"""Post-training int8 quantization for serving, two modes (counterpart of
``utils/quantize.py``).

Weights are stored as per-output-channel symmetric int8
(:class:`QTensor`: int8 values and one fp32 scale per output channel).
From that storage, two compute modes:

1. ``compute="dequant"`` (weight-only): each forward dequantizes the
   int8 weights to fp32 (then autocast's dtype) in front of the same
   convolution; the arithmetic is the fp path's, the weights 4x smaller.
2. ``compute="int8"``: activations are quantized per tensor with a
   dynamic scale (``amax(|x|) / 127``) and every quantized layer computes
   an int8 × int8 → int32 product, rescaled once in fp32.  On the card
   the product is an im2col of the NHWC int8 activation and
   ``torch._int_mm`` (cuBLASLt's int8 GEMM on the tensor cores); on the
   CPU its plain version, a float64 convolution of the int8 values,
   exact because every sum stays far below 2**53.

Torch's idiom is a module swap, not the reference's flax method
interceptor: :func:`quantize_model` copies a model and replaces each
``nn.Conv2d`` / ``nn.Linear`` whose weight holds at least ``min_size``
elements with a :class:`QConv2d` / :class:`QLinear` holding the int8
weight and its scales.  So every int8 tensor is consumed by exactly one
convolution or dense layer by construction (the reference's census).
In SSD300 that quantizes every convolution but ``conv1_1``
(3·3·3·64 = 1728 elements).

Usage::

    qparams = quantize_params(model)              # name -> QTensor | Tensor
    fwd = make_quantized_forward(model)           # weight-only
    y = fwd(qparams, x)                           # == model(x) +- eps
    qmodel = quantize_model(model, compute="int8")
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

#: weights with fewer elements stay fp32 (not worth the rounding error)
MIN_SIZE = 4096
# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
_MM_MIN_ROWS, _MM_ALIGN = 17, 8


class QTensor:
    """Symmetric per-output-channel int8 tensor: ``q`` int8 in the
    layer's torch layout (output channels first), ``scale`` fp32 of shape
    ``(q.shape[0],)``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        s = self.scale.reshape((-1,) + (1,) * (self.q.dim() - 1))
        return self.q.to(dtype) * s.to(dtype)

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device))

    def __repr__(self):
        return f"QTensor(shape={tuple(self.q.shape)}, int8)"


def quantize_tensor(w) -> QTensor:
    """w (O, ...) → int8 values and a per-O scale (symmetric, round half
    to even).  Computed in numpy float32 on the host, as the reference
    does, so the values and scales are the reference's bit for bit."""
    t = w if isinstance(w, torch.Tensor) else None
    a = (t.detach().cpu().numpy() if t is not None else np.asarray(w)
         ).astype(np.float32)
    amax = np.max(np.abs(a), axis=tuple(range(1, a.ndim)))      # (O,)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(a / scale.reshape((-1,) + (1,) * (a.ndim - 1))),
                -127, 127).astype(np.int8)
    dev = t.device if t is not None else torch.device("cpu")
    return QTensor(torch.from_numpy(q).to(dev),
                   torch.from_numpy(scale).to(dev))


# ---------------------------------------------------------------------------
# The int8 product and the activation quantization
# ---------------------------------------------------------------------------


def quantize_activation(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric dynamic quantization: ``(q int8, scale 0-d
    fp32)`` with ``scale = max(amax(|x|), 1e-8) / 127``.  Both divisions
    are by 0-d tensors on ``x``'s device: CUDA turns a division by a
    Python number into a product with its reciprocal, which moves the
    round-half-to-even ties."""
    a = x.to(torch.float32)
    d127 = torch.full((), 127.0, device=a.device)
    scale = torch.clamp(a.abs().amax(), min=1e-8) / d127
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ w (N, K).T`` → int32 (M, N).

    On a CUDA tensor ``torch._int_mm``: ``M`` is padded with zero rows to
    more than 16 and ``N`` to a multiple of 8; ``K`` must be a multiple of
    8 and raises otherwise.  On the CPU the plain version, a float64
    product of the int8 values (exact).  ``launches`` counts the card's
    calls."""
    M, K = a.shape
    N = w.shape[0]
    if a.device.type != "cuda":
        return (a.double() @ w.double().t()).to(torch.int32)
    if K % _MM_ALIGN:
        raise ValueError(f"int8 GEMM: K={K} is not a multiple of "
                         f"{_MM_ALIGN} (torch._int_mm refuses it)")
    n_pad = -N % _MM_ALIGN
    m_pad = max(_MM_MIN_ROWS - M, 0)
    if n_pad:
        w = F.pad(w, (0, 0, 0, n_pad))
    if m_pad:
        a = F.pad(a, (0, 0, 0, m_pad))
    int8_matmul.launches += 1
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:M, :N] if (n_pad or m_pad) else out


int8_matmul.launches = 0


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def int8_conv2d_plain(qa: torch.Tensor, qw: torch.Tensor, stride=1,
                      padding=0, dilation=1) -> torch.Tensor:
    """The plain version of :func:`int8_conv2d`: a float64 ``F.conv2d``
    of the int8 values, cast to int32; exact, since no sum of a layer of
    SSD300 comes near 2**53 (at most 4608·127² in magnitude)."""
    return F.conv2d(qa.double(), qw.double(), None, _pair(stride),
                    _pair(padding), _pair(dilation)).to(torch.int32)


def int8_conv2d(qa: torch.Tensor, qw: torch.Tensor, stride=1, padding=0,
                dilation=1) -> torch.Tensor:
    """int8 (N, C, H, W) activation ⊛ int8 (O, C, kh, kw) weight → int32
    accumulators (N, O, Ho, Wo).

    On the card: the activation goes NHWC and is padded, an as_strided
    view gathers its (kh, kw, C) windows into an (N·Ho·Wo, kh·kw·C) im2col
    matrix, and :func:`int8_matmul` multiplies it with the weight in the
    same (kh, kw, C) order; the result is an NHWC tensor returned as an
    NCHW view.  On the CPU: :func:`int8_conv2d_plain`."""
    if qa.device.type != "cuda":
        return int8_conv2d_plain(qa, qw, stride, padding, dilation)
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    N, C, H, W = qa.shape
    O, _, kh, kw = qw.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    x = F.pad(qa.permute(0, 2, 3, 1), (0, 0, pw, pw, ph, ph)).contiguous()
    Hp, Wp = H + 2 * ph, W + 2 * pw
    cols = x.as_strided((N, Ho, Wo, kh, kw, C),
                        (Hp * Wp * C, sh * Wp * C, sw * C, dh * Wp * C,
                         dw * C, 1)).reshape(N * Ho * Wo, kh * kw * C)
    wmat = qw.permute(0, 2, 3, 1).reshape(O, kh * kw * C)
    acc = int8_matmul(cols, wmat)
    return acc.reshape(N, Ho, Wo, O).permute(0, 3, 1, 2)


def _rescale(acc: torch.Tensor, a_scale: torch.Tensor, w_scale: torch.Tensor,
             bias: Optional[torch.Tensor], channel_dim: int,
             dtype: torch.dtype) -> torch.Tensor:
    shape = [1] * acc.dim()
    shape[channel_dim] = -1
    y = acc.to(torch.float32) * (a_scale * w_scale).reshape(shape)
    if bias is not None:
        y = y + bias.to(torch.float32).reshape(shape)
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Quantized layers
# ---------------------------------------------------------------------------


class _QLayer(nn.Module):
    """The int8 weight (``weight_q``), its per-output-channel scales
    (``weight_scale``) and the fp32 bias; ``compute`` picks the mode."""

    def __init__(self, qt: QTensor, bias: Optional[torch.Tensor],
                 compute: str):
        super().__init__()
        if compute not in ("dequant", "int8"):
            raise ValueError(f"unknown compute mode {compute!r}")
        self.compute = compute
        self.register_buffer("weight_q", qt.q)
        self.register_buffer("weight_scale", qt.scale)
        self.bias = (None if bias is None else
                     nn.Parameter(bias.detach().clone(), requires_grad=False))

    def weight(self) -> torch.Tensor:
        return QTensor(self.weight_q, self.weight_scale).dequant()


class QConv2d(_QLayer):
    """``nn.Conv2d`` over a :class:`QTensor` weight."""

    def __init__(self, conv: nn.Conv2d, qt: QTensor, compute: str):
        if conv.groups != 1 or conv.padding_mode != "zeros" \
                or isinstance(conv.padding, str):
            raise ValueError("QConv2d takes ungrouped convolutions with "
                             "explicit zero padding")
        super().__init__(qt, conv.bias, compute)
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation = conv.dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute == "dequant":
            return F.conv2d(x, self.weight(), self.bias, self.stride,
                            self.padding, self.dilation)
        qa, a_scale = quantize_activation(x)
        acc = int8_conv2d(qa, self.weight_q, self.stride, self.padding,
                          self.dilation)
        return _rescale(acc, a_scale, self.weight_scale, self.bias, 1,
                        x.dtype)


class QLinear(_QLayer):
    """``nn.Linear`` over a :class:`QTensor` weight."""

    def __init__(self, linear: nn.Linear, qt: QTensor, compute: str):
        super().__init__(qt, linear.bias, compute)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute == "dequant":
            return F.linear(x, self.weight(), self.bias)
        qa, a_scale = quantize_activation(x)
        acc = int8_matmul(qa.reshape(-1, qa.shape[-1]), self.weight_q)
        acc = acc.reshape(*qa.shape[:-1], -1)
        return _rescale(acc, a_scale, self.weight_scale, self.bias, -1,
                        x.dtype)


_QUANTIZABLE = {nn.Conv2d: QConv2d, nn.Linear: QLinear}


def _quantizable(module: nn.Module, min_size: int) -> bool:
    return (type(module) in _QUANTIZABLE
            and module.weight.numel() >= min_size)


# ---------------------------------------------------------------------------
# Params and models
# ---------------------------------------------------------------------------

QParams = Dict[str, Union[QTensor, torch.Tensor]]


def quantize_params(model: nn.Module, min_size: int = MIN_SIZE) -> QParams:
    """The model's ``state_dict`` with the weight of every ``nn.Conv2d``
    and ``nn.Linear`` of at least ``min_size`` elements as a
    :class:`QTensor`; everything else passes through."""
    out: QParams = dict(model.state_dict())
    for name, m in model.named_modules():
        if _quantizable(m, min_size):
            key = f"{name}.weight" if name else "weight"
            out[key] = quantize_tensor(m.weight)
    return out


def dequantize_params(qparams: Mapping[str, Any],
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """QTensors back to dense tensors: a ``state_dict`` the fp model
    loads."""
    return {k: v.dequant(dtype) if isinstance(v, QTensor) else v
            for k, v in qparams.items()}


def quantize_model(model: nn.Module, compute: str = "dequant",
                   qparams: Optional[Mapping[str, Any]] = None,
                   min_size: int = MIN_SIZE) -> nn.Module:
    """A copy of ``model`` in eval mode with every ``nn.Conv2d`` /
    ``nn.Linear`` of at least ``min_size`` weight elements swapped for a
    :class:`QConv2d` / :class:`QLinear` running ``compute``.  The int8
    weights are quantized from the model's, or taken from ``qparams``
    (a :func:`quantize_params` dict, e.g. loaded from an artifact).  The
    copy holds no fp32 copy of a quantized weight."""
    if compute not in ("dequant", "int8"):
        raise ValueError(f"unknown compute mode {compute!r}")
    # the copy skips the weights that are about to be replaced
    memo = {id(m.weight): None for m in model.modules()
            if _quantizable(m, min_size)}
    qmodel = copy.deepcopy(model, memo)
    for name, m in list(model.named_modules()):
        if not _quantizable(m, min_size):
            continue
        qt = (quantize_tensor(m.weight) if qparams is None
              else qparams[f"{name}.weight"])
        if not isinstance(qt, QTensor):
            raise TypeError(f"{name}.weight: expected a QTensor in qparams")
        qt = qt.to(m.weight.device)
        copied = qmodel.get_submodule(name)
        layer = _QUANTIZABLE[type(m)](copied, qt, compute)
        parent, _, child = name.rpartition(".")
        setattr(qmodel.get_submodule(parent) if parent else qmodel, child,
                layer)
    if qparams is not None:
        rest = {k: v for k, v in qparams.items()
                if not isinstance(v, QTensor) and k in qmodel.state_dict()}
        qmodel.load_state_dict(rest, strict=False)
    return qmodel.eval()


def _module_state(qparams: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A :func:`quantize_params` dict as the quantized model's tensors
    (each QTensor as ``weight_q`` and ``weight_scale``)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in qparams.items():
        if isinstance(v, QTensor):
            out[k + "_q"], out[k + "_scale"] = v.q, v.scale
        else:
            out[k] = v
    return out


def make_quantized_forward(module: nn.Module, dtype=None,
                           compute: str = "dequant") -> Callable:
    """``fwd(qparams, *inputs)``: the module's eval forward over a
    :func:`quantize_params` dict, the quantized layers running
    ``compute``.  ``dtype`` (e.g. ``"bf16"``) runs the forward under
    autocast to it with the floating inputs cast and the outputs cast
    back to fp32, as ``make_eval_step`` does; the scales and the int8
    rescale stay fp32."""
    from torch.func import functional_call

    from analytics_zoo_tpu_torch.parallel.train import (cast_floating,
                                                        resolve_compute_dtype)

    cdtype = resolve_compute_dtype(dtype)
    cache: Dict[str, nn.Module] = {}

    def fwd(qparams, *inputs):
        if "model" not in cache:
            cache["model"] = quantize_model(module, compute, qparams)
        qmodel = cache["model"]
        state = _module_state(qparams)
        with torch.inference_mode():
            if cdtype is None:
                return functional_call(qmodel, state, inputs)
            dev = next(iter(state.values())).device
            with torch.autocast(dev.type, dtype=cdtype):
                out = functional_call(qmodel, state,
                                      cast_floating(inputs, cdtype))
            return cast_floating(out, torch.float32)

    return fwd


# ---------------------------------------------------------------------------
# Artifacts and sizes
# ---------------------------------------------------------------------------


def save_quantized_npz(path: str, qparams: Mapping[str, Any]) -> str:
    """Persist a (possibly quantized) params dict as one npz file in the
    reference's format: a QTensor as ``<name>#q`` (int8) and
    ``<name>#scale``, any other tensor as ``<name>#raw``.  Returns the
    file's path (``.npz`` appended when missing)."""
    if not path.endswith(".npz"):
        path += ".npz"
    flat: Dict[str, np.ndarray] = {}
    for k, v in qparams.items():
        if "#" in k:
            raise ValueError(f"key {k!r} contains a reserved char")
        if isinstance(v, QTensor):
            flat[k + "#q"] = v.q.cpu().numpy()
            flat[k + "#scale"] = v.scale.cpu().numpy()
        else:
            flat[k + "#raw"] = torch.as_tensor(v).cpu().numpy()
    np.savez_compressed(path, **flat)
    return path


def load_quantized_npz(path: str) -> Any:
    """Read an artifact of :func:`save_quantized_npz` or of the
    reference's: names split at ``/`` into nested dicts (the reference's
    flax paths, e.g. ``params/vgg/conv1_2/kernel``; the port's dotted
    names stay flat), QTensors restored, tensors on the CPU.  A
    reference artifact keeps the reference's layouts; pass it through
    ``utils.convert.quantized_params_from_jax``."""
    data = np.load(path)
    out: Dict[str, Any] = {}
    pending: Dict[str, Dict[str, np.ndarray]] = {}
    leaves: Dict[str, Any] = {}
    for key in data.files:
        name, kind = key.rsplit("#", 1)
        if kind in ("q", "scale"):
            pending.setdefault(name, {})[kind] = data[key]
        else:
            leaves[name] = torch.from_numpy(np.array(data[key]))
    for name, qs in pending.items():
        leaves[name] = QTensor(torch.from_numpy(np.array(qs["q"])),
                               torch.from_numpy(np.array(qs["scale"])))
    for name, leaf in leaves.items():
        parts = name.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def quantized_nbytes(tree: Any) -> Tuple[int, int]:
    """(quantized bytes, fp32-equivalent bytes) over a params dict (or a
    nested one, as :func:`load_quantized_npz` returns)."""
    qb = fb = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, Mapping):
            stack.extend(node.values())
        elif isinstance(node, QTensor):
            n = node.q.numel()
            qb += n + 4 * node.scale.numel()
            fb += 4 * n
        else:
            t = torch.as_tensor(node)
            qb += t.element_size() * t.numel()
            fb += 4 * t.numel()
    return qb, fb
