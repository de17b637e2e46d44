"""Stock layers with BigDL names (counterpart of ``core/layers.py``), and
flax's default kernel initializers for the port's models.

Tensors here are NCHW, so "channels" is dim 1; the reference's layers
are NHWC.  Parameters are initialised as flax initialises the
reference's (Xavier-uniform kernels and zero biases for ``Linear`` and
the convolutions, N(0, 0.05) embeddings, LeCun-normal for the models),
drawn from an optional ``torch.Generator``.  Pooling takes Caffe's
``ceil_mode`` with the reference's arithmetic: the input is padded
bottom and right so the windows cover exactly the output size
(:func:`_pool_out_dim`), and an average divides by the whole window
(``count_include_pad=True``) or by its cells inside the padded input.
``BatchNormalization`` keeps flax's statistics: the biased variance
``E[x²] − E[x]²`` and running averages ``0.9 · ra + 0.1 · batch``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.utils.spmd import rows_rand

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


# std of a unit normal truncated at +-2 (flax's variance_scaling divides by
# it, so the truncated draw keeps the asked-for variance)
_TRUNC2_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``lecun_normal`` in place: variance ``1/fan_in``, truncated at
    two standard deviations."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC2_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Normalize(nn.Module):
    """Lp-normalize across ``dim`` (BigDL ``Normalize``; p=2 for SSD).
    ``eps`` is ADDED to the norm, not a clamp: ``x / (‖x‖ + eps)``."""

    def __init__(self, p: float = 2.0, dim: int = 1, eps: float = 1e-10):
        super().__init__()
        self.p, self.dim, self.eps = p, dim, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 2.0:
            norm = torch.sqrt(torch.sum(x * x, dim=self.dim, keepdim=True))
        else:
            norm = torch.sum(torch.abs(x) ** self.p, dim=self.dim,
                             keepdim=True) ** (1.0 / self.p)
        return x / (norm + self.eps)


class CMul(nn.Module):
    """Learnable elementwise scale (BigDL ``CMul``), broadcast over the
    batch; a 1-D ``shape`` scales the channel dim of NCHW input."""

    def __init__(self, shape: Sequence[int], init_value: Optional[float] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.full(
            tuple(shape), 1.0 if init_value is None else float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if w.dim() == 1 and x.dim() == 4:
            w = w.view(1, -1, 1, 1)
        return x * w


class NormalizeScale(nn.Module):
    """L2-normalize channels then a learnable per-channel scale — the SSD
    conv4_3 normalization (reference ``NormalizeScale.scala:28``: Normalize
    + CMul, scale init 20)."""

    def __init__(self, channels: int, scale: float = 20.0, p: float = 2.0,
                 eps: float = 1e-10):
        super().__init__()
        self.norm = Normalize(p=p, dim=1, eps=eps)
        self.cmul = CMul((channels,), init_value=scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cmul(self.norm(x))


# ---------------------------------------------------------------------------
# Dense / conv / pool
# ---------------------------------------------------------------------------


def _xavier_(module: nn.Module, generator: Optional[torch.Generator]):
    with torch.no_grad():
        nn.init.xavier_uniform_(module.weight, generator=generator)
        if module.bias is not None:
            module.bias.zero_()


class Linear(nn.Linear):
    """Fully-connected layer (BigDL ``Linear``): Xavier-uniform weight,
    zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, bias=use_bias)
        _xavier_(self, generator)


class SpatialConvolution(nn.Conv2d):
    """2-D convolution, NCHW (BigDL ``SpatialConvolution``).  ``padding``
    is an int or pair (symmetric, Caffe-style) or ``"SAME"``/``"VALID"``
    (flax's: SAME pads ``total = max((out − 1)·s + d·(k − 1) + 1 − n, 0)``
    with ``total // 2`` before)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntPair = 3, stride: IntPair = 1,
                 padding: Union[IntPair, str] = 0, dilation: IntPair = 1,
                 groups: int = 1, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        self.same = isinstance(padding, str) and padding.upper() == "SAME"
        pad = (0 if isinstance(padding, str) else _pair(padding))
        super().__init__(in_channels, out_channels, _pair(kernel_size),
                         stride=_pair(stride), padding=pad,
                         dilation=_pair(dilation), groups=groups,
                         bias=use_bias)
        _xavier_(self, generator)

    def pad_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` with flax's SAME padding (itself under other padding)."""
        if not self.same:
            return x
        pads = []
        for n, k, s, d in zip(reversed(x.shape[2:]),
                              reversed(self.kernel_size),
                              reversed(self.stride), reversed(self.dilation)):
            out = -(-n // s)
            total = max((out - 1) * s + d * (k - 1) + 1 - n, 0)
            pads += [total // 2, total - total // 2]
        return F.pad(x, pads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(self.pad_input(x))


class SpatialDilatedConvolution(SpatialConvolution):
    """Dilated convolution (BigDL ``SpatialDilatedConvolution``; SSD's fc6
    has dilation 6)."""


def _pool_out_dim(size: int, win: int, stride: int, pad: int,
                  ceil_mode: bool) -> int:
    if ceil_mode:
        out = math.ceil((size + 2 * pad - win) / stride) + 1
        # Caffe's clamp: the last window starts inside the (left-padded)
        # input, or it would lie wholly in the padding
        if (out - 1) * stride >= size + pad:
            out -= 1
    else:
        out = (size + 2 * pad - win) // stride + 1
    return out


def _pool_pads(x: torch.Tensor, window, stride, padding, ceil_mode):
    """[left, right, top, bottom] so that a padding-free window sweep
    emits exactly the output size (right/bottom grown for ceil mode)."""
    (wh, ww), (sh, sw), (ph, pw) = window, stride, padding
    H, W = x.shape[-2:]
    out_h = _pool_out_dim(H, wh, sh, ph, ceil_mode)
    out_w = _pool_out_dim(W, ww, sw, pw, ceil_mode)
    return [pw, max((out_w - 1) * sw + ww - W - pw, 0),
            ph, max((out_h - 1) * sh + wh - H - ph, 0)]


class SpatialMaxPooling(nn.Module):
    def __init__(self, kernel_size: IntPair = 2,
                 stride: Optional[IntPair] = None, padding: IntPair = 0,
                 ceil_mode: bool = False):
        super().__init__()
        self.window = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        self.padding = _pair(padding)
        self.ceil_mode = ceil_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _pool_pads(x, self.window, self.stride, self.padding,
                          self.ceil_mode)
        x = F.pad(x, pads, value=float("-inf"))
        return F.max_pool2d(x, self.window, self.stride)


class SpatialAveragePooling(nn.Module):
    def __init__(self, kernel_size: IntPair = 2,
                 stride: Optional[IntPair] = None, padding: IntPair = 0,
                 ceil_mode: bool = False, global_pool: bool = False,
                 count_include_pad: bool = True):
        super().__init__()
        self.window = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        self.padding = _pair(padding)
        self.ceil_mode = ceil_mode
        self.global_pool = global_pool
        self.count_include_pad = count_include_pad     # BigDL/Caffe default

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.global_pool:
            return x.mean(dim=(2, 3), keepdim=True)
        pads = _pool_pads(x, self.window, self.stride, self.padding,
                          self.ceil_mode)
        total = F.avg_pool2d(F.pad(x, pads), self.window, self.stride,
                             divisor_override=1)
        if self.count_include_pad:
            return total / (self.window[0] * self.window[1])
        ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                                device=x.device), pads)
        counts = F.avg_pool2d(ones, self.window, self.stride,
                              divisor_override=1)
        return total / torch.clamp(counts, min=1.0)


# ---------------------------------------------------------------------------
# Activations / regularization
# ---------------------------------------------------------------------------


class ReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class LogSoftMax(nn.Module):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(x, dim=self.dim)


class SoftMax(LogSoftMax):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x, dim=self.dim)


class Sigmoid(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x)


class Tanh(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x)


class SeededGenerators:
    """One ``torch.Generator`` a device, each seeded with ``seed`` when
    first asked for: a module's draws (dropout masks) repeat from the
    seed on any device."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._by_device = {}

    def __call__(self, device) -> torch.Generator:
        key = str(torch.device(device))
        if key not in self._by_device:
            self._by_device[key] = torch.Generator(
                device=device).manual_seed(self.seed)
        return self._by_device[key]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``Dropout`` in training: keep with probability 1 − rate and
    scale the kept by 1 / (1 − rate); masks from ``generator`` (on
    ``x``'s device) when given."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    # a data-parallel step's rank draws its rows of the global mask
    mask = rows_rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Dropout(nn.Module):
    """``forward(x, train=False, generator=None)``: the identity unless
    ``train``."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return dropout(x, self.rate, generator) if train else x


class BatchNormalization(nn.Module):
    """Batch norm over feature dim ``dim`` (BigDL ``BatchNormalization`` /
    ``SpatialBatchNormalization``; dim 1 of NCHW maps), with flax's
    statistics: ``forward(x, train=False)`` normalizes by the running
    averages, and with ``train=True`` by the batch's mean and biased
    variance over every other dim (fp32), moving the running averages as
    ``momentum · ra + (1 − momentum) · batch``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dim: int = 1):
        super().__init__()
        self.momentum, self.epsilon, self.dim = momentum, epsilon, dim
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dim = self.dim % x.dim()
        shape = [1] * x.dim()
        shape[dim] = -1
        xf = x.float()
        if train:
            dims = tuple(i for i in range(x.dim()) if i != dim)
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class SequenceBatchNormalization(BatchNormalization):
    """Sequence-wise BN: statistics over (batch, time) jointly for
    (B, T, D) input, the features last (reference
    ``BatchNormalizationDS``)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__(features, momentum, epsilon, dim=-1)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


class LookupTable(nn.Embedding):
    """Embedding lookup (BigDL ``LookupTable``; ids are 0-based here),
    N(0, 0.05) rows."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(vocab_size, embedding_dim)
        with torch.no_grad():
            self.weight.normal_(0.0, 0.05, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids.long())


# ---------------------------------------------------------------------------
# Shape plumbing
# ---------------------------------------------------------------------------


class Transpose(nn.Module):
    def __init__(self, perm: Sequence[int]):
        super().__init__()
        self.perm = tuple(perm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(self.perm)


class Reshape(nn.Module):
    def __init__(self, shape: Sequence[int], batch_mode: bool = True):
        super().__init__()
        self.shape, self.batch_mode = tuple(shape), batch_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.batch_mode:
            return x.reshape((x.shape[0],) + self.shape)
        return x.reshape(self.shape)


class InferReshape(Reshape):
    """Reshape with a -1 wildcard (BigDL ``InferReshape``; ``reshape``
    already infers it)."""


class Squeeze(nn.Module):
    def __init__(self, dim: Optional[int] = None):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.squeeze() if self.dim is None else x.squeeze(self.dim)


class Select(nn.Module):
    """One index along a dim (BigDL ``Select``, 0-based here)."""

    def __init__(self, dim: int, index: int):
        super().__init__()
        self.dim, self.index = dim, index

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.select(self.dim, self.index)


class Reverse(nn.Module):
    """Reverse along a dim (BigDL ``Reverse``; DS2 reverses time)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.flip(x, dims=(self.dim,))
