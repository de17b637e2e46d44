"""Weight bridges between a flax variables tree and a PyTorch
``state_dict``, both ways, and the name-keyed weight copy the Caffe
importer uses.

The port's own copy of ``flatten_params`` (``utils/convert.py`` of the
JAX package) plus the bridges for SSD and its AlexNet and MobileNet
variants, DeepSpeech2, AttentionASR, Faster-RCNN, a Caffe graph and the
small model families (the fraud MLP, NeuralCF, Wide&Deep, the sentiment
heads): the
port names its modules after the flax ones, so ``vgg/conv1_1/kernel``
becomes ``vgg.conv1_1.weight`` with the kernel moved from flax HWIO to
torch OIHW (a Dense kernel, and a 1-D convolution's (k, in, out), is
transposed; an ``embedding`` table keeps its layout).  :func:`state_dict_to_flax` maps tensors named as the module's
(parameters, buffers or their gradients) back onto a flax tree's names
and layouts, so that two trainings compare leaf by leaf.
:func:`train_state_from_jax` carries a whole reference ``TrainState``
(weights, batch statistics, the optimizer's slots and the step) into
the contents of a port checkpoint.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Params pytree → {'vgg/conv1_1/kernel': array, ...} (slash-joined)."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            out.update(flatten_params(v, key))
    else:
        out[prefix] = np.asarray(tree)
    return out


def conv_hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    """flax conv kernel (H, W, I, O) → torch (O, I, H, W)."""
    return np.transpose(w, (3, 2, 0, 1))


# flax leaf name → torch state_dict leaf name, per collection; a leaf
# not listed keeps its name (SSD's CMul ``weight``)
_PARAM_LEAF = {"kernel": "weight", "scale": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _torch_name(coll: str, key: str) -> str:
    """The ``state_dict`` name of flax leaf ``key`` of collection
    ``coll`` (``a/BatchNorm_0/scale`` → ``a.weight``)."""
    leaves = _PARAM_LEAF if coll == "params" else _STAT_LEAF
    parts = [p for p in key.split("/") if p != "BatchNorm_0"]
    return ".".join(parts[:-1] + [leaves.get(parts[-1], parts[-1])])


def _to_flax_layout(key: str, value: np.ndarray) -> np.ndarray:
    """A torch tensor of flax leaf ``key`` in flax's layout (Dense
    kernels transposed, conv kernels OIHW → HWIO)."""
    if key.split("/")[-1] != "kernel":
        return value
    return np.transpose(value, (2, 3, 1, 0)) if value.ndim == 4 else value.T


_KERNEL_OWNERS = (nn.Linear, nn.Conv1d, nn.Conv2d)


def flax_key(module: nn.Module, name: str) -> str:
    """The flax key of parameter ``name`` of ``module`` (the inverse of
    :func:`_torch_name` for ``params``): a ``Linear``/``Conv`` weight is
    a ``kernel``, a batch norm's weight its ``scale``, any other leaf
    keeps its name (``vgg.conv1_1.weight`` → ``vgg/conv1_1/kernel``)."""
    parts = name.split(".")
    owner = module.get_submodule(".".join(parts[:-1]))
    leaf = parts[-1]
    if leaf == "weight":
        if isinstance(owner, _KERNEL_OWNERS):
            leaf = "kernel"
        elif hasattr(owner, "running_mean"):
            leaf = "scale"
    return "/".join(parts[:-1] + [leaf])


def flax_dim_order(key: str, ndim: int) -> Tuple[int, ...]:
    """``order[d]`` is the torch dim of flax dim ``d`` of leaf ``key``:
    a Dense kernel (in, out) is torch (out, in), a conv kernel (kh, kw,
    cin, cout) torch (cout, cin, kh, kw), a 1-D one (k, in, out) torch
    (out, in, k); every other leaf keeps its layout (the layouts of
    :func:`_to_flax_layout`)."""
    if key.split("/")[-1] != "kernel" or ndim < 2:
        return tuple(range(ndim))
    if ndim == 2:
        return (1, 0)
    if ndim == 3:
        return (2, 1, 0)
    return (2, 3, 1, 0)


def state_dict_to_flax(tensors: Mapping[str, torch.Tensor],
                       like: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`flax_variables_to_state_dict`: tensors named
    as the module's ``state_dict`` (or its parameters' gradients) → a
    dict of collections, each flattened to flax's slash-joined keys,
    for every leaf of the flax tree ``like`` that ``tensors`` holds
    (gradients hold no ``batch_stats``).  Values are numpy arrays in
    flax's layouts; a collection with no leaf is left out."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for coll in ("params", "batch_stats"):
        for key in flatten_params(like.get(coll, {})):
            name = _torch_name(coll, key)
            if name in tensors:
                value = tensors[name].detach().float().cpu().numpy()
                out.setdefault(coll, {})[key] = _to_flax_layout(key, value)
    return out


def flax_variables_to_state_dict(variables: Mapping, model: nn.Module
                                 ) -> Dict[str, torch.Tensor]:
    """Map flax ``variables`` (``{"params": …, "batch_stats": …}``, each
    nested or already flattened with slash-joined keys) onto ``model``'s
    ``state_dict`` by name: scope ``a/b/kernel`` becomes ``a.b.weight``
    (Dense kernels transposed, conv kernels HWIO → OIHW), BatchNorm's
    ``scale`` and ``mean/var`` become ``weight`` and
    ``running_mean/running_var``, and flax's inner ``BatchNorm_0`` scope
    is dropped.

    Every flax leaf is used exactly once: a leaf with no counterpart in
    the model, a model entry with no leaf, or a shape that does not fit
    raises.  Returns CPU tensors ready for ``model.load_state_dict``."""
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    extra = []
    for coll in ("params", "batch_stats"):
        for key, value in flatten_params(variables.get(coll, {})).items():
            name = _torch_name(coll, key)
            if key.split("/")[-1] == "kernel":
                value = (conv_hwio_to_oihw(value) if value.ndim == 4
                         else value.T)
            if name not in want or name in out:
                extra.append(f"{coll}/{key}")
                continue
            if tuple(value.shape) != tuple(want[name].shape):
                raise ValueError(f"{coll}/{key}: shape {tuple(value.shape)} "
                                 f"does not fit {name} "
                                 f"{tuple(want[name].shape)}")
            out[name] = torch.tensor(np.array(value), dtype=torch.float32)
    missing = sorted(set(want) - set(out))
    if extra or missing:
        raise KeyError(f"flax → torch bridge: unused flax leaves {extra}, "
                       f"model entries without a leaf {missing}")
    return out


def ssd_params_from_jax(params: Mapping, model: nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """A flax SSD params tree → the port's ``SSDVgg`` ``state_dict``."""
    return flax_variables_to_state_dict({"params": params}, model)


def frcnn_params_from_jax(params: Mapping, model: nn.Module
                          ) -> Dict[str, torch.Tensor]:
    """A flax ``FasterRcnnDetector`` or ``FasterRcnnVgg`` params tree →
    the port's ``state_dict`` of the same module (``frcnn/vgg/conv1_1``
    → ``frcnn.vgg.conv1_1``).  Both flatten the ROI-pooled map HWC into
    fc6 (``models/faster_rcnn.py``), so fc6's kernel needs no permutation,
    only the transpose of every Dense kernel."""
    return flax_variables_to_state_dict({"params": params}, model)


def ssd_alexnet_params_from_jax(params: Mapping, model: nn.Module
                                ) -> Dict[str, torch.Tensor]:
    """A flax ``SSDAlexNet`` params tree → the port's ``SSDAlexNet``
    ``state_dict`` (``conv1`` … ``conv8_2``, ``loc_i``, ``conf_i``)."""
    return flax_variables_to_state_dict({"params": params}, model)


def ssd_mobilenet_params_from_jax(params: Mapping, model: nn.Module
                                  ) -> Dict[str, torch.Tensor]:
    """A flax ``SSDMobileNet`` params tree → the port's ``SSDMobileNet``
    ``state_dict`` (``conv0``, ``ds1/dw`` → ``ds1.dw``, the depthwise
    kernels (3, 3, 1, C) → (C, 1, 3, 3), ``conv14_1`` …)."""
    return flax_variables_to_state_dict({"params": params}, model)


def caffe_graph_params_from_jax(params: Mapping, graph: nn.Module
                                ) -> Dict[str, torch.Tensor]:
    """A reference ``CaffeGraph``'s flax params → the port graph's
    ``state_dict``.  Both name a layer's weights after the Caffe layer
    (names may hold ``/``): a convolution's or InnerProduct's ``kernel``
    (HWIO, or (in, out)) becomes ``weight`` (OIHW, or (out, in)), a
    Normalize's ``cmul/weight`` becomes ``scale``, and BatchNorm's and
    Scale's leaves keep their names.  Every leaf is used exactly once,
    and every entry of the graph needs one, or this raises."""
    src = flatten_params(params)
    want = graph.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for name, ref in want.items():
        layer, leaf = name.rsplit(".", 1)
        key = {"weight": f"{layer}/kernel",
               "scale": f"{layer}/cmul/weight"}.get(leaf)
        if key not in src:
            key = f"{layer}/{leaf}"
        if key not in src:
            raise KeyError(f"no flax leaf for {name}")
        value = src.pop(key)
        if key.endswith("/kernel"):
            value = conv_hwio_to_oihw(value) if value.ndim == 4 else value.T
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} does not "
                             f"fit {name} {tuple(ref.shape)}")
        out[name] = torch.tensor(np.array(value), dtype=ref.dtype)
    if src:
        raise KeyError(f"flax → torch bridge: unused flax leaves "
                       f"{sorted(src)}")
    return out


def load_weights_by_name(state: Any, source: Mapping[str, np.ndarray],
                         rename: Optional[Callable[[str], str]] = None,
                         strict: bool = False
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """Copy ``source`` arrays (slash-keyed, ``conv1_1/weight``) into a
    ``state_dict`` (or a module's) by name, the port's counterpart of the
    reference's by-layer-name copy: entry ``frcnn.vgg.conv1_1.weight`` is
    looked up under its full key ``frcnn/vgg/conv1_1/weight``, then its
    last two parts ``conv1_1/weight``; ``rename`` pre-maps the source
    keys.  Caffe and torch share the OIHW convolution and ``(out, in)``
    dense layouts, so arrays are copied as they are; a shape that does
    not fit raises.

    Returns ``(new_state, report)``: every entry (loaded ones as tensors
    of the entry's dtype and device), and the report's ``loaded``,
    ``missing`` (entries with no source) and ``unused`` (source keys
    never consumed).  ``strict=True`` raises on a missing entry."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    src = {(rename(k) if rename else k): np.asarray(v)
           for k, v in source.items()}
    out: Dict[str, torch.Tensor] = {}
    loaded, missing, used = [], [], set()
    for name, value in state.items():
        parts = name.split(".")
        found = next((c for c in ("/".join(parts), "/".join(parts[-2:]))
                      if c in src), None)
        if found is None:
            out[name] = value
            missing.append(name)
            continue
        w = src[found]
        if tuple(w.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(value.shape)} vs source {found} "
                             f"{tuple(w.shape)}")
        out[name] = torch.as_tensor(np.array(w), dtype=value.dtype,
                                    device=value.device)
        loaded.append(name)
        used.add(found)
    if strict and missing:
        raise KeyError(f"no source weights for: {missing}")
    return out, {"loaded": loaded, "missing": missing,
                 "unused": [k for k in src if k not in used]}


def ds2_params_from_jax(variables: Mapping, model: nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """A flax DeepSpeech2's ``params`` and ``batch_stats`` → the port's
    ``DeepSpeech2`` ``state_dict`` (``conv1`` HWIO → OIHW, Dense kernels
    transposed, ``bn_*/BatchNorm_0/{scale,bias,mean,var}``,
    ``birnn{i}/{fwd,bwd}/body/h2h``)."""
    return flax_variables_to_state_dict(variables, model)


def attention_asr_params_from_jax(params: Mapping, model: nn.Module
                                  ) -> Dict[str, torch.Tensor]:
    """A flax ``AttentionASR`` params tree → the port's ``AttentionASR``
    ``state_dict``: ``conv1`` HWIO → OIHW, Dense kernels (``embed``,
    ``attn/qkv``, ``attn/proj``, ``mlp1``, ``mlp2``, ``fc_out``)
    transposed, LayerNorm ``scale`` → ``weight``, and a MoE block's
    stacked ``w1/b1/w2/b2`` and ``gate`` in their flax layout."""
    return flax_variables_to_state_dict({"params": params}, model)


def _optax_slots(tree: Any) -> Optional[Dict[str, Any]]:
    """The first Adam (``count``/``mu``/``nu``) or momentum (``trace``)
    state inside an optax state tree as a checkpoint restores it raw
    (``inject_hyperparams``' ``inner_state``, ``chain`` lists)."""
    if isinstance(tree, Mapping):
        if {"mu", "nu", "count"} <= set(tree) or "trace" in tree:
            return dict(tree)
        children = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        children = list(tree)
    else:
        return None
    for c in children:
        found = _optax_slots(c)
        if found is not None:
            return found
    return None


def train_state_from_jax(raw: Mapping, model: nn.Module) -> Dict[str, Any]:
    """A reference ``TrainState`` as its ``checkpoint.load`` returns it
    (numpy leaves: ``step``, ``params``, ``model_state`` with the batch
    statistics, the optax ``opt_state``) → the contents of the port's
    ``Optimizer`` snapshot: ``{"model": state_dict, "step": int,
    "opt_state": ...}``.  Adam's ``mu``/``nu``/``count`` or SGD's
    momentum ``trace`` become the port's per-parameter slot lists, in
    ``model.parameters()`` order and in torch layouts (the kernels' own
    transposes); a state with neither becomes ``{}`` (plain SGD)."""
    extra = dict(raw.get("model_state") or {})
    model_sd = flax_variables_to_state_dict(
        {"params": raw["params"], **extra}, model)
    names = [n for n, p in model.named_parameters() if p.requires_grad]

    def per_param(tree) -> list:
        sd = flax_variables_to_state_dict({"params": tree, **extra}, model)
        return [sd[n] for n in names]

    slots = _optax_slots(raw.get("opt_state"))
    if slots is None:
        opt_state: Dict[str, Any] = {}
    elif "trace" in slots:
        opt_state = {"trace": per_param(slots["trace"])}
    else:
        opt_state = {"count": torch.tensor(int(np.asarray(slots["count"])),
                                           dtype=torch.int32),
                     "mu": per_param(slots["mu"]),
                     "nu": per_param(slots["nu"])}
    return {"model": model_sd, "step": int(np.asarray(raw["step"])),
            "opt_state": opt_state}


def fraud_mlp_params_from_jax(params: Mapping, model: nn.Module
                              ) -> Dict[str, torch.Tensor]:
    """A flax ``FraudMLP`` params tree → the port's ``FraudMLP``
    ``state_dict`` (``fc1``, ``fc2``; Dense kernels transposed)."""
    return flax_variables_to_state_dict({"params": params}, model)


def ncf_params_from_jax(params: Mapping, model: nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """A flax ``NeuralCF`` params tree → the port's ``NeuralCF``
    ``state_dict``: the tables (``user_embed/embedding`` →
    ``user_embed.embedding``, ``mf_*`` under ``include_mf``) as they are,
    ``fc{i}`` and ``out`` transposed."""
    return flax_variables_to_state_dict({"params": params}, model)


def wide_deep_params_from_jax(params: Mapping, model: nn.Module
                              ) -> Dict[str, torch.Tensor]:
    """A flax ``WideAndDeep`` params tree → the port's ``WideAndDeep``
    ``state_dict`` (``wide_user``, ``wide_item``, ``wide_cross``,
    ``user_embed``, ``item_embed``, ``fc{i}``, ``out``)."""
    return flax_variables_to_state_dict({"params": params}, model)


def sentiment_params_from_jax(params: Mapping, model: nn.Module
                              ) -> Dict[str, torch.Tensor]:
    """A flax ``SentimentNet`` params tree, any head → the port's
    ``SentimentNet`` ``state_dict``: ``embed/embedding`` (absent with
    frozen vectors), the cells by the DS2 bridge's names
    (``Recurrent_0/body/gru/ir``, ``BiRecurrent_0/{fwd,bwd}/body/lstm/hi``
    ...; Dense kernels transposed), the 1-D convolution's (5, in, out)
    kernel to torch's (out, in, 5), and ``fc``."""
    return flax_variables_to_state_dict({"params": params}, model)


def _is_qtensor(x) -> bool:
    return hasattr(x, "q") and hasattr(x, "scale")


def _flatten_quantized(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested tree → {'vgg/conv1_2/kernel': leaf}, stopping at leaves
    that are quantized tensors (anything with ``q`` and ``scale``)."""
    if isinstance(tree, Mapping):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(_flatten_quantized(v, f"{prefix}/{k}" if prefix
                                          else str(k)))
        return out
    return {prefix: tree}


def quantized_params_from_jax(qvariables: Mapping, model: nn.Module
                              ) -> Dict[str, Any]:
    """The reference's quantized variables (``{"params": ...}``, nested
    or slash-flattened; each quantized leaf anything with
    numpy-convertible ``q`` (int8, HWIO) and ``scale``, as the
    reference's ``QTensor`` or its npz artifact read by
    ``utils.quantize.load_quantized_npz``) → the port's quantized params
    for ``model`` (the fp model, e.g. ``SSDVgg`` or ``NeuralCF``): torch
    names, kernels as
    :class:`~analytics_zoo_tpu_torch.utils.quantize.QTensor` in OIHW
    (Dense kernels transposed), tables as they are with their column
    scales, the scales unchanged.  Ready for
    ``quantize_model(model, qparams=...)``.  The names go through
    :func:`ssd_params_from_jax`'s map; an unused leaf, a model entry
    without one, or a shape that does not fit raises."""
    from analytics_zoo_tpu_torch.utils.quantize import QTensor, scale_axis

    want = model.state_dict()
    out: Dict[str, Any] = {}
    extra = []
    for key, leaf in _flatten_quantized(qvariables.get("params", {})).items():
        name = _torch_name("params", key)
        if name not in want or name in out:
            extra.append(f"params/{key}")
            continue
        quantized = _is_qtensor(leaf)
        value = np.asarray(leaf.q) if quantized else np.asarray(leaf)
        if key.split("/")[-1] == "kernel":
            value = (conv_hwio_to_oihw(value) if value.ndim == 4
                     else value.T)
        if tuple(value.shape) != tuple(want[name].shape):
            raise ValueError(f"params/{key}: shape {tuple(value.shape)} "
                             f"does not fit {name} "
                             f"{tuple(want[name].shape)}")
        value = torch.from_numpy(np.array(value))
        out[name] = (QTensor(value, torch.from_numpy(
            np.asarray(leaf.scale, np.float32).copy()), scale_axis(name))
            if quantized else value.to(torch.float32))
    missing = sorted(set(want) - set(out))
    if extra or missing:
        raise KeyError(f"quantized flax → torch bridge: unused leaves "
                       f"{extra}, model entries without a leaf {missing}")
    return out
