"""Weight bridges between a flax variables tree and a PyTorch
``state_dict``, both ways.

The port's own copy of ``flatten_params`` (``utils/convert.py`` of the
JAX package) plus the bridges for SSD and DeepSpeech2: the port names
its modules after the flax ones, so ``vgg/conv1_1/kernel`` becomes
``vgg.conv1_1.weight`` with the kernel moved from flax HWIO to torch
OIHW.  :func:`state_dict_to_flax` maps tensors named as the module's
(parameters, buffers or their gradients) back onto a flax tree's names
and layouts, so that two trainings compare leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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


def ds2_params_from_jax(variables: Mapping, model: nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """A flax DeepSpeech2's ``params`` and ``batch_stats`` → the port's
    ``DeepSpeech2`` ``state_dict`` (``conv1`` HWIO → OIHW, Dense kernels
    transposed, ``bn_*/BatchNorm_0/{scale,bias,mean,var}``,
    ``birnn{i}/{fwd,bwd}/body/h2h``)."""
    return flax_variables_to_state_dict(variables, model)


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
    """The reference's quantized SSD variables (``{"params": ...}``,
    nested or slash-flattened; each quantized kernel anything with
    numpy-convertible ``q`` (int8, HWIO) and ``scale``, as the
    reference's ``QTensor`` or its npz artifact read by
    ``utils.quantize.load_quantized_npz``) → the port's quantized params
    for ``model`` (the fp ``SSDVgg``): torch names, kernels as
    :class:`~analytics_zoo_tpu_torch.utils.quantize.QTensor` in OIHW
    (Dense kernels transposed), the scales unchanged.  Ready for
    ``quantize_model(model, qparams=...)``.  The names go through
    :func:`ssd_params_from_jax`'s map; an unused leaf, a model entry
    without one, or a shape that does not fit raises."""
    from analytics_zoo_tpu_torch.utils.quantize import QTensor

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
        value = torch.from_numpy(np.ascontiguousarray(value))
        out[name] = (QTensor(value, torch.from_numpy(
            np.asarray(leaf.scale, np.float32).copy())) if quantized
            else value.to(torch.float32))
    missing = sorted(set(want) - set(out))
    if extra or missing:
        raise KeyError(f"quantized flax → torch bridge: unused leaves "
                       f"{extra}, model entries without a leaf {missing}")
    return out
