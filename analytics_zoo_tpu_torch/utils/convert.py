"""Weight import: a flax params tree → a PyTorch ``state_dict``.

The port's own copy of ``flatten_params`` (``utils/convert.py`` of the
JAX package) plus the bridges for SSD and DeepSpeech2: the port names
its modules after the flax ones, so ``vgg/conv1_1/kernel`` becomes
``vgg.conv1_1.weight`` with the kernel moved from flax HWIO to torch
OIHW.
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
    for coll, leaves in (("params", _PARAM_LEAF),
                         ("batch_stats", _STAT_LEAF)):
        for key, value in flatten_params(variables.get(coll, {})).items():
            parts = [p for p in key.split("/") if p != "BatchNorm_0"]
            name = ".".join(parts[:-1] + [leaves.get(parts[-1], parts[-1])])
            if parts[-1] == "kernel":
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
