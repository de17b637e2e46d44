"""Weight import: a flax params tree → a PyTorch ``state_dict``.

The port's own copy of ``flatten_params`` (``utils/convert.py`` of the
JAX package) plus the bridge for SSD: the port names its modules after
the flax ones, so ``vgg/conv1_1/kernel`` becomes ``vgg.conv1_1.weight``
with the kernel moved from flax HWIO to torch OIHW.
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


def ssd_params_from_jax(params: Mapping, model: nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """Map a flax SSD params tree (nested, or already flattened with
    slash-joined keys) onto ``model``'s ``state_dict`` keys.

    Every flax leaf is used exactly once: a leaf with no counterpart in
    the model, a model entry with no leaf, or a shape that does not fit
    raises.  Returns CPU tensors ready for ``model.load_state_dict``."""
    flat = flatten_params(params)          # a flat dict passes unchanged
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    extra = []
    for key, value in flat.items():
        parts = key.split("/")
        leaf = parts[-1]
        if leaf == "kernel":
            name = ".".join(parts[:-1] + ["weight"])
            value = conv_hwio_to_oihw(value) if value.ndim == 4 else value.T
        else:
            name = ".".join(parts)
        if name not in want or name in out:
            extra.append(key)
            continue
        if tuple(value.shape) != tuple(want[name].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} does not fit "
                             f"{name} {tuple(want[name].shape)}")
        out[name] = torch.tensor(value, dtype=torch.float32)
    missing = sorted(set(want) - set(out))
    if extra or missing:
        raise KeyError(f"flax → torch SSD bridge: unused flax leaves "
                       f"{extra}, model entries without a leaf {missing}")
    return out
