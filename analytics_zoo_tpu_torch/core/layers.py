"""The layers the SSD path needs (counterpart of ``core/layers.py``),
and flax's default kernel initializer for the port's models.

Tensors here are NCHW, so "channels" is dim 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

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
