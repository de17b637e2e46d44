"""Optim methods, LR schedules and triggers (counterpart of
``parallel/optim.py``): ``OptimMethod``, ``SGD``, ``Adam``,
``multistep``, ``Trigger`` and ``TrainingState``.

The reference wraps optax transformations; here each method writes the
same arithmetic out on tensors, in optax's order of operations, so that
one step gives the same parameters: Adam with bias-corrected moments and
``eps`` outside the square root, SGD with the decayed weights added to
the gradient before the momentum trace.  An update can be masked (the
step's ``skip_loss_above`` guard): where ``keep`` is false every
parameter and every slot keeps its value.  ``Plateau`` and ``AdamW``
are not ported (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def multistep(base_lr: float, milestones, gamma: float = 0.1) -> Callable:
    """MultiStep LR: multiply by ``gamma`` at each milestone iteration
    (reference SGD ``MultiStep``)."""
    ms = sorted(int(m) for m in milestones)

    def schedule(step: int) -> float:
        return base_lr * (gamma ** sum(step >= m for m in ms))

    return schedule


# ---------------------------------------------------------------------------
# OptimMethod
# ---------------------------------------------------------------------------


class OptimMethod:
    """An update rule with a learning-rate schedule.  ``init(params)``
    makes the slots; ``update(params, grads, state, lr, keep)`` applies
    one step in place."""

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def lr_for_step(self, step: int) -> float:
        return self.schedule(step)

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        raise NotImplementedError  # pragma: no cover - interface

    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: Dict, lr: float,
               keep: Optional[torch.Tensor] = None) -> None:
        raise NotImplementedError  # pragma: no cover - interface


def _assign(dst: torch.Tensor, new: torch.Tensor,
            keep: Optional[torch.Tensor]) -> None:
    """``dst = new``, or only where ``keep`` (a masked update)."""
    dst.copy_(new if keep is None else torch.where(keep, new, dst))


class SGD(OptimMethod):
    """SGD with optional momentum (optax's trace: ``t = g + m·t``,
    Nesterov ``g + m·t``) and L2 weight decay added to the gradient
    first (reference ``new SGD(learningRate=lr, momentum=0.9)``)."""

    def __init__(self, learning_rate: float = 1e-3, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 schedule: Optional[Callable] = None):
        super().__init__(schedule or (lambda step: learning_rate))
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def init(self, params):
        if not self.momentum:
            return {}
        return {"trace": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params, grads, state, lr, keep=None):
        for i, (p, g) in enumerate(zip(params, grads)):
            if self.weight_decay:
                g = g + self.weight_decay * p
            if self.momentum:
                t = g + self.momentum * state["trace"][i]
                _assign(state["trace"][i], t, keep)
                g = g + self.momentum * t if self.nesterov else t
            _assign(p, p + (-lr) * g, keep)


class Adam(OptimMethod):
    """Adam as optax computes it: ``μ = (1−b1)·g + b1·μ``, ``ν =
    (1−b2)·g² + b2·ν``, the update ``μ̂ / (sqrt(ν̂) + eps)`` with
    ``μ̂ = μ / (1 − b1^count)``, ``ν̂ = ν / (1 − b2^count)``, scaled by
    ``−lr``."""

    def __init__(self, learning_rate: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 schedule: Optional[Callable] = None):
        super().__init__(schedule or (lambda step: learning_rate))
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=params[0].device
                                     if params else None),
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params, grads, state, lr, keep=None):
        count = state["count"] + 1
        c = count.float()
        bc1 = 1.0 - self.b1 ** c
        bc2 = 1.0 - self.b2 ** c
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            m = (1.0 - self.b1) * g + self.b1 * mu
            v = (1.0 - self.b2) * (g * g) + self.b2 * nu
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            _assign(mu, m, keep)
            _assign(nu, v, keep)
            _assign(p, p + (-lr) * u, keep)
        _assign(state["count"], count, keep)


# ---------------------------------------------------------------------------
# Triggers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainingState:
    """Host-visible loop state that triggers predicate over.  ``loss``
    holds the last step's loss as the step left it (a tensor on the
    device until something reads it)."""

    epoch: int = 0
    iteration: int = 0
    loss: object = float("inf")


class Trigger:
    """Predicate over :class:`TrainingState` (reference ``Trigger``:
    maxEpoch / maxIteration)."""

    def __init__(self, fn: Callable[[TrainingState], bool],
                 name: str = "trigger"):
        self._fn = fn
        self.name = name

    def __call__(self, state: TrainingState) -> bool:
        return self._fn(state)

    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        return Trigger(lambda s: s.epoch >= n, f"maxEpoch({n})")

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s.iteration >= n, f"maxIteration({n})")
