"""Optim methods, LR schedules and triggers (counterpart of
``parallel/optim.py``): ``OptimMethod``, ``SGD``, ``Adam``, ``AdamW``,
``multistep``, ``Plateau``, ``Trigger`` and ``TrainingState``.

The reference wraps optax transformations; here each method writes the
same arithmetic out on tensors, in optax's order of operations, so that
one step gives the same parameters: Adam with bias-corrected moments and
``eps`` outside the square root, SGD with the decayed weights added to
the gradient before the momentum trace.  An update can be masked (the
step's ``skip_loss_above`` guard): where ``keep`` is false every
parameter and every slot keeps its value.  The learning rate a step uses
is ``schedule(step) * lr_scale``: ``lr_scale`` is 1 unless a
:class:`Plateau`, driven by the validation score between steps, has
lowered it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

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


class Plateau:
    """Plateau-on-metric LR control (reference SGD ``Plateau``): call
    ``update(metric)`` once a validation; after more than ``patience``
    results that do not beat the best by ``epsilon``, ``scale`` is
    multiplied by ``factor`` (unless that takes ``base_lr * scale`` under
    ``min_lr``)."""

    def __init__(self, monitor: str = "score", factor: float = 0.5,
                 patience: int = 10, mode: str = "max", epsilon: float = 1e-4,
                 min_lr: float = 0.0, base_lr: float = 1.0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.min_lr = min_lr
        self.base_lr = base_lr
        self.scale = 1.0
        self.best: Optional[float] = None
        self.num_bad = 0

    def update(self, metric: float) -> float:
        better = (
            self.best is None
            or (self.mode == "max" and metric > self.best + self.epsilon)
            or (self.mode == "min" and metric < self.best - self.epsilon)
        )
        if better:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                new_scale = self.scale * self.factor
                if self.base_lr * new_scale >= self.min_lr:
                    self.scale = new_scale
                self.num_bad = 0
        return self.scale


# ---------------------------------------------------------------------------
# OptimMethod
# ---------------------------------------------------------------------------


class OptimMethod:
    """An update rule with a learning-rate schedule.  ``init(params)``
    makes the slots; ``update(params, grads, state, lr, keep)`` applies
    one step in place.  ``plateau`` (optional) rescales the schedule from
    the validation results (:meth:`on_validation`)."""

    def __init__(self, schedule: Callable[[int], float],
                 plateau: Optional[Plateau] = None):
        self.schedule = schedule
        self.plateau = plateau

    def lr_for_step(self, step: int, lr_scale: float = 1.0) -> float:
        return self.schedule(step) * lr_scale

    @property
    def lr_scale(self) -> float:
        return self.plateau.scale if self.plateau is not None else 1.0

    def on_validation(self, metrics: Dict[str, float]) -> None:
        if self.plateau is not None and self.plateau.monitor in metrics:
            self.plateau.update(metrics[self.plateau.monitor])

    def state_dict(self) -> Dict[str, Any]:
        """Host state a resumed run needs besides the slots: Plateau's
        scale, best score and patience count."""
        if self.plateau is None:
            return {}
        return {"plateau": {"scale": self.plateau.scale,
                            "best": self.plateau.best,
                            "num_bad": self.plateau.num_bad}}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        p = d.get("plateau")
        if p and self.plateau is not None:
            self.plateau.scale = float(p["scale"])
            self.plateau.best = p["best"]
            self.plateau.num_bad = int(p["num_bad"])

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        raise NotImplementedError  # pragma: no cover - interface

    def step_values(self, params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor], state: Dict, lr: float
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """One step as ``(destination, new value)`` pairs over the slots
        and the parameters, nothing written: a caller that consumes them
        one at a time (:meth:`update`) holds one parameter's temporaries
        at a time; the health-checked step collects them all and commits
        once the step's health word is known."""
        raise NotImplementedError  # pragma: no cover - interface

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: Dict, lr: float,
               keep: Optional[torch.Tensor] = None) -> None:
        """Apply one step in place, only where ``keep`` when given."""
        for dst, new in self.step_values(params, grads, state, lr):
            _assign(dst, new, keep)


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
                 schedule: Optional[Callable] = None,
                 plateau: Optional[Plateau] = None):
        if plateau is not None:
            plateau.base_lr = learning_rate
        super().__init__(schedule or (lambda step: learning_rate), plateau)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def init(self, params):
        if not self.momentum:
            return {}
        return {"trace": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step_values(self, params, grads, state, lr):
        for i, (p, g) in enumerate(zip(params, grads)):
            if self.weight_decay:
                g = g + self.weight_decay * p
            if self.momentum:
                t = g + self.momentum * state["trace"][i]
                yield state["trace"][i], t
                g = g + self.momentum * t if self.nesterov else t
            yield p, p + (-lr) * g


class Adam(OptimMethod):
    """Adam as optax computes it: ``μ = (1−b1)·g + b1·μ``, ``ν =
    (1−b2)·g² + b2·ν``, the update ``μ̂ / (sqrt(ν̂) + eps)`` with
    ``μ̂ = μ / (1 − b1^count)``, ``ν̂ = ν / (1 − b2^count)``, scaled by
    ``−lr``."""

    def __init__(self, learning_rate: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 schedule: Optional[Callable] = None,
                 plateau: Optional[Plateau] = None):
        if plateau is not None:
            plateau.base_lr = learning_rate
        super().__init__(schedule or (lambda step: learning_rate), plateau)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=params[0].device
                                     if params else None),
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step_values(self, params, grads, state, lr):
        count = state["count"] + 1
        c = count.float()
        bc1 = 1.0 - self.b1 ** c
        bc2 = 1.0 - self.b2 ** c
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            m = (1.0 - self.b1) * g + self.b1 * mu
            v = (1.0 - self.b2) * (g * g) + self.b2 * nu
            u = self._direction(p, (m / bc1) / (torch.sqrt(v / bc2)
                                                + self.eps))
            new_p = p + (-lr) * u
            yield mu, m
            yield nu, v
            yield p, new_p
        yield state["count"], count

    def _direction(self, p, u):
        return u


class AdamW(Adam):
    """Adam with decoupled weight decay, as optax's ``adamw``: the Adam
    direction plus ``weight_decay · p``, scaled by ``−lr``."""

    def __init__(self, learning_rate: float = 1e-3,
                 weight_decay: float = 1e-4,
                 schedule: Optional[Callable] = None):
        super().__init__(learning_rate, schedule=schedule)
        self.weight_decay = weight_decay

    def _direction(self, p, u):
        return u + self.weight_decay * p


# ---------------------------------------------------------------------------
# Triggers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainingState:
    """Host-visible loop state that triggers predicate over.  ``loss``
    holds the last step's loss as the step left it (a tensor on the
    device until something reads it); ``score`` the last validation
    score; ``epoch_finished`` is true at an epoch's end."""

    epoch: int = 0
    iteration: int = 0
    epoch_finished: bool = False
    loss: object = float("inf")
    score: Optional[float] = None


class Trigger:
    """Predicate over :class:`TrainingState` (reference ``Trigger``:
    everyEpoch / maxEpoch / maxIteration / severalIteration / maxScore /
    minLoss, and their ``or_`` / ``and_``)."""

    def __init__(self, fn: Callable[[TrainingState], bool],
                 name: str = "trigger"):
        self._fn = fn
        self.name = name

    def __call__(self, state: TrainingState) -> bool:
        return self._fn(state)

    @staticmethod
    def always() -> "Trigger":
        return Trigger(lambda s: True, "always")

    @staticmethod
    def every_epoch() -> "Trigger":
        return Trigger(lambda s: s.epoch_finished, "everyEpoch")

    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        return Trigger(lambda s: s.epoch >= n, f"maxEpoch({n})")

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s.iteration >= n, f"maxIteration({n})")

    @staticmethod
    def several_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s.iteration > 0 and s.iteration % n == 0,
                       f"severalIteration({n})")

    @staticmethod
    def max_score(s: float) -> "Trigger":
        return Trigger(lambda st: st.score is not None and st.score >= s,
                       f"maxScore({s})")

    @staticmethod
    def min_loss(l: float) -> "Trigger":
        return Trigger(lambda st: float(st.loss) <= l, f"minLoss({l})")

    @staticmethod
    def or_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: any(t(s) for t in triggers),
                       " | ".join(t.name for t in triggers))

    @staticmethod
    def and_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: all(t(s) for t in triggers),
                       " & ".join(t.name for t in triggers))
