"""The training anomaly sentinel (counterpart of
``resilience/anomaly.py``): the step's health word and the host ladder.

1. **Health word**: ``make_train_step(health_check=True)`` folds the
   finiteness of the loss, the (unscaled, clipped) gradients and the
   *updated* parameters into one int32 scalar a step, on the step's
   device: ``isfinite(leaf).all()`` per floating leaf, reduced per
   section, so a large finite value never sets a bit.  Per-section bits
   name which top-level parameter subtree went non-finite
   (:func:`decode_health`).
2. **Skip**: ``skip_unhealthy=True`` keeps the step's whole state at its
   pre-step values whenever the word is not 0: parameters, optimizer
   slots and the module's buffers (batch statistics and their counts).
   The ``skip_loss_above`` guard becomes the word's spike bit.
3. **Rollback**: :class:`AnomalySentinel`, driven by the ``Optimizer``,
   counts consecutive bad steps; at ``rollback_after`` it restores the
   last-known-good checkpoint tier (promoted after ``promote_after``
   consecutive clean steps, ``parallel.checkpoint`` ``tier="lkg"``) and
   re-seeks the loader past the bad region.
4. **Diverged**: past ``max_rollbacks`` rollbacks the run raises
   :class:`~analytics_zoo_tpu_torch.resilience.errors.TrainingDiverged`,
   which a supervisor does not retry.

On the first bad step of an episode a forensics bundle
(``anomaly_<step>.json``) records the batch's coordinates, the decoded
word, a content hash of the batch (:func:`batch_fingerprint`, equal to
the reference's for equal batches) and the recent losses.

Sections are the sorted top-level names of the parameter tree.  For a
module they are taken from its parameters' flax names
(``utils/convert.py::flax_key``), so a port module and the flax module
it mirrors have the same sections in the same order and a poisoned leaf
sets the same bit in both words.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import logging
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

logger = logging.getLogger("analytics_zoo_tpu_torch")

# ---------------------------------------------------------------------------
# Health word layout (int32 scalar; 0 == healthy)
# ---------------------------------------------------------------------------

#: bit 0: loss non-finite; bit 1: loss spike (> threshold); bit 2: any
#: grad non-finite; bit 3: any updated param non-finite; bits 4+2i /
#: 5+2i: grads / params of section i non-finite.  Sections past
#: ``MAX_SECTIONS`` fold into the last pair so the word stays one int32.
BIT_LOSS_NONFINITE = 0
BIT_LOSS_SPIKE = 1
BIT_GRADS_NONFINITE = 2
BIT_PARAMS_NONFINITE = 3
_SECTION_BIT0 = 4
MAX_SECTIONS = 13          # 4 + 2*13 = 30 bits used, sign bit untouched


def _module_sections(module: nn.Module) -> List[str]:
    """The section of each trainable parameter of ``module``, in
    ``parameters()`` order: the first part of its flax name."""
    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.utils.convert import flax_key

    if isinstance(module, Model):       # the network it wraps
        module = module.module
    return [flax_key(module, name).split("/")[0]
            for name, p in module.named_parameters() if p.requires_grad]


def health_sections(params: Any) -> List[str]:
    """Stable section names: the sorted top-level keys of a mapping, the
    sorted top-level flax names of a module's trainable parameters, or
    ``["params"]`` for anything else.  The step and the decoder use the
    same list."""
    if isinstance(params, nn.Module):
        names = sorted(set(_module_sections(params)))
        return names or ["params"]
    if isinstance(params, Mapping) and len(params):
        return sorted(str(k) for k in params.keys())
    return ["params"]


def section_groups(module: nn.Module) -> Tuple[List[str], List[List[int]]]:
    """``(sections, groups)``: ``groups[i]`` holds the indices, into the
    module's trainable parameters in order, of section ``i``."""
    of = _module_sections(module)
    sections = sorted(set(of)) or ["params"]
    index = {name: i for i, name in enumerate(sections)}
    groups: List[List[int]] = [[] for _ in sections]
    for j, name in enumerate(of):
        groups[index[name]].append(j)
    return sections, groups


def _section_bit(i: int, kind: str) -> int:
    i = min(i, MAX_SECTIONS - 1)
    return _SECTION_BIT0 + 2 * i + (0 if kind == "grads" else 1)


def _leaves(tree) -> List[Any]:
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree, key=str) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _tree_bad(tree, device) -> torch.Tensor:
    """True (a bool tensor on ``device``) when a floating leaf holds a
    non-finite value: ``isfinite(leaf).all()`` per leaf, never a norm or
    a sum, which overflow to inf on finite values."""
    flags = [torch.isfinite(x).all() for x in _leaves(tree)
             if isinstance(x, torch.Tensor)
             and (x.is_floating_point() or x.is_complex())]
    if not flags:
        return torch.zeros((), dtype=torch.bool, device=device)
    return ~torch.stack([f.to(device) for f in flags]).all()


def tree_health_word(loss: torch.Tensor, grads, new_params,
                     sections: Sequence[str],
                     spike_loss_above: Optional[float] = None
                     ) -> torch.Tensor:
    """Fold loss, gradient and updated-parameter finiteness into one
    int32 tensor on the loss's device, without a host read.

    ``grads`` and ``new_params`` map section → its leaves (tensors, in
    lists or dicts); anything else is the one section ``"params"``."""
    dev = loss.device

    def as_map(tree) -> Mapping:
        return tree if isinstance(tree, Mapping) else {"params": tree}

    gmap, pmap = as_map(grads), as_map(new_params)
    word = torch.zeros((), dtype=torch.int32, device=dev)

    def set_bit(word, flag, bit):
        return word | (flag.to(torch.int32) << bit)

    loss = loss.detach()
    word = set_bit(word, ~torch.isfinite(loss), BIT_LOSS_NONFINITE)
    if spike_loss_above is not None:
        # a spike counts only for a finite loss (non-finite has its bit)
        spike = torch.isfinite(loss) & (loss > spike_loss_above)
        word = set_bit(word, spike, BIT_LOSS_SPIKE)
    any_g = torch.zeros((), dtype=torch.bool, device=dev)
    any_p = torch.zeros((), dtype=torch.bool, device=dev)
    for i, name in enumerate(sections):
        g_bad = _tree_bad(gmap.get(name), dev)
        p_bad = _tree_bad(pmap.get(name), dev)
        word = set_bit(word, g_bad, _section_bit(i, "grads"))
        word = set_bit(word, p_bad, _section_bit(i, "params"))
        any_g, any_p = any_g | g_bad, any_p | p_bad
    word = set_bit(word, any_g, BIT_GRADS_NONFINITE)
    word = set_bit(word, any_p, BIT_PARAMS_NONFINITE)
    return word


def word_over_ranks(word: torch.Tensor, group=None) -> torch.Tensor:
    """The OR of every rank's word over ``group`` (a shard's bits are
    its rank's own), as one MAX all-reduce of the bits."""
    shifts = torch.arange(31, dtype=torch.int32, device=word.device)
    bits = (word >> shifts) & 1
    torch.distributed.all_reduce(bits, op=torch.distributed.ReduceOp.MAX,
                                 group=group)
    return (bits << shifts).sum().to(torch.int32)


def decode_health(word: int, sections: Sequence[str]) -> Dict[str, Any]:
    """Host-side report of a health word: names the failing subtrees."""
    word = int(word)
    out: Dict[str, Any] = {
        "healthy": word == 0,
        "loss_nonfinite": bool(word >> BIT_LOSS_NONFINITE & 1),
        "loss_spike": bool(word >> BIT_LOSS_SPIKE & 1),
        "grads_nonfinite": bool(word >> BIT_GRADS_NONFINITE & 1),
        "params_nonfinite": bool(word >> BIT_PARAMS_NONFINITE & 1),
        "bad_sections": {},
    }
    for i, name in enumerate(sections):
        g = bool(word >> _section_bit(i, "grads") & 1)
        p = bool(word >> _section_bit(i, "params") & 1)
        if g or p:
            out["bad_sections"][name] = {"grads": g, "params": p}
    return out


def _flatten_with_path(tree, path: str, out: List[Tuple[str, Any]]):
    """Leaves with their paths as the reference's key strings name them
    (``['input'][0]``); a dict's keys in sorted order, ``None`` no
    leaf."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            _flatten_with_path(tree[k], f"{path}[{k!r}]", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten_with_path(v, f"{path}[{i}]", out)
    elif tree is not None:
        out.append((path, tree))
    return out


def batch_fingerprint(batch: Any) -> str:
    """Content hash of a batch (host arrays or tensors on any device):
    key-ordered, dtype- and shape-tagged blake2s over the raw bytes, the
    reference's digest for equal batches."""
    h = hashlib.blake2s()
    for path, leaf in _flatten_with_path(batch, "", []):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        h.update(path.encode())
        h.update(str(arr.dtype).encode())
        h.update(repr(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Policy + sentinel (host side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AnomalyPolicy:
    """Knobs for the skip → rollback → diverge ladder.

    ``skip`` discards unhealthy updates in the step.  ``rollback_after``
    consecutive bad steps restore the last-known-good tier;
    ``reseek_batches`` (default: ``rollback_after``) deterministic
    batches are then skipped so the stream clears the bad region before
    stepping resumes.  The LKG tier is promoted after ``promote_after``
    consecutive clean steps (and at most every ``promote_after`` steps).
    ``max_rollbacks`` exceeded raises ``TrainingDiverged`` (fatal).
    ``spike_loss_above`` arms the health word's loss-spike bit.
    """

    skip: bool = True
    rollback_after: int = 3
    promote_after: int = 20
    max_rollbacks: int = 2
    reseek_batches: Optional[int] = None
    spike_loss_above: Optional[float] = None
    promote_initial: bool = True
    loss_history: int = 64
    forensics_dir: Optional[str] = None

    def __post_init__(self):
        if self.rollback_after < 1:
            raise ValueError("rollback_after must be >= 1")
        if self.promote_after < 1:
            raise ValueError("promote_after must be >= 1")
        if self.max_rollbacks < 0:
            raise ValueError("max_rollbacks must be >= 0")

    @property
    def reseek(self) -> int:
        return (self.rollback_after if self.reseek_batches is None
                else self.reseek_batches)


class AnomalySentinel:
    """Host-side state machine over per-step health words.

    The Optimizer feeds it one word per step; it answers with the action
    to take (``ok`` / ``skipped`` / ``rollback`` / ``diverged``) and
    keeps the deterministic event log and the loss history the forensics
    bundle reads.
    """

    def __init__(self, policy: AnomalyPolicy, sections: Sequence[str]):
        self.policy = policy
        self.sections = list(sections)
        self.consecutive_bad = 0
        self.clean_streak = 0
        self.bad_steps = 0
        self.skipped = 0
        self.spike_skips = 0
        self.rollbacks = 0
        self.promotions = 0
        self._since_promote: Optional[int] = None
        self.events: List[Dict[str, Any]] = []
        self.loss_history: collections.deque = collections.deque(
            maxlen=policy.loss_history)
        self.forensics_paths: List[str] = []

    # -- per-step ----------------------------------------------------------
    def record_loss(self, loss: float) -> None:
        self.loss_history.append(float(loss))

    def observe(self, word: int) -> Tuple[str, bool]:
        """Feed one health word; returns ``(action, first_detection)``.
        ``first_detection`` is True exactly on the clean→bad transition
        of an episode (the forensics-bundle moment).

        A word carrying ONLY the loss-spike bit keeps the reference
        guard's semantics — skip the update, nothing more: finite
        spikes are routine early training (the reason MultiBoxLoss
        merely skips), so they never count toward the rollback ladder
        and never trigger forensics.  They do reset the clean streak,
        so the LKG tier is not promoted mid-spike-burst."""
        if self._since_promote is not None:
            self._since_promote += 1
        if word == 0:
            self.consecutive_bad = 0
            self.clean_streak += 1
            return "ok", False
        self.clean_streak = 0
        self.bad_steps += 1
        if self.policy.skip:
            self.skipped += 1
        if word == (1 << BIT_LOSS_SPIKE):
            self.spike_skips += 1
            return "skipped", False
        first = self.consecutive_bad == 0
        self.consecutive_bad += 1
        if self.consecutive_bad >= self.policy.rollback_after:
            if self.rollbacks >= self.policy.max_rollbacks:
                return "diverged", first
            return "rollback", first
        return "skipped", first

    # -- ladder bookkeeping ------------------------------------------------
    def should_promote(self) -> bool:
        """Promote the LKG tier when the word has been clean for
        ``promote_after`` consecutive steps, throttled so a long clean
        run re-promotes at most every ``promote_after`` steps."""
        if self.clean_streak < self.policy.promote_after:
            return False
        return (self._since_promote is None
                or self._since_promote >= self.policy.promote_after)

    def note_promoted(self, step: int, snapshot: str) -> None:
        self.promotions += 1
        self._since_promote = 0
        self.events.append({"kind": "lkg_promoted", "step": int(step),
                            "snapshot": snapshot})

    def note_rollback(self, **detail: Any) -> None:
        self.rollbacks += 1
        self.consecutive_bad = 0
        self.clean_streak = 0
        self._since_promote = None   # re-promote only after a fresh streak
        self.events.append({"kind": "rollback",
                            "rollback_index": self.rollbacks, **detail})

    def note_skip(self, word: int, step: int) -> None:
        self.events.append({"kind": "skip", "step": int(step),
                            "health_word": int(word),
                            "consecutive": self.consecutive_bad})

    # -- forensics ---------------------------------------------------------
    def write_forensics(self, directory: str,
                        payload: Dict[str, Any]) -> str:
        """Dump ``anomaly_<step>.json`` (payload must carry ``step``).
        Returns the path; also recorded in :attr:`forensics_paths`."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"anomaly_{payload['step']}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        self.forensics_paths.append(path)
        self.events.append({"kind": "forensics",
                            "path": os.path.basename(path),
                            "step": payload["step"],
                            "health_word": payload.get("health_word")})
        logger.warning("anomaly sentinel: forensics bundle written to %s "
                       "(health word %s)", path, payload.get("health_word"))
        return path

    def stats(self) -> Dict[str, Any]:
        return {"bad_steps": self.bad_steps, "skipped": self.skipped,
                "spike_skips": self.spike_skips,
                "rollbacks": self.rollbacks, "promotions": self.promotions,
                "forensics_bundles": len(self.forensics_paths)}
