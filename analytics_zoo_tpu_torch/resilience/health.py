"""The device-health sentinel: silent-data-corruption detection, straggler
quarantine and eviction (counterpart of ``resilience/health.py``).

The anomaly ladder catches non-finite math and the serving pool catches
crashed or wedged replicas; both trust the silicon.  A device that
computes wrong answers (silent data corruption) or runs persistently
slow degrades the fleet unseen.  This module gives training and serving
the detectors and the decisions to evict it:

- **Parity audit** (:func:`make_audit_fn`): data-parallel ranks must
  hold bit-identical parameters after the gradient all-reduce, so every
  ``audit_every`` steps each rank folds its own copy into one uint32
  word (:func:`tree_fingerprint`) and one ``all_gather`` over the data
  group gives every rank the same vector of words, hence the same
  verdict (:meth:`HealthSentinel.observe_audit`): a single minority rank
  is named.
- **Shadow recompute** (:func:`make_shadow_fn`): a microbatch's forward
  re-run on a second device, the output fingerprints compared
  (:meth:`HealthSentinel.observe_shadow`).
- **Stragglers** (:meth:`HealthSentinel.observe_step_time`): per-device
  EWMAs of step or service time against the fleet median, with
  hysteresis (``flag_after`` consecutive outlier windows flag,
  ``clear_after`` clean ones clear).
- **Quarantine and eviction**: a confirmed suspect raises the retryable
  :class:`~analytics_zoo_tpu_torch.resilience.errors.DeviceQuarantine`
  and the survivors go on without it (:func:`evict_device`, the
  last-known-good tier, ``parallel.elastic.resume_after_quarantine``);
  an ambiguous divergence raises the fatal
  :class:`~analytics_zoo_tpu_torch.resilience.errors.SdcDetected`.
  Serving retires a flagged replica through ``ReplicaPool.quarantine``.

Every knob defaults off (``HealthPolicy(audit_every=0, shadow_every=0)``
and no sentinel armed anywhere by default).

**The fold** is the reference's word for word: FNV-style, position
weights forced odd, uint32 arithmetic wrapping mod 2^32, a float32 leaf
bitcast, another float cast to float32 first, an integer leaf
value-cast.  Torch has no uint32 product, and an int64 product of two
32-bit words overflows, so each product is taken over the 16-bit halves
of the data word in int64 and masked (a Known deviation of the
arithmetic, not of the word).  Leaves are folded in the reference's
tree order: a dict's keys sorted, a list's in order.

Chaos: the ``bit_flip`` fault kind (:mod:`~analytics_zoo_tpu_torch.
resilience.chaos`) arms a process-global flip here (:func:`arm_bit_flip`)
which the audit and the shadow consume: one bit of one element of the
first leaf flipped in the named rank's view before folding, a stuck bit
in that device's read path.
"""

from __future__ import annotations

import dataclasses
import logging
import statistics
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger("analytics_zoo_tpu_torch")

_MASK = 0xFFFFFFFF
_BASIS = 2166136261          # FNV-1a offset basis
_PRIME = 16777619            # FNV prime
_KNUTH = 2654435761          # Knuth's multiplicative hash


# ---------------------------------------------------------------------------
# Chaos hook: deterministic bit-flip injection (the SDC fault model)
# ---------------------------------------------------------------------------

#: the armed flip ``(replica, element, bit)`` or None: process-global, as
#: ``checkpoint.set_fault_hook``, since the chaos schedule fires in the
#: dataset wrapper and the audit runs in the train loop
_FLIP: Optional[Tuple[int, int, int]] = None


def arm_bit_flip(replica: int, element: int = 0,
                 bit: int = 0) -> Optional[Tuple[int, int, int]]:
    """Arm a persistent single-bit corruption of rank ``replica``'s view
    of the audited tree (flat ``element`` of the first leaf, bit
    ``bit``) until :func:`clear_bit_flip`.  Returns the previous spec."""
    global _FLIP
    prev = _FLIP
    _FLIP = (int(replica), int(element), int(bit))
    logger.warning("health: bit_flip armed on replica %d (element %d, "
                   "bit %d)", *_FLIP)
    return prev


def clear_bit_flip() -> None:
    global _FLIP
    _FLIP = None


def active_bit_flip() -> Optional[Tuple[int, int, int]]:
    """The armed flip spec, or None."""
    return _FLIP


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[Any]:
    """Leaves in the reference's tree order: dict keys sorted, sequences
    in order; a module's parameters in registration order."""
    if isinstance(tree, torch.nn.Module):
        return [p.detach() for p in tree.parameters()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if tree is None:
        return []
    return [tree]


def _as_u32(x) -> torch.Tensor:
    """Flat uint32 words of one leaf, held in int64: a 4-byte float is
    bitcast, another float cast to float32 and bitcast, an integer or
    bool value-cast mod 2^32."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    x = x.detach().reshape(-1)
    if x.dtype.is_floating_point:
        if x.dtype != torch.float32:
            x = x.to(torch.float32)
        return x.contiguous().view(torch.int32).to(torch.int64) & _MASK
    if x.dtype == torch.uint32:
        return x.to(torch.int64)
    return x.to(torch.int64) & _MASK


def _leaf_sum(u: torch.Tensor) -> torch.Tensor:
    """``sum(u * w) mod 2^32`` with the odd Knuth position weights ``w``,
    an int64 scalar on ``u``'s device: each product over the 16-bit
    halves of ``u`` so that no int64 term overflows."""
    w = (torch.arange(u.numel(), dtype=torch.int64, device=u.device)
         * _KNUTH & _MASK) | 1
    lo = u & 0xFFFF
    hi = u >> 16
    terms = (lo * w + (((hi * w) & 0xFFFF) << 16)) & _MASK
    return terms.sum() & _MASK


def tree_fingerprint(tree, flip: Optional[Tuple[int, int, bool]] = None
                     ) -> int:
    """The uint32 fold over every leaf of ``tree`` (tensors or arrays),
    equal to the reference's word for the same leaves in the same order.
    A one-bit change anywhere always changes the word (the weights are
    odd), a single-element change almost always.

    ``flip`` (optional) ``(element, bit, on)``: when ``on``, flat
    ``element`` (clipped) of the first leaf has ``bit`` flipped in this
    view before folding, the chaos ``bit_flip`` injection point.

    The word folds on the first leaf's device and is fetched once, at
    the end (the reference folds in-graph and fetches at the decision
    boundary, ``resilience/health.py:121-160``)."""
    word = None
    for k, leaf in enumerate(_leaves(tree)):
        u = _as_u32(leaf)
        if flip is not None and k == 0 and flip[2] and u.numel():
            element, bit = int(flip[0]), int(flip[1])
            idx = min(max(element, 0), u.numel() - 1)
            u = u.clone()
            u[idx] = u[idx] ^ (1 << bit)
        if word is None:
            word = torch.tensor(_BASIS, dtype=torch.int64, device=u.device)
        word = (word * _PRIME + (2 * k + 1)
                + _leaf_sum(u).to(word.device)) & _MASK
    # az-allow: no-host-sync-in-hot-path — the one fetch a fingerprint, at the decision boundary where the reference fetches its word
    return _BASIS if word is None else int(word.item())


def _params_of(model) -> List[torch.Tensor]:
    if isinstance(model, torch.nn.Module):
        return [p.detach() for p in model.parameters()]
    return _leaves(model)


def make_audit_fn(mesh):
    """The parity audit over a pure data-parallel mesh: ``audit(params,
    target, element, bit) -> [word per rank]``.  Every rank of the mesh
    calls it: it folds its own copy of ``params`` (a module's parameters
    or a tree of tensors), with the armed flip applied when this rank is
    ``target`` (``-1`` = none), and one ``all_gather`` over the data group
    gives every rank the same vector, in rank order.  Without a mesh, or
    with one rank, the vector has one word."""
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

    if mesh is None:                    # one process, one word
        return lambda params, target=-1, element=0, bit=0: [
            tree_fingerprint(_params_of(params),
                             flip=(element, bit, int(target) == 0))]
    names = mesh_lib.axis_names(mesh)
    if len(names) != 1:
        raise ValueError(
            f"parity audit needs a pure data-parallel mesh (params "
            f"replicated over one axis); got axes {names} — hybrid meshes "
            f"shard params, so per-replica bit-identity does not hold")
    axis = mesh_lib.data_axis(mesh)
    group = mesh_lib.axis_group(mesh, axis)
    me = mesh_lib.axis_index(mesh, axis)

    def audit(params, target: int = -1, element: int = 0,
              bit: int = 0) -> List[int]:
        on = int(target) >= 0 and me == int(target)
        word = tree_fingerprint(_params_of(params),
                                flip=(element, bit, on))
        if group is None:
            return [word]
        mine = torch.tensor([word], dtype=torch.int64)
        out = [torch.zeros(1, dtype=torch.int64)
               for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, mine, group=group)
        # az-allow: no-host-sync-in-hot-path — the decision boundary: the all_gather's words are host tensors over gloo, read once per audit for the sentinel's verdict
        return [int(t.item()) for t in out]

    return audit


def make_shadow_fn(module, forward_fn=None):
    """The shadow recompute: ``shadow(batch, element, bit, on) -> word``,
    a deterministic eval-mode forward of the batch's ``input`` on the
    device the module and batch sit on, folded to one word.  ``on`` keys
    in the armed flip when this device is the chaos target (corrupting
    its view of the output).  ``forward_fn(module, inputs)`` replaces
    ``module(inputs)`` where the module's call is not its forward."""

    @torch.no_grad()
    def shadow(batch, element: int = 0, bit: int = 0,
               on: bool = False) -> int:
        was = module.training
        module.eval()
        try:
            inputs = batch["input"] if isinstance(batch, dict) else batch
            if forward_fn is not None:
                out = forward_fn(module, inputs)
            elif isinstance(inputs, (tuple, list)):
                out = module(*inputs)
            else:
                out = module(inputs)
        finally:
            module.train(was)
        return tree_fingerprint({"output": out}, flip=(element, bit, on))

    return shadow


def evict_device(mesh, device_index: int, new_width: Optional[int] = None):
    """The eviction's mesh half: a fresh data-parallel mesh over the
    surviving ranks of ``mesh``, rank position ``device_index`` removed
    (``new_width`` narrows further, so the width keeps dividing the
    global batch).  ``torch.distributed`` cannot drop a rank from a
    group, so the survivors get a group of their own: every rank of the
    world calls this at the same point (``new_group`` is collective),
    and the evicted rank, and a rank past ``new_width``, gets ``None``
    back and must leave the loop without entering another collective.
    Compose with the last-known-good tier and the elastic resume
    (``parallel.elastic.resume_after_quarantine``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    survivors = [r for i, r in enumerate(ranks) if i != int(device_index)]
    if not survivors:
        raise ValueError("cannot evict the only device in the mesh")
    if new_width is not None:
        if not 1 <= new_width <= len(survivors):
            raise ValueError(f"new_width {new_width} not in "
                             f"[1, {len(survivors)}]")
        survivors = survivors[:new_width]
    names = mesh_lib.axis_names(mesh)
    # az-allow: one-placement-site — eviction by a new group (ROADMAP Known deviations): torch.distributed cannot drop a rank from a group, so the survivors' mesh is built here, by every rank at the same point
    sub = DeviceMesh(mesh.device_type, survivors,
                     mesh_dim_names=(names[0],) if len(names) == 1
                     else (mesh_lib.data_axis(mesh),))
    return sub if sub.get_coordinate() is not None else None


# ---------------------------------------------------------------------------
# Policy and sentinel (host-side decisions)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HealthPolicy:
    """Knobs of the device-health sentinel.  Both detector cadences
    default to 0, off."""

    #: parity-audit cadence in steps (0 = off)
    audit_every: int = 0
    #: shadow-recompute cadence in steps (0 = off)
    shadow_every: int = 0
    #: the device (rank position) the shadow forward runs on
    shadow_device: int = 1
    #: a device is an outlier when its EWMA > factor × the fleet median
    straggler_factor: float = 1.75
    #: EWMA smoothing of per-device step times
    straggler_alpha: float = 0.25
    #: consecutive outlier observations before flagging
    flag_after: int = 3
    #: consecutive clean observations before an outlier streak resets
    clear_after: int = 2
    #: per-device observations ignored before the EWMA is trusted
    warmup_obs: int = 2
    #: raise ``DeviceQuarantine`` on a confirmed suspect (False: log only)
    evict: bool = True
    #: evictions beyond this degrade to log-only
    max_evictions: int = 1

    def __post_init__(self):
        if self.audit_every < 0 or self.shadow_every < 0:
            raise ValueError("audit_every/shadow_every must be >= 0 "
                             "(0 = off)")
        if self.shadow_device < 1:
            raise ValueError("shadow_device must be >= 1 (device 0 is "
                             "the primary)")
        if self.straggler_factor <= 1.0:
            raise ValueError("straggler_factor must be > 1 (an EWMA at "
                             "the median is not an outlier)")
        if not 0.0 < self.straggler_alpha <= 1.0:
            raise ValueError("straggler_alpha must be in (0, 1]")
        if self.flag_after < 1 or self.clear_after < 1:
            raise ValueError("flag_after/clear_after must be >= 1")
        if self.warmup_obs < 0:
            raise ValueError("warmup_obs must be >= 0")
        if self.max_evictions < 0:
            raise ValueError("max_evictions must be >= 0")


@dataclasses.dataclass
class AuditVerdict:
    """One comparison: ``ok`` when all agree; else ``suspect`` names the
    single minority device (a strict majority agrees) or stays None with
    ``ambiguous=True``."""

    ok: bool
    suspect: Optional[int] = None
    ambiguous: bool = False
    fingerprints: Tuple[int, ...] = ()


class HealthSentinel:
    """The detectors' state machine.  Pure decisions: callers hand it
    host values (fingerprint vectors, per-device seconds) and act on the
    verdicts; raising and evicting stay with the trainer or the serving
    runtime."""

    def __init__(self, policy: Optional[HealthPolicy] = None,
                 registry=None):
        self.policy = policy or HealthPolicy()
        self.registry = registry
        self.events: List[Dict[str, Any]] = []
        self._ewma: Dict[int, float] = {}
        self._obs: Dict[int, int] = {}
        self._streak: Dict[int, int] = {}
        self._clean: Dict[int, int] = {}
        self._flagged: set = set()
        self.audits = 0
        self.divergences = 0
        self.shadow_checks = 0
        self.shadow_mismatches = 0
        self.straggler_flags = 0
        self.quarantines = 0

    def _count(self, name: str) -> None:
        if self.registry is not None:
            # az-allow: registered-metric-names — sentinel-internal helper; every caller passes a literal from the health/* family declared in obs/names.py
            self.registry.counter(name).inc()

    # -- parity audit ------------------------------------------------------
    def observe_audit(self, step: int,
                      fingerprints: Sequence[int]) -> AuditVerdict:
        """Compare one audit's words.  All equal: ok.  One device against
        a strict majority: the suspect.  Anything else (a two-way tie,
        several divergers): ambiguous, the ``SdcDetected`` path."""
        fps = tuple(int(v) for v in fingerprints)
        self.audits += 1
        self._count("health/audits")
        if len(set(fps)) <= 1:
            return AuditVerdict(ok=True, fingerprints=fps)
        self.divergences += 1
        self._count("health/audit_divergences")
        maj_val, maj_n = Counter(fps).most_common(1)[0]
        minority = [i for i, v in enumerate(fps) if v != maj_val]
        suspect = (minority[0] if len(minority) == 1
                   and 2 * maj_n > len(fps) else None)
        self.events.append({"kind": "audit_divergence", "step": int(step),
                            "suspect": suspect,
                            "minority": [int(i) for i in minority],
                            "fingerprints": [int(v) for v in fps]})
        logger.error("health: parity audit diverged at step %d — "
                     "suspect=%s fingerprints=%s", step, suspect, list(fps))
        return AuditVerdict(ok=False, suspect=suspect,
                            ambiguous=suspect is None, fingerprints=fps)

    # -- shadow recompute --------------------------------------------------
    def observe_shadow(self, step: int, primary_fp: int, shadow_fp: int,
                       device: int,
                       tiebreak_fp: Optional[int] = None) -> AuditVerdict:
        """Compare a shadow recompute with the primary; a third vote
        (``tiebreak_fp``) names the odd one out, a bare two-way mismatch
        is ambiguous."""
        p, s = int(primary_fp), int(shadow_fp)
        self.shadow_checks += 1
        self._count("health/shadow_checks")
        if p == s:
            return AuditVerdict(ok=True, fingerprints=(p, s))
        self.shadow_mismatches += 1
        self._count("health/shadow_mismatches")
        suspect = None
        if tiebreak_fp is not None:
            t = int(tiebreak_fp)
            if p == t:
                suspect = int(device)       # the shadow is the odd one
            elif s == t:
                suspect = 0                 # the primary is the odd one
        self.events.append({"kind": "shadow_mismatch", "step": int(step),
                            "device": int(device), "suspect": suspect,
                            "primary_fp": p, "shadow_fp": s,
                            "tiebreak_fp": (int(tiebreak_fp)
                                            if tiebreak_fp is not None
                                            else None)})
        logger.error("health: shadow recompute mismatch at step %d "
                     "(device %d vs primary) — suspect=%s", step, device,
                     suspect)
        return AuditVerdict(ok=False, suspect=suspect,
                            ambiguous=suspect is None, fingerprints=(p, s))

    # -- stragglers --------------------------------------------------------
    def observe_step_time(self, device: int,
                          seconds: float) -> Optional[int]:
        """Feed one per-device step or service time.  Returns the device
        when its EWMA has been over ``straggler_factor`` × the fleet
        median for ``flag_after`` consecutive observations (once, until
        ``clear_after`` clean observations clear it), else None."""
        p = self.policy
        device = int(device)
        n = self._obs.get(device, 0) + 1
        self._obs[device] = n
        prev = self._ewma.get(device)
        self._ewma[device] = (float(seconds) if prev is None else
                              (1.0 - p.straggler_alpha) * prev
                              + p.straggler_alpha * float(seconds))
        if n <= p.warmup_obs:
            return None
        peers = [e for d, e in self._ewma.items()
                 if d != device and self._obs.get(d, 0) > p.warmup_obs]
        if not peers:
            return None
        median = statistics.median(peers)
        if self._ewma[device] > p.straggler_factor * median:
            self._clean[device] = 0
            streak = self._streak.get(device, 0) + 1
            self._streak[device] = streak
            if streak >= p.flag_after and device not in self._flagged:
                self._flagged.add(device)
                self.straggler_flags += 1
                self._count("health/straggler_flags")
                self.events.append({
                    "kind": "straggler_flagged", "device": device,
                    "ewma_s": round(self._ewma[device], 6),
                    "fleet_median_s": round(median, 6),
                    "streak": streak})
                logger.warning("health: device %d flagged as straggler "
                               "(ewma %.4fs vs median %.4fs, streak %d)",
                               device, self._ewma[device], median, streak)
                return device
        else:
            clean = self._clean.get(device, 0) + 1
            self._clean[device] = clean
            if clean >= p.clear_after:
                self._streak[device] = 0
                if device in self._flagged:
                    self._flagged.discard(device)
                    self.events.append({"kind": "straggler_cleared",
                                        "device": device})
        return None

    # -- bookkeeping -------------------------------------------------------
    def note_quarantine(self, device: int, reason: str) -> None:
        """Record an eviction (the caller raises or retires) and drop the
        device's straggler state, so that a retired device's EWMA no
        longer skews the fleet median."""
        device = int(device)
        self.quarantines += 1
        self._count("health/quarantines")
        for m in (self._ewma, self._obs, self._streak, self._clean):
            m.pop(device, None)
        self.events.append({"kind": "quarantine", "device": device,
                            "reason": reason})

    @property
    def eviction_budget_left(self) -> bool:
        return self.quarantines < self.policy.max_evictions

    def flagged(self) -> List[int]:
        return sorted(self._flagged)

    def stats(self) -> Dict[str, int]:
        return {"audits": self.audits,
                "audit_divergences": self.divergences,
                "shadow_checks": self.shadow_checks,
                "shadow_mismatches": self.shadow_mismatches,
                "straggler_flags": self.straggler_flags,
                "quarantines": self.quarantines}
