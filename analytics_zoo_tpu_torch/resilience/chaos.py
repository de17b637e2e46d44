"""The chaos fault-injection matrix (counterpart of ``resilience/chaos.py``).

Where :class:`~analytics_zoo_tpu_torch.parallel.elastic.FaultInjector`
raises one exception once, :class:`ChaosMonkey` drives a schedule of
faults against a running job, each at a chosen global batch index:

===================  ======================================================
kind                 effect
===================  ======================================================
``crash``            raise :class:`InjectedFault` (a lost task)
``xla_transient``    raise a transient device error of a class
                     ``retryable_errors()`` takes (:func:`transient_xla_error`)
``sigterm``          deliver SIGTERM to this process (the graceful
                     preemption path: checkpoint, then ``Preempted``)
``mid_save_kill``    crash the next checkpoint save after the snapshot is
                     written and before its publish rename
``corrupt_latest``   truncate a manifest-listed file of the newest intact
                     snapshot (restore must fall back)
``stall``            sleep past the StallWatchdog deadline
``nan_grads``        a NaN in the batch input (the anomaly sentinel skips)
``inf_loss``         the target blown up so that the loss overflows
``corrupt_batch``    the input's raw bytes scrambled, deterministically
``slow_forward``     serving: latency on one replica's forward
``replica_crash``    serving: one replica's forward raises mid-batch
``burst_load``       serving: the workload's arrival rate multiplied
``bit_flip``         a persistent single-bit corruption of one rank's
                     view of the parameters (the parity audit names it)
``slow_device``      serving: one replica's service time multiplied, with
                     no wedge (only the straggler detector sees it)
===================  ======================================================

The numerical kinds mutate the yielded batch, seeded by the global batch
index, so a replay re-applies the same corruption; ``FaultSpec(batches=
N)`` stretches one over N batches.  The monkey's batch counter runs
across epochs and restart attempts: wrap the dataset once and reuse the
wrapper in every rebuilt ``Optimizer`` (``run_resilient``), and each
fault fires once.  The schedule is plain data, seedable.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal as _signal
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.resilience.errors import InjectedFault

logger = logging.getLogger("analytics_zoo_tpu_torch")

#: kinds that mutate the yielded batch instead of raising
NUMERICAL_KINDS = ("nan_grads", "inf_loss", "corrupt_batch")

#: kinds the serving runtime consumes through
#: :meth:`ChaosMonkey.serving_active` (dispatch or request index); they
#: never fire from a wrapped training dataset
SERVING_KINDS = ("slow_forward", "replica_crash", "burst_load")

#: kinds that model unhealthy silicon (``resilience.health``): ``bit_flip``
#: fires from the dataset wrapper and arms ``health.arm_bit_flip``;
#: ``slow_device`` is consumed by the serving runtime like the serving kinds
DEVICE_KINDS = ("bit_flip", "slow_device")

KINDS = ("crash", "xla_transient", "sigterm", "mid_save_kill",
         "corrupt_latest", "stall") + NUMERICAL_KINDS + SERVING_KINDS \
    + DEVICE_KINDS

#: the accepted ``FaultSpec.detail`` keys per kind (absent: none); an
#: unknown key is refused, so a typo cannot turn a fault into a no-op
_DETAIL_KEYS: Dict[str, frozenset] = {
    "slow_forward": frozenset({"replica", "delay_s"}),
    "replica_crash": frozenset({"replica"}),
    "burst_load": frozenset({"rate_x"}),
    "bit_flip": frozenset({"replica", "element", "bit"}),
    "slow_device": frozenset({"replica", "slow_x"}),
}


def _poison_leaf(batch: Dict[str, Any], key: str) -> np.ndarray:
    """A fresh float copy of ``batch[key]`` (the first element of a tuple
    or list input), put back into ``batch``; the caller's arrays are
    never mutated."""
    val = batch[key]
    if isinstance(val, (tuple, list)):
        arr = np.array(np.asarray(val[0]), copy=True)
        rest = list(val)[1:]
        batch[key] = type(val)([arr] + rest) if isinstance(val, list) \
            else (arr,) + tuple(rest)
    else:
        arr = np.array(np.asarray(val), copy=True)
        batch[key] = arr
    if not np.issubdtype(arr.dtype, np.floating):
        raise TypeError(f"numerical chaos needs a float leaf at "
                        f"batch[{key!r}], got {arr.dtype}")
    return arr


def mutate_batch(kind: str, batch: Dict[str, Any], seed: int
                 ) -> Dict[str, Any]:
    """Apply one numerical fault to a dict batch of host arrays,
    deterministically: the same (kind, seed) on the same clean batch
    gives the same bytes.  Returns a shallow copy."""
    if kind not in NUMERICAL_KINDS:
        raise ValueError(f"not a numerical fault kind: {kind!r}")
    if not isinstance(batch, dict):
        raise TypeError("numerical chaos kinds need dict batches")
    out = dict(batch)
    if kind == "nan_grads":
        arr = _poison_leaf(out, "input")
        arr.reshape(-1)[0] = np.nan
    elif kind == "inf_loss":
        key = "target" if "target" in out else "input"
        arr = _poison_leaf(out, key)
        # large but representable: the squared error overflows float32
        arr.reshape(-1)[0] = np.asarray(1e30, arr.dtype)
    else:  # corrupt_batch: scramble the payload's raw bytes
        arr = _poison_leaf(out, "input")
        rng = np.random.Generator(np.random.PCG64(seed & 0xFFFFFFFFFFFFFFFF))
        flat = arr.view(np.uint8).reshape(-1)
        flat[:] = flat[rng.permutation(flat.size)]
    return out


def transient_xla_error(msg: str = "injected transient device error"):
    """The port's transient device error: an instance of the class a
    failed kernel launch raises (``torch.AcceleratorError``), which
    ``retryable_errors()`` takes; ``torch.cuda.OutOfMemoryError`` where
    that class does not exist."""
    import torch

    cls = getattr(torch, "AcceleratorError", None)
    if cls is not None:
        try:
            return cls(msg)
        except TypeError:
            pass
    return torch.cuda.OutOfMemoryError(msg)


def corrupt_snapshot(checkpoint_path: str) -> Tuple[str, str]:
    """Truncate the largest manifest-listed file of the newest intact
    snapshot under ``checkpoint_path`` (``data/state.pt`` of the port's
    layout) to half its size.  Returns ``(snapshot_dir, relative_file)``;
    raises ``FileNotFoundError`` when there is no intact snapshot."""
    from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt

    found = ckpt.newest_intact(checkpoint_path)
    if found is None:
        raise FileNotFoundError(
            f"no intact snapshot under {checkpoint_path} to corrupt")
    snap_dir, man = found
    files = man.get("files", {})
    if not files:
        raise FileNotFoundError(f"{snap_dir}: manifest lists no files")
    rel = max(files, key=lambda r: files[r]["size"])
    full = os.path.join(snap_dir, rel)
    size = os.path.getsize(full)
    with open(full, "r+b") as f:
        f.truncate(max(size // 2, 1))
    logger.warning("chaos: truncated %s (%d -> %d bytes)", full, size,
                   os.path.getsize(full))
    return snap_dir, rel


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: ``kind`` fires just before the wrapped
    dataset yields global batch ``at_batch``.  The windowed kinds cover
    ``[at_batch, at_batch + batches)``; ``detail`` holds the kind's knobs
    (target replica, delay, rate or slowdown multiplier, flipped bit)."""

    kind: str
    at_batch: int
    batches: int = 1
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.batches < 1:
            raise ValueError("batches must be >= 1")
        windowed = NUMERICAL_KINDS + SERVING_KINDS + ("slow_device",)
        if self.batches > 1 and self.kind not in windowed:
            raise ValueError(f"batches>1 only applies to windowed kinds "
                             f"{windowed}, not {self.kind!r}")
        accepted = _DETAIL_KEYS.get(self.kind, frozenset())
        unknown = set(self.detail) - accepted
        if unknown:
            raise ValueError(
                f"unknown detail key(s) {sorted(unknown)} for kind "
                f"{self.kind!r}; accepted: "
                f"{sorted(accepted) if accepted else '(none)'}")


class ChaosMonkey:
    """Runs a :class:`FaultSpec` schedule.  ``checkpoint_path`` is needed
    by ``mid_save_kill`` and ``corrupt_latest``; ``stall_s`` sizes the
    injected hang.  Every fired fault is appended to :attr:`events`
    (plain dicts with no wall-clock time)."""

    def __init__(self, faults: Sequence[FaultSpec],
                 checkpoint_path: Optional[str] = None,
                 stall_s: float = 1.0):
        self.faults = sorted(faults, key=lambda f: f.at_batch)
        self.checkpoint_path = checkpoint_path
        self.stall_s = stall_s
        self.events: List[Dict[str, Any]] = []
        self.consumed = 0          # the global batch counter
        self._fired = [False] * len(self.faults)
        self._armed_hook = None    # a mid_save_kill hook awaiting a save
        self._armed_flip = False   # a bit_flip armed on the health module

    def arm(self, fault: FaultSpec) -> None:
        """Schedule one more fault mid-run (at a condition known only at
        run time, such as a rollout's current victim)."""
        self.faults.append(fault)
        self._fired.append(False)

    # -- dataset hook ------------------------------------------------------
    def dataset(self, ds) -> "ChaosDataset":
        """``ds`` wrapped so that faults fire at their batch indices; the
        wrapper is re-iterable while the schedule and the counter stay
        with the monkey."""
        return ChaosDataset(self, ds)

    def _due(self) -> List[int]:
        return [i for i, f in enumerate(self.faults)
                if not self._fired[i] and f.at_batch <= self.consumed
                and f.kind not in NUMERICAL_KINDS
                and f.kind not in SERVING_KINDS
                and f.kind != "slow_device"]

    def on_batch(self, batch=None):
        """Fire every due fault (the wrapper calls this before each
        yield) and apply any numerical fault whose window covers this
        batch.  Returns the (possibly mutated) batch."""
        for i in self._due():
            self._fired[i] = True
            f = self.faults[i]
            logger.warning("chaos: firing %s at batch %d", f.kind,
                           self.consumed)
            getattr(self, f"_fire_{f.kind}")(f, i)
        for i, f in enumerate(self.faults):
            if f.kind not in NUMERICAL_KINDS or self._fired[i]:
                continue
            if not (f.at_batch <= self.consumed < f.at_batch + f.batches):
                continue
            logger.warning("chaos: %s poisoning batch %d (window %d..%d)",
                           f.kind, self.consumed, f.at_batch,
                           f.at_batch + f.batches - 1)
            batch = mutate_batch(f.kind, batch, seed=self.consumed)
            self._record(f, scheduled_at=f.at_batch, seed=self.consumed)
            if self.consumed >= f.at_batch + f.batches - 1:
                self._fired[i] = True
        return batch

    def _record(self, f: FaultSpec, **detail) -> None:
        self.events.append({"kind": f.kind, "at_batch": self.consumed,
                            **detail})

    # -- fault kinds -------------------------------------------------------
    def _fire_crash(self, f: FaultSpec, i: int) -> None:
        self._record(f)
        raise InjectedFault(f"injected crash at batch {self.consumed}")

    def _fire_xla_transient(self, f: FaultSpec, i: int) -> None:
        self._record(f)
        raise transient_xla_error(
            f"injected transient device error at batch {self.consumed}")

    def _fire_sigterm(self, f: FaultSpec, i: int) -> None:
        self._record(f)
        os.kill(os.getpid(), _signal.SIGTERM)

    def _fire_stall(self, f: FaultSpec, i: int) -> None:
        self._record(f, stall_s=self.stall_s)
        time.sleep(self.stall_s)

    def _fire_mid_save_kill(self, f: FaultSpec, i: int) -> None:
        from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt

        if self.checkpoint_path is None:
            raise ValueError("mid_save_kill needs ChaosMonkey("
                             "checkpoint_path=...) — an unscoped hook "
                             "could detonate in an unrelated job's save")
        armed_at = self.consumed
        scope = os.path.abspath(self.checkpoint_path)

        def hook(phase: str, path: str) -> None:
            if phase != "pre_publish":
                return
            # scoped to this monkey's checkpoint tree
            if not os.path.abspath(path).startswith(scope + os.sep):
                return
            ckpt.set_fault_hook(None)  # one-shot
            self._armed_hook = None
            self.events.append({"kind": "mid_save_kill",
                                "armed_at_batch": armed_at,
                                "fired_in_save": os.path.basename(path)})
            raise InjectedFault(
                f"injected crash mid-save of {path} (before publish)")

        self._armed_hook = hook
        ckpt.set_fault_hook(hook)

    def _fire_bit_flip(self, f: FaultSpec, i: int) -> None:
        from analytics_zoo_tpu_torch.resilience import health

        replica = int(f.detail.get("replica", 0))
        element = int(f.detail.get("element", 0))
        bit = int(f.detail.get("bit", 0))
        health.arm_bit_flip(replica, element=element, bit=bit)
        self._armed_flip = True
        self._record(f, replica=replica, element=element, bit=bit)

    def _fire_corrupt_latest(self, f: FaultSpec, i: int) -> None:
        if self.checkpoint_path is None:
            raise ValueError("corrupt_latest needs ChaosMonkey("
                             "checkpoint_path=...)")
        try:
            snap, rel = corrupt_snapshot(self.checkpoint_path)
            self._record(f, snapshot=os.path.basename(snap), file=rel)
        except FileNotFoundError:
            # nothing on disk yet: re-arm one batch later
            self._fired[i] = False
            self.faults[i] = FaultSpec(f.kind, f.at_batch + 1)

    # -- serving hooks -----------------------------------------------------
    def serving_active(self, kind: str, index: int,
                       consume: bool = True) -> Optional[FaultSpec]:
        """The spec of serving-consumed ``kind`` whose window covers
        ``index`` (the runtime's dispatch index, or a workload's request
        index), else None.  ``consume=True`` records an event and marks
        the spec fired once ``index`` reaches its window's last slot;
        ``consume=False`` only peeks."""
        if kind not in SERVING_KINDS + ("slow_device",):
            raise ValueError(
                f"not a serving-consumed fault kind: {kind!r}; one of "
                f"{SERVING_KINDS + ('slow_device',)}")
        for i, f in enumerate(self.faults):
            if f.kind != kind or self._fired[i]:
                continue
            if not (f.at_batch <= index < f.at_batch + f.batches):
                continue
            if consume:
                self.events.append({"kind": kind, "at_index": int(index),
                                    **f.detail})
                if index >= f.at_batch + f.batches - 1:
                    self._fired[i] = True
            return f
        return None

    def disarm(self) -> None:
        """Clear the process-global hooks still armed (a ``mid_save_kill``
        hook on the checkpoint module, a ``bit_flip`` on the health
        module), so that no armed fault leaks into a later job."""
        from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt

        if self._armed_hook is not None:
            prev = ckpt.set_fault_hook(None)
            if prev is not None and prev is not self._armed_hook:
                ckpt.set_fault_hook(prev)   # not ours: put it back
            self._armed_hook = None
        if self._armed_flip:
            from analytics_zoo_tpu_torch.resilience import health

            health.clear_bit_flip()
            self._armed_flip = False

    def __enter__(self) -> "ChaosMonkey":
        return self

    def __exit__(self, *exc) -> None:
        self.disarm()

    # -- reporting ---------------------------------------------------------
    def fired_kinds(self) -> List[str]:
        return sorted({e["kind"] for e in self.events})

    def all_fired(self) -> bool:
        return all(self._fired)


class ChaosDataset:
    """A re-iterable dataset bound to a :class:`ChaosMonkey`.  Unknown
    attributes go to the wrapped dataset, so loader metadata stays
    visible through the wrap."""

    def __init__(self, monkey: ChaosMonkey, ds):
        self.monkey = monkey
        self.ds = ds

    def __iter__(self):
        for batch in self.ds:
            batch = self.monkey.on_batch(batch)
            self.monkey.consumed += 1
            yield batch

    def __len__(self):
        return len(self.ds)

    def __getattr__(self, name):
        return getattr(self.__dict__["ds"], name)
