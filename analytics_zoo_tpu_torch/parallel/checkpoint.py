"""Checkpoint and resume (counterpart of ``parallel/checkpoint.py``).

Snapshot lifecycle, the reference's:

1. the state is written into a hidden temp dir (``.tmp_<name>``);
2. a ``manifest.json`` is written beside it with each file's sha256 and
   size and the step and loop metadata;
3. the snapshot is *published* with an atomic directory rename (the old
   one moves to ``.trash_<name>`` first), so a crash at any point before
   the rename leaves the previous snapshot intact;
4. ``keep_last=N`` garbage-collects the oldest ``step_N`` snapshots.

Layout: ``<path>/<'latest' | step_N | lkg | serve-lkg>/{manifest.json,
data/state.pt}``.  Restore verifies the manifest and, when the newest
snapshot is truncated or corrupt, falls back to the newest older intact
one.  The manifest schema is the reference's (``name``, ``step``,
``state_step``, ``tier``, the caller's ``meta``; ``files`` with sha256
and size); the payload is the port's own: one ``torch.save`` of the
state's tensors, copied to the host after one synchronize, and loaded
with ``torch.load(weights_only=True)`` onto the caller's device (a
``target``'s, or ``device``).  Python scalars, strings and nested dicts,
lists and tuples ride along; nothing else is pickled.

Every snapshot the port writes has a manifest: a directory without one
is a partial write, never a restore candidate's payload.
``restore_elastic`` re-places a snapshot under a ``SpecSet`` of another
width.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.resilience.errors import CheckpointCorrupt
from analytics_zoo_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("analytics_zoo_tpu_torch")

MANIFEST = "manifest.json"
_DATA_SUBDIR = "data"
_PAYLOAD = "state.pt"

#: Snapshot tiers with their own named slot beside ``latest``/``step_N``:
#: ``lkg`` (the anomaly ladder's last-known-good) and ``serve-lkg`` (its
#: serving twin, promoted by the runtime's hot swap after clean decision
#: windows, and the rollback target of a tripped canary).  Tier slots are
#: never candidates of the normal resume path: a tier snapshot is
#: usually older than ``latest`` and must not rewind a restart.
TIERS = ("lkg", "serve-lkg")

# Fault-injection hook: ``fn(phase, path)`` at "pre_save" (before the
# write), "pre_publish" (written, not yet renamed) and "post_publish".
# An exception at pre_publish is a crash mid-save: the temp dir stays
# behind (the next save sweeps it) and the previous snapshot is intact.
_fault_hook: Optional[Callable[[str, str], None]] = None

#: Seconds of the last :func:`save` by phase: ``device_to_host``,
#: ``serialize`` (``torch.save``), ``sha256`` (the manifest) and
#: ``publish`` (the renames and the garbage collection).
last_save_s: Dict[str, float] = {}


def set_fault_hook(fn: Optional[Callable[[str, str], None]]):
    """Install (or clear with ``None``) the save-path fault hook; returns
    the previous one."""
    global _fault_hook
    prev, _fault_hook = _fault_hook, fn
    return prev


def _fire(phase: str, path: str) -> None:
    if _fault_hook is not None:
        _fault_hook(phase, path)


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def _json_default(x):
    if isinstance(x, (np.generic, torch.Tensor)):
        return x.item()
    raise TypeError(f"{type(x).__name__} is not JSON serializable")


def _build_manifest(snap_dir: str, meta: Dict[str, Any]) -> Dict[str, Any]:
    files: Dict[str, Dict[str, Any]] = {}
    for root, _dirs, names in os.walk(snap_dir):
        for n in sorted(names):
            full = os.path.join(root, n)
            rel = os.path.relpath(full, snap_dir)
            if rel == MANIFEST:
                continue
            files[rel] = {"size": os.path.getsize(full),
                          "sha256": _sha256(full)}
    return {"format": 1, "meta": meta, "files": files}


def _write_manifest(snap_dir: str, meta: Dict[str, Any]) -> None:
    manifest = _build_manifest(snap_dir, meta)
    with open(os.path.join(snap_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True,
                  default=_json_default)


def read_manifest(snap_dir: str) -> Optional[Dict[str, Any]]:
    """The snapshot's manifest, or ``None`` when it has none (a partial
    write)."""
    p = os.path.join(snap_dir, MANIFEST)
    if not os.path.isfile(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_snapshot(snap_dir: str) -> Dict[str, Any]:
    """Check that every file the manifest lists exists with its recorded
    size and sha256.  Returns the manifest; raises
    :class:`CheckpointCorrupt` at the first discrepancy."""
    man = read_manifest(snap_dir)
    if man is None:
        raise CheckpointCorrupt(f"{snap_dir}: manifest missing or unreadable")
    for rel, info in man.get("files", {}).items():
        full = os.path.join(snap_dir, rel)
        if not os.path.isfile(full):
            raise CheckpointCorrupt(f"{snap_dir}: missing file {rel}")
        size = os.path.getsize(full)
        if size != info["size"]:
            raise CheckpointCorrupt(
                f"{snap_dir}: {rel} truncated ({size} != {info['size']} bytes)")
        if _sha256(full) != info["sha256"]:
            raise CheckpointCorrupt(f"{snap_dir}: {rel} checksum mismatch")
    return man


# ---------------------------------------------------------------------------
# Host copies
# ---------------------------------------------------------------------------


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _host_leaf(x):
    """A tensor as a CPU tensor that owns exactly its bytes (a view of a
    larger storage would serialize the whole storage); numpy arrays and
    numpy scalars become tensors and Python scalars."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).clone()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, torch.Tensor):
        h = x.detach().cpu()
        if (not h.is_contiguous() or h.untyped_storage().nbytes()
                != h.numel() * h.element_size()):
            h = h.contiguous().clone()
        return h
    return x


def host_state(state: Any) -> Any:
    """``state`` with every tensor copied to the host, after one
    synchronize of each CUDA device it touches."""
    devs = {x.device for x in _tree_leaves(state)
            if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for d in devs:
        torch.cuda.synchronize(d)
    return _tree_map(_host_leaf, state)


def _state_step(state: Any) -> Optional[int]:
    step = getattr(state, "step", None)
    if step is None and isinstance(state, dict):
        step = state.get("step")
    if step is None:
        return None
    try:
        return int(step)
    except (TypeError, ValueError, RuntimeError):
        return None


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------


def _publish(base: str, tmp: str, target: str, name: str) -> None:
    """Atomic publish: the live snapshot moves to the trash slot, the
    temp dir takes its name.  The trash slot is cleared only when a live
    target must move into it: after a crash between the two renames it
    holds the only intact snapshot, a restore candidate."""
    trash = os.path.join(base, f".trash_{name}")
    if os.path.exists(target):
        if os.path.isdir(trash):
            shutil.rmtree(trash)
        os.rename(target, trash)
    os.rename(tmp, target)
    shutil.rmtree(trash, ignore_errors=True)


def save(path: str, state: Any, step: Optional[int] = None,
         keep_last: Optional[int] = None,
         meta: Optional[Dict[str, Any]] = None,
         tier: Optional[str] = None) -> str:
    """Save a state (a dict of tensors, scalars and nested containers)
    atomically; returns the published snapshot's directory.

    ``step=None`` overwrites the one ``latest`` snapshot; an integer
    publishes ``step_<step>`` and, with ``keep_last=N``, removes all but
    the newest N step snapshots.  ``meta`` (epoch, iteration, ...) goes
    into the manifest beside the state's own step.  ``tier="lkg"`` or
    ``"serve-lkg"`` publishes into that tier's slot instead."""
    if tier is not None:
        if tier not in TIERS:
            raise ValueError(f"unknown checkpoint tier {tier!r}; "
                             f"one of {TIERS}")
        name = tier
    else:
        name = "latest" if step is None else f"step_{step}"
    base = os.path.abspath(path)
    target = os.path.join(base, name)
    os.makedirs(base, exist_ok=True)
    tmp = os.path.join(base, f".tmp_{name}")
    timing: Dict[str, float] = {}
    t0 = time.perf_counter()
    host = host_state(state)
    timing["device_to_host"] = time.perf_counter() - t0
    _fire("pre_save", target)
    # stale temps of crashed saves: sweep them all (a step-tagged save
    # uses a fresh .tmp_step_N each time, so a same-name sweep would leak
    # a snapshot-sized dir per crash)
    for d in os.listdir(base):
        if d.startswith(".tmp_") and os.path.isdir(os.path.join(base, d)):
            shutil.rmtree(os.path.join(base, d))
    os.makedirs(os.path.join(tmp, _DATA_SUBDIR))
    t0 = time.perf_counter()
    torch.save(host, os.path.join(tmp, _DATA_SUBDIR, _PAYLOAD))
    timing["serialize"] = time.perf_counter() - t0
    man_meta = {"name": name, "step": step, "state_step": _state_step(host)}
    if tier is not None:
        man_meta["tier"] = tier
    man_meta.update(meta or {})
    t0 = time.perf_counter()
    _write_manifest(tmp, man_meta)
    timing["sha256"] = time.perf_counter() - t0
    _fire("pre_publish", target)
    t0 = time.perf_counter()
    _publish(base, tmp, target, name)
    _fire("post_publish", target)
    if keep_last is not None and step is not None:
        _gc_old_steps(base, keep_last)
    timing["publish"] = time.perf_counter() - t0
    last_save_s.clear()
    last_save_s.update(timing)
    return target


def _gc_old_steps(base: str, keep_last: int) -> None:
    steps = _step_dirs(base, require_manifest=False)
    doomed = steps[:-keep_last] if keep_last > 0 else steps
    for _n, d in doomed:
        logger.info("checkpoint GC: removing %s (keep_last=%d)", d, keep_last)
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# Resolve
# ---------------------------------------------------------------------------


def _step_dirs(path: str, require_manifest: bool = True
               ) -> List[Tuple[int, str]]:
    """``(step, dir)`` pairs ascending by step.  ``require_manifest``
    skips partial ``step_N`` writes (no manifest yet)."""
    out: List[Tuple[int, str]] = []
    if not os.path.isdir(path):
        return out
    for d in os.listdir(path):
        if not d.startswith("step_"):
            continue
        try:
            n = int(d.split("_", 1)[1])
        except ValueError:
            continue
        full = os.path.join(path, d)
        if require_manifest and read_manifest(full) is None:
            logger.warning("checkpoint: skipping %s (no manifest — "
                           "partially written)", full)
            continue
        out.append((n, full))
    out.sort()
    return out


def latest_step(path: str, require_manifest: bool = True) -> Optional[int]:
    steps = _step_dirs(path, require_manifest=require_manifest)
    return steps[-1][0] if steps else None


def _recency(snap_dir: str, fallback: float) -> float:
    """Training-position sort key: the manifest's loop iteration, else
    its step tag, else the state's step, else ``fallback``."""
    man = read_manifest(snap_dir)
    if man is not None:
        meta = man.get("meta", {})
        for k in ("iteration", "step", "state_step"):
            v = meta.get(k)
            if v is not None:
                return float(v)
    return fallback


def _candidates(base: str) -> List[str]:
    """Restore candidates newest first by training position (not by slot
    name: a stale ``latest`` must not outrank newer ``step_N``), then the
    ``.trash_*`` slots, where a crash between publish's two renames
    leaves the only intact snapshot."""
    ranked: List[Tuple[float, int, str]] = []
    latest = os.path.join(base, "latest")
    if os.path.isdir(latest):
        ranked.append((_recency(latest, float("inf")), 1, latest))
    for n, d in _step_dirs(base, require_manifest=False):
        ranked.append((_recency(d, float(n)), 0, d))
    ranked.sort(key=lambda t: (t[0], t[1]), reverse=True)
    cands = [d for _r, _tie, d in ranked]
    if os.path.isdir(base):
        cands.extend(os.path.join(base, d) for d in sorted(os.listdir(base))
                     if d.startswith(".trash_")
                     and os.path.isdir(os.path.join(base, d)))
    return cands


def newest_intact(path: str) -> Optional[Tuple[str, Dict[str, Any]]]:
    """``(snapshot_dir, manifest)`` of the newest snapshot that verifies,
    or ``None``: where a restart will resume, without loading it."""
    for c in _candidates(os.path.abspath(path)):
        try:
            return c, verify_snapshot(c)
        except CheckpointCorrupt:
            continue
    return None


def tier_snapshot(path: str, tier: str
                  ) -> Optional[Tuple[str, Dict[str, Any]]]:
    """``(snapshot_dir, manifest)`` of a tier slot when it exists and
    verifies, else ``None``."""
    if tier not in TIERS:
        raise ValueError(f"unknown checkpoint tier {tier!r}; one of {TIERS}")
    snap = os.path.join(os.path.abspath(path), tier)
    if not os.path.isdir(snap):
        return None
    try:
        return snap, verify_snapshot(snap)
    except CheckpointCorrupt as e:
        logger.warning("checkpoint: %s tier slot unusable (%s)", tier, e)
        return None


def lkg_snapshot(path: str) -> Optional[Tuple[str, Dict[str, Any]]]:
    """The last-known-good tier slot (:func:`tier_snapshot` of ``lkg``)."""
    return tier_snapshot(path, "lkg")


def promote_tier(path: str, snap_dir: str, tier: str) -> str:
    """Copy a published snapshot that verifies into a tier slot, with the
    same temp-write → manifest → rename lifecycle as :func:`save`: the
    exact bytes, never re-serialized.  The copy's manifest records its
    source under ``meta.promoted_from``.  Returns the tier slot."""
    if tier not in TIERS:
        raise ValueError(f"unknown checkpoint tier {tier!r}; one of {TIERS}")
    src = os.path.abspath(snap_dir)
    man = verify_snapshot(src)          # never promote unvouched bytes
    base = os.path.abspath(path)
    target = os.path.join(base, tier)
    if src == target:
        return target
    tmp = os.path.join(base, f".tmp_{tier}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    _fire("pre_save", target)
    shutil.copytree(src, tmp)
    meta = dict(man.get("meta", {}))
    meta.update({"name": tier, "tier": tier,
                 "promoted_from": os.path.basename(src)})
    _write_manifest(tmp, meta)
    _fire("pre_publish", target)
    _publish(base, tmp, target, tier)
    _fire("post_publish", target)
    return target


class CheckpointWatcher:
    """Poll for "a different intact snapshot was published" under a
    checkpoint directory: the serving side's view of a trainer.
    Construction baselines the newest intact snapshot; :meth:`poll`
    compares the manifest's sha256 map (content, not mtimes).  Tier slots
    are never candidates, so a promotion does not retrigger it."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._seen = self._fingerprint()[0]

    def _fingerprint(self) -> Tuple[Optional[str],
                                    Optional[Tuple[str, Dict[str, Any]]]]:
        found = newest_intact(self.path)
        if found is None:
            return None, None
        _snap, man = found
        digest = hashlib.sha256(json.dumps(
            {rel: info["sha256"] for rel, info in man.get("files", {}).items()},
            sort_keys=True).encode()).hexdigest()
        return digest, found

    def poll(self) -> Optional[Tuple[str, Dict[str, Any]]]:
        """``(snapshot_dir, manifest)`` of a newly published intact
        snapshot, or ``None`` when nothing changed since the last poll;
        marks the returned snapshot seen."""
        digest, found = self._fingerprint()
        if digest is None or digest == self._seen:
            return None
        self._seen = digest
        return found


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------


def _place_like(loaded, target, where: str):
    """``loaded`` checked against ``target``'s structure and shapes, each
    tensor on its target leaf's device."""
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            raise ValueError(
                f"checkpoint structure mismatch at {where or 'root'}: keys "
                f"{sorted(map(str, loaded)) if isinstance(loaded, dict) else type(loaded).__name__}"
                f" != {sorted(map(str, target))}")
        return type(target)((k, _place_like(loaded[k], v, f"{where}/{k}"))
                            for k, v in target.items())
    if isinstance(target, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) \
                or len(loaded) != len(target):
            raise ValueError(f"checkpoint structure mismatch at {where}")
        return type(target)(_place_like(a, b, f"{where}/{i}")
                            for i, (a, b) in enumerate(zip(loaded, target)))
    if isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) \
                or loaded.shape != target.shape:
            raise ValueError(
                f"checkpoint shape mismatch at {where}: "
                f"{getattr(loaded, 'shape', type(loaded).__name__)} != "
                f"{tuple(target.shape)}")
        return loaded.to(target.device)
    return loaded


def _restore(snap_dir: str, target: Any, verify: bool, device) -> Any:
    if read_manifest(snap_dir) is None:
        raise CheckpointCorrupt(f"{snap_dir}: manifest missing or unreadable")
    if verify:
        verify_snapshot(snap_dir)
    payload = os.path.join(snap_dir, _DATA_SUBDIR, _PAYLOAD)
    if target is not None:
        devs = [x.device for x in _tree_leaves(target)
                if isinstance(x, torch.Tensor)]
        where = devs[0] if devs else torch.device("cpu")
    else:
        where = resolve_device(device)
    state = torch.load(payload, map_location=where, weights_only=True)
    if target is not None:
        state = _place_like(state, target, "")
    return state


def load(path: str, target: Any = None, step: Optional[int] = None,
         verify: bool = True, device=None) -> Any:
    """Restore a checkpoint.  ``target`` (a state of the same structure)
    fixes the structure and shapes, and each tensor lands on its target
    leaf's device; without it the state lands on ``device`` (the GPU
    unless ``device="cpu"``).

    ``step=None`` walks the candidates newest first and returns the first
    that verifies and loads: a truncated or corrupt newest snapshot falls
    back to the newest intact older one (with a warning).  ``step=<int>``
    pins one snapshot, and corruption there raises.  ``verify=False``
    skips the checksums.  ``path`` may also be a snapshot directory."""
    base = os.path.abspath(path)
    if step is not None:
        return _restore(os.path.join(base, f"step_{step}"), target, verify,
                        device)
    cands = _candidates(base)
    if not cands:
        return _restore(base, target, verify, device)   # a snapshot dir
    errors: List[str] = []
    for c in cands:
        try:
            out = _restore(c, target, verify, device)
            if errors:
                logger.warning("checkpoint: restored fallback %s after "
                               "rejecting newer snapshot(s): %s", c,
                               "; ".join(errors))
            return out
        except CheckpointCorrupt as e:
            logger.warning("checkpoint: %s", e)
            errors.append(str(e))
        except Exception as e:  # an unverified payload that fails to load
            logger.warning("checkpoint: restore of %s failed (%s: %s)",
                           c, type(e).__name__, e)
            errors.append(f"{c}: {type(e).__name__}: {e}")
    raise CheckpointCorrupt(
        f"no intact snapshot under {base}: " + "; ".join(errors))


def restore_elastic(path: str, target: Any, specs,
                    step: Optional[int] = None, verify: bool = True,
                    module=None, device=None) -> Any:
    """Restore a snapshot saved at any world width and place it under
    ``specs`` (a ``SpecSet``, possibly of another width W′).

    Snapshots hold whole host tensors (``SpecSet.gather`` before the
    save), so re-placement is one ``specs.place_state``: replicated
    tensors as they are, a ``{name: tensor}`` state of ``module`` cut to
    this rank's shards by the declared rules.  ``target`` (a state of the
    same structure) fixes the structure and the device, as in
    :func:`load`; without it the state lands on ``device``.

    Raises ``ElasticPlacementError`` when the snapshot is intact but does
    not match ``target``'s structure (the wrong model for this
    checkpoint, not corruption), and propagates the same error from
    ``place_state`` when the mesh cannot carry the declaration."""
    from analytics_zoo_tpu_torch.resilience.errors import (
        ElasticPlacementError)

    try:
        state = load(path, target=target, step=step, verify=verify,
                     device=device)
    except CheckpointCorrupt:
        if target is None:
            raise
        raw = load(path, target=None, step=step, verify=verify,
                   device="cpu")

        def keys(tree):
            return sorted(tree) if isinstance(tree, dict) else type(tree)

        raise ElasticPlacementError(
            f"restore_elastic: snapshot is intact but does not structure-"
            f"match the target tree (snapshot top-level keys {keys(raw)}, "
            f"target {keys(target)}) — wrong model for this checkpoint, "
            f"not corruption")
    return specs.place_state(state, module=module)


def has_checkpoint(path: str) -> bool:
    """True when at least one restore candidate exists under ``path`` (it
    may still fail verification; ``load`` falls back)."""
    return bool(_candidates(os.path.abspath(path)))
