"""Program engine: audits of recorded PyTorch programs (counterpart of
``analysis/program.py``).

Source rules see what the code *says*; this engine checks what a program
*does*.  The reference traces each target with ``jax.make_jaxpr`` and
walks the jaxpr.  The port's programs are eager, with control flow that
depends on the data (the NMS rounds of ``ops/nms.py::nms_batched``, a
kernel's fit), which ``torch.export`` and ``make_fx``'s symbolic modes
refuse; so the counterpart of the jaxpr is ONE real run of
``built.fn(*built.args)`` on the device its arguments live on, under a
``TorchDispatchMode`` that records every op reaching the dispatcher: its
name, the dtypes and devices of its tensors in and out, and for a
``c10d`` op its process group.  (``make_fx(tracing_mode="real")`` would
record the same ops as a graph, but drops the process groups of the
collectives and costs a second tracing pass; the mode is simpler.)

The four kernels are bound through ctypes, so no dispatcher sees their
launches.  Their entry points are marked with
``utils/cuda_build.py::kernel_op``: while a program records, each call is
one op named ``K1``…``K4`` on both devices, and the ops inside it (the
plain version's, on the CPU) are not part of the program, because on
the card the kernel stands in their place.

Four checks, the reference's rule names read in torch's terms:

- **no-callbacks-in-hot-program** — host round-trips inside a hot
  program: ``aten._local_scalar_dense`` (``.item()``, ``int()``,
  ``bool()`` of a tensor), a device-to-host copy, and the ops that sync
  on CUDA by nature (``nonzero``, ``masked_select``, ``unique*``,
  ``equal``, indexing with a bool mask, ``repeat_interleave`` without
  ``output_size``), one finding per op.  On the card the sync debug mode
  is armed during the run: each op runs under ``"error"`` and joins the
  findings if it synchronized (backward ops too); a sync outside every
  op (``"warn"`` there) is a finding of the line that asked for it
  (``sync@<file>:<line>``).
- **donation-materialized** — the train state is updated in place: each
  tensor that ``donate_state`` lists keeps its storage across the step.
- **no-float64** — any recorded op with a float64 tensor in or out, a
  kernel op included.  Unlike JAX with x64 off, this is live in torch: a
  numpy float64 array turned into a tensor stays float64.
- **collective-inventory** — every ``c10d`` op runs on a group that the
  pipeline's ``SpecSet`` mesh declares: its whole group or one of its
  axis groups.

Program waivers: where a host round-trip is load-bearing by design (a
ROADMAP Known deviation), the target declares a :class:`ProgramWaiver`
naming the rule and the op, with its reason; it is printed as waived,
and one that matches nothing is ``waiver-unused``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import os
import traceback
import warnings
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from analytics_zoo_tpu_torch.analysis.base import Violation
from analytics_zoo_tpu_torch.utils import cuda_build

#: ops that read a device value on the host, or sync on CUDA by nature
#: (their output's size depends on the data)
SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
    "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.unique_dim_consecutive",
    "aten.equal", "aten.is_nonzero",
})

_BOOL_INDEXED = frozenset({"aten.index", "aten.index_put",
                           "aten.index_put_", "aten._index_put_impl_"})
_REPEAT = "aten.repeat_interleave"
_COPIES = frozenset({"aten._to_copy", "aten.copy_"})

#: what the sync debug mode's warnings say
_SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass(frozen=True)
class ProgramWaiver:
    """A target's declared exception: ``rule`` on ``op``, the first word
    of the finding (a recorded op, e.g. ``aten._local_scalar_dense``, or
    a debug-mode sync site ``sync@<file>:<line>``; a ``fnmatch`` pattern,
    ``None`` for any finding of the rule), with its reason.
    ``device`` limits it to programs recorded on that device type (a
    sync only the card's debug mode sees); ``None`` applies everywhere."""

    rule: str
    op: Optional[str]
    reason: str
    device: Optional[str] = None


@dataclasses.dataclass
class BuiltProgram:
    """One recorded-and-audited program: ``fn(*args)`` run once.

    ``donate_state``: the train state whose every tensor must keep its
    storage across the run (a tree of tensors, or a zero-argument
    callable returning one, read before and after; ``None`` skips the
    check — eval/serving programs donate nothing).  ``specs``: the
    pipeline's declared ``SpecSet``; its mesh's groups are the
    collective-inventory ground truth.  ``hot``: host round-trips are
    violations (every program audited today is hot).  ``waivers``: the
    target's declared exceptions."""

    fn: Callable
    args: Tuple
    specs: Any = None
    donate_state: Any = None
    hot: bool = True
    waivers: Sequence[ProgramWaiver] = ()


@dataclasses.dataclass(frozen=True)
class AuditProgram:
    """A named, lazily-built audit target: ``build()`` returns the
    :class:`BuiltProgram` (construction is deferred so ``--source``-only
    runs never pay for model construction)."""

    name: str
    build: Callable[[], BuiltProgram]


@dataclasses.dataclass
class RecordedOp:
    """One op of a recorded program.  ``syncs``: what makes it a host
    round-trip by nature (empty if nothing does); ``debug_sync``: the
    sync debug mode saw it synchronize."""

    name: str
    dtypes: Tuple[str, ...]
    devices: Tuple[str, ...]
    syncs: str = ""
    group: Any = None
    debug_sync: bool = False


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _process_group(args) -> Any:
    for a in pytree.tree_leaves(args):
        if isinstance(a, torch.ScriptObject) \
                and "ProcessGroup" in a._type().qualified_name():
            return torch.distributed.ProcessGroup.unbox(a)
    return None


def _sync_kind(name: str, args, kwargs, out) -> str:
    if name in SYNC_OPS:
        return "reads a device value on the host" \
            if name == "aten._local_scalar_dense" \
            else "output size depends on the data"
    if name in _BOOL_INDEXED:
        idx = args[1] if len(args) > 1 else ()
        if any(t is not None and t.dtype in (torch.bool, torch.uint8)
               for t in _tensors(idx)):
            return "indexing with a bool mask"
    if name == _REPEAT and kwargs.get("output_size") is None:
        repeats = args[1] if len(args) > 1 else args[0]
        if isinstance(repeats, torch.Tensor):
            return "repeat_interleave without output_size"
    if name in _COPIES:
        if name == "aten.copy_":
            src, dst = args[1], args[0]
        else:
            src, dst = args[0], out
        if isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor) \
                and src.device.type == "cuda" and dst.device.type == "cpu":
            return "device-to-host copy"
    return ""


class ProgramRecorder(TorchDispatchMode):
    """Records every op that reaches the dispatcher while active, and the
    kernel entry points (:func:`~analytics_zoo_tpu_torch.utils.cuda_build.
    kernel_op`) as one op each.

    ``armed`` (on the card): each op runs with the sync debug mode at
    ``"error"``; an op that synchronizes is marked and run again with the
    mode off, so the finding names the op, in a backward too.  Between
    ops the mode is ``"warn"``, and ``debug_syncs`` counts those warnings
    by the line that raised them (:func:`sync_site`)."""

    def __init__(self, armed: bool = False):
        super().__init__()
        self.ops: List[RecordedOp] = []
        self.kernel_calls: Counter = Counter()
        self.debug_syncs: Counter = Counter()
        self._armed = armed
        self._paused = 0

    def _run(self, func, args, kwargs):
        """``(out, synced)``: ``func`` run, on the card under the error
        mode and again, unchecked, if it synchronized (the mode raises
        before the sync, so the first run wrote nothing)."""
        if not self._armed or func.namespace == "c10d":
            # a collective is never run twice: its sync counts by line
            return func(*args, **kwargs), False
        torch.cuda.set_sync_debug_mode("error")
        try:
            return func(*args, **kwargs), False
        except RuntimeError as e:
            if _SYNC_WARNING not in str(e):
                raise
        finally:
            torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
        try:
            return func(*args, **kwargs), True
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        out, synced = self._run(func, args, kwargs)
        name = f"{func.namespace}.{func._schema.name.split('::')[-1]}"
        ts = _tensors((args, kwargs)) + _tensors(out)
        self.ops.append(RecordedOp(
            name=name,
            dtypes=tuple(str(t.dtype) for t in ts),
            devices=tuple(t.device.type for t in ts),
            syncs=_sync_kind(name, args, kwargs, out),
            group=(_process_group(args) if func.namespace == "c10d"
                   else None),
            debug_sync=synced))
        return out

    def kernel(self, name: str, fn: Callable, args, kwargs):
        """Run one kernel entry point as one recorded op (the ops inside
        it unchecked: a sync there is counted by its line)."""
        if self._paused:
            return fn(*args, **kwargs)
        self._paused += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._paused -= 1
        ts = _tensors((args, kwargs)) + _tensors(out)
        self.ops.append(RecordedOp(
            name=name, dtypes=tuple(str(t.dtype) for t in ts),
            devices=tuple(t.device.type for t in ts)))
        self.kernel_calls[name] += 1
        return out


_ROOT = os.path.dirname(cuda_build.PACKAGE_DIR.as_posix())
_SKIP = (os.path.dirname(os.path.abspath(__file__)) + os.sep,
         os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,
         os.path.dirname(os.path.abspath(warnings.__file__)) + os.sep)


def sync_site() -> str:
    """``sync@<file>:<line>``: the innermost line of the calling Python
    stack outside torch, the standard library and this engine — where the
    program asked for the sync (a C++ warning surfaces when its Python
    call returns, and the autograd engine replays a backward's at the
    ``backward()`` call)."""
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if not path.startswith(_SKIP):
            where = (os.path.relpath(path, _ROOT)
                     if path.startswith(_ROOT + os.sep)
                     else os.path.basename(path))
            return f"sync@{where}:{frame.lineno}"
    return "sync@<unknown>"


def _device_of(args) -> str:
    for t in _tensors(args):
        return t.device.type
    return "cpu"


def record(built: BuiltProgram) -> ProgramRecorder:
    """Run ``built.fn(*built.args)`` once under the recorder, the kernel
    entry points routed to it; for a hot program on ``cuda``, the sync
    debug mode armed and each of its warnings counted at its
    :func:`sync_site`."""
    armed = built.hot and _device_of(built.args) == "cuda"
    rec = ProgramRecorder(armed=armed)
    with contextlib.ExitStack() as stack:
        if armed:
            stack.enter_context(warnings.catch_warnings())
            warnings.filterwarnings("always", message=f".*{_SYNC_WARNING}")
            shown = warnings.showwarning

            def show(message, *args, **kwargs):
                if _SYNC_WARNING in str(message):
                    rec.debug_syncs[sync_site()] += 1
                else:
                    shown(message, *args, **kwargs)

            warnings.showwarning = show
            prev_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            stack.callback(torch.cuda.set_sync_debug_mode, prev_mode)
        prev = cuda_build.RECORDER
        cuda_build.RECORDER = rec
        stack.callback(setattr, cuda_build, "RECORDER", prev)
        with rec:
            built.fn(*built.args)
    return rec


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _state_tensors(state) -> List[torch.Tensor]:
    return _tensors(state() if callable(state) else state)


def collective_inventory(rec: ProgramRecorder) -> List[Any]:
    """The process groups of every ``c10d`` op in the recorded program,
    in first-use order (``None`` for an op that names none)."""
    seen: List[Any] = []
    for op in rec.ops:
        if op.name.startswith("c10d.") and op.group not in seen:
            seen.append(op.group)
    return seen


def _group_key(group) -> Any:
    name = getattr(group, "group_name", None)
    return name if name is not None else id(group)


def declared_groups(mesh) -> Set[Any]:
    """The groups a mesh declares: the world's when the mesh covers it,
    else the group of all its ranks where it has one, and each of its
    axes' groups."""
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

    keys: Set[Any] = set()
    whole = (dist.group.WORLD if int(mesh.size()) == dist.get_world_size()
             else (mesh.get_group(mesh_lib.axis_names(mesh)[0])
                   if len(mesh_lib.axis_names(mesh)) == 1 else None))
    if whole is not None:
        keys.add(_group_key(whole))
    for name in mesh_lib.axis_names(mesh):
        keys.add(_group_key(mesh.get_group(name)))
    return keys


def _group_ranks(group) -> List[int]:
    import torch.distributed as dist

    try:
        return list(dist.get_process_group_ranks(group))
    except (RuntimeError, ValueError):   # a group this rank is not in
        return []


def _round_trip(where: str, what: str, detail: str) -> Violation:
    return Violation(
        rule="no-callbacks-in-hot-program", file=where, line=0,
        message=f"{what} inside the program ({detail}) — a host "
                f"round-trip that stalls the launch queue; keep the value "
                f"on the device")


def audit_recorded(where: str, built: BuiltProgram,
                   rec: ProgramRecorder) -> List[Violation]:
    """Every program check over one recorded run (the donation check
    reads ``built.donate_state`` itself, around the run)."""
    out: List[Violation] = []
    if built.hot:
        found: Dict[str, List] = {}
        for op in rec.ops:
            if op.syncs or op.debug_sync:
                n = found.setdefault(op.name, [0, 0, op.syncs])
                n[0] += bool(op.syncs)
                n[1] += op.debug_sync
        for name, (calls, seen, why) in sorted(found.items()):
            detail = [f"{calls} call(s), {why}"] if calls else []
            if seen:
                detail.append(f"{seen} call(s) the sync debug mode saw "
                              f"synchronize")
            out.append(_round_trip(where, name, "; ".join(detail)))
        for site, n in sorted(rec.debug_syncs.items()):
            out.append(_round_trip(
                where, site, f"{n} sync(s) seen by the sync debug mode"))

    f64 = Counter(op.name for op in rec.ops if "torch.float64" in op.dtypes)
    if f64:
        ops = ", ".join(f"{n} ×{c}" for n, c in sorted(f64.items()))
        out.append(Violation(
            rule="no-float64", file=where, line=0,
            message=f"float64 values inside the program ({ops}) — a "
                    f"leaked double (a numpy float64 array, an np.float64 "
                    f"scalar made a tensor) doubles bandwidth and runs at "
                    f"a fraction of the card's fp32 rate"))

    groups = collective_inventory(rec)
    if built.specs is not None and groups:
        from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

        mesh = built.specs.mesh
        declared = declared_groups(mesh)
        for group in groups:
            if _group_key(group) in declared:
                continue
            ops = sorted({op.name for op in rec.ops
                          if op.name.startswith("c10d.")
                          and op.group is group})
            out.append(Violation(
                rule="collective-inventory", file=where, line=0,
                message=f"collectives {ops} over the group of ranks "
                        f"{_group_ranks(group)} but the pipeline's SpecSet "
                        f"declares mesh axes "
                        f"{sorted(mesh_lib.axis_names(mesh))} — the "
                        f"program communicates over a group the "
                        f"declaration doesn't know about"))
    return out


def _apply_program_waivers(where: str, found: List[Violation],
                           waivers: Sequence[ProgramWaiver],
                           device: str) -> List[Violation]:
    active = [w for w in waivers if w.device in (None, device)]
    used = [0] * len(active)
    out: List[Violation] = []
    for v in found:
        op = v.message.split(" ", 1)[0]
        for i, w in enumerate(active):
            if w.rule == v.rule and (w.op is None
                                     or fnmatch.fnmatchcase(op, w.op)):
                used[i] += 1
                v = dataclasses.replace(v, waived=True,
                                        waiver_reason=w.reason)
                break
        out.append(v)
    for w, n in zip(active, used):
        if not n:
            out.append(Violation(
                rule="waiver-unused", file=where, line=0,
                message=f"program waiver for {w.rule!r} on {w.op} matched "
                        f"no violation — the exception it documented is "
                        f"gone; delete it"))
    return out


@dataclasses.dataclass
class AuditResult:
    """What one target's audit found, and the kernel ops it recorded."""

    violations: List[Violation]
    kernels: Dict[str, int]
    debug_syncs: int = 0


def audit_target(target: AuditProgram) -> AuditResult:
    """Build one target, record one run, run every program check."""
    where = f"program:{target.name}"
    try:
        built = target.build()
        device = _device_of(built.args)
        before = None
        if built.donate_state is not None:
            before = [(t, _storage(t))
                      for t in _state_tensors(built.donate_state)]
        rec = record(built)
    except Exception as e:  # a target that cannot run IS a finding
        return AuditResult([Violation(
            rule="program-trace-error", file=where, line=0,
            message=f"audit target failed to run: "
                    f"{type(e).__name__}: {e}")], {})
    found = audit_recorded(where, built, rec)
    if before is not None:
        after = _state_tensors(built.donate_state)
        ptrs = {id(t): p for t, p in before}
        replaced = sum(1 for t in after
                       if id(t) not in ptrs or _storage(t) != ptrs[id(t)])
        if replaced:
            found.append(Violation(
                rule="donation-materialized", file=where, line=0,
                message=f"{replaced}/{len(after)} train-state tensors "
                        f"replaced — the step keeps a second copy of "
                        f"parameters+optimizer state on the device (update "
                        f"in place: copy_, not a rebound .data)"))
    debug = (sum(op.debug_sync for op in rec.ops)
             + sum(rec.debug_syncs.values()))
    return AuditResult(
        _apply_program_waivers(where, found, built.waivers, device),
        dict(rec.kernel_calls), debug)


def audit_program(target: AuditProgram) -> List[Violation]:
    """Build one target, record one run and audit it (the reference's
    entry point)."""
    return audit_target(target).violations


def run_program_engine(targets: Sequence[AuditProgram],
                       results: Optional[Dict[str, AuditResult]] = None
                       ) -> List[Violation]:
    """Audit every target; ``results`` (optional) collects each target's
    :class:`AuditResult` by name."""
    out: List[Violation] = []
    for t in targets:
        r = audit_target(t)
        if results is not None:
            results[t.name] = r
        out.extend(r.violations)
    return out
