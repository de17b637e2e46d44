"""Sharded serving across processes: the runtime on one rank, followers
on the others (the multi-controller counterpart of the reference's one
controller over a mesh).

A tier built with ``specs=`` (``ssd_serving_tiers(specs=...)`` and the
others) runs collectives: every rank of the mesh must call it with the
same batch, in the same order.  Runtimes on each rank would batch
differently (a ``MonotonicClock`` reads each process's own time) and the
ranks would wait on each other forever.  So one rank, the mesh's first,
runs :class:`~analytics_zoo_tpu_torch.serving.runtime.ServingRuntime`
with ``specs=`` and every other rank runs :func:`serve_follower` over the
same tiers:

- each dispatch of a sharded tier on the leader first broadcasts what to
  run (the tier set, the rung, the batch); each follower looks the rung
  up, and the ranks agree that every follower found its work before
  any rank runs it, so that a rank which fails before the tier's
  collectives fails the dispatch on every rank instead of leaving its
  peers waiting in them;
- a hot swap's tier build (``ModelConfig.weights_to_tiers``) broadcasts
  the loaded state, and every follower builds the same tiers from it (a
  sharded tier's build places the weights with ``specs.place_state``);
- after each command every rank reports its outcome: a follower's
  exception becomes that dispatch's failure on the leader, which fences
  or fails over as for any failed forward;
- :meth:`ServingRuntime.close` sends the followers ``stop``.

**Mesh slices** (``ServingRuntime(slice_width=w)``): :class:`SliceLayout`,
built on every rank at the same point, cuts the mesh's ranks into
consecutive slices of ``w``, each a sub-mesh of its own (its ``SpecSet``
through ``SpecSet.replace_mesh``), and gives each slice a control group.
Each rank builds its tiers with its own slice's specs; the leader's
runtime seats replica ``k`` on slice ``k``.  The slice holding the
leader runs as above.  A slice without it is driven remotely: its
control group is the leader and the slice's ranks, the leader sends each
command there and runs nothing itself, the slice's ranks run the tier
with their collectives on the slice's own groups, and the slice's first
rank sends the rows back with its outcome.

Every wait of the control plane (a command, the agreement, an outcome)
runs on a gloo group of its own whose waits end after :data:`TIMEOUT_S`.
Inside a sharded tier, a rank's placement and forward run before the
ranks' first collective of the call (``parallel.specs.gather_rows_guarded``),
which fails the call on every rank when one rank raised.  A hot swap's
build places the weights on the mesh's own groups, whose waits the
process group's timeout bounds.
"""

from __future__ import annotations

import datetime
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

#: the bound of a control-plane wait, seconds
TIMEOUT_S = 600.0


class FollowerFailed(RuntimeError):
    """A follower rank raised in a command the leader sent."""


def _ranks(specs) -> List[int]:
    return [int(r) for r in specs.mesh.mesh.flatten().tolist()]


def _control_group(ranks: Sequence[int]):
    """``ranks`` in a gloo group of their own (every rank of the world
    calls this, at the same point) whose waits end after
    :data:`TIMEOUT_S`."""
    return dist.new_group(list(ranks), backend="gloo",
                          timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


class _Channel:
    """The control plane: the leader's commands, every rank's outcome.
    ``answer`` (a remote slice's first rank) is the rank whose result is
    the command's; ``None``: the leader runs the command itself."""

    def __init__(self, ranks: Sequence[int], answer: Optional[int] = None):
        self.ranks = [int(r) for r in ranks]
        self.leader = self.ranks[0]
        self.answer = answer
        self.group = _control_group(self.ranks)

    def command(self, cmd=None):
        """Broadcast ``cmd`` from the leader; a follower gets it."""
        box = [cmd]
        dist.broadcast_object_list(box, src=self.leader, group=self.group)
        return box[0]

    def agree(self, ready: bool) -> bool:
        """Whether every rank is ready to run the last command."""
        flag = torch.tensor([0 if ready else 1], dtype=torch.int32)
        dist.all_reduce(flag, group=self.group)
        return not flag.item()

    def outcomes(self, err: Optional[str], payload: Any = None) -> List:
        """Every rank's ``(outcome, payload)`` of the last command
        (outcome ``None``: done; the payload is the answering rank's
        result, else ``None``)."""
        out: List = [None] * len(self.ranks)
        dist.all_gather_object(out, (err, payload), group=self.group)
        return out


class SliceLayout:
    """``specs``' mesh cut into slices of ``width`` ranks, each a sub-mesh
    with the mesh's data axis and a control group.  Every rank of the
    world builds it at the same point (the groups are collective), then
    builds its tiers with ``layout.specs`` (its slice's); the leader
    passes the same to ``ServingRuntime(specs=..., slice_width=width)``,
    every other rank to :func:`serve_follower`.  ``slices[k]`` is slice
    ``k``'s ``SpecSet``, ``mine`` this rank's slice."""

    def __init__(self, specs, width: int):
        from torch.distributed.device_mesh import DeviceMesh

        from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

        ranks = _ranks(specs)
        if width < 1 or len(ranks) % width:
            raise ValueError(f"slice width {width} does not divide the "
                             f"mesh's {len(ranks)} ranks")
        self.width = int(width)
        self.n_slices = len(ranks) // width
        self.leader = ranks[0]
        self.groups = [ranks[k * width:(k + 1) * width]
                       for k in range(self.n_slices)]
        axis = mesh_lib.data_axis(specs.mesh)
        self.slices = []
        for group in self.groups:
            if group == ranks:
                self.slices.append(specs)
                continue
            # az-allow: one-placement-site — a slice over processes is a sub-mesh cut by SliceLayout on every rank (ROADMAP Known deviations); the SpecSet takes it through replace_mesh
            sub = DeviceMesh(specs.mesh.device_type, group,
                             mesh_dim_names=(axis,))
            self.slices.append(specs.replace_mesh(sub))
        me = dist.get_rank()
        self.mine = next(k for k, g in enumerate(self.groups) if me in g)
        self.specs = self.slices[self.mine]
        self._channels: List[_Channel] = []
        for group in self.groups:
            remote = self.leader not in group
            ranks_k = [self.leader] + group if remote else group
            if me in ranks_k:
                self._channels.append(_Channel(
                    ranks_k, answer=group[0] if remote else None))
            else:
                _control_group(ranks_k)  # collective: every rank builds it
                self._channels.append(None)
        for k, spec in enumerate(self.slices):
            _LAYOUTS[id(spec)] = (self, k)

    def channel(self, k: int) -> "_Channel":
        """Slice ``k``'s control channel (this rank must be in it)."""
        if self._channels[k] is None:
            raise ValueError(f"rank {dist.get_rank()} is not in slice {k}'s "
                             "control group")
        return self._channels[k]


#: id(slice SpecSet) -> (layout, slice index)
_LAYOUTS: Dict[int, Any] = {}


def layout_of(specs):
    """The :class:`SliceLayout` that made ``specs`` (``None``: none)."""
    found = _LAYOUTS.get(id(specs))
    return found[0] if found is not None else None


def _describe(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"[:400]


class Leader:
    """The leader's half (``ServingRuntime(specs=)`` builds it): the tier
    sets the followers mirror, numbered in the order both sides register
    them.  ``channel``: a slice's (:meth:`SliceLayout.channel`); a remote
    slice's leader runs no tier itself and returns the answering rank's
    rows."""

    def __init__(self, specs, channel: Optional[_Channel] = None):
        self.channel = channel if channel is not None else _Channel(
            _ranks(specs))
        self.remote = self.channel.answer is not None
        self.n_sets = 0

    def _run(self, cmd, local: Callable[[], Any]):
        """Send ``cmd``, run ``local()`` here (a remote slice: nowhere)
        once every follower is ready to run it too, then collect the
        outcomes: this rank's exception is raised, else a follower's."""
        self.channel.command(cmd)
        out = err = None
        if self.channel.agree(True) and not self.remote:
            try:
                out = local()
            except Exception as e:      # noqa: BLE001 - re-raised below
                err = e
        got = self.channel.outcomes(None if err is None else _describe(err))
        if err is not None:
            raise err
        bad = [(r, e) for r, (e, _) in zip(self.channel.ranks, got) if e]
        if bad:
            raise FollowerFailed("; ".join(f"rank {r}: {e}" for r, e in bad))
        if self.remote:
            return got[self.channel.ranks.index(self.channel.answer)][1]
        return out

    def register(self, tiers: Sequence, handle: Optional[int] = None
                 ) -> List:
        """The tiers with each forward announced to the followers first
        (as set ``handle``, by default the followers' next)."""
        import dataclasses

        if handle is None:
            handle = self.n_sets
            self.n_sets += 1

        def wrap(i, forward):
            def run(batch):
                return self._run(("run", handle, i, batch),
                                 lambda: forward(batch))
            return run

        return [dataclasses.replace(t, forward=wrap(i, t.forward))
                for i, t in enumerate(tiers)]

    def builder(self, model: str, build: Callable,
                template: Optional[Sequence] = None) -> Callable:
        """``weights_to_tiers`` whose every call is mirrored: the state
        goes to the followers (as host tensors), each builds its tiers
        from it, and the tiers come back registered (a remote slice's:
        ``template``'s names and speeds, run there)."""
        def weights_to_tiers(state, rid):
            handle = self.n_sets          # the followers' next, built or not
            self.n_sets += 1
            tiers = self._run(("build", model, rid, _cpu(state)),
                              lambda: list(build(state, rid)))
            return self.register(list(template) if self.remote else tiers,
                                 handle)
        return weights_to_tiers

    def stop(self) -> None:
        self.channel.command(("stop",))


def _prepare(cmd, sets: List, builders: Dict[str, Callable], device
             ) -> Callable[[], None]:
    """What a follower runs for ``cmd`` (the rung looked up, a hot swap's
    state moved to ``device``): every failure that can come before a
    tier's collectives comes here, before the ranks agree to run."""
    if cmd[0] == "run":
        _, handle, i, batch = cmd
        forward = sets[handle][i]
        return lambda: forward(batch)
    if cmd[0] == "build":
        _, model, rid, state = cmd
        slot = len(sets)
        sets.append(None)           # the leader numbers it, built or not
        build = builders[model]
        if device is not None:
            state = _to(state, device)

        def run():
            sets[slot] = [t.forward for t in build(state, rid)]
        return run
    raise ValueError(f"unknown command {cmd[0]!r}")


def serve_follower(specs, tiers: Optional[Sequence] = None,
                   models: Optional[Sequence] = None, *, device=None
                   ) -> Dict[str, int]:
    """Serve as a follower rank until the leader's runtime closes.

    ``tiers`` (or ``models``, ``ModelConfig`` s in the leader's order)
    are this rank's copies of what the leader's ``ServingRuntime(specs=
    specs)`` serves, built the same way with the same ``specs``.  Each
    command runs the named rung on the leader's batch, or builds a
    model's tiers from the state of a hot swap (on ``device``, default
    the state's), and reports its outcome; an exception is reported, not
    raised, and the loop goes on.  A control-plane wait longer than
    :data:`TIMEOUT_S` (the leader lost) raises.  Returns the counts of
    runs, builds and failures."""
    if (tiers is None) == (models is None):
        raise ValueError("pass tiers= OR models=")
    found = _LAYOUTS.get(id(specs))
    channel = (found[0].channel(found[1]) if found is not None
               else _Channel(_ranks(specs)))
    answers = channel.answer == dist.get_rank()
    if models is None:
        sets: List[Optional[List[Callable]]] = [
            [t.forward for t in tiers]]
        builders: Dict[str, Callable] = {}
    else:
        sets = [[t.forward for t in cfg.tiers] for cfg in models]
        builders = {cfg.name: cfg.weights_to_tiers for cfg in models}
    counts = {"run": 0, "build": 0, "failed": 0}
    while True:
        cmd = channel.command()
        if cmd[0] == "stop":
            return counts
        if cmd[0] in counts:
            counts[cmd[0]] += 1
        err = job = out = None
        try:
            job = _prepare(cmd, sets, builders, device)
        except Exception as e:          # noqa: BLE001 - reported
            err = _describe(e)
        if channel.agree(err is None) and job is not None:
            try:
                out = job()
            except Exception as e:      # noqa: BLE001 - reported
                err = _describe(e)
        if err is not None:
            counts["failed"] += 1
        channel.outcomes(err, _cpu(out) if answers and err is None
                         and cmd[0] == "run" else None)
