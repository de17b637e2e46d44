"""Sequence (context) parallelism over ``torch.distributed`` (counterpart
of ``parallel/sequence.py``): the time axis T cut over the mesh's
``sequence`` axis, one block a rank, blocks exchanged between ranks.

The reference runs each function's body inside ``shard_map`` and moves
blocks with ``lax.ppermute``.  The port runs one process per rank, so a
body is called with this rank's block and a process group, and every
exchange is one collective: :func:`exchange` over
``dist.all_to_all_single`` with a split size for each peer (0 where this
rank sends or receives nothing).  :func:`ppermute`, :func:`all_to_all`,
:func:`halo_exchange`, :func:`ring_shift` and the pipelined scans are all
built on it, so every rank of the group calls the same collectives in
the same order, forward and backward.  A rank that receives nothing gets
zeros, as ``lax.ppermute`` gives them.  A group of ``None`` is one rank.

- :func:`ppermute` / :func:`all_to_all` — differentiable: the backward of
  a permutation is the inverse permutation, of an all-to-all the
  transposed all-to-all;
- :func:`shard_sequence` / :func:`unshard_sequence` — a rank's T-block of
  a batch, and the blocks gathered back along T (the gather's backward
  hands each rank its own block's cotangent);
- :func:`halo_exchange` — neighbours' edge frames around a block (zeros
  at the ends: a VALID convolution on the result is the SAME one);
- :func:`sequence_scan_local`, :func:`sequence_scan_local_bidir` and
  :func:`sequence_sharded_scan` — the exact n-round pipelined chunk scan;
  a rank runs its chunk only in its own round (the rounds' exchanges run
  on every rank), and the backward runs the rounds in reverse;
- :func:`ring_attention` (blocks in, block out), :func:`full_attention`
  and :class:`RingAttentionLayer` (a model's ``attention_fn``: its
  ``block`` entry takes this rank's q/k/v blocks, as a model on T-blocks
  calls it; called on whole q/k/v it keeps the rank's block and gathers
  the output).

Values that every rank holds whole (a replicated weight, a replicated
activation) and that each rank uses for its own part carry the
convention of the reference's ``shard_map`` transpose: their gradient is
the sum of the ranks' parts, on every rank (:func:`summed_grads`,
:func:`summed_parameters`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from analytics_zoo_tpu_torch.parallel.mesh import (SEQUENCE_AXIS,
                                                   axis_group, axis_index,
                                                   axis_names, axis_size,
                                                   row_block)
from analytics_zoo_tpu_torch.utils.spmd import all_reduce_sum

NEG_INF = -1e30


def sequence_groups(mesh, axis_name: str = SEQUENCE_AXIS,
                    batch_axis: Optional[str] = None):
    """``(sequence group, batch group)`` of this rank: the line of
    ``axis_name`` a time-sharded forward exchanges over, and the line of
    ``batch_axis`` its statistics also sum over (``None`` for an absent
    or one-rank axis)."""
    if axis_name not in axis_names(mesh):
        raise ValueError(f"the mesh {axis_names(mesh)} has no "
                         f"{axis_name!r} axis")
    return (axis_group(mesh, axis_name),
            None if batch_axis is None else axis_group(mesh, batch_axis))


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# ---------------------------------------------------------------------------
# The one collective
# ---------------------------------------------------------------------------


def exchange(group, items: Sequence[Tuple[torch.Tensor, Optional[int],
                                          Optional[int]]]
             ) -> List[torch.Tensor]:
    """Send each ``x`` of ``items = [(x, dst, src), ...]`` to group rank
    ``dst`` and receive a tensor of ``x``'s shape from group rank ``src``
    (``None``: send, or receive, nothing; a receive from nothing is
    zeros), all in ONE ``dist.all_to_all_single`` that every rank of the
    group calls.  Item ``i`` that rank ``j`` sends to this rank is this
    rank's item ``i`` received from ``j``.  Returns the received tensors,
    in item order."""
    n = group_size(group)
    if n == 1:
        return [x.clone() if dst == 0 and src == 0 else torch.zeros_like(x)
                for x, dst, src in items]
    dtype = items[0][0].dtype
    send_parts: List[List[torch.Tensor]] = [[] for _ in range(n)]
    recv_sizes = [0] * n
    for x, dst, src in items:
        if x.dtype != dtype:
            raise ValueError(f"exchange: items of {dtype} and {x.dtype}")
        if dst is not None:
            send_parts[dst].append(x.reshape(-1))
        if src is not None:
            recv_sizes[src] += x.numel()
    send_sizes = [sum(p.numel() for p in parts) for parts in send_parts]
    flat = [p for parts in send_parts for p in parts]
    ref = items[0][0]
    send = (torch.cat(flat) if flat else ref.new_empty(0)).contiguous()
    recv = ref.new_empty(sum(recv_sizes))
    dist.all_to_all_single(recv, send, recv_sizes, send_sizes, group=group)
    offsets = np.concatenate([[0], np.cumsum(recv_sizes)]).tolist()
    taken = [0] * n
    out = []
    for x, dst, src in items:
        if src is None:
            out.append(torch.zeros_like(x))
            continue
        start = offsets[src] + taken[src]
        taken[src] += x.numel()
        out.append(recv[start:start + x.numel()].view(x.shape))
    return out


class _Exchange(torch.autograd.Function):
    """:func:`exchange` under autograd: the backward sends each received
    tensor's cotangent back to its sender (the routes reversed), again in
    one collective."""

    @staticmethod
    def forward(ctx, group, routes, *xs):
        ctx.group, ctx.routes = group, routes
        return tuple(exchange(group, [(x, d, s) for x, (d, s)
                                      in zip(xs, routes)]))

    @staticmethod
    def backward(ctx, *gs):
        back = exchange(ctx.group, [(g.contiguous(), s, d) for g, (d, s)
                                    in zip(gs, ctx.routes)])
        return (None, None) + tuple(back)


def _exchange_ad(group, items):
    xs = [x for x, _, _ in items]
    routes = tuple((d, s) for _, d, s in items)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(_Exchange.apply(group, routes, *xs))
    return exchange(group, items)


def _routes(perm, me: int):
    dst = dict(perm).get(me)
    src = {d: s for s, d in perm}.get(me)
    return dst, src


def ppermute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` is ``[(src, dst), ...]`` over group
    ranks; a rank no pair sends to receives zeros.  Differentiable (the
    backward permutes the cotangent by the inverse pairs)."""
    dst, src = _routes(perm, group_rank(group))
    return _exchange_ad(group, [(x, dst, src)])[0]


def all_to_all(x: torch.Tensor, group, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: ``x`` cut into ``n`` equal parts
    along ``split_axis``, part ``j`` sent to rank ``j``, the parts
    received concatenated along ``concat_axis`` in sender order.
    Differentiable (the backward is the transposed all-to-all)."""
    n = group_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size "
                         f"{x.shape[split_axis]} not divisible by {n} ranks")
    parts = [p.contiguous() for p in torch.chunk(x, n, split_axis)]
    got = _exchange_ad(group, [(p, j, j) for j, p in enumerate(parts)])
    return torch.cat(got, concat_axis)


# ---------------------------------------------------------------------------
# Blocks of T, sums, shifts
# ---------------------------------------------------------------------------


def shard_sequence(x, mesh, axis_name: str = SEQUENCE_AXIS,
                   time_axis: int = 1):
    """This rank's block of ``x`` (a host array or a tensor; T divisible
    by the axis) along ``time_axis``: the T-slice the reference places on
    the rank's device."""
    n = axis_size(mesh, axis_name)
    idx = axis_index(mesh, axis_name)
    T = x.shape[time_axis]
    if T % n:
        raise ValueError(f"T={T} not divisible by the {n} ranks of "
                         f"{axis_name!r}")
    tb = T // n
    if isinstance(x, torch.Tensor):
        return x.narrow(time_axis, idx * tb, tb)
    return np.take(x, np.arange(idx * tb, (idx + 1) * tb), axis=time_axis)


def _all_gather_cat(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """The group's blocks ``x`` concatenated along ``axis`` in rank order
    (one ``all_gather_into_tensor``)."""
    x = x.contiguous()
    n = group_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), axis)


class _GatherBlocks(torch.autograd.Function):
    """The ranks' blocks concatenated along ``axis``; the backward hands
    each rank its own block of the cotangent (every rank computes the
    same function of the whole, so the whole cotangent is on each)."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.axis, ctx.me, ctx.size = axis, group_rank(group), x.shape[axis]
        return _all_gather_cat(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.axis, ctx.me * ctx.size, ctx.size), None, None


def gather_blocks(x: torch.Tensor, group, axis: int = 1) -> torch.Tensor:
    """Every rank's block of ``x`` along ``axis``, in rank order."""
    return x if group is None else _GatherBlocks.apply(x, group, axis)


def unshard_sequence(x: torch.Tensor, mesh=None,
                     axis_name: str = SEQUENCE_AXIS,
                     time_axis: int = 1) -> torch.Tensor:
    """The T-blocks of the axis gathered back into the whole sequence
    (differentiable: the backward is this rank's block of the cotangent).
    Without a mesh (or a one-rank axis), ``x`` itself."""
    group = None if mesh is None else axis_group(mesh, axis_name)
    return gather_blocks(x, group, time_axis)


class _TakeBlock(torch.autograd.Function):
    """This rank's block of a tensor every rank holds whole; the backward
    gathers the ranks' block cotangents into the whole one."""

    @staticmethod
    def forward(ctx, x, group, axis):
        n, me = group_size(group), group_rank(group)
        size = x.shape[axis] // n
        ctx.group, ctx.axis = group, axis
        return x.narrow(axis, me * size, size).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_cat(g, ctx.group, ctx.axis), None, None


def take_block(x: torch.Tensor, group, axis: int = 1) -> torch.Tensor:
    """This rank's block along ``axis`` of a replicated ``x``; its
    gradient is whole on every rank."""
    if group is None:
        return x
    if x.shape[axis] % group_size(group):
        raise ValueError(f"dim {axis} of size {x.shape[axis]} not divisible "
                         f"by {group_size(group)} ranks")
    return _TakeBlock.apply(x, group, axis)


class _SummedGrads(torch.autograd.Function):
    """Identity forward; backward: the cotangents summed over the group
    in one flat all-reduce (replicated values that each rank used for its
    own part)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1).float() for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        out, i = [], 0
        for g in gs:
            out.append(flat[i:i + g.numel()].view_as(g).to(g.dtype))
            i += g.numel()
        return (None,) + tuple(out)


def summed_grads(tensors: Sequence[torch.Tensor], group
                 ) -> List[torch.Tensor]:
    """``tensors`` unchanged, their gradients summed over ``group``: the
    reference's transpose of a replicated ``shard_map`` input."""
    tensors = list(tensors)
    if group is None or not torch.is_grad_enabled() or not any(
            t.requires_grad for t in tensors):
        return tensors
    return list(_SummedGrads.apply(group, *tensors))


def summed_parameters(module: torch.nn.Module, group,
                      skip: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """``module``'s parameters by name (less those of the children named
    in ``skip``), their gradients summed over ``group`` in one
    all-reduce: the weights of a forward that each rank runs on its own
    block of the tokens."""
    named = [(k, t) for k, t in module.named_parameters()
             if k.split(".", 1)[0] not in skip]
    return dict(zip([k for k, _ in named],
                    summed_grads([t for _, t in named], group)))


class _ReplicatedSum(torch.autograd.Function):
    """Sum over the group whose result every rank uses whole: the
    backward hands each rank's term the (whole, identical) cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicated_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``psum`` of the ranks' terms into a value each rank then uses
    whole (the GPipe broadcast of the last stage's outputs)."""
    return x if group is None else _ReplicatedSum.apply(x, group)


def psum_mean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean across the group's ranks (gradient/metric reduction helper;
    the backward of the sum sums the ranks' cotangents)."""
    return all_reduce_sum(x, group) / group_size(group)


def ring_shift(x, group, shift: int = 1):
    """Rotate a block (or a tuple of blocks, in one exchange) ``shift``
    hops around the ring."""
    n, me = group_size(group), group_rank(group)
    xs = x if isinstance(x, (tuple, list)) else (x,)
    dst, src = (me + shift) % n, (me - shift) % n
    got = _exchange_ad(group, [(t, dst, src) for t in xs])
    return tuple(got) if isinstance(x, (tuple, list)) else got[0]


def halo_exchange(x: torch.Tensor, group, left: int, right: int,
                  time_axis: int = 1) -> torch.Tensor:
    """This rank's block extended by the last ``left`` frames of its left
    neighbour and the first ``right`` of its right one (non-wrapping: the
    end ranks get zeros, the global zero padding), both in one exchange.
    A VALID convolution on the result reproduces the unsharded SAME
    one."""
    n, me = group_size(group), group_rank(group)
    items = []
    if left:
        edge = x.narrow(time_axis, x.shape[time_axis] - left, left)
        items.append((edge.contiguous(), me + 1 if me + 1 < n else None,
                      me - 1 if me > 0 else None))
    if right:
        edge = x.narrow(time_axis, 0, right)
        items.append((edge.contiguous(), me - 1 if me > 0 else None,
                      me + 1 if me + 1 < n else None))
    got = _exchange_ad(group, items) if items else []
    parts = ([got[0]] if left else []) + [x] + ([got[-1]] if right else [])
    return torch.cat(parts, time_axis)


# ---------------------------------------------------------------------------
# Rows of an image over a group (spatial partitioning)
# ---------------------------------------------------------------------------


def row_blocks(height: int, n: int) -> List[Tuple[int, int]]:
    """The row partition of a ``height``-row activation over ``n`` ranks,
    ``mesh.row_block`` of each: uneven, and empty where ``height < n``."""
    return [row_block(height, n, r) for r in range(n)]


def fetch_rows(x: torch.Tensor, group, parts: Sequence[Tuple[int, int]],
               wants: Sequence[Tuple[int, int]], fill: float = 0.0,
               axis: int = 2) -> torch.Tensor:
    """Global rows ``[lo, hi)`` = ``wants[me]`` of an activation held by
    rows over ``group``: ``parts[r]`` is the block rank ``r`` holds
    (``x`` is this rank's, along ``axis``) and ``wants[r]`` the range
    rank ``r`` asks for (any width: a halo may reach past a neighbour,
    or an empty range ask for nothing).  Rows outside ``[0, height)``
    are ``fill`` (0 under a convolution, ``-inf`` under a max pool).
    Every rank calls it with the same ``parts`` and ``wants``; the rows
    move in one :func:`exchange` (differentiable: a received row's
    cotangent goes back to its owner)."""
    n, me = group_size(group), group_rank(group)
    a, b = parts[me]
    lo, hi = wants[me]
    height = parts[-1][1]
    items = [(x.narrow(axis, 0, 0), None, None)]   # an exchange of nothing
    recv_at = {}
    for p in range(n):
        if p == me:
            continue
        s, e = max(a, wants[p][0]), min(b, wants[p][1])
        if e > s:
            items.append((x.narrow(axis, s - a, e - s).contiguous(), p, None))
    for p in range(n):
        s, e = max(parts[p][0], lo), min(parts[p][1], hi)
        if p != me and e > s:
            shape = list(x.shape)
            shape[axis] = e - s
            recv_at[p] = len(items)
            items.append((x.new_empty(shape), None, p))
    # every rank reads the same parts and wants: all skip, or all call
    moves = any(max(parts[q][0], wants[p][0]) < min(parts[q][1], wants[p][1])
                for p in range(n) for q in range(n) if p != q)
    got = _exchange_ad(group, items) if moves else None

    def filled(rows):
        shape = list(x.shape)
        shape[axis] = rows
        return torch.full(shape, fill, dtype=x.dtype, device=x.device)

    # the exchange's output of nothing joins the result on every rank, so
    # that a rank which only sends still runs the exchange's backward
    pieces = [got[0]] if moves else []
    if lo < min(0, hi):
        pieces.append(filled(min(0, hi) - lo))
    for p in range(n):
        s, e = max(parts[p][0], lo), min(parts[p][1], hi)
        if e <= s:
            continue
        pieces.append(x.narrow(axis, s - a, e - s) if p == me
                      else got[recv_at[p]])
    if hi > max(height, lo):
        pieces.append(filled(hi - max(height, lo)))
    return torch.cat(pieces, axis) if pieces else x.narrow(axis, 0, 0)


class _GatherRows(torch.autograd.Function):
    """The ranks' row blocks (uneven, maybe empty) concatenated along
    ``axis`` in rank order; the backward hands each rank its own block
    of the (whole, identical) cotangent."""

    @staticmethod
    def forward(ctx, x, group, parts, axis):
        n, me = group_size(group), group_rank(group)
        ctx.axis, ctx.block = axis, parts[me]
        m = max(e - s for s, e in parts)
        pad = list(x.shape)
        pad[axis] = m - x.shape[axis]
        xp = torch.cat([x, x.new_zeros(pad)], axis) if pad[axis] else x
        whole = _all_gather_cat(xp.movedim(axis, 0), group, 0)
        out = [whole.narrow(0, p * m, e - s) for p, (s, e) in enumerate(parts)]
        return torch.cat(out, 0).movedim(0, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        s, e = ctx.block
        return g.narrow(ctx.axis, s, e - s), None, None, None


def gather_rows(x: torch.Tensor, group, parts: Sequence[Tuple[int, int]],
                axis: int = 2) -> torch.Tensor:
    """The whole activation from the ranks' row blocks ``parts`` (every
    rank then uses it whole: each gets its own block's cotangent)."""
    if group is None:
        return x
    return _GatherRows.apply(x, group, tuple(parts), axis)


# ---------------------------------------------------------------------------
# Pipelined chunk scans
# ---------------------------------------------------------------------------


def _step_chunk(step_fn: Callable) -> Callable:
    """A per-step ``step_fn(h, x_t) → (h', y_t)`` as a chunk function
    ``(h, xs (B, Tb, D)) → (h_final, ys (B, Tb, H))``, in time order."""
    def chunk(h, xs):
        ys = []
        for t in range(xs.shape[1]):
            h, y = step_fn(h, xs[:, t])
            ys.append(y)
        return h, torch.stack(ys, 1)
    return chunk


class _RoundScan(torch.autograd.Function):
    """The n-round schedule of one or more chunk scans (a BiRNN layer's
    two directions share the rounds).  Direction ``d`` runs its chunk
    function on this rank's block in round ``eff`` (the rank's place in
    that direction's pipeline) from the carry received in round
    ``eff − 1``; in every other round it passes the carry it holds on
    unchanged.  Each round ends with one exchange of every direction's
    carry, on every rank.  The chunk's autograd graph is kept from its
    round; the backward runs the rounds in reverse, the carries'
    cotangents hopping back one rank a round, and differentiates each
    chunk once, in its own round.  The chunk functions read their
    parameters by closure; ``params`` are the same tensors, passed so
    that their gradients leave through this node."""

    @staticmethod
    def forward(ctx, plan, h0, x, *params):
        chunks, group, grad = plan
        n, me = group_size(group), group_rank(group)
        effs = [n - 1 - me if rev else me for _, rev in chunks]
        hs = [h0] * len(chunks)
        outs = [None] * len(chunks)
        graphs = [None] * len(chunks)
        for r in range(n):
            sends = []
            for d, (fn, rev) in enumerate(chunks):
                if effs[d] == r:
                    with torch.enable_grad() if grad else torch.no_grad():
                        h_in = hs[d].detach().requires_grad_(grad)
                        x_in = x.detach().requires_grad_(grad)
                        h_fin, ys = fn(h_in, x_in.flip(1) if rev else x_in)
                        ys = ys.flip(1) if rev else ys
                    graphs[d] = (h_in, x_in, h_fin, ys)
                    outs[d] = ys.detach()
                    sends.append(h_fin.detach())
                else:
                    sends.append(hs[d])
            got = exchange(group, [
                (h, _hop(me, n, rev)[0], _hop(me, n, rev)[1])
                for h, (_, rev) in zip(sends, chunks)])
            hs = [h0 if effs[d] == 0 else got[d] for d in range(len(chunks))]
        ctx.plan, ctx.graphs, ctx.effs = plan, graphs, effs
        ctx.params = params
        return tuple(outs)

    @staticmethod
    def backward(ctx, *g_ys):
        chunks, group, _ = ctx.plan
        n, me = group_size(group), group_rank(group)
        params = ctx.params
        D = len(chunks)
        g_h = [None] * D               # cotangent of the carry held after r
        g_h0 = None
        g_x = None
        g_p = [None] * len(params)
        for r in reversed(range(n)):
            g_recv = []
            for d in range(D):
                g = g_h[d]
                if ctx.effs[d] == 0 and g is not None:
                    g_h0 = g if g_h0 is None else g_h0 + g
                    g = None
                g_recv.append(g)
            like = [ctx.graphs[d][0] for d in range(D)]
            back = exchange(group, [
                ((g if g is not None else torch.zeros_like(h)).contiguous(),
                 _hop(me, n, rev)[1], _hop(me, n, rev)[0])
                for g, h, (_, rev) in zip(g_recv, like, chunks)])
            for d in range(D):
                if ctx.effs[d] != r:
                    g_h[d] = back[d]
                    continue
                h_in, x_in, h_fin, ys = ctx.graphs[d]
                want = [h_in, x_in] + [p for p in params if p.requires_grad]
                got = torch.autograd.grad(
                    (h_fin, ys), want, (back[d], g_ys[d]),
                    allow_unused=True)
                g_h[d] = got[0]
                g_x = _acc(g_x, got[1])
                it = iter(got[2:])
                g_p = [_acc(gp, next(it)) if p.requires_grad else gp
                       for gp, p in zip(g_p, params)]
        for d in range(D):
            if g_h[d] is not None:
                g_h0 = _acc(g_h0, g_h[d])
        ctx.graphs = None
        return (None, g_h0, g_x) + tuple(g_p)


def _acc(a, b):
    if b is None:
        return a
    return b if a is None else a + b


def _hop(me: int, n: int, reverse: bool) -> Tuple[Optional[int],
                                                  Optional[int]]:
    """(dst, src) of a carry's hop: forward pipelines pass to the next
    rank, reverse ones to the previous; the ends send or receive
    nothing."""
    nxt = me + 1 if me + 1 < n else None
    prv = me - 1 if me > 0 else None
    return (prv, nxt) if reverse else (nxt, prv)


def pipelined_scans(chunks: Sequence[Tuple[Callable, bool]], h0, x, group,
                    params: Sequence[torch.Tensor] = ()):
    """Run each ``(chunk_fn, reverse)`` of ``chunks`` over the T-sharded
    sequence whose block ``x`` (B, Tb, D) this rank holds, all in one
    n-round schedule; returns each direction's (B, Tb, H) block.  The
    chunk functions take ``(h, xs)`` in their own time order (a reverse
    direction gets its block flipped) and return ``(h_final, ys)``.
    ``params``: the tensors they read that need gradients."""
    params = tuple(params)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (h0, x) + params)
    return list(_RoundScan.apply((tuple(chunks), group, grad), h0, x,
                                 *params))


def sequence_scan_local(step_fn: Callable, h0_l, x_l, group,
                        reverse: bool = False, params=()):
    """Per-rank body of :func:`sequence_sharded_scan`: ``x_l`` is this
    rank's (B, Tb, D) chunk, ``h0_l`` (B, H)."""
    return pipelined_scans([(_step_chunk(step_fn), reverse)], h0_l, x_l,
                           group, params)[0]


def sequence_scan_local_bidir(step_fwd: Callable, step_bwd: Callable,
                              h0_l, x_l, group, params=()):
    """Fused bidirectional pipelined scan: both directions share the same
    n rounds (two opposite pipelines, one exchange a round).  Returns
    ``(ys_fwd, ys_bwd)``, each (B, Tb, H)."""
    f, b = pipelined_scans([(_step_chunk(step_fwd), False),
                            (_step_chunk(step_bwd), True)], h0_l, x_l,
                           group, params)
    return f, b


def sequence_sharded_scan(step_fn: Callable, h0, xs, mesh,
                          axis_name: str = SEQUENCE_AXIS,
                          reverse: bool = False,
                          batch_axis: Optional[str] = None, params=()):
    """Exact RNN scan over a T-sharded sequence: ``xs`` is this rank's
    (B, Tb, D) block (its rows of a ``batch_axis``), ``h0`` (B, H),
    ``step_fn(h, x_t) → (h', y_t)``.  Returns this rank's (B, Tb, H)
    block.  n rounds: rank k's chunk runs in round k from the chained
    boundary state of its predecessors; wall-clock equals the unsharded
    scan, activation memory per rank is O(T/n)."""
    if batch_axis is not None and batch_axis not in axis_names(mesh):
        raise ValueError(f"batch_axis {batch_axis!r} is not an axis of "
                         f"the mesh {axis_names(mesh)}")
    return sequence_scan_local(step_fn, h0, xs,
                               axis_group(mesh, axis_name), reverse, params)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _ring_forward(q, k, v, group, causal: bool, scale: float):
    """The online softmax over the ring on this rank's (B, Tb, H, D)
    q/k/v blocks: K/V rotate one hop a round, n − 1 rotations (the
    reference's last rotation is discarded).  Returns the output block
    and the rows' log-sum-exp (B, H, Tb) in fp32."""
    B, Tb, H, D = q.shape
    n, me = group_size(group), group_rank(group)
    o = q.new_zeros((B, H, Tb, D))
    l = q.new_zeros((B, H, Tb), dtype=torch.float32)
    m = q.new_full((B, H, Tb), NEG_INF, dtype=torch.float32)
    ar = torch.arange(Tb, device=q.device)
    q_pos = me * Tb + ar
    k_cur, v_cur = k, v
    for r in range(n):
        src = (me - r) % n
        scores = (torch.einsum("bqhd,bkhd->bhqk", q, k_cur) * scale).float()
        if causal:
            mask = q_pos[:, None] >= (src * Tb + ar)[None, :]
            scores = torch.where(mask[None, None], scores,
                                 scores.new_tensor(NEG_INF))
        new_m = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - new_m[..., None])
        p = torch.where(new_m[..., None] > NEG_INF / 2, p, p.new_zeros(()))
        corr = torch.where(m > NEG_INF / 2, torch.exp(m - new_m),
                           m.new_zeros(()))
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v_cur.dtype), v_cur)
        o = o * corr[..., None].to(o.dtype) + pv
        m = new_m
        if r < n - 1:
            k_cur, v_cur = ring_shift((k_cur, v_cur), group)
    l = torch.clamp(l, min=1e-20)
    out = o / l[..., None].to(o.dtype)
    return out.permute(0, 2, 1, 3), m + torch.log(l)


class _RingAttention(torch.autograd.Function):
    """Ring attention on this rank's blocks, saving only q, k, v, the
    output and the rows' log-sum-exp: the backward recomputes each
    round's probabilities from them, K/V and their gradients' partial
    sums rotating round the ring (n − 1 hops, then one more that brings
    each rank's dK/dV home)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        out, lse = _ring_forward(q, k, v, group, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n, me = group_size(group), group_rank(group)
        Tb = q.shape[1]
        ar = torch.arange(Tb, device=q.device)
        q_pos = me * Tb + ar
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1)
        dq = torch.zeros_like(q)
        k_cur, v_cur = k, v
        dk_cur, dv_cur = torch.zeros_like(k), torch.zeros_like(v)
        for r in range(n):
            src = (me - r) % n
            s = torch.einsum("bqhd,bkhd->bhqk", q, k_cur).float() * scale
            if ctx.causal:
                mask = q_pos[:, None] >= (src * Tb + ar)[None, :]
                s = torch.where(mask[None, None], s, s.new_tensor(NEG_INF))
            p = torch.exp(s - lse[..., None])
            dv_cur = dv_cur + torch.einsum("bhqk,bqhd->bkhd",
                                           p.to(g.dtype), g)
            dp = torch.einsum("bqhd,bkhd->bhqk", g, v_cur).float()
            ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_cur)
            dk_cur = dk_cur + torch.einsum("bhqk,bqhd->bkhd", ds, q)
            if r < n - 1:
                k_cur, v_cur, dk_cur, dv_cur = ring_shift(
                    (k_cur, v_cur, dk_cur, dv_cur), group)
        dk, dv = ring_shift((dk_cur, dv_cur), group)
        return dq, dk, dv, None, None, None


def _ring_attention_local(q, k, v, group, causal: bool,
                          scale: Optional[float]):
    """Per-rank body: q/k/v are this rank's (B, Tb, H, D) blocks."""
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingAttention.apply(q, k, v, group, causal, scale)
    return _ring_forward(q, k, v, group, causal, scale)[0]


def ring_attention(q, k, v, mesh, axis_name: str = SEQUENCE_AXIS,
                   causal: bool = False, scale: Optional[float] = None):
    """Sequence-parallel attention: q, k, v are this rank's (B, Tb, H, D)
    blocks of a T-sharded batch (:func:`shard_sequence`); returns this
    rank's (B, Tb, H, D) output block.  Causal masking uses the blocks'
    global offsets."""
    return _ring_attention_local(q, k, v, axis_group(mesh, axis_name),
                                 causal, scale)


def full_attention(q, k, v, causal: bool = False,
                   scale: Optional[float] = None):
    """One-rank attention over (B, T, H, D) (the reference for tests and
    small T)."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        Tq, Tk = scores.shape[-2], scores.shape[-1]
        mask = (torch.arange(Tq, device=q.device)[:, None]
                >= torch.arange(Tk, device=q.device)[None, :])
        scores = torch.where(mask[None, None], scores,
                             scores.new_tensor(NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class RingAttentionLayer:
    """A model's ``attention_fn`` over the ring.  A model whose layers
    hold this rank's T-block (``models.attention.LongContextEncoder``
    and ``AttentionASR`` over an axis of more than one rank) calls
    :meth:`block` with its (B, T/n, H, D) q/k/v blocks and gets its
    output block.  Called with whole (B, T, H, D) q/k/v (every rank of
    the axis holds them), as the reference's layer is, it keeps this
    rank's block, runs the ring and gathers the output blocks back; the
    q/k/v gradients then come back whole on every rank."""

    def __init__(self, mesh, axis_name: str = SEQUENCE_AXIS,
                 causal: bool = False):
        self.mesh = mesh
        self.axis_name = axis_name
        self.causal = causal

    @property
    def group(self):
        """The axis' process group (``None``: one rank, no ring)."""
        return axis_group(self.mesh, self.axis_name)

    def block(self, q, k, v):
        """This rank's q/k/v blocks in, its output block out: causal
        masking at the blocks' global offsets."""
        group = self.group
        if group is None:
            return full_attention(q, k, v, self.causal)
        return _ring_attention_local(q, k, v, group, self.causal, None)

    def __call__(self, q, k, v):
        group = self.group
        if group is None:
            return full_attention(q, k, v, self.causal)
        qkv = take_block(torch.stack((q, k, v)), group, axis=2)
        return gather_blocks(self.block(qkv[0], qkv[1], qkv[2]), group,
                             axis=1)


def sequence_group_of(attention_fn):
    """The group over which ``attention_fn`` runs a ring (a
    :class:`RingAttentionLayer` over an axis of more than one rank), else
    ``None``.  With a group, a model built on it holds its activations
    by T-block between its entry and its exit."""
    if isinstance(attention_fn, RingAttentionLayer):
        return attention_fn.group
    return None
