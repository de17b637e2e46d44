"""Expert (MoE) parallelism over ``torch.distributed`` (counterpart of
``parallel/expert.py``): switch-style top-1 routing with a static
capacity, one expert a rank along the mesh's ``expert`` axis, tokens
moved by ``parallel.sequence.all_to_all``.

Both paths share :func:`route_top1` (argmax gate, each token's slot in
its expert's bucket counted in int32, tokens past the capacity dropped
to zeros, the output scaled by the chosen gate probability):

- :func:`moe_apply_dense` — one rank: dispatch and combine as einsums
  against the (N, E, C) dispatch tensor, the experts applied in turn;
- :func:`moe_apply_expert_parallel` — this rank's tokens are packed into
  per-expert buckets, one all-to-all ships bucket e to rank e, the
  rank's expert runs once on every sender's bucket, a second all-to-all
  ships the results back.  The capacity applies to each (sender, expert)
  pair.  The stacked expert parameters and the gate kernel are whole on
  every rank (each uses its expert's row); their gradients are summed
  over the axis, as the reference's ``shard_map`` transposes them.

Inside a model whose layers hold this rank's T-block of a (B, T) batch
(ring attention over the ``sequence`` axis) the tokens are routed as the
reference routes the whole batch:

- :func:`moe_apply_dense_blocks` — every token takes the slot it has in
  the (b, t) order of all B·T tokens at the global capacity (one
  all-gather of the ranks' per-row expert counts gives the tokens held
  elsewhere that come before it), and the experts run on the rank;
- :func:`moe_apply_expert_blocks` — one exchange re-lays the rank's
  block into the reference's sender partition (contiguous B·T/n tokens
  in (b, t) order), the expert-parallel body runs on it, and a second
  exchange lays the outputs back.

There the model's block forward has already summed every parameter's
gradient over the axis, so these two sum nothing.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from analytics_zoo_tpu_torch.parallel.mesh import (EXPERT_AXIS, axis_group,
                                                   axis_size)
from analytics_zoo_tpu_torch.parallel.pipeline import (tree_leaves,
                                                       tree_skeleton,
                                                       tree_unflatten)
from analytics_zoo_tpu_torch.parallel.sequence import (_exchange_ad,
                                                       all_to_all,
                                                       gather_blocks,
                                                       group_rank,
                                                       group_size,
                                                       summed_grads,
                                                       take_block)


def route_top1(x: torch.Tensor, gate_kernel: torch.Tensor, capacity: int,
               earlier: Optional[Callable[[torch.Tensor], torch.Tensor]]
               = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 routing: ``(dispatch (N, E, C) 0/1 in x's dtype, scale
    (N,))``.  ``dispatch[i, e, c] = 1`` iff token i goes to expert e at
    slot c; a token past its expert's ``capacity`` has an all-zero row
    and scale 0; ``scale[i]`` is its softmax gate probability.

    ``earlier`` (tokens ``x`` that are part of a larger ordered set):
    maps the (N, E) int32 one-hot choices to the (N, E) counts of tokens
    held elsewhere that come before each token; a token is kept when
    those and the earlier tokens of ``x`` that chose its expert are
    fewer than ``capacity``.  Its bucket slot is then its place among
    ``x``'s tokens of that expert, C = min(capacity, N)."""
    logits = x @ gate_kernel                                # (N, E)
    gates = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(gates, dim=-1)                # (N,)
    E = gate_kernel.shape[-1]
    oh_i = torch.nn.functional.one_hot(expert_idx, E).to(torch.int32)
    oh = oh_i.to(x.dtype)
    # slot = earlier tokens that chose the same expert, counted in int32
    # (a bf16 cumsum stops incrementing at 256: duplicate slots)
    pos_i = ((torch.cumsum(oh_i, 0, dtype=torch.int32) - 1) * oh_i).sum(-1)
    slots = capacity
    if earlier is None:
        keep = pos_i < capacity
    else:
        keep = pos_i + (earlier(oh_i) * oh_i).sum(-1) < capacity
        slots = max(1, min(capacity, x.shape[0]))
    slot_oh = (pos_i[:, None] == torch.arange(slots, device=x.device)
               ).to(x.dtype)                                 # (N, C)
    dispatch = (oh[:, :, None] * slot_oh[:, None, :]
                * keep[:, None, None].to(x.dtype))
    scale = (gates * oh).sum(-1) * keep.to(x.dtype)
    return dispatch, scale


def default_capacity(n_tokens: int, n_experts: int,
                     capacity_factor: float = 1.25) -> int:
    return max(1, math.ceil(n_tokens / n_experts * capacity_factor))


def _row(tree, e: int):
    return tree_unflatten(tree_skeleton(tree),
                          [leaf[e] for leaf in tree_leaves(tree)])


def moe_apply_dense(apply_expert: Callable[[Any, torch.Tensor],
                                           torch.Tensor],
                    stacked_params: Any, gate_kernel: torch.Tensor,
                    x: torch.Tensor, capacity: Optional[int] = None,
                    earlier=None) -> torch.Tensor:
    """One-rank path: x (N, D) → (N, D) (``earlier``: as
    :func:`route_top1`'s)."""
    E = gate_kernel.shape[-1]
    n_experts = tree_leaves(stacked_params)[0].shape[0]
    if n_experts != E:
        raise ValueError(f"stacked_params has {n_experts} experts but "
                         f"gate_kernel routes to {E}")
    C = capacity if capacity is not None else default_capacity(x.shape[0], E)
    if C < 1:
        raise ValueError(f"capacity must be >= 1, got {C}")
    dispatch, scale = route_top1(x, gate_kernel, C, earlier)
    xe = torch.einsum("nec,nd->ecd", dispatch, x)           # (E, C, D)
    ye = torch.stack([apply_expert(_row(stacked_params, e), xe[e])
                      for e in range(E)])
    y = torch.einsum("nec,ecd->nd", dispatch, ye)
    return y * scale[:, None]


def moe_apply_expert_parallel(
        apply_expert: Callable[[Any, torch.Tensor], torch.Tensor],
        stacked_params: Any, gate_kernel: torch.Tensor, x: torch.Tensor,
        mesh, axis_name: str = EXPERT_AXIS,
        capacity: Optional[int] = None) -> torch.Tensor:
    """Expert-parallel path: ``E`` equals the ``axis_name`` width, one
    expert a rank; ``x`` (N_local, D) is this rank's tokens, the result
    its (N_local, D) outputs.  The capacity applies to each (sender,
    expert) pair (default: from the local token count), so a dense run
    at the same per-pair capacity routes alike."""
    E = gate_kernel.shape[-1]
    n = axis_size(mesh, axis_name)
    if E != n:
        raise ValueError(f"{E} experts but {axis_name!r} axis has {n} "
                         f"devices — one expert per device required")
    leaves = tree_leaves(stacked_params)
    if leaves[0].shape[0] != E:
        raise ValueError(f"stacked_params has {leaves[0].shape[0]} experts, "
                         f"expected {E}")
    C = capacity if capacity is not None else default_capacity(x.shape[0], E)
    if C < 1:
        raise ValueError(f"capacity must be >= 1, got {C}")
    group = axis_group(mesh, axis_name)
    *leaves, gk = summed_grads(leaves + [gate_kernel], group)
    return _expert_parallel_local(
        apply_expert, tree_unflatten(tree_skeleton(stacked_params), leaves),
        gk, x, group, C)


def _expert_parallel_local(apply_expert, stacked_params, gate_kernel, x,
                           group, C):
    """The expert-parallel body on this rank's tokens ``x`` (N_l, D):
    route, ship bucket e to rank e, run the rank's expert, ship back."""
    n, me = group_size(group), group_rank(group)
    params = tree_unflatten(tree_skeleton(stacked_params),
                            [p[me] for p in tree_leaves(stacked_params)])
    dispatch, scale = route_top1(x, gate_kernel, C)         # (N_l, E, C)
    xe = torch.einsum("nec,nd->ecd", dispatch, x)           # (E, C, D)
    # bucket e to rank e; row j received is sender j's bucket for mine
    recv = all_to_all(xe, group)                            # (n, C, D)
    ye = apply_expert(params, recv.reshape(n * C, -1)).reshape(n, C, -1)
    back = all_to_all(ye, group)                            # (E, C, D)
    y = torch.einsum("nec,ecd->nd", dispatch, back)
    return y * scale[:, None]


def moe_apply_whole(apply_expert: Callable[[Any, torch.Tensor],
                                           torch.Tensor],
                    stacked_params: Any, gate_kernel: torch.Tensor,
                    x: torch.Tensor, mesh, capacity_factor: float = 1.25,
                    axis_name: str = EXPERT_AXIS) -> torch.Tensor:
    """:func:`moe_apply_expert_parallel` for tokens ``x`` (N, D) that
    every rank of the axis holds whole (a model layer's input): each rank
    routes its block of N/n tokens at the per-pair capacity of that
    block, and the output blocks are gathered back whole (the gradient of
    ``x`` whole on every rank)."""
    group = axis_group(mesh, axis_name)
    n = axis_size(mesh, axis_name)
    cap = default_capacity(x.shape[0] // n, gate_kernel.shape[-1],
                           capacity_factor)
    y = moe_apply_expert_parallel(apply_expert, stacked_params, gate_kernel,
                                  take_block(x, group, axis=0), mesh,
                                  axis_name, cap)
    return gather_blocks(y, group, axis=0)


# ---------------------------------------------------------------------------
# Tokens held by T-block (a ring model's layers)
# ---------------------------------------------------------------------------


def _earlier_in_batch(group, B: int, Tb: int):
    """:func:`route_top1`'s ``earlier`` for this rank's (B, Tb) T-block
    of a (B, n·Tb) batch routed in (b, t) order: for row b, the tokens of
    the other ranks' parts of rows before b and of the earlier ranks'
    blocks of row b (one all-gather of every rank's (B, E) counts; this
    rank's own earlier rows are in its local count already)."""
    n, me = group_size(group), group_rank(group)

    def earlier(oh):
        counts = oh.view(B, Tb, -1).sum(1, dtype=torch.int32)   # (B, E)
        every = counts.new_empty((n * B, counts.shape[1]))
        dist.all_gather_into_tensor(every, counts.contiguous(), group=group)
        every = every.view(n, B, -1)
        others = every.sum(0, dtype=torch.int32) - counts
        before = (torch.cumsum(others, 0, dtype=torch.int32) - others
                  + every[:me].sum(0, dtype=torch.int32))
        return before.repeat_interleave(Tb, 0)

    return earlier


def moe_apply_dense_blocks(apply_expert, stacked_params, gate_kernel,
                           x: torch.Tensor, group,
                           capacity_factor: float = 1.25) -> torch.Tensor:
    """The dense path for ``x`` (B, Tb, D), this rank's T-block over
    ``group``: routing, capacity and drops those of
    :func:`moe_apply_dense` on the whole (B·T, D) batch at
    ``default_capacity(B·T, E, capacity_factor)``; the experts (whole on
    every rank) run on the rank's tokens.  Returns its (B, Tb, D) block."""
    B, Tb, D = x.shape
    T = Tb * group_size(group)
    cap = default_capacity(B * T, gate_kernel.shape[-1], capacity_factor)
    y = moe_apply_dense(apply_expert, stacked_params, gate_kernel,
                        x.reshape(B * Tb, D), capacity=cap,
                        earlier=_earlier_in_batch(group, B, Tb))
    return y.reshape(B, Tb, D)


@functools.lru_cache(maxsize=64)
def _partition_plan(B: int, T: int, n: int, me: int):
    """Moving rank ``me``'s T-block (its B·T/n tokens in (b, t) order)
    to the flat partition (rank j holds tokens [j·M, (j+1)·M) of the
    (b, t) order, M = B·T/n): the counts it sends each rank (a
    contiguous run of its block each), the counts it receives from each,
    and the order that sorts the received runs (source by source) into
    its slab."""
    tb, M = T // n, B * T // n

    def flat(r):
        return (np.arange(B)[:, None] * T + r * tb + np.arange(tb)).ravel()

    sends = np.bincount(flat(me) // M, minlength=n).tolist()
    runs = [flat(r)[flat(r) // M == me] for r in range(n)]
    order = np.argsort(np.concatenate(runs), kind="stable")
    return sends, [len(run) for run in runs], order


def _move(x: torch.Tensor, group, sends: List[int], recvs: List[int]
          ) -> torch.Tensor:
    """Rows ``x`` cut into runs of ``sends`` (run j to rank j), the runs
    received (``recvs`` rows from each rank) concatenated in rank order,
    in one exchange; differentiable."""
    n = len(sends)
    items = [(run, j, None) for j, run in enumerate(torch.split(x, sends))]
    items += [(x.new_empty((m,) + tuple(x.shape[1:])), None, r)
              for r, m in enumerate(recvs)]
    return torch.cat(_exchange_ad(group, items)[n:])


def moe_apply_expert_blocks(apply_expert, stacked_params, gate_kernel,
                            x: torch.Tensor, group, mesh,
                            capacity_factor: float = 1.25,
                            axis_name: str = EXPERT_AXIS) -> torch.Tensor:
    """The expert-parallel path for ``x`` (B, Tb, D), this rank's T-block
    over ``group``, whose ranks are those of ``mesh``'s ``axis_name`` in
    the same order: the tokens are re-laid into the reference's sender
    partition (contiguous B·T/n tokens in (b, t) order), routed at that
    slab's per-pair capacity, run one expert a rank, and laid back.  The
    parameters' gradients are left to the caller to sum (the model's
    block forward sums every parameter over the axis).  Returns the
    rank's (B, Tb, D) block."""
    egroup = axis_group(mesh, axis_name)
    ranks = (lambda g: None if g is None
             else dist.get_process_group_ranks(g))
    if ranks(egroup) != ranks(group):
        raise ValueError(f"the {axis_name!r} axis must span the sequence "
                         f"axis' ranks in their order: {ranks(egroup)} vs "
                         f"{ranks(group)}")
    E, n = gate_kernel.shape[-1], group_size(group)
    if E != n or tree_leaves(stacked_params)[0].shape[0] != E:
        raise ValueError(f"{E} experts on {n} ranks: one expert per rank "
                         f"required")
    B, Tb, D = x.shape
    sends, recvs, order = _partition_plan(B, Tb * n, n, group_rank(group))
    order = torch.as_tensor(order, device=x.device)
    slab = _move(x.reshape(B * Tb, D), group, sends, recvs)[order]
    cap = default_capacity(slab.shape[0], E, capacity_factor)
    y = _expert_parallel_local(apply_expert, stacked_params, gate_kernel,
                               slab, group, cap)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=x.device)
    return _move(y[back], group, recvs, sends).reshape(B, Tb, D)
