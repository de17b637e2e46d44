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
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch

from analytics_zoo_tpu_torch.parallel.mesh import (EXPERT_AXIS, axis_group,
                                                   axis_size)
from analytics_zoo_tpu_torch.parallel.pipeline import (tree_leaves,
                                                       tree_skeleton,
                                                       tree_unflatten)
from analytics_zoo_tpu_torch.parallel.sequence import (all_to_all,
                                                       gather_blocks,
                                                       group_rank,
                                                       summed_grads,
                                                       take_block)


def route_top1(x: torch.Tensor, gate_kernel: torch.Tensor, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 routing: ``(dispatch (N, E, C) 0/1 in x's dtype, scale
    (N,))``.  ``dispatch[i, e, c] = 1`` iff token i goes to expert e at
    slot c; a token past its expert's ``capacity`` has an all-zero row
    and scale 0; ``scale[i]`` is its softmax gate probability."""
    logits = x @ gate_kernel                                # (N, E)
    gates = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(gates, dim=-1)                # (N,)
    E = gate_kernel.shape[-1]
    oh_i = torch.nn.functional.one_hot(expert_idx, E).to(torch.int32)
    oh = oh_i.to(x.dtype)
    # slot = earlier tokens that chose the same expert, counted in int32
    # (a bf16 cumsum stops incrementing at 256: duplicate slots)
    pos_i = ((torch.cumsum(oh_i, 0, dtype=torch.int32) - 1) * oh_i).sum(-1)
    keep = pos_i < capacity
    slot_oh = (pos_i[:, None] == torch.arange(capacity, device=x.device)
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
                    x: torch.Tensor, capacity: Optional[int] = None
                    ) -> torch.Tensor:
    """One-rank path: x (N, D) → (N, D)."""
    E = gate_kernel.shape[-1]
    n_experts = tree_leaves(stacked_params)[0].shape[0]
    if n_experts != E:
        raise ValueError(f"stacked_params has {n_experts} experts but "
                         f"gate_kernel routes to {E}")
    C = capacity if capacity is not None else default_capacity(x.shape[0], E)
    if C < 1:
        raise ValueError(f"capacity must be >= 1, got {C}")
    dispatch, scale = route_top1(x, gate_kernel, C)
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
    me = group_rank(group)
    params = tree_unflatten(tree_skeleton(stacked_params),
                            [p[me] for p in leaves])
    dispatch, scale = route_top1(x, gk, C)                  # (N_l, E, C)
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
