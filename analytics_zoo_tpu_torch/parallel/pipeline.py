"""Pipeline (stage) parallelism over ``torch.distributed`` (counterpart of
``parallel/pipeline.py``): GPipe-style microbatched execution, one stage
a rank along the mesh's ``pipe`` axis.

Stage parameters are stacked on a leading (L, ...) axis
(:func:`stack_stage_params`); every rank holds the stack and applies its
own row.  The tick loop :func:`_gpipe_schedule` runs ``M + L − 1``
ticks: stage 0 injects a microbatch, every stage applies itself, the
result hops one rank right (``parallel.sequence.ppermute``'s exchange),
the last stage collects, and a final sum over the axis hands the outputs
to every rank.  Autograd through it is the reverse-pipelined schedule:
each tick's exchange is differentiated once, in reverse tick order, on
every rank.  The stack and the microbatches are replicated inputs whose
gradients are summed over the axis (each rank's part is its stage), as
the reference's ``shard_map`` transposes them.

Heterogeneous stages (:func:`pipeline_forward_het`) carry each stage's
parameter tree flattened into a padded vector (:func:`flatten_stage_params`)
or a dict of vectors grouped by optimizer kind and dtype
(:func:`flatten_stage_params_grouped`), and each rank unflattens its own.

The pipeline bubble is the usual (L − 1)/(M + L − 1) fraction.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.parallel.mesh import (PIPE_AXIS, axis_group,
                                                   axis_index, axis_names,
                                                   axis_size)
from analytics_zoo_tpu_torch.parallel.sequence import (group_rank,
                                                       group_size, ppermute,
                                                       replicated_sum,
                                                       summed_grads)


# ---------------------------------------------------------------------------
# Trees of tensors (dicts in sorted key order, lists and tuples)
# ---------------------------------------------------------------------------


def _flatten(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the reference's (jax) leaf order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in
                _flatten(v, path + (f"[{i}]",))]
    return [("/".join(path), tree)]


def tree_skeleton(tree):
    """The tree with every leaf replaced by ``None`` (a treedef)."""
    if isinstance(tree, dict):
        return {k: tree_skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_skeleton(v) for v in tree)
    return None


def tree_unflatten(skeleton, leaves):
    it = iter(leaves)

    def build(s):
        if isinstance(s, dict):
            return {k: build(s[k]) for k in sorted(s)}
        if isinstance(s, (list, tuple)):
            return type(s)(build(v) for v in s)
        return next(it)

    out = build(skeleton)
    if isinstance(skeleton, dict):
        out = {k: out[k] for k in skeleton}
    return out


def tree_leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in _flatten(tree)]


def stack_stage_params(params_list) -> Any:
    """[per-stage parameter trees] → one tree with a leading (L, ...)
    axis (the stages share a structure: a stack of identical blocks)."""
    skel = tree_skeleton(params_list[0])
    cols = zip(*[tree_leaves(p) for p in params_list])
    return tree_unflatten(skel, [torch.stack(c) for c in cols])


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) → (M, B/M, ...) microbatches for the pipeline schedule."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} microbatches")
    return x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


def _gpipe_schedule(apply_stage: Callable, mbs: torch.Tensor, group):
    """The shared GPipe tick loop: ``apply_stage(x) → y`` is THIS rank's
    stage (shape preserving), ``mbs`` (M, B, ...) the microbatches.  Each
    tick ends with one exchange (the last tick's would be dropped, so it
    is not made); the last stage's collection is summed over the axis so
    every rank returns it.  Stage selection is by tensor ``where``, not
    by branch, so every rank's exchanges take part in the backward."""
    M = mbs.shape[0]
    n, stage = group_size(group), group_rank(group)
    first = torch.tensor(stage == 0, device=mbs.device)
    last = stage == n - 1
    buf = torch.zeros_like(mbs[0])
    outs = torch.zeros_like(mbs)
    hop = [(i, i + 1) for i in range(n - 1)]
    for t in range(M + n - 1):
        x = torch.where(first, mbs[min(t, M - 1)], buf)
        y = apply_stage(x)
        m_idx = t - (n - 1)
        hit = torch.zeros(M, dtype=torch.bool, device=mbs.device)
        if last and m_idx >= 0:
            hit[m_idx] = True
        outs = torch.where(hit.reshape((M,) + (1,) * (outs.dim() - 1)),
                           y[None], outs)
        if t < M + n - 2:
            buf = ppermute(y, group, hop)
    contrib = torch.where(torch.tensor(last, device=mbs.device), outs,
                          torch.zeros_like(outs))
    return replicated_sum(contrib, group)


def n_stages(mesh, axis_name: str = PIPE_AXIS) -> int:
    """Stages of a pipeline over ``axis_name``: one a rank."""
    return axis_size(mesh, axis_name)


def pipeline_forward(apply_block: Callable[[Any, torch.Tensor], torch.Tensor],
                     stacked_params: Any, microbatches: torch.Tensor,
                     mesh, axis_name: str = PIPE_AXIS,
                     batch_axis: Optional[str] = None,
                     param_specs: Optional[Any] = None) -> torch.Tensor:
    """``y_m = block_{L-1}(... block_0(x_m))`` for every microbatch.

    ``apply_block(stage_params, x) → y`` preserves x's shape;
    ``stacked_params`` has leading dim L == the ``axis_name`` width;
    ``microbatches`` (M, B, ...) are this rank's (its rows of a
    ``batch_axis``; every stage holds the same).  Returns (M, B, ...)
    on every rank.

    ``param_specs`` (a tree of ``PartitionSpec`` matching
    ``stacked_params``; every dim 0 must be ``axis_name``) composes the
    pipeline with tensor parallelism: a leaf's other named dims are cut
    to this rank's shard of that axis before ``apply_block`` sees it
    (which closes a Megatron pair itself, ``sequence.replicated_sum``
    over the ``model`` group standing for the reference's ``psum``); a
    leaf's gradient is summed over ``axis_name`` and over the axes that
    cut it."""
    L = axis_size(mesh, axis_name)
    leaves = tree_leaves(stacked_params)
    if leaves[0].shape[0] != L:
        raise ValueError(
            f"stacked_params has {leaves[0].shape[0]} stages but the "
            f"{axis_name!r} axis has {L} devices — one stage per device "
            "required")
    specs = None
    if param_specs is not None:
        specs = _leaves_of_specs(param_specs)
        for s in specs:
            if not s or s[0] != axis_name:
                raise ValueError(
                    f"param_specs leaf {s} must shard dim 0 over "
                    f"{axis_name!r} (one stage per pipe device)")
    if batch_axis is not None and batch_axis not in axis_names(mesh):
        raise ValueError(f"batch_axis {batch_axis!r} is not an axis of "
                         f"the mesh {axis_names(mesh)}")
    group = axis_group(mesh, axis_name)
    stage = group_rank(group)
    leaves = summed_grads(leaves, group)
    rows = [leaf[stage] for leaf in leaves]
    if specs is not None:
        rows = _cut_to_shards(rows, specs, mesh)
    params = tree_unflatten(tree_skeleton(stacked_params), rows)
    mbs, = summed_grads([microbatches], group)
    return _gpipe_schedule(lambda x: apply_block(params, x), mbs, group)


def _leaves_of_specs(param_specs) -> List[tuple]:
    """The specs of a tree of ``PartitionSpec`` (tuples are leaves)."""
    if isinstance(param_specs, dict):
        return [s for k in sorted(param_specs)
                for s in _leaves_of_specs(param_specs[k])]
    if isinstance(param_specs, list):
        return [s for v in param_specs for s in _leaves_of_specs(v)]
    return [tuple(param_specs)]


def _cut_to_shards(rows, specs, mesh):
    """Each stage row cut along its spec's named dims (past dim 0) to
    this rank's shard, its gradient summed over each cutting axis (the
    shards are disjoint)."""
    out = []
    for row, spec in zip(rows, specs):
        for dim, name in enumerate(spec[1:]):
            if name is None:
                continue
            n, idx = axis_size(mesh, name), axis_index(mesh, name)
            if row.shape[dim] % n:
                raise ValueError(f"dim {dim + 1} of size {row.shape[dim]} "
                                 f"not divisible by {name!r} ({n} ranks)")
            per = row.shape[dim] // n
            row, = summed_grads([row], axis_group(mesh, name))
            row = row.narrow(dim, idx * per, per)
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# Heterogeneous stages
# ---------------------------------------------------------------------------


def default_param_group(path: str, leaf) -> str:
    """``decay`` for ≥ 2-D kernels, ``no_decay`` for biases and norm
    scales (the standard weight-decay exclusion)."""
    return "decay" if getattr(leaf, "ndim", 0) >= 2 else "no_decay"


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def flatten_stage_params_grouped(params_list, classify=default_param_group):
    """[heterogeneous per-stage trees] → (carrier dict, metas): leaves
    grouped by ``(classify(path, leaf), dtype)`` into ``(L, Pmax_group)``
    tensors keyed ``"decay:float32"`` …, zero-padded to the longest
    stage, so a mask over the carrier (:func:`carrier_decay_mask`)
    decays exactly the leaves a per-parameter mask would.  ``metas[i]``
    is a dict (the stage's structure and per-leaf (group, offset, shape,
    dtype) entries)."""
    staged, lengths = [], {}
    for p in params_list:
        offsets: dict = {}
        entries = []
        for path, leaf in _flatten(p):
            key = f"{classify(path, leaf)}:{_dtype_name(leaf.dtype)}"
            off = offsets.get(key, 0)
            entries.append((key, off, tuple(leaf.shape), leaf.dtype))
            offsets[key] = off + leaf.numel()
        for key, used in offsets.items():
            lengths[key] = max(lengths.get(key, 0), used)
        staged.append((tree_skeleton(p), entries, tree_leaves(p)))
    carrier = {}
    for key, pmax in sorted(lengths.items()):
        dt = getattr(torch, key.split(":", 1)[1])
        rows = []
        for _, entries, leaves in staged:
            parts = [leaf.reshape(-1) for (k, _, _, _), leaf
                     in zip(entries, leaves) if k == key]
            vec = torch.cat(parts) if parts else torch.zeros(0, dtype=dt)
            rows.append(torch.nn.functional.pad(vec, (0, pmax - vec.numel())))
        carrier[key] = torch.stack(rows)
    metas = [{"treedef": skel, "entries": tuple(es)}
             for skel, es, _ in staged]
    return carrier, metas


def carrier_decay_mask(carrier):
    """``True`` exactly on the ``decay:*`` components of a grouped
    carrier."""
    return {k: k.startswith("decay:") for k in carrier}


def stage_carrier_slice(carrier, j: int):
    """Stage ``j``'s row of a grouped carrier."""
    return {k: v[j] for k, v in carrier.items()}


def flatten_stage_params(params_list):
    """[heterogeneous per-stage trees] → ((L, Pmax) fp32 carrier, metas):
    each stage's leaves raveled into one fp32 vector, zero-padded to the
    longest.  Prefer :func:`flatten_stage_params_grouped` when the
    optimizer needs per-parameter semantics."""
    metas, vecs = [], []
    for p in params_list:
        leaves = tree_leaves(p)
        vec = (torch.cat([leaf.reshape(-1).float() for leaf in leaves])
               if leaves else torch.zeros(0))
        metas.append((tree_skeleton(p),
                      tuple(tuple(x.shape) for x in leaves),
                      tuple(x.dtype for x in leaves), int(vec.numel())))
        vecs.append(vec)
    pmax = max(v.numel() for v in vecs)
    return (torch.stack([torch.nn.functional.pad(v, (0, pmax - v.numel()))
                         for v in vecs]), metas)


def unflatten_stage(vec, meta):
    """One stage's tree back from its carrier row (grouped: a dict of
    vectors with a dict meta; flat: one vector with a tuple meta)."""
    if isinstance(meta, dict):
        out = []
        for key, off, shp, dt in meta["entries"]:
            k = int(np.prod(shp)) if shp else 1
            out.append(vec[key][off:off + k].reshape(shp).to(dt))
        return tree_unflatten(meta["treedef"], out)
    skel, shapes, dtypes, _ = meta
    out, off = [], 0
    for shp, dt in zip(shapes, dtypes):
        k = int(np.prod(shp)) if shp else 1
        out.append(vec[off:off + k].reshape(shp).to(dt))
        off += k
    return tree_unflatten(skel, out)


def pipeline_forward_het(stage_fns, stacked_vec, metas, microbatches,
                         mesh, axis_name: str = PIPE_AXIS,
                         batch_axis: Optional[str] = None) -> torch.Tensor:
    """The GPipe schedule over heterogeneous stages:
    ``stage_fns[j](params_j, x) → y`` (x and y the same shape, the
    uniform wire format), the carrier from :func:`flatten_stage_params`
    or :func:`flatten_stage_params_grouped`.  Differentiable in the
    carrier."""
    L = axis_size(mesh, axis_name)
    grouped = isinstance(stacked_vec, dict)
    n_rows = (next(iter(stacked_vec.values())).shape[0] if grouped
              else stacked_vec.shape[0])
    if len(stage_fns) != L or n_rows != L:
        raise ValueError(
            f"{len(stage_fns)} stage fns / {n_rows} stage "
            f"vectors for a {L}-device {axis_name!r} axis — need exactly "
            "one stage per device")
    if batch_axis is not None and batch_axis not in axis_names(mesh):
        raise ValueError(f"batch_axis {batch_axis!r} is not an axis of "
                         f"the mesh {axis_names(mesh)}")
    group = axis_group(mesh, axis_name)
    stage = group_rank(group)
    if grouped:
        keys = sorted(stacked_vec)
        rows = summed_grads([stacked_vec[k] for k in keys], group)
        vec = {k: r[stage] for k, r in zip(keys, rows)}
    else:
        vec = summed_grads([stacked_vec], group)[0][stage]
    params = unflatten_stage(vec, metas[stage])
    mbs, = summed_grads([microbatches], group)
    return _gpipe_schedule(lambda x: stage_fns[stage](params, x), mbs,
                           group)

