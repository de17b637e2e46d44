"""Device mesh and batch placement (counterpart of ``parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` over the devices one
controller drives and lets XLA insert the gradient all-reduce.  The port
runs one process per rank (``utils/engine.py``): a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks, with the
reference's axis names, and each rank keeps its own slice of a batch.

Axis conventions (any subset may be size 1):
  ``data``     — data parallel (batch dim)
  ``model``    — tensor parallel (hidden dims)
  ``sequence`` — sequence parallel (time dim, ``parallel/sequence.py``)
  ``pipe``     — pipeline stages (``parallel/pipeline.py``)
  ``expert``   — expert parallel (``parallel/expert.py``)

A step over the ``data`` axis computes the one-device step through the
global-batch scope of ``utils/spmd.py``, which ``parallel/train.py``
opens around a step's forward and loss.  Ranks along ``model``,
``sequence``, ``pipe`` and ``expert`` share the rows of their data
coordinate: a mesh without a ``data`` axis whose first axis is one of
them has one data replica.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from analytics_zoo_tpu_torch.utils import engine

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQUENCE_AXIS = "sequence"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
# axes whose ranks share their data coordinate's rows
SHARED_AXES = (MODEL_AXIS, SEQUENCE_AXIS, PIPE_AXIS, EXPERT_AXIS)


class PartitionSpec(tuple):
    """One mesh-axis name (or ``None``, replicated) per tensor dim,
    over the tensor's torch layout: ``PartitionSpec("model", None)``
    shards a ``Linear`` weight's output features."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def create_mesh(mesh_shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = (DATA_AXIS,),
                device_type: Optional[str] = None):
    """A ``DeviceMesh`` over every rank of the process group (started
    by ``engine.init``, a one-rank group when none runs).  Default: a 1-D
    data-parallel mesh.  A ``-1`` dim is inferred as numpy's reshape does."""
    from torch.distributed.device_mesh import init_device_mesh

    engine.init()
    n = dist.get_world_size()
    if mesh_shape is None:
        mesh_shape = (n,) if len(axis_names) == 1 else None
    if mesh_shape is None:
        raise ValueError("mesh_shape required for multi-axis meshes")
    shape = list(mesh_shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = n // known
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    return init_device_mesh(device_type or engine.device().type,
                            tuple(shape), mesh_dim_names=tuple(axis_names))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    """Width of axis ``name`` (1 when the mesh has no such axis)."""
    names = axis_names(mesh)
    return int(mesh.size(names.index(name))) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (0 without the axis)."""
    return int(mesh.get_local_rank(name)) if name in axis_names(mesh) else 0


def axis_group(mesh, name: str):
    """The process group of this rank's line along ``name``; ``None``
    when the axis is absent or has one rank (no collective needed)."""
    if axis_size(mesh, name) <= 1:
        return None
    return mesh.get_group(name)


def data_axis(mesh) -> str:
    """The mesh axis carrying the batch dim: ``data`` if present, else
    the first axis unless its ranks share rows (:data:`SHARED_AXES`),
    else ``data`` (absent: one replica, width 1)."""
    names = axis_names(mesh)
    if DATA_AXIS in names or names[0] in SHARED_AXES:
        return DATA_AXIS
    return names[0]


def data_width(mesh) -> int:
    return axis_size(mesh, data_axis(mesh))


def batch_spec(mesh, ndim: int = 1) -> PartitionSpec:
    """Dim 0 over the data axis, the rest replicated."""
    return P(data_axis(mesh), *([None] * (ndim - 1)))


def spans_processes(mesh) -> bool:
    """True when the mesh holds more than this process's rank."""
    return int(mesh.size()) > 1


def local_data_slice(global_batch: int, mesh) -> Tuple[int, int]:
    """(start, size) of this rank's rows of a global batch: its data
    coordinate's share (ranks along ``model``, ``sequence``, ``pipe``
    and ``expert`` share the rows)."""
    width = data_width(mesh)
    if global_batch % width:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{width} hosts")
    per = global_batch // width
    return axis_index(mesh, data_axis(mesh)) * per, per


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def row_block(size: int, width: int, index: int) -> Tuple[int, int]:
    """Rows ``[a, b)`` of rank ``index`` of ``width`` in a ``size``-row
    dim, from ``index * size // width``: uneven, or empty where ``size <
    width`` (spatial partitioning's partition of every layer)."""
    return index * size // width, (index + 1) * size // width


def shard_batch(batch, mesh, overrides=None, microbatches: int = 1):
    """This rank's rows of a host batch: dim 0 of every leaf cut over the
    ``data`` axis (0-d leaves and non-arrays are kept whole).  Dim 0
    must divide the data width: pad the batch or drop the remainder.
    With ``microbatches=N`` (a step's ``grad_accum``) the rank keeps its
    share of each of the N consecutive microbatches, in order, so that
    cutting its rows into N gives its part of each global microbatch.

    ``overrides`` (per top-level key of a dict batch, a spec over more
    than dim 0, such as ``tensor.spatial_input_spec``'s ``("data",
    "model", None, None)``): dim 0 is cut as above, and every later dim
    that names an axis is cut to this rank's block of it
    (:func:`row_block`: the image height over ``model``, blocks uneven
    or empty where the dim does not divide)."""
    width = data_width(mesh)
    index = axis_index(mesh, data_axis(mesh))

    def cut(x):
        if not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim == 0:
            return x
        if x.shape[0] % width:
            raise ValueError(
                f"global batch dim {x.shape[0]} not divisible by data-axis "
                f"size {width}; pad the batch or drop the remainder "
                f"(see data.batching drop_remainder)")
        if microbatches == 1:
            per = x.shape[0] // width
            return x[index * per:(index + 1) * per]
        if x.shape[0] % (width * microbatches):
            raise ValueError(
                f"global batch dim {x.shape[0]} not divisible by data-axis "
                f"size {width} × {microbatches} microbatches")
        m = x.shape[0] // microbatches
        per = m // width
        rows = np.concatenate([np.arange(k * m + index * per,
                                         k * m + (index + 1) * per)
                               for k in range(microbatches)])
        return x[torch.from_numpy(rows) if isinstance(x, torch.Tensor)
                 else rows]

    def cut_spec(spec):
        def fn(x):
            x = cut(x)
            if not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim == 0:
                return x
            for dim, ax in enumerate(tuple(spec)[1:x.ndim], start=1):
                if ax is None:
                    continue
                a, b = row_block(x.shape[dim], axis_size(mesh, ax),
                                 axis_index(mesh, ax))
                x = (x.narrow(dim, a, b - a) if isinstance(x, torch.Tensor)
                     else np.take(x, np.arange(a, b), axis=dim))
            return x
        return fn

    if overrides and isinstance(batch, dict):
        return {k: _tree_map(cut_spec(overrides[k]) if k in overrides
                             else cut, v) for k, v in batch.items()}
    return _tree_map(cut, batch)


def _tensors_of(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    out = []
    _tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor)
              else None, tree)
    return out


def mesh_group(mesh):
    """The process group of every rank of ``mesh``: ``None`` (the default
    group) when the mesh holds every rank of the world, else the group of
    a one-axis mesh over some of them (the survivors of an eviction, a
    serving slice)."""
    if int(mesh.size()) == dist.get_world_size():
        return None
    if len(axis_names(mesh)) == 1:
        return mesh.get_group(axis_names(mesh)[0])
    raise ValueError("a mesh of several axes over part of the world has "
                     "no group of all its ranks")


def first_rank(mesh) -> int:
    """The global rank of the mesh's first position (the one that writes
    what the ranks share)."""
    return int(mesh.mesh.flatten()[0])


def replicate(tree, mesh):
    """Broadcast every tensor of ``tree`` (a module's parameters and
    buffers, or a tree of tensors) from rank 0, in place: the one-time
    weight distribution of the reference's ``ModelBroadcast``.  Every rank
    of the mesh calls it.  A tensor holding a rank's shard keeps it."""
    from analytics_zoo_tpu_torch.parallel.tensor import is_sharded

    if spans_processes(mesh):
        src, group = first_rank(mesh), mesh_group(mesh)
        with torch.no_grad():
            for t in _tensors_of(tree):
                if not is_sharded(t):
                    dist.broadcast(t.data, src, group=group)
    return tree


def host_local_state(tree):
    """A host (numpy) copy of a state tree (a module reads its
    ``state_dict``).  A tensor sharded across ranks raises: a local read
    would return one shard, not the value (``SpecSet.gather`` assembles
    those)."""
    from analytics_zoo_tpu_torch.parallel.tensor import is_sharded

    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            if is_sharded(p):
                raise ValueError(
                    f"host_local_state: {name} is sharded across ranks; "
                    "a local read would return one shard, not the value")
        tree = tree.state_dict()

    def get(x):
        if isinstance(x, torch.Tensor):
            if is_sharded(x):
                raise ValueError(
                    "host_local_state: leaf is sharded across ranks; a "
                    "local read would return one shard, not the value")
            return x.detach().cpu().numpy().copy()
        return x

    return _tree_map(get, tree)


def merge_over(results: Any, group) -> list:
    """Every rank's ``results`` of ``group``, in rank order (picklable
    objects; ``[results]`` when ``group`` is ``None``)."""
    if group is None:
        return [results]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, results, group=group)
    return out
