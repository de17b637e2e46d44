"""What a layer asks of a step that runs over a mesh, without knowing the
mesh: the hooks ``core/``, ``ops/`` and ``models/`` call, which
``parallel/`` sets.  Nothing here imports ``parallel/``.

The global batch.  The reference's sharded step computes exactly the
one-device step; the port runs one process per rank, so a criterion or a
batch norm that counts or sums over the batch must see every rank's rows.
``parallel.train`` runs a step's forward and loss inside
:func:`global_batch`; within it :func:`global_count` and
:func:`global_sum` turn a rank's counts and sums into the global batch's,
and :func:`rows_rand` gives a rank its rows of the one-device random
draw.  The convention: a rank's loss, averaged over the data ranks, is
the global loss, and the step averages the gradients.  Outside a scope
every hook is the identity of the one-process step.

The image rows.  Under spatial partitioning a rank holds a block of
the image height; the step opens :func:`row_shards` with the group the
rows are cut over, and a model reads it with :func:`row_group`.

A parameter's whole value.  A weight that tensor-parallel placement
(``parallel.tensor.shard_module``) cut to this rank's shard and that a
layer reads directly rather than through its own forward (the persistent
RNN kernels' h2h weight, DS2's functional convolution) is taken through
:func:`whole`: the placement registered how to gather it, with the
gradient sliced back to the shard.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient of every rank's term is the sum of
    the ranks' gradients of the result (each rank's loss uses it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (``x`` when ``group``
    is ``None``)."""
    return x if group is None else _AllReduceSum.apply(x, group)


# (group, width, index) of each open scope, innermost last
_SCOPE: list = []


@contextlib.contextmanager
def global_batch(group, width: int, index: int = 0):
    """Run a step's forward and loss over a data axis of ``width`` ranks
    joined by ``group`` (``None`` at width 1), this rank at ``index``."""
    _SCOPE.append((group, int(width), int(index)))
    try:
        yield
    finally:
        _SCOPE.pop()


def global_width() -> int:
    """The data ranks of the running step (1 outside a scope)."""
    return _SCOPE[-1][1] if _SCOPE else 1


def global_count(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the running step's data ranks, without
    gradient (a count or a normaliser)."""
    group = _SCOPE[-1][0] if _SCOPE else None
    if group is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the running step's data ranks, with gradient
    (batch-norm sums)."""
    return all_reduce_sum(x, _SCOPE[-1][0] if _SCOPE else None)


def rows_rand(shape, generator=None, device=None) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows (dim 0) of the global
    batch: inside a data-parallel step the draw covers every rank's rows
    and each keeps its own, so a rank draws what the one-device step
    draws for its rows (dropout masks)."""
    width = global_width()
    if width == 1:
        return torch.rand(shape, generator=generator, device=device)
    shape = tuple(shape)
    full = torch.rand((shape[0] * width,) + shape[1:], generator=generator,
                      device=device)
    return full.narrow(0, _SCOPE[-1][2] * shape[0], shape[0])


# the group of each open row scope, innermost last
_ROWS: list = []


@contextlib.contextmanager
def row_shards(group):
    """Run a forward whose image rows are cut over ``group`` (spatial
    partitioning): the input holds this rank's block of the height, and
    a model that knows how (``models.ssd.SSDVgg``) runs its layers on
    row blocks and returns its outputs whole.  ``None``: one rank."""
    _ROWS.append(group)
    try:
        yield
    finally:
        _ROWS.pop()


def row_group():
    """The group of the running row scope (``None`` outside one)."""
    return _ROWS[-1] if _ROWS else None


# parameter → how to gather its whole value (set by tensor-parallel
# placement for each parameter it cuts to a shard)
_WHOLE: "WeakIdKeyDictionary" = WeakIdKeyDictionary()


def set_whole(p: torch.Tensor,
              gather: Callable[[torch.Tensor], torch.Tensor]) -> None:
    """Record how :func:`whole` assembles ``p``."""
    _WHOLE[p] = gather


def whole(p: torch.Tensor) -> torch.Tensor:
    """``p``'s whole value: itself, or its shard gathered (gradient
    sliced back to the shard) when placement cut it."""
    gather = _WHOLE.get(p)
    return p if gather is None else gather(p)
