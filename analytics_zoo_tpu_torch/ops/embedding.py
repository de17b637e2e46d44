"""Embedding lookups: the dedup'd gather with a segment-sum backward
(counterpart of ``ops/embedding.py``).

The recommendation and sentiment models are dominated by ``(vocab,
dim)`` tables whose hot path is a sparse gather, not a matmul.  Three
lookups compute the same function (``LOOKUP_MODES``):

* ``"dedup"`` — :func:`dedup_lookup`: each unique id of the batch is
  gathered once, then inverted back to the batch positions.  Its
  backward (a ``torch.autograd.Function``) sorts the cotangent rows by
  the inverse map, sums each unique id's segment in order
  (``torch.segment_reduce``, so a seeded step repeats bit for bit on the
  card, where an ``index_add_`` over duplicated indices would add in a
  varying order; ``unsafe=True`` skips its checks of the lengths, which
  read them on the host, so the backward runs without a host sync), and
  lands the per-unique rows in the table's gradient with one
  ``index_add_`` over unique ids;
* ``"naive"`` — one row fetch per batch position (autograd's own
  scatter-add backward);
* ``"onehot"`` — the reference semantics ``one_hot(ids) @ table``, the
  densifying baseline the others are held to.

:class:`SparseRows` keeps the reference's static-shape contract: ids
sorted and padded with 0 up to ``size``, padded rows zero, ``count`` the
valid entries.  ``parallel.train.sparse_adam_apply`` consumes it.  A
table row-sharded by the SpecSet rules is ``parallel.tensor``'s to look
up: placement gives its :class:`DedupEmbed` the masked local gather and
the sum over the table's axis.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LOOKUP_MODES = ("dedup", "naive", "onehot")


@torch.no_grad()
def default_embed_init(weight: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> None:
    """flax's ``nn.Embed`` default, ``variance_scaling(1.0, "fan_in",
    "normal", out_axis=0)``: a plain normal of std ``1/sqrt(dim)``."""
    weight.normal_(0.0, 1.0 / math.sqrt(weight.shape[-1]),
                   generator=generator)


@torch.no_grad()
def zeros_init(weight: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> None:
    weight.zero_()


class SparseRows(NamedTuple):
    """A row-sparse embedding gradient: ``rows[k]`` is the segment-summed
    cotangent of ``ids[k]``.  ``ids`` (int64) are the sorted unique ids
    padded with 0 to the static ``size``; ``count`` (0-d int32) is the
    number of leading entries that are real.  Padded entries carry zero
    rows, so a scatter-add may ignore ``count``; a scatter-set (the
    optimizer apply) must mask by it."""

    ids: torch.Tensor
    rows: torch.Tensor
    count: torch.Tensor


def _flat_ids(ids: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(ids).reshape(-1).long()


def _size(ids: torch.Tensor, max_unique: Optional[int]) -> int:
    return int(max_unique) if max_unique else max(int(np.prod(ids.shape)), 1)


def _unique(flat: torch.Tensor, size: int):
    """Static-size unique: sorted ids padded with 0 to ``size``, the
    inverse map and the valid count, without reading a device value on
    the host (the reference's ``jnp.unique(size=)``,
    ``ops/embedding.py:74-80``).  When ``size`` is below the batch's
    positions, more unique ids than ``size`` raises (the reference's
    clamped gather would read a wrong row): only that check reads the
    count back."""
    sorted_ids, order = torch.sort(flat, stable=True)
    new = torch.ones_like(sorted_ids, dtype=torch.bool)
    new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    slot = torch.cumsum(new, 0) - 1
    count = new.sum().to(torch.int32)
    if size < flat.numel():
        n = int(count)
        if n > size:
            raise ValueError(f"max_unique={size} is smaller than the "
                             f"batch's {n} unique ids")
    uids = sorted_ids.new_zeros(size).scatter_(0, slot, sorted_ids)
    inv = torch.empty_like(slot).scatter_(0, order, slot)
    return uids, inv, count


def _segment_rows(g: torch.Tensor, inv: torch.Tensor,
                  size: int) -> torch.Tensor:
    """The flattened cotangent's rows summed per unique id, in sorted
    order: ``(size, dim)``, zero past the valid ids.  The lengths are
    valid by construction (non-negative, summing to the rows), so
    ``segment_reduce`` is told not to check them: the check reads them on
    the host (the reference's segment sum runs inside its program)."""
    gf = g.reshape(-1, g.shape[-1])
    order = torch.argsort(inv, stable=True)
    lengths = torch.zeros(size, dtype=torch.int64, device=inv.device
                          ).index_add_(0, inv, torch.ones_like(inv))
    return torch.segment_reduce(gf[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)


def naive_lookup(table: torch.Tensor, ids) -> torch.Tensor:
    """Plain gather: one row fetch per batch position."""
    ids = torch.as_tensor(ids, device=table.device)
    return table[_flat_ids(ids)].reshape(*ids.shape, table.shape[-1])


def onehot_lookup(table: torch.Tensor, ids) -> torch.Tensor:
    """The reference semantics, ``one_hot(ids) @ table``: a ``(positions,
    vocab)`` matrix forward and a dense ``(vocab, dim)`` gradient."""
    ids = torch.as_tensor(ids, device=table.device)
    oh = F.one_hot(_flat_ids(ids), table.shape[0]).to(table.dtype)
    return (oh @ table).reshape(*ids.shape, table.shape[-1])


class _DedupLookup(torch.autograd.Function):
    """Gather each unique id once; backward: sorted segment sums landed
    with one scatter-add over unique ids."""

    @staticmethod
    def forward(ctx, table, ids, size):
        uids, inv, _ = _unique(_flat_ids(ids), size)
        rows = table[uids]
        ctx.save_for_backward(uids, inv)
        ctx.size, ctx.vocab = size, table.shape[0]
        return rows[inv].reshape(*ids.shape, table.shape[-1])

    @staticmethod
    def backward(ctx, g):
        uids, inv = ctx.saved_tensors
        srows = _segment_rows(g, inv, ctx.size)
        # padded slots add zero rows to row 0: exact, in any order
        table_ct = srows.new_zeros((ctx.vocab, g.shape[-1])).index_add_(
            0, uids, srows)
        return table_ct, None, None


def dedup_lookup(table: torch.Tensor, ids, *,
                 max_unique: Optional[int] = None) -> torch.Tensor:
    """Unique-id-dedup'd lookup with the segment-sum backward.
    ``max_unique`` caps the unique-id buffer (default: one slot a batch
    position, always enough)."""
    ids = torch.as_tensor(ids, device=table.device)
    return _DedupLookup.apply(table, ids, _size(ids, max_unique))


def sharded_embedding_lookup(table: torch.Tensor, ids, *,
                             mode: str = "dedup",
                             max_unique: Optional[int] = None
                             ) -> torch.Tensor:
    """``ids (...,) → (..., dim)`` by ``mode`` (one of ``LOOKUP_MODES``)
    over the rows ``table`` holds."""
    if mode == "dedup":
        return dedup_lookup(table, ids, max_unique=max_unique)
    if mode == "naive":
        return naive_lookup(table, ids)
    if mode == "onehot":
        return onehot_lookup(table, ids)
    raise ValueError(f"unknown lookup mode {mode!r} (one of {LOOKUP_MODES})")


def embedding_grad_rows(ids, cotangent: torch.Tensor, *,
                        max_unique: Optional[int] = None) -> SparseRows:
    """The sparse gradient itself: ``cotangent`` (the output's gradient,
    ``ids.shape + (dim,)``) segment-summed into :class:`SparseRows`."""
    ids = torch.as_tensor(ids, device=cotangent.device)
    size = _size(ids, max_unique)
    uids, inv, count = _unique(_flat_ids(ids), size)
    return SparseRows(ids=uids, rows=_segment_rows(cotangent, inv, size),
                      count=count)


def sparse_rows_to_dense(grad: SparseRows, vocab: int) -> torch.Tensor:
    """Densify a :class:`SparseRows` gradient (tests and debugging)."""
    return grad.rows.new_zeros((vocab, grad.rows.shape[-1])).index_add_(
        0, grad.ids, grad.rows)


class DedupEmbed(nn.Module):
    """An embedding table (parameter ``embedding``, flax's name, so the
    weight bridge and the int8 pattern ``embedding$`` apply) with a
    selectable lookup.  ``embedding_init(weight, generator)`` draws the
    table (default: :func:`default_embed_init`)."""

    def __init__(self, num_embeddings: int, features: int,
                 lookup: str = "dedup",
                 embedding_init: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if lookup not in LOOKUP_MODES:
            raise ValueError(f"unknown lookup mode {lookup!r} "
                             f"(one of {LOOKUP_MODES})")
        self.num_embeddings, self.features = num_embeddings, features
        self.lookup = lookup
        self.embedding_init = embedding_init or default_embed_init
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.embedding_init(self.embedding, generator)

    def forward(self, ids) -> torch.Tensor:
        return sharded_embedding_lookup(self.embedding, ids,
                                        mode=self.lookup)


def lookup_stats(ids: Any) -> dict:
    """Host-side dedup telemetry for one batch of ids: positions, rows
    touched and their ratio (the dedup'd gather's fetches a position)."""
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    flat = np.asarray(ids).reshape(-1)
    unique = int(np.unique(flat).size)
    return {
        "positions": int(flat.size),
        "rows_touched": unique,
        "unique_fraction": float(unique / max(flat.size, 1)),
    }


def publish_lookup_stats(registry: Any, ids: Any) -> dict:
    """One batch's dedup stats into an ``obs.registry.MetricRegistry``:
    the counter ``embed/lookups`` and the gauges ``embed/rows_touched``
    and ``embed/unique_fraction``."""
    stats = lookup_stats(ids)
    registry.counter("embed/lookups").inc()
    registry.gauge("embed/rows_touched").set(stats["rows_touched"])
    registry.gauge("embed/unique_fraction").set(stats["unique_fraction"])
    return stats
