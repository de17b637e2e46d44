"""Recommendation: NeuralCF and Wide&Deep on the dedup'd lookup
(counterpart of ``pipelines/recommendation.py``).

The reference's ``recommender-explicit-feedback.ipynb`` (user and item
LookupTables → JoinTable → MLP → LogSoftMax over 5 rating classes) and
the family's second architecture, Wide&Deep.  The models are dominated
by ``(vocab, dim)`` tables, looked up by ``ops.embedding`` (``"dedup"`` by
default).  Training is the ``Optimizer`` with ``Adam`` and
``ClassNLLCriterion`` over ``{"input": (users, items), "target":
rating_class}`` batches; :func:`rec_serving_tiers` gives
``serving.ServingRuntime`` the fp and int8 rungs.

``shard_tables`` has no effect without a mesh, as in the reference; with
one, every table is row-sharded over the ``model`` axis, in training and
in the ``fp`` serving rung (``specs=``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
from analytics_zoo_tpu_torch.core.module import Model
from analytics_zoo_tpu_torch.models.simple import NeuralCF, WideAndDeep
from analytics_zoo_tpu_torch.parallel import Adam, Optimizer, Trigger
from analytics_zoo_tpu_torch.pipelines.fraud import (REC_INT8_SPEED,
                                                     fp_int8_tiers,
                                                     train_specs)


def _probe():
    return np.zeros((1,), np.int32)


def make_ncf_model(n_users: int = 1000, n_items: int = 1000,
                   embedding_dim: int = 20, mf_embedding_dim: int = 8,
                   hidden: Sequence[int] = (40, 20), n_classes: int = 5,
                   include_mf: bool = True, lookup: str = "dedup",
                   seed: int = 0, device=None) -> Model:
    """A built NeuralCF :class:`Model` (weights from ``seed``)."""
    model = Model(NeuralCF(n_users=n_users, n_items=n_items,
                           embedding_dim=embedding_dim,
                           mf_embedding_dim=mf_embedding_dim,
                           hidden=tuple(hidden), n_classes=n_classes,
                           include_mf=include_mf, lookup=lookup),
                  device=device)
    return model.build(seed, _probe(), _probe())


def make_wide_deep_model(n_users: int = 1000, n_items: int = 1000,
                         embedding_dim: int = 20,
                         hidden: Sequence[int] = (40, 20),
                         n_classes: int = 5, cross_buckets: int = 1000,
                         lookup: str = "dedup", seed: int = 0,
                         device=None) -> Model:
    """A built Wide&Deep :class:`Model` (weights from ``seed``)."""
    model = Model(WideAndDeep(n_users=n_users, n_items=n_items,
                              embedding_dim=embedding_dim,
                              hidden=tuple(hidden), n_classes=n_classes,
                              cross_buckets=cross_buckets, lookup=lookup),
                  device=device)
    return model.build(seed, _probe(), _probe())


def rating_batches(users: np.ndarray, items: np.ndarray, ratings: np.ndarray,
                   batch_size: int):
    """(user, item, rating 1..n_classes) triples → train batches; the
    targets are 0-based classes for ``ClassNLLCriterion``."""
    n = (len(users) // batch_size) * batch_size
    out = []
    for i in range(0, n, batch_size):
        sl = slice(i, i + batch_size)
        out.append({
            "input": (np.asarray(users[sl], np.int32),
                      np.asarray(items[sl], np.int32)),
            "target": np.asarray(ratings[sl], np.int32) - 1,
        })
    return out


def train_recommender(model: Model, batches, epochs: int = 5,
                      lr: float = 1e-3, mesh=None,
                      shard_tables: bool = True) -> Model:
    """Train an NCF/Wide&Deep :class:`Model` on rating batches on its
    device (``Adam(lr)``, ``ClassNLLCriterion``, ``epochs`` epochs).
    ``mesh`` trains data parallel with every lookup table row-sharded
    over its ``model`` axis (``shard_tables``; ``pipeline_specs("rec")``;
    every rank runs this call)."""
    (Optimizer(model, batches, ClassNLLCriterion(),
               specs=train_specs("rec", mesh, shard_tables=shard_tables))
     .set_optim_method(Adam(lr))
     .set_end_when(Trigger.max_epoch(epochs))
     .optimize())
    return model


def predict_ratings(model: Model, users, items) -> np.ndarray:
    """Predicted 1-based rating class per (user, item) pair."""
    with torch.inference_mode():
        log_probs = model.eval()(np.asarray(users, np.int32),
                                 np.asarray(items, np.int32)).cpu().numpy()
    return log_probs.argmax(axis=-1) + 1


def rec_pair(batch: Dict, device) -> tuple:
    """A rec batch's ``(users, items)`` as int64 tensors on ``device``:
    ``batch["input"]`` is the tier's own form ``((B,) users, (B,)
    items)``, or the ``(B, 2)`` array the batcher stacks from
    per-request ``(user, item)`` pairs (the reference's tier takes only
    the first)."""
    x = batch["input"]
    if isinstance(x, (tuple, list)) and len(x) == 2:
        users, items = x
    else:
        pairs = np.asarray(x)
        if pairs.ndim != 2 or pairs.shape[1] != 2:
            raise ValueError(f"rec input: expected (users, items) or a "
                             f"(B, 2) array, got shape {pairs.shape}")
        users, items = pairs[:, 0], pairs[:, 1]
    return tuple(torch.as_tensor(np.asarray(v, np.int64), device=device)
                 for v in (users, items))


def rec_serving_tiers(model, specs=None, device=None) -> List:
    """fp and int8 rungs for ``serving.ServingRuntime`` over a NeuralCF
    or Wide&Deep (a ``Model`` or the module), cheapest last.  A request
    carries one pair (``{"input": (user, item)}``; the batcher stacks the
    batch into ``(B, 2)``), or a batch is given directly as ``{"input":
    ((B,) users, (B,) items)}``.  The int8 rung serves every table of at
    least 4096 entries as int8, dequantized before its lookup.
    ``specs`` (``pipeline_specs("rec", mesh=mesh)``): the ``fp`` rung
    over the data ranks, its tables row-sharded over ``model``
    (``fp_int8_tiers``)."""
    example = {"input": np.zeros((1, 2), np.int32)}
    return fp_int8_tiers(model, rec_pair, example,
                         ("fp32 tables, dedup'd gather, eval step",
                          "weight-only int8 lookup tables "
                          "(quantize_params embedding pattern)"),
                         REC_INT8_SPEED, device, specs)
