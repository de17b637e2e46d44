"""Sentiment analysis (counterpart of ``pipelines/sentiment.py``).

The reference's ``apps/sentimentAnalysis/sentiment.ipynb``: token ids →
an embedding table (trainable, or frozen GloVe vectors) → a GRU, LSTM,
BiLSTM, CNN or CNN-LSTM head → a binary sigmoid, trained with
``BCECriterion`` and ``Adam`` by the one-device ``Optimizer``.  The
trainable table (vocab 20,000 × 100) dominates the parameters and is
looked up by ``ops.embedding`` (``"dedup"`` by default);
:func:`sentiment_serving_tiers` gives ``serving.ServingRuntime`` the fp
and int8 rungs.  ``train_sentiment(mesh=)`` trains data parallel with
the table row-sharded, and ``sentiment_serving_tiers(specs=)`` serves the
``fp`` rung so over a mesh's data ranks.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.core.criterion import BCECriterion
from analytics_zoo_tpu_torch.core.module import Model
from analytics_zoo_tpu_torch.models.simple import SentimentNet
from analytics_zoo_tpu_torch.parallel import Adam, Optimizer, Trigger
from analytics_zoo_tpu_torch.pipelines.fraud import (SENTIMENT_INT8_SPEED,
                                                     fp_int8_tiers,
                                                     train_specs)


def make_sentiment_model(vocab_size: int = 20000, embedding_dim: int = 100,
                         hidden: int = 128, head: str = "gru",
                         embeddings: Optional[np.ndarray] = None,
                         lookup: str = "dedup", seq_len: int = 128,
                         seed: int = 0, device=None) -> Model:
    """A built SentimentNet :class:`Model` (weights from ``seed``; the
    heads take any length, ``seq_len`` is the build's example)."""
    model = Model(SentimentNet(vocab_size=vocab_size,
                               embedding_dim=embedding_dim, hidden=hidden,
                               head=head, embeddings=embeddings,
                               lookup=lookup), device=device)
    return model.build(seed, np.zeros((1, seq_len), np.int32))


def review_batches(tokens: np.ndarray, labels: np.ndarray, batch_size: int):
    """(N, T) token ids + binary labels → train batches."""
    n = (len(tokens) // batch_size) * batch_size
    return [{"input": np.asarray(tokens[i:i + batch_size], np.int32),
             "target": np.asarray(labels[i:i + batch_size], np.float32)}
            for i in range(0, n, batch_size)]


def train_sentiment(model: Model, batches, epochs: int = 5,
                    lr: float = 1e-3, mesh=None,
                    shard_tables: bool = True) -> Model:
    """Train a SentimentNet :class:`Model` on review batches on its device
    (``Adam(lr)``, ``BCECriterion``, dropout 0.2 from the model's
    generator).  ``mesh`` trains data parallel with the table row-sharded
    over its ``model`` axis (``shard_tables``; ``pipeline_specs(
    "sentiment")``; every rank runs this call)."""
    (Optimizer(model, batches, BCECriterion(),
               specs=train_specs("sentiment", mesh,
                                 shard_tables=shard_tables))
     .set_optim_method(Adam(lr))
     .set_end_when(Trigger.max_epoch(epochs))
     .optimize())
    return model


def _tokens(batch: Dict, device) -> tuple:
    return (torch.as_tensor(np.asarray(batch["input"], np.int64),
                            device=device),)


def sentiment_serving_tiers(model, specs=None, seq_len: int = 128,
                            device=None) -> List:
    """fp and int8 rungs for ``serving.ServingRuntime`` over a
    SentimentNet (a ``Model`` or the module), cheapest last.  A request
    carries one ``(seq_len,)`` row of token ids (``{"input": ...}``, the
    batcher's FIXED bucket); a row of the result is its probability.  The
    int8 rung serves the trainable table, the convolution and the cells'
    dense kernels of at least 4096 entries as int8 (a frozen table stays
    fp32).  ``specs`` (``pipeline_specs("sentiment", mesh=mesh)``): the
    ``fp`` rung over the data ranks, the table row-sharded over
    ``model`` (``fp_int8_tiers``)."""
    example = {"input": np.zeros((1, seq_len), np.int32)}
    return fp_int8_tiers(model, _tokens, example,
                         ("fp32 table and head, dedup'd gather, eval step",
                          "weight-only int8 table and kernels "
                          "(quantize_params)"),
                         SENTIMENT_INT8_SPEED, device, specs)
