"""The small model families (counterpart of ``models/simple.py``): the
fraud MLP, the sentiment heads and the two recommenders.

- ``FraudMLP``: ``Linear(29, 10) → Linear(10, 2) → LogSoftMax``;
- ``SentimentNet``: a trainable :class:`~analytics_zoo_tpu_torch.ops.
  embedding.DedupEmbed` table or frozen vectors (a buffer, never a
  parameter), then a GRU, LSTM, BiLSTM, CNN or CNN-LSTM head, dropout 0.2
  in training, a sigmoid of shape ``(B,)``;
- ``NeuralCF``: user and item tables → concat → MLP, plus the GMF
  branch (a second pair of tables fused by product) under ``include_mf``,
  → LogSoftMax over the rating classes;
- ``WideAndDeep``: per-id and hashed user×item cross terms (``n_classes``
  wide lookups) summed with a deep embedding MLP before the LogSoftMax.

Submodules carry the flax names (``fc1``, ``embed``, ``Recurrent_0``,
``BiRecurrent_0``, ``conv``, ``user_embed``, ``fc0``, ``out``...), so
``utils/convert.py`` maps a flax tree by name.  Parameters are drawn as
flax draws them (LeCun-normal kernels, zero biases, the tables' own
initializers) by ``reset_parameters(generator)``, which
``core.module.Model.build`` calls with its seeded generator.  The
recurrent heads use the blocked scan (``engine`` unset), as the
reference's do; none of this reaches a hand-written kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.core.layers import dropout
from analytics_zoo_tpu_torch.core.module import init_parameters
from analytics_zoo_tpu_torch.core.rnn import (BiRecurrent, GRUCell,
                                              LSTMCell, Recurrent)
from analytics_zoo_tpu_torch.ops.embedding import DedupEmbed, zeros_init

HEADS = ("gru", "lstm", "bilstm", "cnn", "cnn-lstm")
# the wide path's multiplicative hash, wrapped to uint32
CROSS_HASH = 2654435761


class _Zoo(nn.Module):
    """flax's defaults on a model's own layers (LeCun-normal kernels, zero
    biases); submodules that draw their own (tables, cells) do so."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for child in self.children():
            init_parameters(child, generator)


class FraudMLP(_Zoo):
    """(B, 29) → (B, 2) log-probs."""

    def __init__(self, in_features: int = 29, hidden: int = 10,
                 n_classes: int = 2):
        super().__init__()
        self.in_features = in_features
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, n_classes)
        self.reset_parameters()

    def forward(self, x):
        return torch.log_softmax(self.fc2(self.fc1(x)), dim=-1)


class SentimentNet(_Zoo):
    """Token ids (B, T) → (B,) sigmoid probability.

    ``head`` ∈ ``HEADS``.  ``embeddings`` (vocab, dim), when given, is a
    frozen table (a non-persistent buffer: not a parameter, not in the
    ``state_dict``, never quantized); otherwise a trainable
    ``DedupEmbed`` named ``embed`` with the ``lookup`` hot path.
    ``forward(x, train=False, generator=None)``: dropout 0.2 only when
    ``train``, with masks from ``generator``."""

    def __init__(self, vocab_size: int = 20000, embedding_dim: int = 100,
                 hidden: int = 128, head: str = "gru",
                 embeddings: Optional[np.ndarray] = None,
                 lookup: str = "dedup"):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}")
        self.head = head
        if embeddings is not None:
            table = torch.as_tensor(np.asarray(embeddings, np.float32))
            self.register_buffer("embeddings", table, persistent=False)
            dim = table.shape[1]
        else:
            self.embeddings = None
            self.embed = DedupEmbed(vocab_size, embedding_dim, lookup=lookup)
            dim = embedding_dim
        if head in ("cnn", "cnn-lstm"):
            # flax's Conv(hidden, (5,), padding="SAME") on NLC; NCL here
            self.conv = nn.Conv1d(dim, hidden, 5, padding=2)
            dim = hidden
        if head in ("gru", "lstm", "cnn-lstm"):
            cell = (GRUCell if head == "gru" else LSTMCell)(hidden, dim)
            self.Recurrent_0 = Recurrent(cell)
        elif head == "bilstm":
            self.BiRecurrent_0 = BiRecurrent(LSTMCell(hidden, dim),
                                             merge="concat")
        self.fc = nn.Linear(2 * hidden if head == "bilstm" else hidden, 1)
        self.reset_parameters()

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        ids = torch.as_tensor(x).long()
        h = (self.embeddings[ids] if self.embeddings is not None
             else self.embed(ids))                       # (B, T, D)
        if self.head in ("cnn", "cnn-lstm"):
            h = torch.relu(self.conv(h.transpose(1, 2)))  # (B, H, T)
            if self.head == "cnn":
                h = h.amax(dim=2)                         # global max pool
            else:
                h = self.Recurrent_0(h.transpose(1, 2))[:, -1]
        elif self.head == "bilstm":
            # the forward direction's outputs first, then the backward's
            h = self.BiRecurrent_0(h)[:, -1]
        else:
            h = self.Recurrent_0(h)[:, -1]
        if train:
            h = dropout(h, 0.2, generator)
        return torch.sigmoid(self.fc(h))[..., 0]


def _mlp(model: nn.Module, in_dim: int, hidden: Sequence[int]) -> int:
    """``fc0``, ``fc1``... of ``hidden`` widths; returns the last width."""
    for i, width in enumerate(hidden):
        model.add_module(f"fc{i}", nn.Linear(in_dim, width))
        in_dim = width
    return in_dim


def _run_mlp(model: nn.Module, h: torch.Tensor, n: int) -> torch.Tensor:
    for i in range(n):
        h = torch.relu(getattr(model, f"fc{i}")(h))
    return h


def cross_bucket(users: torch.Tensor, items: torch.Tensor,
                 buckets: int) -> torch.Tensor:
    """``(u · 2654435761 + i) mod 2³²``, then ``mod buckets``: the
    reference's wrapping uint32 hash, computed in int64 (exact for ids
    below 2³¹) and masked to 32 bits."""
    h = (users.long() * CROSS_HASH + items.long()) & 0xFFFFFFFF
    return h % buckets


class WideAndDeep(_Zoo):
    """``(user_ids (B,), item_ids (B,))`` → ``(B, n_classes)`` log-probs:
    the wide terms ``w_user[u] + w_item[i] + w_cross[hash(u, i)]`` (zero
    initialised ``n_classes``-wide tables) plus the deep MLP's logits."""

    def __init__(self, n_users: int = 1000, n_items: int = 1000,
                 embedding_dim: int = 20, hidden: Sequence[int] = (40, 20),
                 n_classes: int = 5, cross_buckets: int = 1000,
                 lookup: str = "dedup"):
        super().__init__()
        self.cross_buckets = cross_buckets
        self.n_hidden = len(hidden)

        def embed(vocab, dim, init=None):
            return DedupEmbed(vocab, dim, lookup=lookup, embedding_init=init)

        self.wide_user = embed(n_users, n_classes, zeros_init)
        self.wide_item = embed(n_items, n_classes, zeros_init)
        self.wide_cross = embed(cross_buckets, n_classes, zeros_init)
        self.user_embed = embed(n_users, embedding_dim)
        self.item_embed = embed(n_items, embedding_dim)
        self.out = nn.Linear(_mlp(self, 2 * embedding_dim, hidden),
                             n_classes)
        self.reset_parameters()

    def forward(self, users, items):
        users = torch.as_tensor(users).long()
        items = torch.as_tensor(items).long()
        cross = cross_bucket(users, items, self.cross_buckets)
        wide = (self.wide_user(users) + self.wide_item(items)
                + self.wide_cross(cross))
        h = torch.cat([self.user_embed(users), self.item_embed(items)], -1)
        deep = self.out(_run_mlp(self, h, self.n_hidden))
        return torch.log_softmax(wide + deep, dim=-1)


class NeuralCF(_Zoo):
    """``(user_ids (B,), item_ids (B,))`` → ``(B, n_classes)`` log-probs:
    the MLP tower over the concatenated embeddings, plus the GMF branch
    (``mf_user_embed · mf_item_embed``) concatenated in front of it under
    ``include_mf``."""

    def __init__(self, n_users: int = 1000, n_items: int = 1000,
                 embedding_dim: int = 20, mf_embedding_dim: int = 8,
                 hidden: Sequence[int] = (40, 20), n_classes: int = 5,
                 include_mf: bool = True, lookup: str = "dedup"):
        super().__init__()
        self.include_mf = include_mf
        self.n_hidden = len(hidden)
        self.user_embed = DedupEmbed(n_users, embedding_dim, lookup=lookup)
        self.item_embed = DedupEmbed(n_items, embedding_dim, lookup=lookup)
        width = _mlp(self, 2 * embedding_dim, hidden)
        if include_mf:
            self.mf_user_embed = DedupEmbed(n_users, mf_embedding_dim,
                                            lookup=lookup)
            self.mf_item_embed = DedupEmbed(n_items, mf_embedding_dim,
                                            lookup=lookup)
            width += mf_embedding_dim
        self.out = nn.Linear(width, n_classes)
        self.reset_parameters()

    def forward(self, users, items):
        users = torch.as_tensor(users).long()
        items = torch.as_tensor(items).long()
        h = torch.cat([self.user_embed(users), self.item_embed(items)], -1)
        h = _run_mlp(self, h, self.n_hidden)
        if self.include_mf:
            mf = self.mf_user_embed(users) * self.mf_item_embed(items)
            h = torch.cat([mf, h], -1)
        return torch.log_softmax(self.out(h), dim=-1)
