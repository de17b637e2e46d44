"""Long-context attention models (counterpart of ``models/attention.py``):
a transformer encoder whose attention op is pluggable, so the same model
runs on one rank with ``parallel.sequence.full_attention`` or over the
``sequence`` axis with a ``parallel.sequence.RingAttentionLayer``.

``AttentionASR`` is DeepSpeech2 with its BiRNN stack replaced by
transformer blocks: the same stride-2 conv front-end and CTC head.

Over a ``sequence`` axis of n > 1 ranks (a ``RingAttentionLayer``) the
encoder runs on this rank's T-block from its entry to its exit: the
embedding at the block's offset, every block (LayerNorms, projections,
the ring's block entry, the MLP or the MoE), the final LayerNorm, and
for ``AttentionASR`` the head; the block is taken once at the entry
and the output gathered once at the exit.  Each rank's backward then
sees its block's tokens only, so every parameter those layers read has
its gradient summed over the axis (``parallel.sequence.
summed_parameters``); the conv front-end runs whole on every rank.
``MoEFeedForward`` swaps a block's MLP for top-1-routed experts, dense
on one rank or expert parallel over an ``expert`` axis
(``parallel/expert.py``); :func:`make_pipeline_forward_fn` runs the
blocks as GPipe stages over a ``pipe`` axis (``parallel/pipeline.py``).

Module names are the flax scope names (``conv1``, ``encoder/embed``,
``encoder/block{i}/{ln1,attn/qkv,attn/proj,ln2,mlp1,mlp2,moe}``,
``encoder/ln_out``, ``fc_out``), so ``utils/convert.py`` maps a flax tree
by name; the experts' stacked ``w1/b1/w2/b2`` and ``gate`` keep flax's
layout.  Weights come from flax's initialisers drawn from
``torch.Generator().manual_seed(seed)``: LeCun-normal kernels, zero
biases, LayerNorm scale 1 (flax's ε 1e-6), and flax's tanh GELU.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from analytics_zoo_tpu_torch.core.layers import lecun_normal_
from analytics_zoo_tpu_torch.parallel.sequence import (full_attention,
                                                       gather_blocks,
                                                       group_rank,
                                                       sequence_group_of,
                                                       summed_parameters,
                                                       take_block)
from analytics_zoo_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6                  # flax LayerNorm's epsilon


def _dense(in_features: int, out_features: int,
           gen: Optional[torch.Generator]) -> nn.Linear:
    d = nn.Linear(in_features, out_features)
    with torch.no_grad():
        lecun_normal_(d.weight, in_features, gen)
        d.bias.zero_()
    return d


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _call_with(module: nn.Module, params: Dict[str, torch.Tensor],
               name: str, *args):
    """``module``'s child ``name`` run on ``params`` (``module``'s
    parameters by name) instead of its own."""
    pre = name + "."
    return functional_call(module.get_submodule(name),
                           {k[len(pre):]: v for k, v in params.items()
                            if k.startswith(pre)}, args)


class MultiHeadSelfAttention(nn.Module):
    """QKV projection around a pluggable ``attention_fn(q, k, v)`` over
    (B, T, H, D_head).  With a ring over more than one rank, ``x`` is
    this rank's T-block and the ring's block entry runs."""

    def __init__(self, dim: int, num_heads: int = 4,
                 attention_fn: Callable = full_attention, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.attention_fn = attention_fn
        self.qkv = _dense(dim, 3 * dim, generator)
        self.proj = _dense(dim, dim, generator)

    def forward(self, x):
        B, T, _ = x.shape
        q, k, v = self.qkv(x).split(self.dim, -1)
        shape = (B, T, self.num_heads, self.dim // self.num_heads)
        attend = self.attention_fn
        if sequence_group_of(attend) is not None:
            attend = attend.block
        out = attend(q.reshape(shape), k.reshape(shape), v.reshape(shape))
        return self.proj(out.reshape(B, T, self.dim))


class MoEFeedForward(nn.Module):
    """Mixture-of-experts MLP: tokens top-1-routed to ``n_experts`` GELU
    MLPs with a static capacity.  ``expert_mesh=None`` runs the dense
    path; a mesh with an ``expert`` axis runs the experts one a rank
    (each rank of the axis holds the whole input, routes its block of the
    tokens and gathers the outputs).  Routing is the same on both paths;
    the dense capacity is global, the expert-parallel one per (sender,
    expert) pair, so outputs agree when the capacity admits every
    token.  Given a ``sequence_group``, ``x`` is this rank's T-block and
    the tokens route as the whole batch's would
    (``expert.moe_apply_dense_blocks`` / ``moe_apply_expert_blocks``)."""

    def __init__(self, dim: int, n_experts: int = 8, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, expert_mesh=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.n_experts = dim, n_experts
        self.capacity_factor = capacity_factor
        self.expert_mesh = expert_mesh
        E, H = n_experts, dim * mlp_ratio
        self.w1 = nn.Parameter(torch.empty(E, dim, H))
        self.b1 = nn.Parameter(torch.zeros(E, H))
        self.w2 = nn.Parameter(torch.empty(E, H, dim))
        self.b2 = nn.Parameter(torch.zeros(E, dim))
        self.gate = nn.Parameter(torch.empty(dim, E))
        with torch.no_grad():
            # flax's fan-in of a (E, in, out) kernel counts E as its
            # receptive field
            lecun_normal_(self.w1, E * dim, generator)
            lecun_normal_(self.w2, E * H, generator)
            lecun_normal_(self.gate, dim, generator)

    @staticmethod
    def _expert(p, a):
        return _gelu(a @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    def forward(self, x, sequence_group=None):
        from analytics_zoo_tpu_torch.parallel import expert

        B, T, D = x.shape
        if D != self.dim:
            raise ValueError(f"input feature dim {D} != configured "
                             f"dim {self.dim}")
        stacked = {"w1": self.w1, "b1": self.b1, "w2": self.w2,
                   "b2": self.b2}
        if sequence_group is not None:
            if self.expert_mesh is not None:
                return expert.moe_apply_expert_blocks(
                    self._expert, stacked, self.gate, x, sequence_group,
                    self.expert_mesh, self.capacity_factor)
            return expert.moe_apply_dense_blocks(
                self._expert, stacked, self.gate, x, sequence_group,
                self.capacity_factor)
        toks = x.reshape(B * T, D)
        if self.expert_mesh is not None:
            y = expert.moe_apply_whole(self._expert, stacked, self.gate,
                                       toks, self.expert_mesh,
                                       self.capacity_factor)
        else:
            y = expert.moe_apply_dense(
                self._expert, stacked, self.gate, toks,
                capacity=expert.default_capacity(
                    toks.shape[0], self.n_experts, self.capacity_factor))
        return y.reshape(B, T, D)


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln1(x))``, then ``+ mlp(ln2(·))`` (or the
    MoE feed-forward when ``n_experts > 0``)."""

    def __init__(self, dim: int, num_heads: int = 4, mlp_ratio: int = 4,
                 attention_fn: Callable = full_attention, n_experts: int = 0,
                 expert_mesh=None, capacity_factor: float = 1.25, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_experts = n_experts
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadSelfAttention(dim, num_heads, attention_fn,
                                           generator=generator)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        if n_experts > 0:
            self.moe = MoEFeedForward(dim, n_experts, mlp_ratio,
                                      capacity_factor, expert_mesh,
                                      generator=generator)
        else:
            self.mlp1 = _dense(dim, dim * mlp_ratio, generator)
            self.mlp2 = _dense(dim * mlp_ratio, dim, generator)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = self.ln2(x)
        if self.n_experts > 0:
            return x + self.moe(h, sequence_group_of(
                self.attn.attention_fn))
        return x + self.mlp2(_gelu(self.mlp1(h)))


def _sinusoid(T: int, dim: int) -> np.ndarray:
    pos = np.arange(T)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pe = np.zeros((T, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class LongContextEncoder(nn.Module):
    """(B, T, in_features) → (B, T, dim): an embedding with sinusoidal
    positions, ``depth`` blocks, a final LayerNorm.  ``embed_in`` and
    ``finalize`` are the non-block parts, shared with the pipelined
    schedule (:func:`make_pipeline_forward_fn`).  (flax infers the
    embedding's input width; a torch module is given it.)

    With a ring over more than one rank, ``forward`` takes the whole
    batch on every rank, runs :meth:`block_forward` on this rank's
    T-block and gathers the blocks once at the exit."""

    def __init__(self, dim: int = 128, depth: int = 4, num_heads: int = 4,
                 attention_fn: Callable = full_attention, n_experts: int = 0,
                 expert_mesh=None, capacity_factor: float = 1.25, *,
                 in_features: int, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(seed)
        self.dim, self.depth = dim, depth
        self.attention_fn = attention_fn
        self.embed = _dense(in_features, dim, gen)
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(
                dim, num_heads, attention_fn=attention_fn,
                n_experts=n_experts, expert_mesh=expert_mesh,
                capacity_factor=capacity_factor, generator=gen))
        self.ln_out = nn.LayerNorm(dim, eps=LN_EPS)
        if generator is None:
            self.to(resolve_device(device))

    @property
    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    @property
    def sequence_group(self):
        """The ring's group (``None``: every rank holds the whole T)."""
        return sequence_group_of(self.attention_fn)

    def embed_in(self, x, offset: int = 0):
        """The embedding and the sinusoids of positions ``offset`` …
        ``offset + T − 1`` (a T-block's global positions)."""
        return self._positioned(self.embed(x), offset)

    def _positioned(self, h, offset: int):
        pe = torch.from_numpy(_sinusoid(offset + h.shape[1],
                                        self.dim)[offset:])
        return h + pe.to(h.device, h.dtype)

    def finalize(self, h):
        return self.ln_out(h)

    def forward(self, x):
        group = self.sequence_group
        if group is not None:
            return gather_blocks(self.block_forward(take_block(x, group)),
                                 group)
        h = self.embed_in(x)
        for block in self.blocks:
            h = block(h)
        return self.finalize(h)

    def block_forward(self, x):
        """This rank's (B, T/n, in_features) T-block
        (``parallel.sequence.shard_sequence``) in, its (B, T/n, dim)
        block out, as the reference's encoder maps a T-sharded batch;
        the parameters' gradients summed over the axis.  Without a ring,
        :meth:`forward`."""
        group = self.sequence_group
        if group is None:
            return self(x)
        return self.on_block(x, summed_parameters(self, group), group)

    def on_block(self, x, params: Dict[str, torch.Tensor], group):
        """The encoder on this rank's T-block ``x`` with ``params`` (the
        encoder's parameters by name) in place of its own."""
        call = functools.partial(_call_with, self, params)
        h = self._positioned(call("embed", x), group_rank(group) * x.shape[1])
        for i in range(self.depth):
            h = call(f"block{i}", h)
        return call("ln_out", h)


class AttentionASR(nn.Module):
    """DS2 with attention: conv front-end (stride 2 in time) → transformer
    encoder → CTC log-probs (B, T/2, n_alphabet).  Swap ``attention_fn``
    for ``RingAttentionLayer(mesh)`` to run the encoder and the head on
    this rank's block of the ``sequence`` axis (whole features in, whole
    log-probs out on every rank).  Built on ``device`` (the GPU unless
    ``device="cpu"``), in eval mode, from ``seed``."""

    def __init__(self, dim: int = 128, depth: int = 4, num_heads: int = 4,
                 n_alphabet: int = 29, n_mels: int = 13,
                 conv_channels: int = 32,
                 attention_fn: Callable = full_attention, n_experts: int = 0,
                 expert_mesh=None, capacity_factor: float = 1.25, *,
                 device=None, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dim, self.depth, self.num_heads = dim, depth, num_heads
        self.conv1 = nn.Conv2d(1, conv_channels, (11, n_mels), stride=(2, 1),
                               padding=(5, 0))
        with torch.no_grad():
            lecun_normal_(self.conv1.weight, self.conv1.weight[0].numel(),
                          gen)
            self.conv1.bias.zero_()
        self.encoder = LongContextEncoder(
            dim, depth, num_heads, attention_fn, n_experts, expert_mesh,
            capacity_factor, in_features=conv_channels, generator=gen)
        self.fc_out = _dense(dim, n_alphabet, gen)
        self.to(resolve_device(device))
        self.eval()

    def conv(self, x):
        """Conv front-end and clipped ReLU: (B, T, n_mels) → (B, T/2, C)."""
        B = x.shape[0]
        h = self.conv1(x[:, None])                   # (B, C, T', 1)
        h = h.permute(0, 2, 3, 1).reshape(B, h.shape[2], -1)
        return torch.clamp(h, 0.0, 20.0)

    def frontend(self, x):
        """Conv front-end, clipped ReLU and the encoder's embedding."""
        return self.encoder.embed_in(self.conv(x))

    def head(self, h):
        """Final LayerNorm and the CTC log-probs."""
        return torch.log_softmax(self.fc_out(self.encoder.finalize(h)), -1)

    def forward(self, x):
        group = self.encoder.sequence_group
        if group is not None:
            # the conv runs whole (its 11-frame window would need a halo
            # on a block); the rest on this rank's block, gathered once
            p = summed_parameters(self, group, skip=("conv1",))
            enc = {k[len("encoder."):]: v for k, v in p.items()
                   if k.startswith("encoder.")}
            h = self.encoder.on_block(take_block(self.conv(x), group), enc,
                                      group)
            return gather_blocks(torch.log_softmax(
                _call_with(self, p, "fc_out", h), -1), group)
        h = self.frontend(x)
        for block in self.encoder.blocks:
            h = block(h)
        return self.head(h)


def make_pipeline_forward_fn(model: AttentionASR, mesh, n_micro: int = 4,
                             axis_name: str = "pipe",
                             batch_axis: Optional[str] = None):
    """A ``forward_fn(module, inputs, train)`` for ``make_train_step`` /
    ``Optimizer`` running ``model``'s transformer blocks as GPipe stages
    over the mesh's ``pipe`` axis (``parallel.pipeline.pipeline_forward``,
    ``n_micro`` microbatches): the front-end and head are the model's own
    ``frontend``/``head`` on every rank, the blocks' parameters are
    stacked, one stage a rank.  The stages run ``full_attention``.
    Requires ``model.depth`` equal to the axis width and a batch
    divisible by ``n_micro``."""
    from torch.func import functional_call

    from analytics_zoo_tpu_torch.parallel.pipeline import (
        n_stages, pipeline_forward, split_microbatches, stack_stage_params)

    depth = model.depth
    if depth != n_stages(mesh, axis_name):
        raise ValueError(f"model depth {depth} != {axis_name!r} axis size "
                         f"{n_stages(mesh, axis_name)} (one block per "
                         f"device)")
    dev = next(model.parameters()).device
    block = TransformerBlock(model.dim, model.num_heads).to(dev)

    def forward_fn(module, inputs, train=False):
        B = inputs.shape[0]
        h = model.frontend(inputs)
        stacked = stack_stage_params([dict(b.named_parameters())
                                      for b in model.encoder.blocks])
        y = pipeline_forward(
            lambda p, x: functional_call(block, p, (x,)), stacked,
            split_microbatches(h, n_micro), mesh, axis_name=axis_name,
            batch_axis=batch_axis)
        return model.head(y.reshape((B,) + tuple(y.shape[2:])))

    return forward_fn
