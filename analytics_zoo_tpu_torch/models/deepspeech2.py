"""DeepSpeech2 acoustic model (counterpart of ``models/deepspeech2.py``):
mel features ``(B, T, n_mels)`` → log-probs ``(B, T', n_alphabet)``.

conv front-end (11 × n_mels, stride 2 in time) → sequence BN → clipped
ReLU → ``n_rnn_layers`` × (projection → sequence BN → BiRNN of
identity-input clipped-ReLU cells, directions summed) → BN → output
projection → log-softmax.  Module names are the flax scope names
(``conv1``, ``bn_conv1``, ``proj{i}``, ``bn_rnn{i}``, ``birnn{i}`` or
``rnn{i}``, ``bn_out``, ``fc_out``), so ``utils/convert.py`` maps a flax
tree by name.

In ``eval()`` mode sequence BN uses its running statistics; under
``train()`` it normalizes with the batch statistics of the valid frames
(``n_frames``) and updates the running ones with flax's semantics; in a
data-parallel step (``utils.spmd.global_batch``) the statistics are the
global batch's, their sums all-reduced with their gradient.

:func:`sequence_parallel_forward` runs the same model with the time axis
cut over a mesh's ``sequence`` axis (``parallel/sequence.py``): the conv
on halo-extended blocks, each BiRNN layer as one pipelined chunk scan of
both directions (K3 for a chunk under ``rnn_engine="pallas"``, K4 for
its backward), the log-probs gathered back along T.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.core.layers import lecun_normal_
from analytics_zoo_tpu_torch.core.rnn import BiRecurrent, Recurrent, RnnCell
from analytics_zoo_tpu_torch.ops.pallas_rnn import persistent_rnn
from analytics_zoo_tpu_torch.utils import spmd
from analytics_zoo_tpu_torch.utils.device import resolve_device


class SequenceBN(nn.Module):
    """BatchNorm over (B·T) per feature of a ``(B, T, F)`` sequence (flax
    ``BatchNorm``, reference ``BatchNormalizationDS``).

    ``eval()``: ``(x − mean) · scale / sqrt(var + ε) + bias`` with the
    running statistics.  ``train()``: the batch statistics over the frames
    where ``mask`` (broadcastable to ``x``, 1/True = valid) is set — all
    frames without one — as flax computes them: the mean and the biased
    variance ``E[x²] − E[x]²`` (clipped at 0), in fp32; the running
    statistics then move as ``ra = 0.9 · ra + 0.1 · batch`` (flax's
    ``momentum=0.9``, the complement of torch's ``momentum``)."""

    MOMENTUM = 0.9

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        if not self.training:
            shape = x.shape
            y = F.batch_norm(x.reshape(-1, shape[-1]), self.running_mean,
                             self.running_var, self.weight, self.bias,
                             training=False, eps=self.epsilon)
            return y.reshape(shape)
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        if spmd.global_width() > 1:
            mean, mean2 = self._global_moments(xf, mask, dims)
        elif mask is None:
            mean = xf.mean(dims)
            mean2 = (xf * xf).mean(dims)
        else:
            m = torch.broadcast_to(torch.as_tensor(mask, device=x.device),
                                   x.shape).float()
            count = m.sum(dims)
            mean = (xf * m).sum(dims) / count
            mean2 = (xf * xf * m).sum(dims) / count
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        # (every data rank sees the same global moments, so the running
        # statistics move alike everywhere)
        with torch.no_grad():
            self.running_mean.mul_(self.MOMENTUM).add_(
                (1.0 - self.MOMENTUM) * mean)
            self.running_var.mul_(self.MOMENTUM).add_(
                (1.0 - self.MOMENTUM) * var)
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.weight)
        return (y + self.bias).to(x.dtype)


    @staticmethod
    def _global_moments(xf: torch.Tensor, mask, dims):
        """The first two moments over every data rank's valid frames of a
        sharded step: the sums all-reduced with their gradient, the
        count without."""
        m = (torch.ones_like(xf[..., :1]) if mask is None else
             torch.broadcast_to(torch.as_tensor(mask, device=xf.device),
                                xf.shape[:-1] + (1,)).float())
        count = spmd.global_count(m.sum(dims))
        s1 = spmd.global_sum((xf * m).sum(dims))
        s2 = spmd.global_sum((xf * xf * m).sum(dims))
        return s1 / count, s2 / count


def ds2_valid_out_frames(n_frames):
    """Valid output frames of the stride-2 SAME conv for ``n_frames``
    valid inputs: ``ceil(n/2)``."""
    return (n_frames + 1) // 2


class DeepSpeech2(nn.Module):
    """``bidirectional=False`` is the streamable form (``rnn{i}`` layers
    with ``carry``/``return_carry``; the conv then runs VALID on input
    the caller has extended with context frames).  ``rnn_engine``:
    ``None``/``"blocked"`` (a loop over time), ``"pallas"`` (the
    persistent-RNN kernels, K3 forward and K4 backward) or ``"legacy"``
    (the per-step body, no ``n_frames``); the parameters are the same.

    Built on ``device`` (the GPU unless ``device="cpu"``), in eval mode,
    with weights from ``torch.Generator().manual_seed(seed)`` drawn from
    flax's distributions: lecun-normal kernels, zero biases, BN scale 1,
    bias 0, mean 0, var 1."""

    def __init__(self, hidden: int = 1024, n_rnn_layers: int = 3,
                 n_alphabet: int = 29, n_mels: int = 13,
                 conv_channels: int = 32, bidirectional: bool = True,
                 rnn_engine: Optional[str] = None, *, device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.hidden = hidden
        self.n_rnn_layers = n_rnn_layers
        self.n_mels = n_mels
        self.bidirectional = bidirectional
        self.rnn_engine = rnn_engine
        gen = torch.Generator().manual_seed(seed)
        self.conv1 = nn.Conv2d(1, conv_channels, (11, n_mels), stride=(2, 1))
        self.bn_conv1 = SequenceBN(conv_channels)
        cell = RnnCell(hidden, identity_input=True, activation="clipped_relu",
                       generator=gen)
        width = conv_channels
        for i in range(n_rnn_layers):
            self.add_module(f"proj{i}", nn.Linear(width, hidden))
            self.add_module(f"bn_rnn{i}", SequenceBN(hidden))
            if bidirectional:
                self.add_module(f"birnn{i}", BiRecurrent(
                    cell, merge="sum", engine=rnn_engine, generator=gen))
            else:
                self.add_module(f"rnn{i}", Recurrent(
                    cell, engine=rnn_engine, generator=gen))
            width = hidden
        self.bn_out = SequenceBN(hidden)
        self.fc_out = nn.Linear(hidden, n_alphabet)
        self._init_weights(gen)
        self.to(dev)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.conv1.weight, self.conv1.weight[0].numel(), gen)
        self.conv1.bias.zero_()
        for d in [getattr(self, f"proj{i}") for i in range(self.n_rnn_layers)
                  ] + [self.fc_out]:
            lecun_normal_(d.weight, d.in_features, gen)
            d.bias.zero_()

    def forward(self, x: torch.Tensor, n_frames=None, carry=None,
                return_carry: bool = False):
        """``n_frames`` (per-row valid input frames) masks padding: each
        RNN layer's carry freezes past ``ceil(n/2)`` output frames, the
        backward pass reverses only the valid prefix, and in training the
        BN statistics count valid frames only.  ``carry = {"h":
        (per-layer hidden,)}`` / ``return_carry`` stream a unidirectional
        model across calls."""
        streaming = carry is not None or return_carry
        if streaming and self.bidirectional:
            raise ValueError("streaming requires bidirectional=False")
        if n_frames is not None and self.rnn_engine == "legacy":
            raise ValueError("n_frames masking requires rnn_engine in "
                             "('blocked', 'pallas')")
        B = x.shape[0]
        pad = (0, 0) if streaming else (5, 0)
        # (under tensor-parallel rules the conv's weight arrives whole)
        h = F.conv2d(x[:, None], spmd.whole(self.conv1.weight),
                     self.conv1.bias, stride=(2, 1), padding=pad)
        # h: (B, 32, T', 1)
        # flax reshapes NHWC (B, T', 1, 32) to (B, T', 32): channels last
        h = h.permute(0, 2, 3, 1).reshape(B, h.shape[2], -1)
        out_n = bn_mask = None
        if n_frames is not None:
            out_n = ds2_valid_out_frames(
                torch.as_tensor(n_frames, device=x.device).long())
            bn_mask = (torch.arange(h.shape[1], device=x.device)[None, :]
                       < out_n[:, None])[..., None]        # (B, T', 1)
        h = torch.clamp(self.bn_conv1(h, bn_mask), 0.0, 20.0)
        new_h = []
        for i in range(self.n_rnn_layers):
            h = getattr(self, f"bn_rnn{i}")(getattr(self, f"proj{i}")(h),
                                           bn_mask)
            if self.bidirectional:
                h = getattr(self, f"birnn{i}")(h, n_frames=out_n)
            else:
                h0 = carry["h"][i] if carry is not None else None
                h, hN = getattr(self, f"rnn{i}")(
                    h, carry0=h0, return_carry=True, n_frames=out_n)
                new_h.append(hN)
        logits = self.fc_out(self.bn_out(h, bn_mask))
        out = torch.log_softmax(logits, dim=-1)
        if return_carry:
            return out, {"h": tuple(new_h)}
        return out


def _chunk_scan(engine: Optional[str], weight, bias):
    """One direction's chunk recurrence ``(h, pre (B, Tb, H)) → (h_final,
    ys)`` of the clipped-ReLU cell with h2h ``weight`` (out, in) and
    ``bias``: one ``persistent_rnn`` call (K3; K4 under autograd) for
    ``"pallas"``, else the blocked engine's loop over time."""
    if engine == "pallas":
        def chunk(h, pre):
            ys, cf = persistent_rnn(pre, weight.t(), bias, h[None],
                                    cell="vanilla", activation="clipped_relu")
            return cf[0], ys
        return chunk

    def chunk(h, pre):
        ys = []
        for t in range(pre.shape[1]):
            h = torch.clamp(pre[:, t] + F.linear(h, weight, bias), 0.0, 20.0)
            ys.append(h)
        return h, torch.stack(ys, 1)
    return chunk


def sequence_parallel_forward(model: DeepSpeech2, x, mesh,
                              axis_name: str = "sequence",
                              batch_axis: Optional[str] = None,
                              train: bool = False) -> torch.Tensor:
    """The DS2 forward with the time axis cut over the mesh's
    ``axis_name`` (counterpart of the reference's
    ``sequence_parallel_forward``); every rank of the axis calls it.

    ``x``: this rank's rows (of a ``batch_axis``) of the (B, T, n_mels)
    batch, whole in T; T must be divisible by 2·n_seq.  The rank keeps
    its T-block: the stride-2 conv runs VALID on the block extended by a
    5-frame halo each side (zeros at the ends: the global SAME padding),
    the projections and the output head act per frame, and each BiRNN
    layer is one n-round pipelined chunk scan of both directions
    (``parallel.sequence.pipelined_scans``) whose chunk is one
    ``persistent_rnn`` call under ``rnn_engine="pallas"`` (K3, and K4
    for its backward) and the blocked loop otherwise; a rank runs its
    chunks only in its own round.  Returns the (B, T/2, n_alphabet)
    log-probs gathered back whole on every rank of the axis.

    In eval the batch norms use their running statistics.  With
    ``train=True`` they normalise with the global batch statistics
    (sums all-reduced over the ``axis_name`` and ``batch_axis`` ranks,
    with their gradient) and move the running statistics as
    :class:`SequenceBN` does.  Gradients: the log-probs' gather hands
    each rank its block's cotangent, and the parameters' gradients are
    summed over the ``axis_name`` ranks, so every rank of a data
    coordinate holds its rows' whole gradient."""
    from analytics_zoo_tpu_torch.parallel import sequence as seq

    if not model.bidirectional:
        raise ValueError("the sequence-parallel forward runs the BiRNN "
                         "model (bidirectional=True)")
    seq_group, data_group = seq.sequence_groups(mesh, axis_name, batch_axis)
    n_seq = seq.group_size(seq_group)
    if x.shape[1] % (2 * n_seq):
        raise ValueError(
            f"T={x.shape[1]} must be divisible by 2·n_seq={2 * n_seq} "
            "(even per-device chunks for the stride-2 conv front-end)")
    dev = next(model.parameters()).device
    x = torch.as_tensor(x, device=dev)
    B, T, _ = x.shape
    tb = T // n_seq
    x_l = x.narrow(1, seq.group_rank(seq_group) * tb, tb)
    names, tensors = zip(*model.named_parameters())
    p = dict(zip(names, seq.summed_grads(tensors, seq_group)))
    sums_over = [g for g in (data_group, seq_group) if g is not None]
    n_rows = n_seq * seq.group_size(data_group)

    def bn(name, h):
        mod = getattr(model, name)
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        if not train:
            return F.batch_norm(h.reshape(-1, h.shape[-1]), mod.running_mean,
                                mod.running_var, w, b, training=False,
                                eps=mod.epsilon).reshape(h.shape)
        hf = h.float()
        s = torch.cat([hf.sum((0, 1)), (hf * hf).sum((0, 1))])
        for g in sums_over:
            s = spmd.all_reduce_sum(s, g)
        mean, mean2 = (s / (h.shape[0] * h.shape[1] * n_rows)).chunk(2)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            mod.running_mean.mul_(mod.MOMENTUM).add_(
                (1.0 - mod.MOMENTUM) * mean)
            mod.running_var.mul_(mod.MOMENTUM).add_(
                (1.0 - mod.MOMENTUM) * var)
        y = (hf - mean) * (torch.rsqrt(var + mod.epsilon) * w)
        return (y + b).to(h.dtype)

    # conv1: kernel 11, pad 5, stride 2 → a 5-frame halo each side, VALID
    ext = seq.halo_exchange(x_l[:, None], seq_group, 5, 5, time_axis=2)
    h = F.conv2d(ext, p["conv1.weight"], p["conv1.bias"], stride=(2, 1))
    h = h.permute(0, 2, 3, 1).reshape(B, h.shape[2], -1)
    h = torch.clamp(bn("bn_conv1", h), 0.0, 20.0)
    engine = model.rnn_engine
    for i in range(model.n_rnn_layers):
        h = bn(f"bn_rnn{i}", F.linear(h, p[f"proj{i}.weight"],
                                      p[f"proj{i}.bias"]))
        cells = [(p[f"birnn{i}.{d}.body.h2h.weight"],
                  p[f"birnn{i}.{d}.body.h2h.bias"]) for d in ("fwd", "bwd")]
        fwd, bwd = seq.pipelined_scans(
            [(_chunk_scan(engine, *cells[0]), False),
             (_chunk_scan(engine, *cells[1]), True)],
            h.new_zeros((B, model.hidden)), h, seq_group,
            params=[t for cell in cells for t in cell])
        h = fwd + bwd
    logits = F.linear(bn("bn_out", h), p["fc_out.weight"], p["fc_out.bias"])
    return seq.gather_blocks(torch.log_softmax(logits, dim=-1), seq_group,
                             axis=1)


def make_sequence_parallel_forward_fn(model: DeepSpeech2, mesh,
                                      axis_name: str = "sequence",
                                      batch_axis: Optional[str] = "data"):
    """A ``forward_fn(module, inputs, train)`` for ``make_train_step`` /
    ``Optimizer``: :func:`sequence_parallel_forward` of ``model`` over
    ``mesh`` (sequence-parallel CTC training on a ("data", "sequence")
    mesh).  Length-bucketed ``(features, n_frames)`` inputs are refused:
    the time-sharded forward has no ``n_frames`` masking."""

    def forward_fn(module, inputs, train=False):
        if isinstance(inputs, (tuple, list)):
            raise ValueError(
                "sequence-parallel DS2 has no n_frames masking and does "
                "not support length-bucketed (features, n_frames) "
                "batches — train with bucket_edges=None (pad to a fixed "
                "utt_length) when sequence_parallel=True")
        return sequence_parallel_forward(model, inputs, mesh,
                                         axis_name=axis_name,
                                         batch_axis=batch_axis, train=train)

    return forward_fn
