"""Recurrent layers (counterpart of ``core/rnn.py``): time is axis 1,
``[B, T, D] → [B, T, H]``.

Every cell splits its work into ``project`` (the input-side products,
run once over the whole sequence) and ``recur`` (one step of the h2h
recurrence from a projected input), and its parameters carry the flax
names (``h2h``; ``ir/iz/in/hr/hz/hn``; ``ii…io/hi…ho``), so a flax tree
maps onto the module by name (``utils/convert.py``).

``Recurrent(engine=...)`` picks the schedule; the engines share one
parameter set:

- ``"legacy"`` — the per-step body: each step computes its own input
  projection and the h2h product (the cell's ``forward``); the reverse
  direction flips time.  No length masking (``n_frames`` raises, as in
  the reference); kept as the A/B baseline of the other two;
- ``"blocked"`` (the default) — a plain loop over time on the projected
  inputs, with the reference's masking;
- ``"pallas"`` — the persistent-RNN kernels (``ops/pallas_rnn.py``): one
  launch of K3 runs the whole time axis on the card, and under autograd
  one launch of K4 its backward.  A geometry a kernel cannot take raises,
  naming the pass; nothing falls back to the loop.

``n_frames`` (per-row valid lengths, clamped to T) freezes a row's carry
past its length and zeroes those outputs; ``reverse=True`` then reverses
only each row's valid prefix (a per-row gather, not a whole-axis flip),
so padding never enters the backward direction first.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from analytics_zoo_tpu_torch.core.layers import lecun_normal_
from analytics_zoo_tpu_torch.ops.pallas_rnn import persistent_rnn
from analytics_zoo_tpu_torch.utils.spmd import whole

ENGINES = ("legacy", "blocked", "pallas")


def _dense(in_features: int, out_features: int, bias: bool,
           generator=None, orthogonal: bool = False) -> nn.Linear:
    """A flax ``Dense`` as ``nn.Linear``: lecun-normal (or orthogonal)
    kernel, zero bias."""
    d = nn.Linear(in_features, out_features, bias=bias)
    _reset_dense(d, generator, orthogonal)
    return d


@torch.no_grad()
def _reset_dense(d: nn.Linear, generator=None, orthogonal: bool = False):
    if orthogonal:
        nn.init.orthogonal_(d.weight, generator=generator)
    else:
        lecun_normal_(d.weight, d.in_features, generator)
    if d.bias is not None:
        d.bias.zero_()


class RnnCell(nn.Module):
    """Vanilla RNN cell: ``h' = act(W_i x + W_h h + b)``.

    ``identity_input=True`` is the DS2 form: the input is already
    projected by the preceding layer, so there is no ``i2h`` and the
    input width must equal ``hidden_size``."""

    def __init__(self, hidden_size: int, identity_input: bool = False,
                 activation: str = "relu", input_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.identity_input = identity_input
        self.activation = activation
        if not identity_input:
            if input_size is None:
                raise ValueError("RnnCell needs input_size unless "
                                 "identity_input=True")
            self.i2h = _dense(input_size, hidden_size, True, generator)
        self.h2h = _dense(hidden_size, hidden_size, True, generator)

    def reset_parameters(self, generator=None) -> None:
        for d in self.children():
            _reset_dense(d, generator)

    def project(self, x):
        return x if self.identity_input else self.i2h(x)

    def recur(self, carry, pre):
        z = pre + self.h2h(carry)
        if self.activation == "relu":
            new_h = torch.relu(z)
        elif self.activation == "clipped_relu":
            new_h = torch.clamp(z, 0.0, 20.0)
        else:
            new_h = torch.tanh(z)
        return new_h, new_h

    def forward(self, carry, x):
        return self.recur(carry, self.project(x))

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=device)


class _GruGates(nn.Module):
    """flax ``GRUCell`` gate math with the input products split out:
    biased input denses ``ir/iz/in``, orthogonal recurrent denses
    ``hr/hz`` (no bias) and ``hn`` (biased)."""

    def __init__(self, features: int, input_size: int, generator=None):
        super().__init__()
        H = features
        for name in ("ir", "iz", "in"):
            self.add_module(name, _dense(input_size, H, True, generator))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            self.add_module(name, _dense(H, H, bias, generator, True))

    def reset_parameters(self, generator=None) -> None:
        for name, d in self.named_children():
            _reset_dense(d, generator, name.startswith("h"))

    def project(self, x):
        return torch.cat([getattr(self, g)(x) for g in ("ir", "iz", "in")],
                         -1)

    def recur(self, h, pre):
        i_r, i_z, i_n = pre.chunk(3, -1)
        r = torch.sigmoid(i_r + self.hr(h))
        z = torch.sigmoid(i_z + self.hz(h))
        n = torch.tanh(i_n + r * self.hn(h))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class GRUCell(nn.Module):
    def __init__(self, hidden_size: int, input_size: int, generator=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.gru = _GruGates(hidden_size, input_size, generator)

    def reset_parameters(self, generator=None) -> None:
        self.gru.reset_parameters(generator)

    def project(self, x):
        return self.gru.project(x)

    def recur(self, carry, pre):
        return self.gru.recur(carry, pre)

    def forward(self, carry, x):
        return self.recur(carry, self.project(x))

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=device)


class _LstmGates(nn.Module):
    """flax ``OptimizedLSTMCell`` gate math with the input products split
    out: unbiased input kernels ``ii/if/ig/io``, biased orthogonal
    recurrent kernels ``hi/hf/hg/ho``; gate order (i, f, g, o)."""

    def __init__(self, features: int, input_size: int, generator=None):
        super().__init__()
        H = features
        for name in ("ii", "if", "ig", "io"):
            self.add_module(name, _dense(input_size, H, False, generator))
        for name in ("hi", "hf", "hg", "ho"):
            self.add_module(name, _dense(H, H, True, generator, True))

    def reset_parameters(self, generator=None) -> None:
        for name, d in self.named_children():
            _reset_dense(d, generator, name.startswith("h"))

    def project(self, x):
        return torch.cat([getattr(self, g)(x)
                          for g in ("ii", "if", "ig", "io")], -1)

    def recur(self, carry, pre):
        c, h = carry
        i_i, i_f, i_g, i_o = pre.chunk(4, -1)
        i = torch.sigmoid(i_i + self.hi(h))
        f = torch.sigmoid(i_f + self.hf(h))
        g = torch.tanh(i_g + self.hg(h))
        o = torch.sigmoid(i_o + self.ho(h))
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class LSTMCell(nn.Module):
    def __init__(self, hidden_size: int, input_size: int, generator=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.lstm = _LstmGates(hidden_size, input_size, generator)

    def reset_parameters(self, generator=None) -> None:
        self.lstm.reset_parameters(generator)

    def project(self, x):
        return self.lstm.project(x)

    def recur(self, carry, pre):
        return self.lstm.recur(carry, pre)

    def forward(self, carry, x):
        return self.recur(carry, self.project(x))

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        z = torch.zeros((batch, self.hidden_size), dtype=dtype, device=device)
        return (z, z)


def _pallas_cell_kind(cell) -> str:
    """Kernel cell kind of a cell of this module."""
    for kind, cls in (("vanilla", RnnCell), ("gru", GRUCell),
                      ("lstm", LSTMCell)):
        if isinstance(cell, cls):
            return kind
    raise ValueError(f"engine='pallas' has no kernel for "
                     f"{type(cell).__name__}")


def _stack_recurrent_params(kind: str, cell):
    """Gate-stack a cell's h2h kernels and biases into the ``[H, k·H]`` /
    ``[k·H]`` layout of ``ops.pallas_rnn``, in each cell's ``project``
    order; unbiased gates contribute zero bias columns.  A weight sharded
    by tensor-parallel rules arrives gathered whole (its gradient sliced
    back to the shard: ``utils.spmd.whole``)."""
    if kind == "vanilla":
        return whole(cell.h2h.weight).t(), cell.h2h.bias
    if kind == "gru":
        g = cell.gru
        w = torch.cat([whole(g.hr.weight).t(), whole(g.hz.weight).t(),
                       whole(g.hn.weight).t()], 1)
        b = torch.cat([g.hn.bias.new_zeros(2 * cell.hidden_size), g.hn.bias])
        return w, b
    lstm = cell.lstm
    names = ("hi", "hf", "hg", "ho")
    w = torch.cat([whole(getattr(lstm, k).weight).t() for k in names], 1)
    b = torch.cat([getattr(lstm, k).bias for k in names])
    return w, b


def _check_shards(shards: Optional[int]) -> Optional[int]:
    """``pallas_data_shards``: the reference divides the jit-global batch
    by it to price the kernel's VMEM.  A rank here sees its own rows and
    the Hopper fit (``ops.pallas_rnn.check_hopper_fit``) does not depend
    on the batch, so it is validated and kept, with no effect."""
    if shards is not None and (not isinstance(shards, int) or shards < 1):
        raise ValueError(f"pallas_data_shards={shards!r} must be None or a "
                         f"positive int")
    return shards


def _masked_step(cell, carry, pre_t, m_t):
    """One recurrence step with an optional per-row validity mask: an
    invalid row's carry freezes and its output is zeroed."""
    new_carry, y = cell.recur(carry, pre_t)
    if m_t is not None:
        keep = m_t[:, None]
        if isinstance(new_carry, tuple):
            new_carry = tuple(torch.where(keep, nw, old)
                              for nw, old in zip(new_carry, carry))
        else:
            new_carry = torch.where(keep, new_carry, carry)
        y = torch.where(keep, y, torch.zeros_like(y))
    return new_carry, y


class Recurrent(nn.Module):
    """Run a cell over time axis 1: ``[B, T, D] → [B, T, H]``.

    The cell passed in is a template: the layer keeps its own copy as
    ``body`` (the flax scope name) with freshly drawn weights, so two
    layers built from one template do not share parameters."""

    def __init__(self, cell: nn.Module, reverse: bool = False,
                 engine: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 pallas_data_shards: Optional[int] = None):
        super().__init__()
        if engine not in (None,) + ENGINES:
            raise ValueError(f"engine={engine!r} not in {ENGINES}")
        self.body = copy.deepcopy(cell)
        self.body.reset_parameters(generator)
        self.reverse = reverse
        self.engine = engine
        self.pallas_data_shards = _check_shards(pallas_data_shards)

    def _resolve_engine(self) -> str:
        return self.engine or "blocked"

    def forward(self, x, carry0=None, return_carry: bool = False,
                n_frames=None):
        """``carry0``/``return_carry`` expose the boundary state for
        streaming inference (chunked input, state carried across calls)."""
        engine = self._resolve_engine()
        if engine == "legacy":
            if n_frames is not None:
                raise ValueError(
                    "length masking (n_frames) requires engine='blocked' "
                    "or 'pallas' — the legacy per-step scan has no masked "
                    "reverse")
            return self._legacy_scan(x, carry0, return_carry)
        B, T, _ = x.shape
        n = mask = perm = None
        if n_frames is not None:
            # clamp to T: a longer claim would drive the reverse prefix
            # gather out of bounds
            n = torch.as_tensor(n_frames, device=x.device).long().clamp(
                max=T)
            t_idx = torch.arange(T, device=x.device)
            mask = t_idx[None, :] < n[:, None]
            if self.reverse:
                perm = torch.where(mask, n[:, None] - 1 - t_idx[None, :],
                                   t_idx[None, :])
                x = torch.take_along_dim(x, perm[..., None], 1)
        elif self.reverse:
            x = torch.flip(x, (1,))

        pre = self.body.project(x)
        carry = (carry0 if carry0 is not None
                 else self.body.initial_carry(B, x.dtype, x.device))
        if engine == "pallas":
            ys, carry = self._pallas_scan(pre, carry, n)
        else:
            ys, carry = self._blocked_scan(pre, carry, mask)
        if self.reverse:
            ys = (torch.take_along_dim(ys, perm[..., None], 1)
                  if perm is not None else torch.flip(ys, (1,)))
        return (ys, carry) if return_carry else ys

    def _legacy_scan(self, x, carry0, return_carry):
        """The per-step body: the cell's whole step (input projection and
        h2h product) at every time index; reverse flips time."""
        if self.reverse:
            x = torch.flip(x, (1,))
        carry = (carry0 if carry0 is not None
                 else self.body.initial_carry(x.shape[0], x.dtype, x.device))
        ys = []
        for t in range(x.shape[1]):
            carry, y = self.body(carry, x[:, t])
            ys.append(y)
        ys = (torch.stack(ys, 1) if ys
              else x.new_zeros((x.shape[0], 0, self.body.hidden_size)))
        if self.reverse:
            ys = torch.flip(ys, (1,))
        return (ys, carry) if return_carry else ys

    def _blocked_scan(self, pre, carry, mask):
        ys = []
        for t in range(pre.shape[1]):
            carry, y = _masked_step(self.body, carry, pre[:, t],
                                    None if mask is None else mask[:, t])
            ys.append(y)
        if not ys:
            return pre.new_zeros((pre.shape[0], 0, self.body.hidden_size)), \
                carry
        return torch.stack(ys, 1), carry

    def _pallas_scan(self, pre, carry, n):
        """The whole recurrence in one K3 launch on the hoisted
        projections (and its gradient in one K4 launch).  Under autocast
        the h2h kernel is cast to the autocast type, as the reference
        casts every parameter under a bf16 ``compute_dtype``; its
        gradient reaches the fp32 parameter through that cast."""
        kind = _pallas_cell_kind(self.body)
        w, b = _stack_recurrent_params(kind, self.body)
        dev = pre.device
        if torch.is_autocast_enabled(dev.type):
            w = w.to(torch.get_autocast_dtype(dev.type))
        h0 = torch.stack(carry) if isinstance(carry, tuple) else carry[None]
        ys, cf = persistent_rnn(pre, w, b, h0, n, cell=kind,
                                activation=getattr(self.body, "activation",
                                                   "relu"))
        final = (tuple(cf[i] for i in range(cf.shape[0]))
                 if isinstance(carry, tuple) else cf[0])
        return ys, final


class BiRecurrent(nn.Module):
    """Forward plus time-reversed pass over one cell template, merged by
    ``"sum"`` (DS2) or ``"concat"``.  ``n_frames`` masks both directions;
    the backward one reverses each row's valid prefix only."""

    def __init__(self, cell: nn.Module, merge: str = "sum",
                 engine: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 pallas_data_shards: Optional[int] = None):
        super().__init__()
        if merge not in ("sum", "concat"):
            raise ValueError(f"merge={merge!r} not in ('sum', 'concat')")
        self.merge = merge
        self.pallas_data_shards = _check_shards(pallas_data_shards)
        self.fwd = Recurrent(cell, engine=engine, generator=generator,
                             pallas_data_shards=pallas_data_shards)
        self.bwd = Recurrent(cell, reverse=True, engine=engine,
                             generator=generator,
                             pallas_data_shards=pallas_data_shards)

    def forward(self, x, n_frames=None):
        fwd = self.fwd(x, n_frames=n_frames)
        bwd = self.bwd(x, n_frames=n_frames)
        if self.merge == "sum":
            return fwd + bwd
        return torch.cat([fwd, bwd], -1)
