"""Kernels K3 and K4: the persistent-RNN forward and its transposed
backward (counterpart of ``ops/pallas_rnn.py``).

:func:`persistent_rnn` runs one direction's recurrence over the hoisted
input projections: every step computes ``hh = h·w + b`` in fp32 (``h``
rounded to ``w``'s type first), the vanilla / GRU / LSTM gate math, and
the ``n_frames`` mask — a row past its length freezes its carry and
emits 0.  On a CUDA tensor it launches ``csrc/persistent_rnn.cu``, one
cooperative launch that walks the whole time axis; on a CPU tensor it
runs :func:`persistent_rnn_plain`, the forward of the reference's
``_scan_reference`` as a loop over time.

Under autograd the recurrence is :class:`_Persistent`: its forward is K3
with the fp32 carry saved at every ``time_block``-th step (``cs``), its
backward K4 (``csrc/persistent_rnn_bwd.cu``, plain version
:func:`persistent_rnn_bwd_plain`), which walks the time blocks in
reverse, recomputes each from its saved carry and returns ``d_pre``,
``d_w``, ``d_b`` and ``d_h0``.  ``backward="scan"`` differentiates
through :func:`persistent_rnn_plain` instead (the reference's
``_scan_reference`` vjp): tests ask for it, the main path never does.
Without autograd K3 saves nothing.

The reference's VMEM budget and its warn-and-fall-back to the blocked
scan are TPU planning.  Here :func:`check_hopper_fit` holds a geometry
to the kernels' shared-memory need and raises, naming the limit and the
pass; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from analytics_zoo_tpu_torch.utils import cuda_build

# gates per cell (k: width multiple of the stacked h2h product) and carry
# slots (C: vanilla/gru carry h; lstm carries (c, h))
CELL_GATES = {"vanilla": 1, "gru": 3, "lstm": 4}
CELL_CARRY = {"vanilla": 1, "gru": 1, "lstm": 2}
ACTIVATIONS = ("relu", "clipped_relu", "tanh")
BACKWARDS = ("pallas", "scan")

#: the kernels' block: 256 threads, batch rows 8 at a time
KERNEL_THREADS = 256
KERNEL_ROWS = 8
#: H100 SXM defaults for :func:`check_hopper_fit` off the card
H100_SMS = 132
H100_SMEM_OPTIN = 232448


class RnnKernelConfig(NamedTuple):
    """Static kernel config.  ``time_block`` is the number of steps
    between two saved carries (the reference's unroll per grid step):
    the backward recomputes one such block at a time."""

    cell: str               # 'vanilla' | 'gru' | 'lstm'
    activation: str         # vanilla only: 'relu' | 'clipped_relu' | 'tanh'
    time_block: int = 8


def hopper_smem_bytes(hidden: int, cell: str = "vanilla",
                      n_sm: int = H100_SMS) -> int:
    """Shared memory one block of K3 needs besides its slice of ``W``
    (which is read from L2 when it does not fit): ``h`` transposed for 8
    batch rows, the split-K partial sums, and two stages of ``pre``.
    Mirrors ``base_smem_bytes`` in the CUDA source."""
    cols = -(-hidden // n_sm)
    nc = CELL_GATES[cell] * cols
    slices = KERNEL_THREADS // max(nc, 1)
    return 4 * (hidden * KERNEL_ROWS + slices * KERNEL_ROWS * nc
                + 2 * KERNEL_ROWS * nc)


def hopper_bwd_smem_bytes(hidden: int, cell: str = "vanilla",
                          n_sm: int = H100_SMS, weight_bytes: int = 4) -> int:
    """Shared memory one block of K4's sweep needs: the ``k·H`` products
    transposed for 8 batch rows, the split-K partial sums, and one slice
    of ``W`` (``H × k·cols``, the column slice and the row slice by turns).
    Mirrors ``bwd_smem_bytes`` in the CUDA source."""
    cols = -(-hidden // n_sm)
    kH = CELL_GATES[cell] * hidden
    return (4 * (kH * KERNEL_ROWS + KERNEL_THREADS * KERNEL_ROWS)
            + kH * cols * weight_bytes)


def check_hopper_fit(hidden: int, cell: str = "vanilla",
                     n_sm: int = H100_SMS,
                     smem_limit: int = H100_SMEM_OPTIN,
                     backward: bool = False, weight_bytes: int = 4) -> None:
    """Raise ``ValueError`` naming the limit when a kernel cannot take
    ``hidden``: each of at most ``n_sm`` resident blocks owns
    ``ceil(hidden/n_sm)`` columns of every gate (≤ 256, one per thread)
    and must hold ``h`` in shared memory (K3, the forward); with
    ``backward``, K4's block must also hold its slice of ``W`` there."""
    nc = CELL_GATES[cell] * -(-hidden // n_sm)
    if nc > KERNEL_THREADS:
        raise ValueError(
            f"persistent_rnn: H={hidden} ({cell}) gives {nc} product "
            f"columns a block, over the {KERNEL_THREADS} threads of one "
            f"block on {n_sm} SMs")
    need = hopper_smem_bytes(hidden, cell, n_sm)
    if need > smem_limit:
        raise ValueError(
            f"persistent_rnn: H={hidden} ({cell}) needs {need} bytes of "
            f"shared memory a block, over the {smem_limit}-byte limit of "
            f"this card")
    if backward:
        need = hopper_bwd_smem_bytes(hidden, cell, n_sm, weight_bytes)
        if need > smem_limit:
            raise ValueError(
                f"persistent_rnn backward (K4): H={hidden} ({cell}) needs "
                f"{need} bytes of shared memory a block, over the "
                f"{smem_limit}-byte limit of this card")


def _cell_step(cfg: RnnKernelConfig, pre_t, hh, carry):
    """One step of gate math from the input projection ``pre_t`` and the
    recurrent projection ``hh`` (both fp32, gate-stacked).  Returns
    (new_carry, output), as ``core.rnn``'s ``recur`` methods compute it."""
    if cfg.cell == "vanilla":
        z = pre_t + hh
        if cfg.activation == "relu":
            act = torch.clamp(z, min=0.0)
        elif cfg.activation == "clipped_relu":
            act = torch.clamp(z, 0.0, 20.0)
        else:
            act = torch.tanh(z)
        return (act,), act
    if cfg.cell == "gru":
        (h,) = carry
        i_r, i_z, i_n = pre_t.chunk(3, -1)
        h_r, h_z, h_n = hh.chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        new_h = (1.0 - z) * n + z * h
        return (new_h,), new_h
    # lstm — gate order (i, f, g, o), carry (c, h)
    c, h = carry
    i_i, i_f, i_g, i_o = pre_t.chunk(4, -1)
    h_i, h_f, h_g, h_o = hh.chunk(4, -1)
    i = torch.sigmoid(i_i + h_i)
    f = torch.sigmoid(i_f + h_f)
    g = torch.tanh(i_g + h_g)
    o = torch.sigmoid(i_o + h_o)
    new_c = f * c + i * g
    new_h = o * torch.tanh(new_c)
    return (new_c, new_h), new_h


def _cell_vjp(cfg: RnnKernelConfig, pre_t, hh, carry, g_carry, g_y):
    """The VJP of :func:`_cell_step` at one step, written out: the
    cotangents of the new carry and of the output (the new h) pulled back
    to ``(d_pre, d_hh, d_carry_in)``.  The kernel K4 computes the same
    expressions."""
    g_h = g_carry[-1] + g_y
    if cfg.cell == "vanilla":
        z = pre_t + hh
        if cfg.activation == "relu":
            d = torch.where(z > 0, g_h, 0.0)
        elif cfg.activation == "clipped_relu":
            d = torch.where((z > 0) & (z < 20.0), g_h, 0.0)
        else:
            y = torch.tanh(z)
            d = g_h * (1.0 - y * y)
        return d, d, (torch.zeros_like(g_h),)
    if cfg.cell == "gru":
        (h,) = carry
        i_r, i_z, i_n = pre_t.chunk(3, -1)
        h_r, h_z, h_n = hh.chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        da_n = g_h * (1.0 - z) * (1.0 - n * n)
        da_r = da_n * h_n * r * (1.0 - r)
        da_z = g_h * (h - n) * z * (1.0 - z)
        return (torch.cat([da_r, da_z, da_n], -1),
                torch.cat([da_r, da_z, da_n * r], -1), (g_h * z,))
    c, _ = carry
    i_i, i_f, i_g, i_o = pre_t.chunk(4, -1)
    h_i, h_f, h_g, h_o = hh.chunk(4, -1)
    i = torch.sigmoid(i_i + h_i)
    f = torch.sigmoid(i_f + h_f)
    g = torch.tanh(i_g + h_g)
    o = torch.sigmoid(i_o + h_o)
    tc = torch.tanh(f * c + i * g)
    dc = g_carry[0] + g_h * o * (1.0 - tc * tc)
    d = torch.cat([dc * g * i * (1.0 - i), dc * c * f * (1.0 - f),
                   dc * i * (1.0 - g * g), g_h * tc * o * (1.0 - o)], -1)
    return d, d, (dc * f, torch.zeros_like(g_h))


def _no_autocast(device: torch.device):
    """The plain versions repeat the kernels' fp32 arithmetic (bf16 only
    where ``w`` is bf16), whatever autocast region they are called in."""
    return torch.autocast(device.type, enabled=False)


def persistent_rnn_plain(cfg: RnnKernelConfig, pre, w, b, h0, n,
                         save_residuals: bool = False):
    """Plain PyTorch version of K3: the forward of the reference's
    ``_scan_reference``, one loop iteration a step.  ``n`` is ``[B]``
    int valid lengths already clamped to T.  With ``save_residuals`` it
    also returns the fp32 carry at the start of every ``time_block``-th
    step, ``cs [ceil(T/U), C, B, H]`` (the carry is frozen past every
    row's length, so later blocks hold the final carry)."""
    B, T, _ = pre.shape
    dt = pre.dtype
    U = cfg.time_block
    with _no_autocast(pre.device):
        n_col = n.to(pre.device)[:, None]
        carry = tuple(h0[i].float() for i in range(CELL_CARRY[cfg.cell]))
        wf = w.float()
        bf = b.float()
        ys, cs = [], []
        for t in range(T):
            if t % U == 0:
                cs.append(torch.stack(carry))
            keep = n_col > t
            hh = carry[-1].to(w.dtype).float() @ wf + bf
            new_carry, y = _cell_step(cfg, pre[:, t].float(), hh, carry)
            carry = tuple(torch.where(keep, nw, old)
                          for nw, old in zip(new_carry, carry))
            ys.append(torch.where(keep, y, torch.zeros_like(y)))
        out = (torch.stack(ys, 1) if ys
               else pre.new_zeros((B, 0, w.shape[0]), dtype=torch.float32))
        result = (out.to(dt), torch.stack(carry).to(dt))
        if not save_residuals:
            return result
        cs = (torch.stack(cs) if cs else
              pre.new_zeros((0,) + tuple(h0.shape), dtype=torch.float32))
        return result + (cs,)


def persistent_rnn_bwd_plain(cfg: RnnKernelConfig, pre, w, b, n, cs, g_ys,
                             g_cf):
    """Plain PyTorch version of K4 (the reference's ``_rnn_bwd_kernel``):
    an explicit reversed loop over the time blocks.  Each block is
    recomputed forward from its saved carry ``cs[blk]``, then swept in
    reverse through :func:`_cell_vjp`; ``dh`` flows through ``w``
    transposed, ``dW += h_inᵀ·d_hh`` (``h_in`` rounded to ``w``'s type)
    and ``db += Σ d_hh`` accumulate in fp32, and a masked step passes the
    carry's cotangent through.  Returns ``(d_pre, d_w, d_b, d_h0)`` in the
    types of ``pre``, ``w``, ``b`` and ``g_cf``."""
    B, T, kH = pre.shape
    H = w.shape[0]
    U = cfg.time_block
    with _no_autocast(pre.device):
        n_col = n.to(pre.device)[:, None]
        wf = w.float()
        bf = b.float()
        g_carry = [g_cf[i].float() for i in range(CELL_CARRY[cfg.cell])]
        d_pre = pre.new_zeros((B, T, kH), dtype=torch.float32)
        d_w = pre.new_zeros((H, kH), dtype=torch.float32)
        d_b = pre.new_zeros((kH,), dtype=torch.float32)
        for blk in reversed(range(-(-T // U))):
            t0 = blk * U
            steps = min(U, T - t0)
            carry = tuple(cs[blk, i].float() for i in range(len(g_carry)))
            carries, hhs = [carry], []
            for t in range(t0, t0 + steps):
                hh = carry[-1].to(w.dtype).float() @ wf + bf
                new_carry, _ = _cell_step(cfg, pre[:, t].float(), hh, carry)
                carry = tuple(torch.where(n_col > t, nw, old)
                              for nw, old in zip(new_carry, carry))
                carries.append(carry)
                hhs.append(hh)
            for u in reversed(range(steps)):
                t = t0 + u
                keep = n_col > t
                dp, dq, d_in = _cell_vjp(cfg, pre[:, t].float(), hhs[u],
                                         carries[u], g_carry,
                                         g_ys[:, t].float())
                dq = torch.where(keep, dq, 0.0)
                g_carry = [torch.where(keep, d, g)
                           for d, g in zip(d_in, g_carry)]
                g_carry[-1] = g_carry[-1] + dq @ wf.t()
                d_w += carries[u][-1].to(w.dtype).float().t() @ dq
                d_b += dq.sum(0)
                d_pre[:, t] = torch.where(keep, dp, 0.0)
        return (d_pre.to(pre.dtype), d_w.to(w.dtype), d_b.to(b.dtype),
                torch.stack(g_carry).to(g_cf.dtype))


def _launch_persistent_rnn(cfg, pre, w, b, h0, n, ys, cf, cs=None):
    fn = cuda_build.load_function(
        "persistent_rnn", "az_persistent_rnn",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    B, T, _ = pre.shape
    H = w.shape[0]
    dev = pre.device
    # ping-pong carry, rows padded to whole float4s
    hbuf = torch.empty((2, B, -(-H // 4) * 4), dtype=torch.float32,
                       device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(pre.data_ptr(), w.data_ptr(),
                  int(w.dtype == torch.bfloat16), b.data_ptr(),
                  h0.data_ptr(), n.data_ptr(), ys.data_ptr(), cf.data_ptr(),
                  hbuf.data_ptr(), bar.data_ptr(),
                  None if cs is None else cs.data_ptr(), B, T, H,
                  list(CELL_GATES).index(cfg.cell),
                  ACTIVATIONS.index(cfg.activation), cfg.time_block, stream)
    cuda_build.check_launch("persistent_rnn", code, "persistent_rnn kernel")


def _launch_persistent_rnn_bwd(cfg, pre, w, b, n, cs, g_ys, g_cf):
    fn = cuda_build.load_function(
        "persistent_rnn_bwd", "az_persistent_rnn_bwd",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 13
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    B, T, kH = pre.shape
    H = w.shape[0]
    C = CELL_CARRY[cfg.cell]
    U = cfg.time_block
    dev = pre.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    d_pre, dwb, d_h0 = f32(B, T, kH), f32(H + 1, kH), f32(C, B, H)
    # scratch: d_hh (GRU; vanilla and LSTM read d_pre), the h every step
    # reads, the time block's hh and LSTM c, the published d_hh, and the
    # carry's running cotangent
    dhh = f32(B, T, kH) if cfg.cell == "gru" else d_pre
    hin = f32(B, T, -(-H // 4) * 4)
    hhs = f32(U, B, kH)
    cin = f32(U, B, H) if cfg.cell == "lstm" else hhs
    dpub, dst = f32(2, B, -(-kH // 4) * 4), f32(C, B, H)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(pre.data_ptr(), g_ys.data_ptr(), cs.data_ptr(),
                  w.data_ptr(), int(w.dtype == torch.bfloat16), b.data_ptr(),
                  g_cf.data_ptr(), n.data_ptr(), d_pre.data_ptr(),
                  dwb.data_ptr(), d_h0.data_ptr(), dhh.data_ptr(),
                  hin.data_ptr(), hhs.data_ptr(), cin.data_ptr(),
                  dpub.data_ptr(), dst.data_ptr(), bar.data_ptr(), B, T, H,
                  list(CELL_GATES).index(cfg.cell),
                  ACTIVATIONS.index(cfg.activation), U, stream)
    cuda_build.check_launch("persistent_rnn_bwd", code,
                            "persistent_rnn_bwd kernel")
    return d_pre, dwb[:H], dwb[H], d_h0


def _check_device(cell: str, pre, w, backward: bool):
    """Raise unless the kernels take these tensors on their CUDA device
    (K4 too when ``backward``)."""
    dev = pre.device
    if dev.type != "cuda":
        raise ValueError(f"persistent_rnn: no kernel for device {dev}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"persistent_rnn: w must be fp32 or bf16, got "
                         f"{w.dtype}")
    props = torch.cuda.get_device_properties(dev)
    check_hopper_fit(w.shape[0], cell, props.multi_processor_count,
                     props.shared_memory_per_block_optin, backward,
                     w.element_size())


def persistent_rnn_fwd(cfg: RnnKernelConfig, pre, w, b, h0, n,
                       save_residuals: bool = False):
    """K3 (the reference's ``_run_kernel``) on a CUDA tensor, its plain
    version on a CPU tensor: ``(ys, carry)``, and with ``save_residuals``
    also the block-start carries ``cs``.  ``n`` is ``[B]`` int32 clamped
    to T; the caller has checked the shapes (:func:`persistent_rnn`)."""
    if pre.device.type == "cpu":
        return persistent_rnn_plain(cfg, pre, w, b, h0, n, save_residuals)
    _check_device(cfg.cell, pre, w, backward=False)
    B, T, _ = pre.shape
    H = w.shape[0]
    C = CELL_CARRY[cfg.cell]
    dev = pre.device
    cs = (torch.empty((-(-T // cfg.time_block), C, B, H),
                      dtype=torch.float32, device=dev)
          if save_residuals else None)
    if B == 0 or T == 0:
        out = (pre.new_zeros((B, T, H)), h0.to(pre.dtype))
        if save_residuals:
            cs.copy_(h0.float().expand_as(cs))
            return out + (cs,)
        return out
    ys = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    cf = torch.empty((C, B, H), dtype=torch.float32, device=dev)
    _launch_persistent_rnn(cfg, pre.float().contiguous(), w.contiguous(),
                           b.float().contiguous(), h0.float().contiguous(),
                           n.contiguous(), ys, cf, cs)
    persistent_rnn.launches += 1
    out = (ys.to(pre.dtype), cf.to(pre.dtype))
    return out + (cs,) if save_residuals else out


def persistent_rnn_bwd(cfg: RnnKernelConfig, pre, w, b, n, cs, g_ys, g_cf
                       ) -> Tuple[torch.Tensor, ...]:
    """K4: the transposed persistent backward of one direction.  Takes
    the forward's inputs, its saved carries ``cs`` and the cotangents of
    ``(ys, carry)``; returns ``(d_pre, d_w, d_b, d_h0)`` in the types of
    ``pre``, ``w``, ``b`` and ``g_cf``.  On a CUDA tensor it launches
    ``csrc/persistent_rnn_bwd.cu``; on a CPU tensor it runs
    :func:`persistent_rnn_bwd_plain`."""
    if pre.device.type == "cpu":
        return persistent_rnn_bwd_plain(cfg, pre, w, b, n, cs, g_ys, g_cf)
    _check_device(cfg.cell, pre, w, backward=True)
    B, T, _ = pre.shape
    if B == 0 or T == 0:
        return (torch.zeros_like(pre), torch.zeros_like(w),
                torch.zeros_like(b), g_cf.clone())
    d_pre, d_w, d_b, d_h0 = _launch_persistent_rnn_bwd(
        cfg, pre.float().contiguous(), w.contiguous(),
        b.float().contiguous(), n.contiguous(), cs.contiguous(),
        g_ys.float().contiguous(), g_cf.float().contiguous())
    persistent_rnn_bwd.launches += 1
    return (d_pre.to(pre.dtype), d_w.to(w.dtype), d_b.to(b.dtype),
            d_h0.to(g_cf.dtype))


class _Persistent(torch.autograd.Function):
    """The recurrence under autograd: K3 saving its block-start carries
    forward, K4 backward (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, cfg, pre, w, b, h0, n):
        ys, cf, cs = persistent_rnn_fwd(cfg, pre, w, b, h0, n,
                                        save_residuals=True)
        ctx.cfg = cfg
        ctx.h0_dtype = h0.dtype
        ctx.save_for_backward(pre, w, b, n, cs)
        return ys, cf

    @staticmethod
    def backward(ctx, g_ys, g_cf):
        pre, w, b, n, cs = ctx.saved_tensors
        d_pre, d_w, d_b, d_h0 = persistent_rnn_bwd(ctx.cfg, pre, w, b, n, cs,
                                                   g_ys, g_cf)
        return None, d_pre, d_w, d_b, d_h0.to(ctx.h0_dtype), None


def persistent_rnn(pre: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor, n_frames: Optional[torch.Tensor] = None,
                   *, cell: str = "vanilla", activation: str = "relu",
                   time_block: int = 8, backward: str = "pallas"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run one direction's recurrence.

    Args:
      pre: ``[B, T, k·H]`` hoisted input projections, gate-stacked in the
        cell's order (vanilla k=1; GRU ``r,z,n``; LSTM ``i,f,g,o``).
      w: ``[H, k·H]`` gate-stacked h2h kernel, fp32 or bf16.
      b: ``[k·H]`` gate-stacked h2h bias (zeros for unbiased gates).
      h0: ``[C, B, H]`` initial carry (LSTM C=2: ``(c, h)``).
      n_frames: optional ``[B]`` valid lengths (clamped to T); ``None`` =
        all frames valid.
      cell / activation: the gate math.
      time_block: steps between two carries saved for the backward.
      backward: ``"pallas"`` differentiates with K4; ``"scan"`` with
        autograd through :func:`persistent_rnn_plain`.

    Returns ``(ys [B, T, H], carry [C, B, H])`` in ``pre``'s dtype.
    """
    if cell not in CELL_GATES:
        raise ValueError(f"unknown cell kind {cell!r}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation={activation!r} not in {ACTIVATIONS}")
    if backward not in BACKWARDS:
        raise ValueError(f"backward={backward!r} not in {BACKWARDS}")
    if int(time_block) < 1:
        raise ValueError(f"time_block={time_block} must be >= 1")
    cfg = RnnKernelConfig(cell, activation, int(time_block))
    B, T, kH = pre.shape
    H = w.shape[0]
    k, C = CELL_GATES[cell], CELL_CARRY[cell]
    if (tuple(w.shape) != (H, k * H) or kH != k * H
            or tuple(b.shape) != (k * H,) or tuple(h0.shape) != (C, B, H)):
        raise ValueError(
            f"persistent_rnn: shapes pre {tuple(pre.shape)}, w "
            f"{tuple(w.shape)}, b {tuple(b.shape)}, h0 {tuple(h0.shape)} "
            f"do not fit a {cell} cell (k={k}, C={C})")
    dev = pre.device
    if any(t.device != dev for t in (w, b, h0)):
        raise ValueError("persistent_rnn: pre, w, b and h0 must share a "
                         "device")
    if n_frames is None:
        n = torch.full((B,), T, dtype=torch.int32, device=dev)
    else:
        n = torch.as_tensor(n_frames, device=dev).to(torch.int32)
        n = n.clamp(0, T)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (pre, w, b, h0))
    if dev.type != "cpu" and grad and backward == "pallas":
        _check_device(cell, pre, w, backward=True)   # before K3 runs
    if not grad:
        return persistent_rnn_fwd(cfg, pre, w, b, h0, n)
    if backward == "scan":
        return persistent_rnn_plain(cfg, pre, w, b, h0, n)
    return _Persistent.apply(cfg, pre, w, b, h0, n)


persistent_rnn.launches = 0
persistent_rnn_bwd.launches = 0
