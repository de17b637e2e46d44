"""Kernel K3: the persistent-RNN forward (counterpart of
``ops/pallas_rnn.py``).

:func:`persistent_rnn` runs one direction's recurrence over the hoisted
input projections: every step computes ``hh = h·w + b`` in fp32 (``h``
rounded to ``w``'s type first), the vanilla / GRU / LSTM gate math, and
the ``n_frames`` mask — a row past its length freezes its carry and
emits 0.  On a CUDA tensor it launches ``csrc/persistent_rnn.cu``, one
cooperative launch that walks the whole time axis; on a CPU tensor it
runs :func:`persistent_rnn_plain`, the forward of the reference's
``_scan_reference`` as a loop over time.

The reference's VMEM budget and its warn-and-fall-back to the blocked
scan are TPU planning.  Here :func:`check_hopper_fit` holds a geometry
to the kernel's shared-memory need and raises, naming the limit; nothing
falls back.  The gradient (K4, the transposed persistent backward) is
not ported yet: a call that needs one raises.
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

#: the kernel's block: 256 threads, batch rows 8 at a time
KERNEL_THREADS = 256
KERNEL_ROWS = 8
#: H100 SXM defaults for :func:`check_hopper_fit` off the card
H100_SMS = 132
H100_SMEM_OPTIN = 232448

K4_TODO = ("the persistent-RNN backward (K4, ROADMAP.md Queue 2) is not "
           "ported yet: run the recurrence without autograd "
           "(torch.inference_mode) or use engine='blocked'")


class RnnKernelConfig(NamedTuple):
    """Static kernel config.  ``time_block`` is the reference's unroll
    per grid step, kept for signature parity (the CUDA kernel has no
    time blocks); ``backward`` names the gradient engine the K4 port
    will fill."""

    cell: str               # 'vanilla' | 'gru' | 'lstm'
    activation: str         # vanilla only: 'relu' | 'clipped_relu' | 'tanh'
    time_block: int = 8
    backward: str = "pallas"


def hopper_smem_bytes(hidden: int, cell: str = "vanilla",
                      n_sm: int = H100_SMS) -> int:
    """Shared memory one block of the kernel needs besides its slice of
    ``W`` (which is read from L2 when it does not fit): ``h`` transposed
    for 8 batch rows, the split-K partial sums, and two stages of ``pre``.
    Mirrors ``base_smem_bytes`` in the CUDA source."""
    cols = -(-hidden // n_sm)
    nc = CELL_GATES[cell] * cols
    slices = KERNEL_THREADS // max(nc, 1)
    return 4 * (hidden * KERNEL_ROWS + slices * KERNEL_ROWS * nc
                + 2 * KERNEL_ROWS * nc)


def check_hopper_fit(hidden: int, cell: str = "vanilla",
                     n_sm: int = H100_SMS,
                     smem_limit: int = H100_SMEM_OPTIN) -> None:
    """Raise ``ValueError`` naming the limit when the kernel cannot take
    ``hidden``: each of at most ``n_sm`` resident blocks owns
    ``ceil(hidden/n_sm)`` columns of every gate (≤ 256, one per thread)
    and must hold ``h`` in shared memory."""
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


def persistent_rnn_plain(cfg: RnnKernelConfig, pre, w, b, h0, n
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: the forward of the reference's
    ``_scan_reference``, one loop iteration a step.  ``n`` is ``[B]``
    int valid lengths already clamped to T."""
    B, T, _ = pre.shape
    dt = pre.dtype
    n_col = n.to(pre.device)[:, None]
    carry = tuple(h0[i].float() for i in range(CELL_CARRY[cfg.cell]))
    wf = w.float()
    bf = b.float()
    ys = []
    for t in range(T):
        keep = n_col > t
        hh = carry[-1].to(w.dtype).float() @ wf + bf
        new_carry, y = _cell_step(cfg, pre[:, t].float(), hh, carry)
        carry = tuple(torch.where(keep, nw, old)
                      for nw, old in zip(new_carry, carry))
        ys.append(torch.where(keep, y, torch.zeros_like(y)))
    out = (torch.stack(ys, 1) if ys
           else pre.new_zeros((B, 0, w.shape[0]), dtype=torch.float32))
    return out.to(dt), torch.stack(carry).to(dt)


def _launch_persistent_rnn(cfg, pre, w, b, h0, n, ys, cf):
    fn = cuda_build.load_function(
        "persistent_rnn", "az_persistent_rnn",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
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
                  hbuf.data_ptr(), bar.data_ptr(), B, T, H,
                  list(CELL_GATES).index(cfg.cell),
                  ACTIVATIONS.index(cfg.activation), stream)
    cuda_build.check_launch("persistent_rnn", code, "persistent_rnn kernel")


def persistent_rnn(pre: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor, n_frames: Optional[torch.Tensor] = None,
                   *, cell: str = "vanilla", activation: str = "relu",
                   time_block: int = 8
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
      cell / activation: the gate math; ``time_block`` is accepted for
        parity with the reference and has no effect.

    Returns ``(ys [B, T, H], carry [C, B, H])`` in ``pre``'s dtype.
    """
    if cell not in CELL_GATES:
        raise ValueError(f"unknown cell kind {cell!r}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation={activation!r} not in {ACTIVATIONS}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (pre, w, b, h0)):
        raise NotImplementedError(K4_TODO)
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
    if dev.type == "cpu":
        return persistent_rnn_plain(cfg, pre, w, b, h0, n)
    if dev.type != "cuda":
        raise ValueError(f"persistent_rnn: no kernel for device {dev}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"persistent_rnn: w must be fp32 or bf16, got "
                         f"{w.dtype}")
    props = torch.cuda.get_device_properties(dev)
    check_hopper_fit(H, cell, props.multi_processor_count,
                     props.shared_memory_per_block_optin)
    if B == 0 or T == 0:
        return pre.new_zeros((B, T, H)), h0.to(pre.dtype)
    ys = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    cf = torch.empty((C, B, H), dtype=torch.float32, device=dev)
    _launch_persistent_rnn(cfg, pre.float().contiguous(), w.contiguous(),
                           b.float().contiguous(), h0.float().contiguous(),
                           n.contiguous(), ys, cf)
    persistent_rnn.launches += 1
    return ys.to(pre.dtype), cf.to(pre.dtype)


persistent_rnn.launches = 0
