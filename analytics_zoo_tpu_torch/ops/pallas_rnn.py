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

#: the kernels' block: 256 threads, batch rows 8 at a time, each thread
#: a tile of 8 rows x 2 columns over a K-slice; a thread of K3 holds its
#: slice of W in registers up to ``KERNEL_REG_K`` rows, one of K4 the
#: first ``KERNEL_SPLIT_K`` rows (the rest in shared memory)
#: (``csrc/rnn_common.cuh``)
KERNEL_THREADS = 256
KERNEL_ROWS = 8
KERNEL_REG_K = 52
KERNEL_SPLIT_K = 24
#: static shared memory a block of K3 or K4 holds besides the dynamic
#: (the delivery's mbarriers and a word), at most
KERNEL_STATIC_SMEM = 48
#: where K3 and K4's recompute read the block's column slice of W
#: ("split": K4's first rows a thread in registers, the rest shared), by
#: the code the launchers return
W_SOURCES = ("registers", "shared", "l2", "split")
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


class RnnGeometry(NamedTuple):
    """The kernels' partition (``make_geom`` in ``csrc/rnn_common.cuh``):
    ``G`` blocks of ``cols`` hidden columns of every gate (``nc`` product
    columns); the forward product in ``CP`` column pairs × ``S`` K-slices
    of ``klen`` rows of ``H``; K4's dh product in ``CPr`` pairs of own
    columns × ``Sr`` K-slices of ``klenr`` of the ``k·H`` products."""

    H: int
    kH: int
    cols: int
    G: int
    nc: int
    CP: int
    S: int
    klen: int
    CPr: int
    Sr: int
    klenr: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rnn_geometry(hidden: int, cell: str = "vanilla",
                 n_sm: int = H100_SMS) -> RnnGeometry:
    k = CELL_GATES[cell]
    kH = k * hidden
    cols = _cdiv(hidden, n_sm)
    nc = k * cols
    CP = _cdiv(nc, 2)
    klen = _cdiv(hidden, max(1, min(KERNEL_THREADS // CP, hidden)))
    CPr = _cdiv(cols, 2)
    klenr = _cdiv(kH, max(1, min(KERNEL_THREADS // CPr, kH)))
    return RnnGeometry(hidden, kH, cols, _cdiv(hidden, cols), nc, CP,
                       _cdiv(hidden, klen), klen, CPr, _cdiv(kH, klenr),
                       klenr)


def _r4(x: int) -> int:
    return _cdiv(x, 4) * 4


def hopper_smem_bytes(hidden: int, cell: str = "vanilla",
                      n_sm: int = H100_SMS) -> int:
    """Shared memory one block of K3 needs besides its slice of ``W``
    (which sits in registers, or is read from L2 when it does not fit):
    the delivered ``h`` for 8 batch rows, the split-K partial sums, two
    stages of ``pre`` and the block's bias.  Mirrors ``base_floats`` in
    the CUDA source."""
    g = rnn_geometry(hidden, cell, n_sm)
    return 4 * (_r4(hidden * KERNEL_ROWS) + _r4(g.S * KERNEL_ROWS * 2 * g.CP)
                + _r4(2 * KERNEL_ROWS * g.nc) + _r4(g.nc))


def hopper_bwd_smem_bytes(hidden: int, cell: str = "vanilla",
                          n_sm: int = H100_SMS, weight_bytes: int = 4) -> int:
    """Shared memory one block of K4's sweep needs besides its column
    slice of ``W`` (registers, shared memory or L2, as K3): one delivered
    vector of the ``k·H`` products for 8 batch rows, the split-K partial
    sums, the block's bias and the row slice of ``W`` (``cols × k·H``,
    resident for the whole launch).  Mirrors ``bwd_base_bytes`` in the
    CUDA source."""
    g = rnn_geometry(hidden, cell, n_sm)
    red = max(g.S * KERNEL_ROWS * 2 * g.CP, g.Sr * KERNEL_ROWS * 2 * g.CPr)
    return (4 * (_r4(g.kH * KERNEL_ROWS) + _r4(red) + _r4(g.nc))
            + _cdiv(g.kH * 2 * g.CPr * weight_bytes, 16) * 16)


def hopper_w_source(hidden: int, cell: str = "vanilla",
                    n_sm: int = H100_SMS,
                    smem_limit: int = H100_SMEM_OPTIN,
                    backward: bool = False, weight_bytes: int = 4) -> str:
    """Where K3 (or, with ``backward``, K4's recompute) keeps the block's
    column slice of ``W``, as the launchers choose it.  K3:
    ``"registers"`` when a thread's K-slice fits ``KERNEL_REG_K`` rows,
    else ``"shared"`` when the slice fits beside the rest, else ``"l2"``.
    K4: ``"split"`` (the first ``KERNEL_SPLIT_K`` rows a thread in
    registers, the rest in shared memory) when that fits, else ``"l2"``
    (the whole slice in shared memory never fits where the split does
    not)."""
    g = rnn_geometry(hidden, cell, n_sm)
    limit = smem_limit - KERNEL_STATIC_SMEM
    whole = hidden * 2 * g.CP * weight_bytes
    if backward:
        base = hopper_bwd_smem_bytes(hidden, cell, n_sm, weight_bytes)
        split = (g.S * max(0, g.klen - KERNEL_SPLIT_K) * 2 * g.CP
                 * weight_bytes)
        return "split" if base + split <= limit else "l2"
    if g.klen <= KERNEL_REG_K:
        return "registers"
    base = hopper_smem_bytes(hidden, cell, n_sm)
    return "shared" if base + whole <= limit else "l2"


def check_hopper_fit(hidden: int, cell: str = "vanilla",
                     n_sm: int = H100_SMS,
                     smem_limit: int = H100_SMEM_OPTIN,
                     backward: bool = False, weight_bytes: int = 4) -> None:
    """Raise ``ValueError`` naming the limit when a kernel cannot take
    ``hidden``: each of at most ``n_sm`` resident blocks owns
    ``ceil(hidden/n_sm)`` columns of every gate (≤ 256 product columns)
    and must hold the delivered ``h`` in shared memory (K3, the forward);
    with ``backward``, K4's block must also hold the delivered ``d_hh`` and
    its row slice of ``W`` there for the whole launch."""
    limit = smem_limit - KERNEL_STATIC_SMEM
    nc = CELL_GATES[cell] * -(-hidden // n_sm)
    if nc > KERNEL_THREADS:
        raise ValueError(
            f"persistent_rnn (K3): H={hidden} ({cell}) gives {nc} product "
            f"columns a block, over the {KERNEL_THREADS} threads of one "
            f"block on {n_sm} SMs")
    need = hopper_smem_bytes(hidden, cell, n_sm)
    if need > limit:
        raise ValueError(
            f"persistent_rnn (K3): H={hidden} ({cell}) needs {need} bytes of "
            f"shared memory a block, over the {limit}-byte limit of this "
            f"card")
    if backward:
        need = hopper_bwd_smem_bytes(hidden, cell, n_sm, weight_bytes)
        if need > limit:
            raise ValueError(
                f"persistent_rnn backward (K4): H={hidden} ({cell}) needs "
                f"{need} bytes of shared memory a block for its row slice "
                f"of W and the delivered d_hh, over the {limit}-byte limit "
                f"of this card")


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


def _launch_persistent_rnn(cfg, pre, w, b, h0, n, ys, cf, cs=None,
                           stamps=None):
    """Launch K3.  ``stamps`` (int64, :data:`STAMP_WORDS` words, or None)
    takes block 0's step-phase clock stamps (:func:`step_split_us`)."""
    fn = cuda_build.load_function(
        "persistent_rnn", "az_persistent_rnn",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_void_p] * 3)
    B, T, _ = pre.shape
    H = w.shape[0]
    dev = pre.device
    # the delivered h: [2 ping-pong, passes of 8 rows, H, 8], rows past B 0
    hg = torch.zeros((2, -(-B // KERNEL_ROWS), H, KERNEL_ROWS),
                     dtype=torch.float32, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    src = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(pre.data_ptr(), w.data_ptr(),
                  int(w.dtype == torch.bfloat16), b.data_ptr(),
                  h0.data_ptr(), n.data_ptr(), ys.data_ptr(), cf.data_ptr(),
                  hg.data_ptr(), bar.data_ptr(),
                  None if cs is None else cs.data_ptr(), B, T, H,
                  list(CELL_GATES).index(cfg.cell),
                  ACTIVATIONS.index(cfg.activation), cfg.time_block,
                  None if stamps is None else stamps.data_ptr(),
                  ctypes.byref(src), stream)
    cuda_build.check_launch("persistent_rnn", code, "persistent_rnn kernel")
    persistent_rnn.w_source = W_SOURCES[src.value]


def _launch_persistent_rnn_bwd(cfg, pre, w, b, n, cs, g_ys, g_cf,
                               stamps=None):
    """Launch K4; ``stamps`` as for :func:`_launch_persistent_rnn` (chain
    0 the recompute, chain 1 the dh chain)."""
    fn = cuda_build.load_function(
        "persistent_rnn_bwd", "az_persistent_rnn_bwd",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 13
        + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    B, T, kH = pre.shape
    H = w.shape[0]
    C = CELL_CARRY[cfg.cell]
    U = cfg.time_block
    dev = pre.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    d_pre, dwb, d_h0 = f32(B, T, kH), f32(H + 1, kH), f32(C, B, H)
    # scratch: d_hh (GRU; vanilla and LSTM read d_pre), the h every step
    # reads, the time block's hh and LSTM c, and the delivered h and d_hh
    # ([2 ping-pong, passes of 8 rows, width, 8], rows past B 0)
    dhh = f32(B, T, kH) if cfg.cell == "gru" else d_pre
    hin = f32(B, T, -(-H // 4) * 4)
    hhs = f32(U, B, kH)
    cin = f32(U, B, H) if cfg.cell == "lstm" else hhs
    passes = -(-B // KERNEL_ROWS)
    hg = torch.zeros((2, passes, H, KERNEL_ROWS), dtype=torch.float32,
                     device=dev)
    dg = torch.zeros((2, passes, kH, KERNEL_ROWS), dtype=torch.float32,
                     device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    src = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(pre.data_ptr(), g_ys.data_ptr(), cs.data_ptr(),
                  w.data_ptr(), int(w.dtype == torch.bfloat16), b.data_ptr(),
                  g_cf.data_ptr(), n.data_ptr(), d_pre.data_ptr(),
                  dwb.data_ptr(), d_h0.data_ptr(), dhh.data_ptr(),
                  hin.data_ptr(), hhs.data_ptr(), cin.data_ptr(),
                  hg.data_ptr(), dg.data_ptr(), bar.data_ptr(), B, T, H,
                  list(CELL_GATES).index(cfg.cell),
                  ACTIVATIONS.index(cfg.activation), U,
                  None if stamps is None else stamps.data_ptr(),
                  ctypes.byref(src), stream)
    cuda_build.check_launch("persistent_rnn_bwd", code,
                            "persistent_rnn_bwd kernel")
    persistent_rnn_bwd.w_source = W_SOURCES[src.value]
    return d_pre, dwb[:H], dwb[H], d_h0


#: the kernels' step-phase stamps (``csrc/rnn_common.cuh``): steps
#: [16, 80) of each of two chains, ten clock slots a step
STAMP_STEPS, STAMP_PHASES = 64, 10
STAMP_WORDS = 2 * STAMP_STEPS * STAMP_PHASES
#: phase -> (slot it starts at, slot it ends at), by chain order: K3 and
#: K4's recompute deliver h, multiply, run the cell math, then wait at the
#: barrier; K4's dh chain runs the cell's VJP, waits, then delivers d_hh
#: and multiplies
STAMP_SPANS = {
    "forward": {"delivery": (0, 1), "product": (1, 2), "cell": (2, 3),
                "barrier": (3, 4)},
    # the forward's cell phase split at thread 0's first (row, column):
    # partial sums and pre, the gates, the stores, the rest of the phase
    "forward_cell": {"partials": (2, 5), "gates": (5, 6), "stores": (6, 7),
                     "rest": (7, 3)},
    # the forward's last K-slice (the first thread of it): the vector
    # landed, its product done
    "forward_last": {"delivery": (0, 8), "product": (8, 9)},
    "dh": {"cell": (0, 3), "barrier": (3, 4), "delivery": (4, 1),
           "product": (1, 2)},
}


def step_split_us(stamps: torch.Tensor, chain: int, order: str) -> dict:
    """Mean µs a step of each phase from a stamps buffer written by one
    launch (``order``: "forward" or "dh", see :data:`STAMP_SPANS`), and
    their sum, the step."""
    s = stamps.view(2, STAMP_STEPS, STAMP_PHASES)[chain].double().cpu()
    out = {name: ((s[:, b] - s[:, a]).mean() / 1e3).item()
           for name, (a, b) in STAMP_SPANS[order].items()}
    out["step"] = sum(out.values())
    if order == "forward":
        for key, sub in (("cell_split", "forward_cell"),
                         ("last_slice", "forward_last")):
            out[key] = step_split_us(stamps, chain, sub)
            del out[key]["step"]
    return out


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


@cuda_build.kernel_op("K3")
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


@cuda_build.kernel_op("K4")
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
# where the last launch kept its column slice of W (:data:`W_SOURCES`)
persistent_rnn.w_source = persistent_rnn_bwd.w_source = None
