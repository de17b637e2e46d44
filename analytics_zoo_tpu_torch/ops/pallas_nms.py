"""Kernel K1: the greedy NMS suppression sweep (counterpart of
``ops/pallas_nms.py``).

``nms_sweep`` takes per-row candidates already sorted by score, as
``(C, K)`` planes x1/y1/x2/y2 plus a validity mask, and returns the
``(C, K)`` float keep mask: sweep i = 0 … last valid lane; a candidate
still active is kept and deactivates every later candidate whose IoU
with it is ≥ the threshold.  On a CUDA tensor it launches
``csrc/nms_sweep.cu``; on a CPU tensor it runs :func:`nms_sweep_plain`,
the same arithmetic vectorised over rows.

:func:`pallas_nms` is the single-class drop-in for ``ops.nms.nms``
around the sweep (name kept from the reference so each file has one
counterpart).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from analytics_zoo_tpu_torch.ops.nms import topk_stable
from analytics_zoo_tpu_torch.utils import cuda_build

#: shared memory one Hopper block may use (227 KB)
BLOCK_SMEM_BYTES = 232448
#: the sweep kernel's dynamic shared memory: the block's limit less its
#: static shared memory (one int)
SWEEP_SMEM_BYTES = BLOCK_SMEM_BYTES - 64
#: tile sizes of the suppression engine (``csrc/nms_common.cuh``), largest
#: first: a launch takes the largest whose T x T bit mask fits
ENGINE_TILES = (512, 256, 128, 64, 32)
#: the longest row K1 takes: the limit of its first design (a row's four
#: planes and a flag byte, 17 bytes a candidate), which the tiled engine
#: keeps (``sweep_tile(MAX_SWEEP_K)`` finds a tile)
MAX_SWEEP_K = BLOCK_SMEM_BYTES // 17


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def engine_work_bytes(n: int, tile: int) -> int:
    """Bytes of the engine's work area for n candidates in tiles of
    ``tile`` (``nms::work_bytes``): a tile holds at most n rounded up to
    32; each of its rows (tile / 32) mask words rounded up to odd, the
    candidate's area and its suppressors within its own word."""
    t = max(32, min(tile, _round_up(n, 32)))
    return 4 * t * (((t // 32) | 1) + 2)


def sweep_smem_bytes(K: int, tile: int) -> int:
    """One K1 block: float4 boxes (K rounded up to 32), ceil(K/32) alive
    words and the engine's work area (``az_nms_sweep_smem``)."""
    return (16 * _round_up(K, 32) + 4 * ((K + 31) // 32)
            + engine_work_bytes(K, tile))


def sweep_tile(K: int):
    """The largest engine tile whose K1 block fits, or None."""
    return next((t for t in ENGINE_TILES
                 if sweep_smem_bytes(K, t) <= SWEEP_SMEM_BYTES), None)


def sweep_iou(x1, y1, x2, y2, bx1, by1, bx2, by2, off: float):
    """IoU of the kept boxes ``b*`` (broadcast) against the lanes, in the
    reference kernel's exact op order: +off on widths and heights, a
    union floor of 1e-12, then inter/union."""
    ix1 = torch.maximum(x1, bx1)
    iy1 = torch.maximum(y1, by1)
    ix2 = torch.minimum(x2, bx2)
    iy2 = torch.minimum(y2, by2)
    inter = (torch.clamp(ix2 - ix1 + off, min=0.0)
             * torch.clamp(iy2 - iy1 + off, min=0.0))
    area = (x2 - x1 + off) * (y2 - y1 + off)
    area_b = (bx2 - bx1 + off) * (by2 - by1 + off)
    union = torch.clamp(area + area_b - inter, min=1e-12)
    return inter / union


def nms_sweep_plain(x1, y1, x2, y2, valid, iou_threshold: float = 0.45,
                    normalized: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K1: all rows at once, one step of the
    sequential sweep per loop iteration."""
    off = 0.0 if normalized else 1.0
    C, K = x1.shape
    lanes = torch.arange(K, device=x1.device)
    valid = valid > 0
    active = valid.clone()
    keep = torch.zeros((C, K), dtype=torch.float32, device=x1.device)
    if not (C and K):
        return keep
    # the sweep ends at the last valid lane of each row
    n_valid = torch.where(valid, lanes + 1, 0).amax(dim=1)
    for i in range(int(n_valid.max())):
        on = active[:, i] & (i < n_valid)                      # (C,)
        keep[:, i] = on.to(torch.float32)
        iou = sweep_iou(x1, y1, x2, y2, x1[:, i:i + 1], y1[:, i:i + 1],
                        x2[:, i:i + 1], y2[:, i:i + 1], off)
        active &= ~((iou >= iou_threshold) & on[:, None])
    return keep


#: block 0's phase stamps (``nms::stamp``): words of the buffer, and the
#: phases K1 stamps the end of, in order after its start stamp
STAMP_SLOTS = 16
SWEEP_PHASES = ("load", "mask", "walk", "later_tiles", "write")


def phase_split_us(stamps: torch.Tensor, phases, start: int = 0) -> dict:
    """µs of each phase of block 0 from a stamps buffer: slot ``start``
    is the launch's start, slot start + i + 1 the end of ``phases[i]``.
    A slot left 0 is a phase block 0 never reached (a row with few or no
    candidates skips some): it counts 0 µs, so the phases still sum to
    the block's time."""
    t = stamps[start:start + len(phases) + 1].double().cpu().tolist()
    out, prev = {}, t[0]
    for i, name in enumerate(phases):
        end = t[i + 1] or prev
        out[name] = (end - prev) / 1e3
        prev = end
    return out


def _launch_nms_sweep(planes, keep, iou_threshold: float, off: float,
                      stamps=None):
    fn = cuda_build.load_function(
        "nms_sweep", "az_nms_sweep",
        [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p])
    C, K = keep.shape
    with torch.cuda.device(keep.device):
        stream = torch.cuda.current_stream(keep.device).cuda_stream
        code = fn(*(p.data_ptr() for p in planes), keep.data_ptr(), C, K,
                  float(iou_threshold), float(off), sweep_tile(K),
                  None if stamps is None else stamps.data_ptr(), stream)
    cuda_build.check_launch("nms_sweep", code, "nms_sweep kernel")


@cuda_build.kernel_op("K1")
def nms_sweep(x1, y1, x2, y2, valid, iou_threshold: float = 0.45,
              normalized: bool = True) -> torch.Tensor:
    """(C, K) sorted per-row candidates → (C, K) keep mask.
    ``normalized=False`` uses the +1-pixel-width convention."""
    planes = [t.to(torch.float32).contiguous() for t in (x1, y1, x2, y2, valid)]
    C, K = planes[0].shape
    if any(p.shape != (C, K) or p.device != planes[0].device for p in planes):
        raise ValueError("nms_sweep: all five planes must be (C, K) on one "
                         "device")
    dev = planes[0].device
    if dev.type == "cpu":
        return nms_sweep_plain(*planes, iou_threshold=iou_threshold,
                               normalized=normalized)
    if dev.type != "cuda":
        raise ValueError(f"nms_sweep: no kernel for device {dev}")
    if K > MAX_SWEEP_K or sweep_tile(K) is None:
        raise ValueError(f"nms_sweep: K={K} candidates a row exceed the "
                         f"{MAX_SWEEP_K} one block's shared memory holds")
    keep = torch.empty((C, K), dtype=torch.float32, device=dev)
    if C and K:
        _launch_nms_sweep(planes, keep, iou_threshold,
                          0.0 if normalized else 1.0)
        nms_sweep.launches += 1
    return keep


nms_sweep.launches = 0


def pallas_nms(boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float = 0.45, max_output: int = 200,
               pre_topk: int = 400, score_threshold: float = -1e30,
               normalized: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``ops.nms.nms`` (single class) backed by the sweep:
    boxes (N,4), scores (N,) → (keep_idx (max_output,), keep_mask) in the
    original index space, ranked by score."""
    n = scores.shape[0]
    dev = scores.device
    k = min(_round_up(pre_topk, 128), _round_up(n, 128))
    masked = torch.where(scores > score_threshold, scores,
                         torch.full_like(scores, float("-inf")))
    top_scores, top_idx = topk_stable(masked, min(k, n))
    pad = k - top_scores.shape[0]
    if pad:
        top_scores = torch.cat([top_scores, torch.full(
            (pad,), float("-inf"), dtype=top_scores.dtype, device=dev)])
        top_idx = torch.cat([top_idx, torch.zeros(pad, dtype=top_idx.dtype,
                                                  device=dev)])
    tb = boxes[top_idx]                                      # (K, 4)
    valid = (top_scores > float("-inf")).to(torch.float32)
    keep = nms_sweep(tb[None, :, 0], tb[None, :, 1], tb[None, :, 2],
                     tb[None, :, 3], valid[None], iou_threshold,
                     normalized=normalized)[0]
    # first max_output kept candidates, in sorted (score) order
    rank = torch.cumsum(keep, 0) - 1
    sel = (keep > 0) & (rank < max_output)
    slot = torch.where(sel, rank.to(torch.int64),
                       torch.full_like(top_idx, max_output))
    keep_idx = torch.full((max_output + 1,), -1, dtype=torch.int32,
                          device=dev)
    keep_idx[slot[sel]] = top_idx[sel].to(torch.int32)
    keep_mask = torch.zeros((max_output + 1,), dtype=torch.float32,
                            device=dev)
    keep_mask[slot[sel]] = 1.0
    return keep_idx[:max_output], keep_mask[:max_output]
