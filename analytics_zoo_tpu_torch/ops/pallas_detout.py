"""Kernel K2: the fused DetectionOutput (counterpart of
``ops/pallas_detout.py``, every ``stage``).

``fused_detection_output`` computes the whole SSD post-processing chain
in one call — decode; per (image, foreground class) the confidence
filter, a pop-the-max selection capped at ``nms_topk`` (ties to the
lowest prior) and greedy suppression (normalized IoU, ``>=``); then the
global ``keep_topk`` merge (ties to the lowest flat (class row, prior)
index) — and writes ``(class_id, score, x1, y1, x2, y2)`` rows, empty
rows ``(-1, 0, 0, 0, 0, 0)``.

On a CUDA tensor it launches ``csrc/detection_output.cu``; on a CPU
tensor it runs :func:`fused_detection_output_plain`, which vectorises
over every (image, class) row and loops only over the sequential pop
index.  The reference's VMEM budget and its warn-and-fall-back are TPU
planning and have no counterpart: the kernel takes SSD300 and SSD512
alike, and raises, naming the limit, for a geometry past it.

``stage`` takes the reference's profile stages (:data:`STAGES`).  Their
outputs are probes, not detections: every entry of image b's
``(keep_topk, 6)`` block holds the sum over all P priors of the decoded
(and, under ``clip_boxes``, clipped) x1 and y2; ``"select"`` adds the sum
of every kept score of the image's foreground rows (the reference's
``allkeep`` plane).  The kernel sums kept scores above 0, as its kept
lists hold them; with ``conf_thresh >= 0`` that is every kept score.
Unlike the reference's, the port's stages are not prefixes of one
program: ``"full"`` decodes only the candidates, so ``"decode"`` is a
launch of its own and its time is no part of ``"full"``'s.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from analytics_zoo_tpu_torch.ops.bbox import decode_bbox
from analytics_zoo_tpu_torch.ops.pallas_nms import (BLOCK_SMEM_BYTES,
                                                    ENGINE_TILES,
                                                    STAMP_SLOTS,
                                                    SWEEP_PHASES,
                                                    _launch_nms_sweep,
                                                    _round_up,
                                                    engine_work_bytes,
                                                    phase_split_us,
                                                    sweep_iou)

#: the phases the select launch stamps the end of (block 0, slots 0-8),
#: then the merge launch (block 0, slots 9-13); read with
#: ``pallas_nms.phase_split_us``
SELECT_PHASES = ("keys", "radix_select", "compact", "rank_decode", "mask",
                 "walk", "later_tiles", "write")
MERGE_PHASES = ("offsets", "stage", "rank", "write")
MERGE_STAMPS = len(SELECT_PHASES) + 1
from analytics_zoo_tpu_torch.utils import cuda_build

#: the reference's stages: its profile ladder's probes, then the product
STAGES = ("decode", "select", "full")

#: dynamic shared memory one select block may use: 227 KB less the
#: block's static scan scratch
SELECT_SMEM_BYTES = BLOCK_SMEM_BYTES - 256


def _select_bytes(n_priors: int, nms_topk: int, tile: int) -> int:
    """``az_detection_output_smem``: region Y holds the key row (4 bytes
    a prior), later the sorted candidates (box and score, 20 bytes each);
    region X the compacted (score, prior) pairs, the 512-byte radix
    histogram, later the engine's alive bits and work area."""
    m = min(n_priors, nms_topk)
    y = _round_up(max(4 * n_priors, 20 * m), 16)
    x = max(8 * m, 4 * ((m + 31) // 32) + engine_work_bytes(m, tile), 512)
    return y + x


def select_tile(n_priors: int, nms_topk: int):
    """The largest engine tile whose select block fits, or None."""
    return next((t for t in ENGINE_TILES
                 if _select_bytes(n_priors, nms_topk, t)
                 <= SELECT_SMEM_BYTES), None)


def select_smem_bytes(n_priors: int, nms_topk: int) -> int:
    """Shared memory of one select block at the tile it launches with
    (the smallest tile's where none fits)."""
    return _select_bytes(n_priors, nms_topk,
                         select_tile(n_priors, nms_topk) or ENGINE_TILES[-1])


def foreground_ids(n_classes: int, background_id: int):
    return [c for c in range(n_classes) if c != background_id]


def fused_keep_plain(loc, conf, priors, variances, param
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode + per-row selection + suppression, all (image, foreground
    class) rows at once: returns the corner boxes (B,P,4) and the keep
    scores (B,C_fg,P) — a prior's score where it was popped and kept,
    else 0 (the reference kernel's ``allkeep`` plane)."""
    B, P, C = conf.shape
    dev = conf.device
    boxes = decode_bbox(priors, variances, loc, clip=param.clip_boxes)
    fg = torch.as_tensor(foreground_ids(C, param.background_id), device=dev)
    s = conf.index_select(2, fg).transpose(1, 2)             # (B,Cf,P)
    valid = s > param.conf_thresh
    bound = torch.clamp(valid.sum(-1), max=param.nms_topk)   # (B,Cf)
    neg = torch.tensor(float("-inf"), device=dev)
    remaining = torch.where(valid, s, neg)
    active = valid.clone()
    keep = torch.zeros_like(s)
    lanes = torch.arange(P, device=dev)
    bx = [boxes[:, None, :, i] for i in range(4)]            # (B,1,P) each
    for it in range(int(bound.max()) if bound.numel() else 0):
        live = it < bound
        m = remaining.amax(-1, keepdim=True)
        # ties to the lowest prior
        p = torch.where(remaining == m, lanes, P).amin(-1, keepdim=True)
        # rows past their bound re-write their max in place: a no-op
        on = torch.take_along_dim(active, p, -1) & live[..., None]
        remaining = remaining.scatter(
            -1, p, torch.where(live[..., None], neg, m))
        keep = keep.scatter(
            -1, p, torch.where(on, m, torch.take_along_dim(keep, p, -1)))
        pb = [torch.take_along_dim(c.expand_as(s), p, -1) for c in bx]
        iou = sweep_iou(*bx, *pb, 0.0)
        active &= ~((iou >= param.nms_thresh) & on)
    return boxes, keep


def check_stage(stage: str) -> None:
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")


def stage_probe_plain(loc, conf, priors, variances, param, stage: str
                      ) -> torch.Tensor:
    """The probe of a profile stage, one float32 an image (B,): Σ_p x1 +
    Σ_p y2 of every decoded prior, plus, for ``"select"``, Σ of the
    image's kept scores above 0, summed in float64 as the kernel does."""
    if stage == "decode":
        boxes = decode_bbox(priors, variances, loc, clip=param.clip_boxes)
        kept = torch.zeros(conf.shape[0], dtype=torch.float64,
                           device=conf.device)
    else:
        boxes, keep = fused_keep_plain(loc, conf, priors, variances, param)
        kept = torch.where(keep > 0, keep, 0.0).double().sum((1, 2))
    total = (boxes[..., 0].double().sum(-1) + boxes[..., 3].double().sum(-1)
             + kept)
    return total.to(torch.float32)


def fused_detection_output_plain(loc, conf, priors, variances, param,
                                 stage: str = "full") -> torch.Tensor:
    """Plain PyTorch version of K2: (B,P,4), (B,P,C) → (B,keep_topk,6)."""
    check_stage(stage)
    B, P, C = conf.shape
    if stage != "full":
        probe = stage_probe_plain(loc, conf, priors, variances, param, stage)
        return probe[:, None, None].expand(B, param.keep_topk, 6).clone()
    boxes, keep = fused_keep_plain(loc, conf, priors, variances, param)
    fg = torch.as_tensor(foreground_ids(C, param.background_id),
                         device=conf.device)
    flat = keep.reshape(B, -1)
    # stable descending sort: equal scores keep the lowest flat
    # (class row, prior) index first; unkept (0) entries sort last
    vals, order = torch.sort(flat, dim=-1, descending=True, stable=True)
    kout = param.keep_topk
    if vals.shape[-1] < kout:
        fill = kout - vals.shape[-1]
        vals = torch.cat([vals, vals.new_zeros(B, fill)], -1)
        order = torch.cat([order, order.new_zeros(B, fill)], -1)
    vals, order = vals[:, :kout], order[:, :kout]
    ok = vals > 0
    cls = fg[order // P].to(torch.float32)
    bsel = torch.take_along_dim(boxes, (order % P)[..., None], dim=1)
    return torch.cat([
        torch.where(ok, cls, -1.0)[..., None],
        torch.where(ok, vals, 0.0)[..., None],
        torch.where(ok[..., None], bsel, 0.0),
    ], dim=-1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous float32 whose base is 16-byte aligned (the kernel reads
    boxes as float4)."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_fused(loc, conf, priors, variances, param, n_fg, out,
                  stamps=None, stage: str = "full"):
    """Launch K2's ``stage`` into ``out``; ``stamps`` (int64,
    ``STAMP_SLOTS`` words, or None) takes the select's phase stamps
    (:data:`SELECT_PHASES`)."""
    fn = cuda_build.load_function(
        "detection_output", "az_detection_output",
        [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_void_p])
    B, P, C = conf.shape
    dev = conf.device
    kscore = kbox = kcount = None
    if stage != "decode":
        kscore = torch.empty((B, n_fg, param.nms_topk), dtype=torch.float32,
                             device=dev)
        kbox = torch.empty((B, n_fg, param.nms_topk, 4), dtype=torch.float32,
                           device=dev)
        kcount = torch.empty((B, n_fg), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(loc.data_ptr(), conf.data_ptr(), priors.data_ptr(),
                  variances.data_ptr(), ptr(kscore), ptr(kbox), ptr(kcount),
                  out.data_ptr(),
                  B, P, C, n_fg, int(param.background_id),
                  float(param.conf_thresh), float(param.nms_thresh),
                  int(param.nms_topk), int(param.keep_topk),
                  int(bool(param.clip_boxes)),
                  select_tile(P, param.nms_topk), STAGES.index(stage),
                  ptr(stamps), stream)
    cuda_build.check_launch("detection_output", code,
                            "fused DetectionOutput kernel")


def block_phases_us(loc, conf, priors, variances, param, planes) -> dict:
    """Where block 0 of K2's select and merge launches and of one K1
    launch over ``planes`` spends its time, in µs, from the kernels'
    ``%globaltimer`` stamps (:data:`SELECT_PHASES`, :data:`MERGE_PHASES`,
    ``pallas_nms.SWEEP_PHASES``).  CUDA tensors only; one launch each."""
    stamps = torch.zeros(STAMP_SLOTS, dtype=torch.int64, device=loc.device)
    B, _, C = conf.shape
    out = torch.empty((B, param.keep_topk, 6), device=loc.device)
    _launch_fused(loc, conf, priors, variances, param,
                  len(foreground_ids(C, param.background_id)), out,
                  stamps=stamps)
    torch.cuda.synchronize()
    split = {"k2_select": phase_split_us(stamps, SELECT_PHASES),
             "k2_merge": phase_split_us(stamps, MERGE_PHASES, MERGE_STAMPS)}
    stamps.zero_()
    _launch_nms_sweep(planes, torch.empty_like(planes[0]), param.nms_thresh,
                      0.0, stamps=stamps)
    torch.cuda.synchronize()
    split["k1"] = phase_split_us(stamps, SWEEP_PHASES)
    return split


@cuda_build.kernel_op("K2")
def fused_detection_output(loc: torch.Tensor, conf: torch.Tensor,
                           priors: torch.Tensor, variances: torch.Tensor, *,
                           param, stage: str = "full") -> torch.Tensor:
    """Batched fused DetectionOutput: loc (B,P,4), conf (B,P,C)
    probabilities, priors and variances (P,4) → (B, keep_topk, 6).
    ``stage`` "decode" or "select" gives a profile stage's probe (see the
    module's docstring); ``launches_by_stage`` counts each stage's
    launches, ``launches`` all of them."""
    check_stage(stage)
    B, P, C = conf.shape
    if loc.shape != (B, P, 4) or priors.shape != (P, 4) \
            or variances.shape != (P, 4):
        raise ValueError(f"fused DetectionOutput: loc {tuple(loc.shape)}, "
                         f"priors {tuple(priors.shape)} and variances "
                         f"{tuple(variances.shape)} do not fit conf "
                         f"{tuple(conf.shape)}")
    n_fg = len(foreground_ids(C, param.background_id))
    if not n_fg:
        raise ValueError("fused DetectionOutput needs >= 1 foreground class")
    dev = conf.device
    if any(t.device != dev for t in (loc, priors, variances)):
        raise ValueError("fused DetectionOutput: inputs on different devices")
    if dev.type == "cpu":
        return fused_detection_output_plain(loc, conf, priors, variances,
                                            param, stage)
    if dev.type != "cuda":
        raise ValueError(f"fused DetectionOutput: no kernel for device {dev}")
    if select_tile(P, param.nms_topk) is None:
        need = select_smem_bytes(P, param.nms_topk)
        raise ValueError(f"fused DetectionOutput: P={P} priors and nms_topk="
                         f"{param.nms_topk} need {need} bytes of shared "
                         f"memory in one block; the limit is "
                         f"{SELECT_SMEM_BYTES}")
    out = torch.empty((B, param.keep_topk, 6), dtype=torch.float32,
                      device=dev)
    # with nms_topk 0 no score is kept: "select"'s probe is "decode"'s
    launched = ("decode" if stage == "select" and param.nms_topk <= 0
                else stage)
    if B and P and param.keep_topk and (param.nms_topk > 0
                                        or launched == "decode"):
        loc, conf, priors, variances = (
            _aligned(t) for t in (loc, conf, priors, variances))
        _launch_fused(loc, conf, priors, variances, param, n_fg, out,
                      stage=launched)
        fused_detection_output.launches += 1
        fused_detection_output.launches_by_stage[stage] += 1
    else:
        out.zero_()
        if stage == "full":
            out[..., 0] = -1.0
    return out


fused_detection_output.launches = 0
fused_detection_output.launches_by_stage = dict.fromkeys(STAGES, 0)
