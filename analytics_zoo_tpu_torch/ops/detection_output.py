"""DetectionOutput: SSD serving-side post-processing on the device
(counterpart of ``ops/detection_output.py``).

Output layout per image: ``(keep_topk, 6)`` rows ``(class_id, score,
x1, y1, x2, y2)``; empty slots have class_id = -1, score = 0.

``DetectionOutputParam.backend`` keeps the reference's names so tests can
share parameters:

- ``"xla"``: the plain tensor path (per-class IoU matrix + argmax rounds,
  ``ops/nms.py``);
- ``"pallas"``: the unfused path — decode, drop background, stable
  per-class top-k, kernel K1 (``ops/pallas_nms.py``), global top-k;
- ``"fused"``: kernel K2, the whole chain in one call
  (``ops/pallas_detout.py``);
- ``"auto"``: ``"fused"`` on CUDA (``"pallas"`` when ``approx_topk`` is
  set, as the reference), ``"xla"`` on the CPU.

``approx_topk`` asks the unfused path for an approximate per-class top-k
at ``approx_recall``.  The port's selection is the exact stable top-k,
which meets any recall target in (0, 1]; what the flag still changes is
the backend ``"auto"`` picks on the card.

Where ``"fused"`` (asked for, or picked by ``"auto"``) meets a geometry
whose select block does not fit K2's shared memory, ``detection_output``
warns and runs ``"pallas"`` (K1's rows are ``nms_topk`` wide, not P), as
the reference falls back; ``fused_detection_output`` itself refuses it.

All backends implement the same semantics (topk-``nms_topk`` pre-filter,
greedy IoU suppression, global keep-topk, score ties to the lowest
index), so outputs agree up to float associativity.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from analytics_zoo_tpu_torch.ops.bbox import decode_bbox
from analytics_zoo_tpu_torch.ops.nms import nms_batched, topk_stable
from analytics_zoo_tpu_torch.ops.pallas_detout import (
    SELECT_SMEM_BYTES, foreground_ids, fused_detection_output,
    select_smem_bytes, select_tile)
from analytics_zoo_tpu_torch.ops.pallas_nms import _round_up, nms_sweep
from analytics_zoo_tpu_torch.utils.device import tensor_device

BACKENDS = ("auto", "xla", "pallas", "fused")


@dataclasses.dataclass(frozen=True)
class DetectionOutputParam:
    """Reference ``PostProcessParam``; same fields and defaults as the
    JAX package's.  ``approx_recall`` must lie in (0, 1] when
    ``approx_topk`` is set."""

    n_classes: int = 21
    background_id: int = 0
    conf_thresh: float = 0.01
    nms_thresh: float = 0.45
    nms_topk: int = 400
    keep_topk: int = 200
    share_location: bool = True
    clip_boxes: bool = False
    backend: str = "auto"
    approx_topk: bool = False
    approx_recall: float = 0.95


def _detection_output_xla(loc, conf, priors, variances, param):
    """The plain path, every image and class at once: (B,P,4), (B,P,C) →
    (B,keep_topk,6)."""
    B, P, C = conf.shape
    dev = conf.device
    decoded = decode_bbox(priors, variances, loc, clip=param.clip_boxes)
    keep_idx, keep_mask = nms_batched(
        decoded[:, None], conf.transpose(1, 2),
        iou_threshold=param.nms_thresh, max_output=param.nms_topk,
        pre_topk=param.nms_topk, score_threshold=param.conf_thresh)
    T = keep_idx.shape[-1]                                  # (B,C,T)
    class_ids = torch.arange(C, device=dev)
    fg = (class_ids != param.background_id).to(torch.float32)
    keep_mask = keep_mask * fg[:, None]
    flat_idx = keep_idx.reshape(B, C * T).to(torch.int64)
    flat_mask = keep_mask.reshape(B, C * T)
    flat_cls = class_ids.repeat_interleave(T)
    safe_idx = torch.clamp(flat_idx, min=0)
    flat_scores = conf[torch.arange(B, device=dev)[:, None], safe_idx,
                       flat_cls[None]] * flat_mask
    top_scores, order = topk_stable(flat_scores, param.keep_topk)
    top_cls = flat_cls[order]
    top_boxes = torch.take_along_dim(
        decoded, torch.take_along_dim(safe_idx, order, 1)[..., None], dim=1)
    valid = top_scores > 0
    return torch.cat([
        torch.where(valid, top_cls, -1)[..., None].to(torch.float32),
        top_scores[..., None],
        torch.where(valid[..., None], top_boxes, 0.0),
    ], dim=-1)


def detection_output_single(loc, conf, priors, variances,
                            param: DetectionOutputParam) -> torch.Tensor:
    """One image: loc (P,4) deltas, conf (P,C) probabilities →
    (keep_topk, 6)."""
    return _detection_output_xla(loc[None], conf[None], priors, variances,
                                 param)[0]


def sweep_candidates(loc, conf, priors, variances, param):
    """The selection half of the unfused path: decode, drop background,
    stable per-class top-k.  Returns the candidates' boxes (B,C_fg,k,4)
    and scores (B,C_fg,k) (-inf where empty), the validity mask fed to K1
    and the foreground class ids; k is ``nms_topk`` rounded up to 128."""
    B, P, C = conf.shape
    dev = conf.device
    decoded = decode_bbox(priors, variances, loc, clip=param.clip_boxes)
    fg_ids = torch.as_tensor(foreground_ids(C, param.background_id),
                             device=dev)
    Cf = fg_ids.numel()
    scores = conf.index_select(2, fg_ids).transpose(1, 2)   # (B,Cf,P)
    neg = torch.tensor(float("-inf"), device=dev)
    masked = torch.where(scores > param.conf_thresh, scores, neg)
    k = min(_round_up(param.nms_topk, 128), _round_up(P, 128))
    kk = min(k, P)
    top_scores, top_idx = topk_stable(masked, kk)           # (B,Cf,kk)
    if k - kk:
        top_scores = torch.cat([top_scores, neg.expand(B, Cf, k - kk)], -1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros(B, Cf, k - kk)], -1)
    boxes = torch.take_along_dim(decoded[:, None], top_idx[..., None],
                                 dim=2)                     # (B,Cf,k,4)
    # lanes past nms_topk are padding from rounding k up to 128 lanes
    valid = (torch.isfinite(top_scores)
             & (torch.arange(k, device=dev) < param.nms_topk)
             ).to(torch.float32)
    return boxes, top_scores, valid, fg_ids


def _detection_output_pallas(loc, conf, priors, variances, param):
    """The unfused path: candidate selection in tensor code, the
    suppression sweep in kernel K1 over (B·C_fg) rows."""
    boxes, top_scores, valid, fg_ids = sweep_candidates(
        loc, conf, priors, variances, param)
    B, Cf, k = top_scores.shape
    planes = [boxes[..., i].reshape(B * Cf, k) for i in range(4)]
    keep = nms_sweep(*planes, valid.reshape(B * Cf, k),
                     iou_threshold=param.nms_thresh).reshape(B, Cf, k)
    sel = torch.where(torch.isfinite(top_scores), top_scores, 0.0) * keep
    out_scores, order = topk_stable(sel.reshape(B, Cf * k), param.keep_topk)
    out_cls = fg_ids[order // k]
    out_boxes = torch.take_along_dim(boxes.reshape(B, Cf * k, 4),
                                     order[..., None], dim=1)
    ok = out_scores > 0
    return torch.cat([
        torch.where(ok, out_cls, -1)[..., None].to(torch.float32),
        out_scores[..., None],
        torch.where(ok[..., None], out_boxes, 0.0),
    ], dim=-1)


def resolve_backend(param: DetectionOutputParam, device: torch.device) -> str:
    if param.backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {param.backend!r}")
    if param.approx_topk and not 0.0 < param.approx_recall <= 1.0:
        raise ValueError(f"approx_recall must lie in (0, 1], got "
                         f"{param.approx_recall}")
    if param.backend == "auto":
        if device.type != "cuda":
            return "xla"
        return "pallas" if param.approx_topk else "fused"
    return param.backend


def detection_output(loc, conf, priors, variances,
                     param: DetectionOutputParam = DetectionOutputParam(),
                     device=None) -> torch.Tensor:
    """Batched: loc (B,P,4), conf (B,P,C) probabilities → (B, keep_topk, 6).

    Runs where ``loc`` lies (or on ``device``; arrays that are not tensors
    go to the GPU unless ``device="cpu"``).  Dispatches on
    ``param.backend``."""
    dev = tensor_device(loc, device)
    loc, conf, priors, variances = (
        torch.as_tensor(x, dtype=torch.float32, device=dev)
        for x in (loc, conf, priors, variances))
    backend = resolve_backend(param, dev)
    if backend == "fused":
        P = priors.shape[0]
        if select_tile(P, param.nms_topk) is not None:
            return fused_detection_output(loc, conf, priors, variances,
                                          param=param)
        need = select_smem_bytes(P, param.nms_topk)
        warnings.warn(
            f"fused DetectionOutput needs {need} bytes of shared memory "
            f"(P={P}, nms_topk={param.nms_topk}) over the "
            f"{SELECT_SMEM_BYTES}-byte limit of one block — falling back to "
            f"the unfused pallas path")
        backend = "pallas"
    if backend == "pallas":
        return _detection_output_pallas(loc, conf, priors, variances, param)
    return _detection_output_xla(loc, conf, priors, variances, param)


def scale_detections(dets: torch.Tensor, heights, widths) -> torch.Tensor:
    """Project normalized detections to original pixel sizes (imInfo):
    dets (B,K,6)."""
    h = torch.as_tensor(heights, dtype=dets.dtype,
                        device=dets.device).reshape(-1, 1, 1)
    w = torch.as_tensor(widths, dtype=dets.dtype,
                        device=dets.device).reshape(-1, 1, 1)
    return torch.cat([
        dets[..., :2],
        dets[..., 2:3] * w, dets[..., 3:4] * h,
        dets[..., 4:5] * w, dets[..., 5:6] * h,
    ], dim=-1)
