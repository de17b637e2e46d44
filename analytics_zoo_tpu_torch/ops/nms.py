"""Greedy NMS as plain tensor code (the counterpart of ``ops/nms.py``).

1. a stable descending sort down to ``pre_topk`` candidates (the
   reference's topk-400 pre-filter; ties keep the lowest index first, as
   ``lax.top_k`` does — ``torch.topk`` promises no tie order);
2. one pre_topk×pre_topk IoU matrix;
3. ``max_output`` rounds of argmax → record → mask out IoU ≥ thresh.

:func:`nms_batched` runs any number of independent rows at once (per
class, per image); :func:`nms` is the single-row form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from analytics_zoo_tpu_torch.ops.bbox import iou_matrix

NEG_INF = -1e30


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: descending, ties to the lowest
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_batched(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.45, max_output: int = 200,
                pre_topk: int = 400, score_threshold: float = NEG_INF,
                eta: float = 1.0, normalized: bool = True,
                valid_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (…,N,4) broadcastable against scores (…,N) → (keep_idx
    (…,max_output) int32 padded with -1, keep_mask (…,max_output) float32)
    — indices into the ORIGINAL N boxes.  ``eta`` is nmsFast's adaptive
    threshold: after each kept box ``thresh *= eta`` while thresh > 0.5."""
    n = scores.shape[-1]
    neg = torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device)
    active = torch.where(scores > score_threshold, scores, neg)
    if valid_mask is not None:
        active = torch.where(valid_mask > 0, active, neg)
    k = min(pre_topk, n)
    top_scores, top_idx = topk_stable(active, k)
    top_boxes = torch.take_along_dim(boxes, top_idx[..., None], dim=-2)
    iou = iou_matrix(top_boxes, top_boxes, normalized=normalized)  # (…,k,k)

    lead = top_scores.shape[:-1]
    keep_idx = torch.full(lead + (max_output,), -1, dtype=torch.int32,
                          device=scores.device)
    keep_mask = torch.zeros(lead + (max_output,), dtype=torch.float32,
                            device=scores.device)
    act = top_scores
    thresh = torch.full(lead, iou_threshold, dtype=torch.float32,
                        device=scores.device)
    lanes = torch.arange(k, device=scores.device)
    for i in range(min(max_output, k)):
        best = torch.argmax(act, dim=-1, keepdim=True)        # first max
        ok = torch.take_along_dim(act, best, dim=-1)[..., 0] > neg
        picked = torch.take_along_dim(top_idx, best, dim=-1)[..., 0]
        keep_idx[..., i] = torch.where(ok, picked.to(torch.int32),
                                       torch.full_like(keep_idx[..., i], -1))
        keep_mask[..., i] = ok.to(torch.float32)
        row = torch.take_along_dim(iou, best[..., None], dim=-2)[..., 0, :]
        suppress = (row >= thresh[..., None]) | (lanes == best)
        act = torch.where(ok[..., None] & suppress, neg, act)
        shrink = torch.where((thresh > 0.5) & (eta < 1.0), thresh * eta,
                             thresh)
        thresh = torch.where(ok, shrink, thresh)
    return keep_idx, keep_mask


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.45,
        max_output: int = 200, pre_topk: int = 400,
        score_threshold: float = NEG_INF, eta: float = 1.0,
        normalized: bool = True, valid_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (N,4), scores (N,) → (keep_idx (max_output,) int32 padded
    with -1, keep_mask (max_output,) float32)."""
    idx, mask = nms_batched(
        boxes[None], scores[None], iou_threshold, max_output, pre_topk,
        score_threshold, eta, normalized,
        None if valid_mask is None else valid_mask[None])
    return idx[0], mask[0]
