"""Faster-RCNN post-processing on tensors (counterpart of
``ops/frcnn.py``): per-class NMS over the class-wise boxes and scores,
optional box voting and a global ``max_per_image`` cut.

Batched over images and classes: one
:func:`~analytics_zoo_tpu_torch.ops.nms.nms_batched` call runs every
``(image, class)`` row, the background's included (then zeroed, as in
the reference).  Outputs are padded ``(…, max_per_image, 6)`` rows
``(class, score, x1, y1, x2, y2)``: a padded row is class -1, score 0,
box 0.
"""

from __future__ import annotations

import dataclasses

import torch

from analytics_zoo_tpu_torch.ops.bbox import bbox_vote
from analytics_zoo_tpu_torch.ops.nms import nms_batched, topk_stable


@dataclasses.dataclass(frozen=True)
class FrcnnPostParam:
    n_classes: int = 21
    nms_thresh: float = 0.3
    conf_thresh: float = 0.05
    bbox_vote: bool = False
    max_per_image: int = 100
    nms_topk: int = 300


def frcnn_postprocess(scores: torch.Tensor, boxes: torch.Tensor,
                      param: FrcnnPostParam = FrcnnPostParam()
                      ) -> torch.Tensor:
    """scores (…,R,C) softmax probabilities, boxes (…,R,C·4) per-class
    regressed pixel boxes (py-faster-rcnn layout) →
    (…, max_per_image, 6) detections."""
    R, C = scores.shape[-2:]
    lead = scores.shape[:-2]
    s_t = scores.transpose(-1, -2)                           # (…,C,R)
    b_t = boxes.reshape(*lead, R, C, 4).transpose(-3, -2)    # (…,C,R,4)
    keep_idx, keep_mask = nms_batched(
        b_t, s_t, iou_threshold=param.nms_thresh, max_output=param.nms_topk,
        pre_topk=min(param.nms_topk, R), score_threshold=param.conf_thresh,
        normalized=False)
    safe = torch.clamp(keep_idx, min=0).long()
    kept_boxes = torch.take_along_dim(b_t, safe[..., None], dim=-2)
    kept_scores = torch.take_along_dim(s_t, safe, dim=-1) * keep_mask
    if param.bbox_vote:
        kept_boxes = bbox_vote(kept_boxes, kept_scores, b_t, s_t,
                               torch.ones_like(s_t), param.nms_thresh)
    cls_ids = torch.arange(C, device=scores.device)
    kept_scores = kept_scores * (cls_ids != 0).to(torch.float32)[:, None]

    K = kept_scores.shape[-1]
    flat_scores = kept_scores.reshape(*lead, C * K)
    flat_boxes = kept_boxes.reshape(*lead, C * K, 4)
    flat_cls = cls_ids.repeat_interleave(K)
    top_scores, order = topk_stable(flat_scores, param.max_per_image)
    valid = top_scores > 0
    cls = torch.where(valid, flat_cls[order],
                      torch.full_like(order, -1)).to(torch.float32)
    top_boxes = torch.take_along_dim(flat_boxes, order[..., None], dim=-2)
    return torch.cat([
        cls[..., None], top_scores[..., None],
        torch.where(valid[..., None], top_boxes,
                    torch.zeros_like(top_boxes)),
    ], dim=-1)
