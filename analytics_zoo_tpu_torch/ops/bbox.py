"""Bounding-box math on tensors (the counterpart of ``ops/bbox.py``).

Box convention: corner form ``(x1, y1, x2, y2)``; ``normalized=True``
means [0,1] image coordinates (no +1 width term), ``False`` integer pixel
boxes Caffe-style (+1 term).  Every function broadcasts over leading
dims; the float operations follow the reference one for one, in the same
order, so results agree to the last bit where the platforms round alike.
"""

from __future__ import annotations

from typing import Tuple

import torch


def area(boxes: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """(…, 4) → (…,) box areas; empty/invalid boxes give 0."""
    off = 0.0 if normalized else 1.0
    w = boxes[..., 2] - boxes[..., 0] + off
    h = boxes[..., 3] - boxes[..., 1] + off
    return torch.where((w > 0) & (h > 0), w * h, torch.zeros_like(w))


def intersection(a: torch.Tensor, b: torch.Tensor,
                 normalized: bool = True) -> torch.Tensor:
    """Pairwise intersection areas: a (…,N,4), b (…,M,4) → (…,N,M)."""
    off = 0.0 if normalized else 1.0
    a, b = a[..., :, None, :], b[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    w = torch.clamp(x2 - x1 + off, min=0.0)
    h = torch.clamp(y2 - y1 + off, min=0.0)
    return w * h


def iou_matrix(a: torch.Tensor, b: torch.Tensor,
               normalized: bool = True) -> torch.Tensor:
    """Pairwise IoU: a (…,N,4), b (…,M,4) → (…,N,M); 0 where the union
    is not positive."""
    inter = intersection(a, b, normalized)
    ua = (area(a, normalized)[..., :, None] + area(b, normalized)[..., None, :]
          - inter)
    return torch.where(ua > 0, inter / ua, torch.zeros_like(ua))


def center_size(boxes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """corner → (cx, cy, w, h)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + w * 0.5
    cy = boxes[..., 1] + h * 0.5
    return cx, cy, w, h


def encode_bbox(priors: torch.Tensor, variances: torch.Tensor,
                gt: torch.Tensor) -> torch.Tensor:
    """Caffe-SSD center-size encoding of gt boxes against priors, the
    deltas divided by the variances: priors, variances, gt (…,4) →
    (…,4).  Prior sizes and gt sizes are floored at 1e-8, so a zero (padding)
    box encodes to a finite target."""
    pcx, pcy, pw, ph = center_size(priors)
    gcx, gcy, gw, gh = center_size(gt)
    pw = torch.clamp(pw, min=1e-8)
    ph = torch.clamp(ph, min=1e-8)
    ex = (gcx - pcx) / pw / variances[..., 0]
    ey = (gcy - pcy) / ph / variances[..., 1]
    ew = torch.log(torch.clamp(gw, min=1e-8) / pw) / variances[..., 2]
    eh = torch.log(torch.clamp(gh, min=1e-8) / ph) / variances[..., 3]
    return torch.stack([ex, ey, ew, eh], dim=-1)


def decode_bbox(priors: torch.Tensor, variances: torch.Tensor,
                deltas: torch.Tensor, clip: bool = False) -> torch.Tensor:
    """Caffe-SSD center-size decode of predicted deltas against priors →
    corner-form boxes."""
    pcx, pcy, pw, ph = center_size(priors)
    cx = variances[..., 0] * deltas[..., 0] * pw + pcx
    cy = variances[..., 1] * deltas[..., 1] * ph + pcy
    w = torch.exp(variances[..., 2] * deltas[..., 2]) * pw
    h = torch.exp(variances[..., 3] * deltas[..., 3]) * ph
    boxes = torch.stack([cx - w * 0.5, cy - h * 0.5,
                         cx + w * 0.5, cy + h * 0.5], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


def clip_boxes(boxes: torch.Tensor, height=1.0, width=1.0) -> torch.Tensor:
    """Clip corner boxes into the image: each coordinate to [0, width] or
    [0, height], ``min(max(x, 0), hi)`` as ``jnp.clip``.  ``height`` and
    ``width`` are numbers or tensors broadcasting against ``boxes[..., 0]``
    (one image's size a row)."""
    def clip(x, hi):
        return torch.minimum(torch.clamp(x, min=0.0), torch.as_tensor(
            hi, dtype=x.dtype, device=x.device))

    return torch.stack([clip(boxes[..., 0], width), clip(boxes[..., 1], height),
                        clip(boxes[..., 2], width), clip(boxes[..., 3], height)],
                       dim=-1)


def scale_boxes(boxes: torch.Tensor, sx, sy) -> torch.Tensor:
    """Scale x coordinates by ``sx`` and y by ``sy`` (normalized → pixel
    boxes)."""
    return torch.stack([boxes[..., 0] * sx, boxes[..., 1] * sy,
                        boxes[..., 2] * sx, boxes[..., 3] * sy], dim=-1)


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor
                   ) -> torch.Tensor:
    """Faster-RCNN pixel-box regression targets: +1 widths, no variance
    scaling.  (…,4), (…,4) → (…,4)."""
    ew = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    eh = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ecx = ex_rois[..., 0] + 0.5 * (ew - 1.0)
    ecy = ex_rois[..., 1] + 0.5 * (eh - 1.0)
    gw = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gh = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gcx = gt_rois[..., 0] + 0.5 * (gw - 1.0)
    gcy = gt_rois[..., 1] + 0.5 * (gh - 1.0)
    return torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                        torch.log(gw / ew), torch.log(gh / eh)], dim=-1)


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor
                       ) -> torch.Tensor:
    """Apply Faster-RCNN deltas to pixel boxes (the inverse of
    :func:`bbox_transform`)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * (w - 1.0)
    cy = boxes[..., 1] + 0.5 * (h - 1.0)
    ncx = deltas[..., 0] * w + cx
    ncy = deltas[..., 1] * h + cy
    nw = torch.exp(deltas[..., 2]) * w
    nh = torch.exp(deltas[..., 3]) * h
    return torch.stack([ncx - 0.5 * (nw - 1.0), ncy - 0.5 * (nh - 1.0),
                        ncx + 0.5 * (nw - 1.0), ncy + 0.5 * (nh - 1.0)],
                       dim=-1)


def bbox_vote(kept_boxes: torch.Tensor, kept_scores: torch.Tensor,
              all_boxes: torch.Tensor, all_scores: torch.Tensor,
              all_mask: torch.Tensor, iou_thresh: float = 0.5
              ) -> torch.Tensor:
    """Box voting: each kept box (…,K,4) becomes the score-weighted mean
    of the candidates (…,R,4) whose pixel IoU with it is at least
    ``iou_thresh`` (``all_mask`` > 0 marks a candidate); a kept box with
    no such candidate stays.  ``kept_scores`` is unused, as in the
    reference."""
    iou = iou_matrix(kept_boxes, all_boxes, normalized=False)
    w = torch.where((iou >= iou_thresh) & (all_mask[..., None, :] > 0),
                    all_scores[..., None, :], torch.zeros_like(iou))
    total = torch.sum(w, dim=-1, keepdim=True)
    voted = (w @ all_boxes) / torch.clamp(total, min=1e-12)
    return torch.where(total > 0, voted, kept_boxes)
