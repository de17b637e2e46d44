"""RPN proposal layer on tensors (counterpart of ``ops/proposal.py``):
apply the deltas to the anchors, clip to the image, drop boxes smaller
than ``min_size`` (scaled), keep the top ``pre_nms_topn`` by score, NMS,
keep the top ``post_nms_topn``.  Inference only, as in the reference.

Static shapes: "filtering" is a ``-inf`` mask and the output is padded
to ``post_nms_topn`` rows under a validity mask.  Batched over images:
one :func:`~analytics_zoo_tpu_torch.ops.nms.nms_batched` call serves
every image of a batch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from analytics_zoo_tpu_torch.ops.bbox import bbox_transform_inv, clip_boxes
from analytics_zoo_tpu_torch.ops.nms import nms_batched


@dataclasses.dataclass(frozen=True)
class ProposalParam:
    pre_nms_topn: int = 6000
    post_nms_topn: int = 300
    nms_thresh: float = 0.7
    min_size: int = 16


def _as_rows(v, like: torch.Tensor) -> torch.Tensor:
    """A per-image scalar (a number, or a tensor of the leading dims) as
    a float32 tensor on ``like``'s device broadcasting over its last
    dim."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)[
        ..., None]


def proposal(scores: torch.Tensor, deltas: torch.Tensor,
             anchors: torch.Tensor, im_height, im_width, scale,
             param: ProposalParam = ProposalParam()
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (…,N) foreground probabilities, deltas (…,N,4), anchors
    (N,4) pixel boxes shared by every image; ``im_height``, ``im_width``
    and ``scale`` one value per image (numbers or tensors of the leading
    dims).

    Returns (rois (…,post_nms_topn,4) zeroed where padded, mask
    (…,post_nms_topn) float32)."""
    boxes = clip_boxes(bbox_transform_inv(anchors, deltas),
                       _as_rows(im_height, scores) - 1.0,
                       _as_rows(im_width, scores) - 1.0)
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    min_sz = param.min_size * _as_rows(scale, scores)
    keep = (ws >= min_sz) & (hs >= min_sz)
    masked = torch.where(keep, scores, torch.full_like(scores,
                                                       float("-inf")))
    keep_idx, keep_mask = nms_batched(
        boxes, masked, iou_threshold=param.nms_thresh,
        max_output=param.post_nms_topn,
        pre_topk=min(param.pre_nms_topn, scores.shape[-1]),
        normalized=False)
    safe = torch.clamp(keep_idx, min=0).long()
    rois = torch.take_along_dim(boxes, safe[..., None], dim=-2)
    return rois * keep_mask[..., None], keep_mask
