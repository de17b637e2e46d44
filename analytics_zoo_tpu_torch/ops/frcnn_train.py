"""Faster-RCNN training targets and losses (counterpart of
``ops/frcnn_train.py``): approximate joint training as in the
Faster-RCNN paper.

- :func:`rpn_targets`: per-anchor objectness labels (IoU ≥ 0.7 or the
  best anchor of a gt → positive, IoU < 0.3 → negative, anchors crossing
  the image border ignored) and box targets against the matched gt;
- :func:`head_targets`: per-ROI class labels (IoU ≥ 0.5 → the matched
  gt's class, else background) and box targets;
- both sample a fixed-size minibatch deterministically by rank:
  positives by descending IoU, negatives hardest first by the current
  scores.  Ranks come from a stable double argsort, so ties go to the
  lower index, as ``jnp.argsort`` orders them;
- :func:`frcnn_training_loss`: RPN softmax CE + smooth-L1 and head
  softmax CE + smooth-L1 on the target class's 4 deltas, each normalized
  by its sampled count.

Every function takes leading batch dims: the reference maps one image,
here a batch runs as one set of tensor ops with the same result.  The
targets carry no gradient, and the loss runs in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from analytics_zoo_tpu_torch.core.criterion import smooth_l1
from analytics_zoo_tpu_torch.ops.bbox import bbox_transform, iou_matrix


@dataclasses.dataclass(frozen=True)
class FrcnnLossParam:
    rpn_sample: int = 256
    rpn_pos_frac: float = 0.5
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    head_sample: int = 128
    head_pos_frac: float = 0.25
    head_fg_iou: float = 0.5


def _rank_desc(priority: torch.Tensor) -> torch.Tensor:
    """rank[..., i] = position of i when the last dim is sorted by
    priority descending, ties in index order (a stable double argsort)."""
    order = torch.argsort(-priority, dim=-1, stable=True)
    ranks = torch.arange(priority.shape[-1], device=priority.device)
    return torch.empty_like(order).scatter_(
        -1, order, ranks.expand_as(order).contiguous())


def _match(boxes: torch.Tensor, gt: torch.Tensor, gt_mask: torch.Tensor):
    """IoU (…,N,G) of pixel boxes against the valid gts (+1-pixel
    widths), each box's best IoU and its gt (the first maximum)."""
    iou = iou_matrix(boxes, gt, normalized=False)
    iou = torch.where(gt_mask[..., None, :] > 0, iou, torch.zeros_like(iou))
    max_iou, arg_gt = iou.max(dim=-1)
    return iou, max_iou, arg_gt


def _gather_gt(gt: torch.Tensor, arg_gt: torch.Tensor) -> torch.Tensor:
    """gt (…,G,4) rows at arg_gt (…,N) → (…,N,4)."""
    return torch.take_along_dim(gt, arg_gt[..., None], dim=-2)


@torch.no_grad()
def rpn_targets(anchors, gt, gt_mask, im_h, im_w, fg_scores,
                p: FrcnnLossParam = FrcnnLossParam()
                ) -> Tuple[torch.Tensor, ...]:
    """(labels (…,N), cls_w (…,N), box_targets (…,N,4), box_w (…,N)).

    ``anchors`` (N,4) pixel boxes (shared, or with the leading dims);
    ``gt`` (…,G,4) pixel boxes with ``gt_mask`` (…,G) validity; ``im_h``,
    ``im_w`` one value per image; ``fg_scores`` (…,N) the current
    objectness probabilities (hard-negative ranking)."""
    fg_scores = torch.as_tensor(fg_scores)
    dev = fg_scores.device
    anchors, gt, gt_mask = (torch.as_tensor(v, dtype=torch.float32,
                                            device=dev)
                            for v in (anchors, gt, gt_mask))
    im_h = torch.as_tensor(im_h, dtype=torch.float32, device=dev)[..., None]
    im_w = torch.as_tensor(im_w, dtype=torch.float32, device=dev)[..., None]
    iou, max_iou, arg_gt = _match(anchors, gt, gt_mask)
    inside = ((anchors[..., 0] >= 0) & (anchors[..., 1] >= 0)
              & (anchors[..., 2] <= im_w - 1.0)
              & (anchors[..., 3] <= im_h - 1.0))
    # each gt's best anchor is positive even below the IoU bar: a max
    # scatter (bool OR), since padded gts all argmax to anchor 0 with a
    # False that a plain index-assign could write over a valid True
    best_iou, best_anchor = iou.max(dim=-2)                  # (…,G)
    hit = ((gt_mask > 0) & (best_iou > 0)).to(torch.int32)
    is_best = torch.zeros(iou.shape[:-1], dtype=torch.int32, device=dev)
    is_best = is_best.scatter_reduce(-1, best_anchor, hit, "amax") > 0
    pos = inside & ((max_iou >= p.rpn_pos_iou) | is_best)
    neg = inside & (max_iou < p.rpn_neg_iou) & ~pos

    ninf = torch.full((), float("-inf"), device=dev)
    n_pos_cap = int(p.rpn_sample * p.rpn_pos_frac)
    sel_pos = pos & (_rank_desc(torch.where(pos, max_iou, ninf)) < n_pos_cap)
    n_pos = sel_pos.sum(dim=-1, keepdim=True)
    # hardest negatives: the highest current objectness first
    sel_neg = neg & (_rank_desc(torch.where(neg, fg_scores.float(), ninf))
                     < p.rpn_sample - n_pos)
    box_targets = bbox_transform(anchors, _gather_gt(gt, arg_gt))
    return (pos.float(), (sel_pos | sel_neg).float(), box_targets,
            sel_pos.float())


@torch.no_grad()
def head_targets(rois, roi_mask, gt, gt_labels, gt_mask, bg_scores,
                 p: FrcnnLossParam = FrcnnLossParam()
                 ) -> Tuple[torch.Tensor, ...]:
    """(labels (…,R) int64, cls_w (…,R), box_targets (…,R,4), box_w (…,R)).

    ``rois`` (…,R,4) pixel proposals with ``roi_mask`` validity;
    ``gt_labels`` (…,G) class ids (0, the background, is never a gt);
    ``bg_scores`` (…,R) the current 1 − P(background) (hard-negative
    ranking)."""
    bg_scores = torch.as_tensor(bg_scores)
    dev = bg_scores.device
    rois, roi_mask, gt, gt_mask = (
        torch.as_tensor(v, dtype=torch.float32, device=dev)
        for v in (rois, roi_mask, gt, gt_mask))
    gt_labels = torch.as_tensor(gt_labels, device=dev).long()
    _, max_iou, arg_gt = _match(rois, gt, gt_mask)
    valid = roi_mask > 0
    fg = valid & (max_iou >= p.head_fg_iou)
    bg = valid & ~fg

    ninf = torch.full((), float("-inf"), device=dev)
    n_fg_cap = int(p.head_sample * p.head_pos_frac)
    sel_fg = fg & (_rank_desc(torch.where(fg, max_iou, ninf)) < n_fg_cap)
    n_fg = sel_fg.sum(dim=-1, keepdim=True)
    sel_bg = bg & (_rank_desc(torch.where(bg, bg_scores.float(), ninf))
                   < p.head_sample - n_fg)
    labels = torch.where(sel_fg, torch.take_along_dim(gt_labels, arg_gt,
                                                      dim=-1),
                         torch.zeros_like(arg_gt))
    box_targets = bbox_transform(rois, _gather_gt(gt, arg_gt))
    return labels, (sel_fg | sel_bg).float(), box_targets, sel_fg.float()


def _weighted_softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """Softmax CE over (…,N,C) logits weighted by w (…,N), normalized by
    max(Σw, 1) over N → (…)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.take_along_dim(logp, labels.long()[..., None], dim=-1)[..., 0]
    return -(ll * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)


def frcnn_training_loss(outputs: Dict[str, torch.Tensor], batch: Dict,
                        p: FrcnnLossParam = FrcnnLossParam()
                        ) -> torch.Tensor:
    """The mean over the batch's images of the four losses, from
    ``FasterRcnnVgg(..., train_outputs=True)``'s dict and a batch with
    ``target`` = {bboxes (B,G,4) pixel boxes at the network input's
    scale, labels (B,G), mask (B,G)} and ``im_info`` rows (h, w, …).
    Computed in fp32 with autocast off."""
    dev = outputs["rois"].device
    tgt = batch["target"]
    gt = torch.as_tensor(tgt["bboxes"], dtype=torch.float32, device=dev)
    gt_labels = torch.as_tensor(tgt["labels"], device=dev)
    gt_mask = torch.as_tensor(tgt["mask"], dtype=torch.float32, device=dev)
    info = torch.as_tensor(batch["im_info"], dtype=torch.float32, device=dev)
    out = {k: v.float() for k, v in outputs.items()}
    with torch.autocast(dev.type, enabled=False):
        labels, cls_w, box_t, box_w = rpn_targets(
            out["anchors"], gt, gt_mask, info[:, 0], info[:, 1],
            out["fg_scores"].detach(), p)
        rpn_cls = _weighted_softmax_ce(out["rpn_cls_logits"], labels, cls_w)
        rpn_box = ((smooth_l1(out["rpn_deltas"] - box_t)
                    * box_w[..., None]).sum(dim=(-2, -1))
                   / torch.clamp(cls_w.sum(dim=-1), min=1.0))

        cls_logits = out["cls_logits"]
        bg_scores = 1.0 - torch.softmax(cls_logits.detach(), dim=-1)[..., 0]
        hl, hw, hbox_t, hbox_w = head_targets(
            out["rois"], out["roi_mask"], gt, gt_labels, gt_mask, bg_scores,
            p)
        head_cls = _weighted_softmax_ce(cls_logits, hl, hw)
        # the box loss only on the target class's 4 deltas
        C = cls_logits.shape[-1]
        d = out["bbox_deltas"].reshape(*cls_logits.shape[:-1], C, 4)
        d_cls = torch.take_along_dim(d, hl[..., None, None].expand(
            *hl.shape, 1, 4), dim=-2)[..., 0, :]                 # (…,R,4)
        head_box = ((smooth_l1(d_cls - hbox_t) * hbox_w[..., None])
                    .sum(dim=(-2, -1)) / torch.clamp(hw.sum(dim=-1),
                                                    min=1.0))
        return (rpn_cls + rpn_box + head_cls + head_box).mean()
