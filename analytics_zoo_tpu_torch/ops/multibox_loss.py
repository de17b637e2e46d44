"""MultiBoxLoss: the SSD training criterion on tensors (counterpart of
``ops/multibox_loss.py``).

The whole batch at once, with masks in place of filtering so shapes stay
fixed:

- matching: an IoU matrix and a per-prior argmax, then every valid gt
  claims its best prior (the bipartite phase);
- hard-negative mining: the negatives ranked by their background loss
  (one stable descending sort, or the stable top ``mining_topk`` in
  ``mining="topk"``), the first ``neg_pos_ratio·num_pos`` kept;
- smooth-L1 on the encoded deltas of the positives plus cross-entropy on
  the positives and the kept negatives, over the batch's match count.

Three choices keep the port's result the same on the CPU and on the card,
where scatters with repeated indices and ``topk`` promise no order:

- a prior claimed by several gts goes to the LARGEST gt index (the
  reference's scatter lets the later gt win), by a ``scatter_reduce``
  with ``amax``, whose result does not depend on the order;
- ranking sorts stably, so tied losses (the uniform logits of a fresh
  model) go to the lower prior, as ``argsort`` and ``lax.top_k`` order
  them;
- every masked term stays finite: a padding gt is a zero box, and its
  target, floored by ``encode_bbox``, is finite before the mask zeroes
  it (``0 · inf`` would be NaN in the gradient).

The gradient-explosion guard (skip the update when the loss exceeds 50)
lives in the train step's ``skip_loss_above``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.profiler import record_function

from analytics_zoo_tpu_torch.core.criterion import Criterion, smooth_l1
from analytics_zoo_tpu_torch.ops.bbox import encode_bbox, iou_matrix
from analytics_zoo_tpu_torch.utils.device import host_constant
from analytics_zoo_tpu_torch.utils.spmd import global_count, global_width

MINING = ("sort", "topk")


@dataclasses.dataclass(frozen=True)
class MultiBoxLossParam:
    """The reference ``MultiBoxLossParam`` defaults: loc weight 1, 21
    classes, overlap 0.5, negatives 3 a positive.  ``mining="sort"``
    ranks every negative; ``"topk"`` only the ``mining_topk`` hardest
    (exact while ``num_neg`` stays below it, capped there otherwise)."""

    loc_weight: float = 1.0
    n_classes: int = 21
    overlap_threshold: float = 0.5
    background_id: int = 0
    neg_pos_ratio: float = 3.0
    neg_overlap: float = 0.5
    mining: str = "sort"
    mining_topk: int = 1024


def match_priors(priors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_mask: torch.Tensor, overlap_threshold: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Match P priors to G masked ground truths, per image: priors (P,4),
    gt_boxes (…,G,4), gt_mask (…,G) with 1.0 = valid.

    Returns ``(matched_gt_idx (…,P) int64, positive (…,P) bool,
    best_gt_iou (…,P))``.  Each prior takes its best-IoU gt (the first on
    a tie), positive at IoU ≥ ``overlap_threshold``; then every valid gt
    claims its best prior (the first on a tie) whatever the IoU, the
    largest gt index winning a prior claimed twice."""
    iou = iou_matrix(priors, gt_boxes)                       # (…,P,G)
    iou = torch.where(gt_mask[..., None, :] > 0, iou, -1.0)
    best_gt_iou, best_gt = iou.max(-1)
    positive = best_gt_iou >= overlap_threshold
    P, G = iou.shape[-2:]
    best_prior = iou.argmax(-2)                              # (…,G)
    # valid gts scatter their index onto their best prior; invalid ones
    # onto a spare slot P, cut off after
    slot = torch.where(gt_mask > 0, best_prior, P)
    g_ids = torch.arange(G, device=iou.device).expand_as(slot)
    claim = torch.full(slot.shape[:-1] + (P + 1,), -1, dtype=torch.int64,
                       device=iou.device)
    claim = claim.scatter_reduce(-1, slot, g_ids, "amax")[..., :P]
    forced = claim >= 0
    matched = torch.where(forced, claim, best_gt)
    return matched, positive | forced, best_gt_iou


def mine_hard_examples(logp: torch.Tensor, positive: torch.Tensor,
                       best_gt_iou: torch.Tensor,
                       param: MultiBoxLossParam) -> torch.Tensor:
    """The negatives the confidence loss keeps, (…,P) bool, from the log
    class probabilities ``logp`` (…,P,C): candidates are the non-positive
    priors whose best overlap is under ``neg_overlap``; the
    ``min(neg_pos_ratio·num_pos, #candidates)`` with the largest
    background loss are kept, a tie going to the lower prior."""
    neg_cand = ~positive & (best_gt_iou < param.neg_overlap)
    neg_loss = torch.where(neg_cand, -logp[..., param.background_id].detach(),
                           float("-inf"))
    num_pos = positive.sum(-1, keepdim=True).float()
    num_neg = torch.minimum(param.neg_pos_ratio * num_pos,
                            neg_cand.sum(-1, keepdim=True).float())
    order = torch.argsort(neg_loss, dim=-1, descending=True, stable=True)
    if param.mining == "topk":
        k = min(param.mining_topk, order.shape[-1])
        order = order[..., :k]
        num_neg = torch.clamp(num_neg, max=float(k))
    elif param.mining != "sort":
        raise ValueError(f"unknown mining mode {param.mining!r}")
    take = torch.arange(order.shape[-1], device=order.device) < num_neg
    return torch.zeros_like(neg_cand).scatter(-1, order, take) & neg_cand


def multibox_loss(loc_pred: torch.Tensor, conf_logits: torch.Tensor,
                  priors: torch.Tensor, variances: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  gt_mask: torch.Tensor,
                  param: MultiBoxLossParam = MultiBoxLossParam()
                  ) -> torch.Tensor:
    """Batched SSD loss: loc_pred (B,P,4), conf_logits (B,P,C) raw
    logits, priors and variances (P,4), gt_boxes (B,G,4) normalized corner
    form, gt_labels (B,G) int, gt_mask (B,G) 1.0 = valid.  The scalar
    ``(loc + conf) / max(#matches, 1)``."""
    matched, positive, best_iou = match_priors(priors, gt_boxes, gt_mask,
                                               param.overlap_threshold)
    pos_f = positive.float()
    matched_boxes = torch.take_along_dim(gt_boxes, matched[..., None], -2)
    loc_target = encode_bbox(priors, variances, matched_boxes)
    loc_loss = (smooth_l1(loc_pred - loc_target).sum(-1) * pos_f).sum(-1)
    matched_label = torch.where(
        positive, torch.take_along_dim(gt_labels.long(), matched, -1),
        param.background_id)
    logp = torch.log_softmax(conf_logits, -1)
    ce = -torch.take_along_dim(logp, matched_label[..., None], -1)[..., 0]
    neg = mine_hard_examples(logp, positive, best_iou, param)
    conf_loss = (ce * (pos_f + neg.float())).sum(-1)
    # the positives of the whole batch (summed over the data ranks of a
    # sharded step, whose average loss is then the global one)
    total_pos = torch.clamp(global_count(pos_f.sum()), min=1.0) \
        / global_width()
    return ((param.loc_weight * loc_loss).sum() + conf_loss.sum()) / total_pos


class MultiBoxLoss(Criterion):
    """Criterion over :func:`multibox_loss` for the train loop: output
    ``(loc (B,P,4), conf (B,P,C))``, target ``{"bboxes": (B,G,4),
    "labels": (B,G), "mask": (B,G)}`` (the padded form of the reference's
    ragged gt rows).  The priors move to the output's device on first
    use there, once, without a host sync (``host_constant``).  The call
    is the ``torch.profiler`` range ``multibox_loss``."""

    def __init__(self, priors, variances,
                 param: MultiBoxLossParam = MultiBoxLossParam()):
        if param.mining not in MINING:
            raise ValueError(f"mining={param.mining!r} not in {MINING}")
        self.priors = torch.as_tensor(priors, dtype=torch.float32)
        self.variances = torch.as_tensor(variances, dtype=torch.float32)
        self.param = param
        self._on: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _geometry(self, device: torch.device):
        if device not in self._on:
            self._on[device] = (host_constant(self.priors, device),
                                host_constant(self.variances, device))
        return self._on[device]

    @record_function("multibox_loss")
    def __call__(self, output, target, mask=None):
        loc, conf = output
        priors, variances = self._geometry(loc.device)
        dev = loc.device
        boxes, labels, gt_mask = (torch.as_tensor(target[k], device=dev)
                                  for k in ("bboxes", "labels", "mask"))
        return multibox_loss(loc, conf, priors, variances, boxes.float(),
                             labels, gt_mask.float(), self.param)
