"""Detection evaluation: Pascal VOC and COCO mAP (the port's copy of
the JAX package's ``pipelines/evaluation.py``, which is plain numpy; the
port keeps its own so that it imports nothing of that package).

Per-batch TP/FP marking with difficult handling, VOC07 11-point or
area-under-PR AP, the ``+``-mergeable ``DetectionResult`` that plugs
into the ``Optimizer``'s validation loop, COCO-convention matching over
IoU thresholds 0.50:0.05:0.95, and the per-class ``PascalVocEvaluator``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a PR curve (reference ``EvalUtil.vocAp:37``): 11-point
    interpolation (VOC07) or area under the monotonized curve (VOC10+)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            mask = recall >= t
            p = float(precision[mask].max()) if mask.any() else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def mark_tp_fp(det_boxes: np.ndarray, det_scores: np.ndarray,
               gt_boxes: np.ndarray, gt_difficult: np.ndarray,
               iou_threshold: float = 0.5,
               normalized: bool = False) -> np.ndarray:
    """Greedy-match one image's detections (sorted by score desc) against
    gt (reference ``EvalUtil.evaluateBatch:100`` inner loop).

    Returns (N, 3) rows (score, tp, fp); detections matching a *difficult*
    gt count as neither.
    """
    order = np.argsort(-det_scores)
    taken = np.zeros(len(gt_boxes), bool)
    out = np.zeros((len(det_boxes), 3), np.float32)
    off = 0.0 if normalized else 1.0
    if len(gt_boxes):
        # vectorized IoU matrix (numpy twin of ops.bbox.iou_matrix)
        d, g = np.asarray(det_boxes, np.float64), np.asarray(gt_boxes, np.float64)
        ix1 = np.maximum(d[:, None, 0], g[None, :, 0])
        iy1 = np.maximum(d[:, None, 1], g[None, :, 1])
        ix2 = np.minimum(d[:, None, 2], g[None, :, 2])
        iy2 = np.minimum(d[:, None, 3], g[None, :, 3])
        inter = (np.maximum(ix2 - ix1 + off, 0)
                 * np.maximum(iy2 - iy1 + off, 0))
        area_d = (d[:, 2] - d[:, 0] + off) * (d[:, 3] - d[:, 1] + off)
        area_g = (g[:, 2] - g[:, 0] + off) * (g[:, 3] - g[:, 1] + off)
        iou_all = inter / np.maximum(area_d[:, None] + area_g[None, :] - inter,
                                     1e-12)
    for row, i in enumerate(order):
        out[row, 0] = det_scores[i]
        if len(gt_boxes):
            best_j = int(np.argmax(iou_all[i]))
            best_iou = float(iou_all[i, best_j])
        else:
            best_iou, best_j = 0.0, -1
        if best_iou >= iou_threshold and best_j >= 0:
            if gt_difficult[best_j] > 0:
                continue                       # difficult: ignore entirely
            if not taken[best_j]:
                out[row, 1] = 1.0              # tp
                taken[best_j] = True
            else:
                out[row, 2] = 1.0              # duplicate -> fp
        else:
            out[row, 2] = 1.0                  # no match -> fp
    return out


class DetectionResult:
    """Mergeable per-class accumulation of (score, tp, fp) + positive count
    (reference ``DetectionResult.scala:25,57`` monoid)."""

    name = "MeanAveragePrecision"

    def __init__(self, n_classes: int, use_07_metric: bool = True,
                 class_names: Optional[Sequence[str]] = None):
        self.n_classes = n_classes
        self.use_07_metric = use_07_metric
        self.class_names = class_names
        self.marks: Dict[int, List[np.ndarray]] = {c: [] for c in range(n_classes)}
        self.npos = np.zeros(n_classes, np.int64)

    def __add__(self, other: "DetectionResult") -> "DetectionResult":
        out = DetectionResult(self.n_classes, self.use_07_metric,
                              self.class_names)
        for c in range(self.n_classes):
            out.marks[c] = self.marks[c] + other.marks[c]
        out.npos = self.npos + other.npos
        return out

    def ap_per_class(self) -> np.ndarray:
        aps = np.zeros(self.n_classes, np.float32)
        for c in range(self.n_classes):
            if self.npos[c] == 0:
                aps[c] = np.nan
                continue
            if not self.marks[c]:
                aps[c] = 0.0
                continue
            rows = np.concatenate(self.marks[c], axis=0)
            order = np.argsort(-rows[:, 0])
            tp = np.cumsum(rows[order, 1])
            fp = np.cumsum(rows[order, 2])
            recall = tp / self.npos[c]
            precision = tp / np.maximum(tp + fp, 1e-12)
            aps[c] = voc_ap(recall, precision, self.use_07_metric)
        return aps

    def result(self) -> float:
        aps = self.ap_per_class()
        valid = ~np.isnan(aps)
        return float(aps[valid].mean()) if valid.any() else 0.0

    def __repr__(self):
        return f"{self.name}: {self.result():.4f}"


class MeanAveragePrecision:
    """ValidationMethod over ``(detections, target)`` batches — plugs into
    ``parallel.validate`` the way the reference plugs its
    MeanAveragePrecision into the Optimizer's validation loop.

    ``output``: (B, K, 6) DetectionOutput rows (cls, score, x1,y1,x2,y2).
    ``batch["target"]``: padded gt dict (bboxes (B,G,4), labels (B,G),
    difficult (B,G) optional, mask (B,G)).
    """

    def __init__(self, n_classes: int = 21, use_07_metric: bool = True,
                 iou_threshold: float = 0.5, normalized: bool = True,
                 class_names: Optional[Sequence[str]] = None):
        self.n_classes = n_classes
        self.use_07_metric = use_07_metric
        self.iou = iou_threshold
        self.normalized = normalized
        self.class_names = class_names
        self.name = "MeanAveragePrecision"

    def __call__(self, output, batch) -> DetectionResult:
        dets = np.asarray(output)
        target = batch["target"]
        gt_boxes = np.asarray(target["bboxes"])
        gt_labels = np.asarray(target["labels"])
        gt_mask = np.asarray(target["mask"])
        gt_diff = np.asarray(target.get("difficult", np.zeros_like(gt_mask)))
        res = DetectionResult(self.n_classes, self.use_07_metric,
                              self.class_names)
        B = dets.shape[0]
        for b in range(B):
            valid_gt = gt_mask[b] > 0
            for c in range(1, self.n_classes):
                cls_gt = valid_gt & (gt_labels[b] == c)
                res.npos[c] += int((cls_gt & (gt_diff[b] == 0)).sum())
                sel = (dets[b, :, 0] == c) & (dets[b, :, 1] > 0)
                if not sel.any():
                    continue
                marks = mark_tp_fp(
                    dets[b, sel, 2:6], dets[b, sel, 1],
                    gt_boxes[b][cls_gt], gt_diff[b][cls_gt],
                    self.iou, self.normalized)
                res.marks[c].append(marks)
        return res


def _iou_matrix(det_boxes: np.ndarray, gt_boxes: np.ndarray,
                normalized: bool) -> np.ndarray:
    d = np.asarray(det_boxes, np.float64)
    g = np.asarray(gt_boxes, np.float64)
    off = 0.0 if normalized else 1.0
    ix1 = np.maximum(d[:, None, 0], g[None, :, 0])
    iy1 = np.maximum(d[:, None, 1], g[None, :, 1])
    ix2 = np.minimum(d[:, None, 2], g[None, :, 2])
    iy2 = np.minimum(d[:, None, 3], g[None, :, 3])
    inter = (np.maximum(ix2 - ix1 + off, 0) * np.maximum(iy2 - iy1 + off, 0))
    area_d = (d[:, 2] - d[:, 0] + off) * (d[:, 3] - d[:, 1] + off)
    area_g = (g[:, 2] - g[:, 0] + off) * (g[:, 3] - g[:, 1] + off)
    return inter / np.maximum(area_d[:, None] + area_g[None, :] - inter,
                              1e-12)


def mark_tp_fp_multi(det_boxes: np.ndarray, det_scores: np.ndarray,
                     gt_boxes: np.ndarray, gt_difficult: np.ndarray,
                     thresholds: Sequence[float],
                     normalized: bool = True) -> List[np.ndarray]:
    """COCO-convention matching at several IoU thresholds sharing ONE IoU
    matrix + score sort: each detection (score desc) matches the
    HIGHEST-IoU still-unmatched non-difficult gt with IoU ≥ t (pycocotools
    semantics — NOT the VOC argmax-only rule of :func:`mark_tp_fp`, which
    marks a duplicate FP even when another gt would match).  Difficult
    (COCO "ignore") gts absorb otherwise-unmatched detections.

    Returns one (N, 3) (score, tp, fp) array per threshold.
    """
    order = np.argsort(-np.asarray(det_scores))
    n_det, n_gt = len(det_boxes), len(gt_boxes)
    iou = (_iou_matrix(det_boxes, gt_boxes, normalized) if n_gt
           else np.zeros((n_det, 0)))
    diff = np.asarray(gt_difficult) > 0
    outs = []
    for t in thresholds:
        out = np.zeros((n_det, 3), np.float32)
        taken = np.zeros(n_gt, bool)
        for row, i in enumerate(order):
            out[row, 0] = det_scores[i]
            cand = ~taken & ~diff & (iou[i] >= t) if n_gt else np.zeros(0, bool)
            if cand.any():
                j = int(np.argmax(np.where(cand, iou[i], -1.0)))
                taken[j] = True
                out[row, 1] = 1.0                      # tp
            elif n_gt and (diff & (iou[i] >= t)).any():
                continue                               # ignore region
            else:
                out[row, 2] = 1.0                      # fp
        outs.append(out)
    return outs


class MultiIoUResult:
    """Monoid over per-IoU-threshold DetectionResults (COCO-style)."""

    def __init__(self, results: List[DetectionResult],
                 name: str = "mAP@[.5:.95]"):
        self.results = results
        self.name = name

    def __add__(self, other: "MultiIoUResult") -> "MultiIoUResult":
        return MultiIoUResult([a + b for a, b in
                               zip(self.results, other.results)], self.name)

    def result(self) -> float:
        vals = [r.result() for r in self.results]
        return float(np.mean(vals)) if vals else 0.0

    def per_threshold(self) -> List[float]:
        return [r.result() for r in self.results]

    def __repr__(self):
        return f"{self.name}: {self.result():.4f}"


class CocoMeanAveragePrecision:
    """COCO-convention mAP averaged over IoU thresholds 0.50:0.05:0.95
    with area-under-PR AP and pycocotools matching (best still-unmatched
    gt, difficult = ignore region) — net-new over the reference, whose
    COCO support stops at dataset ingestion + VOC-style eval
    (``common/Coco.scala``, ``EvalUtil``).  Same batch interface as
    :class:`MeanAveragePrecision`, so it plugs into ``parallel.validate``
    / ``set_validation`` unchanged.  The per-image IoU matrix and score
    sort are computed ONCE and shared across all thresholds.
    """

    def __init__(self, n_classes: int = 81, normalized: bool = True,
                 class_names: Optional[Sequence[str]] = None,
                 thresholds: Optional[Sequence[float]] = None):
        self.thresholds = (list(thresholds) if thresholds is not None
                           else [0.5 + 0.05 * i for i in range(10)])
        self.n_classes = n_classes
        self.normalized = normalized
        self.class_names = class_names
        self.name = "mAP@[.5:.95]"

    def __call__(self, output, batch) -> MultiIoUResult:
        dets = np.asarray(output)
        target = batch["target"]
        gt_boxes = np.asarray(target["bboxes"])
        gt_labels = np.asarray(target["labels"])
        gt_mask = np.asarray(target["mask"])
        gt_diff = np.asarray(target.get("difficult", np.zeros_like(gt_mask)))
        results = [DetectionResult(self.n_classes, use_07_metric=False,
                                   class_names=self.class_names)
                   for _ in self.thresholds]
        for b in range(dets.shape[0]):
            valid_gt = gt_mask[b] > 0
            for c in range(1, self.n_classes):
                cls_gt = valid_gt & (gt_labels[b] == c)
                npos = int((cls_gt & (gt_diff[b] == 0)).sum())
                for r in results:
                    r.npos[c] += npos
                sel = (dets[b, :, 0] == c) & (dets[b, :, 1] > 0)
                if not sel.any():
                    continue
                marks = mark_tp_fp_multi(
                    dets[b, sel, 2:6], dets[b, sel, 1],
                    gt_boxes[b][cls_gt], gt_diff[b][cls_gt],
                    self.thresholds, self.normalized)
                for r, m in zip(results, marks):
                    r.marks[c].append(m)
        return MultiIoUResult(results, self.name)


class PascalVocEvaluator:
    """Standalone evaluator with per-class AP printout (reference
    ``PascalVocEvaluator.scala:33``; metric picked by year: 2007 → 11-point)."""

    def __init__(self, image_set: str = "voc_2007_test",
                 class_names: Optional[Sequence[str]] = None):
        self.use_07_metric = "2007" in image_set
        self.class_names = class_names

    def evaluate(self, result: DetectionResult) -> float:
        # the year decides the metric, overriding whatever the accumulating
        # method defaulted to (reference picks 07 vs 10+ metric by year)
        result.use_07_metric = self.use_07_metric
        aps = result.ap_per_class()
        names = self.class_names or [str(i) for i in range(len(aps))]
        for name, ap in zip(names[1:], aps[1:]):
            if not np.isnan(ap):
                print(f"AP for {name} = {ap:.4f}")
        valid = ~np.isnan(aps)
        m = float(aps[valid].mean()) if valid.any() else 0.0
        print(f"Mean AP = {m:.4f}")
        return m
