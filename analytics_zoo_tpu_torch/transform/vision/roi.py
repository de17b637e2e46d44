"""ROI labels and the label co-transforms that keep boxes consistent
with image ops (counterpart of ``transform/vision/roi.py``), host numpy
code: ``RoiLabel``, the overlap and projection helpers, and
``RoiNormalize``, ``RoiHFlip``, ``RoiCrop`` and ``RoiExpand``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.transform.vision.image import (FeatureTransformer,
                                                            ImageFeature)


@dataclasses.dataclass
class RoiLabel:
    """Per-image detection labels: N class ids, N×4 corner boxes and N
    difficult flags."""

    labels: np.ndarray      # (N,) float/int class ids
    bboxes: np.ndarray      # (N, 4) corner boxes
    difficult: Optional[np.ndarray] = None  # (N,) 0/1

    def __post_init__(self):
        self.labels = np.asarray(self.labels, np.float32).reshape(-1)
        self.bboxes = np.asarray(self.bboxes, np.float32).reshape(-1, 4)
        if self.difficult is None:
            self.difficult = np.zeros_like(self.labels)
        else:
            self.difficult = np.asarray(self.difficult, np.float32).reshape(-1)

    def size(self) -> int:
        return int(self.labels.shape[0])

    def select(self, keep: np.ndarray) -> "RoiLabel":
        return RoiLabel(self.labels[keep], self.bboxes[keep],
                        self.difficult[keep])

    def to_gt_matrix(self) -> np.ndarray:
        """(N, 6) rows (label, difficult, x1, y1, x2, y2)."""
        return np.concatenate([
            self.labels[:, None], self.difficult[:, None], self.bboxes,
        ], axis=1).astype(np.float32)

    @staticmethod
    def from_gt_matrix(m: np.ndarray) -> "RoiLabel":
        m = np.asarray(m, np.float32).reshape(-1, 6)
        return RoiLabel(m[:, 0], m[:, 2:6], m[:, 1])


# ---------------------------------------------------------------------------
# host-side bbox helpers
# ---------------------------------------------------------------------------


def jaccard_overlap_matrix(a_boxes: np.ndarray,
                           b_boxes: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (T,4) against (G,4) normalized boxes → (T,G)."""
    x1 = np.maximum(a_boxes[:, None, 0], b_boxes[None, :, 0])
    y1 = np.maximum(a_boxes[:, None, 1], b_boxes[None, :, 1])
    x2 = np.minimum(a_boxes[:, None, 2], b_boxes[None, :, 2])
    y2 = np.minimum(a_boxes[:, None, 3], b_boxes[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    a = ((a_boxes[:, 2] - a_boxes[:, 0])
         * (a_boxes[:, 3] - a_boxes[:, 1]))[:, None]
    b = ((b_boxes[:, 2] - b_boxes[:, 0])
         * (b_boxes[:, 3] - b_boxes[:, 1]))[None, :]
    union = a + b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def jaccard_overlap(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one normalized box against (N,4) boxes."""
    return jaccard_overlap_matrix(box[None, :], boxes)[0]


def meet_emit_center_constraint(src_box: np.ndarray,
                                boxes: np.ndarray) -> np.ndarray:
    """True where a gt box's center lies inside ``src_box``."""
    cx = (boxes[:, 0] + boxes[:, 2]) / 2.0
    cy = (boxes[:, 1] + boxes[:, 3]) / 2.0
    return ((cx >= src_box[0]) & (cx <= src_box[2]) &
            (cy >= src_box[1]) & (cy <= src_box[3]))


def project_bbox(src_box: np.ndarray, boxes: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Re-express normalized ``boxes`` in the frame of ``src_box``:
    returns (projected (N,4) clipped
    to [0,1], valid mask — projected boxes with positive area)."""
    w = src_box[2] - src_box[0]
    h = src_box[3] - src_box[1]
    out = np.stack([
        (boxes[:, 0] - src_box[0]) / w,
        (boxes[:, 1] - src_box[1]) / h,
        (boxes[:, 2] - src_box[0]) / w,
        (boxes[:, 3] - src_box[1]) / h,
    ], axis=1)
    out = np.clip(out, 0.0, 1.0)
    valid = (out[:, 2] > out[:, 0]) & (out[:, 3] > out[:, 1])
    return out.astype(np.float32), valid


# ---------------------------------------------------------------------------
# co-transforms
# ---------------------------------------------------------------------------


class RoiNormalize(FeatureTransformer):
    """Pixel gt boxes → [0,1].  Writes a fresh RoiLabel — the caller's label object is never mutated,
    so re-running a chain over retained features stays correct."""

    def transform_mat(self, feature: ImageFeature) -> None:
        label: RoiLabel = feature.label
        h, w = feature.mat.shape[:2]
        bboxes = label.bboxes.copy()
        bboxes[:, 0::2] /= w
        bboxes[:, 1::2] /= h
        feature["label"] = RoiLabel(label.labels.copy(), bboxes,
                                    label.difficult.copy())


class RoiHFlip(FeatureTransformer):
    """Mirror gt x coords; pairs with HFlip on the image.  Non-mutating,
    like RoiNormalize."""

    def __init__(self, normalized: bool = True):
        super().__init__()
        self.normalized = normalized

    def transform_mat(self, feature: ImageFeature) -> None:
        label: RoiLabel = feature.label
        w = 1.0 if self.normalized else feature.mat.shape[1]
        bboxes = label.bboxes.copy()
        bboxes[:, 0] = w - label.bboxes[:, 2]
        bboxes[:, 2] = w - label.bboxes[:, 0]
        feature["label"] = RoiLabel(label.labels.copy(), bboxes,
                                    label.difficult.copy())


class RoiProject(FeatureTransformer):
    """Shared logic of RoiCrop/RoiExpand: re-project gt into
    the frame recorded by the paired image op, dropping boxes whose center
    fell outside (emit-center constraint)."""

    def __init__(self, bbox_key: str, emit_center: bool = True):
        super().__init__()
        self.bbox_key = bbox_key
        self.emit_center = emit_center

    def transform_mat(self, feature: ImageFeature) -> None:
        if self.bbox_key not in feature:
            return
        src = np.asarray(feature[self.bbox_key], np.float32)
        label: RoiLabel = feature.label
        if label.size() == 0:
            return
        projected, valid = project_bbox(src, label.bboxes)
        if self.emit_center:
            valid &= meet_emit_center_constraint(src, label.bboxes)
        new = label.select(valid)
        new.bboxes = projected[valid]
        feature["label"] = new


class RoiCrop(RoiProject):
    """Pairs with Crop."""

    def __init__(self):
        super().__init__("crop_bbox", emit_center=True)


class RoiExpand(RoiProject):
    """Pairs with Expand."""

    def __init__(self):
        super().__init__("expand_bbox", emit_center=False)
