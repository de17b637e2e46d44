"""SSD batch samplers: constrained random crops for training
(counterpart of ``transform/vision/sampler.py``), host numpy code.  Each
sampler tries up to ``max_trials`` random
boxes (scale ∈ [min_scale, max_scale], aspect ∈ [min_ar, max_ar]) and keeps
those meeting its min/max-IoU constraint against the gt; ``RandomSampler``
runs the 7 standard SSD samplers (no-constraint + IoU ≥ .1/.3/.5/.7/.9 +
IoU ≤ 1.0), picks one sampled box at random, and applies Crop + RoiCrop.
Draws come from a ``random.Random`` (by default the per-sample stream
``data.transformer.sample_random``), in the reference's order.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional

import numpy as np

from analytics_zoo_tpu_torch.data.transformer import sample_random
from analytics_zoo_tpu_torch.transform.vision.augmentation import Crop
from analytics_zoo_tpu_torch.transform.vision.image import (FeatureTransformer,
                                                            ImageFeature)
from analytics_zoo_tpu_torch.transform.vision.roi import (
    RoiCrop,
    RoiLabel,
    jaccard_overlap,
    jaccard_overlap_matrix,
)


@dataclasses.dataclass
class BatchSampler:
    """One constrained sampler."""

    max_sample: int = 1
    max_trials: int = 50
    min_scale: float = 0.3
    max_scale: float = 1.0
    min_aspect_ratio: float = 0.5
    max_aspect_ratio: float = 2.0
    min_overlap: Optional[float] = None
    max_overlap: Optional[float] = None

    def sample_box(self, rng: Optional[random.Random] = None) -> np.ndarray:
        return self.sample_boxes(1, rng)[0]

    def sample_boxes(self, n: int,
                     rng: Optional[random.Random] = None) -> np.ndarray:
        """(n, 4) candidate crops drawn at once from a numpy Generator
        seeded by one ``getrandbits(64)`` of ``rng``, as the reference
        seeds it from ``random``."""
        rng = np.random.default_rng((rng or sample_random()).getrandbits(64))
        scale = rng.uniform(self.min_scale, self.max_scale, n)
        min_ar = np.maximum(self.min_aspect_ratio, scale ** 2)
        max_ar = np.minimum(self.max_aspect_ratio, 1.0 / (scale ** 2))
        # a + u·(b-a) rather than rng.uniform(a, b): numpy's Generator
        # raises on inverted bounds, but custom sampler configs can invert
        # (min_aspect_ratio > 1 with large scale) — random.uniform accepted
        # that, and one bad element must not poison the whole draw
        ar = min_ar + rng.uniform(0.0, 1.0, n) * (max_ar - min_ar)
        w = scale * np.sqrt(ar)
        h = scale / np.sqrt(ar)
        x1 = rng.uniform(0.0, 1.0, n) * (1.0 - w)
        y1 = rng.uniform(0.0, 1.0, n) * (1.0 - h)
        return np.stack([x1, y1, x1 + w, y1 + h], axis=1).astype(np.float32)

    def satisfies(self, box: np.ndarray, label: RoiLabel) -> bool:
        if self.min_overlap is None and self.max_overlap is None:
            return True
        if label.size() == 0:
            return False
        ious = jaccard_overlap(box, label.bboxes)
        best = float(ious.max())
        if self.min_overlap is not None and best < self.min_overlap:
            return False
        if self.max_overlap is not None and best > self.max_overlap:
            return False
        return True

    def sample(self, label: RoiLabel,
               rng: Optional[random.Random] = None) -> List[np.ndarray]:
        """Up to ``max_sample`` satisfying boxes in ``max_trials`` tries.
        All trials are drawn and
        checked in one vectorized pass, in trial order."""
        unconstrained = self.min_overlap is None and self.max_overlap is None
        n = (min(self.max_sample, self.max_trials) if unconstrained
             else self.max_trials)
        if n <= 0 or (not unconstrained and label.size() == 0):
            return []
        boxes = self.sample_boxes(n, rng)
        if unconstrained:
            return list(boxes[:self.max_sample])
        # best-gt IoU per trial: (T, G) matrix, one numpy pass
        best = jaccard_overlap_matrix(boxes, label.bboxes).max(axis=1)
        ok = np.ones(n, bool)
        if self.min_overlap is not None:
            ok &= best >= self.min_overlap
        if self.max_overlap is not None:
            ok &= best <= self.max_overlap
        keep = np.flatnonzero(ok)[:self.max_sample]
        return [boxes[i] for i in keep]


def standard_samplers() -> List[BatchSampler]:
    """The 7 SSD-paper samplers."""
    samplers = [BatchSampler()]  # unconstrained whole-ish crop
    for min_iou in (0.1, 0.3, 0.5, 0.7, 0.9):
        samplers.append(BatchSampler(min_overlap=min_iou))
    samplers.append(BatchSampler(max_overlap=1.0))
    return samplers


def generate_batch_samples(label: RoiLabel,
                           samplers: Optional[List[BatchSampler]] = None,
                           rng: Optional[random.Random] = None
                           ) -> List[np.ndarray]:
    """All satisfying boxes from all samplers."""
    samplers = samplers or standard_samplers()
    rng = rng or sample_random()
    boxes: List[np.ndarray] = []
    for s in samplers:
        boxes.extend(s.sample(label, rng))
    return boxes


class RandomSampler(FeatureTransformer):
    """Pick one sampled crop at random and apply it to image + labels.
    No satisfying sample → image passes through unchanged."""

    def __init__(self, samplers: Optional[List[BatchSampler]] = None):
        super().__init__()
        self.samplers = samplers or standard_samplers()
        self.roi_crop = RoiCrop()
        self.rng = sample_random()

    def transform(self, feature: ImageFeature) -> ImageFeature:
        if not feature.is_valid:
            return feature
        label = feature.label
        if not isinstance(label, RoiLabel):
            return feature
        boxes = generate_batch_samples(label, self.samplers, self.rng)
        if not boxes:
            return feature
        box = boxes[self.rng.randrange(len(boxes))]
        feature = Crop(bbox=box.tolist(), normalized=True).transform(feature)
        return self.roi_crop.transform(feature)
