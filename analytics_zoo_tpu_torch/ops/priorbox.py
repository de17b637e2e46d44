"""PriorBox: Caffe-SSD anchor generation, precomputed on host.

The port's own copy of ``analytics_zoo_tpu/ops/priorbox.py`` (numpy only,
kept line for line so the priors are bit-equal).  Reference
``common/nn/PriorBox.scala:48`` computes the prior grid once per feature
map and caches it.  Priors depend only on static shapes, so they are a
numpy-computed constant, copied to the device once per model.

Per-cell box order matches Caffe: for each ``min_size``: the ar=1 min box,
then (if given) the ``sqrt(min·max)`` box, then one box per extra aspect
ratio (each followed by its flip 1/ar when ``flip=True``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PriorBoxParam:
    min_sizes: Sequence[float]
    max_sizes: Sequence[float] = ()
    aspect_ratios: Sequence[float] = ()
    flip: bool = True
    clip: bool = False
    variances: Sequence[float] = (0.1, 0.1, 0.2, 0.2)
    step: Optional[float] = None
    offset: float = 0.5

    @property
    def num_priors(self) -> int:
        ars = _expand_ars(self.aspect_ratios, self.flip)
        return len(self.min_sizes) * len(ars) + len(self.max_sizes)


def _expand_ars(aspect_ratios: Sequence[float], flip: bool):
    """[1] + given ars (deduped), each followed by its reciprocal if flip."""
    ars = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - a) < 1e-6 for a in ars):
            continue
        ars.append(ar)
        if flip:
            ars.append(1.0 / ar)
    return ars


def prior_box(feature_shape: Tuple[int, int], image_size: Tuple[int, int],
              param: PriorBoxParam) -> Tuple[np.ndarray, np.ndarray]:
    """Generate priors for one feature map.

    Returns ``(priors, variances)``, each ``(H·W·num_priors, 4)`` float32,
    priors normalized corner-form (reference output layout
    ``1×2×(H·W·priors·4)`` carries the same two channels).
    """
    fh, fw = feature_shape
    img_h, img_w = image_size
    step_h = param.step if param.step else img_h / fh
    step_w = param.step if param.step else img_w / fw
    ars = _expand_ars(param.aspect_ratios, param.flip)

    boxes = []
    for i in range(fh):
        for j in range(fw):
            cx = (j + param.offset) * step_w
            cy = (i + param.offset) * step_h
            for k, ms in enumerate(param.min_sizes):
                # ar = 1, size = min
                boxes.append(_corner(cx, cy, ms, ms))
                if param.max_sizes:
                    bs = math.sqrt(ms * param.max_sizes[k])
                    boxes.append(_corner(cx, cy, bs, bs))
                for ar in ars:
                    if abs(ar - 1.0) < 1e-6:
                        continue
                    w = ms * math.sqrt(ar)
                    h = ms / math.sqrt(ar)
                    boxes.append(_corner(cx, cy, w, h))
    priors = np.asarray(boxes, np.float32)
    priors[:, 0::2] /= img_w
    priors[:, 1::2] /= img_h
    if param.clip:
        priors = np.clip(priors, 0.0, 1.0)
    variances = np.tile(np.asarray(param.variances, np.float32), (priors.shape[0], 1))
    return priors, variances


def _corner(cx, cy, w, h):
    return (cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0)


def concat_priors(per_map: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """Stack per-feature-map priors into the model-level (P,4) tables."""
    priors = np.concatenate([p for p, _ in per_map], axis=0)
    variances = np.concatenate([v for _, v in per_map], axis=0)
    return priors, variances
