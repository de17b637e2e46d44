"""ImageFeature + FeatureTransformer (counterpart of
``transform/vision/image.py``), host code: ``ImageFeature`` is a keyed
per-image state map and ``FeatureTransformer`` an image transformer that
isolates failures: a failing image is marked ``is_valid=False``, logged,
and flows on (dropped later), so corrupt data never kills an epoch.

Mats are numpy HWC **BGR** arrays (OpenCV's convention).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.data.transformer import Transformer

logger = logging.getLogger("analytics_zoo_tpu_torch")


class ImageFeature:
    """Keyed state map for one image.  Well-known keys:
    ``bytes``, ``mat``, ``floats``, ``label``, ``path``, ``im_info``,
    ``original_width/height``, ``crop_bbox``, ``expand_bbox``."""

    def __init__(self, bytes_: Optional[bytes] = None, label: Any = None,
                 path: str = ""):
        self.state: Dict[str, Any] = {}
        if bytes_ is not None:
            self.state["bytes"] = bytes_
        if label is not None:
            self.state["label"] = label
        self.state["path"] = path
        self.is_valid = True

    # dict-like access
    def __getitem__(self, key: str) -> Any:
        return self.state[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.state[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.state

    def get(self, key: str, default: Any = None) -> Any:
        return self.state.get(key, default)

    # convenience accessors (reference helpers)
    @property
    def mat(self) -> Optional[np.ndarray]:
        return self.state.get("mat")

    @mat.setter
    def mat(self, m: np.ndarray) -> None:
        self.state["mat"] = m

    @property
    def label(self):
        return self.state.get("label")

    @property
    def path(self) -> str:
        return self.state.get("path", "")

    def width(self) -> int:
        return int(self.mat.shape[1]) if self.mat is not None else 0

    def height(self) -> int:
        return int(self.mat.shape[0]) if self.mat is not None else 0

    def original_width(self) -> int:
        return int(self.state.get("original_width", self.width()))

    def original_height(self) -> int:
        return int(self.state.get("original_height", self.height()))

    def get_im_info(self) -> np.ndarray:
        """(height, width, scale_h, scale_w).  A transform that pads the mat (e.g.
        ``AspectScaleCanvas``) stores an explicit ``im_info`` because the
        mat-dims-ratio default below would misreport its scales."""
        if "im_info" in self.state:
            return np.asarray(self.state["im_info"], np.float32)
        h, w = float(self.height()), float(self.width())
        return np.array([
            h, w,
            h / max(self.original_height(), 1),
            w / max(self.original_width(), 1),
        ], np.float32)

    def to_tensor(self, to_rgb: bool = False, to_chw: bool = True) -> np.ndarray:
        """float HWC/CHW view of the mat."""
        floats = self.state.get("floats")
        if floats is None:
            m = self.mat.astype(np.float32)
            if to_rgb:
                m = m[..., ::-1]
            floats = m
        out = np.ascontiguousarray(floats, np.float32)
        return np.transpose(out, (2, 0, 1)) if to_chw else out



class SealForWire(Transformer):
    """Shrink a transformed ImageFeature for cross-process transport.

    Once the float tensor exists, the decode bytes and the working mat
    are dead weight — but ``get_im_info`` derives its values from the
    mat, so the im_info is materialized FIRST (identical values), then
    the bulky intermediates drop.  Appended to the train chain by the
    multiprocess loader path (``pipelines.ssd``): halves-or-better the
    bytes each sample pays through the shared-memory ring
    (``data.parallel``) without changing anything a batcher reads."""


    def transform(self, feature: "ImageFeature") -> "ImageFeature":
        if (isinstance(feature, ImageFeature)
                and feature.get("floats") is not None):
            if "im_info" not in feature.state:
                feature.state["im_info"] = feature.get_im_info()
            feature.state.pop("bytes", None)
            feature.state.pop("mat", None)
        return feature

class FeatureTransformer(Transformer):
    """Vision transformer over ImageFeatures.  Subclasses implement
    ``transform_mat(feature)``; exceptions mark the feature invalid with a
    warning and do NOT propagate.  A feature already invalid is passed
    through untouched.  ``out_key`` snapshots the mat into
    ``feature[out_key]`` after the op."""

    def __init__(self, out_key: Optional[str] = None):
        self.out_key = out_key

    def set_out_key(self, key: str) -> "FeatureTransformer":
        self.out_key = key
        return self

    def transform_mat(self, feature: ImageFeature) -> None:  # pragma: no cover
        pass

    def transform(self, feature: ImageFeature) -> ImageFeature:
        if not isinstance(feature, ImageFeature):
            raise TypeError(f"expected ImageFeature, got {type(feature)}")
        if not feature.is_valid:
            return feature
        try:
            self.transform_mat(feature)
            if self.out_key is not None:
                feature[self.out_key] = None if feature.mat is None \
                    else feature.mat.copy()
        except Exception as e:
            feature.is_valid = False
            logger.warning("transform %s failed for %s: %s",
                           type(self).__name__, feature.path, e)
        return feature
