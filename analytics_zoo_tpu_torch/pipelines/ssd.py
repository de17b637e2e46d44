"""SSD serving over staged batches (counterpart of the serving half of
``pipelines/ssd.py``).

A staged batch is a dict ``{"input": (B,H,W,3) uint8 BGR or float32
mean-subtracted, "im_info": (B,4) rows (h, w, scale_h, scale_w)}``.
:class:`SSDPredictor` runs forward → softmax → DetectionOutput → rescale
on the device for one batch; :func:`run_serving_loop` keeps a window of
batches in flight.  JPEG decode (``predict(records)``), the yuv420 wire,
int8 tiers and sharded serving are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.data.prefetch import overlap_window
from analytics_zoo_tpu_torch.models.ssd import build_priors, config_for
from analytics_zoo_tpu_torch.ops.detection_output import (
    DetectionOutputParam, detection_output, scale_detections)
from analytics_zoo_tpu_torch.parallel.train import make_eval_step
from analytics_zoo_tpu_torch.utils.device import resolve_device

# Caffe-VGG channel means, BGR (reference PreProcessParam defaults)
BGR_MEANS = (104.0, 117.0, 123.0)


@dataclasses.dataclass
class PreProcessParam:
    """The serving fields of the reference ``PreProcessParam``."""

    batch_size: int = 32
    resolution: int = 300
    pixel_means: Sequence[float] = BGR_MEANS


class SSDPredictor:
    """Inference (reference ``SSDPredictor.scala:30``): forward + softmax
    + DetectionOutput, detections rescaled to the original image size via
    ``im_info``.  The model is moved to ``device`` (the GPU unless
    ``device="cpu"``)."""

    def __init__(self, model: nn.Module, param: PreProcessParam,
                 post: Optional[DetectionOutputParam] = None,
                 n_classes: int = 21, compute_dtype=None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.param = param
        self.post = post or DetectionOutputParam(n_classes=n_classes)
        priors, variances = build_priors(config_for(param.resolution))
        self._priors = torch.as_tensor(priors, device=self.device)
        self._variances = torch.as_tensor(variances, device=self.device)
        self._means = torch.as_tensor(param.pixel_means, dtype=torch.float32,
                                      device=self.device)
        self._eval_step = make_eval_step(self.model,
                                         compute_dtype=compute_dtype)

    def set_top_k(self, k: int) -> "SSDPredictor":
        """A predictor serving ``keep_topk=k``; the receiver is unchanged
        (copy-on-write: the copy shares the model and the priors)."""
        new = copy.copy(self)
        new.post = dataclasses.replace(self.post, keep_topk=k)
        return new

    def _detect(self, inputs, h, w) -> torch.Tensor:
        x = torch.as_tensor(inputs).to(self.device, non_blocking=True)
        if x.dtype == torch.uint8:
            # uint8 staging: 4x fewer host→device bytes, normalize here
            x = x.to(torch.float32) - self._means
        loc, conf = self._eval_step(x)
        probs = torch.softmax(conf, dim=-1)
        dets = detection_output(loc, probs, self._priors, self._variances,
                                self.post)
        return scale_detections(dets, h, w)

    def detect_normalized(self, inputs) -> torch.Tensor:
        """Forward + softmax + DetectionOutput → (B, K, 6) detections with
        normalized boxes, on the device."""
        ones = torch.ones(inputs.shape[0], device=self.device)
        return self._detect(inputs, ones, ones)

    def _detect_device(self, batch: Dict) -> torch.Tensor:
        """Enqueue one batch; returns the (B, K, 6) device tensor without
        waiting for it."""
        info = np.asarray(batch["im_info"], np.float32)
        # original size = current / scale
        h = info[:, 0] / np.maximum(info[:, 2], 1e-8)
        w = info[:, 1] / np.maximum(info[:, 3], 1e-8)
        return self._detect(batch["input"], h, w)

    def detect_batch(self, batch: Dict) -> np.ndarray:
        return self._detect_device(batch).cpu().numpy()


def run_serving_loop(batches, dispatch, readback,
                     max_inflight: int = 4) -> List[np.ndarray]:
    """Dispatch staged batches with up to ``max_inflight`` in flight and
    collect per-image arrays.  A batch carrying ``n_valid`` (a padded
    final batch) yields only its first ``n_valid`` rows."""
    out: List[np.ndarray] = []

    def dispatch_sliced(batch):
        n = batch.pop("n_valid", None) if isinstance(batch, dict) else None
        return dispatch(batch), n

    def consume(token):
        tok, n = token
        arr = readback(tok)
        out.extend(arr[i] for i in range(arr.shape[0] if n is None else n))

    overlap_window(batches, dispatch_sliced, consume, max_inflight)
    return out
