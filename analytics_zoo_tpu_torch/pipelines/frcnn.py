"""Faster-RCNN serving (counterpart of ``pipelines/frcnn.py``): the
preprocess chain, one detector forward (trunk → RPN → proposal → ROI
pool → heads → per-class NMS) and the detections rescaled to the
original image size.

As in the reference, serving keeps py-faster-rcnn's aspect-preserving
geometry inside one fixed square canvas (``AspectScaleCanvas``: the long
side scaled to ``resolution``, the rest padded bottom and right), and
``im_info`` carries the scale factors back to original pixels.
``aspect_preserving=False`` takes the distorting square resize instead.

:func:`frcnn_serving_tiers` gives ``serving.ServingRuntime`` two rungs:
fp and weight-only int8.  :func:`train_frcnn` trains the detector
(approximate joint training, ``ops/frcnn_train.py``) through the
``Optimizer`` with a ``forward_fn``, on one device or data parallel over
a mesh (``mesh=``); ``specs=`` serves over a mesh's data ranks.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.pipelines.ssd import (BGR_MEANS,
                                                   PreProcessParam,
                                                   run_serving_loop,
                                                   serving_chain)
from analytics_zoo_tpu_torch.transform.vision import AspectScaleCanvas
from analytics_zoo_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("analytics_zoo_tpu_torch")

# py-faster-rcnn BGR channel means (its models were trained with these,
# not the SSD-Caffe 104/117/123)
FRCNN_BGR_MEANS = (102.9801, 115.9465, 122.7717)

# Relative service time of the int8 rung against the fp rung: the median
# ms of a batch of 8 through the runtime over the fp rung's, each rung
# forced in interleaved windows (chip_smoke.py's frcnn_serving line,
# rung_speed_vs_fp), on an NVIDIA H100 80GB HBM3 at 700.00 W: 1.16, 0.89
# and 1.03 in three runs, the last the quietest (its windows 197-220 ms);
# this is the median of the three.  The host-bound NMS rounds swing a
# batch by up to ±20% between windows, more than the rungs differ: the
# fp32 convolutions are bound by arithmetic, not by the weights' bytes,
# as on SSD.  ServingRuntime.snapshot() reports it; nothing schedules by
# it yet.
INT8_SPEED = 1.03


class FrcnnPredictor:
    """``SSDPredictor``'s counterpart for the Faster-RCNN family, around
    a :class:`~analytics_zoo_tpu_torch.models.faster_rcnn.
    FasterRcnnDetector` moved to ``device`` (the GPU unless
    ``device="cpu"``).

    ``param`` defaults to ``PreProcessParam(resolution=512,
    pixel_means=FRCNN_BGR_MEANS)``; a param left at the SSD-Caffe means
    gets the Faster-RCNN ones unless ``swap_default_means=False``.
    ``quantize``: ``False``, ``True`` / ``"weight"`` (int8 weights
    dequantized in the forward) or ``"int8"`` (int8 × int8 products), as
    ``SSDPredictor``'s; a quantized predictor serves a quantized copy of
    ``detector``.  ``specs``: as ``SSDPredictor``'s, each rank forwarding
    its rows (proposal and post-processing included), the detections
    gathered back."""

    def __init__(self, detector: nn.Module,
                 param: Optional[PreProcessParam] = None,
                 aspect_preserving: bool = True,
                 swap_default_means: bool = True, quantize=False,
                 specs=None, device=None):
        if quantize not in (False, True, "weight", "int8"):
            raise ValueError(f"quantize must be False, True, 'weight' or "
                             f"'int8', got {quantize!r}")
        if param is not None and param.wire_format != "bgr":
            raise ValueError(
                "FrcnnPredictor serves over the uint8 BGR wire only; "
                f"wire_format={param.wire_format!r} is not supported "
                "(the yuv420 wire is an SSDPredictor feature)")
        if param is None:
            param = PreProcessParam(resolution=512,
                                    pixel_means=FRCNN_BGR_MEANS)
        elif (swap_default_means
              and tuple(param.pixel_means) == tuple(BGR_MEANS)):
            # the SSD-Caffe default means are wrong for py-faster-rcnn
            # weights; a caller who wants them passes
            # swap_default_means=False
            logger.info("FrcnnPredictor: replacing default SSD pixel "
                        "means with FRCNN_BGR_MEANS "
                        "(swap_default_means=False keeps them)")
            param = dataclasses.replace(param, pixel_means=FRCNN_BGR_MEANS)
        self.device = resolve_device(device)
        if specs is not None:
            specs.place_state(detector.to(self.device))
        if quantize:
            from analytics_zoo_tpu_torch.utils.quantize import quantize_model

            detector = quantize_model(
                detector, compute="int8" if quantize == "int8" else "dequant")
        self.detector = detector.to(self.device).eval()
        self.quantize = quantize
        self.param = param
        self.aspect_preserving = aspect_preserving
        self._means = torch.as_tensor(param.pixel_means, dtype=torch.float32,
                                      device=self.device)
        if specs is not None:
            self._forward = specs.row_sharded(self._forward)

    def _forward(self, x, info) -> torch.Tensor:
        """NHWC pixels (uint8, or float32 mean-subtracted) and (B, 3)
        ``im_info`` → (B, max_per_image, 6) detections on the device."""
        x = torch.as_tensor(x).to(self.device, non_blocking=True)
        if x.dtype == torch.uint8:
            # uint8 staging: 4x fewer host→device bytes, normalize here
            x = x.to(torch.float32) - self._means
        with torch.inference_mode():
            return self.detector(x, torch.as_tensor(info).to(self.device))

    def _detect_device(self, batch: Dict):
        """Enqueue one batch; returns (device detections, scale_h,
        scale_w), the boxes still in resized-image pixels.  The
        detector's ``im_info`` rows are (height, width, scale): the
        content's size, so boxes clip to the image and not to the
        canvas' padding, and the mean of the two scale factors, by which
        the proposal layer's ``min_size`` scales."""
        im_info = np.asarray(batch["im_info"], np.float32)
        scale_h = np.maximum(im_info[:, 2], 1e-8)
        scale_w = np.maximum(im_info[:, 3], 1e-8)
        info = np.stack([im_info[:, 0], im_info[:, 1],
                         ((scale_h + scale_w) * 0.5).astype(np.float32)],
                        axis=1)
        return self._forward(batch["input"], info), scale_h, scale_w

    @staticmethod
    def _rescale(dets: torch.Tensor, scale_h, scale_w) -> np.ndarray:
        """Read back and project to original pixels: x / scale_w,
        y / scale_h (numpy on the host: the array is tiny)."""
        out = dets.cpu().numpy().copy()
        out[..., 2] /= scale_w[:, None]
        out[..., 4] /= scale_w[:, None]
        out[..., 3] /= scale_h[:, None]
        out[..., 5] /= scale_h[:, None]
        return out

    def detect_batch(self, batch: Dict) -> np.ndarray:
        """(B, max_per_image, 6) detections in original image pixels."""
        return self._rescale(*self._detect_device(batch))

    def predict(self, records) -> List[np.ndarray]:
        """Records (``SSDByteRecord``s) → per-image (K, 6) detections in
        original pixels, through the uint8 serving chain (decoded and
        resized by the predictor's device's routes) and a window of
        batches in flight."""
        resize = (AspectScaleCanvas(self.param.resolution,
                                    device=self.device)
                  if self.aspect_preserving else None)
        return run_serving_loop(
            serving_chain(self.param, uint8=True, resize=resize,
                          device=self.device)(records),
            self._detect_device, lambda t: self._rescale(*t))


def frcnn_serving_tiers(detector: nn.Module,
                        param: Optional[PreProcessParam] = None,
                        specs=None, aspect_preserving: bool = True,
                        device=None) -> List:
    """Degradation rungs for ``serving.ServingRuntime``: two
    ``ServingTier`` s over the same detector forward, cheapest last —
    tier 0 ``fp``, tier 1 ``int8`` (int8 weights dequantized in the
    forward, ``quantize=True``).

    Requests carry one preprocessed canvas (``{"input": (res, res, 3)
    float32}``, the pixel means already subtracted, the batcher's FIXED
    bucket, as for the SSD tiers); the forward gives the whole canvas a
    unit-scale ``im_info``, so detections come back in canvas pixels,
    read back as numpy.  ``device_program()`` gives the rung's forward
    and example arguments of its shapes.  ``specs``: both rungs are
    ``FrcnnPredictor(specs=)``, each rank detecting its rows; every rank
    builds the tiers and calls a rung with the same batch."""
    from analytics_zoo_tpu_torch.serving.ladder import ServingTier

    full = FrcnnPredictor(detector, param=param,
                          aspect_preserving=aspect_preserving, specs=specs,
                          device=device)
    int8 = FrcnnPredictor(detector, param=full.param,
                          swap_default_means=False, quantize=True,
                          specs=specs, device=device)
    res = full.param.resolution

    def fwd(pred: FrcnnPredictor) -> Callable[[Dict], np.ndarray]:
        def forward(batch: Dict) -> np.ndarray:
            B = batch["input"].shape[0]
            im_info = np.tile(np.asarray([[res, res, 1.0, 1.0]], np.float32),
                              (B, 1))
            return pred.detect_batch({"input": batch["input"],
                                      "im_info": im_info})
        return forward

    def program(pred: FrcnnPredictor) -> Callable[[], tuple]:
        def device_program():
            x = torch.zeros((1, res, res, 3), device=pred.device)
            info = torch.tensor([[res, res, 1.0]], device=pred.device)
            return pred._forward, (x, info)
        return device_program

    return [
        ServingTier("fp", fwd(full), speed=1.0,
                    quality_note="full precision, per-class NMS",
                    device_program=program(full)),
        ServingTier("int8", fwd(int8), speed=INT8_SPEED,
                    quality_note="int8 weights, fp math",
                    device_program=program(int8)),
    ]


def frcnn_train_batches(dataset, resolution: int):
    """SSD-style labeled batches (normalized gt) in the Faster-RCNN train
    step's form: ``input`` becomes the forward's tuple ``(pixels,
    im_info, gt_px, gt_mask)``, the gt boxes doubling as ``extra_rois``
    (py-faster-rcnn's guaranteed foreground), and ``target.bboxes`` is
    scaled to pixels for the target assignment."""

    class _DS:
        def __len__(self):
            return len(dataset)

        def __iter__(self):
            for b in dataset:
                B = b["input"].shape[0]
                gt_px = np.asarray(b["target"]["bboxes"],
                                   np.float32) * resolution
                im_info = np.tile(
                    np.asarray([[resolution, resolution, 1.0]], np.float32),
                    (B, 1))
                mask = np.asarray(b["target"]["mask"], np.float32)
                yield {
                    "input": (np.asarray(b["input"], np.float32), im_info,
                              gt_px, mask),
                    "im_info": im_info,
                    "target": {
                        "bboxes": gt_px,
                        "labels": np.asarray(b["target"]["labels"],
                                             np.int32),
                        "mask": mask,
                    },
                }

    return _DS()


def frcnn_forward_fn(module: nn.Module, inputs, train: bool = False):
    """The train step's forward (``Optimizer(forward_fn=...)``): the
    ``FasterRcnnVgg`` on ``(pixels, im_info, gt_px, gt_mask)`` with the gt
    boxes as extra ROIs, returning its training outputs."""
    x, im_info, gt_px, gt_mask = inputs
    return module(x, im_info, train=train, extra_rois=gt_px,
                  extra_rois_mask=gt_mask, train_outputs=True)


def train_frcnn(model: Optional[nn.Module], dataset, resolution: int,
                epochs: int = 10, lr: float = 1e-3, mesh=None,
                loss_param=None, grad_clip_norm: Optional[float] = 10.0,
                lr_schedule=None, epoch_hook=None,
                device=None) -> nn.Module:
    """End-to-end Faster-RCNN training: the RPN objectness and box losses
    and the head class and box losses (``ops.frcnn_train``), the gt boxes
    injected as extra ROIs, deterministic hard-negative sampling; SGD
    with momentum 0.9 (``lr_schedule`` as its schedule), the gradients
    clipped to a global norm of ``grad_clip_norm``, for ``epochs``
    epochs, ``epoch_hook(loop, state)`` after each.

    ``model`` is a ``FasterRcnnVgg`` (a seeded one on ``device``, the GPU
    unless ``device="cpu"``, when None; a given model trains where it
    lies); ``dataset`` yields SSD-style labeled batches with normalized
    gt (e.g. ``pipelines.ssd.load_train_set``), adapted by
    :func:`frcnn_train_batches`.  ``mesh`` trains data parallel
    (``pipeline_specs("frcnn", mesh)``): every rank runs this call on the
    same global batches and trains on its rows; the loss is a mean over
    images, so the averaged gradients are the one-device step's."""
    from analytics_zoo_tpu_torch.models.faster_rcnn import FasterRcnnVgg
    from analytics_zoo_tpu_torch.ops.frcnn_train import (FrcnnLossParam,
                                                         frcnn_training_loss)
    from analytics_zoo_tpu_torch.parallel import SGD, Optimizer, Trigger

    specs = None
    if mesh is not None:
        from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs
        specs = pipeline_specs("frcnn", mesh=mesh)
    loss_param = loss_param or FrcnnLossParam()
    if model is None:
        model = FasterRcnnVgg(device=device, seed=0)

    def criterion(outputs, batch):
        return frcnn_training_loss(outputs, batch, loss_param)

    opt = (Optimizer(model, frcnn_train_batches(dataset, resolution),
                     criterion, forward_fn=frcnn_forward_fn,
                     grad_clip_norm=grad_clip_norm, specs=specs)
           .set_optim_method(SGD(lr, momentum=0.9, schedule=lr_schedule))
           .set_end_when(Trigger.max_epoch(epochs)))
    if epoch_hook is not None:
        opt.set_epoch_hook(epoch_hook)
    opt.optimize()
    return model
