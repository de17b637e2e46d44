"""SSD serving, validation and training (counterpart of
``pipelines/ssd.py``).

A staged batch is a dict ``{"input": (B,H,W,3) uint8 BGR or float32
mean-subtracted, "im_info": (B,4) rows (h, w, scale_h, scale_w)}``; a
training or validation batch also carries ``"target"``: ``{"bboxes":
(B,G,4) normalized corner boxes, "labels": (B,G) int32, "difficult":
(B,G), "mask": (B,G) 1.0 = a real gt}``, the reference's ragged gt rows
padded to ``max_gt`` (``RoiImageToBatch``).

:class:`SSDPredictor` runs forward → softmax → DetectionOutput → rescale
on the device for one batch; :func:`run_serving_loop` keeps a window of
batches in flight; :class:`Validator` and :class:`SSDMeanAveragePrecision`
measure mAP; :func:`train_ssd` is the reference's training entry point.
JPEG decode (``predict(records)``), the input pipeline and augmentation,
the yuv420 wire, int8 tiers and sharded serving or training are not
ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.data.prefetch import overlap_window
from analytics_zoo_tpu_torch.models.ssd import SSDVgg, build_priors, config_for
from analytics_zoo_tpu_torch.ops.detection_output import (
    DetectionOutputParam, detection_output, scale_detections)
from analytics_zoo_tpu_torch.ops.multibox_loss import (MultiBoxLoss,
                                                       MultiBoxLossParam)
from analytics_zoo_tpu_torch.parallel.optim import (SGD, Adam, Plateau,
                                                    Trigger, multistep)
from analytics_zoo_tpu_torch.parallel.train import (Optimizer,
                                                    ValidationMethod,
                                                    make_eval_step)
from analytics_zoo_tpu_torch.pipelines.evaluation import (
    CocoMeanAveragePrecision, DetectionResult, MeanAveragePrecision,
    MultiIoUResult)
from analytics_zoo_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("analytics_zoo_tpu_torch")

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


class Validator:
    """Evaluation with a throughput log (reference ``Validator``): each
    batch's detections from :meth:`SSDPredictor.detect_normalized`, a
    window of batches in flight (``overlap_window``, as
    :func:`run_serving_loop`), each read back and scored by ``evaluator``,
    the results merged.  The int8 modes are not ported yet (ROADMAP.md
    Queue 1 item 7)."""

    def __init__(self, model: nn.Module, param: PreProcessParam,
                 evaluator: Optional[MeanAveragePrecision] = None,
                 post: Optional[DetectionOutputParam] = None, device=None):
        self.predictor = SSDPredictor(model, param, post=post, device=device)
        self.evaluator = evaluator or MeanAveragePrecision()

    def test(self, dataset) -> DetectionResult:
        total: Optional[DetectionResult] = None
        n_records = 0
        t0 = time.perf_counter()

        def dispatch(batch):
            nonlocal n_records
            n_records += batch["input"].shape[0]
            return self.predictor.detect_normalized(batch["input"]), batch

        def consume(token):
            nonlocal total
            dets, batch = token
            r = self.evaluator(dets.cpu().numpy(), batch)
            total = r if total is None else total + r

        overlap_window(dataset, dispatch, consume)
        dt = time.perf_counter() - t0
        logger.info("[Prediction] %d in %.2f seconds. Throughput is %.2f "
                    "records/sec", n_records, dt, n_records / max(dt, 1e-9))
        return total


class SSDMeanAveragePrecision(ValidationMethod):
    """Validation method for the ``Optimizer``'s loop over the raw
    ``(loc, conf)`` logits of ``SSDVgg``: :meth:`detect` (softmax, then
    ``detection_output`` on the logits' device: with the default
    ``backend="auto"`` kernel K2 on the card), then VOC (or COCO) mAP on
    the host."""

    def __init__(self, n_classes: int = 21, resolution: int = 300,
                 post: Optional[DetectionOutputParam] = None,
                 use_07_metric: bool = True, metric: str = "voc"):
        if metric == "coco":
            self.inner = CocoMeanAveragePrecision(n_classes=n_classes)
        elif metric == "voc":
            self.inner = MeanAveragePrecision(n_classes=n_classes,
                                              use_07_metric=use_07_metric)
        else:
            raise ValueError(f"metric must be 'voc' or 'coco', got {metric!r}")
        self.post = post or DetectionOutputParam(n_classes=n_classes)
        priors, variances = build_priors(config_for(resolution))
        self._priors = torch.as_tensor(priors)
        self._variances = torch.as_tensor(variances)
        self.name = self.inner.name

    def detect(self, output) -> torch.Tensor:
        """``(loc, conf)`` logits → (B, keep_topk, 6) normalized
        detections, on the logits' device."""
        loc, conf = output
        dev = loc.device
        probs = torch.softmax(conf, dim=-1)
        return detection_output(loc, probs, self._priors.to(dev),
                                self._variances.to(dev), self.post)

    def __call__(self, output, batch) -> "DetectionResult | MultiIoUResult":
        return self.inner(self.detect(output).cpu().numpy(), batch)


@dataclasses.dataclass
class TrainParams:
    """Reference ``TrainParams`` (its ``Train.scala`` defaults), less the
    fields that only the parts not ported yet read: ``batch_size`` and
    ``max_gt`` (the input path, ROADMAP.md Queue 1 item 8; the batch
    size is the one ``train_set`` was built at), ``overwrite_checkpoint``
    (item 12) and ``job_name`` (item 13)."""

    resolution: int = 300
    n_classes: int = 21
    learning_rate: float = 0.0035
    momentum: float = 0.9
    weight_decay: float = 0.0005
    max_epoch: int = 250
    schedule: str = "plateau"           # 'plateau' | 'multistep'
    lr_steps: Sequence[int] = ()
    warm_up_map: Optional[float] = None  # Adam warm-up target mAP
    warm_up_lr: float = 1e-4
    checkpoint_path: Optional[str] = None
    log_dir: Optional[str] = None
    # fp32 master weights, the forward and backward under bf16 autocast;
    # None = fp32
    compute_dtype: Optional[str] = "bf16"
    # background batch transfer depth; not ported yet (item 8), see
    # train_ssd
    prefetch: int = 2


def train_ssd(train_set, val_set, params: TrainParams,
              model: Optional[nn.Module] = None, mesh=None,
              device_transform: Optional[Callable] = None,
              tp: Optional[str] = None, device=None) -> nn.Module:
    """The reference's training entry point (``Train.scala``) on one
    device: MultiBoxLoss, the update skipped where the loss exceeds 50,
    ``params.compute_dtype``, mAP validation every epoch when ``val_set``
    is given; an optional Adam warm-up at ``warm_up_lr`` until the mAP
    reaches ``warm_up_map``, then SGD with momentum and weight decay under
    Plateau on the mAP (factor 0.5, patience 10) or ``multistep`` at
    ``lr_steps``.

    ``model`` defaults to a seeded ``SSDVgg`` (seed 0) on ``device`` (the
    GPU unless ``device="cpu"``); a given model trains where it lies.
    Batches come from ``train_set`` as the module docstring lays them
    out.  Transfers run in the step (``prefetch=0``) whatever
    ``params.prefetch`` says, until the input path is ported (ROADMAP.md
    Queue 1 item 8).  Refused by name: ``mesh`` and ``tp`` (item 12),
    ``device_transform`` (item 8), ``params.checkpoint_path`` (item 12)
    and ``params.log_dir`` (item 13)."""
    if mesh is not None or tp is not None:
        raise NotImplementedError(
            "train_ssd: sharded training (mesh, tp) is not ported yet "
            "(ROADMAP.md Queue 1 item 12)")
    if device_transform is not None:
        raise NotImplementedError(
            "train_ssd(device_transform=...): the device augmentation is "
            "not ported yet (ROADMAP.md Queue 1 item 8)")
    if params.checkpoint_path:
        raise NotImplementedError(
            "train_ssd: checkpoints (TrainParams.checkpoint_path) are not "
            "ported yet (ROADMAP.md Queue 1 item 12)")
    if params.log_dir:
        raise NotImplementedError(
            "train_ssd: summaries (TrainParams.log_dir) are not ported yet "
            "(ROADMAP.md Queue 1 item 13)")
    priors, variances = build_priors(config_for(params.resolution))
    criterion = MultiBoxLoss(priors, variances,
                             MultiBoxLossParam(n_classes=params.n_classes))
    if model is None:
        model = SSDVgg(params.n_classes, params.resolution, device=device,
                       seed=0)
    evaluator = SSDMeanAveragePrecision(n_classes=params.n_classes,
                                        resolution=params.resolution)

    def make_optimizer(optim_method, end_when):
        opt = (Optimizer(model, train_set, criterion, skip_loss_above=50.0,
                         compute_dtype=params.compute_dtype, prefetch=0)
               .set_optim_method(optim_method)
               .set_end_when(end_when))
        if val_set is not None:
            opt.set_validation(Trigger.every_epoch(), val_set, [evaluator])
        return opt

    if params.warm_up_map is not None and val_set is not None:
        logger.info("warm-up with Adam until mAP >= %.3f", params.warm_up_map)
        make_optimizer(
            Adam(params.warm_up_lr),
            Trigger.or_(Trigger.max_score(params.warm_up_map),
                        Trigger.max_epoch(params.max_epoch)),
        ).optimize()

    if params.schedule == "multistep" and params.lr_steps:
        optim = SGD(params.learning_rate, momentum=params.momentum,
                    weight_decay=params.weight_decay,
                    schedule=multistep(params.learning_rate, params.lr_steps,
                                       0.1))
    else:
        optim = SGD(params.learning_rate, momentum=params.momentum,
                    weight_decay=params.weight_decay,
                    plateau=Plateau(monitor="score", factor=0.5, patience=10,
                                    mode="max", min_lr=1e-5))
    make_optimizer(optim, Trigger.max_epoch(params.max_epoch)).optimize()
    return model
