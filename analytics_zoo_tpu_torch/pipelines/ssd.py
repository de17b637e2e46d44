"""SSD input, serving, validation and training (counterpart of
``pipelines/ssd.py``).

The input half reads ``.azr`` records of JPEGs: ``load_train_set`` (the
reference's host augmentation chain), ``load_train_set_device`` (host
geometry and labels, then ``make_device_augment`` on the card as the
train step's ``device_transform``), ``load_val_set`` and
``serving_chain``.  JPEGs decode through the codec of the pipeline's
``device`` (``data.native``: nvJPEG on the GPU, libjpeg on the CPU).

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
:func:`ssd_serving_tiers` gives ``serving.ServingRuntime`` its three
rungs (fp, int8 weights, int8 with a smaller ``keep_topk``), over a
mesh's data ranks with ``specs=``.  The yuv420 wire and packed staging
(deferred item e) are not ported yet (ROADMAP.md, Queue 1).
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

from analytics_zoo_tpu_torch.data import (DataSet, ParallelTransformer,
                                          RandomTransformer, SSDByteRecord,
                                          Transformer, overlap_window,
                                          pad_ragged)
from analytics_zoo_tpu_torch.models.ssd import SSDVgg, build_priors, config_for
from analytics_zoo_tpu_torch.ops.detection_output import (
    DetectionOutputParam, detection_output, scale_detections)
from analytics_zoo_tpu_torch.ops.multibox_loss import (MultiBoxLoss,
                                                       MultiBoxLossParam)
from analytics_zoo_tpu_torch.parallel.optim import (SGD, Adam, Plateau,
                                                    Trigger, multistep)
from analytics_zoo_tpu_torch.parallel.summary import (TrainSummary,
                                                      ValidationSummary)
from analytics_zoo_tpu_torch.parallel.train import (Optimizer,
                                                    ValidationMethod,
                                                    make_eval_step)
from analytics_zoo_tpu_torch.pipelines.evaluation import (
    CocoMeanAveragePrecision, DetectionResult, MeanAveragePrecision,
    MultiIoUResult)
from analytics_zoo_tpu_torch.transform.vision import (BytesToMat,
                                                      ColorJitter, Expand,
                                                      HFlip, ImageFeature,
                                                      MatToFloats,
                                                      RandomSampler, Resize,
                                                      RoiExpand, RoiHFlip,
                                                      RoiLabel, RoiNormalize)
from analytics_zoo_tpu_torch.utils.device import host_constant, resolve_device

logger = logging.getLogger("analytics_zoo_tpu_torch")

# Caffe-VGG channel means, BGR (reference PreProcessParam defaults)
BGR_MEANS = (104.0, 117.0, 123.0)


@dataclasses.dataclass
class PreProcessParam:
    """The reference ``PreProcessParam``, all fields; the yuv420 wire and
    packed staging are refused (ROADMAP.md deferred item e)."""

    batch_size: int = 32
    resolution: int = 300
    pixel_means: Sequence[float] = BGR_MEANS
    n_partition: int = 1
    max_gt: int = 100
    # host augmentation worker threads; 1 = serial, >1 = a
    # ParallelTransformer pool (not seeded)
    num_workers: int = 1
    # host augmentation worker PROCESSES (data.parallel.ParallelLoader):
    # 0 = in-process; >0 forks that many workers, order-preserving and
    # seeded from loader_seed (byte-identical stream for any count);
    # replaces the thread pool when set
    worker_processes: int = 0
    loader_seed: int = 0
    # record-level windowed shuffle (data.ShuffleBuffer); 0 disables
    shuffle_buffer: int = 0
    shuffle_seed: int = 0
    # device-augmentation staging canvas (None = DeviceAugParam's 512)
    canvas_size: Optional[int] = None
    wire_format: str = "bgr"
    pack_staging: bool = False
    # length-bucketed batching edges, read by the DS2 loader only
    bucket_edges: Optional[Sequence[int]] = None

    def __post_init__(self):
        from analytics_zoo_tpu_torch.transform.vision.device import (
            _refuse_wire)

        _refuse_wire(self.wire_format, self.pack_staging)


class RecordToFeature(Transformer):
    """SSDByteRecord → ImageFeature with its RoiLabel."""

    def transform(self, record: SSDByteRecord) -> ImageFeature:
        f = ImageFeature(record.data, path=record.path)
        gt = record.gt if record.gt is not None else np.zeros((0, 6),
                                                             np.float32)
        f["label"] = RoiLabel.from_gt_matrix(gt)
        return f


class RoiImageToBatch(Transformer):
    """Batch ImageFeatures into padded dicts: ``"input"`` (B, H, W, 3)
    float32, ``"im_info"`` and, with ``keep_label``, ``"target"`` (the
    ragged labels padded to ``max_gt`` under a mask).  Invalid features
    are skipped unless ``MatToFloats`` zero-filled them."""

    def __init__(self, batch_size: int, max_gt: int = 100,
                 keep_label: bool = True, drop_remainder: bool = True):
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.keep_label = keep_label
        self.drop_remainder = drop_remainder

    def _usable(self, f: ImageFeature) -> bool:
        # invalid features stay in the batch ONLY once MatToFloats has
        # zero-filled them — callers' outputs stay index-aligned
        return f.is_valid or f.get("floats") is not None

    def apply_iter(self, it):
        buf: List[ImageFeature] = []
        for f in it:
            if not self._usable(f):
                continue
            buf.append(f)
            if len(buf) == self.batch_size:
                yield self.collate(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield self.collate(buf)

    def collate(self, feats: Sequence[ImageFeature]) -> Dict:
        imgs = np.stack([f["floats"] for f in feats]).astype(np.float32)
        im_info = np.stack([f.get_im_info() for f in feats])
        batch = {"input": imgs, "im_info": im_info}
        if self.keep_label:
            boxes, labels, difficult = [], [], []
            for f in feats:
                lab = f.label if isinstance(f.label, RoiLabel) else RoiLabel(
                    np.zeros(0), np.zeros((0, 4)))
                boxes.append(lab.bboxes)
                labels.append(lab.labels.reshape(-1, 1))
                difficult.append(lab.difficult.reshape(-1, 1))
            b, mask = pad_ragged(boxes, self.max_gt)
            l, _ = pad_ragged(labels, self.max_gt)
            d, _ = pad_ragged(difficult, self.max_gt)
            batch["target"] = {
                "bboxes": b, "labels": l[..., 0].astype(np.int32),
                "difficult": d[..., 0], "mask": mask,
            }
        return batch


def train_transformer(param: PreProcessParam, device=None) -> Transformer:
    """The canonical SSD host augmentation chain: RecordToFeature ->
    BytesToMat -> RoiNormalize -> ColorJitter -> Random(Expand->RoiExpand)
    -> RandomSampler -> Resize(random interp) -> Random(HFlip->RoiHFlip)
    -> MatToFloats(mean subtract).  Decodes with ``device``'s codec."""
    return (
        RecordToFeature()
        >> BytesToMat(device=device)
        >> RoiNormalize()
        >> ColorJitter()
        >> RandomTransformer(Expand(means=param.pixel_means) >> RoiExpand(),
                             0.5)
        >> RandomSampler()
        >> Resize(param.resolution, param.resolution, interp=-1,
                  device=device)
        >> RandomTransformer(HFlip() >> RoiHFlip(), 0.5)
        >> MatToFloats(mean=param.pixel_means,
                       valid_height=param.resolution,
                       valid_width=param.resolution)
    )


def val_transformer(param: PreProcessParam, flip: bool = False,
                    device=None) -> Transformer:
    """Validation chain without augmentation; ``flip=True`` inserts a
    random horizontal flip before the float extraction (the resize-only
    train chain, ``load_train_set(augment=False)``)."""
    chain = (
        RecordToFeature()
        >> BytesToMat(device=device)
        >> RoiNormalize()
        >> Resize(param.resolution, param.resolution, device=device)
    )
    if flip:
        # before MatToFloats: the float tensor is extracted there
        chain = chain >> RandomTransformer(HFlip() >> RoiHFlip(), 0.5)
    return chain >> MatToFloats(mean=param.pixel_means,
                                valid_height=param.resolution,
                                valid_width=param.resolution)


def _maybe_parallel(t: Transformer, workers: int) -> Transformer:
    return ParallelTransformer(t, workers) if workers > 1 else t


def _maybe_loader(ds: DataSet, param: PreProcessParam):
    """Wrap the dataset in the multiprocess loader when the param asks
    for worker processes; otherwise return it unchanged."""
    if param.worker_processes > 0:
        return ds.parallel(param.worker_processes,
                           base_seed=param.loader_seed)
    return ds


def load_train_set_device(pattern: str, param: PreProcessParam,
                          aug=None, device=None):
    """The device-augmentation train path: the host decodes and makes the
    geometry and label decisions, the card does the pixel work.  Returns
    (the dataset of staged batches, the augment function); pass the
    function as ``device_transform=`` to ``train_ssd`` or the step.
    ``device`` (the GPU unless given) picks the codec and where the
    augment runs."""
    from analytics_zoo_tpu_torch.transform.vision import (DeviceAugBatch,
                                                          DeviceAugParam,
                                                          DeviceAugPrepare,
                                                          make_device_augment)

    dev = resolve_device(device)
    if aug is None:
        extra = ({"canvas_size": param.canvas_size}
                 if param.canvas_size else {})
        aug = DeviceAugParam(resolution=param.resolution,
                             pixel_means=tuple(param.pixel_means),
                             wire_format=param.wire_format,
                             pack=param.pack_staging, **extra)
    chain = (RecordToFeature() >> BytesToMat(to_float=False, device=dev)
             >> RoiNormalize() >> DeviceAugPrepare(aug))
    ds = DataSet.from_record_files(pattern, SSDByteRecord.decode,
                                   shuffle_files=True)
    if param.shuffle_buffer:
        ds = ds.shuffle(param.shuffle_buffer, seed=param.shuffle_seed)
    ds = (ds.transform(_maybe_parallel(chain, param.num_workers))
          .transform(DeviceAugBatch(param.batch_size, param.max_gt,
                                    pack=aug.pack)))
    return _maybe_loader(ds, param), make_device_augment(aug, device=dev)


def load_train_set(pattern: str, param: PreProcessParam,
                   augment: bool = True, device=None) -> DataSet:
    """The host augmentation train path.  ``augment=False`` keeps file
    shuffling, the shuffle buffer, the random flip and drop_remainder
    batching but swaps the geometric chain for a plain resize."""
    ds = DataSet.from_record_files(pattern, SSDByteRecord.decode,
                                   shuffle_files=True)
    if param.shuffle_buffer:
        ds = ds.shuffle(param.shuffle_buffer, seed=param.shuffle_seed)
    chain = (train_transformer(param, device) if augment
             else val_transformer(param, flip=True, device=device))
    if param.worker_processes > 0:
        # strip decode bytes + working mat (im_info materialized first)
        # so the shared-memory ring ships only what the batcher reads
        from analytics_zoo_tpu_torch.transform.vision import SealForWire
        chain = chain >> SealForWire()
    return _maybe_loader(
        ds.transform(_maybe_parallel(chain, param.num_workers))
        .transform(RoiImageToBatch(param.batch_size, param.max_gt)), param)


def load_val_set(pattern: str, param: PreProcessParam, device=None):
    """Validation batches (float, mean-subtracted) in record order, the
    last one partial."""
    chain = val_transformer(param, device=device)
    if param.worker_processes > 0:
        from analytics_zoo_tpu_torch.transform.vision import SealForWire
        chain = chain >> SealForWire()
    return _maybe_loader(
        DataSet.from_record_files(pattern, SSDByteRecord.decode)
        .transform(_maybe_parallel(chain, param.num_workers))
        .transform(RoiImageToBatch(param.batch_size, param.max_gt,
                                   drop_remainder=False)), param)


class Uint8ToBatch(RoiImageToBatch):
    """Serving batcher: stacks RESIZED uint8 mats + im_info (the cast and
    mean subtraction run on the device, 4× fewer upload bytes).  Invalid
    records become zero images so outputs stay index-aligned with the
    records; a final partial batch is padded to ``batch_size`` with zero
    images and carries ``n_valid``."""

    def __init__(self, batch_size: int, resolution: int,
                 drop_remainder: bool = False, wire_format: str = "bgr"):
        from analytics_zoo_tpu_torch.transform.vision.device import (
            _refuse_wire)

        super().__init__(batch_size, keep_label=False,
                         drop_remainder=drop_remainder)
        _refuse_wire(wire_format, False)
        self.resolution = resolution
        self.wire_format = wire_format

    def _usable(self, f: ImageFeature) -> bool:
        return True                     # invalid → zero image in collate

    def apply_iter(self, it):
        for batch in super().apply_iter(it):
            n = batch["input"].shape[0]
            if n < self.batch_size:
                pad = self.batch_size - n
                batch = {
                    "input": np.concatenate(
                        [batch["input"],
                         np.zeros((pad,) + batch["input"].shape[1:],
                                  np.uint8)]),
                    "im_info": np.concatenate(
                        [batch["im_info"],
                         np.tile(np.array([[self.resolution,
                                            self.resolution, 1.0, 1.0]],
                                          np.float32), (pad, 1))]),
                    "n_valid": n}
            yield batch

    def collate(self, feats: Sequence[ImageFeature]) -> Dict:
        res = self.resolution
        default_info = np.array([res, res, 1.0, 1.0], np.float32)
        infos = [f.get_im_info() if (f.is_valid and f.mat is not None)
                 else default_info for f in feats]
        zero = np.zeros((res, res, 3), np.uint8)
        mats = [f.mat if (f.is_valid and f.mat is not None) else zero
                for f in feats]
        return {"input": np.stack(mats), "im_info": np.stack(infos)}


def serving_chain(param: PreProcessParam, uint8: bool = False,
                  resize: Optional[Transformer] = None, device=None):
    """The serving preprocess chain: the val transformer and unlabeled
    batching.  ``uint8=True`` keeps pixels uint8 from decode to the
    device; ``resize`` overrides the square ``Resize`` (it must still
    emit ``param.resolution``² mats)."""
    if uint8:
        chain = (RecordToFeature() >> BytesToMat(to_float=False,
                                                  device=device)
                 >> (resize if resize is not None
                     else Resize(param.resolution, param.resolution,
                                 device=device)))
        return (_maybe_parallel(chain, param.num_workers)
                >> Uint8ToBatch(param.batch_size, param.resolution,
                                wire_format=param.wire_format))
    return (_maybe_parallel(val_transformer(param, device=device),
                            param.num_workers)
            >> RoiImageToBatch(param.batch_size, keep_label=False,
                               drop_remainder=False))


class SSDPredictor:
    """Inference (reference ``SSDPredictor.scala:30``): forward + softmax
    + DetectionOutput, detections rescaled to the original image size via
    ``im_info``.  The model is moved to ``device`` (the GPU unless
    ``device="cpu"``).  The priors are the model's (``model.config``: an
    ``SSDAlexNet``'s or ``SSDMobileNet``'s) where it has a config at
    ``param.resolution``, else SSD-VGG's at that resolution.

    ``quantize``: ``False`` (fp serving), ``True`` / ``"weight"`` (int8
    weights dequantized in the forward: the fp arithmetic on 4x smaller
    weights) or ``"int8"`` (int8 × int8 → int32 convolutions on dynamic
    per-tensor activation scales); see ``utils.quantize``.  A quantized
    predictor serves a quantized copy of ``model`` (``quantize_model``)
    and keeps no reference to ``model``, so the caller can release the
    fp32 weights.

    ``specs`` (a ``parallel.specs.SpecSet``, e.g. ``pipeline_specs("ssd",
    mesh=mesh)``): every rank builds the predictor (``model`` placed by
    ``specs.place_state``: rank 0's weights on every rank) and calls it
    with the same batch; each rank runs its rows through the forward and
    the DetectionOutput (K2 on the card), and the detections are
    all-gathered back (``SpecSet.row_sharded``; a batch that does not
    divide the data width runs whole on every rank)."""

    def __init__(self, model: nn.Module, param: PreProcessParam,
                 post: Optional[DetectionOutputParam] = None,
                 n_classes: int = 21, compute_dtype=None, quantize=False,
                 specs=None, device=None):
        if quantize not in (False, True, "weight", "int8"):
            raise ValueError(f"quantize must be False, True, 'weight' or "
                             f"'int8', got {quantize!r}")
        self.device = resolve_device(device)
        self.specs = specs
        if specs is not None:
            specs.place_state(model.to(self.device))
        # the model's own priors (an SSD variant's), else SSD-VGG's at
        # the param's resolution
        config = getattr(model, "config", None)
        if config is None or config.resolution != param.resolution:
            config = config_for(param.resolution)
        if quantize:
            from analytics_zoo_tpu_torch.utils.quantize import quantize_model

            model = quantize_model(
                model, compute="int8" if quantize == "int8" else "dequant")
        self.model = model.to(self.device).eval()
        self.quantize = quantize
        self.param = param
        self.post = post or DetectionOutputParam(n_classes=n_classes)
        priors, variances = build_priors(config)
        self._priors = torch.as_tensor(priors, device=self.device)
        self._variances = torch.as_tensor(variances, device=self.device)
        self._means = torch.as_tensor(param.pixel_means, dtype=torch.float32,
                                      device=self.device)
        self._eval_step = make_eval_step(self.model,
                                         compute_dtype=compute_dtype)
        if specs is not None:
            self._detect = specs.row_sharded(self._detect)

    def set_top_k(self, k: int) -> "SSDPredictor":
        """A predictor serving ``keep_topk=k``; the receiver is unchanged
        (copy-on-write: the copy shares the model and the priors)."""
        new = copy.copy(self)
        new.post = dataclasses.replace(self.post, keep_topk=k)
        return new

    def _detect(self, inputs, h, w, post: DetectionOutputParam
                ) -> torch.Tensor:
        x = torch.as_tensor(inputs).to(self.device, non_blocking=True)
        if x.dtype == torch.uint8:
            # uint8 staging: 4x fewer host→device bytes, normalize here
            x = x.to(torch.float32) - self._means
        loc, conf = self._eval_step(x)
        probs = torch.softmax(conf, dim=-1)
        dets = detection_output(loc, probs, self._priors, self._variances,
                                post)
        return scale_detections(dets, h, w)

    def detect_normalized(self, inputs) -> torch.Tensor:
        """Forward + softmax + DetectionOutput → (B, K, 6) detections with
        normalized boxes, on the device."""
        ones = torch.ones(inputs.shape[0], device=self.device)
        return self._detect(inputs, ones, ones, self.post)

    def _detect_device(self, batch: Dict) -> torch.Tensor:
        """Enqueue one batch; returns the (B, K, 6) device tensor without
        waiting for it."""
        info = np.asarray(batch["im_info"], np.float32)
        # original size = current / scale
        h = info[:, 0] / np.maximum(info[:, 2], 1e-8)
        w = info[:, 1] / np.maximum(info[:, 3], 1e-8)
        return self._detect(batch["input"], h, w, self.post)

    def detect_batch(self, batch: Dict) -> np.ndarray:
        return self._detect_device(batch).cpu().numpy()

    def predict(self, records) -> List[np.ndarray]:
        """Records (``SSDByteRecord``s) → per-image (K, 6) detections in
        original pixels, through the uint8 serving chain (decoded with
        the predictor's device's codec) and a window of batches in
        flight."""
        return run_serving_loop(
            serving_chain(self.param, uint8=True, device=self.device)(
                records),
            self._detect_device, lambda t: t.cpu().numpy())


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
    the results merged.  ``quantize`` goes to the :class:`SSDPredictor`,
    so the int8 serving modes are evaluated as the fp path is."""

    def __init__(self, model: nn.Module, param: PreProcessParam,
                 evaluator: Optional[MeanAveragePrecision] = None,
                 post: Optional[DetectionOutputParam] = None,
                 quantize=False, device=None):
        self.predictor = SSDPredictor(model, param, post=post,
                                      quantize=quantize, device=device)
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
    the host.  The priors go to a device once, the first time a batch's
    logits arrive there, without a host sync (``host_constant``)."""

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
        self._on: Dict[torch.device, tuple] = {}
        self.name = self.inner.name

    def detect(self, output) -> torch.Tensor:
        """``(loc, conf)`` logits → (B, keep_topk, 6) normalized
        detections, on the logits' device."""
        loc, conf = output
        dev = loc.device
        if dev not in self._on:
            self._on[dev] = (host_constant(self._priors, dev),
                             host_constant(self._variances, dev))
        probs = torch.softmax(conf, dim=-1)
        return detection_output(loc, probs, *self._on[dev], self.post)

    def __call__(self, output, batch) -> "DetectionResult | MultiIoUResult":
        return self.inner(self.detect(output).cpu().numpy(), batch)


@dataclasses.dataclass
class TrainParams:
    """Reference ``TrainParams`` (its ``Train.scala`` defaults), less the
    fields nothing in the port reads: ``batch_size`` and ``max_gt`` (the
    input path takes them from ``PreProcessParam``, and ``train_ssd``
    trains at the batch ``train_set`` was built at).  ``job_name`` names
    the summaries' directory under ``log_dir``."""

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
    overwrite_checkpoint: bool = True
    log_dir: Optional[str] = None
    job_name: str = "ssd300"
    # fp32 master weights, the forward and backward under bf16 autocast;
    # None = fp32
    compute_dtype: Optional[str] = "bf16"
    # background pinned upload depth (Optimizer prefetch); 0 = in the step
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
    out, or staged (``load_train_set_device``) with its augment function
    as ``device_transform``; ``params.prefetch`` batches are pinned and
    uploaded ahead of the step on a CUDA device (the ``Optimizer``'s
    ``prefetch``).  With ``params.checkpoint_path`` a snapshot is taken
    every epoch (one ``latest``, or ``step_N`` ones when
    ``params.overwrite_checkpoint`` is false).

    ``mesh`` trains over ``parallel.mesh.create_mesh``'s ranks through
    ``pipeline_specs("ssd", mesh, tp)``: every rank runs this call on the
    same global batches and keeps its rows; ``tp=None`` is data parallel
    (MultiBoxLoss normalised by the whole batch's positives, validation
    through K2 on every rank's rows, merged), ``tp="megatron"`` shards
    the weights by ``tensor.ssd_tp_rules`` over a ("data", "model") mesh,
    and ``tp="spatial"`` cuts the image height over ``model`` with the
    weights replicated (``models.ssd.spatial_forward`` fetches each
    layer's halo rows; the gradients are summed over ``model``; the
    validation runs the same way, through K2 on every rank, each data
    coordinate's rows counted once).  ``params.log_dir`` writes the
    TensorBoard summaries of the run (``Loss`` and ``LearningRate`` a
    step, the validation score) under
    ``<log_dir>/<job_name>/{train,validation}``."""
    specs = None
    if mesh is not None or tp is not None:
        from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs
        specs = pipeline_specs("ssd", mesh=mesh, tp=tp,
                               resolution=params.resolution)
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
                         specs=specs, compute_dtype=params.compute_dtype,
                         prefetch=params.prefetch,
                         device_transform=device_transform)
               .set_optim_method(optim_method)
               .set_end_when(end_when))
        if val_set is not None:
            opt.set_validation(Trigger.every_epoch(), val_set, [evaluator])
        if params.checkpoint_path:
            opt.set_checkpoint(params.checkpoint_path, Trigger.every_epoch(),
                               overwrite=params.overwrite_checkpoint)
        if params.log_dir:
            opt.set_train_summary(TrainSummary(params.log_dir,
                                               params.job_name))
            opt.set_validation_summary(
                ValidationSummary(params.log_dir, params.job_name))
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


# Relative service time of both int8 rungs against the fp rung, the
# median ms of a batch of 8 through the runtime over the fp rung's: int8
# 1.009 and int8_topk50 1.008 in one run, 1.003 and 1.005 in another, on
# an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py's ssd_serving
# line, rung_speed_vs_fp; PERF.md §6).  The two rungs differ by noise,
# so they share one value.  Above 1.0 a rung is not cheaper: the fp32
# convolutions are bound by arithmetic, not by the weights' bytes.
# ServingRuntime.snapshot() reports it; nothing schedules by it yet.
INT8_SPEED = 1.01


def ssd_serving_tiers(model: nn.Module, param: PreProcessParam,
                      post: Optional[DetectionOutputParam] = None,
                      n_classes: int = 21, compute_dtype=None,
                      degraded_topk: int = 50, specs=None,
                      device=None) -> List:
    """Degradation rungs for ``serving.ServingRuntime``: three
    ``ServingTier`` s over ``SSDPredictor``, cheapest last.

    - tier 0 ``fp``: full-precision weights, the full ``keep_topk``;
    - tier 1 ``int8``: int8 weights dequantized in the forward
      (``quantize=True``);
    - tier 2 ``int8_topk<k>``: tier 1's predictor and quantized model
      with ``keep_topk=degraded_topk``, a bounded cut of the kept rows.

    Every rung runs the DetectionOutput backend ``post`` selects (K2 on
    the card with the default ``"auto"``).  Requests carry preprocessed
    images (``{"input": (H, W, 3) float32}``, the batcher's FIXED
    bucket), and a rung's forward returns the batch's (B, K, 6) rows as
    numpy, read back.  ``device_program()`` gives the rung's detect
    callable and example arguments of its shapes, its
    ``DetectionOutputParam`` last.  ``specs`` (e.g.
    ``pipeline_specs("ssd", mesh=mesh)``): every rung is an
    ``SSDPredictor(specs=)``, each rank detecting its rows of the batch,
    the rows gathered back; every rank builds the tiers and calls a rung
    with the same batch (``ServingRuntime(specs=)`` on rank 0 and
    ``serve_follower`` on the others arrange that)."""
    from analytics_zoo_tpu_torch.serving.ladder import ServingTier

    full = SSDPredictor(model, param, post=post, n_classes=n_classes,
                        compute_dtype=compute_dtype, specs=specs,
                        device=device)
    int8 = SSDPredictor(model, param, post=post, n_classes=n_classes,
                        compute_dtype=compute_dtype, quantize=True,
                        specs=specs, device=device)
    low = int8.set_top_k(degraded_topk)

    def fwd(pred: SSDPredictor) -> Callable[[Dict], np.ndarray]:
        def forward(batch: Dict) -> np.ndarray:
            return pred.detect_normalized(batch["input"]).cpu().numpy()
        return forward

    def program(pred: SSDPredictor) -> Callable[[], tuple]:
        def device_program():
            res = pred.param.resolution
            x = torch.zeros((1, res, res, 3), device=pred.device)
            ones = torch.ones(1, device=pred.device)
            return pred._detect, (x, ones, ones, pred.post)
        return device_program

    return [
        ServingTier("fp", fwd(full), speed=1.0,
                    quality_note="full precision, full NMS top-K",
                    device_program=program(full)),
        ServingTier("int8", fwd(int8), speed=INT8_SPEED,
                    quality_note="int8 weights, fp math",
                    device_program=program(int8)),
        ServingTier(f"int8_topk{degraded_topk}", fwd(low),
                    speed=INT8_SPEED,
                    quality_note=f"int8 + keep_topk={degraded_topk} "
                                 "(fewer kept detections per image)",
                    device_program=program(low)),
    ]
