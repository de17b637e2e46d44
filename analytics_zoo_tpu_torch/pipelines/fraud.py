"""Fraud detection (counterpart of ``pipelines/fraud.py``).

The reference's ``BigDLKaggleFraud.scala:13-78``: a frame → VectorAssembler
+ StandardScaler → time-quantile 70/30 split → ``Bagging`` of
:class:`MLPClassifier` s (``Linear(29,10)→Linear(10,2)→LogSoftMax``,
trained by the one-device ``Optimizer`` with ``Adam`` and
``ClassNLLCriterion``) over stratified samples → a vote-threshold sweep
with AUPRC, precision and recall.  :func:`fraud_serving_tiers` gives
``serving.ServingRuntime`` the fp and int8 rungs over a trained model.

Training and serving run on the model's device (the GPU unless the
caller passes ``device="cpu"``); ``specs=`` serves the ``fp`` rung over a
mesh's data ranks.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
from analytics_zoo_tpu_torch.core.module import Model
from analytics_zoo_tpu_torch.models.simple import FraudMLP
from analytics_zoo_tpu_torch.parallel import Adam, Optimizer, Trigger
from analytics_zoo_tpu_torch.pipelines.frame import (
    Bagging,
    Frame,
    FramePipeline,
    Stage,
    StandardScaler,
    StratifiedSampler,
    VectorAssembler,
    time_ordered_split,
)
from analytics_zoo_tpu_torch.utils.device import resolve_device

# Relative service time of the int8 rung against the fp rung, a family
# each: the median ms of a batch of 8 through the runtime over the fp
# rung's, each rung forced in 5 interleaved windows (chip_smoke.py's
# fraud, rec and sentiment lines, rung_speed_vs_fp), on an NVIDIA H100
# 80GB HBM3 at 700.00 W; the mean of two runs: fraud 1.207 and 1.215,
# rec 1.334 and 1.215, sentiment 1.581 and 1.615.  Above 1.0 the rung is
# not cheaper: the fraud rung quantizes nothing and pays the quantized
# forward's dispatch, the rec and sentiment rungs dequantize their
# tables (20,000 x 100 for sentiment) in every forward.
# ServingRuntime.snapshot() reports them; nothing schedules by them yet.
FRAUD_INT8_SPEED = 1.21
REC_INT8_SPEED = 1.27
SENTIMENT_INT8_SPEED = 1.60


def train_specs(name: str, mesh, **opts):
    """The pipeline's declared ``SpecSet`` on ``mesh`` (``None`` without
    one: a one-device ``Optimizer``)."""
    if mesh is None:
        return None
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs
    return pipeline_specs(name, mesh=mesh, **opts)


def fp_int8_tiers(model, to_inputs: Callable[[Dict, torch.device], tuple],
                  example: Dict, notes: Sequence[str], int8_speed: float,
                  device=None, specs=None) -> List:
    """Two ``ServingTier`` s over one model, cheapest last: ``fp`` (the
    eval step) and ``int8`` (``quantize_params`` weights through the
    weight-only ``make_quantized_forward``).  ``to_inputs(batch, device)``
    makes the forward's arguments from a batch; rows come back as numpy;
    ``example`` is a batch of the served shapes for ``device_program``.
    The model (a ``core.module.Model`` or a module) serves where it is,
    or on ``device`` when given (it is moved there).

    ``specs`` (the pipeline's ``SpecSet``): rank 0's weights go to every
    rank, and the ``fp`` rung is ``make_eval_step(specs=)`` over a copy
    placed by ``specs.place_state`` (its tables row-sharded where the
    rules say so), each rank running its rows and the outputs gathered
    back; the ``int8`` rung runs whole on every rank, as the reference's
    un-annotated quantized forward does.  Every rank builds the tiers and
    calls a rung with the same batch."""
    from analytics_zoo_tpu_torch.parallel import make_eval_step
    from analytics_zoo_tpu_torch.parallel.mesh import replicate
    from analytics_zoo_tpu_torch.serving.ladder import ServingTier
    from analytics_zoo_tpu_torch.utils.quantize import (
        make_quantized_forward, quantize_params)

    module: nn.Module = model.module if isinstance(model, Model) else model
    dev = (resolve_device(device) if device is not None
           else next(module.parameters()).device)
    module.to(dev).eval()
    if isinstance(model, Model):
        model.device = dev
    fp_module = module
    if specs is not None:
        if specs.rules is not None:     # the int8 rung keeps whole tables
            replicate(module, specs.mesh)
            fp_module = copy.deepcopy(module)
        specs.place_state(fp_module)
    eval_step = make_eval_step(fp_module, specs=specs)
    qparams = quantize_params(module)
    qfwd = make_quantized_forward(module)

    def fwd_fp(batch: Dict) -> np.ndarray:
        return eval_step(to_inputs(batch, dev)).cpu().numpy()

    def fwd_int8(batch: Dict) -> np.ndarray:
        return qfwd(qparams, *to_inputs(batch, dev)).cpu().numpy()

    return [
        ServingTier("fp", fwd_fp, speed=1.0, quality_note=notes[0],
                    device_program=lambda: (
                        eval_step, (to_inputs(example, dev),))),
        ServingTier("int8", fwd_int8, speed=int8_speed,
                    quality_note=notes[1],
                    device_program=lambda: (
                        qfwd, (qparams, *to_inputs(example, dev)))),
    ]


class MLPClassifier(Stage):
    """Frame estimator training a :class:`FraudMLP` (the reference's
    ``DLClassifier`` adapter): ``fit`` builds the model from ``seed`` on
    ``device`` and trains it for ``epochs`` over batches of the frame's
    rows in order; ``transform`` adds ``prediction`` (argmax) and
    ``log_probs``."""

    def __init__(self, in_features: int = 29, hidden: int = 10,
                 n_classes: int = 2, epochs: int = 10, batch_size: int = 64,
                 lr: float = 5e-3, features_col: str = "features",
                 label_col: str = "label",
                 prediction_col: str = "prediction", mesh=None, seed: int = 0,
                 device=None):
        self.mesh = mesh
        self.in_features = in_features
        self.hidden = hidden
        self.n_classes = n_classes
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.seed = seed
        self.device = device
        self.model: Optional[Model] = None

    def _batches(self, x: np.ndarray, y: np.ndarray):
        n = (len(x) // self.batch_size) * self.batch_size
        return [{"input": x[i:i + self.batch_size],
                 "target": y[i:i + self.batch_size]}
                for i in range(0, n, self.batch_size)]

    def fit(self, frame: Frame) -> "MLPClassifier":
        x = np.asarray(frame[self.features_col], np.float32)
        y = np.asarray(frame[self.label_col], np.int32)
        model = Model(FraudMLP(in_features=self.in_features,
                               hidden=self.hidden, n_classes=self.n_classes),
                      device=self.device)
        model.build(self.seed, np.zeros((1, x.shape[1]), np.float32))
        (Optimizer(model, self._batches(x, y), ClassNLLCriterion(),
                   specs=train_specs("fraud", self.mesh))
         .set_optim_method(Adam(self.lr))
         .set_end_when(Trigger.max_epoch(self.epochs))
         .optimize())
        self.model = model
        return self

    def transform(self, frame: Frame) -> Frame:
        if self.model is None:
            raise RuntimeError("MLPClassifier not fitted")
        x = np.asarray(frame[self.features_col], np.float32)
        with torch.inference_mode():
            log_probs = self.model.eval()(x).cpu().numpy()
        out = dict(frame)
        out[self.prediction_col] = log_probs.argmax(axis=1)
        out["log_probs"] = log_probs
        return out


def fraud_serving_tiers(model, specs=None, device=None) -> List:
    """Degradation rungs for ``serving.ServingRuntime`` over a trained
    ``FraudMLP`` (a ``Model`` or the module), cheapest last: ``fp`` and
    ``int8`` (weight-only; FraudMLP's layers are below the 4096-element
    floor, so that rung quantizes nothing, as in the reference).
    Requests carry one assembled and scaled feature row (``{"input":
    (in_features,) float32}``, the batcher's FIXED bucket).  ``specs``:
    the ``fp`` rung over the data ranks (``fp_int8_tiers``)."""

    def to_inputs(batch: Dict, dev) -> tuple:
        return (torch.as_tensor(np.asarray(batch["input"], np.float32),
                                device=dev),)

    module = model.module if isinstance(model, Model) else model
    example = {"input": np.zeros((1, module.in_features), np.float32)}
    return fp_int8_tiers(model, to_inputs, example,
                         ("fp32 weights, eval step",
                          "weight-only int8 (quantize_params)"),
                         FRAUD_INT8_SPEED, device, specs)


def auprc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the precision-recall curve, step-wise over recall
    (the reference evaluates AUPRC, ``BigDLKaggleFraud.scala:60``)."""
    order = np.argsort(-scores)
    labels = np.asarray(labels)[order]
    tp = np.cumsum(labels == 1)
    fp = np.cumsum(labels != 1)
    npos = max(int((labels == 1).sum()), 1)
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / npos
    d_recall = np.diff(np.concatenate([[0.0], recall]))
    return float(np.sum(precision * d_recall))


def precision_recall(labels: np.ndarray, preds: np.ndarray,
                     positive: int = 1):
    tp = int(((preds == positive) & (labels == positive)).sum())
    fp = int(((preds == positive) & (labels != positive)).sum())
    fn = int(((preds != positive) & (labels == positive)).sum())
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return precision, recall


@dataclasses.dataclass
class FraudResult:
    auprc: float
    best_threshold: int
    precision: float
    recall: float


def run_fraud_pipeline(frame: Frame, feature_cols: Sequence[str],
                       label_col: str = "label", time_col: str = "time",
                       n_models: int = 20,
                       thresholds: Optional[Sequence[int]] = None,
                       epochs: int = 10, mesh=None,
                       device=None) -> FraudResult:
    """The reference flow (``BigDLKaggleFraud.scala``): preprocess → time
    split → ``Bagging`` of ``n_models`` MLPs over stratified samples →
    threshold sweep (default ``n_models // 2 .. n_models``).  ``mesh``
    trains each MLP data parallel (every rank runs this call)."""
    if thresholds is None:
        thresholds = range(max(n_models // 2, 1), n_models + 1)
    else:
        thresholds = [t for t in thresholds if 1 <= t <= n_models]
        if not thresholds:
            raise ValueError(
                f"no requested vote threshold lies in [1, {n_models}] — "
                f"thresholds must not exceed n_models")

    frame = FramePipeline([VectorAssembler(feature_cols),
                           StandardScaler()]).fit_transform(frame)
    train, test = time_ordered_split(frame, time_col)
    n_feat = np.asarray(frame["features"]).shape[1]
    bag = Bagging(
        base_fn=lambda: MLPClassifier(in_features=n_feat, epochs=epochs,
                                      mesh=mesh, device=device),
        n_models=n_models,
        sampler=StratifiedSampler({0: 1.0, 1: 10.0}, label_col=label_col),
        threshold=min(thresholds),
    )
    bag.fit(train)
    votes = bag.transform(test)["votes"]
    labels = np.asarray(test[label_col])
    pr_auc = auprc(labels, votes.astype(np.float32) / n_models)
    best = (0, 0.0, 0.0)
    for t in thresholds:
        p, r = precision_recall(labels, (votes >= t).astype(np.int64))
        if p + r > best[1] + best[2]:
            best = (t, p, r)
    return FraudResult(auprc=pr_auc, best_threshold=best[0],
                       precision=best[1], recall=best[2])
