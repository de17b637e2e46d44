"""Column pipelines (counterpart of ``pipelines/frame.py``; the port's
own copy, host numpy only).

A **Frame** is a plain dict of named columns (numpy arrays or Python
lists of equal length), the stand-in for the reference's Spark ML
DataFrames.  Stages follow the fit/transform contract:

- ``Stage.fit(frame) -> Stage`` learns state (scalers, models);
- ``Stage.transform(frame) -> frame`` adds or replaces columns;
- ``FramePipeline([...])`` chains them (``new Pipeline().setStages``).

With the Spark-ML extensions the reference adds: ``FuncTransformer``
(``feature/FuncTransformer.scala:46``), ``StratifiedSampler``
(``feature/StratifiedSampler.scala:42``), ``Bagging``
(``ensemble/Bagging.scala:79``), and the ``StandardScaler`` /
``VectorAssembler`` the fraud pipeline uses
(``BigDLKaggleFraud.scala:37-49``).  The same seeds give the reference's
outputs exactly.
"""

from __future__ import annotations

import copy
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

Frame = Dict[str, Any]


def frame_length(frame: Frame) -> int:
    return len(next(iter(frame.values())))


def frame_select(frame: Frame, idx: np.ndarray) -> Frame:
    out = {}
    for k, v in frame.items():
        arr = np.asarray(v)
        out[k] = arr[idx]
    return out


class Stage:
    def fit(self, frame: Frame) -> "Stage":
        return self

    def transform(self, frame: Frame) -> Frame:
        return frame

    def fit_transform(self, frame: Frame) -> Frame:
        return self.fit(frame).transform(frame)


class FramePipeline(Stage):
    """``Pipeline().setStages([...])`` equivalent: fit stages in order, each
    consuming the previous stage's transformed output."""

    def __init__(self, stages: Sequence[Stage]):
        self.stages = list(stages)

    def fit(self, frame: Frame) -> "FramePipeline":
        self.fit_transform(frame)
        return self

    def fit_transform(self, frame: Frame) -> Frame:
        """Fit stages in order and return the final transformed frame —
        avoids the second full pass a fit().transform() pair would cost."""
        cur = frame
        for s in self.stages:
            s.fit(cur)
            cur = s.transform(cur)
        return cur

    def transform(self, frame: Frame) -> Frame:
        cur = frame
        for s in self.stages:
            cur = s.transform(cur)
        return cur


class FuncTransformer(Stage):
    """Apply an arbitrary function to one column (reference
    ``FuncTransformer``: persistable udf transformer, used for the fraud
    label remap 0↔2)."""

    def __init__(self, fn: Callable, input_col: str,
                 output_col: Optional[str] = None):
        self.fn = fn
        self.input_col = input_col
        self.output_col = output_col or input_col

    def transform(self, frame: Frame) -> Frame:
        out = dict(frame)
        col = np.asarray(frame[self.input_col])
        out[self.output_col] = np.asarray([self.fn(v) for v in col])
        return out


class VectorAssembler(Stage):
    """Concatenate feature columns into one (N, D) matrix column."""

    def __init__(self, input_cols: Sequence[str], output_col: str = "features"):
        self.input_cols = list(input_cols)
        self.output_col = output_col

    def transform(self, frame: Frame) -> Frame:
        cols = []
        for c in self.input_cols:
            arr = np.asarray(frame[c], np.float32)
            cols.append(arr[:, None] if arr.ndim == 1 else arr)
        out = dict(frame)
        out[self.output_col] = np.concatenate(cols, axis=1)
        return out


class StandardScaler(Stage):
    """Fit mean/std on a matrix column, transform to z-scores."""

    def __init__(self, input_col: str = "features",
                 output_col: Optional[str] = None):
        self.input_col = input_col
        self.output_col = output_col or input_col
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, frame: Frame) -> "StandardScaler":
        x = np.asarray(frame[self.input_col], np.float32)
        self.mean = x.mean(axis=0)
        self.std = np.maximum(x.std(axis=0), 1e-8)
        return self

    def transform(self, frame: Frame) -> Frame:
        if self.mean is None:
            raise RuntimeError("StandardScaler not fitted")
        out = dict(frame)
        x = np.asarray(frame[self.input_col], np.float32)
        out[self.output_col] = (x - self.mean) / self.std
        return out


class StratifiedSampler(Stage):
    """Per-label-fraction resampling (reference ``StratifiedSampler``:
    e.g. ``{2: 0.05, 1: 10, 0: 1}`` — under-sample label 2 to 5%,
    over-sample label 1 ×10)."""

    def __init__(self, fractions: Dict[Any, float], label_col: str = "label",
                 seed: int = 0):
        self.fractions = fractions
        self.label_col = label_col
        self.seed = seed

    def transform(self, frame: Frame) -> Frame:
        rng = np.random.RandomState(self.seed)
        labels = np.asarray(frame[self.label_col])
        keep_idx: List[np.ndarray] = []
        for value, frac in self.fractions.items():
            idx = np.where(labels == value)[0]
            if frac <= 1.0:
                n = int(round(len(idx) * frac))
                keep_idx.append(rng.choice(idx, size=n, replace=False))
            else:
                whole = int(frac)
                rem = frac - whole
                parts = [idx] * whole
                if rem > 0:
                    parts.append(rng.choice(idx, size=int(len(idx) * rem),
                                            replace=False))
                keep_idx.append(np.concatenate(parts))
        idx = np.concatenate(keep_idx)
        rng.shuffle(idx)
        return frame_select(frame, idx)


class Bagging(Stage):
    """Bootstrap-aggregated ensemble (reference ``Bagging.scala:79``):
    N resampled fits of a base estimator; classification votes with an
    integer threshold (≥ t positive sub-votes → positive), regression
    averages.

    ``base_fn() -> Stage`` (or ``base_fn(i) -> Stage``, receiving the
    sub-model index for seeding) must return a fresh estimator whose
    ``transform`` adds ``prediction_col``.
    """

    def __init__(self, base_fn: Callable[[], Stage], n_models: int = 20,
                 sampler: Optional[Stage] = None,
                 prediction_col: str = "prediction",
                 is_classification: bool = True, threshold: int = 10,
                 seed: int = 0):
        self.base_fn = base_fn
        self.n_models = n_models
        self.sampler = sampler
        self.prediction_col = prediction_col
        self.is_classification = is_classification
        self.threshold = threshold
        self.seed = seed
        self.models: List[Stage] = []

    def fit(self, frame: Frame) -> "Bagging":
        n = frame_length(frame)
        self.models = []
        for i in range(self.n_models):
            rng = np.random.RandomState(self.seed + i)
            if self.sampler is not None:
                sampler = copy.deepcopy(self.sampler)
                if hasattr(sampler, "seed"):
                    sampler.seed = self.seed + i
                sub = sampler.transform(frame)
            else:
                idx = rng.randint(0, n, size=n)   # bootstrap
                sub = frame_select(frame, idx)
            # vary model init per sub-model — identical seeds would collapse
            # the ensemble into near-copies and degenerate the vote; prefer
            # passing the index into base_fn, fall back to a seed attribute
            try:
                takes_index = len(inspect.signature(self.base_fn).parameters) >= 1
            except (TypeError, ValueError):
                takes_index = False
            m = self.base_fn(i) if takes_index else self.base_fn()
            if not takes_index and hasattr(m, "seed"):
                m.seed = self.seed + i
            m.fit(sub)
            self.models.append(m)
        return self

    def transform(self, frame: Frame) -> Frame:
        if not self.models:
            raise RuntimeError("Bagging not fitted")
        preds = np.stack([
            np.asarray(m.transform(frame)[self.prediction_col])
            for m in self.models
        ], axis=0)                                 # (M, N)
        out = dict(frame)
        if self.is_classification:
            votes = (preds > 0).sum(axis=0)
            out[self.prediction_col] = (votes >= self.threshold).astype(np.int64)
            out["votes"] = votes
        else:
            out[self.prediction_col] = preds.mean(axis=0)
        return out


def time_ordered_split(frame: Frame, time_col: str,
                       train_fraction: float = 0.7):
    """Quantile split on a time column (reference fraud pipeline's 70/30
    time-based split, ``BigDLKaggleFraud.scala``)."""
    t = np.asarray(frame[time_col], np.float64)
    cut = np.quantile(t, train_fraction)
    train_idx = np.where(t <= cut)[0]
    test_idx = np.where(t > cut)[0]
    return frame_select(frame, train_idx), frame_select(frame, test_idx)
