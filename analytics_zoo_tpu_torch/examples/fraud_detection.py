"""Fraud-detection pipeline (counterpart of ``examples/fraud_detection.py``;
reference ``fraudDetection/src/BigDLKaggleFraud.scala``): Kaggle
creditcard.csv → preprocessing → bagged MLP ensemble → AUPRC, precision
and recall with a vote-threshold sweep (``pipelines/fraud.py::
run_fraud_pipeline``).

    python -m analytics_zoo_tpu_torch.examples.fraud_detection \\
        -f creditcard.csv --out ACCURACY_torch.md

``--csv`` is read with the standard library's ``csv`` module (the
columns ``V*``, ``Amount``, ``Class`` and ``Time``); without it the
reference's synthetic imbalanced frame is drawn.
"""

from __future__ import annotations

import argparse
import csv
import logging
import sys
from typing import Dict, List, Tuple

import numpy as np

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     append_report,
                                                     report_device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Credit-card fraud detection")
    p.add_argument("-f", "--csv", default=None,
                   help="creditcard.csv (Kaggle); synthetic demo if omitted")
    p.add_argument("--models", type=int, default=20, help="bagging size")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--threshold-from", type=int, default=20)
    p.add_argument("--threshold-to", type=int, default=40)
    p.add_argument("--out", default=None,
                   help="append a JSON accuracy report to this md file")
    add_device_argument(p)
    return p


def read_csv_frame(path: str) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """creditcard.csv → (frame, feature columns): the ``V*`` columns and
    ``Amount`` as float32, ``Class`` as ``label`` (int64), ``Time`` as
    ``time`` (float64)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = [h.strip() for h in next(reader)]
        rows = [r for r in reader if r]
    cols = {h: [r[i] for r in rows] for i, h in enumerate(header)}
    feature_cols = [c for c in header if c.startswith("V")] + ["Amount"]
    frame = {c: np.asarray(cols[c], np.float64).astype(np.float32)
             for c in feature_cols}
    frame["label"] = np.asarray(cols["Class"], np.float64).astype(np.int64)
    frame["time"] = np.asarray(cols["Time"], np.float64)
    return frame, feature_cols


def synthetic_frame() -> Tuple[Dict[str, np.ndarray], List[str]]:
    """The reference's synthetic imbalanced frame (~0.2% positives), its
    draws in its order."""
    rng = np.random.RandomState(0)
    n, d = 20000, 29
    x = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d)
    label = ((x @ w) > 2.8).astype(np.int64)   # ~0.2% positives
    feature_cols = [f"V{i}" for i in range(d)]
    frame = {f"V{i}": x[:, i] for i in range(d)}
    frame["label"] = label
    frame["time"] = np.arange(n, dtype=np.float64)
    return frame, feature_cols


def run(args) -> Dict:
    """The pipeline on the frame: the report (with unrounded figures)."""
    from analytics_zoo_tpu_torch.pipelines import run_fraud_pipeline
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.csv:
        frame, feature_cols = read_csv_frame(args.csv)
    else:
        logging.info("no CSV given — running on synthetic imbalanced data")
        frame, feature_cols = synthetic_frame()
    res = run_fraud_pipeline(
        frame, feature_cols, n_models=args.models, epochs=args.epochs,
        thresholds=range(args.threshold_from, args.threshold_to + 1),
        device=dev)
    return {
        "task": ("Kaggle creditcard.csv" if args.csv
                 else "synthetic imbalanced (~0.2% positives)"),
        "auprc": res.auprc,
        "best_threshold": res.best_threshold,
        "precision": res.precision,
        "recall": res.recall,
        "bagging_models": args.models,
        **report_device(dev),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    r = run(args)
    print(f"AUPRC = {r['auprc']:.4f}")
    print(f"best vote threshold = {r['best_threshold']}: "
          f"precision {r['precision']:.4f}, recall {r['recall']:.4f}")
    if args.out:
        report = {k: round(v, 4) if isinstance(v, float) else v
                  for k, v in r.items()}
        append_report(args.out, "Fraud detection, PyTorch port",
                      "analytics_zoo_tpu_torch.examples.fraud_detection",
                      report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
