"""SSD evaluation entry point (counterpart of ``examples/test_ssd.py``;
reference ``ssd/example/Test.scala:72-118``): records → ``Validator`` →
per-class AP printout.

    python -m analytics_zoo_tpu_torch.examples.test_ssd \\
        -f '/data/voc/val*.azr' --model ckpt/model.pt

``--model`` is a ``Model.save`` file (a ``torch.save`` state dict of the
``SSDVgg``), as ``train_ssd --checkpoint`` writes one.  On the card the
DetectionOutput is kernel K2.
"""

from __future__ import annotations

import argparse
import logging
import sys

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     load_ssd_model)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate SSD mAP on records")
    p.add_argument("-f", "--records", required=True)
    p.add_argument("--model", required=True,
                   help="Model.save() file (train_ssd --checkpoint writes "
                        "one as model.pt)")
    p.add_argument("-b", "--batch-size", type=int, default=32)
    p.add_argument("-r", "--resolution", type=int, default=300)
    p.add_argument("--class-number", type=int, default=21)
    p.add_argument("--image-set", default="voc_2007_test")
    add_device_argument(p)
    return p


def evaluate(args) -> float:
    """The run of :func:`main`; returns the mean AP."""
    from analytics_zoo_tpu_torch.pipelines import (
        MeanAveragePrecision, PascalVocEvaluator, PreProcessParam,
        VOC_CLASSES, Validator, load_val_set)

    model = load_ssd_model(args.model, args.class_number, args.resolution,
                           args.device)
    pre = PreProcessParam(batch_size=args.batch_size,
                          resolution=args.resolution)
    val_set = load_val_set(args.records, pre, device=model.device)
    evaluator = MeanAveragePrecision(
        n_classes=args.class_number,
        use_07_metric="2007" in args.image_set,
        class_names=VOC_CLASSES)
    result = Validator(model.module, pre, evaluator,
                       device=model.device).test(val_set)
    return PascalVocEvaluator(args.image_set,
                              class_names=VOC_CLASSES).evaluate(result)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    evaluate(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
