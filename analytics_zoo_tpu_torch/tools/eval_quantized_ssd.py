"""The serving-accuracy cost of int8 and bf16 on a TRAINED SSD model
(counterpart of ``tools/eval_quantized_ssd.py``).

VOC07 mAP of the SAME trained weights served five ways on a freshly
generated shapes validation set: ``fp``; ``int8_weight_only``
(``quantize=True``: int8 weights dequantized in the forward);
``int8_compute`` (``quantize="int8"``: int8 × int8 convolutions);
``bf16`` (``SSDPredictor(compute_dtype="bf16")``, the rung
``ssd_serving_tiers(compute_dtype=)`` serves; not in the reference's
tool); and, with ``--approx``, ``fp_approx_topk``
(``DetectionOutputParam(backend="pallas", approx_topk=True)``, whose
suppression is kernel K1 on the card).  Every other rung runs the
DetectionOutput ``--backend`` names (``fused``, kernel K2 on the card, by
default).  Train the weights first::

    python -m analytics_zoo_tpu_torch.examples.train_shapes_e2e \\
        --params-out ssd_shapes.pt
    python -m analytics_zoo_tpu_torch.tools.eval_quantized_ssd \\
        --params ssd_shapes.pt

``--params`` is a ``Model.save`` file (a ``torch.save`` state dict).
Writes one ``run_metadata``-stamped JSON to ``--out`` (default
``INT8_MAP_PARITY_torch.json``; the reference's ``INT8_MAP_PARITY.json``
is never written), which ``tools/check_artifacts.py`` lints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List, Tuple

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     device_name,
                                                     load_ssd_model)

APPROX_WARNING = (
    "WARNING: --approx: the port's approx_topk selects the exact top-k on "
    "every device (the reference's approx_max_k is approximate on a TPU "
    "only), so delta_approx_topk == 0 is vacuous here; it shows that the "
    "K1 path scores as the others do, not what an approximate top-k "
    "costs")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--params", required=True,
                   help="Model.save() file (a torch state dict)")
    p.add_argument("--resolution", type=int, default=300)
    p.add_argument("--val-images", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=1,
                   help="val-set seed (train_shapes_e2e uses seed 1 for "
                        "its val split)")
    p.add_argument("--out", default="INT8_MAP_PARITY_torch.json")
    p.add_argument("--backend", default="fused",
                   choices=("fused", "pallas", "xla", "auto"),
                   help="DetectionOutput backend for every served config "
                        "but fp_approx_topk (default: the fused kernel K2 "
                        "on the card, its plain version on the CPU), the "
                        "program the serving tiers dispatch")
    p.add_argument("--approx", action="store_true",
                   help="also evaluate fp serving with "
                        "DetectionOutputParam(approx_topk=True) on the "
                        "unfused path (K1 on the card); exact top-k in "
                        "the port, so its delta is vacuous")
    add_device_argument(p)
    return p


def rungs(n_classes: int, backend: str, approx: bool) -> List[Tuple]:
    """``(name, quantize, compute_dtype, DetectionOutputParam)`` of each
    rung, in the report's order."""
    from analytics_zoo_tpu_torch.ops import DetectionOutputParam

    post = DetectionOutputParam(n_classes=n_classes, backend=backend)
    out = [("fp", False, None, post),
           ("int8_weight_only", True, None, post),
           ("int8_compute", "int8", None, post),
           ("bf16", False, "bf16", post)]
    if approx:
        out.append(("fp_approx_topk", False, None,
                    DetectionOutputParam(n_classes=n_classes,
                                         backend="pallas",
                                         approx_topk=True)))
    return out


def rung_map(model, pre, pattern: str, post, quantize=False,
             compute_dtype=None, device=None):
    """VOC07 mAP and its ``DetectionResult`` of ``model`` served one way
    on the records of ``pattern``: a ``Validator`` (``quantize`` goes to
    its predictor), whose predictor the ``bf16`` rung builds itself with
    ``compute_dtype``."""
    from analytics_zoo_tpu_torch.data import SHAPE_CLASSES
    from analytics_zoo_tpu_torch.pipelines import (
        MeanAveragePrecision, PascalVocEvaluator, SSDPredictor, Validator,
        load_val_set)

    n_classes = len(SHAPE_CLASSES)
    validator = Validator(model, pre,
                          evaluator=MeanAveragePrecision(n_classes=n_classes),
                          post=post, quantize=quantize, device=device)
    if compute_dtype is not None:
        validator.predictor = SSDPredictor(
            model, pre, post=post, n_classes=n_classes,
            compute_dtype=compute_dtype, quantize=quantize, device=device)
    result = validator.test(load_val_set(pattern, pre, device=device))
    m = PascalVocEvaluator(class_names=SHAPE_CLASSES).evaluate(result)
    return float(m), result


def run(args) -> Tuple[Dict, Dict[str, float]]:
    """Every rung's mAP on a fresh shapes validation set; returns
    ``(report, mAP by rung unrounded)``."""
    from analytics_zoo_tpu_torch.data import (SHAPE_CLASSES,
                                              generate_shapes_records)
    from analytics_zoo_tpu_torch.pipelines import PreProcessParam

    n_classes = len(SHAPE_CLASSES)
    res = args.resolution
    model = load_ssd_model(args.params, n_classes, res, args.device)
    dev = model.device
    if args.approx:
        print(APPROX_WARNING, file=sys.stderr)
    results: Dict[str, float] = {}
    with tempfile.TemporaryDirectory() as tmp:
        generate_shapes_records(os.path.join(tmp, "val"),
                                n_images=args.val_images, resolution=res,
                                num_shards=2, seed=args.seed, device=dev)
        pre = PreProcessParam(batch_size=args.batch_size, resolution=res,
                              max_gt=8)
        for name, quantize, dtype, post in rungs(n_classes, args.backend,
                                                 args.approx):
            results[name], _ = rung_map(
                model.module, pre, os.path.join(tmp, "val-*.azr"), post,
                quantize=quantize, compute_dtype=dtype, device=dev)
            # raw: deltas must not be rounding artifacts
            print(json.dumps({name: round(results[name], 4)}), flush=True)

    report = {
        "task": "VOC07 mAP of ONE trained SSD served fp vs int8 "
                "(weight-only and real int8 compute) and bf16, same val set",
        "resolution": res, "val_images": args.val_images,
        "detout_backend": args.backend,
        "map": {k: round(v, 4) for k, v in results.items()},
        "delta_weight_only": round(results["int8_weight_only"]
                                   - results["fp"], 6),
        "delta_int8_compute": round(results["int8_compute"]
                                    - results["fp"], 6),
        "delta_bf16": round(results["bf16"] - results["fp"], 6),
        "backend": dev.type,
        "device": device_name(dev),
    }
    if "fp_approx_topk" in results:
        report["delta_approx_topk"] = round(results["fp_approx_topk"]
                                            - results["fp"], 6)
    return report, results


def main(argv=None) -> int:
    from analytics_zoo_tpu_torch.obs import run_metadata

    args = build_parser().parse_args(argv)
    report, _ = run(args)
    report["run_metadata"] = run_metadata(
        "eval_quantized_ssd", seed=args.seed,
        extra={"detout_backend": args.backend,
               "approx": bool(args.approx)})
    print(json.dumps(report))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
