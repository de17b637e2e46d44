"""Train Faster-RCNN end to end on rendered shapes and report VOC07 mAP
(counterpart of ``examples/train_frcnn_shapes.py``).

The rendered-shapes method of ``train_shapes_e2e`` (exact ground truth,
the whole stack in the loop): records (``data/synthetic.py``) → decode
and flip → approximate-joint training (RPN and head losses,
``ops/frcnn_train.py``, through ``pipelines/frcnn.py::train_frcnn``) →
the proposal / ROI-pool / per-class-NMS detector → VOC07 mAP.

    python -m analytics_zoo_tpu_torch.examples.train_frcnn_shapes \\
        --epochs 20 --out ACCURACY_torch.md

``--params-out`` (and its ``.latest`` copy at each ``--eval-every``
probe) is ``Model.save``, a ``torch.save`` state dict of the
``FasterRcnnVgg``, which ``--eval-only`` reads back.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import time
from typing import Dict, Tuple

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     append_report,
                                                     report_device)

CLASSES = ["__background__", "rectangle", "ellipse", "triangle"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--train-images", type=int, default=320)
    p.add_argument("--val-images", type=int, default=96)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--pre-nms", type=int, default=512)
    p.add_argument("--post-nms", type=int, default=64)
    p.add_argument("--anchor-scales", type=float, nargs="+",
                   default=[1, 2, 4],
                   help="anchor side = scale*16px.  The py-faster-rcnn "
                        "default (8,16,32) is sized for ~600px inputs; "
                        "at small --res those anchors all hang off the "
                        "image, every one is cross-boundary-ignored, and "
                        "the RPN never gets a positive")
    p.add_argument("--out", default=None)
    p.add_argument("--eval-every", type=int, default=0, metavar="N",
                   help="evaluate VOC07 mAP on the val set every N epochs "
                        "during training and record the trajectory.  "
                        "0 = final eval only")
    p.add_argument("--lr-decay-at", type=float, nargs="*", default=None,
                   metavar="FRAC",
                   help="multiply LR by 0.1 at these epoch fractions "
                        "(e.g. 0.6 0.85 — py-faster-rcnn style step decay)")
    p.add_argument("--params-out", default="frcnn_shapes_params.pt",
                   help="save the trained weights here right after "
                        "training (Model.save, a torch state dict)")
    p.add_argument("--eval-only", default=None, metavar="PARAMS_FILE",
                   help="skip training; evaluate saved weights (loaded "
                        "into the built model, names and shapes checked)")
    add_device_argument(p)
    return p


def run(args, workdir: str) -> Tuple[Dict, Dict]:
    """Records under ``workdir``, the training and the evaluation:
    ``(report, details)``, details holding the unrounded ``final_map``
    and the trained ``model``."""
    import torch

    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.data import generate_shapes_records
    from analytics_zoo_tpu_torch.models import (FasterRcnnDetector,
                                                FasterRcnnVgg, FrcnnParam)
    from analytics_zoo_tpu_torch.ops import ProposalParam
    from analytics_zoo_tpu_torch.ops.frcnn import FrcnnPostParam
    from analytics_zoo_tpu_torch.pipelines.evaluation import (
        MeanAveragePrecision)
    from analytics_zoo_tpu_torch.pipelines.frcnn import train_frcnn
    from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                       load_train_set,
                                                       load_val_set)
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    param = FrcnnParam(
        num_classes=len(CLASSES),
        anchor_scales=tuple(args.anchor_scales),
        proposal=ProposalParam(pre_nms_topn=args.pre_nms,
                               post_nms_topn=args.post_nms))
    generate_shapes_records(os.path.join(workdir, "train"),
                            n_images=args.train_images, resolution=args.res,
                            num_shards=4, seed=0, device=dev)
    generate_shapes_records(os.path.join(workdir, "val"),
                            n_images=args.val_images, resolution=args.res,
                            num_shards=2, seed=100, device=dev)
    pp = PreProcessParam(batch_size=args.batch_size, resolution=args.res,
                         max_gt=8)
    # augment=False: shuffled and flipped but no Expand/zoom-out, which
    # shrinks objects below the stride-16 feature grid at small --res
    train_set = load_train_set(os.path.join(workdir, "train-*.azr"), pp,
                               augment=False, device=dev)
    val_set = load_val_set(os.path.join(workdir, "val-*.azr"), pp,
                           device=dev)

    model = Model(FasterRcnnVgg(param=param, device=dev, seed=0), device=dev)
    # the serving assembly around the trained network: built on the meta
    # device, its own network swapped for the one trained
    with torch.device("meta"):
        det = FasterRcnnDetector(
            param=param,
            post=FrcnnPostParam(nms_thresh=0.3, conf_thresh=0.05,
                                nms_topk=args.post_nms, max_per_image=20),
            device="meta")
    det.frcnn = model.module
    # host-materialized val batches: each probe re-reads no record
    val_batches = list(val_set)
    info = torch.tensor([[args.res, args.res, 1.0]], device=dev)

    def evaluate():
        evaluator = MeanAveragePrecision(n_classes=len(CLASSES),
                                         class_names=CLASSES)
        total = None
        was_training = det.frcnn.training
        det.eval()
        with torch.inference_mode():
            for batch in val_batches:
                x = torch.as_tensor(batch["input"], device=dev)
                dets = det(x, info.repeat(x.shape[0], 1)).cpu().numpy()
                dets[..., 2:6] /= args.res      # pixel → normalized (gt)
                r = evaluator(dets, batch)
                total = r if total is None else total + r
        det.frcnn.train(was_training)
        return total.result(), total.ap_per_class()

    trajectory = []

    def probe(loop, state):
        if args.eval_every and loop.epoch % args.eval_every == 0:
            m, _ = evaluate()
            trajectory.append({"epoch": loop.epoch,
                               "map_voc07": round(float(m), 4)})
            logging.info("mAP trajectory @ epoch %d: %.4f", loop.epoch,
                         float(m))
            if args.params_out:
                # a long run's insurance: the newest probed weights
                model.save(args.params_out + ".latest")

    schedule = None
    if args.lr_decay_at:
        from analytics_zoo_tpu_torch.parallel.optim import multistep
        iters_per_epoch = -(-args.train_images // args.batch_size)
        schedule = multistep(
            args.lr,
            [int(f * args.epochs * iters_per_epoch)
             for f in args.lr_decay_at])

    t0 = time.perf_counter()
    if args.eval_only:
        model.load(args.eval_only)
        wall = 0.0
    else:
        train_frcnn(model.module, train_set, args.res, epochs=args.epochs,
                    lr=args.lr, lr_schedule=schedule,
                    epoch_hook=probe if args.eval_every else None)
        wall = time.perf_counter() - t0
        if args.params_out:
            model.save(args.params_out)

    mean_ap, per_class = evaluate()
    report = {
        "task": "Faster-RCNN-VGG from scratch on rendered shapes "
                "(3 classes) — reference cannot train this family",
        "final_map_voc07": round(float(mean_ap), 4),
        "ap_per_class": {c: round(float(a), 4)
                         for c, a in zip(CLASSES[1:], per_class[1:])},
        "resolution": args.res,
        "train_images": args.train_images,
        "val_images": args.val_images,
        "epochs": args.epochs,
        "wall_seconds": round(wall, 1),
        **report_device(dev),
    }
    if trajectory:
        report["map_trajectory"] = trajectory
    if args.lr_decay_at:
        report["lr_decay_at"] = args.lr_decay_at
    return report, {"final_map": float(mean_ap), "model": model}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    with tempfile.TemporaryDirectory() as tmp:
        report, _ = run(args, tmp)
    print(json.dumps(report))
    if args.out:
        append_report(args.out, "Faster-RCNN shapes end-to-end, PyTorch port",
                      "analytics_zoo_tpu_torch.examples.train_frcnn_shapes",
                      report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
