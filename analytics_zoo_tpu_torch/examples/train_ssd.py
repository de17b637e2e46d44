"""SSD training entry point (counterpart of ``examples/train_ssd.py``;
reference ``ssd/example/Train.scala:64-136`` scopt CLI, the same knobs in
argparse) over ``pipelines/ssd.py::train_ssd``.

    python -m analytics_zoo_tpu_torch.examples.train_ssd \\
        -f '/data/voc/train*.azr' -v '/data/voc/val*.azr' -b 32 \\
        --checkpoint ckpt

``--device-aug`` stages decoded images and runs the augmentation's pixel
work on the device, in the train step; without it the host runs the
reference's augmentation chain.  The yuv420 wire and the packed staging
(``--wire-format yuv420``, ``--pack``) raise the port's refusal
(ROADMAP.md deferred item e).  ``--weights-npz`` loads a converter npz
(slash-keyed arrays) by layer name.  ``--checkpoint`` snapshots every
epoch and, at the end, writes the trained weights there as ``model.pt``
(the ``Model.save`` file that ``test_ssd`` and ``predict_ssd`` take as
their ``--model``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from analytics_zoo_tpu_torch.examples.common import add_device_argument

logger = logging.getLogger("analytics_zoo_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train SSD on VOC-style records")
    p.add_argument("-f", "--train-records", required=True,
                   help="glob of training .azr record shards")
    p.add_argument("-v", "--val-records", default=None)
    p.add_argument("-b", "--batch-size", type=int, default=32)
    p.add_argument("-e", "--max-epoch", type=int, default=250)
    p.add_argument("-l", "--learning-rate", type=float, default=0.0035)
    p.add_argument("-r", "--resolution", type=int, default=300,
                   choices=(300, 512))
    p.add_argument("--class-number", type=int, default=21)
    p.add_argument("--schedule", default="plateau",
                   choices=("plateau", "multistep"))
    p.add_argument("--lr-steps", type=int, nargs="*", default=[])
    p.add_argument("--warmup-map", type=float, default=None,
                   help="Adam warm-up until this mAP (Trigger.maxScore)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--no-overwrite-checkpoint", action="store_true")
    p.add_argument("--summary-dir", default=None)
    p.add_argument("--job-name", default="ssd300")
    p.add_argument("--weights-npz", default=None,
                   help="pretrained backbone weights (converter npz)")
    p.add_argument("--shuffle-buffer", type=int, default=1024,
                   help="record-level shuffle window (0 = file order only)")
    p.add_argument("--num-workers", type=int, default=1,
                   help="host augmentation worker threads")
    p.add_argument("--prefetch", type=int, default=2,
                   help="device prefetch depth (0 = synchronous)")
    p.add_argument("--device-aug", action="store_true",
                   help="run the augmentation pixel work on the device, in "
                        "the train step (the host decodes and makes the "
                        "geometry only)")
    p.add_argument("--wire-format", choices=("bgr", "yuv420"),
                   default="bgr",
                   help="device-aug staging wire (yuv420 = 1.5 B/px; not "
                        "ported: refused)")
    p.add_argument("--pack", action="store_true",
                   help="device-aug staging as ONE packed transfer per "
                        "batch (not ported: refused)")
    add_device_argument(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.pipelines import (
        PreProcessParam, TrainParams, load_train_set, load_train_set_device,
        load_val_set, train_ssd)
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    # the yuv420 wire and packed staging raise here (deferred item e)
    pre = PreProcessParam(batch_size=args.batch_size,
                          resolution=args.resolution,
                          num_workers=args.num_workers,
                          shuffle_buffer=args.shuffle_buffer,
                          wire_format=args.wire_format,
                          pack_staging=args.pack)
    augment = None
    if args.device_aug:
        train_set, augment = load_train_set_device(args.train_records, pre,
                                                   device=dev)
    else:
        train_set = load_train_set(args.train_records, pre, device=dev)
    val_set = (load_val_set(args.val_records, pre, device=dev)
               if args.val_records else None)
    params = TrainParams(
        resolution=args.resolution, n_classes=args.class_number,
        learning_rate=args.learning_rate, max_epoch=args.max_epoch,
        schedule=args.schedule, lr_steps=args.lr_steps,
        warm_up_map=args.warmup_map, checkpoint_path=args.checkpoint,
        overwrite_checkpoint=not args.no_overwrite_checkpoint,
        log_dir=args.summary_dir, job_name=args.job_name,
        prefetch=args.prefetch)

    model = None
    if args.weights_npz:
        from analytics_zoo_tpu_torch.models import SSDVgg
        from analytics_zoo_tpu_torch.utils.convert import load_weights_by_name

        model = SSDVgg(num_classes=args.class_number,
                       resolution=args.resolution, device=dev)
        with np.load(args.weights_npz, allow_pickle=False) as z:
            source = {k: z[k] for k in z.files}
        new_state, report = load_weights_by_name(model, source)
        logger.info("loaded %d tensors, %d missing", len(report["loaded"]),
                    len(report["missing"]))
        model.load_state_dict(new_state)

    trained = train_ssd(train_set, val_set, params, model=model,
                        device_transform=augment, device=dev)
    if args.checkpoint:
        # the Model.save format
        os.makedirs(args.checkpoint, exist_ok=True)
        torch.save(trained.state_dict(),
                   os.path.join(args.checkpoint, "model.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
