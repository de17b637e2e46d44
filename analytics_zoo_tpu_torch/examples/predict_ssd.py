"""SSD prediction entry point (counterpart of ``examples/predict_ssd.py``;
reference ``ssd/example/Predict.scala``): image folder →
``SSDPredictor.predict`` → a text file of detections an image, and
drawn images with ``--vis``.

    python -m analytics_zoo_tpu_torch.examples.predict_ssd \\
        -f images/ --model ckpt/model.pt --vis

``--model`` is a ``Model.save`` file, as ``train_ssd --checkpoint``
writes one.  The folder's ``*.jpg``, ``*.jpeg`` and ``*.png`` are read, as
the reference globs them; the port's codecs decode JPEG only (nvJPEG on
the card, which never falls back), so a file that is not a JPEG is
refused by name before anything runs.  Only ``--vis`` needs cv2.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     load_ssd_model,
                                                     refuse_non_jpeg)

logger = logging.getLogger("analytics_zoo_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run SSD detection on images")
    p.add_argument("-f", "--image-folder", required=True)
    p.add_argument("--model", required=True,
                   help="Model.save() file (train_ssd --checkpoint writes "
                        "one as model.pt)")
    p.add_argument("-o", "--output-folder", default="ssd_out")
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("-r", "--resolution", type=int, default=300)
    p.add_argument("--class-number", type=int, default=21)
    p.add_argument("--topk", type=int, default=200)
    p.add_argument("--vis", action="store_true",
                   help="save drawn images (needs cv2)")
    p.add_argument("--conf", type=float, default=0.3)
    add_device_argument(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from analytics_zoo_tpu_torch.data import SSDByteRecord
    from analytics_zoo_tpu_torch.pipelines import (PreProcessParam,
                                                   SSDPredictor)
    from analytics_zoo_tpu_torch.pipelines.visualizer import (
        result_to_string, vis_detection)

    paths = sorted(
        q for ext in ("*.jpg", "*.jpeg", "*.png")
        for q in glob.glob(os.path.join(args.image_folder, ext)))
    refuse_non_jpeg(paths)
    if args.vis:
        try:
            import cv2
        except ImportError as e:
            raise SystemExit(f"--vis draws with cv2 (OpenCV), which does "
                             f"not import here: {e}")
    model = load_ssd_model(args.model, args.class_number, args.resolution,
                           args.device)
    records = []
    for path in paths:
        with open(path, "rb") as f:
            records.append(SSDByteRecord(data=f.read(), path=path))

    predictor = SSDPredictor(
        model.module, PreProcessParam(batch_size=args.batch_size,
                                      resolution=args.resolution),
        n_classes=args.class_number, device=model.device
    ).set_top_k(args.topk)
    results = predictor.predict(records)

    os.makedirs(args.output_folder, exist_ok=True)
    for rec, dets in zip(records, results):
        stem = os.path.splitext(os.path.basename(rec.path))[0]
        with open(os.path.join(args.output_folder, stem + ".txt"), "w") as f:
            f.write(result_to_string(dets, conf_thresh=args.conf))
        if args.vis:
            img = cv2.imread(rec.path)
            vis_detection(img, dets, conf_thresh=args.conf,
                          out_path=os.path.join(args.output_folder,
                                                stem + "_det.jpg"))
    logger.info("wrote %d results to %s", len(results), args.output_folder)
    return 0


if __name__ == "__main__":
    sys.exit(main())
