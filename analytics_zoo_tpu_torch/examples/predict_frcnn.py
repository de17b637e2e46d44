"""Faster-RCNN prediction entry point (counterpart of
``examples/predict_frcnn.py``; reference ``ssd/example/Predict.scala``
with ``FrcnnCaffeLoader``, the Faster-RCNN serving path).

Runs the native ``FasterRcnnDetector`` (VGG trunk → RPN → proposal → ROI
pool → heads → per-class NMS) over a folder of images or a seeded demo
batch; ``--caffemodel`` imports py-faster-rcnn VGG16 weights by layer
name (``utils/caffe.py::load_frcnn_vgg_caffe``).

    python -m analytics_zoo_tpu_torch.examples.predict_frcnn \\
        --image-dir images/
    python -m analytics_zoo_tpu_torch.examples.predict_frcnn \\
        --caffemodel VGG16_faster_rcnn.caffemodel

The folder's first 16 files (sorted) are read.  The port decodes JPEG
only (nvJPEG on the card, libjpeg on the CPU; ``data/native.py::
decode_jpeg``) and resizes with ``resize_bilinear``, so a file that is not
a JPEG is refused by name before anything runs.  The timing line is the
host clock's ms of one batch after a warm-up call, to the readback.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     refuse_non_jpeg)
from analytics_zoo_tpu_torch.pipelines.frcnn import FRCNN_BGR_MEANS
from analytics_zoo_tpu_torch.pipelines.voc import VOC_CLASSES

BGR_MEANS = np.asarray(FRCNN_BGR_MEANS, np.float32)


def load_images(image_dir: str, size: int, device
                ) -> Tuple[np.ndarray, List[str]]:
    """The folder's first 16 files, decoded and resized to ``size``²:
    (N, size, size, 3) float BGR and their names."""
    from analytics_zoo_tpu_torch.data.native import codec_for, decode_jpeg
    from analytics_zoo_tpu_torch.transform.vision.augmentation import (
        resize_bilinear)

    paths = sorted(glob.glob(os.path.join(image_dir, "*")))[:16]
    refuse_non_jpeg(paths)
    codec = codec_for(device)
    mats, names = [], []
    for path in paths:
        with open(path, "rb") as f:
            m = decode_jpeg(f.read(), codec)
        if m is None:
            continue
        mats.append(resize_bilinear(m, size, size).astype(np.float32))
        names.append(os.path.basename(path))
    if not mats:
        raise SystemExit(
            f"predict_frcnn: no decodable images found in {image_dir!r} "
            "(supported: JPEG) — pass a directory with images or omit "
            "--image-dir for the random demo batch")
    return np.stack(mats), names


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--image-dir", default=None)
    p.add_argument("--caffemodel", default=None,
                   help="py-faster-rcnn VGG16 .caffemodel to import")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--classes", type=int, default=21)
    p.add_argument("--conf", type=float, default=0.5)
    add_device_argument(p)
    return p


def make_detector(args, device):
    """The seeded detector, with ``--caffemodel``'s weights when given."""
    from analytics_zoo_tpu_torch.models import FasterRcnnDetector, FrcnnParam

    det = FasterRcnnDetector(param=FrcnnParam(num_classes=args.classes),
                             device=device, seed=0)
    if args.caffemodel:
        from analytics_zoo_tpu_torch.utils.caffe import load_frcnn_vgg_caffe

        state, report = load_frcnn_vgg_caffe(det, args.caffemodel)
        det.load_state_dict(state)
        print(f"caffe import: {len(report['loaded'])} loaded, "
              f"{len(report['missing'])} missing")
    return det.eval()


def run(args, detector=None) -> Dict:
    """The detections (``"detections"``, (N, max_per_image, 6) in the
    input's pixels), the image names and the ms of a timed batch;
    ``detector`` replaces the seeded one (its weights carried in)."""
    import torch

    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.image_dir:
        imgs, names = load_images(args.image_dir, args.size, dev)
    else:
        rng = np.random.RandomState(0)
        imgs = rng.rand(2, args.size, args.size, 3).astype(np.float32) * 255
        names = [f"demo{i}" for i in range(len(imgs))]
    x = torch.as_tensor(imgs - BGR_MEANS, device=dev)
    im_info = torch.tensor([[args.size, args.size, 1.0]], device=dev
                           ).repeat(len(imgs), 1)
    det = detector if detector is not None else make_detector(args, dev)

    with torch.inference_mode():
        det(x, im_info).cpu()                      # warm-up
        t0 = time.perf_counter()
        out = det(x, im_info).cpu().numpy()
        dt = time.perf_counter() - t0
    return {"detections": out, "names": names, "ms": dt * 1e3,
            "detector": det}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    r = run(args)
    out, names, dt = r["detections"], r["names"], r["ms"] / 1e3
    print(f"{len(names)} images in {dt*1e3:.1f} ms "
          f"({len(names)/dt:.1f} img/s, after a warm-up call)")
    class_names = VOC_CLASSES if args.classes == len(VOC_CLASSES) else None
    for name, dets in zip(names, out):
        kept = dets[dets[:, 1] >= args.conf]
        print(f"{name}: {len(kept)} detections >= {args.conf}")
        for cls, score, x1, y1, x2, y2 in kept[:10]:
            label = (class_names[int(cls)] if class_names
                     else f"class{int(cls)}")
            print(f"  {label} {score:.3f} "
                  f"[{x1:.0f},{y1:.0f},{x2:.0f},{y2:.0f}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
