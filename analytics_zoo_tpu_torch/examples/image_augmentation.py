"""Image augmentation demo (counterpart of ``examples/image_augmentation.py``;
reference ``apps/feature/image_augmentation.ipynb``): run each vision
transformer on one image and write the results as JPEGs.

    python -m analytics_zoo_tpu_torch.examples.image_augmentation \\
        -f image.jpg -o aug_out

The image is decoded and each result encoded by the port's codec
(``data/native.py``: nvJPEG on the card, libjpeg on the CPU), so the
input must be a JPEG.  The ops follow ``--device`` as the port's
pipelines do: on the card, ``Resize`` is ``resize_bilinear`` and
``Saturation``, ``Hue`` and ``ColorJitter`` convert to and from HSV in
numpy (``augmentation.HSV_TOL`` from cv2's), so nothing imports cv2; on
the CPU both go through cv2, as the reference's.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     refuse_non_jpeg)

SIZE = 300


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Vision transformer demo")
    p.add_argument("-f", "--image", required=True)
    p.add_argument("-o", "--output-folder", default="aug_out")
    add_device_argument(p)
    return p


def make_ops(device) -> Dict:
    """The reference's nine chains, each ending in a 300² resize."""
    from analytics_zoo_tpu_torch.transform.vision import (
        Brightness, CenterCrop, ColorJitter, Contrast, Expand, HFlip, Hue,
        Resize, Saturation)

    def resize():
        return Resize(SIZE, SIZE, device=device)

    return {
        "original": resize(),
        "brightness": Brightness(32, 32) >> resize(),
        "contrast": Contrast(1.5, 1.5) >> resize(),
        "saturation": Saturation(1.5, 1.5, device=device) >> resize(),
        "hue": Hue(18, 18, device=device) >> resize(),
        "hflip": HFlip() >> resize(),
        "expand": Expand(min_expand_ratio=2, max_expand_ratio=2) >> resize(),
        "center_crop": CenterCrop(200, 200) >> resize(),
        "color_jitter": ColorJitter(device=device) >> resize(),
    }


def run(args) -> Dict[str, str]:
    """Each op's JPEG written under ``--output-folder``: ``{name: path}``."""
    from analytics_zoo_tpu_torch.data.native import codec_for, encode_jpeg
    from analytics_zoo_tpu_torch.transform.vision import (BytesToMat,
                                                          ImageFeature)
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    refuse_non_jpeg([args.image])
    with open(args.image, "rb") as f:
        data = f.read()
    codec = codec_for(dev)
    os.makedirs(args.output_folder, exist_ok=True)
    written = {}
    for name, op in make_ops(dev).items():
        feat = BytesToMat(device=dev).transform(
            ImageFeature(data, path=args.image))
        feat = op.transform(feat)
        out = os.path.join(args.output_folder, f"{name}.jpg")
        with open(out, "wb") as f:
            f.write(encode_jpeg(feat.mat.clip(0, 255).astype("uint8"),
                                codec=codec))
        logging.info("wrote %s", out)
        written[name] = out
    return written


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
