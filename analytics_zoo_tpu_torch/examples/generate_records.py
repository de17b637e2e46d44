"""Dataset → sharded record files (counterpart of
``examples/generate_records.py``; reference
``common/dataset/RoiImageSeqGenerator.scala:25``): a VOC devkit or a
plain image folder → ``.azr`` shards.

    python -m analytics_zoo_tpu_torch.examples.generate_records \\
        -f /data/VOCdevkit --imageset voc_2007_trainval -o /data/voc/train

Writing records runs on the host.  ``--device`` names the device whose
pipelines will read them (the GPU by default): a plain folder's images
must be JPEGs, which both of the port's codecs decode; another image
(a ``*.png``, which the reference globs too) is refused by name.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     refuse_non_jpeg)

logger = logging.getLogger("analytics_zoo_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate .azr record shards")
    p.add_argument("-f", "--folder", required=True,
                   help="VOCdevkit root (with --imageset) or image folder")
    p.add_argument("-o", "--output", required=True, help="output prefix")
    p.add_argument("-p", "--num-shards", type=int, default=8)
    p.add_argument("--imageset", default=None,
                   help="e.g. voc_2007_trainval (folder = VOCdevkit root)")
    add_device_argument(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from analytics_zoo_tpu_torch.data import SSDByteRecord, write_ssd_records
    from analytics_zoo_tpu_torch.pipelines import get_imdb
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    if args.imageset:
        dataset = get_imdb(args.imageset, args.folder)
        records = list(dataset.load())
    else:
        paths = sorted(
            q for ext in ("*.jpg", "*.jpeg", "*.png")
            for q in glob.glob(os.path.join(args.folder, ext)))
        refuse_non_jpeg(paths)
        records = []
        for path in paths:
            with open(path, "rb") as f:
                records.append(SSDByteRecord(data=f.read(), path=path))
    paths = write_ssd_records(records, args.output, args.num_shards)
    logger.info("wrote %d records into %d shards: %s …", len(records),
                len(paths), paths[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
