"""Dataset registries: Pascal VOC + COCO → SSD records (counterpart of
``pipelines/voc.py``), host code: the ``get_imdb`` name registry, VOC
XML annotation parsing into RoiLabels with the 20-class list, COCO
instances JSON with the 80-class id remap, and ``to_ssd_records`` into
``data.records`` shards.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List

import numpy as np

from analytics_zoo_tpu_torch.data.records import (SSDByteRecord,
                                                  write_ssd_records)
from analytics_zoo_tpu_torch.transform.vision.roi import RoiLabel

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def parse_voc_annotation(xml_path: str,
                         use_difficult: bool = True) -> RoiLabel:
    """One VOC XML file → RoiLabel (pixel corner boxes, 1-based class ids
    into VOC_CLASSES)."""
    root = ET.parse(xml_path).getroot()
    labels, boxes, difficult = [], [], []
    for obj in root.findall("object"):
        name = obj.find("name").text.strip().lower()
        if name not in VOC_CLASSES:
            continue
        diff = int(obj.findtext("difficult", "0"))
        if not use_difficult and diff:
            continue
        bb = obj.find("bndbox")
        boxes.append([float(bb.findtext("xmin")), float(bb.findtext("ymin")),
                      float(bb.findtext("xmax")), float(bb.findtext("ymax"))])
        labels.append(VOC_CLASSES.index(name))
        difficult.append(diff)
    if not boxes:
        return RoiLabel(np.zeros(0), np.zeros((0, 4)), np.zeros(0))
    return RoiLabel(np.asarray(labels), np.asarray(boxes),
                    np.asarray(difficult))


class PascalVoc:
    """VOCdevkit reader: image set files under ``ImageSets/Main/<set>.txt``, annotations under ``Annotations``,
    images under ``JPEGImages``."""

    def __init__(self, devkit_root: str, year: str = "2007",
                 image_set: str = "trainval"):
        self.root = os.path.join(devkit_root, f"VOC{year}")
        self.image_set = image_set
        self.year = year

    @property
    def name(self) -> str:
        return f"voc_{self.year}_{self.image_set}"

    def image_ids(self) -> List[str]:
        path = os.path.join(self.root, "ImageSets", "Main",
                            f"{self.image_set}.txt")
        with open(path) as f:
            return [line.strip().split()[0] for line in f if line.strip()]

    def load(self) -> Iterator[SSDByteRecord]:
        for img_id in self.image_ids():
            img_path = os.path.join(self.root, "JPEGImages", f"{img_id}.jpg")
            ann_path = os.path.join(self.root, "Annotations", f"{img_id}.xml")
            with open(img_path, "rb") as f:
                data = f.read()
            label = parse_voc_annotation(ann_path)
            yield SSDByteRecord(data=data, path=img_path,
                                gt=label.to_gt_matrix())


class Coco:
    """COCO reader from instances json: remaps the sparse COCO category ids onto contiguous 1..80 ids."""

    def __init__(self, image_dir: str, annotation_json: str):
        self.image_dir = image_dir
        self.annotation_json = annotation_json

    def load(self) -> Iterator[SSDByteRecord]:
        with open(self.annotation_json) as f:
            coco = json.load(f)
        cat_ids = sorted(c["id"] for c in coco["categories"])
        remap = {cid: i + 1 for i, cid in enumerate(cat_ids)}  # 1..80
        by_image: Dict[int, List[dict]] = {}
        for ann in coco["annotations"]:
            if ann.get("iscrowd", 0):
                continue
            by_image.setdefault(ann["image_id"], []).append(ann)
        images = {im["id"]: im for im in coco["images"]}
        for img_id, anns in by_image.items():
            im = images[img_id]
            path = os.path.join(self.image_dir, im["file_name"])
            if not os.path.exists(path):
                continue
            rows = []
            for a in anns:
                x, y, w, h = a["bbox"]
                rows.append([remap[a["category_id"]], 0.0,
                             x, y, x + w, y + h])
            with open(path, "rb") as f:
                data = f.read()
            yield SSDByteRecord(
                data=data, path=path,
                gt=np.asarray(rows, np.float32).reshape(-1, 6))


def get_imdb(name: str, root: str):
    """Dataset registry by name, e.g. ``voc_2007_trainval`` /
    ``voc_2012_test``."""
    parts = name.split("_")
    if parts[0] == "voc":
        return PascalVoc(root, year=parts[1], image_set="_".join(parts[2:]))
    if parts[0] == "coco":
        # standard COCO layout: <root>/<set>/ images,
        # <root>/annotations/instances_<set>.json
        subset = "_".join(parts[1:])
        return Coco(os.path.join(root, subset),
                    os.path.join(root, "annotations",
                                 f"instances_{subset}.json"))
    raise ValueError(f"unknown imdb {name!r}")


def to_ssd_records(dataset, prefix: str, num_shards: int = 8) -> List[str]:
    """Materialize a dataset as sharded record files."""
    return write_ssd_records(list(dataset.load()), prefix, num_shards)
