"""What the SSD entry points share: ``--device``, the saved model's
loader, the refusal of images the port's codecs cannot decode, and the
device's name for reports."""

from __future__ import annotations

import argparse
from typing import Sequence

import torch

from analytics_zoo_tpu_torch.utils.device import resolve_device

JPEG_MAGIC = b"\xff\xd8"


def add_device_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the GPU; 'cpu' "
                        "runs the kernels' plain PyTorch versions)")


def device_name(device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def load_ssd_model(path: str, n_classes: int, resolution: int, device):
    """An ``SSDVgg`` in a ``Model`` on ``device`` with the weights of
    ``path``, a ``Model.save`` file (a ``torch.save`` state dict)."""
    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.models import SSDVgg

    dev = resolve_device(device)
    model = Model(SSDVgg(num_classes=n_classes, resolution=resolution,
                         device=dev), device=dev)
    return model.load(path)


def refuse_non_jpeg(paths: Sequence[str]) -> None:
    """Raise, naming them, for the files that are not JPEGs: the port's
    codecs (nvJPEG on the card, libjpeg on the CPU) decode JPEG only and
    never fall back, so such an image would come out as nothing."""
    bad = []
    for path in paths:
        with open(path, "rb") as f:
            if f.read(2) != JPEG_MAGIC:
                bad.append(path)
    if bad:
        raise SystemExit(f"not JPEG, which the port's codecs (nvJPEG on "
                         f"the card, libjpeg on the CPU) cannot decode: "
                         f"{', '.join(bad)}")
