"""What the examples share: ``--device`` and DS2's ``--rnn-engine``, the
saved SSD model's loader, the refusal of images the port's codecs cannot
decode, the device's name for reports, the accuracy-report sidecar, and
the process group of a multi-rank example."""

from __future__ import annotations

import argparse
import os
from typing import Dict, Sequence

import torch

from analytics_zoo_tpu_torch.utils.device import resolve_device

JPEG_MAGIC = b"\xff\xd8"


def add_device_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the GPU; 'cpu' "
                        "runs the kernels' plain PyTorch versions)")


def add_rnn_engine_argument(p: argparse.ArgumentParser) -> None:
    """DS2's recurrence engine (``make_ds2_model(rnn_engine=)``): None
    is the blocked loop, as on the reference; ``pallas`` runs the
    persistent-RNN kernels, K3 forward and K4 backward, and raises where
    they do not fit the card."""
    p.add_argument("--rnn-engine", choices=("legacy", "blocked", "pallas"),
                   default=None,
                   help="recurrence engine (default: the blocked loop; "
                        "'pallas' runs the persistent-RNN kernels)")


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


def report_device(device) -> Dict[str, str]:
    """A report's ``backend`` (the torch device type, where the reference
    writes JAX's backend) and ``device`` (the card's name)."""
    dev = torch.device(device)
    return {"backend": dev.type, "device": device_name(dev)}


def append_report(out_path: str, title: str, module: str,
                  report: Dict) -> None:
    """Append ``report`` as a titled JSON block to ``out_path`` (the
    README suggests ``ACCURACY_torch.md``, beside the reference's banked
    ``ACCURACY.md``), stamped with ``python -m <module> <options>``."""
    from analytics_zoo_tpu_torch.utils import report as report_lib

    report_lib.append_report(out_path, title, f"-m {module}", report)


def init_ranks(device):
    """Join this process to its ranks (the ``torchrun`` variables, one
    rank when none is set) and return its device.  Ranks that outnumber
    the cards share them (``LOCAL_RANK`` modulo the cards) over gloo,
    since NCCL refuses two ranks of one communicator on one device."""
    from analytics_zoo_tpu_torch.utils import engine
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", 1))
    backend = local_rank = None
    if dev.type == "cuda" and world > torch.cuda.device_count():
        backend = "gloo"
        local_rank = (int(os.environ.get("LOCAL_RANK", 0))
                      % torch.cuda.device_count())
    engine.init(engine.EngineConfig(device=dev.type, backend=backend,
                                    local_rank=local_rank))
    return engine.device()


def lead_rank() -> bool:
    """True on the rank that prints and writes reports (rank 0, or the
    only process)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0
