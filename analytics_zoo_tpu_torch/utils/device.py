"""The port's device policy, in one place."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  A CUDA device with no GPU present raises:
    the port never carries on silently on the CPU — the caller asks for
    it with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev


def tensor_device(x, device=None) -> torch.device:
    """Where an entry point taking arrays runs: an explicit ``device``
    wins, else a tensor's own device, else the default policy."""
    if device is not None:
        return resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(None)


def host_constant(array, device) -> torch.Tensor:
    """A host constant (a model's priors, its anchors) as a tensor on
    ``device``, with no host sync: on the card it is copied from pinned
    memory without blocking, where a copy from pageable memory would
    synchronize the program that first asks for it.  The reference's
    constants are embedded in its jitted programs."""
    t = torch.as_tensor(array)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)
