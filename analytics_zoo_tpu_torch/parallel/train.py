"""Inference step of the port (counterpart of the serving half of
``parallel/train.py``): ``resolve_compute_dtype`` and ``make_eval_step``.
Training is not ported yet (ROADMAP.md, Queue 1 item 6)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


def resolve_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """'bf16'/'fp32'/None/dtype → torch dtype or None (no casting)."""
    if compute_dtype is None or compute_dtype in ("fp32", "float32"):
        return None
    if compute_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16
    if isinstance(compute_dtype, torch.dtype):
        return None if compute_dtype == torch.float32 else compute_dtype
    raise ValueError(f"unknown compute_dtype {compute_dtype!r}")


def make_eval_step(module: nn.Module, compute_dtype=None) -> Callable:
    """``outputs = eval_step(inputs)``: the module's forward without
    autograd.  ``compute_dtype='bf16'`` runs it under bfloat16 autocast
    (the convolutions in bf16) and casts the outputs back to fp32, whatever
    their structure (SSD's ``(loc, conf)``, DS2's one tensor).  The
    step reads the module's parameters at call time, so a later
    ``load_state_dict`` takes effect."""
    cdtype = resolve_compute_dtype(compute_dtype)

    def eval_step(inputs: torch.Tensor):
        with torch.inference_mode():
            if cdtype is None:
                return module(inputs)
            dev = inputs.device.type
            with torch.autocast(dev, dtype=cdtype):
                out = module(inputs.to(cdtype))
            return _to_float(out)

    return eval_step


def _to_float(out):
    """Cast every floating tensor of an output tree (a tensor, or nested
    tuples, lists and dicts of them) to fp32, keeping its structure."""
    if isinstance(out, torch.Tensor):
        return out.float() if out.is_floating_point() else out
    if isinstance(out, (tuple, list)):
        return type(out)(_to_float(o) for o in out)
    if isinstance(out, dict):
        return {k: _to_float(v) for k, v in out.items()}
    return out
