"""Train and eval steps and a one-device ``Optimizer`` (counterpart of
``parallel/train.py``).

``make_train_step`` builds the step the reference jits, here run
eagerly: the module's forward in train mode (under bf16 autocast over
the fp32 parameters when ``compute_dtype="bf16"``, outputs cast back to
fp32 before the criterion), the loss, its gradients by autograd, the
optional global-norm clip, and the optimizer's update, masked when the
loss exceeds ``skip_loss_above``.  Parameters and batch statistics live
in the module and are updated in place; :class:`TrainState` carries the
step count and the optimizer's slots.

Not ported yet, and refused by name: gradient accumulation, fused
device transforms, custom forwards, the health sentinel and sharded
steps (ROADMAP.md Queue 1 items 6, 8, 12 and 13); the ``Optimizer``'s
checkpoints, validation, prefetch, resilience and observability (items
8, 12 and 13).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from analytics_zoo_tpu_torch.parallel.optim import (Adam, OptimMethod,
                                                    TrainingState, Trigger)

logger = logging.getLogger("analytics_zoo_tpu_torch")


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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """What the step carries besides the module: the step count and the
    optimizer's slots (the module holds the parameters and the batch
    statistics, updated in place)."""

    step: int
    opt_state: Dict


def create_train_state(module: nn.Module, optim: OptimMethod) -> TrainState:
    return TrainState(step=0, opt_state=optim.init(
        [p for p in module.parameters() if p.requires_grad]))


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                              f"Queue 1 {item})")


def to_device(batch: Any, device: torch.device) -> Any:
    """A host batch (numpy arrays in dicts, tuples and lists) as tensors
    on ``device``; tensors are moved, other leaves kept."""
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    if isinstance(batch, np.ndarray) or np.isscalar(batch):
        return torch.as_tensor(np.asarray(batch)).to(device,
                                                     non_blocking=True)
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(v, device) for v in batch)
    return batch


def make_train_step(module: nn.Module, criterion: Callable,
                    optim: OptimMethod, *,
                    grad_clip_norm: Optional[float] = None,
                    skip_loss_above: Optional[float] = None,
                    compute_dtype=None, grad_accum: int = 1,
                    device_transform: Optional[Callable] = None,
                    forward_fn: Optional[Callable] = None,
                    health_check: bool = False,
                    metric_fn: Optional[Callable] = None, specs=None,
                    mesh=None) -> Callable:
    """``state, metrics = step(state, batch)`` on the module's device.

    ``batch`` is a dict whose ``"input"`` is the forward's argument (a
    tuple for several, e.g. DS2's ``(features, n_frames)``); numpy leaves
    are moved to the device.  ``criterion(output, batch)`` is the loss.
    ``metrics`` holds ``"loss"`` (a tensor, not read back), ``"lr"`` and
    whatever ``metric_fn(batch)`` returns.
    The step and its parts are ``torch.profiler`` ranges:
    ``train_step`` around ``train_step.forward_loss``,
    ``train_step.backward`` and ``train_step.update``."""
    if grad_accum != 1:
        _not_ported("grad_accum", "item 6")
    if device_transform is not None:
        _not_ported("device_transform", "item 8")
    if forward_fn is not None:
        _not_ported("forward_fn (the sequence-parallel forward)", "item 12")
    if health_check:
        _not_ported("the health sentinel", "item 13")
    if specs is not None or mesh is not None:
        _not_ported("sharded steps (specs, mesh)", "item 12")
    cdtype = resolve_compute_dtype(compute_dtype)
    params = [p for p in module.parameters() if p.requires_grad]

    @record_function("train_step")
    def step(state: TrainState, batch):
        dev = params[0].device
        with record_function("train_step.forward_loss"):
            batch = to_device(batch, dev)
            inputs = batch["input"]
            args = inputs if isinstance(inputs, (tuple, list)) else (inputs,)
            module.train()
            if cdtype is None:
                output = module(*args)
            else:
                with torch.autocast(dev.type, dtype=cdtype):
                    output = module(*args)
                output = _to_float(output)
            loss = criterion(output, batch)
        with record_function("train_step.backward"):
            for p in params:
                p.grad = None
            loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        with torch.no_grad(), record_function("train_step.update"):
            if grad_clip_norm:
                gnorm = torch.sqrt(sum((g.float() * g.float()).sum()
                                       for g in grads))
                scale = torch.clamp(grad_clip_norm / (gnorm + 1e-6), max=1.0)
                grads = [g * scale for g in grads]
            keep = (None if skip_loss_above is None
                    else loss.detach() <= skip_loss_above)
            lr = optim.lr_for_step(state.step)
            optim.update(params, grads, state.opt_state, lr, keep)
        metrics = {"loss": loss.detach(), "lr": lr}
        if metric_fn is not None:
            metrics.update(metric_fn(batch))
        return TrainState(step=state.step + 1,
                          opt_state=state.opt_state), metrics

    return step


class Optimizer:
    """The reference's ``Optimizer`` on one device::

        model = (Optimizer(model, train_set, criterion)
                 .set_optim_method(Adam(lr))
                 .set_end_when(Trigger.max_epoch(n))
                 .optimize())

    ``dataset`` is re-iterated each epoch (a ``data.DataSet`` or any
    iterable of batches).  Each step's metrics are kept in ``history``
    as the step returned them (the loss stays on the device)."""

    def __init__(self, model: nn.Module, dataset, criterion,
                 mesh=None, skip_loss_above: Optional[float] = None,
                 grad_clip_norm: Optional[float] = None, compute_dtype=None,
                 prefetch: int = 0, metric_fn=None, specs=None):
        if prefetch:
            _not_ported("prefetch", "item 8")
        if mesh is not None or specs is not None:
            _not_ported("sharded training (mesh, specs)", "item 12")
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.optim: OptimMethod = Adam(1e-3)
        self.end_when: Trigger = Trigger.max_epoch(1)
        self._step_options = dict(
            skip_loss_above=skip_loss_above, grad_clip_norm=grad_clip_norm,
            compute_dtype=compute_dtype, metric_fn=metric_fn)
        self.history: List[Dict] = []

    def set_optim_method(self, m: OptimMethod) -> "Optimizer":
        self.optim = m
        return self

    def set_end_when(self, t: Trigger) -> "Optimizer":
        self.end_when = t
        return self

    def set_validation(self, *args, **kwargs):
        _not_ported("validation during training", "item 13")

    def set_checkpoint(self, *args, **kwargs):
        _not_ported("checkpointing", "item 12")

    def set_anomaly_policy(self, *args, **kwargs):
        _not_ported("the anomaly sentinel", "item 13")

    def set_observability(self, *args, **kwargs):
        _not_ported("observability", "item 13")

    def optimize(self) -> nn.Module:
        step = make_train_step(self.model, self.criterion, self.optim,
                               **self._step_options)
        state = create_train_state(self.model, self.optim)
        loop = TrainingState()
        t_epoch, records = time.perf_counter(), 0
        while not self.end_when(loop):
            stop = False
            for batch in self.dataset:
                state, metrics = step(state, batch)
                self.history.append(metrics)
                loop.iteration += 1
                loop.loss = metrics["loss"]
                records += _batch_size(batch)
                if self.end_when(loop):
                    stop = True
                    break
            if stop:
                break
            loop.epoch += 1
            loop.loss = float(loop.loss)
            dt = time.perf_counter() - t_epoch
            logger.info("Epoch %d done: %d records in %.1fs (%.1f "
                        "records/s), loss %.4f", loop.epoch, records, dt,
                        records / max(dt, 1e-9), loop.loss)
            t_epoch, records = time.perf_counter(), 0
        self.model.eval()
        return self.model


def _batch_size(batch) -> int:
    x = batch["input"] if isinstance(batch, dict) else batch
    while isinstance(x, (tuple, list)):
        x = x[0]
    return int(x.shape[0])
