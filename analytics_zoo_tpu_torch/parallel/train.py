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

A ``device_transform`` (the SSD device augmentation) runs in the step
after the upload, without autograd; the ``Optimizer``'s ``prefetch``
feeds the step through ``data.prefetch.device_prefetch`` on a CUDA
device.

Not ported yet, and refused by name: custom forwards, the health
sentinel and sharded steps (ROADMAP.md Queue 1 items 12 and 13); the
``Optimizer``'s checkpoints, resilience and observability (items 12 and
13).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from analytics_zoo_tpu_torch.core.criterion import Criterion
from analytics_zoo_tpu_torch.data.prefetch import device_prefetch
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


def _tree_map(fn: Callable, tree):
    """``fn`` on every leaf of nested tuples, lists and dicts, keeping the
    structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor of a tree to ``dtype``; integer tensors
    and other leaves stay as they are."""
    return _tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                     and x.is_floating_point() else x, tree)


def _forward(module: nn.Module, inputs, cdtype: Optional[torch.dtype]):
    """The module on ``inputs`` (a tuple or list is unpacked into its
    arguments).  Under ``cdtype`` the floating inputs are cast to it, the
    forward runs under autocast to it, and the floating outputs come back
    in fp32."""
    args = inputs if isinstance(inputs, (tuple, list)) else (inputs,)
    if cdtype is None:
        return module(*args)
    dev = next(module.parameters()).device
    with torch.autocast(dev.type, dtype=cdtype):
        out = module(*cast_floating(args, cdtype))
    return cast_floating(out, torch.float32)


def make_eval_step(module: nn.Module, compute_dtype=None) -> Callable:
    """``outputs = eval_step(inputs)``: the module's forward without
    autograd.  ``inputs`` is one tensor or a tuple of the forward's
    arguments (DS2's ``(features, n_frames)``).  ``compute_dtype='bf16'``
    runs it under bfloat16 autocast (the convolutions in bf16) with the
    floating inputs cast to bf16 and the outputs cast back to fp32,
    whatever their structure (SSD's ``(loc, conf)``, DS2's one tensor).
    The step reads the module's parameters at call time, so a later
    ``load_state_dict`` takes effect."""
    cdtype = resolve_compute_dtype(compute_dtype)

    def eval_step(inputs):
        with torch.inference_mode():
            return _forward(module, inputs, cdtype)

    return eval_step


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


def _call_criterion(criterion: Callable, output, batch):
    """The criterion protocol: a :class:`Criterion` gets ``(output,
    batch["target"])``, with ``mask=batch["target_mask"]`` when the batch
    has one; any other callable gets ``(output, batch)``."""
    if isinstance(criterion, Criterion):
        target = batch.get("target")
        if "target_mask" in batch:
            return criterion(output, target, mask=batch["target_mask"])
        return criterion(output, target)
    return criterion(output, batch)


def _tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _split_microbatches(batch, n: int) -> List[Any]:
    """``batch`` cut along dim 0 into ``n`` equal microbatches.  Every
    leaf must be a tensor with one common dim 0 divisible by ``n``: a
    leaf that is not batch-major would be cut as if it were."""
    sizes = {leaf.shape[0] if isinstance(leaf, torch.Tensor)
             and leaf.ndim > 0 else None for leaf in _tree_leaves(batch)}
    if None in sizes or len(sizes) != 1:
        raise ValueError(f"grad_accum needs batch-major array leaves with "
                         f"one common dim 0, got leading dims {sizes}")
    (B,) = sizes
    if B % n:
        raise ValueError(f"batch size {B} not divisible by grad_accum={n} "
                         f"(pad or drop_remainder the tail batch)")
    m = B // n
    return [_tree_map(lambda x: x[i * m:(i + 1) * m], batch)
            for i in range(n)]


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
    are moved to the device.  The loss is ``criterion(output,
    batch["target"])`` for a :class:`Criterion` (with ``mask=
    batch["target_mask"]`` when present), else ``criterion(output,
    batch)``; it runs in fp32, outside autocast.  ``grad_accum=N`` cuts the
    batch into N microbatches and steps on the mean of their gradients
    and losses (batch statistics advance once a microbatch).  The
    learning rate is ``optim.lr_for_step(step, optim.lr_scale)``.
    ``metrics`` holds ``"loss"`` (a tensor, not read back), ``"lr"`` and
    whatever ``metric_fn(batch)`` returns.  ``device_transform(batch)``
    (e.g. ``transform.vision.make_device_augment``'s) rewrites the
    uploaded batch, without autograd, before the forward.
    The step and its parts are ``torch.profiler`` ranges:
    ``train_step`` around ``train_step.upload`` (the batch to the device;
    a prefetched batch is there already), ``train_step.device_transform``,
    then ``train_step.forward_loss`` and ``train_step.backward`` once a
    microbatch, and ``train_step.update``."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum} must be >= 1")
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
        with record_function("train_step.upload"):
            batch = to_device(batch, dev)
        if device_transform is not None:
            with torch.no_grad(), record_function(
                    "train_step.device_transform"):
                batch = device_transform(batch)
        micro = ([batch] if grad_accum == 1
                 else _split_microbatches(batch, grad_accum))
        for p in params:
            p.grad = None
        losses = []
        for mb in micro:
            with record_function("train_step.forward_loss"):
                module.train()
                loss = _call_criterion(
                    criterion, _forward(module, mb["input"], cdtype), mb)
            with record_function("train_step.backward"):
                loss.backward()
            losses.append(loss.detach())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        with torch.no_grad(), record_function("train_step.update"):
            loss = losses[0]
            if grad_accum > 1:
                inv = 1.0 / grad_accum
                grads = [g * inv for g in grads]
                loss = sum(losses[1:], losses[0]) * inv
            if grad_clip_norm:
                gnorm = torch.sqrt(sum((g.float() * g.float()).sum()
                                       for g in grads))
                scale = torch.clamp(grad_clip_norm / (gnorm + 1e-6), max=1.0)
                grads = [g * scale for g in grads]
            keep = (None if skip_loss_above is None
                    else loss <= skip_loss_above)
            lr = optim.lr_for_step(state.step, optim.lr_scale)
            optim.update(params, grads, state.opt_state, lr, keep)
        metrics = {"loss": loss, "lr": lr}
        if metric_fn is not None:
            metrics.update(metric_fn(batch))
        return TrainState(step=state.step + 1,
                          opt_state=state.opt_state), metrics

    return step


# ---------------------------------------------------------------------------
# Validation methods
# ---------------------------------------------------------------------------


class ValidationResult:
    """A mergeable metric (a monoid under ``+``): ``value / count``."""

    def __init__(self, value: float, count: float, name: str):
        self.value = value
        self.count = count
        self.name = name

    def __add__(self, other: "ValidationResult") -> "ValidationResult":
        return ValidationResult(self.value + other.value,
                                self.count + other.count, self.name)

    def result(self) -> float:
        return self.value / max(self.count, 1e-12)

    def __repr__(self):
        return f"{self.name}: {self.result():.6f} ({int(self.count)} samples)"


class ValidationMethod:
    """``method(output, batch)`` → a mergeable result with ``name`` and
    ``result()`` (e.g. ``pipelines.ssd.SSDMeanAveragePrecision``)."""

    name = "validation"

    def __call__(self, output, batch):  # pragma: no cover - interface
        raise NotImplementedError


def validate(module: nn.Module, dataset, methods: Sequence[Callable],
             eval_step: Optional[Callable] = None) -> List[Any]:
    """Forward a dataset's ``"input"`` on the module's device and merge
    each method's per-batch results (reference ``Validator.test``)."""
    eval_step = eval_step or make_eval_step(module)
    dev = next(module.parameters()).device
    totals: List[Any] = [None] * len(methods)
    for batch in dataset:
        out = eval_step(to_device(batch["input"], dev))
        for i, m in enumerate(methods):
            r = m(out, batch)
            totals[i] = r if totals[i] is None else totals[i] + r
    return [t for t in totals if t is not None]


class Optimizer:
    """The reference's ``Optimizer`` on one device::

        model = (Optimizer(model, train_set, criterion)
                 .set_optim_method(SGD(lr, momentum=0.9, plateau=...))
                 .set_validation(Trigger.every_epoch(), val_set, [method])
                 .set_end_when(Trigger.max_epoch(n))
                 .optimize())

    ``dataset`` is re-iterated each epoch (a ``data.DataSet`` or any
    iterable of batches).  Each step's metrics are kept in ``history``
    as the step returned them (the loss stays on the device); each
    validation's results in ``val_history``.  Validation runs where its
    trigger fires after a step or at an epoch's end (once an iteration),
    with the model in eval mode, and its score (the first method's,
    unless ``score_name`` says) becomes ``loop.score`` and goes to
    ``optim.on_validation`` (Plateau).

    ``prefetch=N`` on a CUDA model feeds the step through
    ``data.prefetch.device_prefetch``: a thread pins the next N batches
    and uploads them on a side stream while the step runs, closing the
    epoch's host iterator (a multiprocess loader's workers) when the
    epoch ends or stops early.  Pinned memory and a copy stream need a
    card: on a CPU model ``prefetch`` does nothing and the step takes the
    batches as they come.  ``device_transform`` goes to the step."""

    def __init__(self, model: nn.Module, dataset, criterion,
                 mesh=None, skip_loss_above: Optional[float] = None,
                 grad_clip_norm: Optional[float] = None, compute_dtype=None,
                 prefetch: int = 0, grad_accum: int = 1, metric_fn=None,
                 specs=None, device_transform: Optional[Callable] = None):
        if prefetch < 0:
            raise ValueError(f"prefetch={prefetch} must be >= 0")
        if mesh is not None or specs is not None:
            _not_ported("sharded training (mesh, specs)", "item 12")
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.compute_dtype = compute_dtype
        self.prefetch = prefetch
        self.optim: OptimMethod = Adam(1e-3)
        self.end_when: Trigger = Trigger.max_epoch(1)
        self.val_trigger: Optional[Trigger] = None
        self.val_dataset = None
        self.val_methods: Sequence[Callable] = ()
        self._score_name: Optional[str] = None
        self._step_options = dict(
            skip_loss_above=skip_loss_above, grad_clip_norm=grad_clip_norm,
            compute_dtype=compute_dtype, grad_accum=grad_accum,
            metric_fn=metric_fn, device_transform=device_transform)
        self.history: List[Dict] = []
        self.val_history: List[Dict] = []

    def set_optim_method(self, m: OptimMethod) -> "Optimizer":
        self.optim = m
        return self

    def set_end_when(self, t: Trigger) -> "Optimizer":
        self.end_when = t
        return self

    def set_validation(self, trigger: Trigger, dataset,
                       methods: Sequence[Callable],
                       score_name: Optional[str] = None) -> "Optimizer":
        self.val_trigger = trigger
        self.val_dataset = dataset
        self.val_methods = list(methods)
        self._score_name = score_name or (methods[0].name if methods
                                          else None)
        return self

    def set_checkpoint(self, *args, **kwargs):
        _not_ported("checkpointing", "item 12")

    def set_anomaly_policy(self, *args, **kwargs):
        _not_ported("the anomaly sentinel", "item 13")

    def set_observability(self, *args, **kwargs):
        _not_ported("observability", "item 13")

    def optimize(self) -> nn.Module:
        step = make_train_step(self.model, self.criterion, self.optim,
                               **self._step_options)
        eval_step = make_eval_step(self.model,
                                   compute_dtype=self.compute_dtype)
        state = create_train_state(self.model, self.optim)
        loop = TrainingState()
        self._last_val_iter = None
        t_epoch, records = time.perf_counter(), 0
        dev = next(self.model.parameters()).device
        while not self.end_when(loop):
            stop = False
            loop.epoch_finished = False
            host_iter = iter(self.dataset)
            # close_source: the prefetch thread closes host_iter itself
            batches = (device_prefetch(host_iter, dev, self.prefetch,
                                       close_source=True)
                       if self.prefetch and dev.type == "cuda"
                       else host_iter)
            try:
                for batch in batches:
                    state, metrics = step(state, batch)
                    self.history.append(metrics)
                    loop.iteration += 1
                    loop.loss = metrics["loss"]
                    records += _batch_size(batch)
                    self._maybe_validate(loop, eval_step)
                    if self.end_when(loop):
                        stop = True
                        break
            finally:
                if hasattr(batches, "close"):
                    batches.close()
            if stop:
                break
            loop.epoch += 1
            loop.epoch_finished = True
            loop.loss = float(loop.loss)
            dt = time.perf_counter() - t_epoch
            logger.info("Epoch %d done: %d records in %.1fs (%.1f "
                        "records/s), loss %.4f", loop.epoch, records, dt,
                        records / max(dt, 1e-9), loop.loss)
            t_epoch, records = time.perf_counter(), 0
            self._maybe_validate(loop, eval_step)
        self.model.eval()
        return self.model

    def _maybe_validate(self, loop: TrainingState, eval_step) -> None:
        if self.val_trigger is None or not self.val_trigger(loop):
            return
        # an iteration trigger still fires at the epoch's end: validate an
        # iteration once, so Plateau counts it once
        if self._last_val_iter == loop.iteration:
            return
        self._last_val_iter = loop.iteration
        self.model.eval()
        try:
            results = validate(self.model, self.val_dataset,
                               self.val_methods, eval_step=eval_step)
        finally:
            self.model.train()
        metrics = {r.name: r.result() for r in results}
        for name, value in metrics.items():
            logger.info("Validation @ iter %d: %s = %.5f", loop.iteration,
                        name, value)
        self.val_history.append({"iteration": loop.iteration, **metrics})
        if self._score_name and self._score_name in metrics:
            loop.score = metrics[self._score_name]
            self.optim.on_validation({"score": loop.score, **metrics})


def _batch_size(batch) -> int:
    """Dim 0 of the batch's ``"input"``, else of its first array leaf (a
    staged device-augmentation batch has no ``"input"`` yet)."""
    x = batch["input"] if isinstance(batch, dict) and "input" in batch \
        else batch
    return int(_tree_leaves(x)[0].shape[0])
