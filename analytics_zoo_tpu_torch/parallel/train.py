"""Train and eval steps and the ``Optimizer``, on one device or over a
mesh of ranks (counterpart of ``parallel/train.py``).

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

A ``forward_fn(module, inputs, train)`` replaces the module's own call
in the step (Faster-RCNN's training forward, ``pipelines/frcnn.py``), and
``Optimizer.set_epoch_hook`` runs a function after each epoch.

The ``Optimizer`` checkpoints and resumes (``set_checkpoint``,
``set_resume``; ``parallel/checkpoint.py``): a snapshot holds the
module's ``state_dict()`` (parameters and batch statistics), the
``TrainState``'s step and optimizer slots, and in its manifest the loop
position and the optim method's host state (Plateau).  A resumed run
skips the interrupted epoch's trained batches on the host iterator and
repeats no step.  ``set_preemption_handler``, ``set_stall_watchdog`` and
``set_failure_detector`` arm the resilience layer; ``parallel/elastic.py``
supervises restarts.

Over a mesh (``mesh=``, ``specs=``, ``param_rules=``; ``parallel/
specs.py``) every rank runs the same loop on the same global batches and
trains on its rows: the step averages the gradients over the ``data``
axis, the criteria and batch norms see the global batch
(``utils/spmd.py::global_batch``), validation merges the ranks'
results batch by batch, and rank 0 writes a snapshot gathered whole.

``Optimizer.set_anomaly_policy`` arms the anomaly ladder
(``resilience/anomaly.py``): the step's health word, the in-step skip,
rollback to the last-known-good snapshot with a re-seek of the stream,
``TrainingDiverged`` when the rollbacks are spent, and a forensics
bundle an episode.  ``set_observability`` arms the telemetry spine
(``obs/``): a span a step at the loader's coordinates, checkpoint save
and restore spans, ``train/dispatch/*`` and ``train/anomaly/*``
metrics, and the flight recorder's dump on ``TrainingDiverged`` and on
preemption.  ``set_train_summary``/``set_validation_summary`` write
TensorBoard event files (``parallel/summary.py``).

``Optimizer.set_health_policy`` arms the device-health sentinel
(``resilience/health.py``): every ``audit_every`` steps each rank folds
its parameters into one word and the ranks' words are compared (a
minority rank raises ``DeviceQuarantine`` on every rank, an ambiguous
split ``SdcDetected``); every ``shadow_every`` steps the ranks recompute
one microbatch's forward and compare its fingerprints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from analytics_zoo_tpu_torch.core.criterion import Criterion
from analytics_zoo_tpu_torch.data.prefetch import device_prefetch
from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib
from analytics_zoo_tpu_torch.parallel.optim import (Adam, OptimMethod,
                                                    TrainingState, Trigger,
                                                    _assign)
from analytics_zoo_tpu_torch.resilience.errors import (CheckpointCorrupt,
                                                       Preempted, StallError,
                                                       TrainingDiverged)
from analytics_zoo_tpu_torch.utils import spmd

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


def _forward(module: nn.Module, inputs, cdtype: Optional[torch.dtype],
             forward_fn: Optional[Callable] = None, train: bool = False):
    """The module on ``inputs`` (a tuple or list is unpacked into its
    arguments), or ``forward_fn(module, inputs, train)`` when given.
    Under ``cdtype`` the floating inputs are cast to it, the forward runs
    under autocast to it, and the floating outputs come back in fp32."""
    def run(x):
        if forward_fn is not None:
            return forward_fn(module, x, train)
        return module(*(x if isinstance(x, (tuple, list)) else (x,)))

    if cdtype is None:
        return run(inputs)
    dev = next(module.parameters()).device
    with torch.autocast(dev.type, dtype=cdtype):
        out = run(cast_floating(inputs, cdtype))
    return cast_floating(out, torch.float32)


def make_eval_step(module: nn.Module, compute_dtype=None,
                   specs=None) -> Callable:
    """``outputs = eval_step(inputs)``: the module's forward without
    autograd.  ``inputs`` is one tensor or a tuple of the forward's
    arguments (DS2's ``(features, n_frames)``).  ``compute_dtype='bf16'``
    runs it under bfloat16 autocast (the convolutions in bf16) with the
    floating inputs cast to bf16 and the outputs cast back to fp32,
    whatever their structure (SSD's ``(loc, conf)``, DS2's one tensor).
    The step reads the module's parameters at call time, so a later
    ``load_state_dict`` takes effect.

    ``specs`` (a ``SpecSet``, the module placed by its ``place_state``):
    the global batch's rows are cut over the ``data`` axis, each rank
    runs its own, and the outputs are all-gathered back whole on every
    rank; a batch whose dim 0 does not divide the data width runs whole
    on every rank (``SpecSet.ragged_dispatch``).  Every rank calls it.
    Under a spatial declaration (``SpecSet.row_axis``) a rank also keeps
    its block of the image rows, and the forward runs in the
    declaration's ``row_scope``."""
    cdtype = resolve_compute_dtype(compute_dtype)

    def eval_step(inputs):
        with torch.inference_mode():
            return _forward(module, inputs, cdtype)

    return eval_step if specs is None else specs.row_sharded(eval_step)


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
                    skip_unhealthy: bool = False,
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
    microbatch, and ``train_step.update``.

    ``forward_fn(module, inputs, train)`` (``train`` is True here)
    replaces ``module(*inputs)``: it gets the batch's ``"input"`` as it
    is, under the same casts, autocast and ranges, and returns the
    criterion's output.

    ``specs`` (a ``parallel.specs.SpecSet``; ``mesh=`` builds a
    data-parallel one), with the module placed by ``specs.place_state``:
    every rank runs the step on the same global batch and keeps its rows
    (its share of each of the ``grad_accum`` microbatches, so a
    microbatch is the one-device step's; ``step(state, batch,
    placed=True)`` takes them already cut); the
    forward and loss run in ``spmd.global_batch``, so counts and batch
    statistics are the global batch's; the gradients are averaged over
    the ``data`` axis in one flat all-reduce (a shard over its data
    ranks); the loss that ``skip_loss_above`` and the metrics see is the
    global one, and the clip norm is global (a shard's sum of squares
    summed over its axis, a replicated parameter counted once).  The
    range ``train_step.all_reduce`` holds the gradient all-reduce, after
    which each parameter's ``.grad`` is the averaged gradient.  Under a
    spatial declaration (``specs.row_axis``: the image rows over
    ``model``) the forward runs in ``specs.row_scope()``, and a rank's
    gradients, its rows' share, are first summed over the rows' axis.

    ``health_check=True`` adds the anomaly sentinel's health word
    (``resilience/anomaly.py``) as ``metrics["health"]``: an int32 tensor
    on the device, never read back here, folding the finiteness of the
    loss, the (clipped) gradients and the updated parameters, with a bit
    a parameter section, and ``skip_loss_above`` as its spike bit.  The
    update is then computed whole before any of it is written (one extra
    copy of the parameters and slots), so that the word can cover the
    updated parameters.  ``skip_unhealthy=True`` keeps the parameters,
    the optimizer's slots and the module's buffers (batch statistics,
    ``num_batches_tracked``) bit-equal to their pre-step values whenever
    the word is not 0; the buffers are copied before the forward for
    that.  Over a mesh the word is OR-ed over the ranks (range
    ``train_step.health``)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum} must be >= 1")
    if specs is None and mesh is not None:
        from analytics_zoo_tpu_torch.parallel.specs import SpecSet
        specs = SpecSet(mesh)
    cdtype = resolve_compute_dtype(compute_dtype)
    params = [p for p in module.parameters() if p.requires_grad]
    width = specs.data_axis_size if specs is not None else 1
    data_group = specs.data_group() if specs is not None else None
    index = (mesh_lib.axis_index(specs.mesh, mesh_lib.data_axis(specs.mesh))
             if specs is not None else 0)

    row_group = specs.row_group() if specs is not None else None
    grad_group, row_width = data_group, 1
    if row_group is not None:
        # each rank's gradient is its rows' share and the rows' ranks
        # hold one loss: one sum over the whole mesh, divided by the data
        # width, averages over data what the rows' ranks sum
        row_width = mesh_lib.axis_size(specs.mesh, specs.row_axis)
        if width * row_width != torch.distributed.get_world_size():
            raise ValueError(
                f"a row cut over {specs.row_axis!r} takes a mesh of the "
                f"data and the rows' axes alone, over every rank; got "
                f"axes {mesh_lib.axis_names(specs.mesh)}")
        grad_group = torch.distributed.group.WORLD

    @contextlib.contextmanager
    def scoped():
        with spmd.global_batch(data_group, width, index), (
                specs.row_scope() if specs is not None
                else contextlib.nullcontext()):
            yield

    health = health_check or skip_unhealthy
    if health:
        from analytics_zoo_tpu_torch.resilience import anomaly
        sections, groups = anomaly.section_groups(module)
        param_index = {id(p): i for i, p in enumerate(params)}
        buffers = list(module.buffers()) if skip_unhealthy else []

    def checked_update(state: TrainState, grads, loss, lr):
        """Compute the whole update, fold the health word over it, then
        commit it (masked by the word under ``skip_unhealthy``)."""
        pairs = list(optim.step_values(params, grads, state.opt_state, lr))
        new_params: List[Any] = [None] * len(params)
        for dst, new in pairs:
            i = param_index.get(id(dst))
            if i is not None:
                new_params[i] = new
        with record_function("train_step.health"):
            word = anomaly.tree_health_word(
                loss,
                {s: [grads[i] for i in g] for s, g in zip(sections, groups)},
                {s: [new_params[i] for i in g]
                 for s, g in zip(sections, groups)},
                sections, spike_loss_above=skip_loss_above)
            if specs is not None and torch.distributed.is_initialized():
                word = anomaly.word_over_ranks(
                    word, group=mesh_lib.mesh_group(specs.mesh))
        if skip_unhealthy:
            keep = word == 0
        else:
            keep = (None if skip_loss_above is None
                    else loss <= skip_loss_above)
        for dst, new in pairs:
            _assign(dst, new, keep)
        return word, keep

    @record_function("train_step")
    def step(state: TrainState, batch, placed: bool = False):
        dev = params[0].device
        # the forward updates the batch statistics in place before the
        # word is known: keep their pre-step values to restore
        before = ([b.detach().clone() for b in buffers] if skip_unhealthy
                  else [])
        if specs is not None and not placed:
            batch = specs.place_batch(batch, microbatches=grad_accum)
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
            with record_function("train_step.forward_loss"), scoped():
                module.train()
                loss = _call_criterion(
                    criterion, _forward(module, mb["input"], cdtype,
                                        forward_fn, train=True), mb)
            with record_function("train_step.backward"), scoped():
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
            if grad_group is not None:
                with record_function("train_step.all_reduce"):
                    grads, loss = _average_over(grads, loss / row_width,
                                                grad_group, width)
                # each .grad then holds the gradient the update uses
                for p, g in zip(params, grads):
                    p.grad = g
            if grad_clip_norm:
                gnorm = torch.sqrt(_global_sq_norm(params, grads))
                scale = torch.clamp(grad_clip_norm / (gnorm + 1e-6), max=1.0)
                grads = [g * scale for g in grads]
            lr = optim.lr_for_step(state.step, optim.lr_scale)
            word = None
            if health:
                word, keep = checked_update(state, grads, loss, lr)
                for b, old in zip(buffers, before):
                    b.copy_(torch.where(keep, b, old))
            else:
                keep = (None if skip_loss_above is None
                        else loss <= skip_loss_above)
                optim.update(params, grads, state.opt_state, lr, keep)
        metrics = {"loss": loss, "lr": lr}
        if metric_fn is not None:
            metrics.update(metric_fn(batch))
        if word is not None:
            metrics["health"] = word
        return TrainState(step=state.step + 1,
                          opt_state=state.opt_state), metrics

    return step


def _average_over(grads: List[torch.Tensor], loss: torch.Tensor, group,
                  width: int):
    """The gradients and the loss averaged over ``group``'s ``width``
    ranks, in one flat fp32 all-reduce."""
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [loss.reshape(1).float()])
    torch.distributed.all_reduce(flat, group=group)
    flat /= width
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g).to(g.dtype))
        i += g.numel()
    return out, flat[i].to(loss.dtype)


def _global_sq_norm(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of squares of the whole gradient: a shard's sum summed over
    its axis, a replicated gradient counted once."""
    total = sum((g.float() * g.float()).sum() for p, g in zip(params, grads)
                if not tensor_lib.is_sharded(p))
    by_group: Dict[Any, torch.Tensor] = {}
    for p, g in zip(params, grads):
        if tensor_lib.is_sharded(p):
            key = tensor_lib.shard_of(p).ctx.group
            by_group[key] = by_group.get(key, 0.0) + (g.float() ** 2).sum()
    for group, sq in by_group.items():
        if group is not None:
            sq = sq.clone()
            torch.distributed.all_reduce(sq, group=group)
        total = total + sq
    return torch.as_tensor(total)


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


def _argmax_host(output) -> np.ndarray:
    return torch.as_tensor(output).argmax(-1).reshape(-1).cpu().numpy()


class Top1Accuracy(ValidationMethod):
    """Share of rows whose argmax is the target, weighted by
    ``batch["target_mask"]`` when the batch has one."""

    name = "Top1Accuracy"

    def __call__(self, output, batch):
        target = np.asarray(batch["target"]).reshape(-1)
        pred = _argmax_host(output)
        mask = np.asarray(batch.get("target_mask", np.ones_like(target))
                          ).reshape(-1)
        correct = float(np.sum((pred == target) * mask))
        return ValidationResult(correct, float(mask.sum()), self.name)


class Loss(ValidationMethod):
    """The criterion's mean loss, weighted by the batch's rows."""

    name = "Loss"

    def __init__(self, criterion):
        self.criterion = criterion

    def __call__(self, output, batch):
        n = np.asarray(batch["target"]).shape[0]
        with torch.no_grad():
            loss = float(_call_criterion(self.criterion, output,
                                         to_device(batch, output.device)))
        return ValidationResult(loss * n, n, self.name)


class MAE(ValidationMethod):
    """Mean absolute error of the argmax class against the target (the
    recommender's validation metric over 5 rating classes)."""

    name = "MAE"

    def __call__(self, output, batch):
        target = np.asarray(batch["target"]).reshape(-1).astype(np.float32)
        pred = _argmax_host(output).astype(np.float32)
        return ValidationResult(float(np.abs(pred - target).sum()),
                                target.size, self.name)


def sparse_adam_apply(table: torch.Tensor, mu: torch.Tensor,
                      nu: torch.Tensor, count: torch.Tensor, grad,
                      learning_rate: float, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8):
    """Row-sparse (lazy) Adam: update only the rows a batch touched and
    their slots, with :class:`~analytics_zoo_tpu_torch.parallel.optim.Adam`'s
    arithmetic (optax's ``scale_by_adam``: the moments, the bias
    correction at ``count + 1``, ``eps`` outside the square root, the
    step ``p + (-lr) * u``), so touched rows equal a dense Adam step's.
    Untouched rows keep their values and their stale moments.

    ``grad`` is an ``ops.embedding.SparseRows``; its padded tail (past
    ``count``) is masked out, so it never reaches row 0 (the reference
    sends it out of bounds, where a JAX scatter drops it; a torch scatter
    would raise).  Returns new ``(table, mu, nu, count)``."""
    n = int(grad.count)
    ids, g = grad.ids[:n], grad.rows[:n]
    new_count = count + 1
    c = new_count.float()
    m = (1.0 - b1) * g + b1 * mu[ids]
    v = (1.0 - b2) * (g * g) + b2 * nu[ids]
    u = (m / (1.0 - b1 ** c)) / (torch.sqrt(v / (1.0 - b2 ** c)) + eps)
    rows = table[ids] + (-learning_rate) * u
    return (table.index_copy(0, ids, rows.to(table.dtype)),
            mu.index_copy(0, ids, m.to(mu.dtype)),
            nu.index_copy(0, ids, v.to(nu.dtype)), new_count)


def validate(module: nn.Module, dataset, methods: Sequence[Callable],
             eval_step: Optional[Callable] = None, specs=None) -> List[Any]:
    """Forward a dataset's ``"input"`` on the module's device and merge
    each method's per-batch results (reference ``Validator.test``).

    With ``specs`` over a data axis wider than 1, each rank forwards its
    rows of a batch (``eval_step`` is then the plain one) and the ranks'
    results of that batch are merged in rank order, which is the batch's
    row order, so every rank holds the one global score.  A batch whose
    dim 0 does not divide the data width runs whole on every rank.
    Under a spatial declaration each rank also keeps its block of the
    rows, and the forward runs in ``specs.row_scope()``: a data
    coordinate's results count once, whatever the ranks along ``model``."""
    eval_step = eval_step or make_eval_step(module)
    dev = next(module.parameters()).device
    width = specs.data_axis_size if specs is not None else 1
    group = specs.data_group() if width > 1 else None
    totals: List[Any] = [None] * len(methods)
    for batch in dataset:
        rows = _batch_size(batch)
        placed = (specs is not None and rows % width == 0
                  and (group is not None or specs.row_group() is not None))
        split = placed and group is not None
        scope = contextlib.nullcontext()
        if placed:
            batch = specs.place_batch(batch)
            scope = specs.row_scope()
        with scope:
            out = eval_step(to_device(batch["input"], dev))
        results = [m(out, batch) for m in methods]
        for rank_results in (mesh_lib.merge_over(results, group) if split
                             else [results]):
            for i, r in enumerate(rank_results):
                totals[i] = r if totals[i] is None else totals[i] + r
    return [t for t in totals if t is not None]


class Optimizer:
    """The reference's ``Optimizer``, on one device or over a mesh::

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
    batches as they come.  ``device_transform`` and ``forward_fn`` go to
    the step; ``set_epoch_hook(fn)`` calls ``fn(loop, state)`` after each
    completed epoch, after its validation and checkpoint.

    Each step and epoch boundary runs, in order: validation, the
    checkpoint, the stall check, the preemption check (one place, so the
    two boundaries cannot drift apart).

    ``mesh=`` (with ``param_rules=``) or ``specs=`` trains over the ranks
    of a mesh: every rank builds the same ``Optimizer`` over the same
    dataset of global batches (or of its own slices: a dataset with
    ``yields_local_slices``, ``data.parallel.make_input_pipeline``),
    ``optimize`` places the module (``SpecSet.place_state``) and each rank
    trains on its rows; a snapshot's ``world_width`` is the data width."""

    def __init__(self, model: nn.Module, dataset, criterion,
                 mesh=None, skip_loss_above: Optional[float] = None,
                 grad_clip_norm: Optional[float] = None, compute_dtype=None,
                 prefetch: int = 0, grad_accum: int = 1, metric_fn=None,
                 specs=None, device_transform: Optional[Callable] = None,
                 forward_fn: Optional[Callable] = None, param_rules=None):
        if prefetch < 0:
            raise ValueError(f"prefetch={prefetch} must be >= 0")
        if specs is not None:
            if mesh is not None and mesh is not specs.mesh:
                raise ValueError("pass mesh= OR specs= (the SpecSet "
                                 "carries its mesh), not conflicting both")
            if param_rules is not None:
                raise ValueError("param_rules is the sugar for building a "
                                 "SpecSet — declare it inside specs= "
                                 "instead")
        elif mesh is not None or param_rules is not None:
            from analytics_zoo_tpu_torch.parallel.specs import SpecSet
            specs = SpecSet(mesh if mesh is not None
                            else mesh_lib.create_mesh(), rules=param_rules)
        self.specs = specs
        self.mesh = specs.mesh if specs is not None else None
        self.param_rules = specs.rules if specs is not None else None
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
            metric_fn=metric_fn, device_transform=device_transform,
            forward_fn=forward_fn, specs=specs)
        self.epoch_hook: Optional[Callable] = None
        self.history: List[Dict] = []
        self.val_history: List[Dict] = []
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.overwrite_checkpoint = True
        self.checkpoint_keep_last: Optional[int] = None
        self.resume_path: Optional[str] = None
        self._resume_requested = False
        self.failure_detector = None
        self.preemption_handler = None
        self.stall_watchdog = None
        self.anomaly_policy = None
        self._anomaly = None        # AnomalySentinel, built per optimize()
        self.health_policy = None
        self._health = None         # HealthSentinel, built per optimize()
        self._audit_fn = None       # the parity audit, built lazily
        self._shadow_fn = None      # the shadow forward, built lazily
        self.obs = None             # obs.Observability
        self.train_summary = None
        self.val_summary = None
        self._skip_batches = 0          # mid-epoch resume fast-forward
        self._skip_samples: Optional[int] = None
        self._iter_in_epoch = 0
        self._samples_in_epoch = 0
        self._last_ckpt_iter: Optional[int] = None
        self._last_state: Optional[TrainState] = None

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

    def set_epoch_hook(self, fn: Callable) -> "Optimizer":
        """``fn(loop, state)`` after each completed epoch, after its
        validation (the ``TrainingState`` and the step's ``TrainState``;
        the module holds the live parameters)."""
        self.epoch_hook = fn
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       overwrite: bool = True,
                       keep_last: Optional[int] = None) -> "Optimizer":
        """``overwrite=True`` keeps one ``latest`` snapshot; ``False``
        publishes ``step_N`` snapshots, with ``keep_last=N`` retention
        (older snapshots are the fallbacks when the newest is corrupt)."""
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        self.overwrite_checkpoint = overwrite
        self.checkpoint_keep_last = keep_last
        return self

    def set_resume(self, path: Optional[str] = None) -> "Optimizer":
        """Resume from the newest intact checkpoint under ``path`` (the
        ``set_checkpoint`` path by default, resolved at ``optimize()``
        time, so the order of the calls does not matter) when one
        exists."""
        self.resume_path = path
        self._resume_requested = True
        return self

    def set_preemption_handler(self, handler=None) -> "Optimizer":
        """Trap SIGTERM during ``optimize()``: the loop finishes the step
        in flight, takes a forced checkpoint at the boundary and raises
        the retryable ``Preempted``."""
        from analytics_zoo_tpu_torch.resilience.preempt import (
            PreemptionHandler)
        self.preemption_handler = handler or PreemptionHandler()
        return self

    def set_stall_watchdog(self, watchdog) -> "Optimizer":
        """Raise ``StallError`` instead of hanging when the loop makes no
        progress within a deadline: a ``StallWatchdog`` or a timeout in
        seconds.  The heartbeat is per phase (step, validation,
        checkpoint save): size it for the slowest single phase, the
        first step's kernel builds and a full snapshot write included."""
        from analytics_zoo_tpu_torch.resilience.watchdog import StallWatchdog
        if not hasattr(watchdog, "beat"):
            watchdog = StallWatchdog(float(watchdog))
        self.stall_watchdog = watchdog
        return self

    def set_failure_detector(self, detector) -> "Optimizer":
        """A periodic loss-health check
        (``parallel.elastic.DivergenceDetector``); raises out of
        ``optimize()``.  Not consulted while an anomaly policy is armed:
        the sentinel discards bad steps, and the detector would read a
        discarded step's NaN loss and raise before the ladder could roll
        back."""
        self.failure_detector = detector
        return self

    def set_anomaly_policy(self, policy=None) -> "Optimizer":
        """Arm the anomaly ladder (``resilience.anomaly``): the step folds
        a health word over the loss, the gradients and the updated
        parameters, an unhealthy step is discarded in the step, and the
        host escalates: skip → rollback to the last-known-good snapshot
        (and a re-seek of the stream past the bad batches) →
        ``TrainingDiverged`` after ``max_rollbacks``.  A forensics bundle
        (``anomaly_<step>.json``) is written on each episode's first bad
        step.  A rollback needs ``set_checkpoint`` for the ``lkg`` slot.
        Costs one device-to-host read a step: the word and the loss
        together."""
        from analytics_zoo_tpu_torch.resilience.anomaly import AnomalyPolicy
        self.anomaly_policy = policy or AnomalyPolicy()
        return self

    def set_health_policy(self, policy=None) -> "Optimizer":
        """Arm the device-health sentinel (``resilience.health``): every
        ``audit_every`` steps the ranks' parameter fingerprints are
        compared (data-parallel ranks hold bit-identical parameters after
        the gradient all-reduce, so a divergence proves silent data
        corruption and the minority names the device); every
        ``shadow_every`` steps the ranks recompute one microbatch's
        forward and compare its fingerprints (a third rank breaks a tie).
        A named suspect raises the retryable ``DeviceQuarantine`` on
        every rank (pair with ``set_anomaly_policy`` and
        ``set_checkpoint``, so that the survivors resume from the
        last-known-good tier: ``parallel.elastic.
        resume_after_quarantine``); an unattributable divergence raises
        the fatal ``SdcDetected``.  The default policy audits every 8
        steps."""
        from analytics_zoo_tpu_torch.resilience.health import HealthPolicy
        self.health_policy = policy or HealthPolicy(audit_every=8)
        return self

    def set_observability(self, obs=None) -> "Optimizer":
        """Arm the telemetry spine (:class:`analytics_zoo_tpu_torch.obs.
        Observability`; ``None`` builds one): a ``train_step`` span a step
        under trace ``train-e<epoch>-b<batch>`` (the loader's
        coordinates), ``checkpoint_save``/``checkpoint_restore`` spans,
        the ``train/dispatch/*`` metrics of a
        :class:`~analytics_zoo_tpu_torch.utils.profiling.StepTimer`, the
        anomaly ladder's counters, and the flight recorder's dump to
        ``obs.dump_path`` on ``TrainingDiverged`` and on preemption.

        The step span and ``train/dispatch/step_s`` cover the host
        interval of the step call: CUDA launches are asynchronous, so
        without the anomaly sentinel's per-step read this is the host's
        dispatch, not the device's time.  Nothing here synchronizes the
        card; a fenced split of input wait, dispatch and device is
        :class:`analytics_zoo_tpu_torch.obs.StepProbe`'s."""
        from analytics_zoo_tpu_torch.obs import Observability
        self.obs = obs or Observability()
        return self

    def set_train_summary(self, summary) -> "Optimizer":
        """A ``parallel.summary.TrainSummary``: the step's ``Loss`` and
        ``LearningRate`` each iteration, under its triggers."""
        self.train_summary = summary
        return self

    def set_validation_summary(self, summary) -> "Optimizer":
        """A ``parallel.summary.ValidationSummary``: each validation
        method's result at the iteration it ran."""
        self.val_summary = summary
        return self

    def _global_rows(self, batch) -> int:
        """Rows of the global batch ``batch`` stands for (a rank's slice
        times the data width when the dataset yields slices)."""
        n = _batch_size(batch)
        if self.specs is not None and self._local_dataset():
            n *= self.specs.data_axis_size
        return n

    def _local_dataset(self) -> bool:
        """The dataset yields this rank's slices already
        (``data.parallel.make_input_pipeline``)."""
        return bool(getattr(self.dataset, "yields_local_slices", False))

    def _placed(self, host_iter):
        """This rank's rows of each global batch of ``host_iter``; closing
        the generator closes ``host_iter``."""
        try:
            for batch in host_iter:
                yield self.specs.place_batch(
                    batch, microbatches=self._step_options["grad_accum"])
        finally:
            if hasattr(host_iter, "close"):
                host_iter.close()

    def optimize(self) -> nn.Module:
        if self.specs is not None:
            self.specs.place_state(self.model)
        options = dict(self._step_options)
        policy = self.anomaly_policy
        if policy is not None:
            if policy.spike_loss_above is not None:
                options["skip_loss_above"] = policy.spike_loss_above
            options.update(health_check=True, skip_unhealthy=policy.skip)
        step = make_train_step(self.model, self.criterion, self.optim,
                               **options)
        eval_step = make_eval_step(self.model,
                                   compute_dtype=self.compute_dtype)
        state = create_train_state(self.model, self.optim)
        loop = TrainingState()
        self._last_val_iter = None
        if self._resume_requested:
            resume_base = self.resume_path or self.checkpoint_path
            if resume_base:
                state = self._try_resume(resume_base, state, loop)
        self._anomaly = None
        if policy is not None:
            from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
            from analytics_zoo_tpu_torch.resilience.anomaly import (
                AnomalySentinel, health_sections)
            self._anomaly = AnomalySentinel(
                policy, sections=health_sections(self.model))
            if (policy.promote_initial and self.checkpoint_path is not None
                    and self._agreed(ckpt.lkg_snapshot(
                        self.checkpoint_path) is None)):
                # the starting state seeds the last-known-good slot, so a
                # rollback always has a target
                self._promote_lkg(loop, state)
        # the audit and shadow programs close over the mesh and the
        # forward: a reused Optimizer may have swapped either (the elastic
        # replace_mesh path), so they rebuild each optimize()
        self._health = self._audit_fn = self._shadow_fn = None
        if (self.health_policy is not None
                and (self.health_policy.audit_every > 0
                     or self.health_policy.shadow_every > 0)):
            from analytics_zoo_tpu_torch.resilience.health import (
                HealthSentinel)
            self._health = HealthSentinel(
                self.health_policy,
                registry=self.obs.registry if self.obs is not None else None)
        # the spine's hot-path objects are None-checked: an un-armed loop
        # pays nothing and synchronizes nothing
        obs = self.obs
        step_timer = None
        if obs is not None:
            from analytics_zoo_tpu_torch.utils.profiling import StepTimer
            step_timer = StepTimer("train/dispatch", registry=obs.registry)
        t_epoch, records = time.perf_counter(), 0
        dev = next(self.model.parameters()).device
        ph, wd = self.preemption_handler, self.stall_watchdog
        if ph is not None:
            ph.stall_watchdog = wd      # a stall interrupt beats preemption
            ph.install()
        if wd is not None:
            wd.start()
        sentinel = object()
        try:
            while not self.end_when(loop):
                stop = False
                loop.epoch_finished = False
                host_iter = iter(self.dataset)
                # mid-epoch resume: skip the trained batches on the host,
                # before the prefetch thread could pin or upload them
                while self._skip_samples:
                    b = next(host_iter, sentinel)
                    if b is sentinel:
                        break
                    n_skip = self._global_rows(b)
                    if n_skip > self._skip_samples:
                        raise ValueError(
                            f"resume: the checkpointed sample offset leaves "
                            f"{self._skip_samples} samples to skip but the "
                            f"next batch holds {n_skip}: the offset is not "
                            f"on a batch boundary of the resumed stream")
                    self._skip_samples -= n_skip
                    self._samples_in_epoch += n_skip
                    self._iter_in_epoch += 1
                self._skip_samples = None
                while self._skip_batches > 0:
                    b = next(host_iter, sentinel)
                    if b is sentinel:
                        break
                    self._skip_batches -= 1
                    self._samples_in_epoch += self._global_rows(b)
                    self._iter_in_epoch += 1
                placed = self.specs is not None
                if placed and not self._local_dataset():
                    host_iter = self._placed(host_iter)
                # close_source: the prefetch thread closes host_iter itself
                batches = (device_prefetch(host_iter, dev, self.prefetch,
                                           close_source=True)
                           if self.prefetch and dev.type == "cuda"
                           else host_iter)
                epoch_iter = iter(batches)
                try:
                    for batch in epoch_iter:
                        n = (_batch_size(batch) * self.specs.data_axis_size
                             if placed else _batch_size(batch))
                        step_span = None
                        if obs is not None:
                            # the loader's coordinates are the trace id:
                            # the same (epoch, batch) replays as the same
                            # trace
                            step_span = obs.tracer.start(
                                "train_step",
                                f"train-e{loop.epoch}-b{self._iter_in_epoch}",
                                iteration=loop.iteration + 1,
                                epoch=loop.epoch, batch=self._iter_in_epoch)
                        try:
                            with (step_timer.step(n) if step_timer is not None
                                  else contextlib.nullcontext()):
                                state, metrics = step(state, batch,
                                                      placed=placed)
                        except BaseException as e:
                            # a span reaches the recorder when it ends: the
                            # crashed step is what the black box is for
                            if step_span is not None:
                                step_span.end(
                                    status="error",
                                    error=f"{type(e).__name__}: {e}")
                            raise
                        self.history.append(metrics)
                        loop.iteration += 1
                        self._iter_in_epoch += 1
                        self._samples_in_epoch += n
                        loop.loss = metrics["loss"]
                        records += n
                        if self._anomaly is not None:
                            # may restore the lkg state, re-seek the stream
                            # and clear loop.loss/health after a skip
                            state = self._anomaly_step(
                                loop, state, metrics, batch, epoch_iter,
                                placed, step_span=step_span)
                        elif (self.failure_detector is not None
                                and self.failure_detector.should_check(
                                    loop.iteration)):
                            try:
                                self.failure_detector.check(
                                    float(metrics["loss"]), loop.iteration)
                            except Exception as e:
                                if (step_span is not None
                                        and not step_span.ended):
                                    step_span.end(
                                        status="error",
                                        error=f"{type(e).__name__}: {e}")
                                if obs is not None:
                                    obs.recorder.note(
                                        "training_diverged",
                                        iteration=loop.iteration)
                                    obs.dump("training_diverged")
                                raise
                        if self._health is not None:
                            # the audit and shadow at their cadences: a
                            # named device raises DeviceQuarantine (the
                            # survivors go on without it), unattributable
                            # corruption SdcDetected
                            try:
                                self._health_step(loop, batch)
                            except Exception as e:
                                if (step_span is not None
                                        and not step_span.ended):
                                    step_span.end(
                                        status="error",
                                        error=f"{type(e).__name__}: {e}")
                                if obs is not None:
                                    obs.recorder.note(
                                        "device_health",
                                        iteration=loop.iteration)
                                    obs.dump("device_health")
                                raise
                        if step_span is not None and not step_span.ended:
                            step_span.end(status="ok")
                        if self.train_summary is not None:
                            # tensors on the device: read back only where
                            # the tag's trigger fires
                            self.train_summary.add_scalar(
                                "Loss", metrics["loss"], loop.iteration)
                            self.train_summary.add_scalar(
                                "LearningRate", metrics["lr"],
                                loop.iteration)
                        self._boundary_checks(loop, state, eval_step, wd, ph)
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
                self._iter_in_epoch = 0
                self._samples_in_epoch = 0
                loop.loss = float(loop.loss)
                dt = time.perf_counter() - t_epoch
                logger.info("Epoch %d done: %d records in %.1fs (%.1f "
                            "records/s), loss %.4f", loop.epoch, records, dt,
                            records / max(dt, 1e-9), loop.loss)
                t_epoch, records = time.perf_counter(), 0
                self._boundary_checks(loop, state, eval_step, wd, ph)
                if self.epoch_hook is not None:
                    self.epoch_hook(loop, state)
        except KeyboardInterrupt:
            # the stall watchdog interrupts the main thread; a real Ctrl-C
            # (watchdog quiet) keeps its meaning
            self._raise_if_stalled(wd, loop)
            raise
        finally:
            if wd is not None:
                wd.stop()
            if ph is not None:
                ph.uninstall()
        self._last_state = state
        self.model.eval()
        return self.model

    def _boundary_checks(self, loop: TrainingState, state: TrainState,
                         eval_step, wd, ph) -> None:
        """What runs at a step or epoch boundary, in order: validation,
        the checkpoint, the stall check, the preemption check.  Each
        phase gets its own heartbeat.  A stall beats a preemption: the
        watchdog's interrupt may have been taken by the signal handler."""
        if wd is not None:
            wd.beat()
        self._maybe_validate(loop, eval_step)
        if wd is not None:
            wd.beat()
        self._maybe_checkpoint(loop, state)
        self._raise_if_stalled(wd, loop)
        if wd is not None:
            wd.beat()
        if ph is not None and ph.requested:
            self._graceful_preempt(loop, state)

    def _raise_if_stalled(self, wd, loop: TrainingState) -> None:
        if wd is None or not wd.stalled:
            return
        # absorb the watchdog's interrupt if it is still pending (the
        # monitor sets ``stalled`` a moment before interrupt_main)
        try:
            time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        raise StallError(
            f"no training progress past the {wd.timeout_s:.1f}s stall "
            f"deadline at iteration {loop.iteration}")

    def _graceful_preempt(self, loop: TrainingState, state: TrainState):
        """The step-boundary answer to SIGTERM: a forced checkpoint, then
        the retryable ``Preempted``."""
        saved = False
        if self.checkpoint_path is not None:
            saved = self._maybe_checkpoint(loop, state, force=True)
        if self.obs is not None:
            # the end of this run: the black box keeps the steps before
            # the signal, as it does for a divergence
            self.obs.recorder.note(
                "preempted", iteration=loop.iteration, epoch=loop.epoch,
                checkpoint_saved=saved)
            if self.obs.dump_path:
                self.obs.dump("preempted")
        raise Preempted(
            f"preemption signal received at iteration {loop.iteration}; "
            + ("final checkpoint written" if saved else
               "NO final checkpoint written (no path configured, or the "
               "loss or the health word is bad): resume falls back to the "
               "previous snapshot"))

    def _agreed(self, flag: bool) -> bool:
        """``flag`` as the mesh's ranks agree on it (true when any rank
        saw it true): a decision read from the shared disk, taken before
        any rank writes, so that a rank which reads after another's
        write cannot skip the save's collectives."""
        if self.specs is None or not mesh_lib.spans_processes(self.mesh):
            return flag
        dev = next(self.model.parameters()).device
        t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                     group=mesh_lib.mesh_group(self.mesh))
        # az-allow: no-host-sync-in-hot-path — the ranks' agreement before a checkpoint write: every rank must know it on the host, once per save, not per step
        return bool(t.item())

    # -- checkpoint and resume ------------------------------------------------
    def _snapshot_state(self, state: TrainState) -> Dict[str, Any]:
        """What a snapshot holds: the module's parameters and buffers, the
        step and the optimizer's slots (on their devices; ``checkpoint``
        copies them to the host).  Over a mesh: whole host tensors, every
        shard gathered (``SpecSet.gather``, a collective every rank
        runs), so a snapshot is width-agnostic."""
        if self.specs is None:
            return {"model": self.model.state_dict(), "step": int(state.step),
                    "opt_state": state.opt_state}
        model = self.specs.gather(self.model)
        specs = self._slot_specs(state.opt_state)
        slots = self.specs.gather(_flatten_slots(state.opt_state),
                                  specs=specs)
        as_t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in slots.items()}
        return {"model": {k: torch.from_numpy(v) for k, v in model.items()},
                "step": int(state.step),
                "opt_state": _unflatten_slots(state.opt_state, as_t)}

    def _trainable(self) -> List[torch.Tensor]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def _slot_specs(self, opt_state: Dict) -> Dict[str, Any]:
        """The spec of every optimizer slot: its parameter's (a slot list
        runs over the trainable parameters in order)."""
        params = self._trainable()
        out = {}
        for key, value in _flatten_slots(opt_state).items():
            name, _, i = key.rpartition("/")
            if name and i.isdigit() and int(i) < len(params):
                out[key] = tensor_lib.spec_of(params[int(i)])
        return out

    def _place_restored(self, restored: Dict[str, Any]) -> TrainState:
        """A whole restored snapshot cut to this rank's shards: the
        module's tensors loaded in place, the slots returned on the
        module's device."""
        mine = self.model.state_dict(keep_vars=True)
        with torch.no_grad():
            for k, t in mine.items():
                full = restored["model"][k]
                spec = tensor_lib.spec_of(t)
                t.copy_(tensor_lib.shard_tensor(full, spec, self.mesh)
                        if spec is not None else full)
        dev = next(self.model.parameters()).device
        specs = self._slot_specs(restored["opt_state"])
        flat = {k: (tensor_lib.shard_tensor(v, specs[k], self.mesh)
                    if specs.get(k) is not None else v).to(dev)
                if isinstance(v, torch.Tensor) else v
                for k, v in _flatten_slots(restored["opt_state"]).items()}
        return TrainState(step=int(restored["step"]),
                          opt_state=_unflatten_slots(restored["opt_state"],
                                                     flat))

    def _resume_meta(self, loop: TrainingState) -> Dict[str, Any]:
        return {"epoch": loop.epoch, "iteration": loop.iteration,
                "iter_in_epoch": self._iter_in_epoch,
                "samples_in_epoch": self._samples_in_epoch,
                "world_width": (self.specs.data_axis_size
                                if self.specs is not None else 1),
                "optim": self.optim.state_dict()}

    def _save(self, state: TrainState, meta: Dict[str, Any],
              **kw) -> Optional[str]:
        """Write a snapshot of ``state`` under the checkpoint path; over
        several ranks the mesh's first rank writes the gathered state and
        the others wait.  Returns the published directory (``None`` on the other
        ranks)."""
        from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
        snapshot = self._snapshot_state(state)
        spans = (self.specs is not None
                 and mesh_lib.spans_processes(self.mesh))
        target = None
        if not spans or (torch.distributed.get_rank()
                         == mesh_lib.first_rank(self.mesh)):
            target = ckpt.save(self.checkpoint_path, snapshot, meta=meta,
                               **kw)
        if spans:
            torch.distributed.barrier(group=mesh_lib.mesh_group(self.mesh))
        return target

    def _maybe_checkpoint(self, loop: TrainingState, state: TrainState,
                          force: bool = False) -> bool:
        """True when this iteration's state is persisted (saved now, or
        already saved at this iteration).  A non-finite loss, or a health
        word that is not 0 (non-finite gradients or parameters with a
        finite loss), is never saved."""
        if not force and (self.checkpoint_trigger is None
                          or not self.checkpoint_trigger(loop)):
            return False
        if self._last_ckpt_iter == loop.iteration:
            return True
        loss_now = float(loop.loss)
        health_now = int(getattr(loop, "health", 0) or 0)
        if health_now or not np.isfinite(loss_now):
            logger.warning("skipping checkpoint at iteration %d: health "
                           "word %#x, loss %s", loop.iteration, health_now,
                           loss_now)
            return False
        # memoized only on an actual save: a skipped save must not make a
        # later forced call at this iteration report "already persisted"
        self._last_ckpt_iter = loop.iteration
        tag = None if self.overwrite_checkpoint else loop.iteration
        t0 = time.perf_counter()
        span = (self.obs.tracer.span(
                    "checkpoint_save", f"ckpt-i{loop.iteration}",
                    iteration=loop.iteration,
                    tag="latest" if tag is None else f"step_{tag}")
                if self.obs is not None else contextlib.nullcontext())
        with span:
            # the loop position and the optim method's host state ride in
            # the snapshot's own manifest: a restore never pairs
            # parameters with another snapshot's metadata
            self._save(state, self._resume_meta(loop), step=tag,
                       keep_last=self.checkpoint_keep_last)
        if self.obs is not None:
            self.obs.registry.histogram("checkpoint/save_s").observe(
                time.perf_counter() - t0)
        return True

    def _apply_resume_meta(self, meta: Dict[str, Any],
                           loop: TrainingState, step: int) -> None:
        loop.epoch = int(meta.get("epoch", 0))
        loop.iteration = int(meta.get("iteration", step))
        width = self.specs.data_axis_size if self.specs is not None else 1
        saved_width = meta.get("world_width")
        if (self.obs is not None and saved_width is not None
                and int(saved_width) != width):
            self.obs.registry.counter("elastic/restores").inc()
            self.obs.registry.gauge("elastic/world_width").set(float(width))
        if meta.get("samples_in_epoch") is not None:
            # the same geometry consumes exactly iter_in_epoch batches
            self._skip_samples = int(meta["samples_in_epoch"])
            self._skip_batches = 0
        else:
            self._skip_batches = int(meta.get("iter_in_epoch", 0))
        self.optim.load_state_dict(meta.get("optim", {}) or {})

    def _try_resume(self, base: str, state: TrainState,
                    loop: TrainingState) -> TrainState:
        """Restore the module, the step, the slots, the loop position and
        the optim method's state from the newest intact snapshot under
        ``base``, when there is one.  A corrupt newest snapshot falls back
        to the next older intact one; the loop position comes from the
        restored snapshot's own manifest.  Every tensor lands beside the
        one it replaces (the module's device)."""
        from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
        base = os.path.abspath(base)
        if not ckpt.has_checkpoint(base):
            return state
        found = ckpt.newest_intact(base)
        if found is None:
            raise CheckpointCorrupt(f"no intact snapshot under {base}")
        snap_dir, manifest = found
        t0 = time.perf_counter()
        span = (self.obs.tracer.span("checkpoint_restore", "ckpt-restore",
                                     snapshot=os.path.basename(snap_dir))
                if self.obs is not None else contextlib.nullcontext())
        with span:
            # newest_intact checksummed this very directory already
            state, _ = self._restore(snap_dir, state)
        if self.obs is not None:
            self.obs.registry.histogram("checkpoint/restore_s").observe(
                time.perf_counter() - t0)
        self._apply_resume_meta(manifest.get("meta", {}), loop, state.step)
        logger.info("resumed from %s at epoch %d, iteration %d (skipping "
                    "%s in-epoch samples)", snap_dir, loop.epoch,
                    loop.iteration, self._skip_samples)
        return state

    def _restore(self, snap_dir: str, state: TrainState):
        """Load a snapshot into the module (in place): returns its
        ``TrainState`` and the loaded contents.  Over a mesh each rank
        takes its shards."""
        from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
        restored = ckpt.load(snap_dir, target=self._snapshot_state(state),
                             verify=False)
        if self.specs is not None:
            return self._place_restored(restored), restored
        self.model.load_state_dict(restored["model"])
        return TrainState(step=int(restored["step"]),
                          opt_state=restored["opt_state"]), restored

    # -- the device-health sentinel (resilience.health) -----------------------
    def _health_step(self, loop: TrainingState, batch) -> None:
        """The armed detectors at their cadences.  Every rank runs them
        at the same iteration and reaches the same verdict (the words are
        all-gathered), so every rank raises the same error."""
        from analytics_zoo_tpu_torch.resilience import health as health_lib
        from analytics_zoo_tpu_torch.resilience.errors import (
            DeviceQuarantine, SdcDetected)

        pol, sent = self.health_policy, self._health
        step = loop.iteration
        target, element, bit = health_lib.active_bit_flip() or (-1, 0, 0)
        if pol.audit_every > 0 and step % pol.audit_every == 0:
            if self._audit_fn is None:
                self._audit_fn = health_lib.make_audit_fn(self.mesh)
            fps = self._audit_fn(self.model, target, element, bit)
            verdict = sent.observe_audit(step, fps)
            self._health_verdict(loop, verdict, "parity audit",
                                 DeviceQuarantine, SdcDetected)
        if pol.shadow_every > 0 and step % pol.shadow_every == 0 \
                and self.mesh is not None and self.specs.data_axis_size >= 2:
            verdict = self._shadow_check(step, batch, (target, element, bit))
            self._health_verdict(loop, verdict, "shadow recompute",
                                 DeviceQuarantine, SdcDetected)

    def _health_verdict(self, loop, verdict, what, quarantine_cls,
                        sdc_cls) -> None:
        if verdict.ok:
            return
        pol, sent = self.health_policy, self._health
        if verdict.ambiguous:
            raise sdc_cls(
                f"{what} diverged at iteration {loop.iteration} with no "
                f"attributable minority device (fingerprints "
                f"{list(verdict.fingerprints)}); corruption is proven "
                f"but eviction has no target — triage the hardware")
        if pol.evict and sent.eviction_budget_left:
            sent.note_quarantine(verdict.suspect, what.replace(" ", "_"))
            raise quarantine_cls(
                f"{what} named device {verdict.suspect} as corrupt at "
                f"iteration {loop.iteration} (fingerprints "
                f"{list(verdict.fingerprints)}); quarantining — rebuild "
                f"on the surviving devices and resume from the LKG tier",
                device=verdict.suspect)
        logger.error("health: %s named device %s at iteration %d but "
                     "eviction is %s — continuing (detect-only)", what,
                     verdict.suspect, loop.iteration,
                     "off" if not pol.evict else "budget-exhausted")

    def _shadow_check(self, step: int, batch, flip):
        """Every rank of the data group recomputes the forward of the
        first rank's microbatch input (broadcast to all) on its own
        device and copy; the words are all-gathered, rank 0's is the
        primary, ``shadow_device``'s the shadow, a third rank's the
        tiebreak on a mismatch."""
        import torch.distributed as dist

        from analytics_zoo_tpu_torch.resilience import health as health_lib

        pol, sent = self.health_policy, self._health
        axis = mesh_lib.data_axis(self.mesh)
        group = mesh_lib.axis_group(self.mesh, axis)
        me = mesh_lib.axis_index(self.mesh, axis)
        width = self.specs.data_axis_size
        if self._shadow_fn is None:
            fwd = self._step_options.get("forward_fn")
            cdtype = resolve_compute_dtype(self.compute_dtype)
            self._shadow_fn = health_lib.make_shadow_fn(
                self.model, forward_fn=lambda m, x: _forward(
                    m, x, cdtype, forward_fn=fwd))
        box = [mesh_lib._tree_map(
            lambda x: x.detach().cpu() if isinstance(x, torch.Tensor)
            else x, batch["input"] if isinstance(batch, dict) else batch)]
        ranks = [int(r) for r in self.mesh.mesh.flatten().tolist()]
        dist.broadcast_object_list(box, src=ranks[0], group=group)
        dev = next(self.model.parameters()).device
        target, element, bit = flip
        word = self._shadow_fn({"input": to_device(box[0], dev)}, element,
                               bit, on=target == me)
        out = [torch.zeros(1, dtype=torch.int64) for _ in range(width)]
        dist.all_gather(out, torch.tensor([word], dtype=torch.int64),
                        group=group)
        # az-allow: no-host-sync-in-hot-path — the shadow check's decision boundary: the gathered words are host tensors over gloo, read once per shadow check, not per step
        words = [int(t.item()) for t in out]
        shadow_i = min(pol.shadow_device, width - 1)
        tiebreak = None
        if words[0] != words[shadow_i]:
            third = next((j for j in range(width)
                          if j not in (0, shadow_i)), None)
            if third is not None:
                tiebreak = words[third]
        return sent.observe_shadow(step, words[0], words[shadow_i],
                                   device=shadow_i, tiebreak_fp=tiebreak)

    # -- the anomaly ladder (resilience.anomaly) ------------------------------
    def _anomaly_step(self, loop: TrainingState, state: TrainState,
                      metrics, batch, epoch_iter, placed: bool,
                      step_span=None) -> TrainState:
        """Feed the step's health word to the sentinel: forensics on an
        episode's first bad step, then skip, roll back or raise.  Closes
        ``step_span`` with the verdict.  Returns the (possibly restored)
        state."""
        from analytics_zoo_tpu_torch.resilience import anomaly as anomaly_lib

        sent = self._anomaly
        obs = self.obs
        # one device-to-host read for both scalars (the int32 word is
        # exact in float64)
        word_f, loss_host = torch.stack(
            [metrics["health"].to(torch.float64),
             metrics["loss"].detach().to(torch.float64)]).tolist()
        word = int(word_f)
        loop.health = word
        sent.record_loss(loss_host)
        action, first = sent.observe(word)
        if step_span is not None:
            step_span.end(status="ok" if word == 0 else "unhealthy",
                          **({} if word == 0
                             else {"health_word": word, "action": action}))
        if obs is not None and word:
            obs.registry.counter("train/anomaly/bad_steps").inc()
        if word:
            sent.note_skip(word, step=loop.iteration)
            logger.warning(
                "anomaly sentinel: unhealthy step at iteration %d (word "
                "%#x, %d consecutive): %s", loop.iteration, word,
                sent.consecutive_bad,
                anomaly_lib.decode_health(word, sent.sections))
        if first:
            self._write_forensics(sent, word, loop, state, batch)
        if action == "rollback":
            if obs is not None:
                obs.registry.counter("train/anomaly/rollbacks").inc()
            state = self._anomaly_rollback(loop, state)
            self._reseek(epoch_iter, sent.policy.reseek, placed)
        elif action == "diverged":
            if obs is not None:
                # a terminal condition: the ring becomes the black box
                obs.recorder.note(
                    "training_diverged", iteration=loop.iteration,
                    health_word=word, rollbacks=sent.rollbacks,
                    consecutive_bad=sent.consecutive_bad)
                obs.dump("training_diverged")
            raise TrainingDiverged(
                f"anomaly ladder exhausted at iteration {loop.iteration}: "
                f"{sent.consecutive_bad} consecutive unhealthy steps with "
                f"the rollback budget spent ({sent.rollbacks}/"
                f"{sent.policy.max_rollbacks}); last health "
                f"{anomaly_lib.decode_health(word, sent.sections)}; "
                f"forensics bundles: {sent.forensics_paths or 'none'}")
        elif (action == "ok" and sent.should_promote()
                and self.checkpoint_path is not None):
            self._promote_lkg(loop, state)
        if word and action != "diverged" and sent.policy.skip:
            # with the skip armed the live state after a bad step is
            # clean (the update was discarded, or the lkg state restored):
            # clear the word and take the last finite loss, so that the
            # checkpoint guards do not refuse a clean state.  Without the
            # skip the update did apply, and the guards keep refusing.
            loop.health = 0
            finite = [v for v in sent.loss_history if np.isfinite(v)]
            if finite:
                loop.loss = finite[-1]
        return state

    def _anomaly_rollback(self, loop: TrainingState,
                          state: TrainState) -> TrainState:
        """Restore the last-known-good slot (or, without one, the newest
        intact regular snapshot, whose saves are health-guarded too)."""
        from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt

        sent = self._anomaly
        found, tier = None, "lkg"
        if self.checkpoint_path is not None:
            found = ckpt.lkg_snapshot(self.checkpoint_path)
            if found is None:
                found, tier = (ckpt.newest_intact(self.checkpoint_path),
                               "regular")
        if found is None:
            raise TrainingDiverged(
                f"anomaly rollback requested at iteration {loop.iteration} "
                "but no last-known-good (or intact regular) snapshot "
                "exists — configure set_checkpoint so the ladder has a "
                "rollback target")
        snap_dir, man = found
        state, restored = self._restore(snap_dir, state)
        # the live parameters against the snapshot's bytes
        live = self._snapshot_state(state)["model"]
        match = all(torch.equal(live[k].detach().cpu(), v.detach().cpu())
                    for k, v in restored["model"].items())
        self.optim.load_state_dict(
            (man.get("meta", {}) or {}).get("optim", {}) or {})
        sent.note_rollback(
            iteration=loop.iteration, tier=tier,
            snapshot=os.path.basename(snap_dir),
            restored_step=int(state.step),
            params_match_snapshot=bool(match),
            reseek_batches=sent.policy.reseek)
        logger.warning(
            "anomaly sentinel: rollback %d/%d at iteration %d -> %s "
            "(restored step %d, parameters equal to the snapshot: %s)",
            sent.rollbacks, sent.policy.max_rollbacks, loop.iteration,
            snap_dir, int(state.step), match)
        return state

    def _reseek(self, epoch_iter, n: int, placed: bool) -> None:
        """Drop the stream's next ``n`` batches on the host: they count as
        consumed for the resume position but train no step."""
        done = object()
        skipped = 0
        for _ in range(max(n, 0)):
            b = next(epoch_iter, done)
            if b is done:
                break
            skipped += 1
            self._iter_in_epoch += 1
            self._samples_in_epoch += (
                _batch_size(b) * self.specs.data_axis_size if placed
                else _batch_size(b))
        if skipped:
            logger.warning("anomaly sentinel: re-sought the stream past %d "
                           "batch(es) after rollback", skipped)

    def _write_forensics(self, sent, word: int, loop: TrainingState,
                         state: TrainState, batch) -> None:
        from analytics_zoo_tpu_torch.resilience import anomaly as anomaly_lib

        directory = (sent.policy.forensics_dir or self.checkpoint_path
                     or os.getcwd())
        batch_in_epoch = self._iter_in_epoch - 1
        num_workers = getattr(self.dataset, "num_workers", None)
        group_size = getattr(self.dataset, "group_size", None)
        # the worker shards owning the groups this batch spans
        worker_shards = None
        if num_workers and group_size:
            B = _batch_size(batch)
            first = (batch_in_epoch * B) // group_size
            last = ((batch_in_epoch + 1) * B - 1) // group_size
            worker_shards = sorted({g % num_workers
                                    for g in range(first, last + 1)})
        payload = {
            "bundle": "anomaly_forensics",
            "format": 1,
            "step": int(state.step),
            "iteration": loop.iteration,
            "epoch": loop.epoch,
            "batch_in_epoch": batch_in_epoch,
            "health_word": int(word),
            "health": anomaly_lib.decode_health(word, sent.sections),
            "sections": sent.sections,
            "batch_hash": anomaly_lib.batch_fingerprint(batch),
            # strict JSON: non-finite losses become strings
            "loss_history": [v if np.isfinite(v) else repr(v)
                             for v in sent.loss_history],
            # the loader's coordinates of the batch
            "rng": {
                "base_seed": getattr(self.dataset, "base_seed", None),
                "loader_epoch": getattr(self.dataset, "last_epoch", None),
                "num_workers": num_workers,
                "worker_shards": worker_shards,
            },
        }
        if not (self.specs is not None
                and mesh_lib.spans_processes(self.mesh)
                and torch.distributed.get_rank()
                != mesh_lib.first_rank(self.mesh)):
            sent.write_forensics(directory, payload)

    def _promote_lkg(self, loop: TrainingState, state: TrainState) -> None:
        meta = self._resume_meta(loop)
        meta["health_word"] = 0
        target = self._save(state, meta, tier="lkg")
        self._anomaly.note_promoted(
            step=loop.iteration,
            snapshot=os.path.basename(target) if target else "lkg")
        logger.info("anomaly sentinel: promoted the last-known-good "
                    "snapshot at iteration %d", loop.iteration)

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
                               self.val_methods, eval_step=eval_step,
                               specs=self.specs)
        finally:
            self.model.train()
        metrics = {r.name: r.result() for r in results}
        for name, value in metrics.items():
            logger.info("Validation @ iter %d: %s = %.5f", loop.iteration,
                        name, value)
            if self.val_summary is not None:
                self.val_summary.add_scalar(name, value, loop.iteration)
        self.val_history.append({"iteration": loop.iteration, **metrics})
        if self._score_name and self._score_name in metrics:
            loop.score = metrics[self._score_name]
            self.optim.on_validation({"score": loop.score, **metrics})


def _flatten_slots(opt_state: Dict) -> Dict[str, Any]:
    """``{"mu/3": tensor, "count": tensor, ...}``: a slot list's entries
    keyed by their index."""
    out = {}
    for k, v in opt_state.items():
        if isinstance(v, (list, tuple)):
            out.update({f"{k}/{i}": x for i, x in enumerate(v)})
        else:
            out[k] = v
    return out


def _unflatten_slots(like: Dict, flat: Dict[str, Any]) -> Dict:
    return {k: (type(v)(flat[f"{k}/{i}"] for i in range(len(v)))
                if isinstance(v, (list, tuple)) else flat[k])
            for k, v in like.items()}


def _batch_size(batch) -> int:
    """Dim 0 of the batch's ``"input"``, else of its first array leaf (a
    staged device-augmentation batch has no ``"input"`` yet)."""
    x = batch["input"] if isinstance(batch, dict) and "input" in batch \
        else batch
    return int(_tree_leaves(x)[0].shape[0])
