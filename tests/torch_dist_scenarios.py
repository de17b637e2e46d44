"""Rank-side scenarios of the port's multi-rank tests.

Each function here runs in every rank of a group that
``analytics_zoo_tpu_torch.utils.engine.spawn`` starts (gloo on the CPU),
and returns what the test process holds against the JAX package.  This
module imports no JAX and nothing of ``analytics_zoo_tpu``: the ranks run
the port alone.  ``run`` is the spawn target: one group runs a list of
scenarios, so a test module pays for one group.

``StubMesh`` stands in for a mesh where only the axis widths matter (spec
resolution in the test process, which starts no process group).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict

import numpy as np
import torch

#: the spawn target of every group of these tests
TARGET = os.path.abspath(__file__) + ":run"


class StubMesh:
    """Axis names and widths of a mesh, without ranks: enough for
    ``tensor.partition_spec`` and ``SpecSet`` declarations."""

    def __init__(self, shape: Dict[str, int]):
        self.mesh_dim_names = tuple(shape)
        self._sizes = tuple(shape.values())

    def size(self, dim=None):
        return int(np.prod(self._sizes)) if dim is None else self._sizes[dim]

    def get_local_rank(self, name):
        return 0

    def get_group(self, name):
        return None


def unfilled(cls, *args, **kwargs):
    """``cls(*args, **kwargs)`` on the CPU with its weights not drawn:
    built on the meta device and given empty storage, for a model whose
    weights the caller loads next (a Faster-RCNN's seeded draw of its
    137M parameters takes seconds and would be overwritten)."""
    with torch.device("meta"):
        module = cls(*args, **{**kwargs, "device": "meta"})
    return module.to_empty(device="cpu")


def spawn_async(world, scenarios, timeout=240):
    """A future of ``engine.spawn(TARGET, world, ...)`` on the CPU: the
    ranks run while the test process computes the JAX side."""
    from concurrent.futures import ThreadPoolExecutor

    from analytics_zoo_tpu_torch.utils import engine

    pool = ThreadPoolExecutor(1)
    future = pool.submit(engine.spawn, TARGET, world,
                         {"scenarios": scenarios}, device="cpu",
                         timeout=timeout)
    pool.shutdown(wait=False)
    return future


def run(scenarios):
    """``{key: (function name, kwargs)}`` → ``{key: result}``, in order,
    each function one of this module's scenarios."""
    torch.set_num_threads(1)
    out = {}
    for key, (fn, kwargs) in scenarios.items():
        out[key] = globals()[fn](**kwargs)
    return out


def _mesh(shape, axes):
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    return mesh_lib.create_mesh(tuple(shape), tuple(axes))


def _rank():
    import torch.distributed as dist
    return dist.get_rank()


def _state(module) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


@contextlib.contextmanager
def _dropout(on, *modules):
    """Dropout as it is (``on``) or the identity in ``modules``' forwards
    (the JAX side turns flax's off: the packages draw their masks from
    different generators)."""
    saved = [m.dropout for m in modules]
    if not on:
        for m in modules:
            m.dropout = lambda x, rate, generator=None: x
    try:
        yield
    finally:
        for m, f in zip(modules, saved):
            m.dropout = f


@contextlib.contextmanager
def _built_from(weights):
    """``core.module.Model.build(seed, ...)`` loading ``weights[seed]``
    after it builds (a pipeline that builds its own models starts them
    from bridged weights)."""
    from analytics_zoo_tpu_torch.core import module as module_lib

    build = module_lib.Model.build
    if weights is not None:
        def bridged(self, seed, *examples):
            build(self, seed, *examples)
            return self.load_weights(weights[seed])
        module_lib.Model.build = bridged
    try:
        yield
    finally:
        module_lib.Model.build = build


# ---------------------------------------------------------------------------
# The substrate: engine, mesh, specs
# ---------------------------------------------------------------------------


def engine_facts():
    """What ``engine`` and ``mesh`` report on this rank."""
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.utils import engine

    import torch.distributed as dist

    mesh = _mesh((-1,), ("data",))
    x = torch.ones(3) * (_rank() + 1)
    dist.all_reduce(x)
    return {"node_number": engine.node_number(),
            "device_count": engine.device_count(),
            "local_batch": engine.local_batch(16),
            "backend": dist.get_backend(), "device": str(engine.device()),
            "spans": mesh_lib.spans_processes(mesh),
            "slice": mesh_lib.local_data_slice(16, mesh),
            "all_reduce": x.tolist()}


def _fraud_model(seed=0):
    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.models.simple import FraudMLP

    model = Model(FraudMLP(in_features=29, hidden=10, n_classes=2),
                  device="cpu")
    return model.build(seed, np.zeros((1, 29), np.float32))


def _ds2_model(hidden=16, layers=1, seed=0, engine="blocked"):
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import make_ds2_model
    return make_ds2_model(hidden=hidden, n_rnn_layers=layers, seed=seed,
                          rnn_engine=engine, device="cpu")


def roundtrip(shape, axes, rules):
    """place → gather of a module and of its SGD slots: the bytes placed
    come back, on every rank (a fraud MLP replicated, a DS2 under
    ``default_tp_rules``)."""
    from analytics_zoo_tpu_torch.parallel import SGD, tensor as tensor_lib
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.parallel.train import create_train_state

    mesh = _mesh(shape, axes)
    model = (_ds2_model() if rules else _fraud_model())
    before = _state(model)
    specs = SpecSet(mesh, rules=tensor_lib.default_tp_rules()
                    if rules else None)
    specs.place_state(model)
    optim = SGD(0.1, momentum=0.9)
    state = create_train_state(model, optim)
    for t in state.opt_state["trace"]:
        t.add_(1.5)
    params = [p for p in model.parameters() if p.requires_grad]
    slots = specs.gather({f"trace/{i}": t for i, t in
                          enumerate(state.opt_state["trace"])},
                         specs={f"trace/{i}": tensor_lib.spec_of(p)
                                for i, p in enumerate(params)})
    after = specs.gather(model)
    return {"before": before, "after": after,
            "sharded": tensor_lib.sharded_param_count(model),
            "slot_shapes": [tuple(v.shape) for v in slots.values()],
            "param_shapes": [tensor_lib.full_shape(p)
                             for p in params],
            "local_shapes": {n: tuple(p.shape)
                             for n, p in model.named_parameters()},
            "slots_ok": all(np.all(v == 1.5) for v in slots.values())}


def eval_and_batches(batches):
    """``make_eval_step(specs=)`` against the plain forward (a batch that
    divides the data width and a ragged one), and ``place_batch``'s
    rows."""
    from analytics_zoo_tpu_torch.parallel import make_eval_step
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs

    mesh = _mesh((-1,), ("data",))
    specs = pipeline_specs("fraud", mesh=mesh)
    model = _fraud_model()
    plain = make_eval_step(model)
    annotated = make_eval_step(model, specs=specs)
    out = {"eval": [(annotated(torch.from_numpy(x)).numpy(),
                     plain(torch.from_numpy(x)).numpy()) for x in batches]}
    placed = specs.place_batch({"input": batches[0], "scalar": np.float32(2),
                                "nested": (batches[0][:, :2],)})
    out["placed"] = {"input": placed["input"],
                     "scalar": placed["scalar"],
                     "nested": placed["nested"][0]}
    try:
        specs.place_batch({"input": batches[1]})
        out["ragged_place"] = None
    except ValueError as e:
        out["ragged_place"] = str(e)
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------


class MLP(torch.nn.Module):
    """The reference's test MLP: fc1 → ReLU → out."""

    def __init__(self, width=32):
        super().__init__()
        self.fc1 = torch.nn.Linear(8, width)
        self.out = torch.nn.Linear(width, 8)

    def forward(self, x):
        return self.out(torch.relu(self.fc1(x)))


def mlp_train(weights, data, shape, axes, rules, epochs=3):
    """The reference's MLP trained by the ``Optimizer`` over a mesh (SGD
    0.05, momentum 0.9, MSE): the forward of ``data[0]`` after, the
    losses, the sharded-parameter count and the first forward under the
    placed weights."""
    from analytics_zoo_tpu_torch.core.criterion import MSECriterion
    from analytics_zoo_tpu_torch.parallel import (SGD, Optimizer, Trigger,
                                                  tensor as tensor_lib)

    mesh = _mesh(shape, axes)
    torch.manual_seed(0)
    model = MLP()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    param_rules = {"default": tensor_lib.default_tp_rules(),
                   "megatron": tensor_lib.megatron_tp_rules(
                       col=["fc1"], row=["out"]),
                   None: None}[rules]
    opt = (Optimizer(model, data, MSECriterion(), mesh=mesh,
                     param_rules=param_rules)
           .set_optim_method(SGD(0.05, momentum=0.9))
           .set_end_when(Trigger.max_epoch(epochs)))
    opt.optimize()
    with torch.no_grad():
        fwd = model(torch.from_numpy(data[0]["input"])).numpy()
    return {"forward": fwd, "steps": opt._last_state.step,
            "losses": [float(m["loss"]) for m in opt.history],
            "sharded": tensor_lib.sharded_param_count(model),
            "weights": opt.specs.gather(model)}


def analyze_programs(batch):
    """The program engine over ranks: a tensor-parallel DS2 step on a
    ("data", "model") mesh of (2, 2) audited against its own ``SpecSet``
    and then, run again, against one declared over a data-only mesh, and
    the fraud tiers of this rank's width-2 replica slice (the
    ``fraud-slice-w2`` targets).  ``{target: [(rule, waived, message)]}``
    and the slice targets' names."""
    from analytics_zoo_tpu_torch.analysis import targets
    from analytics_zoo_tpu_torch.analysis.program import (AuditProgram,
                                                          audit_program)
    from analytics_zoo_tpu_torch.parallel import Adam, pipeline_specs
    from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion)

    tp_mesh = _mesh((2, 2), ("data", "model"))
    data_only = SpecSet(_mesh((-1,), ("data",)))

    specs = pipeline_specs("ds2", mesh=tp_mesh,
                           param_rules=tensor_lib.default_tp_rules())
    built = targets._train(targets._ds2_model("cpu"), ds2_ctc_criterion(),
                           Adam(1e-3),
                           {k: (tuple(torch.from_numpy(x) for x in v)
                                if isinstance(v, tuple)
                                else torch.from_numpy(v))
                            for k, v in batch.items()}, specs)

    def audit(name, build):
        return [(v.rule, v.waived, v.message)
                for v in audit_program(AuditProgram(name, build))]

    out = {"tp": audit("ds2-tp/train", lambda: built),
           "tp_data_only": audit("ds2-tp/train", lambda: dataclasses.replace(
               built, specs=data_only))}
    slice_targets = targets._fraud_slice_serving(data_only.mesh, "cpu")
    out["slice_names"] = [t.name for t in slice_targets]
    for t in slice_targets:
        out[t.name] = audit(t.name, t.build)
    return out


def health_word_over_ranks():
    """``resilience.anomaly.word_over_ranks`` of a word whose bits differ
    by rank (bit ``rank`` and bit 29 on rank 0): every rank's result."""
    from analytics_zoo_tpu_torch.resilience import anomaly

    rank = _rank()
    word = torch.tensor((1 << rank) | ((1 << 29) if rank == 0 else 0),
                        dtype=torch.int32)
    return int(anomaly.word_over_ranks(word))


def ssd_megatron_forward(weights, x, shape, axes, resolution):
    """An SSD's (loc, conf) under ``ssd_tp_rules`` placement, and every
    row layer's input taken as it came (sharded or sliced)."""
    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs

    mesh = _mesh(shape, axes)
    model = SSDVgg(4, resolution, device="cpu", seed=0)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    specs = pipeline_specs("ssd", mesh=mesh, tp="megatron",
                           resolution=resolution)
    specs.place_state(model)
    with torch.no_grad():
        loc, conf = model(torch.from_numpy(specs.place_batch(x)))
    return {"loc": loc.numpy(), "conf": conf.numpy(),
            "conv4_3": tuple(model.vgg.conv4_3.weight.shape),
            "conf_0": tuple(model.conf_0.weight.shape)}


def ssd_spatial_forward(weights, x, cot, shape, axes):
    """SSD300's ``(loc, conf)`` with the image rows over ``model``
    (``tp="spatial"``'s placement and row scope; ``x``'s dtype), and
    unless ``cot`` is ``None`` the
    gradients of ``sum(loc * cot[0]) + sum(conf * cot[1])`` summed over
    ``model`` as the step sums them (then over ``data``: the whole
    batch's), and the rows this rank held."""
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs

    mesh = _mesh(shape, axes)
    dtype = torch.from_numpy(x).dtype
    model = SSDVgg(4, 300, device="cpu", seed=0).to(dtype)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    specs = pipeline_specs("ssd", mesh=mesh, tp="spatial")
    specs.place_state(model)
    block = torch.from_numpy(specs.place_batch({"input": x})["input"])
    cot = specs.place_batch(list(cot)) if cot is not None else None
    with specs.row_scope(), torch.set_grad_enabled(cot is not None):
        loc, conf = model(block)
    out = {"loc": loc.detach().numpy(), "conf": conf.detach().numpy(),
           "rows": int(block.shape[1])}
    if cot is None:
        return out
    ((loc * torch.from_numpy(cot[0])).sum()
     + (conf * torch.from_numpy(cot[1])).sum()).backward()
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        for group in (specs.row_group(), specs.data_group()):
            if group is not None:
                dist.all_reduce(g, group=group)
        grads[name] = g.numpy()
    return dict(out, grads=grads)


# ---------------------------------------------------------------------------
# Training entry points over a mesh
# ---------------------------------------------------------------------------


def ds2_train(weights, batches, shape, axes, rules, engine="blocked",
              hidden=16, layers=1, epochs=1, lr=3e-4,
              sequence_parallel=False):
    """``train_ds2(mesh=, param_rules=, sequence_parallel=)`` on bridged
    weights: losses, the trained state gathered whole."""
    from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe

    mesh = _mesh(shape, axes)
    model = _ds2_model(hidden, layers, engine=engine)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    runs = []

    class Recording(pipe.Optimizer):
        def optimize(self):
            runs.append(self)
            return super().optimize()

    base, pipe.Optimizer = pipe.Optimizer, Recording
    try:
        pipe.train_ds2(model, batches, epochs=epochs, lr=lr, mesh=mesh,
                       param_rules=(tensor_lib.default_tp_rules()
                                    if rules else None),
                       sequence_parallel=sequence_parallel)
    finally:
        pipe.Optimizer = base
    return {"losses": [float(m["loss"]) for m in runs[0].history],
            "state": SpecSet(mesh).gather(model),
            "sharded": tensor_lib.sharded_param_count(model)}


def ds2_accum(weights, batch, grad_accum):
    """One ``make_train_step(specs=, grad_accum=)`` SGD step of a DS2 over
    a data mesh of every rank: the loss and the parameters after."""
    from analytics_zoo_tpu_torch.parallel import (SGD, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe

    specs = SpecSet(_mesh((-1,), ("data",)))
    model = _ds2_model()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    specs.place_state(model)
    optim = SGD(0.1)
    step = make_train_step(model, pipe.ds2_ctc_criterion(), optim,
                           specs=specs, grad_accum=grad_accum)
    _, metrics = step(create_train_state(model, optim), batch)
    return {"loss": float(metrics["loss"]), "state": _state(model)}


def ssd_train(weights, train, val, shape, axes, tp):
    """``train_ssd(mesh=, tp=)`` (fp32, no prefetch) on bridged weights:
    losses, the merged validation score, the trained state."""
    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.pipelines import ssd as pipe

    mesh = _mesh(shape, axes)
    model = SSDVgg(4, 300, device="cpu", seed=0)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    runs = []

    class Recording(pipe.Optimizer):
        def optimize(self):
            runs.append(self)
            return super().optimize()

    base, pipe.Optimizer = pipe.Optimizer, Recording
    try:
        pipe.train_ssd(train, val, pipe.TrainParams(
            max_epoch=1, n_classes=4, compute_dtype=None, prefetch=0),
            model=model, mesh=mesh, tp=tp)
    finally:
        pipe.Optimizer = base
    return {"losses": [float(m["loss"]) for m in runs[0].history],
            "val": runs[0].val_history,
            "state": SpecSet(mesh).gather(model)}


def frcnn_train(batches, res, shape, axes, pooled=2, weights=None,
                dropout=True):
    """``train_frcnn(mesh=)`` (3 classes, 128 → 32 proposals, ``pooled``
    ROI pooling) on synthetic shapes, from ``weights`` when given, with
    dropout on or off: losses and the trained state."""
    from analytics_zoo_tpu_torch.models import faster_rcnn
    from analytics_zoo_tpu_torch.ops.proposal import ProposalParam
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.pipelines import frcnn as pipe

    mesh = _mesh(shape, axes)
    param = faster_rcnn.FrcnnParam(num_classes=3, pooled=pooled,
                                   proposal=ProposalParam(128, 32))
    if weights is None:
        model = faster_rcnn.FasterRcnnVgg(param, device="cpu", seed=0)
    else:
        # the seeded draw of 137M parameters would be overwritten
        model = unfilled(faster_rcnn.FasterRcnnVgg, param, seed=0)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
    losses = []
    with _dropout(dropout, faster_rcnn):
        pipe.train_frcnn(model, batches, res, epochs=1, lr=3e-3, mesh=mesh,
                         epoch_hook=lambda loop, state: losses.append(
                             float(loop.loss)))
    return {"loss": losses, "state": SpecSet(mesh).gather(model)}


# ---------------------------------------------------------------------------
# Global-batch semantics
# ---------------------------------------------------------------------------


def _scope(mesh):
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.utils import spmd
    axis = mesh_lib.data_axis(mesh)
    return spmd.global_batch(mesh_lib.axis_group(mesh, axis),
                                 mesh_lib.axis_size(mesh, axis),
                                 mesh_lib.axis_index(mesh, axis))


def global_batch_parts(multibox, bn, masked, dropout_shape):
    """On this rank's rows, inside ``spmd.global_batch``: MultiBoxLoss
    (whose positives fall unevenly over the ranks) and its input
    gradients, DS2's sequence BN (outputs, running statistics, input
    gradient), a masked ``ClassNLLCriterion`` mean and a dropout mask."""
    from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
    from analytics_zoo_tpu_torch.core.layers import dropout
    from analytics_zoo_tpu_torch.models.deepspeech2 import SequenceBN
    from analytics_zoo_tpu_torch.ops.multibox_loss import (MultiBoxLoss,
                                                           MultiBoxLossParam)
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

    mesh = _mesh((-1,), ("data",))
    out = {}

    def mine(tree):
        return mesh_lib.shard_batch(tree, mesh)

    with _scope(mesh):
        m = mine(multibox)
        loc = torch.from_numpy(m["loc"]).requires_grad_()
        conf = torch.from_numpy(m["conf"]).requires_grad_()
        crit = MultiBoxLoss(multibox["priors"], multibox["variances"],
                            MultiBoxLossParam(n_classes=4))
        loss = crit((loc, conf), m["target"])
        loss.backward()
        out["multibox"] = (float(loss), loc.grad.numpy(), conf.grad.numpy())

        b = mine({"x": bn["x"], "mask": bn["mask"], "g": bn["g"]})
        layer = SequenceBN(bn["x"].shape[-1]).train()
        x = torch.from_numpy(b["x"]).requires_grad_()
        y = layer(x, torch.from_numpy(b["mask"]))
        (y * torch.from_numpy(b["g"])).sum().backward()
        out["bn"] = (y.detach().numpy(), layer.running_mean.numpy(),
                     layer.running_var.numpy(), x.grad.numpy())

        c = mine(masked)
        lp = torch.from_numpy(c["log_probs"]).requires_grad_()
        nll = ClassNLLCriterion()(lp, c["target"], mask=c["mask"])
        nll.backward()
        out["masked"] = (float(nll), lp.grad.numpy())

        g = torch.Generator().manual_seed(5)
        out["dropout"] = dropout(torch.ones(dropout_shape), 0.5, g).numpy()
    return out


# ---------------------------------------------------------------------------
# The Optimizer across processes, elastic resume
# ---------------------------------------------------------------------------


def _fraud_batches():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 29).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int32)
    return [{"input": x[i:i + 16], "target": y[i:i + 16]}
            for i in range(0, 64, 16)]


def fraud_optimizer(ckpt, epochs, weights, resume=False):
    """The reference's fraud-MLP ``Optimizer`` run over a data mesh of
    every rank from ``weights``, a snapshot an epoch (rank 0 writes):
    steps, the state fingerprint (sum of |params|), the snapshot's
    manifest."""
    from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
    from analytics_zoo_tpu_torch.parallel import (SGD, Optimizer, Trigger,
                                                  checkpoint as ckpt_lib)
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

    mesh = _mesh((-1,), ("data",))
    model = _fraud_model().load_weights(weights)
    opt = (Optimizer(model, _fraud_batches(), ClassNLLCriterion(),
                     mesh=mesh)
           .set_optim_method(SGD(0.1, momentum=0.9))
           .set_end_when(Trigger.max_epoch(epochs))
           .set_checkpoint(ckpt, Trigger.every_epoch()))
    if resume:
        opt.set_resume()
    opt.optimize()
    fp = float(sum(np.abs(p.detach().numpy()).sum()
                   for p in model.parameters()))
    man = None
    if _rank() == 0:
        man = ckpt_lib.verify_snapshot(os.path.join(ckpt, "latest"))["meta"]
    return {"steps": int(opt._last_state.step), "fingerprint": fp,
            "meta": man, "slice": mesh_lib.local_data_slice(16, mesh),
            "spans": mesh_lib.spans_processes(mesh)}


def elastic_matrix(name, base, restore):
    """Width-change matrix of one registered pipeline: at width 4 the
    state is placed, gathered and saved (``restore=False``); at a
    narrower width it is restored through ``restore_elastic`` and one
    step taken from it and from a never-resized placement of the same
    initial state."""
    from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
    from analytics_zoo_tpu_torch.parallel import (SGD, checkpoint as ckpt_lib,
                                                  create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs

    mesh = _mesh((-1,), ("data",))
    specs = pipeline_specs(name, mesh=mesh)
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 4),
                              torch.nn.LogSoftmax(-1))
    host0 = {k: v.clone() for k, v in net.state_dict().items()}
    if not restore:
        specs.place_state(net)
        if _rank() == 0:
            ckpt_lib.save(base, {k: torch.from_numpy(v) for k, v in
                                 specs.gather(net).items()},
                          meta={"world_width": specs.data_axis_size})
        import torch.distributed as dist
        dist.barrier()
        return {"saved": True}
    restored = ckpt_lib.restore_elastic(base, target=host0, specs=specs,
                                        module=net)
    equal = all(torch.equal(restored[k], host0[k]) for k in host0)
    rng = np.random.RandomState(0)
    batch = {"input": rng.randn(8, 8).astype(np.float32),
             "target": (rng.rand(8) * 4).astype(np.int32)}
    out = {"equal": equal}
    for tag, state in (("elastic", restored), ("control", host0)):
        net.load_state_dict(state)
        specs.place_state(net)
        optim = SGD(0.1, momentum=0.9)
        step = make_train_step(net, ClassNLLCriterion(), optim, specs=specs)
        st, m = step(create_train_state(net, optim), batch)
        out[tag] = (repr(float(m["loss"])), _state(net))
    return out


def restore_mismatch(base):
    """``restore_elastic`` onto a target of another structure."""
    from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt_lib
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs
    from analytics_zoo_tpu_torch.resilience.errors import (
        ElasticPlacementError)

    specs = pipeline_specs("fraud", mesh=_mesh((-1,), ("data",)))
    if _rank() == 0:
        ckpt_lib.save(base, {"w": torch.ones(4)})
    import torch.distributed as dist
    dist.barrier()
    try:
        ckpt_lib.restore_elastic(base, target={"w": torch.ones(4),
                                               "extra": torch.ones(2)},
                                 specs=specs)
    except ElasticPlacementError as e:
        return str(e)
    return None


def input_pipeline(n_batches):
    """``make_input_pipeline`` over a data mesh: each rank's slices."""
    from analytics_zoo_tpu_torch.data import DataSet
    from analytics_zoo_tpu_torch.data.parallel import make_input_pipeline

    mesh = _mesh((-1,), ("data",))
    data = DataSet.from_list([
        {"input": np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + i,
         "target": np.arange(8, dtype=np.int32) + 10 * i}
        for i in range(n_batches)])
    pipe = make_input_pipeline(data, mesh, num_workers=0, prefetch=2)
    out = {"local": pipe.yields_local_slices, "len": len(pipe),
           "batches": [b for b in pipe]}
    # the Optimizer fed this rank's slices trains as one fed global batches
    from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
    from analytics_zoo_tpu_torch.parallel import SGD, Optimizer, Trigger

    prints = []
    for feed in (DataSet.from_list(_fraud_batches()),
                 make_input_pipeline(DataSet.from_list(_fraud_batches()),
                                     mesh, prefetch=2)):
        model = _fraud_model()
        opt = (Optimizer(model, feed, ClassNLLCriterion(), mesh=mesh)
               .set_optim_method(SGD(0.1, momentum=0.9))
               .set_end_when(Trigger.max_iteration(3)))
        opt.optimize()
        prints.append((opt._samples_in_epoch, [
            p.detach().numpy().copy() for p in model.parameters()]))
    out["optimizer"] = prints
    return out


# ---------------------------------------------------------------------------
# Row-sharded embedding tables
# ---------------------------------------------------------------------------


def embedding_rows(table, ids, cot, lr):
    """A (vocab, dim) table row-sharded over ``model``: the lookup (each
    mode) and its gradient on the shard; one ``sparse_adam_apply`` of the
    shard's owned rows; the shards gathered back."""
    from analytics_zoo_tpu_torch.ops import embedding as emb
    from analytics_zoo_tpu_torch.parallel import sparse_adam_apply
    from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet

    mesh = _mesh((1, -1), ("data", "model"))
    module = emb.DedupEmbed(table.shape[0], table.shape[1])
    with torch.no_grad():
        module.embedding.copy_(torch.from_numpy(table))
    specs = SpecSet(mesh, rules=tensor_lib.embedding_row_rules())
    specs.place_state(module)
    out = {"local_rows": module.embedding.shape[0]}
    for mode in emb.LOOKUP_MODES:
        module.embedding.grad = None
        module.lookup = mode
        got = module(torch.from_numpy(ids))
        (got * torch.from_numpy(cot)).sum().backward()
        out[mode] = (got.detach().numpy(), specs.gather(
            {"g": module.embedding.grad},
            specs={"g": tensor_lib.spec_of(module.embedding)})["g"])
    grad = emb.embedding_grad_rows(torch.from_numpy(ids),
                                   torch.from_numpy(cot))
    mine = tensor_lib.owned_rows(grad, module.embedding)
    z = torch.zeros_like(module.embedding)
    t, mu, nu, count = sparse_adam_apply(
        module.embedding.detach(), z, z.clone(),
        torch.zeros((), dtype=torch.int32), mine, lr)
    spec = tensor_lib.spec_of(module.embedding)
    out["adam"] = specs.gather({"t": t, "mu": mu, "nu": nu},
                               specs=dict.fromkeys(("t", "mu", "nu"), spec))
    return out


def zoo_train(kind, weights, batches, shape, axes, model_kw, dropout=True):
    """``train_recommender`` (NeuralCF) / ``train_sentiment`` over a
    mesh, or the fraud ``MLPClassifier(mesh=)`` fitted on a frame's
    columns (built from ``weights`` by seed when given), dropout on or off:
    losses and the trained state, gathered whole."""
    from analytics_zoo_tpu_torch.models import simple
    from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet

    mesh = _mesh(shape, axes)
    runs = []
    if kind == "fraud":
        from analytics_zoo_tpu_torch.pipelines import fraud as pipe
    elif kind == "rec":
        from analytics_zoo_tpu_torch.pipelines import recommendation as pipe
    else:
        from analytics_zoo_tpu_torch.pipelines import sentiment as pipe

    class Recording(pipe.Optimizer):
        def optimize(self):
            runs.append(self)
            return super().optimize()

    base, pipe.Optimizer = pipe.Optimizer, Recording
    try:
        if kind == "fraud":
            clf = pipe.MLPClassifier(**model_kw, mesh=mesh, device="cpu")
            with _built_from(weights):
                model = clf.fit(batches).model
        else:
            make = (pipe.make_ncf_model if kind == "rec"
                    else pipe.make_sentiment_model)
            model = make(**model_kw, device="cpu")
            model.load_weights(weights)
            train = (pipe.train_recommender if kind == "rec"
                     else pipe.train_sentiment)
            with _dropout(dropout, simple):
                train(model, batches, epochs=1, mesh=mesh)
    finally:
        pipe.Optimizer = base
    return {"losses": [float(m["loss"]) for m in runs[0].history],
            "state": SpecSet(mesh).gather(model.module),
            "sharded": tensor_lib.sharded_param_count(model)}


def fraud_pipeline(frame, cols, weights, n_models, epochs):
    """``run_fraud_pipeline(mesh=)`` over a data mesh of every rank, the
    bagged classifier of seed ``i`` built from ``weights[i]``: the
    result's fields."""
    from analytics_zoo_tpu_torch.pipelines import fraud

    mesh = _mesh((-1,), ("data",))
    with _built_from(weights):
        res = fraud.run_fraud_pipeline(frame, cols, n_models=n_models,
                                       epochs=epochs, mesh=mesh,
                                       device="cpu")
    return {"auprc": res.auprc, "best_threshold": res.best_threshold,
            "precision": res.precision, "recall": res.recall}


def fail_on_rank(rank):
    """Rank ``rank`` raises; the others wait at a barrier."""
    if _rank() == rank:
        raise RuntimeError("the scenario fails on purpose")
    import torch.distributed as dist
    dist.barrier()


def sleep(seconds):
    import time
    time.sleep(seconds)


# ---------------------------------------------------------------------------
# Sequence, pipeline and expert parallelism
# ---------------------------------------------------------------------------


def _coord(mesh, name):
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    return mesh_lib.axis_index(mesh, name)


def _grad_of(loss, tensors):
    loss.backward()
    return [t.grad.numpy().copy() for t in tensors]


def _leaf(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


def seq_exchanges(x, cot, shape, axes, axis="sequence"):
    """On the ``axis`` line: ``ppermute`` over the wrapping ring and the
    non-wrapping chain, and ``all_to_all``; each with this rank's input
    ``x[idx]`` and the gradient of ``sum(out · cot[idx])``."""
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel import sequence as seq

    mesh = _mesh(shape, axes)
    group = mesh_lib.axis_group(mesh, axis)
    n, idx = mesh_lib.axis_size(mesh, axis), _coord(mesh, axis)
    out = {"idx": idx}
    ops = {"ring": lambda t: seq.ppermute(
               t, group, [(i, (i + 1) % n) for i in range(n)]),
           "chain": lambda t: seq.ppermute(
               t, group, [(i, i + 1) for i in range(n - 1)]),
           "a2a": lambda t: seq.all_to_all(t, group, 0, 1)}
    for name, op in ops.items():
        xi = _leaf(x[idx])
        y = op(xi)
        g, = _grad_of((y * torch.from_numpy(cot[name][idx])).sum(), [xi])
        out[name] = (y.detach().numpy(), g)
    return out


def seq_halo(x, shape, axes, left, right):
    """This rank's block of ``x`` extended by ``halo_exchange``."""
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel import sequence as seq

    mesh = _mesh(shape, axes)
    block = seq.shard_sequence(torch.from_numpy(x), mesh)
    ext = seq.halo_exchange(block, mesh_lib.axis_group(mesh, "sequence"),
                            left, right)
    return {"idx": _coord(mesh, "sequence"), "ext": ext.numpy()}


def seq_scan(x, kernel, bias, cot, shape, axes, batch_axis=None):
    """``sequence_sharded_scan`` of the reference tests' tanh step, both
    directions, on this rank's rows and block: outputs and the gradients
    of ``sum(out · cot)`` for the block, the kernel and the bias (the
    parameters' summed over the sequence ranks)."""
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel import sequence as seq

    mesh = _mesh(shape, axes)
    group = mesh_lib.axis_group(mesh, "sequence")
    start, per = mesh_lib.local_data_slice(x.shape[0], mesh)
    rows = slice(start, start + per)
    out = {"idx": _coord(mesh, "sequence"), "rows": (start, per)}
    for rev in (False, True):
        k, b = _leaf(kernel), _leaf(bias)
        eye = torch.eye(x.shape[-1], kernel.shape[0])

        def step(h, x_t):
            y = torch.tanh(x_t @ eye + h @ k + b)
            return y, y

        xb = seq.shard_sequence(torch.from_numpy(x[rows]), mesh).clone()
        xb.requires_grad_(True)
        ys = seq.sequence_sharded_scan(step, torch.zeros(per, kernel.shape[0]),
                                       xb, mesh, reverse=rev,
                                       batch_axis=batch_axis, params=(k, b))
        c = seq.shard_sequence(torch.from_numpy(cot[rows]), mesh)
        gx, gk, gb = _grad_of((ys * c).sum(), [xb, k, b])
        sums = torch.from_numpy(np.concatenate([gk.ravel(), gb.ravel()]))
        if group is not None:
            dist.all_reduce(sums, group=group)
        out[rev] = (ys.detach().numpy(), gx,
                    sums[:gk.size].reshape(gk.shape).numpy(),
                    sums[gk.size:].numpy())
    return out


def seq_ring(q, k, v, cot, shape, axes, causal):
    """``ring_attention`` on this rank's blocks: the output block and the
    gradients of ``sum(out · cot)`` for the q/k/v blocks."""
    from analytics_zoo_tpu_torch.parallel import sequence as seq

    mesh = _mesh(shape, axes)
    blocks = [seq.shard_sequence(torch.from_numpy(t), mesh).clone()
              .requires_grad_(True) for t in (q, k, v)]
    o = seq.ring_attention(*blocks, mesh, causal=causal)
    c = seq.shard_sequence(torch.from_numpy(cot), mesh)
    grads = _grad_of((o * c).sum(), blocks)
    return {"idx": _coord(mesh, "sequence"), "out": o.detach().numpy(),
            "grads": grads}


def _ds2_bridged(weights, hidden, layers, engine="blocked"):
    model = _ds2_model(hidden, layers, engine=engine)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    return model


def ds2_seq_forward(weights, x, shape, axes, batch_axis, hidden, layers):
    """``sequence_parallel_forward`` (eval) on this rank's rows."""
    from analytics_zoo_tpu_torch.models.deepspeech2 import (
        sequence_parallel_forward)
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

    mesh = _mesh(shape, axes)
    model = _ds2_bridged(weights, hidden, layers)
    start, per = mesh_lib.local_data_slice(x.shape[0], mesh)
    with torch.no_grad():
        out = sequence_parallel_forward(model, x[start:start + per], mesh,
                                        batch_axis=batch_axis)
    return {"rows": (start, per), "out": out.numpy()}


def ds2_seq_step(weights, batch, shape, axes, hidden, layers):
    """One ``make_train_step`` of a DS2 through
    ``make_sequence_parallel_forward_fn`` with SGD at lr 0: the global
    loss, every parameter's gradient (averaged over the data ranks) and
    the batch statistics after the step."""
    from analytics_zoo_tpu_torch.models.deepspeech2 import (
        make_sequence_parallel_forward_fn)
    from analytics_zoo_tpu_torch.parallel import (SGD, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion)

    mesh = _mesh(shape, axes)
    model = _ds2_bridged(weights, hidden, layers)
    optim = SGD(0.0)
    step = make_train_step(
        model, ds2_ctc_criterion(), optim, mesh=mesh,
        forward_fn=make_sequence_parallel_forward_fn(model, mesh))
    _, metrics = step(create_train_state(model, optim), batch)
    return {"loss": float(metrics["loss"]),
            "grads": {k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()},
            "stats": {k: v.numpy().copy() for k, v in
                      model.state_dict().items() if "running" in k}}


def ds2_seq_pipeline(weights, utts, param_kw, shape, axes, hidden, layers):
    """``DeepSpeech2Pipeline(sequence_mesh=)`` transcripts."""
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe

    mesh = _mesh(shape, axes)
    model = _ds2_bridged(weights, hidden, layers)
    tp = pipe.DeepSpeech2Pipeline(model, pipe.DS2Param(**param_kw),
                                  sequence_mesh=mesh, device="cpu")
    return {"utt_length": tp.utt_length,
            "texts": tp.transcribe_samples(utts)}


def ds2_seq_refusals(weights, hidden, layers):
    """The refusals' messages on a real mesh."""
    from analytics_zoo_tpu_torch.models.deepspeech2 import (
        make_sequence_parallel_forward_fn, sequence_parallel_forward)
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe

    mesh = _mesh((-1,), ("sequence",))
    model = _ds2_bridged(weights, hidden, layers)
    out = {}
    for name, call in {
            "odd_t": lambda: sequence_parallel_forward(
                model, torch.zeros(1, 12, 13), mesh),
            "bucketed": lambda: make_sequence_parallel_forward_fn(
                model, mesh)(model, (torch.zeros(1, 16, 13), None), True),
            "no_axis": lambda: pipe.train_ds2(
                model, [], mesh=_mesh((-1,), ("data",)),
                sequence_parallel=True)}.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _block(p, x):
    return x + torch.tanh(x @ p["fc"]["kernel"] + p["fc"]["bias"])


def _wide_block(p, x):
    h = torch.tanh(x @ p["in"]["kernel"] + p["in"]["bias"])
    return x + h @ p["out"]["kernel"] + p["out"]["bias"]


def _tree_leaf(tree):
    if isinstance(tree, dict):
        return {k: _tree_leaf(v) for k, v in tree.items()}
    return _leaf(tree)


def _tree_grad(tree):
    if isinstance(tree, dict):
        return {k: _tree_grad(v) for k, v in tree.items()}
    return tree.grad.numpy().copy()


def pipe_forward(stacked, x, n_micro, tgt, shape, axes, batch_axis=None):
    """``pipeline_forward`` of the reference tests' residual tanh block:
    the output and the gradients of ``mean((y − tgt)²)`` for the stack
    and the input (this rank's rows of a ``batch_axis``)."""
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel import pipeline

    mesh = _mesh(shape, axes)
    start, per = mesh_lib.local_data_slice(x.shape[0], mesh)
    params = _tree_leaf(stacked)
    xi = _leaf(x[start:start + per])
    y = pipeline.pipeline_forward(
        _block, params, pipeline.split_microbatches(xi, n_micro), mesh,
        batch_axis=batch_axis)
    loss = ((y.reshape(xi.shape) - torch.from_numpy(
        tgt[start:start + per])) ** 2).mean()
    loss.backward()
    return {"rows": (start, per), "out": y.detach().numpy(),
            "g_params": _tree_grad(params), "g_x": xi.grad.numpy()}


def pipe_megatron(params, xs, shape, axes):
    """``pipeline_forward(param_specs=)``: a Megatron column → row pair
    in each stage (the kernels cut over ``model``, the pair closed by
    ``replicated_sum`` over it), on a ("model", "pipe") mesh: the loss
    ``mean(y²)`` and the kernels' gradients (whole on every rank)."""
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel import pipeline
    from analytics_zoo_tpu_torch.parallel.mesh import P
    from analytics_zoo_tpu_torch.parallel.sequence import (replicated_sum,
                                                           summed_grads)

    mesh = _mesh(shape, axes)
    group = mesh_lib.axis_group(mesh, "model")

    def block(p, a):
        a_in, = summed_grads([a], group)
        return a + replicated_sum(torch.tanh(a_in @ p["w1"]) @ p["w2"],
                                  group)

    leaves = _tree_leaf(params)
    y = pipeline.pipeline_forward(
        block, leaves, torch.from_numpy(xs), mesh,
        param_specs={"w1": P("pipe", None, "model"),
                     "w2": P("pipe", "model", None)})
    loss = (y ** 2).mean()
    loss.backward()
    return {"loss": float(loss), "grads": _tree_grad(leaves)}


def pipe_het(params, x, n_micro, tgt, grouped):
    """``pipeline_forward_het`` of the reference tests' wide blocks over
    every rank, through the flat or the grouped carrier: the output and
    the carrier's gradient of ``mean((y − tgt)²)``."""
    from analytics_zoo_tpu_torch.parallel import pipeline

    mesh = _mesh((-1,), ("pipe",))
    trees = [_tree_leaf(p) for p in params]
    flat = (pipeline.flatten_stage_params_grouped if grouped
            else pipeline.flatten_stage_params)
    carrier, metas = flat([{k: {n: t.detach() for n, t in v.items()}
                            for k, v in tree.items()} for tree in trees])
    carrier = ({k: v.requires_grad_(True) for k, v in carrier.items()}
               if grouped else carrier.requires_grad_(True))
    fns = [_wide_block] * len(params)
    y = pipeline.pipeline_forward_het(
        fns, carrier, metas, pipeline.split_microbatches(
            torch.from_numpy(x), n_micro), mesh)
    ((y.reshape(x.shape) - torch.from_numpy(tgt)) ** 2).mean().backward()
    grad = ({k: v.grad.numpy() for k, v in carrier.items()} if grouped
            else carrier.grad.numpy())
    return {"out": y.detach().numpy(), "grad": grad}


def _asr_model(weights, kw):
    from analytics_zoo_tpu_torch.models.attention import AttentionASR

    model = AttentionASR(**kw, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    return model


def pipe_asr(weights, kw, batch, n_micro, shape, axes):
    """``make_pipeline_forward_fn`` of an AttentionASR over a ("data",
    "pipe") mesh: this rank's rows' log-probs (eval), then one
    ``make_train_step`` (SGD at lr 0) through it: the global loss and the
    gradients averaged over the data ranks."""
    from analytics_zoo_tpu_torch.models.attention import (
        make_pipeline_forward_fn)
    from analytics_zoo_tpu_torch.parallel import (SGD, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion)

    mesh = _mesh(shape, axes)
    model = _asr_model(weights, kw)
    fwd = make_pipeline_forward_fn(model, mesh, n_micro=n_micro,
                                   batch_axis="data")
    start, per = mesh_lib.local_data_slice(batch["input"].shape[0], mesh)
    with torch.no_grad():
        out = fwd(model, torch.from_numpy(
            batch["input"][start:start + per]), False)
    optim = SGD(0.0)
    step = make_train_step(model, ds2_ctc_criterion(), optim, mesh=mesh,
                           forward_fn=fwd)
    _, metrics = step(create_train_state(model, optim), batch)
    return {"rows": (start, per), "out": out.numpy(),
            "loss": float(metrics["loss"]),
            "grads": {k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()}}


def moe_ep(stacked, gate, x, cot, capacity):
    """``moe_apply_expert_parallel`` over every rank on ``("expert",)``
    with this rank's tokens: the output and the gradients of
    ``sum(y · cot)`` for the tokens, the stack and the gate."""
    from analytics_zoo_tpu_torch.parallel import expert

    mesh = _mesh((-1,), ("expert",))
    idx = _coord(mesh, "expert")
    per = x.shape[0] // gate.shape[1]
    rows = slice(idx * per, (idx + 1) * per)
    params, gk, xi = _tree_leaf(stacked), _leaf(gate), _leaf(x[rows])

    def apply(p, a):
        return torch.nn.functional.gelu(
            a @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]

    y = expert.moe_apply_expert_parallel(apply, params, gk, xi, mesh,
                                         capacity=capacity)
    (y * torch.from_numpy(cot[rows])).sum().backward()
    return {"idx": idx, "out": y.detach().numpy(), "g_x": xi.grad.numpy(),
            "g_params": _tree_grad(params), "g_gate": gk.grad.numpy()}


@contextlib.contextmanager
def collective_calls():
    """Count the collectives this rank calls (by name and dtype, e.g.
    ``"all_gather_into_tensor/float32"``) while the block runs."""
    import torch.distributed as dist

    calls: Dict[str, int] = {}
    names = ("all_gather_into_tensor", "all_to_all_single", "all_reduce")
    saved = {name: getattr(dist, name) for name in names}

    def counted(name):
        def call(tensor, *args, **kwargs):
            key = f"{name}/{str(tensor.dtype).replace('torch.', '')}"
            calls[key] = calls.get(key, 0) + 1
            return saved[name](tensor, *args, **kwargs)
        return call

    for name in names:
        setattr(dist, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def saved_bytes(fn):
    """``(fn(), bytes of the tensors autograd saved while it ran)``."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


def asr_parallel(weights, kw, x, labels, shape, axes, mode, batches=None):
    """An AttentionASR whose attention runs over the ``sequence`` axis
    (``mode="ring"``: ``RingAttentionLayer``; with MoE blocks in ``kw``
    their dense path), whose MoE blocks run one expert a rank
    (``mode="expert"``), or both over the same ranks
    (``mode="ring_expert"``: the ring on the mesh, the experts on
    ``("expert",)`` of the world): the log-probs, the forward's
    collectives, the CTC loss's gradients (every rank whole) and, with
    ``batches``, the losses of ``train_ds2(mesh=)`` on them."""
    from analytics_zoo_tpu_torch.core.criterion import CTCCriterion
    from analytics_zoo_tpu_torch.parallel.sequence import RingAttentionLayer
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe

    mesh = _mesh(shape, axes)
    kw = dict(kw)
    if mode in ("ring", "ring_expert"):
        kw["attention_fn"] = RingAttentionLayer(mesh)
    if mode == "expert":
        kw["expert_mesh"] = mesh
    elif mode == "ring_expert":
        kw["expert_mesh"] = _mesh((-1,), ("expert",))
    model = _asr_model(weights, kw)
    with collective_calls() as calls:
        lp = model(torch.from_numpy(x))
    CTCCriterion(blank_id=0)(lp, torch.from_numpy(labels)).backward()
    out = {"out": lp.detach().numpy(), "collectives": calls,
           "grads": {k: p.grad.numpy().copy()
                     for k, p in model.named_parameters()}}
    if batches is not None:
        runs = []

        class Recording(pipe.Optimizer):
            def optimize(self):
                runs.append(self)
                return super().optimize()

        base, pipe.Optimizer = pipe.Optimizer, Recording
        try:
            pipe.train_ds2(model, batches, epochs=1, lr=2e-3, mesh=mesh)
        finally:
            pipe.Optimizer = base
        out["losses"] = [float(m["loss"]) for m in runs[0].history]
    return out


def encoder_ring(weights, kw, x, causal, cot=None):
    """``LongContextEncoder`` with ``RingAttentionLayer(causal=)`` on a
    (1, n) ("data", "sequence") mesh: the whole forward under autograd
    (its output, the bytes autograd saved, its collectives); with
    ``cot``, the block entry on this rank's ``shard_sequence(x)``
    gathered back, and the gradients of ``sum(y · cot)``."""
    from analytics_zoo_tpu_torch.models.attention import LongContextEncoder
    from analytics_zoo_tpu_torch.parallel.sequence import (
        RingAttentionLayer, shard_sequence, unshard_sequence)

    mesh = _mesh((1, -1), ("data", "sequence"))
    enc = LongContextEncoder(**kw, attention_fn=RingAttentionLayer(
        mesh, causal=causal), in_features=x.shape[-1], device="cpu")
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    with collective_calls() as calls:
        whole, n_saved = saved_bytes(lambda: enc(torch.from_numpy(x)))
    out = {"whole": whole.detach().numpy(), "saved_bytes": n_saved,
           "collectives": calls}
    if cot is not None:
        enc.zero_grad()
        y = unshard_sequence(enc.block_forward(
            torch.from_numpy(shard_sequence(x, mesh))), mesh)
        (y * torch.from_numpy(cot)).sum().backward()
        out["out"] = y.detach().numpy()
        out["grads"] = {k: p.grad.numpy().copy()
                        for k, p in enc.named_parameters()}
    return out


# ---------------------------------------------------------------------------
# Sharded serving: the tiers over the data ranks, the runtime's follower
# ---------------------------------------------------------------------------


def _family_model(family, weights):
    """The port model of a serving family (the test's widths) on the
    CPU, loaded with ``weights`` (a state dict of numpy arrays)."""
    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.models import simple
    from analytics_zoo_tpu_torch.pipelines import (deepspeech2,
                                                   recommendation, sentiment)

    if family == "ssd":
        from analytics_zoo_tpu_torch.models.ssd import SSDVgg
        model = SSDVgg(4, 300, device="cpu")
    elif family == "ds2":
        model = deepspeech2.make_ds2_model(hidden=16, n_rnn_layers=1,
                                           device="cpu")
    elif family == "frcnn":
        from analytics_zoo_tpu_torch.models import faster_rcnn
        from analytics_zoo_tpu_torch.ops.proposal import ProposalParam
        # its weights are loaded below: no seeded draw
        model = unfilled(faster_rcnn.FasterRcnnDetector,
                         faster_rcnn.FrcnnParam(
                             num_classes=4, proposal=ProposalParam(64, 16)),
                         seed=0)
    elif family == "fraud":
        model = Model(simple.FraudMLP(), device="cpu")
    elif family == "rec":
        model = recommendation.make_ncf_model(600, 30, embedding_dim=8,
                                              mf_embedding_dim=4,
                                              hidden=(16, 8), device="cpu")
    else:
        model = sentiment.make_sentiment_model(
            vocab_size=400, embedding_dim=16, hidden=64, head="cnn",
            seq_len=12, device="cpu")
    module = model.module if isinstance(model, Model) else model
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in weights.items()})
    return model


# the SSD rungs' post-processing in the sharded-serving tests: a
# confidence floor above the random weights' near-tied scores
SSD_SERVE_POST = dict(n_classes=4, conf_thresh=0.4)


def family_tiers(family, model, specs=None):
    """A family's serving rungs over ``model`` (the test's widths)."""
    from analytics_zoo_tpu_torch.ops.detection_output import (
        DetectionOutputParam)
    from analytics_zoo_tpu_torch.pipelines import (deepspeech2, fraud, frcnn,
                                                   recommendation, sentiment,
                                                   ssd)

    if family == "ssd":
        return ssd.ssd_serving_tiers(
            model, ssd.PreProcessParam(batch_size=2),
            post=DetectionOutputParam(**SSD_SERVE_POST), n_classes=4,
            degraded_topk=5, specs=specs, device="cpu")
    if family == "ds2":
        return deepspeech2.ds2_serving_tiers(
            model, deepspeech2.DS2Param(decoder="beam", beam_width=4),
            specs=specs, device="cpu")
    if family == "frcnn":
        return frcnn.frcnn_serving_tiers(
            model, ssd.PreProcessParam(resolution=128), specs=specs,
            device="cpu")
    build = {"fraud": fraud.fraud_serving_tiers,
             "rec": recommendation.rec_serving_tiers,
             "sentiment": sentiment.sentiment_serving_tiers}[family]
    kw = {"seq_len": 12} if family == "sentiment" else {}
    return build(model, specs=specs, device="cpu", **kw)


def _rows(out):
    return [str(x) for x in out] if isinstance(out, list) else np.asarray(out)


def serve_tiers(families, shape, axes):
    """Each family's rungs with ``specs`` of its pipeline on the mesh,
    every rung on each of its batches: the rows each rank got back."""
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs

    mesh = _mesh(shape, axes)
    out = {}
    for family, (weights, batches) in families.items():
        specs = pipeline_specs(family, mesh=mesh)
        tiers = family_tiers(family, _family_model(family, weights), specs)
        out[family] = [[_rows(t.forward(b)) for b in batches] for t in tiers]
    return out


def _runtime(tiers, clock, specs, n_replicas=2, models=None):
    from analytics_zoo_tpu_torch import serving

    kw = dict(n_replicas=n_replicas, clock=clock, max_batch=4,
              length_key=None, default_deadline_s=60.0,
              wedge_timeout_s=60.0, specs=specs)
    if isinstance(clock, serving.VirtualClock):
        kw["service_time"] = ((lambda m, e, n, t: 0.01) if models
                              else (lambda e, n, t: 0.01))
    if models is not None:
        return serving.ServingRuntime(models=models, **kw)
    return serving.ServingRuntime(tiers, **kw)


def _fail_before_the_tier(specs, tiers, rows, lead):
    """A follower failing before its tier's forward, through the
    leader's half alone: the leader calls the ``int8`` rung, which the
    follower lacks (its lookup fails), then the ``fp`` rung twice, the
    follower's first placement of the rows raising.  The leader returns
    the exception each call raised (``None``: none) and a last call's
    rows; the follower its counts."""
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.serving.follower import (Leader,
                                                          serve_follower)

    if not lead:
        place = SpecSet.place_batch
        calls = [0]

        def flaky(self, *args, **kw):
            calls[0] += 1
            if calls[0] == 1:
                raise RuntimeError("follower placement fault")
            return place(self, *args, **kw)

        SpecSet.place_batch = flaky
        try:
            return serve_follower(specs, tiers=tiers[:1])
        finally:
            SpecSet.place_batch = place
    leader = Leader(specs)
    fp, int8 = leader.register(tiers)
    caught = []
    for tier in (int8, fp, fp):
        try:
            tier.forward({"input": rows})
            caught.append(None)
        except Exception as e:          # noqa: BLE001 - recorded
            caught.append(type(e).__name__)
    got = np.asarray(fp.forward({"input": rows}))
    leader.stop()
    return {"caught": caught, "rows": got}


def serve_runtime(weights, rows, new_weights, snap_dir, shape, axes):
    """``ServingRuntime(specs=)`` over the fraud rungs sharded on the
    mesh: rank 0 runs the runtime, the others ``serve_follower``.
    ``virtual`` and ``monotonic``: the rows through each clock;
    ``fault``: the follower's forward raises on its first batch;
    ``before``: the follower fails before its tier runs
    (:func:`_fail_before_the_tier`); ``swap``: a hot swap to ``new_weights`` (published by rank 0), then
    the rows again.  Rank 0 returns each run's request rows, accounting,
    pool events and snapshot's mesh; a follower its counts."""
    from analytics_zoo_tpu_torch import serving
    from analytics_zoo_tpu_torch.models import simple
    from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs
    from analytics_zoo_tpu_torch.serving.follower import serve_follower

    mesh = _mesh(shape, axes)
    specs = pipeline_specs("fraud", mesh=mesh)
    lead = _rank() == 0
    out = {}

    def tiers_from(w):
        return family_tiers("fraud", _family_model("fraud", w), specs)

    def serve(run, tiers, clock, models=None):
        if not lead:
            return serve_follower(specs, tiers=None if models else tiers,
                                  models=models)
        rt = _runtime(tiers, clock, specs, models=models)
        for r in rows:
            rt.submit({"input": r}, **({"model": "fraud"} if models
                                       else {}))
        rt.drain()
        if run is not None:
            run(rt)
        rt.close()
        return {"rows": np.stack([np.asarray(r.result)
                                  if r.result is not None
                                  else np.full(2, np.nan)
                                  for r in rt.requests]),
                "accounting": rt.accounting(),
                "events": [e["kind"] for e in rt.pool.events],
                "mesh": rt.snapshot()["mesh"]}

    out["virtual"] = serve(None, tiers_from(weights), serving.VirtualClock())
    out["monotonic"] = serve(None, tiers_from(weights),
                             serving.MonotonicClock())
    tiers = tiers_from(weights)
    if not lead:
        fc1 = simple.FraudMLP.forward
        calls = [0]

        def flaky(self, x):
            calls[0] += 1
            if calls[0] == 1:
                raise RuntimeError("follower fault")
            return fc1(self, x)

        simple.FraudMLP.forward = flaky
    try:
        out["fault"] = serve(None, tiers, serving.MonotonicClock())
    finally:
        if not lead:
            simple.FraudMLP.forward = fc1
    out["before"] = _fail_before_the_tier(specs, tiers, rows[:4], lead)

    def weights_to_tiers(state, rid):
        return tiers_from({k: v.numpy() for k, v in state.items()})

    models = [serving.ModelConfig(name="fraud", tiers=tiers_from(weights),
                                  weights_to_tiers=weights_to_tiers,
                                  length_key=None)]
    if lead:
        snap = ckpt.save(os.path.join(snap_dir, "fraud"),
                         {k: torch.from_numpy(v)
                          for k, v in new_weights.items()}, step=1)

    def swap(rt):
        rt.hot_swap(snap, canary_fraction=0.0, device="cpu")
        for _ in range(50):
            rt.pump(force=True)
            if not rt.swap_active:
                break
        for r in rows:
            rt.submit({"input": r}, model="fraud")
        rt.drain()

    out["swap"] = serve(swap, None, serving.MonotonicClock(), models=models)
    return out


# ---------------------------------------------------------------------------
# The fleet: slices of replicas over the mesh, the parity audit, eviction
# ---------------------------------------------------------------------------


def serve_slices(n_rows=24):
    """``ServingRuntime(slice_width=2, device_budget=)`` over the fraud
    rungs on a mesh of 2 slices of 2 ranks: rank 0 runs the runtime and
    slice 0 with rank 1; slice 1 (ranks 2 and 3) is driven remotely.
    Rank 0 returns the rows' largest difference to one process's
    unsharded rungs, each replica's dispatches, the accounting, the
    budget's refusal of a third slice and the slice records; a follower
    its counts."""
    from analytics_zoo_tpu_torch import serving
    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.models import simple
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs

    mesh = _mesh((-1,), ("data",))
    layout = serving.SliceLayout(pipeline_specs("fraud", mesh=mesh), 2)
    torch.manual_seed(3)
    weights = _state(Model(simple.FraudMLP(), device="cpu").module)
    tiers = family_tiers("fraud", _family_model("fraud", weights),
                         layout.specs)
    if _rank() != 0:
        return serving.serve_follower(layout.specs, tiers=tiers)
    rng = np.random.RandomState(4)
    rows = rng.randn(n_rows, 29).astype(np.float32)
    rt = serving.ServingRuntime(
        tiers, n_replicas=2, clock=serving.MonotonicClock(), max_batch=4,
        length_key=None, default_deadline_s=600.0, wedge_timeout_s=600.0,
        specs=layout.specs, slice_width=2, device_budget=4)
    for r in rows:
        rt.submit({"input": r})
        rt.pump()
    rt.drain()
    grown = rt.pool.resize(3)
    rt.close()
    alone = family_tiers("fraud", _family_model("fraud", weights))[0]
    want = np.asarray(alone.forward({"input": rows}))
    got = np.stack([np.asarray(r.result) for r in rt.requests])
    snap = rt.snapshot()
    return {"max_diff": float(np.abs(got - want).max()),
            "dispatches": {r.rid: r.dispatches for r in rt.pool.replicas},
            "accounting": rt.accounting(), "grown": grown["grown"],
            "clamped": [e for e in rt.pool.events
                        if e["kind"] == "resize_budget_clamped"],
            "slices": snap["slices"], "layout": layout.groups}


def _sdc_batches(n=8, rows=12):
    """Global DS2 batches of 12 rows (4 and 3 ranks both divide them)."""
    rng = np.random.RandomState(7)
    out = []
    for _ in range(n):
        frames = rng.randint(9, 17, rows).astype(np.int32)
        labels = rng.randint(1, 29, (rows, 4)).astype(np.int32)
        mask = (np.arange(4)[None] < rng.randint(1, 5, rows)[:, None])
        out.append({"input": (rng.randn(rows, 16, 13).astype(np.float32),
                              frames),
                    "n_frames": frames, "labels": labels,
                    "label_mask": mask.astype(np.float32)})
    return out


def _sdc_optimizer(mesh, root, data, steps, health=True):
    from analytics_zoo_tpu_torch.parallel import SGD, Optimizer, Trigger
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion)
    from analytics_zoo_tpu_torch.resilience.anomaly import AnomalyPolicy
    from analytics_zoo_tpu_torch.resilience.health import HealthPolicy

    opt = (Optimizer(_ds2_model(), data, ds2_ctc_criterion(), mesh=mesh)
           .set_optim_method(SGD(0.05))
           .set_checkpoint(root, Trigger.several_iteration(2),
                           overwrite=False, keep_last=4)
           .set_anomaly_policy(AnomalyPolicy(rollback_after=3,
                                             promote_after=2,
                                             max_rollbacks=2))
           .set_end_when(Trigger.max_iteration(steps)))
    if health:
        opt.set_health_policy(HealthPolicy(audit_every=1))
    return opt


def sdc_eviction(base, flip_at=4):
    """A tiny DS2 trained data parallel on 4 ranks under the parity audit
    (``audit_every=1``): un-armed, every audit ``ok``; then a chaos
    ``bit_flip`` on rank 2 (armed before batch ``flip_at``): every rank
    raises ``DeviceQuarantine(device=2)``, rank 2 leaves, and the 3
    survivors take one step from the last-known-good tier, held against
    a straight width-3 run (no sentinel, no eviction) from a copy of the
    same snapshot."""
    import shutil

    import torch.distributed as dist

    from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt_lib
    from analytics_zoo_tpu_torch.parallel.elastic import (
        resume_after_quarantine)
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.resilience.chaos import (ChaosMonkey,
                                                          FaultSpec)
    from analytics_zoo_tpu_torch.resilience.errors import DeviceQuarantine

    mesh = _mesh((-1,), ("data",))
    data = _sdc_batches()
    clean = _sdc_optimizer(mesh, os.path.join(base, "clean"), data, 3)
    clean.optimize()
    out = {"clean": clean._health.stats()}
    root = os.path.join(base, "armed")
    monkey = ChaosMonkey([FaultSpec("bit_flip", flip_at,
                                    detail={"replica": 2, "bit": 5})])
    opt = _sdc_optimizer(mesh, root, monkey.dataset(data), 8)
    err = None
    with monkey:
        try:
            opt.optimize()
        except DeviceQuarantine as e:
            err = e
    out["raised"] = (type(err).__name__, getattr(err, "device", None))
    out["divergence"] = [e for e in opt._health.events
                         if e["kind"] == "audit_divergence"]
    lkg = ckpt_lib.lkg_snapshot(root)
    out["lkg_iteration"] = int(lkg[1]["meta"]["iteration"])
    survivors = resume_after_quarantine(
        err, mesh, root, os.path.join(base, "evicted"),
        lambda m, r: _sdc_optimizer(m, r, data, out["lkg_iteration"] + 1))
    if survivors is None:
        out["evicted"] = True
        return out
    survivors.optimize()
    mesh3 = survivors.mesh
    ctrl_root = os.path.join(base, "control")
    if _rank() == 0:
        shutil.copytree(lkg[0], os.path.join(ctrl_root, "latest"))
    dist.barrier(group=mesh3.get_group("data"))
    control = _sdc_optimizer(mesh3, ctrl_root, data,
                             out["lkg_iteration"] + 1,
                             health=False).set_resume(ctrl_root)
    control.optimize()
    out["evicted"] = False
    out["width"] = survivors.specs.data_axis_size
    out["losses"] = ([float(m["loss"]) for m in survivors.history],
                     [float(m["loss"]) for m in control.history])
    spec3 = SpecSet(mesh3)
    a, b = spec3.gather(survivors.model), spec3.gather(control.model)
    out["equal"] = all(np.array_equal(a[k], b[k]) for k in b)
    out["stats"] = survivors._health.stats()
    return out
