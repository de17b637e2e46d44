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


# ---------------------------------------------------------------------------
# Training entry points over a mesh
# ---------------------------------------------------------------------------


def ds2_train(weights, batches, shape, axes, rules, engine="blocked",
              hidden=16, layers=1, epochs=1, lr=3e-4):
    """``train_ds2(mesh=, param_rules=)`` on bridged weights: losses,
    the trained state gathered whole."""
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
                                    if rules else None))
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
    model = faster_rcnn.FasterRcnnVgg(
        faster_rcnn.FrcnnParam(num_classes=3, pooled=pooled,
                               proposal=ProposalParam(128, 32)),
        device="cpu", seed=0)
    if weights is not None:
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
