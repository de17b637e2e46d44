"""The port's multi-process training on ``torch.distributed`` against the
JAX package (``tests/test_distributed.py``).

Spawned gloo groups of ranks that import no JAX (``utils.engine.spawn``,
``torch_dist_scenarios``): a 2-process group starts (``engine.init`` from
the ``torchrun`` variables), every rank sees the world and its
``local_data_slice``, and one all-reduce crosses the process boundary;
the fraud MLP trained by the ``Optimizer`` over 2 ranks equals the JAX
package's single-process run on the same global batches; 4 ranks train 3
epochs with a snapshot each (rank 0 writes), then 2 ranks resume the
same snapshot to epoch 6 and equal the JAX package's 6 epochs.  The
fingerprint (sum of |parameters|) is held to the reference's rtol 2e-5.
``run_fraud_pipeline(mesh=)`` over 2 ranks, its classifiers built from
the reference's initial weights, gives the JAX package's result on a
(2,) mesh (the votes are integers: EQUAL threshold, the scores within
1e-6).  ``train_frcnn(mesh=)`` over 2 ranks, from the reference's
initial weights with dropout off in both packages, is held to the JAX
package's on a (2,) mesh: the loss within 1e-5 relative, and each
parameter's update (one SGD step: the learning rate times the clipped
gradient) within ``FRCNN_TRUNK_TOL`` relative L2 up to conv5_2 and
``FRCNN_HEAD_TOL`` from conv5_3 on: the distance of the port's
one-process step from the JAX package's one-device step on these
inputs, where near-tied max-pool windows and near-zero ReLU inputs of
the random network route a trunk gradient otherwise on each side
(``test_torch_frcnn_train.py``), which moves the global norm and with
it the clip factor of every update.  With dropout on,
``train_frcnn(mesh=)`` is held to the port's own one-process run.
"""

import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_scenarios as sc
from analytics_zoo_tpu.core.criterion import ClassNLLCriterion as JaxNLL
from analytics_zoo_tpu.core.module import Model as JaxModel
from analytics_zoo_tpu.models import faster_rcnn as jax_frcnn
from analytics_zoo_tpu.models.simple import FraudMLP as JaxFraudMLP
from analytics_zoo_tpu.parallel import SGD as JaxSGD
from analytics_zoo_tpu.parallel import Optimizer as JaxOptimizer
from analytics_zoo_tpu.parallel import Trigger as JaxTrigger
from analytics_zoo_tpu.parallel import create_mesh
from analytics_zoo_tpu.pipelines import fraud as jfraud
from analytics_zoo_tpu.pipelines import frcnn as jax_frcnn_pipe
from analytics_zoo_tpu_torch.core.module import Model
from analytics_zoo_tpu_torch.models.simple import FraudMLP
from analytics_zoo_tpu_torch.utils import convert, engine

FP_RTOL = 2e-5
FRCNN_LOSS_TOL = 1e-5
FRCNN_TRUNK_TOL, FRCNN_HEAD_TOL = 2e-2, 1e-3
_BELOW_CONV5_3 = ("vgg/conv1", "vgg/conv2", "vgg/conv3", "vgg/conv4",
                  "vgg/conv5_1", "vgg/conv5_2")
FRCNN_RES = 64


def _jax_model():
    m = JaxModel(JaxFraudMLP(in_features=29, hidden=10, n_classes=2))
    m.build(0, jnp.zeros((1, 29), jnp.float32))
    return m


def _bridged():
    net = Model(FraudMLP(in_features=29, hidden=10, n_classes=2),
                device="cpu").build(0, np.zeros((1, 29), np.float32))
    return {k: v.numpy() for k, v in convert.fraud_mlp_params_from_jax(
        _jax_model().variables["params"], net.module).items()}


def _jax_fingerprint(epochs):
    """The JAX package's single-process run on the same global batches."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 29).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int32)
    batches = [{"input": x[i:i + 16], "target": y[i:i + 16]}
               for i in range(0, 64, 16)]
    model = _jax_model()
    opt = (JaxOptimizer(model, batches, JaxNLL(),
                        mesh=create_mesh((4,), axis_names=("data",),
                                         devices=jax.devices()[:4]))
           .set_optim_method(JaxSGD(0.1, momentum=0.9))
           .set_end_when(JaxTrigger.max_epoch(epochs)))
    opt.optimize()
    return float(sum(np.abs(np.asarray(leaf)).sum()
                     for leaf in jax.tree_util.tree_leaves(
                         jax.device_get(opt._last_state.params))))


def _pipeline_frame():
    """The frame of ``test_torch_zoo_pipelines.py``'s pipeline run."""
    rng = np.random.RandomState(18)
    n = 1200
    x = rng.randn(n, 6).astype(np.float32)
    label = ((x[:, 0] + 0.5 * x[:, 1]) > 1.8).astype(np.int64)
    return {**{f"v{i}": x[:, i] for i in range(6)}, "label": label,
            "time": np.arange(n, dtype=np.float64)}


def _bridged_fraud6(seeds):
    """The reference classifier's initial weights at 6 features for each
    seed (``Bagging`` builds its model ``i`` from seed ``i``), for the
    port's."""
    net = Model(FraudMLP(in_features=6, hidden=10, n_classes=2),
                device="cpu").build(0, np.zeros((1, 6), np.float32))
    out = {}
    for seed in seeds:
        jm = JaxModel(JaxFraudMLP(in_features=6, hidden=10, n_classes=2))
        jm.build(seed, jnp.zeros((1, 6)))
        out[seed] = {k: v.numpy() for k, v in
                     convert.fraud_mlp_params_from_jax(
                         jm.variables["params"], net.module).items()}
    return out


def _jax_frcnn():
    from analytics_zoo_tpu.ops import ProposalParam as JaxProposalParam
    param = jax_frcnn.FrcnnParam(num_classes=3, pooled=2,
                                 proposal=JaxProposalParam(
                                     pre_nms_topn=128, post_nms_topn=32))
    m = JaxModel(jax_frcnn.FasterRcnnVgg(param=param))
    return m.build(0, jnp.zeros((1, FRCNN_RES, FRCNN_RES, 3), jnp.float32),
                   jnp.asarray([[FRCNN_RES, FRCNN_RES, 1.0]], jnp.float32))


def _frcnn_batches(n_batches=1, res=64, n=2):
    """Bright rectangles on a dark background, normalized gt (the
    synthetic task of ``test_torch_frcnn_train.py``)."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n_batches):
        imgs = rng.rand(n, res, res, 3).astype(np.float32) * 10
        bboxes = np.zeros((n, 2, 4), np.float32)
        labels = np.zeros((n, 2), np.int32)
        for b in range(n):
            for g in range(2):
                x1, y1 = rng.randint(2, 30, 2)
                w, h = rng.randint(16, 28, 2)
                x2, y2 = min(x1 + w, res - 2), min(y1 + h, res - 2)
                imgs[b, y1:y2, x1:x2] += 120.0
                bboxes[b, g] = (x1 / res, y1 / res, x2 / res, y2 / res)
                labels[b, g] = 1 + g
        out.append({"input": imgs, "target": {
            "bboxes": bboxes, "labels": labels,
            "mask": np.ones((n, 2), np.float32)}})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist")
    w = _bridged()
    two = sc.spawn_async(2, {
        "facts": ("engine_facts", {}),
        "train": ("fraud_optimizer", dict(ckpt=str(base / "two"), epochs=5,
                                          weights=w)),
        "input": ("input_pipeline", dict(n_batches=3)),
        "pipeline": ("fraud_pipeline", dict(
            frame=_pipeline_frame(), cols=[f"v{i}" for i in range(6)],
            weights=_bridged_fraud6(range(2)), n_models=2,
            epochs=2))},
        timeout=120)
    four = engine.spawn(sc.TARGET, 4, {"scenarios": {
        "train": ("fraud_optimizer", dict(ckpt=str(base / "elastic"),
                                          epochs=3, weights=w))}},
        device="cpu", timeout=120)
    resumed = engine.spawn(sc.TARGET, 2, {"scenarios": {
        "train": ("fraud_optimizer", dict(ckpt=str(base / "elastic"),
                                          epochs=6, weights=w,
                                          resume=True))}},
        device="cpu", timeout=120)
    return {"two": two.result(), "four": four, "resumed": resumed,
            "base": base}


@pytest.fixture(scope="module")
def jax_frcnn_init():
    """The reference Faster-RCNN's initial weights (host copies)."""
    return jax.tree_util.tree_map(np.asarray, _jax_frcnn().variables)


@pytest.fixture(scope="module", autouse=True)
def frcnn_group(jax_frcnn_init):
    """Faster-RCNN over 2 ranks, started with the module: dropout on, and
    from the reference's initial weights with dropout off."""
    from analytics_zoo_tpu_torch.models import faster_rcnn
    from analytics_zoo_tpu_torch.ops.proposal import ProposalParam

    net = sc.unfilled(faster_rcnn.FasterRcnnVgg, faster_rcnn.FrcnnParam(
        num_classes=3, pooled=2, proposal=ProposalParam(128, 32)), seed=0)
    w = {k: v.numpy() for k, v in convert.frcnn_params_from_jax(
        jax_frcnn_init["params"], net).items()}
    return sc.spawn_async(2, {
        "frcnn": ("frcnn_train", dict(batches=_frcnn_batches(),
                                      res=FRCNN_RES, shape=(2,),
                                      axes=("data",))),
        "frcnn_jax": ("frcnn_train", dict(batches=_frcnn_batches(),
                                          res=FRCNN_RES, shape=(2,),
                                          axes=("data",), weights=w,
                                          dropout=False))},
        timeout=180)


def test_two_process_distributed_init(runs):
    for r, got in enumerate(x["facts"] for x in runs["two"]):
        assert got["node_number"] == 2 and got["backend"] == "gloo"
        assert got["spans"] is True
        assert got["slice"] == (8 * r, 8)
        assert got["all_reduce"] == [3.0, 3.0, 3.0]


def test_two_process_optimizer_matches_single_process(runs):
    """20 SGD steps of the fraud MLP over 2 ranks, rank 0's snapshot at
    iteration 20 (``world_width`` 2), the ranks' parameters identical and
    equal to the JAX package's single-process run."""
    got = [x["train"] for x in runs["two"]]
    assert [g["steps"] for g in got] == [20, 20]
    assert [g["slice"] for g in got] == [(0, 8), (8, 8)]
    assert got[0]["fingerprint"] == got[1]["fingerprint"]
    assert got[0]["meta"]["iteration"] == 20
    assert got[0]["meta"]["world_width"] == 2
    assert os.path.isdir(runs["base"] / "two" / "latest")
    np.testing.assert_allclose(got[0]["fingerprint"], _jax_fingerprint(5),
                               rtol=FP_RTOL)


def test_four_process_train_then_elastic_resume_as_two(runs):
    """4 ranks to epoch 3 (a snapshot each epoch, ``world_width`` 4), then
    2 ranks resume that snapshot to epoch 6: the final parameters equal
    the JAX package's 6 epochs in one process."""
    four = [x["train"] for x in runs["four"]]
    assert all(g["steps"] == 12 for g in four)
    assert four[0]["meta"]["world_width"] == 4
    assert [g["slice"] for g in four] == [(0, 4), (4, 4), (8, 4), (12, 4)]
    resumed = [x["train"] for x in runs["resumed"]]
    assert all(g["steps"] == 24 for g in resumed)
    assert resumed[0]["meta"]["world_width"] == 2
    assert resumed[0]["meta"]["iteration"] == 24
    assert resumed[0]["fingerprint"] == resumed[1]["fingerprint"]
    np.testing.assert_allclose(resumed[0]["fingerprint"],
                               _jax_fingerprint(6), rtol=FP_RTOL)


def test_make_input_pipeline_gives_each_rank_its_slices(runs):
    """``make_input_pipeline`` over the 2-rank data mesh: every global
    batch of the dataset, each rank's half of its rows, marked for the
    ``Optimizer`` as slices already."""
    for r, got in enumerate(x["input"] for x in runs["two"]):
        assert got["local"] is True and got["len"] == 3
        for i, b in enumerate(got["batches"]):
            full = np.arange(24, dtype=np.float32).reshape(8, 3) + i
            np.testing.assert_array_equal(b["input"],
                                          full[4 * r:4 * (r + 1)])
            np.testing.assert_array_equal(
                b["target"], np.arange(4 * r, 4 * (r + 1)) + 10 * i)
        # the Optimizer counts global samples and trains alike from both
        (n_global, w_global), (n_local, w_local) = got["optimizer"]
        assert n_global == n_local == 48
        for a, b in zip(w_global, w_local):
            np.testing.assert_array_equal(a, b)


def test_train_frcnn_data_parallel_equals_one_process(frcnn_group):
    """``train_frcnn(mesh=)`` over 2 ranks (an image each, dropout on:
    each rank draws its rows of the one-device masks) equals the
    one-process run: the epoch's loss and every trained parameter."""
    import torch

    from analytics_zoo_tpu_torch.models import faster_rcnn
    from analytics_zoo_tpu_torch.ops.proposal import ProposalParam
    from analytics_zoo_tpu_torch.pipelines import frcnn as pipe

    torch.set_num_threads(1)
    model = faster_rcnn.FasterRcnnVgg(
        faster_rcnn.FrcnnParam(num_classes=3, pooled=2,
                               proposal=ProposalParam(128, 32)),
        device="cpu", seed=0)
    losses = []
    pipe.train_frcnn(model, _frcnn_batches(), 64, epochs=1, lr=3e-3,
                     epoch_hook=lambda loop, state: losses.append(
                         float(loop.loss)))
    for got in (x["frcnn"] for x in frcnn_group.result()):
        np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(got["state"][k], v.numpy(),
                                       atol=1e-5, err_msg=k)


def test_run_fraud_pipeline_over_two_ranks_matches_jax(runs):
    """``run_fraud_pipeline(mesh=)`` over 2 ranks (2 bagged classifiers of
    2 epochs each, built from the reference's initial weights of their
    seeds) against
    the JAX package's ``run_fraud_pipeline`` on a (2,) mesh: the best
    vote threshold EQUAL, AUPRC, precision and recall within 1e-6."""
    want = jfraud.run_fraud_pipeline(
        _pipeline_frame(), [f"v{i}" for i in range(6)], n_models=2,
        epochs=2, mesh=create_mesh((2,), axis_names=("data",),
                                   devices=jax.devices()[:2]))
    for got in (x["pipeline"] for x in runs["two"]):
        assert got["best_threshold"] == want.best_threshold
        for k in ("auprc", "precision", "recall"):
            np.testing.assert_allclose(got[k], getattr(want, k), atol=1e-6,
                                       err_msg=k)


def test_train_frcnn_over_a_mesh_matches_jax(frcnn_group, jax_frcnn_init,
                                             monkeypatch):
    """``train_frcnn(mesh=)`` over 2 ranks (an image each) from the
    reference's initial weights, dropout off in both packages, against
    the JAX package's ``train_frcnn`` on a (2,) mesh: the step's loss,
    and every parameter's update within the distance of the two
    packages' one-process steps (module docstring)."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    model = _jax_frcnn()
    losses = []
    jax_frcnn_pipe.train_frcnn(
        model, _frcnn_batches(), FRCNN_RES, epochs=1, lr=3e-3,
        mesh=create_mesh((2,), axis_names=("data",),
                         devices=jax.devices()[:2]),
        epoch_hook=lambda loop, state: losses.append(float(loop.loss)))
    before = convert.flatten_params(jax_frcnn_init["params"])
    after = convert.flatten_params(model.variables["params"])
    for got in (x["frcnn_jax"] for x in frcnn_group.result()):
        np.testing.assert_allclose(got["loss"], losses, rtol=FRCNN_LOSS_TOL)
        state = convert.state_dict_to_flax(
            {k: torch.from_numpy(v) for k, v in got["state"].items()},
            jax_frcnn_init)["params"]
        for k, w0 in before.items():
            want = np.asarray(after[k], np.float64) - w0
            delta = np.asarray(state[k], np.float64) - w0
            err = np.linalg.norm(delta - want) / max(np.linalg.norm(want),
                                                     1e-30)
            tol = (FRCNN_TRUNK_TOL if k.startswith(_BELOW_CONV5_3)
                   else FRCNN_HEAD_TOL)
            assert err <= tol, (k, err)


def test_spawn_fails_loudly_and_kills_its_group():
    """A rank that raises fails the group with its output; a group past
    its deadline is killed and fails; no child outlives the call."""
    with pytest.raises(RuntimeError, match="on purpose"):
        engine.spawn(sc.TARGET, 2, {"scenarios": {
            "x": ("fail_on_rank", dict(rank=1))}}, device="cpu",
            timeout=60)
    with pytest.raises(RuntimeError, match="did not finish within 5 s"):
        engine.spawn(sc.TARGET, 2, {"scenarios": {
            "x": ("sleep", dict(seconds=60))}}, device="cpu", timeout=5)
