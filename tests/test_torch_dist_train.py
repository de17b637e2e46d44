"""Data- and tensor-parallel training of the port over four gloo ranks
against the JAX package on meshes of the same shapes.

One group of four spawned ranks (``torch_dist_scenarios``, no JAX) runs:
``train_ds2`` data parallel on a (4,) mesh and tensor parallel under
``default_tp_rules`` on a ("data", "model") (2, 2) mesh; the global-batch
parts of a sharded step (MultiBoxLoss with positives uneven over the
ranks, DS2's sequence BN, a masked criterion mean, a dropout mask); the
recommender with row-sharded tables on (2, 2); the sentiment trainer
on (2, 2) with its table row-sharded and on (4,) with dropout on; the
fraud ``MLPClassifier`` on (4,); one ``make_train_step(specs=,
grad_accum=2)`` step.  The JAX package runs the same on its virtual CPU
devices (the reference's sharded step computes the one-device step, so
its loss is the global batch's); weights cross over through
``utils/convert.py``.  Tolerances: losses 1e-5 relative (DP) and 1e-4
(TP, the reference's rtol), parameters as ``test_torch_ds2_train.py``
holds a DS2 run, the global-batch parts 1e-5 absolute; the fraud and
sentiment runs with dropout off against JAX, each parameter within
``ZOO_RTOL`` relative L2 (Adam normalises every gradient entry, so a
summation-order rounding of a gradient moves an update by a few ulps
of the learning rate each step).  Runs with dropout on (the packages
draw their masks from different generators) are held to the port's own
one-process run.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_scenarios as sc
from analytics_zoo_tpu.core.criterion import ClassNLLCriterion as JaxNLL
from analytics_zoo_tpu.core.module import Model as JaxModel
from analytics_zoo_tpu.models.simple import FraudMLP as JaxFraudMLP
from analytics_zoo_tpu.models.deepspeech2 import SequenceBN as JaxBN
from analytics_zoo_tpu.ops.multibox_loss import MultiBoxLossParam as JaxMBP
from analytics_zoo_tpu.ops.multibox_loss import multibox_loss as jax_mbl
from analytics_zoo_tpu.parallel import SGD as JaxSGD
from analytics_zoo_tpu.parallel import create_mesh, default_tp_rules
from analytics_zoo_tpu.parallel import train as jax_train
from analytics_zoo_tpu.parallel.specs import SpecSet as JaxSpecSet
from analytics_zoo_tpu.pipelines import deepspeech2 as jax_pipe
from analytics_zoo_tpu.pipelines import fraud as jfraud
from analytics_zoo_tpu.pipelines import recommendation as jrec
from analytics_zoo_tpu.pipelines import sentiment as jsent
from analytics_zoo_tpu_torch.core.layers import dropout
from analytics_zoo_tpu_torch.core.module import Model
from analytics_zoo_tpu_torch.models.deepspeech2 import DeepSpeech2
from analytics_zoo_tpu_torch.models.simple import FraudMLP
from analytics_zoo_tpu_torch.pipelines import sentiment
from analytics_zoo_tpu_torch.utils import convert

WORLD = 4
LOSS_RTOL = 1e-5
TP_RTOL, TP_ATOL = 1e-4, 1e-5
PART_ATOL = 1e-5
DS2_LR, DS2_STEPS = 3e-4, 2
BEFORE_BN = ("conv1/bias", "proj0/bias")
AFTER_BIAS = ("bn_conv1/BatchNorm_0/mean", "bn_rnn0/BatchNorm_0/mean")
DROPOUT_SHAPE = (8, 6)
ZOO_RTOL = 1e-5
ACCUM_LR = 0.1


def _ds2_batches():
    rng = np.random.RandomState(5)
    out = []
    for _ in range(DS2_STEPS):
        n = np.array([16, 13, 9, 16], np.int32)
        labels = rng.randint(1, 29, (4, 4)).astype(np.int32)
        mask = (np.arange(4)[None] < np.array([4, 3, 2, 3])[:, None])
        out.append({"input": (rng.randn(4, 16, 13).astype(np.float32), n),
                    "n_frames": n, "labels": labels,
                    "label_mask": mask.astype(np.float32)})
    return out


def _ds2_batch8():
    rng = np.random.RandomState(12)
    n = np.array([16, 13, 9, 16, 11, 16, 7, 14], np.int32)
    labels = rng.randint(1, 29, (8, 4)).astype(np.int32)
    mask = (np.arange(4)[None] < np.array([4, 3, 2, 3, 2, 4, 1, 3])[:, None])
    return {"input": (rng.randn(8, 16, 13).astype(np.float32), n),
            "n_frames": n, "labels": labels,
            "label_mask": mask.astype(np.float32)}


def _multibox_inputs():
    rng = np.random.RandomState(3)
    P, G = 48, 3
    lo = rng.uniform(0, 0.7, (P, 2))
    priors = np.concatenate([lo, lo + rng.uniform(0.1, 0.3, (P, 2))],
                            1).astype(np.float32)
    variances = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (P, 1))
    gt = priors[rng.choice(P, (4, G))] + rng.uniform(
        -0.02, 0.02, (4, G, 4)).astype(np.float32)
    mask = np.ones((4, G), np.float32)
    mask[1] = [1, 0, 0]
    mask[2] = 0                      # a rank with no positive at all
    return {"priors": priors, "variances": variances,
            "loc": rng.randn(4, P, 4).astype(np.float32),
            "conf": rng.randn(4, P, 4).astype(np.float32),
            "target": {"bboxes": gt.astype(np.float32),
                       "labels": rng.randint(1, 4, (4, G)).astype(np.int32),
                       "mask": mask}}


def _bn_inputs():
    rng = np.random.RandomState(4)
    x = (rng.randn(4, 6, 5) * 2 + 1).astype(np.float32)
    mask = (np.arange(6)[None] < np.array([6, 2, 5, 1])[:, None])[..., None]
    return {"x": x, "mask": mask, "g": rng.randn(4, 6, 5).astype(np.float32)}


def _masked_inputs():
    rng = np.random.RandomState(6)
    lp = np.log(np.random.RandomState(7).dirichlet(np.ones(5), (4, 3))
                ).astype(np.float32)
    return {"log_probs": lp,
            "target": rng.randint(0, 5, (4, 3)).astype(np.int32),
            "mask": np.float32([[1, 1, 1], [1, 0, 0], [0, 0, 0], [1, 1, 0]])}


def _ratings(seed, n, n_users=40, n_items=30):
    rng = np.random.RandomState(seed)
    return ((rng.zipf(1.3, n) % n_users).astype(np.int32),
            (rng.zipf(1.3, n) % n_items).astype(np.int32),
            rng.randint(1, 6, n).astype(np.int32))


REC_KW = dict(n_users=40, n_items=30, embedding_dim=8, mf_embedding_dim=4,
              hidden=(16, 8))
SENT_KW = dict(vocab_size=64, embedding_dim=8, hidden=8, head="gru",
               seq_len=12)
FRAUD_KW = dict(in_features=6, hidden=10, epochs=2, batch_size=16)


def _fraud_frame():
    rng = np.random.RandomState(8)
    x = rng.randn(64, 6).astype(np.float32)
    return {"features": x, "label": (x[:, 0] + x[:, 1] > 0).astype(np.int32)}


def _jax_ds2():
    return jax_pipe.make_ds2_model(hidden=16, n_rnn_layers=1,
                                   rnn_engine="blocked", utt_length=16)


def _jax_fraud_init():
    m = JaxModel(JaxFraudMLP(in_features=FRAUD_KW["in_features"],
                             hidden=FRAUD_KW["hidden"], n_classes=2))
    return m.build(0, jnp.zeros((1, FRAUD_KW["in_features"])))


def _sentiment_inputs():
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, 64, (32, 12)).astype(np.int32)
    labels = (rng.rand(32) < 0.5).astype(np.float32)
    return sentiment.review_batches(tokens, labels, 16)


@pytest.fixture(scope="module")
def ranks():
    """Every scenario's results, one group of WORLD ranks (a future: the
    ranks run while the tests compute the JAX side)."""
    jmodel = _jax_ds2()
    port = DeepSpeech2(hidden=16, n_rnn_layers=1, device="cpu")
    ds2_w = {k: v.numpy() for k, v in convert.flax_variables_to_state_dict(
        jmodel.variables, port).items()}
    jm = jrec.make_ncf_model(**REC_KW)
    from analytics_zoo_tpu_torch.pipelines import recommendation
    rec_port = recommendation.make_ncf_model(**REC_KW, device="cpu")
    rec_w = {k: v.numpy() for k, v in convert.ncf_params_from_jax(
        jm.variables["params"], rec_port.module).items()}
    sent = sentiment.make_sentiment_model(**SENT_KW, device="cpu")
    sent_w = {k: v.detach().numpy() for k, v in
              sent.module.state_dict().items()}
    rec_batches = recommendation.rating_batches(*_ratings(9, 64), 16)
    fraud_port = Model(FraudMLP(in_features=FRAUD_KW["in_features"],
                                hidden=FRAUD_KW["hidden"], n_classes=2),
                       device="cpu").build(0, np.zeros(
                           (1, FRAUD_KW["in_features"]), np.float32))
    fraud_w = {k: v.numpy() for k, v in convert.fraud_mlp_params_from_jax(
        _jax_fraud_init().variables["params"], fraud_port.module).items()}
    sent_jax_w = {k: v.numpy() for k, v in
                  convert.sentiment_params_from_jax(
                      jsent.make_sentiment_model(**SENT_KW).variables[
                          "params"], sent.module).items()}
    scenarios = {
        "ds2_dp": ("ds2_train", dict(weights=ds2_w, batches=_ds2_batches(),
                                     shape=(WORLD,), axes=("data",),
                                     rules=False)),
        "ds2_tp": ("ds2_train", dict(weights=ds2_w, batches=_ds2_batches(),
                                     shape=(2, 2), axes=("data", "model"),
                                     rules=True)),
        "accum": ("ds2_accum", dict(weights=ds2_w, batch=_ds2_batch8(),
                                    grad_accum=2)),
        "parts": ("global_batch_parts", dict(
            multibox=_multibox_inputs(), bn=_bn_inputs(),
            masked=_masked_inputs(), dropout_shape=(2, 6))),
        "rec": ("zoo_train", dict(kind="rec", weights=rec_w,
                                  batches=rec_batches, shape=(2, 2),
                                  axes=("data", "model"), model_kw=REC_KW)),
        "sentiment": ("zoo_train", dict(
            kind="sentiment", weights=sent_w, batches=_sentiment_inputs(),
            shape=(WORLD,), axes=("data",), model_kw=SENT_KW)),
        "fraud": ("zoo_train", dict(kind="fraud", weights=None,
                                    batches=_fraud_frame(), shape=(WORLD,),
                                    axes=("data",), model_kw=FRAUD_KW)),
        "fraud_jax": ("zoo_train", dict(kind="fraud", weights={0: fraud_w},
                                        batches=_fraud_frame(),
                                        shape=(WORLD,), axes=("data",),
                                        model_kw=FRAUD_KW)),
        "sentiment_jax": ("zoo_train", dict(
            kind="sentiment", weights=sent_jax_w,
            batches=_sentiment_inputs(), shape=(2, 2),
            axes=("data", "model"), model_kw=SENT_KW, dropout=False)),
    }
    return sc.spawn_async(WORLD, scenarios)


def _jax_losses(monkeypatch, run):
    """Run ``run()`` with the JAX ``Optimizer``'s per-step losses kept."""
    seen = []

    class Losses:
        def __init__(self):
            self.values = []

        def add_scalar(self, tag, value, step):
            if tag == "Loss":
                self.values.append(float(value))

    base = jax_train.Optimizer.optimize

    def optimize(self):
        self.train_summary = Losses()
        seen.append(self)
        return base(self)

    monkeypatch.setattr(jax_train.Optimizer, "optimize", optimize)
    run()
    return seen[0].train_summary.values


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_train_ds2_over_a_mesh_matches_jax(ranks, mode, monkeypatch):
    """``train_ds2(mesh=)`` on a (4,) data mesh, and with
    ``param_rules=default_tp_rules()`` on a (2, 2) data × model mesh: the
    losses of both steps, the final parameters and batch statistics, on
    every rank alike, against the JAX package's ``train_ds2`` on a mesh
    of the same shape."""
    jmodel = _jax_ds2()
    init = jax.tree_util.tree_map(np.asarray, jmodel.variables)
    if mode == "dp":
        jmesh = create_mesh((WORLD,), devices=jax.devices()[:WORLD])
        rules = None
    else:
        jmesh = create_mesh((2, 2), axis_names=("data", "model"),
                            devices=jax.devices()[:4])
        rules = default_tp_rules()
    want = _jax_losses(monkeypatch, lambda: jax_pipe.train_ds2(
        jmodel, _ds2_batches(), epochs=1, mesh=jmesh, param_rules=rules))
    got = [r[f"ds2_{mode}"] for r in ranks.result()]
    assert len(want) == DS2_STEPS
    rtol = LOSS_RTOL if mode == "dp" else TP_RTOL
    for r in got:
        np.testing.assert_allclose(r["losses"], want, rtol=rtol)
        assert r["losses"] == got[0]["losses"]
    assert (got[0]["sharded"] > 0) == (mode == "tp")
    state = convert.state_dict_to_flax(
        {k: torch.from_numpy(v) for k, v in got[0]["state"].items()}, init)
    for coll in ("params", "batch_stats"):
        for k, v in convert.flatten_params(jmodel.variables[coll]).items():
            atol = (2 * DS2_LR * DS2_STEPS if k in BEFORE_BN
                    else 0.2 * DS2_LR * DS2_STEPS if k in AFTER_BIAS
                    else 1e-5)
            np.testing.assert_allclose(state[coll][k], np.asarray(v),
                                       atol=atol, err_msg=k)
    for r in got[1:]:
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, got[0]["state"][k], err_msg=k)


def test_multibox_loss_global_positives(ranks):
    """MultiBoxLoss over four ranks whose positives are uneven (one has
    none): the ranks' mean loss is the reference's loss of the whole
    batch, and each rank's input gradient (over the width) its rows of
    the whole batch's gradient."""
    m = _multibox_inputs()
    t = m["target"]

    def loss(loc, conf):
        return jax_mbl(loc, conf, jnp.asarray(m["priors"]),
                       jnp.asarray(m["variances"]),
                       jnp.asarray(t["bboxes"]), jnp.asarray(t["labels"]),
                       jnp.asarray(t["mask"]), JaxMBP(n_classes=4))

    want, (g_loc, g_conf) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(m["loc"]), jnp.asarray(m["conf"]))
    parts = [r["parts"]["multibox"] for r in ranks.result()]
    assert len({p[0] for p in parts}) > 1, "the ranks' losses are all equal"
    np.testing.assert_allclose(np.mean([p[0] for p in parts]), float(want),
                               rtol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([p[1] for p in parts]) / WORLD, np.asarray(g_loc),
        atol=PART_ATOL)
    np.testing.assert_allclose(
        np.concatenate([p[2] for p in parts]) / WORLD, np.asarray(g_conf),
        atol=PART_ATOL)


def test_sequence_bn_global_statistics(ranks):
    """DS2's sequence BN in a data-parallel step: each rank's rows of the
    output, its input gradient and the running statistics (alike on
    every rank) are the flax BN's over the whole masked batch."""
    b = _bn_inputs()
    jbn = JaxBN()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(b["x"]))

    def fwd(x):
        return jbn.apply(variables, x, train=True, mask=b["mask"],
                         mutable=["batch_stats"])

    want, stats = fwd(jnp.asarray(b["x"]))
    g_x = jax.grad(lambda x: jnp.sum(fwd(x)[0] * b["g"]))(
        jnp.asarray(b["x"]))
    parts = [r["parts"]["bn"] for r in ranks.result()]
    np.testing.assert_allclose(np.concatenate([p[0] for p in parts]),
                               np.asarray(want), atol=PART_ATOL)
    np.testing.assert_allclose(np.concatenate([p[3] for p in parts]),
                               np.asarray(g_x), atol=PART_ATOL)
    flat = convert.flatten_params(stats["batch_stats"])
    for p in parts:
        np.testing.assert_allclose(p[1], flat["BatchNorm_0/mean"],
                                   atol=PART_ATOL)
        np.testing.assert_allclose(p[2], flat["BatchNorm_0/var"],
                                   atol=PART_ATOL)


def test_masked_mean_and_dropout_rows(ranks):
    """A masked ``ClassNLLCriterion`` mean over ranks with uneven masks
    (one all masked) is the reference's global mean, its gradient the
    global one; a dropout mask drawn in the step gives each rank its rows
    of the one-device mask."""
    c = _masked_inputs()
    want, g = jax.value_and_grad(lambda lp: JaxNLL()(
        lp, jnp.asarray(c["target"]), mask=jnp.asarray(c["mask"])))(
        jnp.asarray(c["log_probs"]))
    parts = [r["parts"]["masked"] for r in ranks.result()]
    np.testing.assert_allclose(np.mean([p[0] for p in parts]), float(want),
                               rtol=1e-6)
    np.testing.assert_allclose(np.concatenate([p[1] for p in parts]) / WORLD,
                               np.asarray(g), atol=PART_ATOL)
    one = dropout(torch.ones(DROPOUT_SHAPE), 0.5,
                  torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_array_equal(
        np.concatenate([r["parts"]["dropout"] for r in ranks.result()]),
        one)


def test_train_recommender_row_sharded_matches_jax(ranks, monkeypatch):
    """``train_recommender(mesh=)`` on a (2, 2) mesh, the NeuralCF tables
    row-sharded over ``model``: the losses and the final parameters
    against the JAX package's on the same mesh."""
    jm = jrec.make_ncf_model(**REC_KW)
    jmesh = create_mesh((2, 2), axis_names=("data", "model"),
                        devices=jax.devices()[:4])
    want = _jax_losses(monkeypatch, lambda: jrec.train_recommender(
        jm, jrec.rating_batches(*_ratings(9, 64), 16), epochs=1,
        mesh=jmesh))
    got = ranks.result()[0]["rec"]
    assert got["sharded"] >= 2
    np.testing.assert_allclose(got["losses"], want, rtol=TP_RTOL)
    state = convert.state_dict_to_flax(
        {k: torch.from_numpy(v) for k, v in got["state"].items()},
        jm.variables)["params"]
    for k, v in convert.flatten_params(jm.variables["params"]).items():
        np.testing.assert_allclose(state[k], np.asarray(v), atol=TP_ATOL,
                                   rtol=TP_RTOL, err_msg=k)


def test_mlp_classifier_over_a_mesh_equals_one_process(ranks):
    """The fraud ``MLPClassifier(mesh=)`` on a (4,) data mesh: its losses
    and weights equal the one-process classifier's (held to the
    reference by ``test_torch_zoo_pipelines.py``)."""
    from analytics_zoo_tpu_torch.pipelines import fraud
    runs = []
    base = fraud.Optimizer

    class Recording(base):
        def optimize(self):
            runs.append(self)
            return super().optimize()

    fraud.Optimizer = Recording
    try:
        clf = fraud.MLPClassifier(**FRAUD_KW, device="cpu").fit(
            _fraud_frame())
    finally:
        fraud.Optimizer = base
    got = ranks.result()[0]["fraud"]
    np.testing.assert_allclose(got["losses"],
                               [float(m["loss"]) for m in runs[0].history],
                               rtol=LOSS_RTOL)
    for k, v in clf.model.module.state_dict().items():
        np.testing.assert_allclose(got["state"][k], v.numpy(), atol=1e-6,
                                   err_msg=k)


def test_train_sentiment_data_parallel_equals_one_process(ranks):
    """``train_sentiment(mesh=)`` on a (4,) data mesh equals the
    one-process run on the same batches, dropout included (each rank
    draws its rows of the one-device masks)."""
    model = sentiment.make_sentiment_model(**SENT_KW, device="cpu")
    runs = []
    base = sentiment.Optimizer

    class Recording(base):
        def optimize(self):
            runs.append(self)
            return super().optimize()

    sentiment.Optimizer = Recording
    try:
        sentiment.train_sentiment(model, _sentiment_inputs(), epochs=1)
    finally:
        sentiment.Optimizer = base
    got = ranks.result()[0]["sentiment"]
    np.testing.assert_allclose(got["losses"],
                               [float(m["loss"]) for m in runs[0].history],
                               rtol=LOSS_RTOL)
    for k, v in model.module.state_dict().items():
        np.testing.assert_allclose(got["state"][k], v.numpy(), atol=1e-5,
                                   err_msg=k)


def test_grad_accum_microbatches_are_the_one_device_steps(ranks):
    """``make_train_step(specs=, grad_accum=2)`` over four ranks: each rank
    keeps its share of each global microbatch, so the sequence BN and the
    CTC mean see the one-device step's microbatches; the loss and the
    parameters after one SGD step equal the one-process step's."""
    from analytics_zoo_tpu_torch.parallel import (SGD, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe

    jmodel = _jax_ds2()
    model = DeepSpeech2(hidden=16, n_rnn_layers=1, device="cpu")
    model.load_state_dict(convert.flax_variables_to_state_dict(
        jmodel.variables, model))
    optim = SGD(0.1)
    step = make_train_step(model, pipe.ds2_ctc_criterion(), optim,
                           grad_accum=2)
    _, metrics = step(create_train_state(model, optim), _ds2_batch8())
    for r in ranks.result():
        got = r["accum"]
        np.testing.assert_allclose(got["loss"], metrics["loss"].item(),
                                   rtol=LOSS_RTOL)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(got["state"][k], v.numpy(),
                                       atol=1e-6, err_msg=k)


def _assert_state_matches_jax(state, jvariables, rtol):
    """Every parameter of a gathered port state within ``rtol`` relative
    L2 of the JAX package's."""
    got = convert.state_dict_to_flax(
        {k: torch.from_numpy(v) for k, v in state.items()},
        jvariables)["params"]
    want = convert.flatten_params(jvariables["params"])
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(np.asarray(got[k], np.float64) - w) / max(
            np.linalg.norm(w), 1e-30)
        assert err <= rtol, (k, err)


def test_mlp_classifier_over_a_mesh_matches_jax(ranks, monkeypatch):
    """The fraud ``MLPClassifier(mesh=)`` on a (4,) data mesh, built from
    the reference's initial weights: 8 Adam steps' losses and the final
    parameters against the JAX package's classifier on a (4,) mesh."""
    jmesh = create_mesh((WORLD,), devices=jax.devices()[:WORLD])
    fitted = []
    want = _jax_losses(monkeypatch, lambda: fitted.append(
        jfraud.MLPClassifier(**FRAUD_KW, mesh=jmesh).fit(_fraud_frame())))
    for r in ranks.result():
        got = r["fraud_jax"]
        assert len(got["losses"]) == len(want) == 8
        np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
        _assert_state_matches_jax(got["state"], fitted[0].model.variables,
                                  ZOO_RTOL)


def test_train_sentiment_over_a_mesh_matches_jax(ranks, monkeypatch):
    """``train_sentiment(mesh=)`` on a (2, 2) data × model mesh, its
    embedding table row-sharded over ``model`` (``shard_tables``), dropout
    off in both packages: the losses and the final parameters against
    the JAX package's ``train_sentiment`` on a (2, 2) mesh."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    jm = jsent.make_sentiment_model(**SENT_KW)
    jmesh = create_mesh((2, 2), axis_names=("data", "model"),
                        devices=jax.devices()[:4])
    batches = _sentiment_inputs()
    want = _jax_losses(monkeypatch, lambda: jsent.train_sentiment(
        jm, batches, epochs=1, mesh=jmesh))
    for r in ranks.result():
        got = r["sentiment_jax"]
        assert got["sharded"] >= 1
        np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
        _assert_state_matches_jax(got["state"], jm.variables, ZOO_RTOL)


def test_grad_accum_over_four_ranks_matches_jax(ranks):
    """One ``make_train_step(specs=, grad_accum=2)`` SGD step of a DS2
    over four ranks against the JAX package's ``make_train_step(specs=,
    grad_accum=2)`` on a (4,) mesh: the loss, the parameters and the
    batch statistics."""
    jmodel = _jax_ds2()
    variables = jax.tree_util.tree_map(np.asarray, jmodel.variables)
    jopt = JaxSGD(ACCUM_LR)
    specs = JaxSpecSet(create_mesh((WORLD,), devices=jax.devices()[:WORLD]))
    jstep = jax_train.make_train_step(jmodel.module,
                                      jax_pipe.ds2_ctc_criterion(), jopt,
                                      specs=specs, grad_accum=2)
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.array, variables["params"]),
        model_state={"batch_stats": jax.tree_util.tree_map(
            jnp.array, variables["batch_stats"])},
        opt_state=jopt.tx.init(variables["params"]),
        rng=jax.random.PRNGKey(0))
    jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                      _ds2_batch8()), 1.0)
    want = {"params": jstate.params,
            "batch_stats": jstate.model_state["batch_stats"]}
    for r in ranks.result():
        got = r["accum"]
        np.testing.assert_allclose(got["loss"], float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        state = convert.state_dict_to_flax(
            {k: torch.from_numpy(v) for k, v in got["state"].items()},
            variables)
        for coll in ("params", "batch_stats"):
            for k, v in convert.flatten_params(want[coll]).items():
                np.testing.assert_allclose(state[coll][k], np.asarray(v),
                                           atol=1e-5, err_msg=k)
