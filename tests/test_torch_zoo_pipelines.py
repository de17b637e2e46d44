"""Parity of the port's fraud, recommendation and sentiment pipelines with
the JAX package, on the CPU: the column pipelines (``frame.py``, EQUAL
outputs on the same seeds, the reference's cases of
``tests/test_pipelines.py``), ``auprc`` / ``precision_recall``, one
``MLPClassifier`` / ``train_recommender`` / ``train_sentiment`` step on
bridged weights, the validation methods, each serving tier's forward,
requests through the port's ``ServingRuntime`` against the reference's,
and the ``mesh=`` / ``specs=`` refusals.

Tolerances: host numpy stages EQUAL; the steps' updated parameters
within 1e-5 relative L2 (Adam normalises every gradient entry, so the
summation-order rounding of the gradients moves an update by at most a
few ulps of the learning rate); the validation methods EQUAL on the same
outputs (``Loss`` within 1e-6 relative); the tiers' rows within 1e-5
(int8 rungs on bit-equal int8 leaves).  The sentiment step runs with
dropout off in both packages (their masks come from different
generators).

The reference's recommendation tier cannot serve through its runtime:
the batcher stacks the per-request ``(user, item)`` payloads into one
``(B, 2)`` array, which the tier unpacks as a pair and fails on.  The
port's tier takes both forms (ROADMAP.md Queue 3, "Known deviations").
"""

import flax.linen as flax_nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.serving as jserving
import analytics_zoo_tpu_torch.serving as tserving
from analytics_zoo_tpu.core.criterion import ClassNLLCriterion as JNLL
from analytics_zoo_tpu.core.module import Model as JaxModel
from analytics_zoo_tpu.models import simple as jax_simple
from analytics_zoo_tpu.parallel import train as jax_train
from analytics_zoo_tpu.pipelines import frame as jframe
from analytics_zoo_tpu.pipelines import fraud as jfraud
from analytics_zoo_tpu.pipelines import recommendation as jrec
from analytics_zoo_tpu.pipelines import sentiment as jsent
from analytics_zoo_tpu_torch.core import module as tmodule
from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
from analytics_zoo_tpu_torch.models import simple
from analytics_zoo_tpu_torch.parallel import train as ttrain
from analytics_zoo_tpu_torch.pipelines import frame, fraud, recommendation
from analytics_zoo_tpu_torch.pipelines import sentiment
from analytics_zoo_tpu_torch.utils import convert, quantize

torch.set_num_threads(2)

STEP_RTOL = 1e-5
ROW_ATOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _fraud_frame(n=600, seed=0, d=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d)
    label = ((x @ w) > 1.2).astype(np.int64)
    return {**{f"V{i}": x[:, i] for i in range(d)}, "label": label,
            "time": rng.permutation(n).astype(np.float64)}


def _equal_frames(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


# -- frame.py ----------------------------------------------------------------

def test_frame_stages_equal_jax():
    f = _fraud_frame(300)
    cols = [f"V{i}" for i in range(5)]
    for mod in (frame, jframe):
        assert mod.frame_length(f) == 300
    _equal_frames(frame.FramePipeline([frame.VectorAssembler(cols),
                                       frame.StandardScaler()]
                                      ).fit_transform(f),
                  jframe.FramePipeline([jframe.VectorAssembler(cols),
                                        jframe.StandardScaler()]
                                       ).fit_transform(f))
    remap = lambda v: {0: 2, 2: 0}.get(v, v)             # noqa: E731
    _equal_frames(frame.FuncTransformer(remap, "label", "l2").transform(f),
                  jframe.FuncTransformer(remap, "label", "l2").transform(f))
    for seed, fr in ((1, {0: 0.5, 1: 3.0}), (4, {0: 1.0, 1: 10.5})):
        _equal_frames(frame.StratifiedSampler(fr, seed=seed).transform(f),
                      jframe.StratifiedSampler(fr, seed=seed).transform(f))
    for a, b in zip(frame.time_ordered_split(f, "time", 0.7),
                    jframe.time_ordered_split(f, "time", 0.7)):
        _equal_frames(a, b)
    idx = np.random.RandomState(3).randint(0, 300, 50)
    _equal_frames(frame.frame_select(f, idx), jframe.frame_select(f, idx))
    with pytest.raises(RuntimeError):
        frame.StandardScaler().transform(f)


class _Stub:
    """A deterministic estimator: predicts 1 where feature V<k> > 0,
    ``k`` its index (the stage a ``Bagging`` clones)."""

    def __init__(self, k=0):
        self.k = k
        self.seen = None

    def fit(self, f):
        self.seen = int(np.asarray(f["label"]).sum())
        return self

    def transform(self, f):
        return {**f, "prediction": (np.asarray(f[f"V{self.k}"]) > 0)
                .astype(np.int64)}


@pytest.mark.parametrize("sampler", [None, {0: 1.0, 1: 3.0}])
def test_bagging_equal_jax(sampler):
    f = _fraud_frame(200, seed=5)
    outs, seen = [], []
    for mod in (frame, jframe):
        bag = mod.Bagging(base_fn=lambda i: _Stub(i % 5), n_models=4,
                          sampler=(None if sampler is None else
                                   mod.StratifiedSampler(sampler)),
                          threshold=2, seed=3)
        bag.fit(f)
        seen.append([m.seen for m in bag.models])
        outs.append(bag.transform(f))
    assert seen[0] == seen[1]
    _equal_frames(*outs)
    reg = [mod.Bagging(base_fn=lambda i: _Stub(i % 5), n_models=3,
                       is_classification=False).fit(f).transform(f)
           for mod in (frame, jframe)]
    _equal_frames(*reg)


def test_auprc_and_precision_recall_equal_jax():
    rng = np.random.RandomState(7)
    labels = (rng.rand(500) < 0.05).astype(np.int64)
    for scores in (rng.rand(500), labels * 0.5 + rng.rand(500) * 0.6,
                   np.round(rng.rand(500), 1)):
        assert fraud.auprc(labels, scores) == jfraud.auprc(labels, scores)
    preds = (rng.rand(500) < 0.1).astype(np.int64)
    assert fraud.precision_recall(labels, preds) == \
        jfraud.precision_recall(labels, preds)
    assert fraud.auprc(np.array([1, 1, 0, 0]),
                       np.array([0.9, 0.8, 0.2, 0.1])) == pytest.approx(1.0)


def test_mlp_classifier_learns_on_the_cpu():
    f = frame.FramePipeline([frame.VectorAssembler([f"V{i}" for i in
                                                    range(5)]),
                             frame.StandardScaler()]).fit_transform(
        _fraud_frame(600))
    clf = fraud.MLPClassifier(in_features=5, epochs=12, batch_size=64,
                              lr=5e-3, device="cpu").fit(f)
    out = clf.transform(f)
    assert out["log_probs"].shape == (600, 2)
    assert (out["prediction"] == f["label"]).mean() > 0.85


# -- one step on bridged weights --------------------------------------------

def _assert_params_close(tmodel, jvariables):
    got = convert.state_dict_to_flax(
        dict(tmodel.module.named_parameters()), jvariables)["params"]
    want = convert.flatten_params(jvariables["params"])
    assert set(got) == set(want)
    for k, w in want.items():
        assert _rel(got[k], w) <= STEP_RTOL, k


def test_mlp_classifier_step_matches_jax(monkeypatch):
    """``MLPClassifier.fit`` over one batch of 64 (one Adam step of
    5e-3), its model built on the reference's initial weights."""
    f = {"features": np.random.RandomState(8).randn(64, 29).astype(
        np.float32),
         "label": (np.arange(64) % 3 == 0).astype(np.int64)}
    ref = jfraud.MLPClassifier(epochs=1).fit(f)
    init = JaxModel(jax_simple.FraudMLP()).build(0, jnp.zeros((1, 29)))
    build = tmodule.Model.build

    def bridged_build(self, seed, *examples):
        build(self, seed, *examples)
        return self.load_weights(convert.fraud_mlp_params_from_jax(
            init.variables["params"], self.module))

    monkeypatch.setattr(tmodule.Model, "build", bridged_build)
    clf = fraud.MLPClassifier(epochs=1, device="cpu").fit(f)
    _assert_params_close(clf.model, ref.model.variables)
    np.testing.assert_allclose(clf.transform(f)["log_probs"],
                               ref.transform(f)["log_probs"], atol=ROW_ATOL)


def _rec_pair(kind, n_users=40, n_items=30):
    if kind == "ncf":
        jm = jrec.make_ncf_model(n_users, n_items, embedding_dim=8,
                                 mf_embedding_dim=4, hidden=(16, 8))
        tm = recommendation.make_ncf_model(n_users, n_items, embedding_dim=8,
                                           mf_embedding_dim=4,
                                           hidden=(16, 8), device="cpu")
        bridge = convert.ncf_params_from_jax
    else:
        jm = jrec.make_wide_deep_model(n_users, n_items, embedding_dim=8,
                                       hidden=(16, 8), cross_buckets=50)
        tm = recommendation.make_wide_deep_model(
            n_users, n_items, embedding_dim=8, hidden=(16, 8),
            cross_buckets=50, device="cpu")
        bridge = convert.wide_deep_params_from_jax
    tm.load_weights(bridge(jm.variables["params"], tm.module))
    return jm, tm


def _ratings(seed, n, n_users=40, n_items=30):
    rng = np.random.RandomState(seed)
    return ((rng.zipf(1.3, n) % n_users).astype(np.int32),
            (rng.zipf(1.3, n) % n_items).astype(np.int32),
            rng.randint(1, 6, n).astype(np.int32))


@pytest.mark.parametrize("kind", ["ncf", "wd"])
def test_train_recommender_step_matches_jax(kind):
    jm, tm = _rec_pair(kind)
    batches = recommendation.rating_batches(*_ratings(9, 32), 32)
    jbatches = jrec.rating_batches(*_ratings(9, 32), 32)
    for a, b in zip(batches, jbatches):
        np.testing.assert_array_equal(a["target"], b["target"])
    jrec.train_recommender(jm, jbatches, epochs=1, lr=1e-3)
    recommendation.train_recommender(tm, batches, epochs=1, lr=1e-3)
    _assert_params_close(tm, jm.variables)
    users, items, _ = _ratings(10, 16)
    np.testing.assert_array_equal(
        recommendation.predict_ratings(tm, users, items),
        jrec.predict_ratings(jm, users, items))


@pytest.mark.parametrize("head", ["gru", "cnn"])
def test_train_sentiment_step_matches_jax(head, monkeypatch):
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    monkeypatch.setattr(simple, "dropout", lambda x, rate, gen=None: x)
    kw = dict(vocab_size=60, embedding_dim=8, hidden=16, head=head,
              seq_len=7)
    jm = jsent.make_sentiment_model(**kw)
    tm = sentiment.make_sentiment_model(**kw, device="cpu")
    tm.load_weights(convert.sentiment_params_from_jax(jm.variables["params"],
                                                      tm.module))
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, 60, (16, 7)).astype(np.int32)
    labels = (rng.rand(16) < 0.5).astype(np.float32)
    jsent.train_sentiment(jm, jsent.review_batches(tokens, labels, 16),
                          epochs=1)
    sentiment.train_sentiment(tm, sentiment.review_batches(tokens, labels,
                                                           16), epochs=1)
    _assert_params_close(tm, jm.variables)


def test_train_sentiment_applies_dropout_in_training():
    tm = sentiment.make_sentiment_model(60, 8, 16, head="cnn", seq_len=7,
                                        device="cpu")
    x = np.random.RandomState(12).randint(0, 60, (4, 7)).astype(np.int32)
    with torch.no_grad():
        ev = tm.evaluate()(x)
        tr = tm.train()(x)
    assert not torch.equal(ev, tr)


def test_validation_methods_equal_jax():
    rng = np.random.RandomState(13)
    out = np.log(rng.dirichlet(np.ones(5), 24)).astype(np.float32)
    batch = {"input": None, "target": rng.randint(0, 5, 24).astype(np.int32),
             "target_mask": (rng.rand(24) < 0.8).astype(np.float32)}
    plain = {"input": None, "target": batch["target"]}
    t, j = torch.as_tensor(out), jnp.asarray(out)
    for port, ref, b in ((ttrain.Top1Accuracy(), jax_train.Top1Accuracy(),
                          batch),
                         (ttrain.MAE(), jax_train.MAE(), plain)):
        got, want = port(t, b), ref(j, b)
        assert (got.name, got.value, got.count) == (want.name, want.value,
                                                    want.count)
        assert got.result() == want.result()
    got = ttrain.Loss(ClassNLLCriterion())(t, plain)
    want = jax_train.Loss(JNLL())(j, plain)
    assert got.count == want.count and got.name == want.name == "Loss"
    assert got.value == pytest.approx(want.value, rel=1e-6)
    merged = got + got
    assert merged.count == 2 * got.count


def test_validate_runs_mae_and_loss_on_the_model():
    _, tm = _rec_pair("ncf")
    batches = recommendation.rating_batches(*_ratings(14, 64), 32)
    res = ttrain.validate(tm, batches, [ttrain.MAE(),
                                        ttrain.Loss(ClassNLLCriterion())])
    assert [r.name for r in res] == ["MAE", "Loss"]
    assert res[0].count == 64 and np.isfinite(res[1].result())


# -- serving tiers -----------------------------------------------------------

def _fraud_models():
    jm = JaxModel(jax_simple.FraudMLP()).build(0, jnp.zeros((1, 29)))
    tm = tmodule.Model(simple.FraudMLP(), device="cpu")
    tm.load_weights(convert.fraud_mlp_params_from_jax(jm.variables["params"],
                                                      tm.module))
    return jm, tm


def _sent_models(head="cnn"):
    kw = dict(vocab_size=400, embedding_dim=16, hidden=64, head=head,
              seq_len=12)
    jm = jsent.make_sentiment_model(**kw)
    tm = sentiment.make_sentiment_model(**kw, device="cpu")
    tm.load_weights(convert.sentiment_params_from_jax(jm.variables["params"],
                                                      tm.module))
    return jm, tm


def _tiers(family):
    if family == "fraud":
        jm, tm = _fraud_models()
        x = np.random.RandomState(15).randn(8, 29).astype(np.float32)
        return (jfraud.fraud_serving_tiers(jm),
                fraud.fraud_serving_tiers(tm, device="cpu"), {"input": x})
    if family == "rec":
        jm, tm = _rec_pair("ncf", n_users=600)
        users, items, _ = _ratings(16, 8, n_users=600)
        return (jrec.rec_serving_tiers(jm),
                recommendation.rec_serving_tiers(tm, device="cpu"),
                {"input": (users, items)})
    jm, tm = _sent_models()
    x = np.random.RandomState(17).randint(0, 400, (8, 12)).astype(np.int32)
    return (jsent.sentiment_serving_tiers(jm, seq_len=12),
            sentiment.sentiment_serving_tiers(tm, seq_len=12, device="cpu"),
            {"input": x})


@pytest.mark.parametrize("family", ["fraud", "rec", "sentiment"])
def test_tier_forwards_match_jax(family):
    ref, port, batch = _tiers(family)
    assert [t.name for t in port] == [t.name for t in ref] == ["fp", "int8"]
    assert port[0].speed == 1.0
    for r, p in zip(ref, port):
        want = np.asarray(r.forward(batch))
        got = p.forward(batch)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ROW_ATOL, err_msg=r.name)
        fn, args = p.device_program()
        assert fn(*args).shape[0] == 1
    # the int8 rung quantizes the tables, the convolution and the cells'
    # kernels of at least 4096 entries (FraudMLP has none)
    quantized = sorted(k for k, v in port[1].device_program()[1][0].items()
                       if isinstance(v, quantize.QTensor))
    assert quantized == {"fraud": [], "rec": ["user_embed.embedding"],
                         "sentiment": ["conv.weight", "embed.embedding"]
                         }[family]
    if family == "rec":
        pairs = {"input": np.stack(batch["input"], 1)}
        np.testing.assert_array_equal(port[0].forward(pairs),
                                      port[0].forward(batch))


def _runtime(serving, tiers):
    return serving.ServingRuntime(tiers, n_replicas=1,
                                  clock=serving.VirtualClock(), max_batch=4,
                                  length_key=None, default_deadline_s=60.0,
                                  wedge_timeout_s=60.0,
                                  service_time=lambda e, n, t: 0.01)


@pytest.mark.parametrize("family", ["fraud", "sentiment"])
def test_requests_through_both_runtimes(family):
    ref, port, batch = _tiers(family)
    results = []
    for serving, tiers in ((jserving, ref), (tserving, port)):
        rt = _runtime(serving, tiers)
        for row in batch["input"][:6]:
            rt.submit({"input": row})
        rt.drain()
        assert rt.accounting()["by_state"] == {"done": 6}
        results.append(np.stack([np.asarray(r.result)
                                 for r in rt.requests]))
    np.testing.assert_allclose(results[1], results[0], atol=ROW_ATOL)


def test_rec_pair_requests_through_the_port_runtime():
    """Per-request ``(user, item)`` pairs: the port's runtime serves each
    row as the reference tier's direct forward on the pair form; the
    reference's runtime fails every one (the batcher's ``(B, 2)``
    array)."""
    ref, port, batch = _tiers("rec")
    users, items = batch["input"]
    rt = _runtime(tserving, port)
    for u, i in zip(users[:6], items[:6]):
        rt.submit({"input": np.array([u, i], np.int32)})
    rt.drain()
    assert rt.accounting()["by_state"] == {"done": 6}
    want = np.asarray(ref[0].forward({"input": (users[:6], items[:6])}))
    got = np.stack([np.asarray(r.result) for r in rt.requests])
    np.testing.assert_allclose(got, want, atol=ROW_ATOL)
    jrt = _runtime(jserving, ref)
    for u, i in zip(users[:4], items[:4]):
        jrt.submit({"input": np.array([u, i], np.int32)})
    jrt.drain()
    assert jrt.accounting()["by_state"] == {"failed": 4}
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        port[0].forward({"input": np.zeros((4, 3), np.int32)})


def test_mesh_and_specs_are_refused_naming_item_12():
    """Once refused, now served: training over a mesh
    (``tests/test_torch_dist_train.py``; a one-rank mesh here) and sharded
    serving (item 12b.4; two ranks in ``tests/test_torch_specs.py``): over
    a one-rank mesh the ``specs=`` rungs give the plain rungs' rows."""
    import torch_dist_scenarios as sc
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs
    _, tm = _rec_pair("ncf")
    one = sc.StubMesh({"data": 1})
    assert fraud.MLPClassifier(mesh=one).mesh is one
    assert recommendation.train_recommender(tm, [], epochs=0,
                                            mesh=one) is tm
    assert sentiment.train_sentiment(tm, [], epochs=0, mesh=one) is tm
    users, items, _ = _ratings(16, 8, n_users=600)
    rng = np.random.RandomState(17)
    cases = (
        ("fraud", fraud.fraud_serving_tiers, _fraud_models()[1], {},
         {"input": rng.randn(8, 29).astype(np.float32)}),
        ("rec", recommendation.rec_serving_tiers,
         _rec_pair("ncf", n_users=600)[1], {}, {"input": (users, items)}),
        ("sentiment", sentiment.sentiment_serving_tiers, _sent_models()[1],
         {"seq_len": 12},
         {"input": rng.randint(0, 400, (8, 12)).astype(np.int32)}))
    for family, build, model, kw, batch in cases:
        plain = build(model, device="cpu", **kw)
        sharded = build(model, specs=pipeline_specs(family, mesh=one),
                        device="cpu", **kw)
        for p, q in zip(plain, sharded):
            np.testing.assert_array_equal(q.forward(batch), p.forward(batch))


def test_run_fraud_pipeline_on_the_cpu():
    rng = np.random.RandomState(18)
    n = 1200
    x = rng.randn(n, 6).astype(np.float32)
    label = ((x[:, 0] + 0.5 * x[:, 1]) > 1.8).astype(np.int64)
    f = {**{f"v{i}": x[:, i] for i in range(6)}, "label": label,
         "time": np.arange(n, dtype=np.float64)}
    res = fraud.run_fraud_pipeline(f, [f"v{i}" for i in range(6)],
                                   n_models=2, epochs=2, device="cpu")
    assert isinstance(res, fraud.FraudResult)
    assert 0.0 <= res.auprc <= 1.0 and res.best_threshold in (1, 2)
    with pytest.raises(ValueError, match="threshold"):
        fraud.run_fraud_pipeline(f, ["v0"], n_models=2, thresholds=[5],
                                 device="cpu")


def test_visualizer_equal_jax(tmp_path):
    from analytics_zoo_tpu.pipelines import visualizer as jvis
    from analytics_zoo_tpu_torch.pipelines import visualizer

    rng = np.random.RandomState(19)
    image = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    dets = np.array([[3, 0.9, 10, 12, 80, 90], [-1, 0.0, 0, 0, 0, 0],
                     [15, 0.2, 5, 5, 40, 60], [25, 0.7, 30, 2, 150, 110]],
                    np.float32)
    got = visualizer.vis_detection(image, dets,
                                   out_path=str(tmp_path / "a" / "v.jpg"))
    np.testing.assert_array_equal(got, jvis.vis_detection(image, dets))
    assert (tmp_path / "a" / "v.jpg").exists()
    assert visualizer.result_to_string(dets) == jvis.result_to_string(dets)
