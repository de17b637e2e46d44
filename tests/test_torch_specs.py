"""The declare-once sharding substrate of the port (``parallel/specs.py``)
against the JAX package's (``tests/test_specs.py``).

1. **Structure match**: every registered pipeline's spec map covers the
   port model's parameters, and each spec is the reference's for the same
   flax leaf, carried onto the torch layout (a kernel's "output
   features" are dim 0 of a torch weight); the reference resolves on a
   (2, 4) data × model mesh, the port on a stand-in of the same widths.
2. **Roundtrip identity**: ``place_state`` → ``gather`` returns the
   placed bytes, at world 1 and at world 2 (replicated and under
   ``default_tp_rules`` on a (1, 2) mesh), optimizer slots included.
3. **The annotated step**: ``make_eval_step(specs=)`` equals the plain
   forward, a ragged batch included; ``place_batch`` keeps a rank's rows,
   scalars whole; the batch spec trees.
4. **Sharded serving** (two ranks on a ``("data",)`` mesh of 2): the six
   tier families built with ``specs=`` (SSD300 and Faster-RCNN through
   the DetectionOutput on each rank's rows, DS2, fraud, rec, sentiment)
   give every rank, for an even batch, the one-process rungs' rows of
   each rank's half in rank order, and for a ragged batch the
   one-process rows of the whole (it runs whole on every rank):
   transcripts EQUAL, classes EQUAL, numbers within 1e-5 and
   Faster-RCNN's pixel boxes within 1e-2 px, ``tests/test_torch_frcnn.py``'s
   tolerance (one intra-op thread in the ranks, several here); every
   family's rungs equal the JAX package's rungs built with ``specs=``
   on a 2-device CPU mesh from the same weights (rows within 1e-5, the
   detectors' classes EQUAL, scores within 1e-5 and boxes within 1e-4
   normalized or 1e-2 px, the transcripts EQUAL).  ``ServingRuntime(specs=)`` on rank 0 with
   ``serve_follower`` on rank 1, under a ``VirtualClock`` and a
   ``MonotonicClock``: every request done, its rows those of the
   one-process rung within 1e-6; a follower whose forward raises once
   fails that dispatch, which fails over (nothing hangs); a follower
   that fails before its tier runs (a rung it lacks, a fault in its
   placement of the rows) fails that call on the leader, and the next
   call serves; a hot swap
   builds the new tiers on both ranks and serves the new weights' rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_dist_scenarios as sc
from analytics_zoo_tpu.core.module import Model as JaxModel
from analytics_zoo_tpu.parallel import create_mesh as jax_mesh
from analytics_zoo_tpu.parallel import pipeline_specs as jax_pipeline_specs
from analytics_zoo_tpu.parallel import (
    registered_pipelines as jax_registered)
from analytics_zoo_tpu_torch.core.module import Model
from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
from analytics_zoo_tpu_torch.parallel import specs as specs_lib
from analytics_zoo_tpu_torch.parallel.mesh import PartitionSpec as P
from analytics_zoo_tpu_torch.utils import convert

_VARIANTS = {
    "ssd": [{}, {"tp": "megatron"}],
    "frcnn": [{}],
    "ds2": [{}],
    "fraud": [{}],
    "rec": [{}, {"shard_tables": False}],
    "sentiment": [{}, {"shard_tables": False}],
}


def _models(name):
    """(the reference's params tree, the port's network) of the smallest
    real model of each registered pipeline."""
    if name == "ssd":
        from analytics_zoo_tpu.models import SSDVgg as JSSD
        from analytics_zoo_tpu_torch.models.ssd import SSDVgg
        shapes = jax.eval_shape(JSSD(num_classes=4, resolution=300).init,
                                jax.random.PRNGKey(0),
                                jnp.zeros((1, 300, 300, 3), jnp.float32))
        return shapes["params"], SSDVgg(4, 300, device="cpu")
    if name == "frcnn":
        from analytics_zoo_tpu.models import FasterRcnnVgg as JF
        from analytics_zoo_tpu.models import FrcnnParam as JFP
        from analytics_zoo_tpu.ops.proposal import ProposalParam as JPP
        from analytics_zoo_tpu_torch.models import faster_rcnn
        from analytics_zoo_tpu_torch.ops.proposal import ProposalParam
        jnet = JF(param=JFP(num_classes=4, proposal=JPP(64, 16)))
        shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 128, 128, 3)), jnp.ones((1, 3)))
        # names and shapes only: no seeded draw of its 137M parameters
        return shapes["params"], sc.unfilled(
            faster_rcnn.FasterRcnnVgg,
            faster_rcnn.FrcnnParam(num_classes=4,
                                   proposal=ProposalParam(64, 16)))
    if name == "ds2":
        from analytics_zoo_tpu.models.deepspeech2 import DeepSpeech2 as JD
        from analytics_zoo_tpu_torch.models.deepspeech2 import DeepSpeech2
        shapes = jax.eval_shape(JD(hidden=16, n_rnn_layers=1).init,
                                jax.random.PRNGKey(0), jnp.zeros((1, 32, 13)))
        return (shapes["params"],
                DeepSpeech2(hidden=16, n_rnn_layers=1, device="cpu"))
    if name == "fraud":
        from analytics_zoo_tpu.models import FraudMLP as JF
        from analytics_zoo_tpu_torch.models.simple import FraudMLP
        jm = JaxModel(JF(in_features=29, hidden=10, n_classes=2))
        jm.build(0, jnp.zeros((1, 29), jnp.float32))
        m = Model(FraudMLP(in_features=29, hidden=10, n_classes=2),
                  device="cpu").build(0, np.zeros((1, 29), np.float32))
        return jm.variables["params"], m.module
    if name == "rec":
        from analytics_zoo_tpu.pipelines import recommendation as jrec
        from analytics_zoo_tpu_torch.pipelines import recommendation
        kw = dict(n_users=16, n_items=12, embedding_dim=8,
                  mf_embedding_dim=4, hidden=(16, 8))
        return (jrec.make_ncf_model(**kw).variables["params"],
                recommendation.make_ncf_model(**kw, device="cpu").module)
    if name == "sentiment":
        from analytics_zoo_tpu.pipelines import sentiment as jsent
        from analytics_zoo_tpu_torch.pipelines import sentiment
        kw = dict(vocab_size=64, embedding_dim=8, hidden=8, head="gru",
                  seq_len=12)
        return (jsent.make_sentiment_model(**kw).variables["params"],
                sentiment.make_sentiment_model(**kw, device="cpu").module)
    raise AssertionError(f"no model factory for pipeline {name!r}")


def _torch_spec(jspec, key, ndim):
    """A reference spec over flax dims, carried onto the torch layout."""
    axes = list(jspec) + [None] * (ndim - len(jspec))
    order = convert.flax_dim_order(key, ndim)
    out = [None] * ndim
    for d, ax in enumerate(axes):
        out[order[d]] = ax
    return tuple(out)


SERVE_FAMILIES = ("ssd", "frcnn", "ds2", "fraud", "rec", "sentiment")
SERVE_ROW_ATOL = 1e-5       # against the JAX rungs (the zoo's ROW_ATOL)
RUNTIME_ATOL = 1e-6         # the runtime's rows against one process's
FRCNN_BOX_TOL_PX = 1e-2     # test_torch_frcnn.py's BOX_TOL_PX
# the detectors' rows against the JAX rungs (classes EQUAL): scores,
# boxes; SSD's normalized boxes as test_torch_serving.py holds them,
# Faster-RCNN's pixel boxes as test_torch_frcnn.py does
JAX_DET_TOL = {"ssd": (1e-5, 1e-4), "frcnn": (1e-5, FRCNN_BOX_TOL_PX)}


def _serve_models():
    """Each family's JAX model (where the JAX rungs are held too) and port
    model (bridged from it), and its batches: an even one (4 rows; 2 for
    the detectors) and a ragged one (3; 1)."""
    from analytics_zoo_tpu.models import faster_rcnn as jax_frcnn
    from analytics_zoo_tpu.models import SSDVgg as JSSD
    from analytics_zoo_tpu_torch.models import faster_rcnn
    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from test_torch_ds2 import _jax_ds2, _port
    from test_torch_frcnn import _params as frcnn_params
    from test_torch_frcnn import _seeded_params as frcnn_seeded
    from test_torch_ssd import seeded_flax_params
    from test_torch_zoo_pipelines import (_fraud_models, _rec_pair,
                                          _sent_models)

    rng = np.random.RandomState(5)
    out = {}

    def images(res, n, means):
        return (rng.randint(0, 256, (n, res, res, 3)).astype(np.float32)
                - np.float32(means))

    jssd = JSSD(num_classes=4, resolution=300)
    params = seeded_flax_params(jssd, 300, seed=2)
    ssd = SSDVgg(4, 300, device="cpu")
    ssd.load_state_dict(convert.ssd_params_from_jax(params, ssd))
    out["ssd"] = (JaxModel(jssd, {"params": params}), ssd,
                  [{"input": images(300, n, [104, 117, 123])}
                   for n in (2, 1)])
    jdet = jax_frcnn.FasterRcnnDetector(param=frcnn_params(jax_frcnn))
    params = frcnn_seeded(jdet)
    det = sc.unfilled(faster_rcnn.FasterRcnnDetector,
                      frcnn_params(faster_rcnn))
    det.load_state_dict(convert.frcnn_params_from_jax(params, det))
    out["frcnn"] = ((jdet, {"params": params}), det,
                    [{"input": images(128, n, [102, 115, 122])}
                     for n in (2, 1)])
    module, variables = _jax_ds2(16, 1, T=50)
    out["ds2"] = (JaxModel(module, variables),
                  _port(variables, 16, 1, "blocked"),
                  [{"input": rng.randn(n, 40, 13).astype(np.float32),
                    "n_frames": np.array([40, 31, 17, 40][:n], np.int32)}
                   for n in (4, 3)])
    out["fraud"] = _fraud_models() + ([
        {"input": rng.randn(n, 29).astype(np.float32)} for n in (4, 3)],)
    out["rec"] = _rec_pair("ncf", n_users=600) + ([
        {"input": (rng.randint(0, 600, n).astype(np.int32),
                   rng.randint(0, 30, n).astype(np.int32))}
        for n in (4, 3)],)
    out["sentiment"] = _sent_models() + ([
        {"input": rng.randint(0, 400, (n, 12)).astype(np.int32)}
        for n in (4, 3)],)
    return out


def _state_np(model):
    module = model.module if isinstance(model, Model) else model
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def serve_models():
    return _serve_models()


@pytest.fixture(scope="module", autouse=True)
def group(serve_models, tmp_path_factory):
    """Two ranks' scenarios, started with the module (a future: they run
    while the structure tests compute the JAX side)."""
    rng = np.random.RandomState(1)
    batches = [rng.randn(16, 29).astype(np.float32),
               rng.randn(5, 29).astype(np.float32)]
    fraud = _state_np(serve_models["fraud"][1])
    return sc.spawn_async(2, {
        "facts": ("engine_facts", {}),
        "rt_dp": ("roundtrip", dict(shape=(2,), axes=("data",),
                                    rules=False)),
        "rt_tp": ("roundtrip", dict(shape=(1, 2), axes=("data", "model"),
                                    rules=True)),
        "eval": ("eval_and_batches", dict(batches=batches)),
        "tiers": ("serve_tiers", dict(
            families={f: (_state_np(m), b)
                      for f, (_, m, b) in serve_models.items()},
            shape=(2,), axes=("data",))),
        "runtime": ("serve_runtime", dict(
            weights=fraud, rows=rng.randn(10, 29).astype(np.float32),
            new_weights={k: v * 1.5 for k, v in fraud.items()},
            snap_dir=str(tmp_path_factory.mktemp("swap")),
            shape=(2,), axes=("data",))),
    }, timeout=240)


@pytest.fixture
def ranks(group):
    return group.result()


class TestRegistryStructureMatch:
    def test_registry_is_the_references(self):
        assert set(specs_lib.registered_pipelines()) == set(jax_registered())
        assert set(_VARIANTS) == set(jax_registered())

    @pytest.mark.parametrize("name", sorted(_VARIANTS))
    def test_spec_map_matches_the_references(self, name):
        jparams, net = _models(name)
        jmesh = jax_mesh((2, 4), axis_names=("data", "model"))
        stub = sc.StubMesh({"data": 2, "model": 4})
        names = [n for n, _ in net.named_parameters()]
        for opts in _VARIANTS[name]:
            port = specs_lib.pipeline_specs(name, mesh=stub, **opts)
            got = port.state_specs(net)
            assert list(got) == names
            assert all(isinstance(s, P) for s in got.values())
            want_tree = jax_pipeline_specs(name, mesh=jmesh,
                                           **opts).state_specs(jparams)
            # (flax's inner BatchNorm_0 scope has no port counterpart)
            want = {"/".join(str(getattr(e, "key", e)) for e in path
                             if getattr(e, "key", e) != "BatchNorm_0"): s
                    for path, s in jax.tree_util.tree_leaves_with_path(
                        want_tree, is_leaf=lambda x: isinstance(x, JP))}
            sharded = 0
            for n, p in net.named_parameters():
                key = convert.flax_key(net, n)
                assert key in want, (name, opts, n, key)
                expect = _torch_spec(want[key], key, p.ndim)
                have = tuple(got[n]) + (None,) * (p.ndim - len(got[n]))
                assert have == expect, (name, opts, n, have, expect)
                sharded += any(a is not None for a in have)
            if name == "ssd" and opts:
                assert sharded == 35       # every conv of the pairing

    def test_unknown_pipeline_raises_with_registry_listing(self):
        with pytest.raises(KeyError, match="fraud"):
            specs_lib.pipeline_specs("nope", mesh=sc.StubMesh({"data": 1}))

    def test_spatial_refused_naming_item_12b(self):
        """Once refused, now served: ``tp="spatial"`` declares the image
        rows over ``model`` (the reference's ``spatial_input_spec``),
        parameters replicated, and ``shard_batch`` keeps a rank's block
        of the overridden dims (rank 0 of 2: rows 0..2 of 5), the other
        keys cut by rows only."""
        mesh = sc.StubMesh({"data": 1, "model": 2})
        specs = specs_lib.pipeline_specs("ssd", mesh=mesh, tp="spatial")
        assert specs.rules is None and specs.row_axis == "model"
        assert specs.batch_overrides == {
            "input": P("data", "model", None, None)}
        x = np.arange(2 * 5 * 3).reshape(2, 5, 3)
        got = mesh_lib.shard_batch({"input": x, "target": x}, mesh,
                                   overrides={"input": P("data", "model")})
        assert np.array_equal(got["input"], x[:, :2])
        assert np.array_equal(got["target"], x)
        assert specs_lib.pipeline_specs(
            "ssd", mesh=sc.StubMesh({"data": 1}), tp="spatial").row_axis \
            == "model"


class TestRoundtrip:
    def test_place_gather_roundtrip_byte_identical_world_1(self):
        """At world 1 (a stand-in mesh of width 1): the placed bytes come
        back, replicated and under rules (every axis of width 1)."""
        from analytics_zoo_tpu_torch.models.deepspeech2 import DeepSpeech2
        from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib
        for rules in (None, tensor_lib.default_tp_rules()):
            net = DeepSpeech2(hidden=16, n_rnn_layers=1, device="cpu")
            before = {k: v.clone() for k, v in net.state_dict().items()}
            specs = specs_lib.SpecSet(sc.StubMesh({"data": 1, "model": 1}),
                                      rules=rules)
            specs.place_state(net)
            back = specs.gather(net)
            for k, v in before.items():
                assert back[k].dtype == v.numpy().dtype
                assert np.array_equal(back[k], v.numpy()), k

    @pytest.mark.parametrize("key", ["rt_dp", "rt_tp"])
    def test_place_gather_roundtrip_byte_identical_world_2(self, ranks, key):
        for r in ranks:
            got = r[key]
            for k, v in got["before"].items():
                assert np.array_equal(got["after"][k], v), k
            assert got["slots_ok"]
            # slots mirror their parameter's shard, gathered whole
            assert got["slot_shapes"] == got["param_shapes"]
        got = ranks[0][key]
        cut = [n for n, shape in got["local_shapes"].items()
               if shape != got["before"][n].shape]
        # the rules placed shards (each rank holds half of a dim), or not
        assert len(cut) == got["sharded"]
        assert (got["sharded"] > 0) == (key == "rt_tp")

    def test_engine_and_mesh_facts_at_world_2(self, ranks):
        for r, got in enumerate(x["facts"] for x in ranks):
            assert got["node_number"] == got["device_count"] == 2
            assert got["local_batch"] == 8
            assert got["backend"] == "gloo" and got["device"] == "cpu"
            assert got["spans"] is True
            assert got["slice"] == (8 * r, 8)
            assert got["all_reduce"] == [3.0, 3.0, 3.0]


class TestAnnotatedStep:
    def test_annotated_eval_matches_plain_including_ragged_tail(self, ranks):
        for r in ranks:
            for annotated, plain in r["eval"]["eval"]:
                np.testing.assert_allclose(annotated, plain, atol=1e-6)

    def test_place_batch_keeps_a_ranks_rows(self, ranks):
        rng = np.random.RandomState(1)
        full = rng.randn(16, 29).astype(np.float32)
        for r, got in enumerate(x["eval"]["placed"] for x in ranks):
            np.testing.assert_array_equal(got["input"],
                                          full[8 * r:8 * (r + 1)])
            np.testing.assert_array_equal(got["nested"],
                                          full[8 * r:8 * (r + 1), :2])
            assert float(got["scalar"]) == 2.0
        assert "not divisible by data-axis size 2" in \
            ranks[0]["eval"]["ragged_place"]

    def test_batch_specs_tree_shapes(self):
        specs = specs_lib.pipeline_specs("ds2",
                                         mesh=sc.StubMesh({"data": 2}))
        batch = {"input": (np.zeros((8, 32, 13), np.float32),
                           np.zeros((8,), np.int32)),
                 "labels": np.zeros((8, 4), np.int32),
                 "scale": np.float32(1)}
        tree = specs.batch_specs(batch)
        x_spec, n_spec = tree["input"]
        assert x_spec == P("data", None, None)
        assert n_spec == P("data")
        assert tree["labels"] == P("data", None)
        assert tree["scale"] == P()
        assert specs.data_axis_size == 2


def _part(batch, rows):
    """``batch`` with every array leaf cut to ``rows`` along dim 0."""
    def cut(v):
        if isinstance(v, tuple):
            return tuple(cut(x) for x in v)
        return v[rows]
    return {k: cut(v) for k, v in batch.items()}


def _rows_close(got, want, family):
    """Transcripts EQUAL; numeric rows within SERVE_ROW_ATOL, and
    Faster-RCNN's pixel boxes within FRCNN_BOX_TOL_PX (the ranks run on
    one intra-op thread, this process on several: a convolution's sums
    round otherwise in the last bits)."""
    if isinstance(want, list):
        assert got == want
    elif family == "frcnn":
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0,
                                   atol=SERVE_ROW_ATOL)
        np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                                   atol=FRCNN_BOX_TOL_PX)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=SERVE_ROW_ATOL)


def _joined(outs):
    return (sum(outs, []) if isinstance(outs[0], list)
            else np.concatenate([np.asarray(o) for o in outs]))


class TestShardedServing:
    @pytest.mark.parametrize("family", SERVE_FAMILIES)
    def test_tiers_over_two_ranks_equal_one_process(self, ranks,
                                                    serve_models, family):
        _, model, batches = serve_models[family]
        plain = sc.family_tiers(family, model)
        for r in ranks:
            got = r["tiers"][family]
            assert len(got) == len(plain)
            for tier, rows in zip(plain, got):
                even, ragged = batches
                half = len(_part(even, slice(None))["input"]) // 2
                if isinstance(even["input"], tuple):
                    half = len(even["input"][0]) // 2
                want = _joined([sc._rows(tier.forward(_part(even, s)))
                                for s in (slice(0, half),
                                          slice(half, 2 * half))])
                _rows_close(_joined([rows[0]]), want, family)
                _rows_close(_joined([rows[1]]),
                            _joined([sc._rows(tier.forward(ragged))]),
                            family)

    @pytest.mark.parametrize("family", SERVE_FAMILIES)
    def test_tiers_over_two_ranks_equal_jax_on_two_devices(
            self, ranks, serve_models, family):
        from analytics_zoo_tpu.ops.detection_output import (
            DetectionOutputParam as JaxPost)
        from analytics_zoo_tpu.pipelines import deepspeech2 as jds2
        from analytics_zoo_tpu.pipelines import fraud as jfraud
        from analytics_zoo_tpu.pipelines import frcnn as jfrcnn
        from analytics_zoo_tpu.pipelines import recommendation as jrec
        from analytics_zoo_tpu.pipelines import sentiment as jsent
        from analytics_zoo_tpu.pipelines import ssd as jssd

        jm, _, batches = serve_models[family]
        specs = jax_pipeline_specs(family, mesh=jax_mesh(
            (2,), axis_names=("data",), devices=jax.devices()[:2]))
        ref = {"ssd": lambda: jssd.ssd_serving_tiers(
                   jm, jssd.PreProcessParam(batch_size=2),
                   post=JaxPost(**sc.SSD_SERVE_POST), n_classes=4,
                   degraded_topk=5, specs=specs),
               "frcnn": lambda: jfrcnn.frcnn_serving_tiers(
                   *jm, jssd.PreProcessParam(batch_size=2, resolution=128),
                   specs=specs),
               "ds2": lambda: jds2.ds2_serving_tiers(
                   jm, jds2.DS2Param(decoder="beam", beam_width=4),
                   specs=specs),
               "fraud": lambda: jfraud.fraud_serving_tiers(jm, specs=specs),
               "rec": lambda: jrec.rec_serving_tiers(jm, specs=specs),
               "sentiment": lambda: jsent.sentiment_serving_tiers(
                   jm, specs=specs, seq_len=12)}[family]()
        got = ranks[0]["tiers"][family]
        for tier, rows in zip(ref, got):
            want = tier.forward(batches[0])
            if family == "ds2":
                assert rows[0] == [str(t) for t in want], tier.name
            elif family in JAX_DET_TOL:
                got, want = np.asarray(rows[0]), np.asarray(want)
                score_tol, box_tol = JAX_DET_TOL[family]
                np.testing.assert_array_equal(got[..., 0], want[..., 0])
                np.testing.assert_allclose(got[..., 1], want[..., 1],
                                           rtol=0, atol=score_tol)
                np.testing.assert_allclose(got[..., 2:], want[..., 2:],
                                           rtol=0, atol=box_tol)
            else:
                np.testing.assert_allclose(rows[0], np.asarray(want),
                                           atol=SERVE_ROW_ATOL,
                                           err_msg=tier.name)

    def test_runtime_with_a_follower(self, ranks, serve_models):
        lead, follower = ranks[0]["runtime"], ranks[1]["runtime"]
        _, model, _ = serve_models["fraud"]
        rows = np.random.RandomState(1)
        rows.randn(16, 29), rows.randn(5, 29)
        rows = rows.randn(10, 29).astype(np.float32)
        fp = sc.family_tiers("fraud", model)[0]
        want = np.asarray(fp.forward({"input": rows}))
        for run in ("virtual", "monotonic", "fault"):
            got = lead[run]
            assert got["accounting"]["by_state"] == {"done": 10}, run
            np.testing.assert_allclose(got["rows"], want, atol=RUNTIME_ATOL,
                                       err_msg=run)
            assert got["mesh"] == {"axes": {"data": 2},
                                   "data_axis_size": 2}
            assert follower[run]["run"] >= 3
        # the follower's one fault failed its dispatch, which failed over
        assert follower["fault"]["failed"] == 1
        assert "failover" in lead["fault"]["events"]
        assert follower["virtual"]["failed"] == 0
        # the swap: both ranks built the new tiers, then served them
        swap = lead["swap"]
        assert swap["accounting"]["by_state"] == {"done": 20}
        assert follower["swap"]["build"] >= 2
        new = sc._family_model("fraud", {k: v * 1.5 for k, v in
                                         _state_np(model).items()})
        want_new = np.asarray(sc.family_tiers("fraud", new)[0].forward(
            {"input": rows}))
        np.testing.assert_allclose(swap["rows"][:10], want,
                                   atol=RUNTIME_ATOL)
        np.testing.assert_allclose(swap["rows"][10:], want_new,
                                   atol=RUNTIME_ATOL)

    def test_follower_failing_before_its_tier_fails_the_dispatch(
            self, ranks, serve_models):
        lead, follower = ranks[0]["runtime"], ranks[1]["runtime"]
        _, model, _ = serve_models["fraud"]
        rows = np.random.RandomState(1)
        rows.randn(16, 29), rows.randn(5, 29)
        rows = rows.randn(10, 29).astype(np.float32)[:4]
        # the rung the follower lacks fails at its lookup, before any
        # rank runs it; its placement's fault fails inside the guard
        assert lead["before"]["caught"] == ["FollowerFailed",
                                            "RuntimeError", None]
        assert follower["before"] == {"run": 4, "build": 0, "failed": 2}
        want = np.asarray(sc.family_tiers("fraud", model)[0].forward(
            {"input": rows}))
        np.testing.assert_allclose(lead["before"]["rows"], want,
                                   atol=RUNTIME_ATOL)
