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
        return shapes["params"], faster_rcnn.FasterRcnnVgg(
            faster_rcnn.FrcnnParam(num_classes=4,
                                   proposal=ProposalParam(64, 16)),
            device="cpu")
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


@pytest.fixture(scope="module", autouse=True)
def group():
    """Two ranks' scenarios, started with the module (a future: they run
    while the structure tests compute the JAX side)."""
    rng = np.random.RandomState(1)
    batches = [rng.randn(16, 29).astype(np.float32),
               rng.randn(5, 29).astype(np.float32)]
    return sc.spawn_async(2, {
        "facts": ("engine_facts", {}),
        "rt_dp": ("roundtrip", dict(shape=(2,), axes=("data",),
                                    rules=False)),
        "rt_tp": ("roundtrip", dict(shape=(1, 2), axes=("data", "model"),
                                    rules=True)),
        "eval": ("eval_and_batches", dict(batches=batches)),
    }, timeout=120)


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
        with pytest.raises(NotImplementedError, match="item 12b"):
            specs_lib.pipeline_specs("ssd", mesh=sc.StubMesh({"data": 1}),
                                     tp="spatial")
        with pytest.raises(NotImplementedError, match="item 12b"):
            mesh_lib.shard_batch({"input": np.zeros((2, 4))},
                                 sc.StubMesh({"data": 1}),
                                 overrides={"input": P("data", "model")})


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
