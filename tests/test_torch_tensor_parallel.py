"""Tensor parallelism of the port (``parallel/tensor.py``) against the JAX
package's (``tests/test_tensor_parallel.py``).

The rules resolve to the reference's specs carried onto torch layouts
(a ``Linear`` weight is (out, in), a ``Conv2d`` (out, in, kh, kw)).  The
parallel layers run in a group of four gloo ranks: the reference's MLP
trained by the ``Optimizer`` data parallel on a (4,) mesh and tensor
parallel on a (2, 2) data × model mesh (``default_tp_rules`` and a
column/row Megatron pair), against the JAX package's runs at the
reference's tolerance (rtol 1e-4, atol 1e-5); SSD300's forward under
``ssd_tp_rules`` (conv4_3's ``NormalizeScale`` on sharded channels, row
heads) against the unsharded forward.  Spatial partitioning and the
pipeline axis wait for ROADMAP.md Queue 1 item 12b.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as fnn
from jax.sharding import PartitionSpec as JP

import torch_dist_scenarios as sc
from analytics_zoo_tpu.core.criterion import MSECriterion as JaxMSE
from analytics_zoo_tpu.core.module import Model as JaxModel
from analytics_zoo_tpu.parallel import SGD as JaxSGD
from analytics_zoo_tpu.parallel import Optimizer as JaxOptimizer
from analytics_zoo_tpu.parallel import Trigger as JaxTrigger
from analytics_zoo_tpu.parallel import create_mesh
from analytics_zoo_tpu.parallel import tensor as jtensor
from analytics_zoo_tpu_torch.parallel import tensor
from analytics_zoo_tpu_torch.parallel.mesh import PartitionSpec as P
from analytics_zoo_tpu_torch.utils import engine

RTOL, ATOL = 1e-4, 1e-5
MESH = sc.StubMesh({"data": 2, "model": 4})


class MLP(fnn.Module):
    width: int = 32

    @fnn.compact
    def __call__(self, x):
        h = fnn.relu(fnn.Dense(self.width, name="fc1")(x))
        return fnn.Dense(8, name="out")(h)


def _data(n_batches=4, batch=16, dim=8, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim, 8).astype(np.float32)
    return [{"input": (x := rng.randn(batch, dim).astype(np.float32)),
             "target": np.tanh(x @ w)} for _ in range(n_batches)]


def _jax_mlp():
    m = JaxModel(MLP())
    m.build(0, jnp.zeros((1, 8), jnp.float32))
    return m


def _bridged(jm):
    p = jax.tree_util.tree_map(np.asarray, jm.variables["params"])
    return {f"{n}.weight": p[n]["kernel"].T.copy() for n in ("fc1", "out")} \
        | {f"{n}.bias": p[n]["bias"].copy() for n in ("fc1", "out")}


def _ssd_weights():
    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    return {k: v.numpy() for k, v in SSDVgg(4, 300, device="cpu",
                                            seed=2).state_dict().items()}


def _ds2_batch(B=4, T=32, seed=5):
    """A DS2 batch of the program audit's sizes (hidden 16, T 32)."""
    rng = np.random.RandomState(seed)
    n = np.full((B,), T, np.int32)
    return {"input": (rng.randn(B, T, 13).astype(np.float32), n),
            "n_frames": n,
            "labels": rng.randint(1, 29, (B, 4)).astype(np.int32),
            "label_mask": np.ones((B, 4), np.float32)}


@pytest.fixture(scope="module")
def ranks():
    w = _bridged(_jax_mlp())
    x = np.random.RandomState(3).randn(2, 300, 300, 3).astype(np.float32)
    runs = {k: ("mlp_train", dict(weights=w, data=_data(), shape=shape,
                                  axes=axes, rules=rules))
            for k, shape, axes, rules in (
                ("dp", (4,), ("data",), None),
                ("tp", (2, 2), ("data", "model"), "default"),
                ("megatron", (2, 2), ("data", "model"), "megatron"))}
    runs["word_or"] = ("health_word_over_ranks", {})
    runs["analyze"] = ("analyze_programs", dict(batch=_ds2_batch()))
    runs["ssd"] = ("ssd_megatron_forward", dict(
        weights=_ssd_weights(), x=x, shape=(2, 2), axes=("data", "model"),
        resolution=300))
    return engine.spawn(sc.TARGET, 4, {"scenarios": runs}, device="cpu",
                        timeout=240)


class TestPartitionSpec:
    def test_kernel_sharded_on_model_axis(self):
        # a Linear(8 → 32) weight is (32, 8): its output features, dim 0
        assert tensor.partition_spec("params/fc1/kernel", (32, 8), MESH,
                                     tensor.default_tp_rules()) \
            == P("model", None)
        jmesh = create_mesh((2, 4), axis_names=("data", "model"))
        assert jtensor.partition_spec("params/fc1/kernel", (8, 32), jmesh,
                                      jtensor.default_tp_rules()) \
            == JP(None, "model")

    def test_indivisible_dim_falls_back_replicated(self):
        assert tensor.partition_spec("params/fc1/kernel", (30, 8), MESH,
                                     tensor.default_tp_rules()) \
            == P(None, None)

    def test_bias_replicated(self):
        assert tensor.partition_spec("params/fc1/bias", (32,), MESH,
                                     tensor.default_tp_rules()) == P()

    def test_rule_axes_and_the_axis_a_mesh_lacks(self):
        assert tensor.rule_axes(tensor.ssd_tp_rules()) == {"model"}
        assert tensor.partition_spec(
            "params/fc1/kernel", (32, 8), sc.StubMesh({"data": 8}),
            tensor.default_tp_rules()) == P(None, None)


class TestMegatronRules:
    def test_ssd_head_kernels_row_sharded(self):
        rules = tensor.ssd_tp_rules()
        # conf_2 (126, 512, 3, 3): cout 126 does not divide 4, the row
        # rule shards cin 512
        assert tensor.partition_spec("params/conf_2/kernel",
                                     (126, 512, 3, 3), MESH, rules) \
            == P(None, "model", None, None)
        assert tensor.partition_spec("params/vgg/conv4_3/kernel",
                                     (512, 512, 3, 3), MESH, rules) \
            == P("model", None, None, None)
        # optimizer-slot mirrors pick the same spec up through the path
        assert tensor.partition_spec("momentum/conf_2/kernel",
                                     (126, 512, 3, 3), MESH, rules) \
            == P(None, "model", None, None)

    def test_ssd512_rules_cover_extra_block_and_head(self):
        rules = tensor.ssd_tp_rules(resolution=512)
        assert tensor.partition_spec("params/extra/conv10_2/kernel",
                                     (256, 128, 4, 4), MESH, rules) \
            == P("model", None, None, None)
        assert tensor.partition_spec("params/conf_6/kernel",
                                     (84, 256, 3, 3), MESH, rules) \
            == P(None, "model", None, None)
        assert tensor.partition_spec("params/conf_6/kernel",
                                     (84, 256, 3, 3), MESH,
                                     tensor.ssd_tp_rules()) == P()

    def test_megatron_rules_dense_contract_dim(self):
        rules = tensor.megatron_tp_rules(col=["fc1"], row=["fc2"])
        assert tensor.partition_spec("params/fc1/kernel", (32, 8), MESH,
                                     rules) == P("model", None)
        # a Linear (out, in) row rule shards dim 1, the contraction
        assert tensor.partition_spec("params/fc2/kernel", (8, 32), MESH,
                                     rules) == P(None, "model")
        assert tensor.partition_spec("params/other/kernel", (32, 32),
                                     MESH, rules) == P()

    def test_embedding_rows_and_feature_columns(self):
        rules = tensor.default_tp_rules()
        assert tensor.partition_spec("params/e/embedding", (64, 16), MESH,
                                     rules) == P("model", None)
        rules = tensor.megatron_tp_rules(col=["e"], row=[])
        assert tensor.partition_spec("params/e/embedding", (64, 16), MESH,
                                     rules) == P(None, "model")

    def test_mlp_col_row_pair_trains_to_dp_parity(self, ranks):
        """The column → row pair (fc1's slice stays sharded into out's
        contraction) trains as the data-parallel run does, and as the JAX
        package's pair on its (2, 4) mesh."""
        dp = ranks[0]["dp"]
        for r in ranks:
            got = r["megatron"]
            assert got["sharded"] == 2 and got["steps"] == 12
            np.testing.assert_allclose(got["forward"], dp["forward"],
                                       rtol=RTOL, atol=ATOL)
        jm = _jax_mlp()
        (JaxOptimizer(jm, _data(), JaxMSE(),
                      mesh=create_mesh((2, 4), axis_names=("data", "model")),
                      param_rules=jtensor.megatron_tp_rules(col=["fc1"],
                                                            row=["out"]))
         .set_optim_method(JaxSGD(0.05, momentum=0.9))
         .set_end_when(JaxTrigger.max_epoch(3))).optimize()
        np.testing.assert_allclose(ranks[0]["megatron"]["forward"],
                                   np.asarray(jm.forward(_data()[0]["input"])),
                                   rtol=RTOL, atol=ATOL)


def test_health_word_is_or_over_ranks(ranks):
    """A health word over a mesh is every rank's bits OR-ed (a shard's
    finiteness is its rank's own): each of the 4 ranks ends with them
    all."""
    assert [r["word_or"] for r in ranks] == [0b1111 | (1 << 29)] * 4


class TestAnalyzeOverRanks:
    """The program engine's collective inventory on real ranks
    (``analytics_zoo_tpu_torch/analysis/program.py``): a tensor-parallel
    DS2 step on a (2, 2) ("data", "model") mesh is clean against its own
    ``SpecSet`` and fires against one declared over a data-only mesh;
    the fraud rungs of each rank's width-2 slice run clean."""

    def test_collective_inventory_clean_on_the_declared_mesh(self, ranks):
        for r in ranks:
            assert r["analyze"]["tp"] == []

    def test_collective_inventory_fires_on_a_misdeclared_specset(self,
                                                                 ranks):
        for r in ranks:
            got = r["analyze"]["tp_data_only"]
            assert {rule for rule, _, _ in got} == {"collective-inventory"}
            assert not any(waived for _, waived, _ in got)
            assert all("declares mesh axes ['data']" in m for _, _, m in got)
            # the model axis's group and the data axis's of the 2-D mesh
            assert len(got) == 2

    def test_fraud_slice_w2_rungs_audit_clean(self, ranks):
        for r in ranks:
            names = r["analyze"]["slice_names"]
            assert names == ["fraud-slice-w2/serve:fp",
                             "fraud-slice-w2/serve:int8"]
            for name in names:
                assert r["analyze"][name] == [], name


class TestShardTree:
    def test_params_actually_sharded(self, ranks):
        """Under ``default_tp_rules`` every Linear's output features are
        cut in half on a rank, and gathered back whole."""
        got = ranks[0]["tp"]
        assert got["sharded"] == 2
        w = got["weights"]
        assert w["fc1.weight"].shape == (32, 8)
        assert w["out.weight"].shape == (8, 32)

    def test_ssd_forward_parity_under_megatron(self, ranks):
        """SSD300 under ``ssd_tp_rules`` on (2, 2): conv4_3's output
        channels are a rank's half, ``conf_0`` contracts half of its
        input, and (loc, conf) equal the unsharded forward's rows."""
        import torch

        from analytics_zoo_tpu_torch.models.ssd import SSDVgg
        model = SSDVgg(4, 300, device="cpu", seed=0)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in _ssd_weights().items()})
        x = np.random.RandomState(3).randn(2, 300, 300, 3).astype(np.float32)
        with torch.no_grad():
            loc, conf = model(torch.from_numpy(x))
        for r, got in enumerate(k["ssd"] for k in ranks):
            assert got["conv4_3"] == (256, 512, 3, 3)
            assert got["conf_0"] == (16, 256, 3, 3)
            row = r // 2                      # the rank's data coordinate
            np.testing.assert_allclose(got["loc"], loc[row:row + 1].numpy(),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got["conf"],
                                       conf[row:row + 1].numpy(),
                                       rtol=RTOL, atol=ATOL)


class TestTensorParallelTraining:
    def test_2d_mesh_training_matches_data_parallel(self, ranks):
        """Same data, same init: the data × model run under
        ``default_tp_rules`` tracks the pure data-parallel run, and both
        the JAX package's data-parallel run, at the reference's
        tolerance."""
        dp = ranks[0]["dp"]
        assert dp["steps"] == ranks[0]["tp"]["steps"] == 12
        for r in ranks:
            np.testing.assert_allclose(r["tp"]["forward"], dp["forward"],
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(r["tp"]["losses"], dp["losses"],
                                       rtol=RTOL, atol=ATOL)
        jm = _jax_mlp()
        (JaxOptimizer(jm, _data(), JaxMSE(),
                      mesh=create_mesh((8,), axis_names=("data",)))
         .set_optim_method(JaxSGD(0.05, momentum=0.9))
         .set_end_when(JaxTrigger.max_epoch(3))).optimize()
        want = np.asarray(jm.forward(_data()[0]["input"]))
        np.testing.assert_allclose(dp["forward"], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ranks[0]["tp"]["forward"], want,
                                   rtol=RTOL, atol=ATOL)


def test_pallas_data_shards_is_validated_and_changes_nothing():
    """``Recurrent``/``BiRecurrent(pallas_data_shards=)``: the reference
    divides its jit-global batch by it to price the kernel's VMEM; a port
    rank sees its own rows and the Hopper fit does not depend on the
    batch, so a positive count is kept and the forward is the same, and
    anything else raises (ROADMAP.md Queue 3, a known deviation)."""
    import torch

    from analytics_zoo_tpu_torch.core.rnn import BiRecurrent, RnnCell
    cell = RnnCell(8, identity_input=True, activation="clipped_relu")
    x = torch.randn(3, 5, 8, generator=torch.Generator().manual_seed(0))
    outs = []
    for shards in (None, 4):
        layer = BiRecurrent(cell, engine="pallas", pallas_data_shards=shards,
                            generator=torch.Generator().manual_seed(1))
        assert layer.fwd.pallas_data_shards == shards
        outs.append(layer(x))
    assert torch.equal(*outs)
    for bad in (0, -1, 2.5):
        with pytest.raises(ValueError, match="pallas_data_shards"):
            BiRecurrent(cell, pallas_data_shards=bad)
