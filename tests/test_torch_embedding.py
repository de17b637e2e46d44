"""Parity of the port's embedding lookups and their sparse training apply
with the JAX package, on the CPU (the reference's cases of
``tests/test_embedding.py``): the three lookup modes' forward and
backward against the reference's one-hot lookup on ragged, repeated
Zipfian ids, ``max_unique``, ``SparseRows`` padding and ``count``, the
gradient-rows round trip, ``sparse_adam_apply`` over two steps, the
lookup statistics and the unknown mode; and row-sharded tables over two
gloo ranks (``TestRowSharding``).

Tolerances: lookups and table gradients within 1e-5 (gathers are exact;
the one-hot product and the segment sums add in another order);
``sparse_adam_apply``'s touched rows and slots within 1e-6 relative of
the reference's (``pow`` of the bias correction may differ by an ulp
between XLA and torch), and EQUAL to the port's dense ``Adam`` on the
touched rows (the same arithmetic); untouched rows EQUAL to the input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.obs.registry import MetricRegistry as JaxRegistry
from analytics_zoo_tpu.ops import embedding as jemb
from analytics_zoo_tpu.parallel import sparse_adam_apply as jax_sparse_adam
from analytics_zoo_tpu_torch.obs.registry import MetricRegistry
from analytics_zoo_tpu_torch.ops import embedding as emb
from analytics_zoo_tpu_torch.parallel import Adam, sparse_adam_apply

torch.set_num_threads(2)

ATOL = 1e-5
ADAM_RTOL = 1e-6


def _zipf_ids(rng, shape, vocab):
    return (rng.zipf(1.4, size=shape) % vocab).astype(np.int32)


@pytest.mark.parametrize("mode", emb.LOOKUP_MODES)
@pytest.mark.parametrize("shape", [(32,), (7,), (5, 9), (1,)])
def test_forward_matches_jax_onehot(mode, shape):
    rng = np.random.RandomState(0)
    vocab, dim = 50, 6
    table = rng.randn(vocab, dim).astype(np.float32)
    ids = _zipf_ids(rng, shape, vocab)
    got = emb.sharded_embedding_lookup(torch.as_tensor(table),
                                       torch.as_tensor(ids), mode=mode)
    want = np.asarray(jemb.onehot_lookup(jnp.asarray(table),
                                         jnp.asarray(ids)))
    assert tuple(got.shape) == shape + (dim,)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("mode", emb.LOOKUP_MODES)
@pytest.mark.parametrize("shape", [(32,), (7,), (5, 9)])
def test_backward_matches_jax_onehot(mode, shape):
    rng = np.random.RandomState(1)
    vocab, dim = 41, 5
    table = rng.randn(vocab, dim).astype(np.float32)
    ids = _zipf_ids(rng, shape, vocab)
    w = rng.randn(*shape, dim).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.vdot(
        jemb.onehot_lookup(t, jnp.asarray(ids)), w))(jnp.asarray(table)))
    t = torch.as_tensor(table).requires_grad_()
    (emb.sharded_embedding_lookup(t, torch.as_tensor(ids), mode=mode)
     * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, atol=ATOL)


def test_dedup_backward_repeats_bit_for_bit():
    """The sorted segment sums add in one order: two backward passes of
    the same batch give the same table gradient, bit for bit."""
    rng = np.random.RandomState(9)
    table = torch.as_tensor(rng.randn(64, 8).astype(np.float32))
    ids = torch.as_tensor(_zipf_ids(rng, (256,), 64))
    w = torch.as_tensor(rng.randn(256, 8).astype(np.float32))
    grads = []
    for _ in range(2):
        t = table.clone().requires_grad_()
        (emb.dedup_lookup(t, ids) * w).sum().backward()
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])


def test_max_unique_cap_exact_when_sufficient_and_refused_when_not():
    rng = np.random.RandomState(2)
    table = rng.randn(20, 4).astype(np.float32)
    ids = np.array([3, 3, 3, 7, 7, 1], np.int32)
    got = emb.dedup_lookup(torch.as_tensor(table), torch.as_tensor(ids),
                           max_unique=4)
    want = np.asarray(jemb.dedup_lookup(jnp.asarray(table),
                                        jnp.asarray(ids), max_unique=4))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[ids])
    with pytest.raises(ValueError, match="max_unique"):
        emb.dedup_lookup(torch.as_tensor(table), torch.as_tensor(ids),
                         max_unique=2)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="naive"):
        emb.sharded_embedding_lookup(torch.zeros(4, 2),
                                     torch.zeros(2, dtype=torch.long),
                                     mode="bogus")
    with pytest.raises(ValueError, match="naive"):
        emb.DedupEmbed(4, 2, lookup="bogus")


@pytest.mark.parametrize("shape,max_unique", [((4, 6), None), ((16,), 12),
                                              ((4,), None)])
def test_grad_rows_equal_jax(shape, max_unique):
    """``SparseRows``: sorted unique ids padded with 0 to ``size``, the
    segment sums, zero padded rows and ``count``, against the
    reference's; the round trip to a dense gradient."""
    rng = np.random.RandomState(6)
    vocab, dim = 37, 4
    ids = _zipf_ids(rng, shape, vocab)
    if shape == (4,):
        ids[:] = 2                               # 1 unique of 4
    ct = rng.randn(*shape, dim).astype(np.float32)
    want = jemb.embedding_grad_rows(jnp.asarray(ids), jnp.asarray(ct),
                                    max_unique=max_unique)
    got = emb.embedding_grad_rows(torch.as_tensor(ids), torch.as_tensor(ct),
                                  max_unique=max_unique)
    assert isinstance(got, emb.SparseRows)
    assert int(got.count) == int(want.count) == np.unique(ids).size
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows),
                               atol=ATOL)
    np.testing.assert_array_equal(got.rows[int(got.count):].numpy(), 0.0)
    dense = np.asarray(jax.grad(lambda t: jnp.vdot(
        jemb.onehot_lookup(t, jnp.asarray(ids)), ct))(
            jnp.zeros((vocab, dim), jnp.float32)))
    np.testing.assert_allclose(emb.sparse_rows_to_dense(got, vocab).numpy(),
                               dense, atol=ATOL)


def test_sparse_adam_two_steps_match_jax_and_dense_adam():
    """Two steps on the same rows: the touched rows and their slots
    within 1e-6 relative of the reference's ``sparse_adam_apply`` and
    equal to the port's dense ``Adam`` on those rows (bias correction at
    ``count + 1`` included); untouched rows keep their values."""
    rng = np.random.RandomState(8)
    vocab, dim, lr = 17, 4, 1e-2
    table = rng.randn(vocab, dim).astype(np.float32)
    ids = np.array([3, 9, 3, 14, 9, 9], np.int32)
    touched = np.unique(ids)
    untouched = np.setdiff1d(np.arange(vocab), touched)

    j = (jnp.asarray(table), jnp.zeros((vocab, dim)), jnp.zeros((vocab, dim)),
         jnp.zeros((), jnp.int32))
    t = (torch.as_tensor(table), torch.zeros(vocab, dim),
         torch.zeros(vocab, dim), torch.zeros((), dtype=torch.int32))
    dense = torch.nn.Parameter(torch.as_tensor(table.copy()))
    adam = Adam(lr)
    state = adam.init([dense])
    for _ in range(2):
        ct = rng.randn(6, dim).astype(np.float32)
        j = jax_sparse_adam(*j, jemb.embedding_grad_rows(
            jnp.asarray(ids), jnp.asarray(ct)), learning_rate=lr)
        grad = emb.embedding_grad_rows(torch.as_tensor(ids),
                                       torch.as_tensor(ct))
        t = sparse_adam_apply(*t, grad, learning_rate=lr)
        adam.update([dense], [emb.sparse_rows_to_dense(grad, vocab)], state,
                    lr)
    assert int(t[3]) == int(j[3]) == 2
    for got, want, slot in zip(t[:3], j[:3],
                               (dense, state["mu"][0], state["nu"][0])):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[touched], want[touched],
                                   rtol=ADAM_RTOL, atol=0)
        np.testing.assert_array_equal(got[touched],
                                      slot.detach().numpy()[touched])
    np.testing.assert_array_equal(t[0].numpy()[untouched], table[untouched])
    np.testing.assert_array_equal(t[1].numpy()[untouched], 0.0)
    np.testing.assert_array_equal(t[2].numpy()[untouched], 0.0)


def test_sparse_adam_padding_never_reaches_row_zero():
    """Padded ``SparseRows`` entries (ids 0 past ``count``) are masked:
    row 0, not in the batch, keeps its value and its slots."""
    rng = np.random.RandomState(10)
    table = torch.as_tensor(rng.randn(8, 3).astype(np.float32))
    ids = torch.tensor([5, 5, 2, 5])
    grad = emb.embedding_grad_rows(ids, torch.ones(4, 3))
    assert int(grad.count) == 2 and grad.ids.tolist() == [2, 5, 0, 0]
    new, mu, nu, _ = sparse_adam_apply(table, torch.zeros(8, 3),
                                       torch.zeros(8, 3),
                                       torch.zeros((), dtype=torch.int32),
                                       grad, learning_rate=0.1)
    assert torch.equal(new[0], table[0])
    assert not mu[0].any() and not nu[0].any()
    assert not torch.equal(new[5], table[5])


def test_dedup_embed_table_and_its_initializer():
    """The parameter is ``embedding`` (flax's name); the default draw is
    flax's ``variance_scaling(1, fan_in, normal, out_axis=0)``: mean 0,
    std 1/sqrt(dim); ``zeros_init`` gives zeros."""
    g = torch.Generator().manual_seed(0)
    e = emb.DedupEmbed(20000, 64, generator=g)
    assert list(dict(e.named_parameters())) == ["embedding"]
    w = e.embedding.detach().numpy()
    assert abs(w.mean()) < 2e-3 and abs(w.std() * 8.0 - 1.0) < 5e-3
    ref = np.asarray(jemb.DedupEmbed(20000, 64).init(
        jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))["params"]
        ["embedding"])
    assert abs(ref.std() - w.std()) < 5e-4
    z = emb.DedupEmbed(10, 3, embedding_init=emb.zeros_init)
    assert not z.embedding.any()


def test_lookup_stats_and_publish_equal_jax():
    ids = _zipf_ids(np.random.RandomState(11), (8, 16), 100)
    assert emb.lookup_stats(torch.as_tensor(ids)) == jemb.lookup_stats(ids)
    reg, jreg = MetricRegistry(), JaxRegistry()
    for _ in range(2):
        assert emb.publish_lookup_stats(reg, ids) == \
            jemb.publish_lookup_stats(jreg, ids)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.snapshot()["counters"] == {"embed/lookups": 2}


# -- row-sharded tables (the reference's TestRowSharding) --------------------


class TestRowSharding:
    """(vocab, dim) tables row-sharded over ``model``: the rules resolve as
    the reference's, and over two gloo ranks of a (1, 2) mesh
    (``torch_dist_scenarios``) each rank owns half the ids: every lookup
    mode and the table's gradient equal the reference's one-hot lookup on
    the whole table, and ``owned_rows`` + ``sparse_adam_apply`` on a shard
    equal the reference's sparse Adam on those rows."""

    @staticmethod
    def _mesh():
        import torch_dist_scenarios as sc
        return sc.StubMesh({"data": 2, "model": 4})

    def test_embedding_table_row_shards_under_default_rules(self):
        from analytics_zoo_tpu_torch.parallel import tensor
        from analytics_zoo_tpu_torch.parallel.mesh import PartitionSpec as P
        rules = tensor.default_tp_rules()
        mesh = self._mesh()
        assert tensor.partition_spec("params/embed/embedding", (64, 16),
                                     mesh, rules) == P("model", None)
        # a Linear kernel keeps the column shard: (out, in) dim 0
        assert tensor.partition_spec("params/dense/kernel", (16, 32),
                                     mesh, rules) == P("model", None)
        assert tensor.partition_spec("mu/embed/embedding", (64, 16), mesh,
                                     rules) == P("model", None)
        assert tensor.partition_spec("params/embed/embedding", (63, 16),
                                     mesh, rules) == P(None, None)

    def test_embedding_row_rules_only_touch_tables(self):
        from analytics_zoo_tpu_torch.parallel import tensor
        from analytics_zoo_tpu_torch.parallel.mesh import PartitionSpec as P
        rules = tensor.embedding_row_rules()
        assert tensor.partition_spec("params/e/embedding", (64, 16),
                                     self._mesh(), rules) == P("model", None)
        assert tensor.partition_spec("params/d/kernel", (16, 64),
                                     self._mesh(), rules) == P()

    def test_rec_pipeline_specs_row_shard_the_tables(self):
        from analytics_zoo_tpu_torch.parallel.mesh import PartitionSpec as P
        from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs
        from analytics_zoo_tpu_torch.pipelines.recommendation import (
            make_ncf_model)
        net = make_ncf_model(n_users=32, n_items=32, embedding_dim=8,
                             mf_embedding_dim=4, hidden=(16, 8),
                             device="cpu").module
        specs = pipeline_specs("rec", mesh=self._mesh()).state_specs(net)
        tables = {k: v for k, v in specs.items() if "embedding" in k}
        assert len(tables) == 4
        assert all(s == P("model", None) for s in tables.values())
        plain = pipeline_specs("rec", mesh=self._mesh(),
                               shard_tables=False).state_specs(net)
        assert all(s == P() for s in plain.values())

    @pytest.fixture(scope="class")
    def ranks(self):
        import torch_dist_scenarios as sc
        from analytics_zoo_tpu_torch.utils import engine
        rng = np.random.RandomState(9)
        table = rng.randn(64, 8).astype(np.float32)
        ids = _zipf_ids(rng, (6, 4), 64)
        cot = rng.randn(6, 4, 8).astype(np.float32)
        out = engine.spawn(sc.TARGET, 2, {"scenarios": {"rows": (
            "embedding_rows", dict(table=table, ids=ids, cot=cot,
                                   lr=1e-2))}}, device="cpu", timeout=120)
        return table, ids, cot, [r["rows"] for r in out]

    @pytest.mark.parametrize("mode", emb.LOOKUP_MODES)
    def test_row_sharded_lookup_matches_replicated(self, ranks, mode):
        table, ids, cot, got = ranks
        ref = np.asarray(jemb.onehot_lookup(jnp.asarray(table),
                                            jnp.asarray(ids)))
        ref_g = np.asarray(jax.grad(lambda t: jnp.sum(
            jemb.onehot_lookup(t, jnp.asarray(ids)) * cot))(
            jnp.asarray(table)))
        for r in got:
            assert r["local_rows"] == 32
            rows, grad = r[mode]
            np.testing.assert_allclose(rows, ref, atol=ATOL)
            np.testing.assert_allclose(grad, ref_g, atol=ATOL)

    def test_shard_sparse_adam_matches_jax(self, ranks):
        table, ids, cot, got = ranks
        vocab, dim = table.shape
        j = jax_sparse_adam(jnp.asarray(table), jnp.zeros((vocab, dim)),
                            jnp.zeros((vocab, dim)), jnp.zeros((), jnp.int32),
                            jemb.embedding_grad_rows(jnp.asarray(ids),
                                                     jnp.asarray(cot)),
                            learning_rate=1e-2)
        touched = np.unique(ids)
        for r in got:
            adam = r["adam"]
            for key, want in zip(("t", "mu", "nu"), j[:3]):
                np.testing.assert_allclose(adam[key][touched],
                                           np.asarray(want)[touched],
                                           rtol=ADAM_RTOL, atol=1e-7)
            untouched = np.setdiff1d(np.arange(vocab), touched)
            np.testing.assert_array_equal(adam["t"][untouched],
                                          table[untouched])
