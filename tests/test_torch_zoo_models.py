"""Parity of the port's small model families with the JAX package, on the
CPU: ``FraudMLP``, ``NeuralCF`` and ``WideAndDeep`` (each lookup mode),
and ``SentimentNet`` (all five heads, a trainable and a frozen table),
on weights bridged from the reference's (``utils/convert.py``), the
cross hash over the whole id range, the quantized leaf set and the int8
rung's forward.  Inputs are made by numpy from a seed and given to both
packages.

Tolerances: forwards within 1e-5 (the same fp32 ops, summed in another
order by the matmuls and the recurrences); every gradient of a weighted
sum of the output within 1e-5 relative L2 (the tables' sparse gradients
included); the quantized leaves' int8 values and scales EQUAL (the same
numpy float32 arithmetic), the set of quantized leaves EQUAL; the
weight-only int8 forward within 1e-5 of the reference's
``make_quantized_forward``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core.module import Model as JaxModel
from analytics_zoo_tpu.models import simple as jax_simple
from analytics_zoo_tpu.utils import quantize as jax_quantize
from analytics_zoo_tpu_torch.models import simple
from analytics_zoo_tpu_torch.utils import convert, quantize

torch.set_num_threads(2)

FWD_ATOL = 1e-5
GRAD_RTOL = 1e-5
INT8_ATOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _zipf(rng, shape, vocab):
    return (rng.zipf(1.4, size=shape) % vocab).astype(np.int32)


def _randomize_wide(params, rng):
    """Wide tables start at zero in both packages; random values make the
    wide path (the cross hash above all) show in the output."""
    out = jax.tree_util.tree_map(np.asarray, params)
    out = {k: dict(v) for k, v in out.items()}
    for name in ("wide_user", "wide_item", "wide_cross"):
        if name in out:
            out[name]["embedding"] = rng.randn(
                *out[name]["embedding"].shape).astype(np.float32)
    return out


# one case a model: (name, reference module, port module, bridge, inputs)
def _case(name, rng):
    B = 13
    if name == "fraud":
        return (jax_simple.FraudMLP(), simple.FraudMLP(),
                convert.fraud_mlp_params_from_jax,
                (rng.randn(B, 29).astype(np.float32),))
    kind, _, lookup = name.partition(":")
    if kind == "ncf":
        kw = dict(n_users=300, n_items=40, embedding_dim=16,
                  mf_embedding_dim=4, hidden=(16, 8), n_classes=5,
                  lookup=lookup)
        return (jax_simple.NeuralCF(**kw), simple.NeuralCF(**kw),
                convert.ncf_params_from_jax,
                (_zipf(rng, (B,), 300), _zipf(rng, (B,), 40)))
    if kind == "ncf_nomf":
        kw = dict(n_users=30, n_items=40, embedding_dim=8, hidden=(16,),
                  include_mf=False, lookup=lookup)
        return (jax_simple.NeuralCF(**kw), simple.NeuralCF(**kw),
                convert.ncf_params_from_jax,
                (_zipf(rng, (B,), 30), _zipf(rng, (B,), 40)))
    if kind == "wd":
        kw = dict(n_users=300, n_items=40, embedding_dim=16, hidden=(16, 8),
                  n_classes=5, cross_buckets=1000, lookup=lookup)
        return (jax_simple.WideAndDeep(**kw), simple.WideAndDeep(**kw),
                convert.wide_deep_params_from_jax,
                (rng.randint(0, 300, B).astype(np.int32),
                 rng.randint(0, 40, B).astype(np.int32)))
    # sentiment: "sent:<head>:<lookup>" or "sent:<head>:frozen"
    head, _, lookup = lookup.partition(":")
    vocab, dim, hidden = 300, 16, 64
    frozen = lookup == "frozen"
    emb = rng.randn(vocab, dim).astype(np.float32) if frozen else None
    kw = dict(vocab_size=vocab, embedding_dim=dim, hidden=hidden, head=head,
              embeddings=emb, lookup="dedup" if frozen else lookup)
    return (jax_simple.SentimentNet(**kw), simple.SentimentNet(**kw),
            convert.sentiment_params_from_jax,
            (_zipf(rng, (3, 6), vocab),))


CASES = (["fraud"] + [f"ncf:{m}" for m in ("dedup", "naive", "onehot")]
         + ["ncf_nomf:dedup"]
         + [f"wd:{m}" for m in ("dedup", "naive", "onehot")]
         + [f"sent:{h}:dedup" for h in simple.HEADS]
         + ["sent:gru:naive", "sent:gru:onehot", "sent:gru:frozen",
            "sent:cnn:frozen"])


def _pair(name, seed=0):
    rng = np.random.RandomState(seed)
    jmod, tmod, bridge, inputs = _case(name, rng)
    jm = JaxModel(jmod).build(0, *[jnp.asarray(x[:1]) for x in inputs])
    params = _randomize_wide(jm.variables["params"], rng)
    tmod.load_state_dict(bridge(params, tmod))
    return jmod, params, tmod, inputs


@pytest.mark.parametrize("name", CASES)
def test_forward_and_gradients_match_jax(name):
    jmod, params, tmod, inputs = _pair(name)
    jin = [jnp.asarray(x) for x in inputs]
    want = np.asarray(jmod.apply({"params": params}, *jin))
    tin = [torch.as_tensor(x) for x in inputs]
    got = tmod(*tin)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_ATOL)

    w = np.random.RandomState(42).randn(*want.shape).astype(np.float32)
    j_grads = jax.grad(lambda p: jnp.vdot(
        jmod.apply({"params": p}, *jin), w))(params)
    tmod.zero_grad()
    (tmod(*tin) * torch.as_tensor(w)).sum().backward()
    t_grads = {n: p.grad for n, p in tmod.named_parameters()}
    got_g = convert.state_dict_to_flax(t_grads, {"params": params})["params"]
    want_g = convert.flatten_params(j_grads)
    assert set(got_g) == set(want_g)
    for key, g in want_g.items():
        assert _rel(got_g[key], g) <= GRAD_RTOL, key


def test_frozen_table_is_a_buffer_not_a_parameter():
    emb = np.random.RandomState(0).randn(50, 8).astype(np.float32)
    m = simple.SentimentNet(50, 8, 6, head="gru", embeddings=emb)
    names = set(dict(m.named_parameters()))
    assert not any("embed" in n for n in names)
    assert "embeddings" not in m.state_dict()
    np.testing.assert_array_equal(m.embeddings.numpy(), emb)


def test_cross_hash_wraps_like_uint32_over_the_id_range():
    """Every user id >= 2 wraps the product past 2**32; the hash is held
    to the reference's uint32 arithmetic up to the largest ids."""
    rng = np.random.RandomState(3)
    users = np.concatenate([np.arange(0, 6040),
                            np.array([2**20, 2**31 - 1])]).astype(np.int32)
    items = rng.randint(0, 3952, users.shape[0]).astype(np.int32)
    items[-1] = 2**31 - 1
    for buckets in (1000, 7, 2**31 - 1):
        want = np.asarray(((jnp.asarray(users).astype(jnp.uint32)
                            * jnp.uint32(2654435761)
                            + jnp.asarray(items).astype(jnp.uint32))
                           % jnp.uint32(buckets)).astype(jnp.int32))
        got = simple.cross_bucket(torch.as_tensor(users),
                                  torch.as_tensor(items), buckets)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (users[2:].astype(np.uint64) * 2654435761 >= 2**32).all()


def test_wide_deep_forward_at_the_largest_ids():
    """The whole model at MovieLens-1M's id range, the wide tables random:
    the hashed bucket picks the reference's row for the largest ids."""
    rng = np.random.RandomState(4)
    kw = dict(n_users=6040, n_items=3952, embedding_dim=8, hidden=(8,),
              cross_buckets=1000)
    jmod, tmod = jax_simple.WideAndDeep(**kw), simple.WideAndDeep(**kw)
    users = np.concatenate([np.arange(6030, 6040), [0, 1, 2]]).astype(
        np.int32)
    items = np.concatenate([np.arange(3942, 3952), [0, 1, 3951]]).astype(
        np.int32)
    jm = JaxModel(jmod).build(0, jnp.asarray(users[:1]),
                              jnp.asarray(items[:1]))
    params = _randomize_wide(jm.variables["params"], rng)
    tmod.load_state_dict(convert.wide_deep_params_from_jax(params, tmod))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(users),
                                 jnp.asarray(items)))
    got = tmod(torch.as_tensor(users), torch.as_tensor(items))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_ATOL)


def _quantized_leaves_jax(params):
    q = jax_quantize.quantize_params({"params": params})
    return {k: v for k, v in _flat_q(q["params"]).items()
            if isinstance(v, jax_quantize.QTensor)}


def _flat_q(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat_q(v, key))
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("name", ["fraud", "ncf:dedup", "wd:dedup",
                                  "ncf_nomf:dedup"]
                         + [f"sent:{h}:dedup" for h in simple.HEADS]
                         + ["sent:cnn-lstm:frozen"])
def test_quantized_leaf_set_equals_jax(name):
    """The reference quantizes every >= 2-D ``kernel`` / ``embedding`` leaf
    of at least 4096 entries; the port the same leaves, by module type.
    The int8 values and the scales are equal (kernels transposed)."""
    _, params, tmod, _ = _pair(name)
    want = _quantized_leaves_jax(params)
    got = {k: v for k, v in quantize.quantize_params(tmod).items()
           if isinstance(v, quantize.QTensor)}
    names = {convert._torch_name("params", k): k for k in want}
    assert set(got) == set(names)
    for tname, key in names.items():
        ref, qt = want[key], got[tname]
        q = np.asarray(ref.q)
        if key.endswith("kernel"):
            q = q.T
        np.testing.assert_array_equal(qt.q.numpy(), q)
        np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(ref.scale))
    if name.startswith("sent:cnn") and "frozen" not in name:
        assert "conv.weight" in got and "embed.embedding" in got
    if name.startswith("sent:gru"):
        assert "Recurrent_0.body.gru.hr.weight" in got


@pytest.mark.parametrize("name", ["ncf:dedup", "wd:naive", "fraud"]
                         + [f"sent:{h}:dedup" for h in simple.HEADS]
                         + ["sent:gru:frozen"])
def test_int8_rung_forward_matches_jax(name):
    """Weight-only int8 (``make_quantized_forward``, the int8 rungs'
    forward) against the reference's on the same quantized leaves."""
    jmod, params, tmod, inputs = _pair(name)
    qj = jax_quantize.quantize_params({"params": params})
    want = np.asarray(jax_quantize.make_quantized_forward(jmod)(
        qj, *[jnp.asarray(x) for x in inputs]))
    qp = convert.quantized_params_from_jax(qj, tmod)
    got = quantize.make_quantized_forward(tmod)(
        qp, *[torch.as_tensor(x) for x in inputs])
    np.testing.assert_allclose(got.numpy(), want, atol=INT8_ATOL)
    # the port's own quantization of the same weights: equal leaves, so
    # the forwards differ only by the CPU GEMM's rounding, which moves
    # with the operands' memory alignment (1 ulp seen)
    own = quantize.make_quantized_forward(tmod)(
        quantize.quantize_params(tmod), *[torch.as_tensor(x)
                                          for x in inputs])
    np.testing.assert_allclose(own.numpy(), got.numpy(), atol=1e-6)


def test_int8_compute_mode_runs_the_conv1d_in_int8():
    """``compute="int8"`` takes the 1-D convolution through the int8
    product (exact accumulators on the CPU) and looks the table up after
    dequantizing it; the result stays near the fp forward."""
    _, _, tmod, (tokens,) = _pair("sent:cnn:dedup")
    qmodel = quantize.quantize_model(tmod, compute="int8")
    assert isinstance(qmodel.conv, quantize.QConv1d)
    assert isinstance(qmodel.embed, quantize.QDedupEmbed)
    x = torch.as_tensor(tokens)
    with torch.no_grad():
        fp = tmod(x)
        q = qmodel(x)
    np.testing.assert_allclose(q.numpy(), fp.numpy(), atol=2e-2)
