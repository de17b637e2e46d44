"""Pipeline parallelism of the port (``parallel/pipeline.py``,
``models/attention.py::make_pipeline_forward_fn``) over gloo ranks
against the JAX package's on its virtual CPU devices.

One group of four spawned ranks (``torch_dist_scenarios``, no JAX) runs:
``pipeline_forward`` of the reference tests' residual tanh block at
depth 4 over a (4,) ``("pipe",)`` mesh with 4 microbatches and with 1,
and at depth 2 over a (2, 2) ``("data", "pipe")`` mesh (each data rank
its rows), each with the gradients of a squared error for the stack and
the input; ``param_specs`` with a Megatron pair in each stage on a
("model", "pipe") (2, 2) mesh; ``pipeline_forward_het`` of the reference tests' wide blocks
through the flat and the grouped carrier, with the carrier's gradient;
an ``AttentionASR`` (dim 16, depth 2) through
``make_pipeline_forward_fn`` on (2, 2): its log-probs, then one train
step's CTC loss and gradients.  Tolerances are the reference tests'
(``tests/test_pipeline_parallel.py``): forward 1e-5 relative, gradients
1e-4, the AttentionASR forward 1e-4 (its loss 1e-5 and gradients 1e-4
relative against the reference's pipelined forward on a JAX mesh of the
same shape).  The carriers, their masks and the errors are checked in
this process.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import torch_dist_scenarios as sc
from analytics_zoo_tpu.core.criterion import CTCCriterion as JaxCTC
from analytics_zoo_tpu.models.attention import AttentionASR as JaxASR
from analytics_zoo_tpu.models.attention import (
    make_pipeline_forward_fn as jax_make_pipeline_forward_fn)
from analytics_zoo_tpu.parallel import create_mesh
from analytics_zoo_tpu.parallel import pipeline as jpipe
from analytics_zoo_tpu_torch.models.attention import AttentionASR
from analytics_zoo_tpu_torch.parallel import pipeline
from analytics_zoo_tpu_torch.utils import convert

WORLD = 4
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ASR_RTOL, ASR_ATOL = 1e-4, 1e-5
ASR_KW = dict(dim=16, depth=2, num_heads=2)


class Block(nn.Module):
    width: int = 8

    @nn.compact
    def __call__(self, x):
        return x + nn.tanh(nn.Dense(self.width, name="fc")(x))


class WideBlock(nn.Module):
    hidden: int

    @nn.compact
    def __call__(self, x):
        h = nn.tanh(nn.Dense(self.hidden, name="in")(x))
        return x + nn.Dense(x.shape[-1], name="out")(h)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dense(rng, n_in, n_out):
    """A flax Dense's parameters at its init scale (lecun-normal)."""
    return {"kernel": (rng.randn(n_in, n_out) / np.sqrt(n_in))
            .astype(np.float32),
            "bias": (rng.randn(n_out) * 0.1).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _stack(L, seed=0):
    rng = np.random.RandomState(seed)
    return _np(jpipe.stack_stage_params(
        [{"fc": _dense(rng, 8, 8)} for _ in range(L)]))


@functools.lru_cache(maxsize=None)
def _het(seed=20):
    rng = np.random.RandomState(seed)
    return [{"in": _dense(rng, 8, 4 * (i + 1)),
             "out": _dense(rng, 4 * (i + 1), 8)} for i in range(4)]


def _data(seed, B=16):
    r = np.random.RandomState(seed)
    return (r.randn(B, 8).astype(np.float32),
            (r.randn(B, 8) * 0.2).astype(np.float32))


FWD = {"fwd4": (4, 4, 1, ((4,), ("pipe",)), None),
       "fwd1": (4, 1, 2, ((4,), ("pipe",)), None),
       "fwd2d": (2, 2, 3, ((2, 2), ("data", "pipe")), "data")}


@functools.lru_cache(maxsize=None)
def _asr():
    rng = np.random.RandomState(9)
    labels = rng.randint(1, 29, (8, 4)).astype(np.int32)
    batch = {"input": rng.randn(8, 32, 13).astype(np.float32),
             "labels": labels, "label_mask": np.ones((8, 4), np.float32)}
    model = JaxASR(**ASR_KW)
    params = _np(model.init(jax.random.PRNGKey(0),
                            jnp.asarray(batch["input"]))["params"])
    return model, params, batch


@functools.lru_cache(maxsize=None)
def _megatron():
    rng = np.random.RandomState(11)
    return {"params": {
        "w1": (rng.randn(2, 16, 8) * .3).astype(np.float32),
        "w2": (rng.randn(2, 8, 16) * .3).astype(np.float32)},
        "xs": rng.randn(4, 8, 16).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks():
    scenarios = {}
    for key, (L, n_micro, seed, (shape, axes), batch_axis) in FWD.items():
        x, tgt = _data(seed)
        scenarios[key] = ("pipe_forward", dict(
            stacked=_stack(L), x=x, n_micro=n_micro, tgt=tgt, shape=shape,
            axes=axes, batch_axis=batch_axis))
    x, tgt = _data(7, 8)
    for grouped in (False, True):
        scenarios[f"het{grouped}"] = ("pipe_het", dict(
            params=_het(), x=x, n_micro=2, tgt=tgt, grouped=grouped))
    _, params, batch = _asr()
    port = AttentionASR(**ASR_KW, device="cpu")
    weights = {k: v.numpy() for k, v in
               convert.attention_asr_params_from_jax(params, port).items()}
    scenarios["megatron"] = ("pipe_megatron", dict(
        **_megatron(), shape=(2, 2), axes=("model", "pipe")))
    scenarios["asr"] = ("pipe_asr", dict(
        weights=weights, kw=ASR_KW, batch=batch, n_micro=2, shape=(2, 2),
        axes=("data", "pipe")))
    return sc.spawn_async(WORLD, scenarios)


def _jax_block_loss(stacked, x, tgt, n_micro, mesh, batch_axis):
    block = Block()
    mbs = jpipe.split_microbatches(x, n_micro)
    y = jpipe.pipeline_forward(lambda p, a: block.apply({"params": p}, a),
                               stacked, mbs, mesh, batch_axis=batch_axis)
    return jnp.mean((y.reshape(x.shape) - tgt) ** 2), y


@pytest.mark.parametrize("key", list(FWD))
def test_pipeline_forward_matches_reference(ranks, key):
    """The GPipe schedule at depth 4 over 4 ranks (4 microbatches, and
    1), and at depth 2 over the pipe lines of a (2, 2) data × pipe mesh:
    every rank's output within 1e-5 of the reference's
    ``pipeline_forward`` on the same mesh shape, and the gradients of
    ``mean((y − tgt)²)`` (the stack whole on every rank, the rank's input
    rows) within 1e-4 of JAX's through the reference schedule."""
    L, n_micro, seed, (shape, axes), batch_axis = FWD[key]
    x, tgt = _data(seed)
    mesh = create_mesh(shape, axis_names=axes,
                       devices=jax.devices()[:int(np.prod(shape))])
    stacked = jax.tree_util.tree_map(jnp.asarray, _stack(L))
    (_, y), (g_p, g_x) = jax.jit(jax.value_and_grad(
        lambda p, a: _jax_block_loss(p, a, jnp.asarray(tgt), n_micro, mesh,
                                     batch_axis),
        (0, 1), has_aux=True))(stacked, jnp.asarray(x))
    y = np.asarray(y).reshape(x.shape)
    n_data = shape[0] if batch_axis else 1
    for r in ranks.result():
        got = r[key]
        start, per = got["rows"]
        rows = slice(start, start + per)
        np.testing.assert_allclose(got["out"].reshape(per, 8), y[rows],
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
        # the local loss is its rows' mean: the data ranks' mean is JAX's
        np.testing.assert_allclose(got["g_x"] / n_data,
                                   np.asarray(g_x)[rows], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        if batch_axis is None:
            for name in ("kernel", "bias"):
                np.testing.assert_allclose(
                    got["g_params"]["fc"][name], np.asarray(g_p["fc"][name]),
                    rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("grouped", [False, True])
def test_pipeline_forward_het_matches_reference(ranks, grouped):
    """Heterogeneous stages over 4 ranks through the flat and the grouped
    carrier: the output within 1e-5 of the reference's
    ``pipeline_forward_het``, the carrier's gradient within 1e-4 of
    JAX's."""
    params = jax.tree_util.tree_map(jnp.asarray, _het())
    x, tgt = _data(7, 8)
    flat = (jpipe.flatten_stage_params_grouped if grouped
            else jpipe.flatten_stage_params)
    carrier, metas = flat(params)
    mesh = create_mesh((4,), axis_names=("pipe",), devices=jax.devices()[:4])
    blocks = [WideBlock(4 * (i + 1)) for i in range(4)]
    fns = [(lambda p, a, b=b: b.apply({"params": p}, a)) for b in blocks]

    def loss(c):
        y = jpipe.pipeline_forward_het(
            fns, c, metas, jpipe.split_microbatches(jnp.asarray(x), 2), mesh)
        return jnp.mean((y.reshape(x.shape) - tgt) ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(carrier)
    for r in ranks.result():
        got = r[f"het{grouped}"]
        np.testing.assert_allclose(got["out"], np.asarray(y), rtol=FWD_RTOL,
                                   atol=FWD_ATOL)
        if grouped:
            assert sorted(got["grad"]) == sorted(g)
            for k in g:
                np.testing.assert_allclose(got["grad"][k], np.asarray(g[k]),
                                           rtol=GRAD_RTOL, atol=GRAD_ATOL)
        else:
            np.testing.assert_allclose(got["grad"], np.asarray(g),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_pipeline_with_megatron_stages_matches_reference(ranks):
    """``param_specs`` (the pipe × model composition) on a ("model",
    "pipe") mesh of (2, 2): each stage a Megatron column → row pair, its
    kernels cut over ``model`` and the pair closed by a sum over it, as
    the reference's ``tests/test_tensor_parallel.py`` composes them:
    the loss within 1e-5 and the kernels' gradients (whole on every
    rank) within ``rtol=1e-4, atol=1e-5`` of the unsharded sequential
    stack's."""
    m = _megatron()
    p = jax.tree_util.tree_map(jnp.asarray, m["params"])
    xs = jnp.asarray(m["xs"])

    def ref_loss(p):
        def stack(a):
            for s in range(2):
                a = a + jnp.tanh(a @ p["w1"][s]) @ p["w2"][s]
            return a
        return jnp.mean(jax.vmap(stack)(xs) ** 2)

    loss, grads = jax.value_and_grad(ref_loss)(p)
    for r in ranks.result():
        got = r["megatron"]
        assert abs(got["loss"] - float(loss)) < 1e-5
        for k in grads:
            np.testing.assert_allclose(got["grads"][k], np.asarray(grads[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_attention_asr_pipelined_matches_reference(ranks):
    """``make_pipeline_forward_fn`` of an AttentionASR (depth 2, one block
    a stage) over a (2, 2) data × pipe mesh with 2 microbatches a data
    rank: the log-probs within 1e-4 of the reference's pipelined forward
    on a JAX mesh of the same shape; one train step's CTC loss within
    1e-5 relative and every gradient (whole on every rank, averaged over
    the data ranks) within 1e-4 relative of JAX's through it."""
    model, params, batch = _asr()
    mesh = create_mesh((2, 2), axis_names=("data", "pipe"),
                       devices=jax.devices()[:4])
    fwd = jax_make_pipeline_forward_fn(model, mesh, n_micro=4,
                                       batch_axis="data")
    ctc = JaxCTC(blank_id=0)

    def loss_fn(p):
        out, _ = fwd({"params": p}, jnp.asarray(batch["input"]))
        return ctc(out, jnp.asarray(batch["labels"]),
                   label_mask=jnp.asarray(batch["label_mask"])), out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    out = np.asarray(out)
    want = convert.flatten_params(grads)
    got = [r["asr"] for r in ranks.result()]
    for r in got:
        start, per = r["rows"]
        np.testing.assert_allclose(r["out"], out[start:start + per],
                                   rtol=ASR_RTOL, atol=ASR_ATOL)
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        g = convert.state_dict_to_flax(
            {k: torch.from_numpy(v) for k, v in r["grads"].items()},
            {"params": params})["params"]
        assert sorted(g) == sorted(want)
        for k, v in want.items():
            scale = float(np.abs(np.asarray(v)).max())
            np.testing.assert_allclose(g[k], np.asarray(v),
                                       atol=GRAD_RTOL * max(scale, 1e-3),
                                       err_msg=k)
        for k, v in r["grads"].items():
            np.testing.assert_array_equal(v, got[0]["grads"][k], err_msg=k)


def test_carriers_round_trip_against_reference():
    """The flat and the grouped carriers of the reference tests' wide
    stages (one with a bf16 leaf) EQUAL to the reference's: the same
    keys, rows and padding; ``carrier_decay_mask``,
    ``stage_carrier_slice`` and ``unflatten_stage`` give back every leaf
    with its dtype."""
    params = [dict(p) for p in _het()]
    params[2]["gamma"] = np.asarray([1.5, 2.5], jnp.bfloat16)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = [{k: (torch.tensor(np.asarray(v, np.float32)).to(torch.bfloat16)
                    if k == "gamma" else
                    {n: torch.tensor(np.asarray(a)) for n, a in v.items()})
                for k, v in p.items()} for p in params]
    jc, _ = jpipe.flatten_stage_params_grouped(jparams)
    tc, metas = pipeline.flatten_stage_params_grouped(tparams)
    assert sorted(tc) == sorted(jc) == ["decay:float32", "no_decay:bfloat16",
                                        "no_decay:float32"]
    for k in jc:
        np.testing.assert_array_equal(tc[k].float().numpy(),
                                      np.asarray(jc[k], np.float32))
    assert pipeline.carrier_decay_mask(tc) == jpipe.carrier_decay_mask(jc)
    for j, p in enumerate(tparams):
        rec = pipeline.unflatten_stage(pipeline.stage_carrier_slice(tc, j),
                                       metas[j])
        for a, b in zip(pipeline.tree_leaves(rec), pipeline.tree_leaves(p)):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
    flat_j, _ = jpipe.flatten_stage_params(
        jax.tree_util.tree_map(jnp.asarray, _het()))
    flat_t, fmetas = pipeline.flatten_stage_params(
        [{k: {n: torch.tensor(a) for n, a in v.items()}
          for k, v in p.items()} for p in _het()])
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    rec = pipeline.unflatten_stage(flat_t[3], fmetas[3])
    np.testing.assert_array_equal(rec["out"]["kernel"].numpy(),
                                  _het()[3]["out"]["kernel"])


def test_stage_count_and_microbatch_errors():
    """The reference's errors: a stack or a stage list that is not one
    stage a rank, ``param_specs`` whose dim 0 is not the pipe axis, a
    batch the microbatches do not divide, and a model depth other than
    the pipe width."""
    mesh = sc.StubMesh({"pipe": 4})
    stacked = {"fc": {"kernel": torch.zeros(8, 8, 8),
                      "bias": torch.zeros(8, 8)}}
    x = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="one stage per device"):
        pipeline.pipeline_forward(sc._block, stacked, x, mesh)
    with pytest.raises(ValueError, match="must shard dim 0 over 'pipe'"):
        pipeline.pipeline_forward(
            sc._block, {"w": torch.zeros(4, 2)}, x, mesh,
            param_specs={"w": ("model", None)})
    carrier, metas = pipeline.flatten_stage_params(
        [{"w": torch.zeros(2)}] * 3)
    with pytest.raises(ValueError, match="need exactly one stage per"):
        pipeline.pipeline_forward_het([sc._block] * 3, carrier, metas, x,
                                      mesh)
    assert pipeline.split_microbatches(torch.zeros(12, 5), 3).shape == (
        3, 4, 5)
    with pytest.raises(ValueError, match="divisible"):
        pipeline.split_microbatches(torch.zeros(12, 5), 5)
    from analytics_zoo_tpu_torch.models.attention import (
        make_pipeline_forward_fn)
    with pytest.raises(ValueError, match="model depth 2 != 'pipe'"):
        make_pipeline_forward_fn(AttentionASR(**ASR_KW, device="cpu"), mesh)
