"""The attention models of the port (``models/attention.py``) against the
JAX package's, on weights carried across by
``utils/convert.py::attention_asr_params_from_jax``.

In this process: ``AttentionASR`` with full attention and with dense MoE
blocks, and ``LongContextEncoder``, forward within 2e-4; two
``train_ds2`` steps of an AttentionASR against the JAX package's (losses
1e-5 relative).  One group of two spawned ranks (``torch_dist_scenarios``,
no JAX) runs the same AttentionASR with ``RingAttentionLayer`` on a
(1, 2) ``("data", "sequence")`` mesh and with its MoE blocks expert
parallel on a (2,) ``("expert",)`` mesh (capacity factor 8, so no token
drops on either path): the log-probs within 2e-4 of the reference's full
and dense-MoE forwards, the CTC loss's gradients (whole on every rank)
within 2e-4 relative of JAX's, and two ``train_ds2(mesh=)`` steps with
ring attention equal within 1e-5 to this process's one-rank run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_scenarios as sc
from analytics_zoo_tpu.core.criterion import CTCCriterion as JaxCTC
from analytics_zoo_tpu.core.module import Model as JaxModel
from analytics_zoo_tpu.models import attention as jatt
from analytics_zoo_tpu.parallel import create_mesh
from analytics_zoo_tpu.parallel import train as jax_train
from analytics_zoo_tpu.pipelines import deepspeech2 as jax_pipe
from analytics_zoo_tpu_torch.models import attention as att
from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe
from analytics_zoo_tpu_torch.utils import convert

WORLD = 2
TOL = 2e-4
LOSS_RTOL = 1e-5
KW = dict(dim=16, depth=2, num_heads=2)
MOE_KW = dict(KW, n_experts=2, capacity_factor=8.0)
B, T = 2, 32


def _x(seed=3):
    return np.random.RandomState(seed).randn(B, T, 13).astype(np.float32)


LABELS = np.random.RandomState(4).randint(1, 29, (B, 4)).astype(np.int32)


def _batches():
    rng = np.random.RandomState(5)
    return [{"input": rng.randn(4, T, 13).astype(np.float32),
             "labels": rng.randint(1, 29, (4, 3)).astype(np.int32),
             "label_mask": np.ones((4, 3), np.float32)} for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _jax(kind):
    kw = MOE_KW if kind == "moe" else KW
    model = jatt.AttentionASR(**kw)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.asarray(_x()))["params"])
    return model, params


def _port(kind, **extra):
    model, params = _jax(kind)
    kw = MOE_KW if kind == "moe" else KW
    port = att.AttentionASR(**kw, **extra, device="cpu")
    port.load_state_dict(convert.attention_asr_params_from_jax(params, port))
    return port


def _weights(kind):
    return {k: v.numpy() for k, v in _port(kind).state_dict().items()}


@pytest.fixture(scope="module")
def ranks():
    return sc.spawn_async(WORLD, {
        "ring": ("asr_parallel", dict(
            weights=_weights("full"), kw=KW, x=_x(), labels=LABELS,
            shape=(1, 2), axes=("data", "sequence"), mode="ring",
            batches=_batches())),
        "expert": ("asr_parallel", dict(
            weights=_weights("moe"), kw=MOE_KW, x=_x(), labels=LABELS,
            shape=(2,), axes=("expert",), mode="expert")),
    })


@functools.lru_cache(maxsize=None)
def _jax_out_and_grads(kind):
    model, params = _jax(kind)
    ctc = JaxCTC(blank_id=0)

    def loss(p):
        lp = model.apply({"params": p}, jnp.asarray(_x()))
        return ctc(lp, jnp.asarray(LABELS)), lp

    (_, lp), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    return np.asarray(lp), convert.flatten_params(g)


@pytest.mark.parametrize("kind", ["full", "moe"])
def test_attention_asr_matches_reference(kind):
    """One-rank AttentionASR (full attention; dense MoE blocks) on the
    reference's weights: log-probs within 2e-4."""
    want, _ = _jax_out_and_grads(kind)
    with torch.no_grad():
        got = _port(kind)(torch.from_numpy(_x())).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_long_context_encoder_matches_reference():
    """``LongContextEncoder`` (embedding, sinusoidal positions, blocks,
    final LayerNorm) on the reference's weights: within 2e-4."""
    x = np.random.RandomState(5).randn(2, 64, 8).astype(np.float32)
    enc = jatt.LongContextEncoder(**KW)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(enc.apply({"params": params}, jnp.asarray(x)))
    port = att.LongContextEncoder(**KW, in_features=8, device="cpu")
    port.load_state_dict(convert.flax_variables_to_state_dict(
        {"params": params}, port))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _port_train(model, mesh=None):
    runs = []

    class Recording(pipe.Optimizer):
        def optimize(self):
            runs.append(self)
            return super().optimize()

    base, pipe.Optimizer = pipe.Optimizer, Recording
    try:
        pipe.train_ds2(model, _batches(), epochs=1, lr=2e-3, mesh=mesh)
    finally:
        pipe.Optimizer = base
    return [float(m["loss"]) for m in runs[0].history]


def test_train_ds2_trains_attention_asr(monkeypatch):
    """``train_ds2`` takes an AttentionASR, as the reference's
    ``examples/train_attention_asr.py`` does: two Adam steps' losses
    within 1e-5 relative of the JAX package's ``train_ds2``."""
    model, params = _jax("full")
    jmodel = JaxModel(model, {"params": jax.tree_util.tree_map(
        jnp.array, params)})
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
    jax_pipe.train_ds2(jmodel, _batches(), epochs=1, lr=2e-3,
                       mesh=create_mesh((1,), devices=jax.devices()[:1]))
    want = seen[0].train_summary.values
    got = _port_train(_port("full"))
    assert len(want) == 2
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("mode", ["ring", "expert"])
def test_parallel_attention_asr_matches_reference(ranks, mode):
    """Ring attention over the 2-rank sequence axis, and the MoE blocks'
    two experts one a rank: every rank's log-probs within 2e-4 of the
    reference's one-device forward (full attention; the dense MoE path,
    which routes alike when nothing drops), and the CTC loss's gradients,
    whole on every rank, within 2e-4 relative of JAX's.  With ring
    attention, two ``train_ds2`` steps over the mesh give this process's
    one-rank losses within 1e-5."""
    kind = "full" if mode == "ring" else "moe"
    want, grads = _jax_out_and_grads(kind)
    got = [r[mode] for r in ranks.result()]
    _, params = _jax(kind)
    for r in got:
        np.testing.assert_allclose(r["out"], want, rtol=TOL, atol=TOL)
        g = convert.state_dict_to_flax(
            {k: torch.from_numpy(v) for k, v in r["grads"].items()},
            {"params": params})["params"]
        assert sorted(g) == sorted(grads)
        for k, v in grads.items():
            scale = max(float(np.abs(v).max()), 1e-3)
            np.testing.assert_allclose(g[k], v, atol=TOL * scale, err_msg=k)
    if mode == "ring":
        one = _port_train(_port("full"))
        for r in got:
            np.testing.assert_allclose(r["losses"], one, rtol=LOSS_RTOL)
