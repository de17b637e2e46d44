"""Parity of the port's containers and ``Model`` wrapper with the JAX
package's ``core/module.py``, on the CPU (the reference's cases of
``tests/test_core_layers.py``): every container on bridged weights,
``accepted_kwargs``, and ``Model``'s build, forward, save/load,
``load_weights``, ``parameter_count``, ``summary`` and train-mode
dropout from a generator.  Inputs are made by numpy from a seed.

Tolerances: container outputs within 1e-6 (the same fp32 ops; the dense
products may add in another order); save/load and ``load_weights`` round
trips EQUAL; parameter counts EQUAL.
"""

import re

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu import core as J
from analytics_zoo_tpu.core import module as jax_module
from analytics_zoo_tpu_torch.core import layers as L
from analytics_zoo_tpu_torch.core import module as M
from analytics_zoo_tpu_torch.models.simple import SentimentNet
from analytics_zoo_tpu_torch.utils.convert import flatten_params

torch.set_num_threads(2)

ATOL = 1e-6


def _bridge(variables):
    """A reference container's params → the port twin's ``state_dict``:
    ``layers_0/layers_1/Dense_0/kernel`` → ``layers.0.layers.1.weight``,
    kernels transposed."""
    out = {}
    for key, value in flatten_params(variables["params"]).items():
        name = re.sub(r"layers_(\d+)", r"layers.\1", key)
        name = name.replace("/Dense_0", "").replace("/", ".")
        if name.endswith(".kernel"):
            name, value = name[:-len("kernel")] + "weight", value.T
        else:
            value = np.asarray(value)
        out[name] = torch.tensor(np.array(value))
    return out


def _pair(jnet, tnet, x):
    v = jnet.init(jax.random.PRNGKey(0), x)
    tnet.load_state_dict(_bridge(v))
    return v


def _np(t):
    return tuple(_np(u) for u in t) if isinstance(t, tuple) \
        else t.detach().numpy()


X = np.random.RandomState(0).randn(3, 4).astype(np.float32)

# (reference container, port container): each pair on X
CONTAINERS = {
    "sequential": lambda: (
        J.Sequential([J.Linear(5), J.ReLU(), J.Linear(2), J.LogSoftMax()]),
        M.Sequential([L.Linear(4, 5), L.ReLU(), L.Linear(5, 2),
                      L.LogSoftMax()])),
    "concat_join": lambda: (
        J.Sequential([J.ConcatTable([J.Linear(3), J.Linear(5)]),
                      J.JoinTable(axis=-1)]),
        M.Sequential([M.ConcatTable([L.Linear(4, 3), L.Linear(4, 5)]),
                      M.JoinTable(axis=-1)])),
    "concat_select": lambda: (
        J.Sequential([J.ConcatTable([J.Identity(), J.Linear(2)]),
                      J.SelectTable(1)]),
        M.Sequential([M.ConcatTable([M.Identity(), L.Linear(4, 2)]),
                      M.SelectTable(1)])),
    "parallel_cadd": lambda: (
        J.Sequential([J.ConcatTable([J.Identity(), J.Lambda(jnp.tanh)]),
                      J.ParallelTable([J.Linear(3), J.Linear(3)]),
                      J.CAddTable()]),
        M.Sequential([M.ConcatTable([M.Identity(), M.Lambda(torch.tanh)]),
                      M.ParallelTable([L.Linear(4, 3), L.Linear(4, 3)]),
                      M.CAddTable()])),
    "flatten": lambda: (
        J.Sequential([J.ConcatTable([J.ConcatTable([J.Identity(),
                                                    J.Linear(2)]),
                                     J.Linear(3)]),
                      J.FlattenTable()]),
        M.Sequential([M.ConcatTable([M.ConcatTable([M.Identity(),
                                                    L.Linear(4, 2)]),
                                     L.Linear(4, 3)]),
                      M.FlattenTable()])),
}


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_container_matches_jax(name):
    jnet, tnet = CONTAINERS[name]()
    v = _pair(jnet, tnet, jnp.asarray(X))
    want = jnet.apply(v, jnp.asarray(X))
    got = tnet(torch.as_tensor(X))
    want = tuple(np.asarray(w) for w in want) if isinstance(want, tuple) \
        else np.asarray(want)
    got = _np(got)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


class _Flags(nn.Module):
    def forward(self, x, train: bool = False):
        return x + (1.0 if train else 0.0)


class _Plain(nn.Module):
    def forward(self, x):
        return x * 2.0


class _Any(nn.Module):
    def forward(self, x, **kwargs):
        return x + float(len(kwargs))


class _JFlags(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, x, train: bool = False):
        return x + (1.0 if train else 0.0)


class _JPlain(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, x):
        return x * 2.0


def test_accepted_kwargs_routes_flags_like_jax():
    kw = {"train": True, "generator": None}
    assert M.accepted_kwargs(_Flags(), kw) == {"train": True}
    assert M.accepted_kwargs(_Plain(), kw) == {}
    assert M.accepted_kwargs(_Any(), kw) == kw
    assert M.accepted_kwargs(_Plain(), {}) == {}
    assert jax_module.accepted_kwargs(_JFlags(), kw) == {"train": True}
    assert jax_module.accepted_kwargs(_JPlain(), kw) == {}
    # through a Sequential: only the layer that names train gets it
    x = np.ones((2, 3), np.float32)
    got = M.Sequential([_Plain(), _Flags(), _Plain()])(torch.as_tensor(x),
                                                        train=True)
    jn = J.Sequential([_JPlain(), _JFlags(), _JPlain()])
    want = jn.apply(jn.init(jax.random.PRNGKey(0), x), x, train=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lazy_net():
    return M.Sequential([nn.LazyLinear(5), L.ReLU(), nn.LazyLinear(2)])


def test_model_build_materialises_lazy_layers_and_counts_like_jax():
    m = M.Model(_lazy_net(), device="cpu").build(0, np.ones((1, 3),
                                                            np.float32))
    jm = jax_module.Model(J.Sequential([J.Linear(5), J.ReLU(), J.Linear(2)]))
    jm.build(0, jnp.ones((1, 3)))
    assert m.parameter_count() == jm.parameter_count() == 3 * 5 + 5 + 5 * 2 + 2
    assert isinstance(m.module.layers[0], nn.Linear)
    # the same seed draws the same weights; another seed others
    again = M.Model(_lazy_net(), device="cpu").build(0, np.ones((1, 3),
                                                                np.float32))
    other = M.Model(_lazy_net(), device="cpu").build(1, np.ones((1, 3),
                                                                np.float32))
    for (n, a), b, c in zip(m.params.items(), again.params.values(),
                            other.params.values()):
        assert torch.equal(a, b), n
        if n.endswith("weight"):
            assert not torch.equal(a, c), n
    # flax's Dense defaults: LeCun-normal kernel, zero bias
    assert not m.params["layers.0.bias"].any()


def test_model_forward_save_load_and_load_weights(tmp_path):
    net = M.Sequential([L.Linear(3, 4), L.ReLU(), L.Linear(4, 2)])
    m = M.Model(net, device="cpu").build(0, np.ones((1, 3), np.float32))
    x = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    y = m(x)                                        # numpy in, tensor out
    path = str(tmp_path / "model.pt")
    m.save(path)
    m2 = M.Model(M.Sequential([L.Linear(3, 4), L.ReLU(), L.Linear(4, 2)]),
                 device="cpu").build(1, np.ones((1, 3), np.float32))
    assert not torch.equal(m2(x), y)
    m2.load(path)
    assert torch.equal(m2(x), y)
    m3 = M.Model(M.Sequential([L.Linear(3, 4), L.ReLU(), L.Linear(4, 2)]),
                 device="cpu").build(2, np.ones((1, 3), np.float32))
    m3.load_weights({k: v.numpy() for k, v in
                     m.module.state_dict().items()})
    assert torch.equal(m3(x), y)
    with pytest.raises(RuntimeError):
        m3.load_weights({"layers.0.weight": np.zeros((4, 3), np.float32)})


def test_model_train_mode_dropout_from_a_generator():
    """``train()``: the network gets ``train=True`` and a dropout
    generator — the same generator seed gives the same masks; eval mode
    (``evaluate()``) is deterministic and dropout-free."""
    m = M.Model(SentimentNet(60, 8, 16, head="cnn"), device="cpu").build(
        0, np.zeros((1, 7), np.int32))
    x = np.random.RandomState(2).randint(0, 60, (4, 7)).astype(np.int32)
    with torch.no_grad():
        ev = m.evaluate()(x)
        assert torch.equal(ev, m(x))
        m.train()
        a = m(x, generator=torch.Generator().manual_seed(5))
        b = m(x, generator=torch.Generator().manual_seed(5))
        c = m(x, generator=torch.Generator().manual_seed(6))
        own = m(x)                      # the model's own seeded generator
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ev) and not torch.equal(own, ev)
    assert m.training and not m.evaluate().training


def test_model_summary_lists_modules_shapes_and_params():
    m = M.Model(SentimentNet(60, 8, 16, head="bilstm"), device="cpu").build(
        0, np.zeros((1, 7), np.int32))
    text = m.summary(np.zeros((2, 7), np.int32))
    for name in ("embed", "BiRecurrent_0", "fc", "[2, 7, 8]", "[2, 1]"):
        assert name in text, name
    assert f"total params: {m.parameter_count():,}" in text
    top = M.Model(SentimentNet(60, 8, 16, head="bilstm"), device="cpu")
    assert "BiRecurrent_0.fwd" not in top.summary(np.zeros((2, 7), np.int32),
                                                  depth=1)
