"""The port's ``core/layers.py`` against the JAX package's, on the CPU:
each layer on the same numpy-seeded input (NHWC for the reference, NCHW
for the port, transposed between them) and the same weights.

Tolerances: layers that run the same float ops in the same order are
held EQUAL (max pooling, the activations but the softmaxes, the shape
layers, the lookup); a convolution or product sums in another order and
an average pools or batch statistics reduce in another order (within
``TOL``, relative to the output's largest magnitude; measured ≤ 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core import layers as JL
from analytics_zoo_tpu_torch.core import layers as L

torch.set_num_threads(2)
TOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x,
                                                              (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _x(shape=(2, 13, 11, 5), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, padding=1),
    dict(kernel_size=(3, 2), stride=2, padding=(1, 0)),
    dict(kernel_size=3, stride=2, padding="SAME"),
    dict(kernel_size=3, padding="VALID", dilation=2),
    dict(kernel_size=3, padding=6, dilation=6),
    dict(kernel_size=3, padding=1, groups=5, use_bias=False),
])
def test_spatial_convolution_matches_reference(kw):
    x = _x()
    out_ch = 10
    jconv = JL.SpatialConvolution(out_channels=out_ch, **kw)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jconv.apply({"params": params}, jnp.asarray(x))
    conv = L.SpatialConvolution(5, out_ch, **kw)
    k = np.asarray(params["Conv_0"]["kernel"])
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(np.transpose(
            k, (3, 2, 0, 1)))))
        if conv.bias is not None:
            conv.bias.copy_(torch.from_numpy(np.asarray(
                params["Conv_0"]["bias"])))
        got = conv(_nchw(x))
    _close(_nhwc(got), want)


def test_dilated_convolution_and_xavier_init():
    conv = L.SpatialDilatedConvolution(512, 1024, 3, padding=6, dilation=6,
                                       generator=torch.Generator()
                                       .manual_seed(0))
    bound = np.sqrt(6.0 / (9 * 512 + 9 * 1024))
    w = conv.weight.detach()
    assert w.abs().max() <= bound and w.abs().max() > 0.99 * bound
    assert (conv.bias == 0).all()
    lin = L.Linear(30, 7, generator=torch.Generator().manual_seed(0))
    assert lin.weight.abs().max() <= np.sqrt(6.0 / 37)


def test_linear_matches_reference():
    x = _x((4, 30))
    jlin = JL.Linear(out_features=7)
    params = jlin.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jlin.apply({"params": params}, jnp.asarray(x))
    lin = L.Linear(30, 7)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(
            params["Dense_0"]["kernel"]).T))
        lin.bias.copy_(torch.from_numpy(np.asarray(params["Dense_0"]["bias"])))
        got = lin(torch.from_numpy(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("size", [(75, 75), (13, 11), (38, 19)])
@pytest.mark.parametrize("kw", [
    dict(kernel_size=2, stride=2, ceil_mode=True),
    dict(kernel_size=2, stride=2, ceil_mode=False),
    dict(kernel_size=3, stride=2, padding=1, ceil_mode=True),
    dict(kernel_size=3, stride=1, padding=1, ceil_mode=True),
    dict(kernel_size=(3, 2), stride=(2, 1), padding=(1, 0), ceil_mode=True),
])
def test_pooling_with_ceil_mode_matches_reference(size, kw):
    """Max pooling EQUAL; average pooling (whole-window and valid-cell
    divisors) within ``TOL``; the output sizes follow Caffe's ceil rule
    with its clamp."""
    x = _x((2,) + size + (3,), seed=1)
    want = JL.SpatialMaxPooling(**kw).apply({}, jnp.asarray(x))
    got = L.SpatialMaxPooling(**kw)(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    for include in (True, False):
        want = JL.SpatialAveragePooling(count_include_pad=include,
                                        **kw).apply({}, jnp.asarray(x))
        got = L.SpatialAveragePooling(count_include_pad=include,
                                      **kw)(_nchw(x))
        _close(_nhwc(got), want)


def test_pool_out_dim_and_global_pool():
    # 75 → 38 in ceil mode (SSD's pool3); the clamp drops a window that
    # would start in the padding
    assert L._pool_out_dim(75, 2, 2, 0, True) == 38
    assert L._pool_out_dim(75, 2, 2, 0, False) == 37
    for args in [(6, 3, 2, 1, True), (5, 2, 2, 1, True), (7, 3, 3, 1, True),
                 (10, 3, 1, 1, False)]:
        assert L._pool_out_dim(*args) == JL._pool_out_dim(*args)
    x = _x((2, 5, 7, 3))
    want = JL.SpatialAveragePooling(global_pool=True).apply({},
                                                            jnp.asarray(x))
    _close(_nhwc(L.SpatialAveragePooling(global_pool=True)(_nchw(x))), want)


def test_activations_match_reference():
    x = _x((3, 17))
    t = torch.from_numpy(x)
    for jmod, mod, exact in ((JL.ReLU(), L.ReLU(), True),
                             (JL.Sigmoid(), L.Sigmoid(), False),
                             (JL.Tanh(), L.Tanh(), False),
                             (JL.SoftMax(), L.SoftMax(), False),
                             (JL.LogSoftMax(), L.LogSoftMax(), False),
                             (JL.SoftMax(axis=0), L.SoftMax(dim=0), False)):
        want = np.asarray(jmod.apply({}, jnp.asarray(x)))
        got = mod(t).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_dropout_rate_scale_and_eval():
    x = torch.ones(100_000)
    d = L.Dropout(0.25)
    assert d(x) is x
    y = d(x, train=True, generator=torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {
        0.0, float(np.float32(1.0) / np.float32(0.75))}
    assert abs((y == 0).float().mean().item() - 0.25) < 0.01
    y2 = d(x, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)


@pytest.mark.parametrize("seq", [False, True])
def test_batch_normalization_matches_reference(seq):
    """Train mode (batch statistics, the running averages moved) and eval
    mode (the running averages) on the same scale and bias."""
    x = _x((4, 6, 5) if seq else (4, 6, 5, 3), seed=3) * 2.0 + 0.5
    jbn = JL.SequenceBatchNormalization() if seq else JL.BatchNormalization()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(4)
    C = x.shape[-1]
    scale = rng.rand(C).astype(np.float32) + 0.5
    bias = rng.randn(C).astype(np.float32)
    params = {"BatchNorm_0": {"scale": jnp.asarray(scale),
                              "bias": jnp.asarray(bias)}}
    want, upd = jbn.apply({**v, "params": params}, jnp.asarray(x),
                          train=True, mutable=["batch_stats"])
    bn = L.SequenceBatchNormalization(C) if seq else L.BatchNormalization(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    t = torch.from_numpy(x) if seq else _nchw(x)
    got = bn(t, train=True)
    _close(got.detach().numpy() if seq else _nhwc(got), want)
    stats = upd["batch_stats"]["BatchNorm_0"]
    _close(bn.running_mean.numpy(), stats["mean"])
    _close(bn.running_var.numpy(), stats["var"])
    want = jbn.apply({**upd, "params": params}, jnp.asarray(x))
    got = bn(t)
    _close(got.detach().numpy() if seq else _nhwc(got), want)


def test_lookup_table_matches_reference():
    ids = np.array([[0, 3, 9], [9, 1, 1]], np.int32)
    jlt = JL.LookupTable(vocab_size=10, embedding_dim=4)
    params = jlt.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    lt = L.LookupTable(10, 4, generator=torch.Generator().manual_seed(0))
    assert abs(lt.weight.std().item() - 0.05) < 0.03
    with torch.no_grad():
        lt.weight.copy_(torch.from_numpy(np.asarray(
            params["Embed_0"]["embedding"])))
    np.testing.assert_array_equal(
        lt(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jlt.apply({"params": params}, jnp.asarray(ids))))


def test_shape_layers_match_reference():
    x = _x((2, 3, 1, 4))
    t = torch.from_numpy(x)
    for jmod, mod in ((JL.Transpose(perm=(0, 2, 3, 1)),
                       L.Transpose((0, 2, 3, 1))),
                      (JL.Reshape(shape=(12,)), L.Reshape((12,))),
                      (JL.Reshape(shape=(4, 6), batch_mode=False),
                       L.Reshape((4, 6), batch_mode=False)),
                      (JL.InferReshape(shape=(-1, 2)),
                       L.InferReshape((-1, 2))),
                      (JL.Squeeze(axis=2), L.Squeeze(2)),
                      (JL.Squeeze(), L.Squeeze()),
                      (JL.Select(axis=1, index=2), L.Select(1, 2)),
                      (JL.Reverse(axis=3), L.Reverse(3))):
        np.testing.assert_array_equal(
            mod(t).numpy(), np.asarray(jmod.apply({}, jnp.asarray(x))))
