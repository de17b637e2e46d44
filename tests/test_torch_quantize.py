"""The port's int8 quantization (``utils/quantize.py``) against the JAX
package's, on the CPU: the same seeded SSD300 weights bridged into both.

The int8 weights and their scales are bit-equal and select the same
layers (every convolution but ``conv1_1``).  The int8 × int8 layers hold
int32 accumulators equal to the reference's on the same int8 inputs over
SSD300's convolution geometries; the dynamic activation quantization
rounds the same floats (no .5 tie moved in these tests: the port divides
by a 0-d tensor, as the reference's division).  The whole forward under
both compute modes (``INT8_JIT_TOL`` says why the int8 one is held to the
reference's eager arithmetic bit for bit and to its jitted program by a
tolerance), and the reference's npz artifact read by the port, follow.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax import lax

from analytics_zoo_tpu.models import ssd as jax_ssd
from analytics_zoo_tpu.utils import quantize as jq
from analytics_zoo_tpu_torch.models import ssd
from analytics_zoo_tpu_torch.pipelines.ssd import PreProcessParam, SSDPredictor
from analytics_zoo_tpu_torch.utils import quantize as tq
from analytics_zoo_tpu_torch.utils.convert import (_torch_name,
                                                   quantized_params_from_jax,
                                                   ssd_params_from_jax)
from test_torch_ssd import seeded_flax_params

torch.set_num_threads(2)

# SSD300's quantized convolution geometries, at reduced channels and
# sizes: (name, C, O, k, stride, pad, dilation, H)
GEOMETRIES = [
    ("3x3_pad1", 16, 24, 3, 1, 1, 1, 12),
    ("fc6_dilation6", 16, 32, 3, 1, 6, 6, 19),
    ("1x1", 32, 16, 1, 1, 0, 1, 10),
    ("3x3_stride2_pad1", 16, 24, 3, 2, 1, 1, 19),
    ("3x3_pad0", 16, 24, 3, 1, 0, 1, 5),
    ("conf_head_n84", 16, 84, 3, 1, 1, 1, 10),
    ("conf_head_n126", 16, 126, 3, 1, 1, 1, 5),
]
# the whole SSD300 forward, batch 1, port against reference, each output
# relative to its largest magnitude.  Weight-only runs the fp32
# convolutions of test_torch_ssd's parity on dequantized weights
# (measured 4.0e-6, held to its 2e-5).  int8 x int8 is bit-equal to the
# reference's int8 arithmetic run eagerly (``int8_apply``); its jitted
# ``make_quantized_forward`` differs from that eager run by 3.6e-2 of the
# output: XLA contracts each layer's rescale and bias into one fused
# multiply-add (the jitted layer's outputs equal the fp64 ``acc * scale +
# bias`` rounded once), which moves one activation of conv2_1's input by
# 5.7e-8, conv3_1's quantization then flips one int8 value, and each later
# layer's dynamic scale spreads the change (the port's int8 error against
# its own fp32 forward is 5.7e-2 on an NVIDIA H100 80GB HBM3 at 700.00 W,
# chip_smoke.py's ssd_serving line).  Held to 5e-2 there.
DEQUANT_TOL = 2e-5
INT8_JIT_TOL = 5e-2


@pytest.fixture(scope="module")
def bridged():
    """Reference SSD300 (21 classes) and the port's on the same weights,
    each quantized by its own package."""
    jmod = jax_ssd.SSDVgg(num_classes=21, resolution=300)
    variables = {"params": seeded_flax_params(jmod, 300)}
    tmod = ssd.SSDVgg(21, 300, device="cpu", seed=1)
    tmod.load_state_dict(ssd_params_from_jax(variables["params"], tmod))
    jqv = jq.quantize_params(variables)
    return jmod, variables, jqv, tmod, tq.quantize_params(tmod)


def _ref_qtensors(jqv):
    """The reference's QTensors by the port's names."""
    out = {}

    def visit(path, leaf):
        if isinstance(leaf, jq.QTensor):
            key = "/".join(str(p.key) for p in path[1:])   # drop "params"
            out[_torch_name("params", key)] = leaf
        return leaf

    jax.tree_util.tree_map_with_path(
        visit, jqv, is_leaf=lambda x: isinstance(x, jq.QTensor))
    return out


def test_quantize_tensor_bit_equal():
    rng = np.random.RandomState(0)
    w = rng.randn(24, 16, 3, 3).astype(np.float32)    # OIHW
    w[3] = 0.0                                        # an all-zero channel
    w[5, 0, 0, 0] = 1e-30                             # a tiny amax
    got = tq.quantize_tensor(torch.from_numpy(w))
    ref = jq.quantize_tensor(np.transpose(w, (2, 3, 1, 0)))   # HWIO
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(
        got.q.numpy(), np.transpose(np.asarray(ref.q), (3, 2, 0, 1)))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    back = got.dequant().numpy()
    assert (np.abs(back - w) <= got.scale.numpy()[:, None, None, None] / 2
            + 1e-7).all()


def test_quantize_params_bit_equal_and_same_layers(bridged):
    _, _, jqv, tmod, tqp = bridged
    ref = _ref_qtensors(jqv)
    got = {k: v for k, v in tqp.items() if isinstance(v, tq.QTensor)}
    convs = {f"{n}.weight" for n, m in tmod.named_modules()
             if isinstance(m, torch.nn.Conv2d)}
    assert set(got) == set(ref) == convs - {"vgg.conv1_1.weight"}
    assert len(got) == 34
    for k, qt in got.items():
        r = ref[k]
        np.testing.assert_array_equal(
            qt.q.numpy(), np.transpose(np.asarray(r.q), (3, 2, 0, 1)),
            err_msg=k)
        np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(r.scale),
                                      err_msg=k)
    # the rest passes through untouched
    sd = tmod.state_dict()
    for k, v in tqp.items():
        if not isinstance(v, tq.QTensor):
            assert torch.equal(v, sd[k])


def test_quantized_model_swaps_every_quantized_layer(bridged):
    _, _, _, tmod, tqp = bridged
    qmodel = tq.quantize_model(tmod, compute="int8")
    qconvs = {n for n, m in qmodel.named_modules()
              if isinstance(m, tq.QConv2d)}
    assert {f"{n}.weight" for n in qconvs} == {
        k for k, v in tqp.items() if isinstance(v, tq.QTensor)}
    assert all(m.compute == "int8" for m in qmodel.modules()
               if isinstance(m, tq.QConv2d))
    # no fp32 copy of a quantized weight, and the original untouched
    assert not any(isinstance(m, torch.nn.Conv2d) and m.weight.numel()
                   >= tq.MIN_SIZE for m in qmodel.modules())
    assert isinstance(tmod.vgg.conv1_2, torch.nn.Conv2d)
    with pytest.raises(ValueError, match="compute mode"):
        tq.quantize_model(tmod, compute="int4")


def _ref_activation(x_nhwc):
    a = jnp.asarray(x_nhwc)
    qa, s = jq._dynamic_quant_activation(a)
    return np.asarray(qa), np.asarray(s), np.asarray(a / s)


def _ties_moved(got_q, ref_q, ref_ratio):
    """Where the two int8 activations differ: each such entry must sit on
    an exact .5 tie of the reference's quotient; returns their count."""
    diff = got_q != ref_q
    frac = np.abs(ref_ratio[diff]) % 1.0
    assert np.all(frac == 0.5), "an int8 activation differs off a tie"
    return int(diff.sum())


@pytest.mark.parametrize("name,C,O,k,s,p,d,H", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_int8_conv_geometries(name, C, O, k, s, p, d, H):
    """``_int8_conv`` against the port's int8 convolution: the activation
    quantization, the int32 accumulators on the same int8 inputs (equal)
    and the rescaled outputs (1e-6 relative)."""
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    x = (rng.randn(2, H, H, C) * 3).astype(np.float32)            # NHWC
    w = (rng.randn(k, k, C, O) * 0.1).astype(np.float32)          # HWIO
    b = (rng.randn(O) * 0.1).astype(np.float32)
    jqk = jq.quantize_tensor(w)
    m = fnn.Conv(features=O, kernel_size=(k, k), strides=(s, s),
                 padding=[(p, p), (p, p)], kernel_dilation=(d, d))
    ref_y = np.asarray(jq._int8_conv(m, jnp.asarray(x), jqk, jnp.asarray(b)))
    ref_qa, ref_s, ref_ratio = _ref_activation(x)
    ref_acc = np.asarray(lax.conv_general_dilated(
        jnp.asarray(ref_qa), jqk.q, (s, s), [(p, p), (p, p)],
        rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))

    conv = torch.nn.Conv2d(C, O, k, stride=s, padding=p, dilation=d)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.transpose(w, (3, 2, 0, 1))))
        conv.bias.copy_(torch.from_numpy(b))
    layer = tq.QConv2d(conv, tq.quantize_tensor(conv.weight), "int8")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    qa, a_scale = tq.quantize_activation(xt)
    assert a_scale.item() == ref_s.item()
    assert _ties_moved(qa.permute(0, 2, 3, 1).numpy(), ref_qa,
                       ref_ratio) == 0
    acc = tq.int8_conv2d(torch.from_numpy(ref_qa).permute(0, 3, 1, 2),
                         layer.weight_q, s, p, d)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), ref_acc)
    with torch.no_grad():
        y = layer(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(y, ref_y, rtol=1e-6,
                               atol=1e-6 * np.abs(ref_y).max())


def test_int8_dense():
    rng = np.random.RandomState(7)
    x = (rng.randn(5, 3, 64) * 2).astype(np.float32)
    w = (rng.randn(64, 40) * 0.1).astype(np.float32)              # (in, out)
    b = (rng.randn(40) * 0.1).astype(np.float32)
    jqk = jq.quantize_tensor(w)
    ref_y = np.asarray(jq._int8_dense(None, jnp.asarray(x), jqk,
                                      jnp.asarray(b)))
    ref_qa, _, ref_ratio = _ref_activation(x)
    ref_acc = np.asarray(lax.dot_general(
        jnp.asarray(ref_qa), jqk.q, (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    lin = torch.nn.Linear(64, 40)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    layer = tq.QLinear(lin, tq.quantize_tensor(lin.weight), "int8")
    xt = torch.from_numpy(x)
    qa, _ = tq.quantize_activation(xt)
    assert _ties_moved(qa.numpy(), ref_qa, ref_ratio) == 0
    acc = tq.int8_matmul(torch.from_numpy(ref_qa).reshape(-1, 64),
                         layer.weight_q)
    np.testing.assert_array_equal(acc.reshape(5, 3, 40).numpy(), ref_acc)
    with torch.no_grad():
        y = layer(xt).numpy()
    np.testing.assert_allclose(y, ref_y, rtol=1e-6,
                               atol=1e-6 * np.abs(ref_y).max())
    # weight-only mode is the dequantized fp product
    dq = tq.QLinear(lin, tq.quantize_tensor(lin.weight), "dequant")
    with torch.no_grad():
        torch.testing.assert_close(
            dq(xt), xt @ dq.weight().t() + lin.bias, rtol=1e-6, atol=1e-6)


def _x(seed=0):
    return (np.random.RandomState(seed).rand(1, 300, 300, 3) * 255.0
            - 120.0).astype(np.float32)


def _assert_outputs(got, ref, tol):
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * np.abs(r).max())


def test_ssd300_weight_only_forward(bridged):
    """The whole SSD300 forward at batch 1, weight-only: both packages'
    ``make_quantized_forward`` on their own quantized params (bit-equal,
    above)."""
    jmod, _, jqv, tmod, tqp = bridged
    x = _x()
    ref = jq.make_quantized_forward(jmod)(jqv, jnp.asarray(x))
    got = tq.make_quantized_forward(tmod)(tqp, torch.from_numpy(x))
    assert got[0].shape == (1, 8732, 4) and got[1].shape == (1, 8732, 21)
    _assert_outputs(got, ref, DEQUANT_TOL)


def test_ssd300_int8_forward(bridged):
    """The whole SSD300 forward at batch 1, int8 x int8: equal to the
    reference's int8 arithmetic run eagerly, within ``INT8_JIT_TOL`` of
    its jitted ``make_quantized_forward``."""
    jmod, _, jqv, tmod, tqp = bridged
    x = _x()
    got = tq.make_quantized_forward(tmod, compute="int8")(
        tqp, torch.from_numpy(x))
    eager = jq.int8_apply(jmod.apply, jqv, jnp.asarray(x))
    _assert_outputs(got, eager, 0.0)
    jitted = jq.make_quantized_forward(jmod, compute="int8")(
        jqv, jnp.asarray(x))
    _assert_outputs(got, jitted, INT8_JIT_TOL)


def test_reference_artifact_gives_the_same_forward(bridged, tmp_path):
    """The reference's ``save_quantized_npz`` file, read by the port
    without JAX and bridged onto the port's names, gives the forward of
    the port's own quantization; the byte counts agree."""
    _, _, jqv, tmod, tqp = bridged
    path = jq.save_quantized_npz(str(tmp_path / "ssd_int8"), jqv)
    loaded = tq.load_quantized_npz(path)
    assert isinstance(loaded["params"]["vgg"]["conv1_2"]["kernel"],
                      tq.QTensor)
    qparams = quantized_params_from_jax(loaded, tmod)
    assert set(qparams) == set(tqp)
    for k, v in tqp.items():
        if isinstance(v, tq.QTensor):
            assert torch.equal(qparams[k].q, v.q)
            assert torch.equal(qparams[k].scale, v.scale)
        else:
            assert torch.equal(qparams[k], v)
    # the in-memory reference QTensors bridge the same way
    in_memory = quantized_params_from_jax(jqv, tmod)
    assert all(torch.equal(in_memory[k].q, v.q) for k, v in tqp.items()
               if isinstance(v, tq.QTensor))
    x = torch.from_numpy(_x(1))
    with torch.no_grad():
        want = tq.quantize_model(tmod, compute="int8")(x)
        got = tq.quantize_model(tmod, compute="int8", qparams=qparams)(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tq.quantized_nbytes(tqp) == jq.quantized_nbytes(jqv)
    assert tq.quantized_nbytes(qparams) == tq.quantized_nbytes(loaded)
    qb, fb = tq.quantized_nbytes(tqp)
    assert qb < 0.26 * fb
    # the port's own artifact round-trips as a flat params dict
    own = tq.load_quantized_npz(tq.save_quantized_npz(
        str(tmp_path / "own"), tqp))
    assert set(own) == set(tqp)
    assert torch.equal(own["vgg.fc6.weight"].q, tqp["vgg.fc6.weight"].q)


def test_bridge_refuses_a_wrong_artifact(bridged):
    _, _, jqv, tmod, _ = bridged
    flat = dict(jqv["params"])
    flat.pop("loc_0")
    with pytest.raises(KeyError, match="loc_0"):
        quantized_params_from_jax({"params": flat}, tmod)


def test_dequantize_params_loads_into_the_fp_model(bridged):
    _, _, _, tmod, tqp = bridged
    fp = ssd.SSDVgg(21, 300, device="cpu", seed=3)
    fp.load_state_dict(tq.dequantize_params(tqp))
    qt = tqp["vgg.fc6.weight"]
    assert torch.equal(fp.vgg.fc6.weight,
                       qt.q.float() * qt.scale[:, None, None, None])
    assert tq.dequantize_params(tqp, torch.bfloat16)[
        "vgg.fc6.weight"].dtype == torch.bfloat16


def test_predictor_quantize_modes(bridged):
    """``SSDPredictor(quantize=...)`` serves a quantized copy and keeps
    no reference to the fp model; the weight-only predictor's forward is
    the fp forward on the dequantized weights."""
    _, _, _, tmod, tqp = bridged
    param = PreProcessParam(batch_size=1, resolution=300)
    with pytest.raises(ValueError, match="quantize"):
        SSDPredictor(tmod, param, quantize="int4", device="cpu")
    weight = SSDPredictor(tmod, param, quantize=True, device="cpu")
    int8 = SSDPredictor(tmod, param, quantize="int8", device="cpu")
    assert weight.model is not tmod and int8.model is not tmod
    assert isinstance(weight.model.vgg.fc6, tq.QConv2d)
    assert weight.model.vgg.fc6.compute == "dequant"
    assert int8.model.vgg.fc6.compute == "int8"
    fp = ssd.SSDVgg(21, 300, device="cpu", seed=3)
    fp.load_state_dict(tq.dequantize_params(tqp))
    x = torch.from_numpy(_x(2))
    with torch.no_grad():
        got = weight._eval_step(x)
        want = fp(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
