"""Parity of the PyTorch port's SSD geometry and network with the JAX
package, on the CPU: priors bit for bit, the weight bridge, the conv4_3
normalization, and the full-width SSD300 forward on bridged weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core.layers import NormalizeScale as JaxNormalizeScale
from analytics_zoo_tpu.models import ssd as jax_ssd
from analytics_zoo_tpu.ops import bbox as jax_bbox
from analytics_zoo_tpu_torch.core.layers import NormalizeScale
from analytics_zoo_tpu_torch.ops import bbox
from analytics_zoo_tpu_torch.models import ssd
from analytics_zoo_tpu_torch.utils.convert import (flatten_params,
                                                   ssd_params_from_jax)

torch.set_num_threads(2)

CONFIGS = [(300, "pascal"), (300, "coco"), (512, "pascal"), (512, "coco")]


@pytest.mark.parametrize("resolution,dataset", CONFIGS)
def test_priors_bit_equal(resolution, dataset):
    jcfg = (jax_ssd.ssd300_config if resolution == 300
            else jax_ssd.ssd512_config)(dataset)
    tcfg = (ssd.ssd300_config if resolution == 300
            else ssd.ssd512_config)(dataset)
    jp, jv = jax_ssd.build_priors(jcfg)
    tp, tv = ssd.build_priors(tcfg)
    assert tp.shape == (8732 if resolution == 300 else 24564, 4)
    assert tp.dtype == jp.dtype == np.float32
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tv, jv)
    assert ssd.num_priors_per_cell(tcfg) == jax_ssd.num_priors_per_cell(jcfg)


@pytest.mark.parametrize("normalized", [True, False])
def test_bbox_parity(normalized):
    """Box math on the same boxes, including empty and inverted ones.
    Same float ops in the same order, so the results are bit-equal here
    (atol 0); a platform whose ``exp`` rounds differently would break
    only the decode, by an ulp."""
    rng = np.random.RandomState(3)
    scale = 1.0 if normalized else 60.0
    xy = rng.rand(40, 2)
    a = np.concatenate([xy, xy + rng.rand(40, 2) * 0.4 - 0.05], 1) * scale
    b = np.concatenate([xy[::-1], xy[::-1] + rng.rand(40, 2) * 0.3], 1) * scale
    a, b = a.astype(np.float32), b.astype(np.float32)
    deltas = (rng.randn(40, 4) * 0.5).astype(np.float32)
    var = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (40, 1))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pairs = [
        (bbox.area(ta, normalized), jax_bbox.area(a, normalized)),
        (bbox.intersection(ta, tb, normalized),
         jax_bbox.intersection(a, b, normalized)),
        (bbox.iou_matrix(ta, tb, normalized),
         jax_bbox.iou_matrix(a, b, normalized)),
        (torch.stack(bbox.center_size(ta), -1),
         jnp.stack(jax_bbox.center_size(a), -1)),
        (bbox.clip_boxes(ta, 0.5 * scale, 0.7 * scale),
         jax_bbox.clip_boxes(a, 0.5 * scale, 0.7 * scale)),
    ]
    for clip in (False, True):
        pairs.append((bbox.decode_bbox(ta / scale, torch.from_numpy(var),
                                       torch.from_numpy(deltas), clip),
                      jax_bbox.decode_bbox(a / scale, var, deltas, clip)))
    for got, ref in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_normalize_scale_parity():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 16).astype(np.float32)         # NHWC
    x[0, 0, 0] = 0.0          # an all-zero pixel: eps is added, not clamped
    jmod = JaxNormalizeScale(channels=16, scale=20.0)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    w = rng.rand(16).astype(np.float32) * 30
    variables = {"params": {"cmul": {"weight": jnp.asarray(w)}}}
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod = NormalizeScale(16)
    tmod.cmul.weight.data = torch.from_numpy(w)
    got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    # one sqrt and one division over 16-term sums: f32 rounding only
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6)


def seeded_flax_params(jmod, resolution, seed=0):
    """The flax params tree of ``jmod`` with numpy-seeded values: LeCun-
    normal kernels, small random biases, the conv4_3 scale around 20.
    Shapes come from ``eval_shape`` (an eager flax init of the full VGG
    takes tens of seconds on the CPU)."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, resolution, resolution, 3)))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            v = rng.randn(*leaf.shape) / np.sqrt(fan_in)
        elif name == "bias":
            v = rng.randn(*leaf.shape) * 0.01
        else:                                        # the conv4_3 CMul
            v = 20.0 + rng.randn(*leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


@pytest.fixture(scope="module")
def ssd300_pair():
    """A flax SSD300 (21 classes) and the port's, on the same weights."""
    jmod = jax_ssd.SSDVgg(num_classes=21, resolution=300)
    variables = {"params": seeded_flax_params(jmod, 300)}
    tmod = ssd.SSDVgg(21, 300, device="cpu", seed=1)
    tmod.load_state_dict(ssd_params_from_jax(variables["params"], tmod))
    return jmod, variables, tmod


def test_bridge_uses_every_leaf_once(ssd300_pair):
    _, variables, tmod = ssd300_pair
    flat = flatten_params(variables["params"])
    bridged = ssd_params_from_jax(flat, tmod)     # flat input works too
    assert len(bridged) == len(flat) == len(tmod.state_dict())
    # HWIO → OIHW
    np.testing.assert_array_equal(
        bridged["vgg.conv1_1.weight"].numpy(),
        np.transpose(flat["vgg/conv1_1/kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(bridged["conv4_3_norm.cmul.weight"].numpy(),
                                  flat["conv4_3_norm/cmul/weight"])


def test_bridge_raises_on_missing_and_extra(ssd300_pair):
    _, variables, tmod = ssd300_pair
    flat = flatten_params(variables["params"])
    missing = {k: v for k, v in flat.items() if k != "loc_0/bias"}
    with pytest.raises(KeyError, match="loc_0.bias"):
        ssd_params_from_jax(missing, tmod)
    extra = dict(flat, **{"conv42/kernel": np.zeros((3, 3, 1, 1), np.float32)})
    with pytest.raises(KeyError, match="conv42"):
        ssd_params_from_jax(extra, tmod)
    wrong = dict(flat, **{"loc_0/bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="loc_0/bias"):
        ssd_params_from_jax(wrong, tmod)


def test_ssd300_forward_parity(ssd300_pair):
    """Full-width SSD300 at batch 1 on bridged weights.  Tolerance: both
    sides run fp32 convolutions on the CPU, summing in different orders
    over up to 9216 terms a layer through 23 layers; the worst absolute
    error measured is 3.6e-6 of the output's largest magnitude, pinned at
    2e-5 of it (no rtol: near-zero outputs carry the same absolute
    rounding)."""
    jmod, variables, tmod = ssd300_pair
    x = (np.random.RandomState(0).rand(1, 300, 300, 3) * 255.0
         - 120.0).astype(np.float32)
    jloc, jconf = (np.asarray(a) for a in jmod.apply(variables,
                                                      jnp.asarray(x)))
    with torch.no_grad():
        tloc, tconf = (a.numpy() for a in tmod(torch.from_numpy(x)))
    assert tloc.shape == (1, 8732, 4) and tconf.shape == (1, 8732, 21)
    for got, ref in ((tloc, jloc), (tconf, jconf)):
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * scale)


def test_ssd512_layout_on_cpu():
    """The 512 branch (conv10_2 k=4 pad 1) reaches P = 24564 priors."""
    tmod = ssd.SSDVgg(4, 512, device="cpu")
    with torch.no_grad():
        loc, conf = tmod(torch.zeros(1, 512, 512, 3))
    assert loc.shape == (1, 24564, 4) and conf.shape == (1, 24564, 4)


def test_ssd_detector_is_forward_softmax_detection_output(ssd300_pair):
    """``SSDDetector`` = SSDVgg → softmax → DetectionOutput over the
    model's priors (the plain path on the CPU)."""
    from analytics_zoo_tpu_torch.ops.detection_output import (
        DetectionOutputParam, detection_output)

    _, _, tmod = ssd300_pair
    post = DetectionOutputParam(nms_topk=50, keep_topk=20)
    det = ssd.SSDDetector(21, 300, post=post, device="cpu")
    det.ssd.load_state_dict(tmod.state_dict())
    x = torch.from_numpy(np.random.RandomState(5).rand(1, 300, 300, 3)
                         .astype(np.float32) * 100.0)
    with torch.no_grad():
        got = det(x)
        loc, conf = tmod(x)
    want = detection_output(loc, torch.softmax(conf, -1), det.priors,
                            det.variances, post)
    assert got.shape == (1, 20, 6) and det.priors.shape == (8732, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_model_needs_a_device_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ssd.build_ssd_vgg(21, 300)
