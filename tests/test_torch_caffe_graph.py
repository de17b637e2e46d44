"""``utils.caffe.build_caffe_graph`` of the port against the JAX package's,
on the CPU: the reference tests' ``TINY_NET``, ``MINI_SSD`` and
``MINI_FRCNN`` prototxts (``tests/test_caffe.py``), the modern ``Input``
layer, pooling with ``_h``/``_w`` params, Data/label/Accuracy graphs, an
unknown layer, a net that reaches every other converter, and the SSD300
deploy net (``tests/test_caffe_ssd300.py``, and ``chip_smoke.py``'s copy
of it): its 8732 priors, and its detections equal to ``SSDVgg``'s on one
caffemodel.  A Faster-RCNN VGG16 deploy net (``chip_smoke.py``'s: the
Python proposal, ROIPooling) is held to ``FasterRcnnVgg`` on one
caffemodel.

Each small graph runs in both packages on the reference graph's flax
parameters, bridged by ``utils.convert.caffe_graph_params_from_jax``.
Tolerances: tensors within ``TOL`` relative to their largest magnitude
(the two convolution libraries sum in another order; measured ~1e-6);
detections by K2's tolerances: classes equal, scores within 1e-6, boxes
within 1e-5; proposals kept equal.  The two port assemblies of SSD300
run the same convolutions and are held EQUAL.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_dist_scenarios as sc
from analytics_zoo_tpu.utils import caffe as jax_caffe
from analytics_zoo_tpu_torch.models import faster_rcnn
from analytics_zoo_tpu_torch.models.ssd import (SSDVgg, build_priors,
                                                ssd300_config)
from analytics_zoo_tpu_torch.ops.detection_output import (
    DetectionOutputParam, detection_output)
from analytics_zoo_tpu_torch.utils import caffe
from analytics_zoo_tpu_torch.utils.convert import caffe_graph_params_from_jax

torch.set_num_threads(2)
TOL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))


def _reference_test_module(name):
    """A reference test module, for its prototxt fixtures."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_test_module("test_caffe")
REF300 = _reference_test_module("test_caffe_ssd300")

ALL_LAYERS = """
name: "AllLayers"
input: "data"
input_shape { dim: 2 dim: 4 dim: 9 dim: 9 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 6 kernel_size: 3 pad: 1 } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1"
        batch_norm_param { eps: 0.001 } }
layer { name: "sc1" type: "Scale" bottom: "conv1" top: "conv1"
        scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1"
        relu_param { negative_slope: 0.1 } }
layer { name: "lrn1" type: "LRN" bottom: "conv1" top: "lrn1"
        lrn_param { local_size: 3 alpha: 0.5 beta: 0.75 } }
layer { name: "split1" type: "Split" bottom: "lrn1" top: "a" top: "b" }
layer { name: "sig" type: "Sigmoid" bottom: "a" top: "sig" }
layer { name: "tanh" type: "TanH" bottom: "b" top: "tanh" }
layer { name: "sum" type: "Eltwise" bottom: "sig" bottom: "tanh" top: "sum"
        eltwise_param { operation: SUM coeff: 0.5 coeff: 2.0 } }
layer { name: "prod" type: "Eltwise" bottom: "sig" bottom: "tanh"
        top: "prod" eltwise_param { operation: PROD } }
layer { name: "max" type: "Eltwise" bottom: "sum" bottom: "prod" top: "max"
        eltwise_param { operation: MAX } }
layer { name: "abs" type: "AbsVal" bottom: "max" top: "abs" }
layer { name: "pow" type: "Power" bottom: "abs" top: "pow"
        power_param { power: 2 scale: 0.5 shift: 1.0 } }
layer { name: "log" type: "Log" bottom: "pow" top: "log" }
layer { name: "exp" type: "Exp" bottom: "log" top: "exp" }
layer { name: "bnll" type: "BNLL" bottom: "exp" top: "bnll" }
layer { name: "pool1" type: "Pooling" bottom: "bnll" top: "pool1"
        pooling_param { pool: AVE kernel_size: 3 stride: 2 } }
layer { name: "gpool" type: "Pooling" bottom: "bnll" top: "gpool"
        pooling_param { pool: MAX global_pooling: true } }
layer { name: "slice1" type: "Slice" bottom: "pool1" top: "s1" top: "s2"
        slice_param { axis: 1 slice_point: 2 } }
layer { name: "cat1" type: "Concat" bottom: "s2" bottom: "s1" top: "cat1"
        concat_param { axis: 1 } }
layer { name: "perm1" type: "Permute" bottom: "cat1" top: "perm1"
        permute_param { order: 0 order: 3 order: 1 order: 2 } }
layer { name: "resh1" type: "Reshape" bottom: "perm1" top: "resh1"
        reshape_param { shape { dim: 0 dim: -1 } } }
layer { name: "drop1" type: "Dropout" bottom: "resh1" top: "resh1"
        dropout_param { dropout_ratio: 0.3 } }
layer { name: "fc1" type: "InnerProduct" bottom: "resh1" top: "fc1"
        inner_product_param { num_output: 5 } }
layer { name: "flat_g" type: "Flatten" bottom: "gpool" top: "flat_g" }
layer { name: "cat2" type: "Concat" bottom: "fc1" bottom: "flat_g"
        top: "cat2" concat_param { axis: 1 } }
layer { name: "prob" type: "Softmax" bottom: "cat2" top: "prob" }
layer { name: "conv_out" type: "Convolution" bottom: "bnll" top: "conv_out"
        convolution_param { num_output: 3 kernel_h: 3 kernel_w: 1 pad_h: 1
                            pad_w: 0 stride_h: 2 stride_w: 1 } }
"""


def _fill(params, seed=0):
    """The reference graph's params with numpy-seeded values (positive
    BatchNorm variances)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        if key.endswith("moving_var"):
            v = rng.rand(*leaf.shape) + 0.5
        elif key.endswith("kernel"):
            v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            v = rng.randn(*leaf.shape) * 0.1 + (1.0 if key.endswith(
                ("scale", "cmul/weight")) else 0.0)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, params)


def _both(text, x, seed=0):
    """(reference output, port output, reference params, port graph) on
    the same seeded params."""
    netdef = jax_caffe.parse_prototxt(text)
    jg = jax_caffe.build_caffe_graph(netdef)
    params = _fill(jg.init(jax.random.PRNGKey(0), jnp.asarray(x)).get(
        "params", {}),
                   seed)
    want = jg.apply({"params": params}, jnp.asarray(x))
    g = caffe.build_caffe_graph(caffe.parse_prototxt(text),
                                input_shape=x.shape, device="cpu")
    g.load_state_dict(caffe_graph_params_from_jax(params, g))
    with torch.no_grad():
        got = g(torch.from_numpy(x))
    return want, got, params, g


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _dets_equal(got, want):
    """K2's tolerances: classes equal, scores within 1e-6, boxes 1e-5."""
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                               atol=1e-5)


def _nhwc(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_tiny_net_matches_reference_and_loads_a_caffemodel(tmp_path):
    rng = np.random.default_rng(4)
    x = _nhwc(rng, 2, 8, 8, 3)
    want, got, _, g = _both(REF.TINY_NET, x)
    _close(got, want)
    assert set(g.state_dict()) == {"conv1.weight", "conv1.bias",
                                   "fc1.weight", "fc1.bias"}
    # a caffemodel restores into both graphs by layer name (fc1's rows
    # read Caffe's CHW flatten, as the graph flattens its NCHW map)
    w1, b1 = _nhwc(rng, 4, 3, 3, 3), _nhwc(rng, 4)
    w2, b2 = _nhwc(rng, 5, 64), _nhwc(rng, 5)
    path = str(tmp_path / "tiny.caffemodel")
    caffe.save_caffemodel(path, caffe.CaffeNet(name="TinyNet", layers=[
        caffe.CaffeLayer("conv1", "Convolution", ["data"], ["conv1"],
                         [w1, b1]),
        caffe.CaffeLayer("fc1", "InnerProduct", ["pool1"], ["fc1"],
                         [w2, b2])]))
    new, report = caffe.load_caffe_weights(g, path)
    assert not report["missing"] and not report["unused"]
    g.load_state_dict(new)
    jg = jax_caffe.build_caffe_graph(jax_caffe.parse_prototxt(REF.TINY_NET))
    jparams, _ = jax_caffe.load_caffe_weights(
        jg.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], path)
    with torch.no_grad():
        _close(g(torch.from_numpy(x)),
               jg.apply({"params": jparams}, jnp.asarray(x)))


def test_every_converter_matches_reference():
    """BatchNorm, Scale, leaky ReLU, LRN, Split, the unary layers, the
    three Eltwise ops, Power, average and global pooling, Slice, Concat,
    a general Permute, Reshape, Dropout, InnerProduct after a permuted
    map, Flatten, Softmax; two outputs, one a feature map (NHWC out)."""
    x = _nhwc(np.random.default_rng(1), 2, 9, 9, 4)
    want, got, _, _ = _both(ALL_LAYERS, x)
    assert isinstance(got, tuple) and len(got) == len(want) == 2
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    assert got[1].shape == (2, 5, 9, 3)          # conv_out, NHWC


def test_mini_ssd_detections_match_reference():
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(
        np.float32) * 50
    want, got, _, g = _both(REF.MINI_SSD, x)
    assert got.shape == (2, 20, 6)
    assert (got[..., 0] >= 0).sum() >= 20
    _dets_equal(got, want)
    assert "norm1.scale" in g.state_dict()


def test_mini_frcnn_matches_reference():
    """The Python proposal layer and ROIPooling: the (300, 10) class
    probabilities, and the proposals (mask equal)."""
    x = np.random.default_rng(9).standard_normal((1, 64, 64, 3)).astype(
        np.float32) * 30
    want, got, params, g = _both(REF.MINI_FRCNN, x)
    assert got.shape == (300, 10)
    _close(got, want)
    # the proposals, through a graph that returns them
    text = REF.MINI_FRCNN.replace(
        'layer { name: "roi_pool"', 'layer { name: "rois_out" type: '
        '"Python" bottom: "rpn_cls_prob" bottom: "rpn_bbox_pred" '
        'bottom: "im_info" top: "rois_copy" python_param { module: '
        '"rpn.proposal_layer" layer: "ProposalLayer" } }\n'
        'layer { name: "roi_pool"')
    want2, got2, _, _ = _both(text, x)
    (jrois, jmask), (trois, tmask) = want2[0], got2[0]
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(trois.numpy(), np.asarray(jrois), rtol=0,
                               atol=1e-3)


def test_modern_input_layers_and_pooling_hw_params():
    modern = ('layer { name: "data" type: "Input" top: "data" }\n'
              'layer { name: "im_info" type: "Input" top: "im_info" }\n'
              + "\n".join(l for l in REF.MINI_FRCNN.splitlines()
                          if not l.startswith(("input:", "name:"))))
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(
        np.float32) * 30
    want, got, _, _ = _both(modern, x)
    assert got.shape == (300, 10)
    _close(got, want)
    text = ('input: "data" input_shape { dim: 1 dim: 3 dim: 6 dim: 6 }\n'
            'layer { name: "p" type: "Pooling" bottom: "data" top: "p" '
            'pooling_param { pool: MAX kernel_h: 3 kernel_w: 3 stride_h: 1 '
            'stride_w: 1 pad_h: 1 pad_w: 1 } }')
    x = np.random.default_rng(3).standard_normal((1, 6, 6, 3)).astype(
        np.float32)
    want, got, _, _ = _both(text, x)
    assert got.shape == (1, 6, 6, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_data_label_accuracy_graph_and_unknown_layer():
    """Data tops that never materialize and a pruned Accuracy consumer:
    the conv is the output; an unknown type raises, naming it.  With no
    declared input shape the graph's layers appear on its first call."""
    text = ('layer { name: "d" type: "Data" top: "data" top: "label" '
            'include { phase: TEST } }\n'
            'layer { name: "c" type: "Convolution" bottom: "data" top: "c" '
            'convolution_param { num_output: 2 kernel_size: 1 } }\n'
            'layer { name: "acc" type: "Accuracy" bottom: "c" '
            'bottom: "label" top: "acc" }\n'
            'layer { name: "t" type: "Dropout" bottom: "c" top: "t" '
            'include { phase: TRAIN } }')
    g = caffe.build_caffe_graph(caffe.parse_prototxt(text), device="cpu")
    assert not g.state_dict()
    x = np.random.default_rng(6).standard_normal((1, 4, 4, 3)).astype(
        np.float32)
    want, got, _, _ = _both(text, x)
    assert got.shape == (1, 4, 4, 2)
    _close(got, want)
    bad = caffe.parse_prototxt(
        'input: "data" input_shape { dim: 1 dim: 3 dim: 4 dim: 4 }\n'
        'layer { name: "x" type: "FancyOp" bottom: "data" top: "x" }')
    with pytest.raises(NotImplementedError, match="FancyOp"):
        caffe.build_caffe_graph(bad, device="cpu")


def test_every_converter_type_is_reached():
    texts = [REF.TINY_NET, REF.MINI_SSD, REF.MINI_FRCNN, ALL_LAYERS]
    seen = {str(l["type"]) for t in texts
            for l in caffe.net_layers(caffe.parse_prototxt(t))}
    assert set(caffe._CONVERTERS) <= seen
    assert set(caffe._CONVERTERS) == set(jax_caffe._CONVERTERS)


def test_chip_smokes_ssd300_deploy_net_is_the_reference_fixtures():
    """``chip_smoke.py`` carries its own copy of the SSD300 deploy net (it
    imports no test file): layer for layer the reference fixture's."""
    mine = caffe.net_layers(caffe.parse_prototxt(
        chip_smoke.ssd300_deploy_prototxt()))
    ref = caffe.net_layers(caffe.parse_prototxt(
        REF300.ssd300_deploy_prototxt()))
    assert len(mine) == len(ref) > 100
    for a, b in zip(mine, ref):
        assert a == b, (a, b)


def test_ssd300_deploy_graph_priors_and_detections_equal_ssdvgg(tmp_path):
    """The full SSD300 deploy net: 8732 priors equal to ``SSDVgg``'s, and
    one seeded caffemodel through ``load_caffe_weights`` (the graph) and
    ``load_ssd_vgg_caffe`` (``SSDVgg``) gives the same detections."""
    seen = {}

    def capture(graph, spec, ins, louts, ctx):
        seen["priors"] = ins[2]
        return caffe._detection_output(graph, spec, ins, louts, ctx)

    netdef = caffe.parse_prototxt(REF300.ssd300_deploy_prototxt())
    g = caffe.build_caffe_graph(netdef, {"DetectionOutput": capture},
                                device="cpu")
    priors, variances = build_priors(ssd300_config())
    assert seen["priors"][0].shape == (8732, 4)
    np.testing.assert_array_equal(seen["priors"][0].numpy(), priors)
    np.testing.assert_array_equal(seen["priors"][1].numpy(), variances)

    path = str(tmp_path / "ssd300.caffemodel")
    caffe.save_caffemodel(path, chip_smoke.seeded_caffe_net(
        g, np.random.RandomState(0)))
    new, report = caffe.load_caffe_weights(g, path)
    assert not report["missing"] and not report["unused"]
    g.load_state_dict(new)
    model = SSDVgg(21, 300, device="cpu")
    new, report = caffe.load_ssd_vgg_caffe(model, path)
    assert not report["missing"] and not report["unused"]
    model.load_state_dict(new)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 300, 300, 3)).astype(np.float32) * 60)
    with torch.no_grad():
        got = g(x)
        loc, conf = model(x)
    want = detection_output(loc, torch.softmax(conf, -1),
                            torch.from_numpy(priors),
                            torch.from_numpy(variances),
                            DetectionOutputParam(n_classes=21))
    assert (got[..., 0] >= 0).sum() == 200
    torch.testing.assert_close(got, want, rtol=0, atol=0)


FRCNN_POOLED = 3


def test_frcnn_vgg16_deploy_graph_matches_faster_rcnn_vgg(tmp_path):
    """One seeded caffemodel through ``load_caffe_weights`` (the deploy
    graph, two images) and ``load_frcnn_vgg_caffe`` (``FasterRcnnVgg``,
    fc6 permuted to its HWC flatten): the proposals kept equal, the ROIs
    within 1e-3 px, the class probabilities and box deltas within
    ``TOL`` (fc6 sums the pooled map in two orders)."""
    classes = 5
    netdef = caffe.parse_prototxt(chip_smoke.frcnn_vgg16_deploy_prototxt(
        128, FRCNN_POOLED, classes))
    g = caffe.build_caffe_graph(netdef, device="cpu")
    path = str(tmp_path / "frcnn.caffemodel")
    caffe.save_caffemodel(path, chip_smoke.seeded_caffe_net(
        g, np.random.RandomState(2)))
    new, report = caffe.load_caffe_weights(g, path)
    assert not report["missing"] and not report["unused"]
    g.load_state_dict(new)
    assert "rpn_conv/3x3.weight" in new

    model = sc.unfilled(faster_rcnn.FasterRcnnVgg, faster_rcnn.FrcnnParam(
        num_classes=classes, pooled=FRCNN_POOLED))
    new, report = caffe.load_frcnn_vgg_caffe(model, path,
                                             pooled=FRCNN_POOLED)
    assert not report["missing"] and not report["unused"]
    model.load_state_dict(new)

    seen = {}

    def capture(graph, spec, ins, louts, ctx):
        out = caffe._python_proposal(graph, spec, ins, louts, ctx)
        seen["rois"] = out[0]
        return out

    g.registry["Python"] = capture
    x = np.random.default_rng(3).standard_normal(
        (2, 128, 128, 3)).astype(np.float32) * 60
    with torch.no_grad():
        bbox, prob = g(torch.from_numpy(x))
        info = np.tile(np.float32([[128, 128, 1.0]]), (2, 1))
        rois, mask, probs, deltas = model(torch.from_numpy(x), info)
    rois5, gmask = seen["rois"]
    np.testing.assert_array_equal(gmask.numpy(), mask.reshape(-1).numpy())
    np.testing.assert_array_equal(rois5[:, 0].numpy(),
                                  np.repeat([0.0, 1.0], 300))
    np.testing.assert_allclose(rois5[:, 1:].numpy(),
                               rois.reshape(-1, 4).numpy(), rtol=0,
                               atol=1e-3)
    _close(prob, probs.reshape(-1, classes).numpy())
    _close(bbox, deltas.reshape(-1, 4 * classes).numpy())
