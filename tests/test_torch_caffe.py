"""The port's Caffe weight importer and wire-format codec against the
JAX package's, on the CPU: the codec's bytes and fields, V1 and V2
caffemodel round trips read by both packages, prototxt parsing,
``caffe_weight_dict``'s per-type conventions, the by-name copy into the
port's SSD and Faster-RCNN models, and the fc6 CHW/HWC cross-check: one
caffemodel loaded by the reference's ``load_frcnn_vgg_caffe`` and by the
port's gives detectors whose detections agree.

Caffemodel files are written by ``save_caffemodel`` from seeded numpy
weights; nothing is downloaded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_scenarios as sc
from analytics_zoo_tpu.models import faster_rcnn as jax_frcnn
from analytics_zoo_tpu.ops.proposal import ProposalParam as JaxProposalParam
from analytics_zoo_tpu.utils import caffe as jax_caffe
from analytics_zoo_tpu.utils import protowire as jax_pw
from analytics_zoo_tpu_torch.models import faster_rcnn, ssd
from analytics_zoo_tpu_torch.ops.proposal import ProposalParam
from analytics_zoo_tpu_torch.utils import caffe, protowire as pw
from analytics_zoo_tpu_torch.utils.convert import load_weights_by_name

torch.set_num_threads(2)

SIZE, CLASSES, POOLED = 128, 4, 2


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- the wire format ---------------------------------------------------------


def _encode(mod):
    rng = np.random.default_rng(0)
    return (mod.Encoder().varint(1, 0).varint(3, 300).varint(4, 2 ** 35)
            .string(5, "conv1_1é").packed_floats(6, _rand(rng, 7))
            .packed_varints(7, [0, 1, 127, 128, 2 ** 21])
            .float32(8, -2.5).message(9, mod.Encoder().varint(1, 5))
            .bytes(10, b"\x00\xff").tobytes())


def test_codec_bytes_and_fields_equal_reference():
    """The port's encoder writes the reference's bytes; both decoders
    read them to the same fields, and the packed readers agree."""
    data = _encode(pw)
    assert data == _encode(jax_pw)
    got = [(f, w, v if isinstance(v, int) else bytes(v))
           for f, w, v in pw.iter_fields(data)]
    want = [(f, w, v if isinstance(v, int) else bytes(v))
            for f, w, v in jax_pw.iter_fields(data)]
    assert got == want and len(got) == 9
    fields = {f: v for f, _, v in pw.iter_fields(data)}
    np.testing.assert_array_equal(pw.packed_floats(fields[6]),
                                  jax_pw.packed_floats(fields[6]))
    assert pw.packed_varints(fields[7]) == [0, 1, 127, 128, 2 ** 21]
    assert pw.fixed32_float(fields[8]) == -2.5
    assert pw.as_string(fields[5]) == "conv1_1é"
    for v in (0, 1, 127, 128, 300, 2 ** 21, 2 ** 35, 2 ** 63):
        enc = pw.Encoder().varint(3, v).tobytes()
        assert list(pw.iter_fields(enc)) == [(3, pw.WIRETYPE_VARINT, v)]
        assert pw.read_varint(enc, 1) == jax_pw.read_varint(enc, 1)
    with pytest.raises(ValueError, match="varint"):
        pw.read_varint(b"\xff" * 11, 0)


# -- caffemodel round trips ----------------------------------------------------


def _toy_net(mod, rng):
    L = mod.CaffeLayer
    return mod.CaffeNet(name="toy", layers=[
        L("conv1", "Convolution", ["data"], ["conv1"],
          [_rand(rng, 4, 3, 3, 3), _rand(rng, 4)]),
        L("bn1", "BatchNorm", ["conv1"], ["conv1"],
          [_rand(rng, 4), np.abs(_rand(rng, 4)),
           np.asarray([2.0], np.float32)]),
        L("sc1", "Scale", ["conv1"], ["conv1"], [_rand(rng, 4),
                                                 _rand(rng, 4)]),
        L("relu1", "ReLU", ["conv1"], ["conv1"]),
        L("fc1", "InnerProduct", ["conv1"], ["fc1"],
          [_rand(rng, 5, 36), _rand(rng, 5)]),
    ])


@pytest.mark.parametrize("v1", [False, True])
def test_caffemodel_round_trip_read_by_both(tmp_path, v1):
    """A net written by the port (V2 ``layer`` or V1 ``layers``) is the
    reference's bytes; both packages read it back to the same layers."""
    rng = np.random.default_rng(1)
    net = _toy_net(caffe, rng)
    if v1:                                  # V1 has no BatchNorm/Scale enum
        net.layers = [l for l in net.layers if l.type not in ("BatchNorm",
                                                              "Scale")]
    path, ref_path = str(tmp_path / "a.caffemodel"), str(tmp_path / "b")
    caffe.save_caffemodel(path, net, v1=v1)
    jax_caffe.save_caffemodel(ref_path, jax_caffe.CaffeNet(
        net.name, [jax_caffe.CaffeLayer(l.name, l.type, l.bottoms, l.tops,
                                        l.blobs) for l in net.layers]),
        v1=v1)
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    back, ref = caffe.read_caffemodel(path), jax_caffe.read_caffemodel(path)
    assert back.name == ref.name == "toy"
    assert [(l.name, l.type, l.bottoms, l.tops) for l in back.layers] == [
        (l.name, l.type, l.bottoms, l.tops) for l in ref.layers] == [
        (l.name, l.type, l.bottoms, l.tops) for l in net.layers]
    for a, b, c in zip(back.layers, ref.layers, net.layers):
        assert len(a.blobs) == len(c.blobs)
        for x, y, z in zip(a.blobs, b.blobs, c.blobs):
            np.testing.assert_array_equal(x, z)
            np.testing.assert_array_equal(y, z)
    assert back.layer("fc1").blobs[0].shape == (5, 36)
    with pytest.raises(KeyError):
        back.layer("nope")
    if not v1:
        with pytest.raises(ValueError, match="V1"):
            caffe.save_caffemodel(str(tmp_path / "c"), net, v1=True)


def test_legacy_blobs_and_phase_equal_reference():
    """Un-packed float data, pre-BlobShape num/channels/height/width
    dims, double data and a layer's phase parse as the reference's."""
    blob = (pw.Encoder().varint(1, 1).varint(2, 2).varint(3, 3).varint(4, 4)
            .packed_floats(5, np.arange(24, dtype=np.float32)))
    loose = pw.Encoder().message(7, pw.Encoder().packed_varints(1, [3]))
    for v in (1.5, -2.0, 0.25):
        loose.float32(5, v)
    dbl = pw.Encoder().bytes(8, np.arange(3, dtype="<f8").tobytes())
    layer = (pw.Encoder().string(1, "l").string(2, "Convolution")
             .message(7, blob).message(7, loose).message(7, dbl)
             .varint(10, 1))
    data = pw.Encoder().message(100, layer).tobytes()
    got, want = (caffe.parse_net_parameter(data),
                 jax_caffe.parse_net_parameter(data))
    assert got.layers[0].phase == want.layers[0].phase == 1
    assert [b.shape for b in got.layers[0].blobs] == [(1, 2, 3, 4), (3,),
                                                      (3,)]
    for a, b in zip(got.layers[0].blobs, want.layers[0].blobs):
        np.testing.assert_array_equal(a, b)


PROTOTXT = """
name: "TestNet"  # a comment
input: "data"
input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 stride: 1 } }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "p" type: "PriorBox" bottom: "pool1" top: "p"
  prior_box_param { min_size: 30.0 min_size: 60.0 flip: true clip: false
    aspect_ratio: 2 aspect_ratio: 3 variance: 0.1 } include { phase: TEST }
  python_param { param_str: "'feat_stride': 16" } }
"""


def test_prototxt_equal_reference(tmp_path):
    got, want = caffe.parse_prototxt(PROTOTXT), jax_caffe.parse_prototxt(
        PROTOTXT)
    assert got == want
    assert got["layer"][2]["prior_box_param"]["min_size"] == [30.0, 60.0]
    assert [l["name"] for l in caffe.net_layers(got)] == ["conv1", "pool1",
                                                         "p"]
    path = tmp_path / "net.prototxt"
    path.write_text(PROTOTXT)
    assert caffe.parse_prototxt(str(path)) == want
    v1 = caffe.parse_prototxt('layers { name: "a" } layers { name: "b" }')
    assert [l["name"] for l in caffe.net_layers(v1)] == ["a", "b"]


def test_weight_dict_conventions_equal_reference():
    """Per-type blob conventions, the reference's: weight and bias of a
    convolution; legacy (1, 1, out, in) FC blobs canonicalized to (out,
    in); BatchNorm's mean and var divided by the scale factor (0 →
    zeros); Scale; Normalize's scale flattened; other blobs kept by
    index."""
    rng = np.random.default_rng(2)
    L = caffe.CaffeLayer
    net = caffe.CaffeNet(layers=[
        L("conv", "Convolution", blobs=[_rand(rng, 2, 3, 1, 1),
                                        _rand(rng, 1, 1, 1, 2)]),
        L("fc", "InnerProduct", blobs=[_rand(rng, 1, 1, 5, 8),
                                       _rand(rng, 1, 1, 1, 5)]),
        L("bn", "BatchNorm", blobs=[_rand(rng, 3), np.abs(_rand(rng, 3)),
                                    np.asarray([4.0], np.float32)]),
        L("bn0", "BatchNorm", blobs=[_rand(rng, 3), _rand(rng, 3),
                                     np.zeros(1, np.float32)]),
        L("sc", "Scale", blobs=[_rand(rng, 3)]),
        L("norm", "Normalize", blobs=[_rand(rng, 1, 3)]),
        L("odd", "Python", blobs=[_rand(rng, 2, 2), _rand(rng, 1)]),
        L("empty", "ReLU"),
    ])
    got = caffe.caffe_weight_dict(net)
    want = jax_caffe.caffe_weight_dict(jax_caffe.CaffeNet(layers=[
        jax_caffe.CaffeLayer(l.name, l.type, blobs=l.blobs)
        for l in net.layers]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["fc/weight"].shape == (5, 8) and got["fc/bias"].shape == (5,)
    np.testing.assert_allclose(got["bn/moving_mean"],
                               net.layers[2].blobs[0] / 4.0)
    assert (got["bn0/moving_var"] == 0).all()
    assert got["norm/scale"].shape == (3,) and "odd/blob_1" in got


def test_chw_dense_to_hwc_equal_reference():
    rng = np.random.RandomState(0)
    w = rng.randn(6, 3 * 2 * 4).astype(np.float32)           # (out, CHW)
    got = caffe.chw_dense_to_hwc(w, 2, 4, 3)
    np.testing.assert_array_equal(got, jax_caffe.chw_dense_to_hwc(w, 2, 4,
                                                                  3))
    np.testing.assert_array_equal(caffe.chw_dense_to_hwc(w.T, 2, 4, 3),
                                  jax_caffe.chw_dense_to_hwc(w.T, 2, 4, 3))
    x = rng.randn(2, 4, 3).astype(np.float32)                # an HWC map
    np.testing.assert_allclose(got @ x.ravel(),
                               w @ x.transpose(2, 0, 1).ravel(), rtol=1e-5)
    with pytest.raises(ValueError):
        caffe.chw_dense_to_hwc(w, 3, 3, 3)


# -- loading into the port's models -----------------------------------------


def test_load_ssd_vgg_caffe_into_the_port(tmp_path):
    """A Caffe-SSD300 caffemodel of a few layers loads into the port's
    ``SSDVgg`` by name: the renamed heads and the conv4_3 scale land,
    the report's keys are the reference's, unused names are reported
    and a shape that does not fit raises."""
    rng = np.random.default_rng(3)
    model = ssd.SSDVgg(21, 300, device="cpu")
    sd = model.state_dict()
    L = caffe.CaffeLayer
    blobs = {
        "conv1_1": [_rand(rng, 64, 3, 3, 3), _rand(rng, 64)],
        "fc7": [_rand(rng, 1024, 1024, 1, 1), _rand(rng, 1024)],
        "conv4_3_norm_mbox_conf": [_rand(rng, *sd["conf_0.weight"].shape),
                                   _rand(rng, *sd["conf_0.bias"].shape)],
        "conv9_2_mbox_loc": [_rand(rng, *sd["loc_5.weight"].shape),
                             _rand(rng, *sd["loc_5.bias"].shape)],
    }
    layers = [L(n, "Convolution", blobs=b) for n, b in blobs.items()]
    layers += [L("conv4_3_norm", "Normalize", blobs=[_rand(rng, 1, 512)]),
               L("extra_head", "Convolution", blobs=[_rand(rng, 2, 2, 1, 1)])]
    path = str(tmp_path / "ssd.caffemodel")
    caffe.save_caffemodel(path, caffe.CaffeNet(layers=layers))
    new, report = caffe.load_ssd_vgg_caffe(model, path)
    assert set(report) == {"loaded", "missing", "unused"}
    assert sorted(report["loaded"]) == sorted([
        "vgg.conv1_1.weight", "vgg.conv1_1.bias", "vgg.fc7.weight",
        "vgg.fc7.bias", "conf_0.weight", "conf_0.bias", "loc_5.weight",
        "loc_5.bias", "conv4_3_norm.cmul.weight"])
    assert report["unused"] == ["extra_head/weight"]
    assert len(report["missing"]) == len(sd) - 9
    np.testing.assert_array_equal(new["conf_0.weight"].numpy(),
                                  blobs["conv4_3_norm_mbox_conf"][0])
    np.testing.assert_array_equal(new["conv4_3_norm.cmul.weight"].numpy(),
                                  layers[4].blobs[0].ravel())
    model.load_state_dict(new)
    with pytest.raises(KeyError, match="no source"):
        caffe.load_ssd_vgg_caffe(sd, path, strict=True)
    bad = str(tmp_path / "bad.caffemodel")
    caffe.save_caffemodel(bad, caffe.CaffeNet(layers=[
        L("conv1_1", "Convolution", blobs=[_rand(rng, 64, 3, 5, 5)])]))
    with pytest.raises(ValueError, match="shape mismatch"):
        caffe.load_caffe_weights(model, bad)
    new, report = load_weights_by_name(
        sd, {"rpn_conv/3x3/weight": np.zeros((2,), np.float32)},
        rename=faster_rcnn.frcnn_vgg_rename())
    assert report["unused"] == ["rpn_conv_3x3/weight"] and not report["loaded"]


def _frcnn_caffe_net(rng, jparams):
    """A py-faster-rcnn VGG16 caffemodel (Caffe names and layouts: OIHW
    convolutions, (out, in) dense, fc6's rows over the CHW flatten) with
    seeded weights of the shapes of ``jparams``."""
    L = caffe.CaffeLayer
    layers = []
    for name, leaf in list(jparams["vgg"].items()) + [
            (n, jparams[n]) for n in ("rpn_conv_3x3", "rpn_cls_score",
                                      "rpn_bbox_pred", "fc6", "fc7",
                                      "cls_score", "bbox_pred")]:
        k = leaf["kernel"].shape
        if len(k) == 4:
            shape, t = (k[3], k[2], k[0], k[1]), "Convolution"
            fan_in = k[0] * k[1] * k[2]
        else:
            shape, t, fan_in = (k[1], k[0]), "InnerProduct", k[0]
        w = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        b = (rng.standard_normal(shape[0]) * 0.01).astype(np.float32)
        layers.append(L(name.replace("rpn_conv_3x3", "rpn_conv/3x3"), t,
                        blobs=[w, b]))
    return caffe.CaffeNet(name="VGG_ILSVRC_16_layers", layers=layers)


def test_frcnn_caffemodel_same_detections_through_both_loaders(tmp_path):
    """The fc6 CHW/HWC cross-check: one caffemodel written by
    ``save_caffemodel`` is loaded by the reference's
    ``load_frcnn_vgg_caffe`` (flax, HWC fc6) and by the port's; every
    entry is loaded and every blob used, and the two detectors give the
    same detections on the same two images (classes and order equal,
    scores within 1e-5, boxes within 1e-2 px: the two convolution
    libraries' summation order, as ``test_torch_frcnn.py`` states).  A
    copy of fc6 without the permutation gives other detections."""
    jparam = jax_frcnn.FrcnnParam(num_classes=CLASSES, pooled=POOLED,
                                  proposal=JaxProposalParam(pre_nms_topn=64,
                                                            post_nms_topn=16))
    jdet = jax_frcnn.FasterRcnnDetector(param=jparam)
    shapes = jax.eval_shape(jdet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)), jnp.ones((1, 3)))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    rng = np.random.default_rng(4)
    path = str(tmp_path / "frcnn.caffemodel")
    caffe.save_caffemodel(path, _frcnn_caffe_net(rng, zeros["frcnn"]))

    jnew, jreport = jax_caffe.load_frcnn_vgg_caffe(zeros, path,
                                                   pooled=POOLED)
    assert not jreport["missing"] and not jreport["unused"]
    tdet = sc.unfilled(faster_rcnn.FasterRcnnDetector, faster_rcnn.FrcnnParam(
        num_classes=CLASSES, pooled=POOLED,
        proposal=ProposalParam(pre_nms_topn=64, post_nms_topn=16)))
    new, report = caffe.load_frcnn_vgg_caffe(tdet, path, pooled=POOLED)
    assert not report["missing"] and not report["unused"]
    assert len(report["loaded"]) == len(tdet.state_dict()) == 40
    tdet.load_state_dict(new)

    x = (np.random.RandomState(5).rand(2, SIZE, SIZE, 3) * 255
         - 120).astype(np.float32)
    info = np.array([[SIZE, SIZE, 1.0], [100, SIZE, 1.0]], np.float32)
    want = np.asarray(jax.jit(lambda p, a, i: jdet.apply({"params": p}, a, i))(
        jnew, x, info))
    with torch.no_grad():
        got = tdet(torch.from_numpy(x), info).numpy()
    assert (got[..., 1] > 0).sum() >= 10
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                               atol=1e-2)

    raw, _ = caffe.load_caffe_weights(tdet, path,
                                      rename=faster_rcnn.frcnn_vgg_rename())
    tdet.load_state_dict(raw)
    with torch.no_grad():
        unpermuted = tdet(torch.from_numpy(x), info).numpy()
    assert not np.allclose(unpermuted[..., 1], want[..., 1], atol=1e-3)
