"""Parity of the port's vision transforms with the JAX package, on the CPU:
``RoiLabel`` and the projections, the SSD batch samplers, every host
augmentation op, ``DeviceAugPrepare``'s staging and ``DeviceAugBatch``'s
collate, and ``make_device_augment``.  Inputs are made by numpy from a
seed and given to both packages.

Random decisions: the reference draws from the process-global ``random``
(which its loader seeds per sample) and from ``RandomTransformer``'s own
generators; the port draws from ``data.transformer.sample_random()`` and
the same ``RandomTransformer`` generators.  Each test seeds the
reference's ``random`` and the port's stream with one value, and both
packages' ``seed_rngs``, so the decisions must be EQUAL, and the host
ops, which run the same numpy and cv2 code, give EQUAL outputs.

``make_device_augment`` on the CPU (fp32) against the reference's jitted
function on the same staged batch: the jitter and the HSV round trip run
the same fp32 ops, the resample sums in another order (``torch.bmm``
against ``einsum``); measured max-abs 4.3e-4 of a pixel level (levels
run to 255), held to 1e-3.
"""

import random

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.data import parallel as jax_parallel
from analytics_zoo_tpu.transform import vision as jv
from analytics_zoo_tpu.transform.vision import device as jax_device
from analytics_zoo_tpu_torch.data import parallel
from analytics_zoo_tpu_torch.data.transformer import sample_random
from analytics_zoo_tpu_torch.transform import vision as tv
from analytics_zoo_tpu_torch.transform.vision import augmentation, device

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)
AUG_TOL = 1e-3


def _seed(s):
    random.seed(s)
    sample_random().seed(s)


def _label(rng, n):
    wh = rng.rand(n, 2) * 0.5 + 0.05
    xy = rng.rand(n, 2) * (1 - wh)
    return (rng.randint(1, 21, n).astype(np.float32),
            np.concatenate([xy, xy + wh], 1).astype(np.float32),
            (rng.rand(n) < 0.2).astype(np.float32))


def _image(rng, h=67, w=91):
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 0)


def _features(pkg, img, label, float_mat=True):
    f = pkg.ImageFeature(b"", path="x.jpg")
    f.mat = img.astype(np.float32) if float_mat else img.copy()
    f["original_width"], f["original_height"] = img.shape[1], img.shape[0]
    f["label"] = pkg.RoiLabel(*label)
    return f


def _same_feature(a, b):
    assert a.is_valid == b.is_valid
    np.testing.assert_array_equal(a.mat, b.mat)
    for key in ("crop_bbox", "expand_bbox"):
        assert (key in a) == (key in b)
        if key in a:
            np.testing.assert_array_equal(a[key], b[key])
    for x, y in ((a.label.labels, b.label.labels),
                 (a.label.bboxes, b.label.bboxes),
                 (a.label.difficult, b.label.difficult)):
        np.testing.assert_array_equal(x, y)


# -- labels and geometry ----------------------------------------------------

def test_roi_label_and_projections_equal():
    rng = np.random.RandomState(0)
    labels, boxes, diff = _label(rng, 7)
    a, b = jv.RoiLabel(labels, boxes, diff), tv.RoiLabel(labels, boxes, diff)
    m = a.to_gt_matrix()
    np.testing.assert_array_equal(m, b.to_gt_matrix())
    np.testing.assert_array_equal(jv.RoiLabel.from_gt_matrix(m).bboxes,
                                  tv.RoiLabel.from_gt_matrix(m).bboxes)
    keep = np.array([1, 0, 1, 1, 0, 0, 1], bool)
    np.testing.assert_array_equal(a.select(keep).to_gt_matrix(),
                                  b.select(keep).to_gt_matrix())
    for _ in range(20):
        lo, hi = np.sort(rng.rand(2, 2) * 1.6 - 0.3, axis=0)
        src = np.concatenate([lo, hi]).astype(np.float32)
        pa, va = jv.project_bbox(src, boxes)
        pb, vb = tv.project_bbox(src, boxes)
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(
            jv.meet_emit_center_constraint(src, boxes),
            tv.meet_emit_center_constraint(src, boxes))
        np.testing.assert_array_equal(jv.jaccard_overlap(src, boxes),
                                      tv.jaccard_overlap(src, boxes))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batch_samples_and_random_sampler_equal(seed):
    rng = np.random.RandomState(seed)
    label = _label(rng, 1 + seed)
    _seed(100 + seed)
    want = jv.generate_batch_samples(jv.RoiLabel(*label))
    got = tv.generate_batch_samples(tv.RoiLabel(*label))
    assert len(want) == len(got) > 0
    np.testing.assert_array_equal(np.stack(want), np.stack(got))
    _seed(7)
    np.testing.assert_array_equal(jv.standard_samplers()[3].sample_boxes(5),
                                  tv.standard_samplers()[3].sample_boxes(5))
    img = _image(rng)
    _seed(200 + seed)
    a = jv.RandomSampler().transform(_features(jv, img, label))
    b = tv.RandomSampler().transform(_features(tv, img, label))
    _same_feature(a, b)


# -- host ops ---------------------------------------------------------------

def _cpu(pkg):
    """The port's ops whose route follows the device, asked for the CPU's
    (cv2, the reference's)."""
    return {"device": "cpu"} if pkg is tv else {}


def _ops(pkg):
    return {
        "brightness": lambda: pkg.Brightness(),
        "contrast": lambda: pkg.Contrast(),
        "saturation": lambda: pkg.Saturation(),
        "hue": lambda: pkg.Hue(),
        "channel_order": lambda: pkg.ChannelOrder(),
        "color_jitter": lambda: pkg.ColorJitter(random_order_prob=0.5),
        "color_jitter_shuffle": lambda: pkg.ColorJitter(shuffle=True),
        "resize_random": lambda: pkg.Resize(40, 30, interp=-1, **_cpu(pkg)),
        "resize_same": lambda: pkg.Resize(91, 67, interp=-1, **_cpu(pkg)),
        "aspect_scale": lambda: pkg.AspectScale(50, 8, 80, **_cpu(pkg)),
        "aspect_canvas": lambda: pkg.AspectScaleCanvas(64, **_cpu(pkg)),
        "random_aspect": lambda: pkg.RandomAspectScale([30, 40, 50],
                                                       **_cpu(pkg)),
        "hflip": lambda: pkg.HFlip(),
        "expand": lambda: pkg.Expand(),
        "crop": lambda: pkg.Crop(bbox=[0.1, 0.2, 0.7, 0.9]),
        "center_crop": lambda: pkg.CenterCrop(40, 30),
        "random_crop": lambda: pkg.RandomCrop(40, 30),
        "channel_normalize": lambda: pkg.ChannelNormalize((104, 117, 123),
                                                          (2, 3, 4)),
        "filler": lambda: pkg.Filler(0.1, 0.1, 0.5, 0.6),
        "expand_roi": lambda: (pkg.Expand() >> pkg.RoiExpand()),
        "crop_roi": lambda: (pkg.Crop(bbox=[0.2, 0.1, 0.8, 0.7])
                             >> pkg.RoiCrop()),
        "hflip_roi": lambda: (pkg.HFlip() >> pkg.RoiHFlip()),
        "normalize_roi": lambda: pkg.RoiNormalize(),
        "mat_to_floats": lambda: pkg.MatToFloats(mean=(104, 117, 123)),
    }


@pytest.mark.parametrize("name", sorted(_ops(jv)))
@pytest.mark.parametrize("seed", [0, 1])
def test_host_op_equal_to_reference(name, seed):
    rng = np.random.RandomState(seed)
    img, label = _image(rng), _label(rng, 3)
    a_op, b_op = _ops(jv)[name](), _ops(tv)[name]()
    jax_parallel.seed_rngs(a_op, 5 + seed)
    parallel.seed_rngs(b_op, 5 + seed)
    for rep in range(3):
        _seed(1000 * seed + rep)
        a = a_op.transform(_features(jv, img, label))
        b = b_op.transform(_features(tv, img, label))
        _same_feature(a, b)
        if name == "mat_to_floats":
            np.testing.assert_array_equal(a["floats"], b["floats"])


@pytest.mark.parametrize("shape,size", [
    ((67, 91), (300, 300)), ((480, 640), (300, 300)), ((300, 600), (300, 300)),
    ((600, 600), (300, 300)), ((37, 52), (30, 40))])
def test_resize_bilinear_close_to_cv2(shape, size):
    """The card's INTER_LINEAR route against ``cv2.resize``: uint8 within
    1 level (cv2 rounds fixed-point weights; measured max 1), float32
    within 1e-4 (measured max 4.6e-5 over these shapes)."""
    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    (h, w) = size
    got = augmentation.resize_bilinear(img, w, h)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    assert np.abs(got.astype(int) - cv2.resize(img, (w, h))).max() <= 1
    flt = img.astype(np.float32)
    got = augmentation.resize_bilinear(flt, w, h)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, cv2.resize(flt, (w, h)), rtol=0,
                               atol=1e-4)


def test_bytes_to_mat_and_invalid_record(tmp_path):
    rng = np.random.RandomState(3)
    img = _image(rng)
    data = bytes(cv2.imencode(".jpg", img)[1])
    for to_float in (True, False):
        a = jv.BytesToMat(to_float=to_float).transform(jv.ImageFeature(data))
        b = tv.BytesToMat(to_float=to_float, device="cpu").transform(
            tv.ImageFeature(data))
        np.testing.assert_array_equal(a.mat, b.mat)
        assert b.mat.dtype == a.mat.dtype
        assert (b["original_width"], b["original_height"]) == (91, 67)
    bad = tv.BytesToMat(device="cpu").transform(tv.ImageFeature(b"\xff\xd8"
                                                                b"junk"))
    assert not bad.is_valid and bad.mat is None


def test_feature_transformer_isolates_failures(caplog):
    f = tv.ImageFeature(b"", path="broken.jpg")
    f.mat = None
    out = tv.HFlip().transform(f)
    assert not out.is_valid
    assert "broken.jpg" in caplog.text
    assert tv.Brightness().transform(out) is out       # passed through


# -- device augmentation -------------------------------------------------------

def _prepared(pkg, seed, n, canvas=128, big=False):
    """n staged dicts from DeviceAugPrepare on seeded images, labels and
    decisions (one image larger than the canvas when ``big``)."""
    rng = np.random.RandomState(seed)
    param = pkg.DeviceAugParam(canvas_size=canvas, resolution=64)
    prep = pkg.DeviceAugPrepare(param)
    out = []
    for i in range(n):
        h, w = (150, 210) if big and i == 0 else (rng.randint(40, 120),
                                                  rng.randint(40, 120))
        img = _image(rng, h, w)
        label = _label(rng, 1 + i % 4)
        _seed(seed * 100 + i)
        out.append(prep.transform(_features(pkg, img, label,
                                            float_mat=False)))
    return out


def test_device_aug_prepare_and_batch_equal():
    a, b = _prepared(jv, 4, 6), _prepared(tv, 4, 6)
    for x, y in zip(a, b):
        for key in ("canvas", "rect", "size", "flip", "jitter", "im_info"):
            np.testing.assert_array_equal(x[key], y[key])
        np.testing.assert_array_equal(x["label"].to_gt_matrix(),
                                      y["label"].to_gt_matrix())
    ba = jv.DeviceAugBatch(3, max_gt=8).collate(a[:3])
    bb = tv.DeviceAugBatch(3, max_gt=8).collate(b[:3])
    for key in ba["aug"]:
        np.testing.assert_array_equal(ba["aug"][key], bb["aug"][key])
    for key in ba["target"]:
        np.testing.assert_array_equal(ba["target"][key], bb["target"][key])
        assert ba["target"][key].dtype == bb["target"][key].dtype
    np.testing.assert_array_equal(ba["im_info"], bb["im_info"])
    batches = list(tv.DeviceAugBatch(4, drop_remainder=False).apply_iter(
        iter(b + [None])))
    assert [x["aug"]["canvas"].shape[0] for x in batches] == [4, 2]


def test_device_aug_prepare_downscales_without_cv2():
    """An image larger than the canvas shrinks by the numpy bilinear
    resample: within 1 level of cv2.resize (cv2 rounds its fixed-point
    weights; measured max 1)."""
    x, y = _prepared(jv, 8, 2, big=True), _prepared(tv, 8, 2, big=True)
    assert x[0]["size"].tolist() == y[0]["size"].tolist() == [91, 128]
    diff = np.abs(x[0]["canvas"].astype(int) - y[0]["canvas"])
    assert diff.max() <= 1
    for key in ("rect", "flip", "jitter"):
        np.testing.assert_array_equal(x[0][key], y[0][key])


def test_make_device_augment_matches_reference():
    staged = _prepared(tv, 11, 8)
    batch = tv.DeviceAugBatch(8).collate(staged)
    param = tv.DeviceAugParam(canvas_size=128, resolution=64)
    want = np.asarray(jax_device.make_device_augment(
        jv.DeviceAugParam(canvas_size=128, resolution=64))(batch)["input"])
    out = device.make_device_augment(param, device="cpu")(batch)
    got = out["input"]
    assert got.shape == (8, 64, 64, 3) and got.dtype == torch.float32
    # NHWC-contiguous: the model's convolutions take it without a copy
    assert got.is_contiguous()
    err = np.abs(got.numpy() - want).max()
    assert err <= AUG_TOL, err
    assert "aug" not in out and set(out) == {"input", "im_info", "target"}
    # staged tensors on the CPU stay there; bf16 casts the result
    tens = {**batch, "aug": {k: torch.from_numpy(v)
                             for k, v in batch["aug"].items()}}
    half = device.make_device_augment(param, compute_dtype="bf16",
                                      device="cpu")(tens)["input"]
    assert half.dtype == torch.bfloat16 and half.device.type == "cpu"


def test_wire_and_pack_refused():
    for kw in (dict(wire_format="yuv420"), dict(pack=True)):
        with pytest.raises(NotImplementedError, match="item e"):
            tv.DeviceAugParam(**kw)
    with pytest.raises(NotImplementedError, match="item e"):
        tv.DeviceAugBatch(4, pack=True)
    with pytest.raises(ValueError, match="unknown wire_format"):
        tv.DeviceAugParam(wire_format="rgb")
