"""The port's Faster-RCNN serving slice against the JAX package, on the
CPU: anchors, the box transforms, the proposal layer, ROI pooling, the
per-class post-processing, ``FasterRcnnVgg`` / ``FasterRcnnDetector`` on
weights bridged by ``frcnn_params_from_jax``, ``FrcnnPredictor`` and
``frcnn_serving_tiers`` through both serving runtimes.

The network runs at the reference tests' small size (128 px, 4 classes,
``ProposalParam(pre_nms_topn=64, post_nms_topn=16)``) with VGG16's
widths.  Tolerances, each stated where it is used:

- anchors and ``roi_pool`` are bit-equal (host numpy; max is exact);
- the box transforms within 1e-6 relative (the same float ops);
- the proposal keeps the same indices and its ROIs lie within 1e-4 px
  (the decode's ``exp`` rounds differently on the two sides);
- the post-processing keeps classes and order, scores within 1e-6 and
  boxes within 1e-4 px;
- the network's outputs differ by the two convolution libraries'
  summation order: the RPN deltas by ~5e-6, which ``exp`` and anchors up
  to 512 px wide carry to ~2e-3 px on a ROI (``ROI_TOL_PX``), the class
  probabilities by ~1e-6 (``PROB_TOL``); detections keep classes and
  order, scores within ``PROB_TOL`` and boxes within ``BOX_TOL_PX``.
"""

import importlib
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_scenarios as sc
import analytics_zoo_tpu.serving as jserving
from analytics_zoo_tpu.data import records as jax_records
from analytics_zoo_tpu.models import faster_rcnn as jax_frcnn
from analytics_zoo_tpu.ops import bbox as jax_bbox
from analytics_zoo_tpu.pipelines import frcnn as jax_pipe
from analytics_zoo_tpu.pipelines.ssd import (
    PreProcessParam as JaxPreProcessParam)
import analytics_zoo_tpu_torch.serving as tserving
from analytics_zoo_tpu_torch.data import native, records, synthetic
from analytics_zoo_tpu_torch.models import faster_rcnn
from analytics_zoo_tpu_torch.ops import bbox
from analytics_zoo_tpu_torch.pipelines import frcnn as pipe
from analytics_zoo_tpu_torch.pipelines.ssd import PreProcessParam
from analytics_zoo_tpu_torch.utils.convert import frcnn_params_from_jax

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mods(pkg, name):
    """``pkg.ops.<name>`` as a module (the packages export functions
    under some of these names)."""
    return importlib.import_module(f"{pkg}.ops.{name}")


J = types.SimpleNamespace(**{n: _mods("analytics_zoo_tpu", n) for n in (
    "anchor", "proposal", "roi_pool", "frcnn")})
T = types.SimpleNamespace(**{n: _mods("analytics_zoo_tpu_torch", n) for n in (
    "anchor", "proposal", "roi_pool", "frcnn")})

SIZE, CLASSES = 128, 4
ROI_TOL_PX = 1e-2
PROB_TOL = 1e-5
DELTA_TOL = 1e-4
BOX_TOL_PX = 1e-2


def _params(mod, **proposal):
    return mod.FrcnnParam(num_classes=CLASSES, proposal=(
        _mods(mod.__name__.split(".")[0], "proposal").ProposalParam(
            pre_nms_topn=64, post_nms_topn=16, **proposal)))


# -- anchors and box transforms ---------------------------------------------


@pytest.mark.parametrize("base,ratios,scales,h,w", [
    (16, (0.5, 1.0, 2.0), (8, 16, 32), 8, 8),
    (16, (0.5, 1.0, 2.0), (8, 16, 32), 32, 32),
    (16, (0.5, 1.0, 2.0), (8, 16, 32), 38, 50),
    (8, (0.25, 1.0, 3.0, 4.0), (2, 5), 5, 7),
])
def test_anchors_bit_equal(base, ratios, scales, h, w):
    a = J.anchor.shift_anchors(J.anchor.generate_base_anchors(
        base, ratios, scales), h, w, base)
    b = T.anchor.shift_anchors(T.anchor.generate_base_anchors(
        base, ratios, scales), h, w, base)
    assert b.shape == (h * w * len(ratios) * len(scales), 4)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def _boxes(rng, n, size=200.0):
    x1, y1 = rng.rand(n) * (size - 20), rng.rand(n) * (size - 20)
    return np.stack([x1, y1, x1 + rng.rand(n) * 60 + 1,
                     y1 + rng.rand(n) * 60 + 1], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_bbox_transforms_equal_reference(seed):
    """``bbox_transform``, ``bbox_transform_inv`` and ``bbox_vote``
    within 1e-6 relative (and a round trip to the gt)."""
    rng = np.random.RandomState(seed)
    ex, gt = _boxes(rng, 50), _boxes(rng, 50)
    deltas = (rng.randn(3, 50, 4) * 0.3).astype(np.float32)
    t = bbox.bbox_transform(torch.from_numpy(ex), torch.from_numpy(gt))
    np.testing.assert_allclose(
        t.numpy(), np.asarray(jax_bbox.bbox_transform(ex, gt)), rtol=1e-6,
        atol=1e-6)
    back = bbox.bbox_transform_inv(torch.from_numpy(ex), t)
    np.testing.assert_allclose(back.numpy(), gt, rtol=0, atol=1e-3)
    # broadcast over a leading dim, as the proposal layer calls it
    inv = bbox.bbox_transform_inv(torch.from_numpy(ex),
                                  torch.from_numpy(deltas))
    for i in range(3):
        np.testing.assert_allclose(
            inv[i].numpy(),
            np.asarray(jax_bbox.bbox_transform_inv(ex, deltas[i])),
            rtol=1e-6, atol=1e-6)
    kept, cand = _boxes(rng, 12), np.concatenate([_boxes(rng, 40), ex[:8]])
    scores = rng.rand(48).astype(np.float32)
    mask = (rng.rand(48) > 0.2).astype(np.float32)
    want = np.asarray(jax_bbox.bbox_vote(kept, scores[:12], cand, scores,
                                         mask, 0.3))
    got = bbox.bbox_vote(*(torch.from_numpy(a) for a in (
        kept, scores[:12], cand, scores, mask)), 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not np.array_equal(got, kept)        # some boxes were voted


# -- proposal ----------------------------------------------------------------


def _proposal_case(seed):
    """One 8 × 8 map's anchors and two images' scores and deltas: image
    0 at 128² scale 1, image 1 at 96 × 120 scale 2.5 (min_size 40 px)."""
    rng = np.random.RandomState(seed)
    anchors = T.anchor.shift_anchors(T.anchor.generate_base_anchors(), 8, 8)
    n = anchors.shape[0]
    scores = rng.rand(2, n).astype(np.float32)
    deltas = (rng.randn(2, n, 4) * 0.3).astype(np.float32)
    info = np.array([[128, 128, 1.0], [96, 120, 2.5]], np.float32)
    return anchors, scores, deltas, info


def _decoded(anchors, deltas, h, w):
    boxes = np.asarray(jax_bbox.clip_boxes(
        jax_bbox.bbox_transform_inv(anchors, deltas), h - 1.0, w - 1.0))
    return boxes


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pre,post", [(64, 16), (6000, 300)])
def test_proposal_equal_reference(seed, pre, post):
    """Batched over two images with different ``im_info``: per image the
    kept indices equal the reference's and the ROIs lie within 1e-4 px;
    the ``min_size`` filter removes candidates the scores alone would
    have kept (it bites), and padded rows are zero."""
    anchors, scores, deltas, info = _proposal_case(seed)
    param = dict(pre_nms_topn=pre, post_nms_topn=post)
    rois, mask = T.proposal.proposal(
        torch.from_numpy(scores), torch.from_numpy(deltas),
        torch.from_numpy(anchors), torch.from_numpy(info[:, 0]),
        torch.from_numpy(info[:, 1]), torch.from_numpy(info[:, 2]),
        T.proposal.ProposalParam(**param))
    assert rois.shape == (2, post, 4) and mask.shape == (2, post)
    filtered = 0
    for i in range(2):
        jr, jm = J.proposal.proposal(
            scores[i], deltas[i], anchors, info[i, 0], info[i, 1],
            info[i, 2], param=J.proposal.ProposalParam(**param))
        jr, jm = np.asarray(jr), np.asarray(jm)
        np.testing.assert_array_equal(mask[i].numpy(), jm)
        boxes = _decoded(anchors, deltas[i], info[i, 0], info[i, 1])
        # the kept index of each valid row: the decoded box it copies
        valid = jm > 0
        idx = [np.abs(boxes - r).sum(1).argmin() for r in jr[valid]]
        got_idx = [np.abs(boxes - r).sum(1).argmin()
                   for r in rois[i].numpy()[valid]]
        assert got_idx == idx
        np.testing.assert_allclose(rois[i].numpy(), jr, rtol=0, atol=1e-4)
        assert (rois[i].numpy()[~valid] == 0).all()
        ws = boxes[:, 2] - boxes[:, 0] + 1
        hs = boxes[:, 3] - boxes[:, 1] + 1
        small = (ws < 16 * info[i, 2]) | (hs < 16 * info[i, 2])
        assert not small[idx].any()
        filtered += int(small[np.argsort(-scores[i])[:pre]].sum())
    assert filtered > 0


# -- ROI pooling ---------------------------------------------------------------


def _roi_case(seed, scale):
    rng = np.random.RandomState(seed)
    H, W, C = 6, 9, 5
    feat = rng.randn(2, H, W, C).astype(np.float32)
    px = 1.0 / scale
    xy = rng.rand(2, 24, 2) * np.array([W, H]) * px * 1.2 - 0.1 * W * px
    wh = rng.rand(2, 24, 2) * np.array([W, H]) * px
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[0, 0] = [0, 0, W * px - 1, H * px - 1]          # the whole map
    rois[0, 1] = [0.5 * px, 0.5 * px, 2.5 * px, 4.5 * px]  # corners at .5
    rois[0, 2] = [-0.5 * px, 1.5 * px, 3.5 * px, 2.5 * px]  # -0.5: rounds to -1
    rois[0, 3] = [2 * px, 2 * px, 2 * px, 3 * px]         # roi_h < 7
    rois[0, 4] = [-3 * px, -3 * px, -1 * px, -1 * px]     # off the map
    # over the bottom-right edge: the bins past it are empty
    rois[1, 0] = [(W - 2) * px, (H - 1) * px, (W + 4) * px, (H + 3) * px]
    mask = (rng.rand(2, 24) > 0.25).astype(np.float32)
    mask[0, :5] = mask[1, 0] = 1.0
    return feat, rois, mask


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scale,pooled", [(1 / 16, (7, 7)), (1 / 8, (3, 2)),
                                          (0.3, (7, 7))])
def test_roi_pool_bit_equal(seed, scale, pooled):
    """``roi_pool_batch`` and ``roi_pool`` bit-equal to the reference's:
    ROIs over the edges (the bins past the map are empty and give 0) and
    off the map, corners at an exact .5 after scaling (half away from
    zero), ``roi_h < 7`` (bins of repeated rows) and masked ROIs
    (zeros)."""
    feat, rois, mask = _roi_case(seed, scale)
    ph, pw = pooled
    kw = dict(pooled_h=ph, pooled_w=pw, spatial_scale=scale)
    want = np.asarray(J.roi_pool.roi_pool_batch(feat, rois, mask, **kw))
    got = T.roi_pool.roi_pool_batch(torch.from_numpy(feat),
                                    torch.from_numpy(rois),
                                    torch.from_numpy(mask), **kw).numpy()
    assert got.shape == (2, 24, ph, pw, 5)
    np.testing.assert_array_equal(got, want)
    edge = got[1, 0]
    assert (edge == 0).all(-1).any() and not (edge == 0).all()
    assert (got[0, 4] == 0).all()
    for i in range(2):
        np.testing.assert_array_equal(
            T.roi_pool.roi_pool(torch.from_numpy(feat[i]),
                                torch.from_numpy(rois[i]), None,
                                **kw).numpy(),
            np.asarray(J.roi_pool.roi_pool(feat[i], rois[i], None, **kw)))


def test_roi_pool_half_away_from_zero():
    """A corner at x = 2.5 cells rounds to 3 (C ``round()``), not 2."""
    feat = np.zeros((1, 4, 6, 1), np.float32)
    feat[0, :, 2] = 1.0                     # column 2 only
    rois = np.array([[[40.0, 0.0, 80.0, 48.0]]], np.float32)  # x1 = 2.5
    got = T.roi_pool.roi_pool_batch(torch.from_numpy(feat),
                                    torch.from_numpy(rois), pooled_h=1,
                                    pooled_w=1).numpy()
    assert got.item() == 0.0                # column 2 is left of the ROI
    assert np.asarray(J.roi_pool.roi_pool_batch(
        feat, rois, pooled_h=1, pooled_w=1)).item() == 0.0


# -- post-processing -----------------------------------------------------------


def _post_case(seed, ties):
    rng = np.random.RandomState(seed)
    R, C = 40, CLASSES
    s = rng.rand(2, R, C).astype(np.float32) ** 2
    s /= s.sum(-1, keepdims=True)
    if ties:                         # few score levels: many equal scores
        s = (np.round(s * 8) / 8).astype(np.float32)
    xy = rng.rand(2, R, C, 2) * 90
    boxes = np.concatenate([xy, xy + rng.rand(2, R, C, 2) * 40 + 1], -1)
    return s, boxes.reshape(2, R, C * 4).astype(np.float32)


@pytest.mark.parametrize("vote", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_frcnn_postprocess_equal_reference(vote, ties, seed):
    """Classes and order equal (score ties resolved as ``lax.top_k``),
    scores within 1e-6, boxes within 1e-4 px; padded rows class -1,
    score 0, box 0."""
    s, boxes = _post_case(seed, ties)
    kw = dict(n_classes=CLASSES, bbox_vote=vote, max_per_image=30,
              nms_topk=25)
    got = T.frcnn.frcnn_postprocess(torch.from_numpy(s),
                                    torch.from_numpy(boxes),
                                    T.frcnn.FrcnnPostParam(**kw)).numpy()
    assert got.shape == (2, 30, 6)
    for i in range(2):
        want = np.asarray(J.frcnn.frcnn_postprocess(
            s[i], boxes[i], J.frcnn.FrcnnPostParam(**kw)))
        np.testing.assert_array_equal(got[i, :, 0], want[:, 0])
        np.testing.assert_allclose(got[i, :, 1], want[:, 1], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got[i, :, 2:], want[:, 2:], rtol=0,
                                   atol=1e-4)
        pad = got[i, :, 1] <= 0
        assert (got[i, pad, 0] == -1).all() and (got[i, pad, 2:] == 0).all()
        assert (got[i, ~pad, 0] >= 1).all() and (~pad).sum() >= 10


# -- the network -------------------------------------------------------------


def _seeded_params(jdet, seed=0):
    """The flax detector's params with numpy-seeded values (LeCun-normal
    kernels, small random biases); shapes from ``eval_shape``."""
    shapes = jax.eval_shape(jdet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)), jnp.ones((1, 3)))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            v = rng.randn(*leaf.shape) * 0.01
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


@pytest.fixture(scope="module")
def nets():
    """The flax ``FasterRcnnDetector`` and the port's on bridged weights,
    and two images with different ``im_info``."""
    jdet = jax_frcnn.FasterRcnnDetector(param=_params(jax_frcnn))
    params = _seeded_params(jdet)
    tdet = sc.unfilled(faster_rcnn.FasterRcnnDetector, _params(faster_rcnn),
                       seed=3)
    tdet.load_state_dict(frcnn_params_from_jax(params, tdet))
    rng = np.random.RandomState(1)
    x = (rng.rand(2, SIZE, SIZE, 3) * 255 - 120).astype(np.float32)
    info = np.array([[SIZE, SIZE, 1.0], [96, SIZE, 0.8]], np.float32)
    return jdet, params, tdet, x, info


def test_weight_bridge_names_and_layouts(nets):
    jdet, params, tdet, _, _ = nets
    sd = tdet.state_dict()
    assert "frcnn.vgg.conv1_1.weight" in sd and "frcnn.rpn_conv_3x3.bias" in sd
    fc6 = np.asarray(params["frcnn"]["fc6"]["kernel"])        # (HWC, 4096)
    np.testing.assert_array_equal(sd["frcnn.fc6.weight"].numpy(), fc6.T)
    conv = np.asarray(params["frcnn"]["vgg"]["conv3_2"]["kernel"])
    np.testing.assert_array_equal(sd["frcnn.vgg.conv3_2.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    assert sum(p.numel() for p in tdet.parameters()) == sum(
        np.asarray(v).size for v in jax.tree_util.tree_leaves(params))


def test_vgg_outputs_match_reference(nets):
    """``FasterRcnnVgg``: the mask and the kept proposals equal, ROIs
    within ``ROI_TOL_PX``, probabilities within ``PROB_TOL``, deltas
    within ``DELTA_TOL``."""
    jdet, params, tdet, x, info = nets
    jv = jax_frcnn.FasterRcnnVgg(param=_params(jax_frcnn))
    want = jax.jit(lambda p, a, i: jv.apply({"params": p}, a, i))(
        params["frcnn"], x, info)
    with torch.no_grad():
        got = tdet.frcnn(torch.from_numpy(x), info)
    rois, mask, probs, deltas = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[1].numpy(), mask)
    assert mask.sum() >= 16
    np.testing.assert_allclose(got[0].numpy(), rois, rtol=0, atol=ROI_TOL_PX)
    np.testing.assert_allclose(got[2].numpy(), probs, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(got[3].numpy(), deltas, rtol=0, atol=DELTA_TOL)
    np.testing.assert_allclose(got[2].sum(-1).numpy(), 1.0, atol=1e-5)


def test_detector_matches_reference(nets):
    """``FasterRcnnDetector``: detections' classes and order equal,
    scores within ``PROB_TOL``, boxes within ``BOX_TOL_PX``; boxes
    inside each image, padded rows class -1."""
    jdet, params, tdet, x, info = nets
    want = np.asarray(jax.jit(lambda p, a, i: jdet.apply({"params": p}, a, i))(
        params, x, info))
    with torch.no_grad():
        got = tdet(torch.from_numpy(x), torch.from_numpy(info)).numpy()
    _assert_dets(got, want)
    for i in range(2):
        kept = got[i][got[i, :, 1] > 0]
        assert len(kept) >= 5
        assert ((kept[:, 0] >= 1) & (kept[:, 0] < CLASSES)).all()
        assert (kept[:, [2, 4]] <= info[i, 1] - 1).all()
        assert (kept[:, [3, 5]] <= info[i, 0] - 1).all()
        assert (got[i][got[i, :, 1] <= 0][:, 0] == -1).all()


def _assert_dets(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0,
                               atol=PROB_TOL)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                               atol=BOX_TOL_PX)


def test_decode_frcnn_boxes_matches_reference(nets):
    rng = np.random.RandomState(4)
    rois = _boxes(rng, 10, 120.0)
    deltas = (rng.randn(10, 4 * CLASSES) * 0.4).astype(np.float32)
    info = np.array([100.0, 90.0, 1.0], np.float32)
    want = np.asarray(jax_frcnn.decode_frcnn_boxes(rois, deltas, info))
    got = faster_rcnn.decode_frcnn_boxes(torch.from_numpy(rois),
                                         torch.from_numpy(deltas), info)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    both = faster_rcnn.decode_frcnn_boxes(
        torch.from_numpy(np.stack([rois, rois])),
        torch.from_numpy(np.stack([deltas, deltas])), np.stack([info, info]))
    np.testing.assert_array_equal(both[1].numpy(), got.numpy())


def test_training_and_sharding_refused(nets):
    _, _, tdet, x, info = nets
    xt = torch.from_numpy(x[:1])
    # training is ported (tests/test_torch_frcnn_train.py): the keywords
    # run, over a mesh too; sharded serving is refused
    with torch.no_grad():
        out = tdet.frcnn(xt, info[:1], train=True,
                         extra_rois=torch.zeros(1, 2, 4), train_outputs=True)
    assert out["rois"].shape == (1, 16 + 2, 4)
    import torch_dist_scenarios as sc
    assert pipe.train_frcnn(tdet.frcnn, [], SIZE, epochs=0,
                            mesh=sc.StubMesh({"data": 1})) is tdet.frcnn
    # sharded serving is served (item 12b.4): a one-rank mesh's rungs
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    assert [t.name for t in pipe.frcnn_serving_tiers(
        tdet, specs=SpecSet(sc.StubMesh({"data": 1})), device="cpu")] == [
            "fp", "int8"]
    with pytest.raises(NotImplementedError, match="item e"):
        PreProcessParam(wire_format="yuv420")
    yuv = PreProcessParam()
    yuv.wire_format = "yuv420"
    with pytest.raises(ValueError, match="wire"):
        pipe.FrcnnPredictor(tdet, yuv, device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        pipe.FrcnnPredictor(tdet, quantize="int4", device="cpu")
    assert faster_rcnn.frcnn_vgg_rename()("rpn_conv/3x3/weight") == (
        "rpn_conv_3x3/weight")


# -- the predictor and the serving tiers ---------------------------------------


def test_predictor_means_as_reference(nets):
    jdet, params, tdet, _, _ = nets
    for kw in ({}, {"param": PreProcessParam(batch_size=2)},
               {"param": PreProcessParam(batch_size=2),
                "swap_default_means": False}):
        jkw = dict(kw)
        if "param" in jkw:
            jkw["param"] = JaxPreProcessParam(batch_size=2)
        got = pipe.FrcnnPredictor(tdet, device="cpu", **kw).param
        want = jax_pipe.FrcnnPredictor(jdet, {"params": params}, **jkw).param
        assert tuple(got.pixel_means) == tuple(want.pixel_means)
        assert got.resolution == want.resolution


def test_detect_batch_matches_reference(nets):
    """Staged uint8 canvases with ``im_info`` of two originals (scales
    0.64 and 1.28 × 0.8): the detections in original pixels."""
    jdet, params, tdet, _, _ = nets
    rng = np.random.RandomState(7)
    batch = {"input": rng.randint(0, 256, (2, SIZE, SIZE, 3)).astype(
        np.uint8), "im_info": np.array([[SIZE, 82, 0.64, 0.64],
                                        [SIZE, SIZE, 1.28, 0.8]],
                                       np.float32)}
    param = dict(batch_size=2, resolution=SIZE)
    want = jax_pipe.FrcnnPredictor(jdet, {"params": params},
                                   JaxPreProcessParam(**param)
                                   ).detect_batch(batch)
    got = pipe.FrcnnPredictor(tdet, PreProcessParam(**param),
                              device="cpu").detect_batch(batch)
    _assert_dets(got, want)
    assert (got[..., 1] > 0).sum() >= 10


def _mixed_records(n=5):
    """Shapes images of mixed, non-square sizes, encoded by the port."""
    rng = np.random.RandomState(11)
    sizes = [(160, 96), (100, 150), (128, 128), (90, 200), (140, 60)]
    out = []
    for i in range(n):
        img, gt = synthetic.render_shapes_image(rng, 200)
        h, w = sizes[i % len(sizes)]
        out.append(records.SSDByteRecord(
            native.encode_jpeg(np.ascontiguousarray(img[:h, :w]),
                               codec="libjpeg"), f"m{i}.jpg", gt))
    return out


def test_predict_records_matches_reference(nets):
    """``predict(records)`` through ``AspectScaleCanvas`` on records of
    mixed sizes, a final partial batch included: per image, the
    reference's detections."""
    jdet, params, tdet, _, _ = nets
    recs = _mixed_records()
    jrecs = [jax_records.SSDByteRecord(r.data, r.path, r.gt) for r in recs]
    param = dict(batch_size=2, resolution=SIZE)
    want = jax_pipe.FrcnnPredictor(jdet, {"params": params},
                                   JaxPreProcessParam(**param)).predict(jrecs)
    got = pipe.FrcnnPredictor(tdet, PreProcessParam(**param),
                              device="cpu").predict(recs)
    assert len(got) == len(want) == len(recs)
    for g, w, r in zip(got, want, recs):
        _assert_dets(g, w)
    kept = np.concatenate([g[g[:, 1] > 0] for g in got])
    assert len(kept) >= 10 and (kept[:, 2:] >= 0).all()


@pytest.fixture(scope="module")
def tiers(nets):
    jdet, params, tdet, _, _ = nets
    ref = jax_pipe.frcnn_serving_tiers(jdet, {"params": params},
                                       JaxPreProcessParam(batch_size=2,
                                                          resolution=SIZE))
    port = pipe.frcnn_serving_tiers(tdet, PreProcessParam(
        batch_size=2, resolution=SIZE), device="cpu")
    rng = np.random.RandomState(2)
    images = [rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.float32)
              - np.float32(pipe.FRCNN_BGR_MEANS) for _ in range(2)]
    return ref, port, images


def _serve_each_rung(serving, tiers, images):
    clock = serving.VirtualClock()
    rt = serving.ServingRuntime(tiers, n_replicas=1, clock=clock,
                                max_batch=2, default_deadline_s=60.0,
                                wedge_timeout_s=60.0,
                                service_time=lambda e, n, t: 0.01)
    rows = []
    for tier in range(len(tiers)):
        rt.ladder.tier = tier
        for x in images:
            rt.submit({"input": x})
        assert rt.pump(force=True) == 1
        rows.append(np.stack([np.asarray(r.result)
                              for r in rt.requests[-2:]]))
    assert rt.accounting()["by_state"] == {"done": 2 * len(tiers)}
    return rows


def test_serving_tiers_through_both_runtimes(tiers):
    """Both rungs serve through each runtime: the port's rows equal its
    predictors' called directly and match the reference's rung for rung
    (the int8 rung on bit-equal int8 weights); the int8 rung keeps the
    weights of every layer but conv1_1 as int8."""
    ref, port, images = tiers
    assert [t.name for t in port] == [t.name for t in ref] == ["fp", "int8"]
    assert port[0].speed == 1.0 and port[1].speed == pipe.INT8_SPEED
    preds = [t.device_program()[0].__self__ for t in port]
    assert preds[0].quantize is False and preds[1].quantize is True
    q = [n for n, _ in preds[1].detector.named_modules()
         if type(_).__name__ in ("QConv2d", "QLinear")]
    assert len(q) == 19 and "frcnn.vgg.conv1_1" not in q
    fn, args = port[1].device_program()
    assert fn(*args).shape == (1, 100, 6)
    got_rows = _serve_each_rung(tserving, port, images)
    want_rows = _serve_each_rung(jserving, ref, images)
    x = np.stack(images)
    info = np.tile(np.array([[SIZE, SIZE, 1.0, 1.0]], np.float32), (2, 1))
    for pred, got, want in zip(preds, got_rows, want_rows):
        np.testing.assert_array_equal(
            got, pred.detect_batch({"input": x, "im_info": info}))
        _assert_dets(got, want)
        assert (got[..., 1] > 0).sum() >= 10


def test_cuda_chain_imports_no_cv2(tmp_path):
    """With cv2 unimportable, the card's routes (the device is CUDA; the
    CPU's codec, since nvJPEG needs a card) run ``AspectScale`` and
    ``FrcnnPredictor.predict``'s chain, ``serving_chain(uint8=True,
    resize=AspectScaleCanvas)``, on records of mixed sizes.  Against the
    CPU's route (``cv2.resize``): im_info equal, pixels within 1 level."""
    recs = _mixed_records(4)
    paths = records.write_ssd_records(recs, str(tmp_path / "m"), 1)
    out_path = tmp_path / "out.npz"
    code = textwrap.dedent(f"""
        import sys
        sys.modules["cv2"] = None
        import numpy as np
        import torch
        from analytics_zoo_tpu_torch.data import native, records
        from analytics_zoo_tpu_torch.pipelines import ssd
        from analytics_zoo_tpu_torch.transform import vision
        torch.cuda.is_available = lambda: True
        native.codec_for = lambda device: "libjpeg"
        recs = list(records.read_ssd_records({paths!r}))
        param = ssd.PreProcessParam(batch_size=2, resolution={SIZE})
        (a, b) = ssd.serving_chain(param, uint8=True,
                                   resize=vision.AspectScaleCanvas({SIZE})
                                   )(recs)
        f = ssd.BytesToMat(to_float=False).transform(
            ssd.RecordToFeature().transform(recs[0]))
        f = vision.AspectScale(60, 8, 100).transform(f)
        np.savez({str(out_path)!r}, x=np.concatenate([a["input"],
                 b["input"]]), info=np.concatenate([a["im_info"],
                 b["im_info"]]), aspect=f.mat)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    got = np.load(out_path)
    from analytics_zoo_tpu_torch.pipelines import ssd as ssd_pipe
    from analytics_zoo_tpu_torch.transform import vision

    param = PreProcessParam(batch_size=2, resolution=SIZE)
    want = list(ssd_pipe.serving_chain(
        param, uint8=True, resize=vision.AspectScaleCanvas(SIZE, device="cpu"),
        device="cpu")(recs))
    np.testing.assert_array_equal(
        got["info"], np.concatenate([b["im_info"] for b in want]))
    assert np.abs(got["x"].astype(int) - np.concatenate(
        [b["input"] for b in want]).astype(int)).max() <= 1
    f = ssd_pipe.BytesToMat(to_float=False, device="cpu").transform(
        ssd_pipe.RecordToFeature().transform(recs[0]))
    f = vision.AspectScale(60, 8, 100, device="cpu").transform(f)
    assert got["aspect"].shape == f.mat.shape == (104, 64, 3)
    assert np.abs(got["aspect"].astype(int) - f.mat.astype(int)).max() <= 1
