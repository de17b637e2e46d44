"""Parity of the port's Faster-RCNN training slice with the JAX package, on
the CPU: ``rpn_targets`` and ``head_targets`` (the reference's cases,
ties, padded gts and cross-boundary anchors), ``frcnn_training_loss``,
``FasterRcnnVgg``'s training outputs and one step's loss and gradients
on bridged weights, dropout, ``train_frcnn``, and the ``Optimizer``'s
``forward_fn`` and ``set_epoch_hook``.

Inputs are made by numpy from a seed and given to both packages.
Tolerances:

- the sampled targets (labels, weights) are held EQUAL, ties included;
  the box targets within 1e-6 relative (the same fp32 ops);
- ``frcnn_training_loss`` on the same outputs within 1e-5 relative;
- the network (VGG16 widths at 128 px, 4 classes, 64/16 proposals) on
  bridged weights, dropout off: the outputs differ by the two
  convolution libraries' summation order (``RPN_TOL``, ``HEAD_TOL``);
  the targets drawn from them are equal; the loss within 1e-5 relative
  (``LOSS_TOL``, measured 5e-7).  Gradients, relative L2: conv5, the RPN
  and the heads within ``GRAD_TOL`` (measured ≤ 4e-6); conv1–conv4,
  below the trunk's 2 × 2 max pools, within ``TRUNK_GRAD_TOL``: the two
  forwards differ by ~1e-5 relative at conv4_3, so a pool window whose
  two largest values lie closer than that sends its gradient to the
  other element on each side.  On this seed one window of pool4 does
  (0.3895207 / 0.3895241 in the port, the order of a float64 run
  reversed): conv4_3's kernel gradient moves by 4.5e-4 and conv1_1's
  by 6.7e-3 (the reference's own fp32 run lies 3.1e-3 from float64
  there).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_scenarios as sc
from analytics_zoo_tpu.models import faster_rcnn as jax_frcnn
from analytics_zoo_tpu.ops import frcnn_train as jft
from analytics_zoo_tpu_torch.core import layers
from analytics_zoo_tpu_torch.models import faster_rcnn
from analytics_zoo_tpu_torch.ops import frcnn_train as tft
from analytics_zoo_tpu_torch.ops.proposal import ProposalParam
from analytics_zoo_tpu_torch.parallel import optim, train
from analytics_zoo_tpu_torch.pipelines import frcnn as pipe
from analytics_zoo_tpu_torch.utils.convert import (flatten_params,
                                                   frcnn_params_from_jax,
                                                   state_dict_to_flax)

torch.set_num_threads(2)
# the package exports the function ``proposal`` under the module's name
jax_proposal = importlib.import_module("analytics_zoo_tpu.ops.proposal")

SIZE, CLASSES, B, G = 128, 4, 2, 3
RPN_TOL = 1e-4
HEAD_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
TRUNK_GRAD_TOL = 2e-2
_BELOW_POOL4 = ("vgg/conv1", "vgg/conv2", "vgg/conv3", "vgg/conv4")


def T(a):
    return torch.from_numpy(np.asarray(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _boxes(rng, n, span, lo=8.0, hi=60.0):
    xy = rng.rand(n, 2) * span
    wh = lo + rng.rand(n, 2) * (hi - lo)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _assert_targets_equal(got, want):
    """labels and weights EQUAL, box targets within 1e-6 relative."""
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-6)


# the reference's target samplers as one compiled program each, as its
# jitted train step runs them (op by op they compile each op apart)
_jit_rpn_targets = jax.jit(jft.rpn_targets, static_argnums=(6,))
_jit_head_targets = jax.jit(jft.head_targets, static_argnums=(6,))


def _rpn_both(anchors, gt, gt_mask, h, w, fg, p=tft.FrcnnLossParam()):
    jp = jft.FrcnnLossParam(**p.__dict__)
    want = _jit_rpn_targets(jnp.asarray(anchors), jnp.asarray(gt),
                            jnp.asarray(gt_mask), h, w, jnp.asarray(fg), jp)
    got = tft.rpn_targets(T(anchors), T(gt), T(gt_mask), h, w, T(fg), p)
    return got, want


# -- targets -----------------------------------------------------------------


def test_rpn_targets_hand_checked_cases():
    """The reference's cases: an exact match is a positive with a zero
    box target, a far anchor a sampled negative, the best anchor of a gt
    positive below the IoU bar, a cross-boundary anchor ignored."""
    anchors = np.array([[10, 10, 50, 50], [30, 10, 70, 50],
                        [200, 200, 240, 240]], np.float32)
    gt = np.array([[10, 10, 50, 50]], np.float32)
    got, want = _rpn_both(anchors, gt, np.ones(1, np.float32), 300.0, 300.0,
                          np.array([0.9, 0.5, 0.1], np.float32))
    _assert_targets_equal(got, want)
    labels, cls_w, box_t, box_w = (v.numpy() for v in got)
    assert labels[0] == 1 and box_w[0] == 1 and labels[2] == 0
    assert cls_w[2] == 1
    np.testing.assert_allclose(box_t[0], 0.0, atol=1e-6)

    got, want = _rpn_both(np.array([[0, 0, 30, 30], [60, 60, 90, 90]],
                                   np.float32),
                          np.array([[10, 10, 45, 45]], np.float32),
                          np.ones(1, np.float32), 100.0, 100.0,
                          np.zeros(2, np.float32))
    _assert_targets_equal(got, want)
    assert got[0][0] == 1 and got[3][0] == 1

    got, want = _rpn_both(np.array([[-5, 10, 50, 50], [10, 10, 50, 50]],
                                   np.float32),
                          np.array([[10, 10, 50, 50]], np.float32),
                          np.ones(1, np.float32), 300.0, 300.0,
                          np.zeros(2, np.float32))
    _assert_targets_equal(got, want)
    assert got[1][0] == 0 and got[3][0] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rpn_targets_random_with_ties_and_padding(seed):
    """600 anchors (some duplicated, so IoUs tie; fg scores quantized, so
    hard-negative ranks tie), crossing the border, against gts with
    padded rows (zeros, masked) — one of them a padded row that argmaxes
    to anchor 0 — under small sample caps."""
    rng = np.random.RandomState(seed)
    anchors = _boxes(rng, 600, 200.0, 10.0, 80.0) - 10.0
    anchors[0] = (20.0, 20.0, 70.0, 70.0)
    anchors[300:350] = anchors[:50]                     # IoU ties
    gt = np.zeros((4, 4), np.float32)
    gt[:2] = _boxes(rng, 2, 150.0, 30.0, 90.0)
    gt[2] = anchors[0]                                   # best anchor 0
    mask = np.array([1, 1, 1, 0], np.float32)
    fg = np.round(rng.rand(600), 2).astype(np.float32)  # score ties
    p = tft.FrcnnLossParam(rpn_sample=64, rpn_pos_frac=0.5)
    got, want = _rpn_both(anchors, gt, mask, 220.0, 230.0, fg, p)
    _assert_targets_equal(got, want)
    assert got[1].sum() <= 64 and got[3].sum() <= 32
    assert got[0][0] == 1                     # anchor 0 stays positive


def test_rpn_targets_batched_equal_per_image():
    rng = np.random.RandomState(3)
    anchors = _boxes(rng, 300, 120.0) - 4.0
    gt = np.stack([_boxes(rng, G, 100.0, 20.0, 60.0) for _ in range(2)])
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    fg = rng.rand(2, 300).astype(np.float32)
    hs, ws = np.array([128.0, 96.0]), np.array([128.0, 120.0])
    batch = tft.rpn_targets(T(anchors), T(gt), T(mask), T(hs), T(ws), T(fg))
    for b in range(2):
        _, want = _rpn_both(anchors, gt[b], mask[b], float(hs[b]),
                            float(ws[b]), fg[b])
        _assert_targets_equal([v[b] for v in batch], want)


@pytest.mark.parametrize("seed", [0, 1])
def test_head_targets_match_reference(seed):
    """ROIs with invalid rows, duplicates (IoU ties) and quantized
    background scores (rank ties) against padded gts."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((4, 4), np.float32)
    gt[:3] = _boxes(rng, 3, 100.0, 20.0, 60.0)
    labels = np.array([3, 1, 2, 0], np.int32)
    mask = np.array([1, 1, 1, 0], np.float32)
    rois = np.concatenate([_boxes(rng, 150, 120.0, 10.0, 70.0), gt[:3],
                           gt[:3] + 1.0])
    rois[100:110] = rois[:10]
    roi_mask = (rng.rand(len(rois)) > 0.1).astype(np.float32)
    bg = np.round(rng.rand(len(rois)), 1).astype(np.float32)
    p = tft.FrcnnLossParam(head_sample=32, head_pos_frac=0.25)
    want = _jit_head_targets(jnp.asarray(rois), jnp.asarray(roi_mask),
                             jnp.asarray(gt), jnp.asarray(labels),
                             jnp.asarray(mask), jnp.asarray(bg),
                             jft.FrcnnLossParam(**p.__dict__))
    got = tft.head_targets(T(rois), T(roi_mask), T(gt), T(labels), T(mask),
                           T(bg), p)
    _assert_targets_equal(got, want)
    assert got[1].sum() <= 32 and got[3].sum() <= 8
    assert (got[1].numpy()[roi_mask == 0] == 0).all()


def test_head_targets_reference_cases():
    gt = np.array([[10, 10, 50, 50]], np.float32)
    got = tft.head_targets(T(np.array([[10, 10, 50, 50],
                                       [200, 200, 240, 240]], np.float32)),
                           torch.ones(2), T(gt), torch.tensor([3]),
                           torch.ones(1), torch.tensor([0.5, 0.5]))
    assert got[0].tolist() == [3, 0] and got[3].tolist() == [1.0, 0.0]
    np.testing.assert_allclose(got[2][0].numpy(), 0.0, atol=1e-6)
    got = tft.head_targets(T(np.array([[10, 10, 50, 50], [0, 0, 0, 0]],
                                      np.float32)),
                           torch.tensor([1.0, 0.0]), T(gt),
                           torch.tensor([2]), torch.ones(1),
                           torch.tensor([0.5, 0.9]))
    assert got[1][1] == 0


def _random_outputs(rng, n_anchor=200, R=20, C=CLASSES):
    anchors = _boxes(rng, n_anchor, 100.0) - 5.0
    return {
        "rpn_cls_logits": rng.randn(B, n_anchor, 2).astype(np.float32),
        "rpn_deltas": (rng.randn(B, n_anchor, 4) * 0.3).astype(np.float32),
        "fg_scores": rng.rand(B, n_anchor).astype(np.float32),
        "anchors": anchors,
        "rois": np.stack([_boxes(rng, R, 100.0) for _ in range(B)]),
        "roi_mask": (rng.rand(B, R) > 0.2).astype(np.float32),
        "cls_logits": rng.randn(B, R, C).astype(np.float32),
        "bbox_deltas": (rng.randn(B, R, 4 * C) * 0.3).astype(np.float32),
    }


def _gt_batch(rng, span=100.0):
    gt = np.stack([_boxes(rng, G, span, 20.0, 60.0) for _ in range(B)])
    return {"target": {"bboxes": gt,
                       "labels": rng.randint(1, CLASSES, (B, G)).astype(
                           np.int32),
                       "mask": np.array([[1, 1, 0], [1, 1, 1]], np.float32)},
            "im_info": np.array([[SIZE, SIZE, 1.0], [100, SIZE, 1.0]],
                                np.float32)}


def test_training_loss_matches_reference():
    """The four losses on the same outputs, within 1e-5 relative, and the
    gradient with respect to the logits and deltas within 1e-5."""
    rng = np.random.RandomState(5)
    out = _random_outputs(rng)
    batch = _gt_batch(rng)
    # some rois on the gts, so the head has foreground
    out["rois"][:, :G] = batch["target"]["bboxes"] + 1.0
    keys = ("rpn_cls_logits", "rpn_deltas", "cls_logits", "bbox_deltas")

    def jloss(diff):
        return jft.frcnn_training_loss({**out, **diff}, batch)

    # one compiled program, not op by op: the reference's own train step
    # runs the loss jitted
    want, jgrad = jax.jit(jax.value_and_grad(jloss))(
        {k: jnp.asarray(out[k]) for k in keys})
    tout = {k: T(v) for k, v in out.items()}
    for k in keys:
        tout[k].requires_grad_()
    got = tft.frcnn_training_loss(tout, batch)
    got.backward()
    assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want))
    for k in keys:
        assert _rel(tout[k].grad.numpy(), jgrad[k]) <= 1e-5, k


# -- the network ----------------------------------------------------------


def _param(mod, proposal_mod):
    return mod.FrcnnParam(num_classes=CLASSES,
                          proposal=proposal_mod.ProposalParam(
                              pre_nms_topn=64, post_nms_topn=16))


@pytest.fixture(scope="module")
def net():
    """The flax ``FasterRcnnVgg`` on numpy-seeded params and the port's
    on the same weights, two images, their gts (pixels) and ``im_info``."""
    jnet = jax_frcnn.FasterRcnnVgg(param=_param(jax_frcnn, jax_proposal))
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)), jnp.ones((1, 3)))
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            v = rng.randn(*leaf.shape) * 0.01
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    tnet = sc.unfilled(faster_rcnn.FasterRcnnVgg, faster_rcnn.FrcnnParam(
        num_classes=CLASSES, proposal=ProposalParam(64, 16)), seed=1)
    tnet.load_state_dict(frcnn_params_from_jax(params, tnet))
    x = (rng.rand(B, SIZE, SIZE, 3) * 255 - 120).astype(np.float32)
    batch = _gt_batch(rng, span=80.0)
    return jnet, params, tnet, x, batch


def _inputs(x, batch):
    tgt = batch["target"]
    return (x, batch["im_info"], tgt["bboxes"], tgt["mask"])


def test_train_outputs_keys_shapes_and_order(net):
    """The dict's keys and shapes, ``rpn_cls_logits`` in the reference's
    (y, x, anchor) order with [bg, fg] pairs, and the gt ROIs after the
    proposals."""
    jnet, params, tnet, x, batch = net
    xi, info, gt, gm = _inputs(x, batch)
    want = jax.jit(lambda v, *a: jnet.apply(
        v, *a, extra_rois=jnp.asarray(gt), extra_rois_mask=jnp.asarray(gm),
        train_outputs=True))({"params": params}, jnp.asarray(xi),
                             jnp.asarray(info))
    with torch.no_grad():
        got = tnet(T(xi), T(info), extra_rois=T(gt), extra_rois_mask=T(gm),
                   train_outputs=True)
    assert set(got) == set(want)
    N = (SIZE // 16) ** 2 * 9
    shapes = {"rpn_cls_logits": (B, N, 2), "rpn_deltas": (B, N, 4),
              "fg_scores": (B, N), "anchors": (N, 4), "rois": (B, 16 + G, 4),
              "roi_mask": (B, 16 + G), "cls_logits": (B, 16 + G, CLASSES),
              "bbox_deltas": (B, 16 + G, 4 * CLASSES)}
    for k, shape in shapes.items():
        assert tuple(got[k].shape) == shape == tuple(want[k].shape), k
    np.testing.assert_allclose(got["rpn_cls_logits"].numpy(),
                               np.asarray(want["rpn_cls_logits"]),
                               rtol=RPN_TOL, atol=RPN_TOL)
    # softmax of a (bg, fg) pair is the proposal's fg score
    np.testing.assert_allclose(
        torch.softmax(got["rpn_cls_logits"], -1)[..., 1].numpy(),
        got["fg_scores"].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got["anchors"].numpy(),
                                  np.asarray(want["anchors"]))
    np.testing.assert_array_equal(got["roi_mask"].numpy(),
                                  np.asarray(want["roi_mask"]))
    np.testing.assert_array_equal(got["rois"][:, 16:].numpy(), gt)
    np.testing.assert_allclose(got["cls_logits"].numpy(),
                               np.asarray(want["cls_logits"]),
                               rtol=HEAD_TOL, atol=HEAD_TOL)


def test_one_step_loss_and_gradients_match_reference(net):
    """``frcnn_training_loss`` over the training outputs (dropout off) and
    its gradient with respect to every parameter, on bridged weights: the
    sampled targets equal, the loss within ``LOSS_TOL`` relative, each
    gradient within ``GRAD_TOL`` (``TRUNK_GRAD_TOL`` below pool4)
    relative L2."""
    jnet, params, tnet, x, batch = net
    xi, info, gt, gm = _inputs(x, batch)

    @jax.jit
    def jloss(p):
        out = jnet.apply({"params": p}, jnp.asarray(xi), jnp.asarray(info),
                         extra_rois=jnp.asarray(gt),
                         extra_rois_mask=jnp.asarray(gm), train_outputs=True)
        return jft.frcnn_training_loss(out, batch), out

    (want, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    tnet.zero_grad()
    out = pipe.frcnn_forward_fn(tnet, tuple(T(v) for v in (xi, info, gt, gm)))
    got = tft.frcnn_training_loss(out, batch)
    got.backward()

    # the targets drawn from both sides' outputs are equal
    for b in range(B):
        _assert_targets_equal(
            [v[b] for v in tft.rpn_targets(
                out["anchors"], T(gt), T(gm), T(info[:, 0]), T(info[:, 1]),
                out["fg_scores"].detach())],
            [v[b] for v in jax.vmap(
                lambda g, m, i, s: jft.rpn_targets(
                    jout["anchors"], g, m, i[0], i[1], s))(
                    jnp.asarray(gt), jnp.asarray(gm), jnp.asarray(info),
                    jout["fg_scores"])])
    assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want))
    grads = state_dict_to_flax(
        {k: p.grad for k, p in tnet.named_parameters()},
        {"params": params})["params"]
    want_g = flatten_params(jgrad)
    assert set(grads) == set(want_g)
    for k in want_g:
        tol = TRUNK_GRAD_TOL if k.startswith(_BELOW_POOL4) else GRAD_TOL
        assert _rel(grads[k], want_g[k]) <= tol, (k, _rel(grads[k],
                                                          want_g[k]))


def test_dropout_rate_scale_and_seeded_repeat(net):
    """Dropout keeps about half and scales the kept by 2; two models
    seeded alike draw the same masks, and a model's generator moves on
    from step to step."""
    _, _, tnet, x, batch = net
    ones = torch.ones(200_000)
    y = layers.dropout(ones, 0.5, torch.Generator().manual_seed(7))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs((y == 0).float().mean().item() - 0.5) < 0.01
    inputs = tuple(T(v) for v in _inputs(x[:1], {
        "im_info": batch["im_info"][:1],
        "target": {k: v[:1] for k, v in batch["target"].items()}}))
    twins = []
    for _ in range(2):
        m = sc.unfilled(faster_rcnn.FasterRcnnVgg, tnet.param, seed=5)
        m.load_state_dict(tnet.state_dict())
        twins.append(m)

    def run(model, train=True):
        with torch.no_grad():
            return model(*inputs[:2], train=train, extra_rois=inputs[2],
                         extra_rois_mask=inputs[3],
                         train_outputs=True)["cls_logits"]

    a, b = run(twins[0]), run(twins[1])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, run(twins[0]))
    assert not torch.equal(a, run(twins[0], train=False))


# -- the loop --------------------------------------------------------------


def _shapes_batches(n_batches=2, res=64, n=2):
    """Bright rectangles on a dark background, normalized gt (the
    reference test's synthetic task)."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n_batches):
        imgs = rng.rand(n, res, res, 3).astype(np.float32) * 10
        bboxes = np.zeros((n, 2, 4), np.float32)
        labels = np.zeros((n, 2), np.int32)
        for b in range(n):
            for g in range(2):
                x1, y1 = rng.randint(2, 30, 2)
                w, h = rng.randint(16, 28, 2)
                x2, y2 = min(x1 + w, res - 2), min(y1 + h, res - 2)
                imgs[b, y1:y2, x1:x2] += 120.0
                bboxes[b, g] = (x1 / res, y1 / res, x2 / res, y2 / res)
                labels[b, g] = 1 + g
        out.append({"input": imgs, "target": {
            "bboxes": bboxes, "labels": labels,
            "mask": np.ones((n, 2), np.float32)}})
    return out


def test_train_frcnn_lowers_the_loss_and_calls_the_epoch_hook():
    res = 64
    batches = _shapes_batches(res=res)
    model = faster_rcnn.FasterRcnnVgg(
        faster_rcnn.FrcnnParam(num_classes=3,
                               proposal=ProposalParam(128, 32)),
        device="cpu", seed=0)

    def eval_loss():
        tot = 0.0
        with torch.no_grad():
            for fb in pipe.frcnn_train_batches(batches, res):
                out = pipe.frcnn_forward_fn(
                    model, tuple(T(v) for v in fb["input"]))
                tot += tft.frcnn_training_loss(out, fb).item()
        return tot / len(batches)

    seen = []
    loss0 = eval_loss()
    pipe.train_frcnn(model, batches, res, epochs=2, lr=3e-3,
                     epoch_hook=lambda loop, state: seen.append(
                         (loop.epoch, state.step)))
    loss1 = eval_loss()
    assert np.isfinite(loss0) and np.isfinite(loss1)
    assert loss1 < loss0, (loss0, loss1)
    assert seen == [(1, 2), (2, 4)]
    assert not model.training
    # over a one-rank mesh (data parallel at width 1) the run is served
    import torch_dist_scenarios as sc
    assert pipe.train_frcnn(model, batches, res, epochs=0,
                            mesh=sc.StubMesh({"data": 1})) is model


def test_optimizer_forward_fn_and_epoch_hook_order():
    """``forward_fn(module, inputs, train)`` replaces the module's call in
    the step (``train`` True) and not in validation; the epoch hook runs
    once an epoch, after that epoch's validation."""
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    calls, events = [], []

    def forward_fn(module, inputs, train):
        calls.append(train)
        x, scale = inputs
        return module(x) * scale

    class Method(train.ValidationMethod):
        name = "m"

        def __call__(self, output, batch):
            events.append("val")
            return train.ValidationResult(0.0, 1.0, "m")

    data = [{"input": (np.ones((4, 3), np.float32),
                       np.float32(2.0)), "target": np.zeros((4, 2),
                                                           np.float32)}]
    crit = lambda out, batch: (out - torch.as_tensor(  # noqa: E731
        batch["target"])).pow(2).mean()
    opt = (train.Optimizer(model, data, crit, forward_fn=forward_fn)
           .set_optim_method(optim.SGD(0.1))
           .set_end_when(optim.Trigger.max_epoch(2))
           .set_validation(optim.Trigger.every_epoch(),
                           [{"input": np.ones((4, 3), np.float32)}],
                           [Method()])
           .set_epoch_hook(lambda loop, state: events.append(
               ("hook", loop.epoch, state.step))))
    opt.optimize()
    assert calls == [True, True]
    assert events == ["val", ("hook", 1, 1), "val", ("hook", 2, 2)]
    # the step with the hook equals the plain step on the same forward
    m2 = torch.nn.Linear(3, 2)
    m2.load_state_dict({k: v.clone() for k, v in model.state_dict().items()})
    s1 = train.make_train_step(model, crit, optim.SGD(0.1),
                               forward_fn=forward_fn)
    s2 = train.make_train_step(m2, lambda out, b: crit(out * 2.0, b),
                               optim.SGD(0.1))
    b1 = data[0]
    b2 = {"input": b1["input"][0], "target": b1["target"]}
    _, r1 = s1(train.create_train_state(model, optim.SGD(0.1)), b1)
    _, r2 = s2(train.create_train_state(m2, optim.SGD(0.1)), b2)
    assert r1["loss"].item() == r2["loss"].item()
    torch.testing.assert_close(model.weight, m2.weight, rtol=0, atol=0)
