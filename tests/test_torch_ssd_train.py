"""Parity of the port's SSD training slice with the JAX package, on the
CPU: ``encode_bbox``, the criterions, ``match_priors`` and
``multibox_loss``, Plateau and the triggers, ``grad_accum``, the
evaluation, ``SSDMeanAveragePrecision``, two SSD300 train steps and a
``train_ssd`` run with validation.  Inputs are made by numpy from a seed
and given to both packages.

Tolerances: box encoding and the criterions run the same fp32 ops, held
within 1e-6 relative (value and gradient); matches, positives and the
negatives mining keeps are held EQUAL, ties and collisions included;
the MultiBoxLoss value within 1e-5 relative and its gradients within
1e-5 relative L2 (sums over 8732 priors in another order); the numpy
evaluation is the same code and is held equal.  Two SSD300 steps: the
convolutions' gradients differ between the two packages by up to ~2e-3
relative L2 in the first layers (fp32 sums over 90,000 positions in
another order, and ReLUs whose argument rounds across 0).  From the
same parameters the losses agree within 1e-7; after one step, the
second loss, on parameters a step apart, within 5.2e-5 (held to 2e-4):
at this random initialisation one step of lr 2.5e-4 moves the loss from
22.7 to 19.0, so it is that sensitive to the first step's rounding.  The
parameters after the two SGD steps agree within 1.8e-5 relative L2
(measured), held to 4e-5, while the steps move them by 2.8e-4 (the
median).  At ``TrainParams``' lr of 0.0035 both packages' loss jumps
from 22.7 to ~203 after one step; there the second losses agree within
4.6e-4 (held to 1e-3) and the parameters within 2.9e-5 (held to 1e-4).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core import criterion as jax_crit
from analytics_zoo_tpu.models import ssd as jax_ssd
from analytics_zoo_tpu.ops import bbox as jax_bbox
from analytics_zoo_tpu.ops.detection_output import (
    DetectionOutputParam as JaxDetParam, detection_output as jax_detout)
from analytics_zoo_tpu.parallel import optim as jax_optim
from analytics_zoo_tpu.parallel import train as jax_train
from analytics_zoo_tpu.pipelines import evaluation as jax_eval
from analytics_zoo_tpu.pipelines import ssd as jax_pipe
from analytics_zoo_tpu_torch.core import criterion as crit
from analytics_zoo_tpu_torch.models import ssd
from analytics_zoo_tpu_torch.ops import bbox
from analytics_zoo_tpu_torch.ops.multibox_loss import (
    MultiBoxLoss, MultiBoxLossParam, match_priors, mine_hard_examples,
    multibox_loss)
from analytics_zoo_tpu_torch.parallel import optim, train
from analytics_zoo_tpu_torch.pipelines import evaluation
from analytics_zoo_tpu_torch.pipelines import ssd as pipe
from analytics_zoo_tpu_torch.utils.convert import (flatten_params,
                                                   ssd_params_from_jax,
                                                   state_dict_to_flax)

# the package exports the function ``multibox_loss`` under the module's name
jax_mbl = importlib.import_module("analytics_zoo_tpu.ops.multibox_loss")

torch.set_num_threads(2)

T = torch.from_numpy
PRIORS, VARIANCES = ssd.build_priors(ssd.ssd300_config())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _gt(seed, B=2, G=10, n_valid=(7, 3)):
    """Padded gts: random boxes, labels 1..20, ``n_valid`` real a row,
    zero boxes under mask 0 past them."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(B, G, 2) * 0.8
    boxes = np.concatenate([xy, xy + rng.rand(B, G, 2) * 0.3 + 0.02], -1)
    mask = (np.arange(G)[None] < np.asarray(n_valid)[:, None]).astype(
        np.float32)
    boxes = (boxes * mask[..., None]).astype(np.float32)
    labels = (rng.randint(1, 21, (B, G)) * mask).astype(np.int32)
    return boxes, labels, mask


# -- encode_bbox, scale_boxes ------------------------------------------------

def test_encode_bbox_and_scale_boxes_match_jax():
    """Encoding against the SSD300 priors, with two zero (padding) boxes
    on the 1e-8 floors: value and gradient (with respect to the gts)."""
    rng = np.random.RandomState(0)
    P = PRIORS.shape[0]
    xy = rng.rand(P, 2) * 0.8
    gt = np.concatenate([xy, xy + rng.rand(P, 2) * 0.3 + 0.01], -1).astype(
        np.float32)
    gt[:2] = 0.0
    g = rng.randn(P, 4).astype(np.float32)
    want, j_grad = jax.value_and_grad(
        lambda b: jnp.sum(jax_bbox.encode_bbox(PRIORS, VARIANCES, b) * g)
    )(jnp.asarray(gt))
    x = T(gt.copy()).requires_grad_()
    enc = bbox.encode_bbox(T(PRIORS), T(VARIANCES), x)
    (enc * T(g)).sum().backward()
    assert torch.isfinite(enc).all()
    np.testing.assert_allclose(
        enc.detach().numpy(), np.asarray(jax_bbox.encode_bbox(
            PRIORS, VARIANCES, gt)), rtol=1e-6, atol=1e-6)
    assert _rel(x.grad.numpy()[2:], np.asarray(j_grad)[2:]) <= 1e-6
    sx, sy = rng.rand(P).astype(np.float32), rng.rand(P).astype(np.float32)
    np.testing.assert_array_equal(
        bbox.scale_boxes(T(gt), T(sx), T(sy)).numpy(),
        np.asarray(jax_bbox.scale_boxes(gt, sx, sy)))


# -- the criterions ----------------------------------------------------------

def _criterion_inputs(name, rng, shape=(4, 6, 5)):
    x = rng.randn(*shape).astype(np.float32)
    if name in ("ClassNLLCriterion", "CrossEntropyCriterion"):
        if name == "ClassNLLCriterion":
            x = np.asarray(jax.nn.log_softmax(x), np.float32)
        return x, rng.randint(0, shape[-1], shape[:-1]).astype(np.int32), \
            (rng.rand(*shape[:-1]) < 0.7).astype(np.float32)
    if name == "BCECriterion":
        x = (rng.rand(*shape) * 0.98 + 0.01).astype(np.float32)
        y = (rng.rand(*shape) < 0.5).astype(np.float32)
    else:
        y = rng.randn(*shape).astype(np.float32)
    return x, y, (rng.rand(*shape) < 0.7).astype(np.float32)


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,kw", [
    ("ClassNLLCriterion", {}), ("CrossEntropyCriterion", {}),
    ("BCECriterion", {}), ("SmoothL1Criterion", {}),
    ("SmoothL1Criterion", {"sigma": 3.0}), ("MSECriterion", {})])
def test_criterion_matches_jax(name, kw, masked, size_average):
    """Value and gradient against the JAX criterion, with and without a
    mask, averaged and summed (``_reduce``)."""
    rng = np.random.RandomState(1)
    x, y, m = _criterion_inputs(name, rng)
    jc = getattr(jax_crit, name)(size_average=size_average, **kw)
    pc = getattr(crit, name)(size_average=size_average, **kw)
    mk = {"mask": m} if masked else {}
    want, j_grad = jax.value_and_grad(lambda a: jc(
        a, jnp.asarray(y), **{k: jnp.asarray(v) for k, v in mk.items()}))(
            jnp.asarray(x))
    xt = T(x.copy()).requires_grad_()
    got = pc(xt, T(y), **{k: T(v) for k, v in mk.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert _rel(xt.grad.numpy(), j_grad) <= 1e-6


def test_parallel_criterion_and_smooth_l1_match_jax():
    rng = np.random.RandomState(2)
    a, b = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(
        np.float32)
    ta, tb = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(
        np.float32)
    jp = jax_crit.ParallelCriterion().add(jax_crit.MSECriterion(), 0.5).add(
        jax_crit.SmoothL1Criterion(sigma=2.0), 2.0)
    pp = crit.ParallelCriterion().add(crit.MSECriterion(), 0.5).add(
        crit.SmoothL1Criterion(sigma=2.0), 2.0)
    want = jp((jnp.asarray(a), jnp.asarray(b)),
              (jnp.asarray(ta), jnp.asarray(tb)))
    got = pp((T(a), T(b)), (T(ta), T(tb)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="sub-criterions"):
        pp((T(a),), (T(ta),))
    d = np.linspace(-3, 3, 61).astype(np.float32)
    np.testing.assert_allclose(crit.smooth_l1(T(d), 1.5).numpy(),
                               np.asarray(jax_crit.smooth_l1(d, 1.5)),
                               rtol=1e-6, atol=1e-7)


# -- match_priors ------------------------------------------------------------

def _match_case(case):
    boxes, labels, mask = _gt(3, B=1, G=8, n_valid=(6,))
    if case == "duplicated":            # the same gt twice: argmax ties
        boxes[0, 3] = boxes[0, 1]
    elif case == "shared_best_prior":   # two gts whose best prior is one
        boxes[0, 2] = PRIORS[4000]
        boxes[0, 4] = PRIORS[4000] + np.float32([0.002, 0.0, 0.002, 0.0])
    elif case == "all_masked":
        mask[:] = 0.0
        boxes[:] = 0.0
    return boxes, labels, mask


@pytest.mark.parametrize("case", ["random", "duplicated",
                                  "shared_best_prior", "all_masked"])
def test_match_priors_equal_jax(case):
    """Matches, positives and best overlaps EQUAL to the reference's, at
    the 8732 SSD300 priors; the batched call equals the per-image one."""
    boxes, labels, mask = _match_case(case)
    jm, jpos, jiou = (np.asarray(a) for a in jax_mbl.match_priors(
        PRIORS, boxes[0], mask[0]))
    m, pos, iou = match_priors(T(PRIORS), T(boxes), T(mask))
    np.testing.assert_array_equal(m[0].numpy(), jm)
    np.testing.assert_array_equal(pos[0].numpy(), jpos)
    np.testing.assert_array_equal(iou[0].numpy(), jiou)
    single = match_priors(T(PRIORS), T(boxes[0]), T(mask[0]))
    for a, b in zip(single, (m[0], pos[0], iou[0])):
        assert torch.equal(a, b)
    if case == "shared_best_prior":     # the later gt wins the prior
        assert int(m[0, 4000]) == 4 and bool(pos[0, 4000])
    if case == "all_masked":
        assert not pos.any()


# -- multibox_loss -----------------------------------------------------------

@pytest.mark.parametrize("logits", ["random", "zeros"])
@pytest.mark.parametrize("mining,topk", [("sort", 1024), ("topk", 64)])
def test_multibox_loss_matches_jax(logits, mining, topk):
    """At the full 8732 priors, batch 2 (one image with 7 gts, one with
    3): the loss, its gradients with respect to loc and conf, and the
    negatives mining keeps.  All-zero logits tie every negative; the
    reference's kept negatives are the non-positive priors whose conf
    gradient is not 0.  ``mining_topk`` 64 caps ``num_neg`` under
    ``3·num_pos``, so the cap is exercised."""
    boxes, labels, mask = _gt(4)
    rng = np.random.RandomState(5)
    B, P = 2, PRIORS.shape[0]
    loc = (rng.randn(B, P, 4) * 0.3).astype(np.float32)
    conf = (np.zeros((B, P, 21), np.float32) if logits == "zeros"
            else rng.randn(B, P, 21).astype(np.float32))
    jparam = jax_mbl.MultiBoxLossParam(mining=mining, mining_topk=topk)
    param = MultiBoxLossParam(mining=mining, mining_topk=topk)
    want, (j_gl, j_gc) = jax.value_and_grad(
        lambda l, c: jax_mbl.multibox_loss(l, c, PRIORS, VARIANCES, boxes,
                                           labels, mask, jparam),
        argnums=(0, 1))(jnp.asarray(loc), jnp.asarray(conf))
    lt, ct = T(loc.copy()).requires_grad_(), T(conf.copy()).requires_grad_()
    got = multibox_loss(lt, ct, T(PRIORS), T(VARIANCES), T(boxes),
                        T(labels), T(mask), param)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert _rel(lt.grad.numpy(), j_gl) <= 1e-5
    assert _rel(ct.grad.numpy(), j_gc) <= 1e-5
    _, pos, iou = match_priors(T(PRIORS), T(boxes), T(mask))
    neg = mine_hard_examples(torch.log_softmax(T(conf), -1), pos, iou, param)
    want_neg = (np.abs(np.asarray(j_gc)).sum(-1) > 0) & ~pos.numpy()
    np.testing.assert_array_equal(neg.numpy(), want_neg)
    assert neg.sum() > 0


def test_multibox_loss_criterion_and_empty_images():
    """``MultiBoxLoss`` reads the padded target dict; an image with no
    valid gt has no positives and keeps no negatives, and a batch with
    none at all gives a finite loss over a floor of 1 match, with finite
    gradients."""
    boxes, labels, mask = _gt(6, n_valid=(4, 0))
    rng = np.random.RandomState(7)
    out = (T(rng.randn(2, 8732, 4).astype(np.float32)).requires_grad_(),
           T(rng.randn(2, 8732, 21).astype(np.float32)).requires_grad_())
    target = {"bboxes": boxes, "labels": labels, "mask": mask}
    loss = MultiBoxLoss(PRIORS, VARIANCES)(out, target)
    want = jax_mbl.MultiBoxLoss(PRIORS, VARIANCES)(
        tuple(jnp.asarray(o.detach().numpy()) for o in out), target)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _, pos, iou = match_priors(T(PRIORS), T(boxes), T(mask))
    neg = mine_hard_examples(torch.log_softmax(out[1].detach(), -1), pos,
                             iou, MultiBoxLossParam())
    assert pos[1].sum() == 0 and neg[1].sum() == 0
    empty = {"bboxes": np.zeros_like(boxes), "labels": labels * 0,
             "mask": mask * 0}
    loss = MultiBoxLoss(PRIORS, VARIANCES)(out, empty)
    loss.backward()
    assert loss.item() == 0.0
    assert all(torch.isfinite(o.grad).all() for o in out)
    with pytest.raises(ValueError, match="mining"):
        MultiBoxLoss(PRIORS, VARIANCES, MultiBoxLossParam(mining="approx"))


# -- Plateau and the triggers ------------------------------------------------

SCORES = [0.10, 0.20, 0.20, 0.19, 0.2001, 0.18, 0.25, 0.25, 0.24, 0.24,
          0.24, 0.30, 0.30, 0.30, 0.30, 0.29]


@pytest.mark.parametrize("kw", [
    dict(patience=2, factor=0.5, mode="max"),
    dict(patience=0, factor=0.1, mode="max", min_lr=1e-4),
    dict(patience=1, factor=0.5, mode="min", epsilon=0.0)])
def test_plateau_matches_jax(kw):
    """The same LR-scale sequence on a scripted score series, through
    ``on_validation`` of an SGD holding the Plateau (``base_lr`` from the
    method, ``min_lr`` floor), and the same ``state_dict``."""
    jo = jax_optim.SGD(1e-3, momentum=0.9, plateau=jax_optim.Plateau(**kw))
    po = optim.SGD(1e-3, momentum=0.9, plateau=optim.Plateau(**kw))
    jseq, pseq = [], []
    for s in SCORES:
        jo.on_validation({"score": s})
        po.on_validation({"score": s})
        jseq.append(jo.lr_scale)
        pseq.append(po.lr_scale)
        assert po.lr_for_step(3, po.lr_scale) == pytest.approx(
            float(jo.lr_for_step(3, jo.lr_scale)))
    assert pseq == jseq and min(pseq) < 1.0
    assert po.state_dict() == jo.state_dict()
    fresh = optim.SGD(1e-3, plateau=optim.Plateau(**kw))
    fresh.load_state_dict(po.state_dict())
    assert fresh.state_dict() == po.state_dict()
    assert optim.Adam(1e-3).state_dict() == {} and optim.Adam().lr_scale == 1


def test_triggers_match_jax():
    states = [dict(epoch=e, iteration=i, epoch_finished=f, loss=l, score=s)
              for e, i, f, l, s in [(0, 0, False, float("inf"), None),
                                    (1, 4, True, 0.4, 0.3),
                                    (2, 6, False, 0.2, 0.6),
                                    (3, 9, True, 1.5, None)]]
    makers = [
        lambda m: m.Trigger.always(), lambda m: m.Trigger.every_epoch(),
        lambda m: m.Trigger.max_epoch(2), lambda m: m.Trigger.max_iteration(6),
        lambda m: m.Trigger.several_iteration(3),
        lambda m: m.Trigger.max_score(0.5), lambda m: m.Trigger.min_loss(0.4),
        lambda m: m.Trigger.or_(m.Trigger.max_score(0.5),
                                m.Trigger.max_epoch(3)),
        lambda m: m.Trigger.and_(m.Trigger.every_epoch(),
                                 m.Trigger.several_iteration(2))]
    for make in makers:
        jt, pt = make(jax_optim), make(optim)
        assert pt.name == jt.name
        for st in states:
            want = jt(jax_optim.TrainingState(**st))
            assert pt(optim.TrainingState(**st)) == want, (pt.name, st)


# -- grad_accum --------------------------------------------------------------

def test_grad_accum_matches_jax():
    """``grad_accum=2`` on a tiny DeepSpeech2 (two microbatches of 2,
    batch statistics chained through them) against the reference's step
    from the same weights: the loss and every parameter and statistic;
    a batch the microbatches do not divide is refused by name."""
    from analytics_zoo_tpu.models.deepspeech2 import DeepSpeech2 as JaxDS2
    from analytics_zoo_tpu.pipelines import deepspeech2 as jax_ds2
    from analytics_zoo_tpu_torch.models.deepspeech2 import DeepSpeech2
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion)
    from analytics_zoo_tpu_torch.utils.convert import (
        flax_variables_to_state_dict)

    module = JaxDS2(hidden=16, n_rnn_layers=1, rnn_engine="blocked")
    variables = jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 13))))
    model = DeepSpeech2(hidden=16, n_rnn_layers=1, rnn_engine="pallas",
                        device="cpu")
    model.load_state_dict(flax_variables_to_state_dict(variables, model))
    rng = np.random.RandomState(8)
    labels = rng.randint(1, 29, (4, 4)).astype(np.int32)
    batch = {"input": rng.randn(4, 16, 13).astype(np.float32),
             "labels": labels, "label_mask": np.ones((4, 4), np.float32)}
    jopt = jax_optim.SGD(1e-2, momentum=0.9)
    jstep = jax_train.make_train_step(module, jax_ds2.ds2_ctc_criterion(),
                                      jopt, grad_accum=2)
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.array, variables["params"]),
        model_state={"batch_stats": jax.tree_util.tree_map(
            jnp.array, variables["batch_stats"])},
        opt_state=jopt.tx.init(variables["params"]),
        rng=jax.random.PRNGKey(0))
    jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                       1.0)
    popt = optim.SGD(1e-2, momentum=0.9)
    step = train.make_train_step(model, ds2_ctc_criterion(), popt,
                                 grad_accum=2)
    state, metrics = step(train.create_train_state(model, popt), batch)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    got = state_dict_to_flax(model.state_dict(), variables)
    for coll, tree in (("params", jstate.params),
                       ("batch_stats", jstate.model_state["batch_stats"])):
        for k, v in flatten_params(tree).items():
            np.testing.assert_allclose(got[coll][k], np.asarray(v),
                                       atol=1e-5, err_msg=k)
    odd = dict(batch, input=batch["input"][:3], labels=labels[:3],
               label_mask=batch["label_mask"][:3])
    with pytest.raises(ValueError, match="not divisible by grad_accum=2"):
        step(state, odd)
    with pytest.raises(ValueError, match="batch-major"):
        step(state, dict(batch, lr=np.float32(1.0)))


# -- evaluation --------------------------------------------------------------

def _detections(seed, B=3, K=30, C=5):
    """Detection rows (cls, score, box) near seeded gts, with misses,
    duplicates and difficult gts."""
    rng = np.random.RandomState(seed)
    G = 6
    xy = rng.rand(B, G, 2) * 0.7
    gt = np.concatenate([xy, xy + rng.rand(B, G, 2) * 0.25 + 0.05], -1)
    labels = rng.randint(1, C, (B, G)).astype(np.int32)
    mask = (rng.rand(B, G) < 0.85).astype(np.float32)
    difficult = (rng.rand(B, G) < 0.2).astype(np.float32)
    src = rng.randint(0, G, (B, K))
    boxes = np.take_along_axis(gt, src[..., None], 1) + rng.randn(
        B, K, 4) * 0.03
    cls = np.where(rng.rand(B, K) < 0.8,
                   np.take_along_axis(labels, src, 1),
                   rng.randint(1, C, (B, K)))
    scores = np.round(rng.rand(B, K), 2)             # ties in the ranking
    cls = np.where(rng.rand(B, K) < 0.1, -1, cls)     # empty slots
    dets = np.concatenate([cls[..., None], scores[..., None], boxes],
                          -1).astype(np.float32)
    target = {"bboxes": gt.astype(np.float32), "labels": labels,
              "mask": mask, "difficult": difficult}
    return dets, {"target": target}


@pytest.mark.parametrize("method,kw", [
    ("MeanAveragePrecision", dict(use_07_metric=True)),
    ("MeanAveragePrecision", dict(use_07_metric=False)),
    ("CocoMeanAveragePrecision", {})])
def test_evaluation_matches_jax(method, kw):
    """VOC07 11-point, area-under-PR and COCO mAP of the same detections
    and gts, merged over two batches: the per-class APs and the result
    equal the reference's."""
    jm = getattr(jax_eval, method)(n_classes=5, **kw)
    pm = getattr(evaluation, method)(n_classes=5, **kw)
    jr = pr = None
    for seed in (0, 1):
        dets, batch = _detections(seed)
        a, b = jm(dets, batch), pm(dets, batch)
        jr = a if jr is None else jr + a
        pr = b if pr is None else pr + b
    assert pr.name == jr.name
    assert pr.result() == jr.result() and 0 < pr.result() < 1
    parts = ((p, j) for p, j in zip(pr.results, jr.results)) \
        if method.startswith("Coco") else [(pr, jr)]
    for p, j in parts:
        np.testing.assert_array_equal(p.ap_per_class(), j.ap_per_class())
    if method == "MeanAveragePrecision":
        assert (evaluation.PascalVocEvaluator("voc_2007_test").evaluate(pr)
                == jax_eval.PascalVocEvaluator("voc_2007_test").evaluate(jr))


def test_ssd_mean_average_precision_matches_jax():
    """The validation method on the same SSD300 (loc, conf) logits: the
    detections of the port's CPU path (softmax, DetectionOutput "auto")
    against the reference's, and the same mAP."""
    rng = np.random.RandomState(9)
    B, P = 2, PRIORS.shape[0]
    loc = (rng.randn(B, P, 4) * 0.2).astype(np.float32)
    conf = rng.randn(B, P, 21).astype(np.float32)
    conf[..., 0] += 2.0
    boxes, labels, mask = _gt(10)
    batch = {"target": {"bboxes": boxes, "labels": labels, "mask": mask}}
    pm = pipe.SSDMeanAveragePrecision()
    dets = pm.detect((T(loc), T(conf))).numpy()
    want = np.asarray(jax_detout(jnp.asarray(loc),
                                 jax.nn.softmax(jnp.asarray(conf), -1),
                                 PRIORS, VARIANCES, JaxDetParam()))
    np.testing.assert_array_equal(dets[..., 0], want[..., 0])
    np.testing.assert_allclose(dets[..., 1], want[..., 1], atol=1e-6)
    np.testing.assert_allclose(dets[..., 2:], want[..., 2:], atol=1e-5)
    jm = jax_pipe.SSDMeanAveragePrecision()
    assert pm.name == jm.name
    np.testing.assert_allclose(
        pm((T(loc), T(conf)), batch).result(),
        jm((jnp.asarray(loc), jnp.asarray(conf)), batch).result(),
        rtol=1e-6)
    with pytest.raises(ValueError, match="metric"):
        pipe.SSDMeanAveragePrecision(metric="f1")


# -- the Optimizer's validation ----------------------------------------------

class _Recorder(train.ValidationMethod):
    """Counts images and records whether the model was in eval mode."""

    name = "images"

    def __init__(self, model):
        self.model, self.modes = model, []

    def __call__(self, output, batch):
        self.modes.append(self.model.training)
        return train.ValidationResult(float(output.shape[0]), 1.0, self.name)


def test_optimizer_validates_at_triggers():
    """Validation after every second step and at each epoch's end, once
    an iteration: in eval mode, back in train mode for the next step; the
    score reaches ``loop.score`` (read by ``max_score``) and Plateau."""
    model = torch.nn.Linear(3, 2)
    rng = np.random.RandomState(11)
    data = [{"input": rng.randn(4, 3).astype(np.float32),
             "target": rng.randn(4, 2).astype(np.float32)}
            for _ in range(4)]
    rec = _Recorder(model)
    seen_train = []

    def criterion(out, batch):
        seen_train.append(model.training)
        return ((out - torch.as_tensor(batch["target"])) ** 2).mean()

    plateau = optim.Plateau(patience=0)
    opt = (train.Optimizer(model, data, criterion)
           .set_optim_method(optim.SGD(0.1, plateau=plateau))
           .set_validation(optim.Trigger.or_(
               optim.Trigger.several_iteration(2),
               optim.Trigger.every_epoch()), data[:2], [rec])
           .set_end_when(optim.Trigger.max_epoch(2)))
    opt.optimize()
    iters = [v["iteration"] for v in opt.val_history]
    assert iters == [2, 4, 6, 8]               # epoch ends at 4 and 8: once
    assert all(v["images"] == 4.0 for v in opt.val_history)
    assert rec.modes and not any(rec.modes) and all(seen_train)
    assert plateau.best == 4.0 and plateau.scale == 0.5 ** 3
    stop = (train.Optimizer(model, data, criterion)
            .set_validation(optim.Trigger.every_epoch(), data[:1], [rec])
            .set_end_when(optim.Trigger.or_(optim.Trigger.max_score(4.0),
                                            optim.Trigger.max_epoch(5))))
    stop.optimize()
    assert len(stop.history) == 4 and len(stop.val_history) == 1


# -- the slice as a whole ----------------------------------------------------

def _seeded_flax_params(jmod, seed=0):
    """numpy-seeded flax SSD300 params (shapes from ``eval_shape``)."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 300, 300, 3)))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "bias":
            v = rng.randn(*leaf.shape) * 0.01
        else:
            v = 20.0 + rng.randn(*leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


def _ssd_batch(seed, B=1, G=4, max_gt=6):
    rng = np.random.RandomState(seed)
    boxes, labels, mask = _gt(seed, B=B, G=max_gt, n_valid=(G,) * B)
    return {"input": (rng.rand(B, 300, 300, 3) * 255.0 - 120.0).astype(
        np.float32), "target": {"bboxes": boxes, "labels": labels,
                                "mask": mask}}


@functools.lru_cache(maxsize=None)
def _jax_ssd300_step():
    """The reference's SSD300 fp32 train step (SGD, momentum 0.9, weight
    decay 5e-4, lr 2.5e-4 times the step's ``lr_scale``, the update
    skipped above a loss of 50) and its seeded parameters, compiled once
    for the tests that use it."""
    jmod = jax_ssd.SSDVgg(num_classes=21, resolution=300)
    jopt = jax_optim.SGD(2.5e-4, momentum=0.9, weight_decay=5e-4)
    jstep = jax_train.make_train_step(
        jmod, jax_mbl.MultiBoxLoss(PRIORS, VARIANCES), jopt,
        skip_loss_above=50.0)
    return _seeded_flax_params(jmod), jopt, jstep


def _ssd300_steps_both(lr_scale, n_steps=2):
    """``n_steps`` fp32 train steps of SSD300 at batch 1 in both packages
    from bridged weights at lr ``2.5e-4 * lr_scale``: each step's (port,
    reference) loss, each parameter's relative L2 gap between the two
    packages after the steps, and how far the steps moved it."""
    params, jopt, jstep = _jax_ssd300_step()
    model = ssd.SSDVgg(21, 300, device="cpu", seed=1)
    model.load_state_dict(ssd_params_from_jax(params, model))
    batch = _ssd_batch(12)
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.array, params), model_state={},
        opt_state=jopt.tx.init(params), rng=jax.random.PRNGKey(0))
    popt = optim.SGD(2.5e-4 * lr_scale, momentum=0.9, weight_decay=5e-4)
    step = train.make_train_step(model, MultiBoxLoss(PRIORS, VARIANCES),
                                 popt, skip_loss_above=50.0)
    state = train.create_train_state(model, popt)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    losses = []
    for _ in range(n_steps):
        jstate, jm = jstep(jstate, jbatch, lr_scale)
        state, metrics = step(state, batch)
        losses.append((metrics["loss"].item(), float(jm["loss"])))
    got = state_dict_to_flax(model.state_dict(), {"params": params})["params"]
    start = flatten_params(params)
    final = flatten_params(jstate.params)
    errs = {k: _rel(got[k], v) for k, v in final.items()}
    moved = {k: _rel(v, start[k]) for k, v in final.items()}
    return losses, errs, moved


def test_ssd300_two_train_steps_match_jax():
    """Two fp32 ``make_train_step`` steps of SSD300 with ``MultiBoxLoss``
    and SGD (momentum 0.9, weight decay 5e-4, the update skipped above a
    loss of 50) from bridged weights at batch 1: the losses, and every
    parameter within 4e-5 relative L2 of the reference's (see the module
    docstring); the steps moved the parameters by more than that.

    Readings on the CPU: the largest gap 1.8e-5 (conv2_2's kernel), the
    median move 2.8e-4.  Planted in the port's SGD: momentum 0 reads
    6.0e-3 (conf_1's bias); weight decay 0 reads 1.76e-5 and does not
    separate at this lr (``test_optimizers_match_optax`` holds the update
    rules, weight decay included)."""
    losses, errs, moved = _ssd300_steps_both(1.0)
    np.testing.assert_allclose(*losses[0], rtol=1e-5)
    np.testing.assert_allclose(*losses[1], rtol=2e-4)
    assert max(errs.values()) <= 4e-5, errs
    assert np.median(list(moved.values())) > 1e-4


def test_ssd300_step_at_train_params_lr_overshoots_in_both():
    """At ``TrainParams``' lr of 0.0035, one SGD step from the bridged
    random weights sends the loss on the same batch from 22.7 to ~203 in
    the reference and in the port alike (so the loss-50 guard skips the
    second update in both): the jump belongs to the reference's lr at a
    random initialisation, not to the port.  The losses agree within
    1e-3 relative (measured 4.6e-4) and the parameters after the two
    steps within 1e-4 (measured 2.9e-5), while the step moved the median
    parameter by 1.4e-3."""
    scale = pipe.TrainParams().learning_rate / 2.5e-4
    assert scale == pytest.approx(14.0)
    losses, errs, moved = _ssd300_steps_both(scale)
    np.testing.assert_allclose(*losses[0], rtol=1e-5)
    np.testing.assert_allclose(*losses[1], rtol=1e-3)
    assert losses[0][1] < 30.0 and min(losses[1]) > 100.0
    assert max(errs.values()) <= 1e-4, errs
    assert np.median(list(moved.values())) > 1e-3


def test_train_ssd_validates_each_epoch_and_drives_plateau(monkeypatch):
    """``train_ssd`` on the CPU, fp32, 2 epochs of one SSD300 batch with a
    one-image ``val_set``: the SGD Optimizer validates after each epoch,
    its mAP becomes ``loop.score`` and reaches the Plateau; the arguments
    of later items are refused by name."""
    seen = []
    run = train.Optimizer.optimize

    def optimize(self):
        seen.append(self)
        return run(self)

    monkeypatch.setattr(train.Optimizer, "optimize", optimize)
    params = pipe.TrainParams(max_epoch=2, compute_dtype=None)
    batch = _ssd_batch(13)
    model = pipe.train_ssd([batch], [_ssd_batch(14)], params, device="cpu")
    assert not model.training
    (opt,) = seen
    assert [v["iteration"] for v in opt.val_history] == [1, 2]
    assert len(opt.history) == 2
    assert all(np.isfinite(m["loss"].item()) for m in opt.history)
    plateau = opt.optim.plateau
    assert plateau is not None and plateau.base_lr == params.learning_rate
    ref = optim.Plateau(monitor="score", factor=0.5, patience=10, mode="max",
                        min_lr=1e-5)
    for v in opt.val_history:
        ref.update(v["MeanAveragePrecision"])
    assert (plateau.best, plateau.num_bad, plateau.scale) == (
        ref.best, ref.num_bad, ref.scale) and ref.best is not None
    for kw, item in ((dict(mesh=object()), "item 12"),
                     (dict(tp="spatial"), "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            pipe.train_ssd([batch], None, params, model=model, **kw)
    for field, item in (("checkpoint_path", "item 12"),
                        ("log_dir", "item 13")):
        with pytest.raises(NotImplementedError, match=item):
            pipe.train_ssd([batch], None, dataclasses.replace(
                params, **{field: "/nowhere"}), model=model)


def test_validator_matches_validation_method():
    """``Validator.test`` over ``SSDPredictor.detect_normalized`` gives the
    mAP the validation method gives on the model's outputs."""
    model = ssd.SSDVgg(21, 300, device="cpu", seed=2)
    batches = [_ssd_batch(15), _ssd_batch(16)]
    val = pipe.Validator(model, pipe.PreProcessParam(batch_size=1),
                         device="cpu")
    got = val.test(batches)
    (want,) = train.validate(model, batches,
                             [pipe.SSDMeanAveragePrecision()])
    assert got.result() == want.result()
    assert got.npos.sum() == want.npos.sum() == 8
