"""Parity of the PyTorch port's NMS and DetectionOutput with the JAX
package, on the CPU.

The JAX side runs as its own tests run it here: the Pallas kernels in
interpret mode, the rest on XLA:CPU.  The port runs its plain PyTorch
versions (what a kernel wrapper does with a CPU tensor).  Inputs come
from numpy with a seed and go to both packages.

Tolerances: classes and keep masks must be EQUAL (tie order included);
scores within 1e-6 and boxes within 1e-5 absolute — the decode runs the
same float ops in the same order, but XLA:CPU may fuse multiply-adds and
its ``exp`` rounds differently from PyTorch's in the last bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import nms as jax_nms
from analytics_zoo_tpu.ops.detection_output import (
    DetectionOutputParam as JaxParam, detection_output as jax_detout,
    detection_output_single as jax_single)
from analytics_zoo_tpu.ops.pallas_detout import (
    fused_detection_output as jax_fused)
from analytics_zoo_tpu.ops.pallas_nms import (
    nms_sweep as jax_sweep, pallas_nms as jax_pallas_nms)
from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_nms
from analytics_zoo_tpu_torch.ops.detection_output import (
    DetectionOutputParam, detection_output, detection_output_single)
from analytics_zoo_tpu_torch.ops.nms import nms

torch.set_num_threads(2)

T = torch.from_numpy


def _random_boxes(n, seed, pixel=False):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2)
    wh = rng.rand(n, 2) * 0.3 + 0.02
    boxes = np.concatenate([xy, xy + wh], axis=1)
    if pixel:
        boxes = np.round(boxes * 60.0)
    return boxes.astype(np.float32), rng.rand(n).astype(np.float32)


def _inputs(seed, batch=2, priors_n=160, classes=6, bg_bias=0.0,
            hot_frac=0.0, per_class_hot=None):
    """The cases of tests/test_pallas_detout.py, in numpy."""
    rng = np.random.RandomState(seed)
    cx = rng.rand(priors_n, 2).astype(np.float32)
    wh = (rng.rand(priors_n, 2) * 0.2 + 0.05).astype(np.float32)
    priors = np.concatenate([cx - wh / 2, cx + wh / 2], 1)
    variances = np.tile(np.asarray([0.1, 0.1, 0.2, 0.2], np.float32),
                        (priors_n, 1))
    rng = np.random.RandomState(seed)
    loc = (rng.randn(batch, priors_n, 4) * 0.1).astype(np.float32)
    logits = rng.randn(batch, priors_n, classes).astype(np.float32)
    logits[..., 0] += bg_bias
    if hot_frac:
        hot = rng.rand(batch, priors_n) < hot_frac
        logits[..., 1:] += np.where(hot[..., None], 9.0, 0.0)
    if per_class_hot is not None:
        for j, frac in enumerate(per_class_hot, start=1):
            hot = rng.rand(batch, priors_n) < frac
            logits[..., j] += np.where(hot, 9.0, 0.0)
    conf = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    return loc, conf, priors, variances


def _assert_rows_match(got, ref):
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])     # classes
    np.testing.assert_allclose(got[..., 1], ref[..., 1], atol=1e-6)
    np.testing.assert_allclose(got[..., 2:], ref[..., 2:], atol=1e-5)


BASE = dict(n_classes=6, nms_topk=64, keep_topk=32)

CASES = {
    "trained_like_0": (dict(seed=0, bg_bias=7.0, hot_frac=0.05), {}),
    "trained_like_7": (dict(seed=7, bg_bias=7.0, hot_frac=0.05), {}),
    "dense_0": (dict(seed=0), {}),
    "dense_3": (dict(seed=3), {}),
    "ragged": (dict(seed=11, bg_bias=6.0,
                    per_class_hot=[0.5, 0.1, 0.02, 0.002, 0.0]), {}),
    "all_background": (dict(seed=5, bg_bias=20.0), {}),
    "int8_ties": (dict(seed=2, bg_bias=5.0, hot_frac=0.08, quantize=True), {}),
    "clip": (dict(seed=4, bg_bias=4.0, hot_frac=0.1), dict(clip_boxes=True)),
    "background_3": (dict(seed=6, hot_frac=0.05), dict(background_id=3)),
    "keep_beyond_kept": (dict(seed=9, bg_bias=8.0, hot_frac=0.01),
                         dict(keep_topk=120)),
}


def _case(name):
    spec, extra = CASES[name]
    spec = dict(spec)
    quantize = spec.pop("quantize", False)
    loc, conf, priors, variances = _inputs(**spec)
    if quantize:
        conf = (np.round(conf * 127.0) / 127.0).astype(np.float32)
    kw = {**BASE, **extra}
    return loc, conf, priors, variances, kw


class TestNms:
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("variant", ["plain", "eta", "pixel", "mask"])
    def test_nms_matches_jax(self, seed, variant):
        boxes, scores = _random_boxes(120, seed, pixel=variant == "pixel")
        kw = dict(iou_threshold=0.5, max_output=50, pre_topk=100,
                  score_threshold=0.05)
        if variant == "eta":
            kw.update(iou_threshold=0.7, eta=0.9)
        if variant == "pixel":
            kw.update(normalized=False)
        mask = None
        if variant == "mask":
            mask = (np.random.RandomState(seed + 50).rand(120) < 0.7
                    ).astype(np.float32)
        ref_idx, ref_mask = jax_nms(
            jnp.asarray(boxes), jnp.asarray(scores),
            valid_mask=None if mask is None else jnp.asarray(mask), **kw)
        got_idx, got_mask = nms(T(boxes), T(scores),
                                valid_mask=None if mask is None else T(mask),
                                **kw)
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))


class TestNmsSweep:
    """K1's plain version against the Pallas kernel in interpret mode."""

    def _planes(self, seed, C=6, K=128, ties=False, sparse=False,
                pixel=False):
        rng = np.random.RandomState(seed)
        rows = []
        for _ in range(C):
            boxes, scores = _random_boxes(K, int(rng.randint(1 << 30)),
                                          pixel=pixel)
            if ties:        # several identical boxes in a row
                boxes[1::4] = boxes[0::4][:boxes[1::4].shape[0]]
            order = np.argsort(-scores, kind="stable")
            rows.append(boxes[order])
        b = np.stack(rows)                                   # (C,K,4)
        valid = np.ones((C, K), np.float32)
        if sparse:
            valid = (np.arange(K)[None] < rng.randint(0, K // 4, (C, 1))
                     ).astype(np.float32)
        return [np.ascontiguousarray(b[..., i]) for i in range(4)] + [valid]

    @pytest.mark.parametrize("kind", ["random", "ties", "sparse", "pixel"])
    def test_plain_matches_interpret_kernel(self, kind):
        planes = self._planes(3, ties=kind == "ties",
                              sparse=kind == "sparse", pixel=kind == "pixel")
        normalized = kind != "pixel"
        ref = np.asarray(jax_sweep(*(jnp.asarray(p) for p in planes),
                                   iou_threshold=0.45, normalized=normalized,
                                   interpret=True))
        got = pallas_nms.nms_sweep(*(T(p) for p in planes),
                                   iou_threshold=0.45, normalized=normalized)
        np.testing.assert_array_equal(got.numpy(), ref)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_pallas_nms_wrapper_matches_jax(self, seed):
        boxes, scores = _random_boxes(100, seed)
        kw = dict(iou_threshold=0.5, max_output=50, pre_topk=100)
        ref_idx, ref_mask = jax_pallas_nms(jnp.asarray(boxes),
                                           jnp.asarray(scores),
                                           interpret=True, **kw)
        got_idx, got_mask = pallas_nms.pallas_nms(T(boxes), T(scores), **kw)
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))

    def test_cpu_run_counts_no_launch(self):
        before = pallas_nms.nms_sweep.launches
        pallas_nms.nms_sweep(*(T(p) for p in self._planes(0, C=2, K=16)))
        assert pallas_nms.nms_sweep.launches == before


class TestFusedDetectionOutput:
    """K2's plain version against the Pallas kernel in interpret mode AND
    against the reference semantics ``detection_output_single``."""

    @pytest.mark.parametrize("name", sorted(CASES))
    def test_plain_matches_jax(self, name):
        loc, conf, priors, variances, kw = _case(name)
        jp = JaxParam(**kw)
        ref_fused = np.asarray(jax_fused(
            jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors),
            jnp.asarray(variances), param=jp, interpret=True))
        ref_single = np.asarray(jax.vmap(
            lambda l, c: jax_single(l, c, jnp.asarray(priors),
                                    jnp.asarray(variances), jp))(
            jnp.asarray(loc), jnp.asarray(conf)))
        got = pallas_detout.fused_detection_output(
            T(loc), T(conf), T(priors), T(variances),
            param=DetectionOutputParam(**kw)).numpy()
        _assert_rows_match(got, ref_fused)
        _assert_rows_match(got, ref_single)
        if name == "all_background":
            assert (got[..., 0] == -1).all() and (got[..., 1:] == 0).all()
        if name == "keep_beyond_kept":
            assert (got[..., 1] > 0).sum() < got.shape[0] * 120

    def test_background_outside_classes(self):
        """``background_id=-1``: every class is foreground.  The port maps
        rows through the foreground id list on every backend, so its
        fused path matches the reference semantics (the JAX fused kernel
        shifts such rows by one class; see ROADMAP.md, Queue 3)."""
        loc, conf, priors, variances, kw = _case("trained_like_0")
        kw = dict(kw, background_id=-1)
        ref = np.asarray(jax_detout(
            jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors),
            jnp.asarray(variances), JaxParam(**kw, backend="xla")))
        got = pallas_detout.fused_detection_output(
            T(loc), T(conf), T(priors), T(variances),
            param=DetectionOutputParam(**kw)).numpy()
        _assert_rows_match(got, ref)
        assert (got[..., 0] == 0).any()

    @pytest.mark.parametrize("name", ["trained_like_0", "int8_ties",
                                      "background_3", "clip"])
    def test_port_backends_agree(self, name):
        """xla == pallas == fused inside the port, and each against the
        JAX package's backend of the same name."""
        loc, conf, priors, variances, kw = _case(name)
        outs = {}
        for backend in ("xla", "pallas", "fused"):
            outs[backend] = detection_output(
                T(loc), T(conf), T(priors), T(variances),
                DetectionOutputParam(**kw, backend=backend)).numpy()
            ref = np.asarray(jax_detout(
                jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors),
                jnp.asarray(variances), JaxParam(**kw, backend=backend)))
            _assert_rows_match(outs[backend], ref)
        _assert_rows_match(outs["pallas"], outs["xla"])
        _assert_rows_match(outs["fused"], outs["xla"])

    def test_single_image_matches_jax(self):
        loc, conf, priors, variances, kw = _case("trained_like_7")
        ref = np.asarray(jax_single(jnp.asarray(loc[0]), jnp.asarray(conf[0]),
                                    jnp.asarray(priors),
                                    jnp.asarray(variances), JaxParam(**kw)))
        got = detection_output_single(T(loc[0]), T(conf[0]), T(priors),
                                      T(variances),
                                      DetectionOutputParam(**kw)).numpy()
        _assert_rows_match(got, ref)


class TestStages:
    """K2's profile stages: the plain probes against the JAX kernel's
    ``stage="decode"|"select"`` programs in interpret mode.  The JAX
    kernel sums in float32 over its padded lanes (they decode to 0), the
    port in float64: relative tolerance 1e-5 (two float32 sums of 2 × 160
    boxes and the kept scores)."""

    @pytest.mark.parametrize("stage", ["decode", "select"])
    @pytest.mark.parametrize("name", ["trained_like_0", "dense_0",
                                      "all_background", "clip"])
    def test_probe_matches_jax(self, name, stage):
        loc, conf, priors, variances, kw = _case(name)
        if name == "clip":
            # boxes past the image, so the clip changes the sums
            loc = loc * 20.0
        ref = np.asarray(jax_fused(
            jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors),
            jnp.asarray(variances), param=JaxParam(**kw), interpret=True,
            stage=stage))
        got = pallas_detout.fused_detection_output(
            T(loc), T(conf), T(priors), T(variances),
            param=DetectionOutputParam(**kw), stage=stage).numpy()
        assert got.shape == ref.shape == (2, kw["keep_topk"], 6)
        # one value an image, in every entry of its block
        assert (got == got[:, :1, :1]).all()
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        if name == "clip":
            unclipped = pallas_detout.fused_detection_output(
                T(loc), T(conf), T(priors), T(variances),
                param=DetectionOutputParam(**dict(kw, clip_boxes=False)),
                stage=stage).numpy()
            assert not np.allclose(unclipped, got, rtol=1e-3)
        if name == "all_background" and stage == "select":
            # nothing kept: "select"'s probe is "decode"'s
            dec = pallas_detout.fused_detection_output(
                T(loc), T(conf), T(priors), T(variances),
                param=DetectionOutputParam(**kw), stage="decode").numpy()
            np.testing.assert_array_equal(got, dec)

    def test_full_stage_is_the_default_and_unknown_stage_raises(self):
        loc, conf, priors, variances, kw = _case("trained_like_7")
        args = (T(loc), T(conf), T(priors), T(variances))
        param = DetectionOutputParam(**kw)
        np.testing.assert_array_equal(
            pallas_detout.fused_detection_output(*args, param=param,
                                                 stage="full").numpy(),
            pallas_detout.fused_detection_output(*args, param=param).numpy())
        for fn in (lambda: pallas_detout.fused_detection_output(
                       *args, param=param, stage="merge"),
                   lambda: pallas_detout.fused_detection_output_plain(
                       *args, param, stage="merge")):
            with pytest.raises(ValueError, match="stage must be one of"):
                fn()


class TestDispatch:
    def test_auto_is_plain_on_cpu_fused_on_cuda(self):
        from analytics_zoo_tpu_torch.ops.detection_output import (
            resolve_backend)
        p = DetectionOutputParam()
        assert resolve_backend(p, torch.device("cpu")) == "xla"
        assert resolve_backend(p, torch.device("cuda")) == "fused"
        for b in ("xla", "pallas", "fused"):
            q = dataclasses.replace(p, backend=b)
            assert resolve_backend(q, torch.device("cuda")) == b

    def test_auto_on_cpu_tensors_matches_xla(self):
        loc, conf, priors, variances, kw = _case("ragged")
        auto = detection_output(T(loc), T(conf), T(priors), T(variances),
                                DetectionOutputParam(**kw)).numpy()
        xla = detection_output(T(loc), T(conf), T(priors), T(variances),
                               DetectionOutputParam(**kw, backend="xla"))
        np.testing.assert_array_equal(auto, xla.numpy())

    def test_fused_over_limit_warns_and_falls_back(self):
        """60000 priors: K2's select block cannot hold the row, so
        ``"fused"`` (what ``"auto"`` resolves to on the card) warns as the
        reference does and runs the unfused path, whose output equals the
        reference's ``detection_output``."""
        loc, conf, priors, variances = _inputs(seed=8, batch=1,
                                               priors_n=60000, classes=4,
                                               bg_bias=4.0, hot_frac=0.01)
        kw = dict(n_classes=4, nms_topk=64, keep_topk=32)
        assert pallas_detout.select_tile(60000, 64) is None
        with pytest.warns(UserWarning, match=r"P=60000.*falling back to "
                          r"the unfused pallas path"):
            got = detection_output(T(loc), T(conf), T(priors), T(variances),
                                   DetectionOutputParam(**kw,
                                                        backend="fused"))
        want = jax_detout(loc, conf, priors, variances,
                          JaxParam(**kw, backend="xla"))
        assert int((got[..., 1] > 0).sum()) > 0
        _assert_rows_match(got.numpy(), np.asarray(want))

    def test_approx_topk_raises(self):
        """``approx_topk`` runs (the port's exact stable top-k meets any
        recall target; parity in test_torch_serving.py) and raises only
        on a recall target outside (0, 1]."""
        loc, conf, priors, variances, kw = _case("dense_0")
        for recall in (0.0, 1.5):
            with pytest.raises(ValueError, match="approx_recall"):
                detection_output(T(loc), T(conf), T(priors), T(variances),
                                 DetectionOutputParam(**kw, approx_topk=True,
                                                      approx_recall=recall))
        got = detection_output(T(loc), T(conf), T(priors), T(variances),
                               DetectionOutputParam(**kw, approx_topk=True,
                                                    backend="pallas"))
        want = detection_output(T(loc), T(conf), T(priors), T(variances),
                                DetectionOutputParam(**kw, backend="pallas"))
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_unknown_backend_raises(self):
        loc, conf, priors, variances, kw = _case("dense_0")
        with pytest.raises(ValueError, match="backend"):
            detection_output(T(loc), T(conf), T(priors), T(variances),
                             DetectionOutputParam(**kw, backend="tpu"))

    def test_numpy_inputs_without_device_need_a_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        loc, conf, priors, variances, kw = _case("dense_0")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            detection_output(loc, conf, priors, variances,
                             DetectionOutputParam(**kw))
        out = detection_output(loc, conf, priors, variances,
                               DetectionOutputParam(**kw), device="cpu")
        assert out.shape == (2, 32, 6)
