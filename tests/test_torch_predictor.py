"""The SSD300 serving slice end to end: the port's ``SSDPredictor``
against the JAX package's on the same uint8 batch, ``im_info`` and
weights, on the CPU.

The fixture serves with ``conf_thresh=0.4``.  On these seeded weights
that leaves ~30 candidates an image whose scores are at least 7e-5 apart
and at least 6e-4 from the threshold; the forward's own disagreement
moves a score by under 1e-5 (``SCORE_TOL``), so the candidate sets and
every ordering are the same on both sides and the rows must match one
for one.  The test asserts that separation before it compares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core.module import Model
from analytics_zoo_tpu.models import ssd as jax_ssd
from analytics_zoo_tpu.ops.detection_output import (
    DetectionOutputParam as JaxParam, detection_output as jax_detout,
    scale_detections as jax_scale)
from analytics_zoo_tpu.pipelines.ssd import (
    PreProcessParam as JaxPreProcessParam, SSDPredictor as JaxPredictor)
from analytics_zoo_tpu_torch.models import ssd
from analytics_zoo_tpu_torch.ops.detection_output import (
    DetectionOutputParam, detection_output, scale_detections)
from analytics_zoo_tpu_torch.parallel.train import make_eval_step
from analytics_zoo_tpu_torch.pipelines.ssd import (
    PreProcessParam, SSDPredictor, run_serving_loop)
from analytics_zoo_tpu_torch.utils.convert import ssd_params_from_jax
from test_torch_ssd import seeded_flax_params

torch.set_num_threads(2)

POST = dict(n_classes=21, conf_thresh=0.4)
# the forward's float disagreement, as a bound on a softmax score
SCORE_TOL = 1e-5
# box tolerance in original pixels: loc deltas agree to ~1e-5, scaled by
# a 0.1-0.2 variance, a prior size ≤ 1 and images ≤ 500 px wide
BOX_TOL_PX = 1e-3


@pytest.fixture(scope="module")
def served():
    jmod = jax_ssd.SSDVgg(num_classes=21, resolution=300)
    variables = {"params": seeded_flax_params(jmod, 300)}
    tmod = ssd.SSDVgg(21, 300, device="cpu")
    tmod.load_state_dict(ssd_params_from_jax(variables["params"], tmod))
    rng = np.random.RandomState(1)
    batch = {
        "input": rng.randint(0, 256, (2, 300, 300, 3)).astype(np.uint8),
        # (h, w, scale_h, scale_w): originals 375x500 and 300x300
        "im_info": np.asarray([[300, 300, 0.8, 0.6], [300, 300, 1.0, 1.0]],
                              np.float32),
    }
    return jmod, variables, tmod, batch


def _jax_forward(jmod, variables, batch):
    x = batch["input"].astype(np.float32) - np.float32([104, 117, 123])
    loc, conf = jmod.apply(variables, jnp.asarray(x))
    return np.array(loc), np.array(jax.nn.softmax(conf, axis=-1))


def _assert_rows_match(got, ref, box_atol):
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_allclose(got[..., 1], ref[..., 1], rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(got[..., 2:], ref[..., 2:], rtol=0,
                               atol=box_atol)


def test_fixture_scores_are_separated(served):
    jmod, variables, _, batch = served
    _, probs = _jax_forward(jmod, variables, batch)
    fg = probs[..., 1:]
    for b in range(fg.shape[0]):
        cand = np.sort(fg[b][fg[b] > POST["conf_thresh"]])
        assert 5 <= cand.size <= 200
        assert np.diff(cand).min() > 2 * SCORE_TOL
        assert np.abs(fg[b] - POST["conf_thresh"]).min() > 2 * SCORE_TOL


def test_detect_batch_matches_jax_predictor(served):
    jmod, variables, tmod, batch = served
    ref = JaxPredictor(Model(jmod, variables), JaxPreProcessParam(),
                       post=JaxParam(**POST)).detect_batch(dict(batch))
    port = SSDPredictor(tmod, PreProcessParam(),
                        post=DetectionOutputParam(**POST), device="cpu")
    got = port.detect_batch(dict(batch))
    assert got.shape == ref.shape == (2, 200, 6)
    assert (got[..., 1] > 0).sum() > 10
    _assert_rows_match(got, ref, BOX_TOL_PX)


def test_port_tail_on_jax_forward_matches_exactly(served):
    """The JAX forward's (loc, probs) through the port's tail: same
    inputs, so classes and scores must be equal and boxes equal up to
    the decode's last-bit rounding."""
    jmod, variables, _, batch = served
    loc, probs = _jax_forward(jmod, variables, batch)
    priors, variances = jax_ssd.build_priors(jax_ssd.ssd300_config())
    info = batch["im_info"]
    h, w = info[:, 0] / info[:, 2], info[:, 1] / info[:, 3]
    ref = np.asarray(jax_scale(jax_detout(
        jnp.asarray(loc), jnp.asarray(probs), priors, variances,
        JaxParam(**POST)), h, w))
    for backend in ("xla", "pallas", "fused"):
        got = scale_detections(detection_output(
            torch.from_numpy(loc), torch.from_numpy(probs),
            torch.from_numpy(priors), torch.from_numpy(variances),
            DetectionOutputParam(**POST, backend=backend)),
            torch.from_numpy(h), torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(got[..., :2], ref[..., :2])
        np.testing.assert_allclose(got[..., 2:], ref[..., 2:], rtol=0,
                                   atol=1e-4)


def test_set_top_k_is_copy_on_write(served):
    _, _, tmod, batch = served
    base = SSDPredictor(tmod, PreProcessParam(),
                        post=DetectionOutputParam(**POST), device="cpu")
    low = base.set_top_k(5)
    assert base.post.keep_topk == 200 and low.post.keep_topk == 5
    assert low.model is base.model
    full = base.detect_batch(dict(batch))
    cut = low.detect_batch(dict(batch))
    assert cut.shape == (2, 5, 6)
    np.testing.assert_array_equal(cut, full[:, :5])


def test_serving_loop_and_normalized_path(served):
    _, _, tmod, batch = served
    port = SSDPredictor(tmod, PreProcessParam(),
                        post=DetectionOutputParam(**POST), device="cpu")
    padded = dict(batch, n_valid=1)
    out = run_serving_loop([dict(batch), padded], port._detect_device,
                           lambda t: t.numpy(), max_inflight=2)
    assert len(out) == 3
    np.testing.assert_array_equal(out[2], out[0])
    # normalized boxes: the rescale to the original sizes (375x500 and
    # 300x300) is the only difference
    norm = port.detect_normalized(batch["input"]).numpy()
    np.testing.assert_array_equal(norm[..., :2], np.stack(out[:2])[..., :2])
    for b, (h, w) in enumerate([(375.0, 500.0), (300.0, 300.0)]):
        np.testing.assert_allclose(norm[b][:, 2::2] * w, out[b][:, 2::2],
                                   rtol=1e-6)
        np.testing.assert_allclose(norm[b][:, 3::2] * h, out[b][:, 3::2],
                                   rtol=1e-6)


def test_bf16_eval_step_returns_fp32(served):
    _, _, tmod, batch = served
    x = torch.from_numpy(batch["input"][:1].astype(np.float32) - 110.0)
    loc, conf = make_eval_step(tmod, compute_dtype="bf16")(x)
    ref_loc, ref_conf = make_eval_step(tmod)(x)
    assert loc.dtype == conf.dtype == torch.float32
    # bf16 keeps 8 bits of mantissa through 23 conv layers
    scale = ref_conf.abs().max()
    assert (conf - ref_conf).abs().max() < 0.1 * scale


def test_device_policy(monkeypatch, served):
    _, _, tmod, _ = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSDPredictor(tmod, PreProcessParam())
    port = SSDPredictor(tmod, PreProcessParam(), device="cpu")
    assert port.post.backend == "auto" and port.device.type == "cpu"
