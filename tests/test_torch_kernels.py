"""The port's CUDA kernels against their plain PyTorch versions.

Imports neither JAX nor the JAX package, so it runs on the GPU machine:

    python -m pytest tests/test_torch_kernels.py -q

The kernel tests need a CUDA device (the kernels have no CPU mode) and
skip without one; the build and wrapper checks run everywhere.
Tolerances: keep masks and classes EQUAL, scores within 1e-6, boxes
within 1e-5 (the kernel and the plain version run the same float ops;
only ``expf`` may round differently in the last bit).
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.models.ssd import build_priors, ssd300_config
from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_nms, pallas_rnn
from analytics_zoo_tpu_torch.ops.detection_output import (
    DetectionOutputParam, detection_output)
from analytics_zoo_tpu_torch.utils import cuda_build

torch.set_num_threads(2)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _planes(seed, C, K, kind):
    """Score-sorted (C,K) candidate planes: random rows, runs of identical
    boxes, short valid prefixes, or integer pixel boxes."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(C, K, 2)
    boxes = np.concatenate([xy, xy + rng.rand(C, K, 2) * 0.3 + 0.02], -1)
    if kind == "pixel":
        boxes = np.round(boxes * 60.0)
    if kind == "ties":
        boxes[:, 1::2] = boxes[:, 0::2]
    valid = np.ones((C, K), np.float32)
    if kind == "sparse":
        valid = (np.arange(K)[None] < rng.randint(0, K // 4, (C, 1))
                 ).astype(np.float32)
    boxes = boxes.astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(boxes[..., i]))
            for i in range(4)] + [torch.from_numpy(valid)]


def _detout_inputs(seed, P, C, regime, batch=2):
    rng = np.random.RandomState(seed)
    loc = (rng.randn(batch, P, 4) * 0.3).astype(np.float32)
    logits = rng.randn(batch, P, C).astype(np.float32)
    if regime != "dense":
        logits[..., 0] += 7.0
        hot = rng.rand(batch, P) < 0.05
        logits[..., 1:] += np.where(hot[..., None], 9.0, 0.0)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    conf = e / e.sum(-1, keepdims=True)
    if regime == "int8":
        conf = np.round(conf * 127.0) / 127.0
    return torch.from_numpy(loc), torch.from_numpy(conf.astype(np.float32))


def _assert_rows_match(got, want):
    got, want = got.cpu(), want.cpu()
    torch.testing.assert_close(got[..., 0], want[..., 0], rtol=0, atol=0)
    torch.testing.assert_close(got[..., 1], want[..., 1], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[..., 2:], want[..., 2:], rtol=0,
                               atol=1e-5)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_library_name_follows_the_source():
    a = cuda_build.library_path("nms_sweep")
    assert a == cuda_build.library_path("nms_sweep")
    assert a.parent == cuda_build.BUILD_DIR and a.name.startswith(
        "libnms_sweep-")
    assert a != cuda_build.library_path("detection_output")


def test_wrappers_refuse_other_devices():
    planes = [p.to("meta") for p in _planes(0, 2, 8, "random")]
    with pytest.raises(ValueError, match="no kernel"):
        pallas_nms.nms_sweep(*planes)
    loc, conf = (t.to("meta") for t in _detout_inputs(0, 16, 3, "dense"))
    pri = torch.zeros(16, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pallas_detout.fused_detection_output(loc, conf, pri, pri,
                                             param=DetectionOutputParam(3))


def test_fused_geometry_limit_is_named():
    """SSD300 and SSD512 fit one select block; a far larger prior set is
    refused by name before any launch."""
    assert pallas_detout.select_smem_bytes(24564, 400) <= \
        pallas_detout.SELECT_SMEM_BYTES
    assert pallas_detout.select_smem_bytes(60000, 400) > \
        pallas_detout.SELECT_SMEM_BYTES


@pytest.mark.parametrize("kind", ["random", "ties", "sparse", "pixel"])
def test_nms_sweep_kernel(kind):
    dev = _cuda()
    planes = [p.to(dev) for p in _planes(5, 160, 512, kind)]
    normalized = kind != "pixel"
    before = pallas_nms.nms_sweep.launches
    got = pallas_nms.nms_sweep(*planes, normalized=normalized)
    assert pallas_nms.nms_sweep.launches == before + 1
    want = pallas_nms.nms_sweep_plain(*planes, normalized=normalized)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_pallas_nms_wrapper_on_card():
    dev = _cuda()
    rng = np.random.RandomState(3)
    xy = rng.rand(300, 2)
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.rand(300, 2) * 0.3 + 0.02], 1).astype(np.float32))
    scores = torch.from_numpy(rng.rand(300).astype(np.float32))
    got = pallas_nms.pallas_nms(boxes.to(dev), scores.to(dev))
    want = pallas_nms.pallas_nms(boxes, scores)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("regime", ["dense", "trained", "int8"])
@pytest.mark.parametrize("extra", [{}, {"clip_boxes": True},
                                   {"background_id": 3},
                                   {"background_id": -1},
                                   {"keep_topk": 700}])
def test_fused_kernel_small(regime, extra):
    dev = _cuda()
    loc, conf = _detout_inputs(1, 300, 6, regime)
    rng = np.random.RandomState(2)
    cx = rng.rand(300, 2).astype(np.float32)
    wh = (rng.rand(300, 2) * 0.2 + 0.05).astype(np.float32)
    pri = torch.from_numpy(np.concatenate([cx - wh / 2, cx + wh / 2], 1))
    var = torch.tensor([0.1, 0.1, 0.2, 0.2]).expand(300, 4).contiguous()
    p = DetectionOutputParam(**{"n_classes": 6, "nms_topk": 64,
                                "keep_topk": 32, **extra})
    args = [t.to(dev) for t in (loc, conf, pri, var)]
    got = pallas_detout.fused_detection_output(*args, param=p)
    _assert_rows_match(got, pallas_detout.fused_detection_output_plain(
        *args, p))


@pytest.mark.parametrize("regime", ["dense", "int8"])
def test_fused_kernel_ssd300_and_backends_agree(regime):
    dev = _cuda()
    priors, variances = (torch.from_numpy(a).to(dev)
                         for a in build_priors(ssd300_config()))
    loc, conf = (t.to(dev) for t in _detout_inputs(4, 8732, 21, regime))
    p = DetectionOutputParam()
    got = pallas_detout.fused_detection_output(loc, conf, priors, variances,
                                               param=p)
    want = pallas_detout.fused_detection_output_plain(loc, conf, priors,
                                                      variances, p)
    _assert_rows_match(got, want)
    for backend in ("pallas", "xla", "auto"):
        out = detection_output(loc, conf, priors, variances,
                               DetectionOutputParam(backend=backend))
        _assert_rows_match(out, want)


# -- K3: the persistent-RNN forward ---------------------------------------
# Tolerances: the kernel sums each product in another order than
# torch.matmul, and the difference compounds along the recurrence, so the
# test holds the largest absolute error to 1e-4 of the output's largest
# magnitude in fp32 and 2e-2 with bf16 weights (h is rounded to bf16 before
# each product, on both sides, so a rounding flip moves a value by one
# bf16 ulp).

RNN_CASES = [
    # cell, activation, B, T, H
    ("vanilla", "relu", 4, 40, 96),
    ("vanilla", "clipped_relu", 8, 64, 300),
    ("vanilla", "tanh", 3, 11, 6),
    ("vanilla", "clipped_relu", 10, 24, 140),      # two passes of 8 rows
    ("gru", "relu", 5, 48, 160),
    ("lstm", "relu", 5, 48, 160),
]


def _rnn_inputs(seed, cell, B, T, H, masked, wdtype=torch.float32):
    rng = np.random.RandomState(seed)
    k = pallas_rnn.CELL_GATES[cell]
    C = pallas_rnn.CELL_CARRY[cell]
    pre = torch.from_numpy(rng.randn(B, T, k * H).astype(np.float32) * 0.5)
    w = torch.from_numpy((rng.randn(H, k * H) / np.sqrt(H))
                         .astype(np.float32)).to(wdtype)
    b = torch.from_numpy(rng.randn(k * H).astype(np.float32) * 0.1)
    h0 = torch.from_numpy(rng.randn(C, B, H).astype(np.float32) * 0.3)
    n = (torch.from_numpy(rng.randint(0, T + 3, B).astype(np.int32))
         if masked else None)
    return pre, w, b, h0, n


def _rel_err(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-6)
            ).item()


def test_rnn_fit_check_names_the_limit():
    pallas_rnn.check_hopper_fit(1760, "vanilla")
    pallas_rnn.check_hopper_fit(1760, "lstm")
    with pytest.raises(ValueError, match="shared memory"):
        pallas_rnn.check_hopper_fit(9000, "vanilla")
    with pytest.raises(ValueError, match="threads"):
        pallas_rnn.check_hopper_fit(9000, "lstm")


def test_rnn_refuses_autograd_and_other_devices():
    pre, w, b, h0, _ = _rnn_inputs(0, "vanilla", 2, 3, 4, False)
    with pytest.raises(NotImplementedError, match="K4"):
        pallas_rnn.persistent_rnn(pre, w.requires_grad_(), b, h0)
    meta = [t.detach().to("meta") for t in (pre, w, b, h0)]
    with pytest.raises(ValueError, match="no kernel"):
        pallas_rnn.persistent_rnn(*meta)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cell,act,B,T,H", RNN_CASES)
def test_persistent_rnn_kernel(cell, act, B, T, H, masked):
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [t.to(dev) if t is not None else None
            for t in _rnn_inputs(7, cell, B, T, H, masked)]
    before = pallas_rnn.persistent_rnn.launches
    ys, cf = pallas_rnn.persistent_rnn(*args, cell=cell, activation=act)
    torch.cuda.synchronize()
    assert pallas_rnn.persistent_rnn.launches == before + 1
    n = (args[4] if masked else torch.full((B,), T, device=dev)).clamp(0, T)
    want_ys, want_cf = pallas_rnn.persistent_rnn_plain(
        pallas_rnn.RnnKernelConfig(cell, act), *args[:4], n.int())
    assert _rel_err(ys, want_ys) <= 1e-4
    assert _rel_err(cf, want_cf) <= 1e-4
    if masked:                       # masked steps emit exactly 0
        t_idx = torch.arange(T, device=dev)
        pad = t_idx[None, :] >= n[:, None]
        assert (ys[pad] == 0).all()


@pytest.mark.parametrize("cell", ["vanilla", "gru"])
def test_persistent_rnn_kernel_bf16_weights(cell):
    dev = _cuda()
    args = [t.to(dev) for t in _rnn_inputs(
        9, cell, 8, 50, 256, False, torch.bfloat16)[:4]]
    act = "clipped_relu"
    ys, cf = pallas_rnn.persistent_rnn(*args, cell=cell, activation=act)
    n = torch.full((8,), 50, dtype=torch.int32, device=dev)
    want_ys, want_cf = pallas_rnn.persistent_rnn_plain(
        pallas_rnn.RnnKernelConfig(cell, act), *args, n)
    assert _rel_err(ys, want_ys) <= 2e-2
    assert _rel_err(cf, want_cf) <= 2e-2


def test_ds2_forward_pallas_matches_blocked():
    """The DS2 forward through K3 against the blocked loop on the card,
    padded and with ragged ``n_frames``: log-probs within 1e-3 (two
    summation orders through three BiRNN layers)."""
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import make_ds2_model

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(np.random.RandomState(4).randn(4, 300, 13)
                         .astype(np.float32)).to(dev)
    n = torch.tensor([300, 211, 97, 4], device=dev)
    pallas = make_ds2_model(hidden=256, seed=3, rnn_engine="pallas",
                            device=dev)
    blocked = make_ds2_model(hidden=256, seed=3, rnn_engine="blocked",
                             device=dev)
    with torch.inference_mode():
        for kw in ({}, {"n_frames": n}):
            before = pallas_rnn.persistent_rnn.launches
            got = pallas(x, **kw)
            assert pallas_rnn.persistent_rnn.launches == before + 6
            want = blocked(x, **kw)
            assert (got - want).abs().max().item() <= 1e-3
