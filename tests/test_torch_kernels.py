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
from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_nms
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
