"""The port's CUDA kernels against their plain PyTorch versions.

Imports neither JAX nor the JAX package, so it runs on the GPU machine:

    python -m pytest tests/test_torch_kernels.py -q

The kernel tests need a CUDA device (the kernels have no CPU mode) and
skip without one; the build and wrapper checks run everywhere.
Tolerances: keep masks and classes EQUAL, scores within 1e-6, boxes
within 1e-5 (the kernel and the plain version run the same float ops;
only ``expf`` may round differently in the last bit).
"""

import dataclasses

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
    """SSD300 and SSD512 fit one select block at nms_topk 400 (and SSD512
    at 1000) with the engine's largest tile; a far larger prior set is
    refused by name before any launch."""
    for P, k in ((8732, 400), (24564, 400), (24564, 1000)):
        assert pallas_detout.select_tile(P, k) == 512
        assert pallas_detout.select_smem_bytes(P, k) <= \
            pallas_detout.SELECT_SMEM_BYTES
    assert pallas_detout.select_tile(60000, 400) is None
    assert pallas_detout.select_smem_bytes(60000, 400) > \
        pallas_detout.SELECT_SMEM_BYTES


@pytest.mark.parametrize("n_priors", [1, 40, 997, 8732, 24564, 41000,
                                      57000])
def test_select_limit_not_narrowed(n_priors):
    """Every (P, nms_topk) the first select design took (4 bytes a prior
    and 25 a candidate within 227 KB less 1 KB) still finds a tile."""
    k_max = (232448 - 1024 - 4 * n_priors) // 25
    for k in sorted({1, 2, 31, 33, 400, 1000, k_max // 2, k_max}):
        if 1 <= k <= k_max:
            assert pallas_detout.select_tile(n_priors, k) is not None, k


def test_sweep_limit_not_lowered():
    """K1 still takes rows of MAX_SWEEP_K = 227 KB / 17 bytes, its first
    design's limit, in tiles that fit; the SSD shape takes one tile."""
    assert pallas_nms.MAX_SWEEP_K == 232448 // 17
    assert pallas_nms.sweep_tile(512) == 512
    assert pallas_nms.sweep_tile(1536) == 512
    for K in (pallas_nms.MAX_SWEEP_K, 13000, 9000, 4096):
        t = pallas_nms.sweep_tile(K)
        assert t is not None and pallas_nms.sweep_smem_bytes(K, t) <= \
            pallas_nms.SWEEP_SMEM_BYTES
    assert pallas_nms.sweep_tile(15000) is None


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


def test_phase_stamps_split():
    """The stamp slots the kernels write (K2's select 0-8, its merge 9-13)
    fit the buffer, and a split is the difference of neighbouring slots
    in µs."""
    assert pallas_detout.MERGE_STAMPS == len(pallas_detout.SELECT_PHASES) + 1
    assert pallas_detout.MERGE_STAMPS + len(pallas_detout.MERGE_PHASES) + 1 \
        <= pallas_nms.STAMP_SLOTS
    assert len(pallas_nms.SWEEP_PHASES) + 1 <= pallas_nms.STAMP_SLOTS
    stamps = torch.zeros(pallas_nms.STAMP_SLOTS, dtype=torch.int64)
    stamps[9:12] = torch.tensor([5000, 6500, 10000])
    assert pallas_nms.phase_split_us(stamps, ("a", "b"), 9) == \
        {"a": 1.5, "b": 3.5}


@pytest.mark.parametrize("kind", ["random", "ties", "sparse", "pixel"])
@pytest.mark.parametrize("K", [1536, 13000])
def test_nms_sweep_kernel_tiles(K, kind):
    """Rows of several engine tiles (3 of 512; 51 of 256 near
    MAX_SWEEP_K)."""
    dev = _cuda()
    planes = [p.to(dev) for p in _planes(6, 3, K, kind)]
    normalized = kind != "pixel"
    got = pallas_nms.nms_sweep(*planes, normalized=normalized)
    want = pallas_nms.nms_sweep_plain(*planes, normalized=normalized)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("K", [512, 1536])
def test_nms_sweep_kernel_non_prefix_valid(K):
    """Invalid lanes scattered through the row are never kept and
    suppress nothing."""
    dev = _cuda()
    planes = _planes(7, 40, K, "ties")
    rng = np.random.RandomState(8)
    planes[4] = torch.from_numpy((rng.rand(40, K) < 0.6).astype(np.float32))
    planes = [p.to(dev) for p in planes]
    got = pallas_nms.nms_sweep(*planes)
    want = pallas_nms.nms_sweep_plain(*planes)
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


def _priors(seed, P):
    rng = np.random.RandomState(seed)
    cx = rng.rand(P, 2).astype(np.float32)
    wh = (rng.rand(P, 2) * 0.2 + 0.05).astype(np.float32)
    pri = torch.from_numpy(np.concatenate([cx - wh / 2, cx + wh / 2], 1))
    var = torch.tensor([0.1, 0.1, 0.2, 0.2]).expand(P, 4).contiguous()
    return pri, var


def _fused_matches_plain(loc, conf, pri, var, param):
    dev = _cuda()
    args = [t.to(dev) for t in (loc, conf, pri, var)]
    got = pallas_detout.fused_detection_output(*args, param=param)
    _assert_rows_match(got, pallas_detout.fused_detection_output_plain(
        *args, param))


def test_fused_kernel_ssd512_topk_1000():
    """nms_topk 1000 at SSD512 geometry: two engine tiles a row."""
    dev = _cuda()
    from analytics_zoo_tpu_torch.models.ssd import ssd512_config
    priors, variances = (torch.from_numpy(a)
                         for a in build_priors(ssd512_config()))
    loc, conf = _detout_inputs(9, priors.shape[0], 6, "dense")
    p = DetectionOutputParam(n_classes=6, nms_topk=1000, keep_topk=300)
    _fused_matches_plain(loc, conf, priors, variances, p)
    assert dev.type == "cuda"


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_fused_kernel_valid_count_at_topk(delta):
    """Rows whose valid count is nms_topk - 1, nms_topk and nms_topk + 1
    (the radix select runs only for the last)."""
    P, C, k = 600, 4, 200
    rng = np.random.RandomState(10 + delta)
    conf = np.zeros((2, P, C), np.float32)
    for b in range(2):
        for c in range(C):
            lanes = rng.choice(P, k + delta, replace=False)
            conf[b, lanes, c] = rng.rand(k + delta) * 0.9 + 0.05
    loc = torch.from_numpy((rng.randn(2, P, 4) * 0.3).astype(np.float32))
    pri, var = _priors(11, P)
    _fused_matches_plain(loc, torch.from_numpy(conf), pri, var,
                         DetectionOutputParam(n_classes=C, nms_topk=k,
                                              keep_topk=150))


@pytest.mark.parametrize("nms_topk", [50, 333])
def test_fused_kernel_boundary_in_tie_run(nms_topk):
    """int8 scores from five levels: the nms_topk-th score lies inside a
    long run of equal scores, so the lowest priors of the run must be
    taken."""
    P, C = 900, 5
    rng = np.random.RandomState(12)
    conf = (rng.randint(2, 7, (2, P, C)) / 127.0).astype(np.float32)
    loc = torch.from_numpy((rng.randn(2, P, 4) * 0.3).astype(np.float32))
    pri, var = _priors(13, P)
    _fused_matches_plain(loc, torch.from_numpy(conf), pri, var,
                         DetectionOutputParam(n_classes=C, nms_topk=nms_topk,
                                              keep_topk=400))


def test_fused_kernel_negative_conf_thresh():
    """A negative conf_thresh: negative, -0 and +0 scores are candidates
    (-0 ties +0), kept ones with score <= 0 never reach the output."""
    P, C = 500, 4
    rng = np.random.RandomState(14)
    conf = (rng.rand(2, P, C) - 0.4).astype(np.float32)
    conf[:, ::7, 1] = -0.0
    conf[:, 3::7, 1] = 0.0
    loc = torch.from_numpy((rng.randn(2, P, 4) * 0.3).astype(np.float32))
    pri, var = _priors(15, P)
    for k in (100, 450):
        _fused_matches_plain(loc, torch.from_numpy(conf), pri, var,
                             DetectionOutputParam(n_classes=C, nms_topk=k,
                                                  keep_topk=200,
                                                  conf_thresh=-0.5))


def test_fused_kernel_cross_class_ties_and_short_output():
    """Equal scores across classes at the merge (ties to the lowest
    class row, then prior), and keep_topk above the total kept."""
    P, C = 400, 7
    rng = np.random.RandomState(16)
    conf = (rng.randint(0, 4, (3, P, C)) / 127.0).astype(np.float32)
    loc = torch.from_numpy((rng.randn(3, P, 4) * 0.3).astype(np.float32))
    pri, var = _priors(17, P)
    for keep in (40, 5000):
        _fused_matches_plain(loc, torch.from_numpy(conf), pri, var,
                             DetectionOutputParam(n_classes=C, nms_topk=120,
                                                  keep_topk=keep))


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
    ("gru", "relu", 5, 40, 97),     # an odd grid of 97 blocks: no clusters
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
    """Autograd is no longer refused (on the CPU it runs the plain K3/K4;
    ``test_rnn_autograd_launches_k4`` holds the card); a device with no
    kernel still is, forward and backward."""
    pre, w, b, h0, _ = _rnn_inputs(0, "vanilla", 2, 3, 4, False)
    ys, _ = pallas_rnn.persistent_rnn(pre, w.requires_grad_(), b, h0)
    ys.sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
    meta = [t.detach().to("meta") for t in (pre, w, b, h0)]
    with pytest.raises(ValueError, match="no kernel"):
        pallas_rnn.persistent_rnn(*meta)
    cfg = pallas_rnn.RnnKernelConfig("vanilla", "relu")
    n = torch.full((2,), 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pallas_rnn.persistent_rnn_bwd(cfg, meta[0], meta[1], meta[2], n,
                                      meta[3][None], meta[0][..., :4],
                                      meta[3])


def test_rnn_fit_check_prices_the_backward():
    """K4's block holds a whole slice of ``W`` in shared memory: DS2's
    vanilla H=1760 fits in fp32, an LSTM of that width only forward."""
    pallas_rnn.check_hopper_fit(1760, "vanilla", backward=True)
    pallas_rnn.check_hopper_fit(1760, "lstm", backward=False)
    pallas_rnn.check_hopper_fit(512, "lstm", backward=True)
    with pytest.raises(ValueError, match="backward .K4."):
        pallas_rnn.check_hopper_fit(1760, "lstm", backward=True)
    assert pallas_rnn.hopper_bwd_smem_bytes(1760, "vanilla", 132, 2) < \
        pallas_rnn.hopper_bwd_smem_bytes(1760, "vanilla", 132, 4)


def test_rnn_fit_check_names_k4_row_slice():
    """K4 keeps its row slice of ``W`` and the delivered ``d_hh`` in
    shared memory for the whole launch: a GRU of DS2's width is refused
    by name, forward only is taken."""
    pallas_rnn.check_hopper_fit(1760, "gru")
    with pytest.raises(ValueError, match="backward .K4.*row slice"):
        pallas_rnn.check_hopper_fit(1760, "gru", backward=True)
    with pytest.raises(ValueError, match=r"\(K3\).*shared memory"):
        pallas_rnn.check_hopper_fit(9000, "vanilla")


@pytest.mark.parametrize("hidden,cell,n_sm,wbytes,backward,where", [
    (1760, "vanilla", 132, 4, False, "registers"),   # DS2: 49 rows a thread
    (1760, "vanilla", 132, 4, True, "split"),        # 24 + 25 in shared
    (1760, "vanilla", 132, 2, True, "split"),
    (512, "lstm", 132, 4, True, "split"),             # 16 rows: all in regs
    (6, "vanilla", 132, 4, True, "split"),
    (300, "gru", 8, 4, False, "shared"),              # 75 rows a thread
    (1760, "lstm", 132, 4, False, "l2"),              # 394 KB a slice
    (1200, "gru", 132, 4, False, "shared"),           # 71 rows a thread
    (2000, "vanilla", 132, 4, False, "shared"),
    (1900, "vanilla", 132, 4, True, "l2"),            # split part too big
    (1900, "vanilla", 132, 2, True, "split"),
])
def test_rnn_w_source_follows_the_fit(hidden, cell, n_sm, wbytes, backward,
                                      where):
    """Where the launchers keep the block's column slice of ``W``: K3 in
    registers while a thread's K-slice fits ``KERNEL_REG_K`` rows, K4 its
    first ``KERNEL_SPLIT_K`` rows there and the rest in shared memory;
    else K3 all of it in shared memory while it fits beside the rest, and
    else both read it from L2."""
    assert pallas_rnn.hopper_w_source(hidden, cell, n_sm,
                                      backward=backward,
                                      weight_bytes=wbytes) == where


@pytest.mark.parametrize("hidden,cell", [(1760, "vanilla"), (512, "gru"),
                                         (512, "lstm"), (6, "vanilla"),
                                         (1760, "lstm"), (97, "gru")])
def test_rnn_partition_covers_every_input(hidden, cell):
    """The kernels' partition: every hidden column owned by one block,
    every K row in one slice of each product, no slice empty, and no more
    (pair, slice) roles than a block has threads."""
    g = pallas_rnn.rnn_geometry(hidden, cell)
    k = pallas_rnn.CELL_GATES[cell]
    assert g.G <= pallas_rnn.H100_SMS and (g.G - 1) * g.cols < hidden <= \
        g.G * g.cols
    for pairs, width, S, klen in ((g.CP, g.nc, g.S, g.klen),
                                  (g.CPr, g.cols, g.Sr, g.klenr)):
        span = hidden if pairs == g.CP else k * hidden
        assert 2 * pairs >= width and pairs * S <= pallas_rnn.KERNEL_THREADS
        assert (S - 1) * klen < span <= S * klen


def test_step_split_reads_the_stamps():
    """``step_split_us`` turns a stamps buffer into µs a step by phase, in
    each chain's order."""
    s = torch.zeros(2, pallas_rnn.STAMP_STEPS, pallas_rnn.STAMP_PHASES,
                    dtype=torch.int64)
    base = torch.arange(pallas_rnn.STAMP_STEPS)[:, None] * 10_000
    s[0] = base + torch.tensor([0, 1000, 3000, 3500, 5000, 3100, 3200,
                                3300, 1500, 2500])              # forward
    s[1] = base + torch.tensor([0, 6000, 8000, 1000, 4000, 0, 0, 0, 0, 0])
    fwd = pallas_rnn.step_split_us(s.view(-1), 0, "forward")
    dh = pallas_rnn.step_split_us(s.view(-1), 1, "dh")
    assert fwd == {"delivery": 1.0, "product": 2.0, "cell": 0.5,
                   "barrier": 1.5, "step": 5.0,
                   "cell_split": {"partials": 0.1, "gates": 0.1,
                                  "stores": 0.1, "rest": 0.2},
                   "last_slice": {"delivery": 1.5, "product": 1.0}}
    assert dh == {"cell": 1.0, "barrier": 3.0, "delivery": 2.0,
                  "product": 2.0, "step": 8.0}


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


# -- K4: the persistent-RNN backward, and K3's saved carries ---------------
# Tolerance: 1e-4 of each output's largest magnitude (measured ≤ 4.2e-6 at
# the DS2 shape; at these sizes a clipped-ReLU argument within rounding of
# 0, which would send the two versions down different branches, does not
# occur for these seeds).


def _k4_case(seed, cell, act, B, T, H, masked, time_block,
             wdtype=torch.float32):
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    pre, w, b, h0, n = _rnn_inputs(seed, cell, B, T, H, masked, wdtype)
    n = (torch.full((B,), T, dtype=torch.int32) if n is None
         else n.clamp(0, T).int())
    cfg = pallas_rnn.RnnKernelConfig(cell, act, time_block)
    rng = np.random.RandomState(seed + 1)
    g_ys = torch.from_numpy(rng.randn(B, T, H).astype(np.float32))
    g_cf = torch.from_numpy(rng.randn(*h0.shape).astype(np.float32))
    return cfg, [t.to(dev) for t in (pre, w, b, h0, n, g_ys, g_cf)]


@pytest.mark.parametrize("time_block", [8, 5])
@pytest.mark.parametrize("cell,act,B,T,H", RNN_CASES)
def test_persistent_rnn_bwd_kernel(cell, act, B, T, H, time_block):
    """K4 against its plain version from the same saved carries, ragged
    rows (some past T, some empty): d_pre, d_w, d_b, d_h0."""
    cfg, (pre, w, b, h0, n, g_ys, g_cf) = _k4_case(
        11, cell, act, B, T, H, True, time_block)
    _, _, cs = pallas_rnn.persistent_rnn_fwd(cfg, pre, w, b, h0, n,
                                             save_residuals=True)
    before = pallas_rnn.persistent_rnn_bwd.launches
    got = pallas_rnn.persistent_rnn_bwd(cfg, pre, w, b, n, cs, g_ys, g_cf)
    torch.cuda.synchronize()
    assert pallas_rnn.persistent_rnn_bwd.launches == before + 1
    want = pallas_rnn.persistent_rnn_bwd_plain(cfg, pre, w, b, n, cs, g_ys,
                                               g_cf)
    for name, g, r in zip(("d_pre", "d_w", "d_b", "d_h0"), got, want):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert _rel_err(g, r) <= 1e-4, name
    # a step past a row's length gets no gradient; a rerun is bit-equal
    pad = torch.arange(T, device=n.device)[None, :] >= n[:, None]
    assert (got[0][pad] == 0).all()
    again = pallas_rnn.persistent_rnn_bwd(cfg, pre, w, b, n, cs, g_ys, g_cf)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("cell,H,backward,where", [
    ("gru", 1200, False, "shared"),     # K3: 71 rows a thread, 144 KB slice
    ("vanilla", 2000, False, "shared"),
    ("lstm", 1760, False, "l2"),        # K3: a 394 KB slice
    ("vanilla", 1900, True, "l2"),      # K4: the split's shared part too big
])
def test_rnn_w_sources_off_the_register_path(cell, H, backward, where):
    """The column slice of ``W`` read from shared memory or L2, as the fit
    chooses it on this card: K3 (and K4 with ``backward``) against their
    plain versions, and the launcher reporting that source."""
    dev = _cuda()
    props = torch.cuda.get_device_properties(dev)
    assert pallas_rnn.hopper_w_source(
        H, cell, props.multi_processor_count,
        props.shared_memory_per_block_optin, backward) == where
    cfg, (pre, w, b, h0, n, g_ys, g_cf) = _k4_case(19, cell, "tanh", 3, 12,
                                                   H, True, 5)
    ys, cf, cs = pallas_rnn.persistent_rnn_fwd(cfg, pre, w, b, h0, n,
                                               save_residuals=True)
    if not backward:
        assert pallas_rnn.persistent_rnn.w_source == where
    want_ys, want_cf = pallas_rnn.persistent_rnn_plain(cfg, pre, w, b, h0, n)
    assert _rel_err(ys, want_ys) <= 1e-4 and _rel_err(cf, want_cf) <= 1e-4
    if backward:
        got = pallas_rnn.persistent_rnn_bwd(cfg, pre, w, b, n, cs, g_ys,
                                            g_cf)
        assert pallas_rnn.persistent_rnn_bwd.w_source == where
        want = pallas_rnn.persistent_rnn_bwd_plain(cfg, pre, w, b, n, cs,
                                                   g_ys, g_cf)
        for name, g, r in zip(("d_pre", "d_w", "d_b", "d_h0"), got, want):
            assert _rel_err(g, r) <= 1e-4, name


def test_persistent_rnn_bwd_kernel_bf16_weights():
    """bf16 weights: d_w comes back in bf16; within 2e-2 relative L2 of the
    plain version (h rounds to bf16 at different values now and then)."""
    cfg, (pre, w, b, h0, n, g_ys, g_cf) = _k4_case(
        12, "vanilla", "clipped_relu", 8, 50, 256, False, 8, torch.bfloat16)
    _, _, cs = pallas_rnn.persistent_rnn_fwd(cfg, pre, w, b, h0, n,
                                             save_residuals=True)
    got = pallas_rnn.persistent_rnn_bwd(cfg, pre, w, b, n, cs, g_ys, g_cf)
    want = pallas_rnn.persistent_rnn_bwd_plain(cfg, pre, w, b, n, cs, g_ys,
                                               g_cf)
    assert got[1].dtype == torch.bfloat16
    for g, r in zip(got, want):
        g, r = g.float(), r.float()
        assert ((g - r).norm() / r.norm()).item() <= 2e-2


@pytest.mark.parametrize("cell", ["vanilla", "gru", "lstm"])
def test_saved_carries_kernel(cell):
    """K3's ``cs`` against the plain version's, and each saved h equal to
    the output of the row's last valid step before the block start (or
    h0): the same floats."""
    cfg, (pre, w, b, h0, n, _, _) = _k4_case(13, cell, "tanh", 5, 23, 96,
                                             True, 4)
    ys, _, cs = pallas_rnn.persistent_rnn_fwd(cfg, pre, w, b, h0, n,
                                              save_residuals=True)
    torch.cuda.synchronize()
    want = pallas_rnn.persistent_rnn_plain(cfg, pre, w, b, h0, n,
                                           save_residuals=True)[2]
    assert cs.shape == want.shape == (6,) + tuple(h0.shape)
    assert _rel_err(cs, want) <= 1e-4
    rows = torch.arange(5, device=pre.device)
    for blk in range(cs.shape[0]):
        last = torch.clamp(n.long(), max=4 * blk) - 1
        h_then = torch.where((last >= 0)[:, None],
                             ys[rows, last.clamp(min=0)], h0[-1])
        assert torch.equal(cs[blk, -1], h_then), blk


def test_inference_saves_no_carries(monkeypatch):
    """Without autograd K3 launches once and writes no residuals; K4 does
    not launch."""
    cfg, (pre, w, b, h0, n, _, _) = _k4_case(14, "vanilla", "relu", 4, 40,
                                             96, True, 8)
    seen = []
    launch = pallas_rnn._launch_persistent_rnn
    monkeypatch.setattr(pallas_rnn, "_launch_persistent_rnn",
                        lambda *a, **k: seen.append(a[8:] + tuple(
                            k.values())) or launch(*a, **k))
    k3, k4 = (pallas_rnn.persistent_rnn.launches,
              pallas_rnn.persistent_rnn_bwd.launches)
    w.requires_grad_()
    with torch.inference_mode():
        pallas_rnn.persistent_rnn(pre, w, b, h0, n)
    assert pallas_rnn.persistent_rnn.launches == k3 + 1
    assert pallas_rnn.persistent_rnn_bwd.launches == k4
    assert seen == [(None,)]


@pytest.mark.parametrize("cell", ["vanilla", "gru", "lstm"])
def test_rnn_autograd_launches_k4(cell):
    """A ``requires_grad`` call runs K3 (saving its carries) forward and
    K4 backward, once each; its gradients equal autograd through the
    plain loop (``backward="scan"``) on the card within 1e-4."""
    cfg, (pre, w, b, h0, n, g_ys, g_cf) = _k4_case(15, cell, "tanh", 6, 37,
                                                   128, True, 8)
    grads = {}
    for backward in ("pallas", "scan"):
        args = [t.clone().requires_grad_() for t in (pre, w, b, h0)]
        k3, k4 = (pallas_rnn.persistent_rnn.launches,
                  pallas_rnn.persistent_rnn_bwd.launches)
        ys, cf = pallas_rnn.persistent_rnn(*args, n, cell=cell,
                                           activation="tanh",
                                           backward=backward)
        ((ys * g_ys).sum() + (cf * g_cf).sum()).backward()
        torch.cuda.synchronize()
        launched = (pallas_rnn.persistent_rnn.launches - k3,
                    pallas_rnn.persistent_rnn_bwd.launches - k4)
        assert launched == ((1, 1) if backward == "pallas" else (0, 0))
        grads[backward] = [a.grad for a in args]
    for g, r in zip(grads["pallas"], grads["scan"]):
        assert _rel_err(g, r) <= 1e-4


def test_recurrent_prices_k4_only_under_autograd():
    """An LSTM of DS2's width fits K3 but not K4: a ``Recurrent`` layer
    serves it without autograd (one K3 launch) and refuses only a call
    whose gradient would need K4, naming that pass."""
    from analytics_zoo_tpu_torch.core.rnn import LSTMCell, Recurrent

    dev = _cuda()
    layer = Recurrent(LSTMCell(1760, input_size=8), engine="pallas",
                      generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.randn(2, 5, 8, device=dev)
    k3 = pallas_rnn.persistent_rnn.launches
    with torch.inference_mode():
        ys = layer(x, n_frames=torch.tensor([5, 3], device=dev))
    assert pallas_rnn.persistent_rnn.launches == k3 + 1
    assert ys.shape == (2, 5, 1760) and torch.isfinite(ys).all()
    with pytest.raises(ValueError, match="backward .K4."):
        layer(x)


def test_detection_output_falls_back_to_k1_past_k2s_limit():
    """60000 priors do not fit K2's select block: the kernel still refuses
    them, naming the limit, while ``detection_output`` ("auto" on the
    card) warns and runs the unfused path, launching K1 and not K2; its
    rows equal the plain path's."""
    dev = _cuda()
    rng = np.random.RandomState(3)
    P = 60000
    xy = rng.rand(P, 2).astype(np.float32)
    priors = torch.from_numpy(np.concatenate(
        [xy, xy + 0.05], 1).astype(np.float32)).to(dev)
    variances = torch.full((P, 4), 0.1, device=dev)
    loc = torch.from_numpy((rng.randn(1, P, 4) * 0.1).astype(np.float32)
                           ).to(dev)
    conf = torch.softmax(torch.from_numpy(rng.randn(1, P, 4).astype(
        np.float32)).to(dev), -1)
    param = DetectionOutputParam(n_classes=4, nms_topk=64, keep_topk=32)
    with pytest.raises(ValueError, match="shared memory"):
        pallas_detout.fused_detection_output(loc, conf, priors, variances,
                                             param=param)
    k1, k2 = (pallas_nms.nms_sweep.launches,
              pallas_detout.fused_detection_output.launches)
    with pytest.warns(UserWarning, match="falling back to the unfused"):
        got = detection_output(loc, conf, priors, variances, param)
    torch.cuda.synchronize()
    assert (pallas_nms.nms_sweep.launches - k1,
            pallas_detout.fused_detection_output.launches - k2) == (1, 0)
    want = detection_output(loc, conf, priors, variances,
                            dataclasses.replace(param, backend="xla"))
    assert torch.equal(got[..., 0], want[..., 0])
    assert (got[..., 1:] - want[..., 1:]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("case", ["random", "zero_logits", "shared_prior"])
def test_multibox_matching_and_mining_equal_on_card_and_cpu(case):
    """``match_priors`` and ``mine_hard_examples`` at SSD300 (8732
    priors, batch 4, up to 10 gts) give EQUAL results on the card and
    the CPU: random logits, all-zero logits (every negative tied) and two
    gts that share a best prior (the later one wins it on both)."""
    from analytics_zoo_tpu_torch.ops.multibox_loss import (
        MultiBoxLossParam, match_priors, mine_hard_examples)

    dev = _cuda()
    priors, _ = build_priors(ssd300_config())
    rng = np.random.RandomState(4)
    B, G, P = 4, 10, priors.shape[0]
    xy = rng.rand(B, G, 2) * 0.8
    boxes = np.concatenate([xy, xy + rng.rand(B, G, 2) * 0.3 + 0.02], -1)
    mask = (np.arange(G)[None] < rng.randint(0, G + 1, (B, 1))).astype(
        np.float32)
    if case == "shared_prior":
        mask[0, :5] = 1.0
        boxes[0, 1] = priors[4000]
        boxes[0, 3] = priors[4000] + np.float32([0.002, 0, 0.002, 0])
    boxes = (boxes * mask[..., None]).astype(np.float32)
    logits = (np.zeros((B, P, 21)) if case == "zero_logits"
              else rng.randn(B, P, 21)).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        m, pos, iou = match_priors(torch.from_numpy(priors).to(d),
                                   torch.from_numpy(boxes).to(d),
                                   torch.from_numpy(mask).to(d))
        logp = torch.log_softmax(torch.from_numpy(logits).to(d), -1)
        negs = [mine_hard_examples(logp, pos, iou, MultiBoxLossParam(
            mining=mode, mining_topk=64)) for mode in ("sort", "topk")]
        out[d.type] = [t.cpu() for t in (m, pos, *negs)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    if case == "shared_prior":
        assert int(out["cuda"][0][0, 4000]) == 3


def test_ds2_training_pallas_matches_blocked():
    """One DS2 training forward and backward on the card, ragged
    ``n_frames``, through K3/K4 and through the blocked loop: the CTC loss
    and every gradient within 1e-3 relative L2 (two summation orders
    through the conv, one BiRNN layer and the loss); the biases in front
    of a BN, whose gradient is 0 up to rounding, against the largest
    gradient norm."""
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion, make_ds2_model)

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(16)
    n = np.array([300, 211, 97, 40], np.int32)
    labels = rng.randint(1, 29, (4, 12)).astype(np.int32)
    batch = {"input": (torch.from_numpy(rng.randn(4, 300, 13).astype(
        np.float32)).to(dev), torch.from_numpy(n).to(dev)),
        "n_frames": torch.from_numpy(n).to(dev),
        "labels": torch.from_numpy(labels).to(dev),
        "label_mask": torch.ones(4, 12, device=dev)}
    crit = ds2_ctc_criterion()
    out = {}
    for engine in ("pallas", "blocked"):
        model = make_ds2_model(hidden=256, n_rnn_layers=1, seed=5,
                               rnn_engine=engine, device=dev).train()
        before = pallas_rnn.persistent_rnn_bwd.launches
        loss = crit(model(*batch["input"]), batch)
        loss.backward()
        assert pallas_rnn.persistent_rnn_bwd.launches - before == (
            2 if engine == "pallas" else 0)
        out[engine] = (loss.item(), {k: p.grad for k, p in
                                     model.named_parameters()})
    assert abs(out["pallas"][0] - out["blocked"][0]) <= 1e-3 * abs(
        out["blocked"][0])
    top = max(g.norm().item() for g in out["blocked"][1].values())
    for k, r in out["blocked"][1].items():
        g = out["pallas"][1][k]
        scale = top if k in ("conv1.bias", "proj0.bias") else r.norm().item()
        assert (g - r).norm().item() <= 1e-3 * scale, k


# -- the int8 x int8 convolution (im2col + torch._int_mm on the card) --------

# (C, O, k, stride, pad, dilation, B, H): conv1_2's shape at batch 1, fc6,
# a conf head (N = 84, padded to 88), conv6_2 (stride 2), conv8_2 (pad 0)
# and conv9_2 at batch 1 (one output row: M padded past 16)
INT8_CONV_CASES = [
    (64, 64, 3, 1, 1, 1, 1, 300), (512, 1024, 3, 1, 6, 6, 2, 19),
    (512, 84, 3, 1, 1, 1, 2, 38), (256, 512, 3, 2, 1, 1, 2, 19),
    (128, 256, 3, 1, 0, 1, 2, 5), (128, 256, 3, 1, 0, 1, 1, 3),
]


@pytest.mark.parametrize("C,O,k,s,p,d,B,H", INT8_CONV_CASES)
def test_int8_conv_equals_plain_on_card(C, O, k, s, p, d, B, H):
    """The card's int32 accumulators equal the plain float64 version's
    (exact integer sums), and the GEMM ran on the card."""
    from analytics_zoo_tpu_torch.utils import quantize

    dev = _cuda()
    g = torch.Generator().manual_seed(C * 1000 + O)
    qa = torch.randint(-127, 128, (B, C, H, H), generator=g,
                       dtype=torch.int8).to(dev)
    qw = torch.randint(-127, 128, (O, C, k, k), generator=g,
                       dtype=torch.int8).to(dev)
    before = quantize.int8_matmul.launches
    got = quantize.int8_conv2d(qa, qw, s, p, d)
    want = quantize.int8_conv2d_plain(qa, qw, s, p, d)
    assert quantize.int8_matmul.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_int8_gemm_refuses_a_k_not_multiple_of_8():
    """No fallback: a K that torch._int_mm refuses raises on the card."""
    from analytics_zoo_tpu_torch.utils import quantize

    dev = _cuda()
    a = torch.ones(32, 12, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        quantize.int8_matmul(a, torch.ones(16, 12, dtype=torch.int8,
                                           device=dev))


def test_quantized_ssd_on_card_matches_cpu():
    """The int8 x int8 SSD300 forward on the card against the same
    quantized model on the CPU: the integer sums agree exactly, so what
    differs is conv1_1 (fp32, another summation order) and the spread of
    that through the dynamic scales (measured 7.3e-4 of the output's
    largest magnitude on an NVIDIA H100 80GB HBM3 at 700.00 W); within
    5e-3 of each output."""
    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.utils import quantize

    dev = _cuda()
    torch.backends.cudnn.allow_tf32 = False
    cpu = quantize.quantize_model(SSDVgg(21, 300, device="cpu", seed=0),
                                  compute="int8")
    card = quantize.quantize_model(SSDVgg(21, 300, device="cpu", seed=0),
                                   compute="int8").to(dev)
    x = torch.from_numpy(np.random.RandomState(3).rand(1, 300, 300, 3)
                         .astype(np.float32) * 255 - 120)
    with torch.inference_mode():
        want = cpu(x)
        got = card(x.to(dev))
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max() <= 5e-3 * w.abs().max()
