#!/usr/bin/env python3
"""Drive the PyTorch port's SSD300 serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: both CUDA kernels compiled with ``nvcc`` for sm_90a from
   ``analytics_zoo_tpu_torch/csrc`` (in parallel, cached by source hash);
3. K1 (NMS sweep) against its plain PyTorch version at the SSD300 unfused
   shape (batch 8 → 160 rows × 512 candidates): random, tie-heavy and
   sparse rows; keep masks must be equal;
4. K2 (fused DetectionOutput) against its plain version at SSD300
   (batch 8, P=8732, 21 classes; dense untrained and trained-like int8-tie
   confidences) and SSD512 geometry (P=24564): classes equal, scores
   within 1e-6, boxes within 1e-5;
5. serving: ``SSDPredictor`` around a seeded random ``SSDVgg(21, 300)``
   answers 4 staged uint8 batches of 8 through ``backend="auto"`` (K2)
   and one through ``"pallas"`` (K1), with every launch counter set to 0
   just before and read just after; then "fused", "pallas" and the plain
   path must agree on one forward's (loc, probs), and the card's forward
   must agree with a CPU forward of the same weights;
6. timings with CUDA events at the main path's shapes: each kernel and
   its plain version, the forward, and the end-to-end batch;
7. the ``kernels`` line, then the device line last.

Exits non-zero, printing no result, when no CUDA device is present or
the port's package is not beside this script.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): HBM bytes/s, fp32 outside the
# tensor cores (the kernels' IoU and compare arithmetic)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations of one IoU test as the kernels write it: 4 min/max, 2 widths,
# 2 clamps, 1 product, 3 for the area, 3 for the union, 1 divide, 1 compare
IOU_OPS = 17
BATCH = 8


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rows_err(got, want) -> float:
    """Fail unless detection rows agree: classes equal, scores ≤ 1e-6,
    boxes ≤ 1e-5.  Returns the largest absolute difference."""
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    if not torch.equal(got[..., 0], want[..., 0]):
        bad = (got[..., 0] != want[..., 0]).nonzero()[:5].tolist()
        raise AssertionError(f"class ids differ at {bad}")
    ds = (got[..., 1] - want[..., 1]).abs().max().item()
    db = (got[..., 2:] - want[..., 2:]).abs().max().item()
    if ds > 1e-6 or db > 1e-5:
        raise AssertionError(f"score err {ds} (tol 1e-6), box err {db} "
                             "(tol 1e-5)")
    return max(ds, db)


def sweep_planes(rng, C, K, kind):
    """(C,K) score-sorted candidate planes for K1."""
    import numpy as np

    xy = rng.rand(C, K, 2)
    boxes = np.concatenate([xy, xy + rng.rand(C, K, 2) * 0.3 + 0.02], -1)
    valid = np.ones((C, K), np.float32)
    if kind == "ties":              # runs of identical boxes: IoU exactly 1
        boxes[:, 1::2] = boxes[:, 0::2]
    if kind == "sparse":            # short valid prefixes, as in serving
        valid = (np.arange(K)[None] < rng.randint(0, 40, (C, 1))
                 ).astype(np.float32)
    boxes = boxes.astype(np.float32)
    return [np.ascontiguousarray(boxes[..., i]) for i in range(4)] + [valid]


def sweep_ops(keep, valid) -> int:
    """IoU tests the greedy sweep needs on this data: each kept candidate
    against the candidates after it up to the row's last valid lane."""
    import torch

    K = keep.shape[1]
    lanes = torch.arange(K, device=keep.device)
    n_valid = torch.where(valid > 0, lanes + 1, 0).amax(1, keepdim=True)
    later = (n_valid - lanes - 1).clamp(min=0)
    return int(((keep > 0) * later).sum().item()) * IOU_OPS


def detout_work(loc, conf, priors, variances, param):
    """(bytes, operations) the fused DetectionOutput needs on these
    inputs: every input read once and the output written once; the
    decode (20 ops a prior), the confidence filter (1 a score), ranking
    the candidates (n·log2 n compares a row), one IoU test of each kept
    candidate against each candidate ranked after it inside the row's
    nms_topk window, and the merge (keep_topk·log2 C_fg)."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas_detout import (foreground_ids,
                                                           fused_keep_plain)

    B, P, C = conf.shape
    _, keep = fused_keep_plain(loc, conf, priors, variances, param)
    fg = torch.as_tensor(foreground_ids(C, param.background_id),
                         device=conf.device)
    s = conf.index_select(2, fg).transpose(1, 2)
    valid = s > param.conf_thresh
    n_valid = valid.sum(-1)
    n_pop = n_valid.clamp(max=param.nms_topk)
    # rank of each prior in its row's descending stable order
    order = torch.sort(torch.where(valid, s, float("-inf")), dim=-1,
                       descending=True, stable=True)[1]
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(P, device=conf.device).expand_as(order))
    later = (n_pop[..., None] - rank - 1).clamp(min=0)
    iou_tests = int(((keep > 0) * later).sum().item())
    nv = n_valid.double().clamp(min=2)
    ops = (B * P * 20 + B * len(fg) * P
           + int((nv * torch.log2(nv)).sum().item())
           + iou_tests * IOU_OPS
           + B * param.keep_topk * max(1, math.ceil(math.log2(len(fg)))))
    nbytes = 4 * (loc.numel() + conf.numel() + 8 * P
                  + B * param.keep_topk * 6)
    return nbytes, ops


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def synthetic_conf(rng, B, P, C, regime):
    """Softmax confidences: "dense" (untrained, near uniform) or
    "trained" (background-dominated, a few hot priors, int8-quantized so
    scores tie in bulk)."""
    import numpy as np

    logits = rng.randn(B, P, C).astype(np.float32)
    if regime == "trained":
        logits[..., 0] += 7.0
        hot = rng.rand(B, P) < 0.05
        logits[..., 1:] += np.where(hot[..., None], 9.0, 0.0)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    conf = e / e.sum(-1, keepdims=True)
    if regime == "trained":
        conf = np.round(conf * 127.0) / 127.0
    return conf.astype(np.float32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from analytics_zoo_tpu_torch.models.ssd import (build_priors,
                                                    build_ssd_vgg,
                                                    ssd300_config,
                                                    ssd512_config)
    from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_nms
    from analytics_zoo_tpu_torch.ops.detection_output import (
        DetectionOutputParam, detection_output, sweep_candidates)
    from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                       SSDPredictor,
                                                       run_serving_loop)
    from analytics_zoo_tpu_torch.utils import cuda_build

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_build.build_kernels()
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in cuda_build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in libs}
    emit("build", seconds=round(build_s, 3),
         libraries={n: str(p.name) for n, p in libs.items()}, ptxas=ptxas)

    # -- 3. K1 against its plain version ----------------------------------
    k1_err = 0.0
    for kind in ("random", "ties", "sparse"):
        planes = [torch.from_numpy(p).to(dev)
                  for p in sweep_planes(rng, BATCH * 20, 512, kind)]
        got = pallas_nms.nms_sweep(*planes)
        torch.cuda.synchronize()
        want = pallas_nms.nms_sweep_plain(*planes)
        err = (got - want).abs().max().item()
        if err != 0:
            raise AssertionError(f"K1 keep mask differs ({kind}): {err}")
        k1_err = max(k1_err, err)
        emit("k1_check", case=kind, rows=planes[0].shape[0],
             k=planes[0].shape[1], kept=int(got.sum().item()),
             max_abs_err=err)

    # -- 4. K2 against its plain version ----------------------------------
    k2_err = 0.0
    post = DetectionOutputParam(n_classes=21)
    for res, cfg in ((300, ssd300_config()), (512, ssd512_config())):
        pri, var = (torch.from_numpy(a).to(dev) for a in build_priors(cfg))
        P = pri.shape[0]
        for regime in ("dense", "trained"):
            loc = torch.from_numpy((rng.randn(BATCH, P, 4) * 0.5)
                                   .astype(np.float32)).to(dev)
            conf = torch.from_numpy(synthetic_conf(rng, BATCH, P, 21,
                                                   regime)).to(dev)
            got = pallas_detout.fused_detection_output(loc, conf, pri, var,
                                                       param=post)
            torch.cuda.synchronize()
            want = pallas_detout.fused_detection_output_plain(loc, conf, pri,
                                                              var, post)
            err = rows_err(got, want)
            k2_err = max(k2_err, err)
            emit("k2_check", resolution=res, priors=P, regime=regime,
                 kept=int((got[..., 1] > 0).sum().item()), max_abs_err=err)
            if res == 300 and regime == "trained":
                trained_inputs = (loc, conf)

    # -- 5. serving: the main path ----------------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_ssd_vgg(21, 300, device=dev, seed=0)
    param = PreProcessParam(batch_size=BATCH, resolution=300)
    predictor = SSDPredictor(model, param, device=dev)
    unfused = copy.copy(predictor)
    unfused.post = dataclasses.replace(predictor.post, backend="pallas")

    def staged(seed):
        r = np.random.RandomState(seed)
        sizes = r.randint(200, 640, (BATCH, 2)).astype(np.float32)
        info = np.concatenate([np.full((BATCH, 2), 300, np.float32),
                               300.0 / sizes], 1)
        return {"input": r.randint(0, 256, (BATCH, 300, 300, 3))
                .astype(np.uint8), "im_info": info}

    batches = [staged(100 + i) for i in range(4)]
    predictor.detect_batch(staged(99))              # cuDNN warm-up
    torch.cuda.synchronize()
    pallas_nms.nms_sweep.launches = 0
    pallas_detout.fused_detection_output.launches = 0
    served = run_serving_loop([dict(b) for b in batches],
                              predictor._detect_device,
                              lambda t: t.cpu().numpy())
    served_unfused = unfused.detect_batch(dict(batches[0]))
    torch.cuda.synchronize()
    launches = {"nms_sweep": pallas_nms.nms_sweep.launches,
                "fused_detection_output":
                    pallas_detout.fused_detection_output.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    out = np.stack(served)
    if out.shape != (4 * BATCH, 200, 6) or not np.isfinite(out).all():
        raise AssertionError(f"bad detections {out.shape}")
    if not (np.isin(out[..., 0], np.arange(-1, 21)).all()
            and (out[..., 1] >= 0).all() and (out[..., 1] <= 1).all()):
        raise AssertionError("class ids or scores out of range")
    if not np.isfinite(served_unfused).all():
        raise AssertionError("unfused path gave non-finite detections")

    x = (torch.from_numpy(batches[0]["input"]).to(dev).float()
         - torch.tensor(param.pixel_means, device=dev))
    with torch.inference_mode():
        loc, conf = model(x)
        probs = torch.softmax(conf, -1)
    pri, var = predictor._priors, predictor._variances
    backs = {b: detection_output(loc, probs, pri, var,
                                 dataclasses.replace(predictor.post,
                                                     backend=b))
             for b in ("fused", "pallas", "xla")}
    agree = max(rows_err(backs["fused"], backs["xla"]),
                rows_err(backs["pallas"], backs["xla"]))
    # the card's forward against a CPU forward of the same seeded weights
    cpu_model = build_ssd_vgg(21, 300, device="cpu", seed=0)
    with torch.inference_mode():
        cl, cc = cpu_model(x[:1].cpu())
    fwd_err = max(((loc[:1].cpu() - cl).abs().max() / cl.abs().max()).item(),
                  ((conf[:1].cpu() - cc).abs().max() / cc.abs().max()).item())
    if fwd_err > 1e-4:
        raise AssertionError(f"card forward vs CPU forward: {fwd_err}")
    emit("serving", batches=len(batches), batch=BATCH,
         detections=int((out[..., 1] > 0).sum()), launches=launches,
         backends_max_abs_err=agree, forward_rel_err_vs_cpu=fwd_err,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # -- 6. timings at the main path's shapes -----------------------------
    boxes, top, valid, _ = sweep_candidates(loc, probs, pri, var,
                                            predictor.post)
    B, Cf, k = top.shape
    planes = [boxes[..., i].reshape(B * Cf, k).contiguous()
              for i in range(4)] + [valid.reshape(B * Cf, k)]
    keep = pallas_nms.nms_sweep(*planes)
    k1_ms = cuda_ms(lambda: pallas_nms.nms_sweep(*planes), 50)
    k1_plain_ms = cuda_ms(lambda: pallas_nms.nms_sweep_plain(*planes), 3, 1)
    k1_bound, k1_by = bound(6 * planes[0].numel() * 4,
                            sweep_ops(keep, planes[4]))

    def k2(l, c):
        return pallas_detout.fused_detection_output(l, c, pri, var,
                                                    param=predictor.post)

    k2_ms = cuda_ms(lambda: k2(loc, probs), 20)
    k2_plain_ms = cuda_ms(lambda: pallas_detout.fused_detection_output_plain(
        loc, probs, pri, var, predictor.post), 2, 1)
    k2_bound, k2_by = bound(*detout_work(loc, probs, pri, var,
                                         predictor.post))
    t_loc, t_conf = trained_inputs
    k2_trained_ms = cuda_ms(lambda: k2(t_loc, t_conf), 20)
    k2_trained_bound, k2_trained_by = bound(*detout_work(
        t_loc, t_conf, pri, var, predictor.post))
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x), 10)
    for b in batches:                                 # host-clock e2e
        predictor.detect_batch(dict(b))
    torch.cuda.synchronize()
    reps = 12
    t0 = time.perf_counter()
    for i in range(reps):
        predictor.detect_batch(dict(batches[i % len(batches)]))
    e2e_ms = (time.perf_counter() - t0) * 1e3 / reps
    emit("timing", nvidia_smi=smi, forward_ms=fwd_ms,
         e2e_ms_per_batch=e2e_ms, images_per_s=BATCH * 1e3 / e2e_ms,
         k2_trained_like_ms=k2_trained_ms,
         k2_trained_like_bound_ms=k2_trained_bound,
         k2_trained_like_bound_by=k2_trained_by,
         k1_rows=B * Cf, k1_k=k, k1_kept=int(keep.sum().item()))

    # -- 7. kernels, then the device line last ----------------------------
    kernels = [
        {"name": "nms_sweep", "route": "cuda",
         "source": "analytics_zoo_tpu_torch/csrc/nms_sweep.cu",
         "replaces": "analytics_zoo_tpu/ops/pallas_nms.py:91",
         "launches": launches["nms_sweep"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "fused_detection_output", "route": "cuda",
         "source": "analytics_zoo_tpu_torch/csrc/detection_output.cu",
         "replaces": "analytics_zoo_tpu/ops/pallas_detout.py:242",
         "launches": launches["fused_detection_output"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
