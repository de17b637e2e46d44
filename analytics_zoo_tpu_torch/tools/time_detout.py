#!/usr/bin/env python3
"""Time K1 and K2 at the SSD300 serving shape through the wrappers of
whichever ``analytics_zoo_tpu_torch`` comes first on the path, so that
two trees can be compared on one card in one run:

    PYTHONPATH=OLD_TREE python3 analytics_zoo_tpu_torch/tools/time_detout.py
    PYTHONPATH=.        python3 analytics_zoo_tpu_torch/tools/time_detout.py

Run the two in turns (old, new, new, old).  Uses only the public calls
(``fused_detection_output``, ``nms_sweep``, ``sweep_candidates``), which
every tree since the port's first slice has.  Inputs are seeded: batch
8, the SSD300 priors (P=8732), 21 classes, ``DetectionOutputParam``
defaults; "dense" confidences are a near-uniform softmax (every row
saturates its nms_topk = 400 candidates), "trained" ones are
background-dominated with ~5% hot priors and rounded to multiples of
1/127 (scores tie in bulk).  K1 takes the unfused path's candidates of
the same inputs (160 rows of 512).  Prints one JSON line: the package's
directory, the card's name and power limit, each kernel's ms (CUDA
events, the mean of ``REPS`` launches after two), K2's device ms by
launch (``torch.profiler``), and a sha256 of each output, by which two
trees' results can be told apart; for a tree whose kernels carry phase
stamps (this one on), also where block 0 of K2's select and merge
launches and of K1 spends its time, in µs, from the kernels'
``%globaltimer`` stamps.
"""

import hashlib
import json
import subprocess
import sys

B, C, REPS = 8, 21, 50


def cuda_ms(fn, reps: int = REPS) -> float:
    import torch

    fn()
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


def ms_by_kernel(fn, reps: int = 10):
    """Mean device ms a call of each kernel launched by ``fn``, from
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", None)
              or getattr(ev, "cuda_time_total", 0))
        if us and "Memset" not in ev.key and "memcpy" not in ev.key.lower():
            out[ev.key[:60]] = us / 1e3 / reps
    return out


def confidences(rng, P, regime):
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


def sha(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_detout: no CUDA device", file=sys.stderr)
        return 2
    import analytics_zoo_tpu_torch
    from analytics_zoo_tpu_torch.models.ssd import build_priors, ssd300_config
    from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_nms
    from analytics_zoo_tpu_torch.ops.detection_output import (
        DetectionOutputParam, sweep_candidates)

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    pri, var = (torch.from_numpy(a).to(dev)
                for a in build_priors(ssd300_config()))
    P = pri.shape[0]
    param = DetectionOutputParam(n_classes=C)
    result = {"package": analytics_zoo_tpu_torch.__path__[0]}
    for regime in ("dense", "trained"):
        loc = torch.from_numpy((rng.randn(B, P, 4) * 0.5)
                               .astype(np.float32)).to(dev)
        conf = torch.from_numpy(confidences(rng, P, regime)).to(dev)

        def k2():
            return pallas_detout.fused_detection_output(loc, conf, pri, var,
                                                        param=param)

        boxes, _, valid, _ = sweep_candidates(loc, conf, pri, var, param)
        Bn, Cf, k, _ = boxes.shape
        planes = [boxes[..., i].reshape(Bn * Cf, k).contiguous()
                  for i in range(4)] + [valid.reshape(Bn * Cf, k)]

        def k1():
            return pallas_nms.nms_sweep(*planes)

        result[regime] = {
            "k2_ms": cuda_ms(k2), "k1_ms": cuda_ms(k1),
            "k2_ms_by_kernel": ms_by_kernel(k2),
            "k2_sha256": sha(k2()), "k1_sha256": sha(k1()),
            "k2_detections": int((k2()[..., 1] > 0).sum().item()),
            "k1_kept": int(k1().sum().item())}
        if hasattr(pallas_detout, "block_phases_us"):
            result[regime]["block_us"] = pallas_detout.block_phases_us(
                loc, conf, pri, var, param, planes)
    result["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
