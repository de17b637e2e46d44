"""Decompose the SSD serve program on the card: backbone against
DetectionOutput, and DetectionOutput's insides (counterpart of
``tools/profile_serve.py``).

Two levels, as the reference's:

1. **Program**: ``full ≈ backbone + detection_output`` with the residual
   reported.  The trained-like confidence distribution is baked into the
   conf heads' biases (``+bg_bias`` on every background channel: channel
   ``j`` of ``conf_i`` is class ``j % C``, since the port's heads permute
   to NHWC before the ``(B, -1, C)`` reshape), so the whole and the parts
   see the same data; every stage is timed on the loc/conf the biased
   backbone actually produced.
2. **DetectionOutput**, by ``--backend``:

   - ``fused``: kernel K2 at ``stage="decode"``, ``"select"`` and
     ``"full"`` (``ops/pallas_detout.py``), under the reference's keys.
     The port's rungs are NOT prefixes of one program: ``"full"``
     decodes only the candidates, so the decode rung is a launch of its
     own and the deltas need not sum to the kernel's time; the residual
     is reported as measured.  Beside the ladder, K2's block split
     (``pallas_detout.block_phases_us``: the select and merge launches'
     ``%globaltimer`` stamps) gives one decomposition that does telescope;
   - ``pallas``: the legacy four-part split, the selection (decode and
     the stable per-class top-k, ``sweep_candidates``), kernel K1, and the
     final top-k.  The reference's ``approx_max_k`` part times the port's
     exact top-k (the port has no approximate one), and the output says
     so;
   - ``xla``: the plain route, program level only.

Every timed window is ``--iters`` calls fenced by
``torch.cuda.synchronize``, the median of three windows.  The backbone
runs bf16 as the port's serve path does (``make_eval_step(compute_dtype=
"bf16")``: autocast, fp32 weights).  Usage::

    python -m analytics_zoo_tpu_torch.tools.profile_serve
    python -m analytics_zoo_tpu_torch.tools.profile_serve --backend pallas

Writes one ``run_metadata``-stamped JSON to ``--out`` (default
``SERVE_PROFILE_torch.json``; the reference's ``SERVE_PROFILE.json`` is
never written), the card's name and power limit beside every time.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     device_name)

#: a conf head's bias in an ``SSDVgg`` state dict
CONF_BIAS = re.compile(r"(^|\.)conf_\d+\.bias$")

APPROX_NOTE = ("the reference's approx_max_k part times the port's exact "
               "stable top-k: the port has no approximate top-k, so "
               "detout_decode_topk_approx repeats detout_decode_topk's work")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--res", type=int, default=300)
    p.add_argument("--classes", type=int, default=21)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default="SERVE_PROFILE_torch.json")
    p.add_argument("--bg-bias", type=float, default=8.0,
                   help="background-logit shift baked into the conf head "
                        "biases; 0 reproduces the untrained dense-conf "
                        "slow path for comparison")
    p.add_argument("--backend", default="fused",
                   choices=("fused", "pallas", "xla"),
                   help="DetectionOutput backend for BOTH the full "
                        "program and the standalone stages; 'fused' adds "
                        "K2's stage ladder and block split")
    add_device_argument(p)
    return p


def nvidia_smi() -> str:
    """``name, power.limit`` of the first card as nvidia-smi prints them,
    or ``"not available"`` where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "not available"


def timed(fn, *args, iters: int = 10, windows: int = 3) -> float:
    """Seconds a call: the median of ``windows`` windows of ``iters``
    calls, each window ended by a device synchronize (two calls first)."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn(*args)
    fn(*args)
    fence()
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        fence()
        times.append((time.perf_counter() - t0) / iters)
    times.sort()
    return times[len(times) // 2]


def bias_background(state: Dict[str, torch.Tensor], num_classes: int,
                    bg_bias: float) -> Dict[str, torch.Tensor]:
    """A copy of an ``SSDVgg`` state dict with every conf head's
    background-channel bias shifted by ``bg_bias`` (channel ``j`` is class
    ``j % num_classes``; background is class 0)."""
    out = dict(state)
    for name, b in state.items():
        if CONF_BIAS.search(name):
            mask = (torch.arange(b.shape[0], device=b.device)
                    % num_classes) == 0
            out[name] = b + bg_bias * mask.to(b.dtype)
    return out


def _ms(seconds: float) -> float:
    return round(seconds * 1e3, 4)


def run(args) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Profile as ``args`` say; returns ``(report, details)``, details
    holding the backbone's loc/conf, the priors and the param the stages
    ran on."""
    from analytics_zoo_tpu_torch.models.ssd import SSDDetector
    from analytics_zoo_tpu_torch.obs import run_metadata
    from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_nms
    from analytics_zoo_tpu_torch.ops.detection_output import (
        DetectionOutputParam, detection_output, sweep_candidates)
    from analytics_zoo_tpu_torch.ops.nms import topk_stable
    from analytics_zoo_tpu_torch.parallel.train import make_eval_step
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    B, res, C = args.batch, args.res, args.classes
    post = DetectionOutputParam(n_classes=C, backend=args.backend)
    det = SSDDetector(num_classes=C, resolution=res, post=post, device=dev,
                      seed=0).eval()
    # the trained-like background prior in the weights the FULL program
    # runs: the whole and the parts see one conf distribution
    det.ssd.load_state_dict(bias_background(det.ssd.state_dict(), C,
                                            args.bg_bias))
    x = torch.from_numpy(np.random.RandomState(0).rand(B, res, res, 3)
                         .astype(np.float32)).to(dev)
    full = make_eval_step(det, compute_dtype="bf16")
    backbone = make_eval_step(det.ssd, compute_dtype="bf16")
    priors, variances = det.priors, det.variances
    P = priors.shape[0]

    loc, conf_logits = backbone(x)
    loc = loc.float().contiguous()
    conf = torch.softmax(conf_logits.float(), dim=-1).contiguous()

    def detout(l, c):
        return detection_output(l, c, priors, variances, post)

    k = min(pallas_nms._round_up(post.nms_topk, 128),
            pallas_nms._round_up(P, 128))
    Cf = C - 1
    it = args.iters
    k1_before = pallas_nms.nms_sweep.launches
    k2_before = dict(pallas_detout.fused_detection_output.launches_by_stage)
    t_full = timed(full, x, iters=it)
    t_backbone = timed(backbone, x, iters=it)
    t_detout = timed(detout, loc, conf, iters=it)
    residual = t_full - (t_backbone + t_detout)
    valid_counts = (conf[..., 1:].transpose(1, 2) > post.conf_thresh
                    ).sum(-1).reshape(-1).cpu().numpy()

    ms = {
        "full_serve_program": _ms(t_full),
        "backbone_only": _ms(t_backbone),
        "detection_output_total": _ms(t_detout),
        "residual_jit_boundary": _ms(residual),
    }
    detout_coherence = None
    block_split = None

    if args.backend == "fused":
        def stage_fn(stage):
            return lambda l, c: pallas_detout.fused_detection_output(
                l, c, priors, variances, param=post, stage=stage)

        t_decode = timed(stage_fn("decode"), loc, conf, iters=it)
        t_select = timed(stage_fn("select"), loc, conf, iters=it)
        t_kernel = timed(stage_fn("full"), loc, conf, iters=it)
        ms.update({
            "detout_ladder_decode_and_stream": _ms(t_decode),
            "detout_ladder_select_and_sweep": _ms(t_select - t_decode),
            "detout_ladder_global_topk_merge": _ms(t_kernel - t_select),
            "detout_full_kernel": _ms(t_kernel),
        })
        detout_coherence = {
            "ladder_sum_ms": _ms(t_kernel),
            "detout_total_ms": _ms(t_detout),
            "ladder_residual_fraction": round(
                (t_detout - t_kernel) / max(t_detout, 1e-9), 4),
            "rungs_ms": {"decode": _ms(t_decode), "select": _ms(t_select),
                         "full": _ms(t_kernel)},
            "note": "the port's rungs are NOT strict prefixes: 'full' "
                    "decodes only the candidates, so 'decode' is a probe "
                    "launch of its own (every prior decoded and summed) "
                    "and 'select' is the select launch plus that probe; "
                    "the deltas are measured, not telescoping, and need "
                    "not sum to detout_full_kernel.  k2_block_split_us "
                    "(the kernels' %globaltimer stamps) is the split that "
                    "does telescope",
        }
        if dev.type == "cuda":
            boxes, _, valid, _ = sweep_candidates(loc, conf, priors,
                                                  variances, post)
            planes = ([boxes[..., i].reshape(B * Cf, k).contiguous()
                       for i in range(4)] + [valid.reshape(B * Cf, k)])
            block_split = pallas_detout.block_phases_us(
                loc, conf, priors, variances, post, planes)
    elif args.backend == "pallas":
        def stage_topk(l, c):
            return sweep_candidates(l, c, priors, variances, post)

        boxes, top_scores, valid, _ = stage_topk(loc, conf)
        planes = [boxes[..., i].reshape(B * Cf, k).contiguous()
                  for i in range(4)]
        fvalid = valid.reshape(B * Cf, k)

        def stage_sweep(x1, y1, x2, y2, v):
            return pallas_nms.nms_sweep(x1, y1, x2, y2, v,
                                        iou_threshold=post.nms_thresh)

        keep = stage_sweep(*planes, fvalid)

        def stage_final(top_scores, keep, boxes):
            kk = keep.reshape(B, Cf, k)
            sel = torch.where(torch.isfinite(top_scores), top_scores,
                              0.0) * kk
            out_scores, order = topk_stable(sel.reshape(B, Cf * k),
                                            post.keep_topk)
            out_boxes = torch.take_along_dim(boxes.reshape(B, Cf * k, 4),
                                             order[..., None], dim=1)
            return out_scores, out_boxes

        t_topk = timed(stage_topk, loc, conf, iters=it)
        t_topk_approx = timed(stage_topk, loc, conf, iters=it)
        t_sweep = timed(stage_sweep, *planes, fvalid, iters=it)
        t_final = timed(stage_final, top_scores, keep, boxes, iters=it)
        ms.update({
            "detout_decode_topk": _ms(t_topk),
            "detout_decode_topk_approx": _ms(t_topk_approx),
            "detout_pallas_sweep": _ms(t_sweep),
            "detout_final_topk": _ms(t_final),
        })
        parts = t_topk + t_sweep + t_final
        detout_coherence = {
            "ladder_sum_ms": _ms(parts),
            "detout_total_ms": _ms(t_detout),
            "ladder_residual_fraction": round(
                (t_detout - parts) / max(t_detout, 1e-9), 4),
            "note": "legacy decomposition: the parts re-run outside the "
                    "dispatched path, so the residual is real "
                    "unattributed work; " + APPROX_NOTE,
        }
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    k2_after = pallas_detout.fused_detection_output.launches_by_stage
    launches = {
        "nms_sweep": pallas_nms.nms_sweep.launches - k1_before,
        "fused_detection_output_by_stage": {
            s: k2_after[s] - k2_before[s] for s in k2_after},
    }

    report = {
        "device": device_name(dev),
        "nvidia_smi": nvidia_smi() if dev.type == "cuda" else "cpu",
        "batch": B, "resolution": res, "classes": C, "priors": int(P),
        "detout_backend": args.backend,
        "sweep_lanes_k": int(k), "grid_instances": int(B * Cf),
        "bg_bias": args.bg_bias,
        "ms": ms,
        "coherence": {
            "parts_sum_ms": _ms(t_backbone + t_detout),
            "full_ms": _ms(t_full),
            "residual_fraction": round(residual / max(t_full, 1e-9), 4),
        },
        "detout_coherence": detout_coherence,
        "k2_block_split_us": block_split,
        "launches": launches,
        "conf_distribution": (
            "untrained dense (bg_bias=0)" if args.bg_bias == 0 else
            f"trained-like: background bias +{args.bg_bias} baked into "
            "the conf heads; stages timed on the backbone's real output"),
        "valid_candidates_per_class_row": {
            "mean": round(float(valid_counts.mean()), 2),
            "p95": round(float(np.percentile(valid_counts, 95)), 2),
            "max": int(valid_counts.max()),
        },
        "detout_fraction_of_serve": round(t_detout / max(t_full, 1e-9), 4),
        "images_per_sec_full": round(B / t_full, 2),
        "images_per_sec_backbone_only": round(B / t_backbone, 2),
        "note": "device-resident inputs; windows fenced by "
                "torch.cuda.synchronize; bf16 backbone (autocast) as the "
                "port's serve path; whole and parts share one conf "
                "distribution and one backend.  On the CPU the kernels' "
                "plain versions run: its ms are no device times",
        "run_metadata": run_metadata(
            "profile_serve", seed=0,
            extra={"iters": args.iters, "bg_bias": args.bg_bias,
                   "detout_backend": args.backend}),
    }
    details = {"loc": loc, "conf": conf, "priors": priors,
               "variances": variances, "post": post, "x": x}
    return report, details


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report, _ = run(args)
    print(json.dumps(report, indent=2))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
