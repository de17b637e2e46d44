"""One-command telemetry-spine drill: a seeded serve-drill flight
recording plus the instrumented-vs-bare step overhead (counterpart of
``tools/obs_drill.py``), written to ``TELEMETRY_DRILL_torch.json`` (a
name the reference's artifact lint does not govern;
``tools/check_artifacts.py`` lints it).

Two halves:

1. **Flight recording** — the serve drill's overload/failover scenario
   (same seeded arrival script, burst window, replica crash + wedge,
   fp→int8 ladder as ``tools/serve_drill.py``) runs with the
   ``obs.Observability`` spine armed: every request's life is a rooted
   span trace (``request`` → ``queue`` → ``dispatch``), replica fences
   trip the black-box dump, and drill completion dumps the full ring.
   The report pins (a) **span conservation** — every request trace is
   one rooted tree and the root statuses reconcile EXACTLY with
   ``ServingRuntime.accounting()``; (b) **byte-identical replay** — the
   whole scenario runs twice from the seed and the JSONL dump's sha256
   must match (everything runs on the VirtualClock).
2. **Overhead A/B** — :func:`obs_overhead_ab`, the port's copy of the
   reference bench's ``obs_overhead_ab``: interleaved instrumented-vs-bare
   train steps of the same full-size MLP on ``--device``; acceptance is
   the direct per-step cost ≤ 3 % of the bare step.

Usage::

    python -m analytics_zoo_tpu_torch.tools.obs_drill            # full
    python -m analytics_zoo_tpu_torch.tools.obs_drill --smoke    # seconds
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import sys
import time

from analytics_zoo_tpu_torch.examples.common import add_device_argument

#: the reference drill's revision, kept in the report (not in its name)
REVISION = "r01"


def traced_scenario(seed: int, smoke: bool, dump_path=None,
                    make_slo=None, device=None, tiers=None):
    """One drill-shaped scenario (burst + crash + wedge + ladder) with
    the obs spine armed; returns ``(runtime, obs, script_len)``.
    ``make_slo(obs)`` (optional) builds a fresh ``obs.slo.SloEvaluator``
    per run (the evaluator is stateful, and the replay-identity check
    re-runs the scenario) — the ladder then steps on SLO burn instead of
    the raw overload flag (``tools/az_trace.py`` records that variant).
    ``tiers`` (default ``serve_drill.drill_tiers(seed, device)``) lets a
    replay reuse the first run's."""
    from analytics_zoo_tpu_torch.obs import Observability
    from analytics_zoo_tpu_torch.resilience.chaos import ChaosMonkey, FaultSpec
    from analytics_zoo_tpu_torch.serving.ladder import LadderPolicy
    from analytics_zoo_tpu_torch.tools.serve_drill import (
        build_arrival_script, drill_tiers, run_scenario)

    scale = 4 if smoke else 1
    if tiers is None:
        tiers = drill_tiers(seed, device)
    tier_speeds = [t.speed for t in tiers]
    script, _burst = build_arrival_script(
        random.Random(seed), smoke,
        ChaosMonkey([FaultSpec("burst_load", 400 // scale,
                               batches=600 // scale,
                               detail={"rate_x": 4.0})]))
    monkey = ChaosMonkey([
        FaultSpec("replica_crash", 60 // scale, batches=4,
                  detail={"replica": 0}),
        FaultSpec("slow_forward", 120 // scale, batches=4,
                  detail={"replica": 1, "delay_s": 5.0}),
    ])
    # capacity sized so NOTHING is dropped: ~3 spans per scripted
    # request + batch spans + pool events + the post-load recovery
    # submissions run_scenario adds — conservation over a ring that
    # evicted early spans would be vacuous
    capacity = len(script) * 4 + 2048
    obs = Observability(capacity=capacity, dump_path=dump_path)
    rt = run_scenario(script, tiers, tier_speeds, shed=True, chaos=monkey,
                      queue_capacity=64,
                      ladder_policy=LadderPolicy(down_after=2, up_after=6,
                                                 depth_high=2),
                      obs=obs,
                      slo=make_slo(obs) if make_slo is not None else None)
    return rt, obs, len(script)


def _median(xs):
    s = sorted(xs)
    n = len(s)
    if n % 2 == 1:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def obs_overhead_ab(hidden: int = 1024, in_dim: int = 32, batch: int = 128,
                    steps: int = 4, chunks: int = 30, warmup: int = 5,
                    device=None):
    """Instrumented-vs-bare train-step A/B — the telemetry spine's cost,
    measured instead of assumed (the port's copy of the reference
    bench's ``obs_overhead_ab``).

    Both sides run the SAME train step over the SAME resident batch on
    ``device``; the instrumented side additionally does exactly what
    ``Optimizer.set_observability`` does per step — start/end a span at
    the step's loader coordinates and feed a ``StepTimer`` registering
    into the shared ``MetricRegistry``.  The sides alternate in pairs of
    short ``steps``-step chunks, each ended by a device synchronize, over
    a deliberately large MLP step; the headline ratio is of total times.
    A DIRECT microbench of the pure instrumentation ops (span + StepTimer
    + registry, no step) gives the per-step cost free of e2e noise, and
    ``overhead_fraction_direct`` — that cost over the measured bare step
    time — is what the ≤ 3 % acceptance gates on (the ratio is kept as
    the evidence that no hidden systematic cost exists)."""
    import numpy as np
    import torch
    from torch import nn

    from analytics_zoo_tpu_torch.core.criterion import MSECriterion
    from analytics_zoo_tpu_torch.obs import Observability
    from analytics_zoo_tpu_torch.parallel import (Adam, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.utils.device import resolve_device
    from analytics_zoo_tpu_torch.utils.profiling import StepTimer

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    module = nn.Sequential(nn.Linear(in_dim, hidden), nn.ReLU(),
                           nn.Linear(hidden, hidden), nn.ReLU(),
                           nn.Linear(hidden, 1))
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen)
                    / np.sqrt(p.shape[-1]))
    module = module.to(dev)
    optim = Adam(1e-3)
    step = make_train_step(module, MSECriterion(), optim)
    rng = np.random.RandomState(0)
    dev_batch = {
        "input": torch.as_tensor(rng.randn(batch, in_dim), dtype=torch.float32,
                                 device=dev),
        "target": torch.as_tensor(rng.randn(batch, 1), dtype=torch.float32,
                                  device=dev)}
    state = create_train_state(module, optim)

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        state, metrics = step(state, dev_batch)
    fence()

    obs = Observability(capacity=max(4096, chunks * steps + 64))
    timer = StepTimer("train/dispatch", registry=obs.registry)
    tracer = obs.tracer
    counters = {"it": 0}

    def chunk_bare():
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, dev_batch)
        fence()
        return time.perf_counter() - t0

    def chunk_instrumented():
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(steps):
            it = counters["it"]
            span = tracer.start("train_step", f"train-e0-b{it}",
                                iteration=it, epoch=0, batch=it)
            with timer.step(batch):
                state, _ = step(state, dev_batch)
            span.end(status="ok")
            counters["it"] = it + 1
        fence()
        return time.perf_counter() - t0

    t_bare = t_instr = 0.0
    pair_ratios = []                 # per-pair instr/bare RATE ratio
    for c in range(chunks):
        if c % 2 == 0:
            b = chunk_bare()
            i = chunk_instrumented()
        else:
            i = chunk_instrumented()
            b = chunk_bare()
        t_bare += b
        t_instr += i
        pair_ratios.append(b / max(i, 1e-12))
    ratio = t_bare / t_instr         # instrumented/bare rate, on totals

    # direct microbench: the pure per-step instrumentation ops with a
    # no-op "step" — the µs-scale cost, free of e2e scheduler noise
    obs_d = Observability(capacity=4096)
    timer_d = StepTimer("train/dispatch", registry=obs_d.registry)
    n_direct = 5000
    t0 = time.perf_counter()
    for i in range(n_direct):
        span = obs_d.tracer.start("train_step", f"train-e0-b{i}",
                                  iteration=i, epoch=0, batch=i)
        with timer_d.step(batch):
            pass
        span.end(status="ok")
    instr_us = (time.perf_counter() - t0) / n_direct * 1e6
    bare_step_us = t_bare / (chunks * steps) * 1e6
    direct_frac = instr_us / bare_step_us
    return {
        "config": {"hidden": hidden, "in_dim": in_dim, "batch": batch,
                   "steps_per_chunk": steps, "chunk_pairs": chunks,
                   "device": str(dev)},
        "bare_steps_per_sec": round(chunks * steps / t_bare, 2),
        "instrumented_steps_per_sec": round(chunks * steps / t_instr, 2),
        "pair_ratio_p25_p50_p75": [
            round(_median(sorted(pair_ratios)[:len(pair_ratios) // 2]), 4),
            round(_median(pair_ratios), 4),
            round(_median(sorted(pair_ratios)[len(pair_ratios) // 2:]), 4)],
        "ratio_of_totals": round(ratio, 4),
        "overhead_fraction": round(1.0 - ratio, 4),
        "instrumentation_us_per_step": round(instr_us, 2),
        "bare_step_us": round(bare_step_us, 1),
        "overhead_fraction_direct": round(direct_frac, 5),
        "spans_recorded": obs.tracer.spans_ended,
        "ring_dropped": obs.recorder.dropped,
        "registry_step_count": obs.registry.histogram(
            "train/dispatch/step_s").count,
        # the GATE is the direct measurement (the e2e ratio's noise floor
        # on a shared host sits above the µs-scale signal)
        "overhead_le_3pct": direct_frac <= 0.03,
    }


def obs_drill(seed: int, smoke: bool, flight_path=None, device=None,
              overhead_chunks=None) -> dict:
    """The drill.  ``overhead_chunks`` (default 10 smoke, 30 full) sets
    the A/B's chunk pairs; 0 leaves the timed A/B out (and its check)."""
    from analytics_zoo_tpu_torch.obs import (render_prometheus,
                                             span_conservation)
    from analytics_zoo_tpu_torch.tools.serve_drill import drill_tiers

    tiers = drill_tiers(seed, device)
    rt, obs, n_script = traced_scenario(seed, smoke, dump_path=flight_path,
                                        tiers=tiers)
    text = obs.dump("drill_complete")
    digest = hashlib.sha256(text.encode()).hexdigest()

    # byte-identical replay: the ENTIRE flight recording re-derives from
    # the seed (virtual clock + deterministic span/trace ids)
    rt2, obs2, _ = traced_scenario(seed, smoke, tiers=tiers)
    replay_identical = (hashlib.sha256(
        obs2.dump("drill_complete").encode()).hexdigest() == digest)

    events = obs.recorder.events()
    cons = span_conservation(events)
    acct = rt.accounting()
    # root statuses must reconcile with the runtime's own accounting —
    # the span layer cannot lose or invent a request
    by_state = dict(acct["by_state"])
    reconciled = (cons["traces"] == acct["submitted"]
                  and cons["roots_by_status"] == by_state)
    fence_dumps = [d for d in obs.recorder.dumps
                   if d["reason"] == "replica_fenced"]
    fenced = [e for e in events if e.get("kind") == "replica_fenced"]

    # the MODEL stays full-size even in smoke: the overhead is an
    # ~O(µs)/step host cost, only meaningful against a realistically-
    # sized (~25 ms) step — shrinking the model would measure python
    # noise against a trivial step, not the spine against a train step
    # (see obs_overhead_ab's measurement-design note)
    if overhead_chunks is None:
        overhead_chunks = 10 if smoke else 30
    overhead = (obs_overhead_ab(chunks=overhead_chunks, device=device)
                if overhead_chunks else {"skipped": True})

    checks = {
        "span_conservation_ok": cons["ok"],
        "roots_reconcile_with_accounting": reconciled,
        "zero_unaccounted": acct["unaccounted"] == 0,
        "nothing_dropped_from_ring": obs.recorder.dropped == 0,
        "replay_byte_identical_from_seed": replay_identical,
        "fence_tripped_black_box_dump": (bool(fence_dumps)
                                         if flight_path else bool(fenced)),
    }
    if overhead_chunks:
        checks["overhead_le_3pct"] = overhead["overhead_le_3pct"]
    spans = [e for e in events if e.get("kind") == "span"]
    by_name = {}
    for s in spans:
        by_name[s["name"]] = by_name.get(s["name"], 0) + 1
    return {
        "serve_trace": {
            "scripted_requests": n_script,
            "submitted_total": acct["submitted"],
            "accounting": acct,
            "ring_capacity": obs.recorder.capacity,
            "events_recorded": len(events),
            "events_dropped": obs.recorder.dropped,
            "spans": len(spans),
            "spans_by_name": dict(sorted(by_name.items())),
            "conservation": cons,
            "dumps": obs.recorder.dumps,
            "trace_sha256": digest,
            "replay_identical": replay_identical,
            "events_head": events[:3],
            "events_tail": events[-2:],
        },
        "metrics_snapshot": rt.snapshot()["metrics"],
        "prometheus_sample": render_prometheus(
            obs.registry).splitlines()[:8],
        "obs_overhead": overhead,
        "checks": {"ok": all(checks.values()), **checks},
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="TELEMETRY_DRILL_torch.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (~500 requests, seconds of CPU)")
    ap.add_argument("--flight-out", default=None,
                    help="also write the full flight-recorder JSONL here "
                         "(the report itself keeps counts + sha256)")
    add_device_argument(ap)
    return ap


def run(args, overhead_chunks=None) -> dict:
    from analytics_zoo_tpu_torch.obs import run_metadata

    result = obs_drill(args.seed, args.smoke, flight_path=args.flight_out,
                       device=args.device, overhead_chunks=overhead_chunks)
    return {
        "drill": "obs_drill",
        "revision": REVISION,
        "seed": args.seed,
        "smoke": bool(args.smoke),
        "run_metadata": run_metadata("obs_drill", seed=args.seed,
                                     extra={"smoke": bool(args.smoke)}),
        **result,
        "verdict": "PASS" if result["checks"]["ok"] else "FAIL",
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = run(args)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    st = report["serve_trace"]
    oh = report["obs_overhead"]
    print(f"obs drill: {report['verdict']} — {st['spans']} spans over "
          f"{st['submitted_total']} requests "
          f"({st['conservation']['roots_by_status']}), replay identical: "
          f"{st['replay_identical']}, step overhead "
          f"{oh['overhead_fraction_direct']*100:.2f}% direct "
          f"({oh['instrumentation_us_per_step']}us/step; e2e ratio "
          f"{oh['ratio_of_totals']} ~1 within noise); wrote {args.out}")
    return 0 if report["verdict"] == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
