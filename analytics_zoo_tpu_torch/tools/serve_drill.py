"""One-command seeded overload/failover drill for the serving runtime
(counterpart of ``tools/serve_drill.py``).

Drive the port's ``serving.ServingRuntime`` through the full resilience
story on a virtual clock — a 4× arrival burst, load shedding,
degradation to the int8 tier, a mid-batch replica crash with
exactly-once failover, a wedged (slow) forward caught by the watchdog,
background restarts, and hysteresis recovery back to full quality — and
write the reading to ``SERVE_DRILL_torch.json`` (a name the reference's
artifact lint does not govern; ``tools/check_artifacts.py`` lints it).

Two runs over the SAME seeded arrival script:

- **baseline**: one full-quality tier, no shedding (``shed_expired=
  False``), unbounded-in-practice queue — what the offline predictors
  would do under the burst: everything eventually answers, mostly late;
- **drill**: bounded queue + deadline shedding + the fp→int8 ladder +
  chaos faults — late-doomed work is shed before device dispatch and
  the int8 tier buys back capacity.

The headline comparison is the deadline-miss rate (a shed request
counts as missed; so does a completed-late one): shedding + degradation
must beat the no-shedding baseline, and EVERY submitted request must
end in exactly one terminal state (none lost) in both runs.

The model is a real ``nn.Linear(16, 4)`` on ``--device`` (the card by
default), and the int8 tier really runs ``quantize_params`` weights
through ``make_quantized_forward`` — the drill exercises the true
quantize path, while *time* (service seconds, deadlines, restarts) is
virtual so the report is deterministic from the seed.  Both runs are
executed TWICE and the report records that the replay was
byte-identical.

Usage::

    python -m analytics_zoo_tpu_torch.tools.serve_drill            # full
    python -m analytics_zoo_tpu_torch.tools.serve_drill --smoke    # ~1 s
"""

import argparse
import hashlib
import json
import random
import sys

from analytics_zoo_tpu_torch.examples.common import add_device_argument

#: the reference drill's revision, kept in the report (not in its name)
REVISION = "r03"
DECISION_EVERY = 5      # batches per ladder decision window


def build_arrival_script(rng: random.Random, smoke: bool, monkey) -> list:
    """Seeded arrival script: ``(arrival_t, deadline_s)`` per request
    (ABSOLUTE scheduled arrival instants — open-loop offered load: the
    client's deadline is anchored at when the request was *sent*, not at
    whenever the loaded server got around to admitting it).  Rates are
    shaped by the ``burst_load`` ChaosMonkey window (rate multiplied by
    ``detail["rate_x"]`` while the request index is inside the window) —
    the same ``FaultSpec`` machinery the training drills use, driven by
    the request index instead of the batch index."""
    scale = 4 if smoke else 1
    n = 2000 // scale
    base_rate = 80.0            # req/s; tier-0 capacity is 100 req/s
    script = []
    burst_indices = []
    t = 0.0
    for i in range(n):
        spec = monkey.serving_active("burst_load", i, consume=False)
        if spec is not None:
            burst_indices.append(i)
        rate = base_rate * (float(spec.detail["rate_x"])
                            if spec is not None else 1.0)
        # exponential inter-arrival jitter, seeded — a Poisson process
        t += rng.expovariate(rate)
        script.append((t, 0.3))
    burst = ({"kind": "burst_load", "from_index": burst_indices[0],
              "to_index": burst_indices[-1],
              "requests_in_window": len(burst_indices)}
             if burst_indices else None)
    return script, burst


def run_scenario(script, tiers, tier_speeds, *, shed, chaos=None,
                 queue_capacity, ladder_policy=None, obs=None, slo=None):
    """Replay one arrival script against a fresh runtime; returns the
    runtime (drained: every request terminal).  ``obs`` (an
    ``obs.Observability``) arms the telemetry spine — request-lifecycle
    spans land in its flight recorder on the SAME virtual clock, which is
    what ``tools/obs_drill.py`` records.  ``slo`` (an
    ``obs.slo.SloEvaluator``) switches the degradation ladder onto SLO
    burn-rate decisions — what ``tools/az_trace.py`` records."""
    import numpy as np

    from analytics_zoo_tpu_torch.serving import ServingRuntime, VirtualClock

    clock = VirtualClock()
    base_service_s = 0.08       # per max_batch=8 batch at tier 0

    def service_time(edge, n, tier):
        return base_service_s * tier_speeds[tier]

    rt = ServingRuntime(
        tiers, n_replicas=2, clock=clock,
        queue_capacity=queue_capacity, max_batch=8,
        default_deadline_s=0.3, wedge_timeout_s=1.5, restart_s=2.0,
        service_time=service_time, ladder_policy=ladder_policy,
        decision_every=DECISION_EVERY, shed_expired=shed, chaos=chaos,
        obs=obs, slo=slo)

    from analytics_zoo_tpu_torch.resilience.errors import ServerOverloaded

    rng_payload = random.Random(1234)   # payloads, independent of timing
    i = 0
    while i < len(script):
        if clock.now() < script[i][0]:
            if rt.pump() == 0:
                clock.advance(script[i][0] - clock.now())
            continue
        # submit every arrival whose instant passed during the last
        # dispatch — they are the burst the queue must absorb.  The
        # deadline stays anchored at the SCHEDULED arrival instant, so a
        # request the loaded scheduler admits late has already spent that
        # lateness from its budget (open-loop honesty: the client's
        # clock does not stop because the server is busy).
        while i < len(script) and clock.now() >= script[i][0]:
            t_sched, deadline_s = script[i]
            x = [rng_payload.uniform(-1, 1) for _ in range(16)]
            try:
                rt.submit({"input": np.asarray([x], np.float32)},
                          deadline_s=t_sched + deadline_s - clock.now())
            except ServerOverloaded:
                pass            # accounted as shed(queue_full)
            i += 1
        rt.pump()
    # let the tail drain in virtual time (plus post-load clean windows so
    # the ladder can climb back), then force-flush the stragglers
    for _ in range(200):
        if len(rt.queue) == 0:
            break
        clock.advance(0.05)
        rt.pump()
    for _ in range(80):         # clean decision windows at idle load, so
        clock.advance(0.2)      # the ladder's up_after hysteresis can
        rt.submit({"input": np.zeros((1, 16), np.float32)},  # play out
                  deadline_s=5.0)
        rt.pump(force=True)
    rt.drain()
    return rt


def drill_tiers(seed: int, device=None) -> list:
    """The drill's degradation ladder: a real ``nn.Linear(16, 4)`` tier 0
    (``make_eval_step``) and a REAL weight-only int8 tier 1 through
    ``quantize_params`` / ``make_quantized_forward``, both on ``device``
    (the card unless ``"cpu"``), rows read back as numpy.  The int8 tier
    quantizes the 64-element weight (``min_size=0``): at the reference's
    default ``min_size`` (4096) its tier leaves that weight fp32.  Shared
    with ``tools/obs_drill.py`` so the traced drill serves the same
    model."""
    import numpy as np
    import torch
    from torch import nn

    from analytics_zoo_tpu_torch.parallel import make_eval_step
    from analytics_zoo_tpu_torch.serving.ladder import ServingTier
    from analytics_zoo_tpu_torch.utils.device import resolve_device
    from analytics_zoo_tpu_torch.utils.quantize import (make_quantized_forward,
                                                        quantize_params)

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    module = nn.Linear(16, 4)
    with torch.no_grad():
        module.weight.copy_(torch.randn(4, 16, generator=gen) / 4.0)
        module.bias.copy_(torch.randn(4, generator=gen) * 0.01)
    module = module.to(dev).eval()
    eval_step = make_eval_step(module)
    qparams = quantize_params(module, min_size=0)
    qfwd = make_quantized_forward(module)

    def fwd_fp(batch):
        x = torch.as_tensor(batch["input"], device=dev)
        return eval_step(x).cpu().numpy()

    def fwd_int8(batch):
        x = torch.as_tensor(batch["input"], device=dev)
        return qfwd(qparams, x).cpu().numpy()

    return [ServingTier("fp", fwd_fp, speed=1.0,
                        quality_note="fp32 weights"),
            ServingTier("int8", fwd_int8, speed=0.5,
                        quality_note="weight-only int8 "
                                     "(quantize_params)")]


def serving_drill(seed: int, smoke: bool, device=None) -> dict:
    from analytics_zoo_tpu_torch.resilience.chaos import ChaosMonkey, FaultSpec
    from analytics_zoo_tpu_torch.serving.ladder import LadderPolicy

    tiers = drill_tiers(seed, device)
    tier_speeds = [t.speed for t in tiers]
    scale = 4 if smoke else 1

    def burst_spec():
        # request-index window: 4x arrival rate for the middle ~third
        return FaultSpec("burst_load", 400 // scale,
                         batches=600 // scale, detail={"rate_x": 4.0})

    # ONE seeded arrival script shared by baseline and drill — the
    # miss-rate comparison is over identical offered load.  The burst is
    # workload-side chaos: the generator peeks the burst_load window via
    # the FaultSpec machinery while building the script.
    script, burst_event = build_arrival_script(
        random.Random(seed), smoke, ChaosMonkey([burst_spec()]))
    n = len(script)

    baseline = run_scenario(
        script, tiers[:1], tier_speeds[:1], shed=False, queue_capacity=n)
    base_acct = baseline.accounting()
    base_metrics = baseline.metrics.snapshot()

    def drill_once():
        monkey = ChaosMonkey([
            # dispatch-index faults: the crash lands mid-burst (while the
            # ladder is down), the slow forward after recovery started.
            # Windows span a few dispatches so the round-robin is
            # guaranteed to hand the targeted replica a batch inside the
            # window; the fault is consumed on the first hit, and the
            # fenced replica cannot be re-targeted while fenced, so each
            # fires exactly once
            FaultSpec("replica_crash", 60 // scale, batches=4,
                      detail={"replica": 0}),
            FaultSpec("slow_forward", 120 // scale, batches=4,
                      detail={"replica": 1, "delay_s": 5.0}),
        ])
        policy = LadderPolicy(down_after=2, up_after=6, depth_high=2)
        rt = run_scenario(script, tiers, tier_speeds, shed=True,
                          chaos=monkey, queue_capacity=64,
                          ladder_policy=policy)
        return rt, monkey, policy

    rt, monkey, policy = drill_once()
    drill_acct = rt.accounting()
    snap = rt.snapshot()

    # reproducibility: the whole scenario replays byte-identically
    rt2, _, _ = drill_once()

    def digest(r):
        return hashlib.sha256(json.dumps(
            r.snapshot(), sort_keys=True).encode()).hexdigest()

    replay_identical = digest(rt) == digest(rt2)

    ladder_events = snap["ladder"]["transitions"]
    downs = [e for e in ladder_events if e["kind"] == "tier_down"]
    ups = [e for e in ladder_events if e["kind"] == "tier_up"]
    pool_events = rt.pool.events
    fences = [e for e in pool_events if e["kind"] == "replica_fenced"]
    failovers = [e for e in pool_events if e["kind"] == "failover"]
    restarts = [e for e in pool_events if e["kind"] == "replica_restarted"]
    miss_base = base_metrics["deadline_miss_rate"]
    miss_drill = snap["metrics"]["deadline_miss_rate"]

    checks = {
        "baseline_zero_unaccounted": base_acct["unaccounted"] == 0,
        "drill_zero_unaccounted": drill_acct["unaccounted"] == 0,
        "shedding_beats_no_shedding_baseline": miss_drill < miss_base,
        "shed_happened": snap["metrics"]["shed_total"] > 0,
        "int8_tier_engaged": bool(downs),
        "served_on_int8_tier": "1" in snap["metrics"]["latency_by_tier"],
        "int8_tier_disengaged_with_hysteresis": (
            bool(ups) and snap["ladder"]["tier"] == 0),
        "replica_crash_fenced": any("crash" in e.get("error", "").lower()
                                    or "killed" in e.get("error", "")
                                    for e in fences),
        "wedged_forward_fenced": any("wedged" in e.get("error", "")
                                     for e in fences),
        "failover_exactly_once": (
            bool(failovers)
            and all(r.attempts <= 2 for r in rt.requests)),
        "fenced_replicas_restarted": (len(restarts) >= 1
                                      if fences else True),
        "burst_load_window_fired": burst_event is not None,
        "replay_identical_from_seed": replay_identical,
    }
    return {
        "config": {
            "n_requests": n, "base_rate_req_s": 80.0, "burst_rate_x": 4.0,
            "deadline_s": 0.3, "max_batch": 8,
            "service_s_per_batch_tier0": 0.08,
            "tier_speeds": tier_speeds, "queue_capacity_drill": 64,
            "wedge_timeout_s": 1.5, "restart_s": 2.0,
            "ladder_policy": {"down_after": policy.down_after,
                              "up_after": policy.up_after,
                              "depth_high": policy.depth_high},
            "decision_every_batches": DECISION_EVERY,
        },
        "fault_schedule": [
            {"kind": f.kind, "at_index": f.at_batch, "window": f.batches,
             **f.detail} for f in [burst_spec()] + monkey.faults],
        "baseline_no_shedding": {
            "accounting": base_acct,
            "deadline_miss_rate": miss_base,
            "completed_late": base_metrics[
                "deadline_misses_completed_late"],
            "queue_depth_max": base_metrics["queue_depth_max"],
        },
        "drill": {
            "accounting": drill_acct,
            "metrics": snap["metrics"],
            "ladder": snap["ladder"],
            "replicas": snap["replicas"],
            "pool_events": pool_events,
            "chaos_events": ([burst_event] if burst_event else [])
            + monkey.events,
        },
        "miss_rate": {"baseline_no_shedding": miss_base,
                      "shedding_plus_degradation": miss_drill},
        "checks": {"ok": all(checks.values()), **checks},
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="SERVE_DRILL_torch.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (~500 requests, <10 s CPU)")
    add_device_argument(ap)
    return ap


def run(args) -> dict:
    from analytics_zoo_tpu_torch.obs import run_metadata

    result = serving_drill(args.seed, args.smoke, args.device)
    return {
        "drill": "serve_drill",
        "revision": REVISION,
        "seed": args.seed,
        "smoke": bool(args.smoke),
        "run_metadata": run_metadata("serve_drill", seed=args.seed,
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
    mr = report["miss_rate"]
    acct = report["drill"]["accounting"]
    print(f"serve drill: {report['verdict']} — {acct['submitted']} requests "
          f"({acct['by_state']}), miss rate "
          f"{mr['baseline_no_shedding']:.3f} (no shedding) -> "
          f"{mr['shedding_plus_degradation']:.3f} (shed+degrade), "
          f"{len(report['drill']['pool_events'])} replica events; "
          f"wrote {args.out}")
    return 0 if report["verdict"] == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
