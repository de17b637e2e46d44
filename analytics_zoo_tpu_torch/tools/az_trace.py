"""az-trace: trace analytics, tail attribution, and SLO burn reports
over the telemetry spine — plus the seeded SLO drill (counterpart of
``tools/az_trace.py``).

Four modes over one substrate (``obs.trace.TraceStore`` +
``obs.slo.SloEvaluator``):

- **query** a flight recording:
  ``--flight f.jsonl --attribute`` (p99-vs-p50 tail attribution),
  ``--flight f.jsonl --critical-path req-42`` (one request's segment
  decomposition), ``--flight f.jsonl --slo-report`` (the burn-rate
  decision timeline the runtime noted into the black box);
- **drill** (``--drill [--smoke]``): re-run the 2080-request
  overload/failover scenario with the degradation ladder driven by the
  SLO burn-rate engine instead of the raw overload flag, run the full
  analysis stack over the recording, and write everything to
  ``AZ_TRACE_torch.json`` (a name the reference's artifact lint does not
  govern; ``tools/check_artifacts.py`` lints it) — seeded,
  sha256-replayable, metadata-stamped;
- **sentinel** (``--sentinel BASELINE.json``): re-run the drill at the
  baseline's size and diff the fresh attribution/SLO report against
  the baseline (a report this tool's ``--drill`` wrote) — exits
  non-zero on a tail regression (p99 grew, a segment's tail share grew,
  more requests lost, more SLO trips, a hotter peak burn).
  Deterministic from the seed, so baseline-vs-self is clean by
  construction; a real regression means the *code* changed the tail.

Usage::

    python -m analytics_zoo_tpu_torch.tools.az_trace --drill
    python -m analytics_zoo_tpu_torch.tools.az_trace --drill --smoke
    python -m analytics_zoo_tpu_torch.tools.az_trace --flight f.jsonl \
        --attribute
    python -m analytics_zoo_tpu_torch.tools.az_trace --flight f.jsonl \
        --critical-path req-3
    python -m analytics_zoo_tpu_torch.tools.az_trace --flight f.jsonl \
        --slo-report
    python -m analytics_zoo_tpu_torch.tools.az_trace \
        --sentinel AZ_TRACE_torch.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.examples.common import add_device_argument

#: the reference drill's revision, kept in the report (not in its name)
REVISION = "r02"

#: drill SLO configuration — ratio objectives only on purpose: the
#: threshold (p99) kind reads cumulative reservoir stats, whose long
#: memory would hold the ladder down through the idle tail; the
#: windowed ratio objectives are the control-loop-shaped ones
MISS_BUDGET = 0.2
SHED_BUDGET = 0.15
#: 5 min / 1 h equivalent windows shrunk onto the drill's virtual
#: seconds: 300 s -> 3 s (fast), 3600 s -> 36 s (slow)
TIME_SCALE = 1.0 / 100.0


def slo_factory(time_scale: float = TIME_SCALE):
    """Fresh-evaluator factory for ``traced_scenario(make_slo=)`` —
    the evaluator is stateful, and the replay-identity check needs a
    pristine one per run."""
    def make_slo(obs):
        from analytics_zoo_tpu_torch.obs.slo import (SloEvaluator,
                                                     deadline_miss_slo,
                                                     shed_rate_slo)

        return SloEvaluator(
            [deadline_miss_slo(MISS_BUDGET), shed_rate_slo(SHED_BUDGET)],
            time_scale=time_scale, registry=obs.registry)
    return make_slo


def run_slo_drill(seed: int, smoke: bool, flight_path: Optional[str] = None,
                  device=None, tiers=None):
    """One SLO-driven traced scenario (the obs-drill scenario with the
    ladder on burn-rate decisions); returns ``(runtime, obs, text,
    analysis)`` where ``text`` is the flight JSONL and ``analysis`` the
    full derived report (attribution + conservation + SLO)."""
    from analytics_zoo_tpu_torch.obs import TraceStore, span_conservation
    from analytics_zoo_tpu_torch.tools.obs_drill import traced_scenario

    rt, obs, n_script = traced_scenario(seed, smoke,
                                        dump_path=flight_path,
                                        make_slo=slo_factory(),
                                        device=device, tiers=tiers)
    text = obs.dump("drill_complete")
    store = TraceStore.from_jsonl(text)
    acct = rt.accounting()
    cons = span_conservation(store.events)
    analysis = {
        "scripted_requests": n_script,
        "accounting": acct,
        "span_conservation": cons,
        "roots_reconcile_with_accounting": (
            cons["traces"] == acct["submitted"]
            and cons["roots_by_status"] == dict(acct["by_state"])),
        "critical_path_conservation": store.critical_path_conservation(),
        "tail_attribution": store.tail_attribution(),
        "slo": rt.slo.report(),
        "ladder": rt.snapshot()["ladder"],
    }
    return rt, obs, text, analysis


def _pick_examples(store) -> Dict[str, Any]:
    """Deterministic p50/p99 exemplar critical paths for the artifact
    (ties broken by trace id)."""
    done = store.requests("done")
    if not done:
        return {}
    paths = sorted((store.critical_path(t) for t in done),
                   key=lambda p: (p["latency_s"], p["trace"]))
    mid = paths[len(paths) // 2]
    worst = paths[-1]

    def rounded(cp):
        return {**cp,
                "latency_s": round(cp["latency_s"], 6),
                "residual_s": round(cp["residual_s"], 9),
                "segments": {k: round(v, 6)
                             for k, v in cp["segments"].items()}}

    return {"median": rounded(mid), "worst": rounded(worst)}


def az_trace_drill(seed: int, smoke: bool,
                   flight_path: Optional[str] = None,
                   device=None) -> Dict[str, Any]:
    """The drill: run the SLO-driven scenario twice from the seed, pin
    byte-identical replay of both the flight recording AND the derived
    analysis, and assemble the report."""
    from analytics_zoo_tpu_torch.tools.serve_drill import drill_tiers

    tiers = drill_tiers(seed, device)
    rt, obs, text, analysis = run_slo_drill(seed, smoke,
                                            flight_path=flight_path,
                                            tiers=tiers)
    digest = hashlib.sha256(text.encode()).hexdigest()

    _, _, text2, analysis2 = run_slo_drill(seed, smoke, tiers=tiers)
    digest2 = hashlib.sha256(text2.encode()).hexdigest()

    def canon(d):
        return json.dumps(d, sort_keys=True)

    replay_identical = digest == digest2
    analysis_identical = canon(analysis) == canon(analysis2)

    from analytics_zoo_tpu_torch.obs import TraceStore

    store = TraceStore.from_jsonl(text)
    slo_rep = analysis["slo"]
    ladder = analysis["ladder"]
    downs = [e for e in ladder["transitions"] if e["kind"] == "tier_down"]
    ups = [e for e in ladder["transitions"] if e["kind"] == "tier_up"]
    trips = [e for e in slo_rep["timeline"] if e["new_trips"]]
    # the step-down must be SLO-attributed: its transition detail names
    # the burning SLOs (observe_decision wrote them there)
    slo_downs = [e for e in downs if e.get("slo_burning")]
    attr = analysis["tail_attribution"]
    cpc = analysis["critical_path_conservation"]
    slo_notes = store.events_of("slo_decision")

    checks = {
        "zero_unaccounted": analysis["accounting"]["unaccounted"] == 0,
        "span_conservation_ok": analysis["span_conservation"]["ok"],
        "roots_reconcile_with_accounting":
            analysis["roots_reconcile_with_accounting"],
        "critical_path_conservation_ok": cpc["ok"],
        "attribution_has_dominant_segment":
            bool(attr.get("dominant_segment")),
        "fast_window_trip_happened": bool(trips),
        "trip_drove_ladder_step_down": bool(slo_downs),
        "ladder_recovered_to_tier0": (bool(ups)
                                      and ladder["tier"] == 0),
        "slo_decisions_in_black_box": (
            len(slo_notes) == slo_rep["decisions"]),
        "nothing_dropped_from_ring": obs.recorder.dropped == 0,
        "replay_byte_identical_from_seed": replay_identical,
        "analysis_replay_identical": analysis_identical,
    }
    return {
        "config": {
            "slo_budgets": {"deadline-miss-rate": MISS_BUDGET,
                            "shed-rate": SHED_BUDGET},
            "windows": slo_rep["windows"],
            "decision_driver": "SloEvaluator.decide "
                               "(multi-window burn rate)",
        },
        "serve_trace": {
            "scripted_requests": analysis["scripted_requests"],
            "accounting": analysis["accounting"],
            "events_recorded": len(store.events),
            "spans": store.summary()["spans"],
            "conservation": analysis["span_conservation"],
            "trace_sha256": digest,
            "replay_identical": replay_identical,
        },
        "critical_path_conservation": {
            "checked": cpc["checked"],
            "violations": cpc["violations"],
            "tolerance_s": 2e-6,
        },
        "tail_attribution": attr,
        "critical_path_examples": _pick_examples(store),
        "slo": slo_rep,
        "ladder": ladder,
        "checks": {"ok": all(checks.values()), **checks},
    }


# ---------------------------------------------------------------------------
# regression sentinel
# ---------------------------------------------------------------------------

def _lost_fraction(attr: Dict[str, Any]) -> float:
    by_status = attr.get("by_status", {})
    total = sum(by_status.values())
    if not total:
        return 0.0
    return (total - by_status.get("done", 0)) / total


def sentinel_diff(baseline: Dict[str, Any], fresh: Dict[str, Any],
                  rtol: float = 0.10, atol: float = 5e-4) -> List[str]:
    """Tail-regression diff between two drill reports (baseline a report
    this tool wrote, fresh a just-run drill at the same size).  Returns
    human-readable regression strings; empty means clean.  Only
    *growth* regresses — a faster tail is an improvement, not a
    finding."""
    regressions: List[str] = []

    def grew(name: str, b: Optional[float], f: Optional[float]) -> None:
        if b is None or f is None:
            if (b is None) != (f is None):
                regressions.append(f"{name}: {b} -> {f} (appeared/"
                                   f"vanished)")
            return
        if f > b * (1.0 + rtol) + atol:
            regressions.append(
                f"{name}: {b:.6f} -> {f:.6f} "
                f"(+{(f - b):.6f}, > {rtol:.0%}+{atol} tolerance)")

    b_attr = baseline.get("tail_attribution", {})
    f_attr = fresh.get("tail_attribution", {})
    b_pct = b_attr.get("percentiles", {})
    f_pct = f_attr.get("percentiles", {})
    grew("p99 latency (s)", b_pct.get("p99_s"), f_pct.get("p99_s"))
    grew("p50 latency (s)", b_pct.get("p50_s"), f_pct.get("p50_s"))
    grew("cohort gap (s)", b_attr.get("cohort_gap_s"),
         f_attr.get("cohort_gap_s"))
    for seg in sorted(set(b_attr.get("segments", {}))
                      | set(f_attr.get("segments", {}))):
        grew(f"segment {seg} p99-cohort mean (s)",
             b_attr.get("segments", {}).get(seg, {}).get("p99_mean_s"),
             f_attr.get("segments", {}).get(seg, {}).get("p99_mean_s"))
    grew("non-done request fraction",
         _lost_fraction(b_attr), _lost_fraction(f_attr))

    b_slo = baseline.get("slo", {})
    f_slo = fresh.get("slo", {})
    grew("total SLO trips",
         float(sum(b_slo.get("trips", {}).values())),
         float(sum(f_slo.get("trips", {}).values())))
    for name in sorted(set(b_slo.get("peak_burns", {}))
                       | set(f_slo.get("peak_burns", {}))):
        grew(f"peak fast burn [{name}]",
             b_slo.get("peak_burns", {}).get(name, {}).get("fast"),
             f_slo.get("peak_burns", {}).get(name, {}).get("fast"))
    return regressions


def run_sentinel(baseline_path: str, rtol: float = 0.10,
                 device=None) -> Tuple[int, List[str]]:
    """Load the baseline, re-run the drill at the same size and seed,
    diff.  Returns ``(exit_code, regressions)``."""
    with open(baseline_path) as f:
        baseline = json.load(f)
    seed = int(baseline.get("seed", 0))
    smoke = bool(baseline.get("smoke", False))
    fresh = az_trace_drill(seed, smoke, device=device)
    regressions = sentinel_diff(baseline, fresh, rtol=rtol)
    if not fresh["checks"]["ok"]:
        failed = [k for k, v in fresh["checks"].items()
                  if k != "ok" and not v]
        regressions.append(f"fresh drill checks failed: {failed}")
    return (1 if regressions else 0), regressions


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _print_attribution(store) -> None:
    from analytics_zoo_tpu_torch.obs import attribution_rows

    report = store.tail_attribution()
    if not report.get("n_done"):
        print("no completed requests to attribute")
        return
    pct = report["percentiles"]
    print(f"tail attribution over {report['n_done']} completed requests "
          f"(all statuses: {report['by_status']})")
    print(f"  p50={pct['p50_s'] * 1e3:.3f}ms  "
          f"p99={pct['p99_s'] * 1e3:.3f}ms  cohort gap "
          f"{report['cohort_gap_s'] * 1e3:.3f}ms")
    for _, row in attribution_rows(report):
        print("  " + row)
    print(f"  dominant segment: {report['dominant_segment']}")


def _print_slo_report(store) -> None:
    decisions = store.events_of("slo_decision")
    if not decisions:
        print("no slo_decision events in this recording (the runtime "
              "was not armed with an SloEvaluator)")
        return
    trips = [d for d in decisions if d.get("new_trips")]
    overloaded = sum(1 for d in decisions if d.get("overloaded"))
    print(f"{len(decisions)} SLO decisions: {overloaded} overloaded, "
          f"{len(trips)} trips")
    for d in trips:
        print(f"  t={d['t']:.3f}s TRIP {d['new_trips']} "
              f"(burning={d['burning']})")
    recovered = [d for d in decisions if d.get("recovered")]
    for d in recovered:
        print(f"  t={d['t']:.3f}s RECOVERED {d['recovered']}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--flight", default=None,
                    help="flight-recorder JSONL to analyze")
    ap.add_argument("--attribute", action="store_true",
                    help="print the p99-vs-p50 tail-attribution report")
    ap.add_argument("--critical-path", default=None, metavar="TRACE",
                    help="print one trace's segment decomposition "
                         "(e.g. req-42)")
    ap.add_argument("--slo-report", action="store_true",
                    help="print the SLO decision timeline from the "
                         "recording")
    ap.add_argument("--drill", action="store_true",
                    help="run the SLO-driven traced drill and write the "
                         "report")
    ap.add_argument("--sentinel", default=None, metavar="BASELINE",
                    help="re-run the drill and diff against a baseline "
                         "report; exit 1 on tail regression")
    ap.add_argument("--rtol", type=float, default=0.10,
                    help="sentinel relative growth tolerance")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized drill (~500 requests)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="AZ_TRACE_torch.json")
    ap.add_argument("--flight-out", default=None,
                    help="also write the drill's flight JSONL here")
    add_device_argument(ap)
    return ap


def drill_report(args) -> Dict[str, Any]:
    """``--drill``'s stamped report."""
    from analytics_zoo_tpu_torch.obs import run_metadata

    result = az_trace_drill(args.seed, args.smoke,
                            flight_path=args.flight_out, device=args.device)
    return {
        "drill": "az_trace",
        "revision": REVISION,
        "seed": args.seed,
        "smoke": bool(args.smoke),
        "run_metadata": run_metadata("az_trace", seed=args.seed,
                                     extra={"smoke": bool(args.smoke)}),
        **result,
        "verdict": "PASS" if result["checks"]["ok"] else "FAIL",
    }


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.sentinel:
        code, regressions = run_sentinel(args.sentinel, rtol=args.rtol,
                                         device=args.device)
        if regressions:
            for r in regressions:
                print(f"az_trace sentinel: REGRESSION {r}")
        else:
            print("az_trace sentinel: CLEAN — fresh drill matches "
                  f"{args.sentinel} within tolerances")
        return code

    if args.drill:
        report = drill_report(args)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
        st = report["serve_trace"]
        attr = report["tail_attribution"]
        slo = report["slo"]
        print(f"az_trace drill: {report['verdict']} — "
              f"{st['accounting']['submitted']} requests "
              f"({st['accounting']['by_state']}), dominant tail segment "
              f"{attr.get('dominant_segment')}, "
              f"{sum(slo['trips'].values())} SLO trips over "
              f"{slo['decisions']} decisions, replay identical: "
              f"{st['replay_identical']}; wrote {args.out}")
        return 0 if report["verdict"] == "PASS" else 1

    if not args.flight:
        ap.error("need --flight <jsonl>, --drill, or --sentinel")

    from analytics_zoo_tpu_torch.obs import TraceStore, format_critical_path

    store = TraceStore.from_file(args.flight)
    did_something = False
    if args.critical_path:
        print(format_critical_path(store.critical_path(
            args.critical_path)))
        did_something = True
    if args.attribute:
        _print_attribution(store)
        did_something = True
    if args.slo_report:
        _print_slo_report(store)
        did_something = True
    if not did_something:
        s = store.summary()
        print(f"{s['events']} events, {s['spans']} spans, "
              f"{s['requests']} request traces "
              f"(kinds: {s['events_by_kind']})")
        print("use --attribute, --critical-path <trace>, or "
              "--slo-report")
    return 0


if __name__ == "__main__":
    sys.exit(main())
