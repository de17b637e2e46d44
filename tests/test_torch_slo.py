"""The port's SLO engine (``obs/slo.py``) against the JAX package's, on
the CPU.

The same seeded sequences of registry snapshots go through both
packages' ``SloEvaluator``: the decisions must be equal (the burning set,
the trips and recoveries, ``scale_hint``, the windows' fractions and
values), the burn rates within 1e-12, and so the report and the
registry mirror.  The SLO builders, the validation and the ladder's
``observe_decision`` are held equal too.
"""

import math

import numpy as np
import pytest

import analytics_zoo_tpu.obs.registry as jreg
import analytics_zoo_tpu.obs.slo as jslo
import analytics_zoo_tpu.serving.ladder as jladder
import analytics_zoo_tpu_torch.obs.registry as treg
import analytics_zoo_tpu_torch.obs.slo as tslo
import analytics_zoo_tpu_torch.serving.ladder as tladder
from test_torch_serving import _jsonable

BURN_TOL = 1e-12
PKGS = {"reference": (jslo, jreg, jladder), "port": (tslo, treg, tladder)}


def _slos(slo):
    return (slo.default_serving_slos() + slo.model_slos("ds2")
            + slo.model_slos("ssd", miss_budget=0.05, shed_budget=0.02)
            + slo.canary_slos("ds2", 1e-3, 0.2, rollout=1)
            + [slo.SLO(name="custom", kind="ratio", budget=0.3,
                       bad=("serve/failed",), total=("serve/completed",
                                                     "serve/failed"))])


def _stream(seed, n, regime):
    """A seeded sequence of ``(t, registry snapshot)``: counters that
    only grow (a quiet start, a burst of sheds and misses, a recovery)
    and latency histograms whose p99 moves."""
    rng = np.random.RandomState(seed)
    names = ["serve/submitted", "serve/completed", "serve/failed",
             "serve/deadline_misses_completed_late",
             "serve/shed/cause=deadline", "serve/shed/cause=queue_full"]
    for m in ("ds2", "ssd"):
        names += [f"serve/submitted/model={m}", f"serve/completed/model={m}",
                  f"serve/failed/model={m}",
                  f"serve/deadline_misses_completed_late/model={m}",
                  f"serve/shed/model={m}/cause=deadline"]
    counts = dict.fromkeys(names, 0)
    t = 0.0
    out = []
    for i in range(n):
        t += float(rng.choice([0.05, 0.5, 3.0, 40.0]) if regime == "gappy"
                   else rng.uniform(0.2, 2.0))
        phase = "burst" if n // 3 <= i < 2 * n // 3 else "calm"
        for k in counts:
            bad = ("shed" in k or "failed" in k or "misses" in k)
            lam = (6.0 if bad else 20.0) if phase == "burst" else (
                0.2 if bad else 20.0)
            counts[k] += int(rng.poisson(lam))
        hist = {}
        for m in ("ds2", "ssd"):
            for tier in (0, 1):
                p99 = float(rng.uniform(0.05, 1.5 if phase == "burst"
                                        else 0.3))
                hist[f"serve/latency_s/tier={tier}"] = {"p99": p99,
                                                        "p50": p99 / 3}
                hist[f"serve/latency_s/model={m}/tier={tier}"] = {
                    "p99": p99 * 1.1}
        if i % 4:
            hist["serve/canary/divergence/model=ds2/swap=1"] = {
                "max": float(rng.uniform(0, 2e-3))}
        out.append((t, {"counters": dict(counts), "gauges": {},
                        "histograms": hist}))
    return out


def _run(pkg, stream, **kw):
    slo, reg, _ = PKGS[pkg]
    registry = reg.MetricRegistry()
    ev = slo.SloEvaluator(slos=_slos(slo), registry=registry, **kw)
    decisions = []
    for t, snap in stream:
        ev.observe(snap, t)
        decisions.append(ev.decide(t).as_dict())
    return decisions, ev.report(), registry.snapshot(), ev.trips()


def _burns(decisions):
    return [p[w]["burn"] for d in decisions for p in d["per_slo"].values()
            for w in ("fast", "slow")]


def _strip_burns(decisions):
    out = []
    for d in decisions:
        d = dict(d, per_slo={k: {**v, "fast": {x: y for x, y in
                                               v["fast"].items()
                                               if x != "burn"},
                                 "slow": {x: y for x, y in v["slow"].items()
                                          if x != "burn"}}
                             for k, v in d["per_slo"].items()})
        out.append(d)
    return out


@pytest.mark.parametrize("seed,n,regime,kw", [
    (0, 60, "steady", {}),
    (1, 60, "steady", {"fast_window_s": 300.0, "slow_window_s": 3600.0,
                       "time_scale": 0.01}),
    (2, 90, "gappy", {"fast_window_s": 2.0, "slow_window_s": 20.0}),
    (3, 40, "steady", {"fast_burn": 1.5, "slow_burn": 0.8,
                       "recover_burn": 0.2, "time_scale": 0.003}),
    (4, 50, "gappy", {"timeline_cap": 7, "time_scale": 0.02}),
], ids=["default", "scaled", "gappy", "thresholds", "ring"])
def test_decisions_equal_to_reference(seed, n, regime, kw):
    stream = _stream(seed, n, regime)
    ref = _run("reference", stream, **kw)
    got = _run("port", stream, **kw)
    assert _jsonable(_strip_burns(got[0])) == _jsonable(_strip_burns(ref[0]))
    np.testing.assert_allclose(_burns(got[0]), _burns(ref[0]), rtol=0,
                               atol=BURN_TOL)
    for g, r in zip(got[1:], ref[1:]):
        assert _jsonable(g) == _jsonable(r)
    # the streams reach what they are for: trips, recoveries, both hints
    hints = {d["scale_hint"] for d in got[0]}
    assert any(d["new_trips"] for d in got[0])
    assert any(d["recovered"] for d in got[0]) or regime == "gappy"
    assert 1 in hints and (hints & {0, -1})


def test_observe_registry_equal_to_reference():
    """Both evaluators fed a live registry (the runtime's path): the
    counters are read directly, the reservoirs only for threshold SLOs."""
    out = {}
    for pkg, (slo, reg, _) in PKGS.items():
        registry = reg.MetricRegistry(seed=3)
        ev = slo.SloEvaluator(slos=[slo.deadline_miss_slo(0.1),
                                    slo.p99_latency_slo(0.2)],
                              fast_window_s=1.0, slow_window_s=5.0)
        rng = np.random.RandomState(5)
        decisions = []
        for step in range(40):
            for _ in range(rng.randint(1, 6)):
                registry.counter("serve/completed").inc()
                registry.histogram("serve/latency_s/tier=0").observe(
                    float(rng.exponential(0.1 if step < 20 else 0.4)))
            if step >= 15:
                registry.counter("serve/shed/cause=deadline").inc(
                    int(rng.randint(0, 3)))
            ev.observe_registry(registry, 0.25 * step)
            decisions.append(ev.decide(0.25 * step).as_dict())
        out[pkg] = _jsonable({"d": decisions, "r": ev.report()})
    assert out["port"] == out["reference"]
    assert any(d["burning"] for d in out["port"]["d"])


def test_builders_and_validation_equal_to_reference():
    got = [(s.name, s.kind, s.budget, s.bad, s.total, s.value,
            s.description) for s in _slos(tslo)]
    want = [(s.name, s.kind, s.budget, s.bad, s.total, s.value,
             s.description) for s in _slos(jslo)]
    assert got == want
    assert [s.name for s in tslo.canary_slos("m", 0.1)] == [
        "canary-divergence/model=m"]
    for slo in (tslo, jslo):
        for kw, match in (({"kind": "quantile"}, "unknown kind"),
                          ({"budget": 0.0}, "budget"),
                          ({"bad": ()}, "bad= and total="),
                          ({"kind": "threshold", "value": "x"},
                           "threshold kind")):
            args = dict(name="x", kind="ratio", budget=0.1, bad=("a",),
                        total=("b",))
            args.update(kw)
            with pytest.raises(ValueError, match=match):
                slo.SLO(**args)
        with pytest.raises(ValueError, match="at least one"):
            slo.SloEvaluator(slos=[])
        with pytest.raises(ValueError, match="duplicate"):
            slo.SloEvaluator(slos=[slo.shed_rate_slo()] * 2)
        with pytest.raises(ValueError, match="shorter"):
            slo.SloEvaluator(fast_window_s=10.0, slow_window_s=5.0)
        with pytest.raises(ValueError, match="time_scale"):
            slo.SloEvaluator(time_scale=0.0)
        ev = slo.SloEvaluator()
        ev.observe({"counters": {}}, 1.0)
        with pytest.raises(ValueError, match="older"):
            ev.observe({"counters": {}}, 0.5)
        d = ev.decide(1.0)
        assert d.scale_hint == -1 and not d.overloaded
        assert all(math.isclose(p["fast"]["burn"], 0.0)
                   for p in d.per_slo.values())


def test_ladder_observe_decision_equal_to_reference():
    """``DegradationLadder.observe_decision`` on both packages: the same
    decisions step the ladder the same way, each event naming the SLOs
    that drove it."""
    stream = _stream(6, 50, "steady")
    out = {}
    for pkg, (slo, reg, ladder) in PKGS.items():
        ev = slo.SloEvaluator(slos=slo.default_serving_slos())
        lad = ladder.DegradationLadder(3, ladder.LadderPolicy(down_after=2,
                                                              up_after=3))
        actions = []
        for t, snap in stream:
            ev.observe(snap, t)
            actions.append(lad.observe_decision(ev.decide(t),
                                                detail={"queue_depth": 0}))
        out[pkg] = _jsonable({"a": actions, "events": lad.events,
                              "snap": lad.snapshot()})
    assert out["port"] == out["reference"]
    assert {"down", "up"} <= set(out["port"]["a"])
    assert all("slo_burning" in e for e in out["port"]["events"])
