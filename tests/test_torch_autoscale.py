"""The port's autoscaler, resize actuator and mesh-slice accounting against
the JAX package's, on the CPU.

The scenarios of ``tests/test_autoscale.py``'s ``TestAutoscalePolicy``,
``TestResizeActuator`` (at ``compile_s=0``: the port has no compile-cost
model) and ``test_autoscaler_actuates_and_conserves``, and the serving
half of ``tests/test_elastic_mesh.py`` (``ReplicaSlice``, the pool's
``device_budget`` clamp, slice-unit policy bounds, width against count,
the width speedup and a runtime's reshape), run through both packages on
a ``VirtualClock``.  Held EQUAL, field for field: each decision the loop
returns, its ``snapshot()`` (events, counters, the policy), the pool's
events and sizes, each request's record and the runtime's ``snapshot()``;
validation errors by class and by the words of their message.
"""

import dataclasses
import types

import numpy as np
import pytest

import analytics_zoo_tpu.obs.registry as jreg
import analytics_zoo_tpu.obs.slo as jslo
import analytics_zoo_tpu.serving as jserving
from analytics_zoo_tpu.resilience import errors as jerrors
from analytics_zoo_tpu.serving.batcher import AssembledBatch as JBatch
import analytics_zoo_tpu_torch.obs.registry as treg
import analytics_zoo_tpu_torch.obs.slo as tslo
import analytics_zoo_tpu_torch.serving as tserving
from analytics_zoo_tpu_torch.resilience import errors as terrors
from analytics_zoo_tpu_torch.serving.batcher import AssembledBatch as TBatch
from test_torch_fleet import _mux_runtime, _overload, _record, _spy_record
from test_torch_serving import _jsonable

PKGS = {
    "reference": types.SimpleNamespace(s=jserving, errors=jerrors, slo=jslo,
                                       reg=jreg, Batch=JBatch),
    "port": types.SimpleNamespace(s=tserving, errors=terrors, slo=tslo,
                                  reg=treg, Batch=TBatch),
}


def _fwd(batch):
    x = batch["input"]
    return x.reshape(x.shape[0], -1).sum(axis=1)


def _both(scenario):
    ref = _jsonable(scenario(PKGS["reference"]))
    got = _jsonable(scenario(PKGS["port"]))
    assert got == ref
    return got


# -- the policy loop (TestAutoscalePolicy) ------------------------------------

def scenario_grow_streak_cooldown(pkg):
    S = pkg.s
    sc = S.Autoscaler(S.AutoscalePolicy(min_replicas=1, max_replicas=4,
                                        grow_after=2, shrink_after=3,
                                        cooldown=2))
    outs = [sc.observe_hint(1, 2), sc.observe_hint(1, 2),
            sc.observe_hint(1, 3), sc.observe_hint(1, 3),
            sc.observe_hint(1, 3), sc.observe_hint(1, 3)]
    sc2 = S.Autoscaler(S.AutoscalePolicy(max_replicas=4, grow_after=1,
                                         cooldown=0))
    return {"outs": outs, "bound": sc2.observe_hint(1, 4),
            "snap": sc.snapshot(), "snap2": sc2.snapshot()}


def scenario_shrink_streak(pkg):
    S = pkg.s
    sc = S.Autoscaler(S.AutoscalePolicy(min_replicas=1, max_replicas=8,
                                        grow_after=1, shrink_after=3,
                                        cooldown=0))
    outs = [sc.observe_hint(h, 4) for h in (-1, -1, 0, -1, -1, -1)]
    sc2 = S.Autoscaler(S.AutoscalePolicy(min_replicas=2, shrink_after=1,
                                         cooldown=0))
    return {"outs": outs, "floor": sc2.observe_hint(-1, 2),
            "snap": sc.snapshot()}


def scenario_fast_plus_slow_burn(pkg):
    S = pkg.s
    slo = pkg.slo.SLO(name="miss", kind="ratio", budget=0.1,
                      bad=("bad",), total=("total",))
    ev = pkg.slo.SloEvaluator([slo], fast_window_s=10.0,
                              slow_window_s=100.0, time_scale=1.0)
    sc = S.Autoscaler(S.AutoscalePolicy(min_replicas=2, grow_after=1,
                                        cooldown=0, max_replicas=8))
    bad, total, outs = 0, 0, []
    for t in range(0, 95, 5):
        total += 50
        ev.observe({"counters": {"bad": bad, "total": total}}, float(t))
        outs.append(sc.observe_decision(ev.decide(float(t)), 2))
    hint_at_spike = None
    for t in range(100, 160, 5):
        bad += 25
        total += 50
        ev.observe({"counters": {"bad": bad, "total": total}}, float(t))
        d = ev.decide(float(t))
        if hint_at_spike is None:
            hint_at_spike = (d.scale_hint, list(d.burning))
        outs.append(sc.observe_decision(d, 2))
        if outs[-1] is not None:
            break
    return {"outs": outs, "spike": hint_at_spike, "snap": sc.snapshot()}


def scenario_snapshot_only_observer(pkg):
    S = pkg.s
    sc = S.Autoscaler(S.AutoscalePolicy(grow_after=1, shrink_after=2,
                                        cooldown=0, max_replicas=4))
    burn = {"gauges": {"slo/fast_burn/slo=miss": 3.0,
                       "slo/slow_burn/slo=miss": 1.5}}
    idle = {"gauges": {"slo/fast_burn/slo=miss": 0.1,
                       "slo/slow_burn/slo=miss": 0.2}}
    mixed = {"gauges": {"slo/fast_burn/slo=miss": 3.0,
                        "slo/slow_burn/slo=miss": 0.2}}
    return {"outs": [sc.observe_registry(burn, 2, t=0.0),
                     sc.observe_registry(idle, 3, t=1.0),
                     sc.observe_registry(idle, 3, t=2.0),
                     sc.observe_registry(mixed, 2, t=3.0)],
            "snap": sc.snapshot()}


def scenario_registry_export(pkg):
    S = pkg.s
    reg = pkg.reg.MetricRegistry()
    sc = S.Autoscaler(S.AutoscalePolicy(grow_after=1, shrink_after=1,
                                        cooldown=0, max_replicas=4),
                      registry=reg)
    sc.observe_hint(1, 2)
    sc.observe_hint(-1, 3)
    sc.note_quarantine(2, width=2)
    sc.hold = True
    held = sc.observe_hint(1, 2)
    return {"grow": reg.counter("autoscale/grow").value,
            "shrink": reg.counter("autoscale/shrink").value,
            "replicas": reg.gauge("autoscale/replicas").value,
            "held": held, "snap": sc.snapshot()}


POLICY = {
    "grow_streak_cooldown": scenario_grow_streak_cooldown,
    "shrink_streak": scenario_shrink_streak,
    "fast_plus_slow_burn": scenario_fast_plus_slow_burn,
    "snapshot_only_observer": scenario_snapshot_only_observer,
    "registry_export": scenario_registry_export,
}


@pytest.mark.parametrize("name", sorted(POLICY))
def test_policy_loop_equal_to_reference(name):
    got = _both(POLICY[name])
    if name == "grow_streak_cooldown":
        assert got["outs"] == [None, 3, None, None, None, 4]
    if name == "fast_plus_slow_burn":
        assert got["spike"] == [0, []] and got["outs"][-1] == 3
    if name == "registry_export":
        assert got["held"] is None and got["snap"]["holds"] == 1
        assert got["snap"]["evicted_devices"] == 2


# -- the resize actuator (TestResizeActuator, compile_s = 0) ------------------

def _pool(pkg, clock, n=2, service=0.05):
    S = pkg.s

    def factory(rid):
        return S.Replica(rid, [_fwd, _fwd], clock, wedge_timeout_s=60.0,
                         service_hook=lambda batch, r: service)

    return S.ReplicaPool([factory(r) for r in range(n)], clock,
                         restart_s=1.0, replica_factory=factory)


def _batch(pkg, tier=0):
    return pkg.Batch(requests=[], batch={"input": np.ones((1, 2),
                                                          np.float32)},
                     edge="fixed", n_valid=1, tier=tier, model="default")


def scenario_join_prewarm_flag(pkg):
    """``prewarm`` is only recorded: with no compile cost both joins are
    at once, healthy, and a dispatch costs its service time."""
    clock = pkg.s.VirtualClock()
    pool = _pool(pkg, clock, n=1)
    acts = [pool.resize(2, prewarm=True), pool.resize(3, prewarm=False)]
    states = [r.state for r in pool.replicas]
    t0 = clock.now()
    pool.replica_by_rid(2).forward(_batch(pkg, tier=1))
    return {"acts": acts, "states": states, "events": pool.events,
            "served_s": clock.now() - t0,
            "healthy": [r.rid for r in pool.healthy()]}


def scenario_drain_then_retire(pkg):
    S = pkg.s
    clock = S.VirtualClock()
    rt = S.ServingRuntime(
        [S.ServingTier("fp", _fwd)], n_replicas=3, clock=clock,
        queue_capacity=64, max_batch=2, default_deadline_s=30.0,
        wedge_timeout_s=60.0, service_time=lambda e, n, t: 0.05)
    for _ in range(6):
        rt.submit({"input": np.ones((1, 2), np.float32)})
    rt.pump()
    actions = rt.pool.resize(2)
    seen = []
    for _ in range(10):
        rt.submit({"input": np.ones((1, 2), np.float32)})
        clock.advance(0.1)
        rt.pump()
        gone = rt.pool.replica_by_rid(2)
        seen.append(None if gone is None else (gone.state, gone.dispatches))
    rt.drain()
    return {"actions": actions, "seen": seen, "acct": rt.accounting(),
            "events": rt.pool.events, "snap": rt.snapshot()}


def scenario_fenced_and_protected(pkg):
    clock = pkg.s.VirtualClock()
    pool = _pool(pkg, clock, n=3)
    pool.replicas[1].fence(clock.now() + 100.0)
    pool.resize(2)
    fenced = sorted(r.rid for r in pool.replicas)
    pool2 = _pool(pkg, clock, n=3)
    pool2.resize(2, protected=[2])
    return {"fenced": fenced, "protected": [r.rid for r in pool2.replicas],
            "events": [pool.events, pool2.events]}


def scenario_autoscaler_actuates(pkg):
    S = pkg.s
    clock = S.VirtualClock()
    scaler = S.Autoscaler(S.AutoscalePolicy(
        min_replicas=1, max_replicas=4, grow_after=1, shrink_after=4,
        cooldown=1))
    rt = _mux_runtime(pkg, clock, autoscaler=scaler)
    batches = _spy_record(rt)
    _overload(pkg, rt, clock, 1200)
    return _record(rt, batches, grows=scaler.grows, size=rt.pool.size)


ACTUATOR = {
    "join_prewarm_flag": scenario_join_prewarm_flag,
    "drain_then_retire": scenario_drain_then_retire,
    "fenced_and_protected": scenario_fenced_and_protected,
    "autoscaler_actuates": scenario_autoscaler_actuates,
}


@pytest.mark.parametrize("name", sorted(ACTUATOR))
def test_actuator_equal_to_reference(name):
    got = _both(ACTUATOR[name])
    if name == "join_prewarm_flag":
        assert got["states"] == ["healthy"] * 3
        assert got["served_s"] == pytest.approx(0.05)
    if name == "drain_then_retire":
        assert got["acct"]["unaccounted"] == 0 and got["seen"][-1] is None
    if name == "fenced_and_protected":
        assert got["fenced"] == [0, 2] and got["protected"] == [0, 2]
    if name == "autoscaler_actuates":
        assert got["accounting"]["unaccounted"] == 0
        assert got["grows"] >= 1 and got["size"] > 1
        assert got["snapshot"]["autoscale"]["grows"] == got["grows"]
        assert got["snapshot"]["cold_compiles"] == 0


# -- mesh slices (the serving half of tests/test_elastic_mesh.py) -------------

def _slice_factory(pkg, clock, width):
    def make(rid):
        return pkg.s.ReplicaSlice(rid, [_fwd], clock, wedge_timeout_s=5.0,
                                  width=width)
    return make


def scenario_pool_budget_clamps(pkg):
    S = pkg.s
    clock = S.VirtualClock()
    factory = _slice_factory(pkg, clock, width=2)
    pool = S.ReplicaPool([factory(0)], clock, replica_factory=factory,
                         device_budget=4)
    used = [pool.devices_used]
    pool.resize(3, prewarm=False)
    used.append(pool.devices_used)
    pool2 = S.ReplicaPool([factory(0), factory(1)], clock,
                          replica_factory=factory, device_budget=4)
    pool2.resize(1)
    used.append(pool2.devices_used)
    pool2.resize(2, prewarm=False)
    used.append(pool2.devices_used)
    return {"used": used, "size": pool.size, "events": pool.events,
            "events2": pool2.events,
            "widths": [S.Replica(1, [_fwd], clock, 5.0).width,
                       factory(9).width]}


def scenario_width_vs_count(pkg):
    S = pkg.s

    def scaler(**kw):
        base = dict(min_replicas=1, max_replicas=4, grow_after=1,
                    cooldown=0, device_budget=8, reshape_width=4,
                    reshape_fill=0.9)
        base.update(kw)
        return S.Autoscaler(S.AutoscalePolicy(**base))

    out = {}
    for name, sat, widths in (
            ("saturated", {"fraud": 0.97, "ssd": 0.2},
             {"fraud": 1, "ssd": 1}),
            ("below_bar", {"fraud": 0.5}, {"fraud": 1}),
            ("already_wide", {"fraud": 1.0}, {"fraud": 4})):
        sc = scaler()
        got = sc.observe_hint(1, 2, saturation=sat, widths=widths)
        out[name] = {"got": (dataclasses.asdict(got)
                             if dataclasses.is_dataclass(got) else got),
                     "snap": sc.snapshot()}
    sc = S.Autoscaler(S.AutoscalePolicy(min_replicas=1, max_replicas=4,
                                        grow_after=1, cooldown=0))
    out["unarmed"] = sc.observe_hint(1, 2, saturation={"fraud": 1.0},
                                     widths={"fraud": 1})
    sp = S.ServingRuntime._width_speedup
    knee = S.OCCUPANCY_KNEE
    out["speedup"] = [sp(8, 4), sp(knee, 4), sp(2 * knee, 4),
                      sp(4 * knee, 4), sp(200, 2)]
    out["max_devices"] = [
        S.AutoscalePolicy(min_replicas=1, max_replicas=3, slice_width=2,
                          device_budget=6).max_devices,
        S.AutoscalePolicy(max_replicas=3, slice_width=2).max_devices]
    return out


def scenario_runtime_reshape(pkg):
    S = pkg.s
    clock = S.VirtualClock()
    cfg = S.ModelConfig(name="fraud",
                        tiers=[S.ServingTier("fp", _fwd, speed=1.0)],
                        default_deadline_s=1.0, length_key=None)
    rt = S.ServingRuntime(models=[cfg], n_replicas=1, clock=clock,
                          max_batch=256, queue_capacity=512,
                          service_time=lambda m, e, n, t: 0.01)
    rt._do_reshape(S.Reshape(model="fraud", from_width=1, to_width=4,
                             fill=1.0, rationale="test"))
    for _ in range(256):
        rt.submit({"input": np.ones((1, 2), np.float32)})
    rt.drain()
    return {"snap": rt.snapshot(), "events": rt.pool.events,
            "done_t": [r.completed_t for r in rt.requests][-1]}


def scenario_slice_runtime(pkg):
    """``slice_width=2`` replicas under ``device_budget=4`` serving, a grow
    clamped by the budget, the ``slices`` record."""
    S = pkg.s
    clock = S.VirtualClock()
    rt = S.ServingRuntime([S.ServingTier("fp", _fwd)], n_replicas=2,
                          clock=clock, max_batch=4, slice_width=2,
                          device_budget=4, default_deadline_s=10.0,
                          service_time=lambda e, n, t: 0.02)
    for _ in range(12):
        rt.submit({"input": np.ones((1, 2), np.float32)})
    rt.drain()
    acts = rt.pool.resize(3)
    return {"acts": acts, "snap": rt.snapshot(), "events": rt.pool.events,
            "kinds": [type(r).__name__ for r in rt.pool.replicas]}


SLICES = {
    "pool_budget_clamps": scenario_pool_budget_clamps,
    "width_vs_count": scenario_width_vs_count,
    "runtime_reshape": scenario_runtime_reshape,
    "slice_runtime": scenario_slice_runtime,
}


@pytest.mark.parametrize("name", sorted(SLICES))
def test_slices_equal_to_reference(name):
    got = _both(SLICES[name])
    if name == "pool_budget_clamps":
        assert got["used"] == [2, 4, 2, 4] and got["size"] == 2
        clamp = [e for e in got["events"]
                 if e["kind"] == "resize_budget_clamped"]
        assert clamp and clamp[0]["width"] == 2
    if name == "width_vs_count":
        assert got["saturated"]["got"]["model"] == "fraud"
        assert got["below_bar"]["got"] == 3 and got["unarmed"] == 3
        assert got["speedup"][:4] == [1.0, 1.0, 2.0, 4.0]
    if name == "runtime_reshape":
        assert got["snap"]["slices"]["model_width"] == {"fraud": 4}
    if name == "slice_runtime":
        assert got["acts"]["grown"] == []
        assert got["snap"]["slices"]["devices_used"] == 4
        assert got["kinds"] == ["ReplicaSlice"] * 2


@pytest.mark.parametrize("kw,match", [
    (dict(min_replicas=0), "min_replicas"),
    (dict(min_replicas=3, max_replicas=2), "max_replicas"),
    (dict(grow_after=0), "grow_after"),
    (dict(cooldown=-1), "cooldown"),
    (dict(slice_width=0), "slice_width"),
    (dict(min_replicas=1, max_replicas=4, slice_width=2, device_budget=6),
     "SLICE units"),
    (dict(min_replicas=3, max_replicas=3, slice_width=2, device_budget=4),
     "floor"),
    (dict(reshape_fill=0.0), "reshape_fill"),
    (dict(max_replicas=1, slice_width=2, reshape_width=2), "reshape_width"),
    (dict(max_replicas=1, slice_width=1, device_budget=2, reshape_width=4),
     "reshape_width"),
], ids=lambda v: "-".join(f"{k}{v[k]}" for k in v)
    if isinstance(v, dict) else v)
def test_policy_validation_matches_reference(kw, match):
    msgs = []
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match=match) as ei:
            pkg.s.AutoscalePolicy(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_slice_width_validated():
    for pkg in PKGS.values():
        clock = pkg.s.VirtualClock()
        with pytest.raises(ValueError, match="width"):
            pkg.s.ReplicaSlice(2, [_fwd], clock, wedge_timeout_s=5.0,
                               width=0)
        with pytest.raises(ValueError, match="slice_width"):
            pkg.s.ServingRuntime([pkg.s.ServingTier("fp", _fwd)],
                                 slice_width=0)
