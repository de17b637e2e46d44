"""The port's serving telemetry (``ServingRuntime(obs=)``) and trace
analytics (``obs/trace.py``) against the JAX package's, on the CPU.

The scripted serving scenarios of ``tests/test_torch_serving.py`` run
through both runtimes on a ``VirtualClock``, each with an
``Observability`` bundle.  Held EQUAL (exact, the same bytes): the two
flight recordings dumped as JSONL (request, queue, dispatch and batch
spans, the pool's fence and failover events, sessions, SLO decisions)
and the two registries rendered as Prometheus text.  The port's
recording then loads into the REFERENCE's ``TraceStore``, which gives
the same critical path for every request and the same tail-attribution
rows as the port's ``TraceStore`` (exact: the timestamps are the
virtual clock's); every completed request's segments tile its root span
within ``CONSERVATION_TOL_S``; the roots' statuses count what
``accounting()`` counts; and every metric name the runtime registers
resolves in the catalog.
"""

import json

import numpy as np
import pytest

import analytics_zoo_tpu.obs as jobs
import analytics_zoo_tpu_torch.obs as tobs
from test_torch_serving import PKGS, Spy, _build, _drive_load

OBS = {"reference": jobs, "port": tobs}


def _raise_once(pkg, obs):
    rt, clock, _ = _build(pkg, [Spy(raise_on=[2])], obs=obs)
    for _ in range(16):
        rt.submit({"input": np.ones((2, 2), np.float32)})
        clock.advance(0.2)
        rt.pump()
    rt.drain()
    return rt


def _raise_twice(pkg, obs):
    rt, _, _ = _build(pkg, [Spy(raise_on=[1, 2])], obs=obs)
    for _ in range(4):
        rt.submit({"input": np.ones((2, 2), np.float32)})
    rt.drain()
    return rt


def _ladder(pkg, obs):
    rt, clock, _ = _build(
        pkg, [Spy(), Spy()], queue_capacity=8, max_batch=2,
        default_deadline_s=0.4,
        service=lambda e, n, t: 0.15 if t == 0 else 0.06, decision_every=2,
        ladder_policy=pkg.s.LadderPolicy(down_after=2, up_after=3), obs=obs)
    _drive_load(pkg, rt, clock, 40, gap_s=0.05)       # overload: sheds
    _drive_load(pkg, rt, clock, 30, gap_s=0.2)        # calm
    rt.drain()
    return rt


def _queue_full(pkg, obs):
    rt, _, _ = _build(pkg, [Spy()], queue_capacity=2, max_batch=8,
                      default_deadline_s=100.0, obs=obs)
    for _ in range(3):
        try:
            rt.submit({"input": np.ones((1, 2), np.float32)})
        except pkg.errors.ServerOverloaded:
            pass
    rt.drain()
    return rt


def _expiry(pkg, obs):
    rt, clock, _ = _build(pkg, [Spy()], n_replicas=1, max_batch=4,
                          queue_capacity=16, default_deadline_s=1.0,
                          wedge_timeout_s=5.0, service=0.01, obs=obs)
    for dl in (0.5, 5.0, 3.0, 4.0, 0.8, 6.0):
        rt.submit({"input": np.ones((1, 2), np.float32)}, deadline_s=dl)
    clock.advance(1.0)
    rt.drain()
    return rt


def _wedge_budget(pkg, obs):
    rt, clock, _ = _build(pkg, [Spy(wedge_on=[2], wedge_s=9.0)],
                          default_deadline_s=30.0, fence_budget_s=0.5,
                          obs=obs)
    for _ in range(8):
        rt.submit({"input": np.ones((2, 2), np.float32)})
        clock.advance(0.2)
        rt.pump()
    rt.drain()
    return rt


def _slo(pkg, obs):
    mod = OBS["port" if pkg is PKGS["port"] else "reference"]
    rt, clock, _ = _build(
        pkg, [Spy(), Spy()], queue_capacity=8, max_batch=2,
        default_deadline_s=0.4, decision_every=2,
        service=lambda e, n, t: 0.15 if t == 0 else 0.06,
        slo=mod.SloEvaluator(slos=mod.default_serving_slos(),
                             registry=obs.registry, fast_window_s=1.0,
                             slow_window_s=4.0),
        obs=obs)
    _drive_load(pkg, rt, clock, 40, gap_s=0.05)
    rt.drain()
    return rt

SCENARIOS = {"forward_raises_once": _raise_once,
             "forward_raises_twice": _raise_twice,
             "ladder_down_and_up": _ladder, "queue_full": _queue_full,
             "deadline_expiry": _expiry, "wedge_fence_budget": _wedge_budget,
             "slo_decisions": _slo}


def _run(side, name, **kw):
    obs = OBS[side].Observability(**kw)
    rt = SCENARIOS[name](PKGS[side], obs)
    return rt, obs


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_recording_equal_and_analysed_alike(name):
    ref_rt, ref_obs = _run("reference", name)
    rt, obs = _run("port", name)
    text = obs.recorder.to_jsonl()
    assert text == ref_obs.recorder.to_jsonl()
    assert tobs.render_prometheus(obs.registry) == \
        jobs.render_prometheus(ref_obs.registry)
    # the port's recording in the reference's store and in its own
    ref_store = jobs.TraceStore.from_jsonl(text)
    store = tobs.TraceStore.from_jsonl(text)
    assert store.to_jsonl() == text
    assert store.summary() == ref_store.summary()
    for tid in store.requests():
        assert store.critical_path(tid) == ref_store.critical_path(tid)
    report = store.tail_attribution()
    assert report == ref_store.tail_attribution()
    assert tobs.attribution_rows(report) == jobs.attribution_rows(report)
    cons = store.critical_path_conservation()
    assert cons == ref_store.critical_path_conservation()
    assert not cons["violations"]
    # one rooted tree a request, whose roots count the accounting
    spans = tobs.span_conservation(obs.recorder.events())
    assert spans == jobs.span_conservation(ref_obs.recorder.events())
    assert spans["ok"], spans["violations"]
    assert spans["roots_by_status"] == rt.accounting()["by_state"]
    assert spans["traces"] == rt.accounting()["submitted"]
    assert all(tobs.lookup(n) for n in obs.registry.metrics())
    assert rt.metrics.registry is obs.registry


def test_scenarios_reach_what_they_are_named_for():
    """The recordings hold the events the scenarios are for (the
    reference's are equal by the test above)."""
    for name, wasted in (("forward_raises_once", 0.0),
                         ("wedge_fence_budget", 0.5)):
        _, obs = _run("port", name)
        store = tobs.TraceStore.from_recorder(obs.recorder)
        (fo,) = store.events_of("failover")
        assert store.events_of("replica_fenced")
        # the failed attempt until the failover (a crash costs no time, a
        # wedge its fence budget), then the backup's service
        for rid in fo["requests"]:
            cp = store.critical_path(f"req-{rid}")
            assert cp["segments"]["failover_redispatch"] == \
                pytest.approx(wasted, abs=1e-6)
            assert cp["segments"]["dispatch"] > 0
            assert "failover_redispatch" in tobs.format_critical_path(cp)
    _, obs = _run("port", "ladder_down_and_up")
    store = tobs.TraceStore.from_recorder(obs.recorder)
    report = store.tail_attribution()
    assert report["dominant_segment"] == "queue_wait"
    assert set(report["by_status"]) >= {"done", "shed"}
    _, obs = _run("port", "slo_decisions")
    assert obs.recorder.events("slo_decision")
    _, obs = _run("port", "forward_raises_twice")
    assert tobs.span_conservation(obs.recorder.events())[
        "roots_by_status"] == {"failed": 4}


def test_fence_dumps_the_black_box(tmp_path):
    """A replica fence is a terminal condition: with ``dump_path`` armed
    the ring lands there, and the dump equals the reference's."""
    paths = {side: str(tmp_path / side / "bb.jsonl")
             for side in ("reference", "port")}
    recs = {side: _run(side, "forward_raises_once",
                       dump_path=paths[side])[1].recorder
            for side in paths}
    assert [d["reason"] for d in recs["port"].dumps] == ["replica_fenced"]
    with open(paths["port"]) as f, open(paths["reference"]) as g:
        got, want = f.read(), g.read()
    assert got == want
    events = [json.loads(line) for line in got.splitlines()]
    assert events[-1]["kind"] == "replica_fenced"


def test_ring_bound_drops_oldest_alike():
    """A ring smaller than the run keeps the newest events and counts the
    dropped ones, as the reference's does."""
    ref = _run("reference", "ladder_down_and_up", capacity=64)[1].recorder
    got = _run("port", "ladder_down_and_up", capacity=64)[1].recorder
    assert len(got) == 64 and got.dropped > 0
    assert (got.dropped, got.to_jsonl()) == (ref.dropped, ref.to_jsonl())
