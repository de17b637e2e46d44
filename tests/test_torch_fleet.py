"""The port's multiplexed serving runtime (``ServingRuntime(models=...)``)
against the JAX package's, on the CPU.

The scenarios of ``tests/test_autoscale.py``'s ``TestMultiplexedBatching``,
``TestMultiplexedRuntime`` (the autoscaler's in
``tests/test_torch_autoscale.py``) and
``TestStreamingSessions`` run through both packages on a ``VirtualClock``
with spy tiers: per-(model, edge, tier) service estimates, models never
sharing a batch, weighted EDF, per-model batch sizes, SLO burn driving the
per-model ladders and weights, and session-affine streaming sessions
(in-order chunks, incremental deadlines, a shed chunk killing its session,
``close_session``, a dead session's queued chunks).  Held EQUAL, field
for field: ``accounting()``, each request's state, completion time, tier,
model and session, each batch's model, affinity and members, the model
weights, each ladder's events, the session counts and the whole
``snapshot()``.
"""

import types

import numpy as np
import pytest

import analytics_zoo_tpu.obs.slo as jslo
import analytics_zoo_tpu.serving as jserving
from analytics_zoo_tpu.resilience import errors as jerrors
from analytics_zoo_tpu.serving.request import AdmissionQueue as JQueue
import analytics_zoo_tpu_torch.obs.slo as tslo
import analytics_zoo_tpu_torch.serving as tserving
from analytics_zoo_tpu_torch.resilience import errors as terrors
from analytics_zoo_tpu_torch.serving.request import AdmissionQueue as TQueue
from test_torch_serving import _jsonable

PKGS = {
    "reference": types.SimpleNamespace(s=jserving, errors=jerrors,
                                       slo=jslo, Queue=JQueue),
    "port": types.SimpleNamespace(s=tserving, errors=terrors, slo=tslo,
                                  Queue=TQueue),
}


def _fwd(batch):
    x = batch["input"]
    return x.reshape(x.shape[0], -1).sum(axis=1)


def _ones():
    return {"input": np.ones((1, 2), np.float32)}


def _req(pkg, rid, model, deadline_t, clock, length=None):
    return pkg.s.Request(rid=rid, payload=_ones(), arrival_t=clock.now(),
                         deadline_t=deadline_t, model=model, length=length)


def _batch_rec(batch):
    return (batch.model, batch.affinity, str(batch.edge), batch.n_valid,
            batch.tier, tuple(r.rid for r in batch.requests),
            tuple(np.asarray(batch.batch["input"]).shape))


# -- the batcher alone (TestMultiplexedBatching) ------------------------------

def _mux_batcher(pkg, clock, service_time=None, shed_expired=True,
                 plans=None):
    queue = pkg.Queue(64, clock, shed_expired=shed_expired)
    plans = plans or {"a": pkg.s.ModelPlan(), "b": pkg.s.ModelPlan()}
    return queue, pkg.s.DeadlineBatcher(queue, max_batch=4,
                                        service_time=service_time,
                                        plans=plans)


def scenario_cold_estimate_per_key(pkg):
    clock = pkg.s.VirtualClock()
    queue, b = _mux_batcher(pkg, clock)
    b.observe_service_s("fixed", 0.05, tier=0, model="a")
    est = [b.estimate_s("fixed", 1, 0, model="a"),
           b.estimate_s("fixed", 1, 0, model="b")]
    queue.submit(_req(pkg, 0, "b", clock.now() + 100.0, clock))
    first = b.next_batch({"a": 0, "b": 0})
    b.observe_service_s("fixed", 0.2, tier=0, model="b")
    est += [b.estimate_s("fixed", 1, 0, model="b"),
            b.estimate_s("fixed", 1, 1, model="b")]
    return {"estimates": est, "batch": _batch_rec(first)}


def scenario_models_never_share(pkg):
    clock = pkg.s.VirtualClock()
    queue, b = _mux_batcher(pkg, clock)
    for i in range(6):
        queue.submit(_req(pkg, i, "a" if i % 2 else "b",
                          clock.now() + 0.1 * (i + 1), clock))
    seen = []
    while True:
        batch = b.next_batch({"a": 0, "b": 0}, force=True)
        if batch is None:
            break
        seen.append(_batch_rec(batch))
    return {"batches": seen}


def scenario_weighted_negative_slack(pkg):
    clock = pkg.s.VirtualClock()
    queue, b = _mux_batcher(pkg, clock, lambda m, e, n, t: 10.0,
                            shed_expired=False)
    clock.advance(5.0)
    queue.submit(_req(pkg, 0, "a", clock.now() - 0.5, clock))
    queue.submit(_req(pkg, 1, "b", clock.now() - 1.0, clock))
    b.set_model_weight("b", 4.0)
    return {"first": _batch_rec(b.next_batch({"a": 0, "b": 0}))}


def scenario_weighted_boost(pkg):
    clock = pkg.s.VirtualClock()
    queue, b = _mux_batcher(pkg, clock, lambda m, e, n, t: 10.0)
    queue.submit(_req(pkg, 0, "a", clock.now() + 1.0, clock))
    queue.submit(_req(pkg, 1, "b", clock.now() + 2.0, clock))
    tiers = {"a": 0, "b": 0}
    first = b.next_batch(tiers)
    queue.submit(_req(pkg, 2, "a", clock.now() + 1.0, clock))
    b.set_model_weight("b", 4.0)
    boosted = b.next_batch(tiers)
    return {"first": _batch_rec(first), "boosted": _batch_rec(boosted),
            "weight": b.model_weight("b"), "weight_a": b.model_weight("a")}


def scenario_per_model_max_batch(pkg):
    clock = pkg.s.VirtualClock()
    queue, b = _mux_batcher(pkg, clock,
                            plans={"a": pkg.s.ModelPlan(max_batch=2)})
    for i in range(3):
        queue.submit(_req(pkg, i, "a", clock.now() + 100.0, clock))
    batch = b.next_batch({"a": 0})
    with pytest.raises(KeyError, match="no batching plan"):
        b.bucket_of(_req(pkg, 9, "zz", 1.0, clock))
    return {"batch": _batch_rec(batch)}


def scenario_bucketed_streaming_collate(pkg):
    """Two models' buckets with padding, one of them streaming: the
    ``session`` (int64, -1 padding) and ``final`` (int8) vectors."""
    clock = pkg.s.VirtualClock()
    plans = {"v": pkg.s.ModelPlan(bucket_edges=[4, 8]),
             "s": pkg.s.ModelPlan(bucket_edges=[6], streaming=True,
                                  length_key="n_samples", max_batch=3)}
    queue, b = _mux_batcher(pkg, clock, lambda m, e, n, t: 0.01,
                            plans=plans)
    for i, (m, n) in enumerate([("v", 3), ("s", 5), ("v", 7), ("s", 2),
                                ("v", 4)]):
        r = pkg.s.Request(rid=i, payload={"input": np.full(
            (n, 2), i + 1.0, np.float32)}, arrival_t=0.0,
            deadline_t=1.0 + 0.1 * i, model=m, length=n,
            session=(7 if m == "s" else None),
            affinity=(1 if m == "s" else None), final=(i == 3))
        queue.submit(r)
    out = []
    while True:
        batch = b.next_batch({"v": 0, "s": 0}, force=True)
        if batch is None:
            break
        out.append({"rec": _batch_rec(batch),
                    "batch": {k: (np.asarray(v).tolist(),
                                  str(np.asarray(v).dtype))
                              for k, v in batch.batch.items()}})
    return {"batches": out}


# -- the runtime (TestMultiplexedRuntime) -------------------------------------

def _spy_record(rt):
    batches = []
    orig = rt._dispatch

    def record(batch):
        batches.append(_batch_rec(batch))
        orig(batch)

    rt._dispatch = record
    return batches


def _record(rt, batches, **extra):
    snap = rt.snapshot()
    return {
        "accounting": rt.accounting(),
        "requests": [(r.rid, r.state, r.completed_t, r.tier, r.model,
                      r.session, r.affinity, r.final, r.attempts,
                      type(r.error).__name__ if r.error else None,
                      None if r.result is None else float(r.result))
                     for r in rt.requests],
        "batches": batches,
        "weights": {m: rt.batcher.model_weight(m) for m in rt.models},
        "ladders": {m: lad.events for m, lad in rt.ladders.items()},
        "sessions": snap.get("sessions"),
        "pool": rt.pool.events,
        "snapshot": snap,
        **extra,
    }


def _mux_runtime(pkg, clock, **kw):
    S = pkg.s
    models = [
        S.ModelConfig(name="vision",
                      tiers=[S.ServingTier("fp", _fwd),
                             S.ServingTier("int8", _fwd, 0.7)],
                      length_key=None, default_deadline_s=0.3,
                      slos=pkg.slo.model_slos("vision")),
        S.ModelConfig(name="fraud", tiers=[S.ServingTier("fp", _fwd)],
                      length_key=None, default_deadline_s=0.1,
                      slos=pkg.slo.model_slos("fraud")),
    ]
    kw.setdefault("queue_capacity", 64)
    kw.setdefault("max_batch", 4)
    kw.setdefault("decision_every", 4)
    kw.setdefault("service_time",
                  lambda m, e, n, t: 0.05 if m == "vision" else 0.01)
    kw.setdefault("slo_params", dict(fast_window_s=2.0, slow_window_s=20.0,
                                     time_scale=1.0))
    return S.ServingRuntime(models=models, n_replicas=1, clock=clock, **kw)


def _overload(pkg, rt, clock, n, rate=700.0):
    t, script = 0.0, []
    for i in range(n):
        t += 1.0 / rate
        script.append((t, "vision" if i % 3 else "fraud"))
    i = 0
    while i < n:
        if clock.now() < script[i][0]:
            if rt.pump() == 0:
                clock.advance(script[i][0] - clock.now())
            continue
        while i < n and clock.now() >= script[i][0]:
            t_sched, m = script[i]
            dl = 0.3 if m == "vision" else 0.1
            try:
                rt.submit(_ones(), model=m,
                          deadline_s=max(t_sched + dl - clock.now(), 1e-9))
            except pkg.errors.ServerOverloaded:
                pass
            i += 1
        rt.pump()
    rt.drain()


def scenario_burn_drives_weights(pkg):
    clock = pkg.s.VirtualClock()
    rt = _mux_runtime(pkg, clock)
    batches = _spy_record(rt)
    _overload(pkg, rt, clock, 1200)
    return _record(rt, batches, gauge=rt.metrics.registry.gauge(
        "serve/model_weight/model=vision").value,
        fraud=rt.metrics.model_snapshot("fraud"),
        miss_vision=rt.metrics.miss_rate(model="vision"))


def scenario_mux_without_slos(pkg):
    """Two models without SLOs: each ladder steps on its own shed flag
    and the queue depth, the weights stay 1."""
    S = pkg.s
    clock = S.VirtualClock()
    models = [S.ModelConfig(name=m, tiers=[S.ServingTier("fp", _fwd),
                                           S.ServingTier("lo", _fwd, 0.5)],
                            length_key=None, default_deadline_s=dl)
              for m, dl in (("vision", 0.3), ("fraud", 0.1))]
    rt = S.ServingRuntime(
        models=models, n_replicas=2, clock=clock, queue_capacity=16,
        max_batch=4, decision_every=2,
        ladder_policy=S.LadderPolicy(down_after=1, up_after=2),
        service_time=lambda m, e, n, t: 0.04 if t == 0 else 0.02)
    batches = _spy_record(rt)
    _overload(pkg, rt, clock, 300, rate=300.0)
    return _record(rt, batches)


def scenario_submit_requires_model(pkg):
    clock = pkg.s.VirtualClock()
    rt = _mux_runtime(pkg, clock)
    with pytest.raises(ValueError, match="submit\\(model=...\\)"):
        rt.submit(_ones())
    with pytest.raises(KeyError, match="unknown model"):
        rt.submit(_ones(), model="nope")
    with pytest.raises(ValueError, match="not a streaming"):
        rt.open_session("vision")
    return _record(rt, [])


# -- streaming sessions (TestStreamingSessions) -------------------------------

def _stateful_tiers(pkg):
    """Each session's forward output is its running chunk count: an
    out-of-order, dropped or wrong-replica dispatch changes it."""
    stores = []

    def factory(rid):
        store = {}
        stores.append((rid, store))

        def forward(batch):
            out = []
            for sid in batch["session"]:
                sid = int(sid)
                if sid < 0:
                    out.append(-1)
                    continue
                store[sid] = store.get(sid, 0) + 1
                out.append(store[sid])
            return np.asarray(out)
        return [pkg.s.ServingTier("stream", forward,
                                  evict_session=lambda s: store.pop(s, None))]

    return factory, stores


def _session_runtime(pkg, clock, n_replicas=2, **kw):
    factory, stores = _stateful_tiers(pkg)
    cfg = pkg.s.ModelConfig(name="stream", streaming=True,
                            tiers=factory(-1), tier_factory=factory,
                            length_key=None, chunk_deadline_s=0.5)
    kw.setdefault("service_time", lambda m, e, n, t: 0.01)
    rt = pkg.s.ServingRuntime(models=[cfg], n_replicas=n_replicas,
                              clock=clock, queue_capacity=32, max_batch=4,
                              **kw)
    return rt, stores


def _stores(stores):
    return [(rid, dict(sorted(s.items()))) for rid, s in stores]


def scenario_session_affinity(pkg):
    clock = pkg.s.VirtualClock()
    rt, stores = _session_runtime(pkg, clock)
    batches = _spy_record(rt)
    s1, s2 = rt.open_session("stream"), rt.open_session("stream")
    pins = [rt._sessions[s]["replica"] for s in (s1, s2)]
    for k in range(4):
        for sid in (s1, s2):
            rt.submit_chunk(sid, _ones(), final=(k == 3))
        clock.advance(0.05)
        rt.pump()
    rt.drain()
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit_chunk(s1, _ones())
    with pytest.raises(KeyError, match="unknown session"):
        rt.submit_chunk(99, _ones())
    return _record(rt, batches, pins=pins, stores=_stores(stores),
                   pinned=sorted(rt._session_rids()))


def scenario_incremental_deadlines(pkg):
    clock = pkg.s.VirtualClock()
    rt, _ = _session_runtime(pkg, clock)
    sid = rt.open_session("stream")
    r1 = rt.submit_chunk(sid, _ones())
    rt.pump(force=True)
    clock.advance(10.0)
    r2 = rt.submit_chunk(sid, _ones())
    return _record(rt, [], deadlines=[(r.arrival_t, r.deadline_t)
                                      for r in (r1, r2)])


def scenario_shed_chunk_kills_session(pkg):
    clock = pkg.s.VirtualClock()
    rt, stores = _session_runtime(pkg, clock)
    batches = _spy_record(rt)
    sid = rt.open_session("stream")
    rt.submit_chunk(sid, _ones())
    rt.pump(force=True)
    rt.submit_chunk(sid, _ones())
    clock.advance(1.0)
    rt.pump()
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit_chunk(sid, _ones())
    return _record(rt, batches, stores=_stores(stores),
                   pinned=sorted(rt._session_rids()))


def scenario_clamped_chunk_deadlines(pkg):
    clock = pkg.s.VirtualClock()
    rt, _ = _session_runtime(pkg, clock)
    batches = _spy_record(rt)
    sid = rt.open_session("stream")
    rt.submit_chunk(sid, _ones(), deadline_s=5.0)
    rt.submit_chunk(sid, _ones(), deadline_s=0.1)
    rt.drain()
    return _record(rt, batches, deadlines=[r.deadline_t
                                           for r in rt.requests])


def scenario_close_session(pkg):
    clock = pkg.s.VirtualClock()
    rt, stores = _session_runtime(pkg, clock)
    sid = rt.open_session("stream")
    rt.submit_chunk(sid, _ones())
    rt.pump(force=True)
    pinned = [sorted(rt._session_rids())]
    rt.close_session(sid)
    pinned.append(sorted(rt._session_rids()))
    rt.close_session(sid)
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit_chunk(sid, _ones())
    return _record(rt, [], stores=_stores(stores), pinned=pinned)


def scenario_dead_session_queued_chunks(pkg):
    clock = pkg.s.VirtualClock()
    rt, stores = _session_runtime(pkg, clock, n_replicas=1)
    batches = _spy_record(rt)
    sid = rt.open_session("stream")
    for _ in range(3):
        rt.submit_chunk(sid, _ones())
    rt.queue.capacity = 3
    with pytest.raises(pkg.errors.ServerOverloaded):
        rt.submit_chunk(sid, _ones())
    failed_after_shed = rt.snapshot()["sessions"]["failed"]
    rt.drain()
    return _record(rt, batches, stores=_stores(stores),
                   failed_after_shed=failed_after_shed)


def scenario_replica_lost_kills_sessions(pkg):
    """A forward that raises on the pinned replica: the batch fails
    there (no failover), the replica is fenced, every session on it is
    killed and evicted, while the other replica's session completes."""
    S = pkg.s
    clock = S.VirtualClock()
    calls = {}

    def factory(rid):
        store = {}

        def forward(batch):
            calls[rid] = calls.get(rid, 0) + 1
            if rid == 0 and calls[rid] == 2:
                raise RuntimeError("card lost")
            out = []
            for sid in batch["session"]:
                sid = int(sid)
                if sid >= 0:
                    store[sid] = store.get(sid, 0) + 1
                out.append(store.get(sid, -1))
            return np.asarray(out)
        return [S.ServingTier("stream", forward,
                              evict_session=lambda s: store.pop(s, None))]

    cfg = S.ModelConfig(name="stream", streaming=True, tiers=factory(-1),
                        tier_factory=factory, length_key=None,
                        chunk_deadline_s=0.5)
    rt = S.ServingRuntime(models=[cfg], n_replicas=2, clock=clock,
                          queue_capacity=32, max_batch=4,
                          service_time=lambda m, e, n, t: 0.01)
    batches = _spy_record(rt)
    sids = [rt.open_session("stream") for _ in range(3)]
    for k in range(3):
        for sid in sids:
            try:
                rt.submit_chunk(sid, _ones(), final=(k == 2))
            except RuntimeError:
                pass                      # the session was killed
        clock.advance(0.05)
        rt.pump()
    rt.drain()
    clock.advance(10.0)
    rt.pump()
    return _record(rt, batches, calls=calls)


SCENARIOS = {
    "cold_estimate_per_key": scenario_cold_estimate_per_key,
    "models_never_share": scenario_models_never_share,
    "weighted_negative_slack": scenario_weighted_negative_slack,
    "weighted_boost": scenario_weighted_boost,
    "per_model_max_batch": scenario_per_model_max_batch,
    "bucketed_streaming_collate": scenario_bucketed_streaming_collate,
    "burn_drives_weights": scenario_burn_drives_weights,
    "mux_without_slos": scenario_mux_without_slos,
    "submit_requires_model": scenario_submit_requires_model,
    "session_affinity": scenario_session_affinity,
    "incremental_deadlines": scenario_incremental_deadlines,
    "shed_chunk_kills_session": scenario_shed_chunk_kills_session,
    "clamped_chunk_deadlines": scenario_clamped_chunk_deadlines,
    "close_session": scenario_close_session,
    "dead_session_queued_chunks": scenario_dead_session_queued_chunks,
    "replica_lost_kills_sessions": scenario_replica_lost_kills_sessions,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equal_to_reference(name):
    ref = _jsonable(SCENARIOS[name](PKGS["reference"]))
    got = _jsonable(SCENARIOS[name](PKGS["port"]))
    assert got == ref


def test_scenarios_cover_what_they_claim():
    """The scenarios reach what they are named for (on the port; the
    reference is equal by the test above), as ``test_autoscale.py``
    asserts it of the reference."""
    port = PKGS["port"]
    inf = float("inf")
    c = scenario_cold_estimate_per_key(port)
    assert c["estimates"] == [0.05, inf, 0.2, inf]
    assert c["batch"][0] == "b" and c["batch"][3] == 1
    seen = scenario_models_never_share(port)["batches"]
    assert sorted(b[0] for b in seen) == ["a", "b"]
    assert sum(b[3] for b in seen) == 6
    assert scenario_weighted_negative_slack(port)["first"][0] == "b"
    w = scenario_weighted_boost(port)
    assert w["first"][0] == "a" and w["boosted"][0] == "b"
    assert w["weight"] == 4.0 and w["weight_a"] == 1.0
    m = scenario_per_model_max_batch(port)["batch"]
    assert m[3] == 2 and m[6][0] == 2
    coll = scenario_bucketed_streaming_collate(port)["batches"]
    stream = [b for b in coll if b["rec"][0] == "s"]
    assert stream and all(b["rec"][1] == 1 for b in stream)
    assert stream[0]["batch"]["session"] == ([7, 7, -1], "int64")
    assert stream[0]["batch"]["final"][1] == "int8"
    assert {b["rec"][0] for b in coll} == {"v", "s"}

    burn = scenario_burn_drives_weights(port)
    assert burn["accounting"]["unaccounted"] == 0
    assert burn["weights"]["vision"] > 1.0 and burn["weights"]["fraud"] > 1.0
    downs = [e for e in burn["ladders"]["vision"] if e["kind"] == "tier_down"]
    assert downs and any("model=vision" in s
                         for s in downs[0]["slo_burning"])
    assert burn["gauge"] > 1.0 and burn["fraud"]["submitted"] > 0
    assert all(len({b[0]}) == 1 for b in burn["batches"])
    assert set(burn["snapshot"]["models"]) == {"vision", "fraud"}
    assert burn["snapshot"]["slo"]["decisions"] > 0
    plain = scenario_mux_without_slos(port)
    assert plain["weights"] == {"vision": 1.0, "fraud": 1.0}
    assert any(plain["ladders"].values())
    assert "slo" not in plain["snapshot"]

    aff = scenario_session_affinity(port)
    assert aff["accounting"]["by_state"] == {"done": 8}
    assert aff["pins"][0] != aff["pins"][1]
    by_sid = {}
    for rid, state, _, _, _, sid, pin, final, *_, result in aff["requests"]:
        by_sid.setdefault(sid, []).append(result)
    assert all(v == [1, 2, 3, 4] for v in by_sid.values())
    stores = dict(aff["stores"])
    assert stores[aff["pins"][0]] == {0: 4} and stores[aff["pins"][1]] == {
        1: 4}
    assert aff["sessions"] == {"opened": 2, "open": 0, "failed": 0}
    assert aff["pinned"] == []
    d = scenario_incremental_deadlines(port)["deadlines"]
    assert [dl - a for a, dl in d] == pytest.approx([0.5, 0.5])
    assert d[1][0] >= d[0][0] + 10.0
    shed = scenario_shed_chunk_kills_session(port)
    assert [r[1] for r in shed["requests"]] == ["done", "timeout"]
    assert shed["sessions"] == {"opened": 1, "open": 0, "failed": 1}
    assert all(s == {} for _, s in shed["stores"]) and shed["pinned"] == []
    cl = scenario_clamped_chunk_deadlines(port)
    assert cl["deadlines"][1] >= cl["deadlines"][0]
    assert [r[-1] for r in cl["requests"]] == [1, 2]
    close = scenario_close_session(port)
    assert close["pinned"][0] and close["pinned"][1] == []
    assert all(s == {} for _, s in close["stores"])
    assert close["sessions"]["open"] == 0
    dead = scenario_dead_session_queued_chunks(port)
    assert dead["failed_after_shed"] == 1
    assert [r[1] for r in dead["requests"]] == ["failed"] * 3 + ["shed"]
    assert all(s == {} for _, s in dead["stores"])
    lost = scenario_replica_lost_kills_sessions(port)
    assert lost["accounting"]["unaccounted"] == 0
    assert lost["sessions"]["failed"] == 2 and lost["sessions"]["open"] == 0
    assert [e["kind"] for e in lost["pool"]].count("replica_fenced") == 1
    assert "failover" not in [e["kind"] for e in lost["pool"]]
    assert lost["accounting"]["by_state"]["done"] >= 3


# -- configuration and refusals ----------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_model_config_validation(pkg):
    S = PKGS[pkg].s
    factory, _ = _stateful_tiers(PKGS[pkg])
    with pytest.raises(ValueError, match="tier_factory"):
        S.ModelConfig(name="s", streaming=True,
                      tiers=[S.ServingTier("x", _fwd)])
    with pytest.raises(ValueError, match="one bucket edge"):
        S.ModelConfig(name="s", streaming=True, tiers=factory(-1),
                      tier_factory=factory, bucket_edges=[8000, 16000])
    S.ModelConfig(name="s", streaming=True, tiers=factory(-1),
                  tier_factory=factory, bucket_edges=[8000])
    with pytest.raises(ValueError, match="at least one tier"):
        S.ModelConfig(name="x", tiers=[])
    tier = S.ServingTier("fp", _fwd)
    cfg = S.ModelConfig(name="x", tiers=[tier])
    with pytest.raises(ValueError, match="tiers= OR models="):
        S.ServingRuntime([tier], models=[cfg])
    with pytest.raises(ValueError, match="at least one model"):
        S.ServingRuntime(models=[])
    with pytest.raises(ValueError, match="duplicate model"):
        S.ServingRuntime(models=[cfg, cfg])
    bad = S.ModelConfig(name="s", streaming=True, tiers=factory(-1),
                        tier_factory=lambda rid: factory(rid) * 2)
    with pytest.raises(ValueError, match="tier_factory built 2"):
        S.ServingRuntime(models=[bad])
    rt = S.ServingRuntime(models=[cfg], n_replicas=1,
                          clock=S.VirtualClock(),
                          service_time=lambda m, e, n, t: 0.01)
    with pytest.raises(ValueError, match="not a streaming"):
        rt.open_session()
    rt.submit(_ones())                  # one model: no model= needed
    rt.drain()
    assert rt.accounting()["by_state"] == {"done": 1}


def _mux_keyword_runtime(pkg, **kw):
    st = kw.pop("service_time")
    kw.pop("_extra", None)
    if st is None:
        kw["service_time"] = None
    return _mux_runtime(pkg, kw.pop("clock"), **kw)


def _mux_submit(pkg, rt):
    _overload(pkg, rt, rt.clock, 120, rate=300.0)


@pytest.mark.parametrize("kw,item", [
    ({"parallel_replicas": True}, "item 13"),
    ({"slice_width": 0}, "item 13"), ({"device_budget": 4}, "item 13"),
    ({"autoscaler": "Autoscaler"}, "item 13"),
    ({"chaos": "ChaosMonkey"}, "item 13"),
    ({"health": "HealthSentinel"}, "item 13"),
    ({"compile_s": 0.5}, "item 13"),
], ids=lambda v: next(iter(v)) if isinstance(v, dict) else v)
def test_multiplexed_refused_keyword_names_its_item(kw, item):
    """The keywords of ROADMAP.md item 13 on the multiplexed path:
    ``compile_s`` is still refused (a Known deviation); each of the
    others is served, and the runtime's validation error or its
    requests, pool events and snapshot under an overload are EQUAL to
    the reference's (``test_torch_serving.keyword_case``)."""
    import analytics_zoo_tpu.resilience.chaos as jchaos
    import analytics_zoo_tpu.resilience.health as jhealth
    import analytics_zoo_tpu_torch.resilience.chaos as tchaos
    import analytics_zoo_tpu_torch.resilience.health as thealth
    from test_torch_serving import keyword_case

    key, value = next(iter(kw.items()))
    if key == "compile_s":
        cfg = tserving.ModelConfig(name="x",
                                   tiers=[tserving.ServingTier("fp", _fwd)])
        with pytest.raises(NotImplementedError, match=item):
            tserving.ServingRuntime(models=[cfg], **kw)
        return
    pkgs = {"reference": types.SimpleNamespace(
                s=jserving, c=jchaos, h=jhealth, errors=jerrors, slo=jslo),
            "port": types.SimpleNamespace(
                s=tserving, c=tchaos, h=thealth, errors=terrors, slo=tslo)}
    got = {name: _jsonable(keyword_case(pkg, key, value,
                                        _mux_keyword_runtime, _mux_submit))
           for name, pkg in pkgs.items()}
    assert got["port"] == got["reference"]
    if key == "autoscaler":
        assert got["port"]["snapshot"]["autoscale"]["decisions"] > 0


def test_multiplexed_specs_on_one_rank_serves():
    """``specs=`` is served on the multiplexed path too (item 12b.4): over
    a one-rank mesh the model's tiers run as given; a per-replica
    ``tier_factory`` is refused only over several processes."""
    import torch_dist_scenarios as sc
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet

    cfg = tserving.ModelConfig(name="x",
                               tiers=[tserving.ServingTier("fp", _fwd)])
    rt = tserving.ServingRuntime(models=[cfg], n_replicas=1,
                                 specs=SpecSet(sc.StubMesh({"data": 1})))
    rt.submit({"input": np.ones(3, np.float32)}, model="x")
    rt.drain()
    rt.close()
    assert rt.accounting()["by_state"] == {"done": 1}
    assert rt.snapshot()["mesh"]["data_axis_size"] == 1


def test_still_refused_calls_name_their_item():
    """Live swaps are served (``tests/test_torch_live_swap.py``); what
    they still refuse is re-warming (``warm_s``, a Known deviation of
    item 13), and a model without ``weights_to_tiers`` cannot swap."""
    tier = tserving.ServingTier("fp", _fwd)
    cfg = tserving.ModelConfig(name="x", tiers=[tier],
                               weights_to_tiers=lambda v, rid: [tier])
    rt = tserving.ServingRuntime(
        models=[cfg, tserving.ModelConfig(name="y", tiers=[tier])])
    with pytest.raises(NotImplementedError, match="item 13"):
        rt.hot_swap("ckpt", model="x", warm_s=1.0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        rt.pool.hot_swap("ckpt", install=None, warm_s=1.0)
    with pytest.raises(ValueError, match="weights_to_tiers"):
        rt.hot_swap("ckpt", model="y", device="cpu")


def test_models_and_slo_keywords_are_accepted():
    """``models=``, ``slo=`` and ``slo_params=`` are served now: a
    single-model runtime with an evaluator passed in steps its ladder on
    the SLO decision, and a multiplexed one builds its own from the
    models' SLOs with ``slo_params``."""
    S = tserving
    clock = S.VirtualClock()
    ev = tslo.SloEvaluator(slos=[tslo.shed_rate_slo(0.01)],
                           fast_window_s=1.0, slow_window_s=10.0)
    rt = S.ServingRuntime([S.ServingTier("fp", _fwd),
                           S.ServingTier("lo", _fwd, 0.5)], slo=ev,
                          clock=clock, queue_capacity=2, max_batch=2,
                          decision_every=1,
                          ladder_policy=S.LadderPolicy(down_after=1),
                          service_time=lambda e, n, t: 0.01)
    for _ in range(4):
        try:
            rt.submit(_ones())
        except terrors.ServerOverloaded:
            pass
    clock.advance(0.5)
    rt.drain()
    assert rt.slo is ev and rt.ladder.tier == 1
    assert rt.ladder.events[0]["slo_burning"] == ["shed-rate"]
    assert rt.snapshot()["slo"]["trips"] == {"shed-rate": 1}
    cfg = S.ModelConfig(name="m", tiers=[S.ServingTier("fp", _fwd)],
                        slos=tslo.model_slos("m"))
    mux = S.ServingRuntime(models=[cfg], slo_params={"time_scale": 0.01})
    assert isinstance(mux.slo, tslo.SloEvaluator)
    assert mux.slo.fast_window_s == pytest.approx(3.0)
    assert mux.slo.registry is mux.metrics.registry


def test_resize_spares_session_pinned_replicas():
    """``ReplicaPool.resize(protected=...)`` on both packages: a
    protected replica is never the shrink victim, even fenced."""
    out = {}
    for name, pkg in PKGS.items():
        S = pkg.s
        clock = S.VirtualClock()
        rt, _ = _session_runtime(pkg, clock, n_replicas=3)
        rt.pool._fence(rt.pool.replicas[2], pkg.errors.ReplicaWedged("x"))
        acts = [rt.pool.resize(2, protected=[2]),
                rt.pool.resize(1, protected=[0, 2])]
        out[name] = _jsonable({
            "acts": acts, "after": [r.rid for r in rt.pool.replicas],
            "events": rt.pool.events,
            "by_rid": [rt.pool.replica_by_rid(i) is not None
                       for i in range(4)]})
    assert out["port"] == out["reference"]
    assert out["port"]["after"] == [0, 2]
    assert out["port"]["acts"][1]["drained"] == []
