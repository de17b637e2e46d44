"""Live-weight hot swap on the port's runtime (``ServingRuntime.hot_swap``,
``ReplicaPool.hot_swap``) against the JAX package's, on the CPU.

The serial-mode scenarios of ``tests/test_live_swap.py`` run through both
runtimes on the same ``VirtualClock`` schedule and the same toy linear
model (``ones(1, D) @ full((D, D), v)`` makes the served weights
visible): a full rollout, the serve-lkg hysteresis, a canary trip, a
mid-rollout rollback, a corrupt publish, one rollout at a time, a model
without ``weights_to_tiers``, a resize during a rollout and a
session-pinned replica swapped last; and, under the parallel service
model with a ``ChaosMonkey``, a replica crash in the middle of the
rollout (``TestSwapUnderChaosAndResize``).  Each scenario's own
assertions hold on both, and the records (the swap history, the pool's
events with the installed order, the mirrored count, ``accounting()``
and the whole ``snapshot()``) are EQUAL, checkpoint paths aside.

Then a tiny SSD's ``ssd_serving_tiers`` swapped through
``weights_to_tiers`` on the CPU serves the new weights' rows.
"""

import os
import types

import numpy as np
import pytest
import torch

import analytics_zoo_tpu.obs.slo as jslo
import analytics_zoo_tpu.resilience.chaos as jchaos
import analytics_zoo_tpu.serving as jserving
from analytics_zoo_tpu.parallel import checkpoint as jckpt
from analytics_zoo_tpu.resilience import errors as jerrors
import analytics_zoo_tpu_torch.obs.slo as tslo
import analytics_zoo_tpu_torch.resilience.chaos as tchaos
import analytics_zoo_tpu_torch.serving as tserving
from analytics_zoo_tpu_torch.parallel import checkpoint as tckpt
from analytics_zoo_tpu_torch.resilience import errors as terrors
from test_torch_serving import _jsonable

torch.set_num_threads(2)

D = 4   # toy feature dim: ones(1, D) @ full((D, D), v) == a row of D * v

PKGS = {
    "reference": types.SimpleNamespace(s=jserving, slo=jslo, ckpt=jckpt,
                                       errors=jerrors, chaos=jchaos,
                                       load_kw={},
                                       swap_kw={}),
    "port": types.SimpleNamespace(s=tserving, slo=tslo, ckpt=tckpt,
                                  errors=terrors, chaos=tchaos,
                                  load_kw={"device": "cpu"},
                                  swap_kw={"device": "cpu"}),
}


def _state(v: float):
    return {"w": np.full((D, D), float(v), np.float32)}


def _tiers(P, state):
    w = np.asarray(state["w"], np.float64)

    def fwd(batch, _w=w):
        return np.asarray(batch["input"], np.float64) @ _w

    return [P.s.ServingTier("fp", fwd), P.s.ServingTier("int8", fwd, 0.8)]


def _config(P, state):
    return P.s.ModelConfig(
        name="m", tiers=_tiers(P, state),
        weights_to_tiers=lambda loaded, rid: _tiers(P, loaded),
        length_key=None, default_deadline_s=5.0,
        slos=P.slo.model_slos("m", miss_budget=0.9, shed_budget=0.9))


def _runtime(P, state, **kw):
    kw.setdefault("n_replicas", 2)
    kw.setdefault("queue_capacity", 256)
    kw.setdefault("max_batch", 4)
    kw.setdefault("decision_every", 4)
    kw.setdefault("service_time", lambda m, e, n, t: 0.005)
    kw.setdefault("slo_params", dict(time_scale=0.01))
    clock = P.s.VirtualClock()
    return P.s.ServingRuntime(models=[_config(P, state)], clock=clock,
                              **kw), clock


def _feed(rt, clock, n, dt=0.05, model="m"):
    for _ in range(n):
        rt.submit({"input": np.ones((1, D), np.float32)}, model=model)
        clock.advance(dt)
        rt.pump()


def _served_value(rt) -> float:
    """One probe request's output: the weight every healthy replica
    serves, times D."""
    r = rt.submit({"input": np.ones((1, D), np.float32)}, model="m")
    rt.drain()
    assert r.state == "done"
    return float(np.asarray(r.result).ravel()[0])


def _record(rt, base, **extra):
    """What both runtimes must agree on, checkpoint paths made relative
    to the scenario's checkpoint directory."""
    def rel(x):
        if isinstance(x, dict):
            return {k: rel(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [rel(v) for v in x]
        if isinstance(x, str) and x.startswith(base):
            return os.path.relpath(x, base)
        return x

    events = rt.pool.events
    return _jsonable(rel({
        "snapshot": rt.snapshot(),
        "pool_events": events,
        "installed": [e["replica"] for e in rt.pool.events
                      if e["kind"] == "swap_installed"],
        "mirrored": rt.metrics.registry.counter(
            "serve/canary/mirrored/model=m").value,
        "accounting": rt.accounting(),
        **extra}))


# ---------------------------------------------------------------------------
# Scenarios: each returns its record
# ---------------------------------------------------------------------------


def full_rollout(P, base):
    rt, clock = _runtime(P, _state(1.0))
    snap = P.ckpt.save(os.path.join(base, "m"), _state(2.0), step=1)
    _feed(rt, clock, 8)
    rec = rt.hot_swap(snap, canary_fraction=1.0, canary_min=4,
                      divergence_budget=100.0, lkg_after=1, **P.swap_kw)
    assert rec["rollout"] == 0 and rt.swap_active
    submitted_before = rt.accounting()["submitted"]
    _feed(rt, clock, 40)
    rt.drain()
    swap = rt.snapshot()["swap"]
    assert swap["completed"] == 1 and swap["rollbacks"] == 0
    assert swap["history"][0]["outcome"] == "complete"
    served = _served_value(rt)
    assert served == pytest.approx(D * 2.0)
    mirrored = rt.metrics.registry.counter(
        "serve/canary/mirrored/model=m").value
    assert mirrored >= 4
    acct = rt.accounting()
    assert acct["submitted"] == submitted_before + 40 + 1
    assert acct["unaccounted"] == 0
    assert acct["by_state"] == {"done": acct["submitted"]}
    installed = [e["replica"] for e in rt.pool.events
                 if e["kind"] == "swap_installed"]
    assert sorted(installed) == [0, 1]
    assert any(e["kind"] == "swap_rollout_complete" for e in rt.pool.events)
    return _record(rt, base, served=served)


def lkg_hysteresis(P, base):
    rt, clock = _runtime(P, _state(1.0))
    root = os.path.join(base, "m")
    snap = P.ckpt.save(root, _state(2.0), step=1)
    rt.hot_swap(snap, canary_fraction=0.0, lkg_after=2, **P.swap_kw)
    _feed(rt, clock, 4)
    rt.drain()
    assert not rt.swap_active and rt.lkg_pending
    assert P.ckpt.tier_snapshot(root, "serve-lkg") is None
    _feed(rt, clock, 40)
    rt.drain()
    assert not rt.lkg_pending
    assert rt.snapshot()["swap"]["lkg_promotions"] == 1
    tier_dir, man = P.ckpt.tier_snapshot(root, "serve-lkg")
    assert man["meta"]["promoted_from"] == "step_1"
    np.testing.assert_array_equal(
        np.asarray(P.ckpt.load(tier_dir, verify=True, **P.load_kw)["w"]),
        _state(2.0)["w"])
    return _record(rt, base, lkg_meta=man["meta"])


def canary_trip(P, base):
    rt, clock = _runtime(P, _state(1.0))
    snap = P.ckpt.save(os.path.join(base, "m"), _state(500.0), step=1)
    rt.hot_swap(snap, canary_fraction=1.0, canary_min=64,
                divergence_budget=100.0, **P.swap_kw)
    _feed(rt, clock, 24)
    rt.drain()
    swap = rt.snapshot()["swap"]
    assert swap["trips"] == 1 and swap["rollbacks"] == 1
    assert swap["completed"] == 0
    assert swap["history"][0]["outcome"] == "rolled_back"
    assert swap["history"][0]["reason"].startswith(
        "canary_trip: canary-divergence/model=m")
    # tripped in the canary stage: no drain ever happened
    assert not any(e["kind"].startswith("swap_") for e in rt.pool.events)
    served = _served_value(rt)
    assert served == pytest.approx(D * 1.0)
    assert rt.accounting()["unaccounted"] == 0
    rt._swap_rollback("again")                  # the latch: exactly once
    assert rt.snapshot()["swap"]["rollbacks"] == 1
    assert not rt.lkg_pending
    return _record(rt, base, served=served)


def mid_rollout_rollback(P, base):
    rt, clock = _runtime(P, _state(1.0), n_replicas=3)
    snap = P.ckpt.save(os.path.join(base, "m"), _state(2.0), step=1)
    rt.hot_swap(snap, canary_fraction=0.0, **P.swap_kw)
    for _ in range(50):
        _feed(rt, clock, 1)
        if any(e["kind"] == "swap_installed" for e in rt.pool.events):
            break
    assert any(e["kind"] == "swap_installed" for e in rt.pool.events)
    assert rt.swap_active
    rt._swap_rollback("mid_rollout_anomaly: test")
    assert not rt.pool.rollout_active
    swap = rt.snapshot()["swap"]
    assert swap["rollbacks"] == 1 and swap["completed"] == 0
    served = [_served_value(rt) for _ in range(6)]
    assert served == pytest.approx([D * 1.0] * 6)
    rt._swap_rollback("again")
    assert rt.snapshot()["swap"]["rollbacks"] == 1
    return _record(rt, base, served=served)


def corrupt_publish(P, base):
    rt, clock = _runtime(P, _state(1.0))
    snap = P.ckpt.save(os.path.join(base, "m"), _state(2.0), step=1)
    man = P.ckpt.verify_snapshot(snap)
    rel = max(man["files"], key=lambda r: man["files"][r]["size"])
    full = os.path.join(snap, rel)
    data = bytearray(open(full, "rb").read())
    data[-1] ^= 0xFF               # same size, other content
    open(full, "wb").write(bytes(data))
    with pytest.raises(P.errors.CheckpointCorrupt) as err:
        rt.hot_swap(snap, **P.swap_kw)
    assert not rt.swap_active and not rt.pool.rollout_active
    assert "swap" not in rt.snapshot()
    _feed(rt, clock, 8)
    rt.drain()
    served = _served_value(rt)
    assert served == pytest.approx(D * 1.0)
    return _record(rt, base, served=served, error=type(err.value).__name__)


def one_rollout_at_a_time(P, base):
    rt, clock = _runtime(P, _state(1.0))
    root = os.path.join(base, "m")
    s1 = P.ckpt.save(root, _state(2.0), step=1)
    s2 = P.ckpt.save(root, _state(3.0), step=2)
    rt.hot_swap(s1, canary_fraction=1.0, canary_min=1000,
                divergence_budget=100.0, **P.swap_kw)
    with pytest.raises(RuntimeError, match="still in progress"):
        rt.hot_swap(s2, **P.swap_kw)
    return _record(rt, base)


def missing_weights_to_tiers(P, base):
    cfg = P.s.ModelConfig(name="bare", tiers=_tiers(P, _state(1.0)),
                          length_key=None)
    rt = P.s.ServingRuntime(models=[cfg], n_replicas=1,
                            clock=P.s.VirtualClock(),
                            service_time=lambda m, e, n, t: 0.005)
    snap = P.ckpt.save(os.path.join(base, "m"), _state(2.0), step=1)
    with pytest.raises(ValueError, match="weights_to_tiers"):
        rt.hot_swap(snap, model="bare", **P.swap_kw)
    return _jsonable({"snapshot": rt.snapshot()})


def resize_interleave(P, base):
    rt, clock = _runtime(P, _state(1.0), n_replicas=3)
    snap = P.ckpt.save(os.path.join(base, "m"), _state(2.0), step=1)
    rt.hot_swap(snap, canary_fraction=0.0, **P.swap_kw)
    sw = rt.pool._swap
    assert sw is not None and sw["pending"]
    # hold the remaining victims (the next pump re-derives the deferral)
    rt.pool.swap_defer = set(sw["pending"])
    pending = list(sw["pending"])
    actions = rt.pool.resize(4)
    assert actions["grown"] == [3]
    grown = [e["replica"] for e in rt.pool.events
             if e["kind"] == "swap_installed" and e.get("grown")]
    assert grown == [3]
    assert rt.pool.rollout_active
    retired = pending[-1]
    keep = [r.rid for r in rt.pool.replicas if r.rid != retired]
    rt.pool.resize(3, protected=keep)
    _feed(rt, clock, 40)
    rt.drain()
    rt.pump(force=True)
    assert rt.snapshot()["swap"]["completed"] == 1
    assert retired not in [r.rid for r in rt.pool.replicas]
    served = [_served_value(rt) for _ in range(6)]
    assert served == pytest.approx([D * 2.0] * 6)
    assert rt.accounting()["unaccounted"] == 0
    return _record(rt, base, served=served)


def session_swapped_last(P, base):
    def factory(rid):
        store = {}

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

        return [P.s.ServingTier("stream", forward,
                                evict_session=lambda s: store.pop(s, None))]

    stream_cfg = P.s.ModelConfig(name="stream", streaming=True,
                                 tiers=factory(-1), tier_factory=factory,
                                 length_key=None, chunk_deadline_s=2.0)
    clock = P.s.VirtualClock()
    rt = P.s.ServingRuntime(models=[_config(P, _state(1.0)), stream_cfg],
                            n_replicas=2, clock=clock, queue_capacity=64,
                            max_batch=4,
                            service_time=lambda m, e, n, t: 0.005,
                            slo_params=dict(time_scale=0.01))
    sid = rt.open_session("stream")
    pinned = rt._sessions[sid]["replica"]
    other = 1 - pinned
    rt.submit_chunk(sid, {"input": np.ones((1, D), np.float32)})
    rt.pump(force=True)
    snap = P.ckpt.save(os.path.join(base, "m"), _state(2.0), step=1)
    rt.hot_swap(snap, model="m", canary_fraction=0.0, **P.swap_kw)
    started = [e for e in rt.pool.events
               if e["kind"] == "swap_rollout_started"]
    assert started[0]["order"] == [other, pinned]
    _feed(rt, clock, 12)
    rt.drain()
    assert rt.pool.rollout_active
    installed = [e["replica"] for e in rt.pool.events
                 if e["kind"] == "swap_installed"]
    assert installed == [other]
    r = rt.submit_chunk(sid, {"input": np.ones((1, D), np.float32)})
    rt.drain()
    assert int(np.asarray(r.result)) == 2
    rt.submit_chunk(sid, {"input": np.ones((1, D), np.float32)},
                    final=True)
    _feed(rt, clock, 12)
    rt.drain()
    installed = [e["replica"] for e in rt.pool.events
                 if e["kind"] == "swap_installed"]
    assert installed == [other, pinned]
    rt.pump(force=True)
    assert rt.snapshot()["swap"]["completed"] == 1
    assert rt.accounting()["unaccounted"] == 0
    return _record(rt, base)


def _settle(rt, clock, limit=20_000):
    """A parallel-mode drain: advance the clock through the pool's event
    horizon until every request is terminal and no rollout is running."""
    for _ in range(limit):
        if rt.pump(force=True):
            continue
        if rt.accounting()["unaccounted"] == 0 and not rt.swap_active \
                and not rt.pool.rollout_active:
            return
        nxt = rt.next_event_t()
        step = (nxt - clock.now()) if nxt is not None else 0.01
        clock.advance(max(step, 1e-6))
    raise RuntimeError("parallel runtime did not settle")


def crash_mid_rollout(P, base):
    """A replica crash during the rollout, on the parallel service model:
    the crashed batches fail over once each, the fenced replica restarts
    and is swapped on its turn, and the rollout completes with no request
    lost or dispatched more than twice."""
    monkey = P.chaos.ChaosMonkey([])
    rt, clock = _runtime(P, _state(1.0), n_replicas=3,
                         parallel_replicas=True,
                         service_time=lambda m, e, n, t: 0.01,
                         fence_budget_s=0.5, restart_s=0.5, chaos=monkey)
    snap = P.ckpt.save(os.path.join(base, "m"), _state(2.0), step=1)
    _feed(rt, clock, 8, dt=0.02)
    rt.hot_swap(snap, canary_fraction=0.0, **P.swap_kw)
    sw = rt.pool._swap
    assert sw is not None and sw["pending"]
    victim = sw["pending"][-1]     # an unswapped, non-draining rid
    monkey.arm(P.chaos.FaultSpec("replica_crash", rt._dispatch_idx + 1,
                                 batches=200, detail={"replica": victim}))
    _feed(rt, clock, 80, dt=0.02)
    _settle(rt, clock)
    fences = [e for e in rt.pool.events if e["kind"] == "replica_fenced"]
    assert any(e["replica"] == victim for e in fences)
    assert sum(e["kind"] == "failover" for e in rt.pool.events) >= 1
    swap = rt.snapshot()["swap"]
    assert swap["completed"] == 1 and swap["rollbacks"] == 0
    installed = sorted(e["replica"] for e in rt.pool.events
                       if e["kind"] == "swap_installed")
    assert installed == [0, 1, 2]
    acct = rt.accounting()
    assert acct["unaccounted"] == 0
    assert acct["by_state"].get("failed", 0) == 0
    assert all(r.attempts <= 2 for r in rt.requests)
    assert any(r.attempts == 2 for r in rt.requests)
    served = _served_value(rt)
    assert served == pytest.approx(D * 2.0)
    return _record(rt, base, served=served, chaos=monkey.events,
                   attempts=[(r.rid, r.attempts, r.completed_t)
                             for r in rt.requests])


SCENARIOS = {f.__name__: f for f in (
    full_rollout, lkg_hysteresis, canary_trip, mid_rollout_rollback,
    corrupt_publish, one_rollout_at_a_time, missing_weights_to_tiers,
    resize_interleave, session_swapped_last, crash_mid_rollout)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_swap_scenario_equal_to_reference(name, tmp_path):
    bases = {k: str(tmp_path / k) for k in PKGS}
    ref = SCENARIOS[name](PKGS["reference"], bases["reference"])
    got = SCENARIOS[name](PKGS["port"], bases["port"])
    assert got == ref


def test_pool_hot_swap_refuses_warm_s(tmp_path):
    """Re-warming a swapped replica needs the compile-cost model."""
    rt, _clock = _runtime(PKGS["port"], _state(1.0))
    snap = tckpt.save(str(tmp_path / "m"), _state(2.0), step=1)
    with pytest.raises(NotImplementedError, match="item 13"):
        rt.pool.hot_swap(snap, install=lambda r: None, warm_s=1.0)
    with pytest.raises(NotImplementedError, match="item 13"):
        rt.hot_swap(snap, warm_s=1.0, device="cpu")


def test_hot_swap_hashes_the_snapshot_once(tmp_path, monkeypatch):
    """A whole rollout hashes each file of the snapshot once (the
    runtime's verified load); the pool called alone verifies itself."""
    P = PKGS["port"]
    rt, clock = _runtime(P, _state(1.0))
    snap = tckpt.save(str(tmp_path / "m"), _state(2.0), step=1)
    files = sorted(os.path.join(snap, f)
                   for f in tckpt.verify_snapshot(snap)["files"])
    hashed, sha256 = [], tckpt._sha256
    monkeypatch.setattr(tckpt, "_sha256",
                        lambda path, *a: hashed.append(path) or sha256(
                            path, *a))
    rt.hot_swap(snap, canary_fraction=0.0, lkg_after=1000, **P.swap_kw)
    _feed(rt, clock, 40)
    rt.drain()
    assert rt.snapshot()["swap"]["completed"] == 1
    assert _served_value(rt) == pytest.approx(D * 2.0)
    assert sorted(hashed) == files
    with open(files[-1], "r+b") as f:
        f.truncate(1)
    with pytest.raises(terrors.CheckpointCorrupt):
        rt.pool.hot_swap(snap, install=lambda r: None)
    assert not rt.pool.rollout_active


def test_tiny_ssd_serving_tiers_swap_serves_new_weights(tmp_path):
    """``ssd_serving_tiers`` of an SSD300 (4 classes) swapped through
    ``weights_to_tiers``: the module the rungs stand on holds the loaded
    state (on the CPU here), and after the rollout every request's rows
    equal the new weights' predictor's, called directly."""
    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                       ssd_serving_tiers)

    param = PreProcessParam(batch_size=2)
    old = SSDVgg(4, 300, device="cpu", seed=0)
    new = SSDVgg(4, 300, device="cpu", seed=1)
    snap = tckpt.save(str(tmp_path / "ssd"), new.state_dict(), step=1)
    built = []

    def weights_to_tiers(state, rid):
        m = SSDVgg(4, 300, device="cpu", seed=0)
        m.load_state_dict(state)
        built.append((rid, next(m.parameters()).device.type))
        return ssd_serving_tiers(m, param, n_classes=4, device="cpu")

    tiers = ssd_serving_tiers(old, param, n_classes=4, device="cpu")
    cfg = tserving.ModelConfig(name="ssd", tiers=tiers,
                               weights_to_tiers=weights_to_tiers,
                               length_key=None)
    rt = tserving.ServingRuntime(models=[cfg], n_replicas=2,
                                 clock=tserving.VirtualClock(), max_batch=2,
                                 default_deadline_s=60.0,
                                 wedge_timeout_s=60.0,
                                 service_time=lambda m, e, n, t: 0.01)
    rt.hot_swap(snap, canary_fraction=0.0, device="cpu")
    rng = np.random.RandomState(3)
    images = [rng.uniform(-120, 130, (300, 300, 3)).astype(np.float32)
              for _ in range(4)]
    reqs = [rt.submit({"input": x}) for x in images]
    rt.drain()
    rt.pump(force=True)
    assert rt.snapshot()["swap"]["completed"] == 1
    assert built == [(-1, "cpu"), (0, "cpu"), (1, "cpu")]
    assert all(r.state == "done" for r in reqs)
    want = ssd_serving_tiers(new, param, n_classes=4, device="cpu")[0]
    pred = want.device_program()[0].__self__
    got = np.stack([np.asarray(r.result) for r in reqs])
    np.testing.assert_array_equal(
        got, pred.detect_normalized(np.stack(images)).numpy())
    old_rows = tiers[0].device_program()[0].__self__.detect_normalized(
        np.stack(images)).numpy()
    assert not np.array_equal(got, old_rows)
