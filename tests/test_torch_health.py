"""The port's device-health sentinel (``resilience/health.py``) against the
JAX package's, on the CPU.

- the fingerprint: ``tree_fingerprint`` bit-equal to the reference's
  (jitted) on seeded trees of float32, bfloat16, float16 and int32
  leaves, with every single-bit flip of a small tree and with the
  injected flip, one ordered tree fed to both (sorted dict keys);
- ``HealthPolicy`` validation, the audit and shadow votes, the straggler
  hysteresis and the eviction budget: the same observations through
  both sentinels, each verdict, ``stats()`` and the event log EQUAL;
- ``make_audit_fn`` on one process, the hybrid-mesh refusal, the chaos
  ``bit_flip`` arming, the taxonomy, the metric names;
- ``TestServingHealthFeed``'s scenario (a parallel-mode runtime with
  ``chaos=``, ``health=`` and ``device_budget=3``) and the pool's
  quarantine through both packages, the records EQUAL; a ``slow_device``
  replica flagged and quarantined once;
- the ``Optimizer``: the default policy, the programs rebuilt each
  ``optimize()``, an audited run on one process.

The multi-rank audit (a flip on rank 2 of 4 named by every rank, the
survivors' resume) runs in ``tests/test_torch_elastic_mesh.py``'s group.
"""

import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.obs.registry as jreg
import analytics_zoo_tpu.resilience.chaos as jchaos
import analytics_zoo_tpu.resilience.health as jhealth
import analytics_zoo_tpu.serving as jserving
from analytics_zoo_tpu.resilience import errors as jerrors
import analytics_zoo_tpu_torch.obs.registry as treg
import analytics_zoo_tpu_torch.resilience.chaos as tchaos
import analytics_zoo_tpu_torch.resilience.health as thealth
import analytics_zoo_tpu_torch.serving as tserving
from analytics_zoo_tpu_torch.resilience import errors as terrors
from test_torch_serving import _jsonable

PKGS = {
    "reference": types.SimpleNamespace(h=jhealth, c=jchaos, s=jserving,
                                       errors=jerrors, reg=jreg),
    "port": types.SimpleNamespace(h=thealth, c=tchaos, s=tserving,
                                  errors=terrors, reg=treg),
}
_JFP = jax.jit(jhealth.tree_fingerprint)


def _jword(tree, flip=None):
    if flip is None:
        return int(_JFP(tree))
    e, b, on = flip
    return int(jax.jit(lambda t, o: jhealth.tree_fingerprint(
        t, flip=(jnp.uint32(e), jnp.uint32(b), o)))(tree, jnp.bool_(on)))


def _tword(tree, flip=None):
    return thealth.tree_fingerprint(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         tree.items()}, flip=flip)


def _trees():
    rng = np.random.RandomState(0)
    return [
        {"a": rng.randn(3, 4).astype(np.float32),
         "b": rng.randn(5).astype(np.float32)},
        {"w": rng.randn(4097).astype(np.float32),
         "i": rng.randint(-9, 9, (7,)).astype(np.int32),
         "z": rng.randn(2, 3).astype(np.float16)},
        {"big": (rng.randn(300, 200) * 1e4).astype(np.float32)},
    ]


# -- the fingerprint ----------------------------------------------------------

@pytest.mark.parametrize("k", range(3))
def test_fingerprint_equal_to_reference(k):
    tree = _trees()[k]
    assert _tword(tree) == _jword(tree)
    # the injected flip: every bit of an element the clip keeps
    for bit in (0, 7, 23, 31):
        for el in (0, 3, 10 ** 9):
            assert _tword(tree, (el, bit, True)) == _jword(
                tree, (el, bit, True)), (el, bit)
    assert _tword(tree, (1, 3, False)) == _jword(tree)


def test_fingerprint_bf16_and_every_single_bit_flip():
    rng = np.random.RandomState(1)
    raw = rng.randn(33).astype(np.float32)
    assert thealth.tree_fingerprint(
        {"b": torch.from_numpy(raw).to(torch.bfloat16)}) == int(
        _JFP({"b": jnp.asarray(raw, jnp.bfloat16)}))
    tree = {"a": np.arange(6, dtype=np.float32),
            "b": np.ones((3,), np.float32)}
    clean = _tword(tree)
    assert clean == _jword(tree)
    for leaf in ("a", "b"):
        for idx in range(tree[leaf].size):
            for bit in range(32):
                t = {k: v.copy() for k, v in tree.items()}
                t[leaf].view(np.uint32)[idx] ^= np.uint32(1 << bit)
                w = _tword(t)
                assert w != clean, (leaf, idx, bit)
                assert w == _jword(t), (leaf, idx, bit)


def test_fingerprint_of_a_module_is_its_parameters_in_order():
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    leaves = [p.detach().numpy() for p in m.parameters()]
    assert thealth.tree_fingerprint(m) == int(_JFP(leaves))


# -- the policy and the votes -------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"audit_every": -1}, {"shadow_every": -1}, {"shadow_device": 0},
    {"straggler_factor": 1.0}, {"straggler_alpha": 0.0},
    {"straggler_alpha": 1.5}, {"flag_after": 0}, {"clear_after": 0},
    {"warmup_obs": -1}, {"max_evictions": -1},
], ids=lambda kw: next(iter(kw)) + str(next(iter(kw.values()))))
def test_policy_validation_matches_reference(kw):
    msgs = []
    for pkg in PKGS.values():
        with pytest.raises(ValueError) as ei:
            pkg.h.HealthPolicy(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert thealth.HealthPolicy().audit_every == 0


def _verdict(v):
    return (v.ok, v.suspect, v.ambiguous, list(v.fingerprints))


def scenario_votes(pkg):
    reg = pkg.reg.MetricRegistry()
    s = pkg.h.HealthSentinel(registry=reg)
    out = [_verdict(s.observe_audit(8, fps)) for fps in
           ([7, 7, 7, 7], [7, 7, 9, 7], [7, 9, 7, 9], [7, 9, 8, 7], [7, 9],
            [1, 1], [1, 2, 1])]
    out += [_verdict(s.observe_shadow(4, 11, 11, device=1)),
            _verdict(s.observe_shadow(4, 11, 13, device=2, tiebreak_fp=11)),
            _verdict(s.observe_shadow(4, 11, 13, device=2, tiebreak_fp=13)),
            _verdict(s.observe_shadow(4, 11, 13, device=1))]
    s.note_quarantine(1, "parity_audit")
    return {"verdicts": out, "stats": s.stats(), "events": s.events,
            "budget": s.eviction_budget_left,
            "counters": reg.snapshot()["counters"]}


def scenario_stragglers(pkg):
    H = pkg.h
    out = {}

    def warm(s, devices=(0, 1, 2), t=0.05, rounds=3):
        return [s.observe_step_time(d, t) for _ in range(rounds)
                for d in devices]

    s = H.HealthSentinel(H.HealthPolicy(straggler_factor=2.0, flag_after=3,
                                        warmup_obs=2, straggler_alpha=1.0))
    out["flag"] = warm(s) + [s.observe_step_time(2, 0.5) for _ in range(4)]
    out["flag_state"] = (s.flagged(), s.stats(), s.events)
    s = H.HealthSentinel(H.HealthPolicy(straggler_factor=2.0, flag_after=3,
                                        clear_after=2, warmup_obs=2,
                                        straggler_alpha=1.0))
    out["noise"] = warm(s) + [s.observe_step_time(1, t)
                              for _ in range(5) for t in (0.5, 0.05, 0.05)]
    out["noise_state"] = (s.flagged(), s.stats())
    s = H.HealthSentinel(H.HealthPolicy(straggler_factor=2.0, flag_after=2,
                                        clear_after=2, warmup_obs=1,
                                        straggler_alpha=1.0))
    out["clear"] = warm(s, rounds=2) + [s.observe_step_time(2, t) for t in
                                        (0.5, 0.5, 0.05, 0.05)]
    out["clear_state"] = (s.flagged(), s.events)
    s = H.HealthSentinel(H.HealthPolicy(straggler_factor=2.0, flag_after=1,
                                        warmup_obs=3, straggler_alpha=1.0))
    out["warmup"] = warm(s, devices=(0, 1), rounds=4) + [
        s.observe_step_time(2, 1.0) for _ in range(4)]
    s = H.HealthSentinel(H.HealthPolicy(straggler_factor=2.0, flag_after=1,
                                        warmup_obs=1, straggler_alpha=1.0))
    seq = []
    for _ in range(2):
        seq += [s.observe_step_time(0, 0.05), s.observe_step_time(1, 0.05),
                s.observe_step_time(2, 1.0)]
    s.note_quarantine(2, "straggler")
    seq.append(s.observe_step_time(0, 0.12))
    out["median_drop"] = (seq, s.flagged(), s.stats(), s.events)
    s = H.HealthSentinel(H.HealthPolicy(straggler_alpha=0.25))
    rng = random.Random(3)
    out["ewma"] = [s.observe_step_time(rng.randrange(4),
                                       rng.uniform(0.01, 0.2))
                   for _ in range(200)]
    out["ewma_events"] = s.events
    return out


@pytest.mark.parametrize("scenario", [scenario_votes, scenario_stragglers],
                         ids=["votes", "stragglers"])
def test_sentinel_equal_to_reference(scenario):
    ref = _jsonable(scenario(PKGS["reference"]))
    got = _jsonable(scenario(PKGS["port"]))
    assert got == ref
    if scenario is scenario_votes:
        assert got["verdicts"][1] == [False, 2, False, [7, 7, 9, 7]]
        assert got["verdicts"][4][2] is True        # width 2: ambiguous
        assert got["counters"]["health/quarantines"] == 1
    else:
        assert got["flag"][-2:] == [2, None]
        assert got["median_drop"][0][-1] == 0


# -- the audit, eviction and the chaos hook -----------------------------------

def test_audit_on_one_process_and_refusals():
    params = {"w": np.arange(6, dtype=np.float32)}
    audit = thealth.make_audit_fn(None)
    clean = audit(params)
    assert clean == [int(_JFP(params))]
    # one rank holds no minority: the flip changes its one word only
    assert audit(params, 0, 0, 3) == [_jword(params, (0, 3, True))]
    assert thealth.HealthSentinel().observe_audit(0, clean).ok


def test_hybrid_mesh_and_only_device_refused():
    import torch_dist_scenarios as sc

    with pytest.raises(ValueError, match="pure data-parallel"):
        thealth.make_audit_fn(sc.StubMesh({"data": 2, "model": 1}))
    one = types.SimpleNamespace(mesh=torch.tensor([0]))
    with pytest.raises(ValueError, match="only device"):
        thealth.evict_device(one, 0)


@pytest.mark.parametrize("name", sorted(PKGS))
def test_bit_flip_arms_and_disarm_clears(name):
    pkg = PKGS[name]
    monkey = pkg.c.ChaosMonkey([pkg.c.FaultSpec(
        "bit_flip", 1, detail={"replica": 2, "element": 5, "bit": 3})])
    data = [{"x": np.zeros(2)} for _ in range(3)]
    with monkey:
        assert len(list(monkey.dataset(data))) == 3
        assert pkg.h.active_bit_flip() == (2, 5, 3)
        assert monkey.events == [{"kind": "bit_flip", "at_batch": 1,
                                  "replica": 2, "element": 5, "bit": 3}]
    assert pkg.h.active_bit_flip() is None
    try:
        assert pkg.h.arm_bit_flip(1) is None
        assert pkg.h.arm_bit_flip(3, element=2, bit=7) == (1, 0, 0)
    finally:
        pkg.h.clear_bit_flip()


def test_taxonomy_matches_reference():
    for pkg in PKGS.values():
        e = pkg.errors.DeviceQuarantine("replica 2 corrupt", device=2)
        assert pkg.errors.DeviceQuarantine in pkg.errors._RETRYABLE_CLASSES
        assert pkg.errors.is_retryable(e) and e.device == 2
        assert pkg.errors.SdcDetected in pkg.errors.FATAL_ERRORS
        assert not pkg.errors.is_retryable(pkg.errors.SdcDetected("x"))


def test_health_metrics_are_cataloged():
    from analytics_zoo_tpu_torch.obs.names import lookup

    for name in ("health/audits", "health/audit_divergences",
                 "health/shadow_checks", "health/shadow_mismatches",
                 "health/straggler_flags", "health/quarantines"):
        assert lookup(name), name


# -- serving: the health feed and the pool's quarantine -----------------------

def scenario_serving_health_feed(pkg, slow_device=False, n=90):
    """``TestServingHealthFeed``: a chaos ``slow_forward`` on replica 2
    must not flag it (the ladder sees the service time only); with
    ``slow_device`` on replica 1 the ladder flags it and the pool
    quarantines it once."""
    S, C, H = pkg.s, pkg.c, pkg.h
    service_s = 0.05

    def fwd(batch):
        return np.zeros((np.asarray(batch["input"]).shape[0], 1),
                        np.float32)

    clock = S.VirtualClock()
    faults = [C.FaultSpec("slow_forward", 0, batches=10 ** 6,
                          detail={"replica": 2, "delay_s": 0.2})]
    if slow_device:
        faults.append(C.FaultSpec("slow_device", 0, batches=10 ** 6,
                                  detail={"replica": 1, "slow_x": 4.0}))
    monkey = C.ChaosMonkey(faults)
    sentinel = H.HealthSentinel(H.HealthPolicy(
        straggler_factor=2.0, straggler_alpha=0.25, flag_after=2,
        warmup_obs=1, evict=True, max_evictions=1))
    scaler = S.Autoscaler(S.AutoscalePolicy(max_replicas=3))
    rt = S.ServingRuntime(
        [S.ServingTier("fp", fwd, speed=1.0)], n_replicas=3, clock=clock,
        queue_capacity=n, max_batch=1, default_deadline_s=30.0,
        service_time=lambda edge, n_, tier: service_s,
        decision_every=10 ** 9, shed_expired=False, chaos=monkey,
        health=sentinel, parallel_replicas=True, device_budget=3,
        autoscaler=scaler)
    rng = random.Random(0)
    t, arrivals = 0.0, []
    for _ in range(n):
        t += rng.expovariate(1.0 / 0.045)
        arrivals.append(t)
    i = 0
    while i < n:
        now = clock.now()
        if now < arrivals[i]:
            if rt.pump() == 0:
                ev = rt.next_event_t()
                target = arrivals[i] if ev is None else min(ev, arrivals[i])
                clock.advance(max(target - now, 1e-9))
            continue
        while i < n and clock.now() >= arrivals[i]:
            rt.submit({"input": np.zeros((1, 4), np.float32)},
                      deadline_s=30.0)
            i += 1
        rt.pump()
    for _ in range(100_000):
        if len(rt.queue) == 0:
            break
        if rt.pump() == 0:
            ev = rt.next_event_t()
            clock.advance(max((ev - clock.now()) if ev is not None
                              else 0.05, 1e-9))
    rt.drain()
    return {"acct": rt.accounting(), "stats": sentinel.stats(),
            "health_events": sentinel.events, "pool": rt.pool.events,
            "chaos": len(monkey.events), "scaler": scaler.snapshot(),
            "requests": [(r.rid, r.state, r.completed_t, r.attempts)
                         for r in rt.requests],
            "budget": rt.pool.device_budget, "snapshot": rt.snapshot()}


@pytest.mark.parametrize("slow_device", [False, True],
                         ids=["slow_forward_only", "slow_device"])
def test_serving_health_feed_equal_to_reference(slow_device):
    ref = _jsonable(scenario_serving_health_feed(PKGS["reference"],
                                                 slow_device))
    got = _jsonable(scenario_serving_health_feed(PKGS["port"], slow_device))
    assert got == ref
    assert got["acct"]["unaccounted"] == 0
    quarantined = [e for e in got["pool"]
                   if e["kind"] == "replica_quarantined"]
    if slow_device:
        assert got["stats"]["quarantines"] == 1
        assert [e["replica"] for e in quarantined] == [1]
        assert got["budget"] == 2
        assert got["scaler"]["evicted_devices"] == 1
    else:
        assert got["stats"]["straggler_flags"] == 0 and not quarantined
        assert got["budget"] == 3


def scenario_pool_quarantine(pkg):
    S = pkg.s
    clock = S.VirtualClock()
    reps = [S.Replica(i, [lambda b: np.zeros((1, 1))], clock,
                      wedge_timeout_s=1.0) for i in range(3)]
    pool = S.ReplicaPool(reps, clock, device_budget=3)
    got = [pool.quarantine(1, reason="straggler"), pool.quarantine(1),
           pool.quarantine(99)]
    clock.advance(0.01)
    healthy = [r.rid for r in pool.healthy()]
    return {"got": got, "budget": pool.device_budget, "healthy": healthy,
            "events": pool.events, "used": pool.devices_used}


def test_pool_quarantine_equal_to_reference():
    ref = _jsonable(scenario_pool_quarantine(PKGS["reference"]))
    got = _jsonable(scenario_pool_quarantine(PKGS["port"]))
    assert got == ref
    assert got["got"] == [True, False, False] and got["budget"] == 2
    assert got["healthy"] == [0, 2]


# -- the Optimizer ------------------------------------------------------------

def _tiny_optimizer(data):
    from analytics_zoo_tpu_torch.core.criterion import MSECriterion
    from analytics_zoo_tpu_torch.parallel import SGD, Optimizer, Trigger

    torch.manual_seed(0)
    m = torch.nn.Linear(4, 1)
    return (Optimizer(m, data, MSECriterion()).set_optim_method(SGD(0.05))
            .set_end_when(Trigger.max_epoch(1)))


def test_optimizer_health_policy_and_program_cache():
    data = [{"input": np.ones((2, 4), np.float32),
             "target": np.zeros((2, 1), np.float32)}] * 3
    opt = _tiny_optimizer(data)
    assert opt.health_policy is None
    assert opt.set_health_policy().health_policy.audit_every == 8
    stale = object()
    plain = _tiny_optimizer(data)
    plain._audit_fn = plain._shadow_fn = stale
    plain.optimize()
    assert plain._audit_fn is None and plain._shadow_fn is None
    audited = _tiny_optimizer(data).set_health_policy(
        thealth.HealthPolicy(audit_every=1, shadow_every=1))
    audited.optimize()
    assert audited._health.stats()["audits"] == 3
    assert audited._health.stats()["audit_divergences"] == 0
    # one process, no second device: the shadow does not run
    assert audited._health.stats()["shadow_checks"] == 0
    assert callable(audited._audit_fn)
    want = plain.model.weight.detach().clone()
    assert torch.equal(audited.model.weight.detach(), want)
