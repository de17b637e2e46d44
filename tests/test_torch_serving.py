"""The port's online serving runtime (``serving/``) against the JAX
package's, on the CPU.

The same scripted scenarios (those of ``tests/test_serving.py``) run
through both runtimes on a ``VirtualClock`` with one ``service_time``
model and spy tiers that return numpy rows: FIXED and bucketed batching
with padding, EDF order, shedding at a full queue, deadline expiry, a
step down the ladder and back up, a forward that raises on call n (one
re-dispatch; a second failure fails the batch), and a wedge past
``wedge_timeout_s`` with and without ``fence_budget_s``.  Held EQUAL,
field for field: ``accounting()``, each request's state, completion time,
tier and attempts, each dispatched batch's composition, the ladder's and
the pool's events, and the whole ``snapshot()``.

Then ``ssd_serving_tiers`` on bridged SSD300 weights through each
runtime, ``approx_topk`` against the reference's "pallas" rows, and the
refusals of what the port does not serve yet.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.serving as jserving
from analytics_zoo_tpu.core.module import Model
from analytics_zoo_tpu.models import ssd as jax_ssd
from analytics_zoo_tpu.ops.detection_output import (
    DetectionOutputParam as JaxParam, detection_output as jax_detout)
from analytics_zoo_tpu.pipelines.ssd import (
    PreProcessParam as JaxPreProcessParam,
    ssd_serving_tiers as jax_serving_tiers)
from analytics_zoo_tpu.resilience import errors as jerrors
import analytics_zoo_tpu_torch.serving as tserving
from analytics_zoo_tpu_torch.models import ssd
from analytics_zoo_tpu_torch.ops.detection_output import (
    DetectionOutputParam, detection_output, resolve_backend)
from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                   SSDPredictor,
                                                   ssd_serving_tiers)
from analytics_zoo_tpu_torch.resilience import errors as terrors
from analytics_zoo_tpu_torch.utils.convert import ssd_params_from_jax
from test_torch_detection_output import _assert_rows_match, _case
from test_torch_ssd import seeded_flax_params

torch.set_num_threads(2)

PKGS = {
    "reference": types.SimpleNamespace(s=jserving, errors=jerrors),
    "port": types.SimpleNamespace(s=tserving, errors=terrors),
}


class Spy:
    """A tier forward returning each row's sum; ``raise_on`` holds the
    1-based call numbers that raise, ``wedge_on`` those after which the
    next service time is ``wedge_s`` (a forward that stalls); ``seen``
    observes each batch."""

    def __init__(self, raise_on=(), wedge_on=(), wedge_s=9.0, seen=None):
        self.calls = 0
        self.raise_on, self.wedge_on = set(raise_on), set(wedge_on)
        self.wedge_s = wedge_s
        self.pending_wedge = False
        self.seen = seen              # called with each batch dict

    def __call__(self, batch):
        self.calls += 1
        if self.seen is not None:
            self.seen(batch)
        if self.calls in self.raise_on:
            raise RuntimeError(f"spy: forward {self.calls} failed")
        if self.calls in self.wedge_on:
            self.pending_wedge = True
        x = batch["input"]
        return x.reshape(x.shape[0], -1).sum(axis=1)

    def service_time(self, base):
        def st(edge, n, tier):
            if self.pending_wedge:
                self.pending_wedge = False
                return self.wedge_s
            return base(edge, n, tier) if callable(base) else base
        return st


def _build(pkg, spies, speeds=(1.0, 0.6, 0.45), service=0.05, **kw):
    names = ["fp", "int8", "int8_lowk"]
    tiers = [pkg.s.ServingTier(names[i], spy, speeds[i])
             for i, spy in enumerate(spies)]
    kw.setdefault("queue_capacity", 32)
    kw.setdefault("max_batch", 4)
    kw.setdefault("default_deadline_s", 10.0)
    kw.setdefault("wedge_timeout_s", 1.0)
    kw.setdefault("restart_s", 3.0)
    kw.setdefault("n_replicas", 2)
    clock = pkg.s.VirtualClock()
    rt = pkg.s.ServingRuntime(tiers, clock=clock,
                              service_time=spies[0].service_time(service),
                              **kw)
    batches = []
    orig = rt._dispatch

    def record(batch):
        batches.append((str(batch.edge), batch.n_valid, batch.tier,
                        tuple(r.rid for r in batch.requests)))
        orig(batch)

    rt._dispatch = record
    return rt, clock, batches


def _drive_load(pkg, rt, clock, n, gap_s):
    """tests/test_serving.py's fixed arrival schedule: every arrival whose
    instant has passed is submitted before the scheduler's next turn."""
    t_next = clock.now()
    submitted = 0
    while submitted < n:
        if clock.now() < t_next:
            if rt.pump() == 0:
                clock.advance(t_next - clock.now())
            continue
        while submitted < n and clock.now() >= t_next:
            try:
                rt.submit({"input": np.ones((1, 2), np.float32)})
            except pkg.errors.ServerOverloaded:
                pass
            submitted += 1
            t_next += gap_s
        rt.pump()


def _record(rt, batches, spies):
    """Everything the two runtimes must agree on."""
    return {
        "accounting": rt.accounting(),
        "requests": [(r.rid, r.state, r.completed_t, r.tier, r.attempts,
                      type(r.error).__name__ if r.error else None,
                      None if r.result is None else float(r.result))
                     for r in rt.requests],
        "batches": batches,
        "ladder": rt.ladder.events,
        "pool": rt.pool.events,
        "snapshot": rt.snapshot(),
        "forward_calls": [s.calls for s in spies],
    }


# -- the scripted scenarios ----------------------------------------------


def scenario_bucketed(pkg):
    spies = [Spy()]
    rt, clock, batches = _build(pkg, spies, n_replicas=1, max_batch=3,
                                bucket_edges=[8, 16], default_deadline_s=5.0,
                                wedge_timeout_s=5.0, service=0.01)
    for i, n in enumerate([3, 12, 7, 15, 5, 9, 2, 14, 6]):
        rt.submit({"input": np.full((n, 2), i + 1.0, np.float32)},
                  length=n, deadline_s=2.0 + 0.1 * i)
        clock.advance(0.05)
        rt.pump()
    rt.drain()
    return _record(rt, batches, spies)


def scenario_padding(pkg):
    shapes = []
    spy = Spy(seen=lambda b: shapes.append((b["input"].shape,
                                            tuple(b["n_frames"]))))
    rt, clock, batches = _build(pkg, [spy], n_replicas=1, max_batch=4,
                                bucket_edges=[8], default_deadline_s=1.0,
                                wedge_timeout_s=5.0, service=0.01)
    rt.submit({"input": np.ones((5, 3), np.float32)}, length=5)
    rt.submit({"input": np.ones((2, 3), np.float32)}, length=2)
    rt.drain()
    out = _record(rt, batches, [spy])
    out["shapes"] = shapes
    return out


def scenario_fixed_edf_expiry(pkg):
    seen = []
    spy = Spy(seen=lambda b: seen.extend(b["input"][:, 0, 0].tolist()))
    rt, clock, batches = _build(pkg, [spy], n_replicas=1, max_batch=4,
                                queue_capacity=16, default_deadline_s=1.0,
                                wedge_timeout_s=5.0, service=0.01)
    for i, dl in enumerate([0.5, 5.0, 3.0, 4.0, 0.8, 6.0]):
        # a poison value on the requests that expire while queued
        rt.submit({"input": np.full((1, 2), 7.0 if dl < 1 else i,
                                    np.float32)}, deadline_s=dl)
    clock.advance(1.0)
    rt.drain()
    out = _record(rt, batches, [spy])
    out["served_values"] = seen
    return out


def scenario_queue_full(pkg):
    spies = [Spy()]
    rt, clock, batches = _build(pkg, spies, queue_capacity=2, max_batch=8,
                                default_deadline_s=100.0)
    raised = []
    for _ in range(3):
        try:
            rt.submit({"input": np.ones((1, 2), np.float32)})
        except pkg.errors.ServerOverloaded as e:
            raised.append(pkg.errors.is_retryable(e))
    rt.drain()
    out = _record(rt, batches, spies)
    out["raised"] = raised
    return out


def scenario_ladder(pkg):
    spies = [Spy(), Spy()]
    rt, clock, batches = _build(
        pkg, spies, queue_capacity=8, max_batch=2, default_deadline_s=0.4,
        service=lambda e, n, t: 0.15 if t == 0 else 0.06, decision_every=2,
        ladder_policy=pkg.s.LadderPolicy(down_after=2, up_after=3))
    _drive_load(pkg, rt, clock, 40, gap_s=0.05)      # overload
    _drive_load(pkg, rt, clock, 30, gap_s=0.2)       # calm
    rt.drain()
    return _record(rt, batches, spies)


def scenario_raise_once(pkg):
    spies = [Spy(raise_on=[2])]
    rt, clock, batches = _build(pkg, spies)
    for _ in range(16):
        rt.submit({"input": np.ones((2, 2), np.float32)})
        clock.advance(0.2)
        rt.pump()
    rt.drain()
    clock.advance(rt.pool.restart_s + 10.0)
    out = _record(rt, batches, spies)
    out["healthy_after_restart"] = [r.rid for r in rt.pool.healthy()]
    out["pool_after_restart"] = rt.pool.events
    return out


def scenario_raise_twice(pkg):
    spies = [Spy(raise_on=[1, 2])]
    rt, clock, batches = _build(pkg, spies)
    for _ in range(4):
        rt.submit({"input": np.ones((2, 2), np.float32)})
    rt.drain()
    return _record(rt, batches, spies)


def scenario_wedge(pkg, fence_budget_s=None):
    spies = [Spy(wedge_on=[2], wedge_s=9.0)]
    rt, clock, batches = _build(pkg, spies, default_deadline_s=30.0,
                                fence_budget_s=fence_budget_s)
    for _ in range(8):
        rt.submit({"input": np.ones((2, 2), np.float32)})
        clock.advance(0.2)
        rt.pump()
    rt.drain()
    out = _record(rt, batches, spies)
    out["now"] = clock.now()
    return out


SCENARIOS = {
    "bucketed": scenario_bucketed,
    "padding": scenario_padding,
    "fixed_edf_expiry": scenario_fixed_edf_expiry,
    "queue_full": scenario_queue_full,
    "ladder_down_and_up": scenario_ladder,
    "forward_raises_once": scenario_raise_once,
    "forward_raises_twice": scenario_raise_twice,
    "wedge": scenario_wedge,
    "wedge_fence_budget": lambda pkg: scenario_wedge(pkg, fence_budget_s=0.5),
}


def _jsonable(x):
    """numpy scalars → Python, so the two records compare by value."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equal_to_reference(name):
    ref = _jsonable(SCENARIOS[name](PKGS["reference"]))
    got = _jsonable(SCENARIOS[name](PKGS["port"]))
    assert got == ref


def test_scenarios_cover_what_they_claim():
    """The scenarios reach the behaviour they are named for (on the port;
    the reference is equal by the test above)."""
    port = PKGS["port"]
    b = scenario_bucketed(port)
    assert {e for e, *_ in b["batches"]} <= {"8", "16"}
    assert any(n == 3 for _, n, *_ in b["batches"])
    assert scenario_padding(port)["shapes"] == [((4, 8, 3), (5, 2, 0, 0))]
    e = scenario_fixed_edf_expiry(port)
    assert 7.0 not in e["served_values"]
    assert e["accounting"]["by_state"] == {"done": 4, "timeout": 2}
    assert [r[0] for r in e["requests"] if r[1] == "done"] == [1, 2, 3, 5]
    q = scenario_queue_full(port)
    assert q["raised"] == [True] and q["accounting"]["by_state"] == {
        "done": 2, "shed": 1}
    lad = scenario_ladder(port)
    kinds = [ev["kind"] for ev in lad["ladder"]]
    assert "tier_down" in kinds and "tier_up" in kinds
    assert lad["snapshot"]["ladder"]["tier"] == 0
    assert {t for *_, t, _ in lad["batches"]} == {0, 1}
    once = scenario_raise_once(port)
    assert once["accounting"]["by_state"] == {"done": 16}
    assert [ev["kind"] for ev in once["pool"]][:2] == ["replica_fenced",
                                                        "failover"]
    assert once["healthy_after_restart"] == [0, 1]
    twice = scenario_raise_twice(port)
    assert twice["accounting"]["by_state"] == {"failed": 4}
    assert {r[4] for r in twice["requests"]} == {2}
    assert {r[5] for r in twice["requests"]} == {"ReplicaWedged"}
    for budget in (None, 0.5):
        w = scenario_wedge(port, fence_budget_s=budget)
        fences = [ev for ev in w["pool"] if ev["kind"] == "replica_fenced"]
        assert len(fences) == 1 and "wedged" in fences[0]["error"]
        assert w["accounting"]["by_state"] == {"done": 8}
    # the fence budget fences at 0.5 s into the stall, not at its end
    assert (scenario_wedge(port, 0.5)["pool"][0]["t"]
            < scenario_wedge(port)["pool"][0]["t"])


# -- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("kw,item", [
    ({"models": []}, "item 13"), ({"parallel_replicas": True}, "item 13"),
    ({"slice_width": 2}, "item 13"), ({"device_budget": 4}, "item 13"),
    ({"slo": object()}, "item 13"), ({"slo_params": {}}, "item 13"),
    ({"autoscaler": object()}, "item 13"), ({"chaos": object()}, "item 13"),
    ({"obs": object()}, "item 13"), ({"health": object()}, "item 13"),
    ({"specs": object()}, "item 12"), ({"compile_s": 0.5}, "item 13"),
], ids=lambda v: next(iter(v)) if isinstance(v, dict) else v)
def test_refused_keyword_names_its_item(kw, item):
    tiers = [tserving.ServingTier("fp", Spy())]
    with pytest.raises(NotImplementedError, match=item):
        tserving.ServingRuntime(tiers, **kw)


def test_defaults_of_refused_keywords_construct():
    rt = tserving.ServingRuntime(
        [tserving.ServingTier("fp", Spy())], models=None,
        parallel_replicas=False, slice_width=1, device_budget=None,
        slo=None, slo_params=None, autoscaler=None, chaos=None, obs=None,
        health=None, specs=None, compile_s=0.0)
    for call, item in ((rt.open_session, "item 13"),
                       (rt.submit_chunk, "item 13"),
                       (rt.close_session, "item 13"),
                       (rt.hot_swap, "item 12"),
                       (rt.pool.hot_swap, "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            call()


def test_error_taxonomy_matches_reference():
    for name in ("StallError", "ServerOverloaded", "RequestTimeout",
                 "ReplicaWedged"):
        exc = getattr(terrors, name)("x")
        assert terrors.is_retryable(exc) == jerrors.is_retryable(
            getattr(jerrors, name)("x")) is True
    assert terrors.is_retryable(torch.cuda.OutOfMemoryError("oom"))
    assert not terrors.is_retryable(ValueError("bad shape"))


def test_resize_grows_prewarmed_and_drains():
    """``ReplicaPool.resize`` on both packages, the reference at its
    default ``compile_s=0``: growth joins healthy at once; shrink drains,
    then retires idle replicas.  The port keeps no pre-warm model, so its
    ``replica_joined`` event has no ``prewarm`` field: that field is
    dropped from the reference's events before they are held equal."""
    out = {}
    for name, pkg in PKGS.items():
        rt, clock, _ = _build(pkg, [Spy(), Spy()])
        acts = [rt.pool.resize(4)]
        states = [r.state for r in rt.pool.replicas]
        clock.advance(1.0)
        healthy = [r.rid for r in rt.pool.healthy()]
        acts.append(rt.pool.resize(1))
        events = [{k: v for k, v in ev.items() if k != "prewarm"}
                  for ev in rt.pool.events]
        out[name] = _jsonable({"acts": acts, "states": states,
                               "healthy": healthy,
                               "after": [r.rid for r in rt.pool.replicas],
                               "events": events,
                               "next": rt.next_event_t()})
    assert out["port"] == out["reference"]
    assert out["port"]["states"] == ["healthy"] * 4
    assert out["port"]["healthy"] == [0, 1, 2, 3]
    assert out["port"]["after"] == [0]
    assert [ev["kind"] for ev in out["port"]["events"]] == (
        ["replica_joined"] * 2 + ["replica_draining"] * 3
        + ["replica_retired"] * 3)


# -- SSD rungs on bridged weights -------------------------------------------

# as tests/test_torch_predictor.py: scores separated beyond the forward's
# disagreement, so the candidate sets and orders match one for one
POST = dict(n_classes=21, conf_thresh=0.4)
SCORE_TOL = 1e-5
# normalized boxes: loc deltas agree to ~1e-5, scaled by a 0.1-0.2
# variance and a prior size <= 1
BOX_TOL = 1e-4


@pytest.fixture(scope="module")
def ssd_tiers():
    jmod = jax_ssd.SSDVgg(num_classes=21, resolution=300)
    variables = {"params": seeded_flax_params(jmod, 300)}
    tmod = ssd.SSDVgg(21, 300, device="cpu", seed=1)
    tmod.load_state_dict(ssd_params_from_jax(variables["params"], tmod))
    ref = jax_serving_tiers(Model(jmod, variables),
                            JaxPreProcessParam(batch_size=2),
                            post=JaxParam(**POST))
    port = ssd_serving_tiers(tmod, PreProcessParam(batch_size=2),
                             post=DetectionOutputParam(**POST),
                             device="cpu")
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 256, (300, 300, 3)).astype(np.float32)
              - np.float32([104, 117, 123]) for _ in range(2)]
    return ref, port, images


def _serve_each_rung(pkg, tiers, images):
    """Each rung forced in turn for one batch of the two images."""
    clock = pkg.s.VirtualClock()
    rt = pkg.s.ServingRuntime(tiers, n_replicas=1, clock=clock,
                              max_batch=2, default_deadline_s=60.0,
                              wedge_timeout_s=60.0,
                              service_time=lambda e, n, t: 0.01)
    rows = []
    for tier in range(len(tiers)):
        rt.ladder.tier = tier
        for x in images:
            rt.submit({"input": x})
        assert rt.pump(force=True) == 1
        rows.append(np.stack([np.asarray(r.result)
                              for r in rt.requests[-2:]]))
    assert rt.accounting()["by_state"] == {"done": 6}
    return rows


def test_ssd_tiers_names_and_pins(ssd_tiers):
    ref, port, _ = ssd_tiers
    assert [t.name for t in port] == [t.name for t in ref] == [
        "fp", "int8", "int8_topk50"]
    posts = [t.device_program()[1][-1] for t in port]
    assert [p.keep_topk for p in posts] == [
        t.device_program()[1][-1].keep_topk for t in ref] == [200, 200, 50]
    assert [t.speed for t in port][0] == 1.0
    # the int8 rungs share one quantized model, the fp rung has its own
    preds = [t.device_program()[0].__self__ for t in port]
    assert preds[1].model is preds[2].model is not preds[0].model
    assert preds[1].quantize is True and preds[0].quantize is False
    # set_top_k on a predictor reaches no rung (copy-on-write)
    low = preds[0].set_top_k(3)
    assert low.post.keep_topk == 3 and preds[0].post.keep_topk == 200
    assert [t.device_program()[1][-1].keep_topk for t in port] == [
        200, 200, 50]
    fn, args = port[2].device_program()
    assert fn(*args).shape == (1, 50, 6)
    with pytest.raises(NotImplementedError, match="item 12"):
        ssd_serving_tiers(preds[0].model, PreProcessParam(), specs=object(),
                          device="cpu")


def test_ssd_rungs_through_both_runtimes(ssd_tiers):
    """The rungs' rows through each runtime: the two packages' rows match
    one for one (classes equal, scores within ``SCORE_TOL``, boxes within
    ``BOX_TOL``), the port's through the runtime equal its predictor's
    called directly, and ``int8_topk50`` keeps at most 50 rows."""
    ref, port, images = ssd_tiers
    ref_rows = _serve_each_rung(PKGS["reference"], ref, images)
    got_rows = _serve_each_rung(PKGS["port"], port, images)
    x = np.stack(images)
    for t, got, want in zip(port, got_rows, ref_rows):
        pred = t.device_program()[0].__self__
        with torch.no_grad():
            _, conf = pred._eval_step(torch.from_numpy(x))
        fg = torch.softmax(conf, -1)[..., 1:].numpy()
        for b in range(2):
            cand = np.sort(fg[b][fg[b] > POST["conf_thresh"]])
            assert np.diff(cand).min() > 2 * SCORE_TOL, t.name
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0,
                                   atol=SCORE_TOL)
        np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                                   atol=BOX_TOL)
        np.testing.assert_array_equal(
            got, pred.detect_normalized(x).numpy())
        assert (got[..., 1] > 0).sum() >= 5
    assert got_rows[2].shape == (2, 50, 6)
    np.testing.assert_array_equal(got_rows[2], got_rows[1][:, :50])


# -- approx_topk ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["trained_like_0", "dense_3", "int8_ties"])
def test_approx_topk_equals_reference_pallas_rows(name):
    """``approx_topk`` on the unfused path: the reference's
    ``lax.approx_max_k`` (interpret-mode K1) against the port's exact
    stable top-k (K1's plain version), rows equal."""
    loc, conf, priors, variances, kw = _case(name)
    ref = np.asarray(jax_detout(
        jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors),
        jnp.asarray(variances),
        JaxParam(**kw, backend="pallas", approx_topk=True,
                 approx_recall=0.5)))
    got = detection_output(
        torch.from_numpy(loc), torch.from_numpy(conf),
        torch.from_numpy(priors), torch.from_numpy(variances),
        DetectionOutputParam(**kw, backend="pallas", approx_topk=True,
                             approx_recall=0.5)).numpy()
    _assert_rows_match(got, ref)


def test_approx_topk_auto_backend():
    p = DetectionOutputParam(approx_topk=True)
    assert resolve_backend(p, torch.device("cuda")) == "pallas"
    assert resolve_backend(p, torch.device("cpu")) == "xla"
    assert resolve_backend(dataclasses.replace(p, approx_topk=False),
                           torch.device("cuda")) == "fused"
    pred = SSDPredictor(ssd.SSDVgg(4, 300, device="cpu"),
                        PreProcessParam(), device="cpu",
                        post=DetectionOutputParam(n_classes=4,
                                                  approx_topk=True))
    assert pred.detect_normalized(np.zeros((1, 300, 300, 3),
                                           np.float32)).shape == (1, 200, 6)
