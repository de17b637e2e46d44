"""The port's telemetry spine (``obs/``, ``utils/profiling.py``,
``utils/report.py``, ``parallel/summary.py``) and its wiring into the
``Optimizer``, against the JAX package's, on the CPU.

Held EQUAL: the metric catalog; flight recordings fed the same events on
a ``VirtualClock`` (the JSONL bytes, the ring bound, the dumps); the
spans a tracer records and ``span_conservation`` over them; the
Prometheus text of registries filled alike (label escaping, families,
empty reservoirs, the collision errors); the ``SummaryBridge``'s writes;
``StepTimer``'s registry; the report's command and block; and the
``Optimizer``'s telemetry on a Dense(1) bridged into ``nn.Linear`` (span
names, trace ids, statuses and attributes, and the counters).
``TrainSummary`` event files written by the port and by the reference
(tensorboardX) decode to the same tags and steps, and to values equal
as float32.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import analytics_zoo_tpu.obs as jobs
import analytics_zoo_tpu_torch.obs as tobs
from analytics_zoo_tpu.core.criterion import MSECriterion as JaxMSE
from analytics_zoo_tpu.obs import names as jnames
from analytics_zoo_tpu.parallel import SGD as JaxSGD
from analytics_zoo_tpu.parallel import Optimizer as JaxOptimizer
from analytics_zoo_tpu.parallel import Trigger as JaxTrigger
from analytics_zoo_tpu.parallel import summary as jsummary
from analytics_zoo_tpu.resilience.anomaly import \
    AnomalyPolicy as JaxPolicy
from analytics_zoo_tpu.utils import profiling as jprofiling
from analytics_zoo_tpu.utils import report as jreport
from analytics_zoo_tpu.utils.clock import VirtualClock as JaxClock
from analytics_zoo_tpu_torch.core.criterion import MSECriterion
from analytics_zoo_tpu_torch.obs import names, probe, runmeta
from analytics_zoo_tpu_torch.parallel import optim, summary, train
from analytics_zoo_tpu_torch.parallel.elastic import DivergenceDetector
from analytics_zoo_tpu_torch.resilience.anomaly import AnomalyPolicy
from analytics_zoo_tpu_torch.resilience.errors import TrainingDiverged
from analytics_zoo_tpu_torch.utils import profiling, report
from analytics_zoo_tpu_torch.utils.clock import VirtualClock
from test_torch_anomaly import NanBatches, _models

SIDES = {"reference": (jobs, JaxClock), "port": (tobs, VirtualClock)}


def test_catalog_equals_reference():
    assert names.CATALOG == jnames.CATALOG
    probes = list(names.CATALOG) + [
        "serve/latency_s/tier=3", "serve/shed/cause=deadline",
        "slo/trips/slo=p99", "train/dispatch/step_s", "train/nope",
        "serve/latency", "probe/x"]
    assert [names.lookup(n) for n in probes] == \
        [jnames.lookup(n) for n in probes]


# -- recorder, spans ------------------------------------------------------------


def _feed(mod, clock_cls, capacity, tmp):
    clock = clock_cls()
    rec = mod.FlightRecorder(capacity=capacity, clock=clock,
                             dump_path=os.path.join(tmp, "bb.jsonl"))
    tracer = mod.Tracer(clock=clock, recorder=rec)
    for i in range(6):
        root = tracer.start("request", f"req-{i}", rid=i, deadline_s=0.5)
        clock.advance(0.001 * (i + 1))
        q = tracer.start("queue", f"req-{i}", parent=root)
        clock.advance(0.0005)
        q.end("assembled", edge="8")
        q.end("late")                      # the first writer wins
        rec.note("pool", replica=i % 2)
        rec.note("explicit", t=12.5, n=[1, 2])
        with pytest.raises(ValueError, match="parent belongs"):
            tracer.start("x", "req-other", parent=root)
        try:
            with tracer.span("dispatch", f"req-{i}", parent=root, tier=0):
                clock.advance(0.002)
                if i == 3:
                    raise RuntimeError("boom")
        except RuntimeError:
            pass
        root.end("done" if i != 3 else "failed", at=clock.now() + 0.25)
    open_span = tracer.start("request", "req-open")     # never ended
    rec.dump("test")
    with open(rec.dump_path) as f:
        dumped = f.read()
    return rec, tracer, dumped, open_span


@pytest.mark.parametrize("capacity", [4096, 9])
def test_recorder_and_tracer_equal_reference(capacity, tmp_path):
    out = {}
    for side, (mod, clock) in SIDES.items():
        rec, tracer, dumped, _ = _feed(mod, clock, capacity,
                                       str(tmp_path / side))
        out[side] = (rec.to_jsonl(), dumped, rec.dropped, len(rec),
                     [{k: v for k, v in d.items() if k != "path"}
                      for d in rec.dumps],
                     tracer.spans_started, tracer.spans_ended,
                     rec.events("span"))
    assert out["port"] == out["reference"]
    if capacity == 9:
        assert out["port"][2] > 0 and out["port"][3] == 9


def test_span_conservation_equal_reference(tmp_path):
    rec, *_ = _feed(tobs, VirtualClock, 4096, str(tmp_path))
    events = rec.events()
    # an orphan, an unended span and a second root
    events += [{"kind": "span", "name": "dispatch", "trace": "req-0",
                "span": 99, "parent": 77, "t0": 0.0, "t1": None},
               {"kind": "span", "name": "request", "trace": "req-1",
                "span": 98, "parent": None, "t0": 0.0, "t1": 1.0,
                "status": "done"}]
    for prefix in ("req-", "train-", ""):
        got = tobs.span_conservation(events, trace_prefix=prefix)
        assert got == jobs.span_conservation(events, trace_prefix=prefix)
    assert not tobs.span_conservation(events)["ok"]


def test_observability_adopts_the_runtime_clock_unless_pinned():
    for mod, clock_cls in SIDES.values():
        run = clock_cls(5.0)
        free = mod.Observability()
        free.adopt_clock(run)
        assert free.tracer.now() == 5.0 and free.recorder.now() == 5.0
        pinned = mod.Observability(clock=clock_cls(1.0))
        pinned.adopt_clock(run)
        assert pinned.tracer.now() == 1.0
    assert tobs.Observability(dump_path="/x").dump_path == "/x"


# -- exporters -------------------------------------------------------------------


def _fill_basic(reg):
    reg.counter("serve/completed").inc(7)
    reg.counter("serve/shed/cause=queue_full").inc(2)
    reg.counter("serve/shed/cause=deadline").inc()
    reg.gauge("serve/sessions_open").set(3)
    reg.gauge("data/read/records")                 # never set: NaN
    for v in (0.1, 0.3, 0.2):
        reg.histogram("serve/latency_s/tier=0").observe(v)
    reg.histogram("serve/latency_s/tier=1").observe(0.5)


PROM_CASES = {
    "families": _fill_basic,
    "escaping": lambda r: r.counter(
        'serve/shed/cause=say "no" to back\\slash').inc(2),
    "newline": lambda r: r.counter("serve/shed/cause=two\nlines").inc(),
    "empty_reservoir": lambda r: r.histogram("train/dispatch/step_s"),
    "digit_first": lambda r: r.gauge("9lives/x").set(1.5),
    "collision": lambda r: (r.counter("serve/lat-s").inc(),
                            r.counter("serve/lat_s").inc()),
    "total_suffix": lambda r: (r.counter("a/b").inc(),
                               r.gauge("a/b_total").set(1)),
    "sum_suffix": lambda r: (r.histogram("h/x").observe(1.0),
                             r.gauge("h/x_sum").set(2)),
}


@pytest.mark.parametrize("case", sorted(PROM_CASES))
def test_prometheus_text_equal_reference(case):
    out = []
    for mod in (tobs, jobs):
        reg = mod.MetricRegistry()
        PROM_CASES[case](reg)
        try:
            out.append(mod.render_prometheus(reg))
        except ValueError as e:
            out.append(("raised", str(e)))
    assert out[0] == out[1]
    if case in ("collision", "total_suffix", "sum_suffix"):
        assert out[0][0] == "raised" and "collision" in out[0][1]


class Writer:
    """A summary stand-in: records writes; ``floated`` counts host
    reads of lazy values."""

    def __init__(self):
        self.scalars, self.histograms = [], []

    def add_scalar(self, tag, value, it):
        self.scalars.append((tag, float(value), it))

    def add_histogram(self, tag, values, it):
        self.histograms.append((tag, it))

    def close(self):
        pass


class Lazy:
    def __init__(self, v):
        self.v, self.floated = v, 0

    def __float__(self):
        self.floated += 1
        return float(self.v)


def test_summary_bridge_and_gating_equal_reference():
    out = []
    for mod, summ, trig in ((tobs, summary, optim.Trigger),
                            (jobs, jsummary, JaxTrigger)):
        reg = mod.MetricRegistry()
        _fill_basic(reg)
        s = summ.TrainSummary("unused", "app")
        s._writer = Writer()
        s.set_summary_trigger("serve/completed", trig.several_iteration(2))
        s.set_summary_trigger("E", trig.every_epoch())
        bridge = mod.SummaryBridge(s)
        for it in (1, 2, 3, 4):
            bridge.export(reg, it)
        lazy = Lazy(0.25)
        s.set_summary_trigger("Loss", trig.several_iteration(10))
        s.add_scalar("Loss", lazy, 7)
        s.add_scalar("Loss", lazy, 10)
        s.add_scalar("E", 1.0, 3)
        s.add_histogram("W", [1.0, 2.0], 2)
        out.append((s._writer.scalars, s._writer.histograms, lazy.floated))
    assert out[0] == out[1]
    assert out[0][2] == 1          # a gated-off value is never read


def test_train_summary_event_files_equal_reference(tmp_path):
    """The port's own event files and tensorboardX's decode alike: the
    same tags and steps a file, values equal as float32, histograms of
    the same count, sum and range."""
    rng = np.random.RandomState(0)
    hist = rng.randn(200)
    for summ, side in ((summary, "port"), (jsummary, "reference")):
        for cls in (summ.TrainSummary, summ.ValidationSummary):
            s = cls(str(tmp_path / side), "app")
            s.set_summary_trigger("Parameters",
                                  (optim.Trigger if side == "port"
                                   else JaxTrigger).several_iteration(2))
            for it in range(1, 6):
                s.add_scalar("Loss", 1.0 / it, it)
                s.add_scalar("LearningRate", 0.05, it)
                s.add_scalar("Parameters", float(it), it)
            s.add_histogram("W", hist, 5)
            s.close()
    for kind in ("train", "validation"):
        got, want = (summary.read_events(str(tmp_path / side / "app" / kind))
                     for side in ("port", "reference"))

        def scalars(evs):
            return [(e["step"], t, np.float32(v)) for e in evs
                    for t, v in sorted(e["scalars"].items())]

        def histos(evs):
            return [(e["step"], t, h["num"], np.float32(h["sum"]),
                     np.float32(h["min"]), np.float32(h["max"]))
                    for e in evs for t, h in e["histograms"].items()]

        assert scalars(got) == scalars(want) and len(scalars(got)) == 12
        assert histos(got) == histos(want)
        assert got[0]["file_version"] == "brain.Event:2"
    assert summary.ValidationSummary("b", "app").log_dir == \
        jsummary.ValidationSummary("b", "app").log_dir


def test_event_file_crc_is_checked(tmp_path):
    w = summary.EventFileWriter(str(tmp_path))
    w.add_scalar("Loss", 0.5, 1)
    w.close()
    assert summary.crc32c(b"123456789") == 0xE3069283
    data = bytearray(open(w.path, "rb").read())
    data[-6] ^= 0xFF
    with open(w.path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="bad CRC"):
        summary.read_events(w.path)


# -- profiling, probe, report, run metadata ---------------------------------


def test_step_timer_equal_reference():
    out = []
    for mod, prof in ((tobs, profiling), (jobs, jprofiling)):
        reg = mod.MetricRegistry()
        t = prof.StepTimer("train/dispatch", registry=reg)
        for n in (8, 8, 4):
            with t.step(n):
                pass
        snap = reg.snapshot()
        out.append((snap["counters"], snap["histograms"][
            "train/dispatch/step_s"]["count"], sorted(t.summary()),
            t.summary()["records"]))
        with pytest.raises(RuntimeError, match="without"):
            t.__exit__(None, None, None)
    assert out[0] == out[1]


def test_step_probe_splits_a_step():
    reg = tobs.MetricRegistry()
    p = tobs.StepProbe(registry=reg)
    state = {"w": torch.ones(3)}
    for _ in range(3):
        with p.input_wait():
            batch = torch.ones(3)
        state = p.step(lambda s, b: {"w": s["w"] + b}, state, batch)
    s = p.summary()
    ref = jobs.StepProbe().summary()
    assert sorted(s) == sorted(ref) and s["steps"] == 3
    assert 0.0 <= s["host_bound_fraction"] <= 1.0
    assert set(reg.snapshot()["histograms"]) == {
        "probe/input_wait_s", "probe/dispatch_s", "probe/device_s"}
    assert all(names.lookup(n) for n in reg.metrics())
    probe.fence(state)            # CPU tensors: nothing to wait for
    assert torch.equal(state["w"], torch.full((3,), 4.0))


def test_trace_memory_and_run_metadata(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.named_scope("obs_test_scope"):
            torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        assert "obs_test_scope" in f.read()
    mem = profiling.memory_summary()
    assert set(mem) == {"cpu"} and mem["cpu"]["bytes_in_use"] > 0
    meta = tobs.run_metadata("t", seed=3, extra={"smoke": True})
    assert set(runmeta.REQUIRED_KEYS) <= set(meta)
    assert (meta["backend"], meta["torch_version"], meta["smoke"]) == (
        "cpu", torch.__version__, True)
    assert "jax_version" not in meta


def test_report_equal_reference(monkeypatch, tmp_path):
    monkeypatch.setattr(sys, "argv", ["x.py", "--epochs", "3", "--out",
                                      "r.md", "--name", "a b", "--out=y"])
    assert report.reconstruct_command("ex.py") == \
        jreport.reconstruct_command("ex.py")
    for mod, name in ((report, "port.md"), (jreport, "ref.md")):
        mod.append_report(str(tmp_path / name), "T", "ex.py",
                          {"auprc": 0.5})
    assert (tmp_path / "port.md").read_text() == \
        (tmp_path / "ref.md").read_text()


# -- the Optimizer's telemetry --------------------------------------------------


def _fit(side, obs, tmp, bad=(), epochs=2, anomaly=None):
    ref, lin = _models()
    data = NanBatches(bad, n=4)
    ckpt = os.path.join(tmp, side)
    if side == "reference":
        opt = (JaxOptimizer(ref, data, JaxMSE())
               .set_optim_method(JaxSGD(0.05)).set_observability(obs)
               .set_checkpoint(ckpt, JaxTrigger.every_epoch())
               .set_end_when(JaxTrigger.max_epoch(epochs)))
        if anomaly:
            opt.set_anomaly_policy(JaxPolicy(**anomaly))
    else:
        opt = (train.Optimizer(lin, data, MSECriterion())
               .set_optim_method(optim.SGD(0.05)).set_observability(obs)
               .set_checkpoint(ckpt, optim.Trigger.every_epoch())
               .set_end_when(optim.Trigger.max_epoch(epochs)))
        if anomaly:
            opt.set_anomaly_policy(AnomalyPolicy(**anomaly))
    opt.optimize()
    return opt


def _shape(events):
    """A recording without its times: what two clocks cannot share."""
    return [{k: v for k, v in e.items() if k not in ("t0", "t1", "dur", "t")}
            for e in events]


@pytest.mark.parametrize("anomaly", [None, {"rollback_after": 100,
                                            "promote_initial": False}])
def test_optimizer_telemetry_equal_reference(anomaly, tmp_path):
    out = {}
    for side in ("reference", "port"):
        obs = SIDES[side][0].Observability(capacity=512)
        _fit(side, obs, str(tmp_path / side), bad=(1,) if anomaly else (),
             anomaly=dict(anomaly, forensics_dir=str(tmp_path / side))
             if anomaly else None)
        snap = obs.registry.snapshot()
        out[side] = (_shape(obs.recorder.events()), snap["counters"],
                     {k: v["count"] for k, v in snap["histograms"].items()})
        if side == "port":
            assert all(names.lookup(n) for n in obs.registry.metrics())
            steps = [e for e in obs.recorder.events("span")
                     if e["name"] == "train_step"]
            assert steps[0]["trace"] == "train-e0-b0"
            assert steps[-1]["trace"] == "train-e1-b3"
            assert tobs.span_conservation(obs.recorder.events(),
                                          trace_prefix="train-")["ok"]
    assert out["port"] == out["reference"]
    counters = out["port"][1]
    assert counters["train/dispatch/steps"] == 8
    assert counters["train/dispatch/records"] == 64
    assert counters.get("train/anomaly/bad_steps", 0) == (1 if anomaly
                                                          else 0)


def test_step_span_closed_when_the_step_raises():
    def bad_criterion(output, batch):
        raise ValueError("boom in criterion")

    _, lin = _models()
    obs = tobs.Observability(capacity=64)
    opt = (train.Optimizer(lin, list(NanBatches(n=1)), bad_criterion)
           .set_observability(obs).set_end_when(optim.Trigger.max_epoch(1)))
    with pytest.raises(ValueError, match="boom"):
        opt.optimize()
    (step,) = [s for s in obs.recorder.events("span")
               if s["name"] == "train_step"]
    assert step["status"] == "error" and "ValueError" in step["attrs"]["error"]


def test_divergence_and_preemption_dump_the_black_box(tmp_path):
    """Both terminal conditions of a run write the ring to the box."""
    box = str(tmp_path / "flight.jsonl")
    obs = tobs.Observability(capacity=256, dump_path=box)
    _, lin = _models()
    data = list(NanBatches(bad=range(100), n=4))
    opt = (train.Optimizer(lin, data, MSECriterion())
           .set_observability(obs)
           .set_failure_detector(DivergenceDetector(check_every=1,
                                                    max_bad_checks=2))
           .set_end_when(optim.Trigger.max_epoch(3)))
    with pytest.raises(TrainingDiverged):
        opt.optimize()
    assert [d["reason"] for d in obs.recorder.dumps] == ["training_diverged"]
    with open(box) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds[-1] == "training_diverged" and "span" in kinds
    from analytics_zoo_tpu_torch.resilience.errors import Preempted
    from analytics_zoo_tpu_torch.resilience.preempt import PreemptionHandler

    obs = tobs.Observability(capacity=256, dump_path=box)
    handler = PreemptionHandler()

    class Signalled:
        def __iter__(self):
            for i, b in enumerate(NanBatches(n=4)):
                if i == 2:
                    handler.request()
                yield b

    _, lin = _models()
    opt = (train.Optimizer(lin, Signalled(), MSECriterion())
           .set_observability(obs).set_preemption_handler(handler)
           .set_checkpoint(str(tmp_path / "ck"), optim.Trigger.every_epoch())
           .set_end_when(optim.Trigger.max_epoch(1)))
    with pytest.raises(Preempted):
        opt.optimize()
    (ev,) = obs.recorder.events("preempted")
    assert ev["checkpoint_saved"] is True and ev["iteration"] == 3
    assert [d["reason"] for d in obs.recorder.dumps] == ["preempted"]
    assert [s["name"] for s in obs.recorder.events("span")].count(
        "checkpoint_save") == 1
