"""The port's chaos fault injection (``resilience/chaos.py``) against the JAX
package's, on the CPU.

- ``FaultSpec`` validation: the same specs refused by both, with the
  same messages, all 14 kinds accepted;
- ``mutate_batch``: the poisoned bytes EQUAL for every numerical kind and
  several seeds, the caller's arrays untouched;
- a schedule over a wrapped dataset (raising kinds caught, numerical
  windows, ``bit_flip``, ``corrupt_latest`` re-armed while nothing is on
  disk, the serving windows by index): the event logs EQUAL;
- ``mid_save_kill`` and ``corrupt_latest`` against the port's checkpoint
  (``data/state.pt`` and its manifest): the save dies before its
  publish, the newest snapshot is truncated and a restore falls back;
- ``run_resilient`` over one ``ChaosMonkey``-wrapped dataset through a
  crash, SIGTERM, a stall and the transient device error: each fault
  fires once, and the parameters are bit-equal to an uninterrupted run
  (one intra-op thread).
"""

import os
import types

import numpy as np
import pytest
import torch

import analytics_zoo_tpu.resilience.chaos as jchaos
import analytics_zoo_tpu.resilience.errors as jerrors
import analytics_zoo_tpu_torch.resilience.chaos as tchaos
import analytics_zoo_tpu_torch.resilience.errors as terrors
from analytics_zoo_tpu_torch.core.criterion import MSECriterion
from analytics_zoo_tpu_torch.parallel import (SGD, Optimizer, Trigger,
                                              run_resilient)
from analytics_zoo_tpu_torch.parallel import checkpoint as cp
from test_torch_resume import _dataset, _model, one_thread
from test_torch_serving import _jsonable

PKGS = {"reference": types.SimpleNamespace(c=jchaos, errors=jerrors),
        "port": types.SimpleNamespace(c=tchaos, errors=terrors)}


@pytest.fixture(autouse=True)
def _clear_hooks():
    yield
    cp.set_fault_hook(None)
    from analytics_zoo_tpu_torch.resilience import health
    health.clear_bit_flip()


# -- FaultSpec ----------------------------------------------------------------

@pytest.mark.parametrize("args,kw", [
    (("nope", 1), {}),
    (("crash", 1), {"batches": 0}),
    (("crash", 1), {"batches": 2}),
    (("crash", 3), {"detail": {"replica": 1}}),
    (("slow_forward", 3), {"detail": {"replica": 1, "dealy_s": 5.0}}),
    (("bit_flip", 1), {"detail": {"replica": 2, "byte": 0}}),
    (("slow_device", 1), {"detail": {"slow": 2.0}}),
], ids=["unknown_kind", "zero_batches", "window_on_crash", "detail_free",
        "typo_delay", "typo_bit_flip", "typo_slow_device"])
def test_fault_spec_refusals_match_reference(args, kw):
    msgs = []
    for pkg in PKGS.values():
        with pytest.raises(ValueError) as ei:
            pkg.c.FaultSpec(*args, **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_every_kind_accepted():
    assert tchaos.KINDS == jchaos.KINDS and len(tchaos.KINDS) == 14
    details = {"slow_forward": {"replica": 0, "delay_s": 2.0},
               "bit_flip": {"replica": 2, "element": 0, "bit": 3},
               "slow_device": {"replica": 1, "slow_x": 6.0},
               "burst_load": {"rate_x": 4.0}, "replica_crash": {"replica": 0}}
    for kind in tchaos.KINDS:
        spec = tchaos.FaultSpec(kind, 1, detail=details.get(kind, {}))
        assert spec.kind == kind


# -- mutate_batch -------------------------------------------------------------

@pytest.mark.parametrize("kind", jchaos.NUMERICAL_KINDS)
def test_mutate_batch_bytes_equal(kind):
    rng = np.random.RandomState(0)
    for seed in (0, 1, 7, 2 ** 40 + 3):
        clean = {"input": (rng.randn(4, 3, 5).astype(np.float32),
                           np.arange(4, dtype=np.int32)),
                 "target": rng.randn(4, 2).astype(np.float32)}
        keep = {"input": clean["input"][0].copy(),
                "target": clean["target"].copy()}
        ref = jchaos.mutate_batch(kind, dict(clean), seed)
        got = tchaos.mutate_batch(kind, dict(clean), seed)
        for key in ("input", "target"):
            a = ref[key][0] if key == "input" else ref[key]
            b = got[key][0] if key == "input" else got[key]
            assert a.tobytes() == b.tobytes(), (kind, seed, key)
        assert type(got["input"]) is tuple
        np.testing.assert_array_equal(clean["input"][0], keep["input"])
        np.testing.assert_array_equal(clean["target"], keep["target"])
    with pytest.raises(TypeError):
        tchaos.mutate_batch(kind, {"input": np.arange(3),
                                   "target": np.arange(3)}, 0)


# -- a schedule ---------------------------------------------------------------

def scenario_schedule(pkg, base):
    C = pkg.c
    ckpt = os.path.join(base, "ckpt")
    monkey = C.ChaosMonkey([
        C.FaultSpec("crash", 1),
        C.FaultSpec("nan_grads", 2, batches=2),
        C.FaultSpec("corrupt_latest", 3),
        C.FaultSpec("inf_loss", 5),
        C.FaultSpec("corrupt_batch", 6),
        C.FaultSpec("bit_flip", 7, detail={"replica": 1, "bit": 31}),
        C.FaultSpec("stall", 8),
        C.FaultSpec("slow_device", 2, batches=3,
                    detail={"replica": 1, "slow_x": 3.0}),
        C.FaultSpec("replica_crash", 4, detail={"replica": 0}),
    ], checkpoint_path=ckpt, stall_s=0.01)
    rng = np.random.RandomState(5)
    data = [{"input": rng.randn(2, 3).astype(np.float32),
             "target": rng.randn(2, 1).astype(np.float32)}
            for _ in range(5)]
    seen, raised = [], []
    with monkey:
        for _ in range(3):
            try:
                for b in monkey.dataset(data):
                    seen.append(b["input"].tobytes())
            except Exception as e:          # noqa: BLE001 - recorded
                raised.append(type(e).__name__)
        flip = pkg.h.active_bit_flip()
    serving = [[monkey.serving_active(k, i) is not None for i in range(8)]
               for k in ("slow_device", "replica_crash")]
    return {"events": monkey.events, "raised": raised,
            "seen": len(seen), "bytes": seen, "flip": flip,
            "serving": serving, "fired": monkey.fired_kinds(),
            "all": monkey.all_fired(), "consumed": monkey.consumed}


def test_schedule_event_log_equal(tmp_path):
    import analytics_zoo_tpu.resilience.health as jhealth
    import analytics_zoo_tpu_torch.resilience.health as thealth

    PKGS["reference"].h, PKGS["port"].h = jhealth, thealth
    ref = _jsonable(scenario_schedule(PKGS["reference"],
                                      str(tmp_path / "r")))
    got = _jsonable(scenario_schedule(PKGS["port"], str(tmp_path / "p")))
    assert got == ref
    assert got["raised"] == ["InjectedFault"]
    assert got["flip"] == [1, 0, 31]
    # nothing on disk: corrupt_latest re-arms a batch at a time
    assert "corrupt_latest" not in got["fired"]


# -- against the port's checkpoint --------------------------------------------

def test_mid_save_kill_and_corrupt_latest_on_the_port(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    state = {"w": torch.arange(1000, dtype=torch.float32)}
    cp.save(ckpt, state, step=1)
    cp.save(ckpt, {"w": state["w"] * 2}, step=2)
    monkey = tchaos.ChaosMonkey(
        [tchaos.FaultSpec("mid_save_kill", 0),
         tchaos.FaultSpec("corrupt_latest", 1)], checkpoint_path=ckpt)
    it = iter(monkey.dataset([{"x": 0}, {"x": 1}]))
    next(it)
    other = str(tmp_path / "other")
    cp.save(other, state)               # out of scope: not killed
    with pytest.raises(terrors.InjectedFault, match="mid-save"):
        cp.save(ckpt, {"w": state["w"] * 3}, step=3)
    assert not os.path.isdir(os.path.join(ckpt, "step_3"))
    next(it)                            # truncates step_2's payload
    assert monkey.events[-1] == {"kind": "corrupt_latest", "at_batch": 1,
                                 "snapshot": "step_2",
                                 "file": "data/state.pt"}
    assert [e["kind"] for e in monkey.events] == ["mid_save_kill",
                                                  "corrupt_latest"]
    assert monkey.events[0]["fired_in_save"] == "step_3"
    back = cp.load(ckpt, device="cpu")
    assert torch.equal(back["w"], state["w"])       # fell back to step_1
    monkey.disarm()
    assert cp.set_fault_hook(None) is None


def test_transient_error_is_the_retryable_device_error():
    e = tchaos.transient_xla_error("x")
    assert isinstance(e, terrors._device_errors())
    assert terrors.is_retryable(e)


# -- run_resilient through the chaos schedule ---------------------------------

def _build(data, ckpt, **kw):
    return (Optimizer(_model(), data, MSECriterion())
            .set_optim_method(SGD(0.05))
            .set_checkpoint(ckpt, Trigger.every_epoch(), overwrite=False,
                            keep_last=3)
            .set_end_when(Trigger.max_epoch(4)))


def test_run_resilient_through_the_matrix(tmp_path):
    data = _dataset(n_batches=4)
    with one_thread():
        straight = _build(data, str(tmp_path / "s")).optimize()
        ckpt = str(tmp_path / "ckpt")
        monkey = tchaos.ChaosMonkey([
            tchaos.FaultSpec("crash", 2),
            tchaos.FaultSpec("sigterm", 7),
            tchaos.FaultSpec("stall", 11),
            tchaos.FaultSpec("xla_transient", 14)],
            checkpoint_path=ckpt, stall_s=2.0)
        wrapped = monkey.dataset(data)
        errors = []

        def build():
            return (_build(wrapped, ckpt).set_preemption_handler()
                    .set_stall_watchdog(0.8))

        with monkey:
            model = run_resilient(build, ckpt, max_restarts=5,
                                  on_restart=lambda a, e: errors.append(
                                      type(e).__name__))
    assert errors == ["InjectedFault", "Preempted", "StallError",
                      "AcceleratorError"]
    assert monkey.all_fired()
    assert [e["kind"] for e in monkey.events] == [
        "crash", "sigterm", "stall", "xla_transient"]
    for a, b in zip(model.parameters(), straight.parameters()):
        assert torch.equal(a.detach(), b.detach())
