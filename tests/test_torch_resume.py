"""Checkpointed training, resume and restart supervision on the port
(``parallel/train.py``'s ``Optimizer``, ``parallel/elastic.py``,
``resilience/preempt.py``, the push-mode ``resilience/watchdog.py``), on
the CPU.

The ``Optimizer`` cases of ``tests/test_elastic.py`` on a linear model:
crash and resume, the loop position, the give-up budget, a
non-retryable failure, the divergence detector, the mid-epoch
fast-forward, the order of ``set_resume``/``set_checkpoint``, the optim
method's state, no snapshot at a non-finite loss, a kill mid-save, a
corrupt newest snapshot at resume, SIGTERM with a graceful checkpoint,
the stall watchdog alone and with the preemption handler.  The
reference's chaos faults are written out here as small dataset wrappers
(the port's ``ChaosMonkey`` runs them in ``tests/test_torch_chaos.py``).

Then the two packages side by side: a tiny DS2 (hidden 32, 2 layers,
the "blocked" and "pallas" engines, the latter on the plain K3/K4) and
an SSD300 (4 classes, batch 1) train under ``run_resilient`` with a
``FaultInjector``, from bridged weights and the same batches.  Every
loss of every attempt within ``DS2_LOSS_RTOL`` / ``SSD_LOSS_RTOL`` of the
reference's (DS2: 1e-5, as ``tests/test_torch_ds2_train.py`` holds
``train_ds2``, measured 2.2e-6; SSD: 1e-3, as
``tests/test_torch_ssd_train.py`` holds the steps after the first, where
MultiBoxLoss's hard-negative mining turns a last-bit difference into
another negative set, measured 7.1e-4), and the port's resumed
parameters, slots and batch statistics equal to its own straight run
BIT FOR BIT on one intra-op thread (a first parallel op on a loaded CPU
can round differently in its second thread's share, ROADMAP.md F3 and
F4).  A reference checkpoint carried across with
``utils.convert.train_state_from_jax`` resumes on the port and its losses
follow the reference's uninterrupted run (within 1e-5, measured 1.3e-7).
"""

import contextlib
import functools
import os
import signal
import time

import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu_torch.core.criterion import MSECriterion
from analytics_zoo_tpu_torch.parallel import (RETRYABLE_ERRORS, SGD, Adam,
                                              DivergenceDetector,
                                              FaultInjector, Optimizer,
                                              Preempted, StallError,
                                              TrainingDiverged, Trigger,
                                              run_resilient)
from analytics_zoo_tpu_torch.parallel import checkpoint as cp
from analytics_zoo_tpu_torch.parallel.optim import Plateau
from analytics_zoo_tpu_torch.resilience.errors import (CheckpointCorrupt,
                                                       InjectedFault)

DS2_LOSS_RTOL = 1e-5
SSD_LOSS_RTOL = 1e-3


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear_fault_hook():
    yield
    cp.set_fault_hook(None)


def _dataset(n_batches=8, batch=8, dim=4, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim, 1).astype(np.float32)
    batches = []
    for _ in range(n_batches):
        x = rng.randn(batch, dim).astype(np.float32)
        batches.append({"input": x, "target": x @ w})
    return batches


def _model(dim=4):
    m = nn.Linear(dim, 1)
    rng = np.random.RandomState(1)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.randn(1, dim).astype(np.float32)))
        m.bias.zero_()
    return m


def _loss(model, batch):
    with torch.no_grad():
        out = model(torch.from_numpy(batch["input"]))
        return float(((out - torch.from_numpy(batch["target"])) ** 2).mean())


class Poison(MSECriterion):
    def __call__(self, inputs, target, mask=None):
        return super().__call__(inputs, target, mask) + torch.log(
            -torch.ones(()))


class Hooked:
    """Runs ``hooks[i]()`` just before yielding global batch ``i`` (counted
    across epochs and attempts), once each: the chaos faults."""

    def __init__(self, data, hooks):
        self.data, self.hooks, self.i = data, dict(hooks), 0

    def __iter__(self):
        for b in self.data:
            hook = self.hooks.pop(self.i, None)
            self.i += 1
            if hook is not None:
                hook()
            yield b


def _ckpt_step(path):
    return cp.load(path, device="cpu")["step"]


# ---------------------------------------------------------------------------
# test_elastic.py's Optimizer cases on the port
# ---------------------------------------------------------------------------


class TestDivergenceDetector:
    def test_finite_resets_streak(self):
        d = DivergenceDetector(check_every=1, max_bad_checks=2)
        d.check(1.0, 1)
        d.check(float("nan"), 2)
        d.check(1.0, 3)
        d.check(float("nan"), 4)
        with pytest.raises(TrainingDiverged):
            d.check(float("inf"), 5)

    def test_periodic(self):
        d = DivergenceDetector(check_every=10)
        assert d.should_check(10) and d.should_check(20)
        assert not d.should_check(5)


class TestResilientTraining:
    def test_crash_resumes_from_checkpoint(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        data = _dataset(n_batches=4)
        attempts = []

        def build():
            ds = FaultInjector(data, fail_at=6) if not attempts else data
            attempts.append(1)
            return (Optimizer(_model(), ds, MSECriterion())
                    .set_optim_method(SGD(0.05))
                    .set_checkpoint(ckpt, Trigger.every_epoch())
                    .set_end_when(Trigger.max_epoch(4)))

        model = run_resilient(build, ckpt, max_restarts=2)
        assert len(attempts) == 2
        assert _ckpt_step(ckpt) == 16      # 4 epochs of 4, none repeated
        assert _loss(model, data[0]) < _loss(_model(), data[0])

    def test_resume_restores_loop_position(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        data = _dataset(n_batches=3)
        (Optimizer(_model(), data, MSECriterion())
         .set_optim_method(SGD(0.05))
         .set_checkpoint(ckpt, Trigger.every_epoch())
         .set_end_when(Trigger.max_epoch(2))
         .optimize())
        opt2 = (Optimizer(_model(), data, MSECriterion())
                .set_optim_method(SGD(0.05))
                .set_checkpoint(ckpt, Trigger.every_epoch())
                .set_resume(ckpt)
                .set_end_when(Trigger.max_epoch(2)))
        opt2.optimize()
        assert opt2._last_state.step == 6 and opt2.history == []

    def test_gives_up_after_budget(self, tmp_path):
        data = _dataset(n_batches=2)

        def build():
            return (Optimizer(_model(), FaultInjector(data, fail_at=0),
                              MSECriterion())
                    .set_optim_method(SGD(0.05))
                    .set_end_when(Trigger.max_epoch(1)))

        with pytest.raises(RuntimeError, match="injected fault"):
            run_resilient(build, str(tmp_path / "ckpt"), max_restarts=2)

    def test_non_retryable_propagates_immediately(self, tmp_path):
        calls = []

        def build():
            calls.append(1)
            raise ValueError("config bug")

        with pytest.raises(ValueError):
            run_resilient(build, str(tmp_path / "c"), max_restarts=5)
        assert len(calls) == 1

    def test_divergence_detector_in_loop(self, tmp_path):
        opt = (Optimizer(_model(), _dataset(n_batches=4), Poison())
               .set_optim_method(SGD(0.05))
               .set_failure_detector(
                   DivergenceDetector(check_every=1, max_bad_checks=2))
               .set_end_when(Trigger.max_epoch(2)))
        with pytest.raises(TrainingDiverged):
            opt.optimize()
        assert len(opt.history) == 2
        # fatal: the supervisor does not restart into it
        calls = []

        def build():
            calls.append(1)
            return (Optimizer(_model(), _dataset(n_batches=4), Poison())
                    .set_optim_method(SGD(0.05))
                    .set_failure_detector(DivergenceDetector(1, 2))
                    .set_end_when(Trigger.max_epoch(2)))

        with pytest.raises(TrainingDiverged):
            run_resilient(build, str(tmp_path / "c"), max_restarts=3)
        assert len(calls) == 1


class TestReviewRegressions:
    def test_midepoch_resume_fast_forwards(self, tmp_path):
        """A crash after a mid-epoch snapshot: the resume skips the
        interrupted epoch's trained batches, so the run takes exactly
        epochs x batches steps, and its parameters equal a straight
        run's bit for bit."""
        ckpt = str(tmp_path / "ckpt")
        data = _dataset(n_batches=4)
        attempts = []

        def build():
            ds = FaultInjector(data, fail_at=5) if not attempts else data
            attempts.append(1)
            return (Optimizer(_model(), ds, MSECriterion())
                    .set_optim_method(Adam(0.05))
                    .set_checkpoint(ckpt, Trigger.several_iteration(3))
                    .set_end_when(Trigger.max_epoch(2)))

        with one_thread():
            model = run_resilient(build, ckpt, max_restarts=2)
            straight = _model()
            (Optimizer(straight, data, MSECriterion())
             .set_optim_method(Adam(0.05))
             .set_end_when(Trigger.max_epoch(2)).optimize())
        assert len(attempts) == 2
        man = cp.read_manifest(os.path.join(ckpt, "latest"))
        assert man["meta"]["iteration"] == 6
        assert man["meta"]["state_step"] == 6
        for a, b in zip(model.parameters(), straight.parameters()):
            assert torch.equal(a, b)

    def test_resume_before_checkpoint_order_independent(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        data = _dataset(n_batches=2)
        (Optimizer(_model(), data, MSECriterion())
         .set_optim_method(SGD(0.05))
         .set_checkpoint(ckpt, Trigger.every_epoch())
         .set_end_when(Trigger.max_epoch(1))
         .optimize())
        opt = (Optimizer(_model(), data, MSECriterion())
               .set_optim_method(SGD(0.05))
               .set_resume()
               .set_checkpoint(ckpt, Trigger.every_epoch())
               .set_end_when(Trigger.max_epoch(1)))
        opt.optimize()
        assert opt._last_state.step == 2

    def test_optim_state_roundtrip(self, tmp_path):
        m = SGD(0.1, plateau=Plateau(patience=0))
        m.on_validation({"score": 1.0})
        m.on_validation({"score": 0.5})
        assert m.lr_scale == 0.5
        m2 = SGD(0.1, plateau=Plateau(patience=0))
        m2.load_state_dict(m.state_dict())
        assert m2.lr_scale == 0.5 and m2.plateau.best == 1.0
        # and through a snapshot's manifest into a resumed Optimizer
        ckpt = str(tmp_path / "ckpt")
        data = _dataset(n_batches=2)
        opt = (Optimizer(_model(), data, MSECriterion())
               .set_optim_method(m)
               .set_checkpoint(ckpt, Trigger.every_epoch())
               .set_end_when(Trigger.max_epoch(1)))
        opt.optimize()
        m3 = SGD(0.1, plateau=Plateau(patience=0))
        (Optimizer(_model(), data, MSECriterion()).set_optim_method(m3)
         .set_resume(ckpt).set_end_when(Trigger.max_epoch(1)).optimize())
        assert m3.lr_scale == 0.5 and m3.plateau.best == 1.0

    def test_no_checkpoint_when_loss_nonfinite(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        opt = (Optimizer(_model(), _dataset(n_batches=2), Poison())
               .set_optim_method(SGD(0.05))
               .set_checkpoint(ckpt, Trigger.every_epoch())
               .set_end_when(Trigger.max_epoch(1)))
        opt.optimize()
        assert not os.path.exists(os.path.join(ckpt, "latest"))


class TestChaosMatrix:
    def _build(self, data, ckpt):
        return (Optimizer(_model(), data, MSECriterion())
                .set_optim_method(SGD(0.05))
                .set_checkpoint(ckpt, Trigger.several_iteration(2),
                                overwrite=False, keep_last=3)
                .set_end_when(Trigger.max_epoch(3)))

    def test_mid_save_kill_survived(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        kills = []

        def arm():
            def bomb(phase, path):
                if phase == "pre_publish":
                    cp.set_fault_hook(None)
                    kills.append(os.path.basename(path))
                    raise InjectedFault("killed mid-save")
            cp.set_fault_hook(bomb)

        data = Hooked(_dataset(n_batches=4), {3: arm})
        attempts = []

        def build():
            attempts.append(1)
            return self._build(data, ckpt)

        run_resilient(build, ckpt, max_restarts=3)
        assert len(attempts) == 2 and kills == ["step_4"]
        assert _ckpt_step(ckpt) == 12
        assert not [d for d in os.listdir(ckpt) if d.startswith(".tmp_")]

    def test_corrupt_latest_falls_back_on_resume(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        corrupted = []

        def corrupt():
            snap, man = cp.newest_intact(ckpt)
            rel = max(man["files"], key=lambda r: man["files"][r]["size"])
            with open(os.path.join(snap, rel), "r+b") as f:
                f.truncate(3)
            corrupted.append(int(os.path.basename(snap).split("_")[1]))

        def crash():
            raise InjectedFault("crash")

        data = Hooked(_dataset(n_batches=4), {6: corrupt, 7: crash})
        resumed_from = []

        def build():
            found = cp.newest_intact(ckpt)
            resumed_from.append(int(found[1]["meta"]["iteration"])
                                if found else None)
            return self._build(data, ckpt)

        run_resilient(build, ckpt, max_restarts=3)
        assert len(corrupted) == 1
        assert len(resumed_from) == 2 and resumed_from[1] is not None
        assert 0 < resumed_from[1] < corrupted[0]
        assert _ckpt_step(ckpt) == 12

    def test_all_snapshots_corrupt_is_fatal(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        self._build(_dataset(n_batches=2), ckpt).set_end_when(
            Trigger.max_epoch(1)).optimize()
        for d in os.listdir(ckpt):
            with open(os.path.join(ckpt, d, "data", "state.pt"), "r+b") as f:
                f.truncate(3)
        with pytest.raises(CheckpointCorrupt, match="no intact snapshot"):
            self._build(_dataset(n_batches=2), ckpt).set_resume().optimize()

    def test_sigterm_graceful_checkpoint(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        data = Hooked(_dataset(n_batches=4),
                      {2: lambda: os.kill(os.getpid(), signal.SIGTERM)})
        errors = []
        before = signal.getsignal(signal.SIGTERM)

        def build():
            return self._build(data, ckpt).set_preemption_handler()

        run_resilient(build, ckpt, max_restarts=3,
                      on_restart=lambda a, e: errors.append(e))
        assert len(errors) == 1 and isinstance(errors[0], Preempted)
        assert "final checkpoint written" in str(errors[0])
        # the forced snapshot landed at the boundary (iteration 3) and no
        # step was repeated: 3 epochs of 4
        assert os.path.isdir(os.path.join(ckpt, "step_3")) or \
            _ckpt_step(ckpt) == 12
        assert _ckpt_step(ckpt) == 12
        assert signal.getsignal(signal.SIGTERM) is before

    def test_stall_watchdog_raises_instead_of_hanging(self):
        data = _dataset(n_batches=4)

        class SleepyData:
            def __iter__(self):
                for i, b in enumerate(data):
                    if i == 2:
                        time.sleep(2.2)
                    yield b

        opt = (Optimizer(_model(), SleepyData(), MSECriterion())
               .set_optim_method(SGD(0.05))
               .set_stall_watchdog(0.8)
               .set_end_when(Trigger.max_epoch(2)))
        t0 = time.time()
        with pytest.raises(StallError):
            opt.optimize()
        assert time.time() - t0 < 30
        assert isinstance(StallError("x"), RETRYABLE_ERRORS)

    def test_stall_watchdog_with_preemption_handler(self):
        data = _dataset(n_batches=4)

        class SleepyData:
            def __iter__(self):
                for i, b in enumerate(data):
                    if i == 2:
                        time.sleep(2.2)
                    yield b

        opt = (Optimizer(_model(), SleepyData(), MSECriterion())
               .set_optim_method(SGD(0.05))
               .set_preemption_handler()
               .set_stall_watchdog(0.8)
               .set_end_when(Trigger.max_epoch(2)))
        with pytest.raises(StallError):
            opt.optimize()

    def test_cuda_error_is_retryable(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        data = _dataset(n_batches=4)
        attempts = []

        def build():
            ds = (FaultInjector(data, fail_at=5,
                                exc=torch.cuda.OutOfMemoryError("oom"))
                  if not attempts else data)
            attempts.append(1)
            return self._build(ds, ckpt)

        run_resilient(build, ckpt, max_restarts=2)
        assert len(attempts) == 2

    def test_bare_runtime_error_propagates_immediately(self, tmp_path):
        data = _dataset(n_batches=2)
        attempts = []

        def build():
            attempts.append(1)
            return (Optimizer(_model(),
                              FaultInjector(data, fail_at=0,
                                            exc=RuntimeError("real bug")),
                              MSECriterion())
                    .set_optim_method(SGD(0.05))
                    .set_end_when(Trigger.max_epoch(1)))

        with pytest.raises(RuntimeError, match="real bug"):
            run_resilient(build, str(tmp_path / "c"), max_restarts=5)
        assert len(attempts) == 1


# ---------------------------------------------------------------------------
# The two packages: DS2 and SSD under run_resilient
# ---------------------------------------------------------------------------


class _Losses:
    def __init__(self, sink):
        self.sink = sink

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.sink.append(float(value))


def _ds2_batches(pkg_pipe):
    from test_torch_ds2_train import _waves

    samples, labels, lengths = _waves(24, 5)
    return list(pkg_pipe.load_asr_train_set(
        samples, labels, sample_lengths=lengths, bucket_edges=[60],
        batch_size=8, seed=2))


def _resilient_runs(make_opt, data, ckpt, fail_at, losses_of):
    """``run_resilient`` over ``make_opt(dataset)`` with a FaultInjector
    on the first attempt: each attempt's losses."""
    attempts = []

    def build():
        ds = FaultInjector(data, fail_at=fail_at) if not attempts else data
        opt = make_opt(ds)
        attempts.append(opt)
        return opt

    run_resilient(build, ckpt, max_restarts=2)
    return [losses_of(o) for o in attempts], attempts


@functools.lru_cache(maxsize=None)
def _ds2_reference_resilient():
    """The reference's run of the DS2 case (engine-independent: its
    blocked scan), once for both engines: each attempt's losses and the
    final parameters, flattened."""
    import tempfile

    from analytics_zoo_tpu.parallel import elastic as jax_elastic
    from analytics_zoo_tpu.parallel import optim as jax_optim
    from analytics_zoo_tpu.parallel import train as jax_train
    from analytics_zoo_tpu.pipelines import deepspeech2 as jax_pipe
    from analytics_zoo_tpu_torch.utils.convert import flatten_params

    jdata = _ds2_batches(jax_pipe)
    ckpt = tempfile.mkdtemp()
    attempts = []

    def jbuild():
        ds = (jax_elastic.FaultInjector(jdata, fail_at=4) if not attempts
              else jdata)
        sink = []
        o = (jax_train.Optimizer(_ds2_jax_model(), ds,
                                 jax_pipe.ds2_ctc_criterion(),
                                 metric_fn=jax_pipe.ds2_padding_metric)
             .set_optim_method(jax_optim.Adam(3e-3))
             .set_checkpoint(ckpt, jax_optim.Trigger.several_iteration(2),
                             overwrite=False, keep_last=3)
             .set_end_when(jax_optim.Trigger.max_epoch(2))
             .set_train_summary(_Losses(sink)))
        o.sink = sink
        attempts.append(o)
        return o

    jax_elastic.run_resilient(jbuild, ckpt, max_restarts=2)
    return ([o.sink for o in attempts],
            {k: np.asarray(v) for k, v in flatten_params(
                attempts[-1].model.variables["params"]).items()})


def _ds2_jax_model():
    from analytics_zoo_tpu.pipelines import deepspeech2 as jax_pipe

    return jax_pipe.make_ds2_model(hidden=32, n_rnn_layers=2,
                                   rnn_engine="blocked", utt_length=60)


@pytest.mark.parametrize("engine", ["blocked", "pallas"])
def test_ds2_resilient_matches_reference_and_straight_run(engine, tmp_path):
    """2 epochs of 3 bucketed batches, a snapshot every 2 iterations, a
    fault before the 5th batch (epoch 2, batch 2): the second attempt
    resumes from step_4, skips one batch and trains 2 steps."""
    import jax
    from analytics_zoo_tpu_torch.models.deepspeech2 import DeepSpeech2
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe
    from analytics_zoo_tpu_torch.utils.convert import (
        flax_variables_to_state_dict, state_dict_to_flax)

    init = jax.tree_util.tree_map(np.asarray, _ds2_jax_model().variables)

    def pmodel():
        m = DeepSpeech2(hidden=32, n_rnn_layers=2, rnn_engine=engine,
                        device="cpu")
        m.load_state_dict(flax_variables_to_state_dict(init, m))
        return m

    def trig():
        return Trigger.several_iteration(2)

    pdata = _ds2_batches(pipe)
    assert len(pdata) == 3

    def p_opt(ds, model=None):
        return (Optimizer(model or pmodel(), ds, pipe.ds2_ctc_criterion(),
                          metric_fn=pipe.ds2_padding_metric)
                .set_optim_method(Adam(3e-3))
                .set_checkpoint(str(tmp_path / "p"), trig(),
                                overwrite=False, keep_last=3)
                .set_end_when(Trigger.max_epoch(2)))

    ref, final_params = _ds2_reference_resilient()
    with one_thread():
        got, p_attempts = _resilient_runs(
            p_opt, pdata, str(tmp_path / "p"), 4,
            lambda o: [m["loss"].item() for m in o.history])
        straight = pmodel()
        s_opt = p_opt(pdata, straight).set_checkpoint(
            str(tmp_path / "s"), trig())
        s_opt.optimize()
    assert [len(x) for x in got] == [len(x) for x in ref] == [4, 2]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=DS2_LOSS_RTOL)
    # the resumed run repeats no step and equals the straight one
    straight_losses = [m["loss"].item() for m in s_opt.history]
    assert got[0] + got[1] == straight_losses
    resumed = p_attempts[-1]
    assert resumed._last_state.step == 6
    for (k, a), b in zip(resumed.model.state_dict().items(),
                         straight.state_dict().values()):
        assert torch.equal(a, b), k
    for name in ("mu", "nu"):
        for a, b in zip(resumed._last_state.opt_state[name],
                        s_opt._last_state.opt_state[name]):
            assert torch.equal(a, b), name
    # and the final weights stay close to the reference's
    want = final_params
    have = state_dict_to_flax(resumed.model.state_dict(),
                              {"params": init["params"]})["params"]
    assert set(have) == set(want)
    for k, v in want.items():
        # a bias in front of a BN has a gradient of 0 up to rounding, which
        # Adam turns into a step of about ±lr
        atol = (2 if k in ("conv1/bias", "proj0/bias", "proj1/bias")
                else 0.1) * 3e-3 * 6
        np.testing.assert_allclose(have[k], np.asarray(v), atol=atol,
                                   err_msg=k)


def test_ssd_resilient_matches_reference_and_straight_run(tmp_path):
    """SSD300 with 4 classes at batch 1 (MultiBoxLoss, SGD with momentum
    and weight decay, the update skipped above a loss of 50), 2 epochs
    of 2 batches, a snapshot every epoch, a fault before the 3rd batch:
    the second attempt resumes from the epoch-1 snapshot."""
    import jax
    from analytics_zoo_tpu.core.module import Model as JaxModel
    from analytics_zoo_tpu.models import ssd as jax_ssd
    from analytics_zoo_tpu.parallel import elastic as jax_elastic
    from analytics_zoo_tpu.parallel import optim as jax_optim
    from analytics_zoo_tpu.parallel import train as jax_train
    from analytics_zoo_tpu.parallel.mesh import create_mesh
    from analytics_zoo_tpu_torch.models import ssd
    from analytics_zoo_tpu_torch.ops.multibox_loss import (MultiBoxLoss,
                                                           MultiBoxLossParam)
    from analytics_zoo_tpu_torch.utils.convert import ssd_params_from_jax
    from test_torch_ssd_train import (PRIORS, VARIANCES, jax_mbl,
                                      _seeded_flax_params, _ssd_batch)

    params = _seeded_flax_params(jax_ssd.SSDVgg(num_classes=4,
                                                resolution=300), seed=4)
    batches = [_ssd_batch(30 + i) for i in range(2)]
    for b in batches:
        b["target"]["labels"] = np.minimum(b["target"]["labels"], 3)

    def jopt(ds):
        m = JaxModel(jax_ssd.SSDVgg(num_classes=4, resolution=300))
        m.variables = {"params": jax.tree_util.tree_map(np.array, params)}
        sink = []
        o = (jax_train.Optimizer(
                m, ds, jax_mbl.MultiBoxLoss(
                    PRIORS, VARIANCES,
                    jax_mbl.MultiBoxLossParam(n_classes=4)),
                skip_loss_above=50.0,
                mesh=create_mesh(devices=jax.devices()[:1]))
             .set_optim_method(jax_optim.SGD(2.5e-4, momentum=0.9,
                                             weight_decay=5e-4))
             .set_end_when(jax_optim.Trigger.max_epoch(2))
             .set_train_summary(_Losses(sink)))
        o.sink = sink
        return o

    def pmodel():
        m = ssd.SSDVgg(4, 300, device="cpu", seed=0)
        m.load_state_dict(ssd_params_from_jax(params, m))
        return m

    def popt(ds, model=None):
        return (Optimizer(model or pmodel(), ds, MultiBoxLoss(
                    PRIORS, VARIANCES, MultiBoxLossParam(n_classes=4)),
                    skip_loss_above=50.0)
                .set_optim_method(SGD(2.5e-4, momentum=0.9,
                                      weight_decay=5e-4))
                .set_end_when(Trigger.max_epoch(2)))

    attempts = []

    def jbuild():
        ds = (jax_elastic.FaultInjector(batches, fail_at=2) if not attempts
              else batches)
        o = jopt(ds)
        attempts.append(o)
        return o

    jax_elastic.run_resilient(jbuild, str(tmp_path / "j"), max_restarts=2)
    ref = [o.sink for o in attempts]
    with one_thread():
        got, p_attempts = _resilient_runs(
            popt, batches, str(tmp_path / "p"), 2,
            lambda o: [m["loss"].item() for m in o.history])
        straight = pmodel()
        s_opt = popt(batches, straight)
        s_opt.optimize()
    assert [len(x) for x in got] == [len(x) for x in ref] == [2, 2]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=SSD_LOSS_RTOL)
    assert got[0] + got[1] == [m["loss"].item() for m in s_opt.history]
    for (k, a), b in zip(p_attempts[-1].model.state_dict().items(),
                         straight.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(p_attempts[-1]._last_state.opt_state["trace"],
                    s_opt._last_state.opt_state["trace"]):
        assert torch.equal(a, b)


def test_reference_checkpoint_resumes_on_the_port(tmp_path):
    """The reference trains a tiny DS2 for 2 steps and checkpoints; its
    state, loaded by its own ``checkpoint.load`` as numpy, goes through
    ``train_state_from_jax`` into a port snapshot with the reference's
    manifest meta; the port resumes from it and trains 2 more steps,
    whose losses follow the reference's uninterrupted 4-step run."""
    import jax
    from analytics_zoo_tpu.parallel import checkpoint as jcp
    from analytics_zoo_tpu.parallel import optim as jax_optim
    from analytics_zoo_tpu.parallel import train as jax_train
    from analytics_zoo_tpu.pipelines import deepspeech2 as jax_pipe
    from analytics_zoo_tpu_torch.models.deepspeech2 import DeepSpeech2
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe
    from analytics_zoo_tpu_torch.utils.convert import train_state_from_jax

    jdata, pdata = _ds2_batches(jax_pipe), _ds2_batches(pipe)

    def jrun(epochs_iters, ckpt=None):
        sink = []
        o = (jax_train.Optimizer(
                jax_pipe.make_ds2_model(hidden=32, n_rnn_layers=2,
                                        rnn_engine="blocked",
                                        utt_length=60),
                jdata, jax_pipe.ds2_ctc_criterion())
             .set_optim_method(jax_optim.Adam(3e-3))
             .set_end_when(jax_optim.Trigger.max_iteration(epochs_iters))
             .set_train_summary(_Losses(sink)))
        if ckpt:
            o.set_checkpoint(ckpt, jax_optim.Trigger.several_iteration(2))
        o.optimize()
        return sink

    # the reference's uninterrupted 4-step run: the first attempt of
    # ``_ds2_reference_resilient`` is that run (the same model, batches
    # and Adam; its fault comes before a 5th step), computed once a module
    want = _ds2_reference_resilient()[0][0]
    assert len(want) == 4
    first = jrun(2, str(tmp_path / "j"))
    np.testing.assert_allclose(first, want[:2], rtol=1e-6)
    raw = jax.tree_util.tree_map(np.asarray, jcp.load(str(tmp_path / "j")))
    model = DeepSpeech2(hidden=32, n_rnn_layers=2, rnn_engine="pallas",
                        device="cpu")
    contents = train_state_from_jax(raw, model)
    assert contents["step"] == 2
    assert int(contents["opt_state"]["count"]) == 2
    assert len(contents["opt_state"]["mu"]) == len(list(model.parameters()))
    meta = jcp.read_manifest(os.path.join(str(tmp_path / "j"),
                                          "latest"))["meta"]
    cp.save(str(tmp_path / "p"), contents,
            meta={k: meta[k] for k in ("epoch", "iteration",
                                       "iter_in_epoch", "samples_in_epoch",
                                       "world_width", "optim")})
    opt = (Optimizer(model, pdata, pipe.ds2_ctc_criterion())
           .set_optim_method(Adam(3e-3))
           .set_resume(str(tmp_path / "p"))
           .set_end_when(Trigger.max_iteration(4)))
    opt.optimize()
    got = [m["loss"].item() for m in opt.history]
    assert len(got) == 2
    np.testing.assert_allclose(got, want[2:], rtol=DS2_LOSS_RTOL)


def test_entry_points_checkpoint(tmp_path):
    """``train_ds2(checkpoint_path=)`` snapshots every epoch, and a
    resumed ``Optimizer`` restores the module onto its own device."""
    from analytics_zoo_tpu_torch.models.deepspeech2 import DeepSpeech2
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe

    data = _ds2_batches(pipe)
    model = DeepSpeech2(hidden=16, n_rnn_layers=1, rnn_engine="pallas",
                        device="cpu")
    pipe.train_ds2(model, data, epochs=1,
                   checkpoint_path=str(tmp_path / "ds2"))
    snap, man = cp.newest_intact(str(tmp_path / "ds2"))
    assert os.path.basename(snap) == "latest"
    assert man["meta"]["iteration"] == 3 and man["meta"]["epoch"] == 1
    assert man["meta"]["world_width"] == 1
    fresh = DeepSpeech2(hidden=16, n_rnn_layers=1, rnn_engine="pallas",
                        device="cpu", seed=9)
    opt = (Optimizer(fresh, data, pipe.ds2_ctc_criterion())
           .set_optim_method(Adam(3e-4)).set_resume(str(tmp_path / "ds2"))
           .set_end_when(Trigger.max_epoch(1)))
    opt.optimize()
    for (k, a), b in zip(fresh.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), k
    assert opt._last_state.step == 3
