"""The port's anomaly sentinel (``resilience/anomaly.py``, the health
word in ``parallel/train.py::make_train_step`` and the ladder in the
``Optimizer``) against the JAX package's, on the CPU.

- **Health word**: for a DeepSpeech2 (hidden 16) whose weights cross
  through ``utils/convert.py``, the two packages name the same sections
  in the same order, and every leaf poisoned alike (NaN or inf, in the
  gradients or in the updated parameters, a non-finite or spiking loss)
  gives EQUAL words; a large finite value sets no bit in either.
  ``decode_health`` and ``batch_fingerprint`` are EQUAL.
- **Skip**: ``make_train_step(skip_unhealthy=True)`` on that DS2, on one
  intra-op thread: a poisoned batch leaves the parameters, Adam's slots
  and every buffer (batch statistics, ``num_batches_tracked``)
  bit-equal, and the word equals the reference's jitted step's on the
  same weights and batch.
- **Ladder**: the reference's ``TestLadderSmoke`` scenarios (skip then
  rollback, persistent divergence, no rollback target, spikes, an empty
  rollback budget) on a Dense(1) bridged into ``nn.Linear``, with the
  same NaN batches: the same skip, rollback and diverge iterations, the
  same sentinel events and statistics, the same forensics bundles
  (losses within ``LOSS_TOL``) and final weights within ``PARAM_TOL``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn

from analytics_zoo_tpu.core.criterion import MSECriterion as JaxMSE
from analytics_zoo_tpu.core.module import Model as JaxModel
from analytics_zoo_tpu.parallel import SGD as JaxSGD
from analytics_zoo_tpu.parallel import Optimizer as JaxOptimizer
from analytics_zoo_tpu.parallel import Trigger as JaxTrigger
from analytics_zoo_tpu.parallel import optim as jax_optim
from analytics_zoo_tpu.parallel import train as jax_train
from analytics_zoo_tpu.pipelines import deepspeech2 as jax_pipe
from analytics_zoo_tpu.resilience import anomaly as janomaly
from analytics_zoo_tpu.resilience.errors import \
    TrainingDiverged as JaxDiverged
from analytics_zoo_tpu_torch.core.criterion import MSECriterion
from analytics_zoo_tpu_torch.parallel import optim, train
from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe
from analytics_zoo_tpu_torch.resilience import anomaly
from analytics_zoo_tpu_torch.resilience.errors import TrainingDiverged
from analytics_zoo_tpu_torch.utils.convert import (
    flatten_params, flax_variables_to_state_dict)
from test_torch_ds2_train import _ctc_batch, _jax_ds2, _port_ds2

DIM, BS = 4, 8
LOSS_TOL = 1e-5        # relative, a loss in a forensics bundle
PARAM_TOL = 1e-5       # absolute, the final Dense weights


# -- the health word -----------------------------------------------------------


def _ds2():
    module, variables = _jax_ds2(16, 1, T=16)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return module, variables, _port_ds2(variables, 16, 1, "blocked")


def _port_tree(flat, variables, model):
    """A flat flax ``params`` tree as the port's per-section leaves."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *scope, leaf = key.split("/")
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = v
    sd = flax_variables_to_state_dict(
        {"params": tree, "batch_stats": variables["batch_stats"]}, model)
    params = [sd[n] for n, p in model.named_parameters() if p.requires_grad]
    sections, groups = anomaly.section_groups(model)
    return {s: [params[i] for i in g] for s, g in zip(sections, groups)}


def _nested(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *scope, leaf = key.split("/")
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _words(variables, model, grads, params, loss=1.0, spike=None):
    sections = janomaly.health_sections(variables["params"])
    want = int(janomaly.tree_health_word(
        jnp.float32(loss), _nested(grads), _nested(params), sections,
        spike_loss_above=spike))
    got = int(anomaly.tree_health_word(
        torch.tensor(loss, dtype=torch.float32),
        _port_tree(grads, variables, model),
        _port_tree(params, variables, model),
        anomaly.health_sections(model), spike_loss_above=spike))
    return got, want


def test_sections_are_the_reference_sections():
    _, variables, model = _ds2()
    want = janomaly.health_sections(variables["params"])
    assert anomaly.health_sections(model) == want
    assert len(want) > 3          # conv1, the BNs, birnn0, the head
    assert anomaly.health_sections(torch.nn.Linear(4, 1)) == [
        "bias", "kernel"]
    assert anomaly.health_sections({"b": 1, "a": 2}) == \
        janomaly.health_sections({"b": 1, "a": 2})
    assert anomaly.health_sections(np.zeros(3)) == ["params"]


@pytest.mark.parametrize("where,value", [
    ("grads", np.nan), ("grads", np.inf), ("params", np.nan),
    ("params", -np.inf)])
def test_word_equal_for_each_poisoned_leaf(where, value):
    """Every leaf in turn, poisoned alike in both trees: the words are
    equal, and the decoded report names the leaf's section."""
    _, variables, model = _ds2()
    flat = flatten_params(variables["params"])
    sections = janomaly.health_sections(variables["params"])
    for key in flat:
        bad = {k: v.copy() for k, v in flat.items()}
        bad[key].reshape(-1)[-1] = value
        grads, params = (bad, flat) if where == "grads" else (flat, bad)
        got, want = _words(variables, model, grads, params)
        assert got == want, key
        rep = anomaly.decode_health(got, sections)
        assert rep == janomaly.decode_health(want, sections)
        assert rep["bad_sections"] == {
            key.split("/")[0]: {"grads": where == "grads",
                                "params": where == "params"}}


@pytest.mark.parametrize("loss,spike,bits", [
    (float("nan"), None, {"loss_nonfinite"}),
    (float("inf"), 50.0, {"loss_nonfinite"}),
    (75.0, 50.0, {"loss_spike"}), (25.0, 50.0, set()),
    (3.0e38, None, set())])
def test_word_equal_for_the_loss(loss, spike, bits):
    _, variables, model = _ds2()
    flat = flatten_params(variables["params"])
    got, want = _words(variables, model, flat, flat, loss=loss, spike=spike)
    assert got == want
    rep = anomaly.decode_health(got, ["x"])
    assert {k for k in ("loss_nonfinite", "loss_spike") if rep[k]} == bits


def test_large_finite_values_set_no_bit():
    """A fold through a norm or a sum of squares would overflow to inf on
    these finite values and set a false bit."""
    _, variables, model = _ds2()
    flat = {k: np.full_like(v, 3.0e38)
            for k, v in flatten_params(variables["params"]).items()}
    assert _words(variables, model, flat, flat) == (0, 0)


def test_decode_and_fingerprint_equal_reference():
    rng = np.random.RandomState(0)
    sections = [f"s{i}" for i in range(16)]     # past MAX_SECTIONS
    for word in [0, 1, 2, 0xFD] + list(rng.randint(0, 2 ** 31 - 1, 64)):
        assert anomaly.decode_health(word, sections) == \
            janomaly.decode_health(word, sections)
    batches = [
        {"input": rng.randn(8, 4).astype(np.float32),
         "target": rng.randn(8, 1).astype(np.float32)},
        _ctc_batch(3),
        {"input": (rng.randn(2, 5).astype(np.float32), None),
         "n": np.int32(3), "mask": np.ones((2, 3), bool)},
    ]
    for b in batches:
        assert anomaly.batch_fingerprint(b) == janomaly.batch_fingerprint(b)
    b = batches[0]
    as_tensors = {k: torch.from_numpy(v) for k, v in b.items()}
    assert anomaly.batch_fingerprint(as_tensors) == \
        janomaly.batch_fingerprint(b)
    b2 = {k: v.copy() for k, v in b.items()}
    b2["input"][0, 0] += 1
    assert anomaly.batch_fingerprint(b2) != anomaly.batch_fingerprint(b)


# -- the skip --------------------------------------------------------------------


def test_skip_keeps_state_bit_identical_and_word_equals_reference():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        module, variables, model = _ds2()
        opt = optim.Adam(3e-4)
        step = train.make_train_step(model, pipe.ds2_ctc_criterion(), opt,
                                     skip_unhealthy=True)
        buffers = {k: v.clone() for k, v in model.named_buffers()}
        state, metrics = step(train.create_train_state(model, opt),
                              _ctc_batch(5))
        assert int(metrics["health"]) == 0
        # a train-mode forward moves the batch statistics in place
        moved = [k for k, v in model.named_buffers()
                 if not torch.equal(v, buffers[k])]
        assert moved
        before = {k: v.clone() for k, v in model.state_dict().items()}
        slots = {k: [t.clone() for t in v] if isinstance(v, list)
                 else v.clone() for k, v in state.opt_state.items()}
        bad = _ctc_batch(6)
        bad["input"][0][1, 3, 2] = np.nan
        state, metrics = step(state, bad)
        word = int(metrics["health"])
        assert word != 0 and state.step == 2
        after = model.state_dict()
        assert set(moved) <= set(after)
        for k, v in before.items():
            assert torch.equal(v, after[k]), k
        assert int(state.opt_state["count"]) == 1
        for k in ("mu", "nu"):
            assert all(torch.equal(a, b) for a, b in
                       zip(slots[k], state.opt_state[k]))
        # a clean batch steps again
        state, metrics = step(state, _ctc_batch(7))
        assert int(metrics["health"]) == 0
        assert int(state.opt_state["count"]) == 2
    finally:
        torch.set_num_threads(threads)
    # the reference's jitted step on the same weights and batch
    jopt = jax_optim.Adam(3e-4)
    jstep = jax_train.make_train_step(module, jax_pipe.ds2_ctc_criterion(),
                                      jopt, health_check=True,
                                      skip_unhealthy=True)
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.array, variables["params"]),
        model_state={"batch_stats": jax.tree_util.tree_map(
            jnp.array, variables["batch_stats"])},
        opt_state=jopt.tx.init(variables["params"]),
        rng=jax.random.PRNGKey(0))
    _, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, bad), 1.0)
    assert word == int(jm["health"])


# -- the ladder ------------------------------------------------------------------


class NanBatches:
    """``n`` batches an epoch of a seeded linear problem; the batches whose
    global index (epoch * n + i) is in ``bad`` carry a NaN input, those
    in ``spike`` a target 1e3 off (a finite loss spike).  Fresh numpy
    copies every epoch, as a loader hands them out."""

    base_seed = 5

    def __init__(self, bad=(), spike=(), n=6, seed=0):
        rng = np.random.RandomState(seed)
        w = rng.randn(DIM, 1).astype(np.float32)
        self.X = rng.randn(BS * n, DIM).astype(np.float32)
        self.Y = (self.X @ w).astype(np.float32)
        self.bad, self.spike, self.n = set(bad), set(spike), n
        self.epoch = 0

    def __iter__(self):
        e, self.epoch = self.epoch, self.epoch + 1
        for i in range(self.n):
            x = self.X[i * BS:(i + 1) * BS].copy()
            y = self.Y[i * BS:(i + 1) * BS].copy()
            if e * self.n + i in self.bad:
                x[0, 0] = np.nan
            if e * self.n + i in self.spike:
                y += 1e3
            yield {"input": x, "target": y}


def _models():
    ref = JaxModel(jnn.Dense(1))
    ref.build(0, jnp.zeros((1, DIM), jnp.float32))
    lin = torch.nn.Linear(DIM, 1)
    lin.load_state_dict(flax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray,
                                          ref.variables["params"])}, lin))
    return ref, lin


LADDERS = {
    "skip_then_rollback": dict(
        bad=(2, 8, 9), epochs=4, ckpt=True,
        policy=dict(rollback_after=2, promote_after=2)),
    "persistent_divergence": dict(
        bad=range(2, 100), epochs=10, ckpt=True,
        policy=dict(rollback_after=2, promote_after=2, max_rollbacks=1)),
    "no_rollback_target": dict(
        bad=range(1, 50), epochs=4, ckpt=False,
        policy=dict(rollback_after=2)),
    "spikes_never_escalate": dict(
        spike=(1, 2, 3, 7), epochs=2, ckpt=True,
        policy=dict(rollback_after=1, promote_after=2,
                    spike_loss_above=50.0)),
    "empty_rollback_budget": dict(
        bad=(3, 4), epochs=2, ckpt=True,
        policy=dict(rollback_after=2, promote_after=2, max_rollbacks=0)),
}


def _ladder(side, case, tmp):
    """Run one ladder case through one package: the Optimizer, the raised
    error (or None) and the forensics bundles."""
    cfg = LADDERS[case]
    ref, lin = _models()
    data = NanBatches(cfg.get("bad", ()), cfg.get("spike", ()))
    ckpt = os.path.join(tmp, side, "ckpt")
    policy = dict(cfg["policy"], forensics_dir=os.path.join(tmp, side, "f"))
    if side == "reference":
        opt = (JaxOptimizer(ref, data, JaxMSE())
               .set_optim_method(JaxSGD(0.05))
               .set_anomaly_policy(janomaly.AnomalyPolicy(**policy))
               .set_end_when(JaxTrigger.max_epoch(cfg["epochs"])))
        if cfg["ckpt"]:
            opt.set_checkpoint(ckpt, JaxTrigger.several_iteration(2),
                               overwrite=False, keep_last=3)
        raises = JaxDiverged
    else:
        opt = (train.Optimizer(lin, data, MSECriterion())
               .set_optim_method(optim.SGD(0.05))
               .set_anomaly_policy(anomaly.AnomalyPolicy(**policy))
               .set_end_when(optim.Trigger.max_epoch(cfg["epochs"])))
        if cfg["ckpt"]:
            opt.set_checkpoint(ckpt, optim.Trigger.several_iteration(2),
                               overwrite=False, keep_last=3)
        raises = TrainingDiverged
    err = None
    try:
        opt.optimize()
    except raises as e:
        err = str(e).split(":")[0]
    bundles = []
    for path in opt._anomaly.forensics_paths:
        with open(path) as f:
            bundles.append(json.load(f))
    return opt, err, bundles


def _weights(side, opt):
    if side == "reference":
        p = opt.model.variables["params"]
        return np.asarray(p["kernel"]).T, np.asarray(p["bias"])
    return (opt.model.weight.detach().numpy(),
            opt.model.bias.detach().numpy())


@pytest.mark.parametrize("case", sorted(LADDERS))
def test_ladder_equal_to_reference(case, tmp_path):
    runs = {side: _ladder(side, case, str(tmp_path))
            for side in ("reference", "port")}
    (ref, ref_err, ref_bundles), (got, err, bundles) = (
        runs["reference"], runs["port"])
    assert err == ref_err
    assert got._anomaly.stats() == ref._anomaly.stats()
    assert got._anomaly.events == ref._anomaly.events
    assert len(bundles) == len(ref_bundles)
    for b, rb in zip(bundles, ref_bundles):
        lh, rlh = b.pop("loss_history"), rb.pop("loss_history")
        assert b == rb
        assert [isinstance(v, str) for v in lh] == \
            [isinstance(v, str) for v in rlh]
        np.testing.assert_allclose([v for v in lh if not isinstance(v, str)],
                                   [v for v in rlh
                                    if not isinstance(v, str)],
                                   rtol=LOSS_TOL)
    if err is None:         # a diverged reference run keeps no weights
        for a, b in zip(_weights("port", got), _weights("reference", ref)):
            np.testing.assert_allclose(a, b, atol=PARAM_TOL)
            assert np.all(np.isfinite(a))


def test_ladders_reach_what_they_are_named_for(tmp_path):
    """What each case is for (the reference is equal by the test above)."""
    tmp = str(tmp_path)
    opt, err, bundles = _ladder("port", "skip_then_rollback", tmp)
    stats = opt._anomaly.stats()
    assert err is None and stats["bad_steps"] == 3 and \
        stats["rollbacks"] == 1
    (rb,) = [e for e in opt._anomaly.events if e["kind"] == "rollback"]
    assert rb["tier"] == "lkg" and rb["params_match_snapshot"] is True
    assert len(bundles) == 2 and bundles[0]["rng"]["base_seed"] == 5
    assert bundles[0]["batch_hash"] == anomaly.batch_fingerprint(
        list(NanBatches((2,)))[2])
    _, err, _ = _ladder("port", "persistent_divergence", tmp + "/d")
    # batches 2, 3 bad, a rollback, 4 and 5 re-sought, 6 and 7 bad
    assert err == "anomaly ladder exhausted at iteration 6"
    _, err, _ = _ladder("port", "no_rollback_target", tmp + "/n")
    assert err.startswith("anomaly rollback requested")
    opt, err, bundles = _ladder("port", "spikes_never_escalate", tmp + "/s")
    assert err is None and opt._anomaly.stats()["spike_skips"] == 4
    assert not bundles and opt._anomaly.rollbacks == 0
    _, err, _ = _ladder("port", "empty_rollback_budget", tmp + "/e")
    assert err == "anomaly ladder exhausted at iteration 5"


def test_unhealthy_word_refuses_snapshot(tmp_path):
    """The checkpoint guard reads the health word: non-finite parameters
    with a finite loss refuse the snapshot too."""
    ckpt = str(tmp_path / "ckpt")
    _, lin = _models()
    opt = (train.Optimizer(lin, [], MSECriterion())
           .set_optim_method(optim.SGD(0.05))
           .set_checkpoint(ckpt, optim.Trigger.always()))
    state = train.create_train_state(lin, opt.optim)
    loop = optim.TrainingState(loss=1.0)
    loop.health = 1 << anomaly.BIT_PARAMS_NONFINITE
    assert opt._maybe_checkpoint(loop, state) is False
    assert not os.path.exists(os.path.join(ckpt, "latest"))
    loop.health = 0
    assert opt._maybe_checkpoint(loop, state) is True
    assert os.path.exists(os.path.join(ckpt, "latest"))


def test_policy_validation_and_sentinel_equal_reference():
    for kw in (dict(rollback_after=0), dict(promote_after=0),
               dict(max_rollbacks=-1)):
        with pytest.raises(ValueError):
            anomaly.AnomalyPolicy(**kw)
    words = [0, 0, 0xFD, 0, 2, 2, 0xFD, 0xFD, 0, 0, 0, 0xFD, 0xFD, 0xFD]
    sents = [anomaly.AnomalySentinel(anomaly.AnomalyPolicy(
                 rollback_after=2, promote_after=2), ["a"]),
             janomaly.AnomalySentinel(janomaly.AnomalyPolicy(
                 rollback_after=2, promote_after=2), ["a"])]
    trail = []
    for s in sents:
        out = []
        for i, w in enumerate(words):
            action, first = s.observe(w)
            out.append((action, first, s.should_promote()))
            if action == "rollback":
                s.note_rollback(iteration=i)
            elif out[-1][2]:
                s.note_promoted(i, "lkg")
        trail.append((out, s.stats(), s.events))
    assert trail[0] == trail[1]
