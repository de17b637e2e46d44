"""Parity of the port's DeepSpeech2 training slice with the JAX package, on
the CPU: train-mode ``SequenceBN``, the DS2 training forward with its
CTC loss and gradients, ``CTCCriterion``, the optimizers, the train step
and ``Optimizer``, ``load_asr_train_set`` and a 3-step ``train_ds2``.

Tolerances: host data code is the same numpy and is compared exactly;
BN outputs and statistics within 1e-5 (the same fp32 ops in another
summation order); log-probs within 1e-4 and gradients within 1e-4 of
each tensor's largest magnitude (several layers of fp32 products in
another order); CTC losses within 1e-5 relative and their gradients
within 1e-5, except on a row with no alignment: there optax's loss is
~1e5, its recursion subtracts numbers of that size (fp32 spacing 0.008
there), and two implementations of it agree on the gradient within
5e-3 only.  Adam normalises each gradient to about ±lr, so a gradient
near 0 can flip the sign of its update between two summation orders:
the optimizer tests draw gradients at least 0.5 from 0 and hold
parameters within 1e-6; the training runs hold the biases in front of a
BN (whose gradient is 0 up to rounding) within 2·lr a step, and the
running means of the BNs right after them (which those biases shift)
within 0.2·lr a step, every other leaf within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.core.criterion import CTCCriterion as JaxCTC
from analytics_zoo_tpu.models.deepspeech2 import DeepSpeech2 as JaxDS2
from analytics_zoo_tpu.models.deepspeech2 import SequenceBN as JaxBN
from analytics_zoo_tpu.parallel import optim as jax_optim
from analytics_zoo_tpu.parallel import train as jax_train
from analytics_zoo_tpu.pipelines import deepspeech2 as jax_pipe
from analytics_zoo_tpu_torch.core.criterion import (CTCCriterion,
                                                    ctc_loss_plain)
from analytics_zoo_tpu_torch.models.deepspeech2 import (DeepSpeech2,
                                                        SequenceBN)
from analytics_zoo_tpu_torch.parallel import optim, train
from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe
from analytics_zoo_tpu_torch.utils.convert import (
    flatten_params, flax_variables_to_state_dict, state_dict_to_flax)

torch.set_num_threads(2)

T = torch.from_numpy
BN_ATOL = 1e-5
LOGP_ATOL = 1e-4
GRAD_RTOL = 1e-4
# biases followed by a BN: their gradient is 0 up to rounding; and the
# running means of those BNs
BEFORE_BN = ("conv1/bias", "proj0/bias", "proj1/bias")
AFTER_BIAS = ("bn_conv1/BatchNorm_0/mean", "bn_rnn0/BatchNorm_0/mean",
              "bn_rnn1/BatchNorm_0/mean")


# -- train-mode SequenceBN ---------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_sequence_bn_train_matches_flax(masked):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 7, 5) * 2 + 1).astype(np.float32)
    mask = (np.arange(7)[None, :] < np.array([7, 4, 1])[:, None])[..., None]
    mask = mask if masked else None
    g = rng.randn(3, 7, 5).astype(np.float32)
    jbn = JaxBN()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) + 0.5),
        variables)

    def jfwd(params, x):
        return jbn.apply({"params": params,
                          "batch_stats": variables["batch_stats"]}, x,
                         train=True, mask=mask, mutable=["batch_stats"])

    (want, stats) = jfwd(variables["params"], jnp.asarray(x))
    j_gx, j_gp = jax.grad(lambda x, p: jnp.sum(jfwd(p, x)[0] * g),
                          argnums=(0, 1))(jnp.asarray(x),
                                          variables["params"])
    bn = SequenceBN(5)
    bn.load_state_dict(flax_variables_to_state_dict(variables, bn))
    bn.train()
    xt = torch.from_numpy(x).requires_grad_()
    got = bn(xt, None if mask is None else torch.from_numpy(mask))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=BN_ATOL)
    new = state_dict_to_flax(bn.state_dict(), variables)["batch_stats"]
    for k, v in flatten_params(stats["batch_stats"]).items():
        np.testing.assert_allclose(new[k], v, atol=BN_ATOL, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_gx),
                               atol=BN_ATOL)
    got_gp = state_dict_to_flax({k: p.grad for k, p in
                                 bn.named_parameters()}, variables)
    for k, v in flatten_params(j_gp).items():
        np.testing.assert_allclose(got_gp["params"][k], v, atol=BN_ATOL,
                                   err_msg=k)


# -- the DS2 training forward, CTC loss and gradients ------------------------

def _jax_ds2(hidden, layers, T, seed=0):
    module = JaxDS2(hidden=hidden, n_rnn_layers=layers, rnn_engine="blocked")
    variables = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, T, 13)))
    rng = np.random.RandomState(seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) + 0.5),
        variables["batch_stats"])
    return module, {"params": variables["params"], "batch_stats": stats}


def _port_ds2(variables, hidden, layers, engine):
    model = DeepSpeech2(hidden=hidden, n_rnn_layers=layers,
                        rnn_engine=engine, device="cpu")
    model.load_state_dict(flax_variables_to_state_dict(variables, model))
    return model


def _ctc_batch(seed, B=3, T=16, n=(16, 11, 6), n_label=(4, 3, 2), L=5):
    rng = np.random.RandomState(seed)
    labels = np.zeros((B, L), np.int32)
    for i, k in enumerate(n_label):
        labels[i, :k] = rng.choice(np.arange(1, 29), k, replace=False)
    mask = (np.arange(L)[None, :] < np.array(n_label)[:, None])
    nf = np.array(n, np.int32)
    return {"input": (rng.randn(B, T, 13).astype(np.float32), nf),
            "n_frames": nf, "labels": labels,
            "label_mask": mask.astype(np.float32)}


def _assert_grads_close(got, want):
    """Within GRAD_RTOL of each tensor's largest magnitude, or of the
    model's largest for a bias in front of a BN."""
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        scale = top if k in BEFORE_BN else float(np.abs(v).max())
        np.testing.assert_allclose(got[k], v, atol=GRAD_RTOL * scale,
                                   err_msg=k)


@pytest.mark.parametrize("engine", ["blocked", "pallas"])
def test_ds2_training_forward_and_grads_match_jax(engine):
    """Train mode with ragged ``n_frames``: log-probs, the CTC loss of
    ``ds2_ctc_criterion``, every parameter's gradient and the updated
    batch statistics against the JAX package's."""
    module, variables = _jax_ds2(16, 2, T=16)
    model = _port_ds2(variables, 16, 2, engine)
    batch = _ctc_batch(3)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jcrit = jax_pipe.ds2_ctc_criterion()

    def jloss(params):
        out, new = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *jbatch["input"], train=True, mutable=["batch_stats"])
        return jcrit(out, jbatch), (out, new)

    (j_loss, (j_out, j_new)), j_grads = jax.value_and_grad(
        jloss, has_aux=True)(variables["params"])
    model.train()
    tbatch = train.to_device(batch, torch.device("cpu"))
    out = model(*tbatch["input"])
    loss = pipe.ds2_ctc_criterion()(out, tbatch)
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=LOGP_ATOL)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    got = state_dict_to_flax({k: p.grad for k, p in model.named_parameters()},
                             variables)
    want = flatten_params(j_grads)
    assert got["params"].keys() == want.keys()
    _assert_grads_close(got["params"], want)
    stats = state_dict_to_flax(model.state_dict(), variables)["batch_stats"]
    for k, v in flatten_params(j_new["batch_stats"]).items():
        np.testing.assert_allclose(stats[k], v, atol=BN_ATOL, err_msg=k)


# -- CTCCriterion ------------------------------------------------------------

def _ctc_inputs(seed, log_softmax):
    rng = np.random.RandomState(seed)
    B, T, K, L = 4, 12, 29, 6
    logits = rng.randn(B, T, K).astype(np.float32) * 2
    if log_softmax:
        logits = np.asarray(jax.nn.log_softmax(logits), np.float32)
    labels = rng.randint(1, K, (B, L)).astype(np.int32)
    labels[1, 2] = labels[1, 1]                       # a repeat
    n_label = np.array([6, 4, 3, 6])
    n_frame = np.array([12, 9, 5, 3])                 # row 3: infeasible
    label_mask = (np.arange(L)[None] < n_label[:, None]).astype(np.float32)
    logit_mask = (np.arange(T)[None] < n_frame[:, None]).astype(np.float32)
    return logits, labels, logit_mask, label_mask


@pytest.mark.parametrize("masks", [True, False])
@pytest.mark.parametrize("log_softmax", [True, False])
def test_ctc_criterion_matches_jax(masks, log_softmax):
    """Loss and gradient against the JAX ``CTCCriterion`` (optax): on
    DS2's log-probs and on raw logits (optax normalizes its input), with
    masked frames and labels, a repeated label, and a row with fewer
    frames than labels, where optax's loss is large and finite."""
    logits, labels, logit_mask, label_mask = _ctc_inputs(0, log_softmax)
    kw = ({"logit_mask": logit_mask, "label_mask": label_mask} if masks
          else {})
    jcrit = JaxCTC()
    want, j_grad = jax.value_and_grad(lambda x: jcrit(
        x, jnp.asarray(labels), **{k: jnp.asarray(v) for k, v in kw.items()}
    ))(jnp.asarray(logits))
    x = torch.from_numpy(logits.copy()).requires_grad_()
    got = CTCCriterion()(x, torch.from_numpy(labels),
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    got.backward()
    assert np.isfinite(float(want)) and torch.isfinite(got)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    feasible = 3 if masks else 4                      # row 3 has no path
    np.testing.assert_allclose(x.grad.numpy()[:feasible],
                               np.asarray(j_grad)[:feasible], atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy()[feasible:],
                               np.asarray(j_grad)[feasible:], atol=5e-3)


def test_ctc_loss_plain_matches_optax():
    logits, labels, logit_mask, label_mask = _ctc_inputs(1, False)
    want = optax.ctc_loss(jnp.asarray(logits), jnp.asarray(1 - logit_mask),
                          jnp.asarray(labels), jnp.asarray(1 - label_mask))
    got = ctc_loss_plain(torch.from_numpy(logits),
                         torch.from_numpy(1 - logit_mask),
                         torch.from_numpy(labels),
                         torch.from_numpy(1 - label_mask))
    assert float(want[3]) > 1e4                       # the infeasible row
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- optimizers --------------------------------------------------------------

def _grads(rng, shapes):
    """Gradients at least 0.5 away from 0 (see the module docstring)."""
    return [np.sign(r) * (0.5 + np.abs(r)) for r in
            (rng.randn(*s).astype(np.float32) for s in shapes)]


@pytest.mark.parametrize("make", [
    lambda m: m.Adam(3e-3),
    lambda m: m.Adam(1e-2, b1=0.8, b2=0.99, eps=1e-6),
    lambda m: m.SGD(1e-2),
    lambda m: m.SGD(1e-2, momentum=0.9, weight_decay=1e-2),
    lambda m: m.SGD(1e-2, momentum=0.9, nesterov=True),
    lambda m: m.SGD(0.1, momentum=0.9,
                    schedule=m.multistep(0.1, [1, 2], 0.5)),
    lambda m: m.AdamW(1e-2, weight_decay=0.1),
], ids=["adam", "adam-params", "sgd", "sgd-momentum-wd", "sgd-nesterov",
        "sgd-multistep", "adamw"])
def test_optimizers_match_optax(make):
    """Three steps of the port's method against the JAX package's (optax
    under ``inject_hyperparams``, the learning rate set each step as its
    train step does), from the same parameters and gradients."""
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (4,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [_grads(rng, shapes) for _ in range(3)]
    jopt, popt = make(jax_optim), make(optim)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.tx.init(jp)
    pp = [torch.from_numpy(p.copy()) for p in params]
    pstate = popt.init(pp)
    for step, g in enumerate(grads):
        lr = jopt.lr_for_step(step, 1.0)
        jstate = jax_train._set_lr(jstate, lr)
        updates, jstate = jopt.tx.update([jnp.asarray(x) for x in g],
                                         jstate, jp)
        jp = optax.apply_updates(jp, updates)
        assert popt.lr_for_step(step) == pytest.approx(float(lr))
        popt.update(pp, [torch.from_numpy(x) for x in g], pstate,
                    popt.lr_for_step(step))
        for a, b in zip(pp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_masked_update_keeps_params_and_slots():
    p = [torch.ones(3)]
    for method in (optim.Adam(0.1), optim.SGD(0.1, momentum=0.9)):
        state = method.init(p)
        method.update(p, [torch.ones(3)], state, 0.1,
                      keep=torch.tensor(False))
        assert torch.equal(p[0], torch.ones(3))
        assert all(torch.count_nonzero(t) == 0 for v in state.values()
                   for t in (v if isinstance(v, list) else [v]))
    assert optim.Trigger.max_iteration(2)(optim.TrainingState(iteration=2))
    assert not optim.Trigger.max_epoch(2)(optim.TrainingState(epoch=1))


# -- the train step ----------------------------------------------------------

def test_train_step_clip_and_skip_match_jax():
    """One step with ``grad_clip_norm`` against the JAX package's
    ``make_train_step`` (fp32, from bridged weights): parameters and batch
    statistics.  ``skip_loss_above`` under the loss masks the whole
    update (Adam's count too) while the step count moves on."""
    module, variables = _jax_ds2(16, 1, T=16, seed=4)
    model = _port_ds2(variables, 16, 1, "pallas")
    # the JAX step donates its state: keep a host copy of the tree
    variables = jax.tree_util.tree_map(np.asarray, variables)
    batch = _ctc_batch(5)
    jopt = jax_optim.Adam(3e-4)
    jstep = jax_train.make_train_step(module, jax_pipe.ds2_ctc_criterion(),
                                      jopt, grad_clip_norm=0.5)
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.array, variables["params"]),
        model_state={"batch_stats": jax.tree_util.tree_map(
            jnp.array, variables["batch_stats"])},
        opt_state=jopt.tx.init(variables["params"]),
        rng=jax.random.PRNGKey(0))
    jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                       1.0)
    popt = optim.Adam(3e-4)
    step = train.make_train_step(model, pipe.ds2_ctc_criterion(), popt,
                                 grad_clip_norm=0.5)
    state, metrics = step(train.create_train_state(model, popt), batch)
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    got = state_dict_to_flax(model.state_dict(), variables)
    for k, v in flatten_params(jstate.params).items():
        np.testing.assert_allclose(got["params"][k], v, atol=(
            2 * 3e-4 if k in BEFORE_BN else 1e-5), err_msg=k)
    for k, v in flatten_params(jstate.model_state["batch_stats"]).items():
        np.testing.assert_allclose(got["batch_stats"][k], v, atol=BN_ATOL,
                                   err_msg=k)
    before = [p.detach().clone() for p in model.parameters()]
    skip = train.make_train_step(model, pipe.ds2_ctc_criterion(), popt,
                                 skip_loss_above=0.0)
    state, _ = skip(state, batch)
    assert state.step == 2 and int(state.opt_state["count"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


@pytest.mark.parametrize("compute_dtype", [None, "bf16"])
def test_eval_step_takes_an_input_tree(compute_dtype):
    """``make_eval_step`` on DS2's ``(features, n_frames)`` against the
    reference's: the tuple is unpacked into the forward's arguments, and
    under bf16 only the floating leaves are cast (``n_frames`` stays an
    integer tensor).  fp32 within ``LOGP_ATOL``; bf16 within 0.1 of the
    log-probs (the reference casts every parameter to bf16, the port runs
    autocast over fp32 parameters: two roundings of a 8-bit mantissa
    through the conv, BN, one BiRNN and the output layer), and both
    within that of the fp32 result."""
    module, variables = _jax_ds2(16, 1, T=16)
    model = _port_ds2(variables, 16, 1, "pallas").eval()
    x, n = _ctc_batch(9)["input"]
    want = np.asarray(jax_train.make_eval_step(module, compute_dtype)(
        variables, (jnp.asarray(x), jnp.asarray(n))))
    seen = []
    forward = model.forward

    def spy(*args):
        seen.extend(a.dtype for a in args)
        return forward(*args)

    model.forward = spy
    got = train.make_eval_step(model, compute_dtype)((T(x), T(n)))
    assert got.dtype == torch.float32
    assert seen == [torch.float32 if compute_dtype is None
                    else torch.bfloat16, torch.int32]
    atol = LOGP_ATOL if compute_dtype is None else 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


def test_criterion_protocol_matches_jax():
    """``make_train_step`` calls a ``Criterion`` as ``crit(output,
    batch["target"], mask=batch["target_mask"])`` and any other callable
    as ``crit(output, batch)``, as the reference's ``_call_criterion``:
    one SGD step of a dense layer under ``MSECriterion`` with a target
    mask, against the reference's step on the same weights."""
    import flax.linen as fnn

    from analytics_zoo_tpu.core.criterion import MSECriterion as JaxMSE
    from analytics_zoo_tpu_torch.core.criterion import MSECriterion

    rng = np.random.RandomState(10)
    w = rng.randn(5, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    batch = {"input": rng.randn(4, 5).astype(np.float32),
             "target": rng.randn(4, 3).astype(np.float32),
             "target_mask": (rng.rand(4, 3) < 0.6).astype(np.float32)}
    jopt = jax_optim.SGD(0.1)
    jstep = jax_train.make_train_step(fnn.Dense(3), JaxMSE(), jopt)
    params = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, model_state={},
        opt_state=jopt.tx.init(params), rng=jax.random.PRNGKey(0))
    jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                       1.0)
    lin = torch.nn.Linear(5, 3)
    lin.load_state_dict({"weight": T(w.T.copy()), "bias": T(b)})
    popt = optim.SGD(0.1)
    step = train.make_train_step(lin, MSECriterion(), popt)
    _, metrics = step(train.create_train_state(lin, popt), batch)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(lin.weight.detach().numpy().T,
                               np.asarray(jstate.params["kernel"]),
                               atol=1e-6)
    seen = []

    def plain(out, batch):
        seen.append(sorted(batch))
        return out.sum()

    step = train.make_train_step(lin, plain, popt)
    step(train.create_train_state(lin, popt), batch)
    assert seen == [["input", "target", "target_mask"]]


def test_train_step_bf16_and_refusals():
    """``compute_dtype="bf16"`` runs the forward under autocast over the
    fp32 parameters (the loss within 5% of fp32's); ``health_check``
    gives a clean step's word 0 and the Optimizer takes the anomaly
    policy and observability (``tests/test_torch_anomaly.py``); a step
    over a one-rank mesh (``specs=``, ``mesh=``) is the plain step."""
    model = DeepSpeech2(hidden=16, n_rnn_layers=1, rnn_engine="pallas",
                        device="cpu")
    batch = _ctc_batch(6)
    crit = pipe.ds2_ctc_criterion()
    losses = {}
    for cd in (None, "bf16"):
        m = DeepSpeech2(hidden=16, n_rnn_layers=1, rnn_engine="pallas",
                        device="cpu")
        step = train.make_train_step(m, crit, optim.Adam(1e-3),
                                     compute_dtype=cd)
        _, metrics = step(train.create_train_state(m, optim.Adam(1e-3)),
                          batch)
        losses[cd] = metrics["loss"].item()
        assert all(p.dtype == torch.float32 for p in m.parameters())
    assert abs(losses["bf16"] - losses[None]) <= 0.05 * abs(losses[None])
    step = train.make_train_step(model, crit, optim.Adam(1e-3),
                                 health_check=True)
    _, metrics = step(train.create_train_state(model, optim.Adam(1e-3)),
                      batch)
    assert metrics["health"].dtype == torch.int32
    assert int(metrics["health"]) == 0
    import torch_dist_scenarios as sc
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    one = sc.StubMesh({"data": 1})
    for kw in (None, dict(specs=SpecSet(one)), dict(mesh=one)):
        m = DeepSpeech2(hidden=16, n_rnn_layers=1, rnn_engine="pallas",
                        device="cpu")
        step = train.make_train_step(m, crit, optim.Adam(1e-3), **(kw or {}))
        _, metrics = step(train.create_train_state(m, optim.Adam(1e-3)),
                          batch)
        if kw is None:
            plain = metrics["loss"].item()
        else:
            assert metrics["loss"].item() == plain
    opt = train.Optimizer(model, [batch], crit)
    assert opt.set_anomaly_policy() is opt and opt.anomaly_policy.skip
    assert opt.set_observability() is opt and opt.obs is not None
    # checkpoints are served (tests/test_torch_resume.py)
    assert opt.set_checkpoint("/nowhere", optim.Trigger.every_epoch()) is opt
    # the input path is ported: a device transform runs in the step, and
    # prefetch on a CPU model does nothing (pinning needs a card)
    seen = []
    step = train.make_train_step(
        model, crit, optim.Adam(),
        device_transform=lambda b: seen.append(sorted(b)) or b)
    step(train.create_train_state(model, optim.Adam()), batch)
    assert seen == [sorted(batch)]
    assert train.Optimizer(model, [batch], crit, prefetch=2).prefetch == 2
    # sequence parallelism needs a mesh with the axis
    # (tests/test_torch_sequence_ds2.py)
    with pytest.raises(ValueError, match="'sequence' axis, got None"):
        pipe.train_ds2(model, [batch], sequence_parallel=True)


# -- the training set and train_ds2 -----------------------------------------

def _waves(n, seed, lo=4000, hi=9800):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(lo, hi, n)
    samples = np.zeros((n, hi), np.float32)
    for i, m in enumerate(lengths):
        samples[i, :m] = (0.1 * rng.randn(m)).astype(np.float32)
    labels = np.zeros((n, 6), np.int32)
    for i in range(n):
        k = rng.randint(2, 7)
        labels[i, :k] = rng.choice(np.arange(1, 29), k, replace=False)
    return samples, labels, lengths


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            gv = g[k] if k != "input" or not isinstance(g[k], tuple) \
                else g[k]
            for a, b in zip(*(v if isinstance(v, tuple) else (v,)
                              for v in (gv, w[k]))):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=k)


@pytest.mark.parametrize("bucketed", [False, True])
def test_load_asr_train_set_equals_jax(bucketed):
    """Plain (fixed ``utt_length``) and bucketed batches, two epochs (the
    second reshuffled from ``seed + 1``), equal to the JAX package's, and
    the first epoch's again from ``worker_processes=2``."""
    samples, labels, lengths = _waves(20, 0)
    kw = (dict(sample_lengths=lengths, bucket_edges=[30, 45, 60])
          if bucketed else dict(utt_length=50))
    port = pipe.load_asr_train_set(samples, labels, batch_size=3, seed=7,
                                   **kw)
    ref = jax_pipe.load_asr_train_set(samples, labels, batch_size=3, seed=7,
                                      **kw)
    for _ in range(2):
        _assert_batches_equal(list(port), list(ref))
    with pytest.raises(ValueError, match="bucket_edges"):
        pipe.load_asr_train_set(samples, labels, sample_lengths=lengths,
                                bucket_edges=[30])
    # the multiprocess loader: the same batches from two forked workers
    forked = pipe.load_asr_train_set(samples, labels, batch_size=3, seed=7,
                                     worker_processes=2, **kw)
    _assert_batches_equal(list(forked), list(jax_pipe.load_asr_train_set(
        samples, labels, batch_size=3, seed=7, **kw)))


def test_train_ds2_matches_jax(monkeypatch):
    """Three steps of ``train_ds2`` (Adam 3e-4, CTC, bucketed batches of
    8) on a tiny DS2 (hidden 16, 1 layer) from bridged weights: the loss
    of every step and the final parameters and batch statistics against
    the JAX package's ``train_ds2`` (its blocked engine; the port's
    "pallas" engine, the plain K3/K4 here)."""
    samples, labels, lengths = _waves(24, 1)
    kw = dict(sample_lengths=lengths, bucket_edges=[60], batch_size=8,
              seed=3)
    jmodel = jax_pipe.make_ds2_model(hidden=16, n_rnn_layers=1,
                                     rnn_engine="blocked", utt_length=60)
    model = DeepSpeech2(hidden=16, n_rnn_layers=1, rnn_engine="pallas",
                        device="cpu")
    model.load_state_dict(flax_variables_to_state_dict(jmodel.variables,
                                                       model))
    init = jax.tree_util.tree_map(np.asarray, jmodel.variables)
    seen = {}

    class Losses:
        def __init__(self):
            self.values = []

        def add_scalar(self, tag, value, step):
            if tag == "Loss":
                self.values.append(float(value))

    for mod, key in ((jax_train, "jax"), (train, "port")):
        run = mod.Optimizer.optimize

        def optimize(self, run=run, key=key):
            seen[key] = self
            if key == "jax":
                self.train_summary = Losses()
            return run(self)

        monkeypatch.setattr(mod.Optimizer, "optimize", optimize)
    jax_pipe.train_ds2(jmodel, jax_pipe.load_asr_train_set(samples, labels,
                                                           **kw), epochs=1)
    pipe.train_ds2(model, pipe.load_asr_train_set(samples, labels, **kw),
                   epochs=1)
    j_losses = seen["jax"].train_summary.values
    losses = [m["loss"].item() for m in seen["port"].history]
    assert len(losses) == len(j_losses) == 3
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    got = state_dict_to_flax(model.state_dict(), init)
    want = {c: flatten_params(jmodel.variables[c])
            for c in ("params", "batch_stats")}
    start = flatten_params(init["params"])
    for coll, leaves in want.items():
        for k, v in leaves.items():
            atol = (2 * 3e-4 * 3 if k in BEFORE_BN
                    else 0.2 * 3e-4 * 3 if k in AFTER_BIAS else 1e-5)
            np.testing.assert_allclose(got[coll][k], np.asarray(v),
                                       atol=atol, err_msg=k)
    # the parameters moved: the comparison is not of two untrained models
    assert np.abs(got["params"]["fc_out/kernel"]
                  - start["fc_out/kernel"]).max() > 1e-4
