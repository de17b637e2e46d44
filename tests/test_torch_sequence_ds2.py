"""The sequence-parallel DeepSpeech2 of the port
(``models/deepspeech2.py::sequence_parallel_forward``,
``train_ds2(sequence_parallel=True)``,
``DeepSpeech2Pipeline(sequence_mesh=)``) over gloo ranks against the JAX
package, at hidden 16 with the blocked engine.

One group of four spawned ranks (``torch_dist_scenarios``, no JAX) runs:
the eval forward on a (4,) ``("sequence",)`` mesh and on a (2, 2)
``("data", "sequence")`` mesh (held to the reference's
``sequence_parallel_forward`` on meshes of the same shapes, 1e-4
relative); one train step through ``make_sequence_parallel_forward_fn``
on (2, 2) (the CTC loss, every gradient and the batch statistics, held
to the reference's one-device train-mode forward at
``tests/test_sequence_rnn.py``'s bounds: the reference's own
sequence-parallel gradient test holds its sharded forward to that same
one-device oracle); two ``train_ds2(sequence_parallel=True)`` steps on
(2, 2) against the JAX package's ``train_ds2`` (losses 1e-5 relative,
the parameters as ``test_torch_ds2_train.py`` holds a DS2 run);
``DeepSpeech2Pipeline(sequence_mesh=)`` on (2, 2) (a short last batch
padded over the data axis) with transcripts EQUAL to the JAX package's
pipeline; the refusals' messages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_scenarios as sc
from analytics_zoo_tpu.core.criterion import CTCCriterion as JaxCTC
from analytics_zoo_tpu.models import deepspeech2 as jds2
from analytics_zoo_tpu.parallel import create_mesh
from analytics_zoo_tpu.parallel import train as jax_train
from analytics_zoo_tpu.pipelines import deepspeech2 as jax_pipe
from analytics_zoo_tpu_torch.models.deepspeech2 import DeepSpeech2
from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe
from analytics_zoo_tpu_torch.utils import convert

WORLD = 4
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-3, 5e-5
STAT_RTOL, STAT_ATOL = 1e-4, 1e-6
LR, STEPS = 3e-4, 2
BEFORE_BN = ("conv1/bias", "proj0/bias", "proj1/bias")
AFTER_BIAS = ("bn_conv1/BatchNorm_0/mean", "bn_rnn0/BatchNorm_0/mean",
              "bn_rnn1/BatchNorm_0/mean")
ONE, TWO = ((4,), ("sequence",)), ((2, 2), ("data", "sequence"))


def _jax_ds2(hidden, layers, T, seed=0):
    """A flax DS2 with random batch statistics (so eval reads them)."""
    module = jds2.DeepSpeech2(hidden=hidden, n_rnn_layers=layers,
                              rnn_engine="blocked")
    variables = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, T, 13)))
    rng = np.random.RandomState(seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) + 0.5),
        variables["batch_stats"])
    return module, {"params": variables["params"], "batch_stats": stats}


def _weights(variables, hidden, layers):
    port = DeepSpeech2(hidden=hidden, n_rnn_layers=layers, device="cpu")
    return {k: v.numpy() for k, v in
            convert.ds2_params_from_jax(variables, port).items()}


def _x(B, T, seed):
    return np.random.RandomState(seed).randn(B, T, 13).astype(np.float32)


def _batch(seed, B=4, T=64, L=5):
    rng = np.random.RandomState(seed)
    n_label = rng.randint(2, L + 1, B)
    labels = np.zeros((B, L), np.int32)
    for i, k in enumerate(n_label):
        labels[i, :k] = rng.randint(1, 29, k)
    return {"input": rng.randn(B, T, 13).astype(np.float32),
            "labels": labels,
            "label_mask": (labels > 0).astype(np.float32)}


UTTS = {k: np.random.RandomState(i).randn(n).astype(np.float32) * 0.1
        for i, (k, n) in enumerate((("a", 16000), ("b", 24000),
                                    ("c", 9000)))}
PIPE_PARAM = {"segment_seconds": 1, "batch_size": 2}
# the forwards, the training run and the pipeline share one 1-layer
# model (flax's parameters do not depend on T); the step's has 2 layers
MODELS = {"fwd1": 1, "fwd2": 1, "train": 1, "pipe": 1, "step": 2}


@functools.lru_cache(maxsize=None)
def _init(layers):
    return _jax_ds2(16, layers, 64, seed=layers)


def _model(key):
    return _init(MODELS[key])


@pytest.fixture(scope="module")
def ranks():
    def w(key):
        return dict(weights=_weights(_model(key)[1], 16, MODELS[key]),
                    hidden=16, layers=MODELS[key])

    train_w = w("train")
    scenarios = {
        "fwd1": ("ds2_seq_forward", dict(**w("fwd1"), x=_x(2, 96, 3),
                                         shape=ONE[0], axes=ONE[1],
                                         batch_axis=None)),
        "fwd2": ("ds2_seq_forward", dict(**w("fwd2"), x=_x(4, 64, 4),
                                         shape=TWO[0], axes=TWO[1],
                                         batch_axis="data")),
        "step": ("ds2_seq_step", dict(**w("step"), batch=_batch(7),
                                      shape=TWO[0], axes=TWO[1])),
        "train": ("ds2_train", dict(
            weights=train_w["weights"], hidden=16, layers=1,
            batches=[_batch(11), _batch(12)], shape=TWO[0], axes=TWO[1],
            rules=False, lr=LR, sequence_parallel=True)),
        "pipe": ("ds2_seq_pipeline", dict(**w("pipe"), utts=UTTS,
                                          param_kw=PIPE_PARAM,
                                          shape=TWO[0], axes=TWO[1])),
        "refuse": ("ds2_seq_refusals", dict(**w("fwd2"))),
    }
    return sc.spawn_async(WORLD, scenarios)


@pytest.mark.parametrize("key", ["fwd1", "fwd2"])
def test_sequence_parallel_forward_matches_reference(ranks, key):
    """The eval forward on a (4,) sequence mesh (T 96) and a (2, 2) data
    × sequence mesh (T 64, each data rank its rows): every rank's
    log-probs within 1e-4 relative of the reference's
    ``sequence_parallel_forward`` on a mesh of the same shape."""
    module, variables = _model(key)
    shape, axes = (ONE if key == "fwd1" else TWO)
    x = _x(2, 96, 3) if key == "fwd1" else _x(4, 64, 4)
    jm = create_mesh(shape, axis_names=axes,
                     devices=jax.devices()[:int(np.prod(shape))])
    want = np.asarray(jds2.sequence_parallel_forward(
        variables, jnp.asarray(x), jm, model=module,
        batch_axis=None if key == "fwd1" else "data"))
    for r in ranks.result():
        start, per = r[key]["rows"]
        np.testing.assert_allclose(r[key]["out"], want[start:start + per],
                                   rtol=FWD_RTOL, atol=FWD_ATOL)


def test_train_step_bn_statistics_and_gradients(ranks):
    """One train step through ``make_sequence_parallel_forward_fn`` on a
    (2, 2) data × sequence mesh (global-batch BN statistics summed over
    both axes, the carries' cotangents hopping back a rank a round, the
    gathered log-probs' cotangent split by block): the CTC loss within
    1e-5, every parameter's gradient (averaged over the data ranks, each
    sequence rank holding it whole) within ``rtol=5e-3, atol=5e-5``, and
    the running statistics within ``rtol=1e-4, atol=1e-6`` of the
    reference's one-device train-mode step — on every rank alike."""
    module, variables = _model("step")
    b = _batch(7)
    ctc = JaxCTC(blank_id=0)

    def loss_fn(params):
        out, new = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(b["input"]), train=True, mutable=["batch_stats"])
        return ctc(out, jnp.asarray(b["labels"]),
                   label_mask=jnp.asarray(b["label_mask"])), new
    (loss, new), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    got = [r["step"] for r in ranks.result()]
    for r in got:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=LOSS_RTOL)
        g = convert.state_dict_to_flax(
            {k: torch.from_numpy(v) for k, v in r["grads"].items()},
            {"params": variables["params"]})["params"]
        for k, v in convert.flatten_params(grads).items():
            np.testing.assert_allclose(g[k], np.asarray(v), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=k)
        s = convert.state_dict_to_flax(
            {k: torch.from_numpy(v) for k, v in r["stats"].items()},
            {"batch_stats": variables["batch_stats"]})["batch_stats"]
        for k, v in convert.flatten_params(new["batch_stats"]).items():
            np.testing.assert_allclose(s[k], np.asarray(v), rtol=STAT_RTOL,
                                       atol=STAT_ATOL, err_msg=k)
        for k, v in r["grads"].items():
            np.testing.assert_array_equal(v, got[0]["grads"][k], err_msg=k)


def test_train_ds2_sequence_parallel_matches_jax(ranks, monkeypatch):
    """Two ``train_ds2(sequence_parallel=True)`` steps on (2, 2): the
    losses within 1e-5 relative and the parameters and batch statistics
    as ``test_torch_ds2_train.py`` holds a DS2 run, against the JAX
    package's ``train_ds2`` on the same batches (its sequence-parallel
    step computes the one-device step)."""
    _, variables = _model("train")
    variables = jax.tree_util.tree_map(np.asarray, variables)
    jmodel = jax_pipe.make_ds2_model(hidden=16, n_rnn_layers=1,
                                     rnn_engine="blocked", utt_length=64)
    # the step donates its buffers: the JAX model gets copies
    jmodel.variables = jax.tree_util.tree_map(jnp.array, variables)
    seen = []

    class Losses:
        def __init__(self):
            self.values = []

        def add_scalar(self, tag, value, step):
            if tag == "Loss":
                self.values.append(float(value))

    base = jax_train.Optimizer.optimize

    def optimize(self):
        self.train_summary = Losses()
        seen.append(self)
        return base(self)

    monkeypatch.setattr(jax_train.Optimizer, "optimize", optimize)
    jax_pipe.train_ds2(jmodel, [_batch(11), _batch(12)], epochs=1, lr=LR,
                       mesh=create_mesh((1,), devices=jax.devices()[:1]))
    want = seen[0].train_summary.values
    got = [r["train"] for r in ranks.result()]
    assert len(want) == STEPS
    for r in got:
        np.testing.assert_allclose(r["losses"], want, rtol=LOSS_RTOL)
    state = convert.state_dict_to_flax(
        {k: torch.from_numpy(v) for k, v in got[0]["state"].items()},
        variables)
    for coll in ("params", "batch_stats"):
        for k, v in convert.flatten_params(jmodel.variables[coll]).items():
            atol = (2 * LR * STEPS if k in BEFORE_BN
                    else 0.2 * LR * STEPS if k in AFTER_BIAS else 1e-5)
            np.testing.assert_allclose(state[coll][k], np.asarray(v),
                                       atol=atol, err_msg=k)
    for r in got[1:]:
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, got[0]["state"][k], err_msg=k)


def test_pipeline_with_sequence_mesh_matches_jax(ranks):
    """``DeepSpeech2Pipeline(sequence_mesh=)`` on (2, 2): ``utt_length``
    100 (already a multiple of 2·n_seq), three utterances of 1, 1.5 and
    0.56 s in batches of 2 (the last padded over the data axis): the
    transcripts EQUAL to the JAX package's pipeline on the same weights,
    on every rank."""
    _, variables = _model("pipe")
    jmodel = jax_pipe.make_ds2_model(hidden=16, n_rnn_layers=1,
                                     rnn_engine="blocked", utt_length=100)
    jmodel.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    want = jax_pipe.DeepSpeech2Pipeline(
        jmodel, jax_pipe.DS2Param(**PIPE_PARAM)).transcribe_samples(UTTS)
    for r in ranks.result():
        assert r["pipe"]["utt_length"] == 100
        assert r["pipe"]["texts"] == want


def test_refusals(ranks):
    """A T that 2·n_seq does not divide, length-bucketed batches and a
    mesh without a ``sequence`` axis raise with the reference's
    messages; so do ``train_ds2(sequence_parallel=True)`` without a mesh
    and a ``sequence_mesh`` without the axis."""
    for r in ranks.result():
        msgs = r["refuse"]
        assert "must be divisible by 2·n_seq=8" in msgs["odd_t"]
        assert "length-bucketed" in msgs["bucketed"]
        assert "needs a mesh with a 'sequence' axis" in msgs["no_axis"]
    model = DeepSpeech2(hidden=8, n_rnn_layers=1, device="cpu")
    with pytest.raises(ValueError, match="'sequence' axis, got None"):
        pipe.train_ds2(model, [], sequence_parallel=True)
    with pytest.raises(ValueError, match="needs a 'sequence' axis"):
        pipe.DeepSpeech2Pipeline(model, sequence_mesh=sc.StubMesh(
            {"data": 2}), device="cpu")
