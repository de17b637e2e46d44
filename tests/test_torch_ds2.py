"""Parity of the port's DeepSpeech2 serving slice with the JAX package, on
the CPU: the audio chain, the decoders, the weight bridge, the model
forward and the pipeline, on tiny seeded models (hidden 16–32, 1–2
layers).

Tolerances: host featurize and the decoders are the same numpy code, so
they are compared exactly; the device featurizer within 1e-4 (another
FFT library on the same frames, then a log); the forward's log-probs
within 1e-4 (the same fp32 ops in another summation order through the
conv, three projections and the recurrences).
"""

import wave

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core.module import Model
from analytics_zoo_tpu.models.deepspeech2 import DeepSpeech2 as JaxDS2
from analytics_zoo_tpu.pipelines import deepspeech2 as jax_pipe
from analytics_zoo_tpu.transform import audio as jax_audio
from analytics_zoo_tpu.transform.audio.decoders import (
    ids_to_text as jax_ids_to_text)
from analytics_zoo_tpu_torch.models.deepspeech2 import DeepSpeech2, SequenceBN
from analytics_zoo_tpu_torch.parallel.train import make_eval_step
from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe
from analytics_zoo_tpu_torch.transform import audio
from analytics_zoo_tpu_torch.utils.convert import ds2_params_from_jax
from torch_dist_scenarios import StubMesh

torch.set_num_threads(2)

LOGP_ATOL = 1e-4


def _noise(seed, n):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    return (0.05 * rng.randn(n) + 0.2 * np.sin(2 * np.pi * 440.0 * t)
            ).astype(np.float32)


# -- audio chain -------------------------------------------------------------

@pytest.mark.parametrize("n,utt", [(16000, None), (16000, 120), (5000, 100),
                                   (300, 10)])
def test_host_featurize_equals_jax(n, utt):
    x = _noise(n, n)
    np.testing.assert_array_equal(audio.featurize(x, utt_length=utt),
                                  jax_audio.featurize(x, utt_length=utt))


def test_filterbank_and_frames_equal_jax():
    np.testing.assert_array_equal(audio.mel_filterbank_matrix(),
                                  jax_audio.mel_filterbank_matrix())
    x = _noise(1, 4000)
    np.testing.assert_array_equal(audio.frame_signal(x),
                                  jax_audio.frame_signal(x))
    seg, jseg = (m.TimeSegmenter(segment_size=7000).segment(x, "a")
                 for m in (audio, jax_audio))
    assert [(s["audio_id"], s["audio_seq"]) for s in seg] == \
        [(s["audio_id"], s["audio_seq"]) for s in jseg]
    for s, js in zip(seg, jseg):
        np.testing.assert_array_equal(s["samples"], js["samples"])


def test_device_featurizer_matches_jax():
    S = 16000
    batch = np.zeros((3, S), np.float32)
    n_valid = np.array([S, 9000, 250], np.int32)
    for i, n in enumerate(n_valid):
        batch[i, :n] = _noise(10 + i, n)
    got = audio.make_featurizer_device(S, utt_length=110, device="cpu")(
        batch, n_valid)
    want = jax_audio.make_featurizer_device(S, utt_length=110)(batch, n_valid)
    assert got.shape == (3, 110, 13) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_device_featurizer_default_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        audio.make_featurizer_device(16000)


# -- decoders and readers ----------------------------------------------------

def test_decoders_equal_jax():
    rng = np.random.RandomState(0)
    for seed in range(4):
        lp = np.log(np.random.RandomState(seed).dirichlet(
            np.ones(29) * 0.3, size=14)).astype(np.float32)
        assert audio.best_path_decode(lp) == jax_audio.best_path_decode(lp)
        for width in (1, 4, 16):
            assert audio.beam_search_decode(lp, beam_width=width) == \
                jax_audio.beam_search_decode(lp, beam_width=width)
        ids = rng.randint(0, 29, 20)
        assert audio.ids_to_text(ids) == jax_ids_to_text(ids)
    pairs = [("THE CAT SAT", "THE BAT SAT ON"), ("", "A"), ("A B", "")]
    for ref, hyp in pairs:
        assert audio.wer(ref, hyp) == jax_audio.wer(ref, hyp)
        assert audio.cer(ref, hyp) == jax_audio.cer(ref, hyp)
        assert audio.levenshtein(ref, hyp) == jax_audio.levenshtein(ref, hyp)
    vocab = ["hello", "world", "speech"]
    for text in ("HELO WRLD SPEECH", "XYZZY SPEACH"):
        assert audio.VocabDecoder(vocab)(text) == \
            jax_audio.VocabDecoder(vocab)(text)
    ev, jev = audio.ASREvaluator(), jax_audio.ASREvaluator()
    for ref, hyp in pairs:
        ev.add(ref, hyp)
        jev.add(ref, hyp)
    assert (ev.wer, ev.cer) == (jev.wer, jev.cer)
    assert audio.ALPHABET == jax_audio.ALPHABET
    assert audio.BLANK_ID == jax_audio.BLANK_ID


@pytest.mark.parametrize("width,channels", [(2, 1), (2, 2), (1, 1), (4, 1)])
def test_read_wav_equals_jax(tmp_path, width, channels):
    rng = np.random.RandomState(width * 10 + channels)
    raw = rng.randint(0, 256, 800 * width * channels).astype(np.uint8)
    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(16000)
        w.writeframes(raw.tobytes())
    got, rate = audio.read_audio(path)
    want, jrate = jax_audio.read_audio(path)
    assert rate == jrate == 16000
    np.testing.assert_array_equal(got, want)


# -- weight bridge and forward -----------------------------------------------

def _jax_ds2(hidden, layers, T, bidirectional=True, seed=0):
    """A flax DS2 with random running statistics, so that every BN does
    work; initialized once a module for each set of arguments (each call
    gets its own containers over the same immutable arrays)."""
    module, variables = _jax_ds2_init(hidden, layers, T, bidirectional, seed)
    return module, jax.tree_util.tree_map(lambda a: a, variables)


@functools.lru_cache(maxsize=None)
def _jax_ds2_init(hidden, layers, T, bidirectional, seed):
    module = JaxDS2(hidden=hidden, n_rnn_layers=layers,
                    bidirectional=bidirectional, rnn_engine="blocked")
    kw = {} if bidirectional else {"return_carry": True}
    variables = module.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, T, 13)), **kw)
    rng = np.random.RandomState(seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) + 0.5),
        variables["batch_stats"])
    return module, {"params": variables["params"], "batch_stats": stats}


def _port(variables, hidden, layers, engine, bidirectional=True):
    model = DeepSpeech2(hidden=hidden, n_rnn_layers=layers,
                        bidirectional=bidirectional, rnn_engine=engine,
                        device="cpu")
    model.load_state_dict(ds2_params_from_jax(variables, model))
    return model


def _feats(seed, B, T):
    return np.random.RandomState(seed).randn(B, T, 13).astype(np.float32)


@pytest.mark.parametrize("engine", ["blocked", "pallas"])
@pytest.mark.parametrize("hidden,layers", [(16, 1), (32, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_ds2_forward_matches_jax(hidden, layers, masked, engine):
    module, variables = _jax_ds2(hidden, layers, T=15)
    model = _port(variables, hidden, layers, engine)
    x = _feats(3, 3, 15)
    n = np.array([15, 9, 2], np.int32) if masked else None
    want = module.apply(variables, jnp.asarray(x), n_frames=n)
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    n_frames=None if n is None else torch.from_numpy(n))
    assert got.shape == (3, 8, 29)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGP_ATOL)


@pytest.mark.parametrize("engine", ["blocked", "pallas"])
def test_ds2_unidirectional_carry_matches_jax(engine):
    module, variables = _jax_ds2(16, 2, T=16, bidirectional=False)
    model = _port(variables, 16, 2, engine, bidirectional=False)
    rng = np.random.RandomState(4)
    carry = tuple(rng.randn(2, 16).astype(np.float32) for _ in range(2))
    x = _feats(5, 2, 16)
    want, want_c = module.apply(
        variables, jnp.asarray(x),
        carry={"h": tuple(jnp.asarray(c) for c in carry)},
        return_carry=True)
    with torch.no_grad():
        got, got_c = model(torch.from_numpy(x), carry={
            "h": tuple(torch.from_numpy(c) for c in carry)},
            return_carry=True)
    assert got.shape == want.shape == (2, 3, 29)      # VALID conv
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGP_ATOL)
    for g, w in zip(got_c["h"], want_c["h"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGP_ATOL)
    with pytest.raises(ValueError, match="bidirectional"):
        _port(_jax_ds2(16, 1, 16)[1], 16, 1, engine)(
            torch.from_numpy(x), return_carry=True)


def test_bridge_uses_every_leaf_once():
    _, variables = _jax_ds2(16, 2, T=15)
    model = DeepSpeech2(hidden=16, n_rnn_layers=2, device="cpu")
    sd = ds2_params_from_jax(variables, model)
    n_leaves = sum(len(jax.tree_util.tree_leaves(variables[c]))
                   for c in ("params", "batch_stats"))
    assert len(sd) == n_leaves == len(model.state_dict())
    extra = {"params": {**variables["params"],
                        "spare": {"kernel": np.zeros((2, 2))}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="spare"):
        ds2_params_from_jax(extra, model)
    params = dict(variables["params"])
    params.pop("fc_out")
    with pytest.raises(KeyError, match="fc_out"):
        ds2_params_from_jax({"params": params,
                             "batch_stats": variables["batch_stats"]}, model)
    wide = DeepSpeech2(hidden=32, n_rnn_layers=2, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        ds2_params_from_jax(variables, wide)


def test_init_follows_flax_distributions():
    model = DeepSpeech2(hidden=64, n_rnn_layers=1, device="cpu", seed=0)
    w = model.birnn0.fwd.body.h2h.weight
    assert abs(w.std().item() - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert w.abs().max().item() <= 2 * 64 ** -0.5 / 0.87962566103423978
    assert not torch.equal(w, model.birnn0.bwd.body.h2h.weight)
    assert torch.equal(model.bn_rnn0.running_var, torch.ones(64))
    again = DeepSpeech2(hidden=64, n_rnn_layers=1, device="cpu", seed=0)
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    # train mode: batch statistics over the valid frames only (the
    # padded frame's 100 counts nowhere), running ones moved by 0.1
    bn = SequenceBN(4).train()
    x = torch.tensor([[[1.0], [3.0], [100.0]]]).expand(1, 3, 4)
    y = bn(x, torch.tensor([[[True], [True], [False]]]))
    torch.testing.assert_close(y[0, :2], torch.tensor(
        [[-1.0], [1.0]]).expand(2, 4) / np.sqrt(1.0 + 1e-5))
    torch.testing.assert_close(bn.running_mean, torch.full((4,), 0.2))
    torch.testing.assert_close(bn.running_var, torch.full((4,), 1.0))


@pytest.mark.parametrize("engine", ["blocked", "pallas"])
def test_eval_step_bf16_returns_one_fp32_tensor(engine):
    """DS2 returns one tensor of log-probs: under compute_dtype="bf16" it
    comes back as that tensor in fp32, not split into batch rows.  bf16
    activations keep ~3 digits, so it stays within 0.1 of the fp32
    forward."""
    model = DeepSpeech2(hidden=32, n_rnn_layers=2, rnn_engine=engine,
                        device="cpu")
    x = torch.from_numpy(_feats(6, 3, 30))
    out = make_eval_step(model, compute_dtype="bf16")(x)
    assert isinstance(out, torch.Tensor)
    assert out.dtype == torch.float32 and out.shape == (3, 15, 29)
    ref = make_eval_step(model)(x)
    assert (out - ref).abs().max().item() < 0.1


# -- pipeline ----------------------------------------------------------------

def _pipelines(param_kw, engine="pallas"):
    """The JAX pipeline and the port's around one bridged tiny model."""
    module, variables = _jax_ds2(16, 2, T=100, seed=2)
    jmodel = Model(module, variables)
    model = _port(variables, 16, 2, engine)
    return (jax_pipe.DeepSpeech2Pipeline(jmodel,
                                         jax_pipe.DS2Param(**param_kw)),
            pipe.DeepSpeech2Pipeline(model, pipe.DS2Param(**param_kw),
                                     device="cpu"))


UTTS = {"a": _noise(20, 40000), "b": _noise(21, 9000), "c": _noise(22, 16000)}


@pytest.mark.parametrize("kw", [
    {},                                             # fused greedy
    {"device_featurize": False},                    # host featurize, split
    {"decoder": "beam", "beam_width": 4},           # device featurize, beam
])
def test_transcribe_samples_matches_jax(kw):
    param_kw = {"segment_seconds": 1, "batch_size": 2, **kw}
    jp, tp = _pipelines(param_kw)
    assert tp.transcribe_samples(UTTS) == jp.transcribe_samples(UTTS)
    # log-probs of one featurized batch
    segs = [s for a, u in UTTS.items() for s in tp.segmenter.segment(u, a)]
    batch, n_valid = tp._pack_batch(segs[:2])
    feats = tp._make_featurizer()(batch, n_valid)
    want = jp._eval_step(jp.model.variables, jnp.asarray(feats.numpy()))
    np.testing.assert_allclose(tp._eval_step(feats).numpy(),
                               np.asarray(want), atol=LOGP_ATOL)


def test_pipeline_files_evaluate_and_mesh(tmp_path):
    _, tp = _pipelines({"segment_seconds": 1, "batch_size": 2})
    path = str(tmp_path / "u.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((UTTS["b"] * 32767).astype(np.int16).tobytes())
    out = tp.transcribe_files([path])
    assert list(out) == [path] and set(out[path]) <= set(audio.ALPHABET)
    ev = tp.evaluate(UTTS, {"a": "hello", "b": "", "c": "speech"})
    assert 0.0 <= ev.cer and ev.words == 2
    # a sequence mesh needs the axis (tests/test_torch_sequence_ds2.py)
    with pytest.raises(ValueError, match="needs a 'sequence' axis"):
        pipe.DeepSpeech2Pipeline(tp.model, sequence_mesh=StubMesh(
            {"data": 1}), device="cpu")
    assert tp.transcribe_samples({}) == {}


def test_make_ds2_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipe.make_ds2_model(hidden=16, n_rnn_layers=1)
    model = pipe.make_ds2_model(hidden=16, n_rnn_layers=1, device="cpu",
                                rnn_engine="pallas", seed=3)
    assert model.rnn_engine == "pallas" and not model.training
