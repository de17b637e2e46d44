"""The port's DeepSpeech2 online serving against the JAX package's, on the
CPU, on bridged weights (``utils/convert.py::ds2_params_from_jax``) of
tiny models (hidden 16, 1-2 layers).

- ``StreamingDS2``: the port's against the reference's on the chunk plans
  of ``tests/test_streaming_ds2.py``, each piece equal and the log-probs
  within ``rtol=1e-4, atol=1e-5`` (the reference's own bound), through the
  "blocked" loop and the "pallas" engine (K3's plain version here); the
  port's streamed log-probs against its own whole-utterance forward (the
  exactness contract); the guards and their messages.
- ``ds2_serving_tiers``: names, speeds, notes and the ladder as the
  reference's; the same featurized requests through both runtimes on a
  ``VirtualClock`` with one ``service_time``: each request's state and
  tier equal, and each transcript equal to the reference model's forward
  of that row with its ``n_frames`` (the port masks a row's padding; the
  reference's tier forwards it unmasked, so the two runtimes' transcripts
  are equal where a row fills its bucket).
- ``ds2_streaming_tiers`` in the multiplexed runtime: the scenario of
  ``tests/test_streaming_ds2.py``'s session test through both packages,
  the served pieces equal, and equal to a direct ``StreamingDS2``.
- ``NGramDecoder``, ``TranscriptVectorizer``, ``evaluate_ctc_decoders``
  and ``transpose_flip`` equal to the reference's on seeded inputs.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.serving as jserving
from analytics_zoo_tpu.core.module import Model
from analytics_zoo_tpu.pipelines import deepspeech2 as jax_pipe
from analytics_zoo_tpu.transform import audio as jax_audio
import analytics_zoo_tpu_torch.serving as tserving
from analytics_zoo_tpu_torch.models.deepspeech2 import ds2_valid_out_frames
from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe
from analytics_zoo_tpu_torch.transform import audio
from test_torch_ds2 import _jax_ds2, _noise, _port

torch.set_num_threads(2)

# the reference's streaming bound (tests/test_streaming_ds2.py)
STREAM_RTOL, STREAM_ATOL = 1e-4, 1e-5
CHUNK_PLANS = [
    [16000, 16000],                       # regular 1 s chunks
    [3000, 7000, 12000, 5000, 5000],      # irregular
    [400, 1600, 30000],                   # tiny first feed
]


@functools.lru_cache(maxsize=None)
def _models(layers, engine, bidirectional=False, seed=0):
    """The reference's model and the port's on the same weights, built
    once a module for each set of arguments (no test changes either)."""
    module, variables = _jax_ds2(16, layers, T=50,
                                 bidirectional=bidirectional, seed=seed)
    return (Model(module, variables),
            _port(variables, 16, layers, engine,
                  bidirectional=bidirectional))


def _stream(stream, samples, plan):
    pieces, pos = [], 0
    for c in plan:
        pieces.append(stream.accept(samples[pos:pos + c]))
        pos += c
    pieces.append(stream.flush())
    return pieces


# -- StreamingDS2 --------------------------------------------------------------

@pytest.mark.parametrize("engine", ["blocked", "pallas"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("plan", CHUNK_PLANS, ids=["regular", "irregular",
                                                   "tiny_first"])
def test_streaming_equal_to_reference(plan, layers, engine):
    jmodel, model = _models(layers, engine)
    samples = _noise(30 + layers, sum(plan))
    ref = jax_pipe.StreamingDS2(jmodel, keep_log_probs=True)
    got = pipe.StreamingDS2(model, keep_log_probs=True, device="cpu")
    assert _stream(got, samples, plan) == _stream(ref, samples, plan)
    assert got.transcript == ref.transcript
    assert got.log_probs.shape == ref.log_probs.shape
    np.testing.assert_allclose(got.log_probs, ref.log_probs,
                               rtol=STREAM_RTOL, atol=STREAM_ATOL)
    # the exactness contract, on the port alone: the streamed log-probs
    # are the whole utterance's forward
    with torch.no_grad():
        whole = model(torch.from_numpy(audio.featurize(samples)[None]))[0]
    assert got.log_probs.shape == tuple(whole.shape)
    np.testing.assert_allclose(got.log_probs, whole.numpy(),
                               rtol=STREAM_RTOL, atol=STREAM_ATOL)
    assert got.transcript == audio.best_path_decode(whole.numpy())


def test_streaming_guards_and_messages():
    jmodel, model = _models(1, "pallas")
    bi = _models(1, "pallas", bidirectional=True)
    for stream_cls, m, b in ((pipe.StreamingDS2, model, bi[1]),
                             (jax_pipe.StreamingDS2, jmodel, bi[0])):
        kw = {"device": "cpu"} if stream_cls is pipe.StreamingDS2 else {}
        with pytest.raises(ValueError, match="bidirectional=False"):
            stream_cls(b, **kw)
        for bad in (7, 4):
            with pytest.raises(ValueError, match="even and >= 6"):
                stream_cls(m, chunk_frames=bad, **kw)
        stream = stream_cls(m, **kw)
        stream.accept(np.zeros(16000, np.float32))
        stream.flush()
        with pytest.raises(RuntimeError, match="call reset"):
            stream.accept(np.zeros(1000, np.float32))
        assert stream.flush() == ""          # idempotent


def test_streaming_reset_reuse_and_block_shapes():
    """``reset`` gives the same stream again, and the forward sees at most
    three block shapes (first, steady, flush), as the reference's
    jitted apply compiles."""
    _, model = _models(1, "pallas")
    s1 = _noise(40, 16000)
    stream = pipe.StreamingDS2(model, keep_log_probs=True, device="cpu")
    stream.accept(s1)
    stream.flush()
    t1, lp1 = stream.transcript, stream.log_probs
    stream.reset()
    stream.accept(s1)
    stream.flush()
    assert stream.transcript == t1
    np.testing.assert_array_equal(stream.log_probs, lp1)

    stream = pipe.StreamingDS2(model, chunk_frames=20, device="cpu")
    shapes = []
    orig = stream._apply

    def spy(x, c):
        shapes.append(tuple(x.shape))
        return orig(x, c)

    stream._apply = spy
    rng = np.random.RandomState(3)
    for c in (5000, 9000, 20000, 3000, 12000):
        stream.accept((rng.randn(c) * 0.1).astype(np.float32))
    stream.flush()
    assert set(shapes) == {(1, 25, 13), (1, 29, 13), (1, 34, 13)}


# -- ds2_serving_tiers -----------------------------------------------------------

_TIER_PAIRS = {}


def _tier_pairs(param_kw, layers=2):
    """Both packages' ladders for ``param_kw``, built once a module for
    each (a runtime only calls a rung's forward, so the cases of one
    ladder share its rungs and the reference's compiled programs)."""
    key = (tuple(sorted(param_kw.items())), layers)
    if key not in _TIER_PAIRS:
        jmodel, model = _models(layers, "pallas", bidirectional=True,
                                seed=2)
        ref = jax_pipe.ds2_serving_tiers(jmodel,
                                         jax_pipe.DS2Param(**param_kw))
        got = pipe.ds2_serving_tiers(model, pipe.DS2Param(**param_kw),
                                     device="cpu")
        _TIER_PAIRS[key] = (jmodel, model, ref, got)
    return _TIER_PAIRS[key]


@pytest.mark.parametrize("param_kw", [
    {"decoder": "beam", "beam_width": 16}, {"decoder": "beam",
                                            "beam_width": 8},
    {"decoder": "greedy"}], ids=["beam16", "beam8", "greedy"])
def test_serving_tiers_describe_the_reference_ladder(param_kw):
    _, model, ref, got = _tier_pairs(param_kw)
    assert [(t.name, t.speed, t.quality_note) for t in got] == [
        (t.name, t.speed, t.quality_note) for t in ref]
    fn, args = got[0].device_program()
    assert tuple(fn(*args).shape) == (1, 32, 29)
    # specs= is served (item 12b.4): over a one-rank mesh, the same rungs
    import torch_dist_scenarios as sc
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    sharded = pipe.ds2_serving_tiers(model, pipe.DS2Param(**param_kw),
                                     specs=SpecSet(sc.StubMesh({"data": 1})),
                                     device="cpu")
    assert [t.name for t in sharded] == [t.name for t in got]
    fn, args = sharded[0].device_program()
    assert tuple(fn(*args).shape) == (1, 32, 29)
    assert [t.name for t in pipe.ds2_serving_tiers(
        model, pipe.DS2Param(decoder="beam"), degraded_beam=2,
        device="cpu")] == ["beam16", "beam2", "greedy"]


EDGES = [40, 80, 120]


def _utterances(seed, n):
    """Featurized seeded utterances of 0.2-1.2 s (18-118 frames), two of
    them filling their bucket edge."""
    rng = np.random.RandomState(seed)
    lengths = list(rng.randint(3200, 19000, n - 2)) + [6640, 12 * 1600 + 240]
    return [audio.featurize(_noise(100 + i, int(m)))
            for i, m in enumerate(lengths)]


def _serve(pkg, tiers, feats, service_time, tier=None, **kw):
    clock = pkg.VirtualClock()
    kw.setdefault("default_deadline_s", 0.5)
    rt = pkg.ServingRuntime(tiers, n_replicas=2, clock=clock, max_batch=4,
                            bucket_edges=EDGES, queue_capacity=64,
                            service_time=service_time, **kw)
    if tier is not None:
        rt.ladder.tier = tier
    for i, f in enumerate(feats):
        rt.submit({"input": f}, length=f.shape[0])
        clock.advance(0.01 * (i % 3))
        rt.pump()
    rt.drain()
    return rt


@functools.lru_cache(maxsize=None)
def _served_utterances(seed, n):
    """``_utterances(seed, n)`` and the reference's masked log-probs of
    them on ``_tier_pairs``' model, once a module."""
    feats = _utterances(seed, n)
    jmodel = _models(2, "pallas", bidirectional=True, seed=2)[0]
    return feats, _masked_reference(jmodel, feats)


def _masked_reference(jmodel, feats):
    """The reference model's valid log-probs of each utterance, forwarded
    with its ``n_frames`` (padded to the last edge: one program)."""
    x = np.zeros((len(feats), EDGES[-1], 13), np.float32)
    for i, f in enumerate(feats):
        x[i, :f.shape[0]] = f
    n = np.asarray([f.shape[0] for f in feats], np.int32)
    lp = np.asarray(jmodel.module.apply(jmodel.variables, jnp.asarray(x),
                                        n_frames=n))
    return [lp[i, :ds2_valid_out_frames(f.shape[0])]
            for i, f in enumerate(feats)]


@pytest.mark.parametrize("param_kw,tier", [
    ({"decoder": "greedy"}, None),
    ({"decoder": "beam", "beam_width": 8}, 0),
    ({"decoder": "beam", "beam_width": 8}, 1),
    ({"decoder": "beam", "beam_width": 8}, None),
], ids=["greedy", "beam8_forced", "beam2_forced", "beam8_ladder"])
def test_serving_tiers_through_both_runtimes(param_kw, tier):
    jmodel, model, ref_tiers, tiers = _tier_pairs(param_kw)
    feats, masked = _served_utterances(7, 14)
    # service time by edge and tier: the ladder steps down under the
    # load of the un-forced case
    st = (lambda e, n, t: (0.2 if t == 0 else 0.05) * e / 120.0)
    kw = {} if tier is not None else dict(
        decision_every=1, default_deadline_s=0.25,
        ladder_policy=tserving.LadderPolicy(down_after=1))
    jkw = {} if tier is not None else dict(
        decision_every=1, default_deadline_s=0.25,
        ladder_policy=jserving.LadderPolicy(down_after=1))
    ref = _serve(jserving, ref_tiers, feats, st, tier, **jkw)
    got = _serve(tserving, tiers, feats, st, tier, **kw)
    assert got.accounting() == ref.accounting()
    assert [(r.rid, r.state, r.tier, r.completed_t) for r in got.requests] \
        == [(r.rid, r.state, r.tier, r.completed_t) for r in ref.requests]
    assert got.ladder.events == ref.ladder.events
    if tier is None and param_kw["decoder"] == "beam":
        assert {r.tier for r in got.requests if r.state == "done"} >= {0, 1}
        assert got.accounting()["by_state"].get("timeout")
    decoders = [t.name for t in tiers]
    n_done = 0
    for f, lp, g, r in zip(feats, masked, got.requests, ref.requests):
        if g.state != "done":
            continue
        n_done += 1
        name = decoders[g.tier]
        want = (jax_audio.best_path_decode(lp) if name == "greedy" else
                jax_audio.beam_search_decode(lp, beam_width=int(name[4:])))
        assert str(g.result) == want
        if f.shape[0] in EDGES:          # no padding: the runtimes agree
            assert str(g.result) == str(r.result)
    assert n_done >= 8


def test_serving_row_equals_alone_forward():
    """Each served row's valid log-probs equal the same utterance
    forwarded alone at its own length (the port's forward masks the
    padding)."""
    _, model, _, tiers = _tier_pairs({"decoder": "greedy"})
    feats = _utterances(8, 4)
    edge = 120
    batch = np.zeros((4, edge, 13), np.float32)
    for i, f in enumerate(feats):
        batch[i, :f.shape[0]] = f
    n = np.asarray([f.shape[0] for f in feats], np.int32)
    fn, _ = tiers[0].device_program()
    lp = fn((torch.from_numpy(batch), torch.from_numpy(n))).numpy()
    for i, f in enumerate(feats):
        alone = fn((torch.from_numpy(f[None]),
                    torch.from_numpy(n[i:i + 1]))).numpy()[0]
        v = ds2_valid_out_frames(f.shape[0])
        np.testing.assert_allclose(lp[i, :v], alone[:v], rtol=0, atol=1e-5)
    texts = tiers[0].forward({"input": batch, "n_frames": n})
    assert texts == [audio.best_path_decode(lp[i, :ds2_valid_out_frames(
        f.shape[0])]) for i, f in enumerate(feats)]


# -- ds2_streaming_tiers -------------------------------------------------------

def _serve_sessions(pkg_s, stream_tiers, n_sessions, chunk, total):
    cfg = pkg_s.ModelConfig(
        name="ds2-stream", streaming=True, tiers=stream_tiers(),
        tier_factory=lambda rid: stream_tiers(), pad_key="input",
        length_key="n_samples", bucket_edges=[chunk], chunk_deadline_s=2.0)
    clock = pkg_s.VirtualClock()
    rt = pkg_s.ServingRuntime(models=[cfg], n_replicas=2, clock=clock,
                              queue_capacity=32, max_batch=4,
                              service_time=lambda m, e, n, t: 0.02)
    rng = np.random.RandomState(0)
    utts = {s: (rng.randn(total) * 0.1).astype(np.float32)
            for s in range(n_sessions)}
    sids = {s: rt.open_session("ds2-stream") for s in utts}
    reqs = {s: [] for s in utts}
    for k in range(0, total, chunk):
        for s, samples in utts.items():
            piece = samples[k:k + chunk]
            reqs[s].append(rt.submit_chunk(
                sids[s], {"input": piece}, length=len(piece),
                final=(k + chunk >= total)))
        clock.advance(0.1)
        rt.pump()
    rt.drain()
    return rt, utts, {s: [str(r.result) for r in rs]
                      for s, rs in reqs.items()}


@pytest.mark.parametrize("engine", ["blocked", "pallas"])
def test_streaming_sessions_through_both_runtimes(engine):
    jmodel, model = _models(1, engine)
    CHUNK, TOTAL = 5000, 20000
    ref_rt, utts, ref = _serve_sessions(
        jserving, lambda: jax_pipe.ds2_streaming_tiers(
            jmodel, chunk_frames=50), 3, CHUNK, TOTAL)
    got_rt, _, got = _serve_sessions(
        tserving, lambda: pipe.ds2_streaming_tiers(
            model, chunk_frames=50, device="cpu"), 3, CHUNK, TOTAL)
    assert got == ref
    assert got_rt.accounting() == ref_rt.accounting() == {
        "submitted": 12, "by_state": {"done": 12}, "terminal": 12,
        "unaccounted": 0}
    assert got_rt.snapshot()["sessions"] == {"opened": 3, "open": 0,
                                             "failed": 0}
    assert {s["replica"] for s in got_rt._sessions.values()} == set()
    for s, samples in utts.items():
        direct = pipe.StreamingDS2(model, chunk_frames=50, device="cpu")
        pieces = [direct.accept(samples[k:k + CHUNK])
                  for k in range(0, TOTAL, CHUNK)]
        pieces[-1] += direct.flush()
        assert got[s] == pieces, s
    # every replica's store is empty once the sessions are final
    for r in got_rt.pool.replicas:
        tier = r.tier_objs["ds2-stream"][0]
        fn, args = tier.device_program()
        assert tuple(fn(*args)[0].shape) == (1, 25, 29)


def test_streaming_tier_evicts_and_skips_padding():
    _, model = _models(1, "pallas")
    tier = pipe.ds2_streaming_tiers(model, chunk_frames=50,
                                    device="cpu")[0]
    x = _noise(50, 4000)
    batch = {"input": np.stack([x, np.zeros_like(x)]),
             "n_samples": np.asarray([4000, 0], np.int32),
             "session": np.asarray([5, -1], np.int64),
             "final": np.asarray([0, 0], np.int8)}
    assert tier.forward(batch)[1] == ""
    tier.evict_session(5)
    tier.evict_session(5)                 # gone already: a no-op
    batch["final"][0] = 1
    fresh = pipe.StreamingDS2(model, chunk_frames=50, device="cpu")
    want = fresh.accept(x) + fresh.flush()
    assert tier.forward(batch)[0] == want


# -- decoders and featurize --------------------------------------------------

def test_ngram_vectorizer_evaluation_and_transpose_flip_equal_reference():
    vocab = ["hello", "world", "speech", "the", "cat", "sat", "bat"]
    bigrams = [("the", "cat"), ("cat", "sat"), ("hello", "world")]
    for text in ("THE CAX SAT", "HELO WRLD SPEACH", "THE BAT", "XYZZY Q",
                 "", "THE CAT"):
        assert audio.NGramDecoder(vocab, bigrams)(text) == \
            jax_audio.NGramDecoder(vocab, bigrams)(text)
        assert audio.NGramDecoder(vocab, bigrams, max_distance=1)(text) \
            == jax_audio.NGramDecoder(vocab, bigrams, max_distance=1)(text)
    for text, length in (("hello world's", 200), ("A B?C", 3), ("", 5)):
        got = audio.TranscriptVectorizer(max_length=length)(text)
        want = jax_audio.TranscriptVectorizer(max_length=length)(text)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    rng = np.random.RandomState(11)
    lp = np.log(rng.dirichlet(np.ones(29) * 0.2, size=(3, 12))
                ).astype(np.float32)
    labels = rng.randint(0, 29, (3, 6)).astype(np.int32)
    labels[0, 3:] = 0
    batches = [{"input": np.zeros((3, 12, 13), np.float32),
                "labels": labels}] * 2
    want = jax_audio.evaluate_ctc_decoders(lambda x: lp, batches)
    assert audio.evaluate_ctc_decoders(lambda x: lp, batches) == want
    assert audio.evaluate_ctc_decoders(lambda x: torch.from_numpy(lp),
                                       batches) == want
    assert want["sequences"] == 6
    for seed in range(3):
        mel = audio.featurize(_noise(60 + seed, 8000 + 3000 * seed))
        got = audio.transpose_flip(mel)
        assert got.dtype == np.float32 and got.shape == mel.shape[::-1]
        np.testing.assert_array_equal(got, jax_audio.transpose_flip(mel))
    np.testing.assert_array_equal(
        audio.transpose_flip(np.ones((4, 3), np.float32)),
        jax_audio.transpose_flip(np.ones((4, 3), np.float32)))
