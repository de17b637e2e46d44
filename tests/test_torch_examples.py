"""The rest of the command-line examples on the port, on the CPU
(``analytics_zoo_tpu_torch/examples/``: DS2 training, inference and long
audio, AttentionASR, Faster-RCNN predict and shapes training, fraud,
recommender, sentiment, image augmentation), with ``--device cpu``:

- every option of the ten reference scripts, read with ``ast`` from
  ``examples/*.py`` (nothing of them is imported for it), has its
  counterpart with the same default and choices; ``--device`` (default
  ``cuda``) is added to all ten and ``--rnn-engine`` (default None, the
  blocked loop) to the three DS2 ones, and nothing else;
- the synthetic data of ``train_ds2``, ``fraud_detection``,
  ``recommender`` and ``sentiment`` bit-equal to what the reference's
  scripts draw for the same seed (their ``main`` run up to the point
  where the data is handed over);
- ``ds2_inference`` on two seeded wavs with the weights of the
  reference's ``make_ds2_model(hidden=32)`` carried in through
  ``--model``: the transcripts equal the reference
  ``DeepSpeech2Pipeline``'s;
- ``predict_frcnn`` on its demo batch at 128 px with carried weights
  (py-faster-rcnn's test-time 6000/300 proposals): detections held to
  the reference detector's with ``test_torch_frcnn``'s tolerances
  (classes and order equal, scores within ``PROB_TOL``, boxes within
  ``ROI_TOL_PX`` plus ``DELTA_TOL`` times the image's width);
- ``long_audio_asr`` at world 1 (in a child process: it starts a
  process group): the sequence-parallel transcript equals the whole
  forward's;
- ``train_ds2`` (through the persistent-RNN path's plain versions),
  ``train_attention_asr`` full and moe and ``train_frcnn_shapes`` at a
  couple of epochs on a few batches: each report has the reference's
  keys and the loss falls;
- ``image_augmentation`` writes nine decodable JPEGs; the cv2-free HSV
  route is held to cv2 within ``HSV_TOL``.
"""

import importlib.util
import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models import faster_rcnn as jax_frcnn
from analytics_zoo_tpu.pipelines import deepspeech2 as jax_ds2
from analytics_zoo_tpu_torch import parallel as tparallel
from analytics_zoo_tpu_torch.data import native
from analytics_zoo_tpu_torch.data.synthetic import render_shapes_image
from analytics_zoo_tpu_torch.examples import (
    ds2_inference, fraud_detection, image_augmentation, long_audio_asr,
    predict_frcnn, recommender, sentiment, train_attention_asr, train_ds2,
    train_frcnn_shapes)
from analytics_zoo_tpu_torch.models import FasterRcnnDetector, FrcnnParam
from analytics_zoo_tpu_torch.pipelines import deepspeech2 as tds2
from analytics_zoo_tpu_torch.transform.vision import augmentation
from analytics_zoo_tpu_torch.utils.convert import (ds2_params_from_jax,
                                                   frcnn_params_from_jax)
from test_torch_frcnn import (DELTA_TOL, PROB_TOL, ROI_TOL_PX,
                              _seeded_params)
from test_torch_ssd_entry import reference_options

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = {"train_ds2": train_ds2, "ds2_inference": ds2_inference,
        "long_audio_asr": long_audio_asr,
        "train_attention_asr": train_attention_asr,
        "predict_frcnn": predict_frcnn,
        "train_frcnn_shapes": train_frcnn_shapes,
        "fraud_detection": fraud_detection, "recommender": recommender,
        "sentiment": sentiment, "image_augmentation": image_augmentation}
DS2 = ("train_ds2", "ds2_inference", "long_audio_asr")
# the one default that differs: the port's model files are torch.save
# state dicts
PORT_DEFAULTS = {("train_frcnn_shapes", ("--params-out",)):
                 "frcnn_shapes_params.pt"}
CPU = ["--device", "cpu"]


def _reference_module(name):
    """``examples/<name>.py`` loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Handed(Exception):
    """Raised where a reference ``main`` hands its data on."""


# -- the options -------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PORT))
def test_options_match_reference(name):
    ref = reference_options(ROOT / "examples" / f"{name}.py")
    actions = {tuple(a.option_strings): a
               for a in PORT[name].build_parser()._actions
               if a.option_strings != ["-h", "--help"]}
    added = {("--device",)} | ({("--rnn-engine",)} if name in DS2 else set())
    assert set(actions) == set(ref) | added
    assert actions[("--device",)].default == "cuda"
    if name in DS2:
        engine = actions[("--rnn-engine",)]
        assert engine.default is None
        assert engine.choices == ("legacy", "blocked", "pallas")
    for flags, kw in ref.items():
        a = actions[flags]
        store_true = kw.get("action") == "store_true"
        assert a.default == PORT_DEFAULTS.get(
            (name, flags), kw.get("default", False if store_true else None))
        assert a.choices == (tuple(kw["choices"]) if "choices" in kw
                             else None), flags
        assert (a.type.__name__ if a.type else None) == kw.get("type")
        assert a.nargs == kw.get("nargs", 0 if store_true else None)
        assert a.required == kw.get("required", False)


def test_device_cuda_without_a_card_raises(monkeypatch):
    """``--device cuda`` on a machine with no card raises; nothing falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = sentiment.build_parser().parse_args([])
    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        sentiment.run(args)


# -- the synthetic data, bit-equal to the reference's -------------------------


def _run_reference_main(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    with pytest.raises(_Handed):
        _reference_module(name).main()


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [
    dict(n_batches=3, batch_size=8),
    dict(n_batches=2, batch_size=8, seed=123),
    dict(n_batches=2, batch_size=4, utt_length=96, n_tokens=4, seed=5),
])
def test_train_ds2_synthetic_batches_equal_reference(kw):
    ref = _reference_module("train_ds2").synthetic_batches(**kw)
    _assert_trees_equal(train_ds2.synthetic_batches(**kw), ref)


def test_fraud_frame_equals_reference(monkeypatch):
    import analytics_zoo_tpu.pipelines as jpipe

    seen = {}

    def handed(frame, feature_cols, **kw):
        seen.update(frame=frame, cols=feature_cols)
        raise _Handed

    monkeypatch.setattr(jpipe, "run_fraud_pipeline", handed)
    _run_reference_main(monkeypatch, "fraud_detection", [])
    frame, cols = fraud_detection.synthetic_frame()
    assert cols == seen["cols"]
    _assert_trees_equal(frame, seen["frame"])
    # the reference labels it "~0.2% positives"; its draw has 26.7%
    assert frame["label"].sum() == 5336


class _RecordingOptimizer:
    """A stand-in for the reference's ``Optimizer``: keeps the training
    and validation sets and stops ``main`` at ``optimize``."""

    seen = {}

    def __init__(self, model, dataset, criterion, **kw):
        self.seen["train"] = dataset

    def set_optim_method(self, _):
        return self

    def set_validation(self, trigger, dataset, methods):
        self.seen["val"] = dataset
        return self

    def set_end_when(self, _):
        return self

    def optimize(self):
        raise _Handed


@pytest.mark.parametrize("argv", [[], ["--users", "50", "--items", "40",
                                       "--ratings", "3000", "--seed", "3",
                                       "--batch-size", "64"]])
def test_recommender_ratings_equal_reference(monkeypatch, argv):
    """The batches the reference hands its ``Optimizer`` (two shuffled
    training epochs and the held-out pass) equal the port's."""
    import analytics_zoo_tpu.parallel as jpar

    monkeypatch.setattr(jpar, "Optimizer", _RecordingOptimizer)
    _run_reference_main(monkeypatch, "recommender", argv)
    args = recommender.build_parser().parse_args(argv)
    data = recommender.synthetic_ratings(args)
    split = int(args.ratings * 0.9)
    train = recommender.rating_batches(data, 0, split, True, args.batch_size)
    val = recommender.rating_batches(data, split, args.ratings, False,
                                     args.batch_size)
    for got, want in ((train, _RecordingOptimizer.seen["train"]),
                      (train, _RecordingOptimizer.seen["train"]),
                      (val, _RecordingOptimizer.seen["val"])):
        _assert_trees_equal(list(got), list(want))


def test_sentiment_reviews_equal_reference(monkeypatch):
    """The arrays the reference's ``main`` gives ``DataSet.from_arrays``
    (training, then held-out) equal the port's split of
    ``synthetic_reviews``."""
    from analytics_zoo_tpu.data import DataSet

    calls, real = [], DataSet.from_arrays

    def from_arrays(**arrays):
        calls.append(arrays)
        if len(calls) == 2:
            raise _Handed
        return real(**arrays)

    monkeypatch.setattr(DataSet, "from_arrays", staticmethod(from_arrays))
    _run_reference_main(monkeypatch, "sentiment", [])
    args = sentiment.build_parser().parse_args([])
    tokens, labels = sentiment.synthetic_reviews(args.samples, args.seq_len,
                                                 args.vocab)
    split = int(args.samples * 0.8)
    _assert_trees_equal({"input": tokens[:split], "target": labels[:split],
                         "shuffle": True}, calls[0])
    _assert_trees_equal({"input": tokens[split:], "target": labels[split:]},
                        calls[1])


# -- DS2 inference with carried weights ---------------------------------------


def write_wav(path, samples, rate=16000):
    pcm = np.clip(np.round(samples * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def _tones(seconds, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    x = 0.02 * rng.randn(t.size)
    for _ in range(3):
        f0, df = rng.uniform(100, 3000), rng.uniform(-50, 50)
        x += 0.1 * np.sin(2 * np.pi * (f0 + df * t) * t)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def ds2_carried(tmp_path_factory):
    """The reference's ``make_ds2_model(hidden=32, n_rnn_layers=2)`` at a
    3 s segment, its weights saved as the port's ``--model`` file, and two
    seeded wavs."""
    work = tmp_path_factory.mktemp("ds2_examples")
    jmodel = jax_ds2.make_ds2_model(hidden=32, n_rnn_layers=2, utt_length=300)
    port = tds2.make_ds2_model(hidden=32, n_rnn_layers=2, device="cpu")
    path = work / "ds2.pt"
    torch.save(ds2_params_from_jax(jmodel.variables, port), path)
    wavs = work / "wavs"
    wavs.mkdir()
    for i, sec in enumerate((2.0, 4.5)):
        write_wav(wavs / f"utt{i}.wav", _tones(sec, i))
    return jmodel, str(path), str(wavs)


def test_ds2_inference_transcripts_equal_reference(ds2_carried):
    jmodel, path, wavs = ds2_carried
    argv = ["-d", wavs, "-m", path, "-s", "3", "-b", "2", "--hidden", "32",
            "--layers", "2", *CPU]
    got = ds2_inference.run(ds2_inference.build_parser().parse_args(argv))
    paths = sorted(str(p) for p in Path(wavs).glob("*.wav"))
    want = jax_ds2.DeepSpeech2Pipeline(
        jmodel, jax_ds2.DS2Param(segment_seconds=3, batch_size=2)
    ).transcribe_files(paths)
    assert got["transcripts"] == want
    assert all(want.values()) and len(want) == 2


def test_ds2_inference_mapping_file_gives_wer(ds2_carried, tmp_path, capsys):
    """A ``mapping.txt`` through ``main``: the reference's WER/CER line."""
    _, path, wavs = ds2_carried
    mapping = tmp_path / "mapping.txt"
    mapping.write_text("".join(f"{p}\tHELLO WORLD\n"
                               for p in sorted(Path(wavs).glob("*.wav"))))
    assert ds2_inference.main(["-d", str(mapping), "-m", path, "-s", "3",
                               "--hidden", "32", "--layers", "2", *CPU]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("WER = ") and "CER = " in line


# -- Faster-RCNN prediction with carried weights ------------------------------


def test_predict_frcnn_demo_matches_reference():
    size = 128
    jdet = jax_frcnn.FasterRcnnDetector(param=jax_frcnn.FrcnnParam(
        num_classes=4))
    params = _seeded_params(jdet)
    with torch.device("meta"):
        tdet = FasterRcnnDetector(param=FrcnnParam(num_classes=4),
                                  device="meta")
    tdet = tdet.to_empty(device="cpu")
    tdet.load_state_dict(frcnn_params_from_jax(params, tdet))
    args = predict_frcnn.build_parser().parse_args(
        ["--size", str(size), "--classes", "4", *CPU])
    got = predict_frcnn.run(args, detector=tdet.eval())

    rng = np.random.RandomState(0)
    imgs = rng.rand(2, size, size, 3).astype(np.float32) * 255
    import jax

    want = np.asarray(jax.jit(lambda p, a, i: jdet.apply({"params": p}, a, i))(
        params, imgs - predict_frcnn.BGR_MEANS,
        np.tile(np.float32([[size, size, 1.0]]), (2, 1))))
    got_d = got["detections"]
    assert got_d.shape == want.shape
    np.testing.assert_array_equal(got_d[..., 0], want[..., 0])
    np.testing.assert_allclose(got_d[..., 1], want[..., 1], rtol=0,
                               atol=PROB_TOL)
    # a box is a ROI (within ROI_TOL_PX) moved by deltas (within
    # DELTA_TOL) scaled by the ROI's width, at most the image's
    np.testing.assert_allclose(got_d[..., 2:], want[..., 2:], rtol=0,
                               atol=ROI_TOL_PX + DELTA_TOL * size)
    assert got["names"] == ["demo0", "demo1"] and got["ms"] > 0
    assert (got["detections"][..., 1] > 0).sum() >= 2


def test_predict_frcnn_refuses_non_jpeg(tmp_path):
    (tmp_path / "a.png").write_bytes(b"\x89PNG\r\n\x1a\n")
    args = predict_frcnn.build_parser().parse_args(
        ["--image-dir", str(tmp_path), "--size", "64", *CPU])
    with pytest.raises(SystemExit, match="not JPEG.*a.png"):
        predict_frcnn.run(args)


# -- long audio at world 1 -----------------------------------------------------


LONG_AUDIO = """
import json, math
import numpy as np
from analytics_zoo_tpu_torch.examples import long_audio_asr as la
from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
    DS2Param, DeepSpeech2Pipeline, make_ds2_model)
args = la.build_parser().parse_args(
    ["--seconds", "6", "--hidden", "32", "--device", "cpu"])
r = la.run(args)
samples = la.utterance(args)
model = make_ds2_model(hidden=32, n_rnn_layers=1, device="cpu")
whole = DeepSpeech2Pipeline(
    model, DS2Param(segment_seconds=math.ceil(len(samples) / 16000),
                    batch_size=1), device="cpu")
r["whole"] = whole.transcribe_samples({"utt": samples})["utt"]
print(json.dumps(r))
"""


def test_long_audio_sequence_parallel_equals_whole_forward():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    out = subprocess.run([sys.executable, "-c", LONG_AUDIO], cwd=ROOT,
                         capture_output=True, text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["sequence_devices"] == 1 and r["audio_s"] == 6.0
    assert r["seqpar"] == r["whole"] and r["seqpar"]
    assert r["chunked"]


def test_long_audio_sequence_devices_must_span_the_ranks():
    """``--sequence-devices`` other than the world refuses by name (run
    where a one-rank group is started, so in a child)."""
    code = ("from analytics_zoo_tpu_torch.examples import long_audio_asr\n"
            "long_audio_asr.main(['--sequence-devices', '2', '--device', "
            "'cpu', '--seconds', '1'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "--sequence-devices 2" in out.stderr


# -- training examples at a tiny size ------------------------------------------


class _recording:
    """``with _recording(module) as runs:`` — each ``Optimizer`` that
    ``module`` builds, kept in ``runs``."""

    def __init__(self, module):
        self.module, self.runs = module, []

    def __enter__(self):
        runs, base = self.runs, self.module.Optimizer

        class Recording(base):
            def optimize(self):
                runs.append(self)
                return super().optimize()

        self.base = base
        self.module.Optimizer = Recording
        return runs

    def __exit__(self, *exc):
        self.module.Optimizer = self.base


def _epoch_losses(run, steps_per_epoch):
    losses = [float(h["loss"]) for h in run.history]
    assert len(losses) % steps_per_epoch == 0 and np.isfinite(losses).all()
    return np.asarray(losses).reshape(-1, steps_per_epoch).mean(1)


CTC_KEYS = {"task", "cer", "exact_sequence_acc", "beam_cer",
            "beam_exact_sequence_acc", "sequences", "epochs", "backend",
            "device"}


def test_train_ds2_tiny_through_the_kernels_path(monkeypatch):
    """``--rnn-engine pallas`` on the CPU: the persistent-RNN path's
    plain versions, K3's forward and K4's backward, each called."""
    from analytics_zoo_tpu_torch.ops import pallas_rnn

    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "persistent_rnn_plain"),
                      ("bwd", "persistent_rnn_bwd_plain")):
        def counted(*a, _fn=getattr(pallas_rnn, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(pallas_rnn, name, counted)
    args = train_ds2.build_parser().parse_args(
        ["--epochs", "3", "--batches", "2", "--batch-size", "4",
         "--hidden", "32", "--lr", "3e-3", "--rnn-engine", "pallas", *CPU])
    with _recording(tds2) as runs:
        report, model = train_ds2.run(args)
    assert set(report) == CTC_KEYS | {"rnn_engine"}
    assert report["backend"] == report["device"] == "cpu"
    assert report["rnn_engine"] == "pallas" and report["sequences"] == 8
    assert model.birnn0.fwd.engine == "pallas"
    assert calls["fwd"] > 0 and calls["bwd"] > 0, calls
    losses = _epoch_losses(runs[0], 2)
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("variant", ["full", "moe"])
def test_train_attention_asr_tiny(variant):
    args = train_attention_asr.build_parser().parse_args(
        ["--variant", variant, "--epochs", "3", "--batches", "2",
         "--batch-size", "4", "--dim", "16", *CPU])
    with _recording(tds2) as runs:
        report, _ = train_attention_asr.run(args)
    keys = {"task", "model", "cer", "exact_sequence_acc", "beam_cer",
            "beam_exact_sequence_acc", "sequences", "epochs", "backend",
            "device"}
    assert set(report) == keys
    assert report["model"] == f"attention_asr/{variant}"
    losses = _epoch_losses(runs[0], 2)
    assert losses[-1] < losses[0], losses


def test_train_attention_asr_ring_refuses_a_length_off_the_axis(
        monkeypatch):
    """Four ranks and a post-conv length of 45: each rank refuses by
    name before it joins the group."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    args = train_attention_asr.build_parser().parse_args(
        ["--variant", "ring", "--utt-length", "90", *CPU])
    with pytest.raises(SystemExit, match="45 must divide the 4 ranks"):
        train_attention_asr.run(args)


def test_train_frcnn_shapes_tiny(tmp_path):
    """Records → ``train_frcnn`` → detector → VOC07 mAP; ``--params-out``
    read back by ``--eval-only`` gives the same mAP."""
    params = str(tmp_path / "frcnn.pt")
    argv = ["--res", "128", "--train-images", "8", "--val-images", "4",
            "--batch-size", "4", "--epochs", "2", "--pre-nms", "64",
            "--post-nms", "16", "--params-out", params, *CPU]
    parser = train_frcnn_shapes.build_parser()
    with _recording(tparallel) as runs:
        report, details = train_frcnn_shapes.run(parser.parse_args(argv),
                                                 str(tmp_path))
    ref_keys = {"task", "final_map_voc07", "ap_per_class", "resolution",
                "train_images", "val_images", "epochs", "wall_seconds"}
    assert set(report) == ref_keys | {"backend", "device"}
    assert set(report["ap_per_class"]) == {"rectangle", "ellipse",
                                           "triangle"}
    losses = _epoch_losses(runs[0], 2)
    assert losses[-1] < losses[0], losses
    again, _ = train_frcnn_shapes.run(parser.parse_args(
        argv + ["--eval-only", params]), str(tmp_path / "again"))
    assert again["final_map_voc07"] == report["final_map_voc07"]


# -- image augmentation ----------------------------------------------------------


@pytest.fixture(scope="module")
def shape_jpeg(tmp_path_factory):
    img, _ = render_shapes_image(np.random.RandomState(1), 160)
    path = tmp_path_factory.mktemp("aug") / "shape.jpg"
    path.write_bytes(native.encode_jpeg(img, codec=native.codec_for("cpu")))
    return str(path)


def test_image_augmentation_writes_nine_jpegs(shape_jpeg, tmp_path):
    out = tmp_path / "aug"
    assert image_augmentation.main(["-f", shape_jpeg, "-o", str(out),
                                    *CPU]) == 0
    files = sorted(p.name for p in out.iterdir())
    assert files == sorted(f"{n}.jpg" for n in image_augmentation.make_ops(
        "cpu"))
    assert len(files) == 9
    codec = native.codec_for("cpu")
    for name in files:
        m = native.decode_jpeg((out / name).read_bytes(), codec)
        assert m is not None and m.shape == (300, 300, 3), name


def test_image_augmentation_refuses_non_jpeg(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(SystemExit, match="not JPEG"):
        image_augmentation.main(["-f", str(path), "-o", str(tmp_path), *CPU])


def _bgr_images():
    rng = np.random.RandomState(0)
    noise = rng.randint(0, 256, (64, 64, 3)).astype(np.float32)
    # every 8-bit colour of a coarse cube, greys and saturated edges
    levels = np.arange(0, 256, 5)
    cube = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"),
                    -1).reshape(-1, 52 * 52, 3).astype(np.float32)
    shapes, _ = render_shapes_image(np.random.RandomState(2), 96)
    return [noise, cube, shapes.astype(np.float32)]


@pytest.mark.parametrize("i", range(3))
def test_hsv_route_against_cv2(i):
    """The cv2-free 8-bit HSV mat is cv2's exactly; the way back is
    within ``HSV_TOL`` levels of cv2's."""
    mat = _bgr_images()[i]
    hsv = augmentation._to_hsv(mat, cv2_free=True)
    np.testing.assert_array_equal(hsv, augmentation._to_hsv(mat))
    back = augmentation._from_hsv(hsv, cv2_free=True)
    want = augmentation._from_hsv(hsv)
    assert back.dtype == want.dtype == np.float32
    assert np.abs(back - want).max() <= augmentation.HSV_TOL


@pytest.mark.parametrize("op", ["saturation", "hue", "jitter_saturation",
                                "jitter_hue"])
def test_hsv_ops_on_the_card_route_against_cv2(monkeypatch, op):
    """``Saturation``, ``Hue`` and ``ColorJitter`` (one of its HSV ops
    on) built for a CUDA pipeline (the route patched on, as on the card)
    against the same ops through cv2, same draws: within ``HSV_TOL``
    levels (a bound for one HSV op; see ``HSV_TOL`` on chains)."""
    from analytics_zoo_tpu_torch.transform.vision import (ColorJitter, Hue,
                                                          ImageFeature,
                                                          Saturation)
    from analytics_zoo_tpu_torch.data.transformer import sample_random

    make = {"saturation": lambda d: Saturation(1.4, 1.4, device=d),
            "hue": lambda d: Hue(-17, 17, device=d),
            "jitter_saturation": lambda d: ColorJitter(
                brightness_prob=0.0, contrast_prob=0.0, hue_prob=0.0,
                saturation_prob=1.0, device=d),
            "jitter_hue": lambda d: ColorJitter(
                brightness_prob=0.0, contrast_prob=0.0, hue_prob=1.0,
                saturation_prob=0.0, device=d)}[op]
    mats = []
    for route in (False, True):
        monkeypatch.setattr(augmentation, "_resize_route", lambda d: route)
        t = make("cpu")
        hsv_ops = ([t.saturation.inner, t.hue.inner]
                   if op.startswith("jitter") else [t])
        assert all(o.cv2_free == route for o in hsv_ops)
        sample_random().seed(7)
        out = []
        for mat in _bgr_images():
            f = ImageFeature()
            f.mat = mat.copy()
            out.append(t.transform(f).mat)
        mats.append(out)
    for cv, free in zip(*mats):
        assert np.abs(cv - free).max() <= augmentation.HSV_TOL
