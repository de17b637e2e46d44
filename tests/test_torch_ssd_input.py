"""Parity of the port's SSD input path with the JAX package, on the CPU
(the libjpeg codec; nvJPEG, the card's, is checked by ``chip_smoke.py``):
record files, the native reader, JPEG decode and encode, the synthetic
shapes data, the batches of ``load_train_set``, ``load_train_set_device``,
``load_val_set`` and ``serving_chain``, the multiprocess loader, the VOC
reader, ``predict(records)`` and a records-fed ``train_ssd``.

Tolerances: records, decoded pixels, the seeded decisions (staging,
loader order) and the gt matrices are held EQUAL.  The port's libjpeg
encode is byte-equal to ``cv2.imencode`` at quality 92.  The synthetic
renderer draws in numpy where the reference calls cv2: over seeds 0-19
the share of pixels equal to the reference's was 0.9954 at the least
(measured, the rest within 1 level in the background and differing on
the shapes' outlines); held to 0.99 equal and 0.99 within 8 levels.
"""

import dataclasses
import os
import random
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.data import native as jax_native
from analytics_zoo_tpu.data import parallel as jax_parallel
from analytics_zoo_tpu.data import records as jax_records
from analytics_zoo_tpu.data import synthetic as jax_synthetic
from analytics_zoo_tpu.pipelines import ssd as jax_pipe
from analytics_zoo_tpu.pipelines import voc as jax_voc
from analytics_zoo_tpu_torch.data import (DataSet, FnTransformer,
                                          ParallelLoader, native, parallel,
                                          prefetch, records, synthetic)
from analytics_zoo_tpu_torch.models.ssd import SSDVgg, build_priors
from analytics_zoo_tpu_torch.ops.multibox_loss import (MultiBoxLoss,
                                                       MultiBoxLossParam)
from analytics_zoo_tpu_torch.parallel import optim, train
from analytics_zoo_tpu_torch.pipelines import ssd as pipe
from analytics_zoo_tpu_torch.pipelines import voc

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a small canvas keeps the staged batches light; the chain is the real one
CANVAS = 320


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """24 shapes images at 300, 3 shards, rendered and encoded by the
    port (libjpeg)."""
    d = tmp_path_factory.mktemp("shapes")
    return synthetic.generate_shapes_records(str(d / "s"), n_images=24,
                                             num_shards=3, seed=5,
                                             device="cpu")


def _pattern(paths):
    return os.path.join(os.path.dirname(paths[0]), "s-*")


def _recs(n, seed=0):
    rng = np.random.RandomState(seed)
    return [records.SSDByteRecord(
        data=rng.bytes(rng.randint(0, 300)), path=f"img/{i}é.jpg",
        gt=rng.rand(rng.randint(0, 4), 6).astype(np.float32))
        for i in range(n)]


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- records ------------------------------------------------------------------

def test_record_files_cross_read_byte_equal(tmp_path):
    recs = _recs(11)
    ours = records.write_ssd_records(recs, str(tmp_path / "p"), 3)
    theirs = jax_records.write_ssd_records(
        [jax_records.SSDByteRecord(r.data, r.path, r.gt) for r in recs],
        str(tmp_path / "j"), 3)
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()
    for reader, paths in ((records.read_ssd_records, theirs),
                          (jax_records.read_ssd_records, ours)):
        got = list(reader(paths))
        assert [r.path for r in got] == [r.path for r in
                                         recs[0::3] + recs[1::3] + recs[2::3]]
        for g in got:
            want = next(r for r in recs if r.path == g.path)
            assert g.data == want.data
            np.testing.assert_array_equal(g.gt, want.gt.reshape(-1, 6))
    assert (records.shard_paths(str(tmp_path / "p-*"), 1, 2)
            == jax_records.shard_paths(str(tmp_path / "p-*"), 1, 2))
    assert records.shard_paths(str(tmp_path / "p-*")) == sorted(ours)


class _Flaky:
    """An opener whose files raise OSError on chosen reads (counted over
    the whole run)."""

    def __init__(self, fail_on):
        self.fail_on, self.reads = set(fail_on), 0

    def __call__(self, path, mode):
        f = open(path, mode)
        outer = self
        read = f.read

        class Wrapped:
            def read(self, n=-1):
                outer.reads += 1
                if outer.reads in outer.fail_on:
                    raise OSError("transient")
                return read(n)

            def __getattr__(self, name):
                return getattr(f, name)

        return Wrapped()


@pytest.mark.parametrize("fail_on,retries", [((3,), 1), ((3, 6), 2),
                                             ((3, 5), 1)])
def test_read_records_retries_as_the_reference(tmp_path, fail_on, retries):
    (path,) = records.write_ssd_records(_recs(5), str(tmp_path / "r"), 1)
    outcome = []
    for mod in (records, jax_records):
        stats = mod.ReadStats()
        try:
            got = list(mod.read_records(path, retries=retries,
                                        backoff_s=0.0, stats=stats,
                                        opener=_Flaky(fail_on)))
            outcome.append((got, stats.records, stats.retries))
        except mod.ShardReadError as e:
            outcome.append(("raised", str(e).split(":")[-1]))
    assert outcome[0] == outcome[1]
    with pytest.raises(NotImplementedError, match="item 13"):
        records.ReadStats().publish(None)


def test_read_ssd_records_skips_a_truncated_shard(tmp_path):
    paths = records.write_ssd_records(_recs(6), str(tmp_path / "t"), 2)
    with open(paths[0], "r+b") as f:
        f.truncate(os.path.getsize(paths[0]) - 3)
    got = {}
    for mod in (records, jax_records):
        stats = mod.ReadStats()
        got[mod] = ([r.path for r in mod.read_ssd_records(
            paths, skip_errors=True, stats=stats)],
            dataclasses.astuple(stats))
        with pytest.raises(ValueError, match="truncated"):
            list(mod.read_ssd_records(paths))
    assert got[records] == got[jax_records]


def test_native_reader_yields_the_reference_records(shards):
    want = sorted(p for path in shards for p in jax_records.read_records(path))
    with native.NativeRecordReader(shards, n_threads=3) as reader:
        assert sorted(reader) == want
    with native.NativeRecordReader(shards[:1], n_threads=1) as reader:
        assert list(reader) == list(jax_records.read_records(shards[0]))
    assert [native.count_records(p) for p in shards] == [8, 8, 8]
    ds = DataSet.from_record_files(_pattern(shards), native_threads=2)
    assert sorted(ds) == want and not ds._order_deterministic
    with pytest.raises(ValueError, match="reproducible iteration order"):
        ParallelLoader(ds, 2)


# -- JPEG ---------------------------------------------------------------------

def _with_orientation(jpeg: bytes, o: int) -> bytes:
    """``jpeg`` with an EXIF APP1 segment carrying Orientation ``o``."""
    ifd = struct.pack("<H", 1) + struct.pack("<HHIHH", 0x0112, 3, 1, o, 0)
    tiff = b"II*\x00" + struct.pack("<I", 8) + ifd + struct.pack("<I", 0)
    body = b"Exif\x00\x00" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body \
        + jpeg[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_decode_jpeg_equal_to_reference(orientation):
    rng = np.random.RandomState(orientation)
    img = cv2.GaussianBlur(rng.randint(0, 256, (37, 52, 3)).astype(np.uint8),
                           (5, 5), 0)
    data = _with_orientation(bytes(cv2.imencode(".jpg", img)[1]),
                             orientation)
    got = native.decode_jpeg(data)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(got, want)
    assert got.shape == ((52, 37, 3) if orientation >= 5 else (37, 52, 3))
    if jax_native.available():
        np.testing.assert_array_equal(got, jax_native.decode_jpeg(data))
    assert native.decode_jpeg(data[:40]) is None
    assert native.decode_jpeg(b"not a jpeg") is None


def test_encode_jpeg_is_cv2s_and_codecs_refuse_cleanly():
    img, _ = synthetic.render_shapes_image(np.random.RandomState(2))
    assert native.encode_jpeg(img, 92) == bytes(
        cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 92])[1])
    assert native.codec_for("cpu") == "libjpeg"
    assert native.codec_for(torch.device("cuda", 0)) == "nvjpeg"
    with pytest.raises(ValueError, match="unknown JPEG codec"):
        native.decode_jpeg(b"", codec="cv2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            native.check_codec("nvjpeg")


# -- synthetic data --------------------------------------------------------------

@pytest.mark.parametrize("seed", range(0, 20, 4))
def test_shapes_gt_equal_and_pixels_close(seed):
    want_img, want_gt = jax_synthetic.render_shapes_image(
        np.random.RandomState(seed))
    got_img, got_gt = synthetic.render_shapes_image(
        np.random.RandomState(seed))
    np.testing.assert_array_equal(got_gt, want_gt)
    diff = np.abs(got_img.astype(int) - want_img).max(-1)
    assert (diff == 0).mean() >= 0.99
    assert (diff <= 8).mean() >= 0.99


def test_generated_records_gt_equal_reference(shards, tmp_path):
    want = jax_synthetic.generate_shapes_records(str(tmp_path / "j"),
                                                 n_images=24, num_shards=3,
                                                 seed=5)
    for a, b in zip(shards, want):
        ours, theirs = (list(records.read_ssd_records([a])),
                        list(jax_records.read_ssd_records([b])))
        assert [r.path for r in ours] == [r.path for r in theirs]
        for r, s in zip(ours, theirs):
            np.testing.assert_array_equal(r.gt, s.gt)
            assert native.decode_jpeg(r.data).shape == (300, 300, 3)


# -- batches ------------------------------------------------------------------------

def _param(mod, **kw):
    return mod.PreProcessParam(batch_size=4, **kw)


def _device_param(mod):
    from analytics_zoo_tpu.transform.vision import DeviceAugParam as J
    from analytics_zoo_tpu_torch.transform.vision import DeviceAugParam as T

    return (J if mod is jax_pipe else T)(canvas_size=CANVAS)


def _take(it, n):
    out = []
    for b in it:
        out.append(b)
        if len(out) == n:
            break
    if hasattr(it, "close"):
        it.close()
    return out


def test_train_batches_equal_reference(shards):
    pat = _pattern(shards)
    for augment in (True, False):
        got = _take(iter(pipe.load_train_set(
            pat, _param(pipe), augment=augment, device="cpu").parallel(
                0, base_seed=9)), 3)
        want = _take(iter(jax_pipe.load_train_set(
            pat, _param(jax_pipe), augment=augment).parallel(
                0, base_seed=9)), 3)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _same_tree(a, b)


def test_device_staged_and_val_batches_equal_reference(shards):
    pat = _pattern(shards)
    ds, aug = pipe.load_train_set_device(pat, _param(pipe),
                                         aug=_device_param(pipe),
                                         device="cpu")
    jds, _ = jax_pipe.load_train_set_device(pat, _param(jax_pipe),
                                            aug=_device_param(jax_pipe))
    got = list(ds.parallel(0, base_seed=4))
    want = list(jds.parallel(0, base_seed=4))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        _same_tree(a, b)
    out = aug(got[0])
    assert out["input"].shape == (4, 300, 300, 3)
    vparam = pipe.PreProcessParam(batch_size=5)
    got = list(pipe.load_val_set(pat, vparam, device="cpu"))
    want = list(jax_pipe.load_val_set(pat, jax_pipe.PreProcessParam(
        batch_size=5)))
    assert [b["input"].shape[0] for b in got] == [5, 5, 5, 5, 4]
    for a, b in zip(got, want):
        _same_tree(a, b)
    got = list(pipe.serving_chain(vparam, uint8=True, device="cpu")(
        records.read_ssd_records(shards)))
    want = list(jax_pipe.serving_chain(
        jax_pipe.PreProcessParam(batch_size=5), uint8=True)(
            jax_records.read_ssd_records(shards)))
    assert got[-1]["n_valid"] == want[-1]["n_valid"] == 4
    for a, b in zip(got, want):
        _same_tree(a, b)


def test_param_refuses_the_deferred_wires():
    for kw in (dict(wire_format="yuv420"), dict(pack_staging=True)):
        with pytest.raises(NotImplementedError, match="item e"):
            pipe.PreProcessParam(**kw)


# -- the loader ----------------------------------------------------------------------

def _staged_set(mod, pattern, workers=0):
    param = _param(mod, worker_processes=workers, loader_seed=3,
                   shuffle_buffer=8, shuffle_seed=1)
    if mod is jax_pipe:
        return mod.load_train_set_device(pattern, param,
                                         aug=_device_param(mod))[0]
    return mod.load_train_set_device(pattern, param, aug=_device_param(mod),
                                     device="cpu")[0]


def test_loader_stream_identical_for_any_worker_count(shards):
    pat = _pattern(shards)
    streams = {}
    for workers in (0, 1, 2):
        loader = _staged_set(pipe, pat, workers)
        assert isinstance(loader, ParallelLoader) == (workers > 0)
        if workers == 0:
            loader = ParallelLoader(loader, 0, base_seed=3)
        streams[workers] = [list(loader), list(loader)]   # two epochs
        assert loader.respawns == 0 and not loader.worker_pids()
    for workers in (1, 2):
        for a_epoch, b_epoch in zip(streams[0], streams[workers]):
            assert len(a_epoch) == len(b_epoch) == 6
            for a, b in zip(a_epoch, b_epoch):
                _same_tree(a, b)
    # epochs differ (file order and the per-sample seeds fold the epoch)
    assert not np.array_equal(streams[0][0][0]["aug"]["rect"],
                              streams[0][1][0]["aug"]["rect"])
    want = jax_parallel.ParallelLoader(_staged_set(jax_pipe, pat), 0,
                                       base_seed=3)
    for a_epoch, b_epoch in zip(streams[0], [list(want), list(want)]):
        for a, b in zip(a_epoch, b_epoch):
            _same_tree(a, b)


def test_sources_shuffles_and_clones_equal_reference(shards):
    from analytics_zoo_tpu.data import dataset as jax_dataset
    from analytics_zoo_tpu.data import transformer as jax_transformer
    from analytics_zoo_tpu_torch.data import dataset, transformer

    pairs = []
    for mod, tmod in ((dataset, transformer), (jax_dataset, jax_transformer)):
        lst = mod.DataSet.from_list(list(range(30)), shuffle=True, seed=4)
        arr = mod.DataSet.from_arrays(shuffle=True, seed=2,
                                      x=np.arange(12))
        buf = mod.DataSet.from_list(list(range(40))).shuffle(7, seed=3)
        files = mod.DataSet.from_record_files(_pattern(shards),
                                              shuffle_files=True, seed=6,
                                              shard_by_host=False)
        pipeline = tmod.Pipeline([tmod.FnTransformer(lambda x: x + 1),
                                  tmod.FnTransformer(lambda x: x * 2)])
        pairs.append([list(lst), list(lst),
                      [int(b["x"]) for b in arr], list(buf),
                      [len(p) for p in files][:10],
                      list(pipeline(range(4))),
                      list((tmod.FnTransformer(lambda x: x - 1)
                            >> pipeline)(range(3)))])
    assert pairs[0] == pairs[1]
    a = transformer.RandomTransformer(transformer.FnTransformer(abs), 0.5,
                                      rng=random.Random(0))
    b = a.clone()
    assert b.rng is not a.rng and b.rng.getstate() != a.rng.getstate()
    # the shared per-sample stream survives a clone and a pickle
    import pickle
    from analytics_zoo_tpu_torch.transform.vision import Expand

    e = Expand()
    assert e.clone().rng is e.rng is transformer.sample_random()
    assert pickle.loads(pickle.dumps(e)).rng is e.rng


def test_loader_refuses_a_cuda_codec_in_its_workers():
    ds = DataSet.from_list(list(range(8)))
    stage = FnTransformer(lambda x: x)
    stage.codec = "nvjpeg"
    with pytest.raises(ValueError, match="nvJPEG"):
        ParallelLoader(ds.transform(stage), 2)
    assert list(ParallelLoader(ds.transform(stage), 0)) == list(range(8))
    for fn in (parallel.make_input_pipeline, parallel.replay_batches):
        with pytest.raises(NotImplementedError, match="item 12"):
            fn(ds, 0, 0)
    with pytest.raises(NotImplementedError, match="item 12"):
        parallel.elastic_resume_coordinates(0, 0, 1)


def test_worker_refuses_the_cuda_codec(shards):
    """A stage that reaches nvJPEG without naming its codec gets past the
    loader's construction check; in the worker the codec refuses before
    any CUDA call, and the loader raises the worker's error."""
    data = next(records.read_ssd_records(shards)).data
    ds = DataSet.from_list([data] * 4).transform(
        FnTransformer(lambda b: native.decode_jpeg(b, "nvjpeg")))
    with pytest.raises(RuntimeError, match="forked input worker must not "
                                           "touch CUDA"):
        list(ParallelLoader(ds, 2))


def test_loader_respawns_a_killed_worker(shards):
    """A worker that dies mid-epoch is respawned from the group it owes,
    and the stream stays the serial one."""
    def maybe_die(x):
        if x == 9 and not os.path.exists(flag):
            open(flag, "w").close()
            os._exit(3)
        return x * 10

    flag = os.path.join(os.path.dirname(shards[0]), "died")
    ds = DataSet.from_list(list(range(20))).transform(
        FnTransformer(maybe_die)).batch(4)
    loader = ParallelLoader(ds, 2, base_seed=0)
    got = [b.tolist() for b in loader]
    assert got == [[10 * i for i in range(j, j + 4)] for j in range(0, 20, 4)]
    assert loader.respawns == 1


def test_device_prefetch_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        next(prefetch.device_prefetch(iter([{"x": np.zeros(2)}]), "cpu"))
    with pytest.raises(ValueError, match=">= 1"):
        next(prefetch.device_prefetch(iter([]), "cpu", size=0))


# -- VOC ----------------------------------------------------------------------------

def _devkit(root):
    base = os.path.join(root, "VOC2007")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(base, sub))
    rng = np.random.RandomState(1)
    ids = ["000005", "000007", "000009"]
    for k, img_id in enumerate(ids):
        img = rng.randint(0, 256, (40 + k, 60, 3)).astype(np.uint8)
        cv2.imwrite(os.path.join(base, "JPEGImages", f"{img_id}.jpg"), img)
        objs = "".join(textwrap.dedent(f"""
            <object><name>{name}</name><difficult>{diff}</difficult>
              <bndbox><xmin>{3 + j}</xmin><ymin>4</ymin><xmax>{30 + j}</xmax>
              <ymax>{20 + k}</ymax></bndbox></object>""")
            for j, (name, diff) in enumerate(
                [("Dog", 0), ("person", 1), ("unicorn", 0)][:k + 1]))
        with open(os.path.join(base, "Annotations", f"{img_id}.xml"),
                  "w") as f:
            f.write(f"<annotation>{objs}</annotation>")
    with open(os.path.join(base, "ImageSets", "Main", "trainval.txt"),
              "w") as f:
        f.write("\n".join(ids) + "\n")


def test_voc_reader_gives_the_reference_records(tmp_path):
    _devkit(str(tmp_path))
    ann = os.path.join(tmp_path, "VOC2007", "Annotations", "000009.xml")
    for use_difficult in (True, False):
        a = voc.parse_voc_annotation(ann, use_difficult)
        b = jax_voc.parse_voc_annotation(ann, use_difficult)
        np.testing.assert_array_equal(a.to_gt_matrix(), b.to_gt_matrix())
    imdb = voc.get_imdb("voc_2007_trainval", str(tmp_path))
    assert imdb.name == "voc_2007_trainval"
    ours = voc.to_ssd_records(imdb, str(tmp_path / "out" / "p"), 2)
    theirs = jax_voc.to_ssd_records(
        jax_voc.get_imdb("voc_2007_trainval", str(tmp_path)),
        str(tmp_path / "out" / "j"), 2)
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="unknown imdb"):
        voc.get_imdb("imagenet_2012", str(tmp_path))


# -- serving and training from records ------------------------------------------------

def test_predict_records_equals_detect_batch(shards):
    model = SSDVgg(21, 300, device="cpu", seed=1)
    param = pipe.PreProcessParam(batch_size=4)
    pred = pipe.SSDPredictor(model, param, device="cpu")
    recs = list(records.read_ssd_records(shards))[:6]
    got = pred.predict(recs)
    assert len(got) == 6 and all(g.shape == (200, 6) for g in got)
    staged = list(pipe.serving_chain(param, uint8=True, device="cpu")(recs))
    want = []
    for b in staged:
        n = b.pop("n_valid", 4)
        want.extend(pred.detect_batch(b)[:n])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_train_ssd_from_records_with_device_transform(shards, monkeypatch):
    """``train_ssd`` on the CPU from staged record batches with the device
    augmentation: its first step's loss equals that of the same batch
    augmented and fed as arrays.  ``prefetch`` on a CPU model does
    nothing (pinning needs a card)."""
    seen = []
    run = train.Optimizer.optimize

    def optimize(self):
        seen.append(self)
        return run(self)

    monkeypatch.setattr(train.Optimizer, "optimize", optimize)
    pat = _pattern(shards)
    param = dataclasses.replace(_param(pipe), batch_size=2)
    staged, aug = pipe.load_train_set_device(pat, param,
                                             aug=_device_param(pipe),
                                             device="cpu")
    loader = ParallelLoader(staged, 0, base_seed=2)
    params = pipe.TrainParams(max_epoch=1, n_classes=4, compute_dtype=None,
                              prefetch=2)

    class TwoSteps:
        """The loader's epochs, cut to two batches."""

        def __iter__(self):
            return iter(_take(iter(loader), 2))

    model = pipe.train_ssd(TwoSteps(), None, params, device="cpu",
                           device_transform=aug)
    (opt,) = seen
    assert opt.prefetch == 2 and len(opt.history) == 2
    first = opt.history[0]["loss"].item()

    fresh_staged, _ = pipe.load_train_set_device(
        pat, param, aug=_device_param(pipe), device="cpu")
    batch = _take(iter(ParallelLoader(fresh_staged, 0, base_seed=2)), 1)[0]
    arrays = {k: v for k, v in aug(batch).items()}
    arrays["input"] = arrays["input"].numpy()
    fresh = SSDVgg(4, 300, device="cpu", seed=0)
    priors, variances = build_priors(fresh.config)
    sgd = optim.SGD(params.learning_rate, momentum=params.momentum,
                    weight_decay=params.weight_decay)
    step = train.make_train_step(
        fresh, MultiBoxLoss(priors, variances, MultiBoxLossParam(
            n_classes=4)), sgd, skip_loss_above=50.0)
    _, metrics = step(train.create_train_state(fresh, sgd), arrays)
    assert metrics["loss"].item() == first
    assert np.isfinite(opt.history[1]["loss"].item())
    assert not model.training


def test_port_input_path_imports_no_cv2(tmp_path):
    """With cv2 unimportable, the card's input path imports, renders and
    encodes shapes records, stages one image, and validates and serves
    records of other sizes than 300² through ``load_val_set`` and
    ``serving_chain(uint8=True)``.  The subprocess takes the card's routes
    (the device is CUDA) with the CPU's codec, since nvJPEG needs a card.
    Its batches against the CPU's route (``cv2.resize``) on the same
    records: im_info and labels equal, uint8 pixels within 1 level and
    float pixels within 1e-4 (``test_resize_bilinear_close_to_cv2``)."""
    out_path = tmp_path / "batches.npz"
    code = textwrap.dedent(f"""
        import sys
        sys.modules["cv2"] = None
        import numpy as np
        import torch
        import analytics_zoo_tpu_torch.data
        import analytics_zoo_tpu_torch.data.synthetic as synthetic
        import analytics_zoo_tpu_torch.pipelines.ssd as pipe
        import analytics_zoo_tpu_torch.transform.vision.device as device
        from analytics_zoo_tpu_torch.data import native, records
        paths = synthetic.generate_shapes_records(
            {str(tmp_path / 's')!r}, n_images=2, num_shards=1, device="cpu")
        rec = next(records.read_ssd_records(paths))
        f = pipe.RoiNormalize().transform(pipe.BytesToMat(
            to_float=False, device="cpu").transform(
                pipe.RecordToFeature().transform(rec)))
        f.mat = np.concatenate([f.mat] * 2, axis=1)      # 300 x 600
        staged = device.DeviceAugPrepare(device.DeviceAugParam()).transform(f)
        assert staged["size"].tolist() == [256, 512], staged["size"]
        img, gt = synthetic.render_shapes_image(np.random.RandomState(3), 412)
        recs = [rec, records.SSDByteRecord(
            native.encode_jpeg(np.concatenate([f.mat[:, :300]] * 2, 1)),
            "wide.jpg", rec.gt), records.SSDByteRecord(
            native.encode_jpeg(img), "big.jpg", gt)]
        val = records.write_ssd_records(recs, {str(tmp_path / 'v')!r}, 1)
        torch.cuda.is_available = lambda: True
        native.codec_for = lambda device: "libjpeg"
        param = pipe.PreProcessParam(batch_size=2)
        (a, b) = pipe.load_val_set(val[0], param)
        (c, d) = pipe.serving_chain(param, uint8=True)(recs)
        np.savez({str(out_path)!r}, val=np.concatenate([a["input"],
                 b["input"]]), val_info=np.concatenate([a["im_info"],
                 b["im_info"]]), serve=np.concatenate([c["input"],
                 d["input"]]), serve_info=np.concatenate([c["im_info"],
                 d["im_info"]]), n_valid=d["n_valid"])
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    got = np.load(out_path)
    param = pipe.PreProcessParam(batch_size=2)
    val = list(pipe.load_val_set(str(tmp_path / "v-*"), param, device="cpu"))
    want = np.concatenate([b["input"] for b in val])
    assert got["val"].shape == want.shape == (3, 300, 300, 3)
    np.testing.assert_allclose(got["val"], want, rtol=0, atol=1e-4)
    info = np.concatenate([b["im_info"] for b in val])
    np.testing.assert_array_equal(got["val_info"], info)
    # the two records of other sizes were resized, not zero-filled
    np.testing.assert_allclose(info[1:, 2:], [[1, 0.5], [300 / 412] * 2],
                               rtol=1e-6)
    recs = list(records.read_ssd_records([str(tmp_path / "v-00000-of-00001"
                                              ".azr")]))
    served = list(pipe.serving_chain(param, uint8=True, device="cpu")(recs))
    want = np.concatenate([b["input"] for b in served])
    assert int(got["n_valid"]) == served[-1]["n_valid"] == 1
    assert np.abs(got["serve"].astype(int) - want).max() <= 1
    np.testing.assert_array_equal(
        got["serve_info"], np.concatenate([b["im_info"] for b in served]))
