"""SSD's command-line entry points on the port, on the CPU
(``analytics_zoo_tpu_torch/examples/`` and
``tools/eval_quantized_ssd.py``), with ``--device cpu``:

- every option of the reference's scripts, read with ``ast`` from
  ``examples/*.py`` and ``tools/eval_quantized_ssd.py`` (nothing of them
  is imported), has its counterpart with the same default and choices;
  ``--device`` (default ``cuda``) is the only option added;
- weights of a seeded JAX ``SSDVgg(4, 300)`` carried across: the tool's
  ``fp`` rung (``--backend xla``) on 8 shapes validation images of seed
  1 gives the reference ``Validator`` + ``PascalVocEvaluator``'s VOC07
  mAP and AP per class on the same ``.azr`` files within ``MAP_TOL``;
- the rungs, on those weights and 1 image: the plain versions of K2
  (``fused``) and K1 (``pallas``) score equal, and each rung's mAP equals a direct ``Validator`` /
  ``SSDPredictor(compute_dtype="bf16")`` pass;
- the shapes run at a tiny size, its report, snapshot and
  ``--params-out``; the README's chain over a tiny VOC folder;
- F6 on the CPU: the priors placed by ``host_constant`` leave
  ``MultiBoxLoss`` and ``SSDMeanAveragePrecision`` bit-equal.

One module-scoped set of shapes records, one set of carried weights, one
trained model and one chain folder are shared by the tests.
"""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from analytics_zoo_tpu import pipelines as jpipe
from analytics_zoo_tpu.core.module import Model as JaxModel
from analytics_zoo_tpu.models import ssd as jax_ssd
from analytics_zoo_tpu.ops import DetectionOutputParam as JaxPost
from analytics_zoo_tpu.pipelines import evaluation as jev
from analytics_zoo_tpu_torch.data import (SHAPE_CLASSES,
                                          generate_shapes_records, native)
from analytics_zoo_tpu_torch.data.synthetic import render_shapes_image
from analytics_zoo_tpu_torch.examples import (generate_records, predict_ssd,
                                              test_ssd, train_shapes_e2e,
                                              train_ssd)
from analytics_zoo_tpu_torch.examples.common import load_ssd_model
from analytics_zoo_tpu_torch.models import SSDVgg, build_priors, ssd300_config
from analytics_zoo_tpu_torch.ops import DetectionOutputParam
from analytics_zoo_tpu_torch.ops.detection_output import detection_output
from analytics_zoo_tpu_torch.ops.multibox_loss import (MultiBoxLoss,
                                                       MultiBoxLossParam,
                                                       multibox_loss)
from analytics_zoo_tpu_torch.pipelines import (MeanAveragePrecision,
                                               PascalVocEvaluator,
                                               PreProcessParam,
                                               SSDMeanAveragePrecision,
                                               SSDPredictor, VOC_CLASSES,
                                               Validator, load_val_set)
from analytics_zoo_tpu_torch.tools import eval_quantized_ssd as tool
from analytics_zoo_tpu_torch.utils.convert import ssd_params_from_jax
from analytics_zoo_tpu_torch.utils.device import host_constant
from test_torch_ssd import seeded_flax_params

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
N_CLASSES = len(SHAPE_CLASSES)
# VOC07 mAP and AP per class, port against reference on the same records
# and weights: both sum the same 11-point precisions over the same
# ranked detections; scores agree to ~1e-6, so a rank can swap only at a
# near tie
MAP_TOL = 1e-4
PORT = {"generate_records": generate_records, "train_ssd": train_ssd,
        "test_ssd": test_ssd, "predict_ssd": predict_ssd,
        "train_shapes_e2e": train_shapes_e2e, "eval_quantized_ssd": tool}
REFERENCE = {name: ROOT / ("tools" if name == "eval_quantized_ssd"
                           else "examples") / f"{name}.py" for name in PORT}
# the one default that differs: the tool never overwrites the reference's
# banked INT8_MAP_PARITY.json
PORT_DEFAULTS = {("eval_quantized_ssd", ("--out",)):
                 "INT8_MAP_PARITY_torch.json"}


# -- the options -------------------------------------------------------------


def _literal(node):
    if isinstance(node, ast.Name):
        return node.id                    # type=int, type=float
    return ast.literal_eval(node)


def reference_options(path: Path):
    """``{flags: {keyword: value}}`` of every ``add_argument`` call."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            flags = tuple(a.value for a in node.args)
            out[flags] = {k.arg: _literal(k.value) for k in node.keywords
                          if k.arg != "help"}
    return out


@pytest.mark.parametrize("name", sorted(PORT))
def test_options_match_reference(name):
    ref = reference_options(REFERENCE[name])
    actions = {tuple(a.option_strings): a
               for a in PORT[name].build_parser()._actions
               if a.option_strings != ["-h", "--help"]}
    assert set(actions) == set(ref) | {("--device",)}
    assert actions[("--device",)].default == "cuda"
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


def report_keys(path: Path):
    """The keys of the dict a reference script assigns to ``report``."""
    return next([ast.literal_eval(k) for k in n.value.keys]
                for n in ast.walk(ast.parse(path.read_text()))
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "report")


# -- weights carried across, and mAP held to the reference -------------------


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("ssd_entry")


@pytest.fixture(scope="module")
def val8(work):
    """8 shapes validation images of seed 1, as the tool makes them."""
    prefix = str(work / "val8")
    generate_shapes_records(prefix, n_images=8, resolution=300,
                            num_shards=2, seed=1, device="cpu")
    return prefix + "-*.azr"


@pytest.fixture(scope="module")
def bridged(work):
    """A seeded JAX ``SSDVgg(4, 300)``, its flax params, and its weights
    carried across and saved as the port's ``--params`` file."""
    jmod = jax_ssd.SSDVgg(num_classes=N_CLASSES, resolution=300)
    params = seeded_flax_params(jmod, 300)
    tmod = SSDVgg(N_CLASSES, 300, device="cpu", seed=1)
    tmod.load_state_dict(ssd_params_from_jax(params, tmod))
    path = str(work / "bridged.pt")
    torch.save(tmod.state_dict(), path)      # what Model.save writes
    return jmod, params, path


def test_fp_map_equals_reference_validator(val8, bridged):
    jmod, params, path = bridged
    jpre = jpipe.PreProcessParam(batch_size=8, resolution=300, max_gt=8)
    jres = jpipe.Validator(
        JaxModel(jmod, {"params": params}), jpre,
        evaluator=jev.MeanAveragePrecision(n_classes=N_CLASSES),
        post=JaxPost(n_classes=N_CLASSES)).test(
            jpipe.load_val_set(val8, jpre))
    want = jev.PascalVocEvaluator(class_names=SHAPE_CLASSES).evaluate(jres)

    model = load_ssd_model(path, N_CLASSES, 300, "cpu")
    pre = PreProcessParam(batch_size=8, resolution=300, max_gt=8)
    (name, quantize, dtype, post), *_ = tool.rungs(N_CLASSES, "xla", False)
    assert name == "fp" and post.backend == "xla"
    got, res = tool.rung_map(model.module, pre, val8, post, quantize, dtype,
                             "cpu")
    assert want > 0
    assert abs(got - want) <= MAP_TOL, (got, want)
    np.testing.assert_allclose(res.ap_per_class(), jres.ap_per_class(),
                               rtol=0, atol=MAP_TOL)


# -- the shapes run, its snapshot and its weights ----------------------------


@pytest.fixture(scope="module")
def shapes_run(work):
    """``train_shapes_e2e.main`` at a tiny size, its temporary folder kept
    (``--out`` appended, ``--params-out`` written)."""
    import tempfile

    class Kept:
        def __init__(self, *a, **k):
            self.path = str(work / "shapes")
            os.makedirs(self.path)

        def __enter__(self):
            return self.path

        def __exit__(self, *exc):
            return False

    params = str(work / "shapes.pt")
    out = str(work / "report.md")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "TemporaryDirectory", Kept)
        rc = train_shapes_e2e.main([
            "--train-images", "8", "--val-images", "4", "--epochs", "1",
            "--batch-size", "4", "--params-out", params, "--out", out,
            "--device", "cpu"])
    return rc, params, out, work / "shapes"


def test_shapes_run_report_snapshot_and_params(shapes_run):
    rc, params, out, workdir = shapes_run
    assert rc == 1                          # mAP ≤ 0.5 after two steps
    text = Path(out).read_text()
    report = json.loads(text.split("```json\n")[1].split("```")[0])
    assert list(report) == report_keys(REFERENCE["train_shapes_e2e"])
    assert (report["train_images"], report["val_images"],
            report["epochs_max"], report["batch_size"]) == (8, 4, 1, 4)
    assert report["device"] == report["backend"] == "cpu"
    assert set(report["ap_per_class"]) == set(SHAPE_CLASSES[1:])
    manifest = json.loads((workdir / "ckpt" / "latest" / "manifest.json")
                          .read_text())
    assert (manifest["meta"]["epoch"], manifest["meta"]["state_step"]) == (1, 2)
    # --params-out loads where test_ssd and the tool read it
    mean_ap = test_ssd.evaluate(test_ssd.build_parser().parse_args([
        "-f", str(workdir / "val-*.azr"), "--model", params, "-b", "4",
        "--class-number", str(N_CLASSES), "--device", "cpu"]))
    assert mean_ap == pytest.approx(report["final_map_voc07"], abs=5e-5)
    # the tool reads --params through the same loader
    assert tool.load_ssd_model(params, N_CLASSES, 300, "cpu").device.type \
        == "cpu"


@pytest.fixture(scope="module")
def rung_report(bridged, work):
    """The tool on the weights carried from JAX (which detect: the shapes
    run's two steps leave every rung at mAP 0): 1 validation image of
    seed 1, ``--backend fused --approx``, through ``main``; with its
    report, each rung's unrounded mAP (what ``run`` returned to
    ``main``)."""
    params = bridged[2]
    out = work / "rungs.json"
    returned = []

    def spy(args, run=tool.run):
        returned.append(run(args))
        return returned[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tool, "run", spy)
        assert tool.main(["--params", params, "--val-images", "1",
                          "--batch-size", "1", "--approx", "--out",
                          str(out), "--device", "cpu"]) == 0
    prefix = str(work / "val1")
    generate_shapes_records(prefix, n_images=1, resolution=300,
                            num_shards=2, seed=1, device="cpu")
    report, maps = returned[0]
    assert json.loads(out.read_text()) == report
    assert report["val_images"] == 1
    return report, maps, params, prefix + "-*.azr"


def test_tool_report_and_rungs(rung_report):
    report, maps, params, val1 = rung_report
    ref_keys = report_keys(REFERENCE["eval_quantized_ssd"])
    assert list(report) == [k for k in ref_keys if k != "backend"] + [
        "delta_bf16", "backend", "device", "delta_approx_topk",
        "run_metadata"]
    assert report["run_metadata"]["tool"] == "eval_quantized_ssd"
    assert report["detout_backend"] == "fused"
    assert list(report["map"]) == ["fp", "int8_weight_only", "int8_compute",
                                   "bf16", "fp_approx_topk"]
    assert maps["fp"] > 0          # so the equalities below are not of 0s
    # the K2 rung (fused) and the K1 rung (pallas) score equal
    assert report["delta_approx_topk"] == 0.0
    model = load_ssd_model(params, N_CLASSES, 300, "cpu").module
    pre = PreProcessParam(batch_size=1, resolution=300, max_gt=8)
    assert {k: round(v, 4) for k, v in maps.items()} == report["map"]
    pallas, _ = tool.rung_map(model, pre, val1, DetectionOutputParam(
        n_classes=N_CLASSES, backend="pallas"), device="cpu")
    assert maps["fp"] == pallas == maps["fp_approx_topk"]

    # each rung against a direct pass on the same images
    def direct(quantize=False, compute_dtype=None):
        post = DetectionOutputParam(n_classes=N_CLASSES, backend="fused")
        if compute_dtype is None:
            result = Validator(model, pre, MeanAveragePrecision(
                n_classes=N_CLASSES), post=post, quantize=quantize,
                device="cpu").test(load_val_set(val1, pre, device="cpu"))
        else:
            pred = SSDPredictor(model, pre, post=post, n_classes=N_CLASSES,
                                compute_dtype=compute_dtype, device="cpu")
            evaluator = MeanAveragePrecision(n_classes=N_CLASSES)
            result = None
            for batch in load_val_set(val1, pre, device="cpu"):
                r = evaluator(pred.detect_normalized(batch["input"]).numpy(),
                              batch)
                result = r if result is None else result + r
        return PascalVocEvaluator(class_names=SHAPE_CLASSES).evaluate(result)

    assert direct(quantize=True) == maps["int8_weight_only"]
    assert direct(quantize="int8") == maps["int8_compute"]
    assert direct(compute_dtype="bf16") == maps["bf16"]
    assert report["delta_bf16"] == round(maps["bf16"] - maps["fp"], 6)


# -- the README's chain ------------------------------------------------------


def _voc_folder(root: Path, n: int = 2) -> Path:
    """A VOCdevkit with ``n`` rendered images and their XML annotations
    (shape classes named as the first VOC classes)."""
    voc = root / "VOCdevkit" / "VOC2007"
    for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (voc / sub).mkdir(parents=True)
    rng = np.random.RandomState(3)
    ids = []
    for i in range(n):
        img, gt = render_shapes_image(rng, 300)
        img_id = f"{i:06d}"
        ids.append(img_id)
        (voc / "JPEGImages" / f"{img_id}.jpg").write_bytes(
            native.encode_jpeg(img, 92, codec="libjpeg"))
        objs = "".join(
            f"<object><name>{VOC_CLASSES[int(c)]}</name><difficult>0"
            f"</difficult><bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>"
            f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"
            for c, _, x1, y1, x2, y2 in gt)
        (voc / "Annotations" / f"{img_id}.xml").write_text(
            f"<annotation>{objs}</annotation>")
    (voc / "ImageSets" / "Main" / "trainval.txt").write_text(
        "\n".join(ids) + "\n")
    return root / "VOCdevkit"


def test_readme_chain(work, shapes_run, capsys, caplog):
    """generate_records → train_ssd -e 1 → test_ssd → predict_ssd over a
    tiny VOC folder, as the README runs them; the ``model.pt`` that
    ``train_ssd`` writes into its checkpoint directory is the model the
    last two read.  ``--weights-npz`` loads by layer name.
    ``--vis`` draws, with the shapes run's weights: one SGD step of two
    randomly augmented images at the reference's learning rate can leave
    boxes no image can hold (inf), which the reference's drawing refuses
    too."""
    devkit = _voc_folder(work / "chain")
    prefix = str(work / "chain" / "train")
    assert generate_records.main(["-f", str(devkit), "--imageset",
                                  "voc_2007_trainval", "-o", prefix, "-p",
                                  "2", "--device", "cpu"]) == 0
    records = prefix + "-*.azr"
    ckpt = str(work / "chain" / "ckpt")
    npz = str(work / "chain" / "conv1_1.npz")
    w = np.random.RandomState(4).randn(64, 3, 3, 3).astype(np.float32) * 0.1
    np.savez(npz, **{"conv1_1/weight": w,
                     "conv1_1/bias": np.zeros(64, np.float32)})
    with caplog.at_level("INFO", logger="analytics_zoo_tpu_torch"):
        assert train_ssd.main(["-f", records, "-e", "1", "-b", "2",
                               "--checkpoint", ckpt, "--weights-npz", npz,
                               "--device", "cpu"]) == 0
    assert "loaded 2 tensors" in caplog.text
    assert (Path(ckpt) / "latest" / "manifest.json").exists()
    ckpt = str(Path(ckpt) / "model.pt")
    capsys.readouterr()
    assert test_ssd.main(["-f", records, "--model", ckpt, "-b", "2",
                          "--device", "cpu"]) == 0
    assert "Mean AP = " in capsys.readouterr().out
    out = work / "chain" / "out"
    images = devkit / "VOC2007" / "JPEGImages"
    assert predict_ssd.main(["-f", str(images), "--model", ckpt, "-o",
                             str(out), "--conf", "0.0", "-b", "2",
                             "--device", "cpu"]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "000000.txt", "000001.txt"]
    drawn = work / "chain" / "drawn"
    one = work / "chain" / "one"
    one.mkdir()
    (one / "000000.jpg").write_bytes((images / "000000.jpg").read_bytes())
    assert predict_ssd.main(["-f", str(one), "--model", shapes_run[1],
                             "--class-number", str(N_CLASSES), "-o",
                             str(drawn), "--conf", "0.0", "--vis", "-b",
                             "1", "--device", "cpu"]) == 0
    assert sorted(p.name for p in drawn.iterdir()) == [
        "000000.txt", "000000_det.jpg"]
    for p in out.iterdir():
        for line in filter(None, p.read_text().split("\n")):
            name, score, *box = line.split()
            assert name in VOC_CLASSES and len(box) == 4
    # the wire the port has not ported is refused, not ignored
    with pytest.raises(NotImplementedError, match="deferred item e"):
        train_ssd.main(["-f", records, "-e", "1", "--device-aug",
                        "--wire-format", "yuv420", "--device", "cpu"])
    # a PNG is refused by name before anything runs
    png = work / "chain" / "png"
    png.mkdir()
    (png / "a.jpg").write_bytes((images / "000000.jpg").read_bytes())
    (png / "b.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 16)
    with pytest.raises(SystemExit, match="b.png"):
        predict_ssd.main(["-f", str(png), "--model", ckpt, "--device",
                          "cpu"])


# -- F6 on the CPU -----------------------------------------------------------


def test_priors_placed_once_leave_loss_and_detections_bit_equal():
    priors, variances = build_priors(ssd300_config())
    P = priors.shape[0]
    rng = np.random.RandomState(0)
    loc = torch.from_numpy((rng.randn(2, P, 4) * 0.3).astype(np.float32))
    conf = torch.from_numpy(rng.randn(2, P, N_CLASSES).astype(np.float32))
    lo = rng.rand(2, 3, 2) * 0.5
    target = {"bboxes": np.concatenate([lo, lo + 0.3], -1).astype(
        np.float32), "labels": np.array([[1, 2, 3], [3, 1, 0]], np.int32),
        "mask": np.array([[1, 1, 1], [1, 1, 0]], np.float32)}
    param = MultiBoxLossParam(n_classes=N_CLASSES)
    crit = MultiBoxLoss(priors, variances, param)
    want = multibox_loss(loc, conf, torch.as_tensor(priors),
                         torch.as_tensor(variances),
                         torch.as_tensor(target["bboxes"]),
                         torch.as_tensor(target["labels"]),
                         torch.as_tensor(target["mask"]), param)
    for _ in range(2):                       # placed once, reused
        assert torch.equal(crit((loc, conf), target), want)
    assert len(crit._on) == 1
    metric = SSDMeanAveragePrecision(n_classes=N_CLASSES, resolution=300)
    dets = detection_output(loc, torch.softmax(conf, -1),
                            torch.as_tensor(priors),
                            torch.as_tensor(variances), metric.post)
    for _ in range(2):
        assert torch.equal(metric.detect((loc, conf)), dets)
    assert len(metric._on) == 1
    assert torch.equal(host_constant(priors, "cpu"), torch.as_tensor(priors))
