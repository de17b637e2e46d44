"""The port's tools (``analytics_zoo_tpu_torch/tools/``) against the
reference's (``tools/``), on the CPU.

- ``profile_serve``: ``bias_background`` on weights carried through
  ``utils/convert.py`` EQUAL to the reference's; a tiny run through
  ``main`` (the reference's keys, the stamp, no launch on the CPU);
- ``export_serving``: the artifact's int8 tensors and scales EQUAL to
  the reference's ``quantize_params`` on carried weights (SSD300 at 2
  classes, DS2 at hidden 64); DS2's quantized forward against the
  reference's within 1e-4 of the output's scale (both dequantize the
  same int8 weights; the sums' order differs);
- ``convert_caffe``: the npz EQUAL, key for key and array for array, to
  the reference tool's on one seeded caffemodel (with and without
  ``--ssd``); ``--build``'s state dict;
- ``seqfile_to_azr``: its SequenceFile bytes EQUAL to the reference
  writer's, and its ``.azr`` shards EQUAL to the reference tool's from
  the same SequenceFile;
- ``serve_drill --smoke``: the report EQUAL to the reference's but the
  stamp (accounting, miss rates, ladder, pool and chaos events are
  virtual-time outcomes; no field depends on the tiers' float rows);
- ``obs_drill``: span conservation and the reconciliation with the
  accounting, the flight recording byte-EQUAL to the reference's;
- ``az_trace``: the smoke drill's report EQUAL to the reference's but
  the stamp, the query modes' output EQUAL to the reference's on the
  port's recording, ``sentinel_diff`` clean against itself and firing on
  a seeded tail regression;
- ``check_artifacts``: the port's lint on a temporary directory, and the
  port's default names outside the reference's lint.

The overhead A/B's timed chunks run on the card only (``chip_smoke.py``'s
``tools`` phase).
"""

import contextlib
import copy
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax.numpy as jnp  # noqa: E402

from analytics_zoo_tpu.core.module import Model as JaxModel  # noqa: E402
from analytics_zoo_tpu.models import DeepSpeech2 as JaxDS2  # noqa: E402
from analytics_zoo_tpu.models import ssd as jax_ssd  # noqa: E402
from analytics_zoo_tpu.utils import quantize as jq  # noqa: E402
from analytics_zoo_tpu_torch.core.module import Model  # noqa: E402
from analytics_zoo_tpu_torch.models import DeepSpeech2, SSDVgg  # noqa: E402
from analytics_zoo_tpu_torch.ops.pallas_nms import (  # noqa: E402
    phase_split_us)
from analytics_zoo_tpu_torch.tools import (az_trace, check_artifacts,  # noqa
                                           convert_caffe, export_serving,
                                           obs_drill, profile_serve,
                                           seqfile_to_azr, serve_drill)
from analytics_zoo_tpu_torch.utils import caffe  # noqa: E402
from analytics_zoo_tpu_torch.utils import quantize as tq  # noqa: E402
from analytics_zoo_tpu_torch.utils.convert import (  # noqa: E402
    ds2_params_from_jax, quantized_params_from_jax, ssd_params_from_jax)
from test_torch_ssd import seeded_flax_params  # noqa: E402
from tools import az_trace as ref_az_trace  # noqa: E402
from tools import check_artifacts as ref_check  # noqa: E402
from tools import convert_caffe as ref_convert_caffe  # noqa: E402
from tools import obs_drill as ref_obs_drill  # noqa: E402
from tools import profile_serve as ref_profile_serve  # noqa: E402
from tools import seqfile_to_azr as ref_seqfile  # noqa: E402
from tools import serve_drill as ref_serve_drill  # noqa: E402

torch.set_num_threads(2)


def _unstamped(report):
    return {k: v for k, v in report.items() if k != "run_metadata"}


@pytest.fixture(scope="module")
def ssd2():
    """A flax SSD300 at 2 classes with seeded weights, and the port's
    model on the same weights."""
    jmod = jax_ssd.SSDVgg(num_classes=2, resolution=300)
    params = seeded_flax_params(jmod, 300, seed=3)
    tmod = SSDVgg(2, 300, device="cpu")
    tmod.load_state_dict(ssd_params_from_jax(params, tmod))
    return params, tmod


# -- profile_serve -------------------------------------------------------------


def test_bias_background_equals_reference(ssd2):
    """Conf-head channel j is class j % C in both layouts, so shifting
    the reference's flax biases and carrying them equals carrying them
    and shifting the port's state dict."""
    params, tmod = ssd2
    want = ssd_params_from_jax(
        ref_profile_serve.bias_background(params, 2, 8.0), tmod)
    got = profile_serve.bias_background(tmod.state_dict(), 2, 8.0)
    assert set(got) == set(want)
    changed = [k for k in got if not torch.equal(got[k],
                                                 tmod.state_dict()[k])]
    assert changed and all(profile_serve.CONF_BIAS.search(k)
                           for k in changed)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_profile_serve_runs_on_the_cpu(tmp_path):
    """A batch of 1 through ``main`` for each backend: the reference's
    keys, the stamp, no kernel launched on the CPU, the port's lint
    clean on what it wrote."""
    ref_keys = {
        "fused": {"detout_ladder_decode_and_stream",
                  "detout_ladder_select_and_sweep",
                  "detout_ladder_global_topk_merge", "detout_full_kernel"},
        "pallas": {"detout_decode_topk", "detout_decode_topk_approx",
                   "detout_pallas_sweep", "detout_final_topk"}}
    for backend, keys in ref_keys.items():
        out = tmp_path / f"SERVE_PROFILE_{backend}_torch.json"
        assert profile_serve.main(["--batch", "1", "--iters", "1",
                                   "--backend", backend, "--device", "cpu",
                                   "--out", str(out)]) == 0
        report = json.loads(out.read_text())
        assert keys <= set(report["ms"])
        assert {"full_serve_program", "backbone_only",
                "detection_output_total"} <= set(report["ms"])
        assert report["launches"] == {
            "nms_sweep": 0, "fused_detection_output_by_stage": {
                "decode": 0, "select": 0, "full": 0}}
        assert report["device"] == "cpu" and report["priors"] == 8732
        assert "not strict prefixes" in json.dumps(
            report["detout_coherence"]).lower() or backend == "pallas"
    assert check_artifacts.check_artifacts(str(tmp_path)) == []


def test_phase_split_counts_unreached_phases_zero():
    """A stamp block 0 never wrote (0) is a phase it skipped: 0 µs, and
    the phases still sum to the block's time."""
    stamps = torch.tensor([1000, 2000, 0, 5000, 0, 0], dtype=torch.int64)
    split = phase_split_us(stamps, ("a", "b", "c", "d", "e"))
    assert split == {"a": 1.0, "b": 0.0, "c": 3.0, "d": 0.0, "e": 0.0}
    assert sum(split.values()) == 4.0


# -- export_serving ------------------------------------------------------------


def _assert_qparams_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, tq.QTensor):
            assert isinstance(got[k], tq.QTensor), k
            assert torch.equal(got[k].q, v.q), k
            assert torch.equal(got[k].scale, v.scale), k
        else:
            assert torch.equal(got[k], v), k


def test_export_serving_ssd300_equals_reference(ssd2, tmp_path):
    params, tmod = ssd2
    model_file = str(tmp_path / "ssd.pt")
    Model(tmod, device="cpu").save(model_file)
    out = str(tmp_path / "ssd_int8.npz")
    assert export_serving.main(["--model-file", model_file, "--arch",
                                "ssd300", "--classes", "2", "--out", out,
                                "--device", "cpu"]) == 0
    got = tq.load_quantized_npz(out)
    want = quantized_params_from_jax(jq.quantize_params({"params": params}),
                                     tmod)
    _assert_qparams_equal(got, want)
    assert sum(isinstance(v, tq.QTensor) for v in got.values()) >= 20


def test_export_serving_ds2_from_a_snapshot_equals_reference(tmp_path):
    """DS2 at hidden 64 from a checkpoint snapshot, ``--verify`` on: the
    quantized leaves (conv1, proj1/2, every h2h) EQUAL the reference's,
    and the port's quantized forward, which reads conv1's and the cells'
    weights itself, follows the reference's."""
    from analytics_zoo_tpu_torch.parallel import checkpoint

    jmod = JaxDS2(hidden=64)
    jm = JaxModel(jmod)
    jm.build(0, jnp.zeros((1, 100, 13), jnp.float32))
    tmod = DeepSpeech2(hidden=64, device="cpu")
    tmod.load_state_dict(ds2_params_from_jax(jm.variables, tmod))
    snap = str(tmp_path / "ckpt")
    checkpoint.save(snap, {"model": tmod.state_dict(), "step": 3}, step=3)
    out = str(tmp_path / "ds2_int8.npz")
    report = export_serving.run(export_serving.build_parser().parse_args(
        ["--checkpoint", snap, "--arch", "ds2", "--hidden", "64", "--out",
         out, "--verify", "--device", "cpu"]))
    assert report["verify"]["seeded"]["rel"] < export_serving.VERIFY_REL_MAX
    got = tq.load_quantized_npz(out)
    jqv = jq.quantize_params(jm.variables)
    quantized = [k for k, v in got.items() if isinstance(v, tq.QTensor)]
    assert len(quantized) == 9           # conv1, proj1, proj2, six h2h

    def carried(leaf_fn):
        """The reference's quantized leaves as ``leaf_fn(q, scale)``,
        carried into the port's names and layouts by the DS2 bridge."""
        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            if hasattr(t, "q"):
                return leaf_fn(np.asarray(t.q), np.asarray(t.scale))
            return t
        return ds2_params_from_jax(
            {"params": walk(jqv["params"]),
             "batch_stats": jm.variables["batch_stats"]}, tmod)

    want_q = carried(lambda q, s: q.astype(np.float32))
    want_dq = carried(lambda q, s: q.astype(np.float32) * s)
    for k in quantized:
        assert torch.equal(got[k].q.float(), want_q[k]), k
        assert torch.equal(got[k].dequant(), want_dq[k]), k
    x = np.random.RandomState(1).randn(2, 100, 13).astype(np.float32)
    ref = np.asarray(jq.make_quantized_forward(jmod)(jqv, jnp.asarray(x)))
    port = tq.make_quantized_forward(tmod)(got, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


# -- convert_caffe -------------------------------------------------------------


def _seeded_caffe_net(mod, rng):
    """SSD-named layers of every blob convention."""
    L = mod.CaffeLayer

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return mod.CaffeNet(name="seeded", layers=[
        L("conv1_1", "Convolution", ["data"], ["conv1_1"],
          [r(4, 3, 3, 3), r(4)]),
        L("conv4_3_norm", "Normalize", ["conv1_1"], ["n"], [r(4)]),
        L("fc7_mbox_loc", "Convolution", ["n"], ["l"], [r(8, 4, 3, 3),
                                                        r(8)]),
        L("fc7_mbox_conf", "Convolution", ["n"], ["c"], [r(6, 4, 3, 3),
                                                         r(6)]),
        L("bn1", "BatchNorm", ["c"], ["c"], [r(6), np.abs(r(6)),
                                             np.asarray([2.0], np.float32)]),
        L("sc1", "Scale", ["c"], ["c"], [r(6), r(6)]),
        L("fc1", "InnerProduct", ["c"], ["f"], [r(5, 6), r(5)]),
        L("odd", "PReLU", ["f"], ["f"], [r(5)]),
    ])


@pytest.mark.parametrize("ssd", [None, "300"])
def test_convert_caffe_npz_equals_reference(tmp_path, ssd):
    path = str(tmp_path / "seeded.caffemodel")
    caffe.save_caffemodel(path, _seeded_caffe_net(caffe,
                                                  np.random.default_rng(0)))
    extra = ["--ssd", ssd] if ssd else []
    got, want = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    assert convert_caffe.main([path, "-o", got, *extra]) == 0
    assert ref_convert_caffe.main([path, "-o", want, *extra]) == 0
    g, w = np.load(got), np.load(want)
    assert sorted(g.files) == sorted(w.files)
    if ssd:
        assert "loc_1/weight" in g.files
        assert "conv4_3_norm/cmul/weight" in g.files
    for k in w.files:
        assert g[k].dtype == w[k].dtype
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_convert_caffe_build_writes_the_graphs_state(tmp_path):
    proto = tmp_path / "deploy.prototxt"
    proto.write_text("""
name: "tiny"
input: "data"
input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "fc1" type: "InnerProduct" bottom: "conv1" top: "fc1"
  inner_product_param { num_output: 5 } }
""")
    rng = np.random.default_rng(1)
    net = caffe.CaffeNet(name="tiny", layers=[
        caffe.CaffeLayer("conv1", "Convolution", blobs=[
            rng.standard_normal((4, 3, 3, 3)).astype(np.float32),
            rng.standard_normal(4).astype(np.float32)]),
        caffe.CaffeLayer("fc1", "InnerProduct", blobs=[
            rng.standard_normal((5, 256)).astype(np.float32),
            rng.standard_normal(5).astype(np.float32)])])
    model = str(tmp_path / "tiny.caffemodel")
    caffe.save_caffemodel(model, net)
    out = str(tmp_path / "tiny.pt")
    result = convert_caffe.run(convert_caffe.build_parser().parse_args(
        [model, "--prototxt", str(proto), "--build", "--input-shape",
         "1,8,8,3", "-o", out, "--device", "cpu"]))
    assert result["report"]["missing"] == []
    assert result["report"]["unused"] == []
    state = torch.load(out)
    graph = caffe.build_caffe_graph(caffe.parse_prototxt(str(proto)),
                                    input_shape=(1, 8, 8, 3), device="cpu")
    graph.load_state_dict(state)
    np.testing.assert_array_equal(state["conv1.weight"].numpy(),
                                  net.layers[0].blobs[0])


# -- seqfile_to_azr ------------------------------------------------------------


def _records(n=7):
    from analytics_zoo_tpu_torch.data.records import SSDByteRecord

    rng = np.random.RandomState(4)
    out = []
    for i in range(n):
        gt = np.concatenate([rng.randint(1, 21, (i % 3, 2)),
                             rng.rand(i % 3, 4) * 300], 1).astype(np.float32)
        out.append(SSDByteRecord(data=bytes(rng.randint(0, 256, 50 + i,
                                                        dtype=np.uint8)),
                                 path=f"img{i}.jpg", gt=gt))
    return out


def test_seqfile_to_azr_bytes_equal_reference_both_ways(tmp_path,
                                                        monkeypatch):
    """Port → reference format: the port's SequenceFile equals the
    reference writer's bytes (one sync marker for both); reference
    format → .azr: the port's shards equal the reference tool's."""
    sync = bytes(range(16))
    monkeypatch.setattr(ref_seqfile.os, "urandom", lambda n: sync)
    pairs = [seqfile_to_azr.encode_reference_record(r) for r in _records()]
    assert pairs == [ref_seqfile.encode_reference_record(r)
                     for r in _records()]
    port_seq, ref_seq = tmp_path / "port.seq", tmp_path / "ref.seq"
    seqfile_to_azr.write_sequence_file(str(port_seq), pairs, sync=sync)
    ref_seqfile.write_sequence_file(str(ref_seq), pairs)
    assert port_seq.read_bytes() == ref_seq.read_bytes()
    assert list(seqfile_to_azr.read_sequence_file(str(ref_seq))) == pairs

    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    assert seqfile_to_azr.main([str(ref_seq), "-o",
                                str(tmp_path / "port" / "voc"), "-p",
                                "3"]) == 0
    assert ref_seqfile.main([str(ref_seq), "-o", str(tmp_path / "ref" /
                                                     "voc"), "-p", "3"]) == 0
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 3
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "ref" / n).read_bytes()), n
    for v in (0, 1, -1, 127, -112, -113, 128, 2 ** 31 - 1, -2 ** 31):
        assert seqfile_to_azr.write_vint(v) == ref_seqfile.write_vint(v)
        assert seqfile_to_azr.read_vint(seqfile_to_azr.write_vint(v),
                                        0)[0] == v


# -- the drills ----------------------------------------------------------------


def test_serve_drill_smoke_equals_reference(tmp_path):
    out, ref_out = tmp_path / "SERVE_DRILL_torch.json", tmp_path / "r.json"
    assert serve_drill.main(["--smoke", "--device", "cpu", "--out",
                             str(out)]) == 0
    assert ref_serve_drill.main(["--smoke", "--out", str(ref_out)]) == 0
    got, want = json.loads(out.read_text()), json.loads(ref_out.read_text())
    assert got["verdict"] == "PASS" and got["checks"]["ok"]
    assert _unstamped(got) == _unstamped(want)
    assert "torch_version" in got["run_metadata"]
    assert check_artifacts.check_artifacts(str(tmp_path)) == []


def test_traced_scenario_conserves_spans_and_replays_the_reference():
    rt, obs, n_script = obs_drill.traced_scenario(seed=0, smoke=True,
                                                  device="cpu")
    acct = rt.accounting()
    from analytics_zoo_tpu_torch.obs import span_conservation

    cons = span_conservation(obs.recorder.events())
    assert cons["ok"], cons["violations"]
    assert obs.recorder.dropped == 0
    assert cons["traces"] == acct["submitted"] >= n_script
    assert cons["roots_by_status"] == acct["by_state"]
    _, ref_obs, _ = ref_obs_drill.traced_scenario(seed=0, smoke=True)
    assert obs.dump("drill_complete") == ref_obs.dump("drill_complete")


def test_obs_drill_smoke_checks_without_the_timed_ab(tmp_path):
    args = obs_drill.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--flight-out",
         str(tmp_path / "flight.jsonl")])
    report = obs_drill.run(args, overhead_chunks=0)
    assert report["verdict"] == "PASS", report["checks"]
    assert report["obs_overhead"] == {"skipped": True}
    assert "overhead_le_3pct" not in report["checks"]
    st = report["serve_trace"]
    assert st["replay_identical"] and st["events_dropped"] == 0
    assert (tmp_path / "flight.jsonl").exists()


@pytest.fixture(scope="module")
def az_drill(tmp_path_factory):
    """The port's ``az_trace --drill --smoke`` report and recording."""
    d = tmp_path_factory.mktemp("az_trace")
    out, flight = d / "AZ_TRACE_torch.json", d / "flight.jsonl"
    assert az_trace.main(["--drill", "--smoke", "--device", "cpu", "--out",
                          str(out), "--flight-out", str(flight)]) == 0
    return json.loads(out.read_text()), flight


def test_az_trace_drill_equals_reference(az_drill):
    report, _ = az_drill
    assert report["verdict"] == "PASS", report["checks"]
    want = ref_az_trace.az_trace_drill(seed=0, smoke=True)
    got = _unstamped(report)
    for k in ("drill", "revision", "seed", "smoke", "verdict"):
        got.pop(k)
    assert got == json.loads(json.dumps(want))


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_az_trace_query_modes_print_the_references_lines(az_drill):
    _, flight = az_drill
    done = next(e["trace"] for e in map(json.loads,
                                        flight.read_text().splitlines())
                if e.get("kind") == "span" and e.get("parent") is None
                and e.get("status") == "done")
    for argv in (["--attribute", "--slo-report"], ["--critical-path", done],
                 []):
        argv = ["--flight", str(flight), *argv]
        got = _printed(az_trace.main, argv)
        assert got == _printed(ref_az_trace.main, argv)
        assert got.strip()


def test_sentinel_clean_on_itself_and_fires_on_a_tail_regression(
        az_drill, tmp_path):
    report, _ = az_drill
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(report))
    code, regressions = az_trace.run_sentinel(str(path), device="cpu")
    assert (code, regressions) == (0, [])
    assert az_trace.sentinel_diff(report, report) == []
    baseline = copy.deepcopy(report)
    baseline["tail_attribution"]["percentiles"]["p99_s"] /= 2.0
    seg = baseline["tail_attribution"]["segments"]["queue_wait"]
    seg["p99_mean_s"] /= 2.0
    baseline["slo"]["peak_burns"]["shed-rate"]["fast"] /= 2.0
    text = "\n".join(az_trace.sentinel_diff(baseline, report))
    assert "p99 latency" in text
    assert "segment queue_wait" in text
    assert "peak fast burn [shed-rate]" in text
    assert (az_trace.sentinel_diff(baseline, report)
            == ref_az_trace.sentinel_diff(baseline, report))


# -- check_artifacts -----------------------------------------------------------


def test_check_artifacts_on_a_temp_dir(tmp_path):
    from analytics_zoo_tpu_torch.obs import run_metadata

    (tmp_path / "GOOD_torch.json").write_text(json.dumps(
        {"run_metadata": run_metadata("x", seed=0)}))
    (tmp_path / "NEW_torch.json").write_text('{"no": "metadata"}\n')
    (tmp_path / "BROKEN_torch.json").write_text("{truncated\n")
    (tmp_path / "PARTIAL_torch.json").write_text(
        '{"run_metadata": {"tool": "x", "jax_version": "0"}}\n')
    (tmp_path / "unrelated.json").write_text("{not linted")
    problems = check_artifacts.check_artifacts(str(tmp_path))
    assert len(problems) == 3, problems
    assert any("NEW_torch" in p and "missing run_metadata" in p
               for p in problems)
    assert any("BROKEN_torch" in p and "parse" in p for p in problems)
    assert any("PARTIAL_torch" in p and "torch_version" in p
               for p in problems)
    assert check_artifacts.main(["--root", str(tmp_path)]) == 1
    for name in ("NEW_torch.json", "BROKEN_torch.json", "PARTIAL_torch.json"):
        (tmp_path / name).unlink()
    assert check_artifacts.main(["--root", str(tmp_path)]) == 0


def test_port_artifact_names_are_outside_the_references_lint():
    """Every default ``--out`` of a port tool is governed by the port's
    lint and by none of the reference's patterns (whose stamp requires
    ``jax_version``); the repo's root is clean under the port's lint."""
    from analytics_zoo_tpu_torch.tools import eval_quantized_ssd

    names = [p.parse_args(argv).out for p, argv in (
        (profile_serve.build_parser(), []),
        (serve_drill.build_parser(), []),
        (obs_drill.build_parser(), []),
        (az_trace.build_parser(), []),
        (eval_quantized_ssd.build_parser(), ["--params", "x"]))]
    assert len(set(names)) == 5
    for n in names:
        assert check_artifacts.PATTERN.match(n), n
        assert not ref_check.PATTERN.match(n), n
        assert n not in ref_check.EXTRA_STAMPED
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    assert check_artifacts.check_artifacts(root) == []

