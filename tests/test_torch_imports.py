"""The PyTorch port stands alone: no module of ``analytics_zoo_tpu_torch``
and not ``chip_smoke.py`` imports JAX, flax, optax or the JAX package
(checked over the AST, so an import inside a function counts too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "analytics_zoo_tpu")
FILES = sorted((ROOT / "analytics_zoo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_scenarios.py"]


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists()
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# the sharding layer: what places, shards and runs a sharded weight
SHARDING = ("analytics_zoo_tpu_torch.parallel.mesh",
            "analytics_zoo_tpu_torch.parallel.tensor",
            "analytics_zoo_tpu_torch.parallel.specs")
LOWER = sorted(p for d in ("core", "ops", "models")
               for p in (ROOT / "analytics_zoo_tpu_torch" / d).rglob("*.py"))


def imported_modules(path: Path):
    """Every module an import names, ``from a import b`` as ``a`` and
    ``a.b``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", LOWER, ids=lambda p: str(p.relative_to(ROOT)))
def test_layers_below_parallel_know_no_sharding(path):
    """``core/``, ``ops/`` and ``models/`` import nothing of the sharding
    layer: a step over a mesh reaches them through ``utils/spmd.py``'s
    hooks and ``parallel/tensor.py``'s parallel subclasses."""
    bad = sorted(m for m in set(imported_modules(path))
                 if m.startswith(SHARDING))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from analytics_zoo_tpu.ops import nms\n"
                     "import jax.numpy as jnp\n")
    assert set(imported_roots(probe)) == {"analytics_zoo_tpu", "jax"}


def test_port_imports_pull_in_no_jax():
    """Importing every module of the port, the DS2 and serving slices'
    included, in a fresh interpreter loads no module of JAX, flax or the
    JAX package."""
    import subprocess
    import sys

    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (ROOT / "analytics_zoo_tpu_torch").rglob("*.py"))
    assert "analytics_zoo_tpu_torch.pipelines.deepspeech2" in mods
    assert "analytics_zoo_tpu_torch.ops.pallas_rnn" in mods
    # the serving slice: the runtime and what it stands on, quantization
    assert {"analytics_zoo_tpu_torch.serving.runtime",
            "analytics_zoo_tpu_torch.serving.replica",
            "analytics_zoo_tpu_torch.serving.autoscale",
            "analytics_zoo_tpu_torch.resilience.watchdog",
            "analytics_zoo_tpu_torch.obs.registry",
            "analytics_zoo_tpu_torch.utils.clock",
            "analytics_zoo_tpu_torch.utils.quantize"} <= set(mods)
    # the DS2 online slice: the SLO engine, the multiplexed runtime and
    # the streaming pipeline beside the decoders
    assert {"analytics_zoo_tpu_torch.obs.slo",
            "analytics_zoo_tpu_torch.serving.batcher",
            "analytics_zoo_tpu_torch.transform.audio.decoders"} <= set(mods)
    # the Faster-RCNN serving slice and the Caffe importer
    assert {"analytics_zoo_tpu_torch.ops.anchor",
            "analytics_zoo_tpu_torch.ops.proposal",
            "analytics_zoo_tpu_torch.ops.roi_pool",
            "analytics_zoo_tpu_torch.ops.frcnn",
            "analytics_zoo_tpu_torch.models.faster_rcnn",
            "analytics_zoo_tpu_torch.pipelines.frcnn",
            "analytics_zoo_tpu_torch.utils.caffe",
            "analytics_zoo_tpu_torch.utils.protowire"} <= set(mods)
    # the Faster-RCNN training slice, the Caffe graph builder's layers and
    # the SSD variants
    assert {"analytics_zoo_tpu_torch.ops.frcnn_train",
            "analytics_zoo_tpu_torch.core.layers",
            "analytics_zoo_tpu_torch.models.ssd_variants"} <= set(mods)
    # the model-zoo slice: containers, the embedding lookups, the small
    # models and the fraud, recommendation and sentiment pipelines
    assert {"analytics_zoo_tpu_torch.core.module",
            "analytics_zoo_tpu_torch.ops.embedding",
            "analytics_zoo_tpu_torch.models.simple",
            "analytics_zoo_tpu_torch.pipelines.frame",
            "analytics_zoo_tpu_torch.pipelines.fraud",
            "analytics_zoo_tpu_torch.pipelines.recommendation",
            "analytics_zoo_tpu_torch.pipelines.sentiment",
            "analytics_zoo_tpu_torch.pipelines.visualizer"} <= set(mods)
    # the checkpoint slice: snapshots, the restart supervisor, preemption
    # and the push-mode watchdog
    assert {"analytics_zoo_tpu_torch.parallel.checkpoint",
            "analytics_zoo_tpu_torch.parallel.elastic",
            "analytics_zoo_tpu_torch.resilience.preempt",
            "analytics_zoo_tpu_torch.resilience.errors"} <= set(mods)
    # the distribution slice: the engine, the mesh, the rules and the
    # parallel layers, the declare-once specs
    assert {"analytics_zoo_tpu_torch.utils.engine",
            "analytics_zoo_tpu_torch.parallel.mesh",
            "analytics_zoo_tpu_torch.parallel.tensor",
            "analytics_zoo_tpu_torch.parallel.specs",
            "analytics_zoo_tpu_torch.utils.spmd"} <= set(mods)
    # sequence, pipeline and expert parallelism and the attention models
    assert {"analytics_zoo_tpu_torch.parallel.sequence",
            "analytics_zoo_tpu_torch.parallel.pipeline",
            "analytics_zoo_tpu_torch.parallel.expert",
            "analytics_zoo_tpu_torch.models.attention"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from analytics_zoo_tpu_torch.pipelines import (StreamingDS2, "
            "ds2_serving_tiers, ds2_streaming_tiers)\n"
            "from analytics_zoo_tpu_torch.obs import SloEvaluator, "
            "model_slos\n"
            "from analytics_zoo_tpu_torch.pipelines import train_frcnn\n"
            "from analytics_zoo_tpu_torch.utils.caffe import "
            "build_caffe_graph\n"
            "from analytics_zoo_tpu_torch.models import SSDAlexNet, "
            "SSDMobileNet\n"
            "from analytics_zoo_tpu_torch.pipelines import ("
            "run_fraud_pipeline, train_recommender, train_sentiment)\n"
            "from analytics_zoo_tpu_torch.parallel import (run_resilient, "
            "FaultInjector, DivergenceDetector)\n"
            "from analytics_zoo_tpu_torch.parallel.checkpoint import "
            "CheckpointWatcher\n"
            "from analytics_zoo_tpu_torch.utils.convert import "
            "train_state_from_jax\n"
            "from analytics_zoo_tpu_torch.parallel import (SpecSet, "
            "create_mesh, pipeline_specs, default_tp_rules)\n"
            "from analytics_zoo_tpu_torch.data.parallel import "
            "make_input_pipeline\n"
            "from analytics_zoo_tpu_torch.parallel import (route_top1, "
            "pipeline_forward, pipeline_forward_het)\n"
            "from analytics_zoo_tpu_torch.parallel.sequence import ("
            "ring_attention, RingAttentionLayer, halo_exchange)\n"
            "from analytics_zoo_tpu_torch.models import (AttentionASR, "
            "sequence_parallel_forward)\n"
            "from analytics_zoo_tpu_torch.utils.convert import "
            "attention_asr_params_from_jax\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_zoo_slice_imports_without_cv2():
    """The card's import path of the model-zoo slice (the package's
    ``pipelines``, ``models``, ``ops``, ``core`` and ``parallel``) loads
    no cv2: only ``pipelines.visualizer.vis_detection`` needs it, and
    the module and its text dump (``result_to_string``) import without
    it."""
    import subprocess
    import sys

    code = ("import sys\n"
            "sys.modules['cv2'] = None\n"
            "from analytics_zoo_tpu_torch.pipelines import (\n"
            "    fraud_serving_tiers, rec_serving_tiers,\n"
            "    sentiment_serving_tiers, run_fraud_pipeline)\n"
            "from analytics_zoo_tpu_torch.core import Model, Sequential\n"
            "from analytics_zoo_tpu_torch.ops import DedupEmbed\n"
            "from analytics_zoo_tpu_torch.parallel import sparse_adam_apply\n"
            "from analytics_zoo_tpu_torch.models import SentimentNet\n"
            "import numpy as np\n"
            "from analytics_zoo_tpu_torch.pipelines.visualizer import (\n"
            "    result_to_string, vis_detection)\n"
            "assert result_to_string(np.array([[1, 0.5, 0, 0, 4, 4]])) \\\n"
            "    == 'aeroplane 0.5000 0.0 0.0 4.0 4.0'\n"
            "try:\n"
            "    vis_detection(np.zeros((4, 4, 3)), np.zeros((0, 6)))\n"
            "except ImportError:\n"
            "    print('visualizer needs cv2')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "visualizer needs cv2"


EXAMPLES = ("train_ds2", "ds2_inference", "long_audio_asr",
            "train_attention_asr", "predict_frcnn", "train_frcnn_shapes",
            "fraud_detection", "recommender", "sentiment",
            "image_augmentation")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_names_no_cv2_or_pandas(name):
    """The examples run on the card's machine, which has neither cv2 nor
    pandas: no example module imports them, even inside a function."""
    path = ROOT / "analytics_zoo_tpu_torch" / "examples" / f"{name}.py"
    bad = sorted(set(imported_roots(path)) & {"cv2", "pandas"})
    assert not bad, f"{name} imports {bad}"


def test_examples_import_without_cv2_and_pandas():
    """Each example module, and what it imports at module level, loads
    with cv2 and pandas unimportable, and builds its parser."""
    import subprocess
    import sys

    code = ("import importlib, sys\n"
            "sys.modules['cv2'] = None\n"
            "sys.modules['pandas'] = None\n"
            f"for name in {EXAMPLES!r}:\n"
            "    mod = importlib.import_module(\n"
            "        'analytics_zoo_tpu_torch.examples.' + name)\n"
            "    assert mod.build_parser().get_default('device') == 'cuda'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "ok"
