"""The PyTorch port stands alone: no module of ``analytics_zoo_tpu_torch``
and not ``chip_smoke.py`` imports JAX, flax, optax or the JAX package
(checked over the AST, so an import inside a function counts too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "analytics_zoo_tpu")
FILES = sorted((ROOT / "analytics_zoo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
