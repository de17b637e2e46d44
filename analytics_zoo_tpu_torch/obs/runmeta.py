"""Run metadata for stamped artifacts (counterpart of
``obs/runmeta.py``)::

    report["run_metadata"] = run_metadata("telemetry", seed=args.seed)

The sha is HEAD when the artifact is made: for an artifact committed in
the same commit, that is the parent.  ``git_dirty`` says whether the
tree had uncommitted changes.

The port's block names its backend as torch sees it, the device type
and, on a GPU, the card's name (``"cuda:NVIDIA H100 80GB HBM3"``), and
carries ``torch_version`` where the reference carries ``jax_version``.
"""

from __future__ import annotations

import os
import platform
import subprocess
from typing import Any, Dict, Optional

import torch

#: keys every stamped artifact carries
REQUIRED_KEYS = ("tool", "seed", "git_sha", "backend", "torch_version")


def _git(args, cwd: str) -> Optional[str]:
    try:
        out = subprocess.run(["git"] + args, cwd=cwd, capture_output=True,
                             text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def backend_name() -> str:
    """``"cuda:<card name>"`` when a GPU is visible, else ``"cpu"``."""
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name(0)}"
    return "cpu"


def run_metadata(tool: str, seed: Optional[int] = None,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Tool name, seed, git sha and dirty flag, backend, torch and
    Python versions; ``extra`` merges on top.  Never raises: outside a
    git checkout the git fields are ``None``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sha = _git(["rev-parse", "HEAD"], root)
    status = _git(["status", "--porcelain"], root)
    meta: Dict[str, Any] = {
        "tool": tool,
        "seed": seed,
        "git_sha": sha,
        "git_dirty": bool(status) if status is not None else None,
        "backend": backend_name(),
        "torch_version": torch.__version__,
        "python": platform.python_version(),
    }
    meta.update(extra or {})
    return meta
