"""The accuracy-report sidecar (counterpart of ``utils/report.py``):
an example appends its held-out metrics as a titled JSON block to a
markdown file, with the command that produced them."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict


def reconstruct_command(script: str) -> str:
    """The invocation from ``sys.argv``, without ``--out`` (where the
    report goes is not part of the experiment)."""
    argv, skip = [], False
    for a in sys.argv[1:]:
        if skip:
            skip = False
        elif a == "--out":
            skip = True
        elif not a.startswith("--out="):
            argv.append(a if " " not in a else repr(a))
    return (f"python {script} " + " ".join(argv)).rstrip()


def append_report(out_path: str, title: str, script: str,
                  report: Dict[str, Any]) -> None:
    """Append one titled, dated, command-stamped JSON block to
    ``out_path``."""
    with open(out_path, "a") as f:
        f.write(f"\n## {title} ({time.strftime('%Y-%m-%d')})\n\n"
                f"Command: `{reconstruct_command(script)}`\n\n```json\n"
                + json.dumps(report, indent=2) + "\n```\n")
