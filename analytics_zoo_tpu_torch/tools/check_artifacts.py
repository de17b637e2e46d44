"""Lint the port's artifacts: each parses and carries the port's
``run_metadata`` block (counterpart of ``tools/check_artifacts.py``).

The port's tools write their reports under names ending ``_torch.json``
(``SERVE_PROFILE_torch.json``, ``SERVE_DRILL_torch.json``,
``TELEMETRY_DRILL_torch.json``, ``AZ_TRACE_torch.json``,
``INT8_MAP_PARITY_torch.json``: :data:`PATTERN`), none of which starts
with ``OBS_`` or holds a ``_rNN`` revision, so the reference's lint
(``^OBS_.*\\.json``, ``.*_r\\d+.*\\.json`` and ``SERVE_PROFILE.json``) does
not govern them: it requires ``jax_version`` in the stamp, where the
port's carries ``torch_version``.  This lint governs exactly those names,
each of which must

- parse as JSON, and
- carry ``run_metadata`` with every key of the port's
  ``obs.runmeta.REQUIRED_KEYS``.

Every port artifact is stamped, so there is no legacy set.

Usage::

    python -m analytics_zoo_tpu_torch.tools.check_artifacts          # cwd
    python -m analytics_zoo_tpu_torch.tools.check_artifacts --root D
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import List

from analytics_zoo_tpu_torch.obs.runmeta import REQUIRED_KEYS

#: the port's artifacts: a report name ending in ``_torch.json``
PATTERN = re.compile(r"^[A-Za-z0-9_]+_torch\.json$")


def governed(root: str) -> List[str]:
    return sorted(n for n in os.listdir(root)
                  if PATTERN.match(n)
                  and os.path.isfile(os.path.join(root, n)))


def check_artifacts(root: str) -> List[str]:
    """Lint ``root``; returns a list of problem strings (empty = clean)."""
    problems: List[str] = []
    for name in governed(root):
        try:
            with open(os.path.join(root, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            problems.append(f"{name}: does not parse as JSON ({e})")
            continue
        meta = doc.get("run_metadata") if isinstance(doc, dict) else None
        if not isinstance(meta, dict):
            problems.append(
                f"{name}: missing run_metadata block (stamp it with "
                f"analytics_zoo_tpu_torch.obs.run_metadata)")
            continue
        missing = [k for k in REQUIRED_KEYS if k not in meta]
        if missing:
            problems.append(f"{name}: run_metadata missing keys {missing}")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.getcwd())
    args = ap.parse_args(argv)
    problems = check_artifacts(args.root)
    if problems:
        for p in problems:
            print(f"check_artifacts: FAIL {p}")
        return 1
    print(f"check_artifacts: OK — {len(governed(args.root))} port "
          f"artifacts parse and are stamped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
