#!/usr/bin/env python3
"""Run a command that prints one JSON object a line with a ``"phase"``
key (as ``chip_smoke.py`` does) and time it phase by phase, so that two
trees' scripts can be compared on one card in one session:

    cd OLD_TREE && python3 NEW_TREE/analytics_zoo_tpu_torch/tools/time_phases.py -- python3 chip_smoke.py
    cd NEW_TREE && python3 analytics_zoo_tpu_torch/tools/time_phases.py -- python3 chip_smoke.py

The seconds from one printed line to the next go to the later line's
phase (the work that produced it); lines without a phase go to
``"other"``.  The command's own output passes through unchanged, then
one JSON line follows: ``{"time_phases": {"total_s", "rc", "phase_s"}}``,
the command's wall seconds, its exit code and the seconds of each
phase, in the order they first printed.  The exit code is the command's.
"""

import json
import os
import subprocess
import sys
import time


def main(argv) -> int:
    if "--" not in argv or argv.index("--") == len(argv) - 1:
        print(f"usage: {os.path.basename(argv[0])} -- COMMAND [ARGS]",
              file=sys.stderr)
        return 2
    cmd = argv[argv.index("--") + 1:]
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = last = time.perf_counter()
    phase_s = {}
    with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                          env=env) as proc:
        for line in proc.stdout:
            sys.stdout.write(line)
            now = time.perf_counter()
            try:
                phase = json.loads(line).get("phase", "other")
            except (ValueError, AttributeError):
                phase = "other"
            phase_s[phase] = phase_s.get(phase, 0.0) + now - last
            last = now
        rc = proc.wait()
    print(json.dumps({"time_phases": {
        "total_s": time.perf_counter() - t0, "rc": rc,
        "phase_s": phase_s}}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
