"""``analytics_zoo_tpu_torch/tools/time_phases.py``: the command's output
passes through unchanged, each line's seconds go to its phase, and the
exit code is the command's."""

import json
import subprocess
import sys
from pathlib import Path

TOOL = (Path(__file__).resolve().parent.parent / "analytics_zoo_tpu_torch"
        / "tools" / "time_phases.py")

PROGRAM = """
import json, time
print(json.dumps({"phase": "a"}))
time.sleep(0.3)
print("not json")
print(json.dumps({"phase": "b"}))
time.sleep(0.2)
print(json.dumps({"phase": "a"}))
raise SystemExit(3)
"""


def test_phases_timed_and_exit_code_passed_through():
    out = subprocess.run([sys.executable, str(TOOL), "--", sys.executable,
                          "-c", PROGRAM], capture_output=True, text=True,
                         timeout=60)
    lines = out.stdout.splitlines()
    assert out.returncode == 3
    assert lines[:4] == ['{"phase": "a"}', "not json", '{"phase": "b"}',
                         '{"phase": "a"}']
    summary = json.loads(lines[-1])["time_phases"]
    assert summary["rc"] == 3
    assert list(summary["phase_s"]) == ["a", "other", "b"]
    assert summary["phase_s"]["other"] >= 0.3
    assert summary["phase_s"]["a"] >= 0.2
    assert summary["total_s"] >= sum(summary["phase_s"].values())


def test_usage_without_a_command():
    out = subprocess.run([sys.executable, str(TOOL)], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 2 and "usage" in out.stderr
