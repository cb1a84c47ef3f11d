"""A short run of every cell on a CUDA card, through the command itself:
it prints one result line whose `correct` is true, with the cell's metrics.
Skips where there is no card."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


# the CPU tests' settings (conftest.py) are not the benchmark's
SCRUB = ("FASTPLONG_TOKENS_PER_BATCH", "FASTPLONG_MAX_BATCH_READS",
         "OMP_NUM_THREADS")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", cells())
def test_a_short_run_is_correct(cuda_card, name, trace):
    env = {k: v for k, v in os.environ.items() if k not in SCRUB}
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "2147483651", "--seconds", "1", "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    cell = harness.Cell(name)
    if trace:
        names = {m["name"] for m in cell.per_layer}
        assert result["metrics"] and set(result["metrics"]) <= names
        assert result["device"]["busy_s"] > 0
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
