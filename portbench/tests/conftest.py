"""Tests of the benchmark harness.  They run on the CPU; a test that needs
a CUDA card takes the `cuda_card` fixture, which skips where there is none
(decided when the test runs, never while the module is imported)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the port's batches at the size its own CPU tests use, and few threads a
# worker, so that several workers share the CPU
os.environ.setdefault("FASTPLONG_TOKENS_PER_BATCH", str(1 << 15))
os.environ.setdefault("FASTPLONG_MAX_BATCH_READS", "64")
os.environ.setdefault("OMP_NUM_THREADS", "2")

# a mix small enough for the port on the CPU, large enough that
# auto-detection finds the start adapter in every file
TINY = {"files": 2, "reads_per_file": 500, "length_mean": 800,
        "length_sd": 700}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def make_root(tmp, extra_cells=True):
    """A checkout-like root holding BENCHMARK.json and the benchmark's data
    files and references, with a `<config>.tiny` cell of each
    configuration."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for sub in ("configs", "traffic", "metrics", "references"):
        if os.path.isdir(os.path.join(ROOT, "portbench", sub)):
            shutil.copytree(os.path.join(ROOT, "portbench", sub),
                            os.path.join(tmp, "portbench", sub))
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "chunks.json")) as f:
        mix = json.load(f)
    mix.update(TINY)
    with open(os.path.join(tmp, "portbench", "traffic", "tiny.json"),
              "w") as f:
        json.dump(mix, f)
    if extra_cells:
        names = [c["name"] + ".tiny" for c in bench["configs"]]
        for c, n in zip(bench["configs"], names):
            bench["workloads"].append({"name": n, "config": c["name"],
                                       "traffic": "tiny", "chips": 1,
                                       "why": "test"})
        for m in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in m:
                m["workloads"] += names
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path))
