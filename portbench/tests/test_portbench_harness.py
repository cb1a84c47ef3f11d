"""The harness: cells found from files by name, the refusal without a card,
and what the harness and the reference import."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_new_config_mix_and_metric_are_found_as_files(tiny_root):
    """A later PR adds a configuration, a mix, a metric and a cell as new
    files and entries; nothing of the harness is edited."""
    pb = os.path.join(tiny_root, "portbench")
    with open(os.path.join(pb, "configs", "headline_3h.json")) as f:
        conf = json.load(f)
    conf["flags"] = conf["flags"] + ["-l", "50"]
    conf["params"]["length_required"] = 50
    with open(os.path.join(pb, "configs", "dummy.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(pb, "traffic", "tiny.json")) as f:
        mix = json.load(f)
    mix["reads_per_file"] = 123
    with open(os.path.join(pb, "traffic", "dummy_mix.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "metrics", "dummy.jobs.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.jobs))\n")
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "dummy", "source": "test",
                             "file": "portbench/configs/dummy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "dummy.jobs", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "mbases_per_s",
                               "workloads": ["dummy.dummy_mix"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = harness.Cell("dummy.dummy_mix", root=tiny_root)
    assert cell.config["params"]["length_required"] == 50
    assert cell.mix["reads_per_file"] == 123
    assert [m["name"] for m in cell.per_layer] == ["dummy.jobs"]
    assert cell.metric_reader("dummy.jobs")(harness.RunData([1, 2], None)) == 2
    names = {m["name"] for m in harness.Cell(
        "headline_3h.tiny", root=tiny_root).per_layer}
    assert "dummy.jobs" not in names and "reports.s_per_file" in names


def test_every_cell_and_metric_of_the_benchmark_has_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m["name"]))


def test_measurement_path_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "headline_3h.wholerun", "--seed", "3000000001",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA card" in r.stderr


def _imports(code):
    r = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_jax_or_the_program():
    """Neither reference.py nor any configuration's own reference under
    references/, each loaded as the harness loads it."""
    tops = _imports("import glob, os, sys\n"
                    "sys.path.insert(0, %r)\n"
                    "from portbench import reference, check, gen, work\n"
                    "from portbench import harness\n"
                    "for path in sorted(glob.glob(%r)):\n"
                    "    harness.load_module(\n"
                    "        path, 'reference_' + os.path.basename(path))"
                    % (ROOT, os.path.join(ROOT, "portbench", "references",
                                          "*.py")))
    assert not tops & {"jax", "jaxlib", "flax", "fastplong_tpu",
                       "fastplong_tpu_torch"}


def test_the_harness_and_the_port_load_nothing_of_jax():
    tops = _imports(
        "import sys, os; sys.path.insert(0, %r)\n"
        "from portbench import harness, tracing, control\n"
        "harness.Program('cpu', %r, [])" % (ROOT, "/nonexistent"))
    assert "fastplong_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "fastplong_tpu"}


def test_a_directory_with_only_the_benchmark_refuses(tmp_path):
    """Where the port is absent (only BENCHMARK.json and portbench/), a run
    exits with another code than 0 and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "headline_3h.wholerun", "--seed", "7", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        env=dict(os.environ, TMPDIR=str(tmp_path)), timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_the_sink_keeps_only_what_departs_from_the_first_stream():
    first = harness.Sink()
    for part in (b"@a\nACGT\n+\n!!!!\n", b"@b\nGG\n+\n!!\n"):
        first.write(part)
    like = first.value()
    same = harness.Sink(like)
    for part in (b"@a\nACGT\n+\n!!!!\n", b"@b\nGG\n+\n!!\n"):
        same.write(part)
    assert same.parts is None and same.value() is like
    other = harness.Sink(like)
    other.write(b"@a\nACGT\n+\n!!!!\n")
    other.write(b"@c\nTT\n+\n##\n")
    assert other.value() == b"@a\nACGT\n+\n!!!!\n@c\nTT\n+\n##\n"
    short = harness.Sink(like)
    short.write(b"@a\nACGT\n+\n!!!!\n")
    assert short.value() == b"@a\nACGT\n+\n!!!!\n"
    longer = harness.Sink(like)
    longer.write(like + b"@d\nA\n+\n!\n")
    assert longer.value() == like + b"@d\nA\n+\n!\n"


def test_a_launch_record_keeps_a_large_tensor_by_its_shape():
    import torch
    from portbench import tracing, work
    bases = torch.zeros((64, 1000), dtype=torch.uint8)
    lo = torch.tensor([0, 10], dtype=torch.int32)
    kept = [tracing.kept("fpl_stat_batch_into", i, t)
            for i, t in ((0, bases), (5, lo))]
    assert isinstance(kept[0], tracing.Shape) and kept[1] is lo
    assert kept[0].shape == (64, 1000) and kept[0].numel() == 64000
    assert kept[0].element_size() == 1
    out = torch.zeros((64, 1000), dtype=torch.int16)
    args = [tracing.Shape(bases), 64, 1000, None, 28, tracing.Shape(out)]
    assert work.launch_work("fpl_mismatch_scan", args)[:2] == (
        64000 + 64000 * 2 + 28, 2 * 64000 * 28)
