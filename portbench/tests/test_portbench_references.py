"""A configuration's plain reference: reference.py where the configuration
names none, references/<name>.py where it names one, and a cell that stops
at set-up where its reference is missing or does not model a parameter."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import control, gen, harness, reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]

# one small file of a mix, large enough that auto-detection runs
ONE_FILE = {"files": 1, "reads_per_file": 300, "length_mean": 800,
            "length_sd": 700}

# the real reference, less the last passing record of each file's stream
STAND_IN = '''
from portbench import reference

PARAMS = reference.PARAMS


def expected(raw, params, device="cpu", control=None):
    want = reference.expected(raw, params, device, control=control)
    lines = want["stream"].split(b"\\n")[:-5]
    return dict(want, stream=b"".join(line + b"\\n" for line in lines),
                records=want["records"] - 1)
'''


def add_cell(root, name, config):
    """Write `config` as configs/<name>.json and a cell `<name>.one` of it
    over one small file of the chunks mix into a root's BENCHMARK.json."""
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", name + ".json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(pb, "traffic", "chunks.json")) as f:
        mix = dict(json.load(f), **ONE_FILE)
    with open(os.path.join(pb, "traffic", name + "_one.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": name, "source": "test",
                             "file": "portbench/configs/%s.json" % name,
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name + ".one", "config": name,
                               "traffic": name + "_one", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(name + ".one")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return name + ".one"


def headline_config():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "headline_3h.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_that_names_no_reference_is_checked_by_reference_py(
        tmp_path, name):
    """Both cells of the benchmark resolve to portbench.reference itself,
    and what the harness expects of a file is what reference.expected
    gives, for the program's place and for the control's."""
    cell = harness.Cell(name)
    assert "reference" not in cell.config
    assert cell.reference is reference
    files, _ = gen.write_files(dict(cell.mix, **ONE_FILE), 2 ** 31 + 5,
                               str(tmp_path))
    with open(files[0][0], "rb") as f:
        raw = f.read()
    got = cell.expected(raw, "cpu")
    assert got["records"] > 0
    assert got == reference.expected(raw, cell.config["params"], "cpu")
    assert cell.expected(raw, "cpu", control="no_middle") == (
        reference.expected(raw, cell.config["params"], "cpu",
                           control="no_middle"))


def test_a_configuration_brings_its_own_reference(tiny_root):
    """A configuration naming references/stand_in.py, added as new files
    and entries only, is checked against that file by the harness and by
    control.py: a stand-in that drops the last record of the real
    reference's stream reads one record differing in a one-file window,
    and nothing else."""
    os.makedirs(os.path.join(tiny_root, "portbench", "references"),
                exist_ok=True)
    with open(os.path.join(tiny_root, "portbench", "references",
                           "stand_in.py"), "w") as f:
        f.write(STAND_IN)
    name = add_cell(tiny_root, "stand_in",
                    dict(headline_config(), reference="stand_in"))
    cell = harness.Cell(name, root=tiny_root)
    assert cell.reference is not reference
    assert cell.reference.__file__ == os.path.join(
        tiny_root, "portbench", "references", "stand_in.py")
    r = harness.run_cell(cell, 2 ** 31 + 41, 0.1, False, "cpu",
                         time.perf_counter())
    assert r["attempted"] == 1 and r["correct"] is False
    assert {k: c["value"] for k, c in r["checks"].items()} == {
        "stream_records_differing": 1, "report_fields_differing": 0,
        "adapters_differing": 0, "jobs_failed": 0, "jobs_unchecked": 0}
    work = os.path.join(tiny_root, "work")
    os.makedirs(work)
    sound, _, _ = control.readings(cell, 2 ** 31 + 43, "cpu", work,
                                   with_control=False)
    assert sound == {k: c["value"] for k, c in r["checks"].items()}


def copy_of_the_benchmark(tmp):
    """BENCHMARK.json and portbench/ in a directory of their own."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(tmp, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp


@pytest.mark.parametrize("fault", ["missing_reference", "unknown_param",
                                   "not_a_name"])
def test_a_reference_that_cannot_check_the_configuration_stops_the_run(
        tmp_path, fault):
    """A configuration naming a reference file that is not there, or a
    path out of references/ in place of a name, or with a parameter its
    reference does not model (reference.py knows no break), stops the cell
    where it is built, and the command at set-up, with the file's, the
    path's or the parameter's name and no result."""
    root = copy_of_the_benchmark(str(tmp_path))
    config = headline_config()
    if fault == "missing_reference":
        config["reference"] = "not_there"
        named = os.path.join("references", "not_there.py")
    elif fault == "not_a_name":
        config["reference"] = named = "../reference"
    else:
        config["params"]["break_window"] = 100
        named = "break_window"
    name = add_cell(root, "faulty", config)
    with pytest.raises((OSError, ValueError)) as e:
        harness.Cell(name, root=root)
    assert named in str(e.value)
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "2147483700", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=root,
        env=dict(os.environ, TMPDIR=str(tmp_path)), timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "cannot load the cell" in r.stderr and named in r.stderr
