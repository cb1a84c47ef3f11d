"""The break_mask configuration's cell: checked against its own plain
reference, references/break_mask.py, which models every parameter it
sets; and a short window of it on the CPU reads correct."""

import os
import time

from portbench import harness, reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_the_cell_is_checked_by_its_own_reference():
    cell = harness.Cell("break_mask.chunks")
    assert cell.config["reference"] == "break_mask"
    assert cell.reference is not reference
    assert cell.reference.__file__ == os.path.join(
        ROOT, "portbench", "references", "break_mask.py")
    assert set(cell.config["params"]) <= cell.reference.PARAMS
    assert reference.PARAMS < cell.reference.PARAMS
    assert cell.config["flags"][-2:] == ["-b", "-N"]
    assert {m["name"] for m in cell.end_to_end} == {
        "mbases_per_s", "setup_s", "memory_peak_mb"}
    assert "regions.s_per_gbase" in {m["name"] for m in cell.per_layer}


def test_a_short_window_on_the_cpu_is_correct(tiny_root):
    cell = harness.Cell("break_mask.tiny", root=tiny_root)
    r = harness.run_cell(cell, 2 ** 31 + 2111, 0.1, False, "cpu",
                         time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
