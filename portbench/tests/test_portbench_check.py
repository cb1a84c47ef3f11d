"""The check that decides `correct`, on the CPU at a test size: sound runs
of the port come out correct; the control (the reference with the
middle-adapter split left out, in the program's place) and each fault the
cells can have, planted under the timed path, come out not correct."""

import random
import tempfile
import time

import pytest
import torch

from portbench import control, harness, reference

CELLS = ["headline_3h.tiny", "defaults_autodetect.tiny"]


def dp_distance(a, b):
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[-1]


def test_edit_distances_match_the_dynamic_programme():
    import numpy as np
    rng = random.Random(5)
    for m in (1, 5, 16, 23, 28, 63, 64):
        pat = bytes(rng.choice(b"ACGT") for _ in range(m))
        texts = [bytes(rng.choice(b"ACGTN") for _ in range(n))
                 for n in (0, 1, m - 1, m, m + 3, 40)]
        for t in texts:
            assert reference.edit_distance(pat, t) == dp_distance(pat, t)
        for n in (1, m, 16):
            rows = [bytes(rng.choice(b"ACGT") for _ in range(n))
                    for _ in range(20)] + [pat[:n].ljust(n, b"A")]
            got = reference.edit_distance_rows(
                pat, np.frombuffer(b"".join(rows), np.uint8).reshape(-1, n))
            assert got.tolist() == [dp_distance(pat, r) for r in rows]


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_and_the_control(tiny_root, name):
    cell = harness.Cell(name, root=tiny_root)
    sound, ctl, notes = control.readings(cell, 2 ** 31 + 17, "cpu",
                                         tempfile.mkdtemp())
    assert all(v == 0 for v in sound.values()), (sound, notes)
    assert ctl["stream_records_differing"] > 0
    assert ctl["report_fields_differing"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_on_the_cpu(tiny_root, name):
    cell = harness.Cell(name, root=tiny_root)
    r = harness.run_cell(cell, 21, 0.1, True, "cpu", time.perf_counter())
    assert r["correct"] and r["attempted"] >= 2
    assert list(r)[-1] == "checks"
    assert "reports.s_per_file" in r["metrics"]
    assert ("evaluator.s_per_file" in r["metrics"]) == name.startswith(
        "defaults")


def _fault(kind):
    """A wrapper of the step builder that breaks the step it builds."""
    from fastplong_tpu_torch.pipeline import device
    build = device.build_step

    def faulty(p, dev=None, with_stats=True):
        step, stages = build(p, dev, with_stats)

        def broken(bases, quals, lens, read_mask, state=None):
            if kind == "state_unchanged":
                return step(bases, quals, lens, read_mask,
                            None if state is None else state.clone())
            if kind == "half_batch":
                keep = torch.arange(len(read_mask),
                                    device=read_mask.device) % 2 == 0
                return step(bases, quals, lens, read_mask & keep, state)
            out = step(bases, quals, lens, read_mask, state)
            # an answer altered where it is produced: the first live
            # read's first out-read ends one base early
            live = torch.nonzero(out["active"][:, 0])
            if len(live):
                out["out_hi"][live[0, 0], 0] -= 1
            return out
        return broken, stages
    return device, faulty


def test_a_detection_fault_is_not_correct(tiny_root, monkeypatch):
    """Auto-detection extends its key one base short: the adapters in the
    report differ from the reference's."""
    from fastplong_tpu_torch import evaluator
    extend = evaluator.extend_key_to_adapter
    monkeypatch.setattr(evaluator, "extend_key_to_adapter",
                        lambda *a, **k: extend(*a, **k)[:-1])
    cell = harness.Cell("defaults_autodetect.tiny", root=tiny_root)
    r = harness.run_cell(cell, 34, 0.1, False, "cpu", time.perf_counter())
    assert r["correct"] is False
    assert r["checks"]["adapters_differing"]["value"] >= 1
    # the end-to-end metrics; off a card there is no device memory to read
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end} - {
        "memory_peak_mb"}


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(tiny_root, name, kind,
                                                     monkeypatch):
    device, faulty = _fault(kind)
    monkeypatch.setattr(device, "build_step", faulty)
    cell = harness.Cell(name, root=tiny_root)
    r = harness.run_cell(cell, 33, 0.1, False, "cpu", time.perf_counter())
    assert r["correct"] is False
    checks = r["checks"]
    if kind == "state_unchanged":
        assert checks["report_fields_differing"]["value"] > 0
    else:
        assert checks["stream_records_differing"]["value"] > 0
