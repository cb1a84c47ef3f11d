"""The `break_mask` configuration's plain reference
(portbench/references/break_mask.py) against the literal transcription of
detectLowQualityRegions and against the port's CLI on the CPU.

The port runs as the benchmark runs it (portbench.harness.Program: the
CLI in process, passing reads to --stdout) on small files of the `chunks`
mix with more glitches and shorter reads, so that every file has broken
and masked reads; its stream, records, adapters and the report fields
that portbench/check.py compares must equal the reference's, and the
timer dump's break_out_reads and masked_bases the reference's counts.
"""

import json
import os
import re
import sys

import numpy as np
import pytest

from reference_oracle import detect_low_quality_regions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, control, gen, harness  # noqa: E402

BM = harness.load_module(
    os.path.join(ROOT, "portbench", "references", "break_mask.py"),
    "portbench_reference_break_mask")
with open(os.path.join(ROOT, "portbench", "configs",
                       "break_mask.json")) as f:
    CONFIG = json.load(f)
with open(os.path.join(ROOT, "portbench", "configs",
                       "headline_3h.json")) as f:
    HEADLINE = json.load(f)
with open(os.path.join(ROOT, "portbench", "traffic", "chunks.json")) as f:
    MIX = dict(json.load(f), files=3, reads_per_file=100, length_mean=2500,
               length_sd=2000, glitch_rate=1500)
SEED = 2 ** 31 + 2101


# ------------------------------------------------------- (a) the regions


def _qual(rng, n, stretches=()):
    """Q12-Q40 qualities with Q2-Q8 stretches at (start, length)."""
    q = rng.integers(33 + 12, 33 + 41, n)
    for a, k in stretches:
        q[a:a + k] = rng.integers(33 + 2, 33 + 9, len(q[a:a + k]))
    return q.astype(np.uint8)


REGION_CASES = {
    "shorter_than_window": (30, 50, ()),
    "window_long": (50, 50, ((0, 50),)),
    "all_low": (300, 50, ((0, 300),)),
    "touching_start": (400, 50, ((0, 80),)),
    "touching_end": (400, 50, ((320, 80),)),
    "last_full_window": (400, 50, ((350, 50),)),
    "before_last_full_window": (400, 50, ((349, 51),)),
    "two_stretches": (1200, 100, ((200, 150), (800, 120))),
}


@pytest.mark.parametrize("case", sorted(REGION_CASES))
def test_regions_equal_the_transcription(case):
    n, w, stretches = REGION_CASES[case]
    rng = np.random.default_rng(len(case))
    q = _qual(rng, n, stretches)
    for quality in (10, 20):
        assert BM.low_quality_regions(q, w, quality) == [
            tuple(r) for r in detect_low_quality_regions(
                q.tobytes().decode(), w, quality)]


def test_regions_equal_the_transcription_on_random_qualities():
    rng = np.random.default_rng(2101)
    found = 0
    for _ in range(200):
        n = int(rng.integers(0, 700))
        stretches = [(int(rng.integers(0, max(n, 1))),
                      int(rng.integers(1, 120)))
                     for _ in range(int(rng.integers(0, 4)))]
        q = _qual(rng, n, stretches)
        w = int(rng.choice([1, 4, 10, 50, 100]))
        quality = int(rng.choice([5, 10, 20, 30]))
        want = [tuple(r) for r in detect_low_quality_regions(
            q.tobytes().decode(), w, quality)]
        assert BM.low_quality_regions(q, w, quality) == want, (n, w, quality)
        found += len(want) > 0
    assert found > 50


# ------------------------------------------------------- (b)-(d) the files


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each file of the mix: its bytes, the port's job under break_mask
    and its timer dump, and the port's dump under the headline flags."""
    tmp = str(tmp_path_factory.mktemp("break_mask"))
    files, _ = gen.write_files(MIX, SEED, tmp)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
        mp.setenv("FASTPLONG_TIMER_DUMP", os.path.join(tmp, "timer.json"))
        prog = harness.Program("cpu", tmp, CONFIG["flags"])
        plain = harness.Program("cpu", tmp, HEADLINE["flags"])
        for i, (path, bases) in enumerate(files):
            job = prog.run(harness.Job(i, os.path.basename(path), bases),
                           path)
            with open(prog.dump) as f:
                dump = json.load(f)
            plain.run(harness.Job(i, "headline", bases), path)
            with open(plain.dump) as f:
                plain_dump = json.load(f)
            with open(path, "rb") as f:
                raw = f.read()
            out.append((raw, job, dump, plain_dump))
    return out


FILES = range(MIX["files"])


@pytest.mark.parametrize("i", FILES)
def test_the_port_equals_the_reference(runs, i):
    raw, job, _, _ = runs[i]
    assert not job.failed, job.error
    want = BM.expected(raw, CONFIG["params"])
    assert job.stream == want["stream"]
    assert len(check.records(job.stream)) == want["records"]
    assert check.records_differing(job.stream, want["stream"]) == (0, None)
    assert check.report_differing(job.report, want["report"]) == (0, None)
    assert check.adapters_differing(job.report, want["adapters"]) == (
        0, None)
    assert re.search(rb"^@r\d+-", want["stream"], re.M)
    seqs = want["stream"].split(b"\n")[1::4]
    assert any(re.search(rb"N{%d}" % CONFIG["params"]["mask_window"], s)
               for s in seqs)


@pytest.mark.parametrize("i", FILES)
def test_the_dump_counts_what_break_and_mask_did(runs, i):
    raw, _, dump, plain_dump = runs[i]
    want = BM.expected(raw, CONFIG["params"])
    assert want["break_out_reads"] > 0 and want["masked_bases"] > 0
    assert dump["break_out_reads"] == want["break_out_reads"]
    assert dump["masked_bases"] == want["masked_bases"]
    assert dump["launches"]["regions"] == 0     # the CPU's plain version
    assert plain_dump["break_out_reads"] == 0
    assert plain_dump["masked_bases"] == 0


@pytest.mark.parametrize("step", ["no_break", "no_mask"])
def test_each_control_departs_from_the_reference(runs, step):
    """The check of the check: the reference less its break, or less its
    mask, differs from the full reference in the stream and the report
    of every file."""
    for raw, _, _, _ in runs:
        want = BM.expected(raw, CONFIG["params"])
        got = BM.expected(raw, CONFIG["params"], control=step)
        assert check.records_differing(got["stream"], want["stream"])[0] > 0
        assert check.report_differing(
            control.report_text(got["report"]), want["report"])[0] > 0
        counts = ("break_out_reads" if step == "no_break"
                  else "masked_bases")
        assert got[counts] == 0 < want[counts]

