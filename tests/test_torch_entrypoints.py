"""The port's run-level entry points against the JAX package's, on the CPU:
--profile, --prewarm, the folder runner (fastplong_tpu_torch.parallel) and
the public per-read API (fastplong_tpu_torch.models).

Outputs, failed reads, JSON without its command line and normalised HTML
must be byte-identical to the JAX package's for the same input and flags.
"""

import glob
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fastplong_tpu import models as jax_models
from fastplong_tpu import parallel as jax_parallel
from fastplong_tpu_torch import models as torch_models
from fastplong_tpu_torch import parallel as torch_parallel
from golden_util import norm_html, run_ours, strip_command, write_random_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = "AATGTACTTCGTTCAGTTACGTATTGCT"
END = "AGCAATACGTAACTGAACGAAGT"
HEADLINE = ["-s", START, "-e", END, "-5", "-3", "-x"]


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")


def _read(path, mode="rb"):
    with open(path, mode) as f:
        return f.read()


# ------------------------------------------------------------------ --profile

def test_profile_matches_jax_and_writes_trace(tmp_path, cpu):
    from fastplong_tpu_torch.main import main
    d = str(tmp_path)
    fq = write_random_fastq(os.path.join(d, "in.fq"), n_reads=200,
                            min_len=40, max_len=900, seed=21,
                            adapter_start=START, adapter_end=END,
                            adapter_prob=0.6, polya_prob=0.3)
    j_out, j_failed, j_json = run_ours(fq, d, HEADLINE)
    prof = os.path.join(d, "prof")
    outs = [os.path.join(d, n) for n in ("t.fq", "t_failed.fq", "t.json",
                                         "t.html")]
    assert main(["fastplong", "-i", fq, "-o", outs[0], "--failed_out",
                 outs[1], "-j", outs[2], "-h", outs[3], "--profile", prof]
                + HEADLINE) == 0
    assert _read(j_out) == _read(outs[0])
    assert _read(j_failed) == _read(outs[1])
    assert (strip_command(_read(j_json, "r"))
            == strip_command(_read(outs[2], "r")))
    assert (norm_html(_read(os.path.join(d, "my.html"), "r"))
            == norm_html(_read(outs[3], "r")))
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    assert len(traces) == 1, os.listdir(prof)
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    # the run's host ops are in it (on the CPU there is no kernel event),
    # and the whole job's spans: the evaluator's and the reports' too
    assert any(e.get("cat") == "cpu_op" for e in events)
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"fastplong.job", "fastplong.evaluator", "fastplong.runner_run",
            "fastplong.report_json", "fastplong.report_html"} <= spans


# ------------------------------------------------------------------ --prewarm

def test_prewarm_cli_leaves_cwd_empty(tmp_path):
    """`python -m fastplong_tpu_torch.main --prewarm` as a subprocess, with
    I/O flags that it must strip, at the tests' batch sizes (inherited
    from conftest) on one CPU thread, so that it does not crowd the other
    test workers' cores (about 28 s alone)."""
    env = dict(os.environ, FASTPLONG_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    env.pop("FASTPLONG_DAEMON", None)
    r = subprocess.run(
        [sys.executable, "-m", "fastplong_tpu_torch.main", "--prewarm",
         "-s", START, "-x", "-o", "stray.fq", "--json=stray.json"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "prewarm: cold pass" in r.stderr and "(rc=0)" in r.stderr
    assert os.listdir(str(tmp_path)) == []


# ------------------------------------------------------------ parallel.py

def _write_fq(path, n=40, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            ln = int(rng.integers(40, 150))
            seq = "".join(rng.choice(list("ACGT"), size=ln))
            q = "".join(chr(int(x)) for x in rng.integers(35, 70, size=ln))
            f.write("@r%d\n%s\n+\n%s\n" % (i, seq, q))


def test_find_fastqs_matches_jax(tmp_path):
    for name in ("a.fq", "b.fastq", "c.fq.gz", "d.fastq.gz",
                 "Undetermined_x.fq", "notes.txt", "e.fq.bz2"):
        (tmp_path / name).write_text("")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "f.fq").write_text("")
    found = torch_parallel.find_fastqs(str(tmp_path))
    assert found == jax_parallel.find_fastqs(str(tmp_path))
    assert [os.path.basename(p) for p in found] == [
        "a.fq", "b.fastq", "c.fq.gz", "d.fastq.gz"]
    assert torch_parallel.find_fastqs(str(tmp_path / "missing")) == []


def _folder(root, gz=True):
    ind = root / "in"
    ind.mkdir()
    write_random_fastq(str(ind / "x.fq"), n_reads=60, min_len=40,
                       max_len=600, seed=1, adapter_start=START,
                       adapter_end=END, adapter_prob=0.6, polya_prob=0.3)
    _write_fq(str(ind / "y.fastq"), seed=2)
    if gz:
        _write_fq(str(root / "z.fq"), seed=3)
        with open(root / "z.fq", "rb") as src, \
                gzip.open(ind / "z.fq.gz", "wb") as dst:
            dst.write(src.read())
    _write_fq(str(ind / "Undetermined_S0.fq"), seed=4)
    (ind / "notes.txt").write_text("not a FASTQ\n")
    return ind


def _drive(pkg, ind, outd, *extra):
    return pkg.main(["-i", str(ind), "-o", str(outd),
                        "--args=" + " ".join(HEADLINE)] + list(extra))


def test_end_to_end_matches_jax(tmp_path, cpu, capsys):
    ind = _folder(tmp_path)
    j_out, t_out = tmp_path / "jax", tmp_path / "torch"
    assert _drive(jax_parallel, ind, j_out) == 0
    capsys.readouterr()
    assert _drive(torch_parallel, ind, t_out) == 0
    printed = capsys.readouterr().out
    assert printed.count("Processing: ") == 3
    names = sorted(os.listdir(t_out))
    assert names == sorted(os.listdir(j_out))
    assert names == sorted(
        ["overall.html"] + ["%s.clean.fastq.gz" % b for b in "xyz"]
        + ["%s.%s" % (f, e) for f in ("x.fq", "y.fastq", "z.fq.gz")
           for e in ("html", "json")])
    for b in "xyz":
        name = "%s.clean.fastq.gz" % b
        with gzip.open(j_out / name) as a, gzip.open(t_out / name) as t:
            assert a.read() == t.read(), name
    for f in ("x.fq", "y.fastq", "z.fq.gz"):
        assert (strip_command(_read(j_out / (f + ".json"), "r"))
                == strip_command(_read(t_out / (f + ".json"), "r")))
        assert (norm_html(_read(j_out / (f + ".html"), "r"))
                == norm_html(_read(t_out / (f + ".html"), "r")))
    html = _read(t_out / "overall.html", "r")
    assert html == _read(j_out / "overall.html", "r")
    assert "x.fq" in html and "z.fq.gz" in html
    assert "Undetermined" not in html and "notes" not in html


@pytest.mark.parametrize("host", [0, 1])
def test_host_sharding_matches_jax(host, tmp_path, cpu):
    ind = _folder(tmp_path, gz=False)
    made = []
    for name, pkg in (("jax", jax_parallel), ("torch", torch_parallel)):
        outd = tmp_path / name
        assert _drive(pkg, ind, outd, "--num_hosts", "2", "--host_index",
                      str(host)) == 0
        made.append(sorted(os.listdir(outd)))
    assert made[0] == made[1]
    # x.fq to host 0, y.fastq to host 1; only host 0 writes the summary
    want = ["x.fq", "y.fastq"][host]
    assert [n for n in made[1] if n.endswith(".json")] == [want + ".json"]
    assert ("overall.html" in made[1]) == (host == 0)


def test_summary_only_matches_jax(tmp_path, cpu):
    ind = _folder(tmp_path, gz=False)
    outd = tmp_path / "out"
    assert _drive(torch_parallel, ind, outd, "--no_summary") == 0
    assert "overall.html" not in os.listdir(outd)
    # an unrelated JSON in the report dir is no report
    (outd / "stray_config.json").write_text('{"threads": 4}')
    pages = []
    for pkg in (jax_parallel, torch_parallel):
        assert pkg.main(["-i", str(ind), "-o", str(outd),
                            "--summary_only"]) == 0
        pages.append(_read(outd / "overall.html", "r"))
    assert pages[0] == pages[1]
    assert "x.fq" in pages[1] and "stray_config" not in pages[1]


@pytest.mark.parametrize("case", ["empty", "missing", "no_fastq"])
def test_nothing_to_do_matches_jax(case, tmp_path, capsys):
    d = tmp_path / "d"
    if case != "missing":
        d.mkdir()
    if case == "no_fastq":
        (d / "notes.txt").write_text("x")
    argv = ["-i", str(d)] + (["--summary_only"] if case != "no_fastq"
                             else [])
    got = []
    for pkg in (jax_parallel, torch_parallel):
        rc = pkg.main(argv)
        got.append((rc, capsys.readouterr().out))
    assert got[0] == got[1] and got[1][0] == 1


# ------------------------------------------------------------------ models

@pytest.fixture(params=[jax_models, torch_models], ids=["jax", "torch"])
def m(request):
    return request.param


def test_sequence_reverse_complement(m):
    # reference test/sequence_test.cpp:4-9
    s = m.Sequence("AAAATTTTCCCCGGGG")
    rc = ~s
    assert s.mStr == "AAAATTTTCCCCGGGG"
    assert rc.mStr == "CCCCGGGGAAAATTTT"


def test_read_index_parsing(m):
    r = m.Read("@NS500713:64:HFKJJBGXY:1:11101:1675:1101 "
               "1:N:0:TATAGCCT+GACCCCCA", "ACGT", "+", "IIII")
    assert r.last_index() == "GACCCCCA"


def test_fast_merge(m):
    left = m.Read("@name", "TTTTAACCCCCCCCCCCCCCCCCCCCCCCCCCCCAATTTTAAAATTTT",
                  "+", "IIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII")
    right = left.reverse_complement()
    merged = m.ReadPair(left, m.Read(right.name, right.seq, "+",
                                     right.quality)).fast_merge()
    assert merged is not None
    assert merged.seq == left.seq


def test_read_break_by_gap(m):
    r = m.Read("@n", "AAAACCCCGGGGTTTT", "+", "IIIIJJJJKKKKLLLL")
    out = r.break_by_gap(4, 8)
    assert len(out) == 2
    assert out[0].seq == "AAAA" and out[0].quality == "IIII"
    assert out[1].seq == "TTTT" and out[1].quality == "LLLL"
    assert out[0].name == "@split-by-adapter-left-n"
    assert out[1].name == "@split-by-adapter-right-n"


def test_read_break_by_regions(m):
    r = m.Read("@n", "AAAACCCCGGGGTTTT", "+", "IIIIJJJJKKKKLLLL")
    out = r.break_by_regions([(4, 7), (12, 13)])
    assert [x.seq for x in out] == ["AAAA", "GGGG", "TT"]
    assert [x.name for x in out] == ["@r1-n", "@r2-n", "@r3-n"]


def test_mask_region(m):
    r = m.Read("@n", "AAAACCCC", "+", "IIIIJJJJ")
    r.mask_region_with_n(2, 4)
    assert r.seq == "AANNNNCC"


def test_trim_front_clamp(m):
    r = m.Read("@n", "ACGT", "+", "IIII")
    r.trim_front(100)
    assert r.seq == "T"  # clamped to length-1


def test_package_root_exports_models():
    from fastplong_tpu_torch import Read, ReadPair, Sequence
    assert (Read, ReadPair, Sequence) == (torch_models.Read,
                                          torch_models.ReadPair,
                                          torch_models.Sequence)


def _read_state(r):
    return (r.name, r.seq, r.strand, r.quality)


def test_models_agree_on_random_reads():
    """Every Read method, on random reads, gives the same result in both
    packages."""
    rng = np.random.default_rng(31)
    for i in range(200):
        n = int(rng.integers(0, 60))
        seq = "".join(rng.choice(list("ACGTN"), n))
        qual = "".join(chr(int(q)) for q in rng.integers(33, 105, n))
        name = "@r%d:%s+%s/%d" % (i, "AC" * int(rng.integers(0, 3)),
                                  "GT" * int(rng.integers(0, 3)),
                                  int(rng.integers(1, 3)))
        phred64 = bool(rng.random() < 0.2)
        a, b = (mod.Read(name, seq, "+", qual, phred64)
                for mod in (jax_models, torch_models))
        assert _read_state(a) == _read_state(b)
        for meth, args in (("last_index", ()), ("first_index", ()),
                           ("low_qual_count", (int(rng.integers(0, 40)),)),
                           ("to_string", ()),
                           ("to_string_with_tag", ("t",))):
            assert getattr(a, meth)(*args) == getattr(b, meth)(*args)
        start, length = (int(x) for x in rng.integers(-2, n + 3, 2))
        regions = sorted(tuple(sorted(int(x) for x in
                                      rng.integers(-2, n + 3, 2)))
                         for _ in range(int(rng.integers(0, 4))))
        assert ([_read_state(x) for x in a.break_by_gap(start, length)]
                == [_read_state(x) for x in b.break_by_gap(start, length)])
        assert ([_read_state(x) for x in a.break_by_regions(regions)]
                == [_read_state(x) for x in b.break_by_regions(regions)])
        other = (a.reverse_complement(), b.reverse_complement())
        assert _read_state(other[0]) == _read_state(other[1])
        pair = [mod.ReadPair(x, mod.Read(name, seq[::-1], "+", qual))
                .fast_merge() for mod, x in ((jax_models, a),
                                             (torch_models, b))]
        assert (pair[0] is None) == (pair[1] is None)
        if pair[0] is not None:
            assert _read_state(pair[0]) == _read_state(pair[1])
        for mod_read in (a, b):
            mod_read.mask_region_with_n(start, length)
            mod_read.fix_mgi()
            mod_read.trim_front(length)
            mod_read.resize(start)
        assert _read_state(a) == _read_state(b)
