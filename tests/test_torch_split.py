"""The port's split output (--split, --split_by_lines) against the JAX CLI,
on the CPU.

Both CLIs run in-process into directories of their own; every split file
(name and bytes), the JSON report without its command line and the
normalised HTML report must be identical.  The STDIN refusal runs each
CLI as its own process and compares exit code, stdout and stderr.
"""

import contextlib
import glob
import io
import os

import numpy as np
import pytest

from golden_util import norm_html, strip_command, write_random_fastq
from test_torch_cli_surface import _cli


def _input(path, n_reads=300):
    """Random reads (Q2-Q40, which break often cuts) with stretches of
    Q2-Q8 planted in every third read and low-complexity reads for -y."""
    write_random_fastq(path, n_reads=n_reads, min_len=40, max_len=700,
                       seed=51)
    rng = np.random.default_rng(52)
    with open(path, "a") as f:
        for i in range(n_reads // 3):
            n = int(rng.integers(150, 700))
            seq = ("".join(rng.choice(list("ACGT"), n)) if i % 5
                   else "AC" * (n // 2))
            q = rng.integers(33 + 15, 33 + 41, len(seq))
            k = int(rng.integers(20, 120))
            p = int(rng.integers(0, len(seq) - k))
            q[p:p + k] = rng.integers(33 + 2, 33 + 9, k)
            f.write("@lq%d\n%s\n+\n%s\n" % (i, seq, "".join(map(chr, q))))
    return path


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    return _input(str(tmp_path_factory.mktemp("in") / "in.fq"))


def _run(main, in_fq, d, extra):
    """One in-process CLI run into directory d; returns its stderr."""
    os.makedirs(d)
    argv = ["fastplong", "-i", in_fq, "-o", os.path.join(d, "out.fq"),
            "-j", os.path.join(d, "r.json"), "-h", os.path.join(d, "r.html")
            ] + extra
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        main(argv)
    return err.getvalue()


def _same_split(in_fq, tmp_path, extra, monkeypatch):
    """Both CLIs over in_fq with `extra`; returns (split file names, the
    two stderr texts)."""
    from fastplong_tpu.main import main as jax_main
    from fastplong_tpu_torch.main import main as port_main
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    dirs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    errs = [_run(m, in_fq, d, extra) for m, d in zip((jax_main, port_main),
                                                     dirs)]
    names = [sorted(os.path.basename(p) for p in
                    glob.glob(os.path.join(d, "*out.fq"))) for d in dirs]
    assert names[0] == names[1], names
    assert "out.fq" not in names[0]       # split mode writes no plain -o
    for f in names[0]:
        with open(os.path.join(dirs[0], f), "rb") as a, \
                open(os.path.join(dirs[1], f), "rb") as b:
            assert a.read() == b.read(), f
    with open(os.path.join(dirs[0], "r.json")) as a, \
            open(os.path.join(dirs[1], "r.json")) as b:
        assert strip_command(a.read()) == strip_command(b.read())
    with open(os.path.join(dirs[0], "r.html")) as a, \
            open(os.path.join(dirs[1], "r.html")) as b:
        assert norm_html(a.read()) == norm_html(b.read())
    return names[0], errs


CASES = [
    ("split_4", ["--split", "4"], 4),
    ("split_by_lines_4000", ["--split_by_lines", "4000"], None),
    ("split_4_digits_0", ["--split", "4", "--split_prefix_digits", "0"], 4),
    ("split_4_digits_2", ["--split", "4", "--split_prefix_digits", "2"], 4),
]


@pytest.mark.parametrize("name,extra,files", CASES, ids=[c[0] for c in CASES])
def test_split_matches_jax(name, extra, files, reads, tmp_path, monkeypatch):
    names, _ = _same_split(reads, tmp_path, ["-b", "-y"] + extra,
                           monkeypatch)
    if files:
        assert len(names) == files, names
    else:
        assert len(names) > 1, names
    digits = dict(zip(extra[::2], extra[1::2])).get("--split_prefix_digits",
                                                    "4")
    assert names[0] == "%s.out.fq" % "1".zfill(int(digits)), names


def test_split_beyond_read_count_matches_jax(tmp_path, monkeypatch):
    """--split 40 over 30 reads: the warning, and 40 files of which the
    ones no pack reached are created empty."""
    in_fq = write_random_fastq(str(tmp_path / "in.fq"), n_reads=30,
                               min_len=40, max_len=300, seed=53)
    names, errs = _same_split(in_fq, tmp_path, ["--split", "40"],
                              monkeypatch)
    warn = "WARNING: the input file has less reads than the number of " \
           "files to split"
    assert [warn in e for e in errs] == [True, True], errs
    assert len(names) == 40
    sizes = [os.path.getsize(str(tmp_path / "port" / f)) for f in names]
    assert 0 < sum(s > 0 for s in sizes) < 40


def test_split_stdin_refused_like_jax(tmp_path):
    got = []
    for module in ("fastplong_tpu.main", "fastplong_tpu_torch.main"):
        d = tmp_path / module.split(".")[0]
        d.mkdir()
        got.append(_cli(module, ["--stdin", "-o", "out.fq", "--split", "4"],
                        str(d), b"@r\nACGT\n+\nIIII\n"))
    assert got[0] == got[1], got
    assert got[0][0] != 0
    assert b"Splitting by file number is not supported in STDIN mode" \
        in got[0][2]
