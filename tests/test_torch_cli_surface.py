"""The port's CLI against the JAX CLI on the flag sets and I/O cases that
the other CLI tests do not run, on the CPU.

Flag sets run both CLIs in-process: the trimmed FASTQ (decompressed where
it is gzip), --failed_out, the JSON report without its command line and
the normalised HTML report must be byte-identical.  I/O cases run each CLI
as its own process (stdin, exit codes): the exit code, stdout and stderr
must be identical once the module path, the run time and the working
directory are taken out, as are the runtime's own log lines and the frames
of a traceback (each package's files have their own paths and lines).
"""

import gzip
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from golden_util import norm_html, strip_command, write_random_fastq

START = "AATGTACTTCGTTCAGTTACGTATTGCT"
END = "AGCAATACGTAACTGAACGAAGT"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _long_adapter(n=300, seed=31):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), n))


def _write_inputs(d):
    """DNA reads with both adapters and polyA tails, reads of Q25-Q40 with
    no N (they pass every filter), reads with stretches of Q2-Q8
    qualities carrying the 300-bp adapter at either end; the same reads as
    RNA (T as U); a FASTA of adapters, one of them 300 bp."""
    dna = os.path.join(d, "in.fq")
    write_random_fastq(dna, n_reads=60, min_len=40, max_len=800, seed=41,
                       adapter_start=START, adapter_end=END,
                       adapter_prob=0.6, polya_prob=0.3)
    rng = np.random.default_rng(42)
    long_ad = _long_adapter()
    with open(dna, "a") as f:
        for i in range(16):
            n = int(rng.integers(200, 800))
            seq = "".join(rng.choice(list("ACGT"), n))
            if i % 2:
                seq = long_ad[int(rng.integers(0, 40)):] + seq
            else:
                seq = seq + long_ad[:300 - int(rng.integers(0, 40))]
            q = rng.integers(33 + 10, 33 + 41, len(seq))
            k = int(rng.integers(30, 150))
            p = int(rng.integers(0, len(seq) - k))
            q[p:p + k] = rng.integers(33 + 2, 33 + 9, k)
            f.write("@lq%d\n%s\n+\n%s\n" % (i, seq, "".join(map(chr, q))))
        for i in range(20):
            n = int(rng.integers(150, 900))
            seq = START + "".join(rng.choice(list("ACGT"), n)) + END
            q = rng.integers(33 + 25, 33 + 41, len(seq))
            f.write("@hq%d\n%s\n+\n%s\n" % (i, seq, "".join(map(chr, q))))
    rna = os.path.join(d, "rna.fq")
    with open(dna) as src, open(rna, "w") as dst:
        for i, line in enumerate(src):
            dst.write(line.replace("T", "U") if i % 4 == 1 else line)
    fasta = os.path.join(d, "adapters.fa")
    with open(fasta, "w") as f:
        f.write(">start\n%s\n>end\n%s\n>long\n%s\n" % (START, END, long_ad))
    return {"in": dna, "rna": rna, "fasta": fasta}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return _write_inputs(str(tmp_path_factory.mktemp("surface")))


FILTERS = ["-f", "5", "-t", "3", "-q", "20", "-u", "30", "-l", "100",
           "--length_limit", "1000", "-y", "-Y", "40", "-n", "3", "-m", "12"]

# (name, flags, input); {fasta} is the adapter FASTA
FLAG_CASES = [
    ("adapter_fasta", ["-a", "{fasta}"], "in"),
    ("adapter_fasta_with_s_e", ["-a", "{fasta}", "-s", START, "-e", END],
     "in"),
    ("reads_to_process", ["--reads_to_process", "57", "-s", START], "in"),
    ("gzip_output", ["-z", "1", "-s", START, "-e", END], "in"),
    ("rna_input", ["-s", START, "-e", END, "-x"], "rna"),
    ("every_filter", FILTERS, "in"),
    ("custom_cut_windows", ["-5", "-3", "--cut_front_window_size", "8",
                            "--cut_front_mean_quality", "22",
                            "--cut_tail_window_size", "6",
                            "--cut_tail_mean_quality", "18"], "in"),
    ("extension_and_distance", ["-s", START, "-e", END,
                                "--trimming_extension", "20", "-d", "0.2"],
     "in"),
    ("start_adapter_only", ["-s", START], "in"),
    ("start_adapter_300bp", ["-s", _long_adapter()], "in"),
    ("report_title", ["-R", "a surface run", "-s", START], "in"),
    ("break_mask_window_1", ["-b", "--break_window_size", "1", "-N",
                             "--mask_window_size", "1"], "in"),
    ("break_mask_window_3", ["-b", "--break_window_size", "3", "-N",
                             "--mask_window_size", "3"], "in"),
]


def _run_in_process(main, in_fq, workdir, tag, extra):
    gz = "-z" in extra
    outs = [os.path.join(workdir, tag + s) for s in (
        ".fq.gz" if gz else ".fq", ".failed.fq", ".json", ".html")]
    argv = ["fastplong", "-i", in_fq, "-o", outs[0], "--failed_out",
            outs[1], "-j", outs[2], "-h", outs[3]] + extra
    assert main(argv) in (0, None)
    return outs


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name,flags,which", FLAG_CASES,
                         ids=[c[0] for c in FLAG_CASES])
def test_flag_set_matches_jax(name, flags, which, inputs, tmp_path,
                              monkeypatch):
    from fastplong_tpu.main import main as jax_main
    from fastplong_tpu_torch.main import main as port_main
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    extra = [f.format(**inputs) for f in flags]
    d = str(tmp_path)
    j = _run_in_process(jax_main, inputs[which], d, "jax", extra)
    t = _run_in_process(port_main, inputs[which], d, "port", extra)
    for a, b in zip(j[:2], t[:2]):
        assert _read(a) == _read(b), os.path.basename(b)
    assert strip_command(_read(j[2]).decode()) == \
        strip_command(_read(t[2]).decode())
    assert norm_html(_read(j[3]).decode()) == norm_html(_read(t[3]).decode())
    before = json.loads(_read(j[2]))["summary"]["before_filtering"]
    assert before["total_reads"] > 0, "the run read no record"


def _cli(module, args, cwd, stdin=None):
    """One CLI process on the CPU: (exit code, stdout, stderr) with the
    module path, the run time and the working directory taken out."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", FASTPLONG_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                       input=stdin, capture_output=True, timeout=600, env=env)

    def norm(b):
        b = b.replace(cwd.encode(), b"CWD")
        b = re.sub(rb"\S*fastplong_tpu(_torch)?[/.]main(\.py)?", b"fastplong",
                   b)
        b = re.sub(rb"time used: \d+ seconds", b"time used: T seconds", b)
        # glog-style lines of the runtime (E1017 12:00:00.000000 ...)
        b = re.sub(rb"(?m)^[EWIF]\d{4} \d\d:\d\d:\d\d\.\d+ .*\n", b"", b)
        # a traceback's frames: indented lines after its first line
        return re.sub(rb"(?m)(^Traceback \(most recent call last\):\n)"
                      rb"(?:^ .*\n)+", rb"\1", b)
    return r.returncode, norm(r.stdout), norm(r.stderr)


def _records(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(30, 200))
        seq = "".join(rng.choice(list("ACGT"), k))
        q = "".join(chr(int(x)) for x in rng.integers(35, 74, k))
        out.append("@r%d\n%s\n+\n%s\n" % (i, seq, q))
    return out


def _io_case(name, d):
    """(CLI arguments, stdin bytes or None) for one I/O case, with its
    input files written into d."""
    recs = _records(30, sum(map(ord, name)))
    fq = os.path.join(d, "in.fq")
    with open(fq, "w") as f:
        f.write("".join(recs))
    reports = ["-j", "r.json", "-h", "r.html"]
    if name == "stdin_dev_stdout":
        return ["-i", "/dev/stdin", "--stdout"] + reports, "".join(
            recs).encode()
    if name == "bare_stdin":
        return ["--stdin", "--stdout"] + reports, "".join(recs).encode()
    if name == "dont_overwrite":
        with open(os.path.join(d, "out.fq"), "w") as f:
            f.write("kept\n")
        return ["-i", fq, "-o", "out.fq", "--dont_overwrite"] + reports, None
    if name == "malformed_plus_line":
        recs[7] = recs[7].replace("\n+\n", "\n-\n")
    elif name == "malformed_short_record":
        recs[12] = "@r12\nACGTACGT\n+\n"
    elif name == "empty_input":
        recs = []
    elif name == "no_final_newline":
        recs[-1] = recs[-1].rstrip("\n")
    elif name == "missing_input":
        return ["-i", os.path.join(d, "absent.fq"), "-o", "out.fq"] + \
            reports, None
    with open(fq, "w") as f:
        f.write("".join(recs))
    return ["-i", fq, "-o", "out.fq", "--failed_out", "failed.fq"] + \
        reports, None


IO_CASES = ["stdin_dev_stdout", "bare_stdin", "dont_overwrite",
            "malformed_plus_line", "malformed_short_record", "empty_input",
            "no_final_newline", "missing_input"]


@pytest.mark.parametrize("name", IO_CASES)
def test_io_case_matches_jax(name, tmp_path):
    got = {}
    for module in ("fastplong_tpu.main", "fastplong_tpu_torch.main"):
        d = tmp_path / module.split(".")[0]
        d.mkdir()
        args, stdin = _io_case(name, str(d))
        got[module] = _cli(module, args, str(d), stdin)
        files = {}
        for f in ("out.fq", "failed.fq"):
            if (d / f).exists():
                files[f] = (d / f).read_bytes()
        got[module] += (files,)
    j, t = got["fastplong_tpu.main"], got["fastplong_tpu_torch.main"]
    assert j[0] == t[0], (j[0], t[0], j[2][-500:], t[2][-500:])
    assert j[1] == t[1]
    assert j[2] == t[2]
    assert j[3] == t[3]
