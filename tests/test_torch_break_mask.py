"""Break (-b) and N-mask (-N) through the port's CLI against the JAX CLI,
both run in-process on the CPU, on the device, host and monster statistics
routes.

The trimmed FASTQ, --failed_out, the JSON report without its command line
and the normalised HTML report must be byte-identical, and each case must
have found regions: "rN-"-tagged fragments where break is on, N runs of
at least the mask window where mask is on.
"""

import os
import re

import numpy as np
import pytest

from golden_util import norm_html, run_ours, strip_command, write_random_fastq

START = "AATGTACTTCGTTCAGTTACGTATTGCT"
END = "AGCAATACGTAACTGAACGAAGT"
HEADLINE = ["-s", START, "-e", END, "-5", "-3", "-x"]
# break at its defaults finds the planted Q2-Q8 stretches; the mask window
# then finds regions in the fragments' write_random_fastq qualities (Q2-Q40)
BREAK_MASK = ["-b", "-N", "--mask_window_size", "15", "--mask_mean_quality",
              "20"]


def _input(path):
    """write_random_fastq reads with both adapters and polyA tails, reads
    with one to three stretches of Q2-Q8 qualities (regions at the default
    windows), and reads with an adapter planted mid-read."""
    write_random_fastq(path, n_reads=150, min_len=40, max_len=1400, seed=21,
                       adapter_start=START, adapter_end=END,
                       adapter_prob=0.7, polya_prob=0.3)
    rng = np.random.default_rng(22)
    with open(path, "a") as f:
        for i in range(40):
            n = int(rng.integers(300, 1400))
            seq = "".join(rng.choice(list("ACGT"), n))
            q = rng.integers(33 + 12, 33 + 41, n)
            for _ in range(int(rng.integers(1, 4))):
                k = int(rng.integers(60, 300))
                p = int(rng.integers(0, n - 50))
                q[p:p + k] = rng.integers(33 + 2, 33 + 9, len(q[p:p + k]))
            f.write("@lq%d\n%s\n+\n%s\n" % (i, seq, "".join(map(chr, q))))
        for i in range(20):
            left = "".join(rng.choice(list("ACGT"), int(rng.integers(0, 300))))
            right = "".join(rng.choice(list("ACGT"),
                                       int(rng.integers(0, 300))))
            seq = left + (START, END)[i % 2] + right
            qual = "".join(chr(int(q)) for q in
                           rng.integers(35, 74, len(seq)))
            f.write("@mid%d\n%s\n+\n%s\n" % (i, seq, qual))
    return path


def _run_port(in_fq, workdir, extra):
    from fastplong_tpu_torch.main import main
    outs = [os.path.join(workdir, n) for n in
            ("t_out.fq", "t_failed.fq", "t.json", "t.html")]
    argv = ["fastplong", "-i", in_fq, "-o", outs[0], "--failed_out", outs[1],
            "-j", outs[2], "-h", outs[3]] + extra
    assert main(argv) == 0
    return outs


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    return _input(str(tmp_path_factory.mktemp("in") / "in.fq"))


CASES = [
    ("headline_break_mask", HEADLINE + BREAK_MASK, {}),
    ("filters_break", ["-A", "-b"], {}),
    ("filters_mask", ["-A", "-N"], {}),
    ("host_stats_route", HEADLINE + BREAK_MASK,
     {"FASTPLONG_STAT_DEVICE_CAP": "1024"}),
    ("stats_backend_host", HEADLINE + BREAK_MASK + ["--stats_backend", "host"],
     {}),
]


@pytest.mark.parametrize("name,extra,env", CASES, ids=[c[0] for c in CASES])
def test_break_mask_cli_matches_jax(name, extra, env, reads, tmp_path,
                                    monkeypatch):
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    workdir = str(tmp_path)
    j_out, j_failed, j_json = run_ours(reads, workdir, extra)
    j_html = os.path.join(workdir, "my.html")
    t_out, t_failed, t_json, t_html = _run_port(reads, workdir, extra)
    data = {}
    for a, b in ((j_out, t_out), (j_failed, t_failed)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            data[b] = fb.read()
            assert fa.read() == data[b], os.path.basename(b)
    with open(j_json) as fa, open(t_json) as fb:
        assert strip_command(fa.read()) == strip_command(fb.read())
    with open(j_html) as fa, open(t_html) as fb:
        assert norm_html(fa.read()) == norm_html(fb.read())
    if "-b" in extra:
        assert re.search(rb"^@r[0-9]+-", data[t_out], re.M), "no fragment"
    if "-N" in extra:
        w = int(extra[extra.index("--mask_window_size") + 1]
                if "--mask_window_size" in extra else 50)
        assert b"N" * w in data[t_out] + data[t_failed], "nothing masked"
        assert data[t_failed], "no failed reads"
