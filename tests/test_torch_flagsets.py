"""The port's CLI against the JAX CLI on flag sets that reach code no other
port test holds, both run in-process on the CPU: quality and length
filters off, the cut window and mean quality, the N-base limit, split
output with gzip, a 700-bp adapter in an adapter FASTA and as the end
adapter, a gzip input of two members, monster reads (longer than a whole
batch) with break and mask, and --num_hosts 2 with break and mask and
with auto-detection (both hosts in turn, then the offline merge).

Each CLI writes into a directory of its own under the same file names;
the two directories must hold the same files, byte-identical (gzip files
once decompressed; the JSON report without its command line, the HTML
report normalised), the partials of --num_hosts aside.
"""

import gzip
import os

import numpy as np
import pytest

from golden_util import norm_html, strip_command, write_random_fastq

START = "AATGTACTTCGTTCAGTTACGTATTGCT"
END = "AGCAATACGTAACTGAACGAAGT"
HEADLINE = ["-s", START, "-e", END, "-5", "-3", "-x"]
BREAK_MASK = ["-b", "-N", "-s", START, "-e", END, "-x"]
LONG = "".join(np.random.default_rng(17).choice(list("ACGT"), 700))


def _lowq_read(rng, name, seq):
    q = rng.integers(33 + 12, 33 + 41, len(seq))
    for _ in range(int(rng.integers(1, 3))):
        k = int(rng.integers(60, 300))
        p = int(rng.integers(0, max(1, len(seq) - 50)))
        q[p:p + k] = rng.integers(33 + 2, 33 + 9, len(q[p:p + k]))
    return "@%s\n%s\n+\n%s\n" % (name, seq, "".join(map(chr, q)))


def _write_inputs(d):
    """write_random_fastq reads (both headline adapters, polyA tails, 2%
    N), reads with Q2-Q8 stretches, reads carrying the 700-bp adapter at
    either end; the same as a gzip of two members; a file of monster
    reads (34-70 kbases) among short ones; a FASTA of both headline
    adapters and the 700-bp one."""
    rng = np.random.default_rng(43)
    fq = os.path.join(d, "in.fq")
    write_random_fastq(fq, n_reads=80, min_len=40, max_len=1200, seed=44,
                       adapter_start=START, adapter_end=END,
                       adapter_prob=0.6, polya_prob=0.3)
    with open(fq, "a") as f:
        for i in range(12):
            seq = "".join(rng.choice(list("ACGT"), int(rng.integers(300,
                                                                    1200))))
            f.write(_lowq_read(rng, "lq%d" % i, seq))
        for i in range(8):
            core = "".join(rng.choice(list("ACGT"), int(rng.integers(200,
                                                                     900))))
            cut = int(rng.integers(0, 40))
            seq = (LONG[cut:] + core) if i % 2 else (core + LONG[:700 - cut])
            q = rng.integers(33 + 10, 33 + 41, len(seq))
            f.write("@long%d\n%s\n+\n%s\n" % (i, seq, "".join(map(chr, q))))
    with open(fq, "rb") as f:
        data = f.read()
    half = data.index(b"\n@lq0\n") + 1
    with open(fq + ".gz", "wb") as f:
        f.write(gzip.compress(data[:half]) + gzip.compress(data[half:]))
    monster = os.path.join(d, "monster.fq")
    write_random_fastq(monster, n_reads=20, min_len=40, max_len=900,
                       seed=45, adapter_start=START, adapter_end=END,
                       adapter_prob=0.6)
    with open(monster, "a") as f:
        for i, n in enumerate((34000, 52000, 70000)):
            seq = START + "".join(rng.choice(list("ACGT"), n)) + END
            f.write(_lowq_read(rng, "monster%d" % i, seq))
    fasta = os.path.join(d, "adapters.fa")
    with open(fasta, "w") as f:
        f.write(">start\n%s\n>end\n%s\n>long\n%s\n" % (START, END, LONG))
    return {"in": fq, "gz": fq + ".gz", "monster": monster, "fasta": fasta}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return _write_inputs(str(tmp_path_factory.mktemp("flagsets")))


def _hosts(i):
    return ["--num_hosts", "2", "--host_index", str(i)]


# (name, flags, input, hosts); {fasta} is the adapter FASTA
CASES = [
    ("no_quality_no_length_filter", ["-Q", "-L"], "in", False),
    ("cut_window_and_quality", ["-W", "10", "-M", "25", "-5", "-3"], "in",
     False),
    ("n_base_limit", ["--n_base_limit", "2"], "in", False),
    ("split_3_gzip_out", ["--split", "3", "-z", "1"], "in", False),
    ("adapter_fasta_700bp", ["-a", "{fasta}"], "in", False),
    ("end_adapter_700bp", ["-s", START, "-e", LONG], "in", False),
    ("gzip_input_two_members", HEADLINE, "gz", False),
    ("monster_break_mask", BREAK_MASK, "monster", False),
    ("num_hosts_break_mask", BREAK_MASK, "in", True),
    ("num_hosts_autodetect", ["-5", "-3"], "in", True),
]


def _run(main, merge, in_fq, d, flags, hosts):
    """One package's CLI into directory d (with --num_hosts: both hosts,
    then the offline merge of their partials)."""
    os.makedirs(d)
    split = "--split" in flags
    args = ["-i", in_fq, "-o", os.path.join(
        d, "out.fq.gz" if "-z" in flags else "out.fq"),
        "-j", os.path.join(d, "r.json"), "-h", os.path.join(d, "r.html")]
    if not split:
        args += ["--failed_out", os.path.join(d, "failed.fq")]
    for i in ((0, 1) if hosts else (None,)):
        extra = _hosts(i) if hosts else []
        assert main(["fastplong"] + args + flags + extra) in (0, None)
    if hosts:
        assert merge(["merge"] + [os.path.join(d, "r.json.part%d" % i)
                                  for i in (0, 1)]) == 0


def _content(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    if path.endswith(".json"):
        return strip_command(data.decode())
    if path.endswith(".html"):
        return norm_html(data.decode())
    return data


@pytest.mark.parametrize("name,flags,which,hosts", CASES,
                         ids=[c[0] for c in CASES])
def test_flag_set_matches_jax(name, flags, which, hosts, inputs, tmp_path,
                              monkeypatch):
    from fastplong_tpu.main import main as jax_main
    from fastplong_tpu.merge_reports import main as jax_merge
    from fastplong_tpu_torch.main import main as port_main
    from fastplong_tpu_torch.merge_reports import main as port_merge
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    flags = [f.format(**inputs) for f in flags]
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    _run(jax_main, jax_merge, inputs[which], dj, flags, hosts)
    _run(port_main, port_merge, inputs[which], dt, flags, hosts)
    names = sorted(n for n in os.listdir(dj) if ".part" not in n)
    assert names == sorted(n for n in os.listdir(dt) if ".part" not in n)
    for n in names:
        assert _content(os.path.join(dt, n)) == \
            _content(os.path.join(dj, n)), n
    fastq = [n for n in names if ".fq" in n and "failed" not in n]
    assert sum(len(_content(os.path.join(dt, n))) for n in fastq) > 0
    if "--split" in flags:
        assert len(fastq) == 3
    if hosts:
        assert "0001.out.fq" in names and "0002.out.fq" in names
        assert "r.json" in names and "r.html" in names
