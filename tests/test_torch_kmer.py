"""The port's k-mer histogram of adapter auto-detection against the JAX
package, on the CPU.

ops/kmer.py's plain version (what CPU tensors take) must equal
fastplong_tpu/ops/kmer.py:kmer_histogram_device exactly, counts, position
sums and total; where JAX's uint32 guard sends a side to its host route,
the port's 64-bit counters must give that route's result; the port's
Evaluator._kmer_histogram must equal JAX's, and its CLI with no adapter
flags (auto-detection on both sides) must equal the JAX CLI.
"""

import contextlib
import io

import numpy as np
import pytest

from fastplong_tpu.evaluator import Evaluator as JaxEvaluator
from fastplong_tpu.ops import kmer as jkmer
from fastplong_tpu_torch.evaluator import Evaluator
from fastplong_tpu_torch.ops.kmer import KEYSPACE, kmer_histogram

from golden_util import write_random_fastq
from test_torch_cli import _assert_same

W = 129 + 10


def _matrix(rng, n, alphabet=b"ACGTUNx", p=None):
    """[n, 139] window rows over `alphabet`, npos 0..129 with rows at 0
    and 129, base positions and read lengths past them."""
    mat = rng.choice(np.frombuffer(alphabet, np.uint8), size=(n, W), p=p)
    npos = rng.integers(0, 130, n)
    npos[:3] = 0
    npos[3:8] = 129
    base_pos = rng.integers(0, 5000, n)
    lens = base_pos + npos + 9 + rng.integers(1, 200, n)
    return mat, npos, base_pos, lens


MATRICES = {
    "acgt": dict(alphabet=b"ACGT"),
    "other_bytes": dict(alphabet=b"ACGTN.a\x00\xff",
                        p=[.2, .2, .2, .2, .05, .05, .04, .03, .03]),
    "rna": dict(alphabet=b"ACGU"),
    "t_and_u": dict(alphabet=b"ACGTUN", p=[.24, .24, .24, .12, .12, .04]),
}


@pytest.mark.parametrize("end_side", [False, True], ids=["start", "end"])
@pytest.mark.parametrize("kind", list(MATRICES))
def test_histogram_matches_jax(kind, end_side):
    rng = np.random.default_rng(len(kind) + 7 * end_side)
    args = _matrix(rng, 300, **MATRICES[kind]) + (end_side,)
    want = jkmer.kmer_histogram_device(*args)
    got = kmer_histogram(*args, device="cpu")
    assert want is not None
    assert got[0].dtype == np.int64 and got[1].dtype == np.uint64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] > 0


def _hot_matrix(rng, case, n=300):
    """Window rows whose keys collide at one column, as auto-detection's
    sample makes them: "end_at_116" puts END at column 116 of every row
    (the end side's adapter column), "grouped_invalid" puts one of four
    10-mers at column 40 (two of them equal but for T and U) with bytes
    outside ACGTU inside some windows and npos 0 or short of the column in
    others.  Positions stay small, so JAX takes its device route."""
    mat = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(n, W))
    npos = np.full(n, 129)
    base_pos = np.zeros(n, np.int64)
    lens = np.full(n, W, np.int64)
    lens[::7] += rng.integers(1, 50, len(lens[::7]))
    if case == "end_at_116":
        mat[:, 116:116 + 23] = np.frombuffer(b"AGCAATACGTAACTGAACGAAGT",
                                             np.uint8)
        base_pos = lens - W
    else:
        mers = (b"ACGTACGTAC", b"TTTTCCCCGG", b"UUUUCCCCGG", b"GATTACAGAT")
        for i in range(n):
            mat[i, 40:50] = np.frombuffer(mers[i % 4], np.uint8)
        mat[::9, 44] = ord("N")
        mat[1::11, 49] = ord("x")
        npos[::13] = 0
        npos[2::17] = 40
        npos[3::17] = 41
    return mat, npos, base_pos, lens


@pytest.mark.parametrize("end_side", [False, True], ids=["start", "end"])
@pytest.mark.parametrize("case", ["end_at_116", "grouped_invalid"])
def test_hot_key_histogram_matches_jax(case, end_side):
    rng = np.random.default_rng(len(case) + 3 * end_side)
    args = _hot_matrix(rng, case) + (end_side,)
    want = jkmer.kmer_histogram_device(*args)
    got = kmer_histogram(*args, device="cpu")
    assert want is not None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] > 0
    # the hot key collects its column's rows (T and U rows together)
    assert want[0].max() >= (250 if case == "end_at_116" else 100)


def test_histogram_without_windows_matches_jax():
    rng = np.random.default_rng(3)
    mat, npos, base_pos, lens = _matrix(rng, 20)
    npos[:] = 0
    for end_side in (False, True):
        want = jkmer.kmer_histogram_device(mat, npos, base_pos, lens,
                                           end_side)
        got = kmer_histogram(mat, npos, base_pos, lens, end_side, "cpu")
        assert got[2] == want[2] == 0
        assert not got[0].any() and not got[1].any()
        assert got[0].shape == got[1].shape == (KEYSPACE,)


class _LongRead:
    """A read of `length` bases of which only `seg`, at offset `off`, is
    stored: enough for one side's window."""

    def __init__(self, seg, off, length):
        self.seg, self.off, self.length = seg, off, length

    def __getitem__(self, sl):
        assert self.off <= sl.start <= sl.stop <= self.off + len(self.seg)
        return self.seg[sl.start - self.off:sl.stop - self.off]


def _reads(rng, n, min_len, max_len, alphabet="ACGTN"):
    seqs, lens = [], []
    for i in range(n):
        k = int(rng.integers(min_len, max_len + 1))
        s = "".join(rng.choice(list(alphabet), k)).encode()
        if i % 3 == 0 and k > 40:
            s = b"AGATCGGAAGAGCACACGTCTGAACT" + s[26:]
        if i % 4 == 0 and k > 40:
            s = s[:-26] + b"TTCGTTCAGTTACGTATTGCTAAGT"[:26]
        seqs.append(s)
        lens.append(len(s))
    return seqs, np.asarray(lens, np.int64)


def _opt():
    from fastplong_tpu.config import Options
    return Options()


def test_uint32_guard_case_matches_jax_host_route(monkeypatch):
    """End-side windows of reads of about 3 * 10^7 bases with a trim tail
    just shorter than the reads: the windows' positions (length - pos) are
    near 3 * 10^7, so JAX's device route, whose position sums are uint32,
    returns None and the JAX evaluator takes its numpy route; the port's
    64-bit fill must equal that route, sums past 2^32 included."""
    rng = np.random.default_rng(5)
    base, shift_tail = 30_000_000, 29_999_000
    seqs, lens = [], []
    for i in range(400):
        length = base + int(rng.integers(0, 5000))
        sp = max(0, length - 10 - shift_tail - 128)
        seg = "".join(rng.choice(list("ACGTN"), 200)).encode()
        if i % 2:
            seg = seg[:60] + b"AGCAATACGTAACTGAACGAAGT" + seg[83:]
        seqs.append(_LongRead(seg, sp, length))
        lens.append(length)
    lens = np.asarray(lens, np.int64)
    seen = []
    real = jkmer.kmer_histogram_device

    def spy(*a):
        seen.append(real(*a))
        return seen[-1]

    monkeypatch.setattr(jkmer, "kmer_histogram_device", spy)
    monkeypatch.setenv("FASTPLONG_KMER_DEVICE", "1")
    want = JaxEvaluator(_opt())._kmer_histogram(seqs, lens, shift_tail, True)
    assert seen == [None]       # the guard sent JAX to its host route
    got = Evaluator(_opt(), "cpu")._kmer_histogram(seqs, lens, shift_tail,
                                                   True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] > 0
    assert int(got[1].max()) >= 1 << 32


@pytest.mark.parametrize("end_side", [False, True], ids=["start", "end"])
@pytest.mark.parametrize("shift_tail", [1, 30])
def test_evaluator_histogram_matches_jax(end_side, shift_tail):
    """Reads shorter than a window (KEYLEN + shift_tail), of every length
    around the window's reach, with N, U and other bytes."""
    rng = np.random.default_rng(11 + shift_tail)
    seqs, lens = _reads(rng, 300, 1, 400)
    seqs[:3] = [b"", b"ACGTACGTAC", b"ACGTUCGTACxACGTACGTACGTAC"]
    lens = np.asarray([len(s) for s in seqs], np.int64)
    want = JaxEvaluator(_opt())._kmer_histogram(seqs, lens, shift_tail,
                                                end_side)
    got = Evaluator(_opt(), "cpu")._kmer_histogram(seqs, lens, shift_tail,
                                                   end_side)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_cli_auto_detection_without_flags_matches_jax(tmp_path, monkeypatch):
    """BASELINE config 4 (no adapter flags): both sides detected; the
    stderr "Detected:" lines of the two CLIs must match too."""
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    in_fq = write_random_fastq(
        str(tmp_path / "in.fq"), n_reads=300, min_len=100, max_len=900,
        seed=21, adapter_start="AATGTACTTCGTTCAGTTACGTATTGCT",
        adapter_end="AGCAATACGTAACTGAACGAAGT", adapter_prob=0.8)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _assert_same(in_fq, str(tmp_path), [])    # JAX first, then the port
    detected = [ln for ln in err.getvalue().splitlines()
                if ln.startswith(("Detected:", "Not detected",
                                  "Found possible"))]
    assert len(detected) == 4, detected
    assert detected[:2] == detected[2:], detected
    assert all(d.startswith("Detected:") for d in detected), detected
