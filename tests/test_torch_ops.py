"""Each op module of the port against its JAX twin, on the CPU.

The same numpy inputs go through fastplong_tpu/ops/* and
fastplong_tpu_torch/ops/*; every output is an integer or a flag, so every
comparison is exact (tolerance 0).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastplong_tpu.ops import adapter as ja
from fastplong_tpu.ops import align as jal
from fastplong_tpu.ops import filters as jf
from fastplong_tpu.ops import polyx as jp
from fastplong_tpu.ops import primitives as jpr
from fastplong_tpu.ops import qualcut as jq
from fastplong_tpu.ops import regions as jr
from fastplong_tpu.ops import stats_kernels as js
from fastplong_tpu_torch.ops import adapter as ta
from fastplong_tpu_torch.ops import align as tal
from fastplong_tpu_torch.ops import filters as tf
from fastplong_tpu_torch.ops import polyx as tp
from fastplong_tpu_torch.ops import primitives as tpr
from fastplong_tpu_torch.ops import qualcut as tq
from fastplong_tpu_torch.ops import regions as tr
from fastplong_tpu_torch.ops import stats_kernels as ts

START = "AATGTACTTCGTTCAGTTACGTATTGCT"
END = "AGCAATACGTAACTGAACGAAGT"
ACGTN = np.frombuffer(b"ACGTN", np.uint8)


def _batch(seed, B=16, L=300, plant=(), n_runs=True, polya=False):
    """Random reads (4% N), ragged lengths, one padding row; adapters
    planted anywhere, runs of N at both ends, optional polyA tails."""
    rng = np.random.default_rng(seed)
    bases = rng.choice(ACGTN, size=(B, L), p=[.24, .24, .24, .24, .04])
    quals = rng.integers(33 + 2, 33 + 41, size=(B, L)).astype(np.uint8)
    lens = rng.integers(min(25, L), L + 1, size=B).astype(np.int32)
    mask = np.ones(B, bool)
    mask[rng.integers(0, B)] = False
    for i in range(B):
        n = lens[i]
        if n_runs and i % 3 == 0:
            bases[i, :int(rng.integers(1, 6))] = ord("N")
            bases[i, n - int(rng.integers(1, 6)):n] = ord("N")
        if polya and i % 2 == 0:
            k = int(rng.integers(5, 40))
            bases[i, max(0, n - k):n] = ord("A")
        for seq in plant:
            if rng.random() < 0.6:
                a = np.frombuffer(seq.encode(), np.uint8)
                if n > len(a) + 2:
                    p = int(rng.integers(0, n - len(a)))
                    bases[i, p:p + len(a)] = a
        quals[i, n:] = 0
        bases[i, n:] = 0
    return bases, quals, lens, mask


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _eq(got, ref):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _eq(g, r)
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_primitives_match_jax():
    rng = np.random.default_rng(1)
    mask = rng.random((9, 40)) < 0.1
    mask[0] = False
    mask[1] = True
    default = rng.integers(-5, 5, 9).astype(np.int32)
    for fn in ("first_true", "last_true"):
        _eq(getattr(tpr, fn)(*_t(mask, default)),
            getattr(jpr, fn)(*_j(mask, default)))
    quals = rng.integers(33, 74, (9, 40)).astype(np.uint8)
    lens = rng.integers(0, 41, 9).astype(np.int32)
    cq_t = tpr.qual_cumsum(*_t(quals, lens))
    cq_j = jpr.qual_cumsum(*_j(quals, lens))
    _eq(cq_t, cq_j)
    for w in (1, 4, 7, 40, 55):
        _eq(tpr.window_sums(cq_t, w), jpr.window_sums(cq_j, w))


def test_align_matches_jax():
    rng = np.random.default_rng(2)
    bases, quals, lens, _ = _batch(2, B=12, L=64)
    lo = rng.integers(-3, 70, 12).astype(np.int32)
    lo[:3] = (0, 64, 63)
    hi = np.maximum(lo, rng.integers(0, 65, 12)).astype(np.int32)
    hi = np.minimum(hi, 64)
    _eq(tal.align_rows(*_t(bases, lo)),
        jal.align_rows(jnp.asarray(bases.astype(np.uint16)),
                       jnp.asarray(lo)).astype(np.uint8))
    _eq(tal.align_spans(*_t(bases, quals, lo, hi)),
        jal.align_spans(*_j(bases, quals, lo, hi)))
    n = np.maximum(hi - np.maximum(lo, 0), 0).astype(np.int32)
    _eq(tal.align_single(*_t(bases, 64 - hi, n)),
        jal.align_single(*_j(bases, 64 - hi, n)))


CUT_CASES = [
    ("cut_front_tail", 0, 0, dict(enabled_front=True, enabled_tail=True,
                                  window_front=4, quality_front=20,
                                  window_tail=4, quality_tail=20)),
    ("window_7_q25", 0, 0, dict(enabled_front=True, enabled_tail=True,
                                window_front=7, quality_front=25,
                                window_tail=7, quality_tail=25)),
    ("front_tail_trim", 2, 1, dict(enabled_front=True, enabled_tail=True,
                                   window_front=4, quality_front=20,
                                   window_tail=4, quality_tail=20)),
    ("global_trim_only", 3, 2, dict(enabled_front=False, enabled_tail=False,
                                    window_front=4, quality_front=20,
                                    window_tail=4, quality_tail=20)),
    ("front_only", 0, 0, dict(enabled_front=True, enabled_tail=False,
                              window_front=5, quality_front=30,
                              window_tail=4, quality_tail=20)),
    ("tail_only", 0, 4, dict(enabled_front=False, enabled_tail=True,
                             window_front=4, quality_front=20,
                             window_tail=9, quality_tail=28)),
    ("nothing", 0, 0, dict(enabled_front=False, enabled_tail=False,
                           window_front=4, quality_front=20,
                           window_tail=4, quality_tail=20)),
]


@pytest.mark.parametrize("name,front,tail,cut", CUT_CASES,
                         ids=[c[0] for c in CUT_CASES])
def test_trim_and_cut_matches_jax(name, front, tail, cut):
    bases, quals, lens, _ = _batch(10 + len(name), B=24, L=120)
    lens[:4] = (0, 3, 9, 120)
    _eq(tq.trim_and_cut(*_t(bases, quals, lens), front, tail, **cut),
        jq.trim_and_cut(*_j(bases, quals, lens), front, tail, **cut))


@pytest.mark.parametrize("compare_req", [10, 8, 3])
def test_trim_polyx_matches_jax(compare_req):
    bases, quals, lens, _ = _batch(20 + compare_req, B=24, L=150,
                                   polya=True)
    rng = np.random.default_rng(compare_req)
    lo = rng.integers(0, 20, 24).astype(np.int32)
    hi = np.maximum(lo, lens - rng.integers(0, 5, 24)).astype(np.int32)
    hi[:2] = lo[:2]                     # empty spans
    _eq(tp.trim_polyx(*_t(bases, lo, hi), compare_req),
        jp.trim_polyx(*_j(bases, lo, hi), compare_req))


FILT = dict(qual_enabled=True, qualified_qual=ord("0"),
            unqualified_percent_limit=40, n_base_limit=1000000,
            n_base_percent_limit=10, avg_qual_req=0, length_enabled=True,
            required_length=20, max_length=0, complexity_enabled=False,
            complexity_threshold_pct=30)
FILTER_CASES = [
    ("defaults", {}),
    ("complexity", dict(complexity_enabled=True, complexity_threshold_pct=55)),
    ("mean_qual", dict(avg_qual_req=22)),
    ("n_limit", dict(n_base_limit=2, n_base_percent_limit=3)),
    ("length_limit", dict(max_length=100, required_length=60)),
    ("no_quality", dict(qual_enabled=False)),
    ("nothing", dict(qual_enabled=False, length_enabled=False)),
]


@pytest.mark.parametrize("name,over", FILTER_CASES,
                         ids=[c[0] for c in FILTER_CASES])
def test_pass_filter_matches_jax(name, over):
    bases, quals, lens, _ = _batch(30 + len(name), B=24, L=160)
    rng = np.random.default_rng(len(name))
    lo = rng.integers(-1, 30, 24).astype(np.int32)     # -1: inactive slot
    hi = np.maximum(lo, lens - rng.integers(0, 30, 24)).astype(np.int32)
    hi[:3] = lo[:3] + (0, 1, 2)
    kw = dict(FILT, **over)
    _eq(tf.pass_filter(*_t(bases, quals, lo, hi, lens), **kw),
        jf.pass_filter(*_j(bases, quals, lo, hi, lens), **kw))


_STAT_KEYS = ("cycle_q20", "cycle_q30", "cycle_content", "cycle_qual",
              "cycle_total_base", "cycle_total_qual", "base_qual_hist",
              "kmer", "median", "rlen")


@pytest.mark.parametrize("pre", [True, False], ids=["pre", "post"])
def test_stat_batch_matches_jax(pre):
    bases, quals, lens, mask = _batch(40 + pre, B=24, L=200)
    bases[3, 10:20] = ord("U")
    quals[5, :30] = 126                      # histogram clamp at 127
    if pre:
        lo = np.zeros(24, np.int32)
        hi = lens
    else:
        rng = np.random.default_rng(4)
        lo = rng.integers(0, 40, 24).astype(np.int32)
        hi = np.maximum(lo, lens - rng.integers(0, 40, 24)).astype(np.int32)
    got = ts.stat_batch(*_t(bases, quals, lo, hi, mask), zero_lo=pre)
    ref = js.stat_batch(*_j(bases, quals, lo, hi, mask), zero_lo=pre)
    for k in _STAT_KEYS:
        _eq(got[k], ref[k])


def _stat_edges(case, B=24, L=120):
    """Edge batches for stat_batch: every byte value in bases and quals,
    ACGTU-rich rows for the 5-mers, and one family of span cases each."""
    rng = np.random.default_rng(sum(map(ord, case)))
    bases = rng.integers(0, 256, (B, L)).astype(np.uint8)
    quals = rng.integers(0, 256, (B, L)).astype(np.uint8)
    for i in range(1, B, 2):
        bases[i] = rng.choice(np.frombuffer(b"ACGTUN", np.uint8), L,
                              p=[.22, .22, .22, .22, .06, .06])
        quals[i] = rng.integers(33, 75, L)
    lo = rng.integers(0, L // 2, B).astype(np.int32)
    hi = (lo + rng.integers(0, L // 2, B)).astype(np.int32)
    mask = np.ones(B, bool)
    cases = {
        "every_byte": [],
        "masked_rows": [(0, L, False), (-1, L, False), (3, 40, False),
                        (-1, 0, False)],
        "empty_and_inverted": [(0, 0, True), (10, 5, True), (50, 50, True),
                               (L, L, True), (7, -3, True)],
        "full_width": [(0, L, True), (0, L, True), (5, L + 4, True),
                       (L - 3, L + 4, True), (L + 5, L + 9, True)],
        "short_reads": [(0, 1, True), (3, 5, True), (7, 10, True),
                        (0, 4, True), (L - 4, L, True), (2, 7, True)],
        "lo_minus_one": [(-1, L, False), (-1, 50, True), (-1, -1, True),
                         (-1, 3, True), (-2, 9, True)],
    }[case]
    for i, (a, b, m) in enumerate(cases):
        for r in (i, i + len(cases)):      # an ACGTU row and a random row
            lo[r], hi[r], mask[r] = a, b, m
    return bases, quals, lo, hi, mask


STAT_EDGE_CASES = ["every_byte", "masked_rows", "empty_and_inverted",
                   "full_width", "short_reads", "lo_minus_one"]


@pytest.mark.parametrize("pre", [True, False], ids=["pre", "post"])
@pytest.mark.parametrize("case", STAT_EDGE_CASES)
def test_stat_batch_edges_match_jax(case, pre):
    """The edge batches of the kernel's contract, through both packages'
    stat_batch on the CPU, every field exactly."""
    bases, quals, lo, hi, mask = _stat_edges(case)
    got = ts.stat_batch(*_t(bases, quals, lo, hi, mask), zero_lo=pre)
    ref = js.stat_batch(*_j(bases, quals, lo, hi, mask), zero_lo=pre)
    for k in _STAT_KEYS:
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
        _eq(got[k], ref[k])
    assert int(np.asarray(ref["kmer"]).sum()) > 0


def test_stat_batch_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a card gets an error from
    the statistics kernel's wrapper, never the plain version."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError):
        ts.stat_batch_into(meta(ts.flat_side_len(64), torch.int64),
                           meta((2, 64), torch.uint8),
                           meta((2, 64), torch.uint8),
                           meta((1, 2), torch.int32), meta((1, 2), torch.int32),
                           meta((1, 2), torch.bool))


def _specs(seq):
    return ja.AdapterSpec(seq, 0.25), ta.AdapterSpec(seq, 0.25)


def _spans(seed, lens, L):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 12, len(lens)).astype(np.int32)
    hi = np.maximum(lo, lens - rng.integers(0, 12, len(lens))).astype(
        np.int32)
    hi[:2] = lo[:2] + (0, 15)        # empty, and too short to trim
    return lo, np.minimum(hi, L)


@pytest.mark.parametrize("side", ["start", "end"])
@pytest.mark.parametrize("alen", [5, 28, 200, 640])
def test_adapter_trim_matches_jax(side, alen):
    rng = np.random.default_rng(alen)
    seq = (START if side == "start" else END) * 30
    seq = seq[:alen] if alen > 5 else "".join(rng.choice(list("ACGT"), 5))
    L = 900 if alen == 640 else 320
    bases, _, lens, _ = _batch(50 + alen, B=20, L=L, plant=(seq,))
    a = np.frombuffer(seq.encode(), np.uint8)
    for i in range(0, 20, 4):       # adapter (or its end) at the read end
        if side == "start":
            bases[i, 2:2 + min(alen, 40)] = a[alen - min(alen, 40):]
        else:
            n = lens[i]
            k = min(alen, 30)
            bases[i, n - k:n] = a[:k]
    lo, hi = _spans(alen, lens, L)
    js_, ts_ = _specs(seq)
    for ext in (10, 0):
        jfn = getattr(ja, "trim_by_sequence_" + side)
        tfn = getattr(ta, "trim_by_sequence_" + side)
        _eq(tfn(*_t(bases, lo, hi), ts_, ext),
            jfn(*_j(bases, lo, hi), js_, ext))


@pytest.mark.parametrize("lengths", [(28, 23), (5, 23), (200, 640)])
def test_find_middle_adapters_matches_jax(lengths):
    rng = np.random.default_rng(sum(lengths))
    s_seq = (START * 30)[:lengths[0]]
    e_seq = (END * 30)[:lengths[1]]
    L = 1600
    bases, _, lens, _ = _batch(60 + lengths[0], B=16, L=L,
                               plant=(s_seq, e_seq))
    lo, hi = _spans(lengths[1], lens, L)
    sj, st = _specs(s_seq)
    ej, et = _specs(e_seq)
    ext = int(rng.integers(0, 12))
    _eq(ta.find_middle_adapters(*_t(bases, lo, hi), st, et, ext),
        ja.find_middle_adapters(*_j(bases, lo, hi), sj, ej, ext))


# ---- low-quality regions: tests/test_regions.py's four patterns, the edge
# cases of the kernel's contract and the stacked [S, B] form

def _lowq_rows(case, rng, L=640):
    """(quals [B, L], lens, lo, hi) of one pattern of tests/test_regions.py:
    random qualities, alternating low/high blocks, many regions (~/#
    blocks), and blocks behind an 11-byte offset of '~'."""
    def blocks(n):
        out = []
        while len(out) < n:
            lvl = (35, 45) if rng.random() < 0.5 else (63, 74)
            out.extend(rng.integers(*lvl, size=int(rng.integers(5, 60))))
        return out[:n]

    if case == "random":
        rows = [list(rng.integers(33, 75, int(rng.integers(0, 280))))
                for _ in range(64)]
    elif case == "blocky":
        rows = [blocks(int(rng.integers(50, 280))) for _ in range(64)]
    elif case == "many":
        rows = []
        for _ in range(32):
            r = []
            for _ in range(10):
                r += [126] * int(rng.integers(10, 30))
                r += [35] * int(rng.integers(10, 30))
            rows.append(r)
    else:   # offset
        rows = [[126] * 11 + blocks(200) for _ in range(16)]
    B = len(rows)
    quals = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(rows):
        quals[i, :len(r)] = r
        lens[i] = len(r)
    lo = np.full(B, 11 if case == "offset" else 0, np.int32)
    return quals, lens, lo, lens.copy()


def _regions_eq(quals, lens, lo, hi, w, q):
    got = tr.detect_regions(*_t(quals, lens, lo, hi), w, q)
    ref = jr.detect_regions(*_j(quals, lens, lo, hi), w, q)
    for k in ("ws1", "last_end", "count"):
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    return got


REGION_CASES = [("random", 20, 15), ("random", 7, 20), ("random", 1, 10),
                ("blocky", 20, 15), ("blocky", 10, 25), ("blocky", 50, 10),
                ("many", 10, 10), ("many", 5, 5), ("offset", 20, 15)]


@pytest.mark.parametrize("case,w,q", REGION_CASES,
                         ids=["%s-w%d-q%d" % c for c in REGION_CASES])
def test_regions_match_jax(case, w, q):
    rng = np.random.default_rng(sum(map(ord, case)) + w)
    got = _regions_eq(*_lowq_rows(case, rng), w, q)
    assert int(got["count"].sum()) > 0
    if case == "many":
        assert int(got["count"].max()) >= 2


def _region_edges(seed, B=40, L=300):
    """Random and blocky quality rows with the span cases of the kernel's
    contract: inactive slots (hi = lo, at 0 and inside the row), spans that
    reach L, non-zero lo, spans past the read's length, short spans, and
    high-quality rows with no region."""
    rng = np.random.default_rng(seed)
    quals = rng.integers(33 + 2, 33 + 41, (B, L)).astype(np.uint8)
    for i in range(0, B, 3):
        a = int(rng.integers(0, L - 40))
        quals[i, a:a + int(rng.integers(20, 120))] = rng.integers(35, 41)
    quals[B - 4:] = 33 + 40
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lo = rng.integers(0, 60, B).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, L, B), L).astype(np.int32)
    cases = [(0, 0), (37, 37), (0, L), (5, L), (L - 1, L), (L, L),
             (120, 140), (0, 1), (250, L), (3, 299)]
    for i, (a, b) in enumerate(cases):
        lo[i], hi[i] = a, b
    lens[:4] = L
    quals[np.arange(L)[None, :] >= lens[:, None]] = 0
    return quals, lens, lo, hi


@pytest.mark.parametrize("w", [-3, 0, 1, 2, 50, 100, 299, 300, 301, 1000])
def test_region_edges_match_jax(w):
    """w <= 0, w = 1, w > l for the short spans, and w = L - 1, L, L + 1 and
    far beyond L, each over the edge batch."""
    got = _regions_eq(*_region_edges(w + 10), w, 10)
    if 0 < w <= 100:
        assert int(got["count"].sum()) > 0
    if w > 300 or w <= 0:
        assert int(got["count"].sum()) == 0


@pytest.mark.parametrize("S,w", [(2, 100), (4, 50)])
def test_regions_stacked_match_jax(S, w):
    """The [S, B] form the step uses (break over 2 slots at the default
    window 100, mask over 4 at 50, Q10), against one JAX call per slot."""
    quals, lens, _, _ = _region_edges(S, B=24, L=700)
    rng = np.random.default_rng(S)
    for i in range(0, 24, 2):
        a = int(rng.integers(0, 500))
        quals[i, a:a + int(rng.integers(60, 200))] = rng.integers(35, 42)
    quals[np.arange(700)[None, :] >= lens[:, None]] = 0
    cut = np.sort(rng.integers(0, 701, (S + 1, 24)), axis=0).astype(np.int32)
    lo, hi = cut[:-1], cut[1:]
    hi[-1, :3] = lo[-1, :3]                   # inactive slots
    T = (33 + 10) * w
    cq_t = tpr.qual_cumsum(*_t(quals, lens))
    cq_j = jpr.qual_cumsum(*_j(quals, lens))
    got = tr.detect_regions_summary(cq_t, *_t(lo, hi), w, T)
    assert all(g.shape == (S, 24) for g in got)
    for k in range(S):
        ref = jr.detect_regions_summary(cq_j, *_j(lo[k], hi[k]), w, T)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r))
    assert int(got[2].sum()) > 0


def test_regions_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card gets an error,
    never the plain version."""
    cq = torch.empty((2, 65), dtype=torch.int32, device="meta")
    span = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tr.detect_regions_summary(cq, span, span, 10, 430)
