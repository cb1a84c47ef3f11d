"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Skips where torch.cuda.is_available() is false (the kernels have no CPU
mode).  Imports neither JAX nor the test configuration's JAX set-up, so it
runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fastplong_tpu_torch.ops import adapter as tadapter
from fastplong_tpu_torch.ops import regions as tregions
from fastplong_tpu_torch.ops import stats_kernels as tstats
from fastplong_tpu_torch.ops.mismatch import mismatch_scan
from fastplong_tpu_torch.ops.myers import (myers_verify, myers_verify_pair,
                                           pattern_table)

ACGTN = np.frombuffer(b"ACGTN", np.uint8)


def _bases(rng, shape):
    return rng.choice(ACGTN, size=shape, p=[.24, .24, .24, .24, .04])


def _adapter(rng, n):
    return bytes(rng.choice(ACGTN[:4], size=n).tolist())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_on_card(card):
    """Each CUDA kernel against its plain version, on the card."""
    from fastplong_tpu_torch.ops.mismatch import mismatch_scan_plain
    from fastplong_tpu_torch.ops.myers import myers_verify_plain
    rng = np.random.default_rng(3)
    bases = torch.from_numpy(_bases(rng, (64, 4096))).to(card)
    for alen in (23, 28, 300):
        ad = torch.from_numpy(np.frombuffer(_adapter(rng, alen), np.uint8)
                              .copy()).to(card)
        assert torch.equal(mismatch_scan(bases, ad),
                           mismatch_scan_plain(bases, ad))
    for K in (1, 7, 20):
        pat = _adapter(rng, 32 * K)
        pm = pattern_table(pat, card)
        text = torch.from_numpy(_bases(rng, (256, 32 * K))).to(card)
        plen = torch.from_numpy(rng.integers(-1, 32 * K + 1, 256)
                                .astype(np.int32)).to(card)
        assert torch.equal(myers_verify(pm, plen, text, plen),
                           myers_verify_plain(pm, plen, text, plen))
    spec = tadapter.AdapterSpec("AATGTACTTCGTTCAGTTACGTATTGCT", 0.25, card)
    anchor = torch.from_numpy(rng.integers(-20, 4100, 64).astype(np.int32)
                              ).to(card)
    ncand = torch.full((64,), 184, dtype=torch.int32, device=card)
    for start, tbl in ((True, spec.seed_rev), (False, spec.seed_fwd)):
        args = (bases, anchor, ncand, tbl, spec.plen, start)
        assert torch.equal(tadapter.seed_scan(*args),
                           tadapter.seed_scan_plain(*args))


# reads and adapters with bytes beyond ACGTN: IUPAC codes and lowercase
ODD = np.frombuffer(b"ACGTNRYKMacgtn", np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("alen", [1, 5, 23, 28, 31, 32, 33, 64, 200, 255,
                                  256, 300, 511, 512, 700, 1023, 1024, 2000,
                                  2047, 2048, 4096, 8192, 8193, 23552])
def test_mismatch_scan_shapes_on_card(card, alen):
    """The scan against its plain version for every L and B here, with
    zero padding at the end of short reads and non-ACGTN bytes; rows
    longer than one tile (L = 20000) and more rows than one wave holds
    (B = 1100) reach the scan's halo loads and its rows-per-block loop.
    The lengths cross each counter depth (255/256, 511/512, 1023/1024,
    2047/2048), and above 8,192 bp the halo is longer than the tile."""
    from fastplong_tpu_torch.ops.mismatch import mismatch_scan_plain
    rng = np.random.default_rng(50 + alen)
    for odd in (False, True):
        letters = ODD if odd else ACGTN[:4]
        ad = torch.from_numpy(rng.choice(letters, size=alen).astype(np.uint8)
                              ).to(card)
        shapes = [(L, B) for L in (1, 31, 1000, 4093, 8192)
                  for B in (1, 3, 64)] + [(20000, 3), (300, 1100)]
        for L, B in shapes:
            x = rng.choice(letters, size=(B, L)).astype(np.uint8)
            lens = rng.integers(0, L + 1, B)
            x[np.arange(L)[None, :] >= lens[:, None]] = 0
            if L > alen:
                x[0, L - alen:] = ad.cpu().numpy()
            x = torch.from_numpy(x).to(card)
            got = mismatch_scan(x, ad)
            torch.cuda.synchronize()
            assert torch.equal(got, mismatch_scan_plain(x, ad)), (L, B)


@pytest.mark.cuda
@pytest.mark.parametrize("alen", [255, 256, 511, 4095, 8191, 16383, 23552,
                                  32767])
def test_mismatch_scan_top_count_on_card(card, alen):
    """An adapter of one repeated byte over reads of another byte: every
    count is alen, so the counter's top level is set everywhere; two
    tiles a row, so the first tile's halo is loaded, not the zero one."""
    x = torch.full((5, 9000), ord("C"), dtype=torch.uint8, device=card)
    ad = torch.full((alen,), ord("A"), dtype=torch.uint8, device=card)
    got = mismatch_scan(x, ad)
    torch.cuda.synchronize()
    want = torch.full((5, 9000), alen, dtype=torch.uint8 if alen <= 255
                      else torch.int32, device=card)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("alen", [28, 700])
def test_mismatch_scan_many_rows_on_card(card, alen):
    """More than 65,535 rows, in both output types."""
    from fastplong_tpu_torch.ops.mismatch import mismatch_scan_plain
    rng = np.random.default_rng(90 + alen)
    x = torch.from_numpy(_bases(rng, (70000, 100))).to(card)
    ad = torch.from_numpy(np.frombuffer(_adapter(rng, alen), np.uint8)
                          .copy()).to(card)
    got = mismatch_scan(x, ad)
    torch.cuda.synchronize()
    assert torch.equal(got, mismatch_scan_plain(x, ad))


@pytest.mark.cuda
def test_mismatch_scan_refuses_past_its_limits(card):
    """No kernel instance counts past 32,767 bp: the wrapper refuses it,
    and takes 32,767 bp."""
    x = torch.full((2, 64), ord("A"), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="unsupported shape"):
        mismatch_scan(x, torch.zeros(32768, dtype=torch.uint8, device=card))
    got = mismatch_scan(x, torch.ones(32767, dtype=torch.uint8, device=card))
    assert torch.equal(got, torch.full_like(got, 32767))


def _problem(rng, K, T, N, card):
    top = 32 * K - int(rng.integers(0, 8))
    pm = pattern_table(_adapter(rng, top), card)
    text = torch.from_numpy(_bases(rng, (N, T))).to(card)
    plen = rng.integers(-1, top + 1, N).astype(np.int32)
    tlen = rng.integers(0, T + 1, N).astype(np.int32)
    if N >= 4:
        plen[:4] = (top, 0, 1, 33)
        tlen[:4] = (T, 0, T, 5)
    return (pm, torch.from_numpy(plen).to(card), text,
            torch.from_numpy(tlen).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("K", list(range(1, 21)))
def test_myers_verify_every_k_on_card(card, K):
    """The verify against its plain version at every K, at a text width
    that is not a multiple of 32 (and, at K = 1, on both sides of the
    register path's 32 columns)."""
    from fastplong_tpu_torch.ops.myers import myers_verify_plain
    rng = np.random.default_rng(70 + K)
    for T in ((27, 45) if K == 1 else (32 * K - 5,)):
        args = _problem(rng, K, T, 333, card)
        got = myers_verify(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, myers_verify_plain(*args)), T


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [((1, 28, 1024), (2, 64, 1000)),
                                    ((7, 200, 300), (1, 23, 1024)),
                                    ((20, 600, 64), (3, 90, 0)),
                                    ((1, 45, 0), (5, 150, 77))])
def test_myers_verify_pair_on_card(card, shapes):
    """The paired launch with different K, T and N in its two problems
    against the plain version of each."""
    from fastplong_tpu_torch.ops.myers import myers_verify_plain
    rng = np.random.default_rng(sum(k * t for k, t, _ in shapes))
    pair = [_problem(rng, *shape, card) for shape in shapes]
    before = myers_verify.launches
    got = myers_verify_pair(*pair)
    torch.cuda.synchronize()
    assert myers_verify.launches == before + 1
    for g, args in zip(got, pair):
        assert torch.equal(g, myers_verify_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("seq", ["AATGTACTTCGTTCAGTTACGTATTGCT", "ACGTN",
                                 "AGCTTCAGTNRYacgt", "A"])
def test_seed_scan_on_card(card, seq):
    """The seed scan against its plain version on both sides, at plen 16
    and below, with non-ACGT bytes in reads and seeds and anchors at and
    beyond both row ends."""
    rng = np.random.default_rng(len(seq))
    spec = tadapter.AdapterSpec(seq, 0.25, card)
    B, L = 300, 400
    x = rng.choice(np.frombuffer(b"ACGTNRYacgt\0", np.uint8), (B, L))
    anchor = rng.integers(-40, L + 40, B).astype(np.int32)
    anchor[:5] = (0, L - spec.plen, -3, L - 1, L)
    ncand = rng.integers(0, 185, B).astype(np.int32)
    x, anchor, ncand = (torch.from_numpy(a).to(card)
                        for a in (x, anchor, ncand))
    for start, tbl in ((True, spec.seed_rev), (False, spec.seed_fwd)):
        args = (x, anchor, ncand, tbl, spec.plen, start)
        got = tadapter.seed_scan(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, tadapter.seed_scan_plain(*args)), start


@pytest.mark.cuda
@pytest.mark.parametrize("form", [(1, True), (2, False), (4, False)],
                         ids=["pre", "post", "post_S4"])
@pytest.mark.parametrize("shape", [(40, 300), (1100, 64), (300, 1000),
                                   (3, 8192), (1100, 8192)])
def test_stat_batch_on_card(card, shape, form):
    """The statistics kernel (stat_batch_into) against its plain version,
    accumulator and medians exactly, from a non-zero starting accumulator
    of twice the batch's cycle length (whose later cycles must stay as they
    were), on chip_smoke.py's edge batch with each slot's spans drawn anew;
    L = 300 and 1000 take the byte-load path, B = 1100 gives row blocks
    more than one read, and at L = 8192 column blocks take chunks of rows."""
    from chip_smoke import _stat_into_equal, _stat_slots
    S, zero_lo = form
    rng = np.random.default_rng(shape[0] + shape[1] + S)
    arrs = [torch.from_numpy(a).to(card)
            for a in _stat_slots(rng, *shape, S, edge=True)]
    before = tstats.stat_batch_into.launches
    err, _ = _stat_into_equal("stat_batch", arrs, zero_lo, 2 * shape[1],
                              shape[0])
    assert err == 0
    assert tstats.stat_batch_into.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2, 15, 50, 100, 299, 300, 301, 1000])
def test_regions_edges_on_card(card, w):
    """The region scan against its plain version, all three outputs
    exactly, on chip_smoke.py's edge batch (w = 1, w beyond L and beyond
    short spans, inactive slots, spans reaching L, non-zero lo, the
    many-regions pattern, rows with no region), in the [B] form and the
    stacked [2, B] form, one launch each."""
    from chip_smoke import _region_edge_batch
    from fastplong_tpu_torch.ops.primitives import qual_cumsum
    rng = np.random.default_rng(w)
    quals, lens, lo, hi = (torch.from_numpy(a).to(card)
                           for a in _region_edge_batch(rng))
    cq = qual_cumsum(quals, lens)
    for q in (10, 20):
        for a, b in ((lo[0], hi[0]), (lo, hi)):
            args = (cq, a, b, w, (33 + q) * w)
            before = tregions.detect_regions_summary.launches
            got = tregions.detect_regions_summary(*args)
            torch.cuda.synchronize()
            assert tregions.detect_regions_summary.launches == before + 1
            ref = tregions.detect_regions_summary_plain(*args)
            for g, r in zip(got, ref):
                assert g.shape == a.shape and torch.equal(g, r), (q, a.dim())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1100, 8192), (3, 20000), (64, 700)])
def test_regions_stacked_on_card(card, shape):
    """The main path's two forms (break over 2 slots at window 100, mask
    over the 4 slots break leaves at window 50, Q10) against the plain
    version, with chip_smoke.py's low-quality stretches and slots."""
    from chip_smoke import _lowq_quals, _region_spans
    from fastplong_tpu_torch.ops.primitives import qual_cumsum
    from fastplong_tpu_torch.pipeline.device import break_slots
    B, L = shape
    rng = np.random.default_rng(B + L)
    lens = rng.integers(L // 2 + 1, L + 1, B).astype(np.int32)
    quals = torch.from_numpy(_lowq_quals(rng, B, L)).to(card)
    cq = qual_cumsum(quals, torch.from_numpy(lens).to(card))
    two = _region_spans(rng, lens)
    for s, w in ((two, 100), (break_slots(two, cq, 100, 10), 50)):
        args = (cq, s.lo, torch.where(s.active, s.hi, s.lo), w, 43 * w)
        got = tregions.detect_regions_summary(*args)
        torch.cuda.synchronize()
        ref = tregions.detect_regions_summary_plain(*args)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), w


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 5, 50, 100])
def test_regions_block_steps_on_card(card, w):
    """Regions that start and end on either side of the block's search
    steps (multiples of 1,024 positions from the span's start, and of a
    warp's 128), in spans with a non-zero lo, against the plain version."""
    B, L = 64, 6000
    rng = np.random.default_rng(w)
    quals = rng.integers(33 + 25, 33 + 41, (B, L)).astype(np.uint8)
    lo = rng.integers(0, 40, B).astype(np.int32)
    for i in range(B):
        for edge in (1024 * (1 + i % 4), 128 * (1 + i % 7)):
            p = int(lo[i]) + edge + int(rng.integers(-w - 3, w + 3))
            k = int(rng.integers(w + 1, 3 * w + 40))
            quals[i, max(p, 0):p + k] = 33 + 3
    lens = np.full(B, L, np.int32)
    hi = np.where(np.arange(B) % 3 == 0, L,
                  L - rng.integers(0, 500, B)).astype(np.int32)
    from fastplong_tpu_torch.ops.primitives import qual_cumsum
    cq = qual_cumsum(torch.from_numpy(quals).to(card),
                     torch.from_numpy(lens).to(card))
    lo_t, hi_t = (torch.from_numpy(a).to(card) for a in (lo, hi))
    for q in (10, 20):
        args = (cq, lo_t, hi_t, w, (33 + q) * w)
        got = tregions.detect_regions_summary(*args)
        torch.cuda.synchronize()
        ref = tregions.detect_regions_summary_plain(*args)
        assert int(ref[2].sum()) > 0
        for g, r in zip(got, ref):
            assert torch.equal(g, r), q


def _blockscan_case(rng, K, T, N, card, plen_max, pat_bytes, text_bytes):
    """A block-scan problem with a plen_max-byte pattern over pat_bytes
    (a [256, K] table) and texts over text_bytes, a third of them close
    to the pattern; plen and tlen random per lane, with the first lanes at
    the pattern's length, at 0 and at the edges of a 32-bit word and of a
    slab of 32 words."""
    pat = bytes(rng.choice(np.frombuffer(pat_bytes, np.uint8), plen_max)
                .tolist())
    pm = pattern_table(pat, card)
    assert pm.shape[1] == K
    text = rng.choice(np.frombuffer(text_bytes, np.uint8), (N, T))
    m = min(T, plen_max)
    for n in range(0, N, 3):
        keep = rng.random(m) < 0.9
        text[n, :m] = np.where(keep, np.frombuffer(pat[:m], np.uint8),
                               text[n, :m])
    plen = rng.integers(-1, plen_max + 1, N).astype(np.int32)
    tlen = rng.integers(-1, T + 3, N).astype(np.int32)
    edges = [plen_max, 0] + [e for e in (1, 32, 33, 1024, 1025, 2048, 2049,
                                         plen_max - 1) if e < plen_max]
    k = min(N, len(edges))
    plen[:k] = edges[:k]
    tlen[:k] = T
    return (pm, torch.from_numpy(plen).to(card), torch.from_numpy(text)
            .to(card), torch.from_numpy(tlen).to(card))


ACGT = b"ACGT"
# seven distinct bytes, two of them >= 128: the byte permute that turns a
# text byte into a mask address must not sign-extend them
ODD7 = b"ACGTN\x80\xfe"
# twenty distinct bytes: the masks of a step come from twenty rows of the
# table, read through L1
ODD20 = bytes(range(60, 78)) + b"\x81\xff"
TEXT = b"ACGTN"
# bytes absent from every pattern above: rank "absent"
TEXT_ABSENT = b"ACGTN\x00a\x7f\x90\xff"
# byte 0 in the pattern: a column before a word's first is not neutral
ZERO = b"\x00ACGT\xc0"


def _byte_ids(v):
    """Short test ids for the byte sets."""
    if isinstance(v, bytes):
        return {b"ACGT": "acgt", b"ACGTN": "acgtn", ODD7: "odd7",
                ODD20: "odd20", TEXT_ABSENT: "absent",
                ZERO: "zero"}.get(v, "absent20")
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("K,T,N,plen_max,pat_bytes,text_bytes", [
    (21, 700, 64, None, None, None), (22, 330, 96, None, None, None),
    (63, 160, 40, None, None, None), (157, 96, 9, None, None, None),
    # the edges of a slab of 32 words, where a lane's warps meet
    (32, 300, 40, 1024, ACGT, TEXT), (33, 300, 40, 1025, ACGT, TEXT),
    (64, 210, 33, 2048, ACGT, TEXT), (65, 210, 33, 2049, ACGT, TEXT),
    # T not a multiple of 8 or 16, and T past a warp's text ring (1,024)
    (22, 1100, 20, 700, ACGT, TEXT), (33, 1037, 6, 1025, ACGT, TEXT),
    # beyond the cap of 32 warps a lane: two rounds of slabs
    (1057, 24, 5, 33800, ACGT, TEXT),
    # a table of 6,000 words (24,000 B a byte's row), six rounds of slabs
    (6000, 9, 3, 191990, ACGT, TEXT),
    # one lane; blocks of 2 and 8 lanes with a partial last block
    (22, 700, 1, 700, ACGT, TEXT), (22, 700, 133, 700, ACGT, TEXT),
    (33, 120, 1001, 1050, ACGT, TEXT),
    # pattern bytes outside ACGT and >= 128, from 7 and 20 rows of the
    # table; texts with bytes absent from the pattern
    (22, 333, 50, 700, ODD7, TEXT_ABSENT), (40, 200, 50, 1270, ODD7,
                                            TEXT_ABSENT),
    (22, 333, 50, 700, ODD20, TEXT_ABSENT + bytes(range(60, 78))),
    (22, 300, 30, 700, ACGT, TEXT_ABSENT),
    (22, 333, 50, 700, ZERO, TEXT_ABSENT), (40, 200, 30, 1270, ZERO,
                                            TEXT_ABSENT)], ids=_byte_ids)
def test_myers_blockscan_on_card(card, K, T, N, plen_max, pat_bytes,
                                 text_bytes):
    """The block-scan against its plain version, one launch a call: K =
    21, 22, 63 and 157 (5,000 bp) on texts whose widths are not multiples
    of 8 with empty patterns and texts; the slab edges of 32 and 64 words;
    a long T; rounds of slabs past the warp cap; a table of 6,000 words;
    one lane and partial blocks; bytes outside ACGT in the pattern and
    bytes absent from it in the texts."""
    from fastplong_tpu_torch.ops.myers import (myers_blockscan,
                                               myers_verify_plain)
    rng = np.random.default_rng(90 + K + T + N)
    if plen_max is None:
        rng = np.random.default_rng(90 + K)
        args = _problem(rng, K, T, N, card)
    else:
        args = _blockscan_case(rng, K, T, N, card, plen_max, pat_bytes,
                               text_bytes)
    before = myers_blockscan.launches
    got = myers_blockscan(*args)
    torch.cuda.synchronize()
    assert myers_blockscan.launches == before + 1
    assert torch.equal(got, myers_verify_plain(*args))


def _table_pattern(pm, plen):
    """The first plen bytes of the pattern that pattern_table made pm of:
    position i holds the byte whose row has bit i % 32 of word i // 32."""
    bits = np.unpackbits(pm.cpu().numpy().view(np.uint8), axis=1,
                         bitorder="little")
    return bytes(np.argmax(bits[:, :plen], axis=0).astype(np.uint8))


def levenshtein(pat, plen, text, tlen):
    """The block-scan's distances by the textbook dynamic program, for
    patterns too long for the plain version's word loop: out[n] is the
    edit distance of pat[:plen[n]] against text[n, :min(tlen[n], T)]
    (tlen[n] where plen[n] <= 0).  One pattern-long row a text column:
    row[i] = min(up + 1, diagonal + cost), then the insertions as
    i + a running minimum of row[k] - k."""
    pat = np.frombuffer(pat, np.uint8)
    N, T = text.shape
    out = np.empty(N, np.int32)
    for n in range(N):
        p, cols = int(plen[n]), min(max(int(tlen[n]), 0), T)
        if p <= 0:
            out[n] = tlen[n]
            continue
        idx = np.arange(p + 1)
        row = idx.copy()
        for j in range(cols):
            nxt = np.empty_like(row)
            nxt[0] = j + 1
            np.minimum(row[1:] + 1, row[:-1] + (pat[:p] != text[n, j]),
                       out=nxt[1:])
            row = idx + np.minimum.accumulate(nxt - idx)
        out[n] = row[p]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("K,T,N,plen_max", [
    (1057, 1100, 12, 33800), (1057, 2000, 12, 33800),
    (2100, 1337, 12, 67200)])
def test_myers_blockscan_rounds_on_card(card, K, T, N, plen_max):
    """Rounds of slabs (K past 1,024 words: 2 and 3 rounds of 32 warps) on
    texts of more than 128 steps, so that each carry ring between two
    warps wraps, the producer may wait for room and the row between
    rounds holds 138-250 entries; lanes of 32 and 33 slabs beside the
    longest.  Against the dynamic program (levenshtein), since the plain
    version's word loop would take minutes here; tests/
    test_torch_long_adapters.py holds the two equal at smaller sizes."""
    from fastplong_tpu_torch.ops.myers import myers_blockscan
    rng = np.random.default_rng([K, T, N])
    pm, plen, text, tlen = _blockscan_case(rng, K, T, N, card, plen_max,
                                           ACGT, TEXT)
    # lanes of exactly one round, one slab more, and of the last slab
    plen[N - 4:] = torch.tensor([32768, 32769, plen_max - 33, plen_max - 1],
                                dtype=torch.int32)
    before = myers_blockscan.launches
    got = myers_blockscan(pm, plen, text, tlen)
    torch.cuda.synchronize()
    assert myers_blockscan.launches == before + 1
    want = levenshtein(_table_pattern(pm, plen_max), plen.cpu().numpy(),
                       text.cpu().numpy(), tlen.cpu().numpy())
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [1, -1], ids=["start", "end"])
def test_kmer_hist_on_card(card, sign):
    """The k-mer fill against its plain version from a non-zero
    accumulator: bytes outside ACGTU, npos 0, 129 and beyond the row,
    positions whose sums pass 2^32."""
    from fastplong_tpu_torch.ops.kmer import (KEYSPACE, kmer_hist,
                                              kmer_hist_plain)
    rng = np.random.default_rng(5 + sign)
    n = 2000
    mat = rng.choice(np.frombuffer(b"ACGTUNa.", np.uint8), (n, 139),
                     p=[.22, .22, .22, .22, .04, .04, .02, .02])
    mat[::3, 20:43] = np.frombuffer(b"AGCAATACGTAACTGAACGAAGT", np.uint8)
    npos = rng.integers(0, 130, n).astype(np.int32)
    npos[:4] = (0, 129, 300, -5)
    pbase = rng.integers(0, 1 << 31, n).astype(np.int64)
    g = torch.Generator().manual_seed(sign + 2)
    start = torch.randint(0, 1 << 40, (2, KEYSPACE), generator=g)
    got, ref = start.to(card), start.clone()
    before = kmer_hist.launches
    kmer_hist(got, *(torch.from_numpy(a).to(card)
                     for a in (mat, npos, pbase)), sign)
    torch.cuda.synchronize()
    assert kmer_hist.launches == before + 1
    kmer_hist_plain(ref, *(torch.from_numpy(a) for a in (mat, npos, pbase)),
                    sign)
    assert torch.equal(got.cpu(), ref)
    assert int((ref - start)[1].max()) > 1 << 32


def _kmer_groups(rng, case, n):
    """(mat, npos, pbase) whose lanes group at one column, as the k-mer
    kernel's warps (32 rows at one column) see them: every row carrying END
    at column 116 with one pbase (all 32 lanes one group); groups of mixed
    size at column 60, bytes outside ACGTU inside some windows, npos 0,
    negative, short of the column or beyond the row, with two pbase values
    in every warp ("mixed_groups": each lane adds its own window) or one
    ("mixed_one_base": the groups merge, around the invalid lanes); T and U
    rows in one group; one group's positions near 2^31, so that its sum
    passes 2^35."""
    mat = rng.choice(ACGTN[:4], (n, 139))
    npos = np.full(n, 129, np.int32)
    pbase = np.full(n, 139, np.int64)
    if case in ("one_group", "near_2_31"):
        mat[:, 116:139] = np.frombuffer(b"AGCAATACGTAACTGAACGAAGT", np.uint8)
        if case == "near_2_31":
            pbase[:] = (1 << 31) - 7
    elif case == "t_and_u":
        mer = np.frombuffer(b"TTACGTTCAT", np.uint8)
        mat[:, 30:40] = np.where((mer == ord("T")) & (rng.random((n, 10))
                                                      < 0.5), ord("U"), mer)
    else:
        mers = [np.frombuffer(m, np.uint8) for m in (
            b"ACGTACGTAC", b"GATTACAGAT", b"CCCCCGGGGG", b"TTTTTTTTTA")]
        pick = rng.choice(4, n, p=[.5, .3, .15, .05])
        for i in range(n):
            mat[i, 60:70] = mers[pick[i]]
        mat[::5, 65] = ord("N")
        mat[4::9, 69] = ord("a")
        npos[1::7] = 0
        npos[2::7] = -3
        npos[3::7] = 300
        npos[4::7] = 60
        if case == "mixed_groups":
            pbase[::3] = 200
        elif n >= 7:
            # the first warp's first group: rows 1 and 2, then row 6 past
            # rows 3-5 (an N byte, npos 0, npos at the column)
            mat[1:7, 60:70] = mers[0]
            npos[1:7] = 129
            mat[3, 65] = ord("N")
            npos[4:6] = (0, 60)
    return mat, npos, pbase


def _gapped_groups(mat, npos, pbase, col):
    """Warps (32 rows) whose rows share one pbase and whose first group at
    column `col` (the key of the first lane whose right neighbour holds the
    same key, as the kernel forms it) has members that are not adjacent,
    with a lane whose window is invalid between two of them."""
    ok = np.isin(mat[:, col:col + 10], np.frombuffer(b"ACGTU", np.uint8))
    valid = ok.all(axis=1) & (col < npos)
    keys = [bytes(r).replace(b"U", b"T") for r in mat[:, col:col + 10]]
    found = 0
    for w0 in range(0, len(mat) - 1, 32):
        rows = range(w0, min(w0 + 32, len(mat)))
        if len(set(pbase[rows.start:rows.stop])) != 1:
            continue
        firsts = [r for r in rows[:-1] if valid[r] and valid[r + 1]
                  and keys[r] == keys[r + 1]]
        if not firsts:
            continue
        group = [r for r in rows if valid[r] and keys[r] == keys[firsts[0]]]
        found += any(b - a > 1 and not valid[a + 1:b].all()
                     for a, b in zip(group, group[1:]))
    return found


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [1, -1], ids=["start", "end"])
@pytest.mark.parametrize("case,n", [
    ("one_group", 2000), ("mixed_groups", 2000), ("t_and_u", 2000),
    ("near_2_31", 2000), ("mixed_groups", 1), ("mixed_groups", 31),
    ("mixed_groups", 33), ("mixed_groups", 8001), ("mixed_one_base", 2000),
    ("mixed_one_base", 33), ("mixed_one_base", 8001)])
def test_kmer_hist_groups_on_card(card, case, n, sign):
    """The k-mer kernel's merged groups against the plain version from a
    non-zero accumulator, one launch a call, at partial warps and blocks
    (n of 1, 31, 33 and 8,001) too; "mixed_one_base" holds, in every case,
    a warp whose first group merges across an invalid lane."""
    from fastplong_tpu_torch.ops.kmer import (KEYSPACE, kmer_hist,
                                              kmer_hist_plain)
    rng = np.random.default_rng(n + len(case) + sign)
    mat, npos, pbase = _kmer_groups(rng, case, n)
    if case == "mixed_one_base":
        assert _gapped_groups(mat, npos, pbase, 60) > 0
    g = torch.Generator().manual_seed(n + sign)
    start = torch.randint(0, 1 << 40, (2, KEYSPACE), generator=g)
    got, ref = start.to(card), start.clone()
    before = kmer_hist.launches
    kmer_hist(got, *(torch.from_numpy(a).to(card)
                     for a in (mat, npos, pbase)), sign)
    torch.cuda.synchronize()
    assert kmer_hist.launches == before + 1
    kmer_hist_plain(ref, *(torch.from_numpy(a) for a in (mat, npos, pbase)),
                    sign)
    assert torch.equal(got.cpu(), ref)
    added = ref - start
    if case in ("one_group", "t_and_u", "near_2_31"):
        # the group's key collects every row
        assert int(added[0].max()) >= n
    if case == "near_2_31":
        assert int(added[1].max()) > 1 << 35


# ------------------------------------------------ --devices (row slices)

START = "AATGTACTTCGTTCAGTTACGTATTGCT"
END = "AGCAATACGTAACTGAACGAAGT"
HEADLINE = ["-s", START, "-e", END, "-5", "-3", "-x"]


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    return torch.device("cuda", 1)


def _slices_input(path):
    """Reads with both headline adapters and, in a third of them, a
    stretch of Q2-Q8 qualities for break and mask."""
    from chip_smoke import gen_input
    gen_input(path, n_reads=600, mean_len=1500, seed=31, lowq=0.3)


def _argv(d, in_fq, flags):
    return ["fastplong", "-i", in_fq, "-o", str(d / "out.fq"),
            "--failed_out", str(d / "failed.fq"), "-j", str(d / "r.json"),
            "-h", str(d / "r.html")] + flags


def _same_outputs(a, b):
    from chip_smoke import _normalised
    for n in ("out.fq", "failed.fq", "r.json", "r.html"):
        assert _normalised(str(a / n)) == _normalised(str(b / n)), n


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [HEADLINE, HEADLINE + ["-b", "-N"]],
                         ids=["headline", "break_mask"])
def test_two_slices_on_one_card(card, flags, tmp_path):
    """The runner with devices=[cuda:0, cuda:0] (two row slices, two
    statistics partials) writes what it writes with one slice."""
    from fastplong_tpu_torch.main import build_parser, options_from_args
    from fastplong_tpu_torch.processor import process
    in_fq = str(tmp_path / "in.fq")
    _slices_input(in_fq)
    for tag, n in (("one", 1), ("two", 2)):
        d = tmp_path / tag
        d.mkdir()
        argv = _argv(d, in_fq, flags)
        opt = options_from_args(build_parser().parse_args(argv[1:]), argv)
        process(opt, devices=[torch.device("cuda", 0)] * n)
    _same_outputs(tmp_path / "one", tmp_path / "two")


@pytest.mark.cuda
def test_devices_2_on_two_cards(two_cards, tmp_path, monkeypatch):
    """--devices 2 through the CLI equals --devices 1 (both cards used)."""
    from fastplong_tpu_torch.main import main
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cuda")
    in_fq = str(tmp_path / "in.fq")
    _slices_input(in_fq)
    for tag, n in (("one", 1), ("two", 2)):
        d = tmp_path / tag
        d.mkdir()
        assert main(_argv(d, in_fq, HEADLINE + ["--devices", str(n)])) == 0
    _same_outputs(tmp_path / "one", tmp_path / "two")


@pytest.mark.cuda
def test_kernels_on_second_card(two_cards):
    """Every kernel wrapper on cuda:1 tensors, called while cuda:0 is the
    thread's current device, against its plain version on the same
    tensors: each launch goes to its tensors' card (ops/cuda_lib.py:
    launch), one launch a call."""
    from chip_smoke import (_region_edge_batch, _stat_into_equal,
                            _stat_slots)
    from fastplong_tpu_torch.ops.kmer import (KEYSPACE, kmer_hist,
                                              kmer_hist_plain)
    from fastplong_tpu_torch.ops.mismatch import mismatch_scan_plain
    from fastplong_tpu_torch.ops.myers import (myers_blockscan,
                                               myers_verify_plain)
    from fastplong_tpu_torch.ops.primitives import qual_cumsum
    dev = two_cards
    counters = (mismatch_scan, myers_verify, myers_blockscan,
                tadapter.seed_scan, tstats.stat_batch_into,
                tregions.detect_regions_summary, kmer_hist)
    before = sum(c.launches for c in counters)
    rng = np.random.default_rng(17)
    with torch.cuda.device(0):
        bases = torch.from_numpy(_bases(rng, (64, 4096))).to(dev)
        for alen in (28, 300):       # the uint8 and the int32 path
            ad = torch.from_numpy(np.frombuffer(_adapter(rng, alen), np.uint8)
                                  .copy()).to(dev)
            assert torch.equal(mismatch_scan(bases, ad),
                               mismatch_scan_plain(bases, ad)), alen
        one, seven = _problem(rng, 1, 45, 200, dev), _problem(rng, 7, 220,
                                                              100, dev)
        assert torch.equal(myers_verify(*seven), myers_verify_plain(*seven))
        got = myers_verify_pair(one, seven)
        assert torch.equal(got[0], myers_verify_plain(*one))
        assert torch.equal(got[1], myers_verify_plain(*seven))
        longer = _problem(rng, 22, 330, 64, dev)
        assert torch.equal(myers_blockscan(*longer),
                           myers_verify_plain(*longer))
        spec = tadapter.AdapterSpec(START, 0.25, dev)
        anchor = torch.from_numpy(rng.integers(-20, 4100, 64)
                                  .astype(np.int32)).to(dev)
        ncand = torch.full((64,), 184, dtype=torch.int32, device=dev)
        for start, tbl in ((True, spec.seed_rev), (False, spec.seed_fwd)):
            args = (bases, anchor, ncand, tbl, spec.plen, start)
            assert torch.equal(tadapter.seed_scan(*args),
                               tadapter.seed_scan_plain(*args)), start
        arrs = [torch.from_numpy(a).to(dev)
                for a in _stat_slots(rng, 300, 1000, 2, edge=True)]
        assert _stat_into_equal("stat_batch", arrs, False, 2000, 300)[0] == 0
        quals, lens, lo, hi = (torch.from_numpy(a).to(dev)
                               for a in _region_edge_batch(rng))
        args = (qual_cumsum(quals, lens), lo, hi, 50, 43 * 50)
        for g, r in zip(tregions.detect_regions_summary(*args),
                        tregions.detect_regions_summary_plain(*args)):
            assert torch.equal(g, r)
        mat = torch.from_numpy(_bases(rng, (500, 139))).to(dev)
        npos = torch.full((500,), 129, dtype=torch.int32, device=dev)
        pbase = torch.from_numpy(rng.integers(0, 1 << 20, 500)).to(dev)
        acc = torch.zeros((2, KEYSPACE), dtype=torch.int64, device=dev)
        ref = acc.clone()
        kmer_hist(acc, mat, npos, pbase, 1)
        kmer_hist_plain(ref, mat, npos, pbase, 1)
        assert torch.equal(acc, ref)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0
    assert sum(c.launches for c in counters) == before + 10
