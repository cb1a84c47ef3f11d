"""The port's three kernel functions against the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version; inputs are
made from a numpy seed and handed to both packages.  Every result is an
integer, so every comparison is exact (tolerance 0).  The CUDA kernels
themselves run only on a card: tests/test_torch_cuda.py holds each against
its plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastplong_tpu.ops import adapter as jadapter
from fastplong_tpu.ops import myers as jmyers
from fastplong_tpu.ops.pallas_kernels import mismatch_scan as pallas_scan
from fastplong_tpu_torch.ops import adapter as tadapter
from fastplong_tpu_torch.ops.mismatch import mismatch_scan
from fastplong_tpu_torch.ops.myers import (myers_verify, myers_verify_pair,
                                           pattern_table)

ACGTN = np.frombuffer(b"ACGTN", np.uint8)


def _bases(rng, shape):
    return rng.choice(ACGTN, size=shape, p=[.24, .24, .24, .24, .04])


def _adapter(rng, n):
    return bytes(rng.choice(ACGTN[:4], size=n).tolist())


@pytest.mark.parametrize("alen", [5, 23, 28, 200, 255, 256, 300, 511, 512,
                                  640, 1024, 2048])
def test_mismatch_scan_matches_jax(alen):
    """Exact at each counter depth's edge: uint8 up to 255 bp, int32 above,
    with counts from 0 (the planted adapter) up to alen."""
    rng = np.random.default_rng(alen)
    data = _adapter(rng, alen)
    # rows wide enough to hold the whole adapter above 640 bp
    L = 700 if alen <= 640 else alen + 352
    n = min(alen, L - 100)
    bases = _bases(rng, (3, L))
    # plant the adapter (and a damaged copy) so low counts occur
    bases[0, 40:40 + n] = np.frombuffer(data, np.uint8)[:n]
    bases[1, 10:10 + n] = np.frombuffer(data, np.uint8)[:n]
    bases[1, 12] = ord("N")
    ref = np.asarray(jadapter._mismatch_full(jnp.asarray(bases), data))
    got = mismatch_scan(torch.from_numpy(bases),
                        torch.from_numpy(np.frombuffer(data, np.uint8).copy()))
    assert got.numpy().dtype == ref.dtype
    assert ref.dtype == (np.uint8 if alen <= 255 else np.int32)
    np.testing.assert_array_equal(got.numpy(), ref)
    if alen > 640:   # 0 at the planted copy; alen - 1 or more at the end
        assert ref[0, 40] == 0 and ref[:, -1].min() >= alen - 1
    if alen <= 256:
        pl = np.asarray(pallas_scan(jnp.asarray(bases), data, interpret=True))
        np.testing.assert_array_equal(got.numpy().astype(np.int32), pl)


def test_mismatch_scan_limits():
    """The wrapper takes every adapter length up to the kernel's deepest
    counter (32,767 bp), any row count, and refuses what would overflow
    the kernel's int indices."""
    from fastplong_tpu_torch.ops.mismatch import shape_ok
    assert all(shape_ok(1024, 8192, a) for a in (1, 255, 256, 24064, 32767))
    assert shape_ok(70000, 100, 700) and shape_ok(2 ** 31 - 1, 1, 28)
    assert not shape_ok(1, 100, 0) and not shape_ok(1, 100, 32768)
    assert not shape_ok(2 ** 31, 1, 28)
    assert not shape_ok(1, 2 ** 31 - 8192, 28)


@pytest.mark.parametrize("K", list(range(1, 21)))
def test_myers_verify_matches_jax(K):
    rng = np.random.default_rng(100 + K)
    top = 32 * K - int(rng.integers(0, 8))          # longest pattern, K words
    pattern = _adapter(rng, top)
    T = top + 8
    N = 10
    text = _bases(rng, (N, T))
    text[0, 3:3 + top - 2] = np.frombuffer(pattern, np.uint8)[:top - 2]
    plen = rng.integers(1, top + 1, N).astype(np.int32)
    tlen = rng.integers(0, T + 1, N).astype(np.int32)
    plen[:5] = (top, 0, -3, top, 1)        # full, empty, negative, ragged
    tlen[:5] = (T, 7, 4, 0, T)
    masks, Kj = jmyers.build_pattern_masks(pattern)
    assert Kj == K
    ref = np.asarray(jmyers.myers_distance_unrolled(
        masks, K, jnp.asarray(plen), jnp.asarray(text), jnp.asarray(tlen)))
    got = myers_verify(pattern_table(pattern), torch.from_numpy(plen),
                       torch.from_numpy(text), torch.from_numpy(tlen))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the independent DP oracle on every lane (text may be shorter than T)
    for n in range(N):
        p = max(int(plen[n]), 0)
        want = jmyers.edit_distance_host(pattern[:p],
                                         text[n, :tlen[n]].tobytes())
        assert int(got[n]) == want, (n, p, int(tlen[n]))


@pytest.mark.parametrize("alen", [1, 31, 32, 33, 64])
@pytest.mark.parametrize("alphabet", [b"ACGT", b"ACGTNRYKMSWacgtn"])
def test_mismatch_scan_word_edges_and_bytes(alen, alphabet):
    """Lengths at the edges of 32-position words, and adapters and reads
    holding N, IUPAC and lowercase bytes, against _mismatch_full."""
    rng = np.random.default_rng(1000 + alen + len(alphabet))
    letters = np.frombuffer(alphabet, np.uint8)
    data = bytes(rng.choice(letters, size=alen).tolist())
    bases = rng.choice(letters, size=(4, 257)).astype(np.uint8)
    bases[0, 5:5 + alen] = np.frombuffer(data, np.uint8)
    bases[2, 200:] = 0                      # zero padding of a short read
    ref = np.asarray(jadapter._mismatch_full(jnp.asarray(bases), data))
    got = mismatch_scan(torch.from_numpy(bases),
                        torch.from_numpy(np.frombuffer(data, np.uint8).copy()))
    assert got.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def _myers_problem(rng, K, T, N):
    """A random problem with K pattern words and text width T: full,
    empty, negative and ragged pattern lengths; texts of length 0, short
    and full."""
    top = 32 * K - int(rng.integers(0, 8))
    pattern = _adapter(rng, top)
    text = _bases(rng, (N, T))
    if N:
        n = min(T, top) - 2
        text[0, 1:1 + n] = np.frombuffer(pattern, np.uint8)[:n]
    plen = rng.integers(1, top + 1, N).astype(np.int32)
    tlen = rng.integers(0, T + 1, N).astype(np.int32)
    k = min(N, 5)
    plen[:k] = (top, 0, -3, top, 1)[:k]
    tlen[:k] = (T, 7, 4, 0, T)[:k]
    return pattern, plen, text, tlen


@pytest.mark.parametrize("shapes", [((1, 28, 16), (2, 64, 9)),
                                    ((2, 45, 12), (7, 200, 6)),
                                    ((1, 23, 0), (2, 40, 7)),
                                    ((7, 150, 5), (1, 20, 0))])
def test_myers_verify_pair_matches_jax(shapes):
    """Each problem of a pair, with its own K, T and N, against
    myers_distance_unrolled."""
    rng = np.random.default_rng(sum(k * t + n for k, t, n in shapes))
    problems = [_myers_problem(rng, *shape) for shape in shapes]
    got = myers_verify_pair(*[
        (pattern_table(pat), torch.from_numpy(plen), torch.from_numpy(text),
         torch.from_numpy(tlen)) for pat, plen, text, tlen in problems])
    for (pat, plen, text, tlen), g in zip(problems, got):
        masks, K = jmyers.build_pattern_masks(pat)
        ref = np.asarray(jmyers.myers_distance_unrolled(
            masks, K, jnp.asarray(plen), jnp.asarray(text),
            jnp.asarray(tlen)))
        assert g.dtype == torch.int32 and g.shape == (len(plen),)
        np.testing.assert_array_equal(g.numpy(), ref)


@pytest.mark.parametrize("start_side", [True, False])
def test_seed_scan_matches_jax(start_side):
    rng = np.random.default_rng(7 + start_side)
    B, L = 12, 600
    seq = "AATGTACTTCGTTCAGTTACGTATTGCT"
    bases = _bases(rng, (B, L))
    for i in range(B):
        p = int(rng.integers(0, L - len(seq)))
        bases[i, p:p + len(seq)] = np.frombuffer(seq.encode(), np.uint8)
    # anchors inside, at the edges of and outside the row
    anchor = rng.integers(-30, L + 30, B).astype(np.int32)
    anchor[:3] = (0, L - 16, -5)
    ncand = rng.integers(0, 185, B).astype(np.int32)
    jspec = jadapter.AdapterSpec(seq, 0.25)
    tspec = tadapter.AdapterSpec(seq, 0.25)
    ref = np.asarray(jadapter._seed_scan(
        jnp.asarray(bases), jnp.asarray(anchor), jnp.asarray(ncand), jspec,
        start_side))
    got = tadapter._seed_scan(torch.from_numpy(bases),
                              torch.from_numpy(anchor),
                              torch.from_numpy(ncand), tspec, start_side)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("start_side", [True, False])
@pytest.mark.parametrize("seq", ["A", "ACGTN", "AGCTTCAGTNRYacg",
                                 "AGCTTCAGTNRYacgtTTT"])
def test_seed_scan_seeds_match_jax(seq, start_side):
    """Seeds shorter than 16 bytes and seeds with N, IUPAC and lowercase
    bytes, over reads of the same bytes with zero padding, with anchors at
    and beyond both row ends."""
    rng = np.random.default_rng(len(seq) + 10 * start_side)
    B, L = 10, 300
    bases = rng.choice(np.frombuffer(b"ACGTNRYacgt\0", np.uint8), (B, L))
    for i in range(B):
        p = int(rng.integers(0, L - len(seq)))
        bases[i, p:p + len(seq)] = np.frombuffer(seq.encode(), np.uint8)
    plen = min(16, len(seq))
    anchor = rng.integers(-40, L + 40, B).astype(np.int32)
    anchor[:5] = (0, L - plen, -3, L - 1, L)
    ncand = rng.integers(0, 185, B).astype(np.int32)
    jspec = jadapter.AdapterSpec(seq, 0.25)
    tspec = tadapter.AdapterSpec(seq, 0.25)
    assert tspec.plen == plen
    ref = np.asarray(jadapter._seed_scan(
        jnp.asarray(bases), jnp.asarray(anchor), jnp.asarray(ncand), jspec,
        start_side))
    got = tadapter._seed_scan(torch.from_numpy(bases),
                              torch.from_numpy(anchor),
                              torch.from_numpy(ncand), tspec, start_side)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card gets an error,
    never the plain version."""
    meta = torch.empty((2, 64), dtype=torch.uint8, device="meta")
    ad = torch.empty(5, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        mismatch_scan(meta, ad)
    problem = (torch.empty((256, 1), dtype=torch.int32, device="meta"),
               torch.empty(2, dtype=torch.int32, device="meta"), meta,
               torch.empty(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        myers_verify(*problem)
    with pytest.raises(ValueError):
        myers_verify_pair(problem, problem)
