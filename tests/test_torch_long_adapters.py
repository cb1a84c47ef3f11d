"""Adapters longer than 640 bp in the port, against the JAX package on the
CPU.

myers_blockscan's plain version (what CPU tensors take) must equal
fastplong_tpu/ops/myers.py:myers_distance_blockscan exactly, and the
port's CLI with a 700-bp start adapter planted in read middles (whose
middle-adapter search verifies through the block-scan) must equal the JAX
CLI byte for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastplong_tpu.ops.myers import (build_pattern_table,
                                     myers_distance_blockscan)
from fastplong_tpu_torch.ops.myers import (MAX_K, myers_blockscan,
                                           pattern_table)

from test_torch_cli import _assert_same
from test_torch_cuda import _table_pattern, levenshtein


def _problem(rng, plen_max, N, T, pat_bytes=b"ACGT", text_bytes=b"ACGTN"):
    pat = bytes(rng.choice(np.frombuffer(pat_bytes, np.uint8), plen_max)
                .tolist())
    text = rng.choice(np.frombuffer(text_bytes, np.uint8), (N, T))
    for n in range(0, N, 4):       # some texts close to the pattern
        m = min(T, plen_max)
        keep = rng.random(m) < 0.9
        text[n, :m] = np.where(keep, np.frombuffer(pat[:m], np.uint8),
                               text[n, :m])
    plen = rng.integers(-1, plen_max + 1, N).astype(np.int32)
    tlen = rng.integers(0, T + 1, N).astype(np.int32)
    plen[:4] = (0, plen_max, plen_max, 1)
    tlen[:4] = (T, 0, T, T)
    # the edges of a word and of a slab of 32 words (the kernel's warp)
    edges = [e for e in (32, 33, 1024, 1025, 2048, 2049, plen_max - 1)
             if e < plen_max]
    plen[4:4 + len(edges)] = edges
    return pat, text, plen, tlen


# seven distinct pattern bytes, two of them >= 128, and twenty; texts with
# bytes absent from the pattern
ODD7 = b"ACGTN\x80\xfe"
ODD20 = bytes(range(60, 78)) + b"\x81\xff"
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


@pytest.mark.parametrize("plen_max,T,pat_bytes,text_bytes", [
    (641, 160, b"ACGT", b"ACGTN"), (700, 120, b"ACGT", b"ACGTN"),
    (2000, 64, b"ACGT", b"ACGTN"),
    # the slab edges of 32 and 64 words, where the kernel's warps meet
    (1024, 40, b"ACGT", b"ACGTN"), (1025, 40, b"ACGT", b"ACGTN"),
    (2048, 24, b"ACGT", b"ACGTN"), (2049, 24, b"ACGT", b"ACGTN"),
    # T not a multiple of 8 or 16 and past a warp's text ring of 1,024
    (1025, 1037, b"ACGT", b"ACGTN"),
    # past the cap of 32 warps a lane (rounds of slabs), and a table of
    # 6,000 words
    (33800, 12, b"ACGT", b"ACGTN"), (191990, 9, b"ACGT", b"ACGTN"),
    # pattern bytes outside ACGT and >= 128; bytes absent from it
    (700, 77, ODD7, TEXT_ABSENT),
    (700, 77, ODD20, TEXT_ABSENT + bytes(range(60, 78))),
    (700, 77, b"ACGT", TEXT_ABSENT), (1270, 45, ZERO, TEXT_ABSENT)],
    ids=_byte_ids)
def test_blockscan_matches_jax(plen_max, T, pat_bytes, text_bytes):
    rng = np.random.default_rng([plen_max, T, len(pat_bytes),
                                 len(text_bytes)])
    pat, text, plen, tlen = _problem(rng, plen_max, 24, T, pat_bytes,
                                     text_bytes)
    want = np.asarray(myers_distance_blockscan(
        build_pattern_table(pat), jnp.asarray(plen), jnp.asarray(text),
        jnp.asarray(tlen)))
    pm = pattern_table(pat)
    assert pm.shape[1] == (plen_max + 31) // 32 > MAX_K
    got = myers_blockscan(pm, torch.from_numpy(plen), torch.from_numpy(text),
                          torch.from_numpy(tlen))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("plen_max,T,pat_bytes,text_bytes", [
    (1025, 40, b"ACGT", b"ACGTN"), (2049, 24, b"ACGT", b"ACGTN"),
    (33800, 12, b"ACGT", b"ACGTN"), (700, 77, ODD7, TEXT_ABSENT),
    (1270, 45, ZERO, TEXT_ABSENT)], ids=_byte_ids)
def test_blockscan_plain_matches_dynamic_program(plen_max, T, pat_bytes,
                                                 text_bytes):
    """The oracle of the card's test of rounds of slabs (the dynamic
    program, tests/test_torch_cuda.py:levenshtein, and the pattern read
    back from its table) against the plain version, at the slab edges,
    past the 32-warp cap and with bytes outside ACGT and absent."""
    rng = np.random.default_rng([plen_max, T, len(pat_bytes), 7])
    pat, text, plen, tlen = _problem(rng, plen_max, 24, T, pat_bytes,
                                     text_bytes)
    tlen[-3:] = (-1, T + 5, T - 1)
    pm = pattern_table(pat)
    assert _table_pattern(pm, plen_max) == pat
    got = myers_blockscan(pm, torch.from_numpy(plen), torch.from_numpy(text),
                          torch.from_numpy(tlen))
    np.testing.assert_array_equal(got.numpy(),
                                  levenshtein(pat, plen, text, tlen))


def _reads_with_long_adapter(path, adapter, n=30, seed=61):
    """Reads of at most 980 bases (few batches at the tests' budget), most
    with the adapter planted in the middle (some with a few
    substitutions), some with it at the start, some without it."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            left = "".join(rng.choice(list("ACGT"), int(rng.integers(20, 150))))
            right = "".join(rng.choice(list("ACGT"),
                                       int(rng.integers(20, 130))))
            ad = list(adapter)
            for p in rng.integers(0, len(ad), int(rng.integers(0, 40))):
                ad[p] = "ACGT"[int(rng.integers(0, 4))]
            ad = "".join(ad)
            if i % 5 == 4:
                seq = left + right
            elif i % 5 == 3:
                seq = ad + right
            else:
                seq = left + ad + right
            q = "".join(chr(int(x)) for x in rng.integers(33 + 8, 33 + 41,
                                                          len(seq)))
            f.write("@long%d\n%s\n+\n%s\n" % (i, seq, q))
    return path


@pytest.mark.parametrize("end", [None, "AGCAATACGTAACTGAACGAAGT"],
                         ids=["end_reverse_complement", "end_23bp"])
def test_cli_700bp_start_adapter_matches_jax(end, tmp_path, monkeypatch):
    """-s alone (its reverse complement, also 700 bp, is the end adapter:
    both middle verifies take the block-scan) and with a 23-bp -e (the
    start side's verify takes the block-scan, the end side's the verify
    kernel alone)."""
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(62)
    adapter = "".join(rng.choice(list("ACGT"), 700))
    in_fq = _reads_with_long_adapter(str(tmp_path / "in.fq"), adapter)
    _assert_same(in_fq, str(tmp_path),
                 ["-s", adapter] + (["-e", end] if end else []))
    with open(str(tmp_path / "t_out.fq"), "rb") as f:
        names = [ln for i, ln in enumerate(f) if i % 4 == 0]
    # the middle search split reads around the adapter
    assert len(names) > 30, len(names)
