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


def _problem(rng, plen_max, N, T):
    pat = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), plen_max)
                .tolist())
    text = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (N, T))
    for n in range(0, N, 4):       # some texts close to the pattern
        m = min(T, plen_max)
        keep = rng.random(m) < 0.9
        text[n, :m] = np.where(keep, np.frombuffer(pat[:m], np.uint8),
                               text[n, :m])
    plen = rng.integers(-1, plen_max + 1, N).astype(np.int32)
    tlen = rng.integers(0, T + 1, N).astype(np.int32)
    plen[:4] = (0, plen_max, plen_max, 1)
    tlen[:4] = (T, 0, T, T)
    return pat, text, plen, tlen


@pytest.mark.parametrize("plen_max,T", [(641, 160), (700, 120), (2000, 64)])
def test_blockscan_matches_jax(plen_max, T):
    rng = np.random.default_rng(plen_max)
    pat, text, plen, tlen = _problem(rng, plen_max, 24, T)
    want = np.asarray(myers_distance_blockscan(
        build_pattern_table(pat), jnp.asarray(plen), jnp.asarray(text),
        jnp.asarray(tlen)))
    pm = pattern_table(pat)
    assert pm.shape[1] == (plen_max + 31) // 32 > MAX_K
    got = myers_blockscan(pm, torch.from_numpy(plen), torch.from_numpy(text),
                          torch.from_numpy(tlen))
    np.testing.assert_array_equal(got.numpy(), want)


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
