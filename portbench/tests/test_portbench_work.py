"""The frozen work functions at one shape per kernel, against counts made
by hand from chip_smoke.py's formulas."""

import pytest
import torch

from portbench import work

I32 = dict(dtype=torch.int32)


def test_mismatch_scan():
    # [1024, 8192] bases, a 28-base adapter, uint8 counts
    out = torch.empty((1024, 8192), dtype=torch.uint8)
    b, o, peak = work.launch_work(
        "fpl_mismatch_scan", [None, 1024, 8192, None, 28, out, 1])
    assert b == 1024 * 8192 * 2 + 28
    assert o == 2 * 1024 * 8192 * 28
    assert peak == work.INT8_OPS_PER_S
    assert work.bound(b, o, peak) == pytest.approx(
        max(b / 3.35e12, o / 1979e12))


def test_myers_verify_and_pair_and_blockscan():
    # 3 lanes of 40 columns, a 28-base pattern in one word (K = 1)
    text = torch.zeros((3, 40), dtype=torch.uint8)
    plen = torch.tensor([28, 28, 0], **I32)
    tlen = torch.tensor([40, 30, 40], **I32)
    pm = torch.zeros((256, 1), **I32)
    args = [text, 3, 40, plen, tlen, pm, 1, None]
    b, o, peak = work.launch_work("fpl_myers_verify", args)
    assert b == 3 * 40 + 12 * 3 + 256 * 4
    assert o == (40 + 30) * (20 * 1 + 5)
    assert peak == work.WORD32_OPS_PER_S
    assert work.launch_work("fpl_myers_blockscan", args)[:2] == (b, o)
    # 700 bases: 22 words; 700 columns
    text2 = torch.zeros((1, 700), dtype=torch.uint8)
    pm2 = torch.zeros((256, 22), **I32)
    args2 = [text2, 1, 700, torch.tensor([700], **I32),
             torch.tensor([700], **I32), pm2, 22, None]
    b2, o2, _ = work.launch_work("fpl_myers_verify", args2)
    assert (b2, o2) == (700 + 12 + 256 * 22 * 4, 700 * (20 * 22 + 5))
    assert work.launch_work("fpl_myers_verify_pair", args + args2)[:2] == (
        b + b2, o + o2)


def test_seed_scan():
    out = torch.empty((1024, 184), **I32)
    b, o, _ = work.launch_work(
        "fpl_seed_scan", [None, 1024, 8192, None, None, None, 16, 1, 184, out])
    assert b == 1024 * (184 + 16) + 8 * 1024 + 4 * 1024 * 184 + 1024
    assert o == 1024 * 184 * 16 * 20


def test_stat_batch_pre_filter_form():
    lo = torch.zeros((1, 4), **I32)
    hi = torch.tensor([[100, 5000, 0, 9000]], **I32)
    mask = torch.tensor([[True, True, True, False]])
    b, o, _ = work.launch_work(
        "fpl_stat_batch_into",
        [None, None, 1, 4, 8192, lo, hi, mask, 1, None, 8192, None])
    cycles = 100 + 5000
    assert (b, o) == (2 * cycles + 9 * 4 + 16 * (18 * 8192 + 1168) + 4,
                      10 * cycles)


def test_regions():
    lo = torch.tensor([[0, 10, 50]], **I32)
    hi = torch.tensor([[200, 60, 60]], **I32)
    # window 50: spans of 50 or more are tested (the first two)
    b, o, _ = work.launch_work(
        "fpl_regions", [None, 3, 256, lo, hi, 3, 50, 2150, None])
    pos = 201 + 51
    assert (b, o) == (4 * pos + 20 * 3, 8 * pos)


def test_kmer_hist():
    # two rows of 12 columns (3 window positions): row 0's first two of
    # its 3 windows are valid (the third holds its N); row 1's first of its
    # 2 is (the second holds an N): 3 windows, 3 distinct keys
    mat = torch.tensor([list(b"ACGTACGTACGT"), list(b"AAAAAAAAAANN")],
                       dtype=torch.uint8)
    mat[0, 11] = ord("N")
    npos = torch.tensor([3, 2], **I32)
    b, o, _ = work.launch_work(
        "fpl_kmer_hist", [mat, 2, 12, npos, None, 1, None])
    windows, distinct = 3, 3
    assert (b, o) == (24 + 12 * 2 + 32 * distinct, 20 * windows)


def test_every_entry_point_has_a_work_function():
    from fastplong_tpu_torch.ops import cuda_lib
    assert set(work.KERNELS) == set(cuda_lib._SIGNATURES)
