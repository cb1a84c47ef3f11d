"""The 10-mer histogram of adapter auto-detection (kernel 6,
csrc/kmer_hist.cu).

Port of fastplong_tpu/ops/kmer.py (reference src/evaluator.cpp:167-255):
rolling 2-bit keys (A = 0, T/U = 1, C = 2, G = 3, any other byte invalid)
over the sampled end windows of each read, each valid window adding 1 to
one of 4^10 counters and its position to a per-key position accumulator.
A window at column c of row i is valid when its 10 bytes are all ACGTU
and c < npos[i]; its position is pbase[i] + sign * c.

kmer_hist adds one side's windows into a [2, KEYSPACE] int64 accumulator
(row 0 the counts, row 1 the position sums, read as uint64): the CUDA
kernel for CUDA tensors, kmer_hist_plain (the rolling key in PyTorch plus
index_add_) for CPU tensors.  The counters are 64-bit on both, so no
position range needs another route (the JAX package's uint32 device
counters send large ones to its host path).  kmer_histogram is the
evaluator's entry point: the same (counts, posacc, total) as
kmer_histogram_device, on numpy arrays.
"""

import numpy as np
import torch

from ..spans import standalone
from . import cuda_lib

KEYLEN = 10
KEYSPACE = 1 << (KEYLEN * 2)

_CODE = np.full(256, -1, np.int64)
for _c, _v in (("A", 0), ("T", 1), ("U", 1), ("C", 2), ("G", 3)):
    _CODE[ord(_c)] = _v
_CODE_T = torch.from_numpy(_CODE)


def window_keys(mat, npos, pbase, sign):
    """(keys, positions) of the valid windows, int64, row by row: the
    rolling 2-bit key of each window and its position."""
    n, wfull = mat.shape
    W = max(wfull - KEYLEN, 0)
    codes = _CODE_T.to(mat.device)[mat.to(torch.int64)]
    keys = torch.zeros((n, W), dtype=torch.int64, device=mat.device)
    valid = torch.ones((n, W), dtype=torch.bool, device=mat.device)
    for k in range(KEYLEN):
        c = codes[:, k:k + W]
        keys = (keys << 2) | torch.clamp(c, min=0)
        valid &= c >= 0
    col = torch.arange(W, dtype=torch.int64, device=mat.device)[None, :]
    valid &= col < npos.to(torch.int64)[:, None]
    pv = pbase.to(torch.int64)[:, None] + sign * col
    return keys[valid], pv[valid]


def kmer_hist_plain(acc, mat, npos, pbase, sign):
    """Plain PyTorch version of kmer_hist (CPU tensors)."""
    kk, pv = window_keys(mat, npos, pbase, sign)
    acc[0].index_add_(0, kk, torch.ones_like(kk))
    acc[1].index_add_(0, kk, pv)
    return acc


def kmer_hist(acc, mat, npos, pbase, sign):
    """Add the valid windows of mat [n, W + KEYLEN] uint8 (npos [n] window
    positions per row, pbase [n] int64 position of column 0, sign +1 on
    the start side and -1 on the end side) into acc [2, KEYSPACE] int64,
    in place.  CPU tensors take the plain version; CUDA tensors launch the
    kernel, one launch a call."""
    if mat.device.type == "cpu":
        return kmer_hist_plain(acc, mat, npos, pbase, sign)
    n, wfull = mat.shape
    if (mat.dtype != torch.uint8 or acc.dtype != torch.int64
            or tuple(acc.shape) != (2, KEYSPACE) or sign not in (1, -1)):
        raise ValueError("kmer_hist: unsupported inputs")
    npos = npos.to(torch.int32).contiguous()
    pbase = pbase.to(torch.int64).contiguous()
    cuda_lib.require_cuda("kmer_hist", mat, npos, pbase, acc)
    if n == 0 or wfull <= KEYLEN:
        return acc
    cuda_lib.launch(
        "fpl_kmer_hist", mat, cuda_lib.ptr(mat), n, wfull,
        cuda_lib.ptr(npos), cuda_lib.ptr(pbase), sign, cuda_lib.ptr(acc))
    kmer_hist.launches += 1
    return acc


kmer_hist.launches = 0


def kmer_histogram(mat, npos, base_pos, lens, end_side, device, spans=None):
    """(counts int64 [KEYSPACE], posacc uint64 [KEYSPACE], total valid
    windows) of one side, as fastplong_tpu/ops/kmer.py:kmer_histogram_device
    returns them, computed on `device` (numpy inputs: mat [n, W + KEYLEN]
    uint8, npos, base_pos and lens [n]).  The start side's position is
    base_pos + col, the end side's len - base_pos - col.  spans, the
    evaluator's layer (spans.py), times the fill with its wait
    ("kmer_fill") and the copy of the accumulator to the host
    ("kmer_copy")."""
    device = torch.device(device)
    spans = spans or standalone()
    if int(np.sum(npos)) == 0:
        return (np.zeros(KEYSPACE, np.int64), np.zeros(KEYSPACE, np.uint64),
                0)
    if end_side:
        pbase = np.asarray(lens, np.int64) - base_pos
        sign = -1
    else:
        pbase = np.asarray(base_pos, np.int64)
        sign = 1
    with spans("kmer_fill"):
        acc = torch.zeros((2, KEYSPACE), dtype=torch.int64, device=device)
        kmer_hist(acc,
                  torch.from_numpy(np.ascontiguousarray(mat)).to(device),
                  torch.from_numpy(np.asarray(npos, np.int32)).to(device),
                  torch.from_numpy(pbase).to(device), sign)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
    with spans("kmer_copy"):
        host = acc.cpu().numpy()
    counts = host[0]
    return counts, host[1].view(np.uint64), int(counts.sum())
