"""Batched Myers bit-parallel Levenshtein distance (kernel 2,
csrc/myers_verify.cu, and kernel 7, csrc/myers_blockscan.cu).

Port of fastplong_tpu/ops/myers.py:myers_distance_unrolled (reference
src/editdistance.cpp:31-126, the Hyyro/Myers VP/VN/HP/HN recurrence).  The
pattern is a [256, K] table of 32-bit masks (stored as int32 bit patterns);
every lane carries its own pattern length and text length, and a lane with
plen <= 0 returns tlen.  A shorter per-lane pattern is handled by starting
VP with its low plen bits and reading the score bit plen-1: higher mask
bits only carry upward and cannot reach the tracked bit.

myers_verify_pair serves two independent problems (each with its own
table, K, T and N) in one kernel launch; the adapter trims and the
middle-adapter search pair their verifies through it.  myers_blockscan
(port of myers_distance_blockscan) takes a table of any K, for the
middle-adapter search of adapters longer than MAX_DEVICE_PATTERN.  Both
share one plain version, the column loop with the word chain inside,
which takes any K.

The plain version computes in int64 masked to 32 bits: torch's uint32 has
no add, shifts or comparisons on the CPU.
"""

import numpy as np
import torch

from . import cuda_lib

BLOCK = 32
# the reference's Myers/DP boundary (editdistance.cpp:88-124); longer
# patterns take the block-scan form (myers_blockscan)
MAX_DEVICE_PATTERN = 640
MAX_K = MAX_DEVICE_PATTERN // BLOCK
M32 = 0xFFFFFFFF


def pattern_table(pattern: bytes, device="cpu"):
    """[256, K] int32 table: bit i of word r set iff pattern[32r+i] == byte
    (bytes absent from the pattern map to 0, like the JAX select chains)."""
    K = max(1, (len(pattern) + BLOCK - 1) // BLOCK)
    tbl = np.zeros((256, K), np.uint32)
    for i, ch in enumerate(pattern):
        tbl[ch, i // BLOCK] |= np.uint32(1 << (i % BLOCK))
    return torch.from_numpy(tbl.view(np.int32)).to(device)


def myers_verify_plain(pm_tbl, plen, text, tlen):
    """Plain PyTorch version: the recurrence column by column, word by
    word, exactly as myers_distance_unrolled's scan body."""
    N, T = text.shape
    K = pm_tbl.shape[1]
    dev = text.device
    tbl = pm_tbl.to(torch.int64) & M32
    plen = torch.clamp(plen.to(torch.int64), min=0)
    tlen = tlen.to(torch.int64)
    r_idx = torch.arange(K, device=dev)
    bits = torch.clamp(plen[:, None] - r_idx * BLOCK, 0, BLOCK)
    VP = [x for x in torch.where(bits >= BLOCK, M32,
                                 (1 << torch.clamp(bits, max=BLOCK - 1)) - 1
                                 ).unbind(1)]
    VN = [torch.zeros_like(plen) for _ in range(K)]
    top_block = torch.clamp(
        torch.where(plen > 0, (plen - 1) // BLOCK, 0), 0, K - 1)
    top_bit = torch.where(plen > 0, (plen - 1) % BLOCK, 0)
    D = plen.clone()
    for j in range(T):
        active = j < tlen
        pm = tbl[text[:, j].to(torch.int64)]              # [N, K]
        hn_carry = torch.zeros_like(plen)
        hp_carry = torch.ones_like(plen)
        HPs, HNs = [], []
        for r in range(K):
            X = pm[:, r] | hn_carry
            vp, vn = VP[r], VN[r]
            D0 = ((((X & vp) + vp) & M32) ^ vp) | X | vn
            HP = vn | (~(D0 | vp) & M32)
            HN = D0 & vp
            X2 = ((HP << 1) & M32) | hp_carry
            vp_new = ((HN << 1) & M32) | (~(D0 | X2) & M32) | hn_carry
            VP[r] = torch.where(active, vp_new, vp)
            VN[r] = torch.where(active, D0 & X2, vn)
            HPs.append(HP)
            HNs.append(HN)
            hn_carry = (HN >> 31) & 1
            hp_carry = (HP >> 31) & 1
        hp_top = torch.gather(torch.stack(HPs, 1), 1, top_block[:, None])[:, 0]
        hn_top = torch.gather(torch.stack(HNs, 1), 1, top_block[:, None])[:, 0]
        inc = torch.where((hp_top >> top_bit) & 1 != 0, 1,
                          torch.where((hn_top >> top_bit) & 1 != 0, -1, 0))
        D = torch.where(active & (plen > 0), D + inc, D)
    return torch.where(plen > 0, D, tlen).to(torch.int32)


def _kernel_args(pm_tbl, plen, text, tlen):
    """One problem's output tensor, its kernel arguments and the tensors
    that must stay alive until the launch has been enqueued."""
    N, T = text.shape
    K = pm_tbl.shape[1]
    if (text.dtype != torch.uint8 or pm_tbl.dtype != torch.int32
            or pm_tbl.shape[0] != 256 or not 1 <= K <= MAX_K):
        raise ValueError("myers_verify: unsupported table %s %s or text %s"
                         % (tuple(pm_tbl.shape), pm_tbl.dtype, text.dtype))
    plen = plen.to(torch.int32).contiguous()
    tlen = tlen.to(torch.int32).contiguous()
    cuda_lib.require_cuda("myers_verify", text, plen, tlen, pm_tbl)
    out = torch.empty(N, dtype=torch.int32, device=text.device)
    args = [cuda_lib.ptr(text), N, T, cuda_lib.ptr(plen), cuda_lib.ptr(tlen),
            cuda_lib.ptr(pm_tbl), K, cuda_lib.ptr(out)]
    return out, args, (plen, tlen)


def myers_verify(pm_tbl, plen, text, tlen):
    """Edit distance of text[n, :tlen[n]] against the pattern's first
    plen[n] bytes, for each lane n.  pm_tbl: [256, K] int32 from
    pattern_table; plen/tlen: [N] ints; text: [N, T] uint8.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if text.device.type == "cpu":
        return myers_verify_plain(pm_tbl, plen, text, tlen)
    out, args, _keep = _kernel_args(pm_tbl, plen, text, tlen)
    if text.shape[0] == 0:
        return out
    cuda_lib.launch("fpl_myers_verify", text, *args)
    myers_verify.launches += 1
    return out


def myers_verify_pair(first, second):
    """myers_verify of two independent problems, each a tuple
    (pm_tbl, plen, text, tlen) with its own K, T and N, in one kernel
    launch (counted once in myers_verify.launches).  Returns the two
    [N] distance vectors.  CPU tensors take the plain version twice."""
    if first[2].device.type == "cpu" and second[2].device.type == "cpu":
        return myers_verify_plain(*first), myers_verify_plain(*second)
    out0, args0, _keep0 = _kernel_args(*first)
    out1, args1, _keep1 = _kernel_args(*second)
    cuda_lib.require_cuda("myers_verify_pair", first[2], second[2])
    if out0.shape[0] + out1.shape[0] == 0:
        return out0, out1
    cuda_lib.launch("fpl_myers_verify_pair", first[2], *args0, *args1)
    myers_verify.launches += 1
    return out0, out1


myers_verify.launches = 0


def myers_blockscan(pm_tbl, plen, text, tlen):
    """myers_verify for a [256, K] table of any K (the middle-adapter
    search of adapters longer than MAX_DEVICE_PATTERN).  CPU tensors take
    the plain version; CUDA tensors launch the block-scan kernel, whose
    warps each hold 32 words of a lane and pass their carries on through
    shared memory (csrc/myers_blockscan.cu), so the launch needs no
    scratch."""
    if text.device.type == "cpu":
        return myers_verify_plain(pm_tbl, plen, text, tlen)
    N, T = text.shape
    K = pm_tbl.shape[1]
    if (text.dtype != torch.uint8 or pm_tbl.dtype != torch.int32
            or pm_tbl.shape[0] != 256 or K < 1):
        raise ValueError("myers_blockscan: unsupported table %s %s or text "
                         "%s" % (tuple(pm_tbl.shape), pm_tbl.dtype,
                                 text.dtype))
    plen = plen.to(torch.int32).contiguous()
    tlen = tlen.to(torch.int32).contiguous()
    cuda_lib.require_cuda("myers_blockscan", text, plen, tlen, pm_tbl)
    out = torch.empty(N, dtype=torch.int32, device=text.device)
    if N == 0:
        return out
    cuda_lib.launch(
        "fpl_myers_blockscan", text, cuda_lib.ptr(text), N, T,
        cuda_lib.ptr(plen), cuda_lib.ptr(tlen), cuda_lib.ptr(pm_tbl), K,
        cuda_lib.ptr(out))
    myers_blockscan.launches += 1
    return out


myers_blockscan.launches = 0
