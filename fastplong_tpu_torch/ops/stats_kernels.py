"""Per-batch statistics reductions.

Port of fastplong_tpu/ops/stats_kernels.py (reference Stats::statRead,
src/stats.cpp:265-375): per-cycle Q20/Q30/content/quality accumulators
indexed by (base & 0x07), the base-quality histogram, rolling 5-mer counts
and the per-read median quality, reduced over a batch of spans [lo, hi).

stat_batch launches the hand-written CUDA kernel (csrc/stat_batch.cu: one
launch, shared-memory histograms, a per-read 256-bin count for the median,
per-cycle counters in registers) for CUDA tensors; stat_batch_plain is its
plain PyTorch version, which CPU tensors take: index_add_ scatters into one
spare bin that absorbs masked positions, and a row sort for the median, as
jnp.sort is in the JAX package.
"""

import torch

from . import cuda_lib
from .align import align_spans
from .primitives import arange

Q20_CHAR = ord("5")
Q30_CHAR = ord("?")


def _histogram(idx, valid, nbins):
    """int32 [nbins] counts of idx where valid (one spare bin for the
    rest)."""
    flat = torch.where(valid, idx, nbins).reshape(-1).to(torch.int64)
    h = torch.zeros(nbins + 1, dtype=torch.int32, device=idx.device)
    h.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return h[:nbins]


def stat_batch_plain(bases, quals, lo, hi, read_mask, zero_lo=False):
    """Plain PyTorch version of stat_batch."""
    B, L = bases.shape
    lo = lo.to(torch.int32)
    hi = torch.maximum(hi.to(torch.int32), lo)
    rlen = torch.where(read_mask, hi - lo, 0)

    if zero_lo:
        m = arange(L, bases)[None, :] < hi[:, None]
        b = torch.where(m, bases, 0)
        q = torch.where(m, quals, 0)
    else:
        b, q, m = align_spans(bases, quals, lo, hi)
    m = m & read_mask[:, None]
    qv = torch.where(m, q.to(torch.int32), 0)

    bucket = b & 0x07
    q20m = m & (q >= Q20_CHAR)
    q30m = m & (q >= Q30_CHAR)
    qm33 = torch.where(m, qv - 33, 0)

    i32 = torch.int32
    cyc_q20, cyc_q30, cyc_content, cyc_qual = [], [], [], []
    for c in range(8):
        is_c = m & (bucket == c)
        cyc_q20.append((is_c & q20m).sum(dim=0, dtype=i32))
        cyc_q30.append((is_c & q30m).sum(dim=0, dtype=i32))
        cyc_content.append(is_c.sum(dim=0, dtype=i32))
        cyc_qual.append(torch.where(is_c, qm33, 0).sum(dim=0, dtype=i32))
    cycle_q20 = torch.stack(cyc_q20)
    cycle_q30 = torch.stack(cyc_q30)
    cycle_content = torch.stack(cyc_content)
    cycle_qual = torch.stack(cyc_qual)
    cycle_total_base = m.sum(dim=0, dtype=i32)
    cycle_total_qual = qm33.sum(dim=0, dtype=i32)

    # base quality histogram over raw quality bytes (0..127)
    base_qual_hist = _histogram(
        torch.clamp(q.to(torch.int32), max=127), m, 128)

    # rolling 5-mer counts (reference stats.cpp:282-348): count at position
    # i (i >= 4) iff the last five bases all map to A/T/U/C/G
    code = torch.full((B, L), -1, dtype=i32, device=bases.device)
    for ch, v in ((ord("A"), 0), (ord("T"), 1), (ord("U"), 1),
                  (ord("C"), 2), (ord("G"), 3)):
        code = torch.where(b == ch, v, code)

    def shifted(k):
        # code at position i-k (invalid -1 outside)
        return torch.nn.functional.pad(code[:, :L - k], (k, 0), value=-1)

    c0, c1, c2, c3, c4 = (shifted(k) for k in (4, 3, 2, 1, 0))
    kvalid = (c0 >= 0) & (c1 >= 0) & (c2 >= 0) & (c3 >= 0) & (c4 >= 0) & m
    key = (c0 << 8) | (c1 << 6) | (c2 << 4) | (c3 << 2) | c4
    kmer = _histogram(key, kvalid, 1024)

    # per-read median quality: sorted[len >> 1] (reference stats.cpp:351-362)
    q_sorted = torch.sort(torch.where(m, q, 255), dim=-1).values
    half = torch.clamp(rlen >> 1, 0, L - 1).to(torch.int64)
    median = torch.gather(q_sorted, 1, half[:, None])[:, 0]
    median = torch.where(rlen > 0, median, 0)

    return {
        "cycle_q20": cycle_q20,                 # [8, L]
        "cycle_q30": cycle_q30,                 # [8, L]
        "cycle_content": cycle_content,         # [8, L]
        "cycle_qual": cycle_qual,               # [8, L]
        "cycle_total_base": cycle_total_base,   # [L]
        "cycle_total_qual": cycle_total_qual,   # [L]
        "base_qual_hist": base_qual_hist,       # [128]
        "kmer": kmer,                           # [1024]
        "median": median,                       # [B] raw phred33 byte
        "rlen": rlen,                           # [B]
        "read_mask": read_mask,                 # [B]
    }


# the kernel's int32 partial: these four [8, L] blocks, then the total
# bases and quality [L], the quality histogram [128] and the 5-mer counts
# [1024] (csrc/stat_batch.cu)
_CYCLE_FIELDS = ("cycle_q20", "cycle_q30", "cycle_content", "cycle_qual")


def stat_batch(bases, quals, lo, hi, read_mask, zero_lo=False):
    """Returns a dict of per-batch partial statistics.

    read_mask [B] bool excludes padding rows / filtered-out reads.
    zero_lo=True (pre-stats on untrimmed reads) skips span alignment.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if bases.device.type == "cpu":
        return stat_batch_plain(bases, quals, lo, hi, read_mask, zero_lo)
    B, L = bases.shape
    if (bases.dtype != torch.uint8 or quals.dtype != torch.uint8
            or L == 0 or quals.shape != (B, L)
            or read_mask.dtype != torch.bool
            or lo.shape != (B,) or hi.shape != (B,)
            or read_mask.shape != (B,)):
        raise ValueError("stat_batch: unsupported inputs")
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    read_mask = read_mask.contiguous()
    cuda_lib.require_cuda("stat_batch", bases, quals, lo, hi, read_mask)
    dev = bases.device
    flat = torch.zeros(34 * L + 128 + 1024, dtype=torch.int32, device=dev)
    median = torch.empty(B, dtype=torch.uint8, device=dev)
    rlen = torch.empty(B, dtype=torch.int32, device=dev)
    if B > 0:
        rc = cuda_lib.lib().fpl_stat_batch(
            cuda_lib.ptr(bases), cuda_lib.ptr(quals), B, L, cuda_lib.ptr(lo),
            cuda_lib.ptr(hi), cuda_lib.ptr(read_mask), int(bool(zero_lo)),
            cuda_lib.ptr(flat), cuda_lib.ptr(median), cuda_lib.ptr(rlen),
            cuda_lib.stream(bases))
        cuda_lib.check(rc, "stat_batch")
        stat_batch.launches += 1
    out = {k: flat[i * 8 * L:(i + 1) * 8 * L].view(8, L)
           for i, k in enumerate(_CYCLE_FIELDS)}
    o = 32 * L
    out["cycle_total_base"] = flat[o:o + L]
    out["cycle_total_qual"] = flat[o + L:o + 2 * L]
    out["base_qual_hist"] = flat[o + 2 * L:o + 2 * L + 128]
    out["kmer"] = flat[o + 2 * L + 128:]
    out["median"] = median
    out["rlen"] = rlen
    out["read_mask"] = read_mask
    return out


stat_batch.launches = 0
