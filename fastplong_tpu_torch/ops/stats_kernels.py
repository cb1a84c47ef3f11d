"""Per-batch statistics reductions.

Port of fastplong_tpu/ops/stats_kernels.py (reference Stats::statRead,
src/stats.cpp:265-375): per-cycle Q20/Q30/content/quality accumulators
indexed by (base & 0x07), the base-quality histogram, rolling 5-mer counts
and the per-read median quality, reduced over a batch of spans [lo, hi).

stat_batch (= stat_batch_plain) returns one batch's partial sums as a dict,
in plain PyTorch on any device; the JAX-parity tests and the host layer use
it.  The step uses stat_batch_into: the partials of every slot of an
[S, B] span stack added straight into one side of the run's int64
accumulator (the flat layout below), returning the per-read medians.  For
CUDA tensors it launches the hand-written kernel csrc/stat_batch.cu (one
launch per side: row blocks count each read's qualities and 5-mers from
16-byte loads, column blocks sum the per-cycle counters, both add into the
accumulator with integer atomics); CPU tensors take stat_batch_into_plain,
stat_batch_plain plus add_partial for each slot.
"""

import torch

from . import cuda_lib
from .align import align_spans
from .primitives import arange

# One side of the run's statistics accumulator, a flat int64 vector at the
# cycle length SL:
#   [0, 18*SL)    cycle block [SL, 18] = per cycle:
#                   [0:8]  content per base bucket
#                   [8:16] quality sum per base bucket
#                   [16]   total bases   [17] total quality
#   [18*SL, +8)   q20 totals per base bucket
#   [+8, +16)     q30 totals per base bucket
#   [+16, +144)   base quality histogram [128]
#   [+144, +1168) kmer [1024]
# (the layout of fastplong_tpu's [2, F] state).
FLAT_PER_L = 18
FLAT_EXTRA = 8 + 8 + 128 + 1024


def flat_side_len(L):
    return FLAT_PER_L * L + FLAT_EXTRA


def side_stat_len(side):
    """The cycle length SL of a flat side vector."""
    return (side.shape[-1] - FLAT_EXTRA) // FLAT_PER_L

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


stat_batch = stat_batch_plain


def add_partial(side, partial, SL):
    """Add one stat_batch partial into a flat side vector, in place."""
    L = partial["cycle_total_base"].shape[0]
    cyc = side[:FLAT_PER_L * L].view(L, FLAT_PER_L)
    cyc[:, 0:8] += partial["cycle_content"].T
    cyc[:, 8:16] += partial["cycle_qual"].T
    cyc[:, 16] += partial["cycle_total_base"]
    cyc[:, 17] += partial["cycle_total_qual"]
    o = FLAT_PER_L * SL
    side[o:o + 8] += partial["cycle_q20"].sum(dim=1)
    side[o + 8:o + 16] += partial["cycle_q30"].sum(dim=1)
    side[o + 16:o + 144] += partial["base_qual_hist"]
    side[o + 144:o + 1168] += partial["kmer"]


def _check_into(side, bases, quals, lo, hi, read_mask):
    """Raise on inputs that stat_batch_into does not take; returns SL."""
    if bases.dim() != 2:
        raise ValueError("stat_batch_into: bases must be [B, L]")
    B, L = bases.shape
    SL = side_stat_len(side)
    if (bases.dtype != torch.uint8 or quals.dtype != torch.uint8
            or quals.shape != (B, L) or side.dtype != torch.int64
            or side.dim() != 1 or side.shape[0] != flat_side_len(SL)
            or L == 0 or L > SL or lo.dim() != 2 or lo.shape[1] != B
            or hi.shape != lo.shape or read_mask.shape != lo.shape
            or read_mask.dtype != torch.bool):
        raise ValueError("stat_batch_into: unsupported inputs")
    return SL


def stat_batch_into_plain(side, bases, quals, lo, hi, read_mask,
                          zero_lo=False):
    """Plain PyTorch version of stat_batch_into."""
    SL = _check_into(side, bases, quals, lo, hi, read_mask)
    medians = []
    for k in range(lo.shape[0]):
        part = stat_batch_plain(bases, quals, lo[k], hi[k], read_mask[k],
                                zero_lo)
        add_partial(side, part, SL)
        medians.append(part["median"])
    if not medians:
        return torch.empty((0, bases.shape[0]), dtype=torch.uint8,
                           device=bases.device)
    return torch.stack(medians)


def stat_batch_into(side, bases, quals, lo, hi, read_mask, zero_lo=False):
    """Add the statistics of every slot's spans into `side`, in place, and
    return the per-read medians [S, B] uint8.

    side: one [F] int64 row of the run's [2, F] accumulator at cycle length
    SL (the flat layout above), with the batch's L <= SL; cycles L..SL-1
    are left as they are.  bases, quals: [B, L] uint8.  lo, hi, read_mask:
    [S, B] (S slots of the same reads); slot row i reads row i mod B of
    bases and quals.  zero_lo=True (pre-stats on untrimmed reads) takes
    each span from cycle 0.  The sum added is that of stat_batch over each
    slot, bit for bit (every add is an integer add).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if bases.device.type == "cpu":
        return stat_batch_into_plain(side, bases, quals, lo, hi, read_mask,
                                     zero_lo)
    _check_into(side, bases, quals, lo, hi, read_mask)
    S, B = lo.shape
    L = bases.shape[1]
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    read_mask = read_mask.contiguous()
    cuda_lib.require_cuda("stat_batch_into", side, bases, quals, lo, hi,
                          read_mask)
    median = torch.empty((S, B), dtype=torch.uint8, device=bases.device)
    if S * B > 0:
        cuda_lib.launch(
            "fpl_stat_batch_into", bases, cuda_lib.ptr(bases),
            cuda_lib.ptr(quals), S, B, L, cuda_lib.ptr(lo), cuda_lib.ptr(hi),
            cuda_lib.ptr(read_mask), int(bool(zero_lo)), cuda_lib.ptr(side),
            side_stat_len(side), cuda_lib.ptr(median))
        stat_batch_into.launches += 1
    return median


stat_batch_into.launches = 0
