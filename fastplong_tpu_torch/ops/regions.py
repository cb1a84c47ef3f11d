"""Low-quality region detection (drives --break and --mask).

Port of fastplong_tpu/ops/regions.py (reference
Filter::detectLowQualityRegions, src/filter.cpp:83-128, with its
quasi-rolling totalQual quirks).  With S(p) = sum(qual[p : p+w]) and
T = (33 + quality) * w, pass k of a span tests S(x) - base_k against T,
where base_1 = qual[w-1] and base_k = S(start_k) on later passes:

  * ws_k is the first s >= start_k with s + w < l and S(s) - base_k < T;
  * e_k is the first e >= ws_k with e + w < l and S(e+1) - base_k >= T,
    else l - w;
  * region k is (ws_k, e_k + w - 1) and start_{k+1} = e_k + w.

Consecutive regions are adjacent, so a span's regions are summarised as
(ws1, last_end, count): the head fragment ends before ws1, the tail starts
after last_end, and count feeds the tail's "rN-" name tag.

detect_regions_summary launches the hand-written CUDA kernel
(csrc/regions.cu: one block of eight warps per span, each search step
1,024 positions tested by warp ballots and the block's first hit taken
through shared memory; spans with no room for a window leave at once) for
CUDA tensors; detect_regions_summary_plain is its plain PyTorch version,
which CPU tensors take: the JAX package's loop, one pass per region, with
the host checking `done.all()` between passes.
"""

import torch

from . import cuda_lib
from .primitives import arange, first_true, qual_cumsum

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _no_regions(shape, device):
    neg = torch.full(shape, -1, dtype=torch.int32, device=device)
    return neg, neg.clone(), torch.zeros(shape, dtype=torch.int32,
                                         device=device)


def _summary_rows(cq, lo, hi, w, T):
    """The JAX loop for spans [lo, hi) of shape [B]."""
    B = lo.shape[0]
    L = cq.shape[1] - 1
    if w <= 0 or L == 0:
        return _no_regions((B,), cq.device)
    l = hi - lo
    idx = arange(L, cq)[None, :]
    a = torch.clamp(lo[:, None] + idx, 0, L).to(torch.int64)
    b = torch.clamp(lo[:, None] + idx + w, 0, L).to(torch.int64)
    S_all = torch.gather(cq, 1, b) - torch.gather(cq, 1, a)       # [B, L]
    Snext = torch.nn.functional.pad(S_all[:, 1:], (0, 1))
    qw1 = (torch.gather(cq, 1, torch.clamp(lo + w, 0, L)[:, None].long())
           - torch.gather(cq, 1, torch.clamp(lo + w - 1, 0, L)[:, None]
                          .long()))[:, 0]

    start = torch.zeros(B, dtype=torch.int32, device=cq.device)
    done = torch.zeros(B, dtype=torch.bool, device=cq.device)
    first = torch.ones(B, dtype=torch.bool, device=cq.device)
    ws1, last_end, count = _no_regions((B,), cq.device)
    in_span = idx + w < l[:, None]
    while not bool(done.all()):
        S_start = torch.gather(
            S_all, 1, torch.clamp(start, 0, L - 1)[:, None].long())[:, 0]
        base = torch.where(first, qw1, S_start)
        active = ~done & (start + w <= l)
        ws = first_true((idx >= start[:, None]) & in_span
                        & (S_all - base[:, None] < T), -1)
        has_ws = active & (ws >= 0)
        e = first_true((idx >= ws[:, None]) & in_span
                       & (Snext - base[:, None] >= T), l - w)
        ws1 = torch.where(has_ws & first, ws, ws1)
        last_end = torch.where(has_ws, e + w - 1, last_end)
        count = count + has_ws.to(torch.int32)
        start = torch.where(has_ws, e + w, start)
        first = first & ~has_ws
        done = done | ~has_ws
    return ws1, last_end, count


def detect_regions_summary_plain(cq, lo, hi, w, T):
    """Plain PyTorch version of detect_regions_summary."""
    w, T = int(w), int(T)
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    if lo.dim() == 1:
        return _summary_rows(cq, lo, hi, w, T)
    rows = [_summary_rows(cq, lo[k], hi[k], w, T) for k in range(lo.shape[0])]
    if not rows:
        return _no_regions(tuple(lo.shape), cq.device)
    return tuple(torch.stack(r) for r in zip(*rows))


def detect_regions_summary(cq, lo, hi, w, T):
    """Region summary (ws1, last_end, count) of each span [lo, hi).

    cq: [B, L+1] int32 exclusive quality cumsum (primitives.qual_cumsum).
    lo, hi: [B], or [S, B] for S slots of the same reads at once (one
    launch).  Returns three int32 tensors of lo's shape, span-relative:
    ws1 = last_end = -1 and count = 0 where the span has no region (an
    inactive slot arrives as hi = lo; w <= 0 gives no regions).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if cq.device.type == "cpu":
        return detect_regions_summary_plain(cq, lo, hi, w, T)
    w, T = int(w), int(T)
    if (cq.dtype != torch.int32 or cq.dim() != 2 or cq.shape[1] < 1
            or lo.dim() not in (1, 2) or hi.shape != lo.shape
            or lo.shape[-1] != cq.shape[0]
            or not (_I32_MIN <= w <= _I32_MAX and _I32_MIN <= T <= _I32_MAX)):
        raise ValueError("detect_regions_summary: unsupported inputs")
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    cq = cq.contiguous()
    cuda_lib.require_cuda("detect_regions_summary", cq, lo, hi)
    if w <= 0:
        return _no_regions(tuple(lo.shape), cq.device)
    B, L = cq.shape[0], cq.shape[1] - 1
    n = lo.numel()
    out = torch.empty((3,) + tuple(lo.shape), dtype=torch.int32,
                      device=cq.device)
    if n > 0:
        cuda_lib.launch(
            "fpl_regions", cq, cuda_lib.ptr(cq), B, L, cuda_lib.ptr(lo),
            cuda_lib.ptr(hi), n, w, T, cuda_lib.ptr(out))
        detect_regions_summary.launches += 1
    return out[0], out[1], out[2]


detect_regions_summary.launches = 0


def detect_regions(quals, lens, lo, hi, window_size, quality):
    """Convenience wrapper (used by tests): returns a dict of summaries."""
    w = int(window_size)
    T = (33 + int(quality)) * w
    cq = qual_cumsum(quals, lens)
    ws1, last_end, count = detect_regions_summary(cq, lo, hi, w, T)
    return {"ws1": ws1, "last_end": last_end, "count": count}
