"""Adapter search and trimming.

Port of fastplong_tpu/ops/adapter.py (reference AdapterTrimmer,
src/adaptertrimmer.cpp): sliding mismatch-count scans over 200bp end
windows with three scan policies, a 16-mer seed scan by edit distance
(kernel 3, csrc/seed_scan.cu), and Myers-verified decision ladders for
trimBySequenceStart/End, plus the whole-read middle-adapter search.

Reference decision-ladder quirks preserved exactly:
  * the early-return "mismatch <= threshold" path skips the edit-distance
    verification (adaptertrimmer.cpp:99-101,124-126);
  * tie-breaks differ per policy (leftmost scan keeps the LAST best, the
    rightmost scan keeps the LOWEST best, global keeps the FIRST best);
  * the end-side partial scan stops at the first candidate whose edit
    distance exceeds the running minimum ("last one is best" with break,
    adaptertrimmer.cpp:273-286), while the start side keeps scanning;
  * trimFront clamps to length-1, while resize can empty the read;
  * the end-side partial path requires pos > 0 (adaptertrimmer.cpp:288).

Spans [lo, hi) index the padded batch; all outputs are per-read scalars the
host applies to record bytes.
"""

import math

import numpy as np
import torch

from . import cuda_lib
from .mismatch import mismatch_scan
from .myers import (MAX_K, M32, myers_blockscan, myers_verify,
                    myers_verify_pair, pattern_table)
from .primitives import arange, first_true, last_true, take_cols

WINDOW = 200
PATTERN_LEN = 16
SEED_WINDOWS = WINDOW - PATTERN_LEN   # P, candidate seed positions
FAR = 10 ** 6


def _cpp_round(x: float) -> int:
    return int(math.floor(x + 0.5))


class AdapterSpec:
    """Constants for one adapter sequence, as tensors on `device`.

    The start/end trim verifies compare at most min(alen, WINDOW) pattern
    bytes (the full-match search is empty for alen >= WINDOW and the
    partial path's cmplen is bounded by the window); only the middle-adapter
    global search needs the full-length pattern, whose verify takes the
    block-scan kernel beyond MAX_DEVICE_PATTERN bytes (_distance).
    """

    def __init__(self, seq: str, ed_max: float, device="cpu"):
        self.seq = seq
        self.data = seq.encode("latin-1")
        self.alen = len(seq)
        self.plen = min(PATTERN_LEN, self.alen)
        self.ed_max = ed_max
        self.thr_full = _cpp_round(ed_max * self.alen)
        self.thr_seed = _cpp_round(ed_max * self.plen)
        self.verify_cap = min(self.alen, WINDOW)
        self.pm_fwd = pattern_table(self.data[:self.verify_cap], device)
        self.pm_rev = pattern_table(self.data[::-1][:self.verify_cap], device)
        self.pm_full = pattern_table(self.data, device)
        # round(edMax*cmplen) for every cmplen in 0..alen
        self.thr_tbl = torch.tensor(
            [_cpp_round(ed_max * c) for c in range(self.alen + 1)],
            dtype=torch.int32, device=device)
        self.adapter = torch.from_numpy(
            np.frombuffer(self.data, np.uint8).copy()).to(device)
        self.seed_fwd = _seed_table(self.data[:self.plen], device)
        self.seed_rev = _seed_table(self.data[::-1][:self.plen], device)


def _seed_table(pattern: bytes, device):
    """[256] int32: bit i set iff pattern[i] == byte (plen <= 16)."""
    tbl = np.zeros(256, np.int32)
    for i, ch in enumerate(pattern):
        tbl[ch] |= 1 << i
    return torch.from_numpy(tbl).to(device)


def _mismatch_full(bases, spec):
    """Mismatch counts of spec's adapter at every raw position (kernel 1)."""
    return mismatch_scan(bases, spec.adapter)


def _verify_problem(bases, abs_start, spec, cmplen=None, reverse=False,
                    full=False):
    """Arguments (pm, plen, text, tlen) of myers_verify for the Myers
    distance of the window starting (or ending) at abs_start.

    forward: text = bases[abs_start : abs_start+n], pattern = adapter[:n]
    reverse: text = reversed bases[abs_start-n+1 ... abs_start],
             pattern = reversed(adapter)[:n]  (== adapter suffix of len n)
    n = cmplen (per-lane) or alen.  full=True is the middle-adapter search
    (full-length pattern); full=False caps the pattern at min(alen, WINDOW).
    """
    B, L = bases.shape
    n = cmplen if cmplen is not None else torch.full(
        (B,), spec.alen, dtype=torch.int32, device=bases.device)
    T = max(spec.alen if full else spec.verify_cap, 1)
    j = arange(T, bases)[None, :]
    src = abs_start[:, None] - j if reverse else abs_start[:, None] + j
    ok = (j < n[:, None]) & (src >= 0) & (src < L)
    text = torch.where(ok, take_cols(bases, torch.clamp(src, 0, L - 1)), 0)
    if full:
        pm = spec.pm_full
    else:
        pm = spec.pm_rev if reverse else spec.pm_fwd
    return pm, n, text.contiguous(), n


def _distance(problem):
    """Myers distances of one verify problem: the verify kernel up to
    MAX_DEVICE_PATTERN bytes (K <= MAX_K words), the block-scan beyond."""
    if problem[0].shape[1] > MAX_K:
        return myers_blockscan(*problem)
    return myers_verify(*problem)


def _thr_select(cmplen, spec):
    """round(edMax*cmplen) per lane (cmplen clamped to [0, alen])."""
    return spec.thr_tbl[torch.clamp(cmplen, 0, spec.alen).to(torch.int64)]


def seed_scan_plain(bases, base_abs, ncand, seed_tbl, plen, start_side):
    """Plain PyTorch version of seed_scan: all P windows advance one Myers
    step per iteration, in int64 masked to 32 bits."""
    B, L = bases.shape
    P = SEED_WINDOWS
    dev = bases.device
    p = torch.arange(P, device=dev)[None, :]
    tbl = seed_tbl.to(torch.int64) & M32
    full = (1 << plen) - 1
    top = 1 << (plen - 1)
    VP = torch.full((B, P), full, dtype=torch.int64, device=dev)
    VN = torch.zeros((B, P), dtype=torch.int64, device=dev)
    D = torch.full((B, P), plen, dtype=torch.int64, device=dev)
    a = base_abs.to(torch.int64)[:, None]
    for j in range(plen):
        src = a + p + (plen - 1 - j) if start_side else a - p + j
        ok = (src >= 0) & (src < L)
        col = torch.where(ok, torch.gather(bases, 1, torch.clamp(
            src, 0, L - 1)), 0)
        X = tbl[col.to(torch.int64)]
        D0 = ((((X & VP) + VP) & M32) ^ VP) | X | VN
        HP = VN | (~(D0 | VP) & M32)
        HN = D0 & VP
        X2 = ((HP << 1) & M32) | 1
        VP = (((HN << 1) & M32) | (~(D0 | X2) & M32)) & full
        VN = D0 & X2
        D = D + torch.where(HP & top != 0, 1,
                            torch.where(HN & top != 0, -1, 0))
    return torch.where(p < ncand[:, None], D, FAR).to(torch.int32)


def seed_scan(bases, base_abs, ncand, seed_tbl, plen, start_side):
    """ed16[b, p] for the P seed windows of each read (see seed_scan.cu for
    the window geometry).  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if bases.device.type == "cpu":
        return seed_scan_plain(bases, base_abs, ncand, seed_tbl, plen,
                               start_side)
    B, L = bases.shape
    if (bases.dtype != torch.uint8 or seed_tbl.dtype != torch.int32
            or seed_tbl.shape != (256,) or not 1 <= plen <= PATTERN_LEN):
        raise ValueError("seed_scan: unsupported inputs")
    base_abs = base_abs.to(torch.int32).contiguous()
    ncand = ncand.to(torch.int32).contiguous()
    cuda_lib.require_cuda("seed_scan", bases, base_abs, ncand, seed_tbl)
    out = torch.empty((B, SEED_WINDOWS), dtype=torch.int32,
                      device=bases.device)
    if B == 0:
        return out
    cuda_lib.launch(
        "fpl_seed_scan", bases, cuda_lib.ptr(bases), B, L,
        cuda_lib.ptr(base_abs), cuda_lib.ptr(ncand), cuda_lib.ptr(seed_tbl),
        plen, int(bool(start_side)), SEED_WINDOWS, cuda_lib.ptr(out))
    seed_scan.launches += 1
    return out


seed_scan.launches = 0


def _seed_scan(bases, base_abs, ncand, spec, start_side):
    """ed16[b, p]: edit distance of the p-th seed window.

    start side: text = read[p : p+plen] reversed, pattern = rev(adapter)[:plen]
    end side:   text = read[rlen-plen-p : rlen-p], pattern = adapter[:plen]
    base_abs: absolute index of the p=0 window's anchor
      (start side: lo;  end side: lo + rlen - plen)
    """
    tbl = spec.seed_rev if start_side else spec.seed_fwd
    return seed_scan(bases, base_abs, ncand, tbl, spec.plen, start_side)


def search_full(mm, rlen, alen, thr, lo_rel, hi_rel_excl, policy):
    """Shared full-match searchAdapter policies over a mismatch array.

    mm[b, p] is relative to some anchor; candidate range is
    [lo_rel, hi_rel_excl) (per-lane).  policy: 'left' | 'right' | 'global'.
    Returns (pos, needs_verify) where pos is the relative position or -1;
    needs_verify=True lanes must pass the Myers check (early-exit lanes
    skip it, matching adaptertrimmer.cpp:99-101).
    """
    B, P = mm.shape
    mm = mm.to(torch.int32)
    p = arange(P, mm)[None, :]
    in_range = (p >= lo_rel[:, None]) & (p < hi_rel_excl[:, None])
    mm_m = torch.where(in_range, mm, FAR)
    has_any = in_range.any(dim=-1)

    early_mask = in_range & (mm <= thr)
    minus1 = torch.full_like(lo_rel, -1)
    if policy == "right":
        early = last_true(early_mask, minus1)
    else:  # 'left' scans ascending
        early = first_true(early_mask, minus1)

    if policy == "left":
        # ties keep the LAST best: last index achieving the min
        mn = mm_m.min(dim=-1).values
        best = last_true(mm_m == mn[:, None], minus1)
    else:
        # 'right' and 'global': first index achieving the min
        best = torch.argmin(mm_m, dim=-1).to(torch.int32)
    best = torch.where(has_any, best, -1)

    if policy == "global":
        return best, best >= 0
    pos = torch.where(early >= 0, early, best)
    return pos, (early < 0) & (best >= 0)


def trim_by_sequence_start(bases, lo, hi, spec, ext, mm=None):
    """Returns (new_lo, trimmed_ret, rec_cmplen) per read.

    trimmed_ret: value added to FilterResult (0 = no trim).
    rec_cmplen:  0 = none, alen = full adapter, else the partial cmplen
                 (record adapter[alen-cmplen:]).
    """
    B, L = bases.shape
    alen, plen = spec.alen, spec.plen
    rlen = hi - lo
    eligible = rlen >= PATTERN_LEN
    if alen == 0:
        z = torch.zeros_like(lo)
        return lo, z, z
    if mm is None:
        mm = _mismatch_full(bases, spec)

    if alen < WINDOW:
        search_end = torch.clamp(rlen, max=WINDOW)
        # searchAdapter(.., 0, WINDOW, false, true): rightmost policy needs
        # searchEnd > alen; also searchStart + alen > rlen -> -1
        valid_search = (alen <= rlen) & (search_end > alen)
        pos_f, needs_v = search_full(
            mm, rlen, alen, spec.thr_full,
            lo, lo + search_end - alen + 1, "right")
        pos_f = torch.where(valid_search & (pos_f >= 0), pos_f - lo, -1)
        verify_f = _verify_problem(bases, lo + torch.clamp(pos_f, min=0),
                                   spec)
    else:
        # alen >= WINDOW: the reference's full-match ranges are empty
        # (adaptertrimmer.cpp:80-110)
        pos_f = torch.full_like(lo, -1)
        ok_f = torch.zeros_like(eligible)

    # ---- partial 16-mer path
    ncand = torch.clamp(torch.clamp(rlen - plen, max=WINDOW - plen), min=0)
    ed16 = _seed_scan(bases, lo, ncand, spec, start_side=True)
    cand = ed16 <= spec.thr_seed
    e_m = torch.where(cand, ed16, FAR)
    pos_p = torch.where(cand.any(dim=-1),
                        torch.argmin(e_m, dim=-1).to(torch.int32), -1)
    cmplen = torch.clamp(pos_p + plen, max=alen)
    # verify: ed(read[pos+plen-cmplen : pos+plen], adapter[alen-cmplen:])
    verify_p = _verify_problem(
        bases, lo + torch.clamp(pos_p, min=0) + plen - 1, spec,
        cmplen=cmplen, reverse=True)
    if alen < WINDOW:
        # the full-match and the partial verifies share one launch
        ed_f, ed_p = myers_verify_pair(verify_f, verify_p)
        ok_f = (pos_f >= 0) & (~needs_v | (ed_f <= spec.thr_full))
    else:
        ed_p = myers_verify(*verify_p)
    ok_p = (pos_p >= 0) & (ed_p <= _thr_select(cmplen, spec))

    # ---- combine (full match wins; partial only tried if no full match)
    n_full = torch.minimum(pos_f + ext, rlen - alen) + alen
    n_part = torch.minimum(pos_p + ext, rlen - alen) + plen
    use_full = eligible & ok_f
    use_part = eligible & ~ok_f & ok_p
    n = torch.where(use_full, n_full, torch.where(use_part, n_part, 0))
    trimmed = use_full | use_part
    # trimFront semantics (read.cpp:69-73): min(len-1, n); negative empties
    applied = torch.where(n < 0, rlen, torch.minimum(n, rlen - 1))
    new_lo = torch.where(trimmed, lo + applied, lo)
    trimmed_ret = torch.where(trimmed, n, 0)
    rec = torch.where(use_full, alen, torch.where(use_part, cmplen, 0))
    return new_lo, trimmed_ret, rec


def trim_by_sequence_end(bases, lo, hi, spec, ext, mm=None):
    """Returns (new_hi, trimmed_ret, rec_cmplen); rec as in start side but
    recording adapter[:cmplen]."""
    B, L = bases.shape
    alen, plen = spec.alen, spec.plen
    rlen = hi - lo
    eligible = rlen >= PATTERN_LEN
    if alen == 0:
        z = torch.zeros_like(lo)
        return hi, z, z

    # ---- full match: leftmost in [searchStart, rlen-alen) over the last
    # WINDOW bases; raw-coordinate mismatch scan, range offset by lo
    if mm is None:
        mm = _mismatch_full(bases, spec)
    if alen < WINDOW:
        search_start = torch.clamp(rlen - WINDOW, min=0)
        valid_search = (search_start + alen) <= rlen
        pos_f, needs_v = search_full(
            mm, rlen, alen, spec.thr_full,
            lo + search_start, lo + rlen - alen, "left")
        pos_f = torch.where(valid_search & (pos_f >= 0),
                            pos_f - lo - search_start, -1)
        abs_f = search_start + pos_f  # position within the span
        verify_f = _verify_problem(bases, lo + torch.clamp(abs_f, min=0),
                                   spec)
    else:
        # alen >= WINDOW: the leftmost loop is empty for every rlen
        # (adaptertrimmer.cpp:86-95)
        pos_f = torch.full_like(lo, -1)
        abs_f = pos_f
        ok_f = torch.zeros_like(eligible)

    # ---- partial: sequential-break scan (adaptertrimmer.cpp:269-286)
    ncand = torch.clamp(torch.clamp(rlen - plen, max=WINDOW - plen), min=0)
    ed16 = _seed_scan(bases, lo + rlen - plen, ncand, spec, start_side=False)
    cand = ed16 <= spec.thr_seed
    e_m = torch.where(cand, ed16, FAR)
    firstc = first_true(cand, FAR)
    P = e_m.shape[1]
    pidx = arange(P, e_m)[None, :]
    # exclusive running min over candidates before p
    prevmin = torch.nn.functional.pad(
        torch.cummin(e_m, dim=1).values[:, :-1], (1, 0), value=FAR)
    breaking = cand & (pidx > firstc[:, None]) & (e_m > prevmin)
    pb = first_true(breaking, P)
    pos_p = last_true(cand & (pidx < pb[:, None]), torch.full_like(lo, -1))
    # reference requires pos > 0 strictly for the partial path
    has_p = pos_p > 0
    cmplen = torch.clamp(pos_p + plen, max=alen)
    verify_p = _verify_problem(
        bases, lo + rlen - plen - torch.clamp(pos_p, min=0), spec,
        cmplen=cmplen, reverse=False)
    if alen < WINDOW:
        # the full-match and the partial verifies share one launch
        ed_f, ed_p = myers_verify_pair(verify_f, verify_p)
        ok_f = (pos_f >= 0) & (~needs_v | (ed_f <= spec.thr_full))
    else:
        ed_p = myers_verify(*verify_p)
    ok_p = has_p & (ed_p <= _thr_select(cmplen, spec))

    # ---- combine
    mpos = torch.clamp(abs_f - ext, min=0)
    use_full = eligible & ok_f
    use_part = eligible & ~ok_f & ok_p
    ppos = torch.minimum(pos_p + ext, rlen - plen)
    new_len = torch.where(use_full, mpos,
                          torch.where(use_part, rlen - plen - ppos, rlen))
    # resize is a no-op if new_len > rlen or < 0 (read.cpp:62-67)
    new_len = torch.where((new_len >= 0) & (new_len <= rlen), new_len, rlen)
    trimmed_ret = torch.where(use_full, rlen - mpos,
                              torch.where(use_part, ppos + plen, 0))
    rec = torch.where(use_full, alen, torch.where(use_part, cmplen, 0))
    return lo + new_len, trimmed_ret, rec


def _global_candidate(bases, lo, hi, spec, mm=None):
    """The default-policy candidate of searchAdapter over the whole span
    and the arguments of its Myers verify (None when alen == 0)."""
    alen = spec.alen
    rlen = hi - lo
    if alen == 0:
        # degenerate: empty adapter "matches" at 0 whenever the global loop
        # runs at least once (rlen > 0)
        return torch.where(rlen > 0, 0, -1).to(torch.int32), None
    if mm is None:
        mm = _mismatch_full(bases, spec)
    valid = alen <= rlen
    pos, _ = search_full(
        mm, rlen, alen, spec.thr_full, lo, lo + rlen - alen, "global")
    pos = torch.where(valid & (pos >= 0), pos - lo, -1)
    return pos, _verify_problem(bases, lo + torch.clamp(pos, min=0), spec,
                                full=True)


def _global_accept(pos, ed, spec):
    """searchAdapter's result: the candidate if its verify passes, else -1
    (ed is None for the empty adapter, which needs no verify)."""
    return pos if ed is None else torch.where(
        (pos >= 0) & (ed <= spec.thr_full), pos, -1)


def find_middle_adapters(bases, lo, hi, start_spec, end_spec, ext,
                         mm_start=None, mm_end=None):
    """Reference findMiddleAdapters (adaptertrimmer.cpp:13-40).

    Returns (found, start, length) relative to the span."""
    rlen = hi - lo
    # both searches' candidates first, then their verifies in one launch
    # (a side longer than MAX_DEVICE_PATTERN takes the block-scan alone)
    sp, verify_s = _global_candidate(bases, lo, hi, start_spec, mm=mm_start)
    ep, verify_e = _global_candidate(bases, lo, hi, end_spec, mm=mm_end)
    if (verify_s is not None and verify_e is not None
            and max(verify_s[0].shape[1], verify_e[0].shape[1]) <= MAX_K):
        ed_s, ed_e = myers_verify_pair(verify_s, verify_e)
    else:
        ed_s = None if verify_s is None else _distance(verify_s)
        ed_e = None if verify_e is None else _distance(verify_e)
    sp = _global_accept(sp, ed_s, start_spec)
    ep = _global_accept(ep, ed_e, end_spec)
    slen = start_spec.alen
    elen = end_spec.alen

    both = (sp >= 0) & (ep >= 0)
    s_only = (sp >= 0) & (ep < 0)
    e_only = (ep >= 0) & (sp < 0)

    b_start = torch.clamp(torch.minimum(sp, ep) - ext, min=0)
    b_end = torch.minimum(torch.maximum(sp + slen, ep + elen) + ext, rlen)
    s_start = torch.clamp(sp - ext, min=0)
    s_end = torch.minimum(sp + slen + ext, rlen)
    e_start = torch.clamp(ep - ext, min=0)
    e_end = torch.minimum(ep + elen + ext, rlen)

    start = torch.where(both, b_start, torch.where(s_only, s_start, e_start))
    end = torch.where(both, b_end, torch.where(s_only, s_end, e_end))
    found = both | s_only | e_only
    return (found, torch.where(found, start, -1),
            torch.where(found, end - start, 0))
