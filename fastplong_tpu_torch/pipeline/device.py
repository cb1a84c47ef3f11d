"""The per-batch device computation.

Port of fastplong_tpu/pipeline/device.py: the kernel chain that runs over
one padded [B, L] batch — the replacement for the reference's per-read
worker loop (src/seprocessor.cpp:180-329):

  pre-stats -> trimAndCut -> polyX -> adapter trims (start/end/FASTA) ->
  middle-adapter split -> break by low-quality regions -> N-mask ->
  filters -> post-stats

The step is built from the plain parameter dict that kernel_params(opt)
returns, so the JAX package's dict drives it unchanged.

Each batch produces one packed int32 row per read (layout in
build_fast_step) and adds its statistic partials into one device-resident
[2, F] accumulator (row 0 pre, row 1 post), one stat_batch_into call per
side.  The accumulator is int64 and updated in place, so it is drained
once, at the end of the run, without any risk of overflow.
"""

from collections import namedtuple

import numpy as np
import torch

from .. import resolve_device
from ..common import PASS_FILTER
from ..ops.adapter import (AdapterSpec, trim_by_sequence_start,
                           trim_by_sequence_end, find_middle_adapters,
                           _mismatch_full)
from ..ops.filters import N_CHAR, pass_filter
from ..ops.polyx import trim_polyx
from ..ops.primitives import arange, qual_cumsum
from ..ops.qualcut import trim_and_cut
from ..ops.regions import detect_regions_summary
from ..ops.stats_kernels import (FLAT_PER_L, flat_side_len, side_stat_len,
                                 stat_batch_into)
from ..spans import child

TAG_NONE = 0
TAG_SPLIT_LEFT = 1
TAG_SPLIT_RIGHT = 2

# The out-read candidates of a batch: each field is [S, B], one row per
# slot (S = 1, 2 after the middle split, twice that after break).
Slots = namedtuple("Slots", "lo hi active tag region_no is_parent")


def kernel_params(opt):
    """Extract the static (hashable) kernel parameters from Options."""
    qc = opt.quality_cut
    qf = opt.qualfilter
    lf = opt.length_filter
    cf = opt.complexity_filter
    ad = opt.adapter
    return dict(
        trim_front=opt.trim.front,
        trim_tail=opt.trim.tail,
        cut=dict(
            enabled_front=qc.enabled_front, enabled_tail=qc.enabled_tail,
            window_front=qc.window_size_front, quality_front=qc.quality_front,
            window_tail=qc.window_size_tail, quality_tail=qc.quality_tail),
        polyx_enabled=opt.polyx_trim.enabled,
        polyx_min_len=opt.polyx_trim.min_len,
        adapter_enabled=ad.enabled,
        start_seq=ad.sequence_start,
        end_seq=ad.sequence_end,
        fasta_seqs=tuple(ad.seqs_in_fasta),
        ed_max=ad.ed_max,
        ext=ad.trimming_extension,
        break_enabled=opt.break_opt.enabled,
        break_window=opt.break_opt.window_size,
        break_quality=opt.break_opt.quality,
        mask_enabled=opt.mask.enabled,
        mask_window=opt.mask.window_size,
        mask_quality=opt.mask.quality,
        filt=dict(
            qual_enabled=qf.enabled,
            qualified_qual=qf.qualified_qual,
            unqualified_percent_limit=qf.unqualified_percent_limit,
            n_base_limit=qf.n_base_limit,
            n_base_percent_limit=qf.n_base_percent_limit,
            avg_qual_req=qf.avg_qual_req,
            length_enabled=lf.enabled,
            required_length=lf.required_length,
            max_length=lf.max_length,
            complexity_enabled=cf.enabled,
            complexity_threshold_pct=int(round(cf.threshold * 100))),
    )


def adapter_stages(p):
    """Static list of (adapter_seq, side) trim stages, reference order
    (seprocessor.cpp:205-213)."""
    stages = []
    if p["adapter_enabled"]:
        if p["start_seq"]:
            stages.append((p["start_seq"], "start"))
        if p["end_seq"]:
            stages.append((p["end_seq"], "end"))
        for seq in p["fasta_seqs"]:
            stages.append((seq, "start"))
            stages.append((seq, "end"))
    return stages


def params_cap(p):
    """Out-read slots per input read: the middle-adapter split can make
    two, and break splits each into a head and a tail fragment."""
    cap = 2 if p["adapter_enabled"] else 1
    return 2 * cap if p["break_enabled"] else cap


def params_fields(p):
    """int32 columns per read in the packed output row."""
    return 5 + params_cap(p) * 6 + len(adapter_stages(p))


def out_cap(opt):
    return params_cap(kernel_params(opt))


def out_fields(opt):
    return params_fields(kernel_params(opt))


def _regions(s, cq, window, quality):
    """Region summaries of every slot's span, one kernel launch for all
    slots (an inactive slot's span is empty)."""
    return detect_regions_summary(
        cq, s.lo, torch.where(s.active, s.hi, s.lo), window,
        (33 + quality) * window)


def break_slots(s, cq, window, quality):
    """-b: each slot becomes slot A (the whole slot where it has no region,
    else its head fragment, or its tail where it has no head) and slot B
    (the tail where it has both), ordered A0, B0, A1, B1, ...
    (reference Read::breakByRegions, read.cpp:227-262)."""
    ws1, last_end, count = _regions(s, cq, window, quality)
    has = s.active & (count > 0)
    head = has & (ws1 > 0)
    tail = has & (last_end < s.hi - s.lo - 1)
    tail_lo = s.lo + last_end + 1
    a = Slots(torch.where(~head & tail, tail_lo, s.lo),
              torch.where(head, s.lo + ws1, s.hi),
              s.active & (~has | head | tail), s.tag,
              torch.where(head, 1, torch.where(tail, count + 1, 0)),
              s.is_parent & ~has)
    b = Slots(tail_lo, s.hi, head & tail, s.tag, count + 1,
              torch.zeros_like(has))
    return Slots(*(torch.stack([x, y], dim=1).flatten(0, 1)
                   for x, y in zip(a, b)))


def mask_slots(bases, s, cq, window, quality):
    """-N: (bases with every slot's region span written as N, mask_lo,
    mask_hi [S, B] absolute; 0, 0 where a slot has no region)
    (reference Read::maskRegionWithN, read.cpp:217-225)."""
    ws1, last_end, count = _regions(s, cq, window, quality)
    has = s.active & (count > 0)
    m_lo = torch.where(has, s.lo + ws1, 0)
    m_hi = torch.where(has, s.lo + last_end + 1, 0)
    idx = arange(bases.shape[1], bases)
    masked = ((idx >= m_lo[..., None]) & (idx < m_hi[..., None])).any(dim=0)
    return torch.where(masked, N_CHAR, bases), m_lo, m_hi


def build_step(p, device=None, with_stats=True):
    """Returns (step fn, adapter stage list) for parameter dict p.

    device follows resolve_device: CUDA unless the CPU is asked for.
    step(bases, quals, lens, read_mask, state) -> dict of per-read results;
    with with_stats=True the step adds the batch's pre-filter statistics
    into state[0] and its post-filter statistics into state[1] ([2, F]
    int64, in place) and returns the medians ("pre_median" [B],
    "post_median" [S, B]); with_stats=False omits the statistics (state is
    not read, the medians are None).  Inside a span (spans.child), each
    stage that runs is a span of its own ("step.stats_pre",
    "step.trim_cut", "step.polyx", "step.adapter", "step.middle_split",
    "step.regions", "step.filters", "step.stats_post"): the host's issue
    time, and under a profiler the range that holds the ops and kernels
    the stage issued."""
    device = resolve_device(device)
    stages = adapter_stages(p)
    specs = [AdapterSpec(seq, p["ed_max"], device) for seq, _ in stages]
    middle_specs = None
    if p["adapter_enabled"]:
        middle_specs = (AdapterSpec(p["start_seq"], p["ed_max"], device),
                        AdapterSpec(p["end_seq"], p["ed_max"], device))

    def step(bases, quals, lens, read_mask, state=None):
        B = lens.shape[0]
        i32 = dict(dtype=torch.int32, device=bases.device)
        lens = torch.where(read_mask, lens, 0)
        pre_median = None
        if with_stats:
            with child("step.stats_pre"):
                pre_median = stat_batch_into(
                    state[0], bases, quals, torch.zeros_like(lens)[None],
                    lens[None], read_mask[None], zero_lo=True)[0]

        with child("step.trim_cut"):
            lo, hi, null = trim_and_cut(
                bases, quals, lens, p["trim_front"], p["trim_tail"],
                **p["cut"])
            null = null | ~read_mask
            lo = torch.where(null, 0, lo)
            hi = torch.where(null, 0, hi)

        poly = torch.full((B,), -1, **i32)
        poly_trim = torch.zeros((B,), **i32)
        if p["polyx_enabled"]:
            with child("step.polyx"):
                new_hi, poly_b, ptrim = trim_polyx(bases, lo, hi,
                                                   p["polyx_min_len"])
                hi = torch.where(null, hi, new_hi)
                poly = torch.where(null, -1, poly_b)
                poly_trim = torch.where(null, 0, ptrim)

        # ---- adapter trimming (each stage mutates the span in turn); the
        # raw-position mismatch scan depends only on (bases, adapter), so
        # it runs once per distinct adapter and is shared by the stages and
        # the middle-adapter search
        mm_cache = {}

        def mm_for(sp_):
            if sp_.data not in mm_cache and sp_.alen > 0:
                mm_cache[sp_.data] = _mismatch_full(bases, sp_)
            return mm_cache.get(sp_.data)

        trimmed_total = torch.zeros((B,), **i32)
        recs = []
        for spec, (seq, side) in zip(specs, stages):
            with child("step.adapter"):
                if side == "start":
                    new_lo, t, rec = trim_by_sequence_start(
                        bases, lo, hi, spec, p["ext"], mm=mm_for(spec))
                    lo = torch.where(null, lo, new_lo)
                else:
                    new_hi, t, rec = trim_by_sequence_end(
                        bases, lo, hi, spec, p["ext"], mm=mm_for(spec))
                    hi = torch.where(null, hi, new_hi)
                trimmed_total = trimmed_total + torch.where(null, 0, t)
                recs.append(torch.where(null, 0, rec))

        zero = torch.zeros((B,), **i32)
        false = torch.zeros((B,), dtype=torch.bool, device=bases.device)

        # ---- middle adapter split (breakByGap)
        if middle_specs is not None:
            with child("step.middle_split"):
                found, mstart, mlen = find_middle_adapters(
                    bases, lo, hi, middle_specs[0], middle_specs[1],
                    p["ext"], mm_start=mm_for(middle_specs[0]),
                    mm_end=mm_for(middle_specs[1]))
                found = found & ~null
                len1 = mstart
                len2 = (hi - lo) - mstart - mlen
                has_left = found & (len1 > 0)
                has_right = found & (len2 > 0)
                s0_is_parent = ~found
                s0_is_left = found & has_left
                s0_lo = torch.where(s0_is_parent | s0_is_left, lo,
                                    lo + mstart + mlen)
                s0_hi = torch.where(s0_is_parent, hi,
                                    torch.where(s0_is_left, lo + len1, hi))
                s0_tag = torch.where(
                    s0_is_parent, TAG_NONE,
                    torch.where(s0_is_left, TAG_SPLIT_LEFT,
                                TAG_SPLIT_RIGHT)).to(torch.int32)
                slots = Slots(
                    torch.stack([s0_lo, lo + mstart + mlen]),
                    torch.stack([s0_hi, hi]),
                    torch.stack([~null & (~found | has_left | has_right),
                                 has_left & has_right]),
                    torch.stack([s0_tag, zero + TAG_SPLIT_RIGHT]),
                    torch.zeros((2, B), **i32),
                    torch.stack([s0_is_parent, false]))
        else:
            slots = Slots(lo[None], hi[None], ~null[None], zero[None],
                          zero[None], ~false[None])

        # ---- break by low-quality regions, then N-mask every final slot;
        # the mask lands in the bases that the filters and post-stats read
        if p["break_enabled"] or p["mask_enabled"]:
            with child("step.regions"):
                cq = qual_cumsum(quals, lens)
                if p["break_enabled"]:
                    slots = break_slots(slots, cq, p["break_window"],
                                        p["break_quality"])
        bases_eff = bases
        mask_lo = mask_hi = torch.zeros_like(slots.lo)
        if p["mask_enabled"]:
            with child("step.regions"):
                bases_eff, mask_lo, mask_hi = mask_slots(
                    bases, slots, cq, p["mask_window"], p["mask_quality"])

        # ---- filters per out-read slot, then the post-stats of all slots
        with child("step.filters"):
            codes = [pass_filter(bases_eff, quals, slots.lo[c], slots.hi[c],
                                 lens, **p["filt"])
                     for c in range(slots.lo.shape[0])]
            passed = (torch.stack(codes) == PASS_FILTER) & slots.active
        post_median = None
        if with_stats:
            with child("step.stats_post"):
                post_median = stat_batch_into(state[1], bases_eff, quals,
                                              slots.lo, slots.hi, passed)

        active = slots.active.T
        return {
            "lo": lo, "hi": hi, "null": null,
            "out_lo": slots.lo.T, "out_hi": slots.hi.T,
            "out_tag": slots.tag.T, "region_no": slots.region_no.T,
            "is_parent": slots.is_parent.T,
            "mask_lo": mask_lo.T, "mask_hi": mask_hi.T,
            "active": active,
            "n_out": active.sum(dim=1, dtype=torch.int32),
            "code": torch.stack(codes, dim=1),
            "passed": passed.T,
            "poly": poly, "poly_trim": poly_trim,
            "adapter_trimmed": trimmed_total,
            "adapter_recs": (torch.stack(recs, dim=1) if recs
                             else torch.zeros((B, 0), **i32)),
            "pre_median": pre_median, "post_median": post_median,
        }

    return step, stages


# --------------------------------------------------------------------------
# Statistics accumulator: one flat int64 vector per side, in the layout of
# ops/stats_kernels.py (fastplong_tpu's [2, F] state), at
# SL = global_stat_len().
# --------------------------------------------------------------------------


def global_stat_len():
    """The largest bucket at or under the device stat cap: every bucket's
    partials land in ONE [2, F] accumulator of this cycle length."""
    from ..common import stat_device_cap
    from .batches import _BUCKETS
    cap = stat_device_cap()
    ls = [b for b in _BUCKETS if b <= cap]
    return ls[-1] if ls else _BUCKETS[0]


def zero_stats_state(L, device):
    """Zeroed [2, F] int64 accumulator (row 0 = pre, row 1 = post)."""
    return torch.zeros((2, flat_side_len(L)), dtype=torch.int64,
                       device=device)


def grow_stats_state(state, L):
    """`state` at the longer cycle length L, on its device: the old cycle
    block is the new one's prefix, the tail (q20, q30, histogram, k-mers)
    moves to the new tail, the cycles beyond the old length are zero.  Two
    device copies; nothing waits on the device."""
    old = FLAT_PER_L * side_stat_len(state)
    grown = zero_stats_state(L, state.device)
    grown[:, :old].copy_(state[:, :old])
    grown[:, FLAT_PER_L * L:].copy_(state[:, old:])
    return grown


# the share of the device's free memory that one accumulator may take when
# it is made or grown
STATE_MEMORY_SHARE = 16


def stats_state_budget(device):
    """Bytes a [2, F] accumulator on `device` may take when it is made or
    grown: a STATE_MEMORY_SHARE-th of the card's free memory at that moment
    (torch.cuda.mem_get_info); None (no limit) off a card."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0] // STATE_MEMORY_SHARE


def unflatten_side(flat, L):
    """Split one drained flat side vector (numpy) into the named arrays.
    L is the cycle count of the (possibly trimmed) cycle block."""
    out = {}
    cyc = flat[:18 * L].reshape(L, 18)
    out["cycle_content"] = cyc[:, 0:8].T.copy()
    out["cycle_qual"] = cyc[:, 8:16].T.copy()
    out["cycle_total_base"] = cyc[:, 16].copy()
    out["cycle_total_qual"] = cyc[:, 17].copy()
    o = 18 * L
    out["q20_totals"] = flat[o:o + 8]
    o += 8
    out["q30_totals"] = flat[o:o + 8]
    o += 8
    out["base_qual_hist"] = flat[o:o + 128]
    o += 128
    out["kmer"] = flat[o:o + 1024]
    return out


def stats_state_to_numpy(states, max_seen=None):
    """The sum of the [2, F] accumulators in `states` (one per row slice
    under --devices, pipeline/sharding.py), as host int64, with the cycle
    block cut at the power of two covering the longest statted read
    (cycles beyond it are zero) — the cut fastplong_tpu's
    DeviceStats.trimmed_state makes.  Each partial is cut on its device
    and only the cut is copied; a cut selects columns, so the sum of the
    cuts is the cut of the sum that fastplong_tpu/pipeline/fast_runner.py
    takes over its per-device axis, one device's bit for bit.  Returns
    (array, cycle length)."""
    SL = side_stat_len(states[0])
    m = SL
    if max_seen is not None:
        m = max(1, min(SL, int(max_seen)))
        q = 1
        while q < m:
            q *= 2
        m = min(q, SL)
    if m < SL:
        # cut on the device: only the cycles that hold counts are copied
        states = [torch.cat([st[:, :FLAT_PER_L * m], st[:, FLAT_PER_L * SL:]],
                            dim=1) for st in states]
    flat = states[0].to("cpu", copy=True).numpy()
    for st in states[1:]:
        flat += st.cpu().numpy()
    return flat, m


def stats_state_from_numpy(arr, device):
    """A host [2, F] array (either package's layout) as the port's
    accumulator on `device`."""
    return torch.from_numpy(np.asarray(arr, np.int64)).to(device)


# --------------------------------------------------------------------------
# Packed input decode and the fast step
# --------------------------------------------------------------------------

_B5_BASE_LUT = np.frombuffer(b"ACGTN", np.uint8)


def unpack_on_device(packed_in, L, lut):
    """Split one packed batch into (bases, quals, lens, read_mask).  Layout
    from the row stride: L+8 = base5 (one byte per base: code + 5*(q-33),
    255 = padding), 2L+8 = wide (bases || quals).  base5 decode reproduces
    the wide bytes exactly (padding 255 -> base 0, qual 0).  lut is the
    uint8 [5] tensor of b"ACGTN" on the batch's device."""
    W = packed_in.shape[1]
    if W == L + 8:
        x = packed_in[:, :L]
        q5 = torch.div(x, 5, rounding_mode="floor")
        pad = x == 255
        bases = torch.where(pad, 0, lut[(x - q5 * 5).to(torch.int64)])
        quals = torch.where(pad, 0, q5 + 33)
        meta = packed_in[:, L:]
    elif W == 2 * L + 8:
        bases = packed_in[:, :L]
        quals = packed_in[:, L:2 * L]
        meta = packed_in[:, 2 * L:]
    else:
        raise ValueError("packed width %d does not match L=%d" % (W, L))
    lb = meta[:, :4].to(torch.int32)
    lens = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
    return bases.contiguous(), quals.contiguous(), lens, meta[:, 4] != 0


def build_fast_step(p, device=None, with_stats=True):
    """Returns (fast fn, stages) for parameter dict p on `device` (CUDA
    unless the CPU is asked for, as resolve_device decides).

    with_stats=True:  fast(state, packed_in, L) -> rows, adding the batch's
                      pre/post partials into state ([2, F] int64) in place;
    with_stats=False: fast(packed_in, L) -> rows (medians read as 0).

    packed_in: [B, L+8] uint8 (base5) or [B, 2L+8] (wide).
    rows ([B, F] int32), the layout of fastplong_tpu's packed ring rows:
      0: lo   1: hi
      2: flags = null | n_out<<1 | (poly+1)<<4 | pre_median<<8
      3: poly_trim   4: adapter_trimmed (clamped at 0)
      5 + c*6 ... : per slot (out_lo, out_hi, mask_lo, mask_hi, misc,
                    region_no) where misc = code | tag<<6 | passed<<8 |
                    is_parent<<9 | active<<10 | post_median<<11
      5 + cap*6 ...: adapter_recs per stage

    Inside a span (spans.child), the unpacking ("step.unpack") and the
    packing of the rows ("step.pack") are spans, beside build_step's.
    """
    device = resolve_device(device)
    step, stages = build_step(p, device, with_stats)
    cap = params_cap(p)
    lut = torch.from_numpy(_B5_BASE_LUT.copy()).to(device)

    def pack(out):
        zero = torch.zeros_like(out["lo"])

        def i32(x):
            return x.to(torch.int32)

        pre_median = i32(out["pre_median"]) if with_stats else zero
        flags = (i32(out["null"]) | (out["n_out"] << 1)
                 | ((out["poly"] + 1) << 4) | (pre_median << 8))
        # adapter_trimmed can be negative (the reference's partial-path
        # arithmetic underflows for adapters longer than the read); the
        # accounting gate is `> 0` either way
        cols = [out["lo"], out["hi"], flags, out["poly_trim"],
                torch.clamp(out["adapter_trimmed"], min=0)]
        for c in range(cap):
            post_median = (i32(out["post_median"][c]) if with_stats
                           else zero)
            misc = (out["code"][:, c]
                    | (i32(out["out_tag"][:, c]) << 6)
                    | (i32(out["passed"][:, c]) << 8)
                    | (i32(out["is_parent"][:, c]) << 9)
                    | (i32(out["active"][:, c]) << 10)
                    | (post_median << 11))
            cols += [out["out_lo"][:, c], out["out_hi"][:, c],
                     out["mask_lo"][:, c], out["mask_hi"][:, c], misc,
                     out["region_no"][:, c]]
        cols += list(out["adapter_recs"].unbind(1))
        return torch.stack([i32(c) for c in cols], dim=1)

    def core(packed_in, L, state=None):
        with child("step.unpack"):
            bases, quals, lens, read_mask = unpack_on_device(packed_in, L,
                                                             lut)
        out = step(bases, quals, lens, read_mask, state)
        with child("step.pack"):
            return pack(out)

    if not with_stats:
        return core, stages

    def fast(state, packed_in, L):
        return core(packed_in, L, state)

    return fast, stages
