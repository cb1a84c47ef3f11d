"""Plain reference of the `break_mask` configuration: fastplong's path with
break (-b) and N-mask (-N) after the middle-adapter split.

It works out, from the FASTQ bytes and the parameters alone, what
`reference.py` works out for the headline path (the cuts, polyX, the start
and end adapters, the split at a middle adapter, imported from there), and
then, on every out-read of that split, the two steps fastplong's
SingleEndProcessor runs before the filters (seprocessor.cpp:235-262):

* Regions: Filter::detectLowQualityRegions (filter.cpp:83-128), frozen
  from the literal transcription in `tests/reference_oracle.py:199`
  (`detect_low_quality_regions`), quirks included.  Its running total is
  quasi-rolling: a pass starting at `start` begins from the qualities
  [start, w - 1), which is qual[0 : w - 1] on the first pass and nothing
  on every later one (they start at or past w), and then adds
  qual[s + w] and takes away qual[s] at each step.  Written with one
  cumulative sum c of the span's qualities, the total at step s of a pass
  is c[max(w - 1, start)] - c[start] + (c[s + w] - c[start + w])
  - (c[s] - c[start]); a pass's window start is the first s with
  s + w < l whose total is under (33 + Q) * w, and its end e the first
  e >= that start with e + w < l whose total after the step is at least
  that (else l - w).  The region is (start, e + w - 1) and the next pass
  starts at e + w.  Each pass is one NumPy search over the span; nothing
  loops per base.
* Break: Read::breakByRegions (read.cpp:227-262).  Each region, clipped to
  the read, ends the fragment before it: a fragment [last end + 1, region
  start) is kept where it is not empty and named "r<i>-" for the i-th
  region (from 1); after the last region, the fragment to the read's end
  is kept where it is not empty and named "r<regions + 1>-".  A read with
  no region is kept whole and not renamed.  The name prefix goes after
  the '@' and before the split tag ('@' + 'rN-' + split-tag + rest of the
  name, read.cpp:200,209,244,256).  The fragments keep their read's split
  tag and its strand line.
* Mask: Read::maskRegionWithN (read.cpp:217-225) on every fragment left,
  with the mask's own window and quality: every base of each region
  (clipped to the fragment) is written N; the qualities stay.  The masked
  bases are what the filters (the N filter too), the post-filter
  statistics and the stream see.

Departures from those lines: none in what is computed.  The C++ breaks and
masks read objects one at a time; here the out-reads are spans into the
file's bytes, and the masked bases are a copy of the file with the N
written in, so that the filters and the statistics read them as
reference.py reads the file.

It imports `portbench.reference` for what the two share and nothing of
the program or of JAX.
"""

import numpy as np

from portbench import reference as ref
from portbench.reference import (Fastq, NotModelled, _adapter_counts,
                                 _side_stats, middle_adapters, reported,
                                 trim_and_cut, trim_end, trim_polyx,
                                 trim_start)

PARAMS = ref.PARAMS | {"break", "break_window", "break_quality", "mask",
                       "mask_window", "mask_quality"}

RN = b"r%d-"


def low_quality_regions(q, w, quality):
    """detectLowQualityRegions over one span's quality bytes q (a uint8
    array): the regions as (start, end) pairs, end inclusive."""
    l = len(q)
    if l == 0 or w <= 0:
        return []
    thr = (33 + quality) * w
    c = np.zeros(l + 1, np.int64)
    np.cumsum(q, out=c[1:])
    regions = []
    start = 0
    while start + w <= l:
        # the total at each step s in [start, l - w], before its update
        s = np.arange(start, l - w + 1)
        total = (c[max(w - 1, start)] - c[start] + (c[s + w] - c[start + w])
                 - (c[s] - c[start]))
        low = np.flatnonzero(total[:-1] < thr)   # s + w < l
        if not len(low):
            break
        ws = start + int(low[0])
        # the total after the step at e, for e in [ws, l - w)
        up = np.flatnonzero(total[ws - start + 1:] >= thr)
        e = ws + int(up[0]) if len(up) else l - w
        regions.append((ws, e + w - 1))
        start = e + w
    return regions


def break_by_regions(n, regions):
    """breakByRegions over a span of n bases: the fragments as
    (lo, hi, region number) relative to the span."""
    out = []
    last_end = -1
    for i, (a, b) in enumerate(regions):
        a, b = max(a, 0), min(b, n - 1)
        if a > b or a >= n:
            continue
        if a > last_end + 1:
            out.append((last_end + 1, a, i + 1))
        last_end = b
    if last_end < n - 1:
        out.append((last_end + 1, n, len(regions) + 1))
    return out


def _split_slots(fq, p, control):
    """The trims and the middle split, as reference.expected runs them
    with given adapters: (out-reads as (read, lo, hi, tag), null reads,
    polyX reads and bases by base, adapter-trimmed reads and bases,
    recorded adapters, middle splits)."""
    ads = None
    if p["adapter_trimming"]:
        ads = (ref.Adapter(p["start_adapter"], p["ed_max"], fq),
               ref.Adapter(p["end_adapter"], p["ed_max"], fq))
    ext = p["trimming_extension"]
    raw, so_all = fq.raw, fq.seq_off
    lo = np.zeros(fq.n, np.int64)
    hi = fq.lens.copy()
    null = np.zeros(fq.n, bool)
    poly_reads = np.zeros(4, np.int64)
    poly_bases = np.zeros(4, np.int64)
    if p["cut_front"] or p["cut_tail"] or p["polyx"]:
        for r in range(fq.n):
            so, qo, n = int(so_all[r]), int(fq.qual_off[r]), int(fq.lens[r])
            span = trim_and_cut(raw, so, qo, n, p)
            if span is None:
                null[r] = True
                continue
            a, b = span
            if p["polyx"]:
                b, poly, cut = trim_polyx(raw, so, a, b, p["polyx_min_len"])
                if poly >= 0:
                    poly_reads[poly] += 1
                    poly_bases[poly] += cut
            lo[r], hi[r] = a, b
    live = ~null
    trimmed = (0, 0)
    recorded = {}
    split = np.zeros(fq.n, bool)
    if ads is not None:
        t1, front, rec1 = trim_start(fq, so_all + lo, hi - lo, ads[0], ext,
                                     live)
        lo = lo + np.where(live, front, 0)
        t2, new_len, rec2 = trim_end(fq, so_all + lo, hi - lo, ads[1], ext,
                                     live)
        hi = np.where(live, lo + new_len, hi)
        t_total = np.where(live, t1 + t2, 0)
        trimmed = (int((t_total > 0).sum()), int(t_total.sum()))
        for rec, name in ((rec1, lambda n: ads[0].seq[ads[0].alen - n:]),
                          (rec2, lambda n: ads[1].seq[:n])):
            vals, counts = np.unique(rec[live & (rec > 0)],
                                     return_counts=True)
            for v, c in zip(vals.tolist(), counts.tolist()):
                k = name(v).decode()
                recorded[k] = recorded.get(k, 0) + c
        if control != "no_middle":
            split, mstart, mlen = middle_adapters(
                fq, so_all + lo, hi - lo, ads[0], ads[1], ext, live)
            left = split & (mstart > 0)
            right = split & (hi - lo - mstart - mlen > 0)
    slots = []
    for r in np.flatnonzero(live).tolist():
        if not split[r]:
            slots.append((r, int(lo[r]), int(hi[r]), b""))
            continue
        if left[r]:
            slots.append((r, int(lo[r]), int(lo[r] + mstart[r]),
                          ref.TAG_LEFT))
        if right[r]:
            slots.append((r, int(lo[r] + mstart[r] + mlen[r]), int(hi[r]),
                          ref.TAG_RIGHT))
    return (slots, null, (poly_reads, poly_bases), trimmed, recorded,
            int(split.sum()))


def _quals(fq, r, a, b):
    qo = int(fq.qual_off[r])
    return fq.arr[qo + a:qo + b]


def expected(raw, params, device="cpu", control=None):
    """Everything the program should produce for one input file, as
    reference.expected gives it (`stream`, `records`, `adapters`,
    `report`, `null_reads`, `middle_splits`, `bases`), with
    `break_out_reads` (the fragments that break made) and `masked_bases`
    (the bases that the mask wrote N) besides.

    control, for the check of the check only: "no_middle" leaves out the
    middle-adapter split, "no_break" the break, "no_mask" the mask."""
    fq = Fastq(raw, device)
    p = params
    if p["trim_front"] or p["trim_tail"]:
        raise NotModelled("fixed front or tail trimming")
    if p.get("low_complexity_filter"):
        raise NotModelled("the low-complexity filter")
    if p["adapter_trimming"] and "auto" in (p["start_adapter"],
                                            p["end_adapter"]):
        raise NotModelled("adapter auto-detection")
    if any(b"U" in fq.raw[int(fq.seq_off[r]):int(fq.seq_off[r] + fq.lens[r])]
           for r in range(min(fq.n, 100))):
        raise NotModelled("RNA reads")
    (slots, null, (poly_reads, poly_bases), (trimmed_reads, trimmed_bases),
     recorded, splits) = _split_slots(fq, p, control)
    adapters = (reported(p["start_adapter"]), reported(p["end_adapter"]))

    # break each out-read at its low-quality regions: (read, lo, hi, tag,
    # region number), the number 0 for an out-read kept whole
    out = []
    for r, a, b, tag in slots:
        regions = []
        if p["break"] and control != "no_break":
            regions = low_quality_regions(_quals(fq, r, a, b),
                                          p["break_window"],
                                          p["break_quality"])
        if not regions:
            out.append((r, a, b, tag, 0))
            continue
        out += [(r, a + x, a + y, tag, k)
                for x, y, k in break_by_regions(b - a, regions)]
    broken = sum(1 for s in out if s[4] > 0)

    # N-mask each out-read's regions (disjoint, as the out-reads are) in a
    # copy of the file's bytes
    spans = []
    if p["mask"] and control != "no_mask":
        for r, a, b, _, _ in out:
            so = int(fq.seq_off[r]) + a
            for x, y in low_quality_regions(_quals(fq, r, a, b),
                                            p["mask_window"],
                                            p["mask_quality"]):
                x, y = max(x, 0), min(y, b - a - 1)
                if x <= y:
                    spans.append((so + x, so + y + 1))
    masked_bases = sum(y - x for x, y in spans)
    mfq = fq
    if spans:
        arr = fq.arr.copy()
        for x, y in spans:
            arr[x:y] = ord("N")
        mfq = Fastq(arr.tobytes(), device)

    # filters on every out-read, over the masked bases
    rd = np.array([s[0] for s in out], np.int64)
    s_lo = np.array([s[1] for s in out], np.int64)
    s_hi = np.array([s[2] for s in out], np.int64)
    q_a = mfq.qual_off[rd] + s_lo if len(out) else rd
    s_a = mfq.seq_off[rd] + s_lo if len(out) else rd
    ln = s_hi - s_lo
    low = mfq.span_sums(lambda x: x < 33 + p["qualified_quality"], q_a, ln)
    nb = mfq.span_sums(lambda x: x == ord("N"), s_a, ln)
    code = np.full(len(out), ref.PASS, np.int64)
    if p["quality_filtering"]:
        bad_q = low > p["unqualified_percent_limit"] * ln / 100.0
        if p["mean_qual"] > 0:
            tq = mfq.span_sums(lambda x: x, q_a, ln) - 33 * ln
            bad_q |= tq // np.maximum(ln, 1) < p["mean_qual"]
        bad_n = nb * 100 > ln * p["n_percent_limit"]
        if p["n_base_limit"] != 1000000:
            bad_n |= nb > p["n_base_limit"]
        code = np.where(bad_q, ref.FAIL_QUALITY,
                        np.where(bad_n, ref.FAIL_N_BASE, code))
    if p["length_filtering"]:
        short = ln < p["length_required"]
        long_ = ((ln > p["length_limit"]) if p["length_limit"] > 0
                 else short & False)
        code = np.where(code != ref.PASS, code,
                        np.where(short, ref.FAIL_LENGTH,
                                 np.where(long_, ref.FAIL_TOO_LONG,
                                          ref.PASS)))
    code = np.where(ln == 0, ref.FAIL_LENGTH, code)
    passed = code == ref.PASS

    # the stream: '@' + 'rN-' + split tag + the rest of the name
    mraw = mfq.raw
    parts = []
    for i in np.flatnonzero(passed).tolist():
        r, a, b, tag, k = out[i]
        no, nl = int(fq.name_off[r]), int(fq.name_len[r])
        so, qo = int(fq.seq_off[r]), int(fq.qual_off[r])
        st, sl = int(fq.strand_off[r]), int(fq.strand_len[r])
        parts.append(b"@" + (RN % k if k else b"") + tag
                     + mraw[no + 1:no + nl] + b"\n" + mraw[so + a:so + b]
                     + b"\n" + mraw[st:st + sl] + b"\n" + mraw[qo + a:qo + b]
                     + b"\n")
    stream = b"".join(parts)

    pre = _side_stats(fq, fq.seq_off, fq.qual_off, fq.lens)
    post = _side_stats(mfq, s_a[passed], q_a[passed], ln[passed])
    report = {
        "summary.before_filtering": pre["summary"],
        "summary.after_filtering": post["summary"],
        "read_before_filtering.total_cycles": pre["cycles"],
        "read_after_filtering.total_cycles": post["cycles"],
        "filtering_result": {
            "passed_filter_reads": int((code == ref.PASS).sum()),
            "low_quality_reads": int((code == ref.FAIL_QUALITY).sum()),
            "too_many_N_reads": int((code == ref.FAIL_N_BASE).sum()),
            "too_short_reads": int((code == ref.FAIL_LENGTH).sum()),
            "too_long_reads": int((code == ref.FAIL_TOO_LONG).sum())},
    }
    if p["adapter_trimming"]:
        report["adapter_cutting"] = {
            "adapter_trimmed_reads": trimmed_reads,
            "adapter_trimmed_bases": trimmed_bases,
            "read_start_adapter": adapters[0],
            "read_end_adapter": adapters[1],
            "read_adapter_counts": _adapter_counts(recorded)}
    if p["polyx"]:
        report["polyx_trimming"] = {
            "total_polyx_trimmed_reads": int(poly_reads.sum()),
            "polyx_trimmed_reads": dict(zip("ATCG", poly_reads.tolist())),
            "total_polyx_trimmed_bases": int(poly_bases.sum()),
            "polyx_trimmed_bases": dict(zip("ATCG", poly_bases.tolist()))}
    return {"stream": stream, "records": int(passed.sum()),
            "adapters": adapters,
            "report": report,
            "null_reads": int(null.sum()), "middle_splits": splits,
            "bases": int(fq.lens.sum()),
            "break_out_reads": broken, "masked_bases": masked_bases}
