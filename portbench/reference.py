"""Plain reference of what fastplong computes for one input file.

It works out again, from the FASTQ bytes and the configuration's parameters
alone, everything that the program under test derives: the adapters that
auto-detection finds, each read's trimming (quality cut, polyX, start and end
adapters, the split at a middle adapter), the filters, the passing reads'
bytes as `--stdout` writes them, and the JSON report's counts and statistics.

It follows fastplong's own algorithms read by read, as they are set out in
the literal transcriptions of `tests/reference_oracle.py` (frozen here at
commit 7974d2b1f918e43a25c7e77d01c807558f8ff8d2) and in fastplong's
Evaluator, written as plain Python and NumPy.  Only the inner loops that
would take minutes in Python are vectorised: the mismatch counts of an
adapter at every position (NumPy, or plain PyTorch on a card when one is
given), and the edit distances (Myers' bit-parallel recurrence over many
windows at once, checked against the plain dynamic programme in the tests).

It imports nothing of the program and nothing of JAX.
"""

import math

import numpy as np

WINDOW = 200          # adapter search window at each end
PATTERN_LEN = 16      # partial-adapter seed length
KEYLEN = 10           # auto-detection k-mer length
KEYSPACE = 1 << (2 * KEYLEN)
MAX_ADAPTER_LEN = 64
FOLD_THRESHOLD = 100.0
SAMPLE_READS = 64 * 1024          # auto-detection's read sample
SAMPLE_BASES = 8192 * 64 * 1024   # and its base limit

# filter result codes
PASS, FAIL_N_BASE, FAIL_LENGTH, FAIL_TOO_LONG, FAIL_QUALITY = 0, 12, 16, 17, 20

TAG_LEFT = b"split-by-adapter-left-"
TAG_RIGHT = b"split-by-adapter-right-"

# the configuration parameters that expected() reads; a configuration with
# any other parameter needs a reference of its own (see harness.Cell)
PARAMS = frozenset((
    "start_adapter", "end_adapter", "adapter_trimming", "ed_max",
    "trimming_extension", "trim_front", "trim_tail", "cut_front", "cut_tail",
    "cut_window", "cut_quality", "polyx", "polyx_min_len",
    "quality_filtering", "qualified_quality", "unqualified_percent_limit",
    "n_percent_limit", "n_base_limit", "mean_qual", "length_filtering",
    "length_required", "length_limit", "low_complexity_filter"))


class NotModelled(Exception):
    """The input asks for a path this reference does not model."""


def cpp_round(x):
    return int(math.floor(x + 0.5))


# ------------------------------------------------------------ FASTQ parsing


class Fastq:
    """The records of one FASTQ file of 4-line records, by offsets into its
    bytes."""

    def __init__(self, raw, device="cpu"):
        self.device = device
        self._t = None
        self.raw = bytes(raw)
        self.arr = np.frombuffer(self.raw, np.uint8)
        nl = np.flatnonzero(self.arr == 10)
        if len(nl) % 4:
            raise NotModelled("the file is not whole 4-line records")
        nl = nl.reshape(-1, 4)
        starts = np.concatenate(([0], nl[:-1, 3] + 1))
        self.n = len(nl)
        self.name_off = starts
        self.name_len = nl[:, 0] - starts
        self.seq_off = nl[:, 0] + 1
        self.lens = nl[:, 1] - self.seq_off
        self.strand_off = nl[:, 1] + 1
        self.strand_len = nl[:, 2] - self.strand_off
        self.qual_off = nl[:, 2] + 1
        if (self.arr[starts] != ord("@")).any() or (
                nl[:, 3] - self.qual_off != self.lens).any():
            raise NotModelled("malformed records")

    def tensor(self):
        """The file's bytes as a uint8 tensor on the device (kept)."""
        if self._t is None:
            import torch
            self._t = torch.from_numpy(self.arr.copy()).to(self.device)
        return self._t

    def span_sums(self, pred, starts, lens):
        """Per span, how many of the file's bytes [start, start + len)
        satisfy pred (a function of the byte tensor); the spans lie in the
        file."""
        import torch
        starts = torch.from_numpy(np.asarray(starts, np.int64)).to(self.device)
        lens = torch.from_numpy(np.asarray(lens, np.int64)).to(self.device)
        c = torch.zeros(self.arr.shape[0] + 1, dtype=torch.int64,
                        device=self.device)
        torch.cumsum(pred(self.tensor()).long(), 0, out=c[1:])
        out = c[starts + lens] - c[starts]
        del c
        return out.cpu().numpy()


# ------------------------------------------------------------ edit distance


def edit_distance(a, b):
    """Levenshtein distance of two byte strings (Myers' bit-parallel
    recurrence with Python integers: a is the pattern, any length)."""
    m, n = len(a), len(b)
    if m == 0:
        return n
    if n == 0:
        return m
    peq = {}
    for i, c in enumerate(a):
        peq[c] = peq.get(c, 0) | (1 << i)
    full = (1 << m) - 1
    top = 1 << (m - 1)
    vp, vn, score = full, 0, m
    for c in b:
        eq = peq.get(c, 0)
        xv = eq | vn
        xh = (((eq & vp) + vp) ^ vp) | eq
        ph = vn | (~(xh | vp) & full)
        mh = vp & xh
        if ph & top:
            score += 1
        elif mh & top:
            score -= 1
        ph = ((ph << 1) | 1) & full
        mh = (mh << 1) & full
        vp = mh | (~(xv | ph) & full)
        vn = ph & xv
    return score


def edit_distance_rows(pattern, texts, device="cpu"):
    """Levenshtein distance of `pattern` (bytes, 1-64 long) to each row of
    `texts` ([R, n] uint8, every row n long), all rows at once, in plain
    PyTorch on `device` (int64 words; the sum in the recurrence may wrap,
    as it does in unsigned words, and is masked to m bits)."""
    import torch
    m = len(pattern)
    if not 1 <= m <= 64:
        raise NotModelled("pattern length %d" % m)
    R, n = texts.shape
    if R == 0:
        return np.zeros(0, np.int64)

    def word(v):
        return v - (1 << 64) if v >= 1 << 63 else v

    peq = [0] * 256
    for i, c in enumerate(pattern):
        peq[c] |= 1 << i
    peq = torch.tensor([word(v) for v in peq], dtype=torch.int64,
                       device=device)
    full = word((1 << m) - 1)
    top = word(1 << (m - 1))
    x = torch.from_numpy(np.array(texts, np.uint8)).to(device).long()
    vp = torch.full((R,), full, dtype=torch.int64, device=device)
    vn = torch.zeros(R, dtype=torch.int64, device=device)
    score = torch.full((R,), m, dtype=torch.int64, device=device)
    for j in range(n):
        eq = peq[x[:, j]]
        xv = eq | vn
        xh = (((eq & vp) + vp) ^ vp) | eq
        ph = vn | (~(xh | vp) & full)
        mh = vp & xh
        up = (ph & top) != 0
        score += up.long() - (((mh & top) != 0) & ~up).long()
        ph = ((ph << 1) | 1) & full
        mh = (mh << 1) & full
        vp = mh | (~(xv | ph) & full)
        vn = ph & xv
    return score.cpu().numpy()


# ------------------------------------------------------- mismatch counting


def mismatch_counts(fq, adapter):
    """mm[p] = mismatches of `adapter` against the file's bytes
    [p, p + len(adapter)) for every p (bytes past the end of the file count
    as mismatches), in plain PyTorch on the file's device."""
    import torch
    x = torch.cat([fq.tensor(), torch.zeros(len(adapter), dtype=torch.uint8,
                                            device=fq.device)])
    n = fq.arr.shape[0]
    mm = torch.zeros(n, dtype=torch.uint8, device=fq.device)
    for i, c in enumerate(adapter):
        mm += (x[i:i + n] != c).to(torch.uint8)
    return mm.cpu().numpy()


# ------------------------------------------------------------ adapter search
#
# Each stage takes every read at once: `base` is the offset of each read's
# current span in the file, `rlen` its length, `act` the reads the stage
# applies to.  The decisions follow AdapterTrimmer's searchAdapter,
# trimBySequenceStart, trimBySequenceEnd and findMiddleAdapters: a scan
# from the right end keeps the rightmost hit within the threshold, else the
# lowest position of the fewest mismatches; a scan from the left keeps the
# first hit, else the last position of the fewest mismatches; the global
# scan the first position of the fewest; a hit within the threshold is taken
# as it is, any other best position only if its edit distance is within it.

BIG = 1 << 20


class Adapter:
    """One adapter with its mismatch counts at every position of the file."""

    def __init__(self, seq, ed_max, fq):
        self.seq = seq.encode()
        self.alen = len(self.seq)
        if not 1 <= self.alen <= 64:
            raise NotModelled("an adapter of %d bases" % self.alen)
        self.plen = min(PATTERN_LEN, self.alen)
        self.thr = cpp_round(ed_max * self.alen)
        self.pthr = cpp_round(ed_max * self.plen)
        self.ed_max = ed_max
        self.mm = mismatch_counts(fq, self.seq)


def gather(arr, starts, width):
    """[len(starts), width] bytes of arr from each start (indices past the
    end of arr read its last byte)."""
    idx = np.asarray(starts, np.int64)[:, None] + np.arange(width)
    return arr[np.minimum(idx, len(arr) - 1)]


def segments(values, starts, counts, width, fill=255):
    """[len(starts), width] of values[start:start + count], `fill` beyond
    each count."""
    col = np.arange(width)
    ok = col < np.asarray(counts)[:, None]
    idx = np.where(ok, np.asarray(starts)[:, None] + col, 0)
    return np.where(ok, values[idx], fill).astype(np.int64)


def eds_within(fq, pattern_of, starts, lens, limit_of):
    """For each row: edit distance of pattern_of(len) against the file's
    bytes at starts[i] (lens[i] long) within limit_of(len); rows grouped by
    length."""
    out = np.zeros(len(starts), bool)
    for n in np.unique(lens).tolist():
        rows = np.flatnonzero(lens == n)
        eds = edit_distance_rows(pattern_of(n), gather(fq.arr, starts[rows], n),
                                 fq.device)
        out[rows] = eds <= limit_of(n)
    return out


def verify_at(fq, ad, starts):
    """Whether the window of ad.alen bases at each start is within the
    adapter's edit-distance threshold."""
    n = np.full(len(starts), ad.alen)
    return eds_within(fq, lambda _: ad.seq, starts, n, lambda _: ad.thr)


def partial_windows(fq, ad, starts, npos, pattern):
    """[rows, WINDOW - plen] edit distances of the seed pattern against the
    plen-base windows at starts[:, p]; BIG at p >= npos."""
    P = WINDOW - PATTERN_LEN
    F = len(npos)
    texts = gather(fq.arr, starts.reshape(-1), ad.plen)
    eds = edit_distance_rows(pattern, texts, fq.device).reshape(F, P)
    return np.where(np.arange(P) < npos[:, None], eds, BIG)


def trim_start(fq, base, rlen, ad, ext, act):
    """trimBySequenceStart: (trimmed count, front trim, recorded adapter
    length) per read."""
    R = len(base)
    t = np.zeros(R, np.int64)
    front = np.zeros(R, np.int64)
    rec = np.zeros(R, np.int64)
    act = act & (rlen >= PATTERN_LEN)
    end = np.minimum(rlen, WINDOW)
    m_ok = act & (ad.alen <= rlen) & (end > ad.alen)
    W = WINDOW - ad.alen + 1
    mm = segments(ad.mm, base, np.where(m_ok, end - ad.alen + 1, 0), W)
    hit = mm <= ad.thr
    has_hit = m_ok & hit.any(1)
    last_hit = W - 1 - np.argmax(hit[:, ::-1], 1)
    best = np.argmin(mm, 1)
    need = np.flatnonzero(m_ok & ~has_hit)
    ok = np.zeros(R, bool)
    ok[need] = verify_at(fq, ad, base[need] + best[need])
    mpos = np.where(has_hit, last_hit, np.where(ok, best, -1))
    found = mpos >= 0
    mp = np.minimum(mpos + ext, rlen - ad.alen)
    t = np.where(found, mp + ad.alen, t)
    front = np.where(found, np.minimum(rlen - 1, mp + ad.alen), front)
    rec = np.where(found, ad.alen, rec)

    plen = ad.plen
    npos = np.minimum(rlen - plen, WINDOW - plen)
    fb = np.flatnonzero(act & ~found & (npos > 0))
    if len(fb):
        p = np.arange(WINDOW - PATTERN_LEN)
        eds = partial_windows(fq, ad, base[fb, None] + p, npos[fb],
                              ad.seq[ad.alen - plen:])
        eds = np.where(eds <= ad.pthr, eds, BIG)
        cand = eds.min(1) < BIG
        fb, pos = fb[cand], np.argmin(eds[cand], 1)
        cmplen = np.minimum(pos + plen, ad.alen)
        good = eds_within(fq, lambda n: ad.seq[ad.alen - n:],
                          base[fb] + pos + plen - cmplen, cmplen,
                          lambda n: cpp_round(ad.ed_max * n))
        fb, pos, cmplen = fb[good], pos[good], cmplen[good]
        pp = np.minimum(pos + ext, rlen[fb] - ad.alen)
        t[fb] = pp + plen
        front[fb] = np.minimum(rlen[fb] - 1, pp + plen)
        rec[fb] = cmplen
    return t, front, rec


def trim_end(fq, base, rlen, ad, ext, act):
    """trimBySequenceEnd: (trimmed count, new length, recorded adapter
    length) per read."""
    R = len(base)
    t = np.zeros(R, np.int64)
    new_len = rlen.copy()
    rec = np.zeros(R, np.int64)
    act = act & (rlen >= PATTERN_LEN)
    start = np.maximum(0, rlen - WINDOW)
    cnt = rlen - ad.alen - start
    m_ok = act & (start + ad.alen <= rlen) & (cnt > 0)
    W = WINDOW
    mm = segments(ad.mm, base + start, np.where(m_ok, cnt, 0), W)
    hit = mm <= ad.thr
    has_hit = m_ok & hit.any(1)
    first_hit = np.argmax(hit, 1)
    best = W - 1 - np.argmin(mm[:, ::-1], 1)
    need = np.flatnonzero(m_ok & ~has_hit)
    ok = np.zeros(R, bool)
    ok[need] = verify_at(fq, ad, base[need] + start[need] + best[need])
    mpos = np.where(has_hit, start + first_hit,
                    np.where(ok, start + best, -1))
    found = mpos >= 0
    mp = np.maximum(0, mpos - ext)
    t = np.where(found, rlen - mp, t)
    new_len = np.where(found, mp, new_len)
    rec = np.where(found, ad.alen, rec)

    plen = ad.plen
    npos = np.minimum(rlen - plen, WINDOW - plen)
    fb = np.flatnonzero(act & ~found & (npos > 0))
    if len(fb):
        p = np.arange(WINDOW - PATTERN_LEN)
        eds = partial_windows(fq, ad, (base + rlen - plen)[fb, None] - p,
                              npos[fb], ad.seq[:plen])
        rows, poss = [], []
        for i in np.flatnonzero((eds <= ad.pthr).any(1)).tolist():
            pos, mined = -1, -1
            for q, ed in enumerate(eds[i].tolist()):
                if ed <= ad.pthr:
                    if pos < 0 or ed <= mined:
                        pos, mined = q, ed
                    else:
                        break
            if pos > 0:
                rows.append(fb[i])
                poss.append(pos)
        fb = np.array(rows, np.int64)
        pos = np.array(poss, np.int64)
        cmplen = np.minimum(pos + plen, ad.alen)
        good = eds_within(fq, lambda n: ad.seq[:n],
                          base[fb] + rlen[fb] - plen - pos, cmplen,
                          lambda n: cpp_round(ad.ed_max * n))
        fb, pos, cmplen = fb[good], pos[good], cmplen[good]
        pp = np.minimum(pos + ext, rlen[fb] - plen)
        t[fb] = pp + plen
        new_len[fb] = rlen[fb] - plen - pp
        rec[fb] = cmplen
    return t, new_len, rec


def search_global(fq, base, rlen, ad, act):
    """searchAdapter over each whole span but its last position: the first
    position of the fewest mismatches, if within the threshold by edit
    distance; else -1."""
    cnt = rlen - ad.alen
    rows = np.flatnonzero(act & (cnt > 0))
    pos = np.full(len(base), -1, np.int64)
    best = np.array([int(np.argmin(ad.mm[b:b + c])) for b, c in
                     zip(base[rows].tolist(), cnt[rows].tolist())], np.int64)
    ok = verify_at(fq, ad, base[rows] + best) if len(rows) else best > 0
    pos[rows[ok]] = best[ok]
    return pos


def middle_adapters(fq, base, rlen, s_ad, e_ad, ext, act):
    """findMiddleAdapters: (found, start, length) of the adapter stretch
    relative to each span."""
    sp = search_global(fq, base, rlen, s_ad, act)
    ep = search_global(fq, base, rlen, e_ad, act)
    both = (sp >= 0) & (ep >= 0)
    s_only = (sp >= 0) & (ep < 0)
    e_only = (ep >= 0) & (sp < 0)
    start = np.where(both, np.maximum(0, np.minimum(sp, ep) - ext),
                     np.where(s_only, np.maximum(0, sp - ext),
                              np.maximum(0, ep - ext)))
    end = np.where(both, np.minimum(rlen, np.maximum(sp + s_ad.alen,
                                                     ep + e_ad.alen) + ext),
                   np.where(s_only, np.minimum(rlen, sp + s_ad.alen + ext),
                            np.minimum(rlen, ep + e_ad.alen + ext)))
    found = both | s_only | e_only
    return found, start, end - start


# ------------------------------------------------------- quality and polyX


def trim_and_cut(raw, so, qo, n, p):
    """trimAndCut with no fixed front or tail trim: the (lo, hi) span the
    sliding-window cuts leave, or None for a read they empty."""
    ef, et = p["cut_front"], p["cut_tail"]
    if not ef and not et:
        return 0, n
    front = 0
    if ef:
        w = p["cut_window"]
        thr = (33 + p["cut_quality"]) * w
        if n - w <= 0:
            return None
        total = sum(raw[qo:qo + w - 1])
        s = 0
        while s + w < n:
            total += raw[qo + s + w - 1]
            if s > 0:
                total -= raw[qo + s - 1]
            if total >= thr:
                break
            s += 1
        if s > 0:
            s = s + w - 1
        while s < n and raw[so + s] == 78:
            s += 1
        front = s
    rlen = n - front
    if et:
        w = p["cut_window"]
        thr = (33 + p["cut_quality"]) * w
        if n - front - w <= 0:
            return None
        t = n - 1
        total = sum(raw[qo + t - i] for i in range(w - 1))
        while t - w >= front:
            total += raw[qo + t - w + 1]
            if t < n - 1:
                total -= raw[qo + t + 1]
            if total >= thr:
                break
            t -= 1
        if t < n - 1:
            t = t - w + 1
        while t >= 0 and raw[so + t] == 78:
            t -= 1
        rlen = t - front + 1
    if rlen <= 0 or front >= n - 1:
        return None
    return front, front + rlen


_POLY_CODE = {65: 0, 84: 1, 67: 2, 71: 3}


def trim_polyx(raw, so, lo, hi, min_len):
    """PolyX::trimPolyX on [lo, hi): (new hi, base index or -1, trimmed)."""
    rlen = hi - lo
    counts = [0, 0, 0, 0]
    pos = 0
    while pos < rlen:
        c = raw[so + hi - pos - 1]
        if c == 78:
            for b in range(4):
                counts[b] += 1
        elif c in _POLY_CODE:
            counts[_POLY_CODE[c]] += 1
        cmp = pos + 1
        allowed = min(5, cmp // 8)
        if (all(cmp - counts[b] > allowed for b in range(4))
                and (pos >= 8 or pos + 1 >= min_len - 1)):
            break
        pos += 1
    if pos + 1 < min_len:
        return hi, -1, 0
    poly = max(range(4), key=lambda b: (counts[b], -b))
    pb = b"ATCG"[poly]
    while pos >= 0 and (pos >= rlen or raw[so + hi - pos - 1] != pb):
        pos -= 1
    return hi - (pos + 1), poly, pos + 1


# ------------------------------------------------------- auto-detection


def _codes(arr):
    lut = np.full(256, -1, np.int8)
    for c, v in ((b"A", 0), (b"T", 1), (b"U", 1), (b"C", 2), (b"G", 3)):
        lut[c[0]] = v
    return lut[arr]


def kmer_counts(fq, end_side, shift_tail=1):
    """(counts, position sums, valid windows) of the 10-mers in each
    sampled read's first (start side) or last (end side) 128 window
    positions, the last `shift_tail` bases left out."""
    lens = fq.lens
    last = lens - KEYLEN - shift_tail
    if end_side:
        sp = np.maximum(0, last - 128)
        npos = np.minimum(last - sp + 1, 129)
    else:
        sp = np.zeros_like(last)
        npos = np.minimum(last + 1, 128)
    npos = np.where(last < 0, 0, npos)
    width = 129 + KEYLEN
    col = np.arange(width)
    idx = fq.seq_off[:, None] + sp[:, None] + col
    inside = col < (npos + KEYLEN - 1)[:, None]
    codes = np.where(inside, _codes(fq.arr[np.where(inside, idx, 0)]), -1)
    codes = codes.astype(np.int64)
    key = np.zeros((fq.n, 129), np.int64)
    valid = np.ones((fq.n, 129), bool)
    for i in range(KEYLEN):
        c = codes[:, i:i + 129]
        key = (key << 2) + np.maximum(c, 0)
        valid &= c >= 0
    valid &= np.arange(129) < npos[:, None]
    pos = sp[:, None] + np.arange(129)
    weight = (lens[:, None] - pos) if end_side else pos
    k = key[valid]
    counts = np.bincount(k, minlength=KEYSPACE).astype(np.int64)
    posacc = np.bincount(k, weights=weight[valid].astype(np.float64),
                         minlength=KEYSPACE)
    return counts, posacc, int(valid.sum())


def top_key(counts):
    """Evaluator::getTopKey: the most frequent key that passes the
    complexity gates, or -1.  Its `diff` gate reads the bits of the count,
    as the Evaluator does."""
    k = np.arange(KEYSPACE, dtype=np.int64)
    base = [(k >> (2 * i)) & 3 for i in range(KEYLEN)]
    atcg = [sum((b == v).astype(np.int64) for b in base) for v in range(4)]
    skip = np.zeros(KEYSPACE, bool)
    for a in atcg:
        skip |= a >= KEYLEN - 4
    skip |= sum((a == 0).astype(np.int64) for a in atcg) >= 2
    skip |= (k >> KEYLEN) == (k & ((1 << KEYLEN) - 1))
    diff = np.zeros(KEYSPACE, np.int64)
    for s in range(KEYLEN - 1):
        cur = (counts >> ((KEYLEN - s) * 2)) & 3
        prev = (counts >> ((KEYLEN - s - 1) * 2)) & 3
        diff += cur != prev
    skip |= diff < 3
    skip |= (atcg[2] + atcg[3]) >= KEYLEN - 2
    skip |= (k >> 12) == 0xFF
    skip |= k == 0
    masked = np.where(skip, 0, counts)
    best = int(np.argmax(masked))
    return best if masked[best] > 0 else -1


def key_seq(key, n=KEYLEN):
    return "".join("ATCG"[(key >> (2 * (n - 1 - i))) & 3] for i in range(n))


def extend_key(key, counts, posacc):
    """Evaluator::extendKeyToAdapter: grow the key base by base to the left
    and right while one extension holds 70% of the four and half the seed's
    count, at a mean position that moves by -4 to +2."""
    adapter = key_seq(key)
    mask = KEYSPACE - 1
    seed_count = int(counts[key])
    done = {True: False, False: False}
    left = True
    while True:
        cur = key
        while len(adapter) < MAX_ADAPTER_LEN:
            if left:
                nks = [(b << (2 * (KEYLEN - 1))) | (cur >> 2) for b in range(4)]
            else:
                nks = [b | (mask & (cur << 2)) for b in range(4)]
            total = sum(int(counts[x]) for x in nks)
            grown = False
            for b, nk in enumerate(nks):
                c = int(counts[nk])
                if c == 0:
                    continue
                offset = (float(posacc[nk]) / c
                          - float(posacc[cur]) / int(counts[cur]))
                if c / total < 0.7 or c / seed_count < 0.5:
                    continue
                if offset > 2 or offset < -4:
                    continue
                cur = nk
                grown = True
                adapter = ("ATCG"[b] + adapter) if left else (adapter + "ATCG"[b])
                break
            if not grown:
                done[left] = True
                break
            if len(adapter) == MAX_ADAPTER_LEN:
                done[True] = done[False] = True
                break
        left = not left
        if done[True] and done[False]:
            return adapter


def detect_adapter(fq, end_side):
    """Auto-detection of one side: the adapter, or None where it finds
    none or only a short one."""
    counts, posacc, total = kmer_counts(fq, end_side)
    total_key = int((counts > 0).sum())
    counts[0] = 0
    key = top_key(counts)
    count = int(counts[key]) if key >= 0 else 0
    if not (count > 10 and count * total_key > total * FOLD_THRESHOLD):
        return None
    adapter = extend_key(key, counts, posacc)
    return adapter if len(adapter) > 16 else None


# -------------------------------------------------------------- the file


def expected(raw, params, device="cpu", control=None):
    """Everything the program should produce for one input file: a dict
    with `stream` (the passing reads' bytes), `adapters` (start, end), and
    `report` (the JSON report's fields that are compared).

    control, for the check of the check only: "no_middle" leaves out the
    middle-adapter split (the step a faster program might be tempted to
    skip), which breaks the exact-output guarantee."""
    fq = Fastq(raw, device)
    p = params
    if p["trim_front"] or p["trim_tail"]:
        raise NotModelled("fixed front or tail trimming")
    if p.get("low_complexity_filter"):
        raise NotModelled("the low-complexity filter")
    if any(b"U" in fq.raw[int(fq.seq_off[r]):int(fq.seq_off[r] + fq.lens[r])]
           for r in range(min(fq.n, 100))):
        raise NotModelled("RNA reads")

    start_seq, end_seq = p["start_adapter"], p["end_adapter"]
    if p["adapter_trimming"] and "auto" in (start_seq, end_seq):
        if fq.n >= SAMPLE_READS or int(fq.lens.sum()) >= SAMPLE_BASES:
            raise NotModelled("a file larger than auto-detection's sample")
        # a side where auto-detection finds none, or only a short one,
        # keeps the literal "auto" as its adapter, as fastplong does: it
        # matches no read of A, C, G, T and N, and is reported "unspecified"
        if fq.n >= 100:
            if start_seq == "auto":
                start_seq = detect_adapter(fq, end_side=False) or "auto"
            if end_seq == "auto":
                end_seq = detect_adapter(fq, end_side=True) or "auto"
    ads = None
    if p["adapter_trimming"]:
        ads = (Adapter(start_seq, p["ed_max"], fq),
               Adapter(end_seq, p["ed_max"], fq))
    ext = p["trimming_extension"]

    raw = fq.raw
    so_all = fq.seq_off
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
    trimmed_reads = trimmed_bases = 0
    recorded = {}
    split = np.zeros(fq.n, bool)
    left = right = None
    if ads is not None:
        t1, front, rec1 = trim_start(fq, so_all + lo, hi - lo, ads[0], ext, live)
        lo = lo + np.where(live, front, 0)
        t2, new_len, rec2 = trim_end(fq, so_all + lo, hi - lo, ads[1], ext, live)
        hi = np.where(live, lo + new_len, hi)
        t_total = np.where(live, t1 + t2, 0)
        trimmed_reads = int((t_total > 0).sum())
        trimmed_bases = int(t_total.sum())
        for rec, name in ((rec1, lambda n: ads[0].seq[ads[0].alen - n:]),
                          (rec2, lambda n: ads[1].seq[:n])):
            vals, counts = np.unique(rec[live & (rec > 0)], return_counts=True)
            for v, c in zip(vals.tolist(), counts.tolist()):
                k = name(v).decode()
                recorded[k] = recorded.get(k, 0) + c
        if control != "no_middle":
            split, mstart, mlen = middle_adapters(
                fq, so_all + lo, hi - lo, ads[0], ads[1], ext, live)
            left = split & (mstart > 0)
            right = split & (hi - lo - mstart - mlen > 0)
    # out-reads in output order: a read's own span, or its left and right
    # pieces around a middle adapter
    slots = []        # (read, lo, hi, tag)
    for r in np.flatnonzero(live).tolist():
        if not split[r]:
            slots.append((r, int(lo[r]), int(hi[r]), b""))
            continue
        if left[r]:
            slots.append((r, int(lo[r]), int(lo[r] + mstart[r]), TAG_LEFT))
        if right[r]:
            slots.append((r, int(lo[r] + mstart[r] + mlen[r]), int(hi[r]),
                          TAG_RIGHT))

    # filters on every out-read
    rd = np.array([s[0] for s in slots], np.int64)
    s_lo = np.array([s[1] for s in slots], np.int64)
    s_hi = np.array([s[2] for s in slots], np.int64)
    q_a = fq.qual_off[rd] + s_lo if len(slots) else rd
    s_a = fq.seq_off[rd] + s_lo if len(slots) else rd
    ln = s_hi - s_lo
    low = fq.span_sums(lambda x: x < 33 + p["qualified_quality"], q_a, ln)
    nb = fq.span_sums(lambda x: x == ord("N"), s_a, ln)
    code = np.full(len(slots), PASS, np.int64)
    if p["quality_filtering"]:
        bad_q = low > p["unqualified_percent_limit"] * ln / 100.0
        if p["mean_qual"] > 0:
            tq = fq.span_sums(lambda x: x, q_a, ln) - 33 * ln
            bad_q |= tq // np.maximum(ln, 1) < p["mean_qual"]
        bad_n = nb * 100 > ln * p["n_percent_limit"]
        if p["n_base_limit"] != 1000000:
            bad_n |= nb > p["n_base_limit"]
        code = np.where(bad_q, FAIL_QUALITY, np.where(bad_n, FAIL_N_BASE, code))
    if p["length_filtering"]:
        short = ln < p["length_required"]
        long_ = (ln > p["length_limit"]) if p["length_limit"] > 0 else short & False
        code = np.where(code != PASS, code,
                        np.where(short, FAIL_LENGTH,
                                 np.where(long_, FAIL_TOO_LONG, PASS)))
    code = np.where(ln == 0, FAIL_LENGTH, code)
    passed = code == PASS

    # the stream
    parts = []
    for i in np.flatnonzero(passed).tolist():
        r, a, b, tag = slots[i]
        no, nl = int(fq.name_off[r]), int(fq.name_len[r])
        so, qo = int(fq.seq_off[r]), int(fq.qual_off[r])
        st, sl = int(fq.strand_off[r]), int(fq.strand_len[r])
        parts.append(b"@" + tag + raw[no + 1:no + nl] + b"\n"
                     + raw[so + a:so + b] + b"\n" + raw[st:st + sl] + b"\n"
                     + raw[qo + a:qo + b] + b"\n")
    stream = b"".join(parts)

    # statistics
    pre = _side_stats(fq, fq.seq_off, fq.qual_off, fq.lens)
    post = _side_stats(fq, s_a[passed], q_a[passed], ln[passed])
    report = {
        "summary.before_filtering": pre["summary"],
        "summary.after_filtering": post["summary"],
        "read_before_filtering.total_cycles": pre["cycles"],
        "read_after_filtering.total_cycles": post["cycles"],
        "filtering_result": {
            "passed_filter_reads": int((code == PASS).sum()),
            "low_quality_reads": int((code == FAIL_QUALITY).sum()),
            "too_many_N_reads": int((code == FAIL_N_BASE).sum()),
            "too_short_reads": int((code == FAIL_LENGTH).sum()),
            "too_long_reads": int((code == FAIL_TOO_LONG).sum())},
    }
    if ads is not None:
        report["adapter_cutting"] = {
            "adapter_trimmed_reads": trimmed_reads,
            "adapter_trimmed_bases": trimmed_bases,
            "read_start_adapter": reported(start_seq),
            "read_end_adapter": reported(end_seq),
            "read_adapter_counts": _adapter_counts(recorded)}
    if p["polyx"]:
        report["polyx_trimming"] = {
            "total_polyx_trimmed_reads": int(poly_reads.sum()),
            "polyx_trimmed_reads": dict(zip("ATCG", poly_reads.tolist())),
            "total_polyx_trimmed_bases": int(poly_bases.sum()),
            "polyx_trimmed_bases": dict(zip("ATCG", poly_bases.tolist()))}
    return {"stream": stream, "records": int(passed.sum()),
            "adapters": (reported(start_seq), reported(end_seq)),
            "report": report,
            "null_reads": int(null.sum()), "middle_splits": int(split.sum()),
            "bases": int(fq.lens.sum())}


def reported(adapter):
    """An adapter as the JSON report names it."""
    return "unspecified" if adapter in ("", "auto") else adapter


def _side_stats(fq, s_a, q_a, ln):
    """The report's summary of one side from its spans of bases and
    qualities."""
    reads = len(ln)
    bases = int(ln.sum())
    q20 = int(fq.span_sums(lambda x: x >= 33 + 20, q_a, ln).sum())
    q30 = int(fq.span_sums(lambda x: x >= 33 + 30, q_a, ln).sum())
    gc = int(fq.span_sums(lambda x: (x == ord("G")) | (x == ord("C")),
                          s_a, ln).sum())

    def rate(a, b):
        return float("%g" % (0.0 if b == 0 else a / b))

    return {"summary": {
        "total_reads": reads, "total_bases": bases,
        "q20_bases": q20, "q30_bases": q30,
        "q20_rate": rate(q20, bases), "q30_rate": rate(q30, bases),
        "read_mean_length": 0 if reads == 0 else bases // reads,
        "gc_content": rate(gc, bases)},
        "cycles": int(ln.max()) if reads else 0}


def _adapter_counts(recorded):
    """The report's read_adapter_counts: sequences ordered by length, then
    text; those under 1% of the total folded into "others"."""
    items = sorted(recorded.items(), key=lambda kv: (len(kv[0]), kv[0]))
    total = sum(v for _, v in items)
    out = {}
    for s, v in items:
        if total and v / total >= 0.01:
            out[s] = v
    rest = total - sum(out.values())
    if rest > 0:
        out["others"] = rest
    return out
