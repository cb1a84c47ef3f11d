"""Traffic generator: Nanopore-like FASTQ files from a mix's parameters and a
seed.

The read model is Badread's (Wick 2019, JOSS 4:1316; its defaults as its
README gives them), one parameter of the mix each:

* fragment lengths: a gamma distribution of mean `length_mean` and standard
  deviation `length_sd`;
* read identities: `identity_max` times a beta distribution, of mean
  `identity_mean` and standard deviation `identity_sd` (in percent);
* a start adapter in `start_rate` % of the reads, of which a share drawn
  from a beta distribution of mean `start_amount` % is present (its end,
  next to the insert); an end adapter in `end_rate` % of the reads, of which
  a share of mean `end_amount` % is present (its start);
* `chimeras` % of the reads join two fragments, with the first's end
  adapter and the second's start adapter between them by the same rates;
* `junk_reads` % of the reads are low-complexity junk (a short random
  k-mer repeated);
* glitches, one every `glitch_rate` bases on average, each `glitch_size`
  bases of random sequence (mean) in place of `glitch_skip` bases (mean);
* sequencing errors at each adapter base by the read's identity
  (substitution, insertion or deletion alike, an assumption of the mix).

Inserts are uniform ACGT: no reference genome is at hand, and Badread's own
random reads are made so.  Errors inside an insert of random bases cannot be
told from the insert, so only the qualities carry them: each base's Phred
quality is -10 log10 of its error probability, the read's error rate (1 -
identity; 3/4 inside a glitch, a random base) times an exponential factor of
mean 1 (the mix's `assumed` entries), rounded and capped at its
`qual_max`.

What the seed changes and what it does not: each read's structure (the
lengths of its fragments, its identity, its adapter pieces with their
errors, its glitches, whether it is junk or a chimera) comes from the mix's
fixed `sizes_seed` and the file's index, so every seed gives the same set of
sizes; the seed permutes the reads of each file and draws every insert base
and every quality.  The work per file is then the same for every seed.
"""

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
BYTE_TO_BASE = np.resize(ACGT, 256)     # a uniform byte to a uniform base
QBLOCK = 1 << 24          # bases a block when drawing qualities


def _beta_ab(mean, sd):
    """Beta parameters (a, b) of a mean and standard deviation on [0, 1]."""
    k = mean * (1 - mean) / (sd * sd) - 1
    return mean * k, (1 - mean) * k


def _mutate(rng, seq, err):
    """seq (bytes) with each base, at probability err, substituted, deleted
    or preceded by an inserted base (each alike)."""
    out = bytearray()
    hit = rng.random(len(seq)) < err
    kind = rng.integers(0, 3, len(seq))
    alt = rng.integers(0, 4, len(seq))
    for i, c in enumerate(seq):
        if not hit[i]:
            out.append(c)
        elif kind[i] == 0:
            out.append(b"ACGT"[(b"ACGT".index(c) + 1 + alt[i] % 3) % 4])
        elif kind[i] == 2:
            out.append(int(ACGT[alt[i]]))
            out.append(c)
    return bytes(out)


class Plan:
    """The structure of each read of one file: its pieces in order (an
    adapter piece as bytes, an insert as its length), its glitches as
    (offset, length) in the read, its junk k-mer length (0: none) and its
    error rate."""

    def __init__(self, pieces, glitches, junk, err):
        self.pieces, self.glitches, self.junk, self.err = (
            pieces, glitches, junk, np.asarray(err, np.float64))
        self.lens = np.array([sum(p if isinstance(p, int) else len(p)
                                  for p in ps) for ps in pieces], np.int64)

    def take(self, idx):
        idx = [int(i) for i in idx]
        return Plan([self.pieces[i] for i in idx],
                    [self.glitches[i] for i in idx],
                    [self.junk[i] for i in idx], self.err[idx])

    @staticmethod
    def concat(plans):
        return Plan(sum((p.pieces for p in plans), []),
                    sum((p.glitches for p in plans), []),
                    sum((p.junk for p in plans), []),
                    np.concatenate([p.err for p in plans]))


def file_plan(mix, index):
    """The Plan of file `index`, fixed by the mix alone."""
    rng = np.random.default_rng([int(mix["sizes_seed"]), int(index)])
    n = int(mix["reads_per_file"])
    mean, sd = float(mix["length_mean"]), float(mix["length_sd"])
    shape, scale = (mean / sd) ** 2, sd * sd / mean
    imax = float(mix["identity_max"]) / 100
    ia, ib = _beta_ab(float(mix["identity_mean"]) / 100 / imax,
                      float(mix["identity_sd"]) / 100 / imax)
    conc = float(mix["assumed"]["adapter_amount_concentration"])
    s_ad = mix["start_adapter"].encode()
    e_ad = mix["end_adapter"].encode()
    kmax = int(mix["assumed"]["junk_kmer_max"])

    def piece(seq, rate, amount, err, keep_end):
        if rng.random() * 100 >= rate:
            return b""
        m = amount / 100
        f = rng.beta(m * conc, (1 - m) * conc)
        k = int(round(f * len(seq)))
        part = seq[len(seq) - k:] if keep_end else seq[:k]
        return _mutate(rng, part, err)

    def fragment():
        frag = max(1, int(rng.gamma(shape, scale)))
        g = rng.poisson(frag / float(mix["glitch_rate"]))
        size = rng.geometric(1 / float(mix["glitch_size"]), g)
        skip = rng.geometric(1 / float(mix["glitch_skip"]), g)
        n_ins = max(1, frag + int(size.sum()) - int(skip.sum()))
        spans = []
        for s in size.tolist():
            s = min(s, n_ins)
            spans.append((int(rng.integers(0, n_ins - s + 1)), s))
        return n_ins, spans

    pieces, glitches, junk, err = [], [], [], []
    for _ in range(n):
        e = 1 - imax * rng.beta(ia, ib)
        chimera = rng.random() * 100 < float(mix["chimeras"])
        is_junk = rng.random() * 100 < float(mix["junk_reads"])
        ps, gl, off = [], [], 0
        frags = 2 if chimera else 1
        for f in range(frags):
            head = piece(s_ad, float(mix["start_rate"]),
                         float(mix["start_amount"]), e, True)
            ps.append(head)
            off += len(head)
            n_ins, spans = fragment()
            ps.append(n_ins)
            gl += [(off + a, s) for a, s in spans]
            off += n_ins
            tail = piece(e_ad, float(mix["end_rate"]),
                         float(mix["end_amount"]), e, False)
            ps.append(tail)
            off += len(tail)
        pieces.append(ps)
        glitches.append(gl)
        junk.append(int(rng.integers(1, kmax + 1)) if is_junk else 0)
        err.append(e)
    return Plan(pieces, glitches, junk, err)


def warm_plan(mix, plans=None, count=16, stride=16):
    """The warm-up file's reads: every `stride`-th read of file 0 and the
    `count` longest reads of each file, so that the warm-up meets every
    length bucket that the window's reads fall in; `plans` are the files'
    plans where they are at hand."""
    if plans is None:
        plans = [file_plan(mix, i) for i in range(int(mix["files"]))]
    parts = [plans[0].take(range(0, len(plans[0].lens), stride))]
    for plan in plans:
        parts.append(plan.take(np.argsort(plan.lens, kind="stable")[-count:]))
    return Plan.concat(parts)


def file_bytes(mix, index, seed, plan=None):
    """The FASTQ bytes of file `index` of the mix for `seed`; index -1 is
    the warm-up file.  `plan` is the file's plan where it is at hand."""
    if plan is None:
        plan = warm_plan(mix) if index < 0 else file_plan(mix, index)
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), int(index) + 1])
    return render(mix, plan, rng)


# -10 log10 of an exponential variate of mean 1, by 16 bits of a uniform one
_GUMBEL = (-10 * np.log10(-np.log((np.arange(1 << 16) + 0.5) / (1 << 16)))
           ).astype(np.float32)


def render(mix, plan, rng):
    """FASTQ bytes of the plan's reads, in an order and with insert bases
    and qualities drawn from rng."""
    order = rng.permutation(len(plan.lens))
    plan = plan.take(order)
    lens = plan.lens
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    total = int(off[-1])
    seq = BYTE_TO_BASE[np.frombuffer(rng.bytes(total), np.uint8)]
    qe = np.repeat((-10 * np.log10(plan.err)).astype(np.float32), lens)
    q_glitch = np.float32(-10 * np.log10(0.75))
    for r in range(len(lens)):
        p = int(off[r])
        kmer = (ACGT[rng.integers(0, 4, plan.junk[r])] if plan.junk[r]
                else None)
        for piece in plan.pieces[r]:
            if isinstance(piece, int):
                if kmer is not None:
                    seq[p:p + piece] = np.resize(kmer, piece)
                p += piece
            else:
                seq[p:p + len(piece)] = np.frombuffer(piece, np.uint8)
                p += len(piece)
        for a, s in plan.glitches[r]:
            qe[int(off[r]) + a:int(off[r]) + a + s] = q_glitch
    qual = np.empty(total, np.uint8)
    qmax = float(mix["assumed"]["qual_max"])
    for a in range(0, total, QBLOCK):
        b = min(total, a + QBLOCK)
        q = qe[a:b] + _GUMBEL[rng.integers(0, 1 << 16, b - a, np.uint16)]
        np.rint(q, out=q)
        np.clip(q, 0, qmax, out=q)
        qual[a:b] = q.astype(np.uint8) + 33
    del qe
    heads = [b"@read%d\n" % i for i in range(len(lens))]
    hlen = np.fromiter(map(len, heads), np.int64, len(heads))
    rec = hlen + 2 * lens + 4
    roff = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(rec, out=roff[1:])
    buf = np.empty(int(roff[-1]), np.uint8)
    hdr = np.frombuffer(b"".join(heads), np.uint8)
    hoff = np.concatenate(([0], np.cumsum(hlen)))
    for i in range(len(lens)):
        p, h, n, s = int(roff[i]), int(hlen[i]), int(lens[i]), int(off[i])
        buf[p:p + h] = hdr[hoff[i]:hoff[i] + h]
        p += h
        buf[p:p + n] = seq[s:s + n]
        p += n
        buf[p:p + 3] = (10, 43, 10)
        p += 3
        buf[p:p + n] = qual[s:s + n]
        buf[p + n] = 10
    return buf


def write_files(mix, seed, directory):
    """Write the mix's files and its warm-up file into `directory`, each
    flushed to the disk before it returns (so that no write-back of them
    runs later, inside the window); returns (list of (path, bases)),
    (warm path, warm bases)."""
    out = []
    plans = [file_plan(mix, i) for i in range(int(mix["files"]))]
    plans.append(warm_plan(mix, plans))
    for i in list(range(int(mix["files"]))) + [-1]:
        buf = file_bytes(mix, i, seed, plans[i])
        path = os.path.join(directory, "warm.fq" if i < 0 else "in%02d.fq" % i)
        with open(path, "wb") as f:
            f.write(memoryview(buf))
            f.flush()
            os.fsync(f.fileno())
        out.append((path, count_bases(buf)))
    return out[:-1], out[-1]


def count_bases(buf):
    """Bases of a FASTQ buffer of 4-line records: the lengths of its
    sequence lines."""
    nl = np.flatnonzero(buf == 10)
    return int((nl[1::4] - nl[0::4] - 1).sum())
