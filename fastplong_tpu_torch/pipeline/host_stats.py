"""Host-side per-read statistics.

Two routes stat reads here rather than on the device, with the arithmetic
of ops/stats_kernels.stat_batch, which mirrors the reference
Stats::statRead (src/stats.cpp:265-375): --stats_backend host
(BatchStatAccumulator, a native pass over whole packed batches, and
HostStatAccumulator for its monster batches), and a monster batch (a
bucket over stat_device_cap()) whose device accumulator would pass its
memory ceiling (pipeline/runner.py; reads of tens of Mbp), statted read
by read with HostStatAccumulator.  Under --stats_backend auto or device
every other monster bucket is statted on the device.

The per-cycle scatter uses plain fancy-indexed `+=`: within ONE read every
(base-bucket, position) pair is unique, so there are no collisions.
"""

import numpy as np

Q20 = ord("5")
Q30 = ord("?")

_CODE = np.full(256, -1, np.int8)
for _c, _v in ((ord("A"), 0), (ord("T"), 1), (ord("U"), 1),
               (ord("C"), 2), (ord("G"), 3)):
    _CODE[_c] = _v

_STAT_KEYS = ("cycle_q20", "cycle_q30", "cycle_content", "cycle_qual",
              "cycle_total_base", "cycle_total_qual", "base_qual_hist",
              "kmer")



class HostStatAccumulator:
    """Accumulates statRead partials for a group of (usually 1-8) reads."""

    def __init__(self):
        self.L = 0
        self.p = None

    def _ensure(self, n):
        if self.p is None:
            self.p = {
                "cycle_q20": np.zeros((8, n), np.int64),
                "cycle_q30": np.zeros((8, n), np.int64),
                "cycle_content": np.zeros((8, n), np.int64),
                "cycle_qual": np.zeros((8, n), np.int64),
                "cycle_total_base": np.zeros(n, np.int64),
                "cycle_total_qual": np.zeros(n, np.int64),
                "base_qual_hist": np.zeros(128, np.int64),
                "kmer": np.zeros(1024, np.int64),
            }
            self.L = n
            return
        if n > self.L:
            for k in ("cycle_q20", "cycle_q30", "cycle_content",
                      "cycle_qual"):
                buf = np.zeros((8, n), np.int64)
                buf[:, :self.L] = self.p[k]
                self.p[k] = buf
            for k in ("cycle_total_base", "cycle_total_qual"):
                buf = np.zeros(n, np.int64)
                buf[:self.L] = self.p[k]
                self.p[k] = buf
            self.L = n

    def add_read(self, b, q):
        """b, q: np.uint8 arrays of one read's bases/qualities (the span
        to stat, already masked with N where applicable)."""
        n = len(b)
        if n == 0:
            return
        self._ensure(n)
        p = self.p
        idx = np.arange(n)
        bucket = (b & 0x07).astype(np.int64)
        q33 = q.astype(np.int64) - 33
        q20m = q >= Q20
        q30m = q >= Q30
        p["cycle_content"][bucket, idx] += 1
        p["cycle_qual"][bucket, idx] += q33
        p["cycle_q20"][bucket[q20m], idx[q20m]] += 1
        p["cycle_q30"][bucket[q30m], idx[q30m]] += 1
        p["cycle_total_base"][:n] += 1
        p["cycle_total_qual"][:n] += q33
        p["base_qual_hist"] += np.bincount(np.minimum(q, 127).astype(np.int64),
                                           minlength=128)
        if n >= 5:
            code = _CODE[b].astype(np.int64)
            key = ((code[:-4] << 8) | (code[1:-3] << 6) | (code[2:-2] << 4)
                   | (code[3:-1] << 2) | code[4:])
            kvalid = ((code[:-4] >= 0) & (code[1:-3] >= 0) & (code[2:-2] >= 0)
                      & (code[3:-1] >= 0) & (code[4:] >= 0))
            if kvalid.any():
                p["kmer"] += np.bincount(key[kvalid], minlength=1024)

    def partial(self):
        """The accumulated partial dict (or None if nothing was added)."""
        return self.p


class BatchStatAccumulator:
    """Vectorized/native statRead over whole packed batches — the host-
    statistics mode (FASTPLONG_STATS=host).  On hosts with a weak device
    link, shipping the per-cycle accumulators device->host costs more than
    recomputing them here: the native single pass (native/host_io.cpp
    fpl_stat_rows) runs at memory speed (~10ms per 8-Mbase batch).
    Arithmetic is identical to ops/stats_kernels.stat_batch.  Partials are
    produced in the drain layout (q20/q30 as per-base totals), consumed by
    Stats.add_device_partial."""

    def __init__(self, stat_L):
        self.L = stat_L
        self.cyc = np.zeros(stat_L * 18, np.int64)   # position-major [L,18]
        self.q20 = np.zeros(8, np.int64)
        self.q30 = np.zeros(8, np.int64)
        self.hist = np.zeros(128, np.int64)
        self.kmer = np.zeros(1024, np.int64)
        self.max_seen = 0
        self.used = False

    def add_rows(self, packed, L, lo, hi, mlo, mhi, rowmask, layout="wide"):
        """Accumulate spans of a packed batch (wide [B, 2L+8] or base5
        [B, L+8], pipeline/batches.py); returns the per-row median quality
        bytes."""
        medians = np.zeros(packed.shape[0], np.uint8)
        if hi is None or not len(hi):
            return medians
        self.used = True
        m = int(np.max(np.where(np.asarray(rowmask, bool), hi, 0))
                if rowmask is not None else hi.max())
        if m > self.max_seen:
            self.max_seen = min(m, self.L)
        from ..native import stat_rows
        if stat_rows(packed, L, layout == "b5", lo, hi, mlo, mhi, rowmask,
                     self.cyc, self.q20, self.q30, self.hist, self.kmer,
                     medians):
            return medians
        self._numpy_rows(packed, L, lo, hi, mlo, mhi, rowmask, medians,
                         layout)
        return medians

    def _numpy_rows(self, packed, L, lo, hi, mlo, mhi, rowmask, medians,
                    layout="wide"):
        """Pure-python fallback (slow; correctness only)."""
        b5 = layout == "b5"
        for i in range(packed.shape[0]):
            if rowmask is not None and not rowmask[i]:
                continue
            s = int(lo[i]) if lo is not None else 0
            e = min(int(hi[i]), L)
            if e <= s:
                continue
            if b5:
                from .batches import b5_decode
                b, q = b5_decode(packed[i, :L])
            else:
                b = packed[i, :L]
                q = packed[i, L:2 * L]
            if mlo is not None:
                seq = masked_span(b, s, e, mlo[i], mhi[i])
            else:
                seq = b[s:e]
            qs = q[s:e]
            n = e - s
            bucket = seq & 0x07
            pos = np.arange(n)
            qv = qs.astype(np.int64) - 33
            np.add.at(self.cyc, pos * 18 + bucket, 1)
            np.add.at(self.cyc, pos * 18 + 8 + bucket, qv)
            self.cyc[pos * 18 + 16] += 1
            self.cyc[pos * 18 + 17] += qv
            np.add.at(self.q20, bucket[qs >= Q20], 1)
            np.add.at(self.q30, bucket[qs >= Q30], 1)
            self.hist += np.bincount(np.minimum(qs, 127).astype(np.int64),
                                     minlength=128)
            if n >= 5:
                code = _CODE[seq].astype(np.int64)
                key = ((code[:-4] << 8) | (code[1:-3] << 6)
                       | (code[2:-2] << 4) | (code[3:-1] << 2) | code[4:])
                kvalid = ((code[:-4] >= 0) & (code[1:-3] >= 0)
                          & (code[2:-2] >= 0) & (code[3:-1] >= 0)
                          & (code[4:] >= 0))
                if kvalid.any():
                    self.kmer += np.bincount(key[kvalid], minlength=1024)
            medians[i] = median_qual(qs)

    def partial(self):
        """Drain-layout partial dict for Stats.add_device_partial, trimmed
        to the longest span seen; None if nothing was accumulated."""
        if not self.used:
            return None
        m = max(1, self.max_seen)
        cyc = self.cyc[:18 * m].reshape(m, 18)
        return {
            "cycle_content": cyc[:, 0:8].T.copy(),
            "cycle_qual": cyc[:, 8:16].T.copy(),
            "cycle_total_base": cyc[:, 16].copy(),
            "cycle_total_qual": cyc[:, 17].copy(),
            "q20_totals": self.q20,
            "q30_totals": self.q30,
            "base_qual_hist": self.hist,
            "kmer": self.kmer,
        }


def median_qual(q):
    """sorted[len >> 1] (reference stats.cpp:351-362); 0 for empty."""
    n = len(q)
    if n == 0:
        return 0
    return int(np.sort(q)[n >> 1])


def masked_span(seq, lo, hi, m_lo, m_hi):
    """seq[lo:hi] with [m_lo, m_hi) (absolute coords) replaced by N,
    mirroring maskRegionWithN (read.cpp:217-225)."""
    out = seq[lo:hi]
    a = max(lo, int(m_lo))
    b = min(hi, int(m_hi))
    if b > a:
        out = out.copy()
        out[a - lo:b - lo] = ord("N")
    return out
