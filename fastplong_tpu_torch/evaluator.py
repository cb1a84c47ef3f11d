"""Input evaluation pre-passes.

Host/numpy equivalent of the reference Evaluator (src/evaluator.cpp):
  * evaluate_seq_len_and_check_rna — first 100 reads -> max length, U-vs-T
    RNA detection (evaluator.cpp:16-61)
  * evaluate_read_num — sample <=512K reads, extrapolate the total from byte
    positions (evaluator.cpp:63-103)
  * eval_adapter_and_read_num — 10-mer histogram over 128bp end windows of
    <=64K reads, top-key selection with complexity gates, greedy consensus
    extension to <=64bp (evaluator.cpp:105-408)

The k-mer fill runs on the run's device (ops/kmer.py: the CUDA kernel
csrc/kmer_hist.cu on a card, its plain PyTorch version on the CPU); the top
key and the consensus extension stay on the host.  Thresholds replicate the
reference bit-for-bit, including its quirk of computing the `diff`
complexity gate on the COUNT value's bit pattern (evaluator.cpp:294-301
uses `val`, not `k`).
"""

import sys

import numpy as np

from . import resolve_device
from .io.fastq import FastqStreamReader
from .ops.kmer import kmer_histogram
from .spans import standalone
from .util import error_exit

KEYLEN = 10
KEYSPACE = 1 << (KEYLEN * 2)
FOLD_THRESHOLD = 100.0
MAX_ADAPTER_LEN = 64

_CODE = np.full(256, -1, np.int8)
for _c, _v in (("A", 0), ("T", 1), ("U", 1), ("C", 2), ("G", 3)):
    _CODE[ord(_c)] = _v


class _PrefixSample:
    """One sampled pass over the input prefix, shared by all pre-passes."""

    __slots__ = ("tag", "blocks", "records", "bases", "saw_eof",
                 "bytes_read", "bytes_total")

    def __init__(self, tag, blocks, records, bases, saw_eof, bytes_read,
                 bytes_total):
        self.tag = tag
        self.blocks = blocks          # [(RecordBlock, take)]
        self.records = records
        self.bases = bases
        self.saw_eof = saw_eof
        self.bytes_read = bytes_read
        self.bytes_total = bytes_total


class Evaluator:
    def __init__(self, opt, device=None, spans=None):
        """device: where the k-mer fill runs (resolve_device's rule);
        spans: the job's evaluator layer (spans.py), whose totals sum
        both sides of adapter detection."""
        self.opt = opt
        self.device = resolve_device(device)
        self.spans = spans or standalone()
        self._sample = None

    # ------------------------------------------------------ shared sample

    def load_prefix(self, detect: bool, readnum: bool):
        """Read the input prefix ONCE for every pre-pass that will run
        (SURVEY hard-part 6; the reference re-opens the file per pass,
        main.cpp:262-293).  The widest consumer decides the sample limits;
        each consumer then re-derives its numbers with its own arithmetic,
        so results are bit-identical to independent passes."""
        if detect:
            self._sample = self._read_prefix(
                "detect", 64 * 1024, 8192 * 64 * 1024, 16384, cap_take=True)
        elif readnum:
            self._sample = self._read_prefix(
                "readnum", 512 * 1024, 151 * 512 * 1024, 8192,
                cap_take=False)
        else:
            self._sample = self._read_prefix(
                "seqlen", 100, 1 << 62, 100, cap_take=False)

    def _read_prefix(self, tag, read_limit, base_limit, max_records,
                     cap_take):
        reader = FastqStreamReader(self.opt.in_file,
                                   max_records=max_records,
                                   prefix_only=True)
        blocks = []
        records = 0
        bases = 0
        saw_eof = False
        while records < read_limit and bases < base_limit:
            block = reader.next_block()
            if block is None:
                saw_eof = True
                break
            take = min(block.n, read_limit - records) if cap_take else block.n
            blocks.append((block, take))
            records += take
            bases += int(block.seq_len[:take].sum())
        bytes_read, bytes_total = reader.get_bytes()
        reader.close()
        return _PrefixSample(tag, blocks, records, bases, saw_eof,
                             bytes_read, bytes_total)

    # ----------------------------------------------------- seq len / RNA

    def evaluate_seq_len_and_check_rna(self):
        opt = self.opt
        if not opt.in_file:
            return
        if self._sample is not None and self._sample.blocks:
            block = self._sample.blocks[0][0]
        elif self._sample is not None:
            block = None
        else:
            reader = FastqStreamReader(opt.in_file, max_records=100,
                                       prefix_only=True)
            block = reader.next_block()
            reader.close()
        seqlen = 0
        num_t = 0
        num_u = 0
        if block is not None:
            n = min(block.n, 100)
            for i in range(n):
                s = block.seq(i)
                seqlen = max(seqlen, len(s))
                num_t += s.count(b"T")
                num_u += s.count(b"U")
        if num_t > 0 and num_u > 0:
            error_exit("This data contains both U and T")
        elif num_u > 0:
            opt.is_rna = True
            sys.stderr.write("RNA direct sequencing data\n")
        opt.seq_len = seqlen

    # -------------------------------------------------------- read count

    def evaluate_read_num(self) -> int:
        if self._sample is None or self._sample.tag != "readnum":
            self._sample = self._read_prefix(
                "readnum", 512 * 1024, 151 * 512 * 1024, 8192,
                cap_take=False)
        s = self._sample
        if s.saw_eof:
            return s.records
        if s.records > 0:
            bytes_per_read = s.bytes_read / s.records
            return int(s.bytes_total * 1.01 / bytes_per_read)
        return 0

    # --------------------------------------------------- adapter detect

    def eval_adapter_and_read_num(self) -> int:
        opt = self.opt
        if self._sample is None or self._sample.tag != "detect":
            self._sample = self._read_prefix(
                "detect", 64 * 1024, 8192 * 64 * 1024, 16384, cap_take=True)
        s = self._sample
        blocks = s.blocks
        records = s.records
        saw_eof = s.saw_eof
        bytes_read, bytes_total = s.bytes_read, s.bytes_total

        if saw_eof:
            read_num = records
        elif records > 0:
            bytes_per_read = bytes_read / records
            read_num = int(bytes_total * 1.01 / bytes_per_read)
        else:
            read_num = 0

        if records < 100:
            return read_num

        shift_tail = max(1, opt.trim.tail)

        seqs = []
        lens = []
        for block, take in blocks:
            for i in range(take):
                s = block.seq(i)
                seqs.append(s)
                lens.append(len(s))
        lens = np.asarray(lens, np.int64)

        if opt.adapter.sequence_start == "auto":
            sys.stderr.write("Trying to detect adapter sequence at read start\n")
            counts, posacc, total = self._kmer_histogram(
                seqs, lens, shift_tail, end_side=False)
            self._detect(counts, posacc, total, end_side=False)

        if opt.adapter.sequence_end == "auto":
            sys.stderr.write("Trying to detect adapter sequence at read end\n")
            counts, posacc, total = self._kmer_histogram(
                seqs, lens, shift_tail, end_side=True)
            self._detect(counts, posacc, total, end_side=True)

        return read_num

    def _detect(self, counts, posacc, total, end_side):
        opt = self.opt
        with self.spans("top_key"):
            total_key = int((counts > 0).sum())
            counts[0] = 0  # AAAAAAAAAA
            key = get_top_key(counts)
        count = int(counts[key]) if key >= 0 else 0
        if count > 10 and count * total_key > total * FOLD_THRESHOLD:
            with self.spans("extend"):
                adapter = extend_key_to_adapter(
                    key, counts, posacc,
                    is_rna=(opt.is_rna if end_side else False))
            if len(adapter) > 16:
                sys.stderr.write("Detected: %s\n" % adapter)
                if end_side:
                    opt.adapter.sequence_end = adapter
                else:
                    opt.adapter.sequence_start = adapter
            else:
                flag = "-e" if end_side else "-s"
                sys.stderr.write(
                    "Found possible adapter sequence, but it's too short: %s,"
                    " specify %s %s to force trimming using this adapter\n"
                    % (adapter, flag, adapter))
        else:
            sys.stderr.write("Not detected\n")

    def _kmer_histogram(self, seqs, lens, shift_tail, end_side):
        """counts[KEYSPACE], position accumulator, total valid windows;
        the fill runs on the run's device (ops/kmer.py:kmer_histogram)."""
        with self.spans("kmer_matrix"):
            mat, npos, base_pos = window_matrix(seqs, lens, shift_tail,
                                                end_side)
        return kmer_histogram(mat, npos, base_pos, lens, end_side,
                              self.device, spans=self.spans)


def window_matrix(seqs, lens, shift_tail, end_side):
    """(mat [n, 139] uint8, npos [n], base_pos [n]) of one side's k-mer
    windows: row i holds read i's bytes from base_pos[i] on, and npos[i]
    window positions start there.

    start side: pos in [0, min(len-10-shiftTail, 127)], posacc += pos
    end side:   pos in [max(0, len-10-shiftTail-128), len-10-shiftTail],
                posacc += len - pos          (evaluator.cpp:179-234)
    """
    n = len(seqs)
    win = 128 + KEYLEN  # chars needed for 128 window positions
    mat = np.zeros((n, win + 1), np.uint8)  # +1 for inclusive end range
    base_pos = np.zeros(n, np.int64)  # absolute pos of column 0
    npos = np.zeros(n, np.int64)      # number of window positions
    for i, s in enumerate(seqs):
        last = lens[i] - KEYLEN - shift_tail  # inclusive last pos
        if last < 0:
            continue
        if end_side:
            sp = max(0, last - 128)
            base_pos[i] = sp
            npos[i] = min(last - sp + 1, 129)
        else:
            base_pos[i] = 0
            npos[i] = min(last + 1, 128)
        sp = base_pos[i]
        chunk = s[sp:sp + npos[i] + KEYLEN - 1]
        mat[i, :len(chunk)] = np.frombuffer(chunk, np.uint8)
    return mat, npos, base_pos


# ------------------------------------------------------------- top key


def get_top_key(counts):
    """Reference Evaluator::getTopKey (evaluator.cpp:267-322), vectorized."""
    k = np.arange(KEYSPACE, dtype=np.int64)
    val = counts.astype(np.int64)

    atcg = np.zeros((4, KEYSPACE), np.int8)
    for i in range(KEYLEN):
        b = (k >> (i * 2)) & 0x03
        for bb in range(4):
            atcg[bb] += b == bb

    low_complexity = (atcg >= KEYLEN - 4).any(axis=0)
    low_complexity |= (atcg == 0).sum(axis=0) >= 2
    low_complexity |= (k >> KEYLEN) == (k & ((1 << KEYLEN) - 1))

    # NOTE reference quirk: diff is computed from the COUNT value's bits
    diff = np.zeros(KEYSPACE, np.int8)
    for s in range(KEYLEN - 1):
        cur = (val >> ((KEYLEN - s) * 2)) & 0x03
        last = (val >> ((KEYLEN - s - 1) * 2)) & 0x03
        diff += cur != last

    skip = (diff < 3) | low_complexity
    skip |= (atcg[2] + atcg[3]) >= KEYLEN - 2
    skip |= (k >> 12) == 0xFF
    skip |= k == 0

    masked = np.where(skip, 0, val)
    top = int(np.argmax(masked))
    if masked[top] == 0:
        return -1
    return top


# ----------------------------------------------------------- extension


def int2seq(val, seqlen, is_rna=False):
    bases = "AUCG" if is_rna else "ATCG"
    out = []
    for i in range(seqlen):
        out.append(bases[val & 0x03])
        val >>= 2
    return "".join(reversed(out))


def seq2int(seq, pos, keylen=KEYLEN, last_val=-1):
    """Rolling 2-bit key (reference evaluator.cpp:499-554)."""
    if last_val >= 0:
        mask = (1 << (keylen * 2)) - 1
        key = (last_val << 2) & mask
        v = _CODE[ord(seq[pos + keylen - 1])]
        if v < 0:
            return -1
        return key + int(v)
    key = 0
    for i in range(pos, pos + keylen):
        v = _CODE[ord(seq[i])]
        if v < 0:
            return -1
        key = (key << 2) + int(v)
    return key


def match_known_adapter(seq: str) -> str:
    """Exact-prefix match against the known-adapter DB (reference
    Evaluator::matchKnownAdapter, evaluator.cpp:465-483)."""
    from .knownadapters import get_known_adapter
    for adapter in get_known_adapter():
        if len(seq) < len(adapter):
            continue
        if seq[:len(adapter)] == adapter:
            return adapter
    return ""


def get_adapter_with_seed(seed, seqs, keylen, shift_tail=1):
    """Legacy fastp-style seed extension via NucleotideTree (reference
    Evaluator::getAdapterWithSeed, evaluator.cpp:410-463; not called in the
    reference's current flow, kept for capability parity)."""
    from .nucleotidetree import NucleotideTree
    forward = NucleotideTree()
    for s in seqs:
        key = -1
        for pos in range(20, len(s) - keylen - shift_tail + 1):
            key = seq2int(s, pos, keylen, key)
            if key == seed:
                # substr(pos+keylen, len-keylen-shiftTail-pos) == [pos+keylen,
                # len-shiftTail) (evaluator.cpp:422)
                forward.add_seq(s[pos + keylen:len(s) - shift_tail])
    fpath, reached_leaf = forward.get_dominant_path()

    backward = NucleotideTree()
    for s in seqs:
        key = -1
        for pos in range(20, len(s) - keylen - shift_tail + 1):
            key = seq2int(s, pos, keylen, key)
            if key == seed:
                backward.add_seq(s[:pos][::-1])
    bpath, _ = backward.get_dominant_path()

    adapter = bpath[::-1] + int2seq(seed, keylen) + fpath
    if len(adapter) > 60:
        adapter = adapter[:60]
    matched = match_known_adapter(adapter)
    if matched:
        return matched
    if reached_leaf:
        return adapter
    return ""


def extend_key_to_adapter(key, counts, posacc, is_rna=False, left_first=True):
    """Reference Evaluator::extendKeyToAdapter (evaluator.cpp:324-408)."""
    adapter = int2seq(key, KEYLEN, is_rna)
    mask = KEYSPACE - 1
    bases = "AUCG" if is_rna else "ATCG"
    seed_count = int(counts[key])

    left_finished = False
    right_finished = False
    extending_left = left_first
    while True:
        curkey = key
        while len(adapter) < MAX_ADAPTER_LEN:
            total_count = 0
            extended = False
            newkeys = []
            for b in range(4):
                if extending_left:
                    nk = (b << ((KEYLEN - 1) * 2)) | (curkey >> 2)
                else:
                    nk = b | (mask & (curkey << 2))
                newkeys.append(nk)
                total_count += int(counts[nk])
            for b in range(4):
                nk = newkeys[b]
                c = int(counts[nk])
                if c == 0:
                    continue
                offset = (float(posacc[nk]) / c
                          - float(posacc[curkey]) / int(counts[curkey]))
                if c / total_count < 0.7:
                    continue
                if c / seed_count < 0.5:
                    continue
                if offset > 2 or offset < -4:
                    continue
                curkey = nk
                extended = True
                if extending_left:
                    adapter = bases[b] + adapter
                else:
                    adapter = adapter + bases[b]
                break
            if not extended:
                if extending_left:
                    left_finished = True
                else:
                    right_finished = True
                break
            if len(adapter) == MAX_ADAPTER_LEN:
                left_finished = True
                right_finished = True
                break
        extending_left = not extending_left
        if left_finished and right_finished:
            break
    return adapter
