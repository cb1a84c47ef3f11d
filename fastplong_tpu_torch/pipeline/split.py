"""Split output emulation (a copy of fastplong_tpu/pipeline/split.py).

Reproduces the reference's split-file semantics exactly: the reader deals
packs of 16 reads round-robin to N workers (seprocessor.cpp:349-381), and
each worker writes its pack output to a private rotating writer whose file
number advances by N every split.size reads (threadconfig.cpp:72-118).
File names are zero-padded 1-based numbers prefixed to the output name
(0001.out.fq ...), and for --split N any files a worker never filled are
still created empty at the end.

Divergence note: when the input exceeds split.number * split.size in
--split mode, the reference's behavior is timing-dependent (workers MAY
stop consuming once their quota is filled, dropping reads, depending on
queue state — seprocessor.cpp:434-438 checks canBeStopped only between
queue drains).  We implement the deterministic common case: excess reads
keep appending to the worker's last file.
"""

from ..io.writer import Writer
from ..util import basename, dirname, joinpath


class _WorkerState:
    __slots__ = ("working", "count", "writer")

    def __init__(self, t):
        self.working = t
        self.count = 0
        self.writer = None


class SplitWriterSet:
    PACK_SIZE = 16  # reference common.h:33

    def __init__(self, opt):
        self.opt = opt
        self.n = opt.thread
        self.states = [_WorkerState(t) for t in range(self.n)]
        self.pack_idx = 0
        self.pack_reads = 0      # reads in the current (partial) pack
        self.pack_pieces = []    # output pieces of the current pack
        self.pack_passed = 0
        if opt.out:
            for st in self.states:
                self._open(st)

    def _open(self, st):
        opt = self.opt
        num = str(st.working + 1)
        if opt.split.digits > 0:
            num = num.zfill(opt.split.digits)
        filename = joinpath(dirname(opt.out), num + "." + basename(opt.out))
        if st.writer is not None:
            st.writer.close()
        st.writer = Writer(filename, opt.compression,
                           buffer_size=opt.writer_buffer_size)

    def add_read(self, pieces, passed):
        """Append one input read's output pieces (possibly empty) in input
        order; flushes the pack when it reaches PACK_SIZE reads."""
        self.pack_pieces += pieces
        self.pack_reads += 1
        self.pack_passed += passed
        if self.pack_reads == self.PACK_SIZE:
            self._flush_pack()

    def add_block(self, out_bytes, read_lens, read_passed):
        """Vectorized per-block entry: out_bytes is the whole block's
        emitted output (pipeline/emit.emit_block_fast) and read_lens[i]
        its per-record byte length, so pack rotation only needs buffer
        slices at 16-read boundaries — no per-read python loop.  Partial
        packs carry across blocks exactly like add_read."""
        import numpy as np
        cum = np.concatenate(([0], np.cumsum(read_lens)))
        n = len(read_lens)
        i = 0
        while i < n:
            take = min(self.PACK_SIZE - self.pack_reads, n - i)
            nb = int(cum[i + take] - cum[i])
            if nb:
                self.pack_pieces.append(out_bytes[int(cum[i]):
                                                  int(cum[i]) + nb])
            self.pack_reads += take
            self.pack_passed += int(np.sum(read_passed[i:i + take]))
            i += take
            if self.pack_reads == self.PACK_SIZE:
                self._flush_pack()

    def _flush_pack(self):
        if self.pack_reads == 0:
            return
        opt = self.opt
        st = self.states[self.pack_idx % self.n]
        if st.writer is not None and self.pack_pieces:
            st.writer.write(b"".join(self.pack_pieces))
        read_num = (self.pack_passed if opt.split.by_file_lines
                    else self.pack_reads)
        self._mark_processed(st, read_num)
        self.pack_idx += 1
        self.pack_reads = 0
        self.pack_passed = 0
        self.pack_pieces = []

    def _mark_processed(self, st, read_num):
        opt = self.opt
        st.count += read_num
        if st.count >= opt.split.size:
            if (opt.split.by_file_lines
                    or st.working + self.n < opt.split.number):
                st.working += self.n
                if opt.out:
                    self._open(st)
                st.count = 0
            # else: quota exhausted; keep appending (see module docstring)

    def close(self):
        self._flush_pack()
        opt = self.opt
        for st in self.states:
            # backfill empty files for --split N (threadconfig.cpp:112-118)
            if opt.split.by_file_number:
                while st.working + self.n < opt.split.number:
                    st.working += self.n
                    if opt.out:
                        self._open(st)
                    st.count = 0
            if st.writer is not None:
                st.writer.close()
