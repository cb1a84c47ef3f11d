"""Single-file processing pipeline for a GPU attached directly to the host.

    host stream-parse -> bucketed padded batches -> pinned h2d copy ->
    device step -> packed per-read rows back to pinned host memory ->
    host apply to the ORIGINAL record bytes -> async writers

Bases never round-trip through the device, so output equality with the
reference is structural.  What fastplong_tpu/pipeline/runner.py guarantees
is kept — input order, bucketed batches, a bounded number of batches in
flight, async writers and one statistics drain at the end of the run; its
interconnect machinery (link policy, stream feed, prewarm pool, fetch
watchdog) has no counterpart on directly attached hardware.

Devices (--devices N, pipeline/sharding.py): each batch's rows are cut
into one slice per device, every slice is launched before any is waited
on, and each device writes its rows into its part of the batch's pinned
host rows.  One device is the case of one slice.

Statistics: buckets at or under stat_device_cap() accumulate into the
device-resident [2, F] states, one per slice, at global_stat_len().
Longer (monster) buckets bypass the slices: they take the first device's
step into a second [2, F] accumulator, made at the first monster bucket's
length and grown on the device when a longer one comes, while its bytes
stay within device.stats_state_budget; a bucket beyond that takes the
stats-free step and is statted on the host (pipeline/host_stats.py).
Both accumulators are drained once, at the end of the run.
--stats_backend host sends every bucket through the stats-free step and
the host (the native pass, or host_stats.py's for monster buckets)
instead; auto means device.
"""

import contextlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import resolve_device
from ..common import stat_device_cap
from ..filter_result import FilterResult
from ..io.fastq import FastqStreamReader, RecordBlock
from ..io.writer import make_output_writer
from ..ops.stats_kernels import flat_side_len, side_stat_len
from ..spans import standalone
from ..stats import Stats
from ..util import loginfo
from .batches import BatchBuilder, bucket_groups
from .device import (global_stat_len, grow_stats_state, kernel_params,
                     params_cap, stats_state_budget, stats_state_to_numpy,
                     unflatten_side, zero_stats_state)
from .emit import emit_block_fast
from .host_stats import (BatchStatAccumulator, HostStatAccumulator,
                         masked_span, median_qual)
from .sharding import Placement, build_fast_sharded_step, make_devices
from .split import SplitWriterSet

MAX_IN_FLIGHT = 3          # batches dispatched but not yet consumed
MAX_BLOCKS_PENDING = 24    # parsed blocks held before forcing drains


class PackedResults:
    """Decoded view of one batch's packed per-read rows."""

    def __init__(self, arr, cap, n_stages):
        self.cap = cap
        self.lo = arr[:, 0]
        self.hi = arr[:, 1]
        flags = arr[:, 2]
        self.null = (flags & 1).astype(bool)
        self.n_out = (flags >> 1) & 0x7
        self.poly = ((flags >> 4) & 0x7) - 1
        self.pre_median = (flags >> 8) & 0xFF
        self.poly_trim = arr[:, 3]
        self.adapter_trimmed = arr[:, 4]
        base = 5
        self.out_lo = arr[:, base + 0:base + cap * 6:6]
        self.out_hi = arr[:, base + 1:base + cap * 6:6]
        self.mask_lo = arr[:, base + 2:base + cap * 6:6]
        self.mask_hi = arr[:, base + 3:base + cap * 6:6]
        misc = arr[:, base + 4:base + cap * 6:6]
        self.region_no = arr[:, base + 5:base + cap * 6:6]
        self.code = misc & 0x3F
        self.out_tag = (misc >> 6) & 0x3
        self.passed = ((misc >> 8) & 1).astype(bool)
        self.is_parent = ((misc >> 9) & 1).astype(bool)
        self.active = ((misc >> 10) & 1).astype(bool)
        self.post_median = (misc >> 11) & 0xFF
        self.adapter_recs = arr[:, base + cap * 6:]


_FIELDS = ("lo", "hi", "null", "n_out", "active", "out_lo", "out_hi",
           "out_tag", "region_no", "is_parent", "mask_lo", "mask_hi",
           "code", "passed")


class BlockResults:
    """Per-record result arrays for one RecordBlock."""

    def __init__(self, n, cap):
        for name in _FIELDS:
            shape = n if name in ("lo", "hi", "null", "n_out") else (n, cap)
            dt = bool if name in ("null", "active", "is_parent",
                                  "passed") else np.int32
            setattr(self, name, np.zeros(shape, dt))

    def scatter_rows(self, indices, out, rows):
        for name in _FIELDS:
            getattr(self, name)[indices] = getattr(out, name)[rows]


class SingleEndRunner:
    def __init__(self, opt, device=None, devices=None, spans=None):
        """device follows resolve_device; opt.devices above 1 runs on that
        many devices (sharding.make_devices).  devices, a list in which a
        device may repeat, runs one row slice on each and overrides
        both.  spans: the job's stage layer (spans.py), which times the
        runner's stages and, inside `dispatch`, the step's."""
        self.opt = opt
        self.spans = spans or standalone()
        if devices is None:
            devices = (make_devices(opt.devices, device) if opt.devices > 1
                       else [device])
        self.devices = [resolve_device(d) for d in devices]
        self.device = self.devices[0]
        self.placement = Placement(self.devices)
        # monster buckets bypass the slices: the first device alone
        self._monster_placement = (self.placement if self.placement.n == 1
                                   else Placement(self.devices[:1]))
        self.params = kernel_params(opt)
        self.cap = params_cap(self.params)
        self.mask_on = self.params["mask_enabled"]
        self.step, self.stages = build_fast_sharded_step(self.params,
                                                         self.placement)
        self._steps = {}         # (placement, with_stats): built steps
        self.stat_cap = stat_device_cap()
        backend = getattr(opt, "stats_backend", "auto")
        self.host_stats_mode = backend == "host"
        self.pre_stats = Stats(is_rna=opt.is_rna)
        self.post_stats = Stats(is_rna=opt.is_rna)
        self.filter_result = FilterResult()
        self._host_pre = HostStatAccumulator()
        self._host_post = HostStatAccumulator()
        if self.host_stats_mode:
            SL = global_stat_len()
            self._batch_pre = BatchStatAccumulator(SL)
            self._batch_post = BatchStatAccumulator(SL)
            # the pre pass runs on its own worker (the native call
            # releases the GIL); post runs on the main thread at consume
            self._stats_pool = ThreadPoolExecutor(max_workers=1)
        self.states = None       # [2, F] accumulator per slice, made lazily
        self.max_seen = 0        # longest device-statted read
        self.monster_state = None   # [2, F] of the monster buckets
        self.monster_max_seen = 0
        self.monster_step_calls = 0  # step calls into monster_state
        self.host_stat_batches = 0   # monster batches statted on the host
        self.out_writer = None
        self.failed_writer = None
        self.split_set = None    # --split/--split_by_lines writers
        self.reader = None
        self.step_calls = 0      # step launches (one per non-empty slice)

    def _step_for(self, placement, with_stats):
        """The step over placement, with or without statistics, built
        once."""
        if with_stats and placement is self.placement:
            return self.step
        key = (placement, with_stats)
        if key not in self._steps:
            self._steps[key] = build_fast_sharded_step(
                self.params, placement, with_stats)[0]
        return self._steps[key]

    @property
    def monster_stat_len(self):
        """The monster accumulator's cycle length (0 if none was made)."""
        return (0 if self.monster_state is None
                else side_stat_len(self.monster_state))

    def _monster_state_at(self, L):
        """The monster accumulator at a cycle length of at least L, made
        or grown on the first device; None where that would take more
        bytes than stats_state_budget allows at this moment."""
        st = self.monster_state
        if st is not None and side_stat_len(st) >= L:
            return st
        budget = stats_state_budget(self.device)
        if budget is not None and 2 * flat_side_len(L) * 8 > budget:
            return None
        self.monster_state = (zero_stats_state(L, self.device)
                              if st is None else grow_stats_state(st, L))
        return self.monster_state

    # ------------------------------------------------------------------ run

    def run(self):
        """Process the input; returns (pre_stats, post_stats,
        filter_result).  A run that fails stops its writer threads and
        closes its files before the error goes on, so that nothing of it
        keeps running in a process that serves more jobs (the daemon)."""
        try:
            return self._run()
        except BaseException:
            self._abandon()
            raise

    def _abandon(self):
        writers = [self.out_writer, self.failed_writer]
        if self.split_set is not None:
            writers += [st.writer for st in self.split_set.states]
        for w in writers:
            if w is not None:
                # the run's own error is the one to report
                with contextlib.suppress(Exception):
                    w.close()
        if self.host_stats_mode:
            self._stats_pool.shutdown(wait=True, cancel_futures=True)
        if self.reader is not None:
            self.reader.close()

    def _run(self):
        opt = self.opt
        if opt.split.enabled:
            # split mode: per-thread rotating writers, no failed_out
            # (the reference skips initOutput, seprocessor.cpp:66-67)
            self.split_set = SplitWriterSet(opt)
        else:
            if opt.failed_out:
                self.failed_writer = make_output_writer(
                    opt.failed_out, opt.compression,
                    buffer_size=opt.writer_buffer_size)
            if opt.out or opt.output_to_stdout:
                self.out_writer = make_output_writer(
                    opt.out, opt.compression, stdout=opt.output_to_stdout,
                    buffer_size=opt.writer_buffer_size)
        reader = self.reader = FastqStreamReader(
            "/dev/stdin" if opt.input_from_stdin and not opt.in_file
            else opt.in_file, byte_range=opt.byte_range)
        if opt.verbose:
            loginfo("start to load data")
        span = self.spans
        self._block_queue = []   # [block, BlockResults, outstanding reads]
        self._in_flight = deque()
        with span("total_loop"):
            self._read_all(reader)

        with span("writer_close"):
            if self.split_set is not None:
                self.split_set.close()
            for w in (self.out_writer, self.failed_writer):
                if w is not None:
                    w.close()

        with span("stats_finish"):
            # the longer (monster) cycle block first: Stats grows its
            # per-cycle arrays once
            states = ([([self.monster_state], self.monster_max_seen)]
                      if self.monster_state is not None else [])
            if self.states is not None:
                states.append((self.states, self.max_seen))
            if states:
                with span("stats_fetch"):
                    drained = [stats_state_to_numpy(st, seen)
                               for st, seen in states]
                for flat, m in drained:
                    self.pre_stats.add_device_partial(
                        unflatten_side(flat[0], m))
                    self.post_stats.add_device_partial(
                        unflatten_side(flat[1], m))
            parts = [(self.pre_stats, self._host_pre.partial()),
                     (self.post_stats, self._host_post.partial())]
            if self.host_stats_mode:
                self._stats_pool.shutdown(wait=True)
                parts += [(self.pre_stats, self._batch_pre.partial()),
                          (self.post_stats, self._batch_post.partial())]
            for stats, part in parts:
                if part is not None:
                    stats.add_device_partial(part)
            with span("stats_summarize"):
                for stats in (self.pre_stats, self.post_stats):
                    stats.summarize()
                    stats.calc_length_histogram()
        if opt.verbose:
            loginfo("stage seconds: %s" % {
                k: round(v, 4) for k, v in sorted(span.seconds.items())})
        return self.pre_stats, self.post_stats, self.filter_result

    def _read_all(self, reader):
        """Parse the input block by block, pack its reads into length
        buckets and dispatch each full batch; then ship the partial
        batches and drain every batch in flight."""
        opt = self.opt
        span = self.spans
        builders = {}
        processed = 0
        last_reported = 0
        while True:
            with span("read_parse"):
                block = reader.next_block()
            if block is None:
                break
            if opt.reads_to_process > 0:
                remaining = opt.reads_to_process - processed
                if remaining <= 0:
                    break
                if block.n > remaining:
                    block = _truncate_block(block, remaining)
            processed += block.n
            if opt.verbose and processed >= last_reported + 1000000:
                last_reported = processed
                loginfo("loaded %dM reads" % (last_reported // 1000000))
            for w in (self.out_writer, self.failed_writer):
                if w is not None:
                    w.check()   # surface writer-thread failures promptly
            self._block_queue.append(
                [block, BlockResults(block.n, self.cap), block.n])
            for L, take in bucket_groups(block):
                b = builders.get(L)
                if b is None:
                    # rows a multiple of the slices, except in monster
                    # buckets, which bypass them
                    b = builders[L] = BatchBuilder(
                        L, self.placement.n if L <= self.stat_cap else 1)
                pos = 0
                while pos < len(take):
                    k = min(b.space, len(take) - pos)
                    with span("pack"):
                        b.add(block, take[pos:pos + k])
                    pos += k
                    if b.full:
                        self._dispatch(b.take_batch())
            if len(self._block_queue) > MAX_BLOCKS_PENDING:
                # reads held in partially filled builders (sparse length
                # buckets) would block the queue: ship them now
                for b in builders.values():
                    if b.count:
                        self._dispatch(b.take_batch())
                while self._in_flight:
                    self._drain_one()
        for b in builders.values():
            if b.count:
                self._dispatch(b.take_batch())
        while self._in_flight:
            self._drain_one()
        if self._block_queue:
            raise RuntimeError("incomplete blocks at end of input")
        reader.close()

    # -------------------------------------------------------------- batches

    def _dispatch(self, batch):
        """Copy one batch's row slices to their devices, launch the step on
        each and queue the copies of their rows back into one pinned host
        buffer (all asynchronous, each on its device's current stream)."""
        with self.spans("dispatch"):
            n = int(batch.read_mask.sum())
            if n < batch.packed.shape[0]:
                # a partial batch: its rows are a prefix, the rest is padding
                batch.packed = batch.packed[:n]
                batch.lens = batch.lens[:n]
                batch.read_mask = batch.read_mask[:n]
            monster = batch.L > self.stat_cap
            if self.host_stats_mode and not monster:
                batch.pre_medians = self._stats_pool.submit(
                    self._timed_pre_rows, batch)
            placement = self._monster_placement if monster else self.placement
            x, parts = placement.split_rows(batch.packed)
            calls = sum(part is not None for part, _, _ in parts)
            monster_state = (self._monster_state_at(batch.L)
                             if monster and not self.host_stats_mode
                             else None)
            if monster_state is not None:
                rows, events = self._step_for(placement, True)(
                    [monster_state], parts, batch.L)
                self.monster_max_seen = max(self.monster_max_seen,
                                            int(batch.lens.max()))
                self.monster_step_calls += calls
            elif monster or self.host_stats_mode:
                batch.host_monster = monster
                if monster:
                    self.host_stat_batches += 1
                rows, events = self._step_for(placement, False)(parts,
                                                                batch.L)
            else:
                if self.states is None:
                    self.states = placement.init_state(global_stat_len())
                rows, events = self.step(self.states, parts, batch.L)
                self.max_seen = max(self.max_seen, int(batch.lens.max()))
            self.step_calls += calls
            if not (self.host_stats_mode and not monster):
                batch.packed = None   # the host pass no longer needs the feed
            # x stays referenced until the batch is consumed: its pinned pages
            # must outlive the asynchronous copies
            self._in_flight.append((batch, rows, events, x))
        while len(self._in_flight) > MAX_IN_FLIGHT:
            self._drain_one()

    def _drain_one(self):
        batch, rows, events, _ = self._in_flight.popleft()
        with self.spans("device_wait"):
            for event in events:
                event.synchronize()
        with self.spans("accumulate"):
            self._consume_batch(rows.numpy(), batch)
        while self._block_queue and self._block_queue[0][2] == 0:
            block, res, _ = self._block_queue.pop(0)
            with self.spans("emit"):
                self._emit(block, res)

    def _consume_batch(self, rows, batch):
        """Decode one batch's packed rows and route the results."""
        if batch.pre_medians is not None:
            batch.pre_medians = batch.pre_medians.result()
        out = PackedResults(rows, self.cap, len(self.stages))
        if batch.host_monster:
            with self.spans("host_stats"):
                self._host_stat_batch(out, batch)
        elif self.host_stats_mode:
            with self.spans("host_stats"):
                self._host_post_batch(out, batch)
        order = np.full(len(batch.lens), 1 << 60, np.int64)
        for seg in batch.segments:
            order[seg.row_start:seg.row_start + len(seg.indices)] = (
                seg.block.first_index + seg.indices)
        self._accumulate(out, batch, order)
        for seg in batch.segments:
            rows_sl = slice(seg.row_start, seg.row_start + len(seg.indices))
            entry = next(e for e in self._block_queue if e[0] is seg.block)
            entry[1].scatter_rows(seg.indices, out, rows_sl)
            entry[2] -= len(seg.indices)

    def _timed_pre_rows(self, batch):
        with self.spans("host_stats_pre"):
            return self._batch_pre.add_rows(
                batch.packed, batch.L, None, batch.lens.astype(np.int64),
                None, None, batch.read_mask, batch.layout)

    def _host_post_batch(self, out, batch):
        """Host-statistics mode: post statRead per out-slot in one native
        pass per slot over the batch's packed rows; fills the medians."""
        out.pre_median = batch.pre_medians
        for c in range(self.cap):
            pass_c = out.passed[:, c]
            if not pass_c.any():
                continue
            m_lo, m_hi = ((out.mask_lo[:, c].astype(np.int64),
                           out.mask_hi[:, c].astype(np.int64))
                          if self.mask_on else (None, None))
            med = self._batch_post.add_rows(
                batch.packed, batch.L, out.out_lo[:, c].astype(np.int64),
                out.out_hi[:, c].astype(np.int64), m_lo, m_hi, pass_c,
                batch.layout)
            out.post_median[:, c] = np.where(pass_c, med,
                                             out.post_median[:, c])
        batch.packed = None

    def _host_stat_batch(self, out, batch):
        """Host statRead for one monster batch that took the stats-free
        step (--stats_backend host, or beyond the monster accumulator's
        memory ceiling): fills the medians and the host accumulators, with
        the arithmetic of ops/stats_kernels.stat_batch."""
        for seg in batch.segments:
            blk = seg.block
            for k, i in enumerate(seg.indices):
                row = seg.row_start + k
                if not batch.read_mask[row]:
                    continue
                so, sl, qo = blk.seq_off[i], blk.seq_len[i], blk.qual_off[i]
                seq = blk.arr[so:so + sl]
                qual = blk.arr[qo:qo + sl]
                self._host_pre.add_read(seq, qual)
                out.pre_median[row] = median_qual(qual)
                if out.null[row]:
                    continue
                for c in range(self.cap):
                    if not out.passed[row, c]:
                        continue
                    lo = int(out.out_lo[row, c])
                    hi = int(out.out_hi[row, c])
                    b_eff = (masked_span(seq, lo, hi, out.mask_lo[row, c],
                                         out.mask_hi[row, c])
                             if self.mask_on else seq[lo:hi])
                    self._host_post.add_read(b_eff, qual[lo:hi])
                    out.post_median[row, c] = median_qual(qual[lo:hi])

    def _accumulate(self, out, batch, order):
        cap = self.cap
        read_mask = batch.read_mask
        self.pre_stats.add_read_level(
            np.where(read_mask, batch.lens, 0), out.pre_median, read_mask,
            order)
        for ci in range(cap):
            # sub-reads of one input read keep slot order within the read
            self.post_stats.add_read_level(
                out.out_hi[:, ci] - out.out_lo[:, ci], out.post_median[:, ci],
                out.passed[:, ci], order * cap + ci)
        codes = out.code[out.active]
        if len(codes):
            self.filter_result.add_filter_results(codes)
        live = ~out.null
        pm = live & (out.poly >= 0)
        if pm.any():
            for b in range(4):
                sel = pm & (out.poly == b)
                if sel.any():
                    self.filter_result.add_polyx_trimmed(
                        b, int(out.poly_trim[sel].sum()), int(sel.sum()))
        # adapter bookkeeping (addReadTrimmed + per-sequence counts)
        at = out.adapter_trimmed
        tm = live & (at > 0)
        if tm.any():
            self.filter_result.trimmed_adapter_reads += int(tm.sum())
            self.filter_result.trimmed_adapter_bases += int(at[tm].sum())
        recs = out.adapter_recs
        for si, (seq, side) in enumerate(self.stages):
            col = recs[:, si]
            sel = live & (col > 0)
            if not sel.any():
                continue
            vals, counts = np.unique(col[sel], return_counts=True)
            for cmplen, cnt in zip(vals.tolist(), counts.tolist()):
                rec_seq = (seq[len(seq) - cmplen:] if side == "start"
                           else seq[:cmplen])
                self.filter_result.add_adapter_trimmed(rec_seq, cnt)

    def _emit(self, block, res):
        if self.split_set is not None:
            # writer rotation advances only at 16-read pack boundaries
            # (threadconfig.cpp:88-108), so the block's output is sliced
            # per pack by its per-record byte lengths
            out_b, _, read_lens = emit_block_fast(
                block, res, self.cap, self.mask_on, True, False,
                return_read_lens=True)
            read_passed = (res.active & res.passed
                           & ~res.null[:, None]).any(axis=1)
            self.split_set.add_block(out_b, read_lens, read_passed)
            return
        out_b, failed_b = emit_block_fast(
            block, res, self.cap, self.mask_on, self.out_writer is not None,
            self.failed_writer is not None)
        if out_b and self.out_writer is not None:
            self.out_writer.write(out_b)
        if failed_b:
            self.failed_writer.write(failed_b)


def _truncate_block(block, n):
    return RecordBlock(
        block.buf, block.arr,
        block.name_off[:n], block.name_len[:n],
        block.seq_off[:n], block.seq_len[:n],
        block.strand_off[:n], block.strand_len[:n],
        block.qual_off[:n], first_index=block.first_index)

