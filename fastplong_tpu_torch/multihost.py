"""Single-file multi-host sharding of the PyTorch/CUDA port.

The reference scales across processes only at FILE granularity
(parallel.py: one fastplong process per FASTQ); one huge file cannot be
split.  Here a plain FASTQ is sharded by record-aligned BYTE RANGES: host i
of N processes records in [range_i) and writes host-prefixed outputs
(0001.out.fq ... like --split naming, threadconfig.cpp:72-86), plus a
statistics partial.  The final merged JSON/HTML report is produced either

  * over the network: when FASTPLONG_COORDINATOR is set to host:port
    (where host 0 listens), the hosts form a torch.distributed `gloo`
    group before the run, exchange their partials with an all-gather of
    uint8 CPU tensors after it, and host 0 writes the report — the
    collective replacement for the reference's end-of-run Stats::merge
    (src/seprocessor.cpp:108-121) across hosts; or
  * offline: `python -m fastplong_tpu_torch.merge_reports out.json.part0
    out.json.part1 ...` merges the saved partial blobs (shared or copied
    filesystem).

A copy of fastplong_tpu/multihost.py's sharding and partials; the exchange
is torch.distributed in place of jax.distributed.  A partial pickles the
port's Options, which hold numpy arrays and plain values only, so merging
it touches no card; it is merged by this package's merge_reports alone.
Several hosts may share one card: each resolves the run's device as a
single-host run does.

gzip inputs cannot be byte-sharded (no random access without an index) —
multi-host mode requires plain FASTQ; .gz falls back to whole-file
processing on one host via parallel.py's file sharding.
"""

import os
import pickle
from datetime import timedelta

import numpy as np

from .stats import Stats
from .util import error_exit
from .filter_result import FilterResult

_PROBE = 1 << 20  # alignment scan window


def _is_record_start(lines, j, at_eof):
    """Does lines[j] begin a FASTQ record?  '@' alone is not enough (it is
    a legal quality byte), so require a CHAIN of two well-formed records.
    Returns True/False, or None when the window ends mid-chain and the
    file doesn't — the caller must grow the window rather than skip a
    possibly-true start."""
    k = j
    for checked in range(2):
        if k + 3 >= len(lines):
            if not at_eof:
                return None
            # at EOF a shorter chain is conclusive if the remainder is
            # empty (trailing newline split artifact)
            return checked >= 1 and all(not ln for ln in lines[k:])
        if not (lines[k].startswith(b"@") and lines[k + 2].startswith(b"+")
                and len(lines[k + 1]) == len(lines[k + 3])):
            return False
        k += 4
    return True


def align_to_record(path, pos):
    """Smallest record-start byte offset >= pos (file size if none)."""
    size = os.path.getsize(path)
    if pos <= 0:
        return 0
    if pos >= size:
        return size
    probe = _PROBE
    with open(path, "rb") as f:
        # pos itself is a candidate iff it begins a line (previous byte is
        # a newline) — otherwise the window's first "line" is the partial
        # tail of the previous line and must be skipped
        f.seek(pos - 1)
        pos_is_line_start = f.read(1) == b"\n"
        while True:
            f.seek(pos)
            buf = f.read(probe)
            at_eof = pos + len(buf) >= size
            lines = buf.split(b"\n")
            offs = []
            o = 0
            for ln in lines:
                offs.append(o)
                o += len(ln) + 1
            start_line = 0 if pos_is_line_start else 1
            inconclusive = False
            for j in range(start_line, max(start_line, len(lines) - 1)):
                r = _is_record_start(lines, j, at_eof)
                if r is True:
                    return pos + offs[j]
                if r is None:
                    # window ended mid-chain at a live candidate: grow
                    # the window, don't skip a possibly-true start
                    inconclusive = True
                    break
            if at_eof and not inconclusive:
                # no record start in the remainder: everything left
                # belongs to the previous shard's final record
                return size
            probe *= 2


def compute_range(path, num_hosts, host_index):
    """Record-aligned (start, end) byte range of shard host_index/num_hosts."""
    size = os.path.getsize(path)
    cut = [align_to_record(path, size * i // num_hosts)
           for i in range(num_hosts + 1)]
    return cut[host_index], cut[host_index + 1]


def host_prefixed(path, host_index, digits=4):
    """0001.name host-file naming, mirroring --split (threadconfig.cpp:72-86)."""
    if not path:
        return path
    d = os.path.dirname(path)
    b = os.path.basename(path)
    return os.path.join(d, str(host_index + 1).zfill(digits) + "." + b)


# ----------------------------------------------------------- partial (de)ser

def partial_bytes(opt, pre, post, fr):
    """Serialize one host's run partial (pre/post Stats, FilterResult,
    and the opt needed to render reports) to bytes."""
    payload = {
        "opt": opt,
        "reads_pre": pre.reads, "len_sum_pre": pre.length_sum,
        "reads_post": post.reads, "len_sum_post": post.length_sum,
        "fr_stats": fr.filter_read_stats,
        "fr_adapter_reads": fr.trimmed_adapter_reads,
        "fr_adapter_bases": fr.trimmed_adapter_bases,
        "fr_polyx_reads": fr.trimmed_polyx_reads,
        "fr_polyx_bases": fr.trimmed_polyx_bases,
        "fr_adapter_counts": fr.adapter_counts,
    }
    for tag, s in (("pre", pre), ("post", post)):
        payload[tag + "_arrays"] = {
            k: getattr(s, k) for k in
            ("cycle_q20", "cycle_q30", "cycle_content", "cycle_qual",
             "cycle_total_base", "cycle_total_qual", "base_qual_hist",
             "median_qual_hist", "median_qual_bases", "kmer")}
        payload[tag + "_lengths"] = (
            np.concatenate(s._length_chunks) if s._length_chunks
            else np.zeros(0, np.int64))
        if s._qual_len_chunks:
            payload[tag + "_ql"] = tuple(
                np.concatenate([c[i] for c in s._qual_len_chunks])
                for i in range(3))
        else:
            payload[tag + "_ql"] = (np.zeros(0, np.uint8),
                                    np.zeros(0, np.int64),
                                    np.zeros(0, np.int64))
        payload[tag + "_is_rna"] = s.is_rna
    return pickle.dumps(payload, protocol=4)


def save_partial(path, opt, pre, post, fr):
    with open(path, "wb") as f:
        f.write(partial_bytes(opt, pre, post, fr))


def _stats_from(payload, tag, host_index):
    arrays = payload[tag + "_arrays"]
    L = int(arrays["cycle_total_base"].shape[0])
    s = Stats(is_rna=payload[tag + "_is_rna"], guessed_cycles=max(L, 1))
    for k, v in arrays.items():
        getattr(s, k)[..., :v.shape[-1]] += v
    s.reads = int(payload["reads_" + tag])
    s.length_sum = int(payload["len_sum_" + tag])
    lengths = payload[tag + "_lengths"]
    if len(lengths):
        s._length_chunks.append(lengths)
    meds, lens, order = payload[tag + "_ql"]
    if len(meds):
        # offset preserves host-major global input order in the density
        # plot listing (ranges are contiguous byte spans of one file)
        s._qual_len_chunks.append(
            (meds, lens, order + (host_index << 44)))
    return s


def _filter_result_from(payload):
    fr = FilterResult()
    fr.filter_read_stats += payload["fr_stats"]
    fr.trimmed_adapter_reads = int(payload["fr_adapter_reads"])
    fr.trimmed_adapter_bases = int(payload["fr_adapter_bases"])
    fr.trimmed_polyx_reads += payload["fr_polyx_reads"]
    fr.trimmed_polyx_bases += payload["fr_polyx_bases"]
    fr.adapter_counts = dict(payload["fr_adapter_counts"])
    return fr


def merge_partial_blobs(blobs):
    """Merge serialized host partials (in host order) into
    (opt, pre_stats, post_stats, filter_result)."""
    payloads = [pickle.loads(b) for b in blobs]
    pres = [_stats_from(p, "pre", i) for i, p in enumerate(payloads)]
    posts = [_stats_from(p, "post", i) for i, p in enumerate(payloads)]
    frs = [_filter_result_from(p) for p in payloads]
    pre = Stats.merge(pres)
    post = Stats.merge(posts)
    pre.calc_length_histogram()
    post.calc_length_histogram()
    fr = FilterResult.merge(frs)
    return payloads[0]["opt"], pre, post, fr


def write_merged_reports(opt, pre, post, fr):
    from .report.json_report import report_json
    from .report.html_report import report_html
    report_json(opt, fr, pre, post)
    report_html(opt, fr, pre, post)


# ---------------------------------------------------- torch.distributed merge

COORDINATOR_ENV = "FASTPLONG_COORDINATOR"
# seconds a host waits for its peers, at the rendezvous and at the exchange
# of partials; a lost peer fails the run after this instead of hanging it
TIMEOUT_ENV = "FASTPLONG_COORDINATOR_TIMEOUT"
DEFAULT_TIMEOUT_S = 1800


def distributed_init_from_env(opt):
    """Join the `gloo` process group of opt.num_hosts hosts when a
    coordinator (host:port of host 0) is configured; returns whether it
    did.  Runs before the shard's run, so that a missing peer fails it
    early."""
    coord = os.environ.get(COORDINATOR_ENV, "")
    if not coord or opt.num_hosts <= 1:
        return False
    import torch.distributed as dist
    timeout = float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))
    try:
        dist.init_process_group("gloo", init_method="tcp://" + coord,
                                world_size=opt.num_hosts,
                                rank=opt.host_index,
                                timeout=timedelta(seconds=timeout))
    except dist.DistError as e:
        error_exit("--num_hosts: the %d hosts did not meet at %s within "
                   "%g s (%s): %s" % (opt.num_hosts, coord, timeout,
                                      TIMEOUT_ENV, e))
    return True


def allgather_bytes(blob):
    """All-gather one bytes blob per process; returns the list in process
    order.  Two collectives on uint8 CPU tensors: the lengths, then the
    data padded to the longest."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size()
    ln = torch.tensor([len(blob)], dtype=torch.int64)
    lens = [torch.zeros_like(ln) for _ in range(n)]
    dist.all_gather(lens, ln)
    maxlen = max(int(x.item()) for x in lens)
    pad = torch.zeros(maxlen, dtype=torch.uint8)
    pad[:len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    data = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(data, pad)
    return [data[i][:int(lens[i].item())].numpy().tobytes()
            for i in range(n)]


def finish_distributed(opt, pre, post, fr):
    """Report merge over the process group: every host contributes its
    partial, host 0 writes the final JSON/HTML (the cross-host
    Stats::merge analog), then the group is destroyed."""
    import torch.distributed as dist
    try:
        blobs = allgather_bytes(partial_bytes(opt, pre, post, fr))
        if dist.get_rank() == 0:
            mopt, mpre, mpost, mfr = merge_partial_blobs(blobs)
            # reports go to the unprefixed paths the user asked for
            mopt.json_file = opt.json_file_base
            mopt.html_file = opt.html_file_base
            write_merged_reports(mopt, mpre, mpost, mfr)
    finally:
        dist.destroy_process_group()
