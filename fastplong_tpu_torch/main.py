"""CLI entry point of the PyTorch/CUDA port — flag-for-flag compatible
with the reference fastplong (src/main.cpp:29-103) and with
fastplong_tpu.main, whose parser this copies.

Runs on CUDA unless FASTPLONG_TORCH_DEVICE=cpu.  With FASTPLONG_DAEMON=1
the job goes to the resident daemon (daemon.py), which runs it on the
device its client asked for.  The one flag whose code is not ported yet
(--devices above 1) stops with an error naming the ROADMAP item that ports
it.
"""

import argparse
import os
import sys
import time

from . import resolve_device
from .common import VERSION
from .config import Options
from .util import error_exit, num2qual, reverse_complement


def build_parser():
    p = argparse.ArgumentParser(
        prog="fastplong",
        description="ultra-fast FASTQ preprocessing and quality control for "
                    "long reads (PyTorch/CUDA port)",
        add_help=False)
    a = p.add_argument
    a("--help", action="help", help="print this message")
    a("-v", "--version", action="version",
      version="fastplong %s" % VERSION, help="print version")
    # input/output — help text mirrors the reference flag docs
    # (src/main.cpp:29-103)
    a("-i", "--in", dest="in_file", default="",
      help="read input file name")
    a("-o", "--out", default="",
      help="read output file name")
    a("--failed_out", default="",
      help="specify the file to store reads that cannot pass the filters.")
    a("-z", "--compression", type=int, default=4,
      help="compression level for gzip output (1 ~ 9). 1 is fastest, 9 is "
           "smallest, default is 4.")
    a("--stdin", action="store_true",
      help="input from STDIN.")
    a("--stdout", action="store_true",
      help="stream passing-filters reads to STDOUT. Disabled by default.")
    a("--reads_to_process", type=int, default=0,
      help="specify how many reads/pairs to be processed. Default 0 means "
           "process all reads.")
    a("--dont_overwrite", action="store_true",
      help="don't overwrite existing files. Overwritting is allowed by "
           "default.")
    a("-V", "--verbose", action="store_true",
      help="output verbose log information (i.e. when every 1M reads are "
           "processed).")
    # adapter
    a("-A", "--disable_adapter_trimming", action="store_true",
      help="adapter trimming is enabled by default. If this option is "
           "specified, adapter trimming is disabled")
    a("-s", "--start_adapter", default="auto",
      help="the adapter sequence at read start (5').")
    a("-e", "--end_adapter", default="auto",
      help="the adapter sequence at read end (3').")
    a("-a", "--adapter_fasta", default="",
      help="specify a FASTA file to trim both read by all the sequences in "
           "this FASTA file")
    a("-d", "--distance_threshold", type=float, default=0.25,
      help="threshold of sequence-adapter-distance/adapter-length "
           "(0.0 ~ 1.0), greater value means more adapters detected")
    a("--trimming_extension", type=int, default=10,
      help="when an adapter is detected, extend the trimming to make "
           "cleaner trimming, default 10 means trimming 10 bases more")
    # trimming
    a("-f", "--trim_front", type=int, default=0,
      help="trimming how many bases in front for read, default is 0")
    a("-t", "--trim_tail", type=int, default=0,
      help="trimming how many bases in tail for read, default is 0")
    # polyX
    a("-x", "--trim_poly_x", action="store_true",
      help="enable polyX trimming in 3' ends.")
    a("--poly_x_min_len", type=int, default=10,
      help="the minimum length to detect polyX in the read tail. 10 by "
           "default.")
    # quality cutting
    a("-5", "--cut_front", action="store_true",
      help="move a sliding window from front (5') to tail, drop the bases "
           "in the window if its mean quality < threshold, stop otherwise.")
    a("-3", "--cut_tail", action="store_true",
      help="move a sliding window from tail (3') to front, drop the bases "
           "in the window if its mean quality < threshold, stop otherwise.")
    a("-W", "--cut_window_size", type=int, default=None,
      help="the window size option shared by cut_front, cut_tail. "
           "Range: 1~1000, default: 4")
    a("-M", "--cut_mean_quality", type=int, default=None,
      help="the mean quality requirement option shared by cut_front, "
           "cut_tail. Range: 1~36 default: 20 (Q20)")
    a("--cut_front_window_size", type=int, default=None,
      help="the window size option of cut_front, default to "
           "cut_window_size if not specified")
    a("--cut_front_mean_quality", type=int, default=None,
      help="the mean quality requirement option for cut_front, default to "
           "cut_mean_quality if not specified")
    a("--cut_tail_window_size", type=int, default=None,
      help="the window size option of cut_tail, default to "
           "cut_window_size if not specified")
    a("--cut_tail_mean_quality", type=int, default=None,
      help="the mean quality requirement option for cut_tail, default to "
           "cut_mean_quality if not specified")
    # masking
    a("-N", "--mask", action="store_true",
      help="mask the low quality regions with N, these regions are "
           "detected by sliding window with mean quality < "
           "mask_mean_quality.")
    a("--mask_window_size", type=int, default=50,
      help="the size of the sliding window to evaluate the mean quality "
           "for N masking(5~1000000), default: 50")
    a("--mask_mean_quality", type=int, default=10,
      help="the mean quality requirement for sliding window N masking "
           "(5~30), default: 10 (Q10)")
    # breaking
    a("-b", "--break", dest="break_", action="store_true",
      help="break the reads by discarding the low quality regions, these "
           "regions are detected by sliding window with mean quality < "
           "break_mean_quality.")
    a("--break_window_size", type=int, default=100,
      help="the size of the sliding window to evaluate the mean quality "
           "for sliding window breaking(5~1000000), default: 100")
    a("--break_mean_quality", type=int, default=10,
      help="the mean quality requirement for sliding window breaking "
           "(5~30), default: 10 (Q10)")
    # quality filtering
    a("-Q", "--disable_quality_filtering", action="store_true",
      help="quality filtering is enabled by default. If this option is "
           "specified, quality filtering is disabled")
    a("-q", "--qualified_quality_phred", type=int, default=15,
      help="the quality value that a base is qualified. Default 15 means "
           "phred quality >=Q15 is qualified.")
    a("-u", "--unqualified_percent_limit", type=int, default=40,
      help="how many percents of bases are allowed to be unqualified "
           "(0~100). Default 40 means 40%%")
    a("--n_base_limit", type=int, default=1000000,
      help="if number of N base is >n_base_limit, then this read is "
           "discarded (0~1000000). 0 means no N allowed, default 1000000 "
           "means no N limit")
    a("-n", "--n_percent_limit", type=int, default=10,
      help="if one read's N base percentage is >n_percent_limit, then this "
           "read is discarded (0~100). Default 10 means 10%%")
    a("-m", "--mean_qual", type=int, default=0,
      help="if one read's mean_qual quality score <mean_qual, then this "
           "read is discarded. Default 0 means no requirement")
    # length filtering
    a("-L", "--disable_length_filtering", action="store_true",
      help="length filtering is enabled by default. If this option is "
           "specified, length filtering is disabled")
    a("-l", "--length_required", type=int, default=20,
      help="reads shorter than length_required will be discarded, default "
           "is 20.")
    a("--length_limit", type=int, default=0,
      help="reads longer than length_limit will be discarded, default 0 "
           "means no limitation.")
    # low complexity filter
    a("-y", "--low_complexity_filter", action="store_true",
      help="enable low complexity filter. The complexity is defined as the "
           "percentage of base that is different from its next base "
           "(base[i] != base[i+1]).")
    a("-Y", "--complexity_threshold", type=int, default=30,
      help="the threshold for low complexity filter (0~100). Default is "
           "30, which means 30%% complexity is required.")
    # reporting
    a("-j", "--json", default="fastplong.json",
      help="the json format report file name")
    a("-h", "--html", default="fastplong.html",
      help="the html format report file name")
    a("-R", "--report_title", default="fastplong report",
      help="should be quoted with ' or \", default is \"fastplong report\"")
    # threading
    a("-w", "--thread", type=int, default=3,
      help="worker thread number, default is 3")
    a("--devices", type=int, default=1,
      help="run the device step data-parallel over this many accelerator "
           "devices (extension; only 1 is ported), default is 1")
    a("--profile", default="",
      help="write a torch.profiler trace of the run (host ops, and the "
           "card's kernels on CUDA) into this directory, one "
           "*.pt.trace.json file that TensorBoard or Perfetto opens "
           "(extension), disabled by default")
    a("--stats_backend", choices=["device", "host", "auto"],
      default=os.environ.get("FASTPLONG_STATS", "auto"),
      help="where run statistics accumulate (extension): "
           "'device' keeps donated on-device accumulators drained once at "
           "end of run; 'host' computes them in a native host pass per "
           "batch; 'auto' means device on directly attached hardware. "
           "Identical output either way. Default auto (env "
           "FASTPLONG_STATS)")
    a("--num_hosts", type=int, default=1,
      help="shard the input file across this many hosts by record-aligned "
           "byte ranges (extension): each host writes 000N.-prefixed "
           "outputs and a stats partial; with FASTPLONG_COORDINATOR=host:port "
           "(host 0's address) host 0 also writes the merged reports, else "
           "merge the partials with python -m "
           "fastplong_tpu_torch.merge_reports. Default 1")
    a("--host_index", type=int, default=0,
      help="0-based index of this host's shard when --num_hosts > 1")
    # splitting
    a("--split", type=int, default=0,
      help="split output by limiting total split file number with this "
           "option (2~999), a sequential number prefix will be added to "
           "output name ( 0001.out.fq, 0002.out.fq...), disabled by "
           "default")
    a("--split_by_lines", type=int, default=0,
      help="split output by limiting lines of each file with this "
           "option(>=1000), a sequential number prefix will be added to "
           "output name ( 0001.out.fq, 0002.out.fq...), disabled by "
           "default")
    a("--split_prefix_digits", type=int, default=4,
      help="the digits for the sequential number padding (1~10), default "
           "is 4, so the filename will be padded as 0001.xxx, 0 to disable "
           "padding")
    a("--prewarm", action="store_true",
      help="run this configuration twice over a small synthetic input in "
           "a temporary directory and exit (extension); on a card the "
           "first pass builds the CUDA kernel library if it is absent, so "
           "a deployment pays nvcc here rather than in its first job; with "
           "FASTPLONG_DAEMON=1 both passes run in the resident daemon, "
           "which they start and warm")
    return p


def options_from_args(args, argv):
    opt = Options()
    opt.in_file = args.in_file
    opt.out = args.out
    opt.failed_out = args.failed_out
    opt.compression = args.compression
    opt.reads_to_process = args.reads_to_process
    opt.dont_overwrite = args.dont_overwrite
    opt.input_from_stdin = args.stdin
    opt.output_to_stdout = args.stdout
    opt.verbose = args.verbose
    opt.profile_dir = args.profile
    opt.stats_backend = args.stats_backend
    # argparse validates choices only for command-line values, not the
    # env-supplied default — reject a mistyped FASTPLONG_STATS the same way
    if opt.stats_backend not in ("device", "host", "auto"):
        error_exit("invalid stats backend '%s' (FASTPLONG_STATS / "
                   "--stats_backend): choose device, host or auto"
                   % opt.stats_backend)

    opt.adapter.enabled = not args.disable_adapter_trimming
    opt.adapter.sequence_start = args.start_adapter
    opt.adapter.sequence_end = args.end_adapter
    opt.adapter.fasta_file = args.adapter_fasta
    opt.adapter.ed_max = args.distance_threshold
    opt.adapter.trimming_extension = args.trimming_extension
    # end adapter defaults to revcomp of start (main.cpp:138-140)
    if opt.adapter.sequence_start != "auto" and opt.adapter.sequence_end == "auto":
        opt.adapter.sequence_end = reverse_complement(opt.adapter.sequence_start)
    if opt.adapter.fasta_file:
        opt.load_fasta_adapters()

    opt.trim.front = args.trim_front
    opt.trim.tail = args.trim_tail

    opt.polyx_trim.enabled = args.trim_poly_x
    opt.polyx_trim.min_len = args.poly_x_min_len

    qc = opt.quality_cut
    qc.enabled_front = args.cut_front
    qc.enabled_tail = args.cut_tail
    qc.window_size_shared = args.cut_window_size if args.cut_window_size is not None else 4
    qc.quality_shared = args.cut_mean_quality if args.cut_mean_quality is not None else 20
    qc.window_size_front = (args.cut_front_window_size
                            if args.cut_front_window_size is not None
                            else qc.window_size_shared)
    qc.quality_front = (args.cut_front_mean_quality
                        if args.cut_front_mean_quality is not None
                        else qc.quality_shared)
    qc.window_size_tail = (args.cut_tail_window_size
                           if args.cut_tail_window_size is not None
                           else qc.window_size_shared)
    qc.quality_tail = (args.cut_tail_mean_quality
                       if args.cut_tail_mean_quality is not None
                       else qc.quality_shared)
    if not qc.enabled_front and not qc.enabled_tail:
        if any(v is not None for v in (
                args.cut_window_size, args.cut_mean_quality,
                args.cut_front_window_size, args.cut_front_mean_quality,
                args.cut_tail_window_size, args.cut_tail_mean_quality)):
            sys.stderr.write(
                "WARNING: you specified the options for cutting by quality, "
                "but forgot to enable any of cut_front/cut_tail/cut_right. "
                "This will have no effect.\n")

    opt.qualfilter.enabled = not args.disable_quality_filtering
    opt.qualfilter.qualified_qual = ord(num2qual(args.qualified_quality_phred))
    opt.qualfilter.unqualified_percent_limit = args.unqualified_percent_limit
    opt.qualfilter.avg_qual_req = args.mean_qual
    opt.qualfilter.n_base_percent_limit = args.n_percent_limit
    opt.qualfilter.n_base_limit = args.n_base_limit

    opt.length_filter.enabled = not args.disable_length_filtering
    opt.length_filter.required_length = args.length_required
    opt.length_filter.max_length = args.length_limit

    opt.complexity_filter.enabled = args.low_complexity_filter
    opt.complexity_filter.threshold = min(100, max(0, args.complexity_threshold)) / 100.0

    opt.mask.enabled = args.mask
    opt.mask.window_size = args.mask_window_size
    opt.mask.quality = args.mask_mean_quality

    opt.break_opt.enabled = args.break_
    opt.break_opt.window_size = args.break_window_size
    opt.break_opt.quality = args.break_mean_quality

    opt.thread = args.thread
    opt.devices = args.devices
    opt.num_hosts = args.num_hosts
    opt.host_index = args.host_index

    opt.json_file = args.json
    opt.html_file = args.html
    opt.report_title = args.report_title

    opt.split.enabled = args.split > 0 or args.split_by_lines > 0
    opt.split.digits = args.split_prefix_digits
    if args.split > 0 and args.split_by_lines > 0:
        error_exit("You cannot set both splitting by file number (--split) "
                   "and splitting by file lines (--split_by_lines), please "
                   "choose either.")
    if args.split > 0:
        opt.split.number = args.split
        opt.split.need_evaluation = True
        opt.split.by_file_number = True
    if args.split_by_lines > 0:
        if args.split_by_lines % 4 != 0:
            error_exit("Line number (--split_by_lines) should be a multiple of 4")
        opt.split.size = args.split_by_lines // 4
        opt.split.need_evaluation = False
        opt.split.by_file_lines = True

    if opt.input_from_stdin or opt.in_file == "/dev/stdin":
        if opt.split.need_evaluation:
            error_exit("Splitting by file number is not supported in STDIN mode")

    # reference builds the command string with a trailing space (main.cpp:252-256)
    opt.command = "".join(a + " " for a in argv)
    return opt


def unsupported(opt):
    """The first flag of this run whose code is not ported yet, as an error
    message naming its ROADMAP item; None when the run is supported."""
    if opt.devices > 1:
        return "--devices above 1 is not ported yet (ROADMAP A.17)"
    return None


def _run_prewarm(argv):
    """--prewarm: run the given configuration twice over a small synthetic
    input (adapters planted so explicit-adapter configs exercise their
    exact kernel chain).  On a card the first pass builds the kernel
    library if it is absent (ops/cuda_lib.py), so the next real invocation
    starts with it built.  Outputs go to a temporary directory."""
    import shutil
    import tempfile
    args = [a for a in argv[1:] if a != "--prewarm"]
    # strip any I/O options the caller passed; prewarm supplies its own
    io_opts = {"-i", "--in", "-o", "--out", "--failed_out", "-j",
               "--json", "-h", "--html"}
    cleaned, skip = [], False
    start, end = "", ""
    for i, a in enumerate(args):
        if skip:
            skip = False
            continue
        if a in io_opts:
            skip = True
            continue
        if a.split("=", 1)[0] in io_opts:
            continue
        if a in ("-s", "--start_adapter") and i + 1 < len(args):
            start = args[i + 1]
        if a in ("-e", "--end_adapter") and i + 1 < len(args):
            end = args[i + 1]
        cleaned.append(a)
    if start and start != "auto" and (not end or end == "auto"):
        end = reverse_complement(start)
    d = tempfile.mkdtemp(prefix="fastplong_prewarm_")
    try:
        import numpy as np
        rng = np.random.default_rng(5)
        fq = os.path.join(d, "warm.fq")
        bases = np.frombuffer(b"ACGT", np.uint8)
        with open(fq, "wb") as f:
            for i in range(2000):
                n = max(60, int(rng.gamma(3.0, 700.0)))
                seq = rng.choice(bases, size=n).tobytes()
                if start and start != "auto" and rng.random() < 0.8:
                    seq = start.encode() + seq
                if end and end != "auto" and rng.random() < 0.8:
                    seq = seq + end.encode()
                q = rng.integers(38, 73, size=len(seq),
                                 dtype=np.uint8).tobytes()
                f.write(b"@w%d\n" % i + seq + b"\n+\n" + q + b"\n")
        base = ["fastplong", "-i", fq, "-o", os.path.join(d, "out.fq"),
                "-j", os.path.join(d, "r.json"),
                "-h", os.path.join(d, "r.html")] + cleaned
        t0 = time.time()
        rc = main(base) or 0
        t1 = time.time()
        if rc == 0:
            rc = main(base) or 0
        t2 = time.time()
        sys.stderr.write(
            "prewarm: cold pass %.1fs, warm pass %.1fs (rc=%d)\n"
            % (t1 - t0, t2 - t1, rc))
        return rc
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _run_multihost(opt, process, device):
    """Single-file multi-host shard run (see multihost.py)."""
    from . import multihost
    if opt.host_index < 0 or opt.host_index >= opt.num_hosts:
        error_exit("--host_index must be in [0, --num_hosts)")
    if opt.input_from_stdin or opt.in_file in ("/dev/stdin", "-"):
        error_exit("--num_hosts requires a seekable plain input file")
    is_gz = opt.in_file.endswith(".gz")
    if not is_gz:
        try:
            with open(opt.in_file, "rb") as f:
                is_gz = f.read(2) == b"\x1f\x8b"
        except OSError:
            error_exit("cannot read the input file: " + opt.in_file)
    if is_gz:
        error_exit("--num_hosts cannot byte-shard gzip input (no random "
                   "access); use parallel.py file sharding instead")
    if opt.split.enabled:
        error_exit("--split cannot be combined with --num_hosts")
    distributed = multihost.distributed_init_from_env(opt)
    opt.byte_range = multihost.compute_range(
        opt.in_file, opt.num_hosts, opt.host_index)
    opt.json_file_base = opt.json_file
    opt.html_file_base = opt.html_file
    for attr in ("out", "failed_out", "json_file", "html_file"):
        setattr(opt, attr,
                multihost.host_prefixed(getattr(opt, attr), opt.host_index))
    pre, post, fr = process(opt, device)
    part = "%s.part%d" % (opt.json_file_base, opt.host_index)
    multihost.save_partial(part, opt, pre, post, fr)
    sys.stderr.write("stats partial: %s\n" % part)
    if distributed:
        multihost.finish_distributed(opt, pre, post, fr)


def main(argv=None):
    if argv is None:
        argv = sys.argv
    if len(argv) > 1 and "--prewarm" in argv[1:]:
        return _run_prewarm(argv)
    # the warm daemon, before the arguments are parsed and before anything
    # imports torch: the client stays light, and the job runs where torch,
    # the CUDA context and the kernel library are loaded already.  When no
    # job could be handed over, it runs here, on the device it asks for
    if (os.environ.get("FASTPLONG_DAEMON") == "1"
            and os.environ.get("FASTPLONG_DAEMON_CHILD") != "1"
            and len(argv) > 1):
        from . import daemon
        if daemon.eligible(argv):
            rc = daemon.run_via_daemon(argv)
            if rc is not None:
                return rc
            sys.stderr.write("fastplong: daemon unavailable, "
                             "running in-process\n")
    if len(argv) == 1:
        sys.stderr.write(
            "fastplong: ultra-fast FASTQ preprocessing and quality control "
            "for long reads\nversion %s\n" % VERSION)
        build_parser().print_usage(sys.stderr)
        return 0
    args = build_parser().parse_args(argv[1:])
    opt = options_from_args(args, argv)
    msg = unsupported(opt)
    if msg:
        error_exit(msg)
    try:
        device = resolve_device()
    except (RuntimeError, ValueError) as e:
        error_exit(str(e))

    t1 = time.time()
    from .processor import process
    if opt.num_hosts > 1:
        _run_multihost(opt, process, device)
    else:
        process(opt, device)
    t2 = time.time()

    sys.stderr.write("\nJSON report: %s\n" % opt.json_file)
    sys.stderr.write("HTML report: %s\n" % opt.html_file)
    sys.stderr.write("\n%s\n" % opt.command)
    sys.stderr.write("fastplong v%s, time used: %d seconds\n"
                     % (VERSION, int(t2 - t1)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
