"""Top-level processing flow.

Port of fastplong_tpu/processor.py, mirroring the reference main() sequence
(src/main.cpp:258-305): evaluator pre-passes (sequence length / RNA check,
adapter auto-detection, read-count estimation for splitting), option
validation, then the pipeline run and reports (src/seprocessor.cpp:105-146).
"""

import json
import os
import sys
import time

from . import resolve_device
from .evaluator import Evaluator
from .report.html_report import report_html
from .report.json_report import report_json


def _profiled_run(runner, trace_dir):
    """--profile DIR: runner.run() under torch.profiler (host ops, and the
    card's kernels when the run is on CUDA), written into DIR as one
    <host>_<pid>.<ms>.pt.trace.json that TensorBoard's PyTorch profiler
    plugin and Perfetto open."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if runner.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        return runner.run()


def _launch_counts():
    """Each CUDA kernel's launch count so far in this process, by the name
    chip_smoke.py gives it (the wrappers' `launches` counters, which keep
    counting across the jobs of a daemon)."""
    from .ops.adapter import seed_scan
    from .ops.kmer import kmer_hist
    from .ops.mismatch import mismatch_scan
    from .ops.myers import myers_blockscan, myers_verify
    from .ops.regions import detect_regions_summary
    from .ops.stats_kernels import stat_batch_into
    return {"mismatch_scan": mismatch_scan.launches,
            "myers_verify": myers_verify.launches,
            "seed_scan": seed_scan.launches,
            "stat_batch": stat_batch_into.launches,
            "regions": detect_regions_summary.launches,
            "kmer_hist": kmer_hist.launches,
            "myers_blockscan": myers_blockscan.launches}


def process(opt, device=None):
    """Run one configured job; device defaults to FASTPLONG_TORCH_DEVICE,
    else cuda (see fastplong_tpu_torch.resolve_device)."""
    from .pipeline.runner import SingleEndRunner
    device = resolve_device(device)
    phases = {}
    launches0 = _launch_counts()
    t0 = time.perf_counter()
    support_evaluation = (not opt.input_from_stdin
                          and opt.in_file != "/dev/stdin")

    eva = Evaluator(opt, device)
    if support_evaluation:
        # one shared prefix pass feeds seq-len/RNA, adapter detection and
        # read-count estimation
        eva.load_prefix(opt.shall_detect_adapter(),
                        opt.split.need_evaluation)
        eva.evaluate_seq_len_and_check_rna()

    read_num = 0
    if opt.shall_detect_adapter():
        if not support_evaluation:
            sys.stderr.write("Adapter auto-detection is disabled for STDIN mode\n")
        else:
            read_num = eva.eval_adapter_and_read_num()
            sys.stderr.write("\n")

    opt.validate()

    if opt.split.need_evaluation and support_evaluation:
        if read_num == 0:
            read_num = eva.evaluate_read_num()
        opt.split.size = read_num // opt.split.number
        if opt.split.size <= 0:
            opt.split.size = 1
            sys.stderr.write("WARNING: the input file has less reads than the"
                             " number of files to split\n")

    phases["evaluator"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner = SingleEndRunner(opt, device)
    phases["runner_init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if opt.profile_dir:
        pre_stats, post_stats, filter_result = _profiled_run(
            runner, opt.profile_dir)
    else:
        pre_stats, post_stats, filter_result = runner.run()
    phases["runner_run"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    if opt.verbose:
        from .util import loginfo
        loginfo("start to generate reports\n")

    sys.stderr.write("Before filtering:\n")
    pre_stats.print_summary(sys.stderr)
    sys.stderr.write("\n")
    sys.stderr.write("After filtering:\n")
    post_stats.print_summary(sys.stderr)
    sys.stderr.write("\n")
    sys.stderr.write("Filtering result:\n")
    filter_result.print_summary(sys.stderr, opt)

    report_json(opt, filter_result, pre_stats, post_stats)
    report_html(opt, filter_result, pre_stats, post_stats)
    phases["reports"] = time.perf_counter() - t0

    dump = os.environ.get("FASTPLONG_TIMER_DUMP")
    if dump:
        # diagnostics: per-phase and per-stage wall breakdown of this run
        with open(dump, "w") as f:
            json.dump({"device": str(runner.device),
                       "phase_seconds": {k: round(v, 4)
                                         for k, v in phases.items()},
                       "evaluator_seconds": {k: round(v, 4) for k, v
                                             in eva.seconds.items()},
                       "stage_seconds": runner.timer.report(),
                       "step_calls": runner.step_calls,
                       # this job's launches alone
                       "launches": {k: v - launches0[k] for k, v
                                    in _launch_counts().items()}}, f)
    return pre_stats, post_stats, filter_result
