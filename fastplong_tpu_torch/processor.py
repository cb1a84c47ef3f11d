"""Top-level processing flow.

Port of fastplong_tpu/processor.py, mirroring the reference main() sequence
(src/main.cpp:258-305): evaluator pre-passes (sequence length / RNA check,
adapter auto-detection, read-count estimation for splitting), option
validation, then the pipeline run and reports (src/seprocessor.cpp:105-146).
"""

import contextlib
import json
import os
import sys

from . import resolve_device
from .evaluator import Evaluator
from .report.html_report import report_html
from .report.json_report import report_json
from .spans import Spans


@contextlib.contextmanager
def _profiled(trace_dir, device):
    """--profile DIR: the whole job (evaluator, runner and reports) under
    torch.profiler (host ops and the port's spans, and the card's kernels
    when the job runs on CUDA), written into DIR as one
    <host>_<pid>.<ms>.pt.trace.json that TensorBoard's PyTorch profiler
    plugin and Perfetto open.  Without DIR it profiles nothing."""
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


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


def process(opt, device=None, devices=None):
    """Run one configured job; device defaults to FASTPLONG_TORCH_DEVICE,
    else cuda (see fastplong_tpu_torch.resolve_device).  devices, a list in
    which a device may repeat, runs the step's row slices on them
    (SingleEndRunner); the evaluator runs on the first device."""
    from .pipeline.runner import SingleEndRunner
    device = resolve_device(device if devices is None else devices[0])
    spans = Spans()
    phase = spans.layer("phase_seconds")
    launches0 = _launch_counts()
    with _profiled(opt.profile_dir, device), phase("job"):
        with phase("evaluator"):
            eva = Evaluator(opt, device, spans.layer("evaluator_seconds"))
            _evaluate(opt, eva)
        with phase("runner_init"):
            runner = SingleEndRunner(opt, device, devices,
                                     spans.layer("stage_seconds"))
        with phase("runner_run"):
            pre_stats, post_stats, filter_result = runner.run()
        with phase("reports"):
            if opt.verbose:
                from .util import loginfo
                loginfo("start to generate reports\n")
            with phase("report_summary"):
                sys.stderr.write("Before filtering:\n")
                pre_stats.print_summary(sys.stderr)
                sys.stderr.write("\n")
                sys.stderr.write("After filtering:\n")
                post_stats.print_summary(sys.stderr)
                sys.stderr.write("\n")
                sys.stderr.write("Filtering result:\n")
                filter_result.print_summary(sys.stderr, opt)
            with phase("report_json"):
                report_json(opt, filter_result, pre_stats, post_stats)
            with phase("report_html"):
                report_html(opt, filter_result, pre_stats, post_stats)

    dump = os.environ.get("FASTPLONG_TIMER_DUMP")
    if dump:
        # diagnostics: this job's spans by layer (phase_seconds,
        # evaluator_seconds, stage_seconds), its step calls (those into
        # the monster accumulator apart, with its final cycle length, and
        # the monster batches statted on the host) and launches
        with open(dump, "w") as f:
            json.dump({"device": str(runner.device), **spans.report(),
                       "step_calls": runner.step_calls,
                       "monster_step_calls": runner.monster_step_calls,
                       "monster_stat_len": runner.monster_stat_len,
                       "host_stat_batches": runner.host_stat_batches,
                       # this job's launches alone
                       "launches": {k: v - launches0[k] for k, v
                                    in _launch_counts().items()}}, f)
    return pre_stats, post_stats, filter_result


def _evaluate(opt, eva):
    """The evaluator's pre-passes (sequence length and RNA, adapter
    auto-detection, the read count for --split) and option validation."""
    support_evaluation = (not opt.input_from_stdin
                          and opt.in_file != "/dev/stdin")
    if support_evaluation:
        # one shared prefix pass feeds seq-len/RNA, adapter detection and
        # read-count estimation
        with eva.spans("prefix"):
            eva.load_prefix(opt.shall_detect_adapter(),
                            opt.split.need_evaluation)
        with eva.spans("seq_len_rna"):
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
            with eva.spans("read_num"):
                read_num = eva.evaluate_read_num()
        opt.split.size = read_num // opt.split.number
        if opt.split.size <= 0:
            opt.split.size = 1
            sys.stderr.write("WARNING: the input file has less reads than the"
                             " number of files to split\n")
