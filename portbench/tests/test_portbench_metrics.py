"""Each per-layer metric's arithmetic on recorded TIMER_DUMP records, a
recorded launch and a small device trace."""

import statistics

import pytest
import torch

from portbench import harness, tracing, work

# a job's TIMER_DUMP as the port writes it (phase and stage seconds)
DUMP = {"phase_seconds": {"evaluator": 0.35, "runner_init": 0.01,
                          "runner_run": 0.8, "reports": 0.4},
        "stage_seconds": {"read_parse": 0.1, "pack": 0.05, "dispatch": 0.2,
                          "device_wait": 0.01, "accumulate": 0.02,
                          "emit": 0.08, "writer_close": 0.01,
                          "stats_finish": 0.04},
        "step_calls": 3}


def job(i, wall, bases, scale=1.0, traced=False, evaluator=True):
    j = harness.Job(i, "in%02d.fq" % i, bases)
    j.wall = wall
    j.phases = {k: v * scale for k, v in DUMP["phase_seconds"].items()}
    j.stages = {k: v * scale for k, v in DUMP["stage_seconds"].items()}
    j.step_calls = DUMP["step_calls"]
    j.evaluator = evaluator
    j.traced = traced
    return j


@pytest.fixture
def cell(tiny_root):
    return harness.Cell("defaults_autodetect.tiny", root=tiny_root)


def read(cell, name, run):
    return cell.metric_reader(name)(run)


def test_timer_metrics(cell):
    jobs = [job(0, 1.0, 30_000_000), job(1, 1.2, 30_000_000, scale=2.0),
            job(2, 9.9, 30_000_000, scale=50.0, traced=True),
            job(3, 1.4, 40_000_000), job(4, 0.9, 20_000_000)]
    run = harness.RunData(jobs, None)
    timed = [j for j in jobs if not j.traced]
    assert read(cell, "reports.s_per_file", run) == pytest.approx(
        (0.4 + 0.8 + 0.4 + 0.4) / 4)
    assert read(cell, "evaluator.s_per_file", run) == pytest.approx(
        (0.35 + 0.7 + 0.35 + 0.35) / 4)
    gb = 120_000_000 / 1e9
    host = 0.1 + 0.05 + 0.02 + 0.08 + 0.01 + 0.04
    assert read(cell, "runner_host.s_per_gbase", run) == pytest.approx(
        host * 5 / gb)
    assert read(cell, "dispatch.s_per_gbase", run) == pytest.approx(
        0.2 * 5 / gb)
    assert read(cell, "file_s.p75", run) == pytest.approx(
        statistics.quantiles([j.wall for j in timed], n=4)[2])
    assert read(cell, "jobs.mbases_per_s", run) == pytest.approx(
        120 / (1.0 + 1.2 + 1.4 + 0.9))
    assert read(cell, "jobs.mbases_per_s", harness.RunData(
        [j for j in jobs if j.traced], None)) is None
    # nothing to read: no trace, or no auto-detection
    for name in ("step.device_ops_per_call", "kernels.roofline",
                 "device.idle_share"):
        assert read(cell, name, run) is None
    for j in jobs:
        j.evaluator = False
    assert read(cell, "evaluator.s_per_file", run) is None


def ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_trace_metrics(cell):
    # a 1,000 us stretch: a job with a runner span (200-700) and a reports
    # span (750-950); device work at 100-150 (evaluator copy), 300-400 and
    # 350-450 (overlapping kernels), 600-620
    events = [
        ev("portbench.stretch", 0, 1000, "user_annotation"),
        ev("portbench.job", 10, 980, "user_annotation"),
        ev("portbench.evaluator", 50, 140, "user_annotation"),
        ev("portbench.runner", 200, 500, "user_annotation"),
        ev("portbench.reports", 750, 200, "user_annotation"),
        ev("Memcpy HtoD (Pinned -> Device)", 100, 50, "gpu_memcpy"),
        ev("void stat_batch_kernel(Args)", 300, 100, "kernel"),
        ev("void at::native::reduce_kernel<512, 1>(int)", 350, 100, "kernel"),
        ev("void mismatch_bits_kernel<unsigned char, 3>(int)", 600, 20,
           "kernel"),
        ev("aten::add", 300, 5, "cpu_op"),
    ]
    bound = {"a": 30e-6, "b": 12e-6}
    t = tracing.summarize(events, [("a", []), ("b", [])], 2,
                          lambda e, a: bound[e], set(work.KERNELS.values()))
    assert t["window_s"] == pytest.approx(1000e-6)
    assert t["busy_s"] == pytest.approx((50 + 150 + 20) * 1e-6)
    assert t["runner_device_ops"] == 3
    run = harness.RunData([], t)
    assert read(cell, "step.device_ops_per_call", run) == pytest.approx(1.5)
    assert read(cell, "kernels.roofline", run) == pytest.approx(
        100 * 42e-6 / 120e-6)
    assert read(cell, "device.idle_share", run) == pytest.approx(
        100 * (1 - 220 / 1000))
    gaps = dict(t["breakdown"]["idle_gaps"])
    # idle: 0-100 (job), 150-300 (runner 200-300 holds the middle 225),
    # 450-600 and 620-1000 (reports holds 810)
    assert gaps["reports (total)"] == pytest.approx(380e-6)
    assert gaps["runner (total)"] == pytest.approx(300e-6)
    assert gaps["evaluator (total)"] == pytest.approx(100e-6)
    ops = dict(t["breakdown"]["device_ops"])
    assert ops["stat_batch_kernel"] == pytest.approx(100e-6)
    assert ops["at::native::reduce_kernel"] == pytest.approx(100e-6)


def test_recorded_launch_counts_its_tensors():
    """A launch recorded as the tracer records it: the stat kernel's
    arguments with its spans as tensors."""
    lo = torch.tensor([[0, 10]], dtype=torch.int32)
    hi = torch.tensor([[100, 10]], dtype=torch.int32)
    mask = torch.tensor([[True, True]])
    args = [None, None, 1, 2, 128, lo, hi, mask, 0, None, 128, None]
    nbytes, ops, peak = work.launch_work("fpl_stat_batch_into", args)
    assert (nbytes, ops) == (2 * 100 + 9 * 2 + 16 * (18 * 128 + 1168) + 2,
                             10 * 100)
    assert peak == work.WORD32_OPS_PER_S
