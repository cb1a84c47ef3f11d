"""The port's spans (fastplong_tpu_torch/spans.py) on the CPU: with no
profiler running a job enters no `record_function` range; under
torch.profiler every span is a `fastplong.<name>` range on the trace's
clock, nested as process() nests them, each step stage holding the ops it
issued; the timer dump keeps its keys and its nesting sums; a daemon's
jobs dump apart; a worker thread's span never parents the main thread's;
concurrent spans lose no time."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fastplong_tpu_torch import main as tmain
from fastplong_tpu_torch import spans as spans_mod
from fastplong_tpu_torch.pipeline import device as tdev
from fastplong_tpu_torch.pipeline import sharding as tsh
from golden_util import write_random_fastq
from test_torch_daemon import _cli, _io, _jobs, daemon_env  # noqa: F401

START = "AATGTACTTCGTTCAGTTACGTATTGCT"
END = "AGCAATACGTAACTGAACGAAGT"
HEADLINE = ["-s", START, "-e", END, "-5", "-3", "-x"]

# the innermost port span around each span, as process() nests them
PARENT = {
    "job": None,
    "evaluator": "job", "runner_init": "job", "runner_run": "job",
    "reports": "job",
    "report_summary": "reports", "report_json": "reports",
    "report_html": "reports",
    "prefix": "evaluator", "seq_len_rna": "evaluator",
    "read_num": "evaluator", "kmer_matrix": "evaluator",
    "kmer_fill": "evaluator", "kmer_copy": "evaluator",
    "top_key": "evaluator", "extend": "evaluator",
    "total_loop": "runner_run", "writer_close": "runner_run",
    "stats_finish": "runner_run",
    "read_parse": "total_loop", "pack": "total_loop",
    "dispatch": "total_loop", "device_wait": "total_loop",
    "accumulate": "total_loop", "emit": "total_loop",
    "host_stats": "accumulate",
    "stats_fetch": "stats_finish", "stats_summarize": "stats_finish",
    "step": "dispatch",
}
STEP_STAGES = ("step.unpack", "step.stats_pre", "step.trim_cut",
               "step.polyx", "step.adapter", "step.middle_split",
               "step.regions", "step.filters", "step.stats_post",
               "step.pack")
PARENT.update({s: "step" for s in STEP_STAGES})
LAYER = {"phase_seconds": ("job", "evaluator", "runner_init", "runner_run",
                           "reports", "report_summary", "report_json",
                           "report_html"),
         "evaluator_seconds": ("prefix", "seq_len_rna", "read_num",
                               "kmer_matrix", "kmer_fill", "kmer_copy",
                               "top_key", "extend")}
# the flag sets of the traced jobs: the headline with break and mask
# (every step stage), and fastplong's defaults (auto-detection)
JOBS = {"headline": HEADLINE + ["-b", "-N"], "detect": []}


def _input(path, n_reads=150, seed=21):
    return write_random_fastq(path, n_reads=n_reads, min_len=40,
                              max_len=1400, seed=seed, adapter_start=START,
                              adapter_end=END, adapter_prob=0.6,
                              polya_prob=0.3)


def _job(d, fq, flags):
    os.makedirs(d, exist_ok=True)
    rc = tmain.main(["fastplong", "-i", fq, "-o", os.path.join(d, "o.fq"),
                     "-j", os.path.join(d, "r.json"),
                     "-h", os.path.join(d, "r.html")] + flags)
    assert rc == 0


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each of JOBS once under torch.profiler (CPU activity), with the
    statistics cap lowered to the first bucket (1,024) so that both the
    per-slice and the monster accumulators run: {name: (trace events,
    dump)}."""
    d = str(tmp_path_factory.mktemp("spans"))
    fq = _input(os.path.join(d, "in.fq"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
        mp.setenv("FASTPLONG_STAT_DEVICE_CAP", "1024")
        for name, flags in JOBS.items():
            dump = os.path.join(d, name + ".json")
            mp.setenv("FASTPLONG_TIMER_DUMP", dump)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                _job(os.path.join(d, name), fq, flags)
            trace = os.path.join(d, name + ".trace.json")
            prof.export_chrome_trace(trace)
            with open(trace) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X"]
            with open(dump) as f:
                out[name] = (events, json.load(f))
    return out


def _ranges(events):
    """The port's ranges: (start, end, name without the prefix, tid)."""
    return [(e["ts"], e["ts"] + e["dur"], e["name"][len("fastplong."):],
             e["tid"]) for e in events
            if e.get("cat") == "user_annotation"
            and e["name"].startswith(spans_mod.PREFIX)]


def _innermost(ranges, r):
    """The smallest port range on r's thread that holds r."""
    best = None
    for o in ranges:
        if (o is not r and o[3] == r[3] and o[0] <= r[0] and r[1] <= o[1]
                and (best is None or o[1] - o[0] < best[1] - best[0])):
            best = o
    return best[2] if best else None


def _names(dump):
    return {k for layer in ("phase_seconds", "evaluator_seconds",
                            "stage_seconds") for k in dump[layer]}


def test_no_profiler_enters_no_range(tmp_path, monkeypatch):
    """A job with no profiler running enters record_function zero times,
    though it times every span; a span under a profiler enters one."""
    calls = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    dump = str(tmp_path / "dump.json")
    monkeypatch.setenv("FASTPLONG_TIMER_DUMP", dump)
    _job(str(tmp_path / "out"), _input(str(tmp_path / "in.fq"), 60),
         HEADLINE)
    assert calls == []
    with open(dump) as f:
        stages = json.load(f)["stage_seconds"]
    assert {"dispatch", "step", "step.adapter"} <= set(stages)
    with profile(activities=[ProfilerActivity.CPU]):
        with spans_mod.standalone()("probe"):
            pass
    assert calls == ["fastplong.probe"]


@pytest.mark.parametrize("name", sorted(JOBS))
def test_trace_nests_the_spans(traced, name):
    """Every span of the dump is in the trace as a user_annotation range,
    inside the range of the span listed as its parent."""
    events, dump = traced[name]
    ranges = _ranges(events)
    names = _names(dump)
    assert {r[2] for r in ranges} == names
    for r in ranges:
        assert _innermost(ranges, r) == PARENT[r[2]], r
    want = ({"kmer_fill", "top_key"} if name == "detect"
            else {"step.regions", "step.middle_split", "step.polyx"})
    assert want <= names
    # both statistics accumulators ran: the per-slice one and the monster
    # one (step calls with statistics for the buckets over the cap)
    assert {"step.stats_pre", "stats_fetch"} <= names
    assert dump["monster_step_calls"] > 0


def test_step_stages_hold_their_ops(traced):
    """In the traced job, each step stage's range holds at least one aten
    op, and every op in a stage lies inside a `fastplong.step` range."""
    events, _ = traced["headline"]
    ranges = _ranges(events)
    ops = [(e["ts"], e["tid"]) for e in events if e.get("cat") == "cpu_op"]
    steps = [r for r in ranges if r[2] == "step"]
    stages = [r for r in ranges if r[2] in STEP_STAGES]
    assert {r[2] for r in stages} == set(STEP_STAGES)
    for a, b, n, tid in stages:
        inside = [t for t, t_tid in ops if t_tid == tid and a <= t <= b]
        assert inside, n
        assert all(any(sa <= t <= sb for sa, sb, _, _ in steps)
                   for t in inside), n


def test_step_call_ops_start_in_its_range():
    """One call of the sharded step over two CPU slices, inside a span,
    under the profiler: every aten op it issues starts inside one of its
    two `fastplong.step` ranges, except the empty host rows it allocates
    first; outside a span it opens none."""
    argv = ["fastplong", "-i", "in.fq", "-o", "out.fq"] + HEADLINE + [
        "-b", "-N"]
    opt = tmain.options_from_args(tmain.build_parser().parse_args(argv[1:]),
                                  argv)
    place = tsh.Placement(["cpu"] * 2)
    fast, _ = tsh.build_fast_sharded_step(tdev.kernel_params(opt), place)
    rng = np.random.default_rng(5)
    B, L = 16, 256
    lens = rng.integers(40, L + 1, B).astype("<u4")
    meta = np.zeros((B, 8), np.uint8)
    meta[:, :4] = lens.view(np.uint8).reshape(B, 4)
    meta[:, 4] = 1
    packed = np.concatenate(
        [rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L)),
         rng.integers(35, 74, size=(B, L)).astype(np.uint8), meta], 1)
    states = place.init_state(tdev.global_stat_len())
    _, parts = place.split_rows(packed)
    stage = spans_mod.Spans().layer("stage_seconds")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stage("dispatch"):
            fast(states, parts, L)
    steps = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name == "fastplong.step"]
    assert len(steps) == 2
    outside = {e.name for e in prof.events()
               if e.name.startswith("aten::")
               and not any(a <= e.time_range.start <= b for a, b in steps)}
    assert outside == {"aten::empty"}
    assert set(stage.seconds) == {"dispatch", "step"} | set(STEP_STAGES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fast(states, parts, L)
    assert not any(e.name.startswith(spans_mod.PREFIX)
                   for e in prof.events())


@pytest.mark.parametrize("name", sorted(JOBS))
def test_dump_keeps_its_keys_and_nesting_sums(traced, name):
    """Every key the dump had, in the dict of its layer, and every span
    at least the sum of the spans it holds (4-decimal rounding aside)."""
    _, dump = traced[name]
    assert set(dump) == {"device", "phase_seconds", "evaluator_seconds",
                         "stage_seconds", "step_calls", "monster_step_calls",
                         "monster_stat_len", "host_stat_batches",
                         "launches"}
    assert dump["step_calls"] > 0
    for layer, names in LAYER.items():
        assert set(dump[layer]) <= set(names)
    assert {"evaluator", "runner_init", "runner_run",
            "reports"} <= set(dump["phase_seconds"])
    assert {"read_parse", "pack", "dispatch", "device_wait", "accumulate",
            "emit", "writer_close", "stats_finish",
            "total_loop"} <= set(dump["stage_seconds"])
    seconds = {k: v for layer in LAYER.keys() | {"stage_seconds"}
               for k, v in dump[layer].items()}
    for parent in set(PARENT.values()) - {None}:
        kids = [k for k, p in PARENT.items() if p == parent and k in seconds]
        if kids:
            assert seconds[parent] + 1e-4 * len(kids) >= sum(
                seconds[k] for k in kids), parent


def test_daemon_jobs_dump_apart(tmp_path, daemon_env):  # noqa: F811
    """Two jobs of one daemon write two dumps, each of its own job: the
    auto-detecting polyX job's evaluator and step stages are not in the
    next job's, which detects nothing and trims no polyX."""
    fq = _input(str(tmp_path / "in.fq"), 120)
    dumps = [str(tmp_path / "d0.json"), str(tmp_path / "d1.json")]
    for k, flags in enumerate((["-x"], ["-A"])):
        r = _cli(["-i", fq] + flags + _io(tmp_path / ("r%d" % k)),
                 env={"FASTPLONG_TIMER_DUMP": dumps[k]})
        assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert len(_jobs(daemon_env)) == 2
    first, second = (json.load(open(p)) for p in dumps)
    assert {"kmer_fill", "top_key"} <= set(first["evaluator_seconds"])
    assert "step.polyx" in first["stage_seconds"]
    assert not {"kmer_fill", "top_key"} & set(second["evaluator_seconds"])
    assert not {"step.polyx", "step.adapter"} & set(second["stage_seconds"])


def test_worker_span_is_not_the_main_threads_parent():
    """A span open on a worker thread (the host-statistics pre pass, in a
    layer of its own here) is not the parent of the main thread's next
    child span, which lands in the layer of the main thread's open span;
    the worker's own child lands in the worker's layer, and a child with
    no span open on its thread is no span."""
    spans = spans_mod.Spans()
    main, pre = spans.layer("stage_seconds"), spans.layer("worker")
    opened, release = threading.Event(), threading.Event()

    def worker():
        with pre("host_stats_pre"):
            opened.set()
            assert release.wait(30)
            with spans_mod.child("inner"):
                pass

    with main("dispatch"):
        t = threading.Thread(target=worker)
        t.start()
        assert opened.wait(30)
        with spans_mod.child("step"):
            pass
        release.set()
        t.join(30)
    assert not t.is_alive()
    with spans_mod.child("outside"):
        pass
    assert set(main.seconds) == {"dispatch", "step"}
    assert set(pre.seconds) == {"host_stats_pre", "inner"}


def test_concurrent_spans_lose_no_time(monkeypatch):
    """Eight threads closing 2,000 spans each of one name, on a clock
    that steps by exactly one a read and a short switch interval: the
    name's total is every span's second, none lost."""
    local = threading.local()

    class Clock:
        @staticmethod
        def perf_counter():
            local.t = getattr(local, "t", 0.0) + 1.0
            return local.t

    monkeypatch.setattr(spans_mod, "time", Clock)
    stage = spans_mod.Spans().layer("stage_seconds")

    def work():
        for _ in range(2000):
            with stage("pack"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert stage.seconds == {"pack": 16000.0}
