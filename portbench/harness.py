"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name that BENCHMARK.json gives:
configs/<name>.json (its `file` entry), traffic/<name>.json and
metrics/<name>.py.  A configuration that names a `reference` is checked
against references/<reference>.py; one that names none, against
reference.py.
"""

import contextlib
import gc
import importlib.util
import io
import json
import os
import re
import resource
import shutil
import sys
import tempfile
import time

from portbench import check, gen, reference, tracing, work

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "fastplong_tpu")
TRACE_MIN_S = 2.0     # the traced stretch: whole jobs, at least this long
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


# ------------------------------------------------------------ the cell


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix and
    metrics, each read from its own file."""

    def __init__(self, name, root=ROOT):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError("no workload %r in BENCHMARK.json" % name)
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        with open(os.path.join(root, conf["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(root, "portbench", "traffic",
                               self.workload["traffic"] + ".json")) as f:
            self.mix = json.load(f)
        self.root = root
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]
        self.reference = self._reference(self.config.get("reference"))
        unknown = sorted(set(self.config["params"])
                         - set(self.reference.PARAMS))
        if unknown:
            raise ValueError(
                "%s: params %s are not modelled by its reference %s" % (
                    conf["file"], ", ".join(unknown),
                    self.config.get("reference", "reference.py")))

    def _has(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def _reference(self, name):
        """The configuration's plain reference: references/<name>.py, or
        reference.py where the configuration names none."""
        if name is None:
            return reference
        if not isinstance(name, str) or not NAME.match(name):
            raise ValueError("reference %r is not a name" % (name,))
        path = os.path.join(self.root, "portbench", "references",
                            name + ".py")
        if not os.path.isfile(path):
            raise FileNotFoundError("the configuration's reference %s is "
                                    "missing" % path)
        return load_module(path, "portbench_reference_" + name)

    def expected(self, raw, device="cpu", control=None):
        """The reference's expected output of one input file's bytes under
        this configuration's parameters."""
        return self.reference.expected(raw, self.config["params"], device,
                                       control=control)

    def metric_reader(self, name):
        path = os.path.join(self.root, "portbench", "metrics", name + ".py")
        return load_module(path, "portbench_metric_" + name).read


def load_module(path, name):
    """The module of a file under the benchmark, found by its path."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ one job


class Sink:
    """Stands in for sys.stdout during a job: takes the passing reads that
    the program writes to it, and nothing of them reaches the disk.

    Given `like`, the stream of an earlier job over the same file, it
    compares each write with `like` where the write falls and keeps
    nothing while the two agree; from the first write that departs, it
    keeps the stream (the agreeing part before it too).  So only the first
    job of each file holds its stream in memory, and a later job only
    where it differs from that."""

    def __init__(self, like=None):
        self.like = like
        self.pos = 0
        self.parts = [] if like is None else None
        self.buffer = self

    def write(self, data):
        if isinstance(data, str):
            data = data.encode()
        n = memoryview(data).nbytes
        if self.parts is None:
            if self.like.startswith(data, self.pos):
                self.pos += n
                return n
            self.parts = [self.like[:self.pos]]
        self.parts.append(bytes(data))
        self.pos += n
        return n

    def flush(self):
        pass

    def value(self):
        if self.parts is not None:
            return b"".join(self.parts)
        if self.pos == len(self.like):
            return self.like
        return self.like[:self.pos]


class Job:
    def __init__(self, index, name, bases):
        self.index, self.name, self.bases = index, name, bases
        self.wall = 0.0
        self.cpu = 0.0        # the process's user and system seconds
        self.failed = False
        self.error = ""
        self.stream = b""
        self.report = ""
        self.phases, self.stages, self.step_calls = {}, {}, 0
        self.evaluator = False
        self.traced = False


class Program:
    """The port, imported from this checkout, and how to run one job of
    it in process."""

    def __init__(self, device, tmp, flags):
        if ROOT not in sys.path:
            sys.path.insert(0, ROOT)
        os.environ["FASTPLONG_TORCH_DEVICE"] = device
        self.dump = os.path.join(tmp, "timer.json")
        os.environ["FASTPLONG_TIMER_DUMP"] = self.dump
        import fastplong_tpu_torch
        from fastplong_tpu_torch import main as fmain, processor
        from fastplong_tpu_torch.ops import cuda_lib
        from fastplong_tpu_torch.pipeline import runner
        where = os.path.dirname(os.path.abspath(fastplong_tpu_torch.__file__))
        if os.path.dirname(where) != ROOT:
            raise RuntimeError("fastplong_tpu_torch came from %s, not from "
                               "this checkout" % where)
        self.main = fmain.main
        self.modules = {"cuda_lib": cuda_lib, "processor": processor,
                        "runner": runner}
        self.json = os.path.join(tmp, "report.json")
        self.html = os.path.join(tmp, "report.html")
        self.flags = list(flags)

    def run(self, job, path, like=None):
        """Run one job over `path`; `like` is the stream of an earlier
        job over the same file, if any (see Sink)."""
        argv = (["fastplong", "-i", path] + self.flags
                + ["-j", self.json, "-h", self.html, "--stdout"])
        sink, err = Sink(like), io.StringIO()
        old_out = sys.stdout
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        try:
            sys.stdout = sink
            with contextlib.redirect_stderr(err):
                rc = self.main(argv)
            if rc:
                job.failed, job.error = True, "exit code %r" % rc
        except SystemExit as e:
            if e.code:
                job.failed, job.error = True, "exit %r" % e.code
        except Exception as e:     # a failed job is counted, not fatal
            job.failed, job.error = True, "%s: %s" % (type(e).__name__, e)
        finally:
            sys.stdout = old_out
        job.wall = time.perf_counter() - t0
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        job.cpu = (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)
        job.stream = sink.value()
        job.evaluator = "Trying to detect adapter" in err.getvalue()
        if job.failed:
            job.error += " | " + err.getvalue()[-600:]
            return job
        with open(self.json) as f:
            job.report = f.read()
        with open(self.dump) as f:
            d = json.load(f)
        job.phases = d.get("phase_seconds", {})
        job.stages = d.get("stage_seconds", {})
        job.step_calls = int(d.get("step_calls", 0))
        return job


# ------------------------------------------------------------ the run


class RunData:
    """What a metric reader reads: the window's jobs and, in a traced run,
    the traced stretch's summary."""

    def __init__(self, jobs, trace):
        self.jobs = jobs
        self.trace = trace

    def timed_jobs(self):
        """The window's jobs that ran without the profiler."""
        return [j for j in self.jobs if not j.traced and not j.failed]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg):
    sys.stderr.write("portbench: %s\n" % msg)
    sys.stderr.flush()


def run_cell(cell, seed, seconds, trace, device, t_start):
    """Set up, run the window, check and measure; returns the result dict
    (the last line's object, `checks` last) or raises."""
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(cell, seed, seconds, trace, device, t_start, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t_start, tmp):
    import torch
    cuda = device == "cuda"
    prog = Program(device, tmp, cell.config["flags"])
    if cuda:
        from fastplong_tpu_torch.native import get_lib
        built = os.path.exists(prog.modules["cuda_lib"].library_path())
        prog.modules["cuda_lib"].lib()
        get_lib()
        log("kernel library %s" % ("found" if built else "built"))
    t_gen = time.perf_counter()
    files, (warm, warm_bases) = gen.write_files(cell.mix, seed, tmp)
    t_warm = time.perf_counter()
    prog.run(Job(-1, "warm", warm_bases), warm)
    if cuda:
        torch.cuda.synchronize()
    log("set-up: %.3f s to the port's import and library, %.3f s "
        "generating, %.3f s the warm-up job" % (
            t_gen - t_start, t_warm - t_gen, time.perf_counter() - t_warm))

    # the window: one job per file, back to back, until the first job that
    # ends after `seconds`; in a traced run the stretch from the second job
    # on, whole jobs of at least TRACE_MIN_S, is profiled
    jobs = []
    streams = {}      # file -> the stream of its first job
    tracer = stretch = traced_events = None
    state = "pending" if trace else "off"
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        k = len(jobs)
        path, bases = files[k % len(files)]
        job = Job(k, os.path.basename(path), bases)
        if state == "pending" and k >= 1:
            tracer = tracing.Tracer(prog.modules, cuda)
            tracer.start()
            stretch = torch.profiler.record_function("portbench.stretch")
            stretch.__enter__()
            traced_t0 = time.perf_counter()
            state = "active"
        if state == "active":
            job.traced = True
            with torch.profiler.record_function("portbench.job"):
                prog.run(job, path, streams.get(job.name))
            if time.perf_counter() - traced_t0 >= TRACE_MIN_S:
                stretch.__exit__(None, None, None)
                traced_events = tracer.stop(os.path.join(tmp, "trace.json"))
                state = "done"
        else:
            prog.run(job, path, streams.get(job.name))
        if not job.failed:
            streams.setdefault(job.name, job.stream)
        jobs.append(job)
        if (time.perf_counter() - t0 >= seconds
                and state in ("off", "done")):
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    bad = forbidden_modules()
    if bad:
        raise RuntimeError("modules of JAX or the JAX package loaded: %s"
                           % ", ".join(bad))

    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    trace_summary = None
    if trace:
        traced = [j for j in jobs if j.traced]
        trace_summary = tracing.summarize(
            traced_events, tracer.launches,
            sum(j.step_calls for j in traced), work.launch_bound_s,
            set(work.KERNELS.values()))
        tracer.launches = []
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: the reference over each input file the window used
    t_ref = time.perf_counter()
    want = {}

    def expected_of(job):
        if job.name not in want:
            with open(os.path.join(tmp, job.name), "rb") as f:
                raw = f.read()
            want[job.name] = cell.expected(raw, device)
        return want[job.name]

    numbers, notes = check.compare(jobs, expected_of)
    log("reference %.1f s over %d files" % (time.perf_counter() - t_ref,
                                             len(want)))
    for note in notes:
        log(note)
    correct = check.is_correct(numbers)

    bases = sum(j.bases for j in jobs)
    metrics = {}
    if not trace:
        values = {"mbases_per_s": bases / window_s / 1e6, "setup_s": setup_s,
                  "memory_peak_mb": memory_peak / 1e6 if cuda else None}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        data = RunData(jobs, trace_summary)
        for m in cell.per_layer:
            v = cell.metric_reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": memory_peak,
           "power_limit_w": power_limit() if cuda else None}
    result = {"correct": correct, "attempted": len(jobs),
              "failed": numbers["jobs_failed"], "metrics": metrics,
              "device": dev}
    if trace and trace_summary is not None:
        dev["busy_s"] = trace_summary["busy_s"]
        dev["window_s"] = trace_summary["window_s"]
        result["breakdown"] = trace_summary["breakdown"]
    log("window %.3f s, %d jobs, %d bases, setup %.3f s" % (
        window_s, len(jobs), bases, setup_s))
    log("job walls: %s" % " ".join("%.3f" % j.wall for j in jobs))
    log("job cpu s: %s" % " ".join("%.3f" % j.cpu for j in jobs))
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    return result


def power_limit():
    """The card's power limit in watts, as nvidia-smi reads it."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None
