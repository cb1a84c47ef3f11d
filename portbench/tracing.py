"""The traced stretch of a `--trace 1` run: spans around the program's
layers, a record of every kernel launch, the profiler's device timeline, and
what the per-layer metrics and the breakdown read from them.

Everything here is installed for the traced stretch only and taken away
after it, from the benchmark's own files: a span (a `record_function` range,
named `portbench.<layer>`) around `processor.Evaluator`'s pre-passes,
`SingleEndRunner.run`, `processor.report_json` and `processor.report_html`;
a wrapper of `ops.cuda_lib.ptr` and `ops.cuda_lib.launch`, through which
every kernel launch of the program passes, that keeps each launch's entry
point and arguments (device pointers mapped back to the tensors they came
from, a large tensor by its shape alone) so that work.py can count its
bytes and operations.
"""

import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Shape:
    """What work.py reads of a large tensor argument: its shape, element
    count and element size, without the tensor itself."""

    def __init__(self, t):
        self.shape = tuple(t.shape)
        self._numel = t.numel()
        self._size = t.element_size()

    def numel(self):
        return self._numel

    def element_size(self):
        return self._size


def kept(entry, index, t):
    """What the launch record keeps of tensor argument `index`: the tensor
    where work.py reads its contents, else its Shape, so that the stretch
    holds no batch of bases, qualities or outputs past its launch."""
    from portbench.work import CONTENT_ARGS
    return t if index in CONTENT_ARGS.get(entry, ()) else Shape(t)


class Tracer:
    def __init__(self, modules, cuda=True):
        self.m = modules      # the program's modules the wrappers patch
        self.cuda = cuda
        self.launches = []    # (entry, args with tensors)
        self._saved = []
        self._ptrs = {}
        self.prof = None

    # ------------------------------------------------------------ wrappers

    def _patch(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def install(self):
        from torch.profiler import record_function
        cuda_lib = self.m["cuda_lib"]
        processor = self.m["processor"]
        runner_cls = self.m["runner"].SingleEndRunner
        orig_ptr, orig_launch = cuda_lib.ptr, cuda_lib.launch
        ptrs, launches = self._ptrs, self.launches

        def ptr(t):
            v = orig_ptr(t)
            ptrs[id(v)] = (v, t)
            return v

        def launch(entry, t, *args):
            rec = [kept(entry, i, ptrs[id(a)][1]) if id(a) in ptrs else a
                   for i, a in enumerate(args)]
            launches.append((entry, rec))
            ptrs.clear()
            return orig_launch(entry, t, *args)

        def spanned(name, fn):
            def wrapper(*a, **k):
                with record_function("portbench." + name):
                    return fn(*a, **k)
            return wrapper

        base = processor.Evaluator

        class Evaluator(base):
            pass

        for meth in ("load_prefix", "evaluate_seq_len_and_check_rna",
                     "eval_adapter_and_read_num", "evaluate_read_num"):
            setattr(Evaluator, meth, spanned("evaluator", getattr(base, meth)))
        self._patch(cuda_lib, "ptr", ptr)
        self._patch(cuda_lib, "launch", launch)
        self._patch(processor, "Evaluator", Evaluator)
        self._patch(runner_cls, "run", spanned("runner", runner_cls.run))
        self._patch(processor, "report_json",
                    spanned("reports", processor.report_json))
        self._patch(processor, "report_html",
                    spanned("reports", processor.report_html))

    def remove(self):
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)
        self._ptrs.clear()

    # ------------------------------------------------------------ profiler

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.install()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self, trace_path):
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.remove()
        self.prof.export_chrome_trace(trace_path)
        self.prof = None
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(trace_path)
        return events


def union_length(intervals):
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def short_name(name):
    """A device op's name without its return type, template arguments and
    parameters: `at::native::reduce_kernel`, `Memcpy DtoH (Device ->
    Pageable)`, `stat_batch_kernel`."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def summarize(events, launches, step_calls, bound_of, kernel_symbols):
    """What the metrics read from one traced stretch.  Times in the trace
    are microseconds; everything returned is in seconds."""
    dev, spans, stretch = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((a, b, e.get("name", "")))
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(
                "portbench."):
            name = e["name"][len("portbench."):]
            if name == "stretch":
                stretch = (a, b)
            else:
                spans.append((a, b, name))
    if stretch is None or not dev:
        return None
    lo, hi = stretch
    dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
    busy = union_length([(a, b) for a, b, _ in dev])

    # idle gaps, each named by the span that holds its middle
    gaps = []
    end = lo
    for a, b, _ in sorted(dev):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    order = {"evaluator": 0, "runner": 0, "reports": 0, "job": 1}

    def span_of(t):
        best = None
        for a, b, n in spans:
            if a <= t <= b and (best is None or order.get(n, 2) < order.get(
                    best, 2)):
                best = n
        return best or "between_jobs"

    named = {}
    longest = []
    for a, b in gaps:
        n = span_of((a + b) / 2)
        named[n] = named.get(n, 0.0) + (b - a)
        longest.append((b - a, n))
    longest.sort(reverse=True)

    by_op = {}
    kernel_us = 0.0
    dev = [(a, b, short_name(n)) for a, b, n in dev]
    runner = [(a, b) for a, b, n in spans if n == "runner"]
    runner_ops = 0
    for a, b, n in dev:
        by_op[n] = by_op.get(n, 0.0) + (b - a)
        if any(k in n for k in kernel_symbols):
            kernel_us += b - a
        if any(ra <= a <= rb for ra, rb in runner):
            runner_ops += 1
    bound_s = sum(bound_of(entry, args) for entry, args in launches)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = ([["%s (total)" % n, s / 1e6] for n, s in
             sorted(named.items(), key=lambda kv: -kv[1])][:5]
            + [["%s (longest)" % n, s / 1e6] for s, n in longest[:5]])
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "device_ops": len(dev),
        "runner_device_ops": runner_ops,
        "step_calls": step_calls,
        "kernel_s": kernel_us / 1e6,
        "bound_s": bound_s,
        "launches": len(launches),
        "breakdown": {"device_ops": [[n, s / 1e6] for n, s in top],
                      "idle_gaps": idle[:10]},
    }
