"""The port's one timer: named spans of a job's host work.

A job's recorder (Spans, one per process() call) adds each span's wall to
its name's total in the dict of the span's layer; the layers are the keys
of the FASTPLONG_TIMER_DUMP file (processor.py): phase_seconds,
evaluator_seconds and stage_seconds.  A component records through its
layer's view:

    stage = spans.layer("stage_seconds")
    with stage("pack"):
        ...

Spans nest per thread: each thread has its own open span, the parent of
the next span opened on that thread, so a span of the host-statistics
worker never becomes the parent of one on the main thread.  Code that is
handed no recorder (the step and its stages, pipeline/sharding.py and
device.py) opens child(name): a span in the layer of the span open on its
thread, or nothing where none is open.

While a torch profiler runs, a span is also a `record_function` range
named "fastplong.<name>": it lands on the profiler's timeline beside the
aten ops and the card's kernels that its code issued, on one clock.  With
no profiler running it enters no range (an ungated range costs about 30
times the span's two clock reads).
"""

import contextlib
import threading
import time

import torch

PREFIX = "fastplong."

_open = threading.local()      # .span: the span open on this thread


class Spans:
    """One job's spans: the wall totals by layer and name."""

    def __init__(self):
        self.layers = {}       # layer -> {span name: seconds}
        self._lock = threading.Lock()

    def layer(self, layer):
        """The view through which a component records into `layer`."""
        return Layer(self, self.layers.setdefault(layer, {}))

    def report(self):
        """{layer: {name: seconds}}, rounded and sorted, for the dump."""
        return {layer: {k: round(v, 4) for k, v in sorted(totals.items())}
                for layer, totals in self.layers.items()}


class Layer:
    """A layer's view of a job's recorder: view(name) is one span."""

    __slots__ = ("job", "seconds")

    def __init__(self, job, seconds):
        self.job = job
        self.seconds = seconds

    def __call__(self, name):
        return _Span(self, name)


def standalone():
    """A view of a recorder of its own, for a caller outside a job (a
    test, a tool) whose spans nobody reads."""
    return Spans().layer("standalone")


def child(name):
    """A span in the layer of the span open on this thread; no span (and
    no cost beyond this lookup) where none is open."""
    top = getattr(_open, "span", None)
    if top is None:
        return contextlib.nullcontext()
    return _Span(top.layer, name)


class _Span:
    __slots__ = ("layer", "name", "parent", "range", "t0")

    def __init__(self, layer, name):
        self.layer = layer
        self.name = name

    def __enter__(self):
        self.parent = getattr(_open, "span", None)
        _open.span = self
        self.range = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        seconds = self.layer.seconds
        with self.layer.job._lock:
            seconds[self.name] = seconds.get(self.name, 0.0) + dt
        _open.span = self.parent
        return False
