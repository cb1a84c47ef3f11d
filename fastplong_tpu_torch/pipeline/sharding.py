"""Data-parallel execution over several devices: the step over row slices.

Port of fastplong_tpu/pipeline/sharding.py, the counterpart of the
reference's N worker threads with private Stats merged at the end of the
run (src/seprocessor.cpp:108-121).  The JAX package shards the padded
[B, L] batch over a device mesh with shard_map; here the batch's rows are
cut into n contiguous slices (torch.tensor_split: uneven, or empty, when B
is not a multiple of n), and slice i runs the one-device fast step on
device i, writes its own rows into its part of the batch's host rows and
adds into its own [2, F] statistics partial.  The host sums the partials
once, at the drain (device.stats_state_to_numpy).  No collective runs in
the hot path: reads are independent.

A device list may repeat a device.  On the CPU, --devices N runs N slices
on the one CPU device (the counterpart of the virtual CPU devices under
which the JAX package's tests run --devices 8), and a library caller may
run two slices on one card (pipeline/runner.py: SingleEndRunner's
`devices`).
"""

import torch

from .. import resolve_device
from ..spans import child
from ..util import error_exit
from .device import (adapter_stages, build_fast_step, build_step,
                     params_fields, stats_state_to_numpy, zero_stats_state)


def make_devices(n, device=None):
    """The n devices of --devices n: cuda:0 .. cuda:n-1, as the JAX package
    takes jax.devices()[:n], or n times the CPU when the run is on the CPU
    (resolve_device's rule).  Stops with the JAX package's message when
    fewer cards are visible."""
    device = resolve_device(device)
    if device.type == "cpu":
        return [device] * n
    avail = torch.cuda.device_count()
    if avail < n:
        error_exit("--devices %d requested but only %d device(s) available"
                   % (n, avail))
    return [torch.device("cuda", i) for i in range(n)]


class Placement:
    """Where the row slices of a batch run (the counterpart of
    MeshPlacement): slice i on devices[i]."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        self.pinned = any(d.type == "cuda" for d in self.devices)

    def split_rows(self, packed):
        """Cut a host batch (numpy [B, W]) into n contiguous row slices and
        start each non-empty slice's copy to its device (from pinned
        memory, non-blocking, on that device's current stream).  Returns
        (host, parts): host is the batch as a CPU tensor, whose pages must
        outlive the copies; parts[i] is (slice on devices[i], or None when
        the slice is empty, its first row, its end row)."""
        host = torch.from_numpy(packed)
        if self.pinned:
            host = host.pin_memory()
        parts, r0 = [], 0
        for dev, rows in zip(self.devices, torch.tensor_split(host, self.n)):
            r1 = r0 + rows.shape[0]
            parts.append((rows.to(dev, non_blocking=True) if r1 > r0
                          else None, r0, r1))
            r0 = r1
        return host, parts

    def init_state(self, L):
        """One zeroed [2, F] statistics partial per slice, on its device."""
        return [zero_stats_state(L, d) for d in self.devices]


def _per_device(placement, build):
    """build(device) once per distinct device of placement, listed per
    slice."""
    built = {}
    for d in placement.devices:
        if d not in built:
            built[d] = build(d)
    return [built[d] for d in placement.devices]


def build_fast_sharded_step(p, placement, with_stats=True):
    """The fast step (device.build_fast_step) over placement's row slices.
    Returns (fast, stages):

      with_stats=True:  fast(states, parts, L) -> (rows, events), slice i
                        adding its pre/post partials into states[i]
                        (placement.init_state) in place;
      with_stats=False: fast(parts, L) -> (rows, events), the stats-free
                        form (--stats_backend host).

    parts: placement.split_rows(packed)[1].  rows: a host [B, F] int32
    tensor, pinned when a device is a card, holding the one-device step's
    rows in the same order; each slice's device writes its own rows into
    it asynchronously, and events holds one CUDA event per slice launched
    on a card, recorded on that device's current stream after the copy:
    wait on all of them before reading rows.  Every non-empty slice is
    launched before any is waited on; an empty slice launches nothing.
    Inside a span (the runner's `dispatch`), each slice's step call and
    the copy of its rows is the span "step" (spans.child), which holds
    the step's stages."""
    steps = _per_device(
        placement, lambda d: build_fast_step(p, d, with_stats)[0])
    F = params_fields(p)

    def fast(states, parts, L):
        rows = torch.empty((parts[-1][2], F), dtype=torch.int32,
                           pin_memory=placement.pinned)
        events = []
        for i, (x, r0, r1) in enumerate(parts):
            if x is None:
                continue
            with child("step"):
                out = (steps[i](states[i], x, L) if with_stats
                       else steps[i](x, L))
                rows[r0:r1].copy_(out, non_blocking=True)
            if x.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(x.device))
                events.append(event)
        return rows, events

    if not with_stats:
        return (lambda parts, L: fast(None, parts, L)), adapter_stages(p)
    return fast, adapter_stages(p)


def build_sharded_step(p, placement):
    """The unfused dict step (device.build_step) over placement's row
    slices.  Returns (step, stages): step(bases, quals, lens, read_mask),
    CPU tensors [B, L], [B, L], [B], [B], runs slice i through build_step
    on devices[i] with a fresh partial of cycle length L, and returns
    build_step's dict on the CPU, its per-read fields joined in slice
    order, with "stats": the partials summed on the host ([2, F] int64
    numpy, device.stats_state_to_numpy) — the counterpart of the JAX
    step's psum of its statistics."""
    steps = _per_device(placement, lambda d: build_step(p, d)[0])

    def step(bases, quals, lens, read_mask):
        L = bases.shape[1]
        states, outs = [], []
        for i, (dev, b, q, n, m) in enumerate(zip(
                placement.devices,
                *(torch.tensor_split(t, placement.n)
                  for t in (bases, quals, lens, read_mask)))):
            if n.shape[0] == 0:
                continue
            states.append(zero_stats_state(L, dev))
            outs.append(steps[i](*(t.to(dev) for t in (b, q, n, m)),
                                 states[-1]))
        # post_median is [S, B]: its rows are the slots
        joined = {k: torch.cat([o[k].cpu() for o in outs],
                               dim=1 if k == "post_median" else 0)
                  for k in outs[0]}
        joined["stats"] = stats_state_to_numpy(states)[0]
        return joined

    return step, adapter_stages(p)
