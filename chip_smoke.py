#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (fastplong_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from fastplong_tpu_torch/csrc, holds each
kernel against its plain PyTorch version at the main path's shapes and a
few others (exact match required: every result is an integer; the Myers
verify also as the paired launch the main path makes; the statistics
kernel, which adds into the run's accumulator, from a non-zero one over 1,
2 and 4 slots at the headline batch shape and on edge batches; the region
scan in the break and mask forms and on an edge batch; the k-mer fill of
adapter auto-detection on both sides of the headline input's sample and on
an edge batch; the block-scan Myers kernel at 700, 2,000 and 5,000 bp;
the mismatch scan's int32 path at 700 and 2,000 bp, with an fp32 one-hot
conv1d as its library yardstick), checks the
fused step on CUDA against the port's CPU step with the headline and the
break-and-mask parameters, then drives the headline CLI (-s START -e END
-5 -3 -x, both reports, --failed_out) on CUDA three times over a 64-Mbase
input made from a seed, checks each run's kernel launches against its step
count, compares its four outputs byte for byte with the port's CPU run of
the same input, and profiles one more CUDA run (no index_add_ may appear
among its device ops; each profile prints device ops per step call).
Then, as functional checks over a 64-Mbase input with low-quality
stretches planted, the headline flags with break and mask (-b -N: one
CUDA run, its launches, "rN-" fragments and failed reads in its output,
byte parity with the CPU run, and a profile) and with N-masking alone
(-N: its launches, failed reads holding runs of N at least one window
long, byte parity with the CPU run, and a profile).  The fused step
with -b -N and with -N must find regions too.  Then BASELINE config 4
(no adapter flags: both adapters auto-detected, one k-mer fill launch a
side; outputs and "Detected:" lines equal to the CPU run's) and config 5
(-b -y --split 4: the four split files, JSON and HTML equal to the CPU
run's) over the headline input, and a 700-bp start adapter over a few
hundred reads (each side's middle verify through the block-scan kernel;
byte parity with the CPU run), each with its launch counts checked.
Then the run-level entry points, each held to the headline run of phase
5: the headline with --profile DIR (5g: one trace file holding the four
headline kernels' device events by CUDA symbol; outputs unchanged),
--prewarm as a subprocess from a copy of the package with no built
library, and a fresh process timed by its parts (5h, cold start),
parallel.py in process over the headline input cut into four files (5i),
and --num_hosts 2 as two processes sharing the card over a gloo group,
its shards, merged report and offline merge (5j).  Then the warm daemon
(5k: `import torch` timed twice in fresh processes; CLI clients with
FASTPLONG_DAEMON=1, cold and warm over 300 reads, the headline over the
64-Mbase input and config 4, each job's outputs, launches and
"Detected:" lines held to the in-process runs, no client importing
torch, the daemon holding a CUDA context until shutdown_daemon() ends
it) and `python -m fastplong_tpu_torch.edbench` on the card (5l).

    python3 chip_smoke.py --walls

runs only the headline CLI three times and its profile, and prints the
walls, stage seconds, launches and top device ops without checking them;
copied into an unpacked older tree, it measures that tree's package, so
that two trees can be timed in turns in one run on one card.

The second-to-last line of standard output is {"kernels": [...]}; the last
is {"ok": true, "device": {...}}.  Any failure raises and exits non-zero.
Imports nothing of JAX or of fastplong_tpu.  Works in a temporary
directory outside the checkout and removes it.
"""

import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

START = "AATGTACTTCGTTCAGTTACGTATTGCT"
END = "AGCAATACGTAACTGAACGAAGT"
# a 33 bp adapter of knownadapters.py (Illumina TruSeq): the shortest
# length that needs two Myers words
TRUSEQ = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
HEADLINE = ["-s", START, "-e", END, "-5", "-3", "-x"]
SEED = 7
N_READS = 8000     # reads of the headline input (bench.py gen_input)
# BASELINE configs 4 and 5 (tools/cpu_anchor.py:42-43): auto-detection with
# no adapter flags, and break, low-complexity filter and split by file number
CONFIG4 = []
CONFIG5 = ["-b", "-y", "--split", "4"]


def _long_seq(n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), n))


# a start adapter longer than the Myers verify's 640 bp (phase 5f)
LONG_ADAPTER = _long_seq(700, 17)

# bound model: the H100 SXM's published peak rates.
# Each kernel's operations are counted at the peak for their type: the
# mismatch scan compares bytes (int8 peak, 1,979 TOP/s); the Myers kernels
# work on 32-bit words, for which the only published rate outside the
# tensor cores is the 32-bit one (67 T/s).  No integer pipe of the card
# runs faster than these, so each bound is a lower bound.
MEM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
WORD32_OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def bound(nbytes, ops, ops_per_s):
    tb = nbytes / MEM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(fn, warmup=2, reps=7, inner=10):
    """Median per-call device time of fn by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


def graph_ms(fn, reps=7, inner=20):
    """Median per-call device time of fn, launched from a captured CUDA
    graph of `inner` calls so that host launch overhead cannot leave the
    card idle between calls (events around each replay)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


def max_err(a, b):
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError("shape/dtype differ: %s %s vs %s %s"
                             % (a.shape, a.dtype, b.shape, b.dtype))
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def require_equal(name, a, b):
    err = max_err(a, b)
    if err != 0:
        raise AssertionError("%s: kernel differs from its plain version, "
                             "max_abs_err %d" % (name, err))
    return err


# ------------------------------------------------------------------ phases

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else (
        "nvidia-smi unavailable: %s" % smi.stderr.strip())
    log(card)
    log("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    return card


def phase_build():
    from fastplong_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    so = cuda_lib.build()
    cuda_lib.lib()
    log("phase 2: kernel library %s ready in %.1f s"
        % (os.path.basename(so), time.perf_counter() - t0))
    with open(so + ".ptxas.txt") as f:
        for line in f:
            line = line.rstrip()
            if (line.startswith(("build_seconds", "==")) or "registers" in line
                    or "spill" in line):
                log("  " + line.strip())


def _rand_bases(rng, shape):
    import numpy as np
    return rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=shape,
                      p=[.24, .24, .24, .24, .04])


def phase_kernels(in_fq):
    """Each kernel against its plain version at the main path's shapes
    (the k-mer fill on the sample of in_fq, the headline input);
    returns {name: record} for the JSON line (the main-path shape) and
    prints the other shapes."""
    import numpy as np
    import torch
    from fastplong_tpu_torch.ops.adapter import (AdapterSpec, seed_scan,
                                                 seed_scan_plain)
    from fastplong_tpu_torch.ops.mismatch import (mismatch_scan,
                                                  mismatch_scan_plain)
    from fastplong_tpu_torch.ops.myers import (myers_verify,
                                               myers_verify_pair,
                                               myers_verify_plain,
                                               pattern_table)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rec = {}

    # ---- kernel 1: mismatch scan
    bases = torch.from_numpy(_rand_bases(rng, (1024, 8192))).to(dev)
    for label, seq, rows in (("28 bp", START, 1024), ("23 bp", END, 1024),
                             ("33 bp", TRUSEQ, 1024),
                             ("300 bp", (START * 11)[:300], 256),
                             ("700 bp", LONG_ADAPTER, 256),
                             ("2,000 bp", _long_seq(2000, 3), 256)):
        x = bases[:rows].contiguous()
        ad = torch.from_numpy(np.frombuffer(seq.encode(), np.uint8)
                              .copy()).to(dev)
        got = mismatch_scan(x, ad)
        err = require_equal("mismatch_scan", got, mismatch_scan_plain(x, ad))
        B, L = x.shape
        alen = len(seq)
        ms = graph_ms(lambda: mismatch_scan(x, ad))
        ev = cuda_ms(lambda: mismatch_scan(x, ad))
        plain = cuda_ms(lambda: mismatch_scan_plain(x, ad), reps=3, inner=2)
        bms, by = bound(B * L + B * L * got.element_size() + alen,
                        2 * B * L * alen, INT8_OPS_PER_S)
        # the one-hot convolution: fp16 (exact up to 2,048) up to 300 bp,
        # fp32 with TF32 off (exact up to 2^24) at 700 and 2,000 bp
        lib = _conv_mismatch(x, ad, got)
        r = dict(name="mismatch_scan", shape="[%d, %d] x %s" % (B, L, label),
                 max_abs_err=err, ms=ms, eager_ms=ev, plain_ms=plain,
                 bound_ms=bms, bound_by=by, library_ms=lib)
        log("phase 3: " + json.dumps(r))
        rec.setdefault("mismatch_scan", r)

    # ---- kernel 2: Myers verify (trim verifies at T = alen <= 200, middle
    # search at T = alen; the largest pattern, K = 20, at T = 640), then
    # the main path's paired launch of the 28 bp and 23 bp problems
    probs = {}
    for label, pat, N, T in (("trim/middle 28 bp", START, 1024, 28),
                             ("trim/middle 23 bp", END, 1024, 23),
                             ("64 bp, K=2", (TRUSEQ * 2)[:64], 1024, 64),
                             ("200 bp, K=7", (START * 8)[:200], 1024, 200),
                             ("640 bp, K=20", (START * 23)[:640], 1024, 640)):
        pm = pattern_table(pat.encode(), dev)
        text = torch.from_numpy(_rand_bases(rng, (N, T))).to(dev)
        plen = torch.from_numpy(rng.integers(-2, T + 1, N).astype(np.int32)
                                ).to(dev)
        args = (pm, plen, text, plen)
        probs[label] = args
        got = myers_verify(*args)
        slow = T > 200
        err = require_equal("myers_verify", got, myers_verify_plain(*args))
        ms = graph_ms(lambda: myers_verify(*args))
        ev = cuda_ms(lambda: myers_verify(*args))
        plain = cuda_ms(lambda: myers_verify_plain(*args),
                        warmup=0 if slow else 1, reps=1 if slow else 3,
                        inner=1)
        bms, by = bound(*_myers_work(*args), WORD32_OPS_PER_S)
        r = dict(name="myers_verify", shape="N=%d T=%d K=%d (%s)"
                 % (N, T, pm.shape[1], label), max_abs_err=err, ms=ms,
                 eager_ms=ev, plain_ms=plain, bound_ms=bms, bound_by=by,
                 library_ms=None)
        log("phase 3: " + json.dumps(r))
    # the fixed cost of a K = 1 launch (launch, loads, stores): the 28 bp
    # problem with empty texts, so that no column is computed
    pm, plen, text, _ = probs["trim/middle 28 bp"]
    args = (pm, plen, text, torch.zeros_like(plen))
    err = require_equal("myers_verify", myers_verify(*args),
                        myers_verify_plain(*args))
    bms, by = bound(*_myers_work(*args), WORD32_OPS_PER_S)
    log("phase 3: " + json.dumps(dict(
        name="myers_verify", shape="N=1024 T=28 K=1, tlen 0 (fixed cost)",
        max_abs_err=err, ms=graph_ms(lambda: myers_verify(*args)),
        bound_ms=bms, bound_by=by, library_ms=None)))
    pair = (probs["trim/middle 28 bp"], probs["trim/middle 23 bp"])
    got = myers_verify_pair(*pair)
    err = max(require_equal("myers_verify_pair", g, myers_verify_plain(*a))
              for g, a in zip(got, pair))
    ms = graph_ms(lambda: myers_verify_pair(*pair))
    ev = cuda_ms(lambda: myers_verify_pair(*pair))
    plain = cuda_ms(lambda: [myers_verify_plain(*a) for a in pair], reps=3,
                    inner=1)
    work = [_myers_work(*a) for a in pair]
    bms, by = bound(sum(w[0] for w in work), sum(w[1] for w in work),
                    WORD32_OPS_PER_S)
    r = dict(name="myers_verify", shape="pair: N=1024 T=28 K=1 + N=1024 "
             "T=23 K=1 (the main path's paired launch)", max_abs_err=err,
             ms=ms, eager_ms=ev, plain_ms=plain, bound_ms=bms, bound_by=by,
             library_ms=None)
    log("phase 3: " + json.dumps(r))
    rec["myers_verify"] = r

    # ---- kernel 3: seed scan, both sides, [1024, 184] lanes
    spec = AdapterSpec(START, 0.25, dev)
    x = bases[:, :1024].contiguous()
    B, L = x.shape
    lo = torch.from_numpy(rng.integers(0, 200, B).astype(np.int32)).to(dev)
    rlen = torch.from_numpy(rng.integers(0, L - 200, B).astype(np.int32)
                            ).to(dev)
    ncand = torch.clamp(torch.clamp(rlen - spec.plen, max=184), min=0)
    for side, anchor, tbl in (("start side", lo, spec.seed_rev),
                              ("end side", lo + rlen - spec.plen,
                               spec.seed_fwd)):
        start = side == "start side"
        args = (x, anchor, ncand, tbl, spec.plen, start)
        got = seed_scan(*args)
        err = require_equal("seed_scan", got, seed_scan_plain(*args))
        ms = graph_ms(lambda: seed_scan(*args))
        ev = cuda_ms(lambda: seed_scan(*args))
        plain = cuda_ms(lambda: seed_scan_plain(*args), reps=3, inner=2)
        P = got.shape[1]
        bms, by = bound(B * (P + spec.plen) + 8 * B + 4 * B * P + 1024,
                        B * P * spec.plen * 20, WORD32_OPS_PER_S)
        r = dict(name="seed_scan", shape="[%d, %d] %s" % (B, P, side),
                 max_abs_err=err, ms=ms, eager_ms=ev, plain_ms=plain,
                 bound_ms=bms, bound_by=by, library_ms=None)
        log("phase 3: " + json.dumps(r))
        rec.setdefault("seed_scan", r)

    rec["stat_batch"] = phase_stat_batch(rng, bases)
    rec["regions"] = phase_regions(rng)
    rec["kmer_hist"] = phase_kmer(rng, in_fq)
    rec["myers_blockscan"] = phase_blockscan(rng)
    return rec


def _fastq_seqs(path):
    seqs = []
    with open(path, "rb") as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                seqs.append(line.rstrip(b"\n"))
    return seqs


def _kmer_edge_batch(rng, n=600):
    """(mat, npos, pbase): bytes outside ACGTU, rows with no window (npos
    0, as for reads shorter than a window) and with every window (129),
    an adapter in half the rows so that its keys collect about 300
    windows, at positions near 2^31, so that their sums pass 2^32."""
    import numpy as np
    mat = rng.choice(np.frombuffer(b"ACGTUNa.\x00", np.uint8), (n, 139),
                     p=[.22, .22, .22, .22, .04, .03, .02, .02, .01])
    mat[::2, 30:30 + len(END)] = np.frombuffer(END.encode(), np.uint8)
    npos = rng.integers(0, 130, n).astype(np.int32)
    npos[:50] = 0
    npos[50:100] = 129
    pbase = rng.integers(1 << 30, 1 << 31, n).astype(np.int64)
    return mat, npos, pbase


def phase_kmer(rng, in_fq):
    """The k-mer fill (kmer_hist) against its plain version, exactly, into
    a zero accumulator as the evaluator gives it: both sides of config 4's
    sample (the headline input's 8,000 reads, as auto-detection takes
    them) and an edge batch from a non-zero accumulator; times by CUDA
    graph and events, the plain time, one scatter_add_ over the same keys
    (keys not timed) and the copy of the accumulator to the host.
    Returns the start side's record."""
    import numpy as np
    import torch
    from fastplong_tpu_torch.evaluator import window_matrix
    from fastplong_tpu_torch.ops.kmer import (KEYSPACE, kmer_hist,
                                              kmer_hist_plain, window_keys)
    dev = torch.device("cuda")
    seqs = _fastq_seqs(in_fq)
    lens = np.asarray([len(x) for x in seqs], np.int64)
    rec = None
    for side, end in (("start side", False), ("end side", True)):
        mat, npos, base_pos = window_matrix(seqs, lens, 1, end)
        pbase = lens - base_pos if end else base_pos
        args = [torch.from_numpy(a).to(dev)
                for a in (mat, npos.astype(np.int32), pbase)] + [
                    -1 if end else 1]
        got = kmer_hist(torch.zeros((2, KEYSPACE), dtype=torch.int64,
                                    device=dev), *args)
        ref = kmer_hist_plain(torch.zeros_like(got), *args)
        err = require_equal("kmer_hist", got, ref)
        acc = torch.zeros_like(got)
        ms = graph_ms(lambda: kmer_hist(acc, *args))
        ev = cuda_ms(lambda: kmer_hist(acc, *args))
        plain = cuda_ms(lambda: kmer_hist_plain(acc, *args), reps=3, inner=1)
        kk, pv = window_keys(*args)
        idx = torch.cat([kk, kk + KEYSPACE])
        src = torch.cat([torch.ones_like(kk), pv])
        flat = torch.zeros(2 * KEYSPACE, dtype=torch.int64, device=dev)
        flat.scatter_add_(0, idx, src)
        if not torch.equal(flat.view(2, KEYSPACE), got):
            raise AssertionError("scatter_add_ yardstick disagrees with the "
                                 "kernel")
        lib = cuda_ms(lambda: flat.scatter_add_(0, idx, src))
        copies = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got.cpu()
            copies.append((time.perf_counter() - t0) * 1e3)
        windows = int(kk.numel())
        distinct = int((got[0] != 0).sum().item())
        bms, by = bound(mat.size + 12 * len(npos) + 32 * distinct,
                        20 * windows, WORD32_OPS_PER_S)
        r = dict(name="kmer_hist", shape="config 4 sample [%d, %d] %s, %d "
                 "windows, %d keys" % (mat.shape + (side, windows, distinct)),
                 max_abs_err=err, ms=ms, eager_ms=ev, plain_ms=plain,
                 bound_ms=bms, bound_by=by, library_ms=lib,
                 copy_to_host_ms=statistics.median(copies))
        log("phase 3: " + json.dumps(r))
        rec = rec or r
    for sign in (1, -1):
        mat, npos, pbase = _kmer_edge_batch(rng)
        args = [torch.from_numpy(a).to(dev) for a in (mat, npos, pbase)]
        g = torch.Generator().manual_seed(sign + 2)
        start = torch.randint(0, 1 << 40, (2, KEYSPACE), generator=g).to(dev)
        got = kmer_hist(start.clone(), *args, sign)
        ref = kmer_hist_plain(start.clone(), *args, sign)
        err = require_equal("kmer_hist", got, ref)
        top = int((ref - start)[1].max().item())
        if top <= 1 << 32:
            raise AssertionError("kmer_hist edge batch: no position sum "
                                 "passed 2^32")
        log("phase 3: " + json.dumps(dict(
            name="kmer_hist", shape="edge batch [600, 139], sign %+d, from a "
            "non-zero accumulator; largest position sum added %d" % (sign,
                                                                     top),
            max_abs_err=err)))
    return rec


def phase_blockscan(rng):
    """The block-scan Myers kernel against its plain version, exactly, at
    the middle-adapter search's shapes (plen = tlen = alen on most lanes,
    some lanes shorter or empty): [1024, 700] (K = 22), [1024, 2000]
    (K = 63) and a small batch with a 5,000-bp pattern (K = 157) over
    300-column texts, which the plain loop can still run.  The plain time
    is its one call.  Returns the 700 bp record (phase 5f's shape)."""
    import numpy as np
    import torch
    from fastplong_tpu_torch.ops.myers import (myers_blockscan,
                                               myers_verify_plain,
                                               pattern_table)
    dev = torch.device("cuda")
    rec = None
    for label, plen_max, N, T in (("700 bp, K=22", 700, 1024, 700),
                                  ("2,000 bp, K=63", 2000, 1024, 2000),
                                  ("5,000 bp, K=157", 5000, 64, 300)):
        pat = _long_seq(plen_max, plen_max).encode()
        pm = pattern_table(pat, dev)
        text = _rand_bases(rng, (N, T))
        m = min(T, plen_max)
        for n in range(0, N, 3):      # texts close to the pattern
            keep = rng.random(m) < 0.9
            text[n, :m] = np.where(keep, np.frombuffer(pat[:m], np.uint8),
                                   text[n, :m])
        plen = np.full(N, plen_max, np.int32)
        tlen = np.full(N, T, np.int32)
        some = rng.random(N) < 0.1
        plen[some] = rng.integers(-1, plen_max + 1, int(some.sum()))
        tlen[some] = rng.integers(0, T + 1, int(some.sum()))
        args = (pm, torch.from_numpy(plen).to(dev),
                torch.from_numpy(text).to(dev), torch.from_numpy(tlen).to(dev))
        got = myers_blockscan(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = myers_verify_plain(*args)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        err = require_equal("myers_blockscan", got, ref)
        ms = graph_ms(lambda: myers_blockscan(*args), reps=5, inner=5)
        ev = cuda_ms(lambda: myers_blockscan(*args), reps=5, inner=5)
        bms, by = bound(*_myers_work(*args), WORD32_OPS_PER_S)
        r = dict(name="myers_blockscan", shape="N=%d T=%d K=%d (%s)"
                 % (N, T, pm.shape[1], label), max_abs_err=err, ms=ms,
                 eager_ms=ev, plain_ms=plain, bound_ms=bms, bound_by=by,
                 library_ms=None)
        log("phase 3: " + json.dumps(r))
        rec = rec or r
    return rec


def _lowq_quals(rng, B, L, frac=0.3):
    """Q5-Q39 quality rows (the headline input's) with one to three
    stretches of 60-800 bytes at Q2-Q8 planted in `frac` of them (rates
    chosen so that break and mask find regions, not taken from measured
    reads)."""
    import numpy as np
    quals = rng.integers(33 + 5, 33 + 40, (B, L)).astype(np.uint8)
    for i in np.nonzero(rng.random(B) < frac)[0]:
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.integers(0, L))
            k = min(int(rng.integers(60, 801)), L - p)
            quals[i, p:p + k] = rng.integers(33 + 2, 33 + 9, k)
    return quals


def _region_edge_batch(rng, B=48, L=300):
    """(quals, lens, lo [2, B], hi [2, B]) for the region kernel's edge
    cases: Q2-Q40 rows, rows with Q2-Q8 stretches, the many-regions
    pattern of alternating '~' and '#' blocks, high-quality rows with no
    region; inactive slots (hi = lo, at 0 and inside the row), spans that
    reach L, non-zero lo, spans past the read's length, short spans."""
    import numpy as np
    quals = rng.integers(33 + 2, 33 + 41, (B, L)).astype(np.uint8)
    for i in range(0, B, 4):
        p = int(rng.integers(0, L - 40))
        k = min(int(rng.integers(20, 150)), L - p)
        quals[i, p:p + k] = rng.integers(33 + 2, 33 + 9, k)
    for i in range(1, B, 4):
        row = []
        while len(row) < L:
            row += ([126] * int(rng.integers(10, 30))
                    + [35] * int(rng.integers(10, 30)))
        quals[i] = row[:L]
    quals[B - 4:] = 33 + 40
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lens[:8] = L
    quals[np.arange(L)[None, :] >= lens[:, None]] = 0
    cut = np.sort(rng.integers(0, L + 1, (3, B)), axis=0).astype(np.int32)
    lo, hi = cut[:-1].copy(), cut[1:].copy()
    cases = [(0, 0), (37, 37), (0, L), (5, L), (L - 1, L), (L, L),
             (120, 140), (0, 1), (250, L), (3, L - 1), (11, 200), (0, L)]
    for i, (a, b) in enumerate(cases):
        lo[i % 2, i], hi[i % 2, i] = a, b
    return quals, lens, lo, hi


def _region_work(L, lo, hi, w):
    """(bytes, operations) of one region call for its bound: the cq
    entries of every span that a pass tests (l >= w), 4 bytes each, read
    once; lo and hi read and the three results written once; about 8 word
    operations per tested position."""
    import torch
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    n = torch.clamp(hi, 0, L) - torch.clamp(lo, 0, L) + 1
    n = torch.where((hi - lo >= w) & (n > 0), n, 0)
    pos = int(n.sum().item())
    return 4 * pos + 20 * lo.numel(), 8 * pos


def _region_spans(rng, lens):
    """The break form's two slots for reads of these lengths, as the
    middle split leaves them: trimmed ends, about one read in ten split
    in two, the second slot inactive elsewhere."""
    import numpy as np
    import torch
    from fastplong_tpu_torch.pipeline.device import Slots
    B = len(lens)
    lo = rng.integers(0, 60, B)
    hi = np.maximum(lo, lens - rng.integers(0, 60, B))
    split = rng.random(B) < 0.1
    mid = lo + ((hi - lo) * rng.random(B)).astype(np.int64)
    zero = np.zeros(B, np.int32)
    ints = [np.stack(a).astype(np.int32) for a in (
        [lo, mid], [np.where(split, mid, hi), hi], [zero, zero],
        [zero, zero])]
    flags = [np.stack(a) for a in ([np.ones(B, bool), split],
                                   [~split, np.zeros(B, bool)])]
    lo2, hi2, tag, region = (torch.from_numpy(a).cuda() for a in ints)
    active, parent = (torch.from_numpy(a).cuda() for a in flags)
    return Slots(lo2, hi2, active, tag, region, parent)


def phase_regions(rng):
    """The region scan against its plain version, all three outputs
    exactly: an edge batch at windows from 1 to beyond L in the [B] and
    [2, B] forms, then the main path's two launches at [1024, 8192] with
    low-quality stretches planted: break over the middle split's 2 slots
    (window 100, Q10) and mask over the 4 slots break leaves (window 50,
    Q10), and the -N path's launch, mask over the middle split's 2 slots;
    timed by CUDA graph and by events.  Returns the record of the mask
    over 4 slots (the break-and-mask path's)."""
    import numpy as np
    import torch
    from fastplong_tpu_torch.ops.primitives import qual_cumsum
    from fastplong_tpu_torch.ops.regions import (
        detect_regions_summary, detect_regions_summary_plain)
    from fastplong_tpu_torch.pipeline.device import break_slots
    dev = torch.device("cuda")
    names = ("ws1", "last_end", "count")

    def equal(args):
        got = detect_regions_summary(*args)
        ref = detect_regions_summary_plain(*args)
        return got, max(require_equal("regions " + k, g, r)
                        for k, g, r in zip(names, got, ref))

    quals, lens, lo, hi = (torch.from_numpy(a).to(dev)
                           for a in _region_edge_batch(rng))
    cq = qual_cumsum(quals, lens)
    found = 0
    for w in (1, 2, 15, 50, 100, 299, 300, 301, 1000):
        for q in (10, 20):
            for a, b in ((lo[0], hi[0]), (lo, hi)):
                got, err = equal((cq, a, b, w, (33 + q) * w))
                found += int(got[2].sum().item())
    log("phase 3: " + json.dumps(dict(
        name="regions", shape="edge batch [48, 300], [B] and [2, B] spans, "
        "w in 1, 2, 15, 50, 100, 299, 300, 301, 1000 at Q10 and Q20",
        max_abs_err=err, regions_found=found)))

    B, L = 1024, 8192
    lens = rng.integers(L // 2 + 1, L + 1, B).astype(np.int32)
    quals = torch.from_numpy(_lowq_quals(rng, B, L)).to(dev)
    cq = qual_cumsum(quals, torch.from_numpy(lens).to(dev))
    two = _region_spans(rng, lens)
    four = break_slots(two, cq, 100, 10)
    recs = {}
    for form, s, w in (("break: [2, %d] spans, window 100 Q10" % B, two, 100),
                       ("mask: [4, %d] spans, window 50 Q10" % B, four, 50),
                       ("mask alone (-N): [2, %d] spans, window 50 Q10" % B,
                        two, 50)):
        args = (cq, s.lo, torch.where(s.active, s.hi, s.lo), w, 43 * w)
        got, err = equal(args)
        ms = graph_ms(lambda: detect_regions_summary(*args))
        ev = cuda_ms(lambda: detect_regions_summary(*args))
        plain = cuda_ms(lambda: detect_regions_summary_plain(*args),
                        warmup=1, reps=3, inner=1)
        bms, by = bound(*_region_work(L, args[1], args[2], w),
                        WORD32_OPS_PER_S)
        rec = dict(name="regions", shape="[%d, %d] %s" % (B, L, form),
                   max_abs_err=err, ms=ms, eager_ms=ev, plain_ms=plain,
                   bound_ms=bms, bound_by=by, library_ms=None,
                   spans_with_regions=int((got[2] > 0).sum().item()))
        log("phase 3: " + json.dumps(rec))
        recs[form.split(":")[0]] = rec
    if not recs["mask alone (-N)"]["spans_with_regions"]:
        raise AssertionError("regions: the -N form found no region")
    return recs["mask"]


def _stat_edge_batch(rng, B, L):
    """Every byte value in bases and quals, ACGTU-rich rows for the 5-mers,
    and the span cases: empty, hi < lo, full width, lo = -1 on a masked and
    an unmasked row, spans past the row end, reads shorter than 5."""
    import numpy as np
    bases = rng.integers(0, 256, (B, L)).astype(np.uint8)
    quals = rng.integers(0, 256, (B, L)).astype(np.uint8)
    for i in range(12, B, 2):
        bases[i] = rng.choice(np.frombuffer(b"ACGTUN", np.uint8), L,
                              p=[.22, .22, .22, .22, .06, .06])
        quals[i] = rng.integers(33, 75, L)
    lo = rng.integers(-2, L // 2, B).astype(np.int32)
    hi = (lo + rng.integers(0, L, B)).astype(np.int32)
    mask = rng.random(B) < 0.85
    cases = [(0, 0, True), (10, 5, True), (0, L, True), (-1, L, False),
             (-1, 50, True), (L - 3, L + 4, True), (L + 5, L + 9, True),
             (3, 4, True), (7, 9, True), (0, 3, True), (5, 4 + L, True),
             (0, L, False)]
    for i, (a, b, m) in enumerate(cases[:B]):
        lo[i], hi[i], mask[i] = a, b, m
    return bases, quals, lo, hi, mask


def _stat_slots(rng, B, L, S, edge):
    """(bases, quals, lo, hi, mask) with lo, hi, mask [S, B]: the edge
    batch with each slot's spans drawn anew (slot 0 keeps the span cases),
    or the headline shape: random reads, trimmed spans [lo, hi) on 95% of
    them, and, for S = 2 and 4, the middle split (one read in ten cut in
    two) and then break (one slot in five cut in two), as the step's slots
    leave them."""
    import numpy as np
    if edge:
        bases, quals, lo, hi, mask = _stat_edge_batch(rng, B, L)
        spans = [(lo, hi, mask)] + [_stat_edge_batch(rng, B, L)[2:]
                                    for _ in range(S - 1)]
        lo, hi, mask = (np.stack(x) for x in zip(*spans))
        return bases, quals, lo, hi, mask
    bases = _rand_bases(rng, (B, L))
    quals = rng.integers(33 + 2, 33 + 41, (B, L)).astype(np.uint8)
    lo = rng.integers(0, 200, B).astype(np.int32)
    hi = (lo + rng.integers(0, L - 200, B)).astype(np.int32)
    lo, hi = lo[None], hi[None]
    mask = (rng.random(B) < 0.95)[None]
    while lo.shape[0] < S:
        share = 0.1 if lo.shape[0] == 1 else 0.2
        cut = rng.random(lo.shape) < share
        mid = lo + ((hi - lo) * rng.random(lo.shape)).astype(np.int32)
        lo = np.stack([lo, np.where(cut, mid, hi)], 1).reshape(-1, B)
        hi = np.stack([np.where(cut, mid, hi), hi], 1).reshape(-1, B)
        mask = np.stack([mask, mask & cut], 1).reshape(-1, B)
    return bases, quals, lo, hi, mask


def _stat_into_equal(name, args, zero_lo, SL, seed):
    """stat_batch_into against stat_batch_into_plain from one non-zero
    starting accumulator: the side vectors and the medians must be equal;
    cycles at and past L must keep their starting values.  Returns
    (max_abs_err, the kernel's side vector)."""
    import torch
    from fastplong_tpu_torch.ops.stats_kernels import (
        flat_side_len, stat_batch_into, stat_batch_into_plain)
    g = torch.Generator().manual_seed(seed)
    start = torch.randint(-(1 << 40), 1 << 40, (flat_side_len(SL),),
                          generator=g, dtype=torch.int64).to(args[0].device)
    got, ref = start.clone(), start.clone()
    err = max(require_equal(name + " median",
                            stat_batch_into(got, *args, zero_lo=zero_lo),
                            stat_batch_into_plain(ref, *args,
                                                  zero_lo=zero_lo)),
              require_equal(name + " accumulator", got, ref))
    L = args[0].shape[1]
    if L < SL:
        require_equal(name + " cycles past L", got[18 * L:18 * SL],
                      start[18 * L:18 * SL])
    return err, got


def _stat_work(L, lo, hi, mask, zero_lo):
    """(bytes, operations) of one stat_batch_into call for its bound: the
    in-span bytes of bases and quals read once (what these spans need),
    lo/hi/mask read once, the accumulator's 18 L cycle values and its
    1,168 other values read and written once (int64), the medians written
    once; about 10 word operations per in-span cycle."""
    import torch
    lo = lo.to(torch.int64)
    hi = torch.maximum(hi.to(torch.int64), lo)
    n = hi if zero_lo else hi - lo
    n = torch.where(mask, torch.clamp(n, 0, L), 0)
    cycles = int(n.sum().item())
    rows = lo.numel()
    return (2 * cycles + 9 * rows + 16 * (18 * L + 1168) + rows,
            10 * cycles)


def phase_stat_batch(rng, bases):
    """The statistics kernel (stat_batch_into) against its plain version,
    exactly, from a non-zero starting accumulator: on the edge batch in the
    pre-filter form and over 2 and 4 slots, with L below the accumulator's
    cycle length (whose later cycles must stay as they were) and at an L
    that takes the byte-load path, then at the headline batch shape in the
    step's three forms (S = 1 pre-filter with zero_lo, S = 2 post-filter
    after the middle split, S = 4 after break), each timed by CUDA graph
    and by events.  Returns the S = 2 record (the headline's post-filter
    launch)."""
    import torch
    from fastplong_tpu_torch.ops.stats_kernels import (
        flat_side_len, stat_batch_into, stat_batch_into_plain)
    dev = bases.device
    for S, zero_lo, (B, L), SL in ((1, True, (40, 304), 1024),
                                   (2, False, (40, 304), 1024),
                                   (4, False, (40, 304), 304),
                                   (2, False, (37, 301), 512),
                                   (1, True, (37, 301), 512)):
        args = [torch.from_numpy(a).to(dev)
                for a in _stat_slots(rng, B, L, S, edge=True)]
        err, _ = _stat_into_equal("stat_batch", args, zero_lo, SL, S + L)
        log("phase 3: " + json.dumps(dict(
            name="stat_batch", shape="edge batch [%d, %d], S = %d, %s, "
            "accumulator at SL = %d" % (B, L, S, "pre-filter (zero_lo)"
                                        if zero_lo else "post-filter", SL),
            max_abs_err=err)))
    B, L = bases.shape
    rec = None
    for S, zero_lo, form in ((1, True, "S = 1 pre-filter (zero_lo)"),
                             (2, False, "S = 2 post-filter (middle split)"),
                             (4, False, "S = 4 post-filter (after break)")):
        _, quals, lo, hi, mask = _stat_slots(rng, B, L, S, edge=False)
        if zero_lo:
            lo[:] = 0
        args = [bases] + [torch.from_numpy(a).to(dev)
                          for a in (quals, lo, hi, mask)]
        err, _ = _stat_into_equal("stat_batch", args, zero_lo, L, S)
        side = torch.zeros(flat_side_len(L), dtype=torch.int64, device=dev)
        ms = graph_ms(lambda: stat_batch_into(side, *args, zero_lo=zero_lo))
        ev = cuda_ms(lambda: stat_batch_into(side, *args, zero_lo=zero_lo))
        plain = cuda_ms(lambda: stat_batch_into_plain(side, *args,
                                                      zero_lo=zero_lo),
                        reps=3, inner=1)
        bms, by = bound(*_stat_work(L, *args[2:], zero_lo), WORD32_OPS_PER_S)
        r = dict(name="stat_batch", shape="[%d, %d] %s" % (B, L, form),
                 max_abs_err=err, ms=ms, eager_ms=ev, plain_ms=plain,
                 bound_ms=bms, bound_by=by, x_bound=ms / bms,
                 library_ms=None)
        log("phase 3: " + json.dumps(r))
        if S == 2:
            rec = r
    return rec


def _myers_work(pm, plen, text, tlen):
    """(bytes, operations) of one Myers problem for its bound: text, plen,
    tlen and the table read once, the distances written once; about 20
    word operations per column for each pattern word up to the lane's top
    word, and 5 for its score, over the columns its text has."""
    import torch
    N, T = text.shape
    K = pm.shape[1]
    p = torch.clamp(plen.to(torch.int64), min=0)
    words = torch.clamp((p - 1) // 32, 0, K - 1) + 1
    cols = torch.clamp(tlen.to(torch.int64), 0, T)
    ops = int(torch.where(p > 0, cols * (20 * words + 5), 0).sum().item())
    return N * T + 12 * N + pm.numel() * 4, ops


def _conv_mismatch(x, ad, mm):
    """Time of one torch conv1d computing the same mismatch counts from a
    one-hot encoding of the bases: mm = alen - matches.  fp16 up to 300
    bp (its integers are exact up to 2,048), else fp32 with TF32 off
    (main() sets it), exact up to 2^24.  Checked equal to the kernel's
    output; the encoding is not timed."""
    import torch
    import torch.nn.functional as F
    codes = torch.full((256,), 5, dtype=torch.int64, device=x.device)
    for i, c in enumerate(b"ACGTN"):
        codes[c] = i
    alen = ad.shape[0]
    dtype = torch.float16 if alen <= 300 else torch.float32
    xp = F.pad(x, (0, alen - 1))
    onehot = F.one_hot(codes[xp.long()], 6)[..., :5].permute(0, 2, 1)
    onehot = onehot.to(dtype).contiguous()
    w = F.one_hot(codes[ad.long()], 6)[..., :5].T[None].to(dtype)
    w = w.contiguous()
    match = F.conv1d(onehot, w)[:, 0]
    if not torch.equal((alen - match.float()).to(mm.dtype), mm):
        raise AssertionError("conv1d yardstick (%s) disagrees with the "
                             "kernel" % dtype)
    return cuda_ms(lambda: F.conv1d(onehot, w))


def _rand_batch(rng, B, L, plant=(), lowq=False):
    """Random reads with N bases and adapters planted anywhere in them;
    lowq: the qualities of _lowq_quals."""
    import numpy as np
    bases = _rand_bases(rng, (B, L))
    quals = (_lowq_quals(rng, B, L) if lowq else
             rng.integers(33 + 2, 33 + 41, size=(B, L)).astype(np.uint8))
    lens = rng.integers(min(25, L), L + 1, size=B).astype(np.int32)
    mask = np.ones(B, bool)
    mask[rng.integers(0, B)] = False
    for i in range(B):
        for seq in plant:
            if rng.random() < 0.5:
                a = np.frombuffer(seq.encode(), np.uint8)
                if lens[i] > len(a) + 2:
                    p = int(rng.integers(0, lens[i] - len(a)))
                    bases[i, p:p + len(a)] = a
    return bases, quals, lens, mask


def _pack(bases, quals, lens, mask, b5):
    """The runner's batch layouts (pipeline/batches.py): base5 [B, L+8] or
    wide [B, 2L+8], each ending in len(le32) || mask || 3 zero bytes."""
    import numpy as np
    from fastplong_tpu_torch.pipeline.batches import _B5_CODE, _B5_QMUL
    B, L = bases.shape
    valid = np.arange(L)[None, :] < lens[:, None]
    meta = np.zeros((B, 8), np.uint8)
    meta[:, :4] = lens.astype("<i4").view(np.uint8).reshape(B, 4)
    meta[:, 4] = mask
    if b5:
        v = (_B5_CODE[bases] + _B5_QMUL[quals]).astype(np.uint8)
        return np.concatenate([np.where(valid, v, 255).astype(np.uint8),
                               meta], axis=1)
    return np.concatenate([np.where(valid, bases, 0),
                           np.where(valid, quals, 0), meta],
                          axis=1).astype(np.uint8)


def _params(flags):
    from fastplong_tpu_torch.main import build_parser, options_from_args
    from fastplong_tpu_torch.pipeline.device import kernel_params
    argv = ["fastplong", "-i", "in.fq", "-o", "out.fq"] + flags
    return kernel_params(options_from_args(
        build_parser().parse_args(argv[1:]), argv))


def _region_rows(rows, cap):
    """(active slots that carry a region number, slots with a mask span
    mask_hi > mask_lo) in packed step rows."""
    slot = rows[:, 5:5 + 6 * cap].reshape(len(rows), cap, 6)
    active = (slot[..., 4] >> 10) & 1
    return (int(((slot[..., 5] > 0) & (active == 1)).sum()),
            int((slot[..., 3] > slot[..., 2]).sum()))


def phase_step(flags=HEADLINE):
    """The fused step on CUDA against the port's CPU step, bit for bit:
    packed rows and the statistics accumulator (break and mask runs get
    low-quality stretches in their batches and must find regions: break
    fragments with a region number, mask spans with mask_hi > mask_lo)."""
    import numpy as np
    import torch
    from fastplong_tpu_torch.pipeline.device import (build_fast_step,
                                                     global_stat_len,
                                                     params_cap,
                                                     zero_stats_state)
    p = _params(flags)
    lowq = p["break_enabled"] or p["mask_enabled"]
    found = [0, 0]
    rng = np.random.default_rng(SEED + 1 + lowq)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    fast_g, _ = build_fast_step(p, cuda)
    fast_c, _ = build_fast_step(p, cpu)
    SL = global_stat_len()
    st_g, st_c = zero_stats_state(SL, cuda), zero_stats_state(SL, cpu)
    L = 8192
    tg = tc = 0.0
    for k in range(3):
        batch = _rand_batch(rng, 256, L, plant=(START, END), lowq=lowq)
        packed = torch.from_numpy(_pack(*batch, b5=(k != 2)))
        t0 = time.perf_counter()
        rows_g = fast_g(st_g, packed.to(cuda), L).cpu()
        tg += time.perf_counter() - t0
        t0 = time.perf_counter()
        rows_c = fast_c(st_c, packed, L)
        tc += time.perf_counter() - t0
        if not torch.equal(rows_g, rows_c):
            bad = (rows_g != rows_c).nonzero()[:5].tolist()
            raise AssertionError("step rows differ (batch %d): %s" % (k, bad))
        found = [a + b for a, b in zip(found, _region_rows(rows_c.numpy(),
                                                            params_cap(p)))]
    if not torch.equal(st_g.cpu(), st_c):
        raise AssertionError("step statistics state differs")
    if (p["break_enabled"] and not found[0]) or (
            p["mask_enabled"] and not p["break_enabled"] and not found[1]):
        raise AssertionError("step with %s found no region: %d fragments "
                             "with a region number, %d mask spans"
                             % (flags[len(HEADLINE):], *found))
    log("phase 4: fused step, flags %s, [256, %d] x 3 batches (base5, "
        "base5, wide) bit-exact on cuda vs cpu, rows and state (host wall "
        "%.3f s cuda, %.3f s cpu); %d fragments with a region number, %d "
        "mask spans"
        % (" ".join(f for f in flags if len(f) < 5), L, tg, tc, *found))


def gen_input(path, n_reads=None, mean_len=8000, seed=SEED, lowq=0.0):
    """The repo's headline input (bench.py gen_input): gamma(3, mean/3)
    lengths with a floor of 100, 80% of reads with each adapter planted.
    lowq: the share of reads that get one to three stretches of 60-800
    bases with quality bytes 35-41 (Q2-Q8) at random positions; these
    rates only make break and mask find regions for a functional check,
    and are not taken from measured reads."""
    import numpy as np
    n_reads = n_reads or N_READS
    rng = np.random.default_rng(seed)
    qtab = (rng.integers(33 + 5, 33 + 40, size=1 << 16)).astype(np.uint8)
    s_arr = np.frombuffer(START.encode(), np.uint8)
    e_arr = np.frombuffer(END.encode(), np.uint8)
    nbases = 0
    with open(path, "wb") as f:
        chunks = []
        for i in range(n_reads):
            n = max(100, int(rng.gamma(3.0, mean_len / 3.0)))
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
            if rng.random() < 0.8:
                seq = np.concatenate([s_arr, seq])
            if rng.random() < 0.8:
                seq = np.concatenate([seq, e_arr])
            qual = qtab[rng.integers(0, 1 << 16, size=len(seq))]
            if lowq and rng.random() < lowq:
                for _ in range(int(rng.integers(1, 4))):
                    p = int(rng.integers(0, len(seq)))
                    k = min(int(rng.integers(60, 801)), len(seq) - p)
                    qual[p:p + k] = rng.integers(35, 42, k)
            nbases += len(seq)
            chunks += [b"@read%d\n" % i, seq.tobytes(), b"\n+\n",
                       qual.tobytes(), b"\n"]
            if len(chunks) > 4000:
                f.write(b"".join(chunks))
                chunks = []
        f.write(b"".join(chunks))
    return nbases


def headline_input(workdir):
    """(path, bases) of the headline input in workdir, made on first use."""
    in_fq = os.path.join(workdir, "in.fq")
    if not os.path.exists(in_fq):
        t0 = time.perf_counter()
        headline_input.bases = gen_input(in_fq)
        log("phase 5: input %d reads, %d bases, made in %.1f s"
            % (N_READS, headline_input.bases, time.perf_counter() - t0))
    return in_fq, headline_input.bases


def run_cli(workdir, in_fq, tag, device, timer_dump=None, flags=HEADLINE):
    """One in-process CLI run; returns (wall seconds, output paths)."""
    from fastplong_tpu_torch.main import main
    outs = [os.path.join(workdir, tag + s)
            for s in (".fq", ".failed.fq", ".json", ".html")]
    argv = ["fastplong", "-i", in_fq, "-o", outs[0], "--failed_out",
            outs[1], "-j", outs[2], "-h", outs[3]] + flags
    env = {"FASTPLONG_TORCH_DEVICE": device}
    if timer_dump:
        env["FASTPLONG_TIMER_DUMP"] = timer_dump
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with open(os.path.join(workdir, tag + ".log"), "w") as err, \
                contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            rc = main(argv)
            if device == "cuda":
                import torch
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise AssertionError("CLI run %s exited %r" % (tag, rc))
    return wall, outs


def _normalised(path):
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith(".json"):
        data = re.sub(rb'"command": ".*"', b'"command": "X"', data)
    elif path.endswith(".html"):
        data = re.sub(rb'at [0-9: -]+ </title>', b'at T </title>', data)
        data = re.sub(rb'at [0-9: -]+ </div>', b'at T </div>', data)
        data = re.sub(rb'<p>.*?</p>', b'<p>X</p>', data)
    return data


def require_same_outputs(got, want, phase, what):
    """Four output paths against four: FASTQ and failed reads byte for
    byte, JSON without its command line, normalised HTML."""
    for g, w in zip(got, want):
        if _normalised(g) != _normalised(w):
            raise AssertionError("phase %s: %s differs from %s (%s)"
                                 % (phase, os.path.basename(g),
                                    os.path.basename(w), what))


def check_report(out_fq, json_path, n_reads, n_bases, phase="5"):
    """The JSON report against the input and the trimmed FASTQ: every input
    read and base counted before filtering, every written record and base
    after it, and adapters found in the reads that carry them."""
    with open(json_path) as f:
        rep = json.load(f)
    before = rep["summary"]["before_filtering"]
    after = rep["summary"]["after_filtering"]
    out_reads = out_bases = 0
    with open(out_fq, "rb") as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                out_reads += 1
                out_bases += len(line) - 1
    trimmed = rep["adapter_cutting"]["adapter_trimmed_reads"]
    got = (before["total_reads"], before["total_bases"],
           after["total_reads"], after["total_bases"])
    want = (n_reads, n_bases, out_reads, out_bases)
    if got != want or not 0 < trimmed <= n_reads:
        raise AssertionError("report disagrees with the data: reads/bases "
                             "%s, expected %s; adapter-trimmed reads %d"
                             % (got, want, trimmed))
    log("phase %s: report counts match the input (%d reads, %d bases) and "
        "the output (%d reads, %d bases); %d reads adapter-trimmed"
        % ((phase,) + want + (trimmed,)))


# kernel launches per step call on each path: one scan per distinct
# adapter, one seed scan per trim side, three paired verifies (start trim,
# end trim, middle), one statistics launch per side of the accumulator
# (pre-filter, and post-filter over all out-read slots at once), and one
# region launch for break and one for mask (all slots of a stage at once)
PER_STEP = {
    "headline": {"mismatch_scan": 2, "myers_verify": 3, "seed_scan": 2,
                 "stat_batch": 2, "regions": 0},
    "break_mask": {"mismatch_scan": 2, "myers_verify": 3, "seed_scan": 2,
                   "stat_batch": 2, "regions": 2},
    "mask": {"mismatch_scan": 2, "myers_verify": 3, "seed_scan": 2,
             "stat_batch": 2, "regions": 1},
    # config 4: the detected adapters take the headline's kernels
    "autodetect": {"mismatch_scan": 2, "myers_verify": 3, "seed_scan": 2,
                   "stat_batch": 2},
    # config 5 adds one break launch (all slots at once)
    "config5": {"mismatch_scan": 2, "myers_verify": 3, "seed_scan": 2,
                "stat_batch": 2, "regions": 1},
    # a 700 bp -s (and its reverse complement as -e): the trims verify
    # alone (no full-match search at 200 bp and over), each side's middle
    # verify takes the block-scan
    "long": {"mismatch_scan": 2, "myers_verify": 2, "seed_scan": 2,
             "stat_batch": 2, "myers_blockscan": 2},
}
# kernel launches per run: the k-mer fill, once a side of auto-detection
PER_RUN = {"autodetect": {"kmer_hist": 2}, "config5": {"kmer_hist": 2}}
# device ops per step call in the profiled runs of the tree before the
# statistics kernel added into the accumulator itself (commit 0110662,
# PERF.md)
OPS_PER_STEP_BEFORE = {"headline": 1040, "break_mask": 1380}


def kernel_wrappers(names):
    """The wrappers whose `launches` count the kernels named (regions is
    imported only when named, and the statistics kernel's wrapper is
    stat_batch where stat_batch_into does not exist, so that --walls runs
    in an older tree)."""
    from fastplong_tpu_torch.ops import stats_kernels
    from fastplong_tpu_torch.ops.adapter import seed_scan
    from fastplong_tpu_torch.ops.mismatch import mismatch_scan
    from fastplong_tpu_torch.ops.myers import myers_verify
    stat = getattr(stats_kernels, "stat_batch_into", None)
    wrappers = {"mismatch_scan": mismatch_scan, "myers_verify": myers_verify,
                "seed_scan": seed_scan,
                "stat_batch": stat or stats_kernels.stat_batch}
    if "regions" in names:
        from fastplong_tpu_torch.ops.regions import detect_regions_summary
        wrappers["regions"] = detect_regions_summary
    if "kmer_hist" in names:
        from fastplong_tpu_torch.ops.kmer import kmer_hist
        wrappers["kmer_hist"] = kmer_hist
    if "myers_blockscan" in names:
        from fastplong_tpu_torch.ops.myers import myers_blockscan
        wrappers["myers_blockscan"] = myers_blockscan
    return {n: wrappers[n] for n in names}


def path_kernels(path):
    return tuple(PER_STEP[path]) + tuple(PER_RUN.get(path, ()))


def check_launches(launches, steps, path):
    want = {n: c * steps for n, c in PER_STEP[path].items()}
    want.update(PER_RUN.get(path, {}))
    missing = [n for n, c in launches.items() if c <= 0 < want[n]]
    if missing:
        raise AssertionError("kernels not launched on the %s path: %s"
                             % (path, missing))
    if launches != want:
        raise AssertionError("launches %s, expected %s for %d steps"
                             % (launches, want, steps))


def phase_cli(workdir, walls_only=False):
    """The headline CLI on CUDA over the 64-Mbase input, its launch counts,
    byte parity with the CPU run, and one profiled run.  walls_only: the
    three runs and the profile, printed and not checked."""
    import torch
    in_fq, nbases = headline_input(workdir)
    small = os.path.join(workdir, "small.fq")
    with open(in_fq, "rb") as src, open(small, "wb") as dst:
        dst.write(b"".join(src.readline() for _ in range(4 * 300)))
    run_cli(workdir, small, "warm", "cuda")   # first-call set-up off clock
    from fastplong_tpu_torch import native
    log("phase 5: native host library %s, gzip through %s" % (
        "loaded" if native.get_lib() is not None else "MISSING (numpy path)",
        "libdeflate" if native.gzip_available() else "zlib"))

    # three runs of the same CLI in this process, for the host's spread;
    # the launch counts are set to 0 before each run and read after it
    wrappers = kernel_wrappers(
        ("mismatch_scan", "myers_verify", "seed_scan", "stat_batch")
        if walls_only else tuple(PER_STEP["headline"]))
    walls = []
    for k in range(3):
        for w in wrappers.values():
            w.launches = 0
        dump = os.path.join(workdir, "timer%d.json" % k)
        wall, outs_g = run_cli(workdir, in_fq, "cuda%d" % k, "cuda",
                               timer_dump=dump)
        launches = {n: w.launches for n, w in wrappers.items()}
        walls.append(wall)
        with open(dump) as f:
            timing = json.load(f)
        log("phase 5: headline CLI on cuda, run %d: %d bases in %.3f s = "
            "%.2f Mbases/s; %d step calls; kernel launches %s"
            % (k, nbases, wall, nbases / wall / 1e6, timing["step_calls"],
               json.dumps(launches)))
        log("phase 5:   seconds " + json.dumps(timing))
        if not walls_only:
            check_launches(launches, timing["step_calls"], "headline")
    med = statistics.median(walls)
    log("phase 5: headline wall median %.3f s (%.2f Mbases/s), range "
        "%.3f-%.3f s over 3 runs" % (med, nbases / med / 1e6, min(walls),
                                     max(walls)))

    if not walls_only:
        cpu_parity(workdir, in_fq, outs_g, nbases)
    _, evs = profile_cli(workdir, in_fq, path="headline")
    if not walls_only:
        no_index_add(evs)
    return launches, torch.cuda.get_device_name(0), outs_g


def no_index_add(evs):
    stray = [e.key for e in evs if "index_add" in e.key
             or "indexFunc" in e.key]
    if stray:
        raise AssertionError("index_add_ still runs on the device: %s"
                             % stray)


def run_counted(workdir, in_fq, tag, flags, path, phase, label=None):
    """One CUDA CLI run with the launch counts of `path`'s kernels set to 0
    before it and checked after it; returns (launches, output paths,
    wall)."""
    wrappers = kernel_wrappers(path_kernels(path))
    for w in wrappers.values():
        w.launches = 0
    dump = os.path.join(workdir, "timer_%s.json" % tag)
    wall, outs_g = run_cli(workdir, in_fq, tag, "cuda", timer_dump=dump,
                           flags=flags)
    launches = {n: w.launches for n, w in wrappers.items()}
    with open(dump) as f:
        timing = json.load(f)
    log("phase %s: %s CLI on cuda (a functional check): wall %.3f s; %d "
        "step calls; kernel launches %s"
        % (phase, label or " ".join(flags[len(HEADLINE):]), wall,
           timing["step_calls"], json.dumps(launches)))
    log("phase %s:   seconds %s" % (phase, json.dumps(timing)))
    check_launches(launches, timing["step_calls"], path)
    return launches, outs_g, wall


def phase_break_mask(workdir):
    """The headline flags with break and mask (-b -N, default windows)
    over a 64-Mbase input with low-quality stretches in 30% of its reads:
    one CUDA run with its launch counts, fragments and failed reads, byte
    parity with the CPU run, and a profile.  Returns (launches, input
    path, its bases)."""
    in_fq = os.path.join(workdir, "lowq.fq")
    flags = HEADLINE + ["-b", "-N"]
    t0 = time.perf_counter()
    nbases = gen_input(in_fq, seed=8, lowq=0.3)
    log("phase 5b: input %d reads, %d bases (30%% with Q2-Q8 stretches), "
        "made in %.1f s" % (N_READS, nbases, time.perf_counter() - t0))
    launches, outs_g, _ = run_counted(workdir, in_fq, "bm_cuda", flags,
                                      "break_mask", "5b")
    with open(outs_g[0], "rb") as f:
        fragments = len(re.findall(rb"^@r[0-9]+-", f.read(), re.M))
    failed = os.path.getsize(outs_g[1])
    log("phase 5b: %d rN- fragments in the output, failed reads %d B"
        % (fragments, failed))
    if not fragments or not failed:
        raise AssertionError("the break-and-mask run wrote no fragment or "
                             "no failed read")
    cpu_parity(workdir, in_fq, outs_g, nbases, flags=flags, phase="5b")
    _, evs = profile_cli(workdir, in_fq, flags=flags, phase="5b",
                         path="break_mask")
    no_index_add(evs)
    return launches, in_fq, nbases


def _n_runs(path, window):
    """(records, records whose sequence holds a run of at least `window`
    N) in a FASTQ file."""
    records = runs = 0
    pat = re.compile(rb"N{%d,}" % window)
    with open(path, "rb") as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                records += 1
                runs += pat.search(line) is not None
    return records, runs


def phase_mask(workdir, in_fq, nbases):
    """The headline flags with N-masking alone (-N, default window 50 at
    Q10) over phase 5b's input, where the mask is not preceded by break:
    one CUDA run with its launch counts; most N-masked reads fail the
    default N limit (-n: more than 10% N), so the failed-reads file must
    hold reads with runs of N at least one window long; byte parity with
    the CPU run."""
    flags = HEADLINE + ["-N"]
    _, outs_g, _ = run_counted(workdir, in_fq, "n_cuda", flags, "mask",
                               "5c")
    out_n = _n_runs(outs_g[0], 50)
    failed_n = _n_runs(outs_g[1], 50)
    log("phase 5c: reads with a run of >= 50 N: %d of %d written, %d of %d "
        "failed" % (out_n[1], out_n[0], failed_n[1], failed_n[0]))
    if not failed_n[1]:
        raise AssertionError("the -N run wrote no read masked over a whole "
                             "window")
    cpu_parity(workdir, in_fq, outs_g, nbases, flags=flags, phase="5c")
    profile_cli(workdir, in_fq, flags=flags, phase="5c", path="mask")


def _detection_lines(workdir, tag):
    """The auto-detection verdicts in run `tag`'s stderr."""
    with open(os.path.join(workdir, tag + ".log")) as f:
        return [ln.rstrip("\n") for ln in f if ln.startswith(
            ("Detected:", "Not detected", "Found possible"))]


def phase_autodetect(workdir):
    """BASELINE config 4: the CLI with no adapter flags over the headline
    input, so that both adapters are auto-detected: one CUDA run with its
    launch counts (one k-mer fill a side, the headline's kernels per step),
    the evaluator's seconds (the fill and the copy of its accumulator to
    the host among them), byte parity of its four outputs and of its
    "Detected:" lines with the CPU run.  Returns its launches."""
    in_fq, nbases = headline_input(workdir)
    launches, outs_g, _ = run_counted(workdir, in_fq, "c4_cuda", CONFIG4,
                                      "autodetect", "5d",
                                      label="config 4 (no adapter flags)")
    cpu_parity(workdir, in_fq, outs_g, nbases, flags=CONFIG4, phase="5d")
    got, want = (_detection_lines(workdir, t) for t in ("c4_cuda", "cpu"))
    log("phase 5d: %s" % " | ".join(got))
    if got != want or len(got) != 2 or not all(
            d.startswith("Detected:") for d in got):
        raise AssertionError("auto-detection differs or failed: cuda %s, "
                             "cpu %s" % (got, want))
    return launches


def _split_files(workdir, tag):
    import glob
    paths = glob.glob(os.path.join(workdir, "*." + tag + ".fq"))
    return {os.path.basename(p).split(".")[0]: p for p in paths}


def phase_config5(workdir, card):
    """BASELINE config 5, -b -y --split 4 (auto-detection, break, the
    low-complexity filter, four split files) over the headline input: one
    CUDA run with its launch counts and wall beside the card, the four
    split files byte-equal to the CPU run's, the JSON without its command
    line and the normalised HTML equal, every read and base accounted
    for."""
    in_fq, nbases = headline_input(workdir)
    _, outs_g, wall = run_counted(workdir, in_fq, "c5_cuda", CONFIG5,
                                  "config5", "5e",
                                  label="config 5 (-b -y --split 4)")
    log("phase 5e: config 5 wall %.3f s for %d bases (%.2f Mbases/s), %s; "
        "a functional check" % (wall, nbases, nbases / wall / 1e6, card))
    t0 = time.perf_counter()
    _, outs_c = run_cli(workdir, in_fq, "c5_cpu", "cpu", flags=CONFIG5)
    log("phase 5e: the same CLI on the cpu in %.1f s"
        % (time.perf_counter() - t0))
    files_g, files_c = (_split_files(workdir, t) for t in ("c5_cuda",
                                                           "c5_cpu"))
    if sorted(files_g) != sorted(files_c) or len(files_g) != 4:
        raise AssertionError("split files differ: %s vs %s"
                             % (sorted(files_g), sorted(files_c)))
    reads = bases = 0
    for k in sorted(files_g):
        with open(files_g[k], "rb") as a, open(files_c[k], "rb") as b:
            data = a.read()
            if data != b.read():
                raise AssertionError("split file %s differs between cuda "
                                     "and cpu runs" % k)
        seqs = data.split(b"\n")[1::4]
        reads += len(seqs)
        bases += sum(map(len, seqs))
    require_same_outputs(outs_g[2:], outs_c[2:], "5e", "cuda against cpu")
    with open(outs_g[2]) as f:
        rep = json.load(f)["summary"]
    got = (rep["before_filtering"]["total_reads"],
           rep["before_filtering"]["total_bases"],
           rep["after_filtering"]["total_reads"],
           rep["after_filtering"]["total_bases"])
    if got != (N_READS, nbases, reads, bases):
        raise AssertionError("config 5 report %s, expected %s"
                             % (got, (N_READS, nbases, reads, bases)))
    log("phase 5e: split files %s identical on cuda and cpu (%d reads, %d "
        "bases, as the report counts), json and html identical"
        % (" ".join("%s: %d B" % (k, os.path.getsize(files_g[k]))
                    for k in sorted(files_g)), reads, bases))


def long_adapter_input(path, n_reads=300, seed=9):
    """A few hundred reads of 800-4,000 bases: LONG_ADAPTER planted in the
    middle of 60% of them (with up to 30 substitutions), its last 40-150
    bases at the start of 20%, nothing in the rest; Q8-Q40 qualities."""
    import numpy as np
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ad = np.frombuffer(LONG_ADAPTER.encode(), np.uint8)
    nbases = 0
    with open(path, "wb") as f:
        for i in range(n_reads):
            seq = rng.choice(acgt, int(rng.integers(800, 4001)))
            u = rng.random()
            if u < 0.6:
                a = ad.copy()
                k = int(rng.integers(0, 31))
                a[rng.integers(0, len(a), k)] = rng.choice(acgt, k)
                p = int(rng.integers(0, len(seq)))
                seq = np.concatenate([seq[:p], a, seq[p:]])
            elif u < 0.8:
                seq = np.concatenate([ad[-int(rng.integers(40, 151)):], seq])
            qual = rng.integers(33 + 8, 33 + 41, len(seq)).astype(np.uint8)
            nbases += len(seq)
            f.write(b"@long%d\n%s\n+\n%s\n" % (i, seq.tobytes(),
                                                qual.tobytes()))
    return nbases


def phase_long_adapter(workdir):
    """A 700-bp start adapter (-s; its reverse complement is the end
    adapter) over a few hundred reads that carry it: one CUDA run in which
    each side's middle-adapter verify takes the block-scan kernel (launch
    counts checked), and byte parity of its four outputs with the CPU
    run.  Returns its launches."""
    in_fq = os.path.join(workdir, "long.fq")
    nbases = long_adapter_input(in_fq)
    flags = ["-s", LONG_ADAPTER]
    launches, outs_g, _ = run_counted(workdir, in_fq, "long_cuda", flags,
                                      "long", "5f",
                                      label="-s (a 700 bp adapter)")
    cpu_parity(workdir, in_fq, outs_g, nbases, flags=flags, phase="5f",
               n_reads=300)
    return launches


def cpu_parity(workdir, in_fq, outs_g, nbases, flags=HEADLINE, phase="5",
               n_reads=None):
    """The same CLI on the CPU; its four outputs must equal the CUDA
    run's."""
    t0 = time.perf_counter()
    _, outs_c = run_cli(workdir, in_fq, "cpu", "cpu", flags=flags)
    log("phase %s: the same CLI on the cpu in %.1f s"
        % (phase, time.perf_counter() - t0))
    require_same_outputs(outs_g, outs_c, phase, "cuda against cpu")
    log("phase %s: whole-input outputs identical on cuda and cpu "
        "(fastq %d B, failed %d B, json %d B, html %d B)"
        % ((phase,) + tuple(os.path.getsize(p) for p in outs_g)))
    check_report(outs_g[0], outs_g[2], n_reads or N_READS, nbases, phase)


def profile_cli(workdir, in_fq, flags=HEADLINE, phase="5", path=None):
    """One profiled CUDA run: its wall, device time, op count (in all and
    per step call, beside the count before this tree where there is one)
    and top device ops; returns (wall, device events)."""
    from torch.profiler import ProfilerActivity, profile
    dump = os.path.join(workdir, "timer_prof.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pwall, _ = run_cli(workdir, in_fq, "prof", "cuda", timer_dump=dump,
                           flags=flags)
    with open(dump) as f:
        steps = json.load(f)["step_calls"]
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) is not None
           and str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in evs)
    nops = sum(e.count for e in evs)
    before = OPS_PER_STEP_BEFORE.get(path)
    log("phase %s: profiled run wall %.3f s; device busy %.3f ms in %d "
        "device ops = %.1f%% of that wall; %d step calls, %.1f device ops "
        "per step call%s"
        % (phase, pwall, busy_us / 1e3, nops, 100.0 * busy_us / 1e6 / pwall,
           steps, nops / max(steps, 1),
           " (0110662: about %d)" % before if before else ""))
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:15]:
        log("phase %s:   %9.3f ms %6d x %s" % (
            phase, e.self_device_time_total / 1e3, e.count, e.key[:100]))
    for e in evs:
        if "stat_batch_kernel" in e.key or "regions_kernel" in e.key:
            log("phase %s:   in the run: %.5f ms per launch of %s (%d "
                "launches)" % (phase, e.self_device_time_total / 1e3
                               / max(e.count, 1), e.key[:60], e.count))
    return pwall, evs

# the CUDA symbols of the headline's four kernels, as a trace names them
HEADLINE_SYMBOLS = {"mismatch_scan": "mismatch_bits_kernel",
                    "myers_verify": "myers_verify_kernel",
                    "seed_scan": "seed_scan_kernel",
                    "stat_batch": "stat_batch_kernel"}


def phase_profile_flag(workdir, outs5):
    """5g: the headline CLI on CUDA with --profile DIR: its launch counts,
    one trace file in DIR holding device events of the four headline
    kernels under their CUDA symbols, outputs equal to phase 5's run."""
    import glob
    in_fq, _ = headline_input(workdir)
    trace_dir = os.path.join(workdir, "trace")
    launches, outs, wall = run_counted(
        workdir, in_fq, "profile_flag", HEADLINE + ["--profile", trace_dir],
        "headline", "5g", label="the headline with --profile DIR")
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError("--profile wrote %s, not one trace file"
                             % os.listdir(trace_dir))
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {n: sum(sym in k for k in kernels)
             for n, sym in HEADLINE_SYMBOLS.items()}
    log("phase 5g: trace %s, %d B, %d events, %d kernel events; by symbol "
        "%s against launches %s" % (
            os.path.basename(traces[0]), os.path.getsize(traces[0]),
            len(events), len(kernels), json.dumps(found),
            json.dumps(launches)))
    missing = [n for n, c in found.items() if c == 0]
    if missing:
        raise AssertionError("the --profile trace holds no device event of "
                             "%s" % missing)
    require_same_outputs(outs, outs5, "5g", "--profile changed the output")
    log("phase 5g: outputs identical to phase 5's run (wall %.3f s with the "
        "profiler on)" % wall)


def _package_copy(root):
    """The package's sources under root, without a built library."""
    import shutil
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.copytree(os.path.join(here, "fastplong_tpu_torch"),
                    os.path.join(root, "fastplong_tpu_torch"),
                    ignore=shutil.ignore_patterns("_kernels", "*.so",
                                                  "__pycache__"))
    return root


# a fresh process's first job, timed by its parts (phase 5h)
FRESH_PROCESS = """
import json, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t2 = time.perf_counter()
from fastplong_tpu_torch.main import main
from fastplong_tpu_torch.ops import cuda_lib
cuda_lib.lib()
t3 = time.perf_counter()
rc = main(["fastplong"] + sys.argv[1:])
torch.cuda.synchronize()
t4 = time.perf_counter()
print(json.dumps({"import_torch": t1 - t0, "cuda_start": t2 - t1,
                  "import_port_load_library": t3 - t2, "first_job": t4 - t3,
                  "rc": rc}))
"""


def phase_prewarm(workdir):
    """5h, cold start.  First `python -m fastplong_tpu_torch.main
    --prewarm` with the headline adapter flags, a subprocess on cuda in an
    empty working directory, from a copy of the package with no built
    library, as a first deployment starts: rc 0, the directory left empty,
    the kernel library built by its cold pass, its cold and warm pass
    seconds.  Then a fresh process from the checkout, whose library phase
    2 built, as each later job starts: its seconds to import torch, to
    start CUDA, to import the port and load the library, and for its
    first CLI run (phase 5's 300-read warm-up input), with that run's
    timer dump."""
    here = os.path.dirname(os.path.abspath(__file__))
    cold = _package_copy(os.path.join(workdir, "unbuilt"))
    cwd = tempfile.mkdtemp(dir=workdir)
    env = dict(os.environ, PYTHONPATH=cold, FASTPLONG_TORCH_DEVICE="cuda")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "fastplong_tpu_torch.main", "--prewarm"]
        + HEADLINE, cwd=cwd, env=env, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    lines = [ln for ln in r.stderr.splitlines() if ln.startswith("prewarm: ")]
    left = os.listdir(cwd)
    if r.returncode != 0 or len(lines) != 1 or left:
        raise AssertionError("--prewarm: rc %d, left %s in its directory:\n%s"
                             % (r.returncode, left, r.stderr[-3000:]))
    kdir = os.path.join(cold, "fastplong_tpu_torch", "_kernels")
    built = [p for p in os.listdir(kdir) if p.endswith(".ptxas.txt")]
    if len(built) != 1:
        raise AssertionError("--prewarm built no kernel library: %s" % built)
    with open(os.path.join(kdir, built[0])) as f:
        build = f.readline().strip()
    log("phase 5h: --prewarm with the library absent: %s; process wall "
        "%.1f s; its cold pass built the library (%s)"
        % (lines[0], wall, build))

    dump = os.path.join(workdir, "timer_fresh.json")
    out = os.path.join(workdir, "fresh")
    env = dict(os.environ, PYTHONPATH=here, FASTPLONG_TORCH_DEVICE="cuda",
               FASTPLONG_TIMER_DUMP=dump)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", FRESH_PROCESS, "-i",
         os.path.join(workdir, "small.fq"), "-o", out + ".fq", "-j",
         out + ".json", "-h", out + ".html"] + HEADLINE,
        cwd=workdir, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError("a fresh process exited %d:\n%s"
                             % (r.returncode, r.stderr[-3000:]))
    parts = json.loads(r.stdout.splitlines()[-1])
    with open(dump) as f:
        timing = json.load(f)
    log("phase 5h: a fresh process with the library built, its first job "
        "(300 reads): process wall %.2f s; seconds %s; the job's %s"
        % (wall, json.dumps(parts), json.dumps(timing)))
    return wall


def _write_records(path, lines):
    import gzip
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(b"".join(lines))
    else:
        with open(path, "wb") as f:
            f.write(b"".join(lines))


def phase_parallel(workdir):
    """5i: fastplong_tpu_torch.parallel.main in process over a folder of
    the headline input cut, record-aligned, into four files (one gzipped),
    an Undetermined_S0.fq and a non-FASTQ file, with the headline flags:
    exactly four files processed, the four headline kernels launched,
    each decompressed clean output equal to a single CUDA CLI run of that
    file, overall.html naming the four, their summed pre-filter reads and
    bases equal to the input's."""
    import gzip
    import io
    from fastplong_tpu_torch import parallel
    in_fq, nbases = headline_input(workdir)
    folder = os.path.join(workdir, "folder")
    outdir = os.path.join(workdir, "folder_out")
    os.makedirs(folder)
    with open(in_fq, "rb") as f:
        lines = f.readlines()
    per = len(lines) // 4 // 4 * 4
    names = ["part1.fq", "part2.fq.gz", "part3.fastq", "part4.fq"]
    for k, name in enumerate(names):
        _write_records(os.path.join(folder, name),
                       lines[k * per:(k + 1) * per if k < 3 else None])
    _write_records(os.path.join(folder, "Undetermined_S0.fq"), lines[:400])
    with open(os.path.join(folder, "samplesheet.csv"), "w") as f:
        f.write("sample,file\npart1,part1.fq\n")
    wrappers = kernel_wrappers(tuple(HEADLINE_SYMBOLS))
    for w in wrappers.values():
        w.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with open(os.path.join(workdir, "parallel.log"), "w") as err, \
            contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = parallel.main(["-i", folder, "-o", outdir,
                            "--args=" + " ".join(HEADLINE)])
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    processed = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("Processing: ")]
    log("phase 5i: parallel.py over %d files in %.3f s (rc %d); kernel "
        "launches %s" % (len(processed), wall, rc, json.dumps(launches)))
    if rc != 0 or len(processed) != 4:
        raise AssertionError("parallel.py processed %d files, rc %d:\n%s"
                             % (len(processed), rc, out.getvalue()[-2000:]))
    if not all(launches.values()):
        raise AssertionError("parallel.py ran without kernels: %s"
                             % launches)
    reads = bases = 0
    for k, name in enumerate(names):
        _, outs = run_cli(workdir, os.path.join(folder, name),
                          "single%d" % k, "cuda")
        base = name.split(".")[0]
        with gzip.open(os.path.join(outdir, base + ".clean.fastq.gz")) as g, \
                open(outs[0], "rb") as s1:
            if g.read() != s1.read():
                raise AssertionError("parallel.py's output of %s differs "
                                     "from a single CLI run" % name)
        with open(os.path.join(outdir, name + ".json")) as f:
            rep = json.load(f)["summary"]["before_filtering"]
        reads += rep["total_reads"]
        bases += rep["total_bases"]
    with open(os.path.join(outdir, "overall.html")) as f:
        html = f.read()
    if not all(n in html for n in names) or "Undetermined" in html:
        raise AssertionError("overall.html does not list the four files")
    if (reads, bases) != (N_READS, nbases):
        raise AssertionError("parallel.py's reports count %d reads, %d "
                             "bases; the input has %d, %d"
                             % (reads, bases, N_READS, nbases))
    log("phase 5i: four clean outputs identical to single CLI runs; "
        "overall.html lists the four; %d reads, %d bases before filtering, "
        "as in the input" % (reads, bases))


def phase_num_hosts(workdir, outs5):
    """5j: --num_hosts 2 as two subprocesses sharing the card, joined by
    FASTPLONG_COORDINATOR on a free local port, with the headline flags:
    both exit 0 within the script's timeout; their outputs and failed
    reads, each pair concatenated, equal phase 5's; host 0's merged JSON
    and the offline merge_reports JSON equal phase 5's JSON."""
    import shutil
    import socket
    from fastplong_tpu_torch.merge_reports import main as merge_main
    here = os.path.dirname(os.path.abspath(__file__))
    in_fq, _ = headline_input(workdir)
    d = os.path.join(workdir, "hosts")
    os.makedirs(d)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    timeout = 300
    env = dict(os.environ, PYTHONPATH=here, FASTPLONG_TORCH_DEVICE="cuda",
               FASTPLONG_COORDINATOR="127.0.0.1:%d" % port,
               FASTPLONG_COORDINATOR_TIMEOUT=str(timeout))
    outs = [os.path.join(d, "m" + s)
            for s in (".fq", ".failed.fq", ".json", ".html")]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fastplong_tpu_torch.main", "-i", in_fq,
         "-o", outs[0], "--failed_out", outs[1], "-j", outs[2], "-h",
         outs[3], "--num_hosts", "2", "--host_index", str(i)] + HEADLINE,
        cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in (0, 1)]
    try:
        results = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for i, (p, (_, err)) in enumerate(zip(procs, results)):
        if p.returncode != 0:
            raise AssertionError("host %d exited %d:\n%s" % (
                i, p.returncode, err.decode(errors="replace")[-3000:]))
    log("phase 5j: two host processes on one card, both rc 0 in %.1f s"
        % wall)
    for got, want in ((outs[0], outs5[0]), (outs[1], outs5[1])):
        cat = b""
        for i in (0, 1):
            with open(os.path.join(d, "%04d.%s" % (i + 1,
                                                   os.path.basename(got))),
                      "rb") as f:
                cat += f.read()
        with open(want, "rb") as f:
            if cat != f.read():
                raise AssertionError("the two hosts' %s differ from phase "
                                     "5's" % os.path.basename(got))
    require_same_outputs(outs[2:3], outs5[2:3], "5j", "host 0's merged "
                         "report")
    shutil.copy(outs[2], outs[2] + ".from_gloo")
    with open(os.path.join(workdir, "merge.log"), "w") as err, \
            contextlib.redirect_stderr(err):
        rc = merge_main(["merge", outs[2] + ".part0", outs[2] + ".part1"])
    if rc != 0:
        raise AssertionError("merge_reports exited %d" % rc)
    require_same_outputs(outs[2:3], outs5[2:3], "5j", "the offline merge")
    log("phase 5j: shards concatenated equal phase 5's output and failed "
        "reads; the gloo-merged and the offline-merged JSON equal phase "
        "5's")


# ------------------------------------------------------------- 5k and 5l

def _import_torch_seconds():
    r = subprocess.run(
        [sys.executable, "-c", "import time; t0 = time.perf_counter(); "
         "import torch; print(time.perf_counter() - t0)"],
        capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError("import torch failed:\n%s" % r.stderr[-3000:])
    return float(r.stdout.split()[-1])


def _compute_apps():
    """The card's compute processes as nvidia-smi lists them (pid, used
    memory): the pids are those of nvidia-smi's pid namespace."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise AssertionError("nvidia-smi --query-compute-apps failed: %s"
                             % r.stderr.strip())
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


# an import of the torch package in `python -X importtime` output
_TORCH_IMPORT = re.compile(r"\|\s+torch(\.|\s*$)")


def _daemon_client(workdir, env, in_fq, tag, flags):
    """One `python -X importtime -m fastplong_tpu_torch.main` client with
    FASTPLONG_DAEMON=1; returns (wall, output paths, the job's timer dump,
    the job's stderr lines).  Fails if the client ran the job itself or
    imported torch."""
    outs = [os.path.join(workdir, tag + s)
            for s in (".fq", ".failed.fq", ".json", ".html")]
    dump = os.path.join(workdir, "timer_%s.json" % tag)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "fastplong_tpu_torch.main",
         "-i", in_fq, "-o", outs[0], "--failed_out", outs[1], "-j", outs[2],
         "-h", outs[3]] + flags, cwd=workdir, capture_output=True,
        text=True, timeout=900, env=dict(env, FASTPLONG_TIMER_DUMP=dump))
    wall = time.perf_counter() - t0
    lines = r.stderr.splitlines()
    imports = [ln for ln in lines if ln.startswith("import time:")]
    job_err = [ln for ln in lines if not ln.startswith("import time:")]
    if r.returncode != 0:
        raise AssertionError("daemon client %s exited %d:\n%s"
                             % (tag, r.returncode, "\n".join(job_err)[-3000:]))
    if any("daemon unavailable" in ln for ln in job_err):
        raise AssertionError("client %s ran its job in process:\n%s"
                             % (tag, "\n".join(job_err)[-3000:]))
    torch_lines = [ln for ln in imports if _TORCH_IMPORT.search(ln)]
    if torch_lines or not imports:
        raise AssertionError("client %s imported torch (%s) or printed no "
                             "import times" % (tag, torch_lines[:3]))
    with open(dump) as f:
        timing = json.load(f)
    return wall, outs, timing, job_err


def _daemon_jobs(ddir):
    """The job lines of the daemon's log."""
    with open(os.path.join(ddir, "torch_daemon.log")) as f:
        return [json.loads(ln) for ln in f if ln.startswith('{"job"')]


def _check_job_launches(timing, path, phase):
    """The launches a daemon job made, from its timer dump (the counters
    as they stood after the job, less as they stood before it), against
    its step calls."""
    launches = {n: timing["launches"][n] for n in path_kernels(path)}
    log("phase %s:   the job's step calls %d, kernel launches %s"
        % (phase, timing["step_calls"], json.dumps(launches)))
    check_launches(launches, timing["step_calls"], path)


def phase_daemon(workdir, card, outs5, fresh_wall):
    """5k, the warm daemon (FASTPLONG_DAEMON=1) on cuda, each client a
    subprocess of `python -X importtime -m fastplong_tpu_torch.main` with
    its socket directory in the workdir.  First `import torch` twice in
    fresh processes.  Then a cold client over phase 5's 300-read input
    (it spawns the daemon), a warm one over the same input timed by its
    parts (the client's own share; the job as the daemon timed it) with
    outputs equal to the cold one's and to phase 5's in-process run of
    that input, a warm headline client over the 64-Mbase input (outputs
    equal to phase 5's, launches per step as there), and a config-4 client
    ("Detected:" lines equal to phase 5d's).  No client may import torch or
    run its job itself; the daemon must hold a CUDA context and be gone
    after shutdown_daemon()."""
    here = os.path.dirname(os.path.abspath(__file__))
    ddir = os.path.join(workdir, "daemon")
    os.makedirs(ddir)
    env = dict(os.environ, PYTHONPATH=here, FASTPLONG_TORCH_DEVICE="cuda",
               FASTPLONG_DAEMON="1", FASTPLONG_DAEMON_DIR=ddir)
    imports = [_import_torch_seconds() for _ in range(2)]
    log("phase 5k: import torch in a fresh process, twice in a row: %.3f s, "
        "%.3f s; %s" % (imports[0], imports[1], card))
    apps0 = _compute_apps()
    small = os.path.join(workdir, "small.fq")
    old = os.environ.get("FASTPLONG_DAEMON_DIR")
    os.environ["FASTPLONG_DAEMON_DIR"] = ddir
    from fastplong_tpu_torch import daemon
    pid = None
    try:
        cold, outs_cold, _, _ = _daemon_client(workdir, env, small,
                                               "d_cold", HEADLINE)
        conn, hello = daemon._connect()
        conn.close()
        pid = hello["pid"]
        warm, outs_warm, timing, _ = _daemon_client(workdir, env, small,
                                                    "d_warm", HEADLINE)
        job = _daemon_jobs(ddir)[-1]["seconds"]
        require_same_outputs(outs_warm, outs_cold, "5k",
                             "the warm job against the cold one")
        require_same_outputs(outs_warm, [os.path.join(workdir, "warm" + s)
                                         for s in (".fq", ".failed.fq",
                                                   ".json", ".html")],
                             "5k", "the daemon against phase 5's in-process "
                             "run of the 300 reads")
        log("phase 5k: 300 reads, headline flags: cold client (spawns the "
            "daemon) %.3f s; warm client %.3f s = the client's own %.3f s + "
            "the job in the daemon %.3f s (a fresh process in 5h: %.2f s); "
            "%s" % (cold, warm, warm - job, job, fresh_wall, card))
        log("phase 5k:   the warm job's seconds %s" % json.dumps(timing))

        in_fq, nbases = headline_input(workdir)
        wall, outs, timing, _ = _daemon_client(workdir, env, in_fq,
                                               "d_headline", HEADLINE)
        job = _daemon_jobs(ddir)[-1]["seconds"]
        require_same_outputs(outs, outs5, "5k", "the daemon's headline job "
                             "against phase 5's run")
        log("phase 5k: headline over %d bases through the warm daemon: "
            "client %.3f s (%.2f Mbases/s) = the client's own %.3f s + the "
            "job %.3f s; outputs identical to phase 5's; %s"
            % (nbases, wall, nbases / wall / 1e6, wall - job, job, card))
        _check_job_launches(timing, "headline", "5k")

        wall, outs, timing, err = _daemon_client(workdir, env, in_fq,
                                                 "d_c4", CONFIG4)
        got = [ln for ln in err if ln.startswith(
            ("Detected:", "Not detected", "Found possible"))]
        want = _detection_lines(workdir, "c4_cuda")
        if got != want:
            raise AssertionError("phase 5k: the daemon's detection %s, phase "
                                 "5d's %s" % (got, want))
        require_same_outputs(outs, [os.path.join(workdir, "c4_cuda" + s)
                                    for s in (".fq", ".failed.fq", ".json",
                                              ".html")],
                             "5k", "the daemon's config-4 job against 5d's")
        log("phase 5k: config 4 through the daemon: client %.3f s; %s; "
            "outputs identical to phase 5d's" % (wall, " | ".join(got)))
        _check_job_launches(timing, "autodetect", "5k")

        # the daemon's CUDA context.  nvidia-smi may list processes under
        # another pid namespace than this one's, so the daemon's pid is
        # looked for there and, failing that, its process must have the
        # CUDA driver mapped and the card one more compute process
        apps = _compute_apps()
        with open("/proc/%d/maps" % pid) as f:
            has_driver = "libcuda.so" in f.read()
        pids = [a.split(",")[0].strip() for a in apps]
        if not (str(pid) in pids
                or (has_driver and len(apps) == len(apps0) + 1)):
            raise AssertionError(
                "phase 5k: no CUDA context of the daemon (pid %d, libcuda "
                "mapped: %s): compute apps %s before it, %s with it"
                % (pid, has_driver, apps0, apps))
        log("phase 5k: the daemon (pid %d) holds a CUDA context: libcuda "
            "mapped %s; compute apps before it %s, with it %s"
            % (pid, has_driver, apps0, apps))
        if not daemon.shutdown_daemon():
            raise AssertionError("phase 5k: the daemon did not acknowledge "
                                 "its shutdown")
        deadline = time.time() + 60
        while time.time() < deadline and os.path.exists("/proc/%d" % pid):
            time.sleep(0.2)
        if os.path.exists("/proc/%d" % pid):
            raise AssertionError("phase 5k: the daemon (pid %d) outlived its "
                                 "shutdown" % pid)
        pid = None
        jobs = _daemon_jobs(ddir)
        if [j["rc"] for j in jobs] != [0] * 4:
            raise AssertionError("phase 5k: the daemon's jobs %s" % jobs)
        log("phase 5k: 4 jobs, all rc 0; the daemon exited on shutdown; "
            "compute apps now %s" % _compute_apps())
    finally:
        if pid is not None and os.path.exists("/proc/%d" % pid):
            daemon.shutdown_daemon()
            time.sleep(2)
            if os.path.exists("/proc/%d" % pid):
                os.kill(pid, 9)
        if old is None:
            os.environ.pop("FASTPLONG_DAEMON_DIR", None)
        else:
            os.environ["FASTPLONG_DAEMON_DIR"] = old


_EDBENCH_LINE = re.compile(r"^test (\d+) edit_distance calls, takes (\d+) ms "
                           r"\((\d+\.\d) M calls/s\)$")


def phase_edbench(workdir, card):
    """5l: `python -m fastplong_tpu_torch.edbench` on cuda: rc 0, three
    timing lines and the pass line, its M calls/s beside the card."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, FASTPLONG_TORCH_DEVICE="cuda")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "fastplong_tpu_torch.edbench"],
                       cwd=workdir, env=env, capture_output=True, text=True,
                       timeout=300)
    wall = time.perf_counter() - t0
    lines = r.stdout.splitlines()
    timed = [_EDBENCH_LINE.match(ln) for ln in lines[:-1]]
    if (r.returncode != 0 or len(lines) != 4 or not all(timed)
            or lines[-1] != "all edit_distance vectors passed"):
        raise AssertionError("edbench: rc %d\n%s\n%s" % (
            r.returncode, r.stdout[-2000:], r.stderr[-2000:]))
    for ln in lines:
        log("phase 5l: " + ln)
    log("phase 5l: edbench %s M calls/s for distances 0, 1, 90 (process "
        "%.1f s); %s" % (" / ".join(m.group(3) for m in timed), wall, card))


def main():
    try:
        import torch
    except ImportError:
        sys.stderr.write("chip_smoke: torch is not installed\n")
        return 2
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)\n")
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "fastplong_tpu_torch", "csrc")):
        sys.stderr.write("chip_smoke: run from a checkout of the repository "
                         "(fastplong_tpu_torch/ not found beside it)\n")
        return 2
    sys.path.insert(0, here)
    torch.backends.cudnn.allow_tf32 = False
    walls_only = sys.argv[1:] == ["--walls"]
    if sys.argv[1:] and not walls_only:
        sys.stderr.write("usage: chip_smoke.py [--walls]\n")
        return 2
    workdir = tempfile.mkdtemp(prefix="fastplong_chip_smoke_")
    try:
        card = phase_device()
        phase_build()
        if walls_only:
            launches, kind, _ = phase_cli(workdir, walls_only=True)
            print(json.dumps({"walls_of": here, "launches": launches}))
            return 0
        rec = phase_kernels(headline_input(workdir)[0])
        phase_step()
        phase_step(HEADLINE + ["-b", "-N"])
        phase_step(HEADLINE + ["-N"])
        launches, kind, outs5 = phase_cli(workdir)
        bm, lowq_fq, lowq_bases = phase_break_mask(workdir)
        launches["regions"] = bm["regions"]
        phase_mask(workdir, lowq_fq, lowq_bases)
        launches["kmer_hist"] = phase_autodetect(workdir)["kmer_hist"]
        phase_config5(workdir, card)
        launches["myers_blockscan"] = phase_long_adapter(
            workdir)["myers_blockscan"]
        done = {}
        for phase, fn, args in (
                ("5g", phase_profile_flag, lambda: (outs5,)),
                ("5h", phase_prewarm, tuple),
                ("5i", phase_parallel, tuple),
                ("5j", phase_num_hosts, lambda: (outs5,)),
                ("5k", phase_daemon, lambda: (card, outs5, done["5h"])),
                ("5l", phase_edbench, lambda: (card,))):
            t0 = time.perf_counter()
            done[phase] = fn(workdir, *args())
            log("phase %s: done in %.1f s" % (phase, time.perf_counter()
                                               - t0))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    from fastplong_tpu_torch.ops.cuda_lib import CSRC
    src = os.path.relpath(CSRC, here)
    replaces = {
        "mismatch_scan": "fastplong_tpu/ops/pallas_kernels.py:56",
        "myers_verify": "fastplong_tpu/ops/myers.py:149",
        "seed_scan": "fastplong_tpu/ops/adapter.py:195",
        "stat_batch": "fastplong_tpu/ops/stats_kernels.py:23",
        "regions": "fastplong_tpu/ops/regions.py:36",
        "kmer_hist": "fastplong_tpu/ops/kmer.py:41",
        "myers_blockscan": "fastplong_tpu/ops/myers.py:233"}
    # launches: each kernel's count on its own path, set to 0 just before
    # that run and read just after it (the headline for the first four,
    # the break-and-mask run for the region scan, config 4 for the k-mer
    # fill, the 700 bp adapter's run for the block-scan)
    kernels = []
    for name in replaces:
        r = rec[name]
        kernels.append(dict(
            name=name, route="cuda", source="%s/%s.cu" % (src, name),
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
