#!/usr/bin/env python3
"""Time the parts of the port's statistics and region kernels on the card,
for this tree's sources and for those of an older revision, in one run.

    python3 tools/torch_kernel_roles.py prepare REV DIR   # in a git checkout
    python3 tools/torch_kernel_roles.py run DIR           # on a card

`prepare` writes into DIR (a directory that .gitignore lists, such as
_archive/roles) the statistics and region kernels of revision REV (the
int32-partial statistics kernel, fpl_stat_batch, with its one warp per
region span) and of this tree, each statistics source patched with a
launch mode (1: row blocks only, 2: column blocks only, 3: both) and with
-D switches that leave out parts of its work:

    NO_CNT, NO_KMER   the row blocks' quality-count and 5-mer atomics
    NO_Q2030          REV's per-cycle Q20/Q30 atomics
    NO_COLMATH        this tree's column-block arithmetic (the bytes are
                      still loaded)
    MINB, CNTC        this tree's blocks per SM in the launch bounds, and
                      copies of the row blocks' quality count

`run` builds every variant with nvcc (all at once), then prints the median
time per call of 20 calls replayed from a CUDA graph at [1024, 8192] (the
headline batch), in the step's three forms (S = 1 pre-filter, S = 2 and
S = 4 post-filter); REV's kernel once per slot, alone and with the step's
zero-fill and add into the accumulator that this tree's kernel does
itself; with the inputs warm in L2 and after a 256 MB write that evicts
them; and the region kernels of both trees in the break and mask forms,
warm and evicted.  Every variant that does all its work is checked against
this tree's plain version first.  It prints the card's name and power
limit first.
"""

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CSRC = os.path.join(ROOT, "fastplong_tpu_torch", "csrc")


def _sub(text, old, new):
    if old not in text:
        raise SystemExit("patch does not apply: %r" % old[:60])
    return text.replace(old, new)


def _patch_old(s):
    """REV's stat_batch.cu with a launch mode and NO_CNT / NO_KMER /
    NO_Q2030."""
    s = _sub(s, """        atomicAdd(&s_cnt[q], 1);
        atomicAdd(&s_hist[min(q, 127u)], 1);
        if (ok && i >= 4) atomicAdd(&s_kmer[key], 1);""", """#ifndef NO_CNT
        atomicAdd(&s_cnt[q], 1);
        atomicAdd(&s_hist[min(q, 127u)], 1);
#else
        if (q == 300) s_cnt[0] = 1;
#endif
#ifndef NO_KMER
        if (ok && i >= 4) atomicAdd(&s_kmer[key], 1);
#else
        if (ok && i >= 4 && key == 5000) s_kmer[0] = 1;
#endif""")
    s = _sub(s, """    if (a20) atomicAdd(&o.q20[at], a20);
    if (a30) atomicAdd(&o.q30[at], a30);""", """#ifndef NO_Q2030
    if (a20) atomicAdd(&o.q20[at], a20);
    if (a30) atomicAdd(&o.q30[at], a30);
#else
    tq += a20 + a30;
#endif""")
    s = _sub(s, 'extern "C" int fpl_stat_batch(',
             'extern "C" int fpl_stat_batch_m(int mode, ')
    s = _sub(s, """  const int64_t blocks = static_cast<int64_t>(nrow) +
                         static_cast<int64_t>(ncolb) * nchunks;""",
             """  const int64_t blocks = (mode & 1 ? nrow : 0) +
      (mode & 2 ? static_cast<int64_t>(ncolb) * nchunks : 0);""")
    return _sub(s, "static_cast<const uint8_t*>(read_mask), zero_lo, nrow,",
                "static_cast<const uint8_t*>(read_mask), zero_lo,\n"
                "      mode == 2 ? 0 : nrow,")


def _patch_new(s):
    """This tree's stat_batch.cu with a launch mode and NO_CNT / NO_KMER /
    NO_COLMATH / MINB / CNTC."""
    s = _sub(s, "#include <cstdint>\n", """#include <cstdint>
#ifndef MINB
#define MINB 6
#endif
#ifndef CNTC
#define CNTC 1
#endif
""")
    s = _sub(s, "constexpr int kMinBlocks = 6;",
             "constexpr int kMinBlocks = MINB;")
    s = _sub(s, "constexpr uint32_t kBadCode = 4;",
             "constexpr uint32_t kBadCode = 4;\n"
             "constexpr int kCntStride = CNTC > 1 ? 257 : 256;")
    s = _sub(s, """      atomicAdd(&cnt[q], 1);
      if (run >= 5 && j >= 4) atomicAdd(&kmer[key], 1);""", """#ifndef NO_CNT
      atomicAdd(&cnt[(threadIdx.x & 31) % CNTC * kCntStride + q], 1);
#else
      if (q == 999) cnt[0] = 1;
#endif
#ifndef NO_KMER
      if (run >= 5 && j >= 4) atomicAdd(&kmer[key], 1);
#else
      if (run >= 5 && j >= 4 && key == 5000) kmer[0] = 1;
#endif""")
    s = _sub(s, """    c[k] = cnt[bin];
    cnt[bin] = 0;""", """    c[k] = 0;
    for (int cc = 0; cc < CNTC; ++cc) {
      c[k] += cnt[cc * kCntStride + bin];
      cnt[cc * kCntStride + bin] = 0;
    }""")
    s = _sub(s, "  int cnt[2][256];", "  int cnt[2][CNTC * kCntStride];")
    s = _sub(s, "for (int i = tid; i < 2 * 256; i += kThreads) "
             "sh.cnt[i >> 8][i & 255] = 0;",
             "for (int i = tid; i < 2 * CNTC * kCntStride; i += kThreads)\n"
             "    (&sh.cnt[0][0])[i] = 0;")
    s = _sub(s, """      if (x[u] == kNone) continue;
""", """      if (x[u] == kNone) continue;
#ifdef NO_COLMATH
      cnt += x[u] + q[u];
      continue;
#endif
""")
    s = _sub(s, 'extern "C" int fpl_stat_batch_into(',
             'extern "C" int fpl_stat_batch_into_m(int mode, ')
    return _sub(s, """  const int64_t blocks = static_cast<int64_t>(a.nrow) +
                         static_cast<int64_t>(a.ncolb) * nchunks;""",
                """  const int64_t blocks = (mode & 1 ? a.nrow : 0) +
      (mode & 2 ? static_cast<int64_t>(a.ncolb) * nchunks : 0);
  if (!(mode & 1)) a.nrow = 0;""")


def prepare(rev, out):
    os.makedirs(out, exist_ok=True)

    def show(path):
        return subprocess.run(["git", "show", "%s:%s" % (rev, path)],
                              cwd=ROOT, check=True, capture_output=True,
                              text=True).stdout
    src = "fastplong_tpu_torch/csrc/"
    files = {
        "stat_old.cu": _patch_old(show(src + "stat_batch.cu")),
        "regions_old.cu": show(src + "regions.cu"),
        "stat_new.cu": _patch_new(open(os.path.join(CSRC, "stat_batch.cu"))
                                  .read()),
        "regions_new.cu": open(os.path.join(CSRC, "regions.cu")).read(),
    }
    for name, text in files.items():
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    with open(os.path.join(out, "REV"), "w") as f:
        f.write(rev + "\n")
    print("wrote %s into %s" % (sorted(files), out))


OLD = {"base": [], "no_kmer": ["-DNO_KMER"], "no_cnt": ["-DNO_CNT"],
       "no_cnt_kmer": ["-DNO_CNT", "-DNO_KMER"], "no_q2030": ["-DNO_Q2030"]}
NEW = {"base": [], "minb4": ["-DMINB=4"], "cntc4": ["-DCNTC=4"],
       "no_cnt_kmer": ["-DNO_CNT", "-DNO_KMER"],
       "no_colmath": ["-DNO_COLMATH"]}
ROLES = {"base", "no_cnt_kmer", "no_colmath"}


def _build(d):
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared"]
    jobs = [("stat_old", v, "stat_old.cu", f) for v, f in OLD.items()]
    jobs += [("stat_new", v, "stat_new.cu", f) for v, f in NEW.items()]
    jobs += [("regions_old", "base", "regions_old.cu", []),
             ("regions_new", "base", "regions_new.cu", [])]
    procs = []
    for kind, v, src, f in jobs:
        so = os.path.join(d, "%s_%s.so" % (kind, v))
        procs.append((kind, v, so, subprocess.Popen(
            [nvcc] + flags + f + [os.path.join(d, src), "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    outs = [(k, v, so, p.communicate()[0].decode()) for k, v, so, p in procs]
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for (kind, v, so, text), (_, _, _, p) in zip(outs, procs):
        if p.returncode != 0:
            raise SystemExit("nvcc failed on %s %s:\n%s" % (kind, v, text))
        lib = ctypes.CDLL(so)
        if kind == "stat_old":
            lib.fpl_stat_batch_m.argtypes = [I, P, P, I, I, P, P, P, I, P, P,
                                             P, P]
        elif kind == "stat_new":
            lib.fpl_stat_batch_into_m.argtypes = [I, P, P, I, I, I, P, P, P,
                                                  I, P, I, P, P]
        else:
            lib.fpl_regions.argtypes = [P, I, I, P, P, I, I, I, P, P]
        libs[kind, v] = lib
    return libs


def run(d):
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from fastplong_tpu_torch.ops.primitives import qual_cumsum
    from fastplong_tpu_torch.ops.regions import detect_regions_summary_plain
    from fastplong_tpu_torch.ops.stats_kernels import (flat_side_len,
                                                       stat_batch_into_plain)
    from fastplong_tpu_torch.pipeline.device import break_slots
    cs.phase_device()
    with open(os.path.join(d, "REV")) as f:
        rev = f.read().strip()
    print("older revision: %s" % rev, flush=True)
    libs = _build(d)
    dev = torch.device("cuda")

    def P(t):
        return ctypes.c_void_p(t.data_ptr())

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    write_ms = cs.graph_ms(lambda: flush.fill_(1), inner=5)

    def cold(fn):
        return cs.graph_ms(lambda: (flush.fill_(1), fn()), inner=5) - write_ms

    res = {}

    def say(key, ms, note=""):
        res[key] = ms
        print("%-58s %.5f ms %s" % (key, ms, note), flush=True)

    rng = np.random.default_rng(cs.SEED)
    B, L = 1024, 8192
    bases = torch.from_numpy(cs._rand_bases(rng, (B, L))).to(dev)
    side = torch.zeros(flat_side_len(L), dtype=torch.int64, device=dev)
    flat = torch.zeros(34 * L + 1152, dtype=torch.int32, device=dev)
    med = torch.empty(B, dtype=torch.uint8, device=dev)
    rlen = torch.empty(B, dtype=torch.int32, device=dev)

    def old_add(flat):
        cyc = side[:18 * L].view(L, 18)
        cyc[:, 0:8] += flat[16 * L:24 * L].view(8, L).T
        cyc[:, 8:16] += flat[24 * L:32 * L].view(8, L).T
        cyc[:, 16] += flat[32 * L:33 * L]
        cyc[:, 17] += flat[33 * L:34 * L]
        o = 18 * L
        side[o:o + 8] += flat[:8 * L].view(8, L).sum(dim=1)
        side[o + 8:o + 16] += flat[8 * L:16 * L].view(8, L).sum(dim=1)
        side[o + 16:o + 1168] += flat[34 * L:]

    for S, zl, form in ((1, True, "S=1 pre"), (2, False, "S=2 post"),
                        (4, False, "S=4 post")):
        _, q, lo, hi, m = cs._stat_slots(rng, B, L, S, edge=False)
        if zl:
            lo[:] = 0
        quals = torch.from_numpy(q).to(dev)
        lo, hi, m = (torch.from_numpy(a).to(dev).contiguous()
                     for a in (lo, hi.astype(np.int32), m))
        lo = lo.to(torch.int32)
        ref = torch.zeros_like(side)
        ref_med = stat_batch_into_plain(ref, bases, quals, lo, hi, m,
                                        zero_lo=zl)

        def old_call(lib, mode, k, add=False):
            if add:
                flat.zero_()
            lib.fpl_stat_batch_m(mode, P(bases), P(quals), B, L, P(lo[k]),
                                 P(hi[k]), P(m[k]), int(zl), P(flat), P(med),
                                 P(rlen), stream())
            if add:
                old_add(flat)

        for v in OLD:
            lib = libs["stat_old", v]
            for mode, mn in ((3, "both"), (1, "row"), (2, "col")):
                if (v == "no_q2030" and mode == 1) or (
                        v in ("no_kmer", "no_cnt", "no_cnt_kmer")
                        and mode == 2):
                    continue
                say("stat %s %s old %s %s (slot 0)" % (form, rev, v, mn),
                    cs.graph_ms(lambda: old_call(lib, mode, 0)))
        lib = libs["stat_old", "base"]
        say("stat %s %s old x%d slots" % (form, rev, S),
            cs.graph_ms(lambda: [old_call(lib, 3, k) for k in range(S)]))
        say("stat %s %s old x%d slots + zero-fill and add" % (form, rev, S),
            cs.graph_ms(lambda: [old_call(lib, 3, k, True)
                                 for k in range(S)]))
        say("stat %s %s old x%d slots, L2 evicted" % (form, rev, S),
            cold(lambda: [old_call(lib, 3, k) for k in range(S)]))
        mm = torch.empty((S, B), dtype=torch.uint8, device=dev)

        def new_call(lib, mode, out):
            lib.fpl_stat_batch_into_m(mode, P(bases), P(quals), S, B, L,
                                      P(lo), P(hi), P(m), int(zl), P(out), L,
                                      P(mm), stream())

        for v in NEW:
            lib = libs["stat_new", v]
            if v in ("base", "minb4", "cntc4"):
                got = torch.zeros_like(side)
                new_call(lib, 3, got)
                torch.cuda.synchronize()
                if not (torch.equal(got, ref) and torch.equal(mm, ref_med)):
                    raise SystemExit("stat_new %s differs from the plain "
                                     "version" % v)
            for mode, mn in ((3, "both"), (1, "row"), (2, "col")):
                if mode != 3 and v not in ROLES:
                    continue
                say("stat %s new %s %s" % (form, v, mn),
                    cs.graph_ms(lambda: new_call(lib, mode, side)),
                    "exact" if v in ("base", "minb4", "cntc4") and mode == 3
                    else "")
        lib = libs["stat_new", "base"]
        say("stat %s new base both, L2 evicted" % form,
            cold(lambda: new_call(lib, 3, side)))

    lens = rng.integers(L // 2 + 1, L + 1, B).astype(np.int32)
    cq = qual_cumsum(torch.from_numpy(cs._lowq_quals(rng, B, L)).to(dev),
                     torch.from_numpy(lens).to(dev))
    two = cs._region_spans(rng, lens)
    for form, s, w in (("break [2, 1024] w100", two, 100),
                       ("mask [4, 1024] w50", break_slots(two, cq, 100, 10),
                        50)):
        lo = s.lo.contiguous()
        hi = torch.where(s.active, s.hi, s.lo).contiguous()
        ref = detect_regions_summary_plain(cq, lo, hi, w, 43 * w)
        for tree in ("old", "new"):
            lib = libs["regions_" + tree, "base"]
            out = torch.empty((3,) + tuple(lo.shape), dtype=torch.int32,
                              device=dev)

            def fn():
                lib.fpl_regions(P(cq), B, L, P(lo), P(hi), lo.numel(), w,
                                43 * w, P(out), stream())
            fn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise SystemExit("regions %s differs from the plain version"
                                 % tree)
            name = rev if tree == "old" else "new"
            say("regions %s %s warm" % (form, name), cs.graph_ms(fn), "exact")
            say("regions %s %s L2 evicted" % (form, name), cold(fn))
    print(json.dumps(res))


def main():
    a = sys.argv[1:]
    if len(a) == 3 and a[0] == "prepare":
        prepare(a[1], a[2])
    elif len(a) == 2 and a[0] == "run":
        run(a[1])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
