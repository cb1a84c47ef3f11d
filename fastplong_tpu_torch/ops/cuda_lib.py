"""Build and load the port's CUDA kernels.

The sources are fastplong_tpu_torch/csrc/*.cu, each with a plain C entry
point.  On first use every source is compiled by its own nvcc process (all
started together) for sm_90a, the objects are linked into one shared
library, and the library is loaded with ctypes.  The build directory is
fastplong_tpu_torch/_kernels/ (listed in .gitignore); the library's name
carries a hash of the sources, so an edited source rebuilds.  A failed
build raises: nothing here falls back to another implementation.

Each C entry point takes device pointers and the CUDA stream as void*,
launches on that stream without synchronising, and returns
cudaGetLastError().  Every wrapper calls its entry point through `launch`,
which makes the device of the wrapper's tensors the host thread's current
device for the call (a <<<...>>> launch goes to the current device, not to
the stream's) and raises on a non-zero code.
"""

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fpl_mismatch_scan": [_P, _I, _I, _P, _I, _P, _I, _P],
    "fpl_myers_verify": [_P, _I, _I, _P, _P, _P, _I, _P, _P],
    "fpl_myers_verify_pair": [_P, _I, _I, _P, _P, _P, _I, _P] * 2 + [_P],
    "fpl_seed_scan": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P],
    "fpl_stat_batch_into": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _P,
                            _P],
    "fpl_regions": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P],
    "fpl_kmer_hist": [_P, _I, _I, _P, _P, _I, _P, _P],
    "fpl_myers_blockscan": [_P, _I, _I, _P, _P, _P, _I, _P, _P],
}

_lib = None    # the loaded library (one per process)


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc():
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc") or ""]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "in %s cannot be built" % CSRC)


def library_path():
    h = hashlib.sha256()
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "libfplcuda-%s.so" % h.hexdigest()[:16])


def build():
    """Compile csrc/*.cu into the hashed shared library unless it exists;
    returns its path.  The compiler's `-Xptxas -v` report is kept beside
    it as <library>.ptxas.txt, with the build's wall time."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(BUILD_DIR, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc] + NVCC_FLAGS + ["-Xptxas", "-v", "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        # wait for every compiler before judging any, so that a failure
        # leaves no nvcc running
        outs = [p.communicate(timeout=900)[0].decode(errors="replace")
                for _, p in procs]
        report = []
        for (src, p), out in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError("nvcc failed on %s:\n%s" % (src, out))
            report.append("== %s\n%s" % (os.path.basename(src), out))
        tmp = so[:-len(".so")] + ".tmp.so"
        r = subprocess.run([nvcc] + NVCC_FLAGS + ["-shared"] + objs
                           + ["-o", tmp], capture_output=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed:\n%s"
                               % r.stderr.decode(errors="replace"))
        os.replace(tmp, so)
        with open(so + ".ptxas.txt", "w") as f:
            f.write("build_seconds %.3f\n" % (time.perf_counter() - t0))
            f.write("\n".join(report))
    return so


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(build())
        for name, args in _SIGNATURES.items():
            fn = getattr(L, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = L
    return _lib


def stream(t):
    """The current CUDA stream of tensor t's device, as a void*."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(entry, t, *args):
    """Call the C entry point `entry` with args and the current stream of
    tensor t's device, t's device being the host thread's current device
    for the call, so that a thread whose current device is another card
    launches on t's card; raises if the entry point returns an error."""
    import torch
    with torch.cuda.device(t.device):
        rc = getattr(lib(), entry)(*args, stream(t))
    if rc != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d"
                           % (entry, rc))


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(name, *tensors):
    """Raise unless every tensor is a contiguous tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("%s: tensors must share one CUDA device, got %s"
                             % (name, [str(x.device) for x in tensors]))
        if not t.is_contiguous():
            raise ValueError("%s: tensors must be contiguous" % name)
