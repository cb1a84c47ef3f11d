"""Edit-distance micro-benchmark of the PyTorch/CUDA port.

Twin of fastplong_tpu/edbench.py, the counterpart of the reference's
built-in self-benchmark (src/editdistance.cpp:141-172): verifies the three
reference test vectors through ops/myers.py:myers_verify (on a card, the
kernel of csrc/myers_verify.cu) and times batched evaluations.  Runs on
CUDA unless FASTPLONG_TORCH_DEVICE=cpu:

    python -m fastplong_tpu_torch.edbench
"""

import sys
import time

import numpy as np

STR1 = [
    "CCTATCAGGGAGCTGTGGGCCAGCCAGGAGGCAGCACATGCCCAATCCCAGGCCCCTCCCGTTGTAAGT"
    "TCCCGTTCTACCCGACAGGGACCTGCTGACAAAAGACAGGGCTGGAGAGCCAGCCTGAAGGCCCTGGGA"
    "CCCTTCTATCCAC",
    "ACTTATGTTTTTAAATGAGGATTATTGATAGTACTCTTGGTTTTTATACCATTCAGATCACTGAATTTA"
    "TAAAGTACCCATCTAGTACTTCAAAAAGTAAAGTGTTCTGCCAGATCTTAGGTATAGAGGACCCTAACA"
    "CAGTAAGATCGGA",
    "TAGGGGTATGAGTAGAGCTGAGCTGGGGGAAAAGAGGGAAATTCCCAGGGGTGGAGGAAGAGTCAAGTC"
    "CCCCTCTACACCTAGAGGATGAACTTAAGGAAGGAGTGAAGGTCATATGTGTTGTTCCTGAGGAAAAGG"
    "CCGCTGTAGAAAA",
]
STR2 = [
    STR1[0],
    "ACTTATGTTTTTAAATGAGGATTATTGATAGTACTCTTGGTTTTTATACCATTCAGATCACTGAATTTA"
    "TAAAGTACCCATCTAGTACTTGAAAAAGTAAAGTGTTCTGCCAGATCTTAGGTATAGAGGACCCTAACA"
    "CAGTAAGATCGGA",
    "CCTGGGCCTGGCCCTTGTCTAAAACTGACTCTTTTGAGGGTGATTTTGGATGTTCTTAGTAGAGTCTCT"
    "CACCTGTACTTTCCTTGCCTAAGGTGCTGTCTTCTCTTGCAGGTTGCCTACACGTTCCTCACATGCCCT"
    "AAGAACCATGGGA",
]
EXPECTED = [0, 1, 90]
LANES = 8192   # lanes per kernel call


def main(n_calls=100000):
    """Check and time the three vectors; 0 if all pass, else 1.  n_calls:
    the calls timed per vector, rounded down to whole launches of LANES
    (at least one)."""
    import torch
    from . import resolve_device
    from .ops.myers import myers_verify, pattern_table
    from .util import error_exit
    try:
        device = resolve_device()
    except (RuntimeError, ValueError) as e:
        error_exit(str(e))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for i in range(3):
        a, b = STR1[i], STR2[i]
        pm = pattern_table(a.encode(), device)
        row = torch.from_numpy(np.frombuffer(b.encode(), np.uint8).copy())
        text = row.expand(LANES, -1).contiguous().to(device)
        plen = torch.full((LANES,), len(a), dtype=torch.int32, device=device)
        tlen = torch.full((LANES,), len(b), dtype=torch.int32, device=device)
        d = myers_verify(pm, plen, text, tlen)   # warm-up: first launch
        sync()
        t0 = time.perf_counter()
        reps = max(1, n_calls // LANES)
        for _ in range(reps):
            d = myers_verify(pm, plen, text, tlen)
        sync()
        dt = time.perf_counter() - t0
        total = reps * LANES
        print("test %d edit_distance calls, takes %d ms (%.1f M calls/s)"
              % (total, int(dt * 1000), total / dt / 1e6))
        ret = int(d[0])
        if ret != EXPECTED[i]:
            print("Fail: (edit_distance), expect %d, but got %d:\n%s\n%s"
                  % (EXPECTED[i], ret, STR1[i], STR2[i]))
            return 1
    print("all edit_distance vectors passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
