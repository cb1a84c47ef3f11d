"""Adapter mismatch scan (kernel 1, csrc/mismatch_scan.cu).

mm[b, p] = #(bases[b, p+i] != adapter[i], i < alen) at every raw position
p in [0, L); windows running past L compare against zero padding (callers
mask by range).  uint8 output when alen <= 255, int32 above — the contract
of fastplong_tpu/ops/adapter.py:_mismatch_full, which stands in for the
Pallas kernel fastplong_tpu/ops/pallas_kernels.py:_mismatch_pallas.
"""

import torch

from . import cuda_lib

_MAX_ALEN = 2 ** 15 - 1   # the deepest counter the kernel has, 15 levels
_MAX_INT = 2 ** 31 - 1    # B and every position the kernel indexes are ints
_MAX_TILE = 32 * 256      # positions in one block's tile


def out_dtype(alen):
    return torch.uint8 if alen <= 255 else torch.int32


def mismatch_scan_plain(bases, adapter):
    """Plain PyTorch version: alen shifted compares.  adapter is a uint8
    tensor on bases' device."""
    B, L = bases.shape
    alen = adapter.shape[0]
    dt = out_dtype(alen)
    padded = torch.nn.functional.pad(bases, (0, alen))
    mm = torch.zeros((B, L), dtype=dt, device=bases.device)
    for i in range(alen):
        mm += (padded[:, i:i + L] != adapter[i]).to(dt)
    return mm


def shape_ok(B, L, alen):
    """Whether the kernel takes [B, L] bases and an alen-byte adapter:
    alen from 1 to 32,767, and B and each position up to the end of the
    last tile's halo (L + one tile + alen + 32) within a C int."""
    return (0 < alen <= _MAX_ALEN and B <= _MAX_INT
            and L + _MAX_TILE + alen + 32 <= _MAX_INT)


def mismatch_scan(bases, adapter):
    """[B, L] uint8 bases x [alen] uint8 adapter -> [B, L] mismatch counts.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if bases.device.type == "cpu":
        return mismatch_scan_plain(bases, adapter)
    cuda_lib.require_cuda("mismatch_scan", bases, adapter)
    if bases.dtype != torch.uint8 or adapter.dtype != torch.uint8:
        raise ValueError("mismatch_scan takes uint8 bases and adapter")
    B, L = bases.shape
    alen = adapter.shape[0]
    if not shape_ok(B, L, alen):
        raise ValueError("mismatch_scan: unsupported shape B=%d L=%d "
                         "alen=%d" % (B, L, alen))
    dt = out_dtype(alen)
    out = torch.empty((B, L), dtype=dt, device=bases.device)
    if B == 0 or L == 0:
        return out
    cuda_lib.launch(
        "fpl_mismatch_scan", bases, cuda_lib.ptr(bases), B, L,
        cuda_lib.ptr(adapter), alen, cuda_lib.ptr(out),
        int(dt == torch.uint8))
    mismatch_scan.launches += 1
    return out


mismatch_scan.launches = 0
