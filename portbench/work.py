"""The H100's peaks and each hand kernel's bytes and operations.

Frozen copy of `chip_smoke.py`'s bound model at commit
7974d2b1f918e43a25c7e77d01c807558f8ff8d2: `bound` and the H100 SXM peaks
(chip_smoke.py:136-156), `_stat_work` (:922), `_region_work` (:740),
`_myers_work` (:994), the mismatch scan's counts (:299), the seed scan's
(:410) and the k-mer fill's (:476).  Each function reckons the work from the
problem's shapes and the spans it is given (what the inputs need, not the
most a kernel could touch), so the same work is counted whatever kernel does
it.  Here they take one launch's own arguments, as the harness records them
from `fastplong_tpu_torch.ops.cuda_lib.launch`: the C entry point's name and
its arguments, each device pointer replaced by the tensor it came from.
"""

MEM_BYTES_PER_S = 3.35e12     # HBM3
INT8_OPS_PER_S = 1979e12      # dense int8
WORD32_OPS_PER_S = 67e12      # 32-bit words outside the tensor cores

# entry point -> the CUDA symbol of its kernel (csrc/*.cu)
KERNELS = {
    "fpl_mismatch_scan": "mismatch_bits_kernel",
    "fpl_myers_verify": "myers_verify_kernel",
    "fpl_myers_verify_pair": "myers_verify_kernel",
    "fpl_seed_scan": "seed_scan_kernel",
    "fpl_stat_batch_into": "stat_batch_kernel",
    "fpl_regions": "regions_kernel",
    "fpl_kmer_hist": "kmer_hist_kernel",
    "fpl_myers_blockscan": "myers_blockscan_kernel",
}


# entry point -> the arguments whose contents launch_work reads (per-row
# spans and lengths, the k-mer fill's window matrix); of every other tensor
# argument it reads the shape, element count and element size alone
CONTENT_ARGS = {
    "fpl_myers_verify": (3, 4),
    "fpl_myers_blockscan": (3, 4),
    "fpl_myers_verify_pair": (3, 4, 11, 12),
    "fpl_stat_batch_into": (5, 6, 7),
    "fpl_regions": (3, 4),
    "fpl_kmer_hist": (0, 3),
}


def bound(nbytes, ops, ops_per_s):
    """Least seconds the card can take: the larger of the bytes at the
    memory's peak and the operations at their type's peak."""
    return max(nbytes / MEM_BYTES_PER_S, ops / ops_per_s)


def _myers_work(pm, plen, text, tlen):
    import torch
    N, T = text.shape
    K = pm.shape[1]
    p = torch.clamp(plen.to(torch.int64), min=0)
    words = torch.clamp((p - 1) // 32, 0, K - 1) + 1
    cols = torch.clamp(tlen.to(torch.int64), 0, T)
    ops = int(torch.where(p > 0, cols * (20 * words + 5), 0).sum().item())
    return N * T + 12 * N + pm.numel() * 4, ops


def _stat_work(L, lo, hi, mask, zero_lo):
    import torch
    lo = lo.to(torch.int64)
    hi = torch.maximum(hi.to(torch.int64), lo)
    n = hi if zero_lo else hi - lo
    n = torch.where(mask, torch.clamp(n, 0, L), 0)
    cycles = int(n.sum().item())
    rows = lo.numel()
    return (2 * cycles + 9 * rows + 16 * (18 * L + 1168) + rows,
            10 * cycles)


def _region_work(L, lo, hi, w):
    import torch
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    n = torch.clamp(hi, 0, L) - torch.clamp(lo, 0, L) + 1
    n = torch.where((hi - lo >= w) & (n > 0), n, 0)
    pos = int(n.sum().item())
    return 4 * pos + 20 * lo.numel(), 8 * pos


def _kmer_windows(mat, npos, keylen=10):
    """(valid windows, distinct keys) of a k-mer fill: the windows of each
    row's first npos positions whose bases are all A, C, G, T or U."""
    import torch
    code = torch.full((256,), -1, dtype=torch.int64, device=mat.device)
    for c, v in ((b"A", 0), (b"T", 1), (b"U", 1), (b"C", 2), (b"G", 3)):
        code[c[0]] = v
    c = code[mat.long()]
    n, wfull = mat.shape
    P = wfull - keylen + 1
    key = torch.zeros((n, P), dtype=torch.int64, device=mat.device)
    ok = torch.ones((n, P), dtype=torch.bool, device=mat.device)
    for i in range(keylen):
        ci = c[:, i:i + P]
        key = key * 4 + torch.clamp(ci, min=0)
        ok &= ci >= 0
    ok &= torch.arange(P, device=mat.device)[None, :] < npos.long()[:, None]
    keys = key[ok]
    return int(keys.numel()), int(torch.unique(keys).numel())


def launch_work(entry, args):
    """(bytes, operations, operations per second at peak) of one launch,
    from its arguments (tensors where the launch passed device pointers)."""
    if entry == "fpl_mismatch_scan":
        bases, B, L, adapter, alen, out = args[:6]
        return (B * L + B * L * out.element_size() + alen,
                2 * B * L * alen, INT8_OPS_PER_S)
    if entry in ("fpl_myers_verify", "fpl_myers_blockscan"):
        text, N, T, plen, tlen, pm = args[:6]
        return _myers_work(pm, plen, text, tlen) + (WORD32_OPS_PER_S,)
    if entry == "fpl_myers_verify_pair":
        b0, o0 = _myers_work(args[5], args[3], args[0], args[4])
        b1, o1 = _myers_work(args[13], args[11], args[8], args[12])
        return b0 + b1, o0 + o1, WORD32_OPS_PER_S
    if entry == "fpl_seed_scan":
        bases, B, L, base_abs, ncand, tbl, plen, start, P = args[:9]
        return (B * (P + plen) + 8 * B + 4 * B * P + 1024,
                B * P * plen * 20, WORD32_OPS_PER_S)
    if entry == "fpl_stat_batch_into":
        bases, quals, S, B, L, lo, hi, mask, zero_lo = args[:9]
        return _stat_work(L, lo, hi, mask, bool(zero_lo)) + (WORD32_OPS_PER_S,)
    if entry == "fpl_regions":
        cq, B, L, lo, hi, n, w = args[:7]
        return _region_work(L, lo, hi, w) + (WORD32_OPS_PER_S,)
    if entry == "fpl_kmer_hist":
        mat, n, wfull, npos = args[:4]
        windows, distinct = _kmer_windows(mat, npos)
        return (mat.numel() + 12 * n + 32 * distinct, 20 * windows,
                WORD32_OPS_PER_S)
    raise KeyError("no work function for %s" % entry)


def launch_bound_s(entry, args):
    return bound(*launch_work(entry, args))
