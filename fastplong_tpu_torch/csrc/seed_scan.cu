// Seed scan: ed16[b, p] is the single-word Myers edit distance of the p-th
// of P = 184 seed windows of a read against the adapter's 16-byte seed
// (plen = min(16, alen) steps), or 10**6 for windows p >= ncand[b].
//   start side: window p, step j reads row[base_abs + p + plen - 1 - j]
//               (the text runs reversed against the reversed adapter);
//   end side:   window p, step j reads row[base_abs - p + j].
// Bytes outside [0, L) read as zero.  masks[c] has bit i set iff the seed
// pattern's byte i is c.
//
// Replaces fastplong_tpu/ops/adapter.py:_seed_scan, which runs all P
// windows as [B, P] lanes of a 16-step unrolled recurrence.
//
// Bound on an H100: 16 steps of about 15 integer operations per window, on
// at most P + 16 bytes of each row: bound by integer operations, and in
// practice by the launch (1024 reads are 6,144 warps of 16 steps).
// Design: one block per read, one warp per 32 windows (6 warps cover 184),
// no block barrier.  The 32 windows of a warp span 32 + plen - 1 <= 47
// bytes of the row: each lane loads two of them (coalesced, zero outside
// the row) and looks up their pattern masks in the 256-entry table through
// the read-only cache, both loads issued before the recurrence.  Step j of
// a lane then takes the mask of its window's byte from the lane that holds
// it by two __shfl_sync, so the fully unrolled loop (plen = 16; a generic
// loop for shorter seeds) touches no memory, and the distance is updated
// without a branch.  The table keeps every byte exact (N, IUPAC codes,
// lowercase, and 0 outside the row) at two loads per lane, where a compare
// against the seed bytes would cost 16 compares per step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kFar = 1000000;

template <int kPlen>
__global__ void seed_scan_kernel(const uint8_t* __restrict__ bases, int L,
                                 const int* __restrict__ base_abs,
                                 const int* __restrict__ ncand,
                                 const uint32_t* __restrict__ masks,
                                 int plen_arg, int start_side, int P,
                                 int* __restrict__ out) {
  const int plen = kPlen > 0 ? kPlen : plen_arg;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int p0 = threadIdx.x & ~31;
  const uint8_t* row = bases + static_cast<int64_t>(b) * L;
  const int64_t a = base_abs[b];
  // the warp's bytes: base + 0 .. base + 63, of which offsets 0 .. 31 +
  // plen - 1 are read; offset o of lane l at step j is o0 + dir * j
  const int64_t base = start_side ? a + p0 : a - p0 - 31;
  const int o0 = start_side ? lane + plen - 1 : 31 - lane;
  const int dir = start_side ? -1 : 1;
  const int64_t s0 = base + lane;
  const int64_t s1 = s0 + 32;
  const uint32_t c0 = (s0 >= 0 && s0 < L) ? row[s0] : 0u;
  const uint32_t c1 = (s1 >= 0 && s1 < L) ? row[s1] : 0u;
  const uint32_t m0 = __ldg(masks + c0);
  const uint32_t m1 = __ldg(masks + c1);
  const int ncb = ncand[b];

  const uint32_t full = (1u << plen) - 1u;
  const int top = plen - 1;
  uint32_t VP = full;
  uint32_t VN = 0u;
  int D = plen;
#pragma unroll
  for (int j = 0; j < (kPlen > 0 ? kPlen : plen); ++j) {
    const int o = o0 + dir * j;
    const uint32_t x0 = __shfl_sync(kFull, m0, o & 31);
    const uint32_t x1 = __shfl_sync(kFull, m1, o & 31);
    const uint32_t X = o < 32 ? x0 : x1;
    const uint32_t D0 = (((X & VP) + VP) ^ VP) | X | VN;
    const uint32_t HP = VN | ~(D0 | VP);
    const uint32_t HN = D0 & VP;
    const uint32_t X2 = (HP << 1) | 1u;
    VP = ((HN << 1) | ~(D0 | X2)) & full;
    VN = D0 & X2;
    // HP and HN never share a bit
    D += static_cast<int>((HP >> top) & 1u) - static_cast<int>((HN >> top) & 1u);
  }
  const int p = p0 + lane;
  if (p < P) out[static_cast<int64_t>(b) * P + p] = p < ncb ? D : kFar;
}

}  // namespace

extern "C" int fpl_seed_scan(const void* bases, int B, int L,
                             const void* base_abs, const void* ncand,
                             const void* masks, int plen, int start_side,
                             int P, void* out, void* stream) {
  if (B <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const int threads = (P + 31) / 32 * 32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(bases);
  const auto* ab = static_cast<const int*>(base_abs);
  const auto* nc = static_cast<const int*>(ncand);
  const auto* m = static_cast<const uint32_t*>(masks);
  auto* o = static_cast<int*>(out);
  if (plen == 16) {
    seed_scan_kernel<16><<<B, threads, 0, st>>>(x, L, ab, nc, m, plen,
                                                start_side, P, o);
  } else {
    seed_scan_kernel<0><<<B, threads, 0, st>>>(x, L, ab, nc, m, plen,
                                               start_side, P, o);
  }
  return static_cast<int>(cudaGetLastError());
}
