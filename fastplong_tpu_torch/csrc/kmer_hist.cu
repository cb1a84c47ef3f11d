// 10-mer histogram of adapter auto-detection: for every row i of
// mat [n, wfull] (uint8, the sampled end window of one read) and every
// column c < min(npos[i], wfull - 10) whose 10 bytes mat[i, c .. c + 9] are
// all A, T, U, C or G, the window's 2-bit key (A = 0, T/U = 1, C = 2, G = 3,
// first byte in the high bits) adds 1 to acc[0][key] and
// pbase[i] + sign * c to acc[1][key].  acc is the run's [2, 4^10] int64
// accumulator (the position sums are read as uint64); the kernel adds into
// it, so one launch fills one side.
//
// Replaces fastplong_tpu/ops/kmer.py:_accumulate, the jitted scatter-add of
// the JAX package's adapter detection (uint32 counters there, with a host
// route for position sums that could wrap; 64-bit counters here).
//
// Bound on an H100: each row's bytes read once (139 bytes a row, about
// 1.1 MB for 8,000 sampled reads) and two 64-bit atomics per valid window
// (about 1M a side); the 4^10 bins (16.8 MB for both rows) do not fit in
// shared memory, so the atomics go to L2, where they spread over a million
// addresses.  Design: one warp per row, each lane four consecutive columns
// of a 128-column chunk; a lane loads its 13 bytes (its four windows and
// their overlap; the row is at most a few cache lines, so the warp's loads
// come from L1) and rolls its key one byte at a time, with a run length of
// valid bytes in place of a validity mask.  The counts are integers, so any
// order of the atomics gives the plain version's sums bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyLen = 10;
constexpr uint32_t kKeyMask = (1u << (2 * kKeyLen)) - 1u;
constexpr int kKeySpace = 1 << (2 * kKeyLen);
constexpr int kPerLane = 4;                  // columns per lane and chunk
constexpr int kChunk = 32 * kPerLane;        // columns per warp and chunk

__device__ __forceinline__ int base_code(uint32_t b) {
  switch (b) {
    case 'A': return 0;
    case 'T': case 'U': return 1;
    case 'C': return 2;
    case 'G': return 3;
    default: return -1;
  }
}

__global__ void __launch_bounds__(kThreads)
    kmer_hist_kernel(const uint8_t* __restrict__ mat, int n, int wfull,
                     const int* __restrict__ npos,
                     const int64_t* __restrict__ pbase, int sign,
                     unsigned long long* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  const int W = wfull - kKeyLen;
  unsigned long long* counts = acc;
  unsigned long long* posacc = acc + kKeySpace;
  for (int i = blockIdx.x * kWarps + (threadIdx.x >> 5); i < n;
       i += gridDim.x * kWarps) {
    const int cols = min(__ldg(npos + i), W);
    const uint8_t* row = mat + static_cast<int64_t>(i) * wfull;
    const unsigned long long base =
        static_cast<unsigned long long>(__ldg(pbase + i));
    for (int c0 = kPerLane * lane; c0 < cols; c0 += kChunk) {
      uint32_t key = 0u;
      int run = 0;    // valid bytes ending at the current one
#pragma unroll
      for (int b = 0; b < kPerLane + kKeyLen - 1; ++b) {
        const int j = c0 + b;
        const int code = j < wfull ? base_code(__ldg(row + j)) : -1;
        key = ((key << 2) | static_cast<uint32_t>(code < 0 ? 0 : code)) &
              kKeyMask;
        run = code < 0 ? 0 : run + 1;
        const int c = j - (kKeyLen - 1);    // the window ending at j
        if (b >= kKeyLen - 1 && run >= kKeyLen && c < cols) {
          atomicAdd(counts + key, 1ull);
          atomicAdd(posacc + key,
                    base + static_cast<unsigned long long>(
                               static_cast<int64_t>(sign) * c));
        }
      }
    }
  }
}

}  // namespace

extern "C" int fpl_kmer_hist(const void* mat, int n, int wfull,
                             const void* npos, const void* pbase, int sign,
                             void* acc, void* stream) {
  if (n < 0 || wfull <= kKeyLen || (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    kmer_hist_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(mat), n, wfull,
        static_cast<const int*>(npos), static_cast<const int64_t*>(pbase),
        sign, static_cast<unsigned long long*>(acc));
  }
  return static_cast<int>(cudaGetLastError());
}
