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
// (about 1 M windows a side); the 4^10 bins (16.8 MB for both rows) do not
// fit in shared memory, so the atomics go to L2, and they, not the steps,
// set the kernel's time (without them it takes under a quarter of it).
// Auto-detection's sample puts each adapter at one column in every row
// that carries it (START at column 0 of the start side, END at column 116
// of the end side), so some 6,400 rows would send their atomics to the
// same few dozen addresses, where they queue.
//
// Design: the lanes of a warp take 32 rows and one range of at most kSpan
// columns, so that at each step the 32 lanes stand at the same column; 9
// columns a warp keep its chain of steps short, which small batches wait
// for, and blocks of 4 warps spread a small batch's atomics over more SMs.
// A lane loads its row's bytes of the range (the windows and their
// 9-byte overlap) as aligned 4-byte words, all at once, and realigns them
// with funnel shifts; it then rolls its key one byte a step, straight-line
// code, with a run length of valid bytes in place of a validity mask.  At
// each column the lanes whose windows hold the key of the first lane whose
// right neighbour holds the same key form a group (a shuffle and two
// ballots; __match_any_sync costs about 500 cycles a call on an H100, and
// in the sample only an adapter's key fills a column); the group's first
// lane adds its size to acc[0][key] and size * (pbase + sign * c) to
// acc[1][key], so an adapter's thousands of same-address atomics become
// one a warp.  The exchanges of up to kChunk columns are issued together,
// so that their latencies overlap.  Groups form only in warps whose rows
// share one pbase (the sample's do: 0 on the start side, 139 on the end
// side for reads of 139 bases or more); every other lane adds its own
// window.  The sums are integers, so any order of the atomics gives the
// plain version's result bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyLen = 10;
constexpr uint32_t kKeyMask = (1u << (2 * kKeyLen)) - 1u;
constexpr int kKeySpace = 1 << (2 * kKeyLen);
// columns a warp takes at most: 129 window columns split into 15 ranges
constexpr int kSpan = 9;
constexpr int kChunk = 8;    // columns whose exchanges are issued together
// a lane's bytes: the range's windows and their overlap
constexpr int kBytes = kSpan + kKeyLen - 1;
constexpr int kWords = (kBytes + 3) / 4;

// 2-bit code of an ASCII byte (A = 0, T/U = 1, C = 2, G = 3: bits 1-2 of
// the byte, swapped) and whether it is one of A, C, G, T, U
__device__ __forceinline__ uint32_t base_code(uint32_t b, bool& ok) {
  const uint32_t d = b - 'A';
  ok = d < 21u && ((0x180045u >> d) & 1u);   // A, C, G, T, U from 'A'
  const uint32_t x = (b >> 1) & 3u;           // A 0, C 1, T/U 2, G 3
  return ((x << 1) | (x >> 1)) & 3u;
}

__global__ void __launch_bounds__(kThreads)
    kmer_hist_kernel(const uint8_t* __restrict__ mat, int n, int wfull,
                     const int* __restrict__ npos,
                     const int64_t* __restrict__ pbase, int sign,
                     int ranges, int span,
                     unsigned long long* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  const int64_t gw =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (gw >= static_cast<int64_t>((n + 31) / 32) * ranges) return;
  const int row = static_cast<int>(gw / ranges) * 32 + lane;
  const int c0 = static_cast<int>(gw % ranges) * span;
  const int c1 = min(c0 + span, wfull - kKeyLen);   // columns [c0, c1)
  const bool live = row < n;    // a lane past the last row has no window

  // this lane's bytes c0 .. c1 + 8 of its row, as words from the aligned
  // word that holds byte c0 (only words that hold one of them are read)
  const uintptr_t first = reinterpret_cast<uintptr_t>(
      mat + static_cast<int64_t>(live ? row : 0) * wfull + c0);
  const uintptr_t last = first + (c1 - c0 + kKeyLen - 2);
  const uint32_t* w0 =
      reinterpret_cast<const uint32_t*>(first & ~uintptr_t{3});
  uint32_t w[kWords + 1];
#pragma unroll
  for (int t = 0; t <= kWords; ++t)
    w[t] = live && reinterpret_cast<uintptr_t>(w0 + t) <= last ? __ldg(w0 + t)
                                                               : 0u;
  const int cols = live ? __ldg(npos + row) : 0;
  const unsigned long long base =
      live ? static_cast<unsigned long long>(__ldg(pbase + row)) : 0ull;
  const uint32_t shift = 8u * static_cast<uint32_t>(first & 3u);
  // whether the warp's rows share one pbase, so that a group's position
  // sum is size * (pbase + sign * c)
  const unsigned long long base0 = __shfl_sync(0xffffffffu, base, 0);
  const bool one_base = __all_sync(0xffffffffu, !live || base == base0);

  unsigned long long* counts = acc;
  unsigned long long* posacc = acc + kKeySpace;
  uint32_t key = 0u;
  int run = 0;    // valid bytes ending at the current one
  auto roll = [&](int j) {    // takes byte j into key and run
    const uint32_t word = __funnelshift_r(w[j / 4], w[j / 4 + 1], shift);
    bool ok;
    const uint32_t code = base_code((word >> (8 * (j % 4))) & 0xFFu, ok);
    key = ((key << 2) | code) & kKeyMask;
    run = ok ? run + 1 : 0;
  };
#pragma unroll
  for (int j = 0; j < kKeyLen - 1; ++j) roll(j);
  // the windows kChunk columns at a time, each exchange issued for all of
  // them before the next, so that their latencies overlap
#pragma unroll
  for (int k0 = 0; k0 < kSpan; k0 += kChunk) {
    // a window's tag: its key, or (keys are below 2^20) a value that
    // matches no other lane's where the window is not valid
    uint32_t tag[kChunk], pairs[kChunk], lead[kChunk], group[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk && k0 + k < kSpan; ++k) {
      roll(k0 + k + kKeyLen - 1);
      const int c = c0 + k0 + k;
      tag[k] = run >= kKeyLen && c < c1 && c < cols ? key
                                                    : 0x80000000u | lane;
    }
    // the lanes whose right neighbour holds the same key, then the key of
    // the first of them and the lanes that hold it
#pragma unroll
    for (int k = 0; k < kChunk && k0 + k < kSpan; ++k) {
      const uint32_t right = __shfl_down_sync(0xffffffffu, tag[k], 1);
      pairs[k] = __ballot_sync(0xffffffffu, lane < 31 && tag[k] == right);
    }
#pragma unroll
    for (int k = 0; k < kChunk && k0 + k < kSpan; ++k)
      lead[k] = __shfl_sync(0xffffffffu, tag[k], __ffs(pairs[k]) - 1);
#pragma unroll
    for (int k = 0; k < kChunk && k0 + k < kSpan; ++k)
      group[k] = __ballot_sync(
          0xffffffffu, one_base && pairs[k] != 0u && tag[k] == lead[k]);
#pragma unroll
    for (int k = 0; k < kChunk && k0 + k < kSpan; ++k) {
      const unsigned peers = (group[k] >> lane) & 1u ? group[k] : 1u << lane;
      if (tag[k] < 0x80000000u && lane == __ffs(peers) - 1) {
        const int size = __popc(peers);
        const int c = c0 + k0 + k;
        atomicAdd(counts + tag[k], static_cast<unsigned long long>(size));
        atomicAdd(posacc + tag[k],
                  (base + static_cast<unsigned long long>(
                              static_cast<int64_t>(sign) * c)) * size);
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
    // the window columns in `ranges` ranges of at most kSpan each
    const int W = wfull - kKeyLen;
    const int ranges = (W + kSpan - 1) / kSpan;
    const int span = (W + ranges - 1) / ranges;
    const int64_t warps = static_cast<int64_t>((n + 31) / 32) * ranges;
    const int64_t blocks = (warps + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    kmer_hist_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(mat), n, wfull,
        static_cast<const int*>(npos), static_cast<const int64_t*>(pbase),
        sign, ranges, span, static_cast<unsigned long long*>(acc));
  }
  return static_cast<int>(cudaGetLastError());
}
