// Low-quality region summary: for each span i = (slot, read) of an [S, B]
// stack of spans [lo, hi) over the reads' exclusive quality cumsum cq
// [B, L + 1] (row b = i mod B), the (ws1, last_end, count) of
// ops/regions.py:detect_regions_summary_plain, bit for bit.  With l = hi - lo
// and, for 0 <= s < L,
//   S(s)     = cq[clip(lo + s + w, 0, L)] - cq[clip(lo + s, 0, L)],
//   Snext(s) = S(s + 1) for s < L - 1, and 0 at s = L - 1,
// a pass is active while start + w <= l; its base is
// qw1 = cq[clip(lo + w, 0, L)] - cq[clip(lo + w - 1, 0, L)] on the first
// pass and S(clip(start, 0, L - 1)) after it;
//   ws = the first s >= start with s + w < l and S(s) - base < T,
//   e  = the first e >= ws with e + w < l and Snext(e) - base >= T, else
//        l - w;
// a pass with no ws ends the span; otherwise ws1 is set on the first hit,
// last_end = e + w - 1, count += 1 and start = e + w.  Every sum and bound
// is int32 arithmetic that wraps, as in the JAX function.  Outputs go to
// out[0 .. n) (ws1), out[n .. 2n) (last_end) and out[2n .. 3n) (count),
// n = S * B; (-1, -1, 0) where a span has no region.
//
// Replaces fastplong_tpu/ops/regions.py:detect_regions_summary, a
// lax.while_loop of whole-batch [B, L] passes that runs until every span
// is done, one pass per region.  In PyTorch that loop would need the host
// to read `done.all()` after every pass, a sync inside the step.
//
// Bound on an H100: each in-span position's cq entry (4 bytes) read once,
// a few integer operations per position: bound by bytes.  The kernel before
// this design gave each span one warp, 128 positions per search step; on
// the card it took 0.034 ms at [2, 1024] x 8192 with cq warm in L2 and
// 0.069 ms with cq evicted (0.073 ms a launch inside the step): a chain of
// about 48 dependent steps per span, each as slow as the memory that
// serves it (tools/torch_kernel_roles.py, PERF.md).  Design: one block of
// kWarps warps per span.  Each search step tests kWarps * kChunks * 32
// consecutive positions: every lane issues its 2 * kChunks (ws search) or
// 4 * kChunks (e search, for S(s + 1)) coalesced loads of cq first, then
// one __ballot_sync per 32 positions in order and __ffs give each warp
// its first hit, and the block takes the
// least of the warps' hits through shared memory after one barrier (the
// slots alternate between steps, so no second barrier is needed).  Every
// thread keeps the span's pass state, so all of them take the same
// branches.  start only moves forward (start_{k+1} = e_k + w > ws_k), so a
// span costs about l / 1024 steps however many regions it has, and nothing
// leaves the card between passes.  A span with no room for a window (l <= w
// where the bounds do not wrap) leaves at once.  The window sums come from
// cq rather than from the quality bytes: two loads a position from a buffer
// the step already holds, and no in-block prefix sum.  It takes 0.017-0.020
// ms warm and 0.024-0.027 ms evicted in the break and mask forms, 2.6
// times its bound warm; other block sizes (4 to 16 warps) and step widths
// (512 to 2,048 positions) made little difference.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;          // 32-position chunks per warp and step
constexpr int kStep = kWarps * kChunks * 32;   // positions per search step
constexpr int kNoHit = INT_MAX;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

struct Span {
  const int* cq;    // this read's row of L + 1 sums
  int L;
  int lo;
  int w;

  __device__ __forceinline__ int S(int s) const {
    const int a = wadd(lo, s);
    return wsub(__ldg(cq + clip(wadd(a, w), 0, L)), __ldg(cq + clip(a, 0, L)));
  }
  __device__ __forceinline__ int Snext(int s) const {
    return s < L - 1 ? S(s + 1) : 0;
  }
};

// The first s in [from, lim) with s + w < l and, for the ws search,
// S(s) - base < T or, for the e search, Snext(s) - base >= T; -1 if none.
// lim <= L bounds the positions the span can test (see the kernel).  Every
// thread of the block calls it with the same arguments and gets the same
// result; hit[2][kWarps] are the warps' slots, alternated by `parity`.
template <bool kExtend>
__device__ int first_hit(const Span& sp, int from, int lim, int l, int base,
                         int T, int (*hit)[kWarps], int& parity) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int s0 = from; s0 < lim; s0 += kStep) {
    const int w0 = s0 + warp * kChunks * 32;
    int v[kChunks];
    bool ok[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int s = w0 + 32 * k + lane;
      ok[k] = s < lim && wadd(s, sp.w) < l;
      v[k] = ok[k] ? (kExtend ? sp.Snext(s) : sp.S(s)) : 0;
    }
    int mine = kNoHit;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int d = wsub(v[k], base);
      const unsigned m = __ballot_sync(kFull, ok[k] && (kExtend ? d >= T
                                                                : d < T));
      if (m && mine == kNoHit) mine = w0 + 32 * k + __ffs(m) - 1;
    }
    if (lane == 0) hit[parity][warp] = mine;
    __syncthreads();
    int first = kNoHit;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) first = min(first, hit[parity][w]);
    parity ^= 1;
    if (first != kNoHit) return first;
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads)
regions_kernel(const int* __restrict__ cq, int B, int L,
               const int* __restrict__ lo, const int* __restrict__ hi, int n,
               int w, int T, int* __restrict__ out) {
  __shared__ int hit[2][kWarps];
  const int i = blockIdx.x;
  const int* row = cq + static_cast<int64_t>(i % B) * (L + 1);
  const Span sp{row, L, lo[i], w};
  const int l = wsub(hi[i], sp.lo);
  // s + w < l holds exactly for s < l - w while s + w cannot wrap for any
  // s < L; otherwise every position up to L is tested as it stands
  const long long room = static_cast<long long>(l) - w;
  const int lim = static_cast<long long>(w) + L - 1 > INT_MAX ? L
      : room <= 0 ? 0
      : room < L ? static_cast<int>(room) : L;
  int ws1 = -1;
  int last_end = -1;
  int count = 0;
  if (lim > 0) {      // else no pass can find a window: the block leaves
    const int qw1 = wsub(__ldg(row + clip(wadd(sp.lo, w), 0, L)),
                         __ldg(row + clip(wsub(wadd(sp.lo, w), 1), 0, L)));
    int parity = 0;
    int start = 0;
    // every hit lies in [0, L) and beyond the last, so at most L passes
    // hit; the count test only keeps a span whose bounds wrap from looping
    while (wadd(start, w) <= l && count <= L) {
      const int base = count == 0 ? qw1 : sp.S(clip(start, 0, L - 1));
      const int ws = first_hit<false>(sp, max(start, 0), lim, l, base, T,
                                      hit, parity);
      if (ws < 0) break;
      int e = first_hit<true>(sp, ws, lim, l, base, T, hit, parity);
      if (e < 0) e = wsub(l, w);
      if (count == 0) ws1 = ws;
      last_end = wsub(wadd(e, w), 1);
      count += 1;
      start = wadd(e, w);
    }
  }
  if (threadIdx.x == 0) {
    out[i] = ws1;
    out[n + i] = last_end;
    out[2 * static_cast<int64_t>(n) + i] = count;
  }
}

}  // namespace

extern "C" int fpl_regions(const void* cq, int B, int L, const void* lo,
                           const void* hi, int n, int w, int T, void* out,
                           void* stream) {
  if (n <= 0 || B <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  regions_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cq), B, L, static_cast<const int*>(lo),
      static_cast<const int*>(hi), n, w, T, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
