// Batched Myers/Hyyro bit-vector edit distance for patterns of any length:
// out[n] is the Levenshtein distance of text[n, :tlen[n]] against the
// pattern's first plen[n] bytes (a lane with plen <= 0 returns tlen), with
// the pattern given as a [256, K] table of 32-bit masks for any K (bit i of
// word r is set iff pattern[32 r + i] == byte).  The same distances as
// csrc/myers_verify.cu, which holds a lane's words on one warp and so stops
// at K = 32.
//
// Replaces fastplong_tpu/ops/myers.py:myers_distance_blockscan, the JAX
// package's form for patterns longer than 640 bp (K > 20): a scan over the
// text with a scan over the K words inside.  The middle-adapter search of
// a start or end adapter longer than 640 bp runs it with T = alen.
//
// Bound on an H100: a few bytes of input per lane and about 20 integer
// operations per column and word, in a chain that is serial over the text
// and over the words; the latency of that chain bounds it.  Design: one
// warp per lane, in passes of 32 words.  In pass s thread t holds word
// 32 s + t and the warp runs the wavefront of myers_verify.cu over it: at
// step m thread t updates its word over the eight columns 8 (m - t) ..
// 8 (m - t) + 7, taking the hn/hp carries of word 32 s + t - 1 at those
// columns from thread t - 1 by one __shfl_up_sync a step.  Thread 31 also
// stores its word's carries, eight columns' worth in one 32-bit value, in a
// per-lane scratch row, and in the next pass thread 0 reads them from there
// as the carries of the word below its own (pass 0 takes hp 1, hn 0).  A
// step reads the carry entry that thread 31 wrote in the previous pass and
// overwrites an entry already read, so one row of ceil(T / 8) values per
// lane serves every pass; __syncwarp orders the passes.  Only words up to
// the pattern's top word (plen - 1) / 32 are computed: a word feeds only
// the words above it, and the score reads the top word alone.  Columns past
// the lane's text length within its last step change words that no score
// reads, and the score counts only the lane's own columns.  No word is
// kept in shared memory or across passes, so any K runs with the same
// registers; a lane costs about (top / 32 + 1) (T / 8 + 31) steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;                // lanes per block
constexpr int kThreads = 32 * kWarps;
constexpr int kAhead = 8;                // columns per wavefront step

__device__ __forceinline__ uint32_t low_bits(int bits) {
  bits = bits < 0 ? 0 : bits;
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

__global__ void __launch_bounds__(kThreads)
    myers_blockscan_kernel(const uint8_t* __restrict__ text, int N, int T,
                           const int* __restrict__ plen_in,
                           const int* __restrict__ tlen_in,
                           const uint32_t* __restrict__ pm, int K,
                           uint32_t* __restrict__ scratch, int nblk,
                           int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;                      // whole warps leave together
  const int plen = max(__ldg(plen_in + n), 0);
  const int tlen = __ldg(tlen_in + n);
  if (plen == 0) {
    if (lane == 0) out[n] = tlen;
    return;
  }
  const int steps = max(min(tlen, T), 0);
  const int top = min((plen - 1) / 32, K - 1);
  const int score_shift = 31 - ((plen - 1) & 31);
  const uint8_t* row = text + static_cast<int64_t>(n) * T;
  uint32_t* carry_row = scratch + static_cast<int64_t>(n) * nblk;
  const unsigned last = T > 0 ? T - 1 : 0;
  auto byte_at = [&](int j) {
    return T > 0 ? __ldg(row + min(static_cast<unsigned>(j), last)) : 0;
  };
  int D = plen;
  for (int w0 = 0; w0 <= top; w0 += 32) {
    const int r = w0 + lane;               // this thread's word
    const bool works = r <= top;
    const int cols = works ? steps : 0;
    const int mmax = (steps + kAhead - 1) / kAhead + min(top - w0, 31);
    const uint32_t* pm_r = pm + min(r, K - 1);
    auto mask_at = [&](int b) { return __ldg(pm_r + b * K); };
    const bool from_scratch = lane == 0 && w0 > 0;
    const bool to_scratch = lane == 31 && r < top;
    const int score_cols = r == top ? cols : 0;
    uint32_t VP = low_bits(plen - 32 * r), VN = 0u;
    uint32_t cur[kAhead];
    int nb[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      cur[u] = mask_at(byte_at(u - kAhead * lane));
      nb[u] = byte_at(kAhead + u - kAhead * lane);
    }
    // bit kAhead - 1 - u: HP (low byte) and HN (next byte) bit 31 of this
    // thread's word at column u of its last step, for the word above
    uint32_t carries = 0u;
    for (int m = 0; m < mmax; ++m) {
      const int c0 = kAhead * (m - lane);  // this step's first column
      uint32_t nxt[kAhead];
      int nb2[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        nxt[u] = mask_at(nb[u]);
        nb2[u] = byte_at(c0 + 2 * kAhead + u);
      }
      uint32_t in = __shfl_up_sync(kFull, carries, 1);
      if (static_cast<unsigned>(c0) < static_cast<unsigned>(cols)) {
        // the carries of word r - 1 at columns c0 .. c0 + 7; word 0 takes
        // hp 1, hn 0
        if (lane == 0) in = from_scratch ? carry_row[c0 / kAhead] : 0xFFu;
        const uint32_t hp_bits = in & 0xFFu;
        const uint32_t hn_bits = (in >> kAhead) & 0xFFu;
        uint32_t hp_acc = 0u, hn_acc = 0u, hp_top = 0u, hn_top = 0u;
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          // bit 31: the carry at column c0 + u
          const uint32_t hp_src = hp_bits << (24 + u);
          const uint32_t hn_src = hn_bits << (24 + u);
          const uint32_t X = cur[u] | (hn_src >> 31);
          const uint32_t D0 = (((X & VP) + VP) ^ VP) | X | VN;
          const uint32_t HP = VN | ~(D0 | VP);
          const uint32_t HN = D0 & VP;
          const uint32_t X2 = __funnelshift_l(hp_src, HP, 1);
          VP = __funnelshift_l(hn_src, HN, 1) | ~(D0 | X2);
          VN = D0 & X2;
          hp_acc = __funnelshift_l(HP, hp_acc, 1);
          hn_acc = __funnelshift_l(HN, hn_acc, 1);
          hp_top = __funnelshift_l(HP << score_shift, hp_top, 1);
          hn_top = __funnelshift_l(HN << score_shift, hn_top, 1);
        }
        carries = hp_acc | (hn_acc << kAhead);
        if (to_scratch) carry_row[c0 / kAhead] = carries;
        // +1 per HP and -1 per HN score bit, over the lane's own columns
        const int nv = min(max(score_cols - c0, 0), kAhead);
        const uint32_t valid = (0xFFu << (kAhead - nv)) & 0xFFu;
        D += __popc(hp_top & valid) - __popc(hn_top & valid);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        cur[u] = nxt[u];
        nb[u] = nb2[u];
      }
    }
    __syncwarp();
  }
  if (lane == (top & 31)) out[n] = D;
}

}  // namespace

extern "C" int fpl_myers_blockscan(const void* text, int N, int T,
                                   const void* plen, const void* tlen,
                                   const void* pm, int K, void* scratch,
                                   int nblk, void* out, void* stream) {
  if (K < 1 || N < 0 || T < 0 || nblk < (T + kAhead - 1) / kAhead)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0) {
    const int blocks = (N + kWarps - 1) / kWarps;
    myers_blockscan_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(text), N, T,
        static_cast<const int*>(plen), static_cast<const int*>(tlen),
        static_cast<const uint32_t*>(pm), K,
        static_cast<uint32_t*>(scratch), nblk, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
