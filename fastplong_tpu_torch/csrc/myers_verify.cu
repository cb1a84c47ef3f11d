// Batched Myers/Hyyro bit-vector edit distance: out[n] is the Levenshtein
// distance of text[n, :tlen[n]] against the pattern's first plen[n] bytes
// (a lane with plen <= 0 returns tlen).  The pattern is given as a
// [256, K] table of 32-bit masks: bit i of word r is set iff
// pattern[32 r + i] == byte.
//
// Replaces fastplong_tpu/ops/myers.py:myers_distance_unrolled as
// fastplong_tpu/ops/adapter.py:_verify_at calls it (the trim verifies, with
// T = min(alen, 200) and K <= 7, and the middle-adapter search, with
// T = alen and K <= 20).
//
// Bound on an H100: a few bytes of input per lane and about 20 integer
// operations per column and word; the recurrence is serial over the text,
// so what bounds the kernel is the latency of its dependency chain, not
// bytes or issue.  Design, per regime:
//
//   * K = 1 and T <= 32 (the headline's 23 and 28 bp adapters): one thread
//     per lane, blocks of 32 threads so that 1024 lanes spread over 32 SMs.
//     Before the column loop a thread loads its text into registers (4-byte
//     loads where the rows allow) while the warp copies the 1 KB table to
//     shared memory (no block barrier: a block is one warp), then looks up
//     each column's mask, so the fully unrolled loop waits on no memory.
//   * otherwise (K >= 2, or a K = 1 text longer than 32): a warp wavefront.
//     Word r of a lane lives on thread r of a group of K threads, so a warp
//     holds floor(32 / K) lanes.  At step m thread r updates its word over
//     the eight columns 8 (m - r) .. 8 (m - r) + 7; the hn/hp carries of
//     word r - 1 at those columns come from thread r - 1, packed into one
//     word and passed by one __shfl_up_sync per step, and the thread that
//     holds the pattern's top word keeps the score.  A lane takes
//     ceil(steps / 8) + top steps (top = (plen - 1) / 32; words above it
//     cannot reach the score and are not computed) instead of steps * K
//     dependent word updates in one thread, and a shuffle's latency is paid
//     once per eight columns.  While a step runs, the thread's masks of the
//     next step and its text bytes of the step after are in flight, so no
//     column waits on a load.  Columns past the lane's text length within
//     its last step change words that no score reads (a column's words
//     feed only the same column of the words above), and the score counts
//     only the lane's own columns: every distance is the plain version's,
//     whose words freeze there.
//
// Two independent problems (each with its own table, K, T, N, plen, tlen
// and text) can share one launch: blocks [0, a.blocks) serve the first,
// the rest the second.  The problems are passed by value as kernel
// arguments; nothing is copied to the card per call.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 32;     // one warp per block
constexpr int kRegT = 32;        // longest text of the K = 1 register path
constexpr int kMaxK = 32;        // one warp holds a lane's words
constexpr int kAhead = 8;        // columns per wavefront step

struct Problem {
  const uint8_t* text;
  const int* plen;
  const int* tlen;
  const uint32_t* pm;
  int* out;
  int N, T, K, blocks;
};

__host__ __device__ __forceinline__ bool register_path(const Problem& p) {
  return p.K == 1 && p.T <= kRegT;
}

// one word of the Hyyro recurrence; hn_in/hp_in are the carries of the
// word below at the same column
__device__ __forceinline__ void myers_word(uint32_t X, uint32_t hn_in,
                                           uint32_t hp_in, uint32_t& VP,
                                           uint32_t& VN, uint32_t& HP,
                                           uint32_t& HN) {
  X |= hn_in;
  const uint32_t vp = VP;
  const uint32_t vn = VN;
  const uint32_t D0 = (((X & vp) + vp) ^ vp) | X | vn;
  HP = vn | ~(D0 | vp);
  HN = D0 & vp;
  const uint32_t X2 = (HP << 1) | hp_in;
  VP = (HN << 1) | ~(D0 | X2) | hn_in;
  VN = D0 & X2;
}

__device__ __forceinline__ int score_step(uint32_t HP, uint32_t HN,
                                          uint32_t top) {
  return (HP & top) ? 1 : ((HN & top) ? -1 : 0);
}

__device__ __forceinline__ uint32_t low_bits(int bits) {
  bits = bits < 0 ? 0 : bits;
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

// K = 1, T <= 32: one thread per lane, text and masks in registers
__device__ __forceinline__ void verify_registers(const Problem& p, int blk) {
  __shared__ uint32_t s_pm[256];
  const int lane = threadIdx.x;
  const int n = blk * kThreads + lane;
  const bool live = n < p.N;
  // the warp copies the 1 KB table while its text loads are in flight
#pragma unroll
  for (int k = 0; k < 256 / kThreads; ++k)
    s_pm[lane + kThreads * k] = __ldg(p.pm + lane + kThreads * k);
  const int T = p.T;
  const uint8_t* row = p.text + static_cast<int64_t>(live ? n : 0) * T;
  const bool words = (T & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(p.text) & 3) == 0;
  uint32_t w[kRegT / 4];
#pragma unroll
  for (int k = 0; k < kRegT / 4; ++k) {
    uint32_t v = 0u;
    if (live && 4 * k < T) {
      if (words) {
        v = __ldg(reinterpret_cast<const uint32_t*>(row) + k);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (4 * k + b < T)
            v |= static_cast<uint32_t>(__ldg(row + 4 * k + b)) << (8 * b);
      }
    }
    w[k] = v;
  }
  const int plen = live ? max(__ldg(p.plen + n), 0) : 0;
  const int tlen = live ? __ldg(p.tlen + n) : 0;
  const int steps = min(tlen, T);
  __syncwarp();
  uint32_t X[kRegT];
#pragma unroll
  for (int j = 0; j < kRegT; ++j)
    X[j] = j < steps ? s_pm[(w[j >> 2] >> (8 * (j & 3))) & 0xFFu] : 0u;

  uint32_t VP = low_bits(plen), VN = 0u;
  const uint32_t top = 1u << ((plen - 1) & 31);
  int D = plen;
#pragma unroll
  for (int j = 0; j < kRegT; ++j) {
    if (j < steps) {
      uint32_t HP, HN;
      myers_word(X[j], 0u, 1u, VP, VN, HP, HN);
      D += score_step(HP, HN, top);
    }
  }
  if (live) p.out[n] = plen > 0 ? D : tlen;
}

// any K <= 32: a lane's K words on K threads of the warp, as a wavefront
// over blocks of kAhead columns
__device__ __forceinline__ void verify_wavefront(const Problem& p, int blk) {
  const int K = p.K;
  const int G = kThreads / K;               // lanes per warp
  const int lane = threadIdx.x;
  const int g = lane / K;
  const int r = lane - g * K;                // this thread's word
  const int n = blk * G + g;
  const bool live = g < G && n < p.N;
  int plen = 0, tlen = 0, steps = 0, top = 0;
  if (live) {
    plen = max(__ldg(p.plen + n), 0);
    tlen = __ldg(p.tlen + n);
    steps = max(min(tlen, p.T), 0);
    top = plen > 0 ? min((plen - 1) / 32, K - 1) : 0;
  }
  const bool works = live && plen > 0 && r <= top;
  // columns this thread updates: [0, cols); it reaches column block b at
  // step b + r
  const int cols = works ? steps : 0;
  const int mmax =
      __reduce_max_sync(kFull, works ? (cols + kAhead - 1) / kAhead + r : 0);

  uint32_t VP = low_bits(plen - 32 * r), VN = 0u;
  int D = plen;
  const bool first = r == 0;
  // the score bit (plen - 1) % 32 of the top word, moved to bit 31
  const int score_shift = 31 - ((plen - 1) & 31);
  const int score_cols = r == top ? cols : 0;
  const uint8_t* row = p.text + static_cast<int64_t>(live ? n : 0) * p.T;
  const uint32_t* pm = p.pm + r;
  // loads clamped to the row: a column outside the lane's text is never
  // scored, so its bytes need not be right
  const bool any_text = p.T > 0;
  const unsigned last = any_text ? p.T - 1 : 0;
  auto byte_at = [&](int j) {
    return any_text ? __ldg(row + min(static_cast<unsigned>(j), last)) : 0;
  };
  auto mask_at = [&](int b) { return __ldg(pm + b * K); };
  // while a block runs, the masks of the next block and the text bytes of
  // the one after it are in flight
  uint32_t cur[kAhead];
  int nb[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    cur[u] = mask_at(byte_at(u - kAhead * r));
    nb[u] = byte_at(kAhead + u - kAhead * r);
  }
  // bit kAhead - 1 - u: HP (low byte) and HN (next byte) bit 31 of this
  // thread's word at column u of its last block, for thread r + 1
  uint32_t carries = 0u;
  for (int m = 0; m < mmax; ++m) {
    const int c0 = kAhead * (m - r);         // this step's first column
    uint32_t nxt[kAhead];
    int nb2[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      nxt[u] = mask_at(nb[u]);
      nb2[u] = byte_at(c0 + 2 * kAhead + u);
    }
    const uint32_t in = __shfl_up_sync(kFull, carries, 1);
    if (static_cast<unsigned>(c0) < static_cast<unsigned>(cols)) {
      // the carries of word r - 1 at columns c0 .. c0 + 7; the lowest word
      // takes hp 1, hn 0
      const uint32_t hp_bits = first ? 0xFFu : in & 0xFFu;
      const uint32_t hn_bits = first ? 0u : (in >> kAhead) & 0xFFu;
      uint32_t hp_acc = 0u, hn_acc = 0u, hp_top = 0u, hn_top = 0u;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        // bit 31: the carry at column c0 + u
        const uint32_t hp_src = hp_bits << (24 + u);
        const uint32_t hn_src = hn_bits << (24 + u);
        // myers_word, with the carries shifted in by funnel shifts
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
  if (live && r == top) p.out[n] = plen > 0 ? D : tlen;
}

__device__ __forceinline__ void verify(const Problem& p, int blk) {
  if (register_path(p))
    verify_registers(p, blk);
  else
    verify_wavefront(p, blk);
}

__global__ void __launch_bounds__(kThreads)
    myers_verify_kernel(const Problem a, const Problem b) {
  if (static_cast<int>(blockIdx.x) < a.blocks)
    verify(a, blockIdx.x);
  else
    verify(b, blockIdx.x - a.blocks);
}

Problem make_problem(const void* text, int N, int T, const void* plen,
                     const void* tlen, const void* pm, int K, void* out) {
  Problem p;
  p.text = static_cast<const uint8_t*>(text);
  p.plen = static_cast<const int*>(plen);
  p.tlen = static_cast<const int*>(tlen);
  p.pm = static_cast<const uint32_t*>(pm);
  p.out = static_cast<int*>(out);
  p.N = N;
  p.T = T;
  p.K = K;
  const int lanes = register_path(p) ? kThreads : kThreads / K;
  p.blocks = N > 0 ? (N + lanes - 1) / lanes : 0;
  return p;
}

}  // namespace

extern "C" int fpl_myers_verify_pair(
    const void* text0, int N0, int T0, const void* plen0, const void* tlen0,
    const void* pm0, int K0, void* out0, const void* text1, int N1, int T1,
    const void* plen1, const void* tlen1, const void* pm1, int K1, void* out1,
    void* stream) {
  if (K0 < 1 || K0 > kMaxK || K1 < 1 || K1 > kMaxK || N0 < 0 || N1 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem a = make_problem(text0, N0, T0, plen0, tlen0, pm0, K0, out0);
  const Problem b = make_problem(text1, N1, T1, plen1, tlen1, pm1, K1, out1);
  const int blocks = a.blocks + b.blocks;
  if (blocks > 0)
    myers_verify_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a, b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fpl_myers_verify(const void* text, int N, int T,
                                const void* plen, const void* tlen,
                                const void* pm_tbl, int K, void* out,
                                void* stream) {
  return fpl_myers_verify_pair(text, N, T, plen, tlen, pm_tbl, K, out,
                               nullptr, 0, 1, nullptr, nullptr, nullptr, 1,
                               nullptr, stream);
}
