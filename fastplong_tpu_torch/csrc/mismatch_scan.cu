// Adapter mismatch scan: mm[b, p] = #{i < alen : row[p + i] != adapter[i]},
// where positions past the row length L compare against a zero byte.
//
// Replaces the Pallas kernel fastplong_tpu/ops/pallas_kernels.py
// (_mismatch_pallas, body _kernel) and its XLA twin
// fastplong_tpu/ops/adapter.py:_mismatch_full, whose contract it keeps:
// uint8 output when alen <= 255, int32 above.
//
// Bound on an H100: every input byte is read once and every output byte
// written once, so the floor is the bytes (2 B per position at uint8 out).
// A compare loop costs three instructions per adapter byte per output
// (about 84 per output at 28 bp) and is bound by instruction issue
// instead.  The uint8 path therefore counts bit-parallel, 32 positions to a
// 32-bit word:
//
//   * loads: a block owns W = blockDim.x words of 32 positions of one row;
//     thread t loads word t into registers as two 16-byte loads (bytes past
//     L become 0).  The first (alen - 1) / 32 + 1 threads also load one
//     halo word past the tile, unless the tile reaches the row's end (as
//     every tile of the main path's [*, 8192] rows does): its halo is
//     zero bytes, whose planes are constants;
//   * mismatch planes: for each distinct adapter byte c, a thread turns its
//     32 bytes into a 32-bit mask (bit k set iff byte k != c) with SIMD
//     byte arithmetic on 4-byte words (an exact nonzero-byte test; the
//     bytes regrouped even/odd once, so that one multiply without carries
//     gathers eight flags and three byte permutes assemble the word) and
//     stores it in shared memory.
//     Any byte works (N, lowercase, IUPAC, and 0 against the padding).
//     Planes are built eight distinct bytes at a time; an adapter with more
//     than eight takes several passes.  (Warp votes, __ballot_sync per byte
//     value, cost more here: a vote, a compare and a select per 32
//     positions per byte value, plus the shared-memory staging they need.)
//   * counting: thread t owns output word t.  For adapter position i the
//     mismatch bits of its 32 outputs are the plane of adapter[i] shifted
//     by i (__funnelshift_r over two plane words); a bit-sliced counter
//     adds them eight at a time through a carry-save tree (seven adders of
//     two operations each, then one carry rippling up from level 3);
//   * output: the counter planes are spread to bytes four at a time (a
//     multiply puts four bits into four bytes) and each thread stores its
//     32 bytes as two 16-byte stores (neighbouring threads, neighbouring
//     addresses).
//
// Streaming: with one row per block every block of the single wave would
// load, count and store in lockstep, leaving the memory idle while the SMs
// count.  So four blocks of 256 threads (up to 64 registers each, 10 KB of
// shared memory) sit on each SM, and a block scans its tile of enough rows
// for one wave (two at [1024, 8192] on 132 SMs), loading the next row's
// words while it counts one and storing while it counts the next.
//
// The int32 path (alen > 255) is off the main path and keeps the compare
// loop: the adapter and a tile of 1024 positions plus halo in shared memory,
// four counters per thread.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWords = 256;   // words per block on the uint8 path
constexpr int kGroup = 8;        // distinct adapter bytes per plane pass
constexpr int kBlocksPerSM = 4;  // resident blocks of kMaxWords threads

// the 32 bytes of word `word` of a row, bytes past L read as 0
__device__ __forceinline__ void load_word(const uint8_t* src, int L,
                                          int word, uint32_t (&w)[8]) {
  const int p = word * 32;
  if (p + 32 <= L && (reinterpret_cast<uintptr_t>(src + p) & 15) == 0) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(src + p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(src + p) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t v = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (p + 4 * q + k < L)
          v |= static_cast<uint32_t>(src[p + 4 * q + k]) << (8 * k);
      w[q] = v;
    }
  }
}

// the 32 bytes regrouped for mismatch_bits: e[2q] holds positions 8q,
// 8q + 2, 8q + 4, 8q + 6 and e[2q + 1] positions 8q + 1, ..., 8q + 7
__device__ __forceinline__ void split_even_odd(uint32_t (&w)[8]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t lo = w[2 * q], hi = w[2 * q + 1];
    w[2 * q] = __byte_perm(lo, hi, 0x6420);
    w[2 * q + 1] = __byte_perm(lo, hi, 0x7531);
  }
}

// bit k set iff position k of the 32 bytes differs from c (c4 = c *
// 0x01010101); e from split_even_odd
__device__ __forceinline__ uint32_t mismatch_bits(const uint32_t (&e)[8],
                                                  uint32_t c4) {
  uint32_t top[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t xa = e[2 * q] ^ c4;
    const uint32_t xb = e[2 * q + 1] ^ c4;
    // bit 7 of each byte set iff that byte is nonzero (the add cannot carry
    // across bytes)
    const uint32_t fa = ((xa & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | xa;
    const uint32_t fb = ((xb & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | xb;
    // position 8q + j's flag at bit 6 + j of its byte pair ...
    const uint32_t y = ((fa >> 1) & 0x40404040u) | (fb & 0x80808080u);
    // ... and, by one multiply without carries, at bit 24 + j
    top[q] = y * 0x00041041u;
  }
  return __byte_perm(__byte_perm(top[0], top[1], 0x0073),
                     __byte_perm(top[2], top[3], 0x0073), 0x5410);
}

// acc + a + b = acc' + 2 * carry, bit by bit (a carry-save adder)
__device__ __forceinline__ uint32_t csa(uint32_t& acc, uint32_t a,
                                        uint32_t b) {
  const uint32_t carry = (acc & a) | (acc & b) | (a & b);
  acc ^= a ^ b;
  return carry;
}

// adds x to the bit-sliced counter C from level k up (half adders)
template <int NLEV>
__device__ __forceinline__ void ripple(uint32_t (&C)[NLEV], int k0,
                                       uint32_t x) {
#pragma unroll
  for (int k = 0; k < NLEV; ++k) {
    if (k >= k0) {
      const uint32_t t = C[k] & x;
      C[k] ^= x;
      x = t;
    }
  }
}

// the plane word pair of adapter position i: s_off holds byte offsets
__device__ __forceinline__ const uint32_t* at(const uint32_t* planes,
                                              int off) {
  return reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(planes) + off);
}

// adds the mismatch bits of every adapter position to the counter C.  The
// bits of position i are the plane word pair at(planes, s_off[i]), shifted
// by i.  Groups of eight positions go through a carry-save tree (seven
// adders, two operations each) before one carry ripples up from level 3.
template <int NLEV>
__device__ __forceinline__ void count_all(uint32_t (&C)[NLEV],
                                          const uint32_t* planes,
                                          const int* s_off, int alen) {
  int i = 0;
  if constexpr (NLEV >= 4) {
    for (; i + 8 <= alen; i += 8) {
      const int4 o0 = *reinterpret_cast<const int4*>(s_off + i);
      const int4 o1 = *reinterpret_cast<const int4*>(s_off + i + 4);
      const int off[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
      uint32_t x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const uint32_t* p = at(planes, off[u]);
        x[u] = __funnelshift_r(p[0], p[1], (i + u) & 31);
      }
      const uint32_t c1a = csa(C[0], x[0], x[1]);
      const uint32_t c1b = csa(C[0], x[2], x[3]);
      const uint32_t c1c = csa(C[0], x[4], x[5]);
      const uint32_t c1d = csa(C[0], x[6], x[7]);
      const uint32_t c2a = csa(C[1], c1a, c1b);
      const uint32_t c2b = csa(C[1], c1c, c1d);
      ripple(C, 3, csa(C[2], c2a, c2b));
    }
  }
  for (; i < alen; ++i) {
    const uint32_t* p = at(planes, s_off[i]);
    ripple(C, 0, __funnelshift_r(p[0], p[1], i & 31));
  }
}

// NLEV: bit length of alen (the counter's depth), 1..8.  Block (x, y)
// scans tile x of rows [y * rows_per_block, ...).
template <int NLEV>
__global__ void __launch_bounds__(kMaxWords, kBlocksPerSM)
    mismatch_bits_kernel(const uint8_t* __restrict__ bases, int B, int L,
                         const uint8_t* __restrict__ adapter, int alen,
                         int rows_per_block, uint8_t* __restrict__ out) {
  __shared__ __align__(16) int s_off[256];   // its plane word, in bytes
  __shared__ uint8_t s_grp[256];     // plane pass of adapter position i
  __shared__ uint8_t s_dist[256];    // distinct adapter bytes
  __shared__ int s_ndist;
  extern __shared__ uint32_t s_plane[];   // [kGroup][NW]
  const int W = blockDim.x;
  const int tid = threadIdx.x;
  const int H = ((alen - 1) >> 5) + 1;   // halo words past the tile
  const int NW = W + H;
  const int w0 = blockIdx.x * W;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(r0 + rows_per_block, B);
  const bool halo = tid < H;
  // a tile that reaches the row's end has only zero bytes in its halo
  const bool tail = (w0 + W) * 32 >= L;
  const bool load_halo = halo && !tail;

  uint32_t w[8], h[8];
  load_word(bases + static_cast<int64_t>(r0) * L, L, w0 + tid, w);
  if (load_halo) load_word(bases + static_cast<int64_t>(r0) * L, L,
                           w0 + W + tid, h);

  // ---- while the loads are in flight, warp 0 gives each distinct adapter
  // byte a plane slot, in order of first appearance, 32 positions at a
  // time: a byte seen in an earlier chunk keeps its slot; the new ones are
  // grouped by __match_any_sync and numbered by their first lane
  if (tid < 32) {
    int nd = 0;
    for (int i0 = 0; i0 < alen; i0 += 32) {
      const int i = i0 + tid;
      const bool in = i < alen;
      const int c = in ? __ldg(adapter + i) : 256 + tid;   // unmatched
      int slot = -1;
      for (int d = 0; d < nd; ++d)
        if (s_dist[d] == c) slot = d;
      const int lead = __ffs(__match_any_sync(kFull, c)) - 1;
      const unsigned fresh = __ballot_sync(kFull, in && slot < 0 &&
                                                      lead == tid);
      if (slot < 0) {
        slot = nd + __popc(fresh & ((1u << lead) - 1u));
        if (in && lead == tid) s_dist[slot] = static_cast<uint8_t>(c);
      }
      if (in) {
        s_off[i] = 4 * ((slot % kGroup) * NW + (i >> 5));
        s_grp[i] = static_cast<uint8_t>(slot / kGroup);
      }
      nd += __popc(fresh);
      __syncwarp();
    }
    if (tid == 0) s_ndist = nd;
  }
  __syncthreads();
  const int ndist = s_ndist;
  const int ngroups = (ndist + kGroup - 1) / kGroup;
  const int word = w0 + tid;            // this thread's output word
  const bool live = word * 32 < L;

  for (int row = r0; row < r1; ++row) {
    const uint8_t* src = bases + static_cast<int64_t>(row) * L;
    // the next row's words are in flight while this row is counted
    uint32_t wn[8], hn[8];
    if (row + 1 < r1) {
      load_word(src + L, L, w0 + tid, wn);
      if (load_halo) load_word(src + L, L, w0 + W + tid, hn);
    }
    uint32_t C[NLEV];
#pragma unroll
    for (int k = 0; k < NLEV; ++k) C[k] = 0u;
    for (int g = 0; g < ngroups; ++g) {
      if (g > 0) {   // a row's registers are not kept across the counting
        __syncthreads();   // the previous pass is done with the planes
        load_word(src, L, w0 + tid, w);
        if (load_halo) load_word(src, L, w0 + W + tid, h);
      }
      split_even_odd(w);
      if (load_halo) split_even_odd(h);
      const int nd = min(kGroup, ndist - g * kGroup);
      for (int d = 0; d < nd; ++d) {
        const uint32_t c = s_dist[g * kGroup + d];
        s_plane[d * NW + tid] = mismatch_bits(w, c * 0x01010101u);
        if (halo)
          s_plane[d * NW + W + tid] =
              tail ? (c != 0 ? 0xFFFFFFFFu : 0u)
                   : mismatch_bits(h, c * 0x01010101u);
      }
      __syncthreads();
      if (live) {
        if (ngroups == 1) {
          count_all<NLEV>(C, s_plane + tid, s_off, alen);
        } else {
          for (int i = 0; i < alen; ++i) {
            if (s_grp[i] != g) continue;
            const uint32_t* p = at(s_plane + tid, s_off[i]);
            ripple(C, 0, __funnelshift_r(p[0], p[1], i & 31));
          }
        }
      }
    }

    // ---- counter planes -> one byte per position
    if (live) {
      uint32_t o[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t acc = 0u;
#pragma unroll
        for (int k = 0; k < NLEV; ++k) {
          const uint32_t nib = (C[k] >> (4 * q)) & 0xFu;
          acc |= ((nib * 0x00204081u) & 0x01010101u) << k;
        }
        o[q] = acc;
      }
      uint8_t* dst = out + static_cast<int64_t>(row) * L + word * 32;
      if (word * 32 + 32 <= L &&
          (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
      } else {
        for (int q = 0; q < 32 && word * 32 + q < L; ++q)
          dst[q] = static_cast<uint8_t>(o[q >> 2] >> (8 * (q & 3)));
      }
    }
    __syncthreads();   // the next row rewrites the planes
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      w[q] = wn[q];
      h[q] = hn[q];
    }
  }
}

// ---- int32 output (alen > 255): the compare loop
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

__global__ void mismatch_loop_kernel(const uint8_t* __restrict__ bases,
                                     int L,
                                     const uint8_t* __restrict__ adapter,
                                     int alen, int32_t* __restrict__ out) {
  extern __shared__ uint8_t smem[];
  uint8_t* s_ad = smem;
  uint8_t* s_row = smem + alen;
  const int64_t row = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const uint8_t* src = bases + row * L;
  for (int i = threadIdx.x; i < alen; i += kThreads) s_ad[i] = adapter[i];
  const int span = kTile + alen - 1;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const int p = p0 + i;
    s_row[i] = p < L ? src[p] : 0;
  }
  __syncthreads();

  int acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0;
  for (int i = 0; i < alen; ++i) {
    const uint8_t a = s_ad[i];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      acc[k] += s_row[k * kThreads + threadIdx.x + i] != a;
  }
  int32_t* dst = out + row * L;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int p = p0 + k * kThreads + threadIdx.x;
    if (p < L) dst[p] = acc[k];
  }
}

// rows per block: enough blocks for one wave over the card's SMs, each
// block then streams its rows, loading the next while it counts one.  The
// SM count is kept per device (the launch's device is the current one,
// ops/cuda_lib.py:launch), so cards of different types each get theirs
constexpr int kMaxDevices = 64;

int rows_per_block(int blocks_per_row, int B) {
  static int sms_of[kMaxDevices] = {};
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices) {
    if (sms_of[dev] == 0 &&
        cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      sms_of[dev] = 132;
    sms = sms_of[dev];
  }
  const long slots = static_cast<long>(sms) * kBlocksPerSM;
  const long need = static_cast<long>(blocks_per_row) * B;
  return static_cast<int>(std::max(1L, (need + slots - 1) / slots));
}

template <int NLEV>
void launch_bits(const uint8_t* b, int B, int L, const uint8_t* a, int alen,
                 uint8_t* out, cudaStream_t s) {
  const int words = (L + 31) / 32;
  const int W = std::min(kMaxWords, (words + 31) / 32 * 32);
  const int NW = W + ((alen - 1) >> 5) + 1;
  const size_t smem = static_cast<size_t>(NW) * kGroup * 4;
  const int tiles = (words + W - 1) / W;
  const int rows = rows_per_block(tiles, B);
  const dim3 grid(tiles, (B + rows - 1) / rows);
  mismatch_bits_kernel<NLEV><<<grid, W, smem, s>>>(b, B, L, a, alen, rows,
                                                   out);
}

}  // namespace

extern "C" int fpl_mismatch_scan(const void* bases, int B, int L,
                                 const void* adapter, int alen, void* out,
                                 int out_u8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bases);
  const uint8_t* a = static_cast<const uint8_t*>(adapter);
  if (alen <= 0 || B <= 0 || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_u8) {
    if (alen > 255) return static_cast<int>(cudaErrorInvalidValue);
    uint8_t* o = static_cast<uint8_t*>(out);
    const int nlev = 32 - __builtin_clz(static_cast<unsigned>(alen));
    switch (nlev) {
#define FPL_BITS_CASE(n) \
  case n:                \
    launch_bits<n>(b, B, L, a, alen, o, s); \
    break;
      FPL_BITS_CASE(1) FPL_BITS_CASE(2) FPL_BITS_CASE(3) FPL_BITS_CASE(4)
      FPL_BITS_CASE(5) FPL_BITS_CASE(6) FPL_BITS_CASE(7) FPL_BITS_CASE(8)
#undef FPL_BITS_CASE
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    const dim3 grid((L + kTile - 1) / kTile, B);
    const size_t smem = 2 * static_cast<size_t>(alen) + kTile;
    mismatch_loop_kernel<<<grid, kThreads, smem, s>>>(
        b, L, a, alen, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
