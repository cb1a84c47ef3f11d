// Adapter mismatch scan: mm[b, p] = #{i < alen : row[p + i] != adapter[i]},
// where positions past the row length L compare against a zero byte.
//
// Replaces the Pallas kernel fastplong_tpu/ops/pallas_kernels.py
// (_mismatch_pallas, body _kernel) and its XLA twin
// fastplong_tpu/ops/adapter.py:_mismatch_full, whose contract it keeps:
// uint8 output when alen <= 255, int32 above.
//
// Bound on an H100: every input byte is read once and every output byte
// written once, so the floor is the bytes (2 B per position at uint8 out,
// 5 B at int32 out) up to about 1,000 bp, and the alen byte compares per
// position at the int8 peak above.  A compare loop costs three
// instructions per adapter byte per output and is bound by instruction
// issue.  So one kernel, for both output types, counts bit-parallel, 32
// positions to a 32-bit word:
//
//   * slots: while the first row's loads are in flight, every warp marks
//     the bytes of its 32-position chunks of the adapter in a 256-bit set
//     (one shared atomic per distinct byte of a chunk); a byte's plane slot
//     is its rank in the set, and every thread fills a share of the
//     positions' tables: the offset of its plane word (4 B) and its plane
//     pass (1 B);
//   * loads: a block owns a tile of W words of 32 positions of one row;
//     the thread of word t loads it into registers as two 16-byte loads
//     (bytes past L become 0).  The H = (alen - 1) / 32 + 1 halo words past
//     the tile are loaded by threads k, k + W, ... (more than one word each
//     only above 8,192 bp), unless the tile reaches the row's end (as every
//     tile of the main path's [*, 8192] rows does): its halo is zero bytes,
//     whose planes are constants;
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
//   * counting: for adapter position i the mismatch bits of a word's 32
//     outputs are the plane of adapter[i] shifted by i (__funnelshift_r over
//     two plane words); a bit-sliced counter of NLEV levels, NLEV the bit
//     length of alen (1-8 for uint8 output, 9-15 for int32), adds them
//     eight at a time through a carry-save tree (seven adders of two
//     operations each).  Over whole 32-position chunks the shifts are
//     constants and the level-3 carries of two groups of eight meet in one
//     more adder before a carry ripples up from level 4; the rest go eight
//     at a time (a ripple from level 3), then one at a time.  One thread
//     counts a word at either output type.  The count's two 4-byte plane
//     loads per position and word (about 31 cycles of an SM's shared-memory
//     bandwidth per adapter position at [256, 8192]) are what bounds it;
//     loading each distinct byte's pair once per 32 positions would cut
//     them;
//   * output: the counter planes are spread to bytes four positions at a
//     time (a multiply puts four bits into four bytes), levels 0-7 into one
//     word and 8-14 into another.  At uint8 a thread stores its 32 bytes
//     as two 16-byte stores; at int32 one byte permute a position joins the
//     two bytes into its count and the thread stores its 32 counts as eight
//     16-byte stores (neighbouring threads, neighbouring 128-byte runs).
//
// Shared memory, dynamic, per block: the planes, kGroup x (W + H) words,
// and the positions' tables, 5 B each.  With W = 256 that is 8.2 KiB at
// 28 bp, 12.1 KiB at 700 bp, 19.7 KiB at 2,000 bp and 200 KiB at the
// longest adapter taken, 32,767 bp (NLEV = 15); above 48 KiB the launch
// raises the instance's limit first (once per device), and fewer blocks
// then sit on an SM.  Indices are int: positions up to L + 32 (W + H) must
// fit (the wrapper checks).
//
// Streaming: with one row per block every block of the single wave would
// load, count and store in lockstep, leaving the memory idle while the SMs
// count.  So four blocks of 256 threads sit on each SM (__launch_bounds__
// for every instance, so each gets at most 64 registers; `-Xptxas -v`
// reports 63-64 and no spill for all fifteen), a block scans its tile of
// enough rows for one wave of the blocks an SM holds (two rows at [1024,
// 8192] on 132 SMs; the count is asked of the occupancy API once per
// instance, device and shared-memory size), and it loads the next row's
// words while it counts one.

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWords = 256;   // words (threads) per block
constexpr int kGroup = 8;        // distinct adapter bytes per plane pass
constexpr int kBlocksPerSM = 4;  // resident blocks of kMaxWords threads
constexpr int kMaxLevels = 15;   // counter depth of the longest adapter
constexpr int kDefaultSmem = 48 * 1024;   // dynamic shared memory unasked

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

// the planes of the 32 bytes of one word for the nd distinct bytes
// dist[0 .. nd), stored nw words apart from plane
__device__ __forceinline__ void store_planes(uint32_t (&w)[8],
                                             const uint8_t* dist, int nd,
                                             uint32_t* plane, int nw) {
  split_even_odd(w);
  for (int d = 0; d < nd; ++d)
    plane[d * nw] = mismatch_bits(w, dist[d] * 0x01010101u);
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

// the number of bytes below c in the 256-bit set `seen`
__device__ __forceinline__ int byte_rank(const uint32_t* seen, int c) {
  int r = c < 256 ? __popc(seen[c >> 5] & ((1u << (c & 31)) - 1u)) : 0;
  for (int j = 0; j < (c >> 5); ++j) r += __popc(seen[j]);
  return r;
}

// the plane word pair of adapter position i: s_off holds byte offsets
__device__ __forceinline__ const uint32_t* at(const uint32_t* planes,
                                              int off) {
  return reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(planes) + off);
}

// adds the mismatch bits of adapter positions i .. i + 7, shifted by s0 ..
// s0 + 7 (s0 = i % 32), to levels 0-2 of the counter C through a
// carry-save tree (seven adders, two operations each); returns the carry
// into level 3.  The bits of position i are the plane word pair
// at(planes, s_off[i]), shifted by i.
template <int NLEV>
__device__ __forceinline__ uint32_t add8(uint32_t (&C)[NLEV],
                                         const uint32_t* planes,
                                         const int* s_off, int i, int s0) {
  const int4 o0 = *reinterpret_cast<const int4*>(s_off + i);
  const int4 o1 = *reinterpret_cast<const int4*>(s_off + i + 4);
  const int off[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
  uint32_t x[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const uint32_t* p = at(planes, off[u]);
    x[u] = __funnelshift_r(p[0], p[1], s0 + u);
  }
  const uint32_t c1a = csa(C[0], x[0], x[1]);
  const uint32_t c1b = csa(C[0], x[2], x[3]);
  const uint32_t c1c = csa(C[0], x[4], x[5]);
  const uint32_t c1d = csa(C[0], x[6], x[7]);
  const uint32_t c2a = csa(C[1], c1a, c1b);
  const uint32_t c2b = csa(C[1], c1c, c1d);
  return csa(C[2], c2a, c2b);
}

// adds the mismatch bits of adapter positions 0 .. alen - 1 to the
// counter C.  Over whole 32-position chunks the shifts are constants and
// the level-3 carries of two groups of eight meet in one more adder before
// a carry ripples up from level 4; then groups of eight (a ripple from
// level 3), then single positions.
template <int NLEV>
__device__ __forceinline__ void count_all(uint32_t (&C)[NLEV],
                                          const uint32_t* planes,
                                          const int* s_off, int alen) {
  int i = 0;
  if constexpr (NLEV >= 6) {
    for (; i + 32 <= alen; i += 32) {
#pragma unroll
      for (int h = 0; h < 32; h += 16) {
        const uint32_t c3a = add8(C, planes, s_off, i + h, h);
        const uint32_t c3b = add8(C, planes, s_off, i + h + 8, h + 8);
        ripple(C, 4, csa(C[3], c3a, c3b));
      }
    }
  }
  if constexpr (NLEV >= 4) {
    for (; i + 8 <= alen; i += 8)
      ripple(C, 3, add8(C, planes, s_off, i, i & 31));
  }
  for (; i < alen; ++i) {
    const uint32_t* p = at(planes, s_off[i]);
    ripple(C, 0, __funnelshift_r(p[0], p[1], i & 31));
  }
}

// bits K0 .. K0 + 7 (those below NLEV) of the counts of positions 4q ..
// 4q + 3, one byte each
template <int K0, int NLEV>
__device__ __forceinline__ uint32_t spread4(const uint32_t (&C)[NLEV],
                                            int q) {
  uint32_t acc = 0u;
#pragma unroll
  for (int k = K0; k < NLEV && k < K0 + 8; ++k) {
    const uint32_t nib = (C[k] >> (4 * q)) & 0xFu;
    acc |= ((nib * 0x00204081u) & 0x01010101u) << (k - K0);
  }
  return acc;
}

// the counts of the counter C's 32 positions into dst[0 .. n)
template <int NLEV>
__device__ __forceinline__ void store_counts(const uint32_t (&C)[NLEV],
                                             uint8_t* dst, int n) {
  uint32_t o[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) o[q] = spread4<0>(C, q);
  if (n == 32 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
  } else {
#pragma unroll
    for (int q = 0; q < 32; ++q)
      if (q < n) dst[q] = static_cast<uint8_t>(o[q >> 2] >> (8 * (q & 3)));
  }
}

template <int NLEV>
__device__ __forceinline__ void store_counts(const uint32_t (&C)[NLEV],
                                             int32_t* dst, int n) {
  const bool vec = n == 32 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t lo = spread4<0>(C, q), hi = spread4<8>(C, q);
    uint32_t v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)   // byte m of lo, then byte m of hi
      v[m] = __byte_perm(lo, hi, 0x40 + 0x11 * m) & 0xFFFFu;
    if (vec) {
      reinterpret_cast<uint4*>(dst)[q] = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (4 * q + m < n) dst[4 * q + m] = static_cast<int32_t>(v[m]);
    }
  }
}

// T: the output type, uint8_t (alen <= 255) or int32_t; NLEV: bit length
// of alen (the counter's depth).  Block (x, y) scans tile x, of blockDim.x
// words, of rows [y * rows_per_block, ...).
template <typename T, int NLEV>
__global__ void __launch_bounds__(kMaxWords, kBlocksPerSM)
    mismatch_bits_kernel(const uint8_t* __restrict__ bases, int B, int L,
                         const uint8_t* __restrict__ adapter, int alen,
                         int rows_per_block, T* __restrict__ out) {
  static_assert(NLEV <= (sizeof(T) == 1 ? 8 : kMaxLevels), "counter depth");
  __shared__ uint8_t s_dist[256];    // distinct adapter bytes, in order
  __shared__ uint32_t s_seen[8];     // the set of adapter bytes
  extern __shared__ __align__(16) uint32_t s_plane[];   // [kGroup][NW]
  const int W = blockDim.x;
  const int tid = threadIdx.x;
  const int H = ((alen - 1) >> 5) + 1;   // halo words past the tile
  const int NW = W + H;
  // after the planes: each adapter position's plane word, in bytes, and
  // its plane pass
  int* s_off = reinterpret_cast<int*>(s_plane + kGroup * NW);
  uint8_t* s_grp = reinterpret_cast<uint8_t*>(s_off + alen);
  const int w0 = blockIdx.x * W;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(r0 + rows_per_block, B);
  // a tile that reaches the row's end has only zero bytes in its halo
  const bool tail = (w0 + W) * 32 >= L;

  uint32_t w[8];
  load_word(bases + static_cast<int64_t>(r0) * L, L, w0 + tid, w);

  // ---- while the loads are in flight, every warp marks the bytes of its
  // 32-position chunks of the adapter in a 256-bit set (one shared atomic
  // per distinct byte of a chunk, by its first lane); a byte's plane slot
  // is its rank in the set, so that every thread can fill the tables of a
  // share of the positions
  if (tid < 8) s_seen[tid] = 0u;
  __syncthreads();
  const int lane = tid & 31;
  for (int i0 = tid - lane; i0 < alen; i0 += W) {
    const bool in = i0 + lane < alen;
    const int c = in ? __ldg(adapter + i0 + lane) : 256;
    const unsigned same = __match_any_sync(kFull, c);
    if (in && lane == __ffs(same) - 1)
      atomicOr(&s_seen[c >> 5], 1u << (c & 31));
  }
  __syncthreads();
  for (int i = tid; i < alen; i += W) {
    const int slot = byte_rank(s_seen, __ldg(adapter + i));
    s_off[i] = 4 * ((slot % kGroup) * NW + (i >> 5));
    s_grp[i] = static_cast<uint8_t>(slot / kGroup);
  }
  for (int c = tid; c < 256; c += W)
    if ((s_seen[c >> 5] >> (c & 31)) & 1u)
      s_dist[byte_rank(s_seen, c)] = static_cast<uint8_t>(c);
  const int ndist = byte_rank(s_seen, 256);
  __syncthreads();
  const int ngroups = (ndist + kGroup - 1) / kGroup;
  const int word = w0 + tid;            // this thread's output word
  const bool live = word * 32 < L;

  for (int row = r0; row < r1; ++row) {
    const uint8_t* src = bases + static_cast<int64_t>(row) * L;
    // the next row's words are in flight while this row is counted
    uint32_t wn[8];
    if (row + 1 < r1) load_word(src + L, L, w0 + tid, wn);
    uint32_t C[NLEV];
#pragma unroll
    for (int k = 0; k < NLEV; ++k) C[k] = 0u;
    for (int g = 0; g < ngroups; ++g) {
      if (g > 0) {   // a row's registers are not kept across the counting
        __syncthreads();   // the previous pass is done with the planes
        load_word(src, L, w0 + tid, w);
      }
      const int nd = min(kGroup, ndist - g * kGroup);
      const uint8_t* dist = s_dist + g * kGroup;
      store_planes(w, dist, nd, s_plane + tid, NW);
      for (int k = tid; k < H; k += W) {
        if (tail) {
          for (int d = 0; d < nd; ++d)
            s_plane[d * NW + W + k] = dist[d] != 0 ? 0xFFFFFFFFu : 0u;
        } else {
          uint32_t h[8];
          load_word(src, L, w0 + W + k, h);
          store_planes(h, dist, nd, s_plane + W + k, NW);
        }
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
    if (live)
      store_counts(C, out + static_cast<int64_t>(row) * L + word * 32,
                   min(32, L - word * 32));
    __syncthreads();   // the next row rewrites the planes
#pragma unroll
    for (int q = 0; q < 8; ++q) w[q] = wn[q];
  }
}

// the SM count of the current device (the launch's, ops/cuda_lib.py:launch),
// kept per device so that cards of different types each get theirs
constexpr int kMaxDevices = 64;

int sm_count() {
  static int sms_of[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 132;
  if (sms_of[dev] == 0 &&
      cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms_of[dev] = 132;
  return sms_of[dev];
}

// The blocks of instance `kernel` an SM holds at `smem` bytes of dynamic
// shared memory on the current device, the instance's shared-memory limit
// raised first where it needs more than 48 KiB.  Both answers are fixed for
// an instance, a device and a size, so each is asked once and kept (T and
// NLEV give each instance its own store).
template <typename T, int NLEV>
cudaError_t blocks_per_sm(const void* kernel, int threads, size_t smem,
                          int* per_sm) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> known;   // (device, smem)
  static int raised[kMaxDevices] = {};                  // limit set, bytes
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find({dev, smem});
  if (it != known.end()) {
    *per_sm = it->second;
    return cudaSuccess;
  }
  if (smem > kDefaultSmem && (dev >= kMaxDevices ||
                              raised[dev] < static_cast<int>(smem))) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) raised[dev] = static_cast<int>(smem);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads,
                                                    smem);
  if (e == cudaSuccess) known[{dev, smem}] = *per_sm;
  return e;
}

// Tiles of up to 256 words, and rows per block: enough blocks for one
// wave of the blocks an SM holds, each streaming its rows.
template <typename T, int NLEV>
cudaError_t launch_bits(const uint8_t* b, int B, int L, const uint8_t* a,
                        int alen, T* out, cudaStream_t s) {
  const int words = (L - 1) / 32 + 1;
  const int W = std::min(kMaxWords, (words + 31) / 32 * 32);
  const int NW = W + ((alen - 1) >> 5) + 1;
  const size_t smem = static_cast<size_t>(NW) * kGroup * 4 +
                      static_cast<size_t>(alen) * (sizeof(int) + 1);
  auto* kernel = mismatch_bits_kernel<T, NLEV>;
  int per_sm = 1;
  const cudaError_t e = blocks_per_sm<T, NLEV>(
      reinterpret_cast<const void*>(kernel), W, smem, &per_sm);
  if (e != cudaSuccess) return e;
  const int tiles = (words + W - 1) / W;
  const long slots = static_cast<long>(sm_count()) * std::max(1, per_sm);
  const long need = static_cast<long>(tiles) * B;
  const int rows = static_cast<int>(std::max(1L, (need + slots - 1) / slots));
  const dim3 grid(tiles, (B + rows - 1) / rows);
  kernel<<<grid, W, smem, s>>>(b, B, L, a, alen, rows, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fpl_mismatch_scan(const void* bases, int B, int L,
                                 const void* adapter, int alen, void* out,
                                 int out_u8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bases);
  const uint8_t* a = static_cast<const uint8_t*>(adapter);
  if (alen <= 0 || B <= 0 || L <= 0 || (alen <= 255) != (out_u8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nlev = 32 - __builtin_clz(static_cast<unsigned>(alen));
  uint8_t* o8 = static_cast<uint8_t*>(out);
  int32_t* o32 = static_cast<int32_t*>(out);
  cudaError_t e = cudaErrorInvalidValue;
  switch (nlev) {
#define FPL_U8(n) \
  case n:         \
    e = launch_bits<uint8_t, n>(b, B, L, a, alen, o8, s); \
    break;
#define FPL_I32(n) \
  case n:          \
    e = launch_bits<int32_t, n>(b, B, L, a, alen, o32, s); \
    break;
    FPL_U8(1) FPL_U8(2) FPL_U8(3) FPL_U8(4)
    FPL_U8(5) FPL_U8(6) FPL_U8(7) FPL_U8(8)
    FPL_I32(9) FPL_I32(10) FPL_I32(11) FPL_I32(12)
    FPL_I32(13) FPL_I32(14) FPL_I32(15)
#undef FPL_U8
#undef FPL_I32
    default:
      break;
  }
  return static_cast<int>(e);
}
