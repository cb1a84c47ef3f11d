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
// and over the words.  At the path's batches (12-97 lanes) most SMs idle,
// and a launch takes one lane's chain: steps times the latency of a step.
// A step's instructions go out in order from one SM sub-partition, so
// what it costs is the dependences of its eight columns (about 7
// dependent operations a column) plus whatever else the warp must run
// around them.
//
// Design.  A lane's words go in slabs of 32, one slab a warp, thread t of
// slab s holding word 32 s + t, all slabs of a lane on concurrent warps
// (at most kMaxWarps; beyond, slab s runs on warp s % W after slab s - W).
// Each warp runs the wavefront of myers_verify.cu over its slab: at step m
// thread t updates its word over the eight columns 8 (m - t) .. 8 (m - t)
// + 7, taking the hp/hn carries of the word below at those columns from
// thread t - 1 by one __shfl_up_sync a step.  Thread 31 hands its carries
// (eight columns in 16 bits) to thread 0 of the next slab's warp through a
// ring of kCarryRing entries in shared memory, each entry one 32-bit word
// tagged with its sequence number, so that no fence is needed: the whole
// consumer warp waits for the tag together (a broadcast load, no
// divergence), and the producer warp waits for room once every 32 steps,
// for all of their entries, on the consumer's count (published every
// kConsumed entries).  The carries from the last warp of one round of
// slabs to the first warp of the next take a row of ceil(T / 8) entries
// instead, which never waits for room, so no ring of waits can close.  A
// lane so takes about T / 8 + top steps, not (top / 32 + 1) (T / 8 + 31).
//
// A step is straight-line code, so that the compiler can fill the
// columns' dependence gaps with the step's other work (the next step's
// text and masks, the shuffle): every thread runs every step, a thread
// sets its word's starting state at its first column, and the steps from
// the first text end on keep VP and VN of columns past the text
// (kGuard).  The carries in from, and out to, another warp are compiled
// only into the slabs that have one.  Each warp streams its lane's text
// through a ring of 1,024 bytes in shared memory (four chunks of 256
// columns, a chunk loaded from global memory 32 steps before it is stored
// and 32 more before it is read, at the start of each 32 steps), so a
// step's eight columns are one 8-byte shared load; a mask is read through
// L1 from the table (one byte permute and one wide multiply-add for its
// address), a step ahead.  Only words up to the lane's top word
// (plen - 1) / 32 are computed: a word feeds only the words above it.  The
// distance is read once, from the last column's vertical deltas: D = cols
// + sum over the words of popc(VP) - popc(VN) below plen, so the steps
// keep no score bits.

#include <cstdint>
#include <mutex>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kAhead = 8;               // columns per wavefront step
constexpr int kMaxWarps = 32;           // warps a lane takes at most
constexpr int kBlockWarps = 8;          // warps a block of several lanes holds
// threads a block holds at most: one lane of kMaxWarps warps, or lanes of
// fewer warps up to kBlockWarps
constexpr int kMaxThreads =
    32 * (kMaxWarps > kBlockWarps ? kMaxWarps : kBlockWarps);
constexpr int kChunk = 32 * kAhead;     // text columns staged at a time
constexpr int kRing = 4 * kChunk;       // a warp's text ring, in bytes
constexpr int kCarryRing = 128;         // carry entries between two warps
constexpr int kConsumed = 16;           // a consumer publishes every 16
constexpr uint32_t kNoTag = 0xFFFF0000u;   // an entry no step waits for
// a producer waits at the start of 32 steps for room for their entries,
// while its consumer may have read only the entries before them, and
// published that only to the last multiple of kConsumed
static_assert(kCarryRing > 2 * 32 + kConsumed, "carry ring too small");
constexpr int kMaxSmem = 227 * 1024;    // shared memory a block may have
constexpr int kDefaultSmem = 48 * 1024;

// Shared memory of a block of L lanes of W warps: each warp's text ring,
// the carry rings (ring b of a lane feeds its warp b; ring 0 is unused
// with one round), the rows between rounds, the consumers' counts and
// the per-lane sums.
struct Layout {
  int row, text, carry, wrap, read, acc, bytes;
};

__host__ __device__ inline Layout layout(int T, int W, int L, int rounds) {
  Layout s{};
  s.row = rounds > 1 ? (T + kAhead - 1) / kAhead : 0;
  int o = 0;
  s.text = o;
  o += W * L * kRing;
  s.carry = o;
  o += W * L * kCarryRing * 4;
  s.wrap = o;
  o += L * s.row * 4;
  s.read = o;
  o += L * W * 4;
  s.acc = o;
  o += L * 4;
  s.bytes = o;
  return s;
}

__device__ __forceinline__ uint32_t low_bits(int bits) {
  bits = bits < 0 ? 0 : bits;
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

// The carries between warps: one 32-bit word an entry, its sequence number
// in the high half and the carries in the low, so that an entry is read
// once its own tag is there and no fence orders two words.  A consumer's
// count of entries read is the only other word (room for the producer).
__device__ __forceinline__ uint32_t load_shared(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

__device__ __forceinline__ void store_shared(uint32_t* p, uint32_t v) {
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

// One lane's view of the block: what its warps share.
struct Lane {
  const uint8_t* row;        // text[n]
  const uint32_t* pm;        // the table
  int T, K, plen, cols, top, ne, W;
  uint32_t* carry;           // this lane's W carry rings
  uint32_t* wrap;            // its row between rounds
  uint32_t* read;            // entries read from each ring
};

// the 8 bytes of columns c0 .. c0 + 7 in the text ring
__device__ __forceinline__ uint2 bytes_at(const uint8_t* ring, int c0) {
  return *reinterpret_cast<const uint2*>(ring + (c0 & (kRing - 1)));
}

// byte u (0-7) of a step's eight, as an integer
__device__ __forceinline__ uint32_t byte_of(uint2 b, int u) {
  return __byte_perm(u < 4 ? b.x : b.y, 0u, 0x4440u | (u & 3));
}

// eight bytes of the text from column c (bytes past the row repeat its
// last byte)
__device__ __forceinline__ uint2 load_text(const Lane& ln, int c) {
  uint32_t v[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = min(c + i, ln.T - 1);
    v[i >> 2] |= static_cast<uint32_t>(__ldg(ln.row + j)) << (8 * (i & 3));
  }
  return make_uint2(v[0], v[1]);
}

// Eight columns of one word.  in: the word below's hp (bits 0-7) and hn
// (bits 8-15) carries, bit 7 - u for column u; returns this word's in the
// same form.  kGuard: keep VP and VN of the columns from nv on.
template <bool kGuard>
__device__ __forceinline__ uint32_t columns(const uint32_t (&eq)[kAhead],
                                            uint32_t in, uint32_t& VP,
                                            uint32_t& VN, int nv) {
  const uint32_t hp_bits = in & 0xFFu;
  const uint32_t hn_bits = (in >> kAhead) & 0xFFu;
  uint32_t hp_acc = 0u, hn_acc = 0u;
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    // bit 31: the carry at column c0 + u
    const uint32_t hp_src = hp_bits << (24 + u);
    const uint32_t hn_src = hn_bits << (24 + u);
    const uint32_t X = eq[u] | (hn_src >> 31);
    const uint32_t D0 = (((X & VP) + VP) ^ VP) | X | VN;
    const uint32_t HP = VN | ~(D0 | VP);
    const uint32_t HN = D0 & VP;
    const uint32_t X2 = __funnelshift_l(hp_src, HP, 1);
    const uint32_t vp = __funnelshift_l(hn_src, HN, 1) | ~(D0 | X2);
    const uint32_t vn = D0 & X2;
    if (!kGuard || u < nv) {
      VP = vp;
      VN = vn;
    }
    hp_acc = __funnelshift_l(HP, hp_acc, 1);
    hn_acc = __funnelshift_l(HN, hn_acc, 1);
  }
  return hp_acc | (hn_acc << kAhead);
}

// Slab s of a lane (words 32 s .. 32 s + 31) on warp w, in round s / W;
// kTakes: s > 0 (its carries come from another warp), kGives: a slab
// above it exists.  Returns this thread's popc(VP) - popc(VN) below plen
// at the last column.
template <bool kTakes, bool kGives>
__device__ int run_slab(const Lane& ln, int s, int w, uint8_t* ring,
                        int lane) {
  const int round = s / ln.W;
  const int r = 32 * s + lane;               // this thread's word
  // the mask of byte b for word r: one wide multiply-add from the byte
  const uint64_t mrow = reinterpret_cast<uint64_t>(ln.pm + min(r, ln.K - 1));
  const uint32_t stride = 4u * ln.K;
  auto mask = [&](uint32_t b) {
    return __ldg(reinterpret_cast<const uint32_t*>(
        mrow + static_cast<uint64_t>(b) * stride));
  };
  // carry-in: ring w, or the row between rounds into warp 0
  const uint32_t* in_ring = w == 0 ? ln.wrap : ln.carry + w * kCarryRing;
  const int in_base = (w == 0 ? round - 1 : round) * ln.ne;
  // carry-out: ring w + 1, or the row when this warp ends a round
  const int wo = w + 1 == ln.W ? 0 : w + 1;
  uint32_t* out_ring = wo == 0 ? ln.wrap : ln.carry + wo * kCarryRing;
  const int out_base = round * ln.ne;

  // the text ring: chunk 0 now, chunk 1 in registers, slot 3 (read by the
  // threads still before column 0) set to zero bytes
  *reinterpret_cast<uint2*>(ring + 8 * lane) = load_text(ln, 8 * lane);
  *reinterpret_cast<uint2*>(ring + 3 * kChunk + 8 * lane) = make_uint2(0, 0);
  uint2 pending = load_text(ln, kChunk + 8 * lane);
  __syncwarp();

  const uint32_t VP0 = low_bits(ln.plen - 32 * r);
  uint32_t VP = VP0, VN = 0u, carries = 0u;
  // one step: columns 8 (m - lane) .. + 7 with the masks in cur, while the
  // next step's masks go to nxt
  auto step = [&](int m, const uint32_t (&cur)[kAhead],
                  uint32_t (&nxt)[kAhead], auto guard) {
    const int c0 = kAhead * (m - lane);       // this step's first column
    const uint2 b = bytes_at(ring, c0 + kAhead);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) nxt[u] = mask(byte_of(b, u));
    uint32_t in = __shfl_up_sync(kFull, carries, 1);
    if (lane == 0) in = 0xFFu;                 // word 0: hp 1, hn 0
    if (kTakes && m < ln.ne) {
      // thread 0's carries at columns 8 m ..: every thread waits for the
      // entry together (one broadcast load a try, no divergence)
      const int seq = in_base + m;
      const uint32_t* e = in_ring + (w == 0 ? m : seq & (kCarryRing - 1));
      uint32_t v;
      while (((v = load_shared(e)) >> 16) != (seq & 0xFFFFu)) {
      }
      if (lane == 0) in = v & 0xFFFFu;
      if (w != 0 && lane == 0 && ((m + 1) % kConsumed == 0 || m + 1 == ln.ne))
        store_shared(ln.read + w, seq + 1);
    }
    if (c0 == 0) {                             // this word's first column
      VP = VP0;
      VN = 0u;
    }
    carries = columns<decltype(guard)::value>(cur, in, VP, VN,
                                              ln.cols - c0);
    if (kGives && lane == 31 &&
        static_cast<unsigned>(c0) < static_cast<unsigned>(ln.cols)) {
      const int seq = out_base + c0 / kAhead;
      store_shared(out_ring + (wo == 0 ? c0 / kAhead
                                       : seq & (kCarryRing - 1)),
                   (static_cast<uint32_t>(seq) << 16) | carries);
    }
  };
  // steps in pairs (the masks change registers without copies); from the
  // step at which thread 0 reaches the text's end on, guarded
  const int steps = (ln.ne + min(ln.top - 32 * s, 31) + 1) & ~1;
  const int tail = min((ln.cols / kAhead) & ~1, steps);
  uint32_t ma[kAhead], mb[kAhead];
  {
    const uint2 b = bytes_at(ring, -kAhead * lane);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) ma[u] = mask(byte_of(b, u));
  }
  for (int m0 = 0; m0 < steps; m0 += 32) {
    // chunk q + 1 into the ring (its slot last held chunk q - 3), chunk
    // q + 2 from global memory
    const int q = m0 / 32;
    if (kGives && wo != 0) {
      // room in ring wo for this chunk's entries (up to out_base + m0):
      // every thread waits together
      while (static_cast<int>(load_shared(ln.read + wo)) + kCarryRing <=
             out_base + m0) {
      }
    }
    *reinterpret_cast<uint2*>(
        ring + (((q + 1) * kChunk + 8 * lane) & (kRing - 1))) = pending;
    pending = load_text(ln, (q + 2) * kChunk + 8 * lane);
    __syncwarp();
    const int m1 = min(m0 + 32, steps);
    const int mid = max(min(tail, m1), m0);
    for (int m = m0; m < mid; m += 2) {
      step(m, ma, mb, std::false_type());
      step(m + 1, mb, ma, std::false_type());
    }
    for (int m = mid; m < m1; m += 2) {
      step(m, ma, mb, std::true_type());
      step(m + 1, mb, ma, std::true_type());
    }
  }
  __syncwarp();                                // the ring is reused
  if (r > ln.top) return 0;
  const uint32_t v = low_bits(ln.plen - 32 * r);
  return __popc(VP & v) - __popc(VN & v);
}

__global__ void __launch_bounds__(kMaxThreads)
    myers_blockscan_kernel(const uint8_t* __restrict__ text, int N, int T,
                           const int* __restrict__ plen_in,
                           const int* __restrict__ tlen_in,
                           const uint32_t* __restrict__ pm, int K, int W,
                           int L, int rounds, int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout sl = layout(T, W, L, rounds);
  uint32_t* s_carry = reinterpret_cast<uint32_t*>(smem + sl.carry);
  uint32_t* s_read = reinterpret_cast<uint32_t*>(smem + sl.read);
  int* s_acc = reinterpret_cast<int*>(smem + sl.acc);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * L;
  for (int i = tid; i < W * L * kCarryRing + L * sl.row; i += blockDim.x)
    s_carry[i] = kNoTag;                   // the rings and the rows
  for (int i = tid; i < W * L; i += blockDim.x) s_read[i] = 0u;
  if (tid < L) s_acc[tid] = 0;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int lb = warp / W, w = warp % W;
  const int n = n0 + lb;
  int acc = 0;
  if (n < N) {
    Lane ln;
    ln.plen = __ldg(plen_in + n);
    ln.cols = max(min(__ldg(tlen_in + n), T), 0);
    if (ln.plen > 0 && ln.cols > 0) {
      ln.row = text + static_cast<int64_t>(n) * T;
      ln.pm = pm;
      ln.T = T;
      ln.K = K;
      ln.top = min((ln.plen - 1) / 32, K - 1);
      ln.ne = (ln.cols + kAhead - 1) / kAhead;
      ln.W = W;
      ln.carry = s_carry + lb * W * kCarryRing;
      ln.wrap = reinterpret_cast<uint32_t*>(smem + sl.wrap) + lb * sl.row;
      ln.read = s_read + lb * W;
      uint8_t* ring = smem + sl.text + warp * kRing;
      const int slabs = ln.top / 32 + 1;
      for (int s = w; s < slabs; s += W) {
        if (s == 0)
          acc += slabs > 1 ? run_slab<false, true>(ln, s, w, ring, lane)
                           : run_slab<false, false>(ln, s, w, ring, lane);
        else
          acc += s + 1 < slabs ? run_slab<true, true>(ln, s, w, ring, lane)
                               : run_slab<true, false>(ln, s, w, ring, lane);
      }
    }
  }
  acc = __reduce_add_sync(kFull, acc);
  if (lane == 0 && acc != 0) atomicAdd(s_acc + lb, acc);
  __syncthreads();
  if (tid < L && n0 + tid < N) {
    const int m = n0 + tid;
    const int plen = __ldg(plen_in + m);
    const int tlen = __ldg(tlen_in + m);
    const int cols = max(min(tlen, T), 0);
    out[m] = plen <= 0 ? tlen : cols == 0 ? plen : cols + s_acc[tid];
  }
}

// the SM count of the current device, and the kernel's shared-memory
// limit raised to `smem` where it needs more than 48 KiB
constexpr int kMaxDevices = 64;

cudaError_t device_facts(size_t smem, int* sms) {
  static std::mutex mu;
  static int sms_of[kMaxDevices] = {};
  static int raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (sms_of[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *sms = sms_of[dev];
  if (smem > kDefaultSmem && raised[dev] < static_cast<int>(smem)) {
    e = cudaFuncSetAttribute(myers_blockscan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    raised[dev] = static_cast<int>(smem);
  }
  return cudaSuccess;
}

}  // namespace

// Warps per lane W: one per slab of 32 words up to kMaxWarps (rounds of W
// slabs beyond).  Lanes per block L: enough that the blocks fill the SMs
// once, up to kBlockWarps warps a block.  A block that does not fit in
// shared memory (a row between rounds longer than about 190 KiB: T over
// 380,000 with K over 1,024) is refused.
extern "C" int fpl_myers_blockscan(const void* text, int N, int T,
                                   const void* plen, const void* tlen,
                                   const void* pm, int K, void* out,
                                   void* stream) {
  if (K < 1 || N < 0 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const int slabs = (K + 31) / 32;
  const int W = slabs < kMaxWarps ? slabs : kMaxWarps;
  const int rounds = (slabs + W - 1) / W;
  int sms = 132;
  cudaError_t e = device_facts(0, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  int L = kBlockWarps / W;
  if (L > (N + sms - 1) / sms) L = (N + sms - 1) / sms;
  if (L < 1) L = 1;
  const Layout sl = layout(T, W, L, rounds);
  if (sl.bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  e = device_facts(static_cast<size_t>(sl.bytes), &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  myers_blockscan_kernel<<<(N + L - 1) / L, 32 * W * L, sl.bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), N, T, static_cast<const int*>(plen),
      static_cast<const int*>(tlen), static_cast<const uint32_t*>(pm), K, W,
      L, rounds, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

