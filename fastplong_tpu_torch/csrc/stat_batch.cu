// Per-batch read statistics, added straight into one side of the run's
// int64 accumulator: for every slot row i of an [S, B] stack of spans
// (row i reads row b = i mod B of the [B, L] bases and quals), the sums of
// ops/stats_kernels.py:stat_batch_plain, added as add_partial adds them.
//
//   Cycle j of row i is the byte at column (start_i + j) mod L for
//   j < n_i, where, with hi_i = max(hi[i], lo[i]):
//     zero_lo form (pre-filter):  start_i = 0,                n_i = hi_i;
//     span form (post-filter):    start_i = clamp(lo[i], 0, L), n_i = hi_i - lo[i];
//   n_i is clamped to [0, L] and is 0 where read_mask[i] is false.
//
// The side vector holds, at cycle length SL >= L (k = base & 7):
//   [SL, 18] per cycle: content[k], sum of (qual - 33)[k], total bases,
//            total (qual - 33)          (cycles L..SL-1 are not touched)
//   q20[8], q30[8]   totals per bucket of qual >= '5' and qual >= '?'
//   hist[128]        bin min(qual, 127)
//   kmer[1024]       5-mers of A/T/U/C/G (U as T, uppercase only) ending at
//                    cycle j >= 4, key c0<<8|..|c4
// and median[i] (uint8) is sorted(row)[clamp(rlen >> 1, 0, L - 1)], where
// the row holds the read's n_i quals and L - n_i bytes 255 and rlen =
// hi_i - lo[i] (0 where read_mask[i] is false), or 0 where rlen <= 0.
//
// Replaces fastplong_tpu/ops/stats_kernels.py:stat_batch, which XLA ran as
// masked column sums per bucket, two scatter-adds and a row sort, and the
// step's add of its partial into the accumulator
// (fastplong_tpu/pipeline/device.py:_flat_partial).
//
// Bound on an H100: each in-span byte of bases and quals read once (about
// 2 * sum(n_i) bytes) and the accumulator's touched cycles read and
// written once (18 * L * 16 bytes): bound by bytes.  The kernel before this
// design (an int32 partial per slot, added into the accumulator by about
// ten more device ops) took 0.036 ms a slot at [1024, 8192], 12 times that
// bound; its row blocks alone took 0.027 ms and its column blocks 0.023
// ms, and leaving out its atomics saved under 0.002 ms: both roles waited
// on chains of one-byte loads, one round trip per 32 positions
// (tools/torch_kernel_roles.py, PERF.md).  Design: one launch per side, two
// kinds of blocks; every result is an integer and every atomic an integer
// add (the int64 adds as unsigned adds of the two's complement), so the
// order of the adds changes no bit.
//
//   * Row blocks (the first kRowBlocks blocks) take whole rows, one at a
//     time, in 16-column chunks aligned to the row (one chunk a thread, two
//     loaded before either is counted): a 16-byte load of bases and one of
//     quals, and the 4 bases before the chunk in one 4-byte load, from which
//     each position's 5-mer key rolls with no exchange between lanes.  A
//     position's cycle is its column minus the span's start on the
//     unwrapped column axis, so a span that wraps past L is counted once.
//     Each row's qualities go into a 256-bin count in shared memory (two
//     buffers, so one barrier a row); warp 0 then scans it for the median
//     (the padding's 255s are added in the scan) and folds it into the
//     block's quality histogram, while the other warps go on to the next
//     row.  The 5-mer counts are privatised per block in shared memory.
//     Where L is not a multiple of 16, or a pointer is not 16-byte aligned,
//     the same code runs with 1-column chunks and byte loads.
//   * Column blocks own 32 cycles each and walk a chunk of rows with their
//     eight warps, warp w taking spans w, w + 8, ... of those in the chunk
//     that reach the block's first cycle (packed first, by warp ballots),
//     eight rows' bytes loaded before any is counted.  A lane keeps its
//     cycle's counters packed in five 64-bit registers:
//     eight 8-bit counts each for content, Q20 and Q30, and eight 16-bit
//     sums of the raw quality bytes (a lane sees at most 128 rows).  At the
//     end the block sums the eight warps' counters, reduces Q20 and Q30 to
//     one total per bucket (one atomic each), and adds the 32 cycles x 18
//     values, contiguous in the accumulator, with coalesced atomics.  The
//     chunk size puts about kColBlocksTarget column blocks on the card.
//
// Row blocks come first in the grid, so that the walks over whole rows
// start first; the column blocks fill in around them.  At six blocks an SM
// (40 registers) it takes 0.030-0.034 ms for one to four slots at
// [1024, 8192], still about 10 times its bound.  What holds it: the row
// blocks' two shared-memory atomics per position (the row blocks alone
// take 0.017 ms, 0.004 ms without them; four copies of the count change
// nothing, so the cost is the atomics' rate, not same-address conflicts),
// and the column blocks' byte arithmetic over short chains of loads per
// block (alone 0.021 ms, 0.013 ms without the arithmetic).  Four cycles a
// lane from 4-byte loads made the column blocks slower, not faster.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;           // per SM: at most 40 registers
constexpr int kRowBlocks = 528;         // 4 per SM on 132 SMs
constexpr int kColBlocksTarget = 528;
constexpr int kMaxChunk = 1024;         // rows per column block
constexpr int kUnroll = 8;              // rows loaded ahead per lane
constexpr int kVec = 16;                // columns per row-role chunk
constexpr int kHist = 128;
constexpr int kKmer = 1024;
constexpr int kPer = 18;                // int64 per cycle in the accumulator
constexpr uint32_t kBadCode = 4;
constexpr uint32_t kNone = 0x100;       // no byte (an empty slot of a batch)

struct Args {
  const uint8_t* bases;
  const uint8_t* quals;
  int S, B, L;
  const int* lo;
  const int* hi;
  const uint8_t* mask;
  int zero_lo;
  unsigned long long* side;   // cycle block [SL, 18]
  unsigned long long* tail;   // side + 18 * SL: q20, q30, hist, kmer
  uint8_t* median;
  int nrow;                   // row blocks
  int ncolb;                  // column blocks per chunk of rows
  int chunk;                  // rows per column block
};

struct Span {
  int start;   // column of cycle 0
  int n;       // cycles in the span, in [0, L]
  int rlen;
};

__device__ __forceinline__ Span row_span(const Args& a, int i) {
  const int l = a.lo[i];
  const int h = max(a.hi[i], l);
  const bool on = a.mask[i] != 0;
  Span s;
  s.rlen = on ? h - l : 0;
  const int n = a.zero_lo ? h : h - l;
  s.n = on ? min(max(n, 0), a.L) : 0;
  s.start = a.zero_lo ? 0 : min(max(l, 0), a.L);
  return s;
}

__device__ __forceinline__ void add64(unsigned long long* p, int v) {
  atomicAdd(p, static_cast<unsigned long long>(static_cast<long long>(v)));
}

// 2-bit code of A, T/U, C, G; kBadCode for any other byte
__device__ __forceinline__ uint32_t base_code(uint32_t x) {
  return x == 'A' ? 0u
       : (x == 'T' || x == 'U') ? 1u
       : x == 'C' ? 2u
       : x == 'G' ? 3u : kBadCode;
}

// ------------------------------------------------------------- row role

// The bytes of one chunk: V columns from unwrapped column u0 (< 2 L), and
// the 4 bases before it (circularly) in `prev`, oldest in the low byte.
template <int V>
struct Chunk {
  uint32_t b[(V + 3) / 4];
  uint32_t q[(V + 3) / 4];
  uint32_t prev;
};

template <int V>
__device__ __forceinline__ Chunk<V> load_chunk(const uint8_t* brow,
                                               const uint8_t* qrow, int L,
                                               int u0) {
  const int c = u0 >= L ? u0 - L : u0;
  Chunk<V> ch;
  if constexpr (V == kVec) {
    // L % 16 == 0 and both rows 16-byte aligned
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(brow + c));
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(qrow + c));
    ch.b[0] = b.x; ch.b[1] = b.y; ch.b[2] = b.z; ch.b[3] = b.w;
    ch.q[0] = q.x; ch.q[1] = q.y; ch.q[2] = q.z; ch.q[3] = q.w;
    ch.prev = __ldg(reinterpret_cast<const uint32_t*>(
        brow + (c == 0 ? L - 4 : c - 4)));
  } else {
    static_assert(V == 1, "chunks are 16 columns or 1");
    ch.b[0] = __ldg(brow + c);
    ch.q[0] = __ldg(qrow + c);
    ch.prev = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      int col = c - 4 + t;
      if (col < 0) col += L;
      // only where L < 4, when no 5-mer can count, may col stay negative
      const uint32_t x = col >= 0 ? __ldg(brow + col) : 0u;
      ch.prev |= x << (8 * t);
    }
  }
  return ch;
}

// Count one chunk's in-span positions: its qualities into cnt and its
// 5-mers into kmer.
template <int V>
__device__ __forceinline__ void count_chunk(const Chunk<V>& ch, int u0,
                                            const Span& s, int* cnt,
                                            int* kmer) {
  uint32_t key = 0;
  int run = 0;          // valid codes in a row, ending at this position
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t v = base_code((ch.prev >> (8 * t)) & 0xFFu);
    run = v == kBadCode ? 0 : run + 1;
    key = ((key << 2) | (v & 3u)) & (kKmer - 1);
  }
  const int j0 = u0 - s.start;
#pragma unroll
  for (int p = 0; p < V; ++p) {
    const uint32_t x = (ch.b[p >> 2] >> (8 * (p & 3))) & 0xFFu;
    const uint32_t q = (ch.q[p >> 2] >> (8 * (p & 3))) & 0xFFu;
    const uint32_t v = base_code(x);
    run = v == kBadCode ? 0 : run + 1;
    key = ((key << 2) | (v & 3u)) & (kKmer - 1);
    const int j = j0 + p;
    if (j >= 0 && j < s.n) {
      atomicAdd(&cnt[q], 1);
      if (run >= 5 && j >= 4) atomicAdd(&kmer[key], 1);
    }
  }
}

// Warp 0, after a row is counted: its median from the 256-bin count cnt,
// cnt folded into the block's histogram and zeroed.
__device__ void finish_row(int* cnt, const Span& s, int L, int* hist,
                           uint8_t* median) {
  const int lane = threadIdx.x & 31;
  // smallest v with #{row <= v} > half; lane l holds bins 8l .. 8l+7
  const int half = min(max(s.rlen >> 1, 0), L - 1);
  int c[8];
  int sum = 0;
  int over = 0;         // bins 127 .. 255 all go to hist[127]
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int bin = 8 * lane + k;
    c[k] = cnt[bin];
    cnt[bin] = 0;
    sum += c[k];
    if (bin < kHist - 1) {
      hist[bin] += c[k];
    } else {
      over += c[k];
    }
  }
  over = __reduce_add_sync(kFull, over);
  if (lane == 0) hist[kHist - 1] += over;
  if (lane == 31) {
    c[7] += L - s.n;      // the padding's 255s
    sum += L - s.n;
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  const unsigned hit = __ballot_sync(kFull, incl > half);
  if (lane == __ffs(hit) - 1) {
    int acc = incl - sum;
    int med = -1;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc += c[k];
      if (med < 0 && acc > half) med = 8 * lane + k;
    }
    *median = static_cast<uint8_t>(s.rlen > 0 ? med : 0);
  }
}

struct RowShared {
  int cnt[2][256];
  int hist[kHist];
  int kmer[kKmer];
};

template <int V>
__device__ void row_block(const Args& a, RowShared& sh) {
  const int tid = threadIdx.x;
  const int L = a.L;
  for (int i = tid; i < kKmer; i += kThreads) sh.kmer[i] = 0;
  for (int i = tid; i < 2 * 256; i += kThreads) sh.cnt[i >> 8][i & 255] = 0;
  if (tid < kHist) sh.hist[tid] = 0;
  __syncthreads();
  const int rows = a.S * a.B;
  int buf = 0;
  for (int i = blockIdx.x; i < rows; i += a.nrow) {
    const Span s = row_span(a, i);
    if (s.n == 0) {       // the whole row is padding bytes 255
      if (tid == 0) a.median[i] = s.rlen > 0 ? 255 : 0;
      continue;
    }
    const int64_t off = static_cast<int64_t>(i % a.B) * L;
    const uint8_t* brow = a.bases + off;
    const uint8_t* qrow = a.quals + off;
    int* cnt = sh.cnt[buf];
    // chunks of the unwrapped columns [start, start + n), start + n <= 2 L
    const int c0 = s.start / V;
    const int nch = (s.start + s.n - 1) / V - c0 + 1;
    for (int k = tid; k < nch; k += 2 * kThreads) {
      const bool two = k + kThreads < nch;
      const int u0 = (c0 + k) * V;
      const int u1 = u0 + kThreads * V;
      const Chunk<V> ch0 = load_chunk<V>(brow, qrow, L, u0);
      Chunk<V> ch1;
      if (two) ch1 = load_chunk<V>(brow, qrow, L, u1);
      count_chunk(ch0, u0, s, cnt, sh.kmer);
      if (two) count_chunk(ch1, u1, s, cnt, sh.kmer);
    }
    // the count is complete; warp 0 also finished the row before last,
    // so the other buffer is zero again
    __syncthreads();
    if ((tid >> 5) == 0) finish_row(cnt, s, L, sh.hist, a.median + i);
    buf ^= 1;
  }
  __syncthreads();
  for (int i = tid; i < kKmer; i += kThreads) {
    if (sh.kmer[i]) add64(&a.tail[16 + kHist + i], sh.kmer[i]);
  }
  if (tid < kHist && sh.hist[tid]) add64(&a.tail[16 + tid], sh.hist[tid]);
}

// ---------------------------------------------------------- column role

struct ColShared {
  int4 row[kMaxChunk];                 // start, n, data row of the spans read
  uint64_t part[kWarps][5][32];        // each warp's packed counters
  int val[32][kPer];                   // the block's 32 cycles x 18 values
  int nact;
};

__device__ void column_block(const Args& a, ColShared& sh, int cb, int rc) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;
  const int L = a.L;
  const int rows = a.S * a.B;
  const int r0 = rc * a.chunk;
  const int nrows = min(a.chunk, rows - r0);
  if (tid == 0) sh.nact = 0;
  __syncthreads();
  // the chunk's rows whose span reaches this block's first cycle, packed
  // by warp (one atomic a warp)
  for (int t0 = 0; t0 < nrows; t0 += kThreads) {
    const int i = r0 + t0 + tid;
    Span s{0, 0, 0};
    if (t0 + tid < nrows) s = row_span(a, i);
    const bool keep = s.n > cb * 32;
    const unsigned m = __ballot_sync(kFull, keep);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&sh.nact, __popc(m));
    at = __shfl_sync(kFull, at, 0) + __popc(m & ((1u << lane) - 1u));
    if (keep) sh.row[at] = make_int4(s.start, s.n, i % a.B, 0);
  }
  __syncthreads();
  const int nact = sh.nact;
  const int j = cb * 32 + lane;
  // 8-bit lanes: count, q20, q30 per bucket; 16-bit lanes: sums of the
  // raw quality bytes of buckets 0-3 (qs0) and 4-7 (qs1)
  uint64_t cnt = 0, q20 = 0, q30 = 0, qs0 = 0, qs1 = 0;
  for (int rb = g; rb < nact && j < L; rb += kWarps * kUnroll) {
    uint32_t x[kUnroll], q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + u * kWarps;
      x[u] = kNone;
      q[u] = 0;
      if (r < nact) {
        const int4 e = sh.row[r];
        if (j < e.y) {
          int c = e.x + j;
          if (c >= L) c -= L;
          const int64_t at = static_cast<int64_t>(e.z) * L + c;
          x[u] = __ldg(a.bases + at);
          q[u] = __ldg(a.quals + at);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (x[u] == kNone) continue;
      const uint32_t sh8 = (x[u] & 7u) * 8u;
      cnt += 1ull << sh8;
      q20 += static_cast<uint64_t>(q[u] >= '5') << sh8;
      q30 += static_cast<uint64_t>(q[u] >= '?') << sh8;
      const uint64_t add = static_cast<uint64_t>(q[u]) << ((x[u] & 3u) * 16u);
      const bool upper = (x[u] & 4u) != 0;
      qs0 += upper ? 0ull : add;
      qs1 += upper ? add : 0ull;
    }
  }
  sh.part[g][0][lane] = cnt;
  sh.part[g][1][lane] = q20;
  sh.part[g][2][lane] = q30;
  sh.part[g][3][lane] = qs0;
  sh.part[g][4][lane] = qs1;
  __syncthreads();
  // thread (warp k, lane c): bucket k of cycle c, summed over the warps
  {
    const int c = lane;
    const int k = g;
    int content = 0, n20 = 0, n30 = 0, qraw = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      content += static_cast<int>((sh.part[w][0][c] >> (8 * k)) & 0xFFu);
      n20 += static_cast<int>((sh.part[w][1][c] >> (8 * k)) & 0xFFu);
      n30 += static_cast<int>((sh.part[w][2][c] >> (8 * k)) & 0xFFu);
      qraw += static_cast<int>(
          (sh.part[w][3 + (k >> 2)][c] >> (16 * (k & 3))) & 0xFFFFu);
    }
    sh.val[c][k] = content;
    sh.val[c][8 + k] = qraw - 33 * content;
    n20 = __reduce_add_sync(kFull, n20);
    n30 = __reduce_add_sync(kFull, n30);
    if (c == 0) {
      if (n20) add64(&a.tail[k], n20);
      if (n30) add64(&a.tail[8 + k], n30);
    }
  }
  __syncthreads();
  if (tid < 32) {
    int tb = 0, tq = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      tb += sh.val[tid][k];
      tq += sh.val[tid][8 + k];
    }
    sh.val[tid][16] = tb;
    sh.val[tid][17] = tq;
  }
  __syncthreads();
  // 32 cycles x 18 values, contiguous in the accumulator
  const int ncyc = min(32, L - cb * 32);
  unsigned long long* out = a.side + static_cast<int64_t>(cb) * 32 * kPer;
  const int* val = &sh.val[0][0];
  for (int e = tid; e < ncyc * kPer; e += kThreads) {
    if (val[e]) add64(out + e, val[e]);
  }
}

union SharedAll {
  RowShared row;
  ColShared col;
};

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stat_batch_kernel(Args a) {
  __shared__ SharedAll sh;
  if (static_cast<int>(blockIdx.x) < a.nrow) {
    row_block<V>(a, sh.row);
  } else {
    const int c = blockIdx.x - a.nrow;
    column_block(a, sh.col, c % a.ncolb, c / a.ncolb);
  }
}

}  // namespace

extern "C" int fpl_stat_batch_into(const void* bases, const void* quals,
                                   int S, int B, int L, const void* lo,
                                   const void* hi, const void* read_mask,
                                   int zero_lo, void* side, int SL,
                                   void* median, void* stream) {
  if (L > SL || S < 0 || B < 0 || L < 0 ||
      static_cast<int64_t>(S) * B > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0 || B == 0 || L == 0) return static_cast<int>(cudaSuccess);
  const int rows = S * B;
  Args a;
  a.bases = static_cast<const uint8_t*>(bases);
  a.quals = static_cast<const uint8_t*>(quals);
  a.S = S;
  a.B = B;
  a.L = L;
  a.lo = static_cast<const int*>(lo);
  a.hi = static_cast<const int*>(hi);
  a.mask = static_cast<const uint8_t*>(read_mask);
  a.zero_lo = zero_lo;
  a.side = static_cast<unsigned long long*>(side);
  a.tail = a.side + static_cast<int64_t>(kPer) * SL;
  a.median = static_cast<uint8_t*>(median);
  a.nrow = rows < kRowBlocks ? rows : kRowBlocks;
  a.ncolb = (L + 31) / 32;
  // row chunks: about kColBlocksTarget column blocks, at most kMaxChunk
  // rows each
  int nchunks = (kColBlocksTarget + a.ncolb - 1) / a.ncolb;
  if (nchunks > rows) nchunks = rows;
  a.chunk = (rows + nchunks - 1) / nchunks;
  if (a.chunk > kMaxChunk) a.chunk = kMaxChunk;
  nchunks = (rows + a.chunk - 1) / a.chunk;
  const int64_t blocks = static_cast<int64_t>(a.nrow) +
                         static_cast<int64_t>(a.ncolb) * nchunks;
  const bool vec = L % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(bases) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(quals) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    stat_batch_kernel<kVec><<<static_cast<unsigned>(blocks), kThreads, 0,
                              st>>>(a);
  } else {
    stat_batch_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        a);
  }
  return static_cast<int>(cudaGetLastError());
}
