// Per-batch read statistics: the partial sums of one [B, L] batch over each
// read's span, as ops/stats_kernels.py:stat_batch_plain computes them.
//
//   Cycle j of read b is the byte at column (start_b + j) mod L for
//   j < n_b, where, with hi_b = max(hi[b], lo[b]):
//     zero_lo form (pre-filter):  start_b = 0,                n_b = hi_b;
//     span form (post-filter):    start_b = clamp(lo[b], 0, L), n_b = hi_b - lo[b];
//   n_b is clamped to [0, L] and is 0 where read_mask[b] is false.
//
// Outputs (int32 unless noted), with k = base & 7 for any byte value:
//   cycle_q20 / cycle_q30 / cycle_content / cycle_qual  [8, L]
//       (qual >= '5', qual >= '?', count, sum of qual - 33 per bucket k)
//   cycle_total_base / cycle_total_qual  [L]
//   base_qual_hist [128]   bin min(qual, 127)
//   kmer [1024]            5-mers of A/T/U/C/G (U as T, uppercase only)
//                          ending at cycle i >= 4, key c0<<8|..|c4
//   median [B] uint8       sorted(row)[clamp(rlen >> 1, 0, L - 1)] where the
//                          row holds the read's n_b quals and L - n_b bytes
//                          255, or 0 where rlen <= 0
//   rlen [B]               hi_b - lo[b] where read_mask[b], else 0
// The sums and histograms go into `out` (zeroed by the caller) in the order
// q20 | q30 | content | qual | total_base | total_qual | hist | kmer.
//
// Replaces fastplong_tpu/ops/stats_kernels.py:stat_batch, which XLA ran as
// masked column sums per bucket, two scatter-adds and a row sort.
//
// Bound on an H100: each in-span byte of bases and quals read once, about
// 2 * sum(n_b) bytes, and the [34 L + 1152] partial written once: bound by
// bytes.  Design: one launch, two kinds of blocks (every result is an
// integer and every atomic an integer add, so the order of the adds does
// not change a bit).
//
//   * Row blocks (the first kRowBlocks blocks, or B if fewer) walk whole
//     reads, one at a time; each warp takes a contiguous eighth of the
//     read in steps of 32 cycles.  A read's 256-bin count of its quals
//     sits in shared memory; after the read, warp 0 scans it for the median
//     (the padding's 255s are added to bin 255 in the scan), so no sort is
//     made.  The quality histogram and the 5-mer counts are privatised per
//     block in shared memory and flushed once, with one global atomic per
//     non-zero bin.  A lane's 5-mer takes the codes of the four cycles
//     before its own from the lanes before it (__shfl_up_sync) or, for the
//     first lanes, from the previous step's last lanes (__shfl_down_sync of
//     the codes it kept), so each byte is loaded once.  Positions outside
//     a span touch no bin.
//   * Column blocks own 32 cycles each and walk a chunk of at most 255
//     reads with their eight warps, warp w taking reads w, w + 8, ...: one
//     byte load per cycle and read, a warp's 32 lanes on 32 neighbouring
//     columns.  A thread keeps its cycle's 34 counters packed in five
//     64-bit registers: eight 8-bit counts each for content, Q20 and Q30,
//     and eight 16-bit sums of the raw quality bytes (at most 255 * 255 <
//     65536), so a byte costs a shift and four adds and no dynamically
//     indexed array.  At the end of the chunk the eight warps' packed
//     counters are added lane by lane in shared memory, and warp 0 adds
//     the non-zero counters to the [8, L] and [L] outputs, one coalesced
//     atomic each.  The chunk size puts about kColBlocksTarget column
//     blocks on the card whatever the bucket width, and no more than 255
//     reads in a chunk.
//
// Row blocks come first in the grid, so that the long walks over whole
// reads start first; the column blocks fill in around them.  What holds the
// kernel above its bound is the row blocks' 5-mer count: its shared-memory
// atomics land on scattered bins (see PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBlocks = 528;         // 4 per SM on 132 SMs
constexpr int kColBlocksTarget = 528;
constexpr int kMaxChunk = 255;          // 8-bit packed counts
constexpr int kHist = 128;
constexpr int kKmer = 1024;
constexpr int kBadCode = 4;

struct Span {
  int start;   // column of cycle 0
  int n;       // cycles in the span, in [0, L]
  int rlen;
};

__device__ __forceinline__ Span row_span(const int* lo, const int* hi,
                                         const uint8_t* read_mask, int b,
                                         int L, int zero_lo) {
  const int l = lo[b];
  const int h = max(hi[b], l);
  const bool on = read_mask[b] != 0;
  Span s;
  s.rlen = on ? h - l : 0;
  const int n = zero_lo ? h : h - l;
  s.n = on ? min(max(n, 0), L) : 0;
  s.start = zero_lo ? 0 : min(max(l, 0), L);
  return s;
}

__device__ __forceinline__ int column(const Span& s, int j, int L) {
  const int c = s.start + j;    // < 2 L
  return c >= L ? c - L : c;
}

// 2-bit code of A, T/U, C, G; kBadCode for any other byte
__device__ __forceinline__ uint32_t base_code(uint32_t x) {
  return x == 'A' ? 0u
       : (x == 'T' || x == 'U') ? 1u
       : x == 'C' ? 2u
       : x == 'G' ? 3u : static_cast<uint32_t>(kBadCode);
}

struct Outs {
  int* q20;
  int* q30;
  int* content;
  int* qual;
  int* total_base;
  int* total_qual;
  int* hist;
  int* kmer;
  uint8_t* median;
  int* rlen;
};

__device__ void row_block(const uint8_t* __restrict__ bases,
                          const uint8_t* __restrict__ quals, int B, int L,
                          const int* lo, const int* hi,
                          const uint8_t* read_mask, int zero_lo, int nrow,
                          const Outs& o) {
  __shared__ int s_cnt[256];
  __shared__ int s_hist[kHist];
  __shared__ int s_kmer[kKmer];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int i = tid; i < kKmer; i += kThreads) s_kmer[i] = 0;
  if (tid < kHist) s_hist[tid] = 0;

  for (int b = blockIdx.x; b < B; b += nrow) {
    const Span s = row_span(lo, hi, read_mask, b, L, zero_lo);
    const uint8_t* brow = bases + static_cast<int64_t>(b) * L;
    const uint8_t* qrow = quals + static_cast<int64_t>(b) * L;
    s_cnt[tid] = 0;
    __syncthreads();
    // warp w takes cycles [c0, c1), a multiple of 32 long
    const int per = ((s.n + 32 * kWarps - 1) / (32 * kWarps)) * 32;
    const int c0 = warp * per;
    const int c1 = min(c0 + per, s.n);
    // codes of the 32 cycles before the current step (lanes 28..31 matter)
    uint32_t prev = kBadCode;
    if (c0 < c1 && c0 > 0 && lane >= 28) {
      prev = base_code(brow[column(s, c0 - 32 + lane, L)]);
    }
    for (int i0 = c0; i0 < c1; i0 += 32) {
      const int i = i0 + lane;
      const bool in = i < c1;
      uint32_t v = kBadCode;
      uint32_t q = 0;
      if (in) {
        const int c = column(s, i, L);
        v = base_code(brow[c]);
        q = qrow[c];
      }
      uint32_t key = v;
      bool ok = v != kBadCode;
#pragma unroll
      for (int k = 1; k <= 4; ++k) {
        const uint32_t a = __shfl_up_sync(kFull, v, k);
        const uint32_t p = __shfl_down_sync(kFull, prev, 32 - k);
        const uint32_t ck = lane >= k ? a : p;
        ok = ok && ck != kBadCode;
        key |= ck << (2 * k);
      }
      if (in) {
        atomicAdd(&s_cnt[q], 1);
        atomicAdd(&s_hist[min(q, 127u)], 1);
        if (ok && i >= 4) atomicAdd(&s_kmer[key], 1);
      }
      prev = v;
    }
    __syncthreads();
    if (warp == 0) {
      // smallest v with #{row <= v} > half; lane l holds bins 8l .. 8l+7
      const int half = min(max(s.rlen >> 1, 0), L - 1);
      int cnt[8];
      int sum = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cnt[k] = s_cnt[8 * lane + k];
        sum += cnt[k];
      }
      if (lane == 31) {
        cnt[7] += L - s.n;      // the padding's 255s
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
        int c = incl - sum;
        int med = -1;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          c += cnt[k];
          if (med < 0 && c > half) med = 8 * lane + k;
        }
        o.median[b] = static_cast<uint8_t>(s.rlen > 0 ? med : 0);
        o.rlen[b] = s.rlen;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < kKmer; i += kThreads) {
    if (s_kmer[i]) atomicAdd(&o.kmer[i], s_kmer[i]);
  }
  if (tid < kHist && s_hist[tid]) atomicAdd(&o.hist[tid], s_hist[tid]);
}

__device__ void column_block(const uint8_t* __restrict__ bases,
                             const uint8_t* __restrict__ quals, int B, int L,
                             const int* lo, const int* hi,
                             const uint8_t* read_mask, int zero_lo, int cb,
                             int rc, int chunk, const Outs& o) {
  __shared__ int s_start[kMaxChunk];
  __shared__ int s_n[kMaxChunk];
  __shared__ uint64_t s_part[kWarps][5][32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;          // row group
  const int r0 = rc * chunk;
  const int rows = min(chunk, B - r0);
  for (int t = tid; t < rows; t += kThreads) {
    const Span s = row_span(lo, hi, read_mask, r0 + t, L, zero_lo);
    s_start[t] = s.start;
    s_n[t] = s.n;
  }
  __syncthreads();
  const int j = cb * 32 + lane;
  // 8-bit lanes: count, q20, q30 per bucket; 16-bit lanes: sums of the
  // raw quality bytes of buckets 0-3 (qs0) and 4-7 (qs1)
  uint64_t cnt = 0, q20 = 0, q30 = 0, qs0 = 0, qs1 = 0;
  const uint8_t* brow = bases + static_cast<int64_t>(r0) * L;
  const uint8_t* qrow = quals + static_cast<int64_t>(r0) * L;
  for (int r = g; r < rows && j < L; r += kWarps) {
    if (j >= s_n[r]) continue;
    int c = s_start[r] + j;
    if (c >= L) c -= L;
    const int64_t at = static_cast<int64_t>(r) * L + c;
    const uint32_t x = brow[at];
    const uint32_t q = qrow[at];
    const uint32_t sh = (x & 7u) * 8u;
    cnt += 1ull << sh;
    q20 += static_cast<uint64_t>(q >= '5') << sh;
    q30 += static_cast<uint64_t>(q >= '?') << sh;
    const uint64_t add = static_cast<uint64_t>(q) << ((x & 3u) * 16u);
    const bool upper = (x & 4u) != 0;
    qs0 += upper ? 0ull : add;
    qs1 += upper ? add : 0ull;
  }
  // the row groups' packed counters add up lane by lane: a chunk holds at
  // most kMaxChunk reads, so no 8-bit count and no 16-bit sum overflows
  s_part[g][0][lane] = cnt;
  s_part[g][1][lane] = q20;
  s_part[g][2][lane] = q30;
  s_part[g][3][lane] = qs0;
  s_part[g][4][lane] = qs1;
  __syncthreads();
  if (g != 0 || j >= L) return;
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    cnt += s_part[w][0][lane];
    q20 += s_part[w][1][lane];
    q30 += s_part[w][2][lane];
    qs0 += s_part[w][3][lane];
    qs1 += s_part[w][4][lane];
  }
  int tb = 0, tq = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int n = static_cast<int>((cnt >> (8 * k)) & 0xFFu);
    if (n == 0) continue;
    const uint64_t qs = k < 4 ? qs0 : qs1;
    const int qsum = static_cast<int>((qs >> (16 * (k & 3))) & 0xFFFFu) -
                     33 * n;
    const int a20 = static_cast<int>((q20 >> (8 * k)) & 0xFFu);
    const int a30 = static_cast<int>((q30 >> (8 * k)) & 0xFFu);
    const int64_t at = static_cast<int64_t>(k) * L + j;
    atomicAdd(&o.content[at], n);
    if (qsum) atomicAdd(&o.qual[at], qsum);
    if (a20) atomicAdd(&o.q20[at], a20);
    if (a30) atomicAdd(&o.q30[at], a30);
    tb += n;
    tq += qsum;
  }
  if (tb) atomicAdd(&o.total_base[j], tb);
  if (tq) atomicAdd(&o.total_qual[j], tq);
}

__global__ void __launch_bounds__(kThreads)
stat_batch_kernel(const uint8_t* __restrict__ bases,
                  const uint8_t* __restrict__ quals, int B, int L,
                  const int* __restrict__ lo, const int* __restrict__ hi,
                  const uint8_t* __restrict__ read_mask, int zero_lo,
                  int nrow, int ncolb, int chunk, Outs o) {
  if (static_cast<int>(blockIdx.x) < nrow) {
    row_block(bases, quals, B, L, lo, hi, read_mask, zero_lo, nrow, o);
  } else {
    const int c = blockIdx.x - nrow;
    column_block(bases, quals, B, L, lo, hi, read_mask, zero_lo, c % ncolb,
                 c / ncolb, chunk, o);
  }
}

}  // namespace

extern "C" int fpl_stat_batch(const void* bases, const void* quals, int B,
                              int L, const void* lo, const void* hi,
                              const void* read_mask, int zero_lo, void* out,
                              void* median, void* rlen, void* stream) {
  if (B <= 0 || L <= 0) return static_cast<int>(cudaSuccess);
  const int nrow = B < kRowBlocks ? B : kRowBlocks;
  const int ncolb = (L + 31) / 32;
  // row chunks: about kColBlocksTarget column blocks, at most kMaxChunk
  // reads each
  int nchunks = (kColBlocksTarget + ncolb - 1) / ncolb;
  if (nchunks > B) nchunks = B;
  int chunk = (B + nchunks - 1) / nchunks;
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  nchunks = (B + chunk - 1) / chunk;
  int* base = static_cast<int*>(out);
  const int64_t L8 = static_cast<int64_t>(8) * L;
  Outs o;
  o.q20 = base;
  o.q30 = base + L8;
  o.content = base + 2 * L8;
  o.qual = base + 3 * L8;
  o.total_base = base + 4 * L8;
  o.total_qual = base + 4 * L8 + L;
  o.hist = base + 4 * L8 + 2 * L;
  o.kmer = o.hist + kHist;
  o.median = static_cast<uint8_t*>(median);
  o.rlen = static_cast<int*>(rlen);
  const int64_t blocks = static_cast<int64_t>(nrow) +
                         static_cast<int64_t>(ncolb) * nchunks;
  stat_batch_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(quals),
      B, L, static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<const uint8_t*>(read_mask), zero_lo, nrow, ncolb, chunk, o);
  return static_cast<int>(cudaGetLastError());
}
