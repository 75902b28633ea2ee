// Fused masked cdist -> top-K (K = 1 is the masked argmin), f32.
// List instances K = 1, 5, 8, 16; a caller's k <= 16 takes the smallest
// K >= k and keeps the first k columns (see below). A k above 16 takes
// the wide path (masked_topk_wide_kernel, below). Any feature width C.
//
// Replaces the TPU kernels pose6d_tpu/ops/pallas/cdist.py:40
// masked_argmin_cdist and :99 masked_topk_cdist. For each row a_i of
// a (B, N, C) it returns the K smallest masked squared distances
// max(|a_i|^2 - 2 a_i.b_j + |b_j|^2, 0) (the TPU kernel's expansion) to
// the valid rows of b (B, M, C), ascending, with the lower column index
// first on ties. Masked columns never win. A row with fewer than K
// valid columns fills its remaining slots with (1e9, 0), which is what
// the JAX package's k-pass top-k returns there (pose6d_tpu/ops/nn.py:
// 67-80: once the valid columns are exhausted every entry is 1e9 and
// argmin takes column 0). So a row's top-k is the k-prefix of its top-K
// for every K >= k, and one instance serves every smaller k.
//
// What bounds it on the H100. Neither instantiation writes the distance
// matrix; both read a few hundred KB and are compute work far below the
// card's f32 ridge point, so they are bound by instruction issue and by
// how much of the card a call can fill, not by bytes:
// - ICP's argmin (K = 1, C = 3): per (query, column) pair 3 FMAs for
//   a.b, then fmaf, add, max, compare and two selects: ~9 instructions,
//   of which only 6 flops count toward the f32 roofline. Issue bounds it
//   near 2x the flop bound.
// - The spectral top-5 (K = 5, C = 30, or 64 for a ZoomOut map) and
//   ZoomOut's argmin (K = 1, C = 34 to 64): C FMAs per pair plus the same
//   few, and a sorted insertion for the rare pair that enters a row's
//   list; FMA issue bounds it.
// - A one-frame call is 2048 queries: one thread per query walking all
//   M columns would be 64 warps for 132 SMs, each in one dependent FMA
//   chain, and one frame would cost as much as sixteen.
// What the design does about it:
// - Splits the column walk three ways: kCl lanes of each warp take
//   interleaved columns of a shared-memory tile (the warp's other lanes
//   take other queries); a block's 8 warps take different queries over
//   the same tile; and when (B, N) alone gives fewer than two blocks
//   per SM, the columns are cut into segments, one per block (grid.y),
//   so a one-frame call still fills every SM (masked_topk_cdist_splits
//   picks the count from B, N, M and the SM count).
// - Breaks the dependency chain: each thread evaluates kQpt queries x
//   kCpt columns per step (8 x 4 for C <= 3, 2 x 2 for C <= 32, 1 x 4
//   for C <= 64; K = 8 and 16 keep fewer queries a thread, so that the
//   longer sorted lists stay in registers) with independent accumulators, the queries in
//   registers and the columns read from shared memory as float4 (kCl
//   distinct columns per warp instruction, in distinct banks), so each
//   shared-memory wavefront feeds up to 4 * kQpt FMAs. C <= 3 skips the
//   always-zero fourth feature.
// - Folds validity into the staged tile: a masked or out-of-range column
//   gets |b|^2 = +inf, so its d2 is +inf and never enters a list,
//   without a branch per column.
// - Keeps f32 FMAs: |a|^2, |b|^2 and a.b as fmaf chains over the
//   features in order, then fmaxf(fmaf(-2, a.b, |a|^2) + |b|^2, 0),
//   which rounds as a2 - 2 * a.b + b2 does (2 * a.b is exact). Tensor
//   cores in TF32 would put d2 errors far above the check's tolerance.
// - Merges deterministically: a thread walks its columns in increasing
//   order, so a strict d2 compare keeps the lower column on ties; every
//   merge after that (across a warp's column lanes by shuffles, across
//   segments in a second small kernel over fixed-order partial lists)
//   compares (d2, column) lexicographically, so the result does not
//   depend on the order in which lanes or blocks finish.
// The wrapper passes a and b unpadded, with their batch and row strides
// (a row may be a slice of a wider tensor); the kernel zero-fills the
// features up to CP = 4, 32 or 64 in registers and shared memory (zero
// features change no distance), so a call makes no copies.
//
// Features wider than 64 (ZoomOut's argmin and top-5 at eval.zoomout_k
// or Predictor(zoomout_k) above 64; the naive solver at n_fmap > 64) and
// k above 16 (resolve --topk 24) share one distance walk (tile_d2): one
// warp per query row, 8 rows a block over shared-memory tiles of 128
// columns whose features are staged in chunks of 64 (row stride 65, so
// the 32 lanes' columns sit in distinct banks) beside the 8 rows' chunk;
// lane l takes columns l, l + 32, l + 64, l + 96 of each tile, so a
// lane meets its columns in increasing order. Its d2 is the expression
// above with the same fmaf chains over the features in order, bit for
// bit the list instances' value. Bound as above (C FMAs a pair, ~2
// issued instructions each with the shared-memory read); the simple
// layout costs one shared load per FMA and is not tuned.
// - masked_topk_chunked_kernel (K = 1, 5, 8 at C > 64): each lane keeps
//   a sorted list of K (d2, column), then a butterfly over the 32 lanes
//   as in the list instances; one pass. (A K = 16 list spilled there on
//   an H100; 8 < k <= 16 takes the wide path at C > 64, whose order and
//   fill are those of lax.top_k, which the JAX package runs above 8.)
// - masked_topk_wide_kernel (k > 16, any C): the register lists do not
//   scale with k, so a row's k-th smallest key (d2 bits, column; d2 >= 0,
//   so its bits order as the floats do; a masked column is +inf) is found
//   by radix select on the d2 bits, four passes of 8 bits, each a fresh
//   walk that histograms the digit of the columns whose higher digits
//   match (256 bins a warp in shared memory; integer counts, any order).
//   A fifth walk writes the keys below the k-th d2, and the lowest
//   columns at that d2 (ballot ranks in column order), to a (B, N, k)
//   scratch; each lane then ranks its entries among the k by (d2,
//   column) and writes them to their slots. Recomputing the distances
//   in every pass needs no (N, M) store, so no M or C is refused. Masked
//   columns rank after every valid one in column order and come out at
//   1e9: lax.top_k's order and fill (pose6d_tpu/ops/nn.py:81), which is
//   what the JAX package runs above k = 8.
//
// C interface (ctypes): returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMergeThreads = 128;
constexpr float kBig = 1e9f;

// The tiling of each padded feature width CP: kQpt queries x kCpt
// columns a thread; kCl lanes of a warp split the columns (the other
// 32 / kCl lanes take other queries); kTile b rows staged per tile; the
// shared-memory row stride in floats (36 for CP = 32: the kCl columns
// of one warp read land in distinct 4-bank groups); the features that
// enter the products (C <= 3 takes the CP = 4 layout and skips the
// always-zero fourth); blocks per SM that the registers must allow.
template <int CP> struct BaseTiling;
template <> struct BaseTiling<4> {
  static constexpr int kQpt = 8, kCpt = 4, kCl = 8, kTile = 256;
  static constexpr int kStride = 4, kUsed = 3, kMinBlocks = 1;
};
template <> struct BaseTiling<32> {
  static constexpr int kQpt = 2, kCpt = 2, kCl = 4, kTile = 128;
  static constexpr int kStride = 36, kUsed = 32, kMinBlocks = 2;
};
// 32 < C <= 64 (ZoomOut's embeddings): one query a thread, its 64
// features in registers, 4 columns of each of a warp's 8 column lanes per
// step; row stride 68 (17 4-bank groups: the 8 columns of one read land
// in distinct groups). Two blocks per SM cap the registers at 128
// without spills; measured 28 % faster than one block of 148 registers.
template <> struct BaseTiling<64> {
  static constexpr int kQpt = 1, kCpt = 4, kCl = 8, kTile = 128;
  static constexpr int kStride = 68, kUsed = 64, kMinBlocks = 2;
};

// A list of K > 5 entries per query: the C <= 3 layout keeps 4 (K = 8)
// or 2 (K = 16) queries a thread, the wider ones 1, so that a thread's
// lists (kQpt x K distances and indices) and the butterfly's copy of
// one list stay in registers; at C <= 64 with K = 16 one block per SM
// may take the registers that needs.
template <int CP, int K> struct Tiling : BaseTiling<CP> {
  static constexpr int kQpt =
      K <= 5 ? BaseTiling<CP>::kQpt : (CP == 4 ? (K <= 8 ? 4 : 2) : 1);
  static constexpr int kMinBlocks =
      (CP == 64 && K > 8) ? 1 : BaseTiling<CP>::kMinBlocks;
};

template <int CP, int K>
constexpr int kRowsPerBlock = kWarps * (32 / Tiling<CP, K>::kCl) *
                              Tiling<CP, K>::kQpt;

// (d, j) before (e, i) in the order (d2, column).
__device__ __forceinline__ bool before(float d, int j, float e, int i) {
  return d < e || (d == e && j < i);
}

// Sorted insertion with constant indices only: walking down from the
// tail, an entry after the new one moves up a slot and the new one
// lands above the first entry before it. kLex = false compares d2 only
// (columns arrive in increasing order, so the earlier one stays first).
template <int K, bool kLex>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int j) {
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    const bool after_prev =
        s > 0 && (kLex ? before(d, j, bd[s - 1], bi[s - 1]) : d < bd[s - 1]);
    if (after_prev) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (kLex ? before(d, j, bd[s], bi[s]) : d < bd[s]) {
      bd[s] = d;
      bi[s] = j;
    }
  }
}

// A list's slots that found no column hold (+inf, 0); the final output
// writes (1e9, 0) there, partial lists keep +inf for the merge.
template <int K>
__device__ __forceinline__ void store(float* od, int* oi, const float (&bd)[K],
                                      const int (&bi)[K], bool final_out) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool keep = !final_out || bd[s] != INFINITY;
    od[s] = keep ? bd[s] : kBig;
    oi[s] = keep ? bi[s] : 0;
  }
}

// grid (ceil(N / kRowsPerBlock), splits, B). With one split the block
// writes the output; with more it writes its segment's partial lists to
// out[((batch * splits + split) * n + row) * K].
template <int K, int CP>
__global__ void __launch_bounds__(kThreads, Tiling<CP, K>::kMinBlocks)
masked_topk_cdist_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         const unsigned char* __restrict__ b_valid,
                         float* __restrict__ out_d2, int* __restrict__ out_idx,
                         int n, int m, int c, int seg, long long a_sb,
                         long long a_sn, long long b_sb, long long b_sn,
                         long long v_sb) {
  using T = Tiling<CP, K>;
  constexpr int kQpt = T::kQpt, kCpt = T::kCpt, kCl = T::kCl;
  constexpr int kTile = T::kTile, kStride = T::kStride, kUsed = T::kUsed;
  constexpr int kStep = kCl * kCpt;          // columns of one warp step
  static_assert(kTile % kStep == 0, "a tile is whole steps");
  __shared__ __align__(16) float bs[kTile * kStride];
  __shared__ float b2s[kTile];

  const int batch = blockIdx.z, split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cl = lane % kCl, ql = lane / kCl;
  const int row0 = blockIdx.x * kRowsPerBlock<CP, K> +
                   (warp * (32 / kCl) + ql) * kQpt;
  const float* ab = a + batch * a_sb;
  const float* bb = b + batch * b_sb;
  const unsigned char* vb = b_valid + batch * v_sb;
  const int j_begin = split * seg;
  const int j_end = min(m, j_begin + seg);

  float ar[kQpt][CP], a2[kQpt];
#pragma unroll
  for (int q = 0; q < kQpt; ++q) {
    const int row = row0 + q;
    a2[q] = 0.f;
#pragma unroll
    for (int f = 0; f < CP; ++f) {
      ar[q][f] = (row < n && f < c) ? ab[row * a_sn + f] : 0.f;
      a2[q] = fmaf(ar[q][f], ar[q][f], a2[q]);
    }
  }
  float bd[kQpt][K];
  int bi[kQpt][K];
#pragma unroll
  for (int q = 0; q < kQpt; ++q) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[q][s] = INFINITY;
      bi[q][s] = 0;
    }
  }

  for (int t0 = j_begin; t0 < j_end; t0 += kTile) {
    __syncthreads();
    for (int t = threadIdx.x; t < kTile * CP; t += kThreads) {
      const int jj = t / CP, f = t % CP, j = t0 + jj;
      bs[jj * kStride + f] = (j < j_end && f < c) ? bb[j * b_sn + f] : 0.f;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kTile; t += kThreads) {
      const int j = t0 + t;
      float s2 = 0.f;
#pragma unroll
      for (int f = 0; f < CP; ++f)
        s2 = fmaf(bs[t * kStride + f], bs[t * kStride + f], s2);
      b2s[t] = (j < j_end && vb[j]) ? s2 : INFINITY;
    }
    __syncthreads();
    const int steps = (min(kTile, j_end - t0) + kStep - 1) / kStep;
    for (int st = 0; st < steps; ++st) {
      int col[kCpt];
      float acc[kQpt][kCpt];
#pragma unroll
      for (int u = 0; u < kCpt; ++u) {
        col[u] = st * kStep + u * kCl + cl;
#pragma unroll
        for (int q = 0; q < kQpt; ++q) acc[q][u] = 0.f;
      }
#pragma unroll
      for (int f = 0; f < CP; f += 4) {
        float4 bv[kCpt];
#pragma unroll
        for (int u = 0; u < kCpt; ++u)
          bv[u] = *reinterpret_cast<const float4*>(&bs[col[u] * kStride + f]);
#pragma unroll
        for (int q = 0; q < kQpt; ++q) {
#pragma unroll
          for (int u = 0; u < kCpt; ++u) {
            acc[q][u] = fmaf(ar[q][f], bv[u].x, acc[q][u]);
            if (f + 1 < kUsed) acc[q][u] = fmaf(ar[q][f + 1], bv[u].y, acc[q][u]);
            if (f + 2 < kUsed) acc[q][u] = fmaf(ar[q][f + 2], bv[u].z, acc[q][u]);
            if (f + 3 < kUsed) acc[q][u] = fmaf(ar[q][f + 3], bv[u].w, acc[q][u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kCpt; ++u) {
        const float b2 = b2s[col[u]];
        const int j = t0 + col[u];
#pragma unroll
        for (int q = 0; q < kQpt; ++q) {
          const float d = fmaxf(fmaf(-2.f, acc[q][u], a2[q]) + b2, 0.f);
          if (d < bd[q][K - 1]) insert<K, false>(bd[q], bi[q], d, j);
        }
      }
    }
  }

  // the kCl column lanes of a query group: a butterfly over the low lane
  // bits, after which every lane holds the group's lists
#pragma unroll
  for (int off = 1; off < kCl; off <<= 1) {
#pragma unroll
    for (int q = 0; q < kQpt; ++q) {
      float od[K];
      int oi[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        od[s] = __shfl_xor_sync(0xffffffffu, bd[q][s], off);
        oi[s] = __shfl_xor_sync(0xffffffffu, bi[q][s], off);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) insert<K, true>(bd[q], bi[q], od[s], oi[s]);
    }
  }
  if (cl != 0) return;
  const bool final_out = gridDim.y == 1;
#pragma unroll
  for (int q = 0; q < kQpt; ++q) {
    const int row = row0 + q;
    if (row >= n) continue;
    const size_t o = ((size_t)(batch * gridDim.y + split) * n + row) * K;
    store<K>(out_d2 + o, out_idx + o, bd[q], bi[q], final_out);
  }
}

// One thread per (batch, row): the segments' partial lists in segment
// order, merged by (d2, column), then the (1e9, 0) fill.
template <int K>
__global__ void __launch_bounds__(kMergeThreads)
merge_splits_kernel(const float* __restrict__ part_d2,
                    const int* __restrict__ part_idx, float* __restrict__ out_d2,
                    int* __restrict__ out_idx, int n, int splits, int rows) {
  const int r = blockIdx.x * kMergeThreads + threadIdx.x;
  if (r >= rows) return;
  const int batch = r / n, row = r % n;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
  for (int sp = 0; sp < splits; ++sp) {
    const size_t p = ((size_t)(batch * splits + sp) * n + row) * K;
#pragma unroll
    for (int s = 0; s < K; ++s)
      insert<K, true>(bd, bi, part_d2[p + s], part_idx[p + s]);
  }
  store<K>(out_d2 + (size_t)r * K, out_idx + (size_t)r * K, bd, bi, true);
}

// The shared distance walk of the chunked and wide kernels: one warp per
// query row, kWalkRows rows a block.
constexpr int kWalkRows = kWarps;
constexpr int kWalkTile = 128;              // columns staged per tile
constexpr int kWalkCols = kWalkTile / 32;   // columns of a lane per tile
constexpr int kWalkChunk = 64;              // features staged per chunk
constexpr int kWalkStride = kWalkChunk + 1; // odd: lanes' columns in distinct banks
constexpr int kBins = 256;                  // radix digits of 8 bits
constexpr unsigned kInfBits = 0x7f800000u;  // +inf: a masked column

struct WalkSmem {
  float bs[kWalkTile][kWalkStride];
  float as[kWalkRows][kWalkChunk];
  float b2s[kWalkTile];
};

// One tile of the walk over the M columns for the block's rows row0 ..
// row0 + 7 (warp w takes row0 + w): d[u] is the masked d2 of the lane's
// column t0 + 32 u + lane (+inf for a masked column or one past M), so a
// lane meets its columns in increasing order over the tiles. a2 is the
// warp's row's |a|^2. Whole block: every thread calls it for every tile.
__device__ __forceinline__ void tile_d2(
    WalkSmem& sm, const float* __restrict__ ab, const float* __restrict__ bb,
    const unsigned char* __restrict__ vb, int row0, int n, int m, int c,
    long long a_sn, long long b_sn, float a2, int t0,
    float (&d)[kWalkCols]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[kWalkCols];
#pragma unroll
  for (int u = 0; u < kWalkCols; ++u) acc[u] = 0.f;
  for (int f0 = 0; f0 < c; f0 += kWalkChunk) {
    const int fc = min(kWalkChunk, c - f0);
    __syncthreads();  // the previous chunk is consumed
    for (int t = threadIdx.x; t < kWalkTile * fc; t += kThreads) {
      const int jj = t / fc, f = t % fc, j = t0 + jj;
      sm.bs[jj][f] = j < m ? bb[j * b_sn + f0 + f] : 0.f;
    }
    for (int t = threadIdx.x; t < kWalkRows * fc; t += kThreads) {
      const int r = t / fc, f = t % fc, row = row0 + r;
      sm.as[r][f] = row < n ? ab[row * a_sn + f0 + f] : 0.f;
    }
    __syncthreads();
    // |b|^2 of the tile's columns, one fmaf chain over the features in
    // order across the chunks (thread t keeps column t's)
    if (threadIdx.x < kWalkTile) {
      float s2 = f0 == 0 ? 0.f : sm.b2s[threadIdx.x];
      for (int f = 0; f < fc; ++f)
        s2 = fmaf(sm.bs[threadIdx.x][f], sm.bs[threadIdx.x][f], s2);
      sm.b2s[threadIdx.x] = s2;
    }
#pragma unroll 4
    for (int f = 0; f < fc; ++f) {
      const float af = sm.as[warp][f];
#pragma unroll
      for (int u = 0; u < kWalkCols; ++u)
        acc[u] = fmaf(af, sm.bs[u * 32 + lane][f], acc[u]);
    }
  }
  __syncthreads();  // b2s complete
#pragma unroll
  for (int u = 0; u < kWalkCols; ++u) {
    const int j = t0 + u * 32 + lane;
    d[u] = j < m && vb[j]
        ? fmaxf(fmaf(-2.f, acc[u], a2) + sm.b2s[u * 32 + lane], 0.f)
        : INFINITY;
  }
}

// |a|^2 of row `row` (0 past N), one fmaf chain over the features.
__device__ __forceinline__ float row_norm2(const float* __restrict__ ab,
                                           int row, int n, int c,
                                           long long a_sn) {
  float a2 = 0.f;
  if (row < n) {
    for (int f = 0; f < c; ++f) {
      const float x = ab[row * a_sn + f];
      a2 = fmaf(x, x, a2);
    }
  }
  return a2;
}

// K <= 8 at any C (used for C > 64): grid (ceil(N / 8), 1, B); each lane
// keeps a sorted list over its columns, then a butterfly merges the
// warp's 32 lists by (d2, column).
template <int K>
__global__ void __launch_bounds__(kThreads)
masked_topk_chunked_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           const unsigned char* __restrict__ b_valid,
                           float* __restrict__ out_d2,
                           int* __restrict__ out_idx, int n, int m, int c,
                           long long a_sb, long long a_sn, long long b_sb,
                           long long b_sn, long long v_sb) {
  __shared__ __align__(16) WalkSmem sm;
  const int batch = blockIdx.z, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kWalkRows, row = row0 + threadIdx.x / 32;
  const float* ab = a + batch * a_sb;
  const float a2 = row_norm2(ab, row, n, c, a_sn);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
  const float* bb = b + batch * b_sb;
  const unsigned char* vb = b_valid + batch * v_sb;
  for (int t0 = 0; t0 < m; t0 += kWalkTile) {
    float d[kWalkCols];
    tile_d2(sm, ab, bb, vb, row0, n, m, c, a_sn, b_sn, a2, t0, d);
#pragma unroll
    for (int u = 0; u < kWalkCols; ++u) {
      if (d[u] < bd[K - 1])
        insert<K, false>(bd, bi, d[u], t0 + u * 32 + lane);
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float od[K];
    int oi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      od[s] = __shfl_xor_sync(0xffffffffu, bd[s], off);
      oi[s] = __shfl_xor_sync(0xffffffffu, bi[s], off);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) insert<K, true>(bd, bi, od[s], oi[s]);
  }
  if (lane != 0 || row >= n) return;
  const size_t o = ((size_t)batch * n + row) * K;
  store<K>(out_d2 + o, out_idx + o, bd, bi, true);
}

// Any k <= M (used for k > 16) at any C: grid (ceil(N / 8), 1, B), one
// warp per row. Radix select of the row's k-th smallest d2 over four
// walks, a fifth that writes the k winners unsorted to the scratch
// (sc_bits: d2 bits, sc_idx: columns; (B, N, k) each), then a rank sort
// into the output.
__global__ void __launch_bounds__(kThreads)
masked_topk_wide_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const unsigned char* __restrict__ b_valid,
                        float* __restrict__ out_d2, int* __restrict__ out_idx,
                        unsigned* __restrict__ sc_bits,
                        int* __restrict__ sc_idx, int n, int m, int c, int k,
                        long long a_sb, long long a_sn, long long b_sb,
                        long long b_sn, long long v_sb) {
  __shared__ __align__(16) WalkSmem sm;
  __shared__ unsigned hist[kWalkRows][kBins];
  const int batch = blockIdx.z, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kWalkRows, row = row0 + warp;
  const float* ab = a + batch * a_sb;
  const float* bb = b + batch * b_sb;
  const unsigned char* vb = b_valid + batch * v_sb;
  const float a2 = row_norm2(ab, row, n, c, a_sn);
  // d2 >= 0 (the clamp; & clears the sign of a -0), so the bits order as
  // the values do; +inf (masked) after every finite d2
  auto bits_of = [](float d) { return __float_as_uint(d) & 0x7fffffffu; };

  // the k-th smallest d2 bits: `prefix` on the digits fixed so far,
  // `need` its rank among the columns that match them (1-based)
  unsigned prefix = 0u, fixed = 0u;
  int need = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = lane; i < kBins; i += 32) hist[warp][i] = 0u;
    __syncwarp();
    for (int t0 = 0; t0 < m; t0 += kWalkTile) {
      float d[kWalkCols];
      tile_d2(sm, ab, bb, vb, row0, n, m, c, a_sn, b_sn, a2, t0, d);
#pragma unroll
      for (int u = 0; u < kWalkCols; ++u) {
        const unsigned x = bits_of(d[u]);
        if (t0 + u * 32 + lane < m && (x & fixed) == prefix)
          atomicAdd(&hist[warp][(x >> shift) & (kBins - 1)], 1u);
      }
    }
    __syncwarp();
    // lane l holds bins 8 l .. 8 l + 7; an inclusive scan of their sums
    unsigned cnt[kBins / 32], sum = 0u;
#pragma unroll
    for (int i = 0; i < kBins / 32; ++i) {
      cnt[i] = hist[warp][(kBins / 32) * lane + i];
      sum += cnt[i];
    }
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const unsigned excl = incl - sum, want = static_cast<unsigned>(need);
    const unsigned owner = __ballot_sync(0xffffffffu,
                                         excl < want && want <= incl);
    const int src = __ffs(owner) - 1;  // one lane: k <= M columns counted
    int bin = 0;
    unsigned below = 0u;
    if (lane == src) {
      unsigned c0 = excl;
#pragma unroll
      for (int i = 0; i < kBins / 32; ++i) {
        if (c0 < want && want <= c0 + cnt[i]) {  // one i
          bin = (kBins / 32) * lane + i;
          below = c0;
        }
        c0 += cnt[i];
      }
    }
    bin = __shfl_sync(0xffffffffu, bin, src);
    below = __shfl_sync(0xffffffffu, below, src);
    need -= static_cast<int>(below);
    prefix |= static_cast<unsigned>(bin) << shift;
    fixed |= static_cast<unsigned>(kBins - 1) << shift;
  }

  // the winners: every column below the k-th d2 (slots 0 .. k - need - 1)
  // and the `need` lowest columns at it (slots k - need ..), each set in
  // column order by ballot ranks
  const size_t r0 = ((size_t)batch * n + min(row, n - 1)) * k;
  const bool live = row < n;
  const unsigned lower = (1u << lane) - 1u;
  int n_lt = 0, n_eq = 0;
  for (int t0 = 0; t0 < m; t0 += kWalkTile) {
    float d[kWalkCols];
    tile_d2(sm, ab, bb, vb, row0, n, m, c, a_sn, b_sn, a2, t0, d);
#pragma unroll
    for (int u = 0; u < kWalkCols; ++u) {
      const int j = t0 + u * 32 + lane;
      const unsigned x = bits_of(d[u]);
      const bool lt = j < m && x < prefix, eq = j < m && x == prefix;
      const unsigned bl = __ballot_sync(0xffffffffu, lt);
      const unsigned be = __ballot_sync(0xffffffffu, eq);
      if (live && lt) {
        const int s = n_lt + __popc(bl & lower);
        sc_bits[r0 + s] = x;
        sc_idx[r0 + s] = j;
      }
      if (live && eq) {
        const int e = n_eq + __popc(be & lower);
        if (e < need) {
          sc_bits[r0 + k - need + e] = x;
          sc_idx[r0 + k - need + e] = j;
        }
      }
      n_lt += __popc(bl);
      n_eq += __popc(be);
    }
  }
  __syncwarp();
  if (!live) return;
  // rank sort: an entry's slot is the number of entries before it in
  // (d2, column) order (the keys are distinct)
  for (int e = lane; e < k; e += 32) {
    const unsigned x = sc_bits[r0 + e];
    const int j = sc_idx[r0 + e];
    int slot = 0;
    for (int f = 0; f < k; ++f) {
      const unsigned y = sc_bits[r0 + f];
      slot += y < x || (y == x && sc_idx[r0 + f] < j);
    }
    out_d2[r0 + slot] = x == kInfBits ? kBig : __uint_as_float(x);
    out_idx[r0 + slot] = j;
  }
}

// the longest list of the list instances, and of the chunked ones (C >
// 64); above them the wide kernel
constexpr int kMaxListK = 16, kMaxChunkedK = 8;

// Whether a call takes the wide kernel.
bool wide_path(int c, int k) {
  return k > kMaxListK || (c > kWalkChunk && k > kMaxChunkedK);
}

int padded_width(int c) {
  return c <= BaseTiling<4>::kUsed ? 4 : (c <= BaseTiling<32>::kUsed ? 32 : 64);
}

template <int K, int CP>
int plan_splits_cp(int batch, int n, int m, int sms) {
  constexpr int rows = kRowsPerBlock<CP, K>;
  const long long base = (long long)((n + rows - 1) / rows) * batch;
  const long long target = 2LL * sms;     // two resident blocks per SM
  const int tiles = (m + Tiling<CP, K>::kTile - 1) / Tiling<CP, K>::kTile;
  long long s = target / (base > 0 ? base : 1);
  s = s < 1 ? 1 : (s > tiles ? tiles : s);
  const int per = (int)((tiles + s - 1) / s);
  return (tiles + per - 1) / per;
}

template <int K>
int plan_splits_k(int batch, int n, int m, int c, int sms) {
  switch (padded_width(c)) {
    case 4: return plan_splits_cp<K, 4>(batch, n, m, sms);
    case 32: return plan_splits_cp<K, 32>(batch, n, m, sms);
    default: return plan_splits_cp<K, 64>(batch, n, m, sms);
  }
}

// The column segments of a launch: the list instances K in {1, 5, 8, 16}
// at C <= 64 plan them; the walk kernels (C > 64, or k > 16) take 1; 0
// for a list k that is no instance.
int plan_splits(int batch, int n, int m, int c, int k, int sms) {
  if (wide_path(c, k)) return 1;
  if (c > kWalkChunk) return (k == 1 || k == 5 || k == 8) ? 1 : 0;
  switch (k) {
    case 1: return plan_splits_k<1>(batch, n, m, c, sms);
    case 5: return plan_splits_k<5>(batch, n, m, c, sms);
    case 8: return plan_splits_k<8>(batch, n, m, c, sms);
    case 16: return plan_splits_k<16>(batch, n, m, c, sms);
    default: return 0;
  }
}

template <int K, int CP>
void launch(const float* a, const float* b, const unsigned char* v,
            float* d2, int* idx, float* part_d2, int* part_idx, int batch,
            int n, int m, int c, int splits, const long long* st,
            cudaStream_t stream) {
  constexpr int kTile = Tiling<CP, K>::kTile;
  const int tiles = (m + kTile - 1) / kTile;
  const int seg = (tiles + splits - 1) / splits * kTile;
  const int rows = kRowsPerBlock<CP, K>;
  dim3 grid((n + rows - 1) / rows, splits, batch);
  masked_topk_cdist_kernel<K, CP><<<grid, kThreads, 0, stream>>>(
      a, b, v, splits == 1 ? d2 : part_d2, splits == 1 ? idx : part_idx, n,
      m, c, seg, st[0], st[1], st[2], st[3], st[4]);
  if (splits > 1) {
    const int total = batch * n;
    merge_splits_kernel<K><<<(total + kMergeThreads - 1) / kMergeThreads,
                             kMergeThreads, 0, stream>>>(
        part_d2, part_idx, d2, idx, n, splits, total);
  }
}

template <int K>
void launch_k(const float* a, const float* b, const unsigned char* v,
              float* d2, int* idx, float* part_d2, int* part_idx, int batch,
              int n, int m, int c, int splits, const long long* st,
              cudaStream_t stream) {
  if constexpr (K <= kMaxChunkedK) {
    if (c > kWalkChunk) {
      dim3 grid((n + kWalkRows - 1) / kWalkRows, 1, batch);
      masked_topk_chunked_kernel<K><<<grid, kThreads, 0, stream>>>(
          a, b, v, d2, idx, n, m, c, st[0], st[1], st[2], st[3], st[4]);
      return;
    }
  }
  switch (padded_width(c)) {
    case 4:
      launch<K, 4>(a, b, v, d2, idx, part_d2, part_idx, batch, n, m, c,
                   splits, st, stream);
      break;
    case 32:
      launch<K, 32>(a, b, v, d2, idx, part_d2, part_idx, batch, n, m, c,
                    splits, st, stream);
      break;
    default:
      launch<K, 64>(a, b, v, d2, idx, part_d2, part_idx, batch, n, m, c,
                    splits, st, stream);
  }
}

}  // namespace

// The number of column segments (grid.y) the launch below takes for this
// shape on a card with `sms` SMs (0 for a k <= 16 that is not an
// instance); with more than one, the caller passes partial-list buffers
// of (batch, splits, n, k).
extern "C" int masked_topk_cdist_splits(int batch, int n, int m, int c,
                                        int k, int sms) {
  return plan_splits(batch, n, m, c, k, sms);
}

// a (B, N, C) and b (B, M, C) f32 with unit feature stride and the given
// batch / row strides in elements; b_valid (B, M) bytes with batch
// stride v_sb. Any C >= 1; k in {1, 5, 8, 16} (1, 5, 8 at C > 64), or
// the wide kernel's k <= M (any k > 16, and 8 < k <= 16 at C > 64), for
// which part_d2 / part_idx are its (B, N, k) scratch.
extern "C" int masked_topk_cdist_f32(const void* a, const void* b,
                                     const void* b_valid, void* out_d2,
                                     void* out_idx, void* part_d2,
                                     void* part_idx, int batch, int n, int m,
                                     int c, int k, int splits, long long a_sb,
                                     long long a_sn, long long b_sb,
                                     long long b_sn, long long v_sb,
                                     void* stream) {
  if (c < 1 || splits < 1 || batch < 1 || n < 1 || m < 1 ||
      (splits > 1 && !(part_d2 && part_idx)) ||
      (splits > 1 && (c > kWalkChunk || k > kMaxListK)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const unsigned char* vf = static_cast<const unsigned char*>(b_valid);
  float* d2 = static_cast<float*>(out_d2);
  int* idx = static_cast<int*>(out_idx);
  float* pd = static_cast<float*>(part_d2);
  int* pi = static_cast<int*>(part_idx);
  const long long st[5] = {a_sb, a_sn, b_sb, b_sn, v_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide_path(c, k)) {
    if (k > m || !(part_d2 && part_idx))
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((n + kWalkRows - 1) / kWalkRows, 1, batch);
    masked_topk_wide_kernel<<<grid, kThreads, 0, s>>>(
        af, bf, vf, d2, idx, reinterpret_cast<unsigned*>(pd), pi, n, m, c, k,
        a_sb, a_sn, b_sb, b_sn, v_sb);
    return static_cast<int>(cudaGetLastError());
  }
  switch (k) {
    case 1:
      launch_k<1>(af, bf, vf, d2, idx, pd, pi, batch, n, m, c, splits, st, s);
      break;
    case 5:
      launch_k<5>(af, bf, vf, d2, idx, pd, pi, batch, n, m, c, splits, st, s);
      break;
    case 8:
      launch_k<8>(af, bf, vf, d2, idx, pd, pi, batch, n, m, c, splits, st, s);
      break;
    case 16:
      launch_k<16>(af, bf, vf, d2, idx, pd, pi, batch, n, m, c, splits, st, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
