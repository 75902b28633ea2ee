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
// k above 16 (resolve --topk 24) share one register-tiled distance walk
// (walk_d2): each thread holds R rows x 2 columns of independent fmaf
// chains; features are staged 16 at a time (64 bytes of each column,
// swizzled against bank conflicts) by cp.async into two buffers, one
// float4 shared load feeding 4 R (or 8) FMAs. Its d2 is the expression
// above with the same fmaf chains over the features in order, bit for
// bit the list instances' value. Bound as above: C FMAs a pair.
// - masked_topk_chunked_kernel (K = 1, 5, 8 at C > 64): 16 rows a block;
//   each tile's d2 goes to shared memory, where each lane of a row's warp
//   keeps a sorted list of K (d2, column) over its columns; a butterfly
//   over the 32 lanes merges them as in the list instances, and column
//   segments across blocks fill the card at B = 1 (merged by
//   merge_splits_kernel). (A K = 16 list spilled there on an H100; 8 < k
//   <= 16 takes the wide path at C > 64, whose order and fill are those
//   of lax.top_k, which the JAX package runs above 8.)
// - masked_topk_wide_kernel (k > 16, any C): the register lists do not
//   scale with k, so a row's k-th smallest key (d2 bits, column; d2 >= 0,
//   so its bits order as the floats do; a masked column is +inf) is found
//   by radix select on the d2 bits, 4 bits a pass, each lane counting its
//   columns in registers and 8 warp reductions adding them up, starting
//   below the bits that the row's least and largest finite d2 share. For
//   k <= 64 it runs over candidates: the columns at or below the largest
//   of the lanes' ceil(k / 32)-th smallest d2 (at least k of them),
//   compacted in column order (at most 1024; else the whole row). Then the
//   keys below the k-th d2, and the lowest columns at it (ballot ranks in
//   column order), go to a (B, N, k) scratch; each lane then ranks its
//   entries among the k by (d2, column) and writes them to their slots.
//   8 rows a block, one warp a row. Two routes, which the wrapper picks
//   from M and the card's shared memory (ops/kernels/cdist.wide_route):
//   - rows: each row's M distances are computed once into shared memory
//     (8 rows x M x 4 bytes: M <= 5183 on an H100) and read there;
//   - walk: the distances are recomputed by each walk that needs them:
//     one for the row's statistics and one for the candidates (k <= 64),
//     and only where a row has more than 1024 candidates or k > 64, one
//     per radix pass (8, over bits 30 .. 0) and one for the winners; so
//     no M is refused.
//   Masked columns rank after every valid one in column order and come
//   out at 1e9: lax.top_k's order and fill (pose6d_tpu/ops/nn.py:81),
//   which is what the JAX package runs above k = 8.
//
// C interface (ctypes): returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"

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

// ---- The walk kernels: features above 64, or k above 16 ----

// The register-tiled distance walk. A block's kThreads threads compute the
// d2 of R rows x kTile = 2 kThreads columns per tile: thread t owns the R
// rows x columns t and t + kThreads, with 2 R independent fmaf chains.
// Features arrive in chunks of 16, copied with cp.async into two buffers
// (chunk q + 1 lands while chunk q is in use), over every tile of the
// block's columns in one sequence. A column's chunk is 64 contiguous bytes
// of b, in 16-, 8- or 4-byte copies as b's alignment allows, and sits in
// shared memory with its float4 swizzled by the column's index, so that 8
// consecutive columns' float4 reads land in 8 distinct bank groups; every
// thread reads the same row chunk (a broadcast). One b read feeds 4 R
// FMAs, one a read 8. The stage's size (columns x features a chunk) is set
// by the shared memory that the wide kernel's rows leave; 2 columns a
// thread x 16 features timed fastest of 1 x 32, 4 x 8 and 8 x 4 at C = 30,
// 96 and 128 (scripts/torch_cdist_tilings.py; H100 80GB HBM3, 700 W).
constexpr int kDigits = 16;                 // radix bins of 4 bits
constexpr unsigned kInfBits = 0x7f800000u;  // +inf: a masked column
constexpr unsigned kFull = 0xffffffffu;

template <int R>
struct Walk {
  static constexpr int kRows = R, kCols = 2, kFC = 16;
  static constexpr int kTile = kThreads * kCols, kVec = kFC / 4;
  // floats of the two stage buffers (the tile's columns, then the rows)
  static constexpr int kBuf = (kTile + R) * kFC;
  static constexpr int kStage = 2 * kBuf;
  // the rows' |a|^2 after the stage buffers (a multiple of 4 floats)
  static constexpr int kA2 = (R + 3) / 4 * 4;
  // float4 i of staged column jj: columns 2 apart alternate their float4
  // order, so 8 consecutive columns' float4 i meet 8 bank groups
  __device__ __forceinline__ static int at(int jj, int i) {
    return jj * kFC + 4 * (i ^ ((jj >> 1) & 3));
  }
};
// the wide kernel: 8 rows (one a warp for the select); the chunked
// kernel: 16 rows (two a warp), which halves the staged reads of b per row
using WideWalk = Walk<kWarps>;
using ChunkWalk = Walk<2 * kWarps>;

struct WalkArgs {
  const float* ab;            // the frame's a
  const float* bb;            // the frame's b
  const unsigned char* vb;    // the frame's b_valid
  int row0, n, c, j_begin, j_end;
  long long a_sn, b_sn;
  int pa, pb;                 // bytes a copy of a and of b: 16, 8 or 4
};

// One copy of `bytes` (at most P) into P bytes of shared memory.
template <int P>
__device__ __forceinline__ void copy(float* dst, const float* src,
                                     int bytes) {
  if constexpr (P == 16)
    async_copy::copy16n(dst, src, bytes);
  else if constexpr (P == 8)
    async_copy::copy8n(dst, src, bytes);
  else
    async_copy::copy4(dst, src, bytes != 0);
}

// The tile's columns t0 .. t0 + kTile - 1 (zeros past j_end) of chunk
// features f0 .. f0 + 15 (zeros past nf of them), in P-byte copies:
// consecutive threads take consecutive pieces of a column.
template <class W, int P>
__device__ __forceinline__ void stage_cols(const WalkArgs& w, float* bs,
                                           int t0, int f0, int nf) {
  constexpr int kF = P / 4, kPieces = W::kFC / kF;
#pragma unroll 8
  for (int i = 0; i < W::kCols * kPieces; ++i) {
    const int e = threadIdx.x + kThreads * i, jj = e / kPieces;
    const int f = e % kPieces * kF, j = t0 + jj;
    const int bytes = j < w.j_end ? 4 * max(0, min(kF, nf - f)) : 0;
    copy<P>(bs + W::at(jj, f / 4) + f % 4,
            bytes ? w.bb + (size_t)j * w.b_sn + f0 + f : w.bb, bytes);
  }
}

// The rows row0 .. row0 + R - 1 (zeros past N) of the chunk, unswizzled.
template <class W, int P>
__device__ __forceinline__ void stage_rows(const WalkArgs& w, float* as,
                                           int f0, int nf) {
  constexpr int kF = P / 4, kPieces = W::kFC / kF;
  for (int e = threadIdx.x; e < W::kRows * kPieces; e += kThreads) {
    const int row = w.row0 + e / kPieces, f = e % kPieces * kF;
    const int bytes = row < w.n ? 4 * max(0, min(kF, nf - f)) : 0;
    copy<P>(as + e * kF,
            bytes ? w.ab + (size_t)row * w.a_sn + f0 + f : w.ab, bytes);
  }
}

// Issues the copies of chunk `ch` (features 16 ch .. 16 ch + 15, zeros
// past C) of the tile at column t0 into stage buffer `buf`.
template <class W>
__device__ __forceinline__ void stage_chunk(const WalkArgs& w, float* stage,
                                            int buf, int t0, int ch) {
  float* bs = stage + buf * W::kBuf;
  float* as = bs + W::kTile * W::kFC;
  const int f0 = ch * W::kFC, nf = min(W::kFC, w.c - f0);
  switch (w.pb) {  // uniform
    case 16: stage_cols<W, 16>(w, bs, t0, f0, nf); break;
    case 8: stage_cols<W, 8>(w, bs, t0, f0, nf); break;
    default: stage_cols<W, 4>(w, bs, t0, f0, nf);
  }
  switch (w.pa) {
    case 16: stage_rows<W, 16>(w, as, f0, nf); break;
    case 8: stage_rows<W, 8>(w, as, f0, nf); break;
    default: stage_rows<W, 4>(w, as, f0, nf);
  }
}

// The walk over the block's columns [j_begin, j_end) in tiles of kTile.
// After a tile's last chunk each thread passes the d2 of its R rows x U
// columns below j_end to put(r, jj, t0, d) (jj the column within the tile
// at t0; +inf for a masked column), then, after a barrier, every thread
// calls done(t0); the next tile's puts come after another barrier. d2 is
// the list instances' expression: a.b, |b|^2 as fmaf chains over the
// features in order (the zero features past C add exact zeros), then
// fmaxf(fmaf(-2, a.b, |a|^2) + |b|^2, 0) with |a|^2 = a2s[r]. Whole block.
template <class W, class Put, class Done>
__device__ __forceinline__ void walk_d2(const WalkArgs& w, float* stage,
                                        const float* a2s, Put put,
                                        Done done) {
  constexpr int R = W::kRows, U = W::kCols;  // U: columns a thread
  const int nch = (w.c + W::kFC - 1) / W::kFC;
  const int total = (w.j_end - w.j_begin + W::kTile - 1) / W::kTile * nch;
  float acc[R][U], b2[U];
  bool valid[U];  // the tile's columns' mask, read at its first chunk
#pragma unroll
  for (int u = 0; u < U; ++u) {
    b2[u] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][u] = 0.f;
  }
  if (total > 0) stage_chunk<W>(w, stage, 0, w.j_begin, 0);
  async_copy::commit();
  for (int q = 0; q < total; ++q) {
    const int t0 = w.j_begin + q / nch * W::kTile, ch = q % nch;
    if (q + 1 < total)
      stage_chunk<W>(w, stage, (q + 1) & 1,
                        w.j_begin + (q + 1) / nch * W::kTile, (q + 1) % nch);
    async_copy::commit();
    async_copy::wait<1>();
    __syncthreads();
    if (ch == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = t0 + threadIdx.x + kThreads * u;
        valid[u] = j < w.j_end && w.vb[j];
      }
    }
    const float* bs = stage + (q & 1) * W::kBuf;
    const float4* as =
        reinterpret_cast<const float4*>(bs + W::kTile * W::kFC);
#pragma unroll
    for (int i = 0; i < W::kVec; ++i) {
      float4 bv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        bv[u] = *reinterpret_cast<const float4*>(
            bs + W::at(threadIdx.x + kThreads * u, i));
        b2[u] = fmaf(bv[u].x, bv[u].x, b2[u]);
        b2[u] = fmaf(bv[u].y, bv[u].y, b2[u]);
        b2[u] = fmaf(bv[u].z, bv[u].z, b2[u]);
        b2[u] = fmaf(bv[u].w, bv[u].w, b2[u]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 av = as[r * W::kVec + i];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          acc[r][u] = fmaf(av.x, bv[u].x, acc[r][u]);
          acc[r][u] = fmaf(av.y, bv[u].y, acc[r][u]);
          acc[r][u] = fmaf(av.z, bv[u].z, acc[r][u]);
          acc[r][u] = fmaf(av.w, bv[u].w, acc[r][u]);
        }
      }
    }
    if (ch == nch - 1) {  // uniform: the tile's d2 is complete
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = threadIdx.x + kThreads * u, j = t0 + jj;
        const bool in = j < w.j_end, ok = valid[u];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (in)
            put(r, jj, t0,
                ok ? fmaxf(fmaf(-2.f, acc[r][u], a2s[r]) + b2[u], 0.f)
                   : INFINITY);
          acc[r][u] = 0.f;
        }
        b2[u] = 0.f;
      }
      __syncthreads();
      done(t0);
    }
    __syncthreads();  // buffer q & 1 is refilled by the next iteration
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

// d2 >= 0 (the clamp; & clears the sign of a -0), so the bits order as the
// values do; +inf (masked) after every finite d2.
__device__ __forceinline__ unsigned d2_bits(float d) {
  return __float_as_uint(d) & 0x7fffffffu;
}

// A warp's radix select of the k-th smallest d2 bits among its row's
// columns, 4 bits a pass from bit `top` down: `prefix` holds the bits
// fixed so far (`fixed`), `need` the k-th's rank among the columns that
// match them (1-based). Each lane counts its own columns in registers (16
// bins of 8 bits in c[4]: at most 255 between flushes), and a flush adds
// the 32 lanes' counts with 8 warp reductions (16-bit halves) into the
// totals that every lane holds. Integer counts: any order of columns
// gives the same result.
struct Radix {
  unsigned prefix, fixed, mask, c[4], tot[kDigits];
  int need, top, shift;

  __device__ __forceinline__ void init(int top_, unsigned prefix_,
                                       unsigned fixed_, int need_) {
    top = top_;
    prefix = prefix_;
    fixed = fixed_;
    need = need_;
  }
  __device__ __forceinline__ bool more() const { return top >= 0; }
  __device__ __forceinline__ void start() {
    const int width = min(4, top + 1);
    shift = top + 1 - width;
    mask = (1u << width) - 1u;
#pragma unroll
    for (int q = 0; q < 4; ++q) c[q] = 0u;
#pragma unroll
    for (int d = 0; d < kDigits; ++d) tot[d] = 0u;
  }
  __device__ __forceinline__ void count(unsigned x) {
    if ((x & fixed) == prefix) {
      const unsigned d = (x >> shift) & mask, inc = 1u << (8 * (d & 3u));
#pragma unroll
      for (int q = 0; q < 4; ++q) c[q] += (d >> 2) == q ? inc : 0u;
    }
  }
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned even = __reduce_add_sync(kFull, c[q] & 0x00ff00ffu);
      const unsigned odd = __reduce_add_sync(kFull, (c[q] >> 8) & 0x00ff00ffu);
      tot[4 * q] += even & 0xffffu;
      tot[4 * q + 1] += odd & 0xffffu;
      tot[4 * q + 2] += even >> 16;
      tot[4 * q + 3] += odd >> 16;
      c[q] = 0u;
    }
  }
  // the first bin whose running count reaches `need` (one exists: the
  // columns that match the prefix number at least `need`)
  __device__ __forceinline__ void finish() {
    flush();
    unsigned cum = 0u, below = 0u;
    int b = -1;
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
      if (b < 0 && cum + tot[d] >= static_cast<unsigned>(need)) {
        b = d;
        below = cum;
      }
      cum += tot[d];
    }
    need -= static_cast<int>(below);
    prefix |= static_cast<unsigned>(b) << shift;
    fixed |= mask << shift;
    top = shift - 1;
  }
};

// The winners of a row, visited in 32-column groups in column order: every
// column below the k-th d2 bits `thr` (slots 0 .. k - need - 1) and the
// `need` lowest columns at it (slots k - need ..), each set in column order
// by ballot ranks, written to the (B, N, k) scratch at r0.
struct Winners {
  unsigned thr;
  int need, n_lt, n_eq, k;
  size_t r0;
  bool live;

  __device__ __forceinline__ void group(unsigned* __restrict__ sc_bits,
                                        int* __restrict__ sc_idx, unsigned x,
                                        int j, bool in) {
    const unsigned lower = (1u << (threadIdx.x % 32)) - 1u;
    const bool lt = in && x < thr, eq = in && x == thr;
    const unsigned bl = __ballot_sync(kFull, lt);
    const unsigned be = __ballot_sync(kFull, eq);
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
};

// A warp's row statistics over its columns (visited in any order): the
// least bits, the largest finite bits and the finite count (every finite
// d2 shares the bits above the highest one where the least and the
// largest differ, so a select starts below them), and each lane's two
// smallest bits.
struct RowStats {
  unsigned m1 = kFull, m2 = kFull, lo, hi = 0u;
  int nf = 0;

  __device__ __forceinline__ void add(unsigned x) {
    if (x < m1) {
      m2 = m1;
      m1 = x;
    } else if (x < m2) {
      m2 = x;
    }
    if (x < kInfBits) {
      hi = max(hi, x);
      ++nf;
    }
  }
  __device__ __forceinline__ void reduce() {
    lo = __reduce_min_sync(kFull, m1);
    hi = __reduce_max_sync(kFull, hi);
    nf = __reduce_add_sync(kFull, nf);
  }
  // for k <= 64: the largest, over the lanes, of a lane's ceil(k / 32)-th
  // smallest bits; at least k columns lie at or below it
  __device__ __forceinline__ unsigned bound(int k) const {
    return __reduce_max_sync(kFull, k <= 32 ? m1 : m2);
  }
};

// candidates a warp keeps: (d2 bits, column) pairs
constexpr int kCand = 1024;
constexpr int kMaxCandK = 64;  // k for which the bound above exists

// The columns at or below `bound`, visited in 32-column groups in column
// order, compacted in that order into (bits, column) pairs; n past kCand
// counts them without storing.
struct Compactor {
  unsigned bound;
  int n;
  unsigned* cbits;
  int* ccol;

  __device__ __forceinline__ void group(unsigned x, int j, bool in) {
    const bool take = in && x <= bound;
    const unsigned bal = __ballot_sync(kFull, take);
    const int at = n + __popc(bal & ((1u << (threadIdx.x % 32)) - 1u));
    if (take && at < kCand) {
      cbits[at] = x;
      ccol[at] = j;
    }
    n += __popc(bal);
  }
};

// The k-th smallest bits of a row (win.thr) and the rank `need` among the
// columns at them, from the row's statistics and `len` of its values
// (value(i)), which hold every column at or below the k-th.
template <class Value>
__device__ __forceinline__ void select_row(Radix& rx, Winners& win,
                                           const RowStats& st, int k,
                                           int len, Value value) {
  if (k > st.nf) {  // every finite column wins, then the first masked ones
    win.thr = kInfBits;
    win.need = k - st.nf;
  } else if (st.lo == st.hi) {
    win.thr = st.lo;
    win.need = k;
  } else {
    const int top = 31 - __clz(st.lo ^ st.hi);
    const unsigned fixed = ~((2u << top) - 1u);
    rx.init(top, st.lo & fixed, fixed, k);
    while (rx.more()) {
      rx.start();
      for (int i = threadIdx.x % 32; i < len; i += 32) rx.count(value(i));
      rx.finish();
    }
    win.thr = rx.prefix;
    win.need = rx.need;
  }
}

// The dynamic shared memory of the wide kernel's two routes: the stage
// buffers, the rows' |a|^2, then either every row's M distances (rows in
// shared memory; the select's candidates reuse the stage buffers) or one
// tile of distances and the candidates (the walk recomputed).
constexpr int kWideFixedFloats = WideWalk::kStage + WideWalk::kA2;
constexpr int kCandFloats = 2 * kWarps * kCand;
static_assert(kCandFloats <= WideWalk::kStage, "candidates fit the stage");
size_t wide_smem_bytes(int m, bool rows) {
  return 4 * (kWideFixedFloats +
              (rows ? (size_t)kWarps * m
                    : (size_t)kWarps * WideWalk::kTile + kCandFloats));
}
constexpr int kChunkSmemBytes =
    4 * (ChunkWalk::kStage + ChunkWalk::kA2 +
         ChunkWalk::kRows * ChunkWalk::kTile);
// the blocks per SM that the chunked kernel's shared memory allows (of the
// H100's 228 KB), for its registers' cap
constexpr int kChunkMinBlocks = kChunkSmemBytes <= 113 * 1024 ? 2 : 1;

// Any k <= M (used for k > 16, and 8 < k <= 16 above 64 features) at any
// C: grid (ceil(N / 8), 1, B), warp w selects row row0 + w. The winners
// go unsorted to the scratch (sc_bits: d2 bits, sc_idx: columns; (B, N, k)
// each), then a rank sort writes the output. For k <= 64 each lane's
// ceil(k / 32) smallest bits bound the row's k-th smallest by the largest
// of them over the lanes, and the columns at or below that bound are
// compacted, in column order, into at most kCand candidates, over which
// the select runs and the winners are found; more candidates (heavy ties)
// or k above 64 take the whole row. kRows: every row's d2 is computed once
// into shared memory (rows x M x 4 bytes must fit) and read there; else
// walks recompute it: one for the statistics, one for the candidates and,
// only where a row needs them, the radix passes over bits 30 .. 0 (8, +inf
// included) and the winners (no M refused).
template <bool kRows>
__global__ void __launch_bounds__(kThreads, 1)
masked_topk_wide_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const unsigned char* __restrict__ b_valid,
                        float* __restrict__ out_d2, int* __restrict__ out_idx,
                        unsigned* __restrict__ sc_bits,
                        int* __restrict__ sc_idx, int n, int m, int c, int k,
                        long long a_sb, long long a_sn, long long b_sb,
                        long long b_sn, long long v_sb, int pa, int pb) {
  using W = WideWalk;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* a2s = smem + W::kStage;
  float* dist = a2s + W::kA2;  // rows (kRows) or a tile
  const int batch = blockIdx.z, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kWarps, row = row0 + warp;
  const WalkArgs w{a + batch * a_sb, b + batch * b_sb, b_valid + batch * v_sb,
                   row0, n, c, 0, m, a_sn, b_sn, pa, pb};
  if (threadIdx.x < kWarps)
    a2s[threadIdx.x] = row_norm2(w.ab, row0 + threadIdx.x, n, c, a_sn);
  // (a2s is read after the walk's first barrier)
  const float* mine =
      dist + (kRows ? (size_t)warp * m : (size_t)warp * W::kTile);
  unsigned* cbits = reinterpret_cast<unsigned*>(
                        kRows ? stage : dist + kWarps * W::kTile) +
                    warp * 2 * kCand;
  int* ccol = reinterpret_cast<int*>(cbits + kCand);
  auto cand_value = [&](int i) { return cbits[i]; };

  Winners win;
  win.k = k;
  win.n_lt = win.n_eq = 0;
  win.live = row < n;
  win.r0 = ((size_t)batch * n + min(row, n - 1)) * k;
  Radix rx;
  RowStats st;
  Compactor cp{0u, 0, cbits, ccol};
  if constexpr (kRows) {
    walk_d2<W>(
        w, stage, a2s,
        [&](int r, int jj, int t0, float d) {
          dist[(size_t)r * m + t0 + jj] = d;
        },
        [](int) {});
    // 8 loads a lane ahead of their use (the candidates' stores below may
    // alias them for the compiler)
    constexpr int kAhead = 8;
    for (int j0 = 0; j0 < m; j0 += 32 * kAhead) {
      unsigned x[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = j0 + 32 * u + lane;
        x[u] = j < m ? d2_bits(mine[j]) : kFull;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (j0 + 32 * u + lane < m) st.add(x[u]);
    }
    st.reduce();
    bool cand = false;
    if (k <= st.nf && k <= kMaxCandK) {
      cp.bound = st.bound(k);
      for (int j0 = 0; j0 < m; j0 += 32 * kAhead) {
        unsigned x[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int j = j0 + 32 * u + lane;
          x[u] = j < m ? d2_bits(mine[j]) : kFull;
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int j = j0 + 32 * u + lane;
          cp.group(x[u], j, j < m);
        }
      }
      cand = cp.n <= kCand;
    }
    if (cand) {
      select_row(rx, win, st, k, cp.n, cand_value);
      for (int i0 = 0; i0 < cp.n; i0 += 32) {
        const int i = i0 + lane;
        win.group(sc_bits, sc_idx, i < cp.n ? cbits[i] : kFull,
                  i < cp.n ? ccol[i] : 0, i < cp.n);
      }
    } else {
      select_row(rx, win, st, k, m,
                 [&](int j) { return d2_bits(mine[j]); });
      for (int j0 = 0; j0 < m; j0 += 32) {
        const int j = j0 + lane;
        win.group(sc_bits, sc_idx, j < m ? d2_bits(mine[j]) : kFull, j,
                  j < m);
      }
    }
  } else {
    auto put = [&](int r, int jj, int, float d) {
      dist[r * W::kTile + jj] = d;
    };
    walk_d2<W>(w, stage, a2s, put, [&](int t0) {
      for (int i = lane; i < W::kTile; i += 32)
        if (t0 + i < m) st.add(d2_bits(mine[i]));
    });
    st.reduce();
    // how this warp's row is selected: 0 from candidates, 1 by radix
    // walks, 2 every finite column (k > the finite count)
    int mode = k > st.nf ? 2 : (k <= kMaxCandK ? 0 : 1);
    if (__syncthreads_or(mode == 0)) {
      cp.bound = mode == 0 ? st.bound(k) : 0u;
      walk_d2<W>(w, stage, a2s, put, [&](int t0) {
        if (mode != 0) return;
        for (int i = 0; i < W::kTile; i += 32) {
          const int j = t0 + i + lane;
          cp.group(j < m ? d2_bits(mine[i + lane]) : kFull, j, j < m);
        }
      });
      if (mode == 0 && cp.n > kCand) mode = 1;
    }
    if (mode == 0) select_row(rx, win, st, k, cp.n, cand_value);
    if (mode == 2) select_row(rx, win, st, k, 0, cand_value);
    if (__syncthreads_or(mode == 1)) {
      // the same passes for every warp, so the block's walks stay together
      rx.init(30, 0u, 0x80000000u, k);
      while (rx.more()) {
        rx.start();
        walk_d2<W>(w, stage, a2s, put, [&](int t0) {
          if (mode != 1) return;
#pragma unroll 4
          for (int i = lane; i < W::kTile; i += 32)
            if (t0 + i < m) rx.count(d2_bits(mine[i]));
          rx.flush();  // at most kTile / 32 columns a lane per tile
        });
        rx.finish();
      }
      if (mode == 1) {
        win.thr = rx.prefix;
        win.need = rx.need;
      }
    }
    if (mode == 0) {
      for (int i0 = 0; i0 < cp.n; i0 += 32) {
        const int i = i0 + lane;
        win.group(sc_bits, sc_idx, i < cp.n ? cbits[i] : kFull,
                  i < cp.n ? ccol[i] : 0, i < cp.n);
      }
    }
    if (__syncthreads_or(mode != 0)) {
      walk_d2<W>(w, stage, a2s, put, [&](int t0) {
        if (mode == 0) return;
        for (int i = 0; i < W::kTile; i += 32) {
          const int j = t0 + i + lane;
          win.group(sc_bits, sc_idx, j < m ? d2_bits(mine[i + lane]) : kFull,
                    j, j < m);
        }
      });
    }
  }
  __syncwarp();
  if (!win.live) return;
  // rank sort: an entry's slot is the number of entries before it in
  // (d2, column) order (the keys are distinct)
  const size_t r0 = win.r0;
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

// K <= 8 above 64 features: grid (ceil(N / 16), splits, B); warp w keeps
// rows row0 + 2 w and + 1. After each tile of d2 in shared memory, each
// lane inserts its columns (32 i + lane, in increasing order) into a
// sorted list per row; at the end a butterfly merges the warp's 32 lists
// by (d2, column). With one split the block writes the output, with more
// its segment's partial lists (merged by merge_splits_kernel), as the list
// instances do.
template <int K>
__global__ void __launch_bounds__(kThreads, kChunkMinBlocks)
masked_topk_chunked_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           const unsigned char* __restrict__ b_valid,
                           float* __restrict__ out_d2,
                           int* __restrict__ out_idx, int n, int m, int c,
                           int seg, long long a_sb, long long a_sn,
                           long long b_sb, long long b_sn, long long v_sb,
                           int pa, int pb) {
  using W = ChunkWalk;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* a2s = smem + W::kStage;
  float* tile = a2s + W::kA2;
  const int batch = blockIdx.z, split = blockIdx.y, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * W::kRows, j_begin = split * seg;
  const WalkArgs w{a + batch * a_sb, b + batch * b_sb, b_valid + batch * v_sb,
                   row0, n, c, j_begin, min(m, j_begin + seg), a_sn, b_sn,
                   pa, pb};
  if (threadIdx.x < W::kRows)
    a2s[threadIdx.x] = row_norm2(w.ab, row0 + threadIdx.x, n, c, a_sn);
  float bd[2][K];
  int bi[2][K];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[rr][s] = INFINITY;
      bi[rr][s] = 0;
    }
  }
  walk_d2<W>(
      w, stage, a2s,
      [&](int r, int jj, int, float d) { tile[r * W::kTile + jj] = d; },
      [&](int t0) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float* d = tile + (2 * warp + rr) * W::kTile;
#pragma unroll
          for (int i = 0; i < W::kTile; i += 32) {
            const float x = d[i + lane];
            if (t0 + i + lane < w.j_end && x < bd[rr][K - 1])
              insert<K, false>(bd[rr], bi[rr], x, t0 + i + lane);
          }
        }
      });
  const bool final_out = gridDim.y == 1;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float od[K];
      int oi[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        od[s] = __shfl_xor_sync(kFull, bd[rr][s], off);
        oi[s] = __shfl_xor_sync(kFull, bi[rr][s], off);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) insert<K, true>(bd[rr], bi[rr], od[s], oi[s]);
    }
    const int row = row0 + 2 * warp + rr;
    if (lane == 0 && row < n) {
      const size_t o = ((size_t)(batch * gridDim.y + split) * n + row) * K;
      store<K>(out_d2 + o, out_idx + o, bd[rr], bi[rr], final_out);
    }
  }
}

// the longest list of the list instances (features up to kMaxListC), and
// of the chunked ones (above); above them the wide kernel
constexpr int kMaxListK = 16, kMaxChunkedK = 8, kMaxListC = 64;

// Whether a call takes the wide kernel.
bool wide_path(int c, int k) {
  return k > kMaxListK || (c > kMaxListC && k > kMaxChunkedK);
}

int padded_width(int c) {
  return c <= BaseTiling<4>::kUsed ? 4 : (c <= BaseTiling<32>::kUsed ? 32 : 64);
}

// Column segments for blocks of `rows` rows walking `m` columns in tiles
// of `tile`: enough for two resident blocks per SM, whole tiles each.
int plan_splits_rows(int batch, int n, int m, int rows, int tile, int sms) {
  const long long base = (long long)((n + rows - 1) / rows) * batch;
  const long long target = 2LL * sms;     // two resident blocks per SM
  const int tiles = (m + tile - 1) / tile;
  long long s = target / (base > 0 ? base : 1);
  s = s < 1 ? 1 : (s > tiles ? tiles : s);
  const int per = (int)((tiles + s - 1) / s);
  return (tiles + per - 1) / per;
}

template <int K>
int plan_splits_k(int batch, int n, int m, int c, int sms) {
  switch (padded_width(c)) {
    case 4:
      return plan_splits_rows(batch, n, m, kRowsPerBlock<4, K>,
                              Tiling<4, K>::kTile, sms);
    case 32:
      return plan_splits_rows(batch, n, m, kRowsPerBlock<32, K>,
                              Tiling<32, K>::kTile, sms);
    default:
      return plan_splits_rows(batch, n, m, kRowsPerBlock<64, K>,
                              Tiling<64, K>::kTile, sms);
  }
}

// The column segments of a launch: the list instances K in {1, 5, 8, 16}
// at C <= 64 and the chunked ones K in {1, 5, 8} above plan them; the wide
// kernel takes 1; 0 for a list k that is no instance.
int plan_splits(int batch, int n, int m, int c, int k, int sms) {
  if (wide_path(c, k)) return 1;
  if (c > kMaxListC)
    return (k == 1 || k == 5 || k == 8)
               ? plan_splits_rows(batch, n, m, ChunkWalk::kRows,
                                  ChunkWalk::kTile, sms)
               : 0;
  switch (k) {
    case 1: return plan_splits_k<1>(batch, n, m, c, sms);
    case 5: return plan_splits_k<5>(batch, n, m, c, sms);
    case 8: return plan_splits_k<8>(batch, n, m, c, sms);
    case 16: return plan_splits_k<16>(batch, n, m, c, sms);
    default: return 0;
  }
}

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// The walk kernels with dynamic shared memory up to the card's opt-in
// allowed (once).
void prepare_walk_kernels() {
  static const bool done = [] {
    const int bytes = smem_optin();
    const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaFuncSetAttribute(masked_topk_wide_kernel<true>, attr, bytes);
    cudaFuncSetAttribute(masked_topk_wide_kernel<false>, attr, bytes);
    cudaFuncSetAttribute(masked_topk_chunked_kernel<1>, attr, bytes);
    cudaFuncSetAttribute(masked_topk_chunked_kernel<5>, attr, bytes);
    cudaFuncSetAttribute(masked_topk_chunked_kernel<8>, attr, bytes);
    return true;
  }();
  (void)done;
}

// The bytes of each copy of a row of f32 features at this base, batch
// stride and row stride (in elements): 16, 8 or 4, as the alignment
// allows.
int piece_bytes(const void* p, long long sb, long long sn) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  if (a % 16 == 0 && sb % 4 == 0 && sn % 4 == 0) return 16;
  if (a % 8 == 0 && sb % 2 == 0 && sn % 2 == 0) return 8;
  return 4;
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
}

template <int K>
void merge(float* d2, int* idx, const float* part_d2, const int* part_idx,
           int batch, int n, int splits, cudaStream_t stream) {
  const int total = batch * n;
  merge_splits_kernel<K><<<(total + kMergeThreads - 1) / kMergeThreads,
                           kMergeThreads, 0, stream>>>(
      part_d2, part_idx, d2, idx, n, splits, total);
}

template <int K>
void launch_k(const float* a, const float* b, const unsigned char* v,
              float* d2, int* idx, float* part_d2, int* part_idx, int batch,
              int n, int m, int c, int splits, const long long* st,
              cudaStream_t stream) {
  if constexpr (K <= kMaxChunkedK) {
    if (c > kMaxListC) {
      prepare_walk_kernels();
      constexpr int kTile = ChunkWalk::kTile;
      const int seg = ((m + kTile - 1) / kTile + splits - 1) / splits * kTile;
      dim3 grid((n + ChunkWalk::kRows - 1) / ChunkWalk::kRows, splits, batch);
      masked_topk_chunked_kernel<K>
          <<<grid, kThreads, kChunkSmemBytes, stream>>>(
              a, b, v, splits == 1 ? d2 : part_d2,
              splits == 1 ? idx : part_idx, n, m, c, seg, st[0], st[1],
              st[2], st[3], st[4], piece_bytes(a, st[0], st[1]),
              piece_bytes(b, st[2], st[3]));
      if (splits > 1) merge<K>(d2, idx, part_d2, part_idx, batch, n, splits,
                               stream);
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
  if (splits > 1) merge<K>(d2, idx, part_d2, part_idx, batch, n, splits,
                           stream);
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

// The dynamic shared memory in bytes that the wide kernel takes at M
// columns with every row's distances kept (rows != 0) or with the walk
// recomputed (rows == 0), at most INT_MAX.
extern "C" int masked_topk_cdist_wide_smem(int m, int rows) {
  const size_t bytes = wide_smem_bytes(m, rows != 0);
  return bytes > 0x7fffffffu ? 0x7fffffff : static_cast<int>(bytes);
}

// a (B, N, C) and b (B, M, C) f32 with unit feature stride and the given
// batch / row strides in elements; b_valid (B, M) bytes with batch
// stride v_sb. Any C >= 1; k in {1, 5, 8, 16} (1, 5, 8 at C > 64), for
// which part_d2 / part_idx are the segments' partial lists when splits >
// 1, or the wide kernel's k <= M (any k > 16, and 8 < k <= 16 at C > 64),
// for which they are its (B, N, k) scratch and wide_route picks its route:
// 0 every row's distances in shared memory (refused where they do not
// fit), 1 the walk recomputed every pass.
extern "C" int masked_topk_cdist_f32(const void* a, const void* b,
                                     const void* b_valid, void* out_d2,
                                     void* out_idx, void* part_d2,
                                     void* part_idx, int batch, int n, int m,
                                     int c, int k, int splits, int wide_route,
                                     long long a_sb, long long a_sn,
                                     long long b_sb, long long b_sn,
                                     long long v_sb, void* stream) {
  if (c < 1 || splits < 1 || batch < 1 || n < 1 || m < 1 ||
      (splits > 1 && !(part_d2 && part_idx)) ||
      (splits > 1 && wide_path(c, k)))
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
    const bool rows = wide_route == 0;
    if (k > m || !(part_d2 && part_idx) || (wide_route != 0 && wide_route != 1) ||
        wide_smem_bytes(m, rows) > static_cast<size_t>(smem_optin()))
      return static_cast<int>(cudaErrorInvalidValue);
    prepare_walk_kernels();
    dim3 grid((n + kWarps - 1) / kWarps, 1, batch);
    const size_t bytes = wide_smem_bytes(m, rows);
    const int pa = piece_bytes(a, a_sb, a_sn), pb = piece_bytes(b, b_sb, b_sn);
    unsigned* sb = reinterpret_cast<unsigned*>(pd);
    if (rows)
      masked_topk_wide_kernel<true><<<grid, kThreads, bytes, s>>>(
          af, bf, vf, d2, idx, sb, pi, n, m, c, k, a_sb, a_sn, b_sb, b_sn,
          v_sb, pa, pb);
    else
      masked_topk_wide_kernel<false><<<grid, kThreads, bytes, s>>>(
          af, bf, vf, d2, idx, sb, pi, n, m, c, k, a_sb, a_sn, b_sb, b_sn,
          v_sb, pa, pb);
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
