// Fused masked cdist -> top-K (K = 1 is the masked argmin), f32.
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
// argmin takes column 0).
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
//   for C <= 64) with independent accumulators, the queries in
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
template <int CP> struct Tiling;
template <> struct Tiling<4> {
  static constexpr int kQpt = 8, kCpt = 4, kCl = 8, kTile = 256;
  static constexpr int kStride = 4, kUsed = 3, kMinBlocks = 1;
};
template <> struct Tiling<32> {
  static constexpr int kQpt = 2, kCpt = 2, kCl = 4, kTile = 128;
  static constexpr int kStride = 36, kUsed = 32, kMinBlocks = 2;
};
// 32 < C <= 64 (ZoomOut's embeddings): one query a thread, its 64
// features in registers, 4 columns of each of a warp's 8 column lanes per
// step; row stride 68 (17 4-bank groups: the 8 columns of one read land
// in distinct groups). Two blocks per SM cap the registers at 128
// without spills; measured 28 % faster than one block of 148 registers.
template <> struct Tiling<64> {
  static constexpr int kQpt = 1, kCpt = 4, kCl = 8, kTile = 128;
  static constexpr int kStride = 68, kUsed = 64, kMinBlocks = 2;
};

template <int CP>
constexpr int kRowsPerBlock = kWarps * (32 / Tiling<CP>::kCl) *
                              Tiling<CP>::kQpt;

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
__global__ void __launch_bounds__(kThreads, Tiling<CP>::kMinBlocks)
masked_topk_cdist_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         const unsigned char* __restrict__ b_valid,
                         float* __restrict__ out_d2, int* __restrict__ out_idx,
                         int n, int m, int c, int seg, long long a_sb,
                         long long a_sn, long long b_sb, long long b_sn,
                         long long v_sb) {
  using T = Tiling<CP>;
  constexpr int kQpt = T::kQpt, kCpt = T::kCpt, kCl = T::kCl;
  constexpr int kTile = T::kTile, kStride = T::kStride, kUsed = T::kUsed;
  constexpr int kStep = kCl * kCpt;          // columns of one warp step
  static_assert(kTile % kStep == 0, "a tile is whole steps");
  __shared__ __align__(16) float bs[kTile * kStride];
  __shared__ float b2s[kTile];

  const int batch = blockIdx.z, split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cl = lane % kCl, ql = lane / kCl;
  const int row0 = blockIdx.x * kRowsPerBlock<CP> +
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

int padded_width(int c) {
  return c <= Tiling<4>::kUsed ? 4 : (c <= Tiling<32>::kUsed ? 32 : 64);
}

template <int CP>
int plan_splits_cp(int batch, int n, int m, int sms) {
  constexpr int rows = kRowsPerBlock<CP>;
  const long long base = (long long)((n + rows - 1) / rows) * batch;
  const long long target = 2LL * sms;     // two resident blocks per SM
  const int tiles = (m + Tiling<CP>::kTile - 1) / Tiling<CP>::kTile;
  long long s = target / (base > 0 ? base : 1);
  s = s < 1 ? 1 : (s > tiles ? tiles : s);
  const int per = (int)((tiles + s - 1) / s);
  return (tiles + per - 1) / per;
}

int plan_splits(int batch, int n, int m, int c, int sms) {
  switch (padded_width(c)) {
    case 4: return plan_splits_cp<4>(batch, n, m, sms);
    case 32: return plan_splits_cp<32>(batch, n, m, sms);
    default: return plan_splits_cp<64>(batch, n, m, sms);
  }
}

template <int K, int CP>
void launch(const float* a, const float* b, const unsigned char* v,
            float* d2, int* idx, float* part_d2, int* part_idx, int batch,
            int n, int m, int c, int splits, const long long* st,
            cudaStream_t stream) {
  constexpr int kTile = Tiling<CP>::kTile;
  const int tiles = (m + kTile - 1) / kTile;
  const int seg = (tiles + splits - 1) / splits * kTile;
  const int rows = kRowsPerBlock<CP>;
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
// shape on a card with `sms` SMs; with more than one, the caller passes
// partial-list buffers of (batch, splits, n, k).
extern "C" int masked_topk_cdist_splits(int batch, int n, int m, int c,
                                        int sms) {
  return plan_splits(batch, n, m, c, sms);
}

// a (B, N, C) and b (B, M, C) f32 with unit feature stride and the given
// batch / row strides in elements; b_valid (B, M) bytes with batch
// stride v_sb. C <= 64, k in {1, 5}.
extern "C" int masked_topk_cdist_f32(const void* a, const void* b,
                                     const void* b_valid, void* out_d2,
                                     void* out_idx, void* part_d2,
                                     void* part_idx, int batch, int n, int m,
                                     int c, int k, int splits, long long a_sb,
                                     long long a_sn, long long b_sb,
                                     long long b_sn, long long v_sb,
                                     void* stream) {
  if (c < 1 || c > 64 || splits < 1 || (splits > 1 && !(part_d2 && part_idx)))
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
  switch (k) {
    case 1:
      launch_k<1>(af, bf, vf, d2, idx, pd, pi, batch, n, m, c, splits, st, s);
      break;
    case 5:
      launch_k<5>(af, bf, vf, d2, idx, pd, pi, batch, n, m, c, splits, st, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
