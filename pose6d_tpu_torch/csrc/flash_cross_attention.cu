// Masked multi-head cross-attention forward with an online softmax, f32.
//
// Replaces the TPU kernel pose6d_tpu/ops/pallas/attention.py:30
// flash_cross_attention (which wraps JAX's library Pallas flash
// attention, pads head_dim 16 -> 128 and folds the key mask into a
// -1e9 bias channel). Here the key-validity mask comes in directly and
// there is no padding. Layout is the refiner's (dim, heads) channel
// split: q (B, N, DIM, H), k/v (B, M, DIM, H), out (B, N, DIM, H);
// channel c of a projection is c = d * H + h. The scale is 1/sqrt(DIM).
// A query row with no valid key returns zeros, as masked_softmax does
// on the XLA branch.
//
// Optional output for training: lse (B, N, H), the log-sum-exp of the
// scaled scores of each (query, head) row over its valid keys, -inf for
// a row with no valid key. The backward (flash_cross_attention_bwd.cu)
// recomputes the probabilities from it. Serving passes a null pointer.
//
// What bounds it on the H100: instruction issue. One call of the
// refiner is 5120 x 2048 (query, key) pairs x 2 heads, each 2 x 16 FMAs
// and one expf (~1.4 GFLOP per frame with every key valid), against
// ~1 MB of q, k, v and out; the scores never reach memory. The sm_90a
// build issues ~52 instructions per (query, head, key) (cuobjdump -sass:
// ~1670 per step of 8 keys x 4 rows): 32 FFMA of the two products, ~7
// for expf, the mask select, max, difference and sum, and 4 float4
// shared loads. At 4 warp-instructions per clock on each of 132 SMs
// that is ~1.0 ms for the B = 16 kernel_check pair of calls, 1.6x the
// f32 FMA bound; only tensor cores (3xTF32 mma.sync, to keep the f32
// result) would cut the count. A one-frame call must also fill 132 SMs,
// while one block per 256 queries gives 8 blocks for the PC -> CAD
// direction (2048 queries over 5120 keys).
// What the design does about it:
// - One block covers both heads of kThreads * kQpt queries; each thread
//   owns kQpt queries x H heads = 4 (query, head) rows, their q and
//   output accumulators in registers. K and V are read from shared
//   memory as float4: each float4 holds 4 channels of one key (for H = 2
//   two dims of both heads), so one read feeds 4 * kQpt FMAs.
// - K and V tiles of kTK whole tokens (16 H contiguous floats each) are
//   copied with 16-byte cp.async, two buffers: the next tile lands while
//   the current one is in use.
// - Before the walk, the block packs the key mask of each of its tiles
//   into a 32-bit word in shared memory. Tiles with no valid key are
//   never copied or computed; inside a tile, steps of kCK keys with no
//   valid key are skipped. The online softmax rescales once per step.
// - The wrapper cuts the keys into G segments (grid.y): enough for at
//   least two blocks on every SM, and among those the G that leaves the
//   smallest tail of the last wave (ops/kernels/_build.py plan_segments;
//   at B = 1 G = 22 and 33 for the two calls). Segment g takes key tiles
//   g, g + G, ..., interleaved so that valid keys that form a prefix (the
//   serve path's padding) spread over all of them. Each segment writes
//   (running max, running sum, unnormalised accumulator) per (query,
//   head) to scratch; a second small kernel merges the segments in
//   segment order, so every launch gives the same bits. A segment
//   without a valid key merges as (-inf, 0, 0) with weight 0; a row
//   whose segments are all empty gets zeros and lse = -inf.
// - f32 FMAs and expf throughout, as the plain version computes it. q is
//   multiplied by the scale once, at load: exact for 1/sqrt(16) = 0.25.
//
// C interface (ctypes): returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"

namespace {

constexpr int kDim = 16;
constexpr int kThreads = 128;
constexpr int kTK = 32;            // keys per staged tile: one bit each
constexpr int kMaxSegTiles = 256;  // key tiles one segment can walk
constexpr int kCombineThreads = 128;

// Per head count: queries per thread (kQpt x H (query, head) rows) and
// keys per online-softmax step.
template <int H>
struct Tiling {
  static constexpr int kQpt = 4 / H, kCK = 8;
};
template <int H>
constexpr int kQueriesPerBlock = kThreads * Tiling<H>::kQpt;

// grid (ceil(N / kQueriesPerBlock), segments, B). With one segment the
// block writes out (and lse); with more it writes its partial state.
template <int H>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const unsigned char* __restrict__ kv_valid,
                 float* __restrict__ out, float* __restrict__ lse,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int n, int m, int segments, float scale) {
  constexpr int kTok = kDim * H, kVec = kTok / 4, kQ = Tiling<H>::kQpt;
  constexpr int kCK = Tiling<H>::kCK;
  __shared__ __align__(16) float ks[2][kTK][kTok];
  __shared__ __align__(16) float vs[2][kTK][kTok];
  __shared__ unsigned words[kMaxSegTiles];

  const int batch = blockIdx.z, seg = blockIdx.y;
  const int qbase = blockIdx.x * kQueriesPerBlock<H> + threadIdx.x;
  const float* kb = k + (size_t)batch * m * kTok;
  const float* vb = v + (size_t)batch * m * kTok;
  const unsigned char* mb = kv_valid + (size_t)batch * m;
  const int tiles = (m + kTK - 1) / kTK;
  const int nt = seg < tiles ? (tiles - seg + segments - 1) / segments : 0;

  // word i: bit jj set when key (seg + i * segments) * kTK + jj is valid
  for (int i = threadIdx.x; i < nt; i += kThreads) {
    const int j0 = (seg + i * segments) * kTK;
    unsigned wd = 0u;
#pragma unroll
    for (int jj = 0; jj < kTK; ++jj) {
      const int j = j0 + jj;
      if (j < m && mb[j]) wd |= 1u << jj;
    }
    words[i] = wd;
  }

  float qr[kQ][kTok], acc[kQ][kTok], mx[kQ][H], sm[kQ][H];
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) {
    const int row = qbase + qi * kThreads;
    const float4* qv =
        reinterpret_cast<const float4*>(q + ((size_t)batch * n + row) * kTok);
#pragma unroll
    for (int c4 = 0; c4 < kVec; ++c4) {
      // q pre-scaled: for scale 1/sqrt(16) = 0.25, a power of two, every
      // score comes out as (q . k) * scale does, bit for bit
      const float4 t = row < n ? qv[c4] : make_float4(0, 0, 0, 0);
      qr[qi][4 * c4 + 0] = t.x * scale;
      qr[qi][4 * c4 + 1] = t.y * scale;
      qr[qi][4 * c4 + 2] = t.z * scale;
      qr[qi][4 * c4 + 3] = t.w * scale;
    }
#pragma unroll
    for (int c = 0; c < kTok; ++c) acc[qi][c] = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      mx[qi][h] = -INFINITY;
      sm[qi][h] = 0.f;
    }
  }
  __syncthreads();  // words[] complete

  auto stage = [&](int i, int buf) {
    const int j0 = (seg + i * segments) * kTK;
    for (int e = threadIdx.x; e < kTK * kVec; e += kThreads) {
      const int jj = e / kVec, c4 = e % kVec, j = j0 + jj;
      const bool ok = j < m;
      const size_t off = (size_t)(ok ? j : 0) * kTok + c4 * 4;
      async_copy::copy16(&ks[buf][jj][c4 * 4], kb + off, ok);
      async_copy::copy16(&vs[buf][jj][c4 * 4], vb + off, ok);
    }
  };
  auto next_live = [&](int i) {
    while (i < nt && words[i] == 0u) ++i;
    return i;
  };

  int i = next_live(0), buf = 0;
  if (i < nt) stage(i, 0);
  async_copy::commit();
  while (i < nt) {
    const int inext = next_live(i + 1);
    if (inext < nt) stage(inext, buf ^ 1);
    async_copy::commit();
    async_copy::wait<1>();
    __syncthreads();
    const unsigned wd = words[i];
#pragma unroll 1
    for (int c0 = 0; c0 < kTK; c0 += kCK) {
      const unsigned cw = (wd >> c0) & ((1u << kCK) - 1u);
      if (cw == 0u) continue;  // uniform across the block
      float s[kQ][H][kCK];
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
#pragma unroll
          for (int jj = 0; jj < kCK; ++jj) s[qi][h][jj] = 0.f;
        }
      }
      // scaled scores: per (query, head) an FMA chain over d in order
#pragma unroll
      for (int jj = 0; jj < kCK; ++jj) {
#pragma unroll
        for (int c4 = 0; c4 < kVec; ++c4) {
          const float4 kv =
              *reinterpret_cast<const float4*>(&ks[buf][c0 + jj][4 * c4]);
          const float kc[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
          for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int ch = 4 * c4 + t;
              s[qi][ch % H][jj] = fmaf(qr[qi][ch], kc[t], s[qi][ch % H][jj]);
            }
          }
        }
      }
      // online softmax: one rescale per step of kCK keys
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float cm = -INFINITY;
#pragma unroll
          for (int jj = 0; jj < kCK; ++jj) {
            const float x = (cw >> jj) & 1u ? s[qi][h][jj] : -INFINITY;
            s[qi][h][jj] = x;
            cm = fmaxf(cm, x);
          }
          const float nm = fmaxf(mx[qi][h], cm);
          const float corr = expf(mx[qi][h] - nm);  // 0 on the first step
          sm[qi][h] *= corr;
#pragma unroll
          for (int d = 0; d < kDim; ++d) acc[qi][d * H + h] *= corr;
#pragma unroll
          for (int jj = 0; jj < kCK; ++jj) {
            const float p = expf(s[qi][h][jj] - nm);  // 0 for masked keys
            sm[qi][h] += p;
            s[qi][h][jj] = p;
          }
          mx[qi][h] = nm;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kCK; ++jj) {
#pragma unroll
        for (int c4 = 0; c4 < kVec; ++c4) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[buf][c0 + jj][4 * c4]);
          const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int ch = 4 * c4 + t;
              acc[qi][ch] = fmaf(s[qi][ch % H][jj], vc[t], acc[qi][ch]);
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled next iteration
    buf ^= 1;
    i = inext;
  }

#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) {
    const int row = qbase + qi * kThreads;
    if (row >= n) continue;
    const size_t r = (size_t)batch * n + row;
    if (segments == 1) {
      float inv[H];
#pragma unroll
      for (int h = 0; h < H; ++h)
        inv[h] = sm[qi][h] > 0.f ? 1.f / sm[qi][h] : 0.f;
      float4* o = reinterpret_cast<float4*>(out + r * kTok);
#pragma unroll
      for (int c4 = 0; c4 < kVec; ++c4) {
        const int c = 4 * c4;
        o[c4] = make_float4(acc[qi][c] * inv[c % H],
                            acc[qi][c + 1] * inv[(c + 1) % H],
                            acc[qi][c + 2] * inv[(c + 2) % H],
                            acc[qi][c + 3] * inv[(c + 3) % H]);
      }
      if (lse != nullptr) {
#pragma unroll
        for (int h = 0; h < H; ++h)
          lse[r * H + h] =
              sm[qi][h] > 0.f ? mx[qi][h] + logf(sm[qi][h]) : -INFINITY;
      }
    } else {
      const size_t pr = ((size_t)(batch * segments + seg)) * n + row;
      float4* pa = reinterpret_cast<float4*>(part_acc + pr * kTok);
#pragma unroll
      for (int c4 = 0; c4 < kVec; ++c4) {
        const int c = 4 * c4;
        pa[c4] = make_float4(acc[qi][c], acc[qi][c + 1], acc[qi][c + 2],
                             acc[qi][c + 3]);
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        part_ml[pr * 2 * H + 2 * h] = mx[qi][h];
        part_ml[pr * 2 * H + 2 * h + 1] = sm[qi][h];
      }
    }
  }
}

// One thread per (frame, query, 4 channels): the segments' states merged
// in segment order against the largest running max of each head.
template <int H>
__global__ void __launch_bounds__(kCombineThreads)
flash_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, float* __restrict__ out,
                     float* __restrict__ lse, int n, int segments, int total) {
  constexpr int kTok = kDim * H, kVec = kTok / 4;
  const int idx = blockIdx.x * kCombineThreads + threadIdx.x;
  if (idx >= total) return;
  const int c4 = idx % kVec;
  const size_t r = idx / kVec;  // batch * n + row
  const int batch = static_cast<int>(r / n), row = static_cast<int>(r % n);
  const size_t p0 = (size_t)batch * segments * n + row;  // segment 0
  float M[H], L[H], a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int h = 0; h < H; ++h) {
    M[h] = -INFINITY;
    L[h] = 0.f;
  }
  for (int g = 0; g < segments; ++g) {
    const float* ml = part_ml + (p0 + (size_t)g * n) * 2 * H;
#pragma unroll
    for (int h = 0; h < H; ++h) M[h] = fmaxf(M[h], ml[2 * h]);
  }
  for (int g = 0; g < segments; ++g) {
    const size_t pr = p0 + (size_t)g * n;
    const float* ml = part_ml + pr * 2 * H;
    float wt[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      // an empty segment (max -inf) weighs 0, also when every one is
      wt[h] = ml[2 * h] == -INFINITY ? 0.f : expf(ml[2 * h] - M[h]);
      L[h] = fmaf(wt[h], ml[2 * h + 1], L[h]);
    }
    const float4 pa =
        reinterpret_cast<const float4*>(part_acc + pr * kTok)[c4];
    a[0] = fmaf(wt[0 % H], pa.x, a[0]);
    a[1] = fmaf(wt[1 % H], pa.y, a[1]);
    a[2] = fmaf(wt[2 % H], pa.z, a[2]);
    a[3] = fmaf(wt[3 % H], pa.w, a[3]);
  }
  float inv[H];
#pragma unroll
  for (int h = 0; h < H; ++h) inv[h] = L[h] > 0.f ? 1.f / L[h] : 0.f;
  // 4 * c4 is a multiple of H, so channel 4 * c4 + t is head t % H
  reinterpret_cast<float4*>(out + r * kTok)[c4] =
      make_float4(a[0] * inv[0 % H], a[1] * inv[1 % H], a[2] * inv[2 % H],
                  a[3] * inv[3 % H]);
  if (lse != nullptr && c4 == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      lse[r * H + h] = L[h] > 0.f ? M[h] + logf(L[h]) : -INFINITY;
  }
}

template <int H>
int launch(const float* q, const float* k, const float* v,
           const unsigned char* valid, float* out, float* lse,
           float* part_acc, float* part_ml, int batch, int n, int m,
           int segments, float scale, cudaStream_t stream) {
  const int tiles = (m + kTK - 1) / kTK;
  if ((tiles + segments - 1) / segments > kMaxSegTiles ||
      (segments > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n + kQueriesPerBlock<H> - 1) / kQueriesPerBlock<H>, segments,
            batch);
  flash_fwd_kernel<H><<<grid, kThreads, 0, stream>>>(
      q, k, v, valid, out, lse, part_acc, part_ml, n, m, segments, scale);
  if (segments > 1) {
    const int total = batch * n * (kDim * H / 4);
    flash_combine_kernel<H>
        <<<(total + kCombineThreads - 1) / kCombineThreads, kCombineThreads,
           0, stream>>>(part_acc, part_ml, out, lse, n, segments, total);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int tiles(int* out) {
  out[0] = kQueriesPerBlock<H>;
  out[1] = kTK;
  out[2] = kMaxSegTiles;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], flash_fwd_kernel<H>, kThreads, 0));
}

}  // namespace

// The kernel's tiling for `heads`, for the wrapper's planner: {queries
// per block, keys per tile, most key tiles per segment, resident blocks
// per SM on this card}. Non-zero for a head count the kernel does not
// take.
extern "C" int flash_cross_attention_tiles(int heads, int* out) {
  switch (heads) {
    case 1: return tiles<1>(out);
    case 2: return tiles<2>(out);
    case 4: return tiles<4>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (B, N, dim, H), k/v (B, M, dim, H) f32 and kv_valid (B, M) bytes,
// contiguous, 16-byte aligned. With segments > 1: part_acc (B, segments,
// N, dim * H) and part_ml (B, segments, N, H, 2) f32 scratch.
extern "C" int flash_cross_attention_f32(const void* q, const void* k,
                                         const void* v, const void* kv_valid,
                                         void* out, void* lse, void* part_acc,
                                         void* part_ml, int batch, int n,
                                         int m, int dim, int heads,
                                         int segments, float scale,
                                         void* stream) {
  if (dim != kDim || segments < 1 || batch < 1 || n < 1 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const unsigned char* mf = static_cast<const unsigned char*>(kv_valid);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);  // may be null (no lse wanted)
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (heads) {
    case 1:
      return launch<1>(qf, kf, vf, mf, of, lf, pa, pm, batch, n, m, segments,
                       scale, s);
    case 2:
      return launch<2>(qf, kf, vf, mf, of, lf, pa, pm, batch, n, m, segments,
                       scale, s);
    case 4:
      return launch<4>(qf, kf, vf, mf, of, lf, pa, pm, batch, n, m, segments,
                       scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
