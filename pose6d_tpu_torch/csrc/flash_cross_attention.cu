// Masked multi-head cross-attention forward with an online softmax, f32.
//
// Replaces the TPU kernel pose6d_tpu/ops/pallas/attention.py:30
// flash_cross_attention (which wraps JAX's library Pallas flash
// attention, pads head_dim to 128 and folds the key mask into a
// -1e9 bias channel). Here the key-validity mask comes in directly. Layout
// is the refiner's (dim, heads) channel split: q (B, N, DIM, H), k/v
// (B, M, DIM, H), out (B, N, DIM, H); channel c of a projection is
// c = d * H + h. The scale is the caller's (1/sqrt(the caller's dim)).
// Instances: DIM = 16 with H = 1 or 2, and DIM = 32, 64 and 128 with
// H = 1. The wrapper (ops/kernels/attention.py) zero-pads a caller's head
// dim up to the smallest instance dim (zero channels change neither
// q . k nor the kept part of the output, which it slices back), and for
// DIM x H > 32 (4 heads of 16, 2 or 4 heads of 32, 3 or 8 heads, every
// head of 64 or 128) lays each head out as a frame of its own, (B H, N,
// DIM, 1), so a thread's q and accumulator rows stay at 64 floats each (a
// 4-head instance of 16 ran slower than the fold on an H100; PERF.md).
// DIM 16 and 32 run flash_fwd_kernel on the CUDA cores (below); DIM 64
// and 128 run flash_fwd_tc_kernel on the tensor cores (after it).
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
// f32 FMA bound. A one-frame call must also fill 132 SMs, while one
// block per 256 queries gives 8 blocks for the PC -> CAD direction (2048
// queries over 5120 keys).
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
// - f32 FMAs and expf throughout, as the plain version computes it.
//   Where the scale is a power of two (1/sqrt(16) = 0.25, 1/sqrt(64),
//   1/sqrt(4); frexp's mantissa 0.5, decided by the wrapper on the
//   caller's scale, never on the instance's DIM, and refused by the C
//   entry for any other scale) q is multiplied by it
//   once, at load, which is exact: every score comes out as
//   (q . k) * scale does. Otherwise (1/sqrt(8) for a dim-8 call padded
//   to the DIM = 16 instance, 1/sqrt(32), 1/sqrt(128)) each score is
//   scaled after its dot product, in the plain version's order: one FMUL
//   per (query, key), ~1/33 of the step's arithmetic.
// - K and V tiles live in dynamic shared memory (cudaFuncSetAttribute
//   once per instance; 70 KB for the tensor-core kernel at DIM = 128,
//   above the 48 KB of a static array).
//
// C interface (ctypes): returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTK = 32;            // keys per staged tile: one bit each
constexpr int kMaxSegTiles = 256;  // key tiles one segment can walk
constexpr int kCombineThreads = 128;

// Per (head dim, head count) of the CUDA-core instances (DIM x H <= 32):
// each thread owns kQpt queries (kQpt x H (query, head) rows: 64 floats
// of q and of accumulator a thread); keys per online-softmax step.
template <int DIM, int H>
struct Tiling {
  static constexpr int kTok = DIM * H;
  static constexpr int kQpt = 64 / kTok, kCK = 8;
  static_assert(kTok <= 32, "wider tokens run on the tensor cores");
};
template <int DIM, int H>
constexpr int kQueriesPerBlock = kThreads * Tiling<DIM, H>::kQpt;

// Dynamic shared memory of an instance: K and V tiles (two buffers
// each), then the segment's key-tile words.
template <int DIM, int H>
constexpr int kSmemBytes =
    (4 * kTK * DIM * H) * (int)sizeof(float) + kMaxSegTiles * 4;

// grid (ceil(N / kQueriesPerBlock), segments, B). With one segment the
// block writes out (and lse); with more it writes its partial state.
// kPreScale: the scale is a power of two, so q is scaled at load.
template <int DIM, int H, bool kPreScale>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const unsigned char* __restrict__ kv_valid,
                 float* __restrict__ out, float* __restrict__ lse,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int n, int m, int segments, float scale) {
  using T = Tiling<DIM, H>;
  constexpr int kTok = T::kTok;
  constexpr int kVec = kTok / 4;  // float4 of a token
  constexpr int kQ = T::kQpt, kCK = T::kCK;
  const float qscale = kPreScale ? scale : 1.f;
  extern __shared__ __align__(16) float smem[];
  float (*ks)[kTK][kTok] = reinterpret_cast<float (*)[kTK][kTok]>(smem);
  float (*vs)[kTK][kTok] =
      reinterpret_cast<float (*)[kTK][kTok]>(smem + 2 * kTK * kTok);
  unsigned* words = reinterpret_cast<unsigned*>(smem + 4 * kTK * kTok);

  const int batch = blockIdx.z, seg = blockIdx.y;
  const int qbase = blockIdx.x * kQueriesPerBlock<DIM, H> + threadIdx.x;
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
      // q pre-scaled by a power-of-two scale: every score comes out as
      // (q . k) * scale does, bit for bit
      const float4 t =
          row < n ? qv[c4] : make_float4(0, 0, 0, 0);
      qr[qi][4 * c4 + 0] = t.x * qscale;
      qr[qi][4 * c4 + 1] = t.y * qscale;
      qr[qi][4 * c4 + 2] = t.z * qscale;
      qr[qi][4 * c4 + 3] = t.w * qscale;
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

  constexpr int kTokVec = kTok / 4;
  auto stage = [&](int i, int buf) {
    const int j0 = (seg + i * segments) * kTK;
    for (int e = threadIdx.x; e < kTK * kTokVec; e += kThreads) {
      const int jj = e / kTokVec, c4 = e % kTokVec, j = j0 + jj;
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
      // scaled scores: per (query, head) an FMA chain over the channels
      // in order
#pragma unroll
      for (int jj = 0; jj < kCK; ++jj) {
#pragma unroll
        for (int c4 = 0; c4 < kVec; ++c4) {
          const float4 kv = *reinterpret_cast<const float4*>(
              &ks[buf][c0 + jj][4 * c4]);
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
            const float sc = kPreScale ? s[qi][h][jj] : s[qi][h][jj] * scale;
            const float x = (cw >> jj) & 1u ? sc : -INFINITY;
            s[qi][h][jj] = x;
            cm = fmaxf(cm, x);
          }
          const float nm = fmaxf(mx[qi][h], cm);
          const float corr = expf(mx[qi][h] - nm);  // 0 on the first step
          sm[qi][h] *= corr;
#pragma unroll
          for (int d = 0; d < DIM; ++d) acc[qi][d * H + h] *= corr;
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
          const float4 vv = *reinterpret_cast<const float4*>(
              &vs[buf][c0 + jj][4 * c4]);
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
        o[c4] = make_float4(
            acc[qi][c] * inv[c % H], acc[qi][c + 1] * inv[(c + 1) % H],
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
        pa[c4] = make_float4(acc[qi][c], acc[qi][c + 1],
                                             acc[qi][c + 2], acc[qi][c + 3]);
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        part_ml[pr * 2 * H + 2 * h] = mx[qi][h];
        part_ml[pr * 2 * H + 2 * h + 1] = sm[qi][h];
      }
    }
  }
}

// ---- DIM = 64 and 128: the tensor cores ----
//
// flash_fwd_tc_kernel computes both products as 3xTF32 mma.sync.m16n8k8
// (mma_tf32.cuh): at DIM 64 and 128 the CUDA-core kernel's ~52
// instructions per (query, key) grow with DIM, while a tensor-core
// product of 16 queries x 8 keys x 8 dims is one instruction (three for
// the f32-near split). What bounds it on the H100: the rate of mma.sync,
// ~316 TFLOP/s of TF32 (chip_smoke.py mma_rate, H100 80GB HBM3, 700 W),
// for 3 x 4 DIM flops per (query, key): S = Q K^T and O += P V.
// - A warp owns 16 queries, a block 4 warps (64 queries). Q stays in
//   registers as raw f32 A fragments (DIM / 2 floats a lane), split per
//   key tile; O is DIM / 8 accumulator n-tiles (DIM / 2 floats a lane).
// - Per key tile of kTK = 32 keys (its mask word as in the CUDA-core
//   kernel; tiles without a valid key are never copied), S is 4 n-tiles
//   of 8 keys, each over DIM / 8 k-steps: 4 independent chains. The k
//   index of S is permuted (k-slot (step s, t) is dim 16 (s / 2) + 4 t +
//   2 (s % 2), slot t + 4 the next dim), so a lane reads its B
//   fragments of two k-steps as one float4 of a key row; the keys of an
//   n-tile are permuted too (column n is key n / 2 + 4 (n % 2)), so that
//   the accumulator's columns 2 t and 2 t + 1 are keys t and t + 4:
//   exactly the A fragment of P that the second product needs, without
//   a shuffle or a shared-memory round trip.
// - The online softmax in f32 registers: the tile's row max over a
//   lane's 8 scores and a quad shuffle, exp2 with log2(e) folded into
//   the scale (ex2.approx.ftz), a per-lane partial row sum added over the
//   quad at the end. The scale: q pre-scaled where it is a power of two,
//   as in the CUDA-core kernel, else folded into the exponent's FMA.
// - O += P V: the output columns of n-tile 4 i + j are 32 i + 4 g + j
//   for B column g, so a lane reads its V fragments as float4s of one key
//   row and its accumulators hold 8 contiguous columns of a row (float4
//   stores).
// - K and V rows are padded to DIM + 4 and DIM + 8 floats: the float4
//   reads of 8 lanes (2 keys x 4 t, and 4 keys 2t apart) land in 8
//   distinct bank groups.
// - Key segments across blocks, the segments' merge (flash_combine_kernel)
//   and the lse output as in the CUDA-core kernel; partial (max, sum) are
//   in the scaled scores' units.
constexpr int kTcWarps = kThreads / 32;
constexpr int kTcQueries = 16 * kTcWarps;  // queries a block
constexpr float kLog2e = 1.4426950408889634f;

template <int DIM>
struct TcShape {
  static constexpr int kSteps = DIM / 8;     // k-steps of S, n-tiles of O
  static constexpr int kKStride = DIM + 4;   // shared row strides
  static constexpr int kVStride = DIM + 8;
  static constexpr int kSmemBytes =
      2 * kTK * (kKStride + kVStride) * (int)sizeof(float) + kMaxSegTiles * 4;
  // blocks per SM that the registers must allow (q and O take DIM floats
  // a lane)
  static constexpr int kMinBlocks = DIM > 64 ? 2 : 3;
  static_assert(DIM % 32 == 0, "whole float4 groups of n-tiles");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// grid (ceil(N / 64), segments, B); q, k, v (B, ., DIM) (one head). With
// one segment the block writes out (and lse); with more, its partial
// state. kPreScale: the scale is a power of two, so q is scaled at load.
template <int DIM, bool kPreScale>
__global__ void __launch_bounds__(kThreads, TcShape<DIM>::kMinBlocks)
flash_fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const unsigned char* __restrict__ kv_valid,
                    float* __restrict__ out, float* __restrict__ lse,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int n, int m, int segments, float scale) {
  using S = TcShape<DIM>;
  constexpr int kSteps = S::kSteps, kKS = S::kKStride, kVS = S::kVStride;
  extern __shared__ __align__(16) float smem[];
  float (*ks)[kTK][kKS] = reinterpret_cast<float (*)[kTK][kKS]>(smem);
  float (*vs)[kTK][kVS] =
      reinterpret_cast<float (*)[kTK][kVS]>(smem + 2 * kTK * kKS);
  unsigned* words =
      reinterpret_cast<unsigned*>(smem + 2 * kTK * (kKS + kVS));

  const int batch = blockIdx.z, seg = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int kg = g / 2 + 4 * (g % 2);  // the key of S's B column g
  const int r0 = blockIdx.x * kTcQueries + warp * 16;  // rows r0 + g, + 8
  const float* kb = k + (size_t)batch * m * DIM;
  const float* vb = v + (size_t)batch * m * DIM;
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

  // Q's A fragments, raw f32 (q pre-scaled by a power-of-two scale is
  // exact): qa[s] = (row g, slot t), (g + 8, t), (g, t + 4), (g + 8, t +
  // 4) of k-step s, slot t at dim 16 (s / 2) + 4 t + 2 (s % 2)
  const float qscale = kPreScale ? scale : 1.f;
  float qa[kSteps][4];
#pragma unroll
  for (int p = 0; p < kSteps / 2; ++p) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r0 + g < n)
      x = *reinterpret_cast<const float4*>(
          q + ((size_t)batch * n + r0 + g) * DIM + 16 * p + 4 * t);
    if (r0 + g + 8 < n)
      y = *reinterpret_cast<const float4*>(
          q + ((size_t)batch * n + r0 + g + 8) * DIM + 16 * p + 4 * t);
    qa[2 * p][0] = x.x * qscale;
    qa[2 * p][1] = y.x * qscale;
    qa[2 * p][2] = x.y * qscale;
    qa[2 * p][3] = y.y * qscale;
    qa[2 * p + 1][0] = x.z * qscale;
    qa[2 * p + 1][1] = y.z * qscale;
    qa[2 * p + 1][2] = x.w * qscale;
    qa[2 * p + 1][3] = y.w * qscale;
  }
  // n-tile 4 i + j: (row g, column 32 i + 8 t + j), (g, + 4), (g + 8, ..)
  float o[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[s][e] = 0.f;
  // rows g and g + 8: the running max of the (unscaled unless kPreScale)
  // scores and this lane's part of the running sum
  float mx[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f};
  const float unit = kPreScale ? 1.f : scale;  // score -> scaled score
  const float sl2e = unit * kLog2e;
  __syncthreads();  // words[] complete

  constexpr int kVec = DIM / 4;
  auto stage = [&](int i, int buf) {
    const int j0 = (seg + i * segments) * kTK;
    for (int e = threadIdx.x; e < kTK * kVec; e += kThreads) {
      const int jj = e / kVec, c4 = e % kVec, j = j0 + jj;
      const bool ok = j < m;
      const size_t off = (size_t)(ok ? j : 0) * DIM + c4 * 4;
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
    // S: n-tile c holds keys 8 c + t (c0, c2) and 8 c + t + 4 (c1, c3)
    float s[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll
    for (int p = 0; p < kSteps / 2; ++p) {
      mma_tf32::FragA ae, ao;
      ae.set(qa[2 * p][0], qa[2 * p][1], qa[2 * p][2], qa[2 * p][3]);
      ao.set(qa[2 * p + 1][0], qa[2 * p + 1][1], qa[2 * p + 1][2],
             qa[2 * p + 1][3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(
            &ks[buf][8 * c + kg][16 * p + 4 * t]);
        mma_tf32::mma3(s[c], ae, mma_tf32::FragB(kv.x, kv.y));
        mma_tf32::mma3(s[c], ao, mma_tf32::FragB(kv.z, kv.w));
      }
    }
    // masked keys -> -inf; the tile's max of rows g (h = 0), g + 8 (1)
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * c + t + 4 * (e & 1);
        const float x = (wd >> key) & 1u ? s[c][e] : -INFINITY;
        s[c][e] = x;
        tm[e >> 1] = fmaxf(tm[e >> 1], x);
      }
    }
    float nml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 1));
      tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 2));
      // the tile has a valid key, so the new max is finite; the first
      // tile's correction is exp2(-inf) = 0
      const float nm = fmaxf(mx[h], tm[h]);
      const float corr = ex2((mx[h] - nm) * sl2e);
      mx[h] = nm;
      nml[h] = nm * sl2e;
      ls[h] *= corr;
#pragma unroll
      for (int nt8 = 0; nt8 < kSteps; ++nt8) {
        o[nt8][2 * h] *= corr;
        o[nt8][2 * h + 1] *= corr;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[c][e], sl2e, -nml[e >> 1]));  // 0 masked
        s[c][e] = p;
        ls[e >> 1] += p;
      }
    }
    // O += P V, k-step c over keys 8 c .. 8 c + 7 (slot t: key 8 c + t)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mma_tf32::FragA pa;
      pa.set(s[c][0], s[c][2], s[c][1], s[c][3]);
#pragma unroll
      for (int i4 = 0; i4 < kSteps / 4; ++i4) {
        const float4 v0 = *reinterpret_cast<const float4*>(
            &vs[buf][8 * c + t][32 * i4 + 4 * g]);
        const float4 v1 = *reinterpret_cast<const float4*>(
            &vs[buf][8 * c + t + 4][32 * i4 + 4 * g]);
        mma_tf32::mma3(o[4 * i4], pa, mma_tf32::FragB(v0.x, v1.x));
        mma_tf32::mma3(o[4 * i4 + 1], pa, mma_tf32::FragB(v0.y, v1.y));
        mma_tf32::mma3(o[4 * i4 + 2], pa, mma_tf32::FragB(v0.z, v1.z));
        mma_tf32::mma3(o[4 * i4 + 3], pa, mma_tf32::FragB(v0.w, v1.w));
      }
    }
    __syncthreads();  // the buffer is refilled next iteration
    buf ^= 1;
    i = inext;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the row sum over the quad: (a + b) + (c + d) on every lane
    ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
    ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
    const int row = r0 + g + 8 * h;
    if (row >= n) continue;
    const size_t r = (size_t)batch * n + row;
    const bool single = segments == 1;
    const float mul = single ? (ls[h] > 0.f ? 1.f / ls[h] : 0.f) : 1.f;
    const size_t pr = ((size_t)(batch * segments + seg)) * n + row;
    float* dst = single ? out + r * DIM : part_acc + pr * DIM;
#pragma unroll
    for (int i4 = 0; i4 < kSteps / 4; ++i4) {
      float4* o4 = reinterpret_cast<float4*>(dst + 32 * i4 + 8 * t);
      o4[0] = make_float4(o[4 * i4][2 * h] * mul, o[4 * i4 + 1][2 * h] * mul,
                          o[4 * i4 + 2][2 * h] * mul,
                          o[4 * i4 + 3][2 * h] * mul);
      o4[1] = make_float4(
          o[4 * i4][2 * h + 1] * mul, o[4 * i4 + 1][2 * h + 1] * mul,
          o[4 * i4 + 2][2 * h + 1] * mul, o[4 * i4 + 3][2 * h + 1] * mul);
    }
    if (t != 0) continue;
    const float m_scaled = mx[h] * unit;  // -inf: no valid key here
    if (single) {
      if (lse != nullptr)
        lse[r] = ls[h] > 0.f ? m_scaled + logf(ls[h]) : -INFINITY;
    } else {
      part_ml[pr * 2] = m_scaled;
      part_ml[pr * 2 + 1] = ls[h];
    }
  }
}

// One thread per (frame, query, 4 channels): the segments' states merged
// in segment order against the largest running max of each head.
template <int DIM, int H>
__global__ void __launch_bounds__(kCombineThreads)
flash_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, float* __restrict__ out,
                     float* __restrict__ lse, int n, int segments, int total) {
  constexpr int kTok = DIM * H, kVec = kTok / 4;
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

// The kernel of an instance (DIM x H >= 64: the tensor cores), its
// queries per block and dynamic shared memory.
template <int DIM, int H>
constexpr bool kTensorCores = DIM * H >= 64;
template <int DIM, int H>
constexpr int queries_per_block() {
  if constexpr (kTensorCores<DIM, H>)
    return kTcQueries;
  else
    return kQueriesPerBlock<DIM, H>;
}
template <int DIM, int H>
constexpr int smem_bytes() {
  if constexpr (kTensorCores<DIM, H>)
    return TcShape<DIM>::kSmemBytes;
  else
    return kSmemBytes<DIM, H>;
}
template <int DIM, int H, bool kPreScale>
auto kernel() {
  if constexpr (kTensorCores<DIM, H>)
    return flash_fwd_tc_kernel<DIM, kPreScale>;
  else
    return flash_fwd_kernel<DIM, H, kPreScale>;
}

// The kernel of an instance with its dynamic shared memory allowed (once).
template <int DIM, int H, bool kPreScale>
const void* prepared() {
  static const bool done = [] {
    cudaFuncSetAttribute(kernel<DIM, H, kPreScale>(),
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes<DIM, H>());
    return true;
  }();
  (void)done;
  return reinterpret_cast<const void*>(kernel<DIM, H, kPreScale>());
}

template <int DIM, int H, bool kPreScale>
int launch(const float* q, const float* k, const float* v,
           const unsigned char* valid, float* out, float* lse,
           float* part_acc, float* part_ml, int batch, int n, int m,
           int segments, float scale, cudaStream_t stream) {
  const int tiles = (m + kTK - 1) / kTK;
  if ((tiles + segments - 1) / segments > kMaxSegTiles ||
      (segments > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  prepared<DIM, H, kPreScale>();
  constexpr int kQ = queries_per_block<DIM, H>();
  dim3 grid((n + kQ - 1) / kQ, segments, batch);
  kernel<DIM, H, kPreScale>()<<<grid, kThreads, smem_bytes<DIM, H>(),
                                stream>>>(q, k, v, valid, out, lse, part_acc,
                                          part_ml, n, m, segments, scale);
  if (segments > 1) {
    const int total = batch * n * (DIM * H / 4);
    flash_combine_kernel<DIM, H>
        <<<(total + kCombineThreads - 1) / kCombineThreads, kCombineThreads,
           0, stream>>>(part_acc, part_ml, out, lse, n, segments, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// Both pre-scale variants share the tiling; the planner asks for the one
// without (the two take the same registers but for the scale's FMUL).
template <int DIM, int H>
int tiles(int* out) {
  out[0] = queries_per_block<DIM, H>();
  out[1] = kTK;
  out[2] = kMaxSegTiles;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], prepared<DIM, H, false>(), kThreads, smem_bytes<DIM, H>()));
}

template <int DIM, int H>
int launch_scaled(bool pow2, const float* q, const float* k, const float* v,
                  const unsigned char* valid, float* out, float* lse,
                  float* part_acc, float* part_ml, int batch, int n, int m,
                  int segments, float scale, cudaStream_t stream) {
  return pow2 ? launch<DIM, H, true>(q, k, v, valid, out, lse, part_acc,
                                     part_ml, batch, n, m, segments, scale,
                                     stream)
              : launch<DIM, H, false>(q, k, v, valid, out, lse, part_acc,
                                      part_ml, batch, n, m, segments, scale,
                                      stream);
}

}  // namespace

// The kernel's tiling for (dim, heads), for the wrapper's planner:
// {queries per block, keys per tile, most key tiles per segment, resident
// blocks per SM on this card}. Non-zero for an instance the kernel does
// not have.
extern "C" int flash_cross_attention_tiles(int dim, int heads, int* out) {
  if (heads == 2 && dim == 16) return tiles<16, 2>(out);
  if (heads != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dim) {
    case 16: return tiles<16, 1>(out);
    case 32: return tiles<32, 1>(out);
    case 64: return tiles<64, 1>(out);
    case 128: return tiles<128, 1>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (B, N, dim, H), k/v (B, M, dim, H) f32 and kv_valid (B, M) bytes
// (dim 16 with H 1 or 2; dim 32, 64 or 128 with H 1), contiguous, 16-byte
// aligned. With segments > 1: part_acc (B, segments, N, dim * H) and
// part_ml (B, segments, N, H, 2) f32 scratch. prescale: q is scaled at
// load (the scale must be a power of two).
extern "C" int flash_cross_attention_f32(const void* q, const void* k,
                                         const void* v, const void* kv_valid,
                                         void* out, void* lse, void* part_acc,
                                         void* part_ml, int batch, int n,
                                         int m, int dim, int heads,
                                         int segments, float scale,
                                         int prescale, void* stream) {
  if (segments < 1 || batch < 1 || n < 1 || m < 1)
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
  // q scaled at load (prescale != 0) only for a power-of-two scale
  // (mantissa 0.5), where it is exact
  int e2 = 0;
  const bool pow2 = prescale != 0;
  if (pow2 && frexpf(scale, &e2) != 0.5f)
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_LAUNCH(D, H)                                                  \
  launch_scaled<D, H>(pow2, qf, kf, vf, mf, of, lf, pa, pm, batch, n, m,    \
                      segments, scale, s)
  if (heads == 2 && dim == 16) return FLASH_LAUNCH(16, 2);
  if (heads != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dim) {
    case 16: return FLASH_LAUNCH(16, 1);
    case 32: return FLASH_LAUNCH(32, 1);
    case 64: return FLASH_LAUNCH(64, 1);
    case 128: return FLASH_LAUNCH(128, 1);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_LAUNCH
}
