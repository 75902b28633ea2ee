// Masked multi-head cross-attention backward (dq, dk, dv), f32 results
// from 3xTF32 tensor-core products.
//
// Replaces the backward of the TPU kernel
// pose6d_tpu/ops/pallas/attention.py:30 flash_cross_attention: JAX's
// library Pallas flash attention brings two fused backward
// pallas_calls (dq and dkv), which jax.value_and_grad runs in every
// training step (pose6d_tpu/train/train_step.py:83), once for each
// direction of the refiner. Layout as the forward
// (flash_cross_attention.cu): q, dq, out, dout (B, N, DIM, H); k, v,
// dk, dv (B, M, DIM, H); channel c = d * H + h; the caller's scale.
// Instances: DIM = 16 with H = 1 or 2, and DIM = 32, 64 and 128 with
// H = 1; the wrapper pads a caller's head dim to the smallest instance
// dim and, for DIM x H > 32, lays each head out as a frame of its own,
// as for the forward (a 4-head instance of 16 spilled registers at its
// 255 and ran slower than the fold on an H100; PERF.md). A
// product over DIM takes DIM / 8 k-steps of m16n8k8 and an update DIM / 8
// n-tiles of 8 columns, so the DIM = 32, H = 1 instance holds as many
// fragments and accumulators as the DIM = 16, H = 2 one (two heads of two
// k-steps each). DIM = 64 and 128 run the wide kernels at the end of this
// file (flash_bwd_dq_wide_kernel, flash_bwd_dkv_wide_kernel; their own
// note), on the same prep and merge passes.
//
// FlashAttention-2 style recomputation from the forward's log-sum-exp
// L (B, N, H): the (H, N, M) probabilities are never stored.
//   p_ij  = exp(s_ij - L_i),  s_ij = scale * q_i . k_j   (valid j only)
//   D_i   = dout_i . out_i
//   ds_ij = p_ij * (dout_i . v_j - D_i)
//   dq_i  = scale * sum_j ds_ij k_j
//   dk_j  = scale * sum_i ds_ij q_i,   dv_j = sum_i p_ij dout_i
// Launches on one stream, in order:
//   prep : per (frame, query) D_i and L_i log2(e) per head, and per tile
//          of 32 queries a word with a bit for each live row (dout not
//          all zero and L finite). A row that is not live gets L = +inf,
//          so its p is exactly 0: never exp(+inf).
//   dq   : a block of kRowsBlk queries (all heads) walks the key tiles;
//   dkv  : a block of kRowsBlk keys (all heads) walks the query tiles;
//   merge: when the walk is split across blocks, the segments' partial
//          dq (or dk, dv) added in segment order.
// Each block sums its own rows in a fixed order and nothing is added
// atomically, so every launch gives the same bits. A masked key gets
// dk = dv = 0 exactly (written as zeros); a query with no valid key
// contributes nothing and gets dq = 0.
//
// What bounds it on the H100: operations, and on this design the
// latency of its dependent products. Per (query, key, head) the five
// products of 16 (s, dout . v, and the dq, dk, dv updates) are 160
// flops against ~1.5 MB of inputs and outputs per frame; the two kernels
// recompute s and dout . v, 7 products in all. Every product runs on
// the tensor cores as mma.sync.m16n8k8 TF32 with each f32 operand split
// into a TF32 high part and the rest (a = a_hi + a_lo; a_lo b_hi +
// a_hi b_lo + a_hi b_hi), which keeps the result near f32: one TF32
// product (~1e-3 relative) would fail the checks. The sm_90a build
// issues ~200 instructions per chunk of 8 x 16 (query, key) x 2 heads
// in the dq kernel, 36 of them HMMA, and ~250 in the dkv kernel, 48
// HMMA: ~57 lane-instructions per (query, key, head) (cuobjdump -sass;
// chip_smoke.py phase sass prints the build's counts). mma.sync
// sustains ~316 TFLOP/s of TF32 on an H100 SXM at 700 W (chip_smoke.py,
// mma_rate_kernel below), 64 % of the dense peak that only wgmma
// reaches; at B = 8 the kernels run at ~45 % of that rate and ~35 % of
// the issue rate, with 12 warps per SM (three blocks of at most 168
// registers): each chunk is a chain of dependent products.
// What the design of the DIM = 16 and 32 instances does about it:
// - A warp owns 16 rows (queries in dq, keys in dkv) of both heads; its
//   own rows' operands (q and dout, or k and v) are split once into
//   register fragments. The walked tile's tokens (32 keys or queries)
//   are copied whole, 16 H contiguous floats each, with 16-byte cp.async
//   into two buffers, rows padded by 4 floats so that fragment loads
//   are free of bank conflicts. A tile's 4 chunks of 8 are unrolled, so
//   one chunk's products overlap the next one's loads and exponentials.
// - Fragments without shuffles or shared-memory round trips (both cost
//   instructions; this costs none). A sum over d or over a chunk's 8
//   rows may run in any order, so the kernels permute the k index of
//   each product: for s and dout . v, k-slot (step s, t, half) is
//   d = 4 t + 2 s + half, so a lane reads its B fragment as whole float4s
//   of one token; for the updates, k-slot t is row 2 t of the chunk and
//   t + 4 is row 2 t + 1, which is exactly how the m16n8k8 accumulator
//   lays out P and dS, so they feed the next product as they are. The
//   output columns d = 2 g + n-tile make each lane's accumulators 4
//   contiguous d of a row: float4 stores.
// - The split truncates (one LOP3 and one FADD per operand):
//   cvt.rna.tf32.f32 compiles to four instructions on sm_90.
// - exp2 with log2(e) folded into the scale and L (ex2.approx.ftz;
//   relative error ~2^-22), P, dS and the accumulators in f32
//   registers.
// - Skipped before they are copied: key tiles with no valid key (a mask
//   word per tile, as in the forward) and query tiles with no live row
//   (the prep pass's words). A dkv block whose keys are all masked, or a
//   dq block whose queries are all dead, writes zeros and exits.
// - When a direction's grid gives fewer than two blocks per SM, or ends
//   in a ragged wave, the wrapper splits the walk into G interleaved
//   segments (ops/kernels/attention.py flash_backward_segments over
//   _build.plan_segments; G = 3 for both kernels and both directions at
//   B = 8); a merge pass adds the partials in segment order.
//
// C interface (ctypes): returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
#include "mma_tf32.cuh"

namespace {

using mma_tf32::FragA;
using mma_tf32::FragB;
using mma_tf32::mma;
using mma_tf32::mma3;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;           // walked rows per tile: one mask bit each
constexpr int kMaxSegTiles = 256;   // tiles one segment can walk
constexpr int kFlatThreads = 128;   // prep and merge passes
constexpr float kLog2e = 1.4426950408889634f;

// The instances up to 32 floats a token (DIM = 16 with H = 1 or 2, DIM =
// 32 with H = 1).
template <int DIM, int H>
struct Shape {
  static constexpr int kTok = DIM * H;      // floats per token
  static_assert(kTok <= 32, "wider tokens run the wide kernels");
  static constexpr int kStride = kTok + 4;  // shared row stride
  static constexpr int kVec = kTok / 4;     // float4 per token
  // rows a block owns (queries of the dq kernel, keys of the dkv kernel)
  static constexpr int kRowsBlk = 16 * kWarps;
  // k-steps of a product over DIM, and n-tiles (of 8 columns) of an
  // update: both DIM / 8
  static constexpr int kSteps = DIM / 8;
  // a lane's share of a token: 2 kSteps consecutive d of each head
  static constexpr int kPart = 2 * kSteps * H;
  // dynamic shared memory: two buffers of two operand tiles, the (L, D)
  // tiles of the dkv kernel, the segment's words
  static constexpr int kTileFloats = 2 * kTile * kStride;
  static constexpr int kSmemBytes =
      (2 * kTileFloats + 2 * kTile * 2 * H) * 4 + kMaxSegTiles * 4;
};
// three blocks per SM: registers capped at 168
constexpr int kMinBlocks = 3;

// Walks a segment's live tiles (words[i] != 0 for i < nt) through two
// shared buffers: stage(i, buf) issues tile i's copies, body(i, buf)
// computes on it while the next live tile lands in the other buffer.
template <class Stage, class Body>
__device__ __forceinline__ void walk(const unsigned* words, int nt,
                                     Stage stage, Body body) {
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
    body(i, buf);
    __syncthreads();  // the buffer is refilled next iteration
    buf ^= 1;
    i = inext;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d = sum over k-steps s of a[s] b[s], a fresh product, in 3xTF32.
// b[s] is built from `row` (a lane's share of one token, kPart floats):
// k-slots t and t + 4 of step s are its d = 2 s and 2 s + 1 of head h.
template <int DIM, int H>
__device__ __forceinline__ void product(
    float (&d)[4], const FragA (&a)[Shape<DIM, H>::kSteps],
    const float (&row)[Shape<DIM, H>::kPart], int h) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = 0.f;
#pragma unroll
  for (int st = 0; st < Shape<DIM, H>::kSteps; ++st)
    mma3(d, a[st], FragB(row[2 * st * H + h], row[(2 * st + 1) * H + h]));
}

// TF32 mma.sync throughput probe: every warp issues `iters` x 8
// independent m16n8k8 products; out[block] = a sum that keeps them live.
__global__ void __launch_bounds__(128)
mma_rate_kernel(int iters, float* __restrict__ out) {
  unsigned a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  b[0] = a[1];
  b[1] = a[2];
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(d[j], a, b);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (sum == 12345.f) out[blockIdx.x] = sum;
}

template <int N>
__device__ __forceinline__ void load(const float* p, float (&v)[N]) {
  static_assert(N % 2 == 0, "vector loads of 2 or 4 floats");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 t = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// The A fragments (every k-step) of one head for rows r and r + 8 of
// `rows` (a lane's share of a token: kPart floats from channel kPart t
// on, as load() reads it): k-slot (step s, t, half) is d = 2 kSteps t +
// 2 s + half (d = 4 t + 2 s + half at DIM = 16).
template <int DIM, int H>
__device__ __forceinline__ void frag_rows(
    const float (&r)[Shape<DIM, H>::kPart],
    const float (&r8)[Shape<DIM, H>::kPart], int h,
    FragA (&f)[Shape<DIM, H>::kSteps]) {
#pragma unroll
  for (int s = 0; s < Shape<DIM, H>::kSteps; ++s)
    f[s].set(r[2 * s * H + h], r8[2 * s * H + h], r[(2 * s + 1) * H + h],
             r8[(2 * s + 1) * H + h]);
}

// A lane's share of one token, kPart floats from channel kPart t on, from
// device memory; zeros for a row past the end.
template <int DIM, int H>
__device__ __forceinline__ void token_part(
    const float* base, int row, int rows, int t,
    float (&v)[Shape<DIM, H>::kPart]) {
  constexpr int kPart = Shape<DIM, H>::kPart;
  if (row < rows) {
    load(base + (size_t)row * Shape<DIM, H>::kTok + kPart * t, v);
  } else {
#pragma unroll
    for (int i = 0; i < kPart; ++i) v[i] = 0.f;
  }
}

// Per (frame, query): ld = (L log2 e or +inf, D) per head, and the tile's
// live word. One thread per query of npad (N rounded up to the dq
// kernel's rows per block) per frame, so a warp is one tile; rows past N
// get (+inf, 0). D is an FMA chain over the token's channels in order,
// read a float4 at a time.
template <int DIM, int H>
__global__ void __launch_bounds__(kFlatThreads)
flash_bwd_prep_kernel(const float* __restrict__ out,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ ld,
                      unsigned* __restrict__ words, int n, int npad,
                      int total) {
  constexpr int kTok = DIM * H;
  const int idx = blockIdx.x * kFlatThreads + threadIdx.x;
  if (idx >= total) return;  // whole warps: total is a multiple of 32
  const int batch = idx / npad, i = idx % npad;
  float D[H];
  bool nonzero = false;
#pragma unroll
  for (int h = 0; h < H; ++h) D[h] = 0.f;
  if (i < n) {
    const size_t r = ((size_t)batch * n + i) * kTok;
#pragma unroll 4
    for (int c4 = 0; c4 < kTok / 4; ++c4) {
      float o[4], g[4];
      load(out + r + 4 * c4, o);
      load(dout + r + 4 * c4, g);
      // per head an FMA chain over d in order
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        D[(4 * c4 + e) % H] = fmaf(g[e], o[e], D[(4 * c4 + e) % H]);
        nonzero |= g[e] != 0.f;  // true for NaN
      }
    }
  }
  bool live = false;
  float* lp = ld + ((size_t)batch * npad + i) * 2 * H;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float L = i < n ? lse[((size_t)batch * n + i) * H + h] : -INFINITY;
    const bool lh = nonzero && L != -INFINITY;
    live |= lh;
    lp[2 * h] = lh ? L * kLog2e : INFINITY;
    lp[2 * h + 1] = D[h];
  }
  const unsigned w = __ballot_sync(0xffffffffu, live);
  if (threadIdx.x % 32 == 0) words[idx / 32] = w;
}

// Key-tile mask words of one segment: word i has bit jj set when key
// (seg + i * segments) * kTile + jj is valid. kNT: the block's threads.
template <int kNT = kThreads>
__device__ __forceinline__ void key_words(const unsigned char* mb, int m,
                                          int seg, int segments, int nt,
                                          unsigned* words) {
  for (int i = threadIdx.x; i < nt; i += kNT) {
    const int j0 = (seg + i * segments) * kTile;
    unsigned wd = 0u;
#pragma unroll 8
    for (int jj = 0; jj < kTile; ++jj) {
      const int j = j0 + jj;
      if (j < m && mb[j]) wd |= 1u << jj;
    }
    words[i] = wd;
  }
}

// Writes rows r and r + 8 of a warp's (dim x head) accumulators,
// acc[h][n-tile][4] in m16n8 layout (columns d = kSteps g' + n-tile),
// times `mul`; zeros where `zero`. Lane (g, t) holds d = 2 kSteps t ..
// 2 kSteps t + 2 kSteps - 1 of both rows: channels kPart t .. kPart t +
// kPart - 1.
template <int DIM, int H>
__device__ __forceinline__ void write_rows(
    float* base, int row, int rows, int t,
    const float (&acc)[H][Shape<DIM, H>::kSteps][4], float mul, bool zero0,
    bool zero8) {
  constexpr int kSteps = Shape<DIM, H>::kSteps, kPart = Shape<DIM, H>::kPart;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= rows) continue;
    const bool zero = half ? zero8 : zero0;
    float v[kPart];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      // c0 / c2: column 2 t -> d = 2 kSteps t + n-tile; c1 / c3: d =
      // 2 kSteps t + kSteps + n-tile
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int nt = 0; nt < kSteps; ++nt)
          v[(e * kSteps + nt) * H + h] = acc[h][nt][2 * half + e] * mul;
    }
    if (zero) {
#pragma unroll
      for (int e = 0; e < kPart; ++e) v[e] = 0.f;
    }
    store(base + (size_t)r * Shape<DIM, H>::kTok + kPart * t, v);
  }
}

// The 16-bit live word of rows r .. r + 15 (r a multiple of 16) of one
// frame's query words.
__device__ __forceinline__ unsigned rows16(const unsigned* qw, int r) {
  return (qw[r / kTile] >> (r % kTile)) & 0xffffu;
}

// grid (ceil(N / kRowsBlk), segments, B). With one segment the block
// writes dq (times scale); with more, its partial sum goes to
// dq_out[(batch * segments + seg) * N ...].
template <int DIM, int H>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const unsigned char* __restrict__ kv_valid,
                    const float* __restrict__ dout,
                    const float* __restrict__ ld,
                    const unsigned* __restrict__ qwords,
                    float* __restrict__ dq_out, int n, int m, int npad,
                    int segments, float scale_log2e, float mul) {
  using S = Shape<DIM, H>;
  constexpr int kTok = S::kTok, kStride = S::kStride, kVec = S::kVec;
  constexpr int kSteps = S::kSteps, kPart = S::kPart;
  extern __shared__ __align__(16) float smem[];
  float (*ks)[kTile][kStride] =
      reinterpret_cast<float (*)[kTile][kStride]>(smem);
  float (*vs)[kTile][kStride] =
      reinterpret_cast<float (*)[kTile][kStride]>(smem + S::kTileFloats);
  unsigned* words = reinterpret_cast<unsigned*>(smem + 2 * S::kTileFloats +
                                                2 * kTile * 2 * H);

  const int batch = blockIdx.z, seg = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int i0 = blockIdx.x * S::kRowsBlk;
  const int r0 = i0 + warp * 16;  // the warp's rows r0 + g, r0 + g + 8
  float* ob = dq_out + ((size_t)batch * segments + seg) * n * kTok;
  const unsigned* qw = qwords + (size_t)batch * (npad / kTile);
  unsigned any = 0u;
#pragma unroll
  for (int r = 0; r < S::kRowsBlk; r += 16) any |= rows16(qw, i0 + r);
  const unsigned mine = rows16(qw, r0);

  float acc[H][kSteps][4];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int nt = 0; nt < kSteps; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][nt][e] = 0.f;

  if (any == 0u) {  // no live query: dq = 0 (uniform)
    write_rows<DIM, H>(ob, r0 + g, n, t, acc, 0.f, false, false);
    return;
  }

  const float* kb = k + (size_t)batch * m * kTok;
  const float* vb = v + (size_t)batch * m * kTok;
  const int tiles = (m + kTile - 1) / kTile;
  const int nt = seg < tiles ? (tiles - seg + segments - 1) / segments : 0;
  key_words(kv_valid + (size_t)batch * m, m, seg, segments, nt, words);

  // the warp's own rows: q and dout as A fragments, (L log2 e, D)
  FragA qf[H][kSteps], df[H][kSteps];
  float Lr[2][H], Dr[2][H];
  {
    float a[kPart], a8[kPart];
    const float* qb = q + (size_t)batch * n * kTok;
    const float* db = dout + (size_t)batch * n * kTok;
    token_part<DIM, H>(qb, r0 + g, n, t, a);
    token_part<DIM, H>(qb, r0 + g + 8, n, t, a8);
#pragma unroll
    for (int h = 0; h < H; ++h) frag_rows<DIM, H>(a, a8, h, qf[h]);
    token_part<DIM, H>(db, r0 + g, n, t, a);
    token_part<DIM, H>(db, r0 + g + 8, n, t, a8);
#pragma unroll
    for (int h = 0; h < H; ++h) frag_rows<DIM, H>(a, a8, h, df[h]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l[2 * H];
      load(ld + ((size_t)batch * npad + r0 + g + 8 * half) * 2 * H, l);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        Lr[half][h] = l[2 * h];
        Dr[half][h] = l[2 * h + 1];
      }
    }
  }
  __syncthreads();  // words[] complete

  auto stage = [&](int i, int buf) {
    const int j0 = (seg + i * segments) * kTile;
    for (int e = threadIdx.x; e < kTile * kVec; e += kThreads) {
      const int jj = e / kVec, c4 = e % kVec, j = j0 + jj;
      const bool ok = j < m;
      const size_t off = (size_t)(ok ? j : 0) * kTok + c4 * 4;
      async_copy::copy16(&ks[buf][jj][c4 * 4], kb + off, ok);
      async_copy::copy16(&vs[buf][jj][c4 * 4], vb + off, ok);
    }
  };
  walk(words, nt, stage, [&](int i, int buf) {
    const unsigned wd = words[i];
    if (mine == 0u) return;  // uniform across the warp
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += 8) {
      const unsigned cw = (wd >> c0) & 0xffu;
      // s and dout . v: B fragments from key row c0 + g, d = 2 kSteps t ..
      float kr[kPart], vr[kPart];
      load(&ks[buf][c0 + g][kPart * t], kr);
      load(&vs[buf][c0 + g][kPart * t], vr);
      // the dq update's B fragments: keys c0 + 2 t and c0 + 2 t + 1,
      // d = kSteps g + n-tile
      float ka[kSteps * H], kb2[kSteps * H];
      load(&ks[buf][c0 + 2 * t][kSteps * g * H], ka);
      load(&ks[buf][c0 + 2 * t + 1][kSteps * g * H], kb2);
      const bool m0 = (cw >> (2 * t)) & 1u, m1 = (cw >> (2 * t + 1)) & 1u;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float s[4], dp[4];
        product<DIM, H>(s, qf[h], kr, h);
        product<DIM, H>(dp, df[h], vr, h);
        // accumulator (row g / g + 8, key 2 t / 2 t + 1); a masked key
        // gets exp2(-inf) = 0
        const float p0 = ex2(m0 ? fmaf(s[0], scale_log2e, -Lr[0][h])
                                : -INFINITY);
        const float p1 = ex2(m1 ? fmaf(s[1], scale_log2e, -Lr[0][h])
                                : -INFINITY);
        const float p2 = ex2(m0 ? fmaf(s[2], scale_log2e, -Lr[1][h])
                                : -INFINITY);
        const float p3 = ex2(m1 ? fmaf(s[3], scale_log2e, -Lr[1][h])
                                : -INFINITY);
        FragA ds;
        ds.set(p0 * (dp[0] - Dr[0][h]), p2 * (dp[2] - Dr[1][h]),
               p1 * (dp[1] - Dr[0][h]), p3 * (dp[3] - Dr[1][h]));
#pragma unroll
        for (int n8 = 0; n8 < kSteps; ++n8)
          mma3(acc[h][n8], ds, FragB(ka[n8 * H + h], kb2[n8 * H + h]));
      }
    }
  });
  write_rows<DIM, H>(ob, r0 + g, n, t, acc, mul, false, false);
}

// grid (ceil(M / kRowsBlk), segments, B). With one segment the block
// writes dk (times scale) and dv; with more, its partial sums go to
// dk_out / dv_out[(batch * segments + seg) * M ...].
template <int DIM, int H>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ kv_valid,
                     const float* __restrict__ dout,
                     const float* __restrict__ ld,
                     const unsigned* __restrict__ qwords,
                     float* __restrict__ dk_out, float* __restrict__ dv_out,
                     int n, int m, int npad, int segments, float scale_log2e,
                     float mul) {
  using S = Shape<DIM, H>;
  constexpr int kTok = S::kTok, kStride = S::kStride, kVec = S::kVec;
  constexpr int kSteps = S::kSteps, kPart = S::kPart;
  extern __shared__ __align__(16) float smem[];
  float (*qs)[kTile][kStride] =
      reinterpret_cast<float (*)[kTile][kStride]>(smem);
  float (*dos)[kTile][kStride] =
      reinterpret_cast<float (*)[kTile][kStride]>(smem + S::kTileFloats);
  float (*lds)[kTile][2 * H] = reinterpret_cast<float (*)[kTile][2 * H]>(
      smem + 2 * S::kTileFloats);
  unsigned* words = reinterpret_cast<unsigned*>(smem + 2 * S::kTileFloats +
                                                2 * kTile * 2 * H);

  const int batch = blockIdx.z, seg = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int j0 = blockIdx.x * S::kRowsBlk;
  const int r0 = j0 + warp * 16;  // the warp's keys r0 + g, r0 + g + 8
  const unsigned char* mb = kv_valid + (size_t)batch * m;
  const bool v0 = r0 + g < m && mb[r0 + g];
  const bool v8 = r0 + g + 8 < m && mb[r0 + g + 8];
  const size_t orow = ((size_t)batch * segments + seg) * m * kTok;

  float dka[H][kSteps][4], dva[H][kSteps][4];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int nt = 0; nt < kSteps; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[h][nt][e] = dva[h][nt][e] = 0.f;

  // every key of the block masked: dk = dv = 0 (uniform)
  if (!__syncthreads_or(v0 || v8)) {
    write_rows<DIM, H>(dk_out + orow, r0 + g, m, t, dka, 0.f, true,
                       true);
    write_rows<DIM, H>(dv_out + orow, r0 + g, m, t, dva, 0.f, true,
                       true);
    return;
  }
  const bool mine = __any_sync(0xffffffffu, v0 || v8);

  const float* qb = q + (size_t)batch * n * kTok;
  const float* db = dout + (size_t)batch * n * kTok;
  const float* lb = ld + (size_t)batch * npad * 2 * H;
  const int tiles = npad / kTile;
  const int nt = seg < tiles ? (tiles - seg + segments - 1) / segments : 0;
  const unsigned* qw = qwords + (size_t)batch * tiles;
  for (int i = threadIdx.x; i < nt; i += kThreads)
    words[i] = qw[seg + i * segments];

  // the warp's own keys: k and v as A fragments
  FragA kf[H][kSteps], vf[H][kSteps];
  {
    float a[kPart], a8[kPart];
    const float* kb = k + (size_t)batch * m * kTok;
    const float* vb = v + (size_t)batch * m * kTok;
    token_part<DIM, H>(kb, r0 + g, m, t, a);
    token_part<DIM, H>(kb, r0 + g + 8, m, t, a8);
#pragma unroll
    for (int h = 0; h < H; ++h) frag_rows<DIM, H>(a, a8, h, kf[h]);
    token_part<DIM, H>(vb, r0 + g, m, t, a);
    token_part<DIM, H>(vb, r0 + g + 8, m, t, a8);
#pragma unroll
    for (int h = 0; h < H; ++h) frag_rows<DIM, H>(a, a8, h, vf[h]);
  }
  __syncthreads();  // words[] complete

  auto stage = [&](int i, int buf) {
    const int q0 = (seg + i * segments) * kTile;
    for (int e = threadIdx.x; e < kTile * kVec; e += kThreads) {
      const int ii = e / kVec, c4 = e % kVec, row = q0 + ii;
      const bool ok = row < n;
      const size_t off = (size_t)(ok ? row : 0) * kTok + c4 * 4;
      async_copy::copy16(&qs[buf][ii][c4 * 4], qb + off, ok);
      async_copy::copy16(&dos[buf][ii][c4 * 4], db + off, ok);
    }
    // (L, D) of the tile: 64 H contiguous floats (rows past N included)
    for (int e = threadIdx.x; e < kTile * H / 2; e += kThreads)
      async_copy::copy16(&lds[buf][0][0] + 4 * e,
                         lb + (size_t)q0 * 2 * H + 4 * e, true);
  };
  walk(words, nt, stage, [&](int, int buf) {
    if (!mine) return;  // uniform across the warp
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += 8) {
      // s^T and (dout . v)^T: B fragments from query row c0 + g
      float qr[kPart], dr[kPart];
      load(&qs[buf][c0 + g][kPart * t], qr);
      load(&dos[buf][c0 + g][kPart * t], dr);
      // the updates' B fragments: queries c0 + 2 t and c0 + 2 t + 1,
      // d = kSteps g + n-tile
      float qa[kSteps * H], qb2[kSteps * H], da[kSteps * H],
          db2[kSteps * H];
      load(&qs[buf][c0 + 2 * t][kSteps * g * H], qa);
      load(&qs[buf][c0 + 2 * t + 1][kSteps * g * H], qb2);
      load(&dos[buf][c0 + 2 * t][kSteps * g * H], da);
      load(&dos[buf][c0 + 2 * t + 1][kSteps * g * H], db2);
      // (L log2 e, D) per head of queries c0 + 2 t, c0 + 2 t + 1
      float la[2 * H], lc[2 * H];
      load(&lds[buf][c0 + 2 * t][0], la);
      load(&lds[buf][c0 + 2 * t + 1][0], lc);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float s[4], dp[4];
        product<DIM, H>(s, kf[h], qr, h);
        product<DIM, H>(dp, vf[h], dr, h);
        // accumulator (key g / g + 8, query 2 t / 2 t + 1); a dead
        // query has L = +inf, so p = 0
        const float p0 = ex2(fmaf(s[0], scale_log2e, -la[2 * h]));
        const float p1 = ex2(fmaf(s[1], scale_log2e, -lc[2 * h]));
        const float p2 = ex2(fmaf(s[2], scale_log2e, -la[2 * h]));
        const float p3 = ex2(fmaf(s[3], scale_log2e, -lc[2 * h]));
        FragA pf, ds;
        pf.set(p0, p2, p1, p3);
        ds.set(p0 * (dp[0] - la[2 * h + 1]), p2 * (dp[2] - la[2 * h + 1]),
               p1 * (dp[1] - lc[2 * h + 1]), p3 * (dp[3] - lc[2 * h + 1]));
#pragma unroll
        for (int n8 = 0; n8 < kSteps; ++n8) {
          mma3(dva[h][n8], pf, FragB(da[n8 * H + h], db2[n8 * H + h]));
          mma3(dka[h][n8], ds, FragB(qa[n8 * H + h], qb2[n8 * H + h]));
        }
      }
    }
  });
  // a masked key's row may hold anything (rows of a product are
  // independent): it is written as zeros
  write_rows<DIM, H>(dk_out + orow, r0 + g, m, t, dka, mul, !v0, !v8);
  write_rows<DIM, H>(dv_out + orow, r0 + g, m, t, dva, 1.f, !v0, !v8);
}

// ---- DIM = 64 and 128: whole-width warps ----
//
// flash_bwd_dq_wide_kernel and flash_bwd_dkv_wide_kernel replace, at
// these two widths, the same TPU function's dq and dkv pallas_calls
// (pose6d_tpu/ops/pallas/attention.py:30, the library flash attention's
// fused backward). What bounds them on the H100: the rate of mma.sync,
// ~316 TFLOP/s of TF32 (mma_rate_kernel, H100 80GB HBM3, 700 W), for 7
// products of 3 x 2 DIM flops per (query, key): s and dout . v in both
// kernels, dq, dk and dv once. The inputs (~2 MB a frame at DIM 128) are
// read from L2 once per block of owned rows.
// What the design does about it:
// - No dimension split: a warp owns 16 rows at the full DIM. Its
//   accumulators stay in f32 registers, DIM / 2 floats a lane each (dq
//   in the dq kernel; dk and dv in the dkv kernel: 128 at DIM 128).
// - The block's own operands (q and dout in the dq kernel, k and v in
//   the dkv kernel) are copied once, raw f32, into shared memory, and
//   their A fragments read from there for each product and split there
//   (hi = the top 19 bits, lo = the rest): registers at DIM 128 hold the
//   accumulators but not the raw fragments too. Stored split, they
//   would take twice the shared memory and leave no room for the walked
//   tiles.
// - Blocks own kWarps x 16 rows: 128 at DIM 128 (8 warps, one block an
//   SM: 193.5 KB of shared memory, 255 registers a thread), 64 at DIM 64
//   (4 warps, 65.5 KB, three blocks an SM). Each staged tile of 32
//   walked rows serves all of them: 4-8x the rows of the split design,
//   whose warps also swapped partial s and dout . v through shared
//   memory for every 8 walked rows.
// - Per walked tile a warp computes s (or s^T) for its 16 rows against
//   all 32 walked rows at once: each A fragment, read and split once a
//   k-step, feeds 4 n-tiles; dout . v likewise. The k index of those
//   products is permuted as in flash_fwd_tc_kernel (k-step 2 p + e, slot
//   t: dim 16 p + 4 t + 2 e; slot t + 4: the next dim), so a lane reads
//   its A and B fragments of two k-steps as one float4 of a row.
// - The walked rows of n-tile c are rows 8 c .. 8 c + 7 in order, so the
//   accumulator's columns 2 t and 2 t + 1 are walked rows 8 c + 2 t and
//   8 c + 2 t + 1: P and dS leave the accumulator as the A fragment of
//   the update's k-step c (k-slot t: row 8 c + 2 t, slot t + 4: the next
//   row), without a shuffle or a shared-memory round trip. An update's
//   n-tile 4 i + j holds dims 32 i + 4 g + j for B column g, so its B
//   fragments are float4s of the walked rows and a lane's accumulators
//   hold 8 contiguous dims of a row (float4 stores).
// - Tiles are DIM floats a row without padding; granule (4 floats) q of
//   row r is stored at q ^ swz(r), swz(r) = (r & 6) ^ 4 (r & 1), which
//   puts the 8 lanes of every quarter-warp's float4 read in 8 distinct
//   bank groups in both read patterns (rows 8 c + g at granule 4 p + t,
//   and rows 8 c + 2 t (+ 1) at granule 8 i + g), where no row padding
//   serves both.
// - The walked tiles (k and v, or q, dout and (L, D)) go through two
//   buffers with 16-byte cp.async, the own rows with the first tile;
//   tiles with no valid key or no live query are skipped, as in the
//   kernels above, and so are warps whose own rows are all dead.
// - mma.sync and not wgmma: TF32 wgmma reads both operands K-major from
//   shared memory, but the walked tile is the B operand of s = q k^T with
//   the dims as k and of dq = dS k with the rows as k, so every tile
//   would be stored twice (transposed, and split into hi and lo for
//   3xTF32): 4x the shared memory of one raw tile, and a transpose per
//   stage.
template <int DIM>
struct Wide {
  static constexpr int kWarps = DIM == 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowsBlk = 16 * kWarps;  // also the query padding
  static constexpr int kVec = DIM / 4;          // granules a row
  static constexpr int kOwnFloats = kRowsBlk * DIM;
  static constexpr int kTileFloats = kTile * DIM;
  // own two operands, two buffers of two walked tiles, two (L, D) tiles,
  // the segment's words
  static constexpr int kSmemBytes =
      (2 * kOwnFloats + 4 * kTileFloats + 2 * kTile * 2) * 4 +
      kMaxSegTiles * 4;
  // DIM 128: the dkv kernel's dk and dv take 128 registers a lane (255);
  // DIM 64: three blocks (168 registers; faster than two blocks of 255 on
  // an H100, scripts/torch_flash_bwd_variants.py)
  static constexpr int kMinBlocks = DIM == 128 ? 1 : 3;
  static_assert(DIM % 32 == 0, "whole float4 groups of n-tiles");
};

// Offset of granule q (4 floats) of row r in a swizzled tile of DIM-float
// rows.
template <int DIM>
__device__ __forceinline__ int swz(int r, int q) {
  return r * DIM + 4 * (q ^ ((r & 6) ^ ((r & 1) << 2)));
}

// Copies rows r0 .. r0 + count - 1 of a (rows, DIM) matrix into a
// swizzled tile (zeros past the end), kNT threads.
template <int DIM, int kNT>
__device__ __forceinline__ void stage_rows(float* tile, const float* src,
                                           int r0, int count, int rows) {
  constexpr int kVec = DIM / 4;
  for (int e = threadIdx.x; e < count * kVec; e += kNT) {
    const int r = e / kVec, c4 = e % kVec, row = r0 + r;
    const bool ok = row < rows;
    async_copy::copy16(tile + swz<DIM>(r, c4),
                       src + (size_t)(ok ? row : 0) * DIM + 4 * c4, ok);
  }
}

// A lane's offset (floats) of granule 4 p + t in a row r = g (mod 8) of
// a swizzled tile, less 16 p: swz(g) = 4 s2 + low puts the granule at 4 (p
// ^ s2) + (t ^ low), i.e. 16 p + 4 (t ^ low) + 16 s2 for even p and - 16
// s2 for odd p. Every address of the hot loops is such a lane offset plus
// a compile-time one.
__device__ __forceinline__ int lane_offset(int g, int t, int odd) {
  const int sw = (g & 6) ^ ((g & 1) << 2);
  return 4 * (t ^ (sw & 3)) + (odd ? -16 : 16) * (sw >> 2);
}

// acc[c] = (own rows r, r + 8) . (walked rows 8 c + g) over DIM for the
// 4 n-tiles c of a walked tile, in 3xTF32: column g of n-tile c is walked
// row 8 c + g. r = g (mod 8).
template <int DIM>
__device__ __forceinline__ void scores(float (&acc)[4][4], const float* own,
                                       int r, const float* walked, int g,
                                       int t) {
  const int le = lane_offset(g, t, 0), lo = lane_offset(g, t, 1);
  const float* oe = own + r * DIM + le;
  const float* oo = own + r * DIM + lo;
  const float* we = walked + g * DIM + le;
  const float* wo = walked + g * DIM + lo;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
#pragma unroll
  for (int p = 0; p < DIM / 16; ++p) {
    const float* o = (p & 1 ? oo : oe) + 16 * p;
    const float4 x = *reinterpret_cast<const float4*>(o);
    const float4 y = *reinterpret_cast<const float4*>(o + 8 * DIM);
    FragA ae, ao;
    ae.set(x.x, y.x, x.y, y.y);
    ao.set(x.z, y.z, x.w, y.w);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(
          (p & 1 ? wo : we) + 16 * p + 8 * c * DIM);
      mma3(acc[c], ae, FragB(b.x, b.y));
      mma3(acc[c], ao, FragB(b.z, b.w));
    }
  }
}

// acc[4 i + j] += a . walked rows 8 c + 2 t, 8 c + 2 t + 1 (k-slots t,
// t + 4), columns: dims 32 i + 4 g + j, in 3xTF32. Granule 8 i + g of
// row 8 c + 2 t (swz 2 t) is at 32 i + 4 (g ^ 2 t), of row 8 c + 2 t + 1
// (swz 2 t ^ 4) at 32 i + 4 (g ^ 2 t ^ 4).
template <int DIM>
__device__ __forceinline__ void update(float (&acc)[DIM / 8][4],
                                       const FragA& a, const float* walked,
                                       int c, int g, int t) {
  const float* w0 = walked + (8 * c + 2 * t) * DIM + 4 * (g ^ (2 * t));
  const float* w1 =
      walked + (8 * c + 2 * t + 1) * DIM + 4 * (g ^ (2 * t) ^ 4);
#pragma unroll
  for (int i = 0; i < DIM / 32; ++i) {
    const float4 x0 = *reinterpret_cast<const float4*>(w0 + 32 * i);
    const float4 x1 = *reinterpret_cast<const float4*>(w1 + 32 * i);
    mma3(acc[4 * i], a, FragB(x0.x, x1.x));
    mma3(acc[4 * i + 1], a, FragB(x0.y, x1.y));
    mma3(acc[4 * i + 2], a, FragB(x0.z, x1.z));
    mma3(acc[4 * i + 3], a, FragB(x0.w, x1.w));
  }
}

// Writes rows row and row + 8 of a warp's update accumulators (lane (g,
// t): dims 32 i + 8 t + j from c0 / c2 of n-tile 4 i + j, 32 i + 8 t + 4 +
// j from c1 / c3) times `mul`; zeros where zero0 / zero8.
template <int DIM>
__device__ __forceinline__ void write_wide(float* base, int row, int rows,
                                           int t,
                                           const float (&acc)[DIM / 8][4],
                                           float mul, bool zero0,
                                           bool zero8) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= rows) continue;
    const bool zero = half ? zero8 : zero0;
    float4* o = reinterpret_cast<float4*>(base + (size_t)r * DIM);
#pragma unroll
    for (int i = 0; i < DIM / 32; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * half + e;
        o[8 * i + 2 * t + e] =
            zero ? make_float4(0.f, 0.f, 0.f, 0.f)
                 : make_float4(acc[4 * i][k] * mul, acc[4 * i + 1][k] * mul,
                               acc[4 * i + 2][k] * mul,
                               acc[4 * i + 3][k] * mul);
      }
    }
  }
}

template <int DIM>
__device__ __forceinline__ void zero_acc(float (&acc)[DIM / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < DIM / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// grid (ceil(N / kRowsBlk), segments, B), one head; as flash_bwd_dq_kernel.
template <int DIM>
__global__ void __launch_bounds__(Wide<DIM>::kThreads, Wide<DIM>::kMinBlocks)
flash_bwd_dq_wide_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const unsigned char* __restrict__ kv_valid,
                         const float* __restrict__ dout,
                         const float* __restrict__ ld,
                         const unsigned* __restrict__ qwords,
                         float* __restrict__ dq_out, int n, int m, int npad,
                         int segments, float scale_log2e, float mul) {
  using W = Wide<DIM>;
  constexpr int kNT = W::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // own rows, swizzled
  float* dos = qs + W::kOwnFloats;
  float* ks = dos + W::kOwnFloats;     // two buffers each
  float* vs = ks + 2 * W::kTileFloats;
  unsigned* words = reinterpret_cast<unsigned*>(
      vs + 2 * W::kTileFloats + 2 * kTile * 2);

  const int batch = blockIdx.z, seg = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int i0 = blockIdx.x * W::kRowsBlk;
  const int wr = warp * 16;  // the warp's rows i0 + wr + g, + 8
  float* ob = dq_out + ((size_t)batch * segments + seg) * n * DIM;
  const unsigned* qw = qwords + (size_t)batch * (npad / kTile);
  unsigned any = 0u;
#pragma unroll
  for (int r = 0; r < W::kRowsBlk; r += 16) any |= rows16(qw, i0 + r);
  const unsigned mine = rows16(qw, i0 + wr);

  float acc[DIM / 8][4];
  zero_acc<DIM>(acc);
  if (any == 0u) {  // no live query: dq = 0 (uniform)
    write_wide<DIM>(ob, i0 + wr + g, n, t, acc, 0.f, false, false);
    return;
  }

  const float* kb = k + (size_t)batch * m * DIM;
  const float* vb = v + (size_t)batch * m * DIM;
  const int tiles = (m + kTile - 1) / kTile;
  const int nt = seg < tiles ? (tiles - seg + segments - 1) / segments : 0;
  key_words<kNT>(kv_valid + (size_t)batch * m, m, seg, segments, nt, words);
  // the own rows land with the first walked tile
  stage_rows<DIM, kNT>(qs, q + (size_t)batch * n * DIM, i0, W::kRowsBlk, n);
  stage_rows<DIM, kNT>(dos, dout + (size_t)batch * n * DIM, i0, W::kRowsBlk,
                       n);
  float Lr[2], Dr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float2 l = *reinterpret_cast<const float2*>(
        ld + ((size_t)batch * npad + i0 + wr + g + 8 * half) * 2);
    Lr[half] = l.x;
    Dr[half] = l.y;
  }
  __syncthreads();  // words[] complete

  auto stage = [&](int i, int buf) {
    const int j0 = (seg + i * segments) * kTile;
    stage_rows<DIM, kNT>(ks + buf * W::kTileFloats, kb, j0, kTile, m);
    stage_rows<DIM, kNT>(vs + buf * W::kTileFloats, vb, j0, kTile, m);
  };
  walk(words, nt, stage, [&](int i, int buf) {
    if (mine == 0u) return;  // uniform across the warp
    const unsigned wd = words[i];
    const float* kt = ks + buf * W::kTileFloats;
    float s[4][4], dp[4][4];
    scores<DIM>(s, qs, wr + g, kt, g, t);
    scores<DIM>(dp, dos, wr + g, vs + buf * W::kTileFloats, g, t);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // accumulator (row g / g + 8, key 8 c + 2 t / + 1); a masked key
      // gets exp2(-inf) = 0
      const bool m0 = (wd >> (8 * c + 2 * t)) & 1u;
      const bool m1 = (wd >> (8 * c + 2 * t + 1)) & 1u;
      const float p0 = ex2(m0 ? fmaf(s[c][0], scale_log2e, -Lr[0]) : -INFINITY);
      const float p1 = ex2(m1 ? fmaf(s[c][1], scale_log2e, -Lr[0]) : -INFINITY);
      const float p2 = ex2(m0 ? fmaf(s[c][2], scale_log2e, -Lr[1]) : -INFINITY);
      const float p3 = ex2(m1 ? fmaf(s[c][3], scale_log2e, -Lr[1]) : -INFINITY);
      FragA ds;
      ds.set(p0 * (dp[c][0] - Dr[0]), p2 * (dp[c][2] - Dr[1]),
             p1 * (dp[c][1] - Dr[0]), p3 * (dp[c][3] - Dr[1]));
      update<DIM>(acc, ds, kt, c, g, t);
    }
  });
  async_copy::wait<0>();  // the own rows' copies, when no tile was walked
  write_wide<DIM>(ob, i0 + wr + g, n, t, acc, mul, false, false);
}

// grid (ceil(M / kRowsBlk), segments, B), one head; as
// flash_bwd_dkv_kernel.
template <int DIM>
__global__ void __launch_bounds__(Wide<DIM>::kThreads, Wide<DIM>::kMinBlocks)
flash_bwd_dkv_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const unsigned char* __restrict__ kv_valid,
                          const float* __restrict__ dout,
                          const float* __restrict__ ld,
                          const unsigned* __restrict__ qwords,
                          float* __restrict__ dk_out,
                          float* __restrict__ dv_out, int n, int m,
                          int npad, int segments, float scale_log2e,
                          float mul) {
  using W = Wide<DIM>;
  constexpr int kNT = W::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* kso = smem;                   // own rows, swizzled
  float* vso = kso + W::kOwnFloats;
  float* qs = vso + W::kOwnFloats;     // two buffers each
  float* dos = qs + 2 * W::kTileFloats;
  float* lds = dos + 2 * W::kTileFloats;  // [2][kTile][2]
  unsigned* words = reinterpret_cast<unsigned*>(lds + 2 * kTile * 2);

  const int batch = blockIdx.z, seg = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int j0 = blockIdx.x * W::kRowsBlk;
  const int wr = warp * 16;  // the warp's keys j0 + wr + g, + 8
  const int r0 = j0 + wr;
  const unsigned char* mb = kv_valid + (size_t)batch * m;
  const bool v0 = r0 + g < m && mb[r0 + g];
  const bool v8 = r0 + g + 8 < m && mb[r0 + g + 8];
  const size_t orow = ((size_t)batch * segments + seg) * m * DIM;

  float dka[DIM / 8][4], dva[DIM / 8][4];
  zero_acc<DIM>(dka);
  zero_acc<DIM>(dva);
  // every key of the block masked: dk = dv = 0 (uniform)
  if (!__syncthreads_or(v0 || v8)) {
    write_wide<DIM>(dk_out + orow, r0 + g, m, t, dka, 0.f, true, true);
    write_wide<DIM>(dv_out + orow, r0 + g, m, t, dva, 0.f, true, true);
    return;
  }
  const bool mine = __any_sync(0xffffffffu, v0 || v8);

  const float* qb = q + (size_t)batch * n * DIM;
  const float* db = dout + (size_t)batch * n * DIM;
  const float* lb = ld + (size_t)batch * npad * 2;
  const int tiles = npad / kTile;
  const int nt = seg < tiles ? (tiles - seg + segments - 1) / segments : 0;
  const unsigned* qw = qwords + (size_t)batch * tiles;
  for (int i = threadIdx.x; i < nt; i += kNT) words[i] = qw[seg + i * segments];
  stage_rows<DIM, kNT>(kso, k + (size_t)batch * m * DIM, j0, W::kRowsBlk, m);
  stage_rows<DIM, kNT>(vso, v + (size_t)batch * m * DIM, j0, W::kRowsBlk, m);
  __syncthreads();  // words[] complete

  auto stage = [&](int i, int buf) {
    const int q0 = (seg + i * segments) * kTile;
    stage_rows<DIM, kNT>(qs + buf * W::kTileFloats, qb, q0, kTile, n);
    stage_rows<DIM, kNT>(dos + buf * W::kTileFloats, db, q0, kTile, n);
    // (L, D) of the tile: 64 contiguous floats (rows past N included)
    for (int e = threadIdx.x; e < kTile / 2; e += kNT)
      async_copy::copy16(lds + buf * kTile * 2 + 4 * e,
                         lb + (size_t)q0 * 2 + 4 * e, true);
  };
  walk(words, nt, stage, [&](int, int buf) {
    if (!mine) return;  // uniform across the warp
    const float* qt = qs + buf * W::kTileFloats;
    const float* dt = dos + buf * W::kTileFloats;
    const float* lt = lds + buf * kTile * 2;
    float s[4][4], dp[4][4];
    scores<DIM>(s, kso, wr + g, qt, g, t);
    scores<DIM>(dp, vso, wr + g, dt, g, t);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // accumulator (key g / g + 8, query 8 c + 2 t / + 1); a dead query
      // has L = +inf, so p = 0
      const float2 la = *reinterpret_cast<const float2*>(lt + 2 * (8 * c + 2 * t));
      const float2 lc =
          *reinterpret_cast<const float2*>(lt + 2 * (8 * c + 2 * t + 1));
      const float p0 = ex2(fmaf(s[c][0], scale_log2e, -la.x));
      const float p1 = ex2(fmaf(s[c][1], scale_log2e, -lc.x));
      const float p2 = ex2(fmaf(s[c][2], scale_log2e, -la.x));
      const float p3 = ex2(fmaf(s[c][3], scale_log2e, -lc.x));
      FragA pf, ds;
      pf.set(p0, p2, p1, p3);
      ds.set(p0 * (dp[c][0] - la.y), p2 * (dp[c][2] - la.y),
             p1 * (dp[c][1] - lc.y), p3 * (dp[c][3] - lc.y));
      update<DIM>(dva, pf, dt, c, g, t);
      update<DIM>(dka, ds, qt, c, g, t);
    }
  });
  async_copy::wait<0>();  // the own rows' copies, when no tile was walked
  // a masked key's row may hold anything (rows of a product are
  // independent): it is written as zeros
  write_wide<DIM>(dk_out + orow, r0 + g, m, t, dka, mul, !v0, !v8);
  write_wide<DIM>(dv_out + orow, r0 + g, m, t, dva, 1.f, !v0, !v8);
}

// out[b, r, :] = mul * sum over s in order of part[b, s, r, :], one
// float4 per thread.
__global__ void __launch_bounds__(kFlatThreads)
flash_bwd_merge_kernel(const float4* __restrict__ part,
                       float4* __restrict__ out, int per_frame,
                       int segments, int total, float mul) {
  const int idx = blockIdx.x * kFlatThreads + threadIdx.x;
  if (idx >= total) return;
  const int b = idx / per_frame, r = idx % per_frame;
  const float4* pb = part + (size_t)b * segments * per_frame + r;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sg = 0; sg < segments; ++sg) {
    const float4 x = pb[(size_t)sg * per_frame];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  out[idx] = make_float4(a.x * mul, a.y * mul, a.z * mul, a.w * mul);
}

int merge(const float* part, float* out, int batch, int rows, int tok,
          int segments, float mul, cudaStream_t stream) {
  const int per_frame = rows * tok / 4, total = batch * per_frame;
  flash_bwd_merge_kernel<<<(total + kFlatThreads - 1) / kFlatThreads,
                           kFlatThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out),
      per_frame, segments, total, mul);
  return static_cast<int>(cudaGetLastError());
}

// An instance's kernels and tiling: flash_bwd_dq_kernel and
// flash_bwd_dkv_kernel up to 32 floats a token, the wide kernels above
// (DIM 64 and 128, one head).
template <int DIM, int H, bool kWide = (DIM * H > 32)>
struct Plan {
  using S = Shape<DIM, H>;
  static constexpr int kRowsBlk = S::kRowsBlk, kThreads = ::kThreads;
  static constexpr int kSmemBytes = S::kSmemBytes;
  static constexpr auto dq = flash_bwd_dq_kernel<DIM, H>;
  static constexpr auto dkv = flash_bwd_dkv_kernel<DIM, H>;
};
template <int DIM, int H>
struct Plan<DIM, H, true> {
  static_assert(H == 1, "wide tokens are one head");
  using W = Wide<DIM>;
  static constexpr int kRowsBlk = W::kRowsBlk, kThreads = W::kThreads;
  static constexpr int kSmemBytes = W::kSmemBytes;
  static constexpr auto dq = flash_bwd_dq_wide_kernel<DIM>;
  static constexpr auto dkv = flash_bwd_dkv_wide_kernel<DIM>;
};

// The dq (which 0) or dkv (1) kernel of an instance, its dynamic shared
// memory allowed (once).
template <int DIM, int H>
const void* prepared(int which) {
  using P = Plan<DIM, H>;
  static const bool done = [] {
    cudaFuncSetAttribute(P::dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         P::kSmemBytes);
    cudaFuncSetAttribute(P::dkv,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         P::kSmemBytes);
    return true;
  }();
  (void)done;
  return which == 0 ? reinterpret_cast<const void*>(P::dq)
                    : reinterpret_cast<const void*>(P::dkv);
}

template <int DIM, int H>
int launch(const float* q, const float* k, const float* v,
           const unsigned char* valid, const float* out, const float* dout,
           const float* lse, float* ld, unsigned* qwords, float* dq,
           float* dk, float* dv, float* part_q, float* part_k,
           float* part_v, int batch, int n, int m, int seg_q, int seg_kv,
           float scale, cudaStream_t stream) {
  using P = Plan<DIM, H>;
  constexpr int kTok = DIM * H, kRowsBlk = P::kRowsBlk;
  // queries padded to whole dq blocks (a multiple of the 32-row tiles)
  const int npad = (n + kRowsBlk - 1) / kRowsBlk * kRowsBlk;
  const int ktiles = (m + kTile - 1) / kTile, qtiles = npad / kTile;
  if ((ktiles + seg_q - 1) / seg_q > kMaxSegTiles ||
      (qtiles + seg_kv - 1) / seg_kv > kMaxSegTiles ||
      (seg_q > 1 && part_q == nullptr) ||
      (seg_kv > 1 && (part_k == nullptr || part_v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  prepared<DIM, H>(0);
  const float sl2e = scale * kLog2e;
  const int total = batch * npad;
  flash_bwd_prep_kernel<DIM, H>
      <<<(total + kFlatThreads - 1) / kFlatThreads, kFlatThreads, 0,
         stream>>>(out, dout, lse, ld, qwords, n, npad, total);
  dim3 gq((n + kRowsBlk - 1) / kRowsBlk, seg_q, batch);
  P::dq<<<gq, P::kThreads, P::kSmemBytes, stream>>>(
      q, k, v, valid, dout, ld, qwords, seg_q > 1 ? part_q : dq, n, m, npad,
      seg_q, sl2e, seg_q > 1 ? 1.f : scale);
  if (seg_q > 1) {
    const int e = merge(part_q, dq, batch, n, kTok, seg_q, scale, stream);
    if (e) return e;
  }
  dim3 gk((m + kRowsBlk - 1) / kRowsBlk, seg_kv, batch);
  P::dkv<<<gk, P::kThreads, P::kSmemBytes, stream>>>(
      q, k, v, valid, dout, ld, qwords, seg_kv > 1 ? part_k : dk,
      seg_kv > 1 ? part_v : dv, n, m, npad, seg_kv, sl2e,
      seg_kv > 1 ? 1.f : scale);
  if (seg_kv > 1) {
    int e = merge(part_k, dk, batch, m, kTok, seg_kv, scale, stream);
    if (!e) e = merge(part_v, dv, batch, m, kTok, seg_kv, 1.f, stream);
    if (e) return e;
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DIM, int H>
int tiles(int kernel, int* out) {
  using P = Plan<DIM, H>;
  out[0] = P::kRowsBlk;
  out[1] = kTile;
  out[2] = kMaxSegTiles;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], prepared<DIM, H>(kernel), P::kThreads, P::kSmemBytes));
}

}  // namespace

// Runs mma_rate_kernel on `blocks` blocks of 128 threads (out: `blocks`
// floats of device scratch).
extern "C" int flash_cross_attention_bwd_mma_rate(int blocks, int iters,
                                                  void* out, void* stream) {
  mma_rate_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The tiling of the dq (kernel 0) or dkv (kernel 1) kernel for (dim,
// heads), for the wrapper's planner: {rows per block, walked rows per
// tile, most tiles per segment, resident blocks per SM on this card}.
// Non-zero for an instance the kernels do not have.
extern "C" int flash_cross_attention_bwd_tiles(int dim, int heads,
                                               int kernel, int* out) {
  if (kernel != 0 && kernel != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (heads == 2 && dim == 16) return tiles<16, 2>(kernel, out);
  if (heads != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dim) {
    case 16: return tiles<16, 1>(kernel, out);
    case 32: return tiles<32, 1>(kernel, out);
    case 64: return tiles<64, 1>(kernel, out);
    case 128: return tiles<128, 1>(kernel, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, out, dout (B, n, dim, heads), k, v (B, m, dim, heads) f32 (dim 16
// with heads 1 or 2; dim 32, 64 or 128 with heads 1), kv_valid (B, m)
// bytes, lse (B, n, heads) f32, contiguous, 16-byte aligned. Scratch: ld
// (B, npad, heads, 2) f32 and qwords (B, npad / 32) u32 with npad = n
// rounded up to the dq kernel's rows per block (128 at dim 128, else 64);
// with seg_q > 1, part_q (B, seg_q, n, dim * heads);
// with seg_kv > 1, part_k and part_v (B, seg_kv, m, dim * heads) f32.
extern "C" int flash_cross_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* kv_valid,
    const void* out, const void* dout, const void* lse, void* ld,
    void* qwords, void* dq, void* dk, void* dv, void* part_q, void* part_k,
    void* part_v, int batch, int n, int m, int dim, int heads, int seg_q,
    int seg_kv, float scale, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || seg_q < 1 || seg_kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const unsigned char* mv = static_cast<const unsigned char*>(kv_valid);
  unsigned* qw = static_cast<unsigned*>(qwords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_LAUNCH(D, H)                                               \
  launch<D, H>(f(q), f(k), f(v), mv, f(out), f(dout), f(lse), w(ld), qw,     \
               w(dq), w(dk), w(dv), w(part_q), w(part_k), w(part_v), batch,  \
               n, m, seg_q, seg_kv, scale, s)
  if (heads == 2 && dim == 16) return FLASH_BWD_LAUNCH(16, 2);
  if (heads != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dim) {
    case 16: return FLASH_BWD_LAUNCH(16, 1);
    case 32: return FLASH_BWD_LAUNCH(32, 1);
    case 64: return FLASH_BWD_LAUNCH(64, 1);
    case 128: return FLASH_BWD_LAUNCH(128, 1);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_LAUNCH
}
