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
// dk, dv (B, M, DIM, H); channel c = d * H + h; scale 1/sqrt(DIM).
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
//   dq   : a block of kRows queries (both heads) walks the key tiles;
//   dkv  : a block of kRows keys (both heads) walks the query tiles;
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
// What the design does about it:
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

namespace {

constexpr int kDim = 16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // queries per dq block, keys per dkv
constexpr int kTile = 32;           // walked rows per tile: one mask bit each
constexpr int kMaxSegTiles = 256;   // tiles one segment can walk
constexpr int kFlatThreads = 128;   // prep and merge passes
constexpr float kLog2e = 1.4426950408889634f;

template <int H>
struct Shape {
  static constexpr int kTok = kDim * H;     // floats per token
  static constexpr int kStride = kTok + 4;  // shared row stride
  static constexpr int kVec = kTok / 4;     // float4 per token
  // three blocks per SM for one or two heads: registers capped at 168
  static constexpr int kMinBlocks = H <= 2 ? 3 : 1;
};

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

// x = hi + lo: hi is x truncated to TF32 (its top 19 bits; one LOP3,
// where cvt.rna.tf32.f32 compiles to four instructions on sm_90), lo the
// exact rest, |lo| < 2^-10 |x|, which goes in as raw f32 bits (the
// tensor core reads its top 19 bits): ~2^-20 |x| from the exact rest.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A fragment of m16n8k8 (rows g, g + 8; k-slots t, t + 4), split.
struct FragA {
  unsigned hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// B fragment (k-slots t, t + 4; column g), split.
struct FragB {
  unsigned hi[2], lo[2];
  __device__ __forceinline__ FragB(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small cross terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// d = a[0] b[0] + a[1] b[1], a fresh product over both k-steps, in
// 3xTF32.
__device__ __forceinline__ void product(float (&d)[4], const FragA (&a)[2],
                                        const FragB& b0, const FragB& b1) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = 0.f;
  mma3(d, a[0], b0);
  mma3(d, a[1], b1);
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

// The A fragments (both k-steps) of one head for rows r and r + 8 of
// `rows` (a token of 4 H floats from channel 4 t H on, as load() reads
// it): k-slot (step s, t, half) is d = 4 t + 2 s + half.
template <int H>
__device__ __forceinline__ void frag_rows(const float (&r)[4 * H],
                                          const float (&r8)[4 * H], int h,
                                          FragA (&f)[2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
    f[s].set(r[2 * s * H + h], r8[2 * s * H + h], r[(2 * s + 1) * H + h],
             r8[(2 * s + 1) * H + h]);
}

// One token's 4 H floats from channel 4 t H on, from device memory;
// zeros for a row past the end.
template <int H>
__device__ __forceinline__ void token_quad(const float* base, int row,
                                           int rows, int t,
                                           float (&v)[4 * H]) {
  if (row < rows) {
    load(base + (size_t)row * Shape<H>::kTok + 4 * t * H, v);
  } else {
#pragma unroll
    for (int i = 0; i < 4 * H; ++i) v[i] = 0.f;
  }
}

// Per (frame, query): ld = (L log2 e or +inf, D) per head, and the tile's
// live word. One thread per query of npad (N rounded up to kRows) per
// frame, so a warp is one tile; rows past N get (+inf, 0).
template <int H>
__global__ void __launch_bounds__(kFlatThreads)
flash_bwd_prep_kernel(const float* __restrict__ out,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ ld,
                      unsigned* __restrict__ words, int n, int npad,
                      int total) {
  constexpr int kTok = Shape<H>::kTok;
  const int idx = blockIdx.x * kFlatThreads + threadIdx.x;
  if (idx >= total) return;  // whole warps: total is a multiple of 32
  const int batch = idx / npad, i = idx % npad;
  float D[H];
  bool nonzero = false;
#pragma unroll
  for (int h = 0; h < H; ++h) D[h] = 0.f;
  if (i < n) {
    const size_t r = ((size_t)batch * n + i) * kTok;
    float o[kTok], g[kTok];
    load(out + r, o);
    load(dout + r, g);
    // per head an FMA chain over d in order
#pragma unroll
    for (int c = 0; c < kTok; ++c) {
      D[c % H] = fmaf(g[c], o[c], D[c % H]);
      nonzero |= g[c] != 0.f;  // true for NaN
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
// (seg + i * segments) * kTile + jj is valid.
__device__ __forceinline__ void key_words(const unsigned char* mb, int m,
                                          int seg, int segments, int nt,
                                          unsigned* words) {
  for (int i = threadIdx.x; i < nt; i += kThreads) {
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
// acc[h][n-tile][4] in m16n8 layout (columns d = 2 g' + n-tile), times
// `mul`; zeros where `zero`. Lane (g, t) holds d = 4 t .. 4 t + 3 of both
// rows: channels 4 t H .. 4 t H + 4 H - 1.
template <int H>
__device__ __forceinline__ void write_rows(float* base, int row, int rows,
                                           int t, const float (&acc)[H][2][4],
                                           float mul, bool zero0,
                                           bool zero8) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= rows) continue;
    const bool zero = half ? zero8 : zero0;
    float v[4 * H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      // c0 / c2: column 2 t -> d = 4 t + n-tile; c1 / c3: d = 4 t + 2 +
      // n-tile
      v[0 * H + h] = acc[h][0][2 * half] * mul;
      v[1 * H + h] = acc[h][1][2 * half] * mul;
      v[2 * H + h] = acc[h][0][2 * half + 1] * mul;
      v[3 * H + h] = acc[h][1][2 * half + 1] * mul;
    }
    if (zero) {
#pragma unroll
      for (int e = 0; e < 4 * H; ++e) v[e] = 0.f;
    }
    store(base + (size_t)r * Shape<H>::kTok + 4 * t * H, v);
  }
}

// grid (ceil(N / kRows), segments, B). With one segment the block writes
// dq (times scale); with more, its partial sum goes to
// dq_out[(batch * segments + seg) * N ...].
template <int H>
__global__ void __launch_bounds__(kThreads, Shape<H>::kMinBlocks)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const unsigned char* __restrict__ kv_valid,
                    const float* __restrict__ dout,
                    const float* __restrict__ ld,
                    const unsigned* __restrict__ qwords,
                    float* __restrict__ dq_out, int n, int m, int npad,
                    int segments, float scale_log2e, float mul) {
  constexpr int kTok = Shape<H>::kTok, kStride = Shape<H>::kStride;
  constexpr int kVec = Shape<H>::kVec;
  __shared__ __align__(16) float ks[2][kTile][kStride];
  __shared__ __align__(16) float vs[2][kTile][kStride];
  __shared__ unsigned words[kMaxSegTiles];

  const int batch = blockIdx.z, seg = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int i0 = blockIdx.x * kRows;
  const int r0 = i0 + warp * 16;  // the warp's rows r0 + g, r0 + g + 8
  float* ob = dq_out + ((size_t)batch * segments + seg) * n * kTok;
  const unsigned* qw = qwords + (size_t)batch * (npad / kTile) + i0 / kTile;
  unsigned any = 0u;
#pragma unroll
  for (int w = 0; w < kRows / kTile; ++w) any |= qw[w];
  // the warp's 16 rows are half of a 32-row word
  const unsigned mine = (qw[warp / 2] >> (16 * (warp & 1))) & 0xffffu;

  float acc[H][2][4];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][nt][e] = 0.f;

  if (any == 0u) {  // no live query: dq = 0 (uniform)
    write_rows<H>(ob, r0 + g, n, t, acc, 0.f, false, false);
    return;
  }

  const float* kb = k + (size_t)batch * m * kTok;
  const float* vb = v + (size_t)batch * m * kTok;
  const int tiles = (m + kTile - 1) / kTile;
  const int nt = seg < tiles ? (tiles - seg + segments - 1) / segments : 0;
  key_words(kv_valid + (size_t)batch * m, m, seg, segments, nt, words);

  // the warp's own rows: q and dout as A fragments, (L log2 e, D)
  FragA qf[H][2], df[H][2];
  float Lr[2][H], Dr[2][H];
  {
    float a[4 * H], a8[4 * H];
    const float* qb = q + (size_t)batch * n * kTok;
    const float* db = dout + (size_t)batch * n * kTok;
    token_quad<H>(qb, r0 + g, n, t, a);
    token_quad<H>(qb, r0 + g + 8, n, t, a8);
#pragma unroll
    for (int h = 0; h < H; ++h) frag_rows<H>(a, a8, h, qf[h]);
    token_quad<H>(db, r0 + g, n, t, a);
    token_quad<H>(db, r0 + g + 8, n, t, a8);
#pragma unroll
    for (int h = 0; h < H; ++h) frag_rows<H>(a, a8, h, df[h]);
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
      // s and dout . v: B fragments from key row c0 + g, d = 4 t ..
      float kr[4 * H], vr[4 * H];
      load(&ks[buf][c0 + g][4 * t * H], kr);
      load(&vs[buf][c0 + g][4 * t * H], vr);
      // the dq update's B fragments: keys c0 + 2 t and c0 + 2 t + 1,
      // d = 2 g + n-tile
      float ka[2 * H], kb2[2 * H];
      load(&ks[buf][c0 + 2 * t][2 * g * H], ka);
      load(&ks[buf][c0 + 2 * t + 1][2 * g * H], kb2);
      const bool m0 = (cw >> (2 * t)) & 1u, m1 = (cw >> (2 * t + 1)) & 1u;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float s[4], dp[4];
        product(s, qf[h], FragB(kr[h], kr[H + h]),
                FragB(kr[2 * H + h], kr[3 * H + h]));
        product(dp, df[h], FragB(vr[h], vr[H + h]),
                FragB(vr[2 * H + h], vr[3 * H + h]));
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
        for (int n8 = 0; n8 < 2; ++n8)
          mma3(acc[h][n8], ds, FragB(ka[n8 * H + h], kb2[n8 * H + h]));
      }
    }
  });
  write_rows<H>(ob, r0 + g, n, t, acc, mul, false, false);
}

// grid (ceil(M / kRows), segments, B). With one segment the block writes
// dk (times scale) and dv; with more, its partial sums go to
// dk_out / dv_out[(batch * segments + seg) * M ...].
template <int H>
__global__ void __launch_bounds__(kThreads, Shape<H>::kMinBlocks)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ kv_valid,
                     const float* __restrict__ dout,
                     const float* __restrict__ ld,
                     const unsigned* __restrict__ qwords,
                     float* __restrict__ dk_out, float* __restrict__ dv_out,
                     int n, int m, int npad, int segments, float scale_log2e,
                     float mul) {
  constexpr int kTok = Shape<H>::kTok, kStride = Shape<H>::kStride;
  constexpr int kVec = Shape<H>::kVec;
  __shared__ __align__(16) float qs[2][kTile][kStride];
  __shared__ __align__(16) float dos[2][kTile][kStride];
  __shared__ __align__(16) float lds[2][kTile][2 * H];
  __shared__ unsigned words[kMaxSegTiles];

  const int batch = blockIdx.z, seg = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int j0 = blockIdx.x * kRows;
  const int r0 = j0 + warp * 16;  // the warp's keys r0 + g, r0 + g + 8
  const unsigned char* mb = kv_valid + (size_t)batch * m;
  const bool v0 = r0 + g < m && mb[r0 + g];
  const bool v8 = r0 + g + 8 < m && mb[r0 + g + 8];
  const size_t orow = ((size_t)batch * segments + seg) * m * kTok;

  float dka[H][2][4], dva[H][2][4];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[h][nt][e] = dva[h][nt][e] = 0.f;

  // every key of the block masked: dk = dv = 0 (uniform)
  if (!__syncthreads_or(v0 || v8)) {
    write_rows<H>(dk_out + orow, r0 + g, m, t, dka, 0.f, true, true);
    write_rows<H>(dv_out + orow, r0 + g, m, t, dva, 0.f, true, true);
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
  FragA kf[H][2], vf[H][2];
  {
    float a[4 * H], a8[4 * H];
    const float* kb = k + (size_t)batch * m * kTok;
    const float* vb = v + (size_t)batch * m * kTok;
    token_quad<H>(kb, r0 + g, m, t, a);
    token_quad<H>(kb, r0 + g + 8, m, t, a8);
#pragma unroll
    for (int h = 0; h < H; ++h) frag_rows<H>(a, a8, h, kf[h]);
    token_quad<H>(vb, r0 + g, m, t, a);
    token_quad<H>(vb, r0 + g + 8, m, t, a8);
#pragma unroll
    for (int h = 0; h < H; ++h) frag_rows<H>(a, a8, h, vf[h]);
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
      float qr[4 * H], dr[4 * H];
      load(&qs[buf][c0 + g][4 * t * H], qr);
      load(&dos[buf][c0 + g][4 * t * H], dr);
      // the updates' B fragments: queries c0 + 2 t and c0 + 2 t + 1,
      // d = 2 g + n-tile
      float qa[2 * H], qb2[2 * H], da[2 * H], db2[2 * H];
      load(&qs[buf][c0 + 2 * t][2 * g * H], qa);
      load(&qs[buf][c0 + 2 * t + 1][2 * g * H], qb2);
      load(&dos[buf][c0 + 2 * t][2 * g * H], da);
      load(&dos[buf][c0 + 2 * t + 1][2 * g * H], db2);
      // (L log2 e, D) per head of queries c0 + 2 t, c0 + 2 t + 1
      float la[2 * H], lc[2 * H];
      load(&lds[buf][c0 + 2 * t][0], la);
      load(&lds[buf][c0 + 2 * t + 1][0], lc);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float s[4], dp[4];
        product(s, kf[h], FragB(qr[h], qr[H + h]),
                FragB(qr[2 * H + h], qr[3 * H + h]));
        product(dp, vf[h], FragB(dr[h], dr[H + h]),
                FragB(dr[2 * H + h], dr[3 * H + h]));
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
        for (int n8 = 0; n8 < 2; ++n8) {
          mma3(dva[h][n8], pf, FragB(da[n8 * H + h], db2[n8 * H + h]));
          mma3(dka[h][n8], ds, FragB(qa[n8 * H + h], qb2[n8 * H + h]));
        }
      }
    }
  });
  // a masked key's row may hold anything (rows of a product are
  // independent): it is written as zeros
  write_rows<H>(dk_out + orow, r0 + g, m, t, dka, mul, !v0, !v8);
  write_rows<H>(dv_out + orow, r0 + g, m, t, dva, 1.f, !v0, !v8);
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

template <int H>
int launch(const float* q, const float* k, const float* v,
           const unsigned char* valid, const float* out, const float* dout,
           const float* lse, float* ld, unsigned* qwords, float* dq,
           float* dk, float* dv, float* part_q, float* part_k,
           float* part_v, int batch, int n, int m, int seg_q, int seg_kv,
           float scale, cudaStream_t stream) {
  constexpr int kTok = Shape<H>::kTok;
  const int npad = (n + kRows - 1) / kRows * kRows;
  const int ktiles = (m + kTile - 1) / kTile, qtiles = npad / kTile;
  if ((ktiles + seg_q - 1) / seg_q > kMaxSegTiles ||
      (qtiles + seg_kv - 1) / seg_kv > kMaxSegTiles ||
      (seg_q > 1 && part_q == nullptr) ||
      (seg_kv > 1 && (part_k == nullptr || part_v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float sl2e = scale * kLog2e;
  const int total = batch * npad;
  flash_bwd_prep_kernel<H>
      <<<(total + kFlatThreads - 1) / kFlatThreads, kFlatThreads, 0,
         stream>>>(out, dout, lse, ld, qwords, n, npad, total);
  dim3 gq((n + kRows - 1) / kRows, seg_q, batch);
  flash_bwd_dq_kernel<H><<<gq, kThreads, 0, stream>>>(
      q, k, v, valid, dout, ld, qwords, seg_q > 1 ? part_q : dq, n, m, npad,
      seg_q, sl2e, seg_q > 1 ? 1.f : scale);
  if (seg_q > 1) {
    const int e = merge(part_q, dq, batch, n, kTok, seg_q, scale, stream);
    if (e) return e;
  }
  dim3 gk((m + kRows - 1) / kRows, seg_kv, batch);
  flash_bwd_dkv_kernel<H><<<gk, kThreads, 0, stream>>>(
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

template <int H>
int tiles(int kernel, int* out) {
  out[0] = kRows;
  out[1] = kTile;
  out[2] = kMaxSegTiles;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3],
      kernel == 0 ? reinterpret_cast<const void*>(flash_bwd_dq_kernel<H>)
                  : reinterpret_cast<const void*>(flash_bwd_dkv_kernel<H>),
      kThreads, 0));
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

// The tiling of the dq (kernel 0) or dkv (kernel 1) kernel for `heads`,
// for the wrapper's planner: {rows per block, walked rows per tile, most
// tiles per segment, resident blocks per SM on this card}. Non-zero for
// a head count the kernels do not take.
extern "C" int flash_cross_attention_bwd_tiles(int heads, int kernel,
                                               int* out) {
  if (kernel != 0 && kernel != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (heads) {
    case 1: return tiles<1>(kernel, out);
    case 2: return tiles<2>(kernel, out);
    case 4: return tiles<4>(kernel, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, out, dout (B, n, dim, heads), k, v (B, m, dim, heads) f32, kv_valid
// (B, m) bytes, lse (B, n, heads) f32, contiguous, 16-byte aligned.
// Scratch: ld (B, npad, heads, 2) f32 and qwords (B, npad / 32) u32 with
// npad = n rounded up to the rows per block; with seg_q > 1, part_q (B, seg_q, n, dim *
// heads); with seg_kv > 1, part_k and part_v (B, seg_kv, m, dim * heads)
// f32.
extern "C" int flash_cross_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* kv_valid,
    const void* out, const void* dout, const void* lse, void* ld,
    void* qwords, void* dq, void* dk, void* dv, void* part_q, void* part_k,
    void* part_v, int batch, int n, int m, int dim, int heads, int seg_q,
    int seg_kv, float scale, void* stream) {
  if (dim != kDim || batch < 1 || n < 1 || m < 1 || seg_q < 1 || seg_kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const unsigned char* mv = static_cast<const unsigned char*>(kv_valid);
  unsigned* qw = static_cast<unsigned*>(qwords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (heads) {
    case 1:
      return launch<1>(f(q), f(k), f(v), mv, f(out), f(dout), f(lse), w(ld),
                       qw, w(dq), w(dk), w(dv), w(part_q), w(part_k),
                       w(part_v), batch, n, m, seg_q, seg_kv, scale, s);
    case 2:
      return launch<2>(f(q), f(k), f(v), mv, f(out), f(dout), f(lse), w(ld),
                       qw, w(dq), w(dk), w(dv), w(part_q), w(part_k),
                       w(part_v), batch, n, m, seg_q, seg_kv, scale, s);
    case 4:
      return launch<4>(f(q), f(k), f(v), mv, f(out), f(dout), f(lse), w(ld),
                       qw, w(dq), w(dk), w(dv), w(part_q), w(part_k),
                       w(part_v), batch, n, m, seg_q, seg_kv, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
