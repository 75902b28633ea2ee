// RANSAC's hypothesis scoring, f32: the inlier count of every hypothesis
// of a block, per frame.
//
// Replaces no TPU kernel: the JAX package scores its hypotheses in plain
// XLA (pose6d_tpu/solvers/ransac.py), and the port's plain version
// (ops/kernels/ransac.py) builds the same (B, H, N) residual planes in
// eager PyTorch: ~58 passes over 1.3 GB planes a block at the batch
// path's B = 64, H = 512, N = 10240, the largest share of a batch. For
// hypothesis h = (R, t) of frame b and pair j = (s, d),
//
//   counts[b, h] = #{ j : vmask[b, j] != 0 and d2(h, j) < thr2[b] }
//   d2 = ((e0^2 + e1^2) + e2^2),  e_i = p_i - d_i,
//   p_i = ((R_i0 s_0 + R_i1 s_1) + R_i2 s_2) + t_i,
//
// each operation rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn
// are never contracted to an FMA): the plain version's order, so the
// counts equal its counts bit for bit (0 + e0^2 = e0^2 there). Rows of a
// frame whose active[b] is false are 0. vmask holds 0 or 1.
//
// What bounds it on the H100: instruction issue. A (hypothesis, pair) is
// 24 multiplies and adds for d2, the compare and the count, and two
// broadcast shared-memory loads: ~32 instructions, against 28 bytes of
// pair data read once per block of hypotheses. The bytes are nothing; the
// planes are gone.
// What the design does about it:
// - A thread owns one hypothesis: its R and t in 12 registers, its count
//   in an int register. A block serves kHyp hypotheses of one frame.
// - The frame's pairs stream through shared memory in tiles of kTile
//   pairs, as float4 (s, mask) and (d, 0), copied 4 bytes at a time with
//   cp.async (any N, any alignment) into two buffers: the next tile lands
//   while the block scores this one. Every thread reads the same pair:
//   broadcast loads.
// - A block whose frame has exited returns after one read of active[b];
//   a tile without a valid pair is skipped (the caller puts the valid
//   pairs first, so the invalid tail costs one vote a tile).
// - When B x ceil(H / kHyp) blocks would not give every SM two, the
//   wrapper splits the pair walk into S interleaved segments (grid.y;
//   ops/kernels/_build.py plan_segments: S = 40 at B = 1, H = 512, N =
//   10240). Each segment adds its partial count to the zeroed output
//   with a float atomicAdd: every partial and every sum is an integer
//   below 2^24 (the wrapper refuses N >= 2^24), so each addition is
//   exact and their order does not change the bits.
//
// C interface (ctypes): returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kHyp = 128;    // hypotheses (threads) per block
constexpr int kTile = 256;   // pairs per staged tile
constexpr int kPairFloats = 8;  // (s, mask), (d, unused)

// one axis's squared residual, in the plain version's order
__device__ __forceinline__ float axis_sq(float r0, float r1, float r2,
                                         float t, float4 s, float d) {
  const float p = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r0, s.x), __fmul_rn(r1, s.y)),
                __fmul_rn(r2, s.z)),
      t);
  const float e = __fsub_rn(p, d);
  return __fmul_rn(e, e);
}

// grid (ceil(H / kHyp), segments, B); counts zeroed before the launch.
__global__ void __launch_bounds__(kHyp)
ransac_inlier_counts_kernel(const float* __restrict__ rs,
                            const float* __restrict__ ts,
                            const float* __restrict__ src,
                            const float* __restrict__ dst,
                            const float* __restrict__ vmask,
                            const float* __restrict__ thr2,
                            const bool* __restrict__ active,
                            float* __restrict__ counts, int h, int n,
                            int segments) {
  const int b = blockIdx.z, seg = blockIdx.y;
  if (!active[b]) return;  // uniform across the block
  __shared__ __align__(16) float4 tile[2][kTile][2];

  const int hyp = blockIdx.x * kHyp + threadIdx.x;
  const bool own = hyp < h;
  const size_t row = (size_t)b * h + (own ? hyp : 0);
  float r[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = rs[row * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = ts[row * 3 + i];
  const float th = thr2[b];
  const float* sb = src + (size_t)b * n * 3;
  const float* db = dst + (size_t)b * n * 3;
  const float* mb = vmask + (size_t)b * n;
  const int tiles = (n + kTile - 1) / kTile;

  // src and dst floats e of the tile go to pair e / 3, component e % 3;
  // a pair past the end lands as zeros (mask 0: not counted)
  auto stage = [&](int tt, int buf) {
    const int j0 = tt * kTile, len = min(kTile, n - j0);
    float* base = reinterpret_cast<float*>(&tile[buf][0][0]);
    for (int e = threadIdx.x; e < 7 * kTile; e += kHyp) {
      if (e < 6 * kTile) {
        const int side = e / (3 * kTile), f = e - side * 3 * kTile;
        const int j = f / 3, c = f - 3 * j;
        const float* g = side ? db : sb;
        async_copy::copy4(base + j * kPairFloats + 4 * side + c,
                          j < len ? g + (size_t)j0 * 3 + f : g, j < len);
      } else {
        const int j = e - 6 * kTile;
        async_copy::copy4(base + j * kPairFloats + 3,
                          j < len ? mb + j0 + j : mb, j < len);
      }
    }
  };

  int cnt = 0, buf = 0;
  if (seg < tiles) stage(seg, 0);
  async_copy::commit();
  for (int tt = seg; tt < tiles; tt += segments) {
    if (tt + segments < tiles) stage(tt + segments, buf ^ 1);
    async_copy::commit();
    async_copy::wait<1>();
    __syncthreads();
    bool live = false;
    for (int j = threadIdx.x; j < kTile; j += kHyp)
      live |= tile[buf][j][0].w != 0.f;
    if (__syncthreads_or(live)) {
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        const float4 s = tile[buf][j][0], d = tile[buf][j][1];
        const float q = __fadd_rn(
            __fadd_rn(axis_sq(r[0], r[1], r[2], t[0], s, d.x),
                      axis_sq(r[3], r[4], r[5], t[1], s, d.y)),
            axis_sq(r[6], r[7], r[8], t[2], s, d.z));
        cnt += (q < th) & (s.w != 0.f);
      }
    }
    __syncthreads();  // the buffer is refilled next iteration
    buf ^= 1;
  }
  if (own && cnt) atomicAdd(&counts[row], static_cast<float>(cnt));
}

}  // namespace

// The kernel's tiling, for the wrapper's planner: {hypotheses per block,
// pairs per tile, resident blocks per SM on this card}.
extern "C" int ransac_inlier_counts_tiles(int* out) {
  out[0] = kHyp;
  out[1] = kTile;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], ransac_inlier_counts_kernel, kHyp, 0));
}

// rs (B, h, 3, 3), ts (B, h, 3), src, dst (B, n, 3), vmask (B, n), thr2
// (B,) f32 and active (B,) bool, contiguous; counts (B, h) f32, written
// whole (zeroed here, then the segments' counts added).
extern "C" int ransac_inlier_counts_f32(const void* rs, const void* ts,
                                        const void* src, const void* dst,
                                        const void* vmask, const void* thr2,
                                        const void* active, void* counts,
                                        int batch, int h, int n, int segments,
                                        void* stream) {
  if (batch < 1 || h < 1 || n < 1 || n >= (1 << 24) || segments < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed =
      cudaMemsetAsync(counts, 0, sizeof(float) * (size_t)batch * h, s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  dim3 grid((h + kHyp - 1) / kHyp, segments, batch);
  ransac_inlier_counts_kernel<<<grid, kHyp, 0, s>>>(
      static_cast<const float*>(rs), static_cast<const float*>(ts),
      static_cast<const float*>(src), static_cast<const float*>(dst),
      static_cast<const float*>(vmask), static_cast<const float*>(thr2),
      static_cast<const bool*>(active), static_cast<float*>(counts), h, n,
      segments);
  return static_cast<int>(cudaGetLastError());
}
