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
// What bounds it on the H100: operations. At the main-path shapes one
// call is 5120 x 2048 keys x 2 heads x (16 + 16) FMAs plus one exp per
// score (~1.4 GFLOP) against ~1 MB of q, k, v and out; a plain
// implementation writes and re-reads the (H, N, M) score tensor
// (84 MB per frame). The kernel keeps the scores out of memory: one
// thread owns one (query, head) row with q and the output accumulator
// in registers; K/V tiles of 32 keys x DIM are staged in shared memory
// (all lanes read the same entry: a broadcast), and the online softmax
// rescales the accumulator once per tile. Grid: (query tile, head,
// frame). f32 FMAs throughout; wgmma and TMA are left for later work.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // queries per block
constexpr int kTK = 32;        // keys per staged tile

template <int DIM>
__global__ void __launch_bounds__(kThreads)
flash_cross_attention_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const unsigned char* __restrict__ kv_valid,
                             float* __restrict__ out,
                             float* __restrict__ lse, int n, int m, int heads,
                             float scale) {
  __shared__ float ks[kTK][DIM];
  __shared__ float vs[kTK][DIM];
  __shared__ unsigned char valid_s[kTK];

  const int h = blockIdx.y;
  const int batch = blockIdx.z;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)DIM * heads;  // one token's channels
  const float* qb = q + (size_t)batch * n * stride;
  const float* kb = k + (size_t)batch * m * stride;
  const float* vb = v + (size_t)batch * m * stride;
  const unsigned char* mb = kv_valid + (size_t)batch * m;

  float qr[DIM], acc[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    qr[d] = (row < n) ? qb[(size_t)row * stride + (size_t)d * heads + h]
                      : 0.f;
    acc[d] = 0.f;
  }
  float run_max = -INFINITY;
  float run_sum = 0.f;

  for (int j0 = 0; j0 < m; j0 += kTK) {
    __syncthreads();
    for (int t = threadIdx.x; t < kTK * DIM; t += kThreads) {
      const int jj = t / DIM, d = t % DIM, j = j0 + jj;
      const size_t off = (size_t)j * stride + (size_t)d * heads + h;
      ks[jj][d] = (j < m) ? kb[off] : 0.f;
      vs[jj][d] = (j < m) ? vb[off] : 0.f;
    }
    for (int t = threadIdx.x; t < kTK; t += kThreads) {
      const int j = j0 + t;
      valid_s[t] = (j < m) ? mb[j] : 0;
    }
    __syncthreads();

    float s[kTK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kTK; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) dot = fmaf(qr[d], ks[jj][d], dot);
      s[jj] = valid_s[jj] ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    if (tile_max == -INFINITY) continue;  // no valid key in this tile
    const float new_max = fmaxf(run_max, tile_max);
    const float corr = expf(run_max - new_max);  // 0 on the first tile
    run_sum *= corr;
#pragma unroll
    for (int d = 0; d < DIM; ++d) acc[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < kTK; ++jj) {
      const float p = expf(s[jj] - new_max);  // 0 for masked keys
      run_sum += p;
#pragma unroll
      for (int d = 0; d < DIM; ++d) acc[d] = fmaf(p, vs[jj][d], acc[d]);
    }
    run_max = new_max;
  }
  if (row < n) {
    const float inv = (run_sum > 0.f) ? 1.f / run_sum : 0.f;
    float* ob = out + (size_t)batch * n * stride;
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      ob[(size_t)row * stride + (size_t)d * heads + h] = acc[d] * inv;
    if (lse != nullptr)
      lse[((size_t)batch * n + row) * heads + h] =
          (run_sum > 0.f) ? run_max + logf(run_sum) : -INFINITY;
  }
}

template <int DIM>
void launch(const float* q, const float* k, const float* v,
            const unsigned char* valid, float* out, float* lse, int batch,
            int n, int m, int heads, float scale, cudaStream_t stream) {
  dim3 grid((n + kThreads - 1) / kThreads, heads, batch);
  flash_cross_attention_kernel<DIM><<<grid, kThreads, 0, stream>>>(
      q, k, v, valid, out, lse, n, m, heads, scale);
}

}  // namespace

extern "C" int flash_cross_attention_f32(const void* q, const void* k,
                                         const void* v, const void* kv_valid,
                                         void* out, void* lse, int batch,
                                         int n, int m, int dim, int heads,
                                         float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const unsigned char* mf = static_cast<const unsigned char*>(kv_valid);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);  // may be null (no lse wanted)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim != 16) return static_cast<int>(cudaErrorInvalidValue);
  launch<16>(qf, kf, vf, mf, of, lf, batch, n, m, heads, scale, s);
  return static_cast<int>(cudaGetLastError());
}
