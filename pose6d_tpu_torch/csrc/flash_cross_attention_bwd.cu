// Masked multi-head cross-attention backward (dq, dk, dv), f32.
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
// Two kernels on one stream, in order:
//   dq kernel : one thread per (query, head), K/V tiles of 32 keys in
//               shared memory; it also writes D for the second kernel.
//   dkv kernel: one thread per (key, head), Q / dout / L / D tiles of
//               64 queries in shared memory.
// Each thread sums its own row in a fixed order: no atomics, so the
// result is deterministic. A masked key gets dk = dv = 0 exactly (its
// thread skips every query); a query with no valid key (L = -inf)
// contributes nothing and gets dq = 0 (never exp(+inf)). Padded query
// rows arrive with dout = 0 and so contribute 0.
//
// What bounds it on the H100: operations. At the main path's shapes a
// direction is 5120 x 2048 (query, key) pairs x 2 heads, each ~4 x 16
// FMAs per kernel plus an exp, against ~2 MB of inputs and outputs per
// frame. f32 FMAs on the CUDA cores; wgmma and TMA are left for later
// work.
//
// C interface (ctypes): returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // rows (queries or keys) per block
constexpr int kTK = 32;        // keys per staged tile (dq kernel)
constexpr int kTQ = 64;        // queries per staged tile (dkv kernel)

template <int DIM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const unsigned char* __restrict__ kv_valid,
                    const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int n, int m, int heads,
                    float scale) {
  __shared__ float ks[kTK][DIM];
  __shared__ float vs[kTK][DIM];
  __shared__ unsigned char valid_s[kTK];

  const int h = blockIdx.y;
  const int batch = blockIdx.z;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)DIM * heads;
  const size_t qoff = (size_t)batch * n * stride;
  const float* kb = k + (size_t)batch * m * stride;
  const float* vb = v + (size_t)batch * m * stride;
  const unsigned char* mb = kv_valid + (size_t)batch * m;
  const size_t lidx = ((size_t)batch * n + row) * heads + h;

  float qr[DIM], dor[DIM], acc[DIM];
  float D = 0.f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const size_t off = qoff + (size_t)row * stride + (size_t)d * heads + h;
    qr[d] = (row < n) ? q[off] : 0.f;
    dor[d] = (row < n) ? dout[off] : 0.f;
    D = fmaf(dor[d], (row < n) ? out[off] : 0.f, D);
    acc[d] = 0.f;
  }
  const float L = (row < n) ? lse[lidx] : -INFINITY;
  if (row < n) delta[lidx] = D;
  const bool live = L != -INFINITY;  // false: no valid key, dq = 0

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
    if (!live) continue;
#pragma unroll 4
    for (int jj = 0; jj < kTK; ++jj) {
      if (!valid_s[jj]) continue;  // uniform across the block
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        s = fmaf(qr[d], ks[jj][d], s);
        dp = fmaf(dor[d], vs[jj][d], dp);
      }
      const float p = expf(s * scale - L);
      const float ds = p * (dp - D);
#pragma unroll
      for (int d = 0; d < DIM; ++d) acc[d] = fmaf(ds, ks[jj][d], acc[d]);
    }
  }
  if (row < n) {
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      dq[qoff + (size_t)row * stride + (size_t)d * heads + h] = acc[d] * scale;
  }
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ kv_valid,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int n, int m, int heads,
                     float scale) {
  __shared__ float qs[kTQ][DIM];
  __shared__ float dos[kTQ][DIM];
  __shared__ float ls[kTQ];
  __shared__ float dls[kTQ];

  const int h = blockIdx.y;
  const int batch = blockIdx.z;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)DIM * heads;
  const float* qb = q + (size_t)batch * n * stride;
  const float* dob = dout + (size_t)batch * n * stride;
  const size_t koff = (size_t)batch * m * stride;
  const float* lb = lse + (size_t)batch * n * heads;
  const float* db = delta + (size_t)batch * n * heads;
  const bool valid = col < m && kv_valid[(size_t)batch * m + col];

  float kr[DIM], vr[DIM], dkr[DIM], dvr[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const size_t off = koff + (size_t)col * stride + (size_t)d * heads + h;
    kr[d] = valid ? k[off] : 0.f;
    vr[d] = valid ? v[off] : 0.f;
    dkr[d] = 0.f;
    dvr[d] = 0.f;
  }

  for (int i0 = 0; i0 < n; i0 += kTQ) {
    __syncthreads();
    for (int t = threadIdx.x; t < kTQ * DIM; t += kThreads) {
      const int ii = t / DIM, d = t % DIM, i = i0 + ii;
      const size_t off = (size_t)i * stride + (size_t)d * heads + h;
      qs[ii][d] = (i < n) ? qb[off] : 0.f;
      dos[ii][d] = (i < n) ? dob[off] : 0.f;
    }
    for (int t = threadIdx.x; t < kTQ; t += kThreads) {
      const int i = i0 + t;
      ls[t] = (i < n) ? lb[(size_t)i * heads + h] : -INFINITY;
      dls[t] = (i < n) ? db[(size_t)i * heads + h] : 0.f;
    }
    __syncthreads();
    if (!valid) continue;  // masked key: dk = dv = 0 exactly
#pragma unroll 4
    for (int ii = 0; ii < kTQ; ++ii) {
      const float L = ls[ii];
      if (L == -INFINITY) continue;  // uniform across the block
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        s = fmaf(kr[d], qs[ii][d], s);
        dp = fmaf(vr[d], dos[ii][d], dp);
      }
      const float p = expf(s * scale - L);
      const float ds = p * (dp - dls[ii]);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        dvr[d] = fmaf(p, dos[ii][d], dvr[d]);
        dkr[d] = fmaf(ds, qs[ii][d], dkr[d]);
      }
    }
  }
  if (col < m) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const size_t off = koff + (size_t)col * stride + (size_t)d * heads + h;
      dk[off] = dkr[d] * scale;
      dv[off] = dvr[d];
    }
  }
}

template <int DIM>
void launch(const float* q, const float* k, const float* v,
            const unsigned char* valid, const float* out, const float* dout,
            const float* lse, float* delta, float* dq, float* dk, float* dv,
            int batch, int n, int m, int heads, float scale,
            cudaStream_t stream) {
  dim3 gq((n + kThreads - 1) / kThreads, heads, batch);
  flash_bwd_dq_kernel<DIM><<<gq, kThreads, 0, stream>>>(
      q, k, v, valid, out, dout, lse, delta, dq, n, m, heads, scale);
  dim3 gk((m + kThreads - 1) / kThreads, heads, batch);
  flash_bwd_dkv_kernel<DIM><<<gk, kThreads, 0, stream>>>(
      q, k, v, valid, dout, lse, delta, dk, dv, n, m, heads, scale);
}

}  // namespace

extern "C" int flash_cross_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* kv_valid,
    const void* out, const void* dout, const void* lse, void* delta,
    void* dq, void* dk, void* dv, int batch, int n, int m, int dim,
    int heads, float scale, void* stream) {
  if (dim != 16) return static_cast<int>(cudaErrorInvalidValue);
  launch<16>(static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v),
             static_cast<const unsigned char*>(kv_valid),
             static_cast<const float*>(out), static_cast<const float*>(dout),
             static_cast<const float*>(lse), static_cast<float*>(delta),
             static_cast<float*>(dq), static_cast<float*>(dk),
             static_cast<float*>(dv), batch, n, m, heads, scale,
             static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
