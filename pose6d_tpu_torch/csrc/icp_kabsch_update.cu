// One ICP update, f32: the distance-gated weighted Kabsch fit of a frame's
// source points onto their nearest target points, solved by Horn's
// quaternion method with a fixed-sweep Jacobi eigensolve, in one launch.
//
// Replaces no TPU kernel: the JAX package's update is plain XLA
// (pose6d_tpu/solvers/icp.py make_step, pose6d_tpu/solvers/kabsch.py
// kabsch_umeyama). The port ran it as ~70 small eager launches and one
// torch.linalg.eigh that waits on the host for its error check, 30 to 45
// times a batch: host-paced. For frame b, with w_i = src_valid_i &
// (dmin_i < gate_b) and d_i = tgt[j_i],
//
//   W = sum w_i, mu_s = sum w_i s_i / W, mu_d = sum w_i d_i / W,
//   H = sum w_i (s_i - mu_s)(d_i - mu_d)^T / W + 1e-12 I,
//
// then Horn's symmetric 4x4 matrix of H, the eigenvector of its largest
// eigenvalue by 8 cyclic Jacobi sweeps of 6 pivots (the JAX package's
// _jacobi_eig4_maxvec, pose6d_tpu/solvers/kabsch.py:27, with its
// |apq| < 1e-30 guards), q normalised, R(q) and t = mu_d - R mu_s. Where
// W < 3 the frame keeps its R and t and applied[b] is 0. H is centred in
// a second pass over the points: the one-pass form sum w s d^T - W mu_s
// mu_d^T cancels about two digits in f32 with points ~50 cm from the
// camera at a ~14 cm spread. The plain version (ops/kernels/icp.py)
// repeats this arithmetic; sums are taken in another order here, so the
// two agree to f32 rounding, not bit for bit.
//
// What bounds it on the H100: nothing of the card. ~33 bytes a source
// point (src 12, valid 1, j 4, dmin 4, the gathered target 12) and ~40
// operations: 4.3 MB, 1.3 us at B = 64, N = 2048. The cost was launches
// and a host wait; the design is one launch and no host read.
// What the design does about it:
// - One block per frame (any B, any N and M): its threads stride over
//   the source points, gather the target rows of the gated points only,
//   and reduce in a fixed order (warp shuffles, then the warps' partials
//   in order), so two launches give the same bits.
// - The second pass re-reads the same rows (from L1 / L2) for the centred
//   H; nothing is staged in shared memory, so N and M are unbounded.
// - One thread builds Horn's matrix and runs the Jacobi in scalar
//   registers (each pivot a template instance, every index a constant);
//   the block's other threads have finished.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSweeps = 8;

// x[k] summed over the block, in a fixed order; every thread gets the
// sums. scratch is reused: the trailing barrier guards it.
template <int K>
__device__ __forceinline__ void block_sum(float (&x)[K],
                                          float (*scratch)[K]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x[k] += __shfl_xor_sync(0xffffffffu, x[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp][k] = x[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = scratch[0][k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += scratch[w][k];
    x[k] = s;
  }
  __syncthreads();
}

// One Jacobi rotation annihilating a[p][q] of the symmetric a, accumulated
// into v's columns p and q, as the JAX package's sweep body.
template <int p, int q>
__device__ __forceinline__ void jacobi_pivot(float (&a)[4][4],
                                             float (&v)[4][4]) {
  const float app = a[p][p], aqq = a[q][q], apq = a[p][q];
  const bool tiny = fabsf(apq) < 1e-30f;
  const float tau = (aqq - app) / (2.0f * (tiny ? 1e-30f : apq));
  const float tsign = tau >= 0.0f ? 1.0f : -1.0f;
  float tval = tsign / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  if (tiny) tval = 0.0f;
  const float c = 1.0f / sqrtf(1.0f + tval * tval);
  const float s = tval * c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k == p || k == q) continue;
    const float akp = a[k][p], akq = a[k][q];
    const float nkp = c * akp - s * akq;
    const float nkq = s * akp + c * akq;
    a[k][p] = nkp;
    a[p][k] = nkp;
    a[k][q] = nkq;
    a[q][k] = nkq;
  }
  a[p][p] = c * c * app - 2.0f * c * s * apq + s * s * aqq;
  a[q][q] = s * s * app + 2.0f * c * s * apq + c * c * aqq;
  a[p][q] = 0.0f;
  a[q][p] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float vkp = v[k][p], vkq = v[k][q];
    v[k][p] = c * vkp - s * vkq;
    v[k][q] = s * vkp + c * vkq;
  }
}

// R (row-major 3x3) maximising trace(R^T H): Horn's matrix, Jacobi, the
// eigenvector of the largest diagonal entry (the first on a tie).
__device__ void rotation_from_h(const float (&h)[9], float (&r)[9]) {
  const float sxx = h[0], sxy = h[1], sxz = h[2];
  const float syx = h[3], syy = h[4], syz = h[5];
  const float szx = h[6], szy = h[7], szz = h[8];
  float a[4][4] = {
      {sxx + syy + szz, syz - szy, szx - sxz, sxy - syx},
      {syz - szy, sxx - syy - szz, sxy + syx, szx + sxz},
      {szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy},
      {sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz}};
  float v[4][4] = {{1.f, 0.f, 0.f, 0.f},
                   {0.f, 1.f, 0.f, 0.f},
                   {0.f, 0.f, 1.f, 0.f},
                   {0.f, 0.f, 0.f, 1.f}};
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    jacobi_pivot<0, 1>(a, v);
    jacobi_pivot<0, 2>(a, v);
    jacobi_pivot<0, 3>(a, v);
    jacobi_pivot<1, 2>(a, v);
    jacobi_pivot<1, 3>(a, v);
    jacobi_pivot<2, 3>(a, v);
  }
  float best = a[0][0], qv[4] = {v[0][0], v[1][0], v[2][0], v[3][0]};
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    if (a[c][c] > best) {
      best = a[c][c];
#pragma unroll
      for (int k = 0; k < 4; ++k) qv[k] = v[k][c];
    }
  }
  const float norm = fmaxf(
      sqrtf(qv[0] * qv[0] + qv[1] * qv[1] + qv[2] * qv[2] + qv[3] * qv[3]),
      1e-12f);
  const float w = qv[0] / norm, x = qv[1] / norm, y = qv[2] / norm,
              z = qv[3] / norm;
  r[0] = 1.0f - 2.0f * (y * y + z * z);
  r[1] = 2.0f * (x * y - w * z);
  r[2] = 2.0f * (x * z + w * y);
  r[3] = 2.0f * (x * y + w * z);
  r[4] = 1.0f - 2.0f * (x * x + z * z);
  r[5] = 2.0f * (y * z - w * x);
  r[6] = 2.0f * (x * z - w * y);
  r[7] = 2.0f * (y * z + w * x);
  r[8] = 1.0f - 2.0f * (x * x + y * y);
}

// grid (B,), kThreads threads.
__global__ void __launch_bounds__(kThreads)
icp_kabsch_update_kernel(const float* __restrict__ src,
                         const bool* __restrict__ src_valid,
                         const float* __restrict__ tgt,
                         const int* __restrict__ jidx,
                         const float* __restrict__ dmin,
                         const float* __restrict__ gate,
                         const float* __restrict__ r_in,
                         const float* __restrict__ t_in,
                         float* __restrict__ r_out, float* __restrict__ t_out,
                         unsigned char* __restrict__ applied, int n, int m) {
  __shared__ float scratch7[kWarps][7];
  __shared__ float scratch9[kWarps][9];
  const int b = blockIdx.x;
  const float* sb = src + (size_t)b * n * 3;
  const float* tb = tgt + (size_t)b * m * 3;
  const bool* vb = src_valid + (size_t)b * n;
  const int* jb = jidx + (size_t)b * n;
  const float* db = dmin + (size_t)b * n;
  const float g = gate[b];

  // pass 1: W, sum w s, sum w d
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (vb[i] && db[i] < g) {
      const float* s = sb + (size_t)i * 3;
      const float* d = tb + (size_t)jb[i] * 3;
      acc[0] += 1.0f;
      acc[1] += s[0];
      acc[2] += s[1];
      acc[3] += s[2];
      acc[4] += d[0];
      acc[5] += d[1];
      acc[6] += d[2];
    }
  }
  block_sum(acc, scratch7);
  const float wsum = acc[0];
  if (wsum < 3.0f) {  // uniform across the block
    if (threadIdx.x < 9) r_out[(size_t)b * 9 + threadIdx.x] =
        r_in[(size_t)b * 9 + threadIdx.x];
    if (threadIdx.x < 3) t_out[(size_t)b * 3 + threadIdx.x] =
        t_in[(size_t)b * 3 + threadIdx.x];
    if (threadIdx.x == 0) applied[b] = 0;
    return;
  }
  const float mus[3] = {acc[1] / wsum, acc[2] / wsum, acc[3] / wsum};
  const float mud[3] = {acc[4] / wsum, acc[5] / wsum, acc[6] / wsum};

  // pass 2: the centred cross-covariance
  float hs[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (vb[i] && db[i] < g) {
      const float* s = sb + (size_t)i * 3;
      const float* d = tb + (size_t)jb[i] * 3;
      const float es[3] = {s[0] - mus[0], s[1] - mus[1], s[2] - mus[2]};
      const float ed[3] = {d[0] - mud[0], d[1] - mud[1], d[2] - mud[2]};
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) hs[3 * r + c] += es[r] * ed[c];
      }
    }
  }
  block_sum(hs, scratch9);
  if (threadIdx.x != 0) return;
  float h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = hs[k] / wsum;
  h[0] += 1e-12f;
  h[4] += 1e-12f;
  h[8] += 1e-12f;
  float r[9];
  rotation_from_h(h, r);
#pragma unroll
  for (int k = 0; k < 9; ++k) r_out[(size_t)b * 9 + k] = r[k];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t_out[(size_t)b * 3 + i] =
        mud[i] - (r[3 * i] * mus[0] + r[3 * i + 1] * mus[1] +
                  r[3 * i + 2] * mus[2]);
  applied[b] = 1;
}

}  // namespace

// src (B, n, 3) f32, src_valid (B, n) bool, tgt (B, m, 3) f32, j (B, n)
// int32 in [0, m), dmin (B, n) f32, gate (B,) f32 (squared), r_in (B, 3,
// 3), t_in (B, 3) f32, all contiguous; writes r_out (B, 3, 3), t_out (B,
// 3) f32 and applied (B,) uint8 whole.
extern "C" int icp_kabsch_update_f32(const void* src, const void* src_valid,
                                     const void* tgt, const void* j,
                                     const void* dmin, const void* gate,
                                     const void* r_in, const void* t_in,
                                     void* r_out, void* t_out, void* applied,
                                     int batch, int n, int m, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || n >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  icp_kabsch_update_kernel<<<batch, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const bool*>(src_valid),
      static_cast<const float*>(tgt), static_cast<const int*>(j),
      static_cast<const float*>(dmin), static_cast<const float*>(gate),
      static_cast<const float*>(r_in), static_cast<const float*>(t_in),
      static_cast<float*>(r_out), static_cast<float*>(t_out),
      static_cast<unsigned char*>(applied), n, m);
  return static_cast<int>(cudaGetLastError());
}
