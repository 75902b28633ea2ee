// 3xTF32 tensor-core products with f32 results: mma.sync.m16n8k8 TF32
// with each f32 operand split into a TF32 high part and the rest (a =
// a_hi + a_lo; a_lo b_hi + a_hi b_lo + a_hi b_hi), which keeps a product
// near f32 where one TF32 product (~1e-3 relative) would not. Used by
// flash_cross_attention.cu (the forward at DIM 64 and 128) and
// flash_cross_attention_bwd.cu.
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8,
// row) a0 (row g, k-slot t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); B (8 x 8, col) b0 (k-slot t, column g), b1 (t + 4, g); the
// accumulator c0 (row g, column 2 t), c1 (g, 2 t + 1), c2 (g + 8, 2 t),
// c3 (g + 8, 2 t + 1).
#pragma once

#include <cuda_runtime.h>

namespace mma_tf32 {

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

}  // namespace mma_tf32
