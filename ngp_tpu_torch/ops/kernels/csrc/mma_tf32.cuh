// The tensor-core tile code of the f32 heads (cp_kernels.cu): mma.sync
// m16n8k8 with TF32 inputs and f32 accumulators, run three times per product
// on each value's split into a TF32 high part and a TF32 low part (3xTF32):
// a b = a_hi b_hi + a_hi b_lo + a_lo b_hi + a_lo b_lo, and the last term,
// which is left out, is within 2^-22 of |a b|, so the sums keep f32's
// accuracy where one TF32 product keeps about three digits.
//
// Fragments of one warp, lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 = (row g, column t), a1 = (g + 8, t),
//     a2 = (g, t + 4), a3 = (g + 8, t + 4);
//   B (8 x 8, column-major): b0 = (row t, column g), b1 = (t + 4, g);
//   C / D (16 x 8, f32): c0, c1 = row g, columns 2t, 2t+1; c2, c3 = row
//     g + 8, as in mma_bf16.cuh's m16n8k16.
// A split B operand sits in shared memory in fragment order: per (k-step of
// 8, n-tile of 8) 32 lanes x {b0 hi, b1 hi, b0 lo, b1 lo}, one 16-byte load
// a lane (cp_kernels.cu: x3_b_load, x3_b_split).

#pragma once

#include <stdint.h>

namespace {

// x rounded to TF32 (nearest, ties away from zero), as the bits of an f32
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to within 2^-22 |x|: hi is x rounded to TF32, lo the rest
// (x - hi, exact in f32) rounded to TF32
struct Tf32Split {
  float hi, lo;
};

__device__ __forceinline__ Tf32Split split_tf32(float x) {
  const float hi = __uint_as_float(to_tf32(x));
  return {hi, __uint_as_float(to_tf32(x - hi))};
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 for a split A fragment (hi, lo) and a split B fragment
// {b0 hi, b1 hi, b0 lo, b1 lo}: the two small cross terms first, then the
// large one, into a fresh accumulator that the CUDA cores add to d, rounded
// to nearest. The tensor cores' adds do not round to nearest: with the
// running sum carried through them over K, the f32 train step on the card
// missed its gradient bound (tests/test_torch_cuda_kernels.py::
// test_train_step_on_the_card_matches_cpu); here they add only one k-step's
// 8 products.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float4 b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(t, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(t, ah, __float_as_uint(b.x), __float_as_uint(b.y));
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// the A fragment of 16 f32 rows at a_lo (row g) and a_hi (row g + 8), each
// at its column t, split as it is read
__device__ __forceinline__ void split_a(const float* a_lo, const float* a_hi, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float v[4] = {a_lo[0], a_hi[0], a_lo[4], a_hi[4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32Split s = split_tf32(v[i]);
    ah[i] = __float_as_uint(s.hi);
    al[i] = __float_as_uint(s.lo);
  }
}

}  // namespace
