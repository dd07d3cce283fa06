// The tensor-core tile code the bf16 kernels share (cp_kernels.cu's heads,
// mlp_kernels.cu's chain): mma.sync m16n8k16, bf16 -> f32, and the fragment
// order of a B operand in shared memory.
//
// Fragments of one warp, lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = row g, columns 2t, 2t+1; a1 = row g + 8, the
//     same columns; a2, a3 = the same rows, columns 2t + 8, 2t + 9;
//   B (16 x 8, column-major): b0 = rows 2t, 2t+1 of column g; b1 = rows
//     2t + 8, 2t + 9;
//   C / D (16 x 8, f32): c0, c1 = row g, columns 2t, 2t+1; c2, c3 = row g + 8.
// So the accumulators of n-tiles 2j and 2j + 1 of one product, each pair
// packed into one bf16x2 register, are the A fragment of k-step j of a
// product that takes them as its input: a chain of layers keeps its
// activations in registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Element (k, n) of a [K, N] B operand in fragment order: per (k-step of 16,
// n-tile of 8) 32 lanes x {b0, b1}, b0 = rows 2t, 2t+1 and b1 = rows 2t+8,
// 2t+9 of column g, for lane = 4 g + t.
__device__ __forceinline__ int frag_slot(int k, int n, int n_tiles) {
  const int kk = k & 15;
  const int lane = (n & 7) * 4 + ((kk & 7) >> 1);
  return ((((k >> 4) * n_tiles + (n >> 3)) * 32 + lane) << 2) + ((kk >> 3) << 1) + (kk & 1);
}

// two f32 values rounded to bf16 (nearest even) and packed, the lower column
// in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
