// Shared by the grid encoder's kernels (grid_kernels.cu: forward and table
// gradient; grid_bwd_x_kernels.cu: the gradient in the points): the
// parameter block, the position, weight and corner-row arithmetic and the
// vector loads of table rows, so every kernel reads the rows the others do.
// Each source includes it into its own anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kMaxDims = 4;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 64;
constexpr int kFwdThreads = 128;  // points per forward block

struct GridParams {
  const float* x;  // [B, D]
  long long B;
  int L;
  float scale[kMaxLevels];
  int offset[kMaxLevels];          // first table row of the level
  uint32_t size[kMaxLevels];       // table rows of the level
  uint32_t mask[kMaxLevels];       // size - 1 where size is a power of two, else 0
  uint32_t stride[kMaxLevels][kMaxDims];  // dense strides; 0 for dims past the ones that fit
  int hashed[kMaxLevels];
  float shift;  // 0.5, or 0 with align_corners
  int smoothstep;
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

template <int D> __device__ __forceinline__ bool in_box(const float* q) {
  bool in = true;
#pragma unroll
  for (int d = 0; d < D; ++d) in = in && !(q[d] < 0.f || q[d] > 1.f);
  return in;
}

// lower corner i0 and interpolation fractions of point q at level l; with
// dfrac, each fraction's derivative in its position too: 1, or smoothstep's
// 6 f (1 - f) as autograd expands f * f * (3 - 2 f)
template <int D>
__device__ __forceinline__ void level_pos(const GridParams& p, int l, const float* q,
                                          uint32_t* i0, float* frac, float* dfrac = nullptr) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pos = __fadd_rn(__fmul_rn(q[d], p.scale[l]), p.shift);
    const float pf = floorf(pos);
    const float f = __fsub_rn(pos, pf);
    i0[d] = (uint32_t)(int)pf;
    if (p.smoothstep) {
      const float t = __fsub_rn(3.f, __fmul_rn(2.f, f));
      frac[d] = __fmul_rn(__fmul_rn(f, f), t);
      if (dfrac) {
        dfrac[d] = __fsub_rn(__fadd_rn(__fmul_rn(t, f), __fmul_rn(t, f)),
                             __fmul_rn(2.f, __fmul_rn(f, f)));
      }
    } else {
      frac[d] = f;
      if (dfrac) dfrac[d] = 1.f;
    }
  }
}

// d-linear weight of corner k (bit d of k: the upper corner along axis d),
// multiplied in axis order
template <int D> __device__ __forceinline__ float corner_weight(const float* frac, int k) {
  float w = (k & 1) ? frac[0] : __fsub_rn(1.f, frac[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) {
    w = __fmul_rn(w, (k >> d & 1) ? frac[d] : __fsub_rn(1.f, frac[d]));
  }
  return w;
}

// flat table row of corner k of the cell at i0, level l
template <int D>
__device__ __forceinline__ uint32_t corner_row(const GridParams& p, int l, const uint32_t* i0,
                                               int k) {
  const uint32_t primes[kMaxDims] = {1u, 2654435761u, 805459861u, 3674653429u};
  uint32_t idx = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const uint32_t c = i0[d] + (uint32_t)((k >> d) & 1);
    idx = p.hashed[l] ? (idx ^ (c * primes[d])) : (idx + c * p.stride[l][d]);
  }
  const uint32_t m = p.mask[l];
  return (uint32_t)p.offset[l] + (m != 0u ? idx & m : idx % p.size[l]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int B> struct Word;  // an aligned load of B bytes
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// N consecutive values of TT at src, aligned to N * sizeof(TT), as f32 by
// vector loads of up to 16 bytes
template <typename TT, int N>
__device__ __forceinline__ void load_vals(const TT* src, float* v) {
  constexpr int kBytes = N * (int)sizeof(TT);
  constexpr int kWord = kBytes < 16 ? kBytes : 16;
  using W = typename Word<kWord>::T;
  union {
    W w[kBytes / kWord];
    TT e[N];
  } u;
#pragma unroll
  for (int i = 0; i < kBytes / kWord; ++i) u.w[i] = __ldg(reinterpret_cast<const W*>(src) + i);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = to_f32(u.e[i]);
}

// strides: D per level, level-major
int fill_params(GridParams* p, const float* x, long long B, int D, int L, const float* scales,
                const int* offsets, const unsigned* sizes, const unsigned* strides,
                const int* hashed, float shift, int smoothstep) {
  if (L < 1 || L > kMaxLevels || D < 2 || D > kMaxDims) return (int)cudaErrorInvalidValue;
  p->x = x;
  p->B = B;
  p->L = L;
  for (int l = 0; l < L; ++l) {
    p->scale[l] = scales[l];
    p->offset[l] = offsets[l];
    p->size[l] = sizes[l];
    p->mask[l] = sizes[l] != 0u && (sizes[l] & (sizes[l] - 1u)) == 0u ? sizes[l] - 1u : 0u;
    for (int d = 0; d < kMaxDims; ++d) p->stride[l][d] = d < D ? strides[D * l + d] : 0u;
    p->hashed[l] = hashed[l];
  }
  p->shift = shift;
  p->smoothstep = smoothstep;
  return (int)cudaSuccess;
}

}  // namespace
