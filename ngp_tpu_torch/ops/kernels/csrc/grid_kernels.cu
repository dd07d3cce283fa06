// Multiresolution hash / tiled grid encoder for Hopper (sm_90a).
//
// The JAX package leaves this encoder to XLA (ngp_tpu/ops/hashgrid.py:
// grid_encode: a take of the table and an einsum with the d-linear weights per
// level, hashgrid.py:203-204); these kernels do that work by hand.
//
//   ngp_grid_encode_fwd       features [B, L*C] from points [B, 3] and the table
//   ngp_grid_encode_bwd_rows  the VJP of the take + einsum: for every (point,
//                             level, corner) the corner's flat table row and its
//                             cotangent row w * g; ngp_scatter_add_rows
//                             (scatter_kernels.cu) then adds the rows into the
//                             f32 table gradient
//
// One thread per (point, level), level fastest, so the threads of a warp
// write a point's output row (and, backward, its 8 * L corner rows) together.
// Per-level scale, row offset, row count, dense strides and the hashed flag
// sit in the kernel's parameter block. corner_row is the one device copy of
// the index arithmetic (gridencoder.cu:66-84 through hashgrid.py:125-158):
// row-major dense index over the dims whose stride fits the level, XOR of
// per-dim primes in wrapping uint32 when a hashed level overflows, then
// % rows; both kernels call it, so the backward adds into the rows the
// forward read. Positions use separate f32 multiply and add (no FMA
// contraction), as the JAX and PyTorch versions do, so the same points fall
// into the same cells.
//
// Forward at the train step (1,048,576 points x 16 levels, C = 2): 134 M
// corner gathers of 8 bytes from a 49 MB f32 table that mostly stays in the
// 50 MB L2; 12.6 MB in and 64 MB (bf16) out. The gathers, not the output,
// bound it. Backward writes 134 M int32 indices and f32 rows of C (1.6 GB at
// that shape), all levels in one launch; fusing it with the scatter into one
// atomic pass is later work.
//
// Rounding: with a bf16 output (the bf16 compute type) each table value and
// each corner weight is rounded to bf16, the products summed in f32 and the
// feature rounded once, as JAX's bf16 einsum on the CPU does; backward, the
// product w * g is rounded to bf16 (the einsum's VJP), and the gradient then
// sums in f32 where JAX sums in bf16. Points outside [0, 1]^3 get zero
// features and corner index -1 (no adds).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 64;

struct GridParams {
  const float* x;  // [B, 3]
  long long B;
  int L;
  float scale[kMaxLevels];
  int offset[kMaxLevels];          // first table row of the level
  uint32_t size[kMaxLevels];       // table rows of the level
  uint32_t stride[kMaxLevels][3];  // dense strides; 0 for dims past the ones that fit
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

__device__ __forceinline__ bool in_box(const float* q) {
  return !(q[0] < 0.f || q[0] > 1.f || q[1] < 0.f || q[1] > 1.f || q[2] < 0.f ||
           q[2] > 1.f);
}

// lower corner i0 and interpolation fractions of point q at level l
__device__ __forceinline__ void level_pos(const GridParams& p, int l, const float* q,
                                          uint32_t* i0, float* frac) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(q[d], p.scale[l]), p.shift);
    const float pf = floorf(pos);
    float f = __fsub_rn(pos, pf);
    if (p.smoothstep) f = __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.f, __fmul_rn(2.f, f)));
    i0[d] = (uint32_t)(int)pf;
    frac[d] = f;
  }
}

// d-linear weight of corner k (bit d of k: the upper corner along axis d)
__device__ __forceinline__ float corner_weight(const float* frac, int k) {
  float w = (k & 1) ? frac[0] : __fsub_rn(1.f, frac[0]);
  w = __fmul_rn(w, (k & 2) ? frac[1] : __fsub_rn(1.f, frac[1]));
  return __fmul_rn(w, (k & 4) ? frac[2] : __fsub_rn(1.f, frac[2]));
}

// flat table row of corner k of the cell at i0, level l
__device__ __forceinline__ uint32_t corner_row(const GridParams& p, int l, const uint32_t* i0,
                                               int k) {
  const uint32_t primes[3] = {1u, 2654435761u, 805459861u};
  uint32_t idx = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const uint32_t c = i0[d] + (uint32_t)((k >> d) & 1);
    idx = p.hashed[l] ? (idx ^ (c * primes[d])) : (idx + c * p.stride[l][d]);
  }
  return (uint32_t)p.offset[l] + idx % p.size[l];
}

template <typename TT, typename TO, int C>
__global__ void grid_fwd_kernel(GridParams p, const TT* __restrict__ table, TO* __restrict__ out) {
  constexpr bool kRound = sizeof(TO) == 2;
  const long long n = p.B * p.L;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const long long b = i / p.L;
    const int l = (int)(i - b * p.L);
    const float q[3] = {__ldg(p.x + 3 * b), __ldg(p.x + 3 * b + 1), __ldg(p.x + 3 * b + 2)};
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    if (in_box(q)) {
      uint32_t i0[3];
      float frac[3];
      level_pos(p, l, q, i0, frac);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float w = corner_weight(frac, k);
        if (kRound) w = round_bf16(w);
        const size_t row = (size_t)corner_row(p, l, i0, k) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float v = ld(table, row + c);
          if (kRound) v = round_bf16(v);
          acc[c] = fmaf(w, v, acc[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) st(out, (size_t)i * C + c, acc[c]);
  }
}

template <typename TG, int C>
__global__ void grid_bwd_rows_kernel(GridParams p, const TG* __restrict__ g,
                                     int* __restrict__ idx_out, float* __restrict__ rows_out) {
  constexpr bool kRound = sizeof(TG) == 2;
  const long long n = p.B * p.L;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const long long b = i / p.L;
    const int l = (int)(i - b * p.L);
    const float q[3] = {__ldg(p.x + 3 * b), __ldg(p.x + 3 * b + 1), __ldg(p.x + 3 * b + 2)};
    const size_t base = (size_t)i * 8;
    if (!in_box(q)) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        idx_out[base + k] = -1;
#pragma unroll
        for (int c = 0; c < C; ++c) rows_out[(base + k) * C + c] = 0.f;
      }
      continue;
    }
    uint32_t i0[3];
    float frac[3];
    level_pos(p, l, q, i0, frac);
    float gv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) gv[c] = ld(g, (size_t)i * C + c);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float w = corner_weight(frac, k);
      if (kRound) w = round_bf16(w);
      idx_out[base + k] = (int)corner_row(p, l, i0, k);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float r = w * gv[c];
        if (kRound) r = round_bf16(r);
        rows_out[(base + k) * C + c] = r;
      }
    }
  }
}

int fill_params(GridParams* p, const float* x, long long B, int L, const float* scales,
                const int* offsets, const unsigned* sizes, const unsigned* strides,
                const int* hashed, float shift, int smoothstep) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  p->x = x;
  p->B = B;
  p->L = L;
  for (int l = 0; l < L; ++l) {
    p->scale[l] = scales[l];
    p->offset[l] = offsets[l];
    p->size[l] = sizes[l];
    for (int d = 0; d < 3; ++d) p->stride[l][d] = strides[3 * l + d];
    p->hashed[l] = hashed[l];
  }
  p->shift = shift;
  p->smoothstep = smoothstep;
  return (int)cudaSuccess;
}

int blocks_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename TT, typename TO>
int launch_fwd(const GridParams& p, int C, const void* table, void* out, cudaStream_t s) {
  const int blocks = blocks_for(p.B * p.L);
  const TT* t = static_cast<const TT*>(table);
  TO* o = static_cast<TO*>(out);
  switch (C) {
    case 1: grid_fwd_kernel<TT, TO, 1><<<blocks, kThreads, 0, s>>>(p, t, o); break;
    case 2: grid_fwd_kernel<TT, TO, 2><<<blocks, kThreads, 0, s>>>(p, t, o); break;
    case 4: grid_fwd_kernel<TT, TO, 4><<<blocks, kThreads, 0, s>>>(p, t, o); break;
    case 8: grid_fwd_kernel<TT, TO, 8><<<blocks, kThreads, 0, s>>>(p, t, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TG>
int launch_bwd(const GridParams& p, int C, const void* g, int* idx, float* rows,
               cudaStream_t s) {
  const int blocks = blocks_for(p.B * p.L);
  const TG* gg = static_cast<const TG*>(g);
  switch (C) {
    case 1: grid_bwd_rows_kernel<TG, 1><<<blocks, kThreads, 0, s>>>(p, gg, idx, rows); break;
    case 2: grid_bwd_rows_kernel<TG, 2><<<blocks, kThreads, 0, s>>>(p, gg, idx, rows); break;
    case 4: grid_bwd_rows_kernel<TG, 4><<<blocks, kThreads, 0, s>>>(p, gg, idx, rows); break;
    case 8: grid_bwd_rows_kernel<TG, 8><<<blocks, kThreads, 0, s>>>(p, gg, idx, rows); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ngp_grid_encode_fwd(const float* x, long long B, const void* table, int table_bf16,
                                   int C, int L, const float* scales, const int* offsets,
                                   const unsigned* sizes, const unsigned* strides,
                                   const int* hashed, float shift, int smoothstep, void* out,
                                   int out_bf16, void* stream) {
  GridParams p;
  const int err = fill_params(&p, x, B, L, scales, offsets, sizes, strides, hashed, shift,
                              smoothstep);
  if (err != (int)cudaSuccess || B <= 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16) {
    return out_bf16 ? launch_fwd<__nv_bfloat16, __nv_bfloat16>(p, C, table, out, s)
                    : launch_fwd<__nv_bfloat16, float>(p, C, table, out, s);
  }
  return out_bf16 ? launch_fwd<float, __nv_bfloat16>(p, C, table, out, s)
                  : launch_fwd<float, float>(p, C, table, out, s);
}

extern "C" int ngp_grid_encode_bwd_rows(const float* x, long long B, const void* g, int g_bf16,
                                        int C, int L, const float* scales, const int* offsets,
                                        const unsigned* sizes, const unsigned* strides,
                                        const int* hashed, float shift, int smoothstep,
                                        int* idx, float* rows, void* stream) {
  GridParams p;
  const int err = fill_params(&p, x, B, L, scales, offsets, sizes, strides, hashed, shift,
                              smoothstep);
  if (err != (int)cudaSuccess || B <= 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g_bf16 ? launch_bwd<__nv_bfloat16>(p, C, g, idx, rows, s)
                : launch_bwd<float>(p, C, g, idx, rows, s);
}
