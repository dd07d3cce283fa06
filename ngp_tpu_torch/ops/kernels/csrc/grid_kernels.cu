// Multiresolution hash / tiled grid encoder for Hopper (sm_90a).
//
// The JAX package leaves this encoder to XLA (ngp_tpu/ops/hashgrid.py:
// grid_encode: a take of the table and an einsum with the d-linear weights per
// level, hashgrid.py:203-204); these kernels do that work by hand.
//
//   ngp_grid_encode_fwd  features [B, L*C] from points [B, 3] and the table
//   ngp_grid_encode_bwd  the VJP of the take + einsum in one pass: every
//                        (point, level, corner) adds its cotangent row
//                        w * g by f32 atomics into the table gradient
//
// Per-level scale, row offset, row count, dense strides and the hashed flag
// sit in the kernel's parameter block. corner_row is the one device copy of
// the index arithmetic (gridencoder.cu:66-84 through hashgrid.py:125-158):
// row-major dense index over the dims whose stride fits the level, XOR of
// per-dim primes in wrapping uint32 when a hashed level overflows, then
// % rows; both kernels call it with the same level_pos and corner_weight, so
// the backward adds into the rows the forward read. Positions use separate
// f32 multiply and add (no FMA contraction), as the JAX and PyTorch versions
// do, so the same points fall into the same cells.
//
// Forward at the train step (1,048,576 points x 16 levels, C = 2): one
// thread per (point, level), level fastest, so a warp writes its points'
// output rows together; 134 M corner gathers of 8 bytes from a 49 MB f32
// table that mostly stays in the 50 MB L2; 12.6 MB in and 64 MB (bf16) out.
// The gathers, not the output, bound it.
//
// Backward: one warp per (32 points, level), level outside, so the warps of a
// block share their points' x and g rows in L1, and at a coarse level a
// warp's 32 consecutive samples of one ray mostly share a cell. A (point,
// level) whose cotangent row is zero, and a corner whose product row is
// zero, adds nothing: the masked slots of a train step (about 90% late in
// training) cost a load and no atomic. Lanes whose corner row is equal sum
// their products by shuffles (match_any, then a peer reduction) and one lane
// issues the float2 / float4 atomic. The table the wrapper zeroes (49 MB)
// stays mostly in L2; the bound is reading x and g and writing the table
// once (126 MB, 0.04 ms at the train shape), and what it meets first is the
// L2 atomic rate on the non-zero rows. Atomics sum in no fixed order, so the
// result varies in the last f32 bits from run to run; adding +-0 to a sum
// that starts at +0 leaves it unchanged, so skipping zero rows is exact.
//
// Rounding: with a bf16 output (the bf16 compute type) each table value and
// each corner weight is rounded to bf16, the products summed in f32 and the
// feature rounded once, as JAX's bf16 einsum on the CPU does; backward, the
// weight and the product w * g are rounded to bf16 (the einsum's VJP), and
// the gradient then sums in f32 where JAX sums in bf16. Points outside
// [0, 1]^3 get zero features and add nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900) && (CUDART_VERSION >= 12010)
#define NGP_VECTOR_ATOMICS 1
#endif

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

// Sum of x over the lanes of `peers` (a set of lanes of this warp holding the
// same key), left at the lowest lane of the set; the other lanes' results are
// partial. Every lane of `active` calls it together (E. Westphal's peer
// reduction: log2(set size) rounds of a shuffle from the next peer up).
__device__ __forceinline__ float sum_peers(unsigned active, unsigned peers, float x) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(active, above != 0u)) {
    const int next = __ffs(above);
    const float t = __shfl_sync(active, x, next > 0 ? next - 1 : 0);
    if (next > 0 && !(rank & 1)) x += t;
    above &= ~__ballot_sync(active, rank & 1);
    rank >>= 1;
  }
  return x;
}

// dst[0 .. C-1] += v by atomics: one float2 / float4 atomic per 2 / 4 columns
// (sm_90 and CUDA 12.1 on), else one per column
template <int C> __device__ __forceinline__ void add_row(float* dst, const float* v) {
#pragma unroll
  for (int c = 0; c < C; ++c) atomicAdd(dst + c, v[c]);
}
#ifdef NGP_VECTOR_ATOMICS
template <> __device__ __forceinline__ void add_row<2>(float* dst, const float* v) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
}
template <> __device__ __forceinline__ void add_row<4>(float* dst, const float* v) {
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
}
template <> __device__ __forceinline__ void add_row<8>(float* dst, const float* v) {
  add_row<4>(dst, v);
  add_row<4>(dst + 4, v + 4);
}
#endif

// dtable[corner_row(l, k)] += round(round(w_k) * g[b, l]) for every (point b,
// level l, corner k) whose product row is not zero. One warp per (32 points,
// level), lane = point, so the warps of a block walk the levels of the same
// 32 points (their x and g rows meet in L1) and a warp's corner rows at a
// coarse level are mostly equal (consecutive samples of one ray share a
// cell): lanes whose row is equal sum their products by shuffles and one
// lane adds the sum.
template <typename TG, int C>
__global__ void grid_bwd_kernel(GridParams p, const TG* __restrict__ g,
                                float* __restrict__ dtable) {
  constexpr bool kRound = sizeof(TG) == 2;
  const int lane = threadIdx.x & 31;
  const long long units = (p.B + 31) / 32 * p.L;
  const long long step = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long u = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; u < units;
       u += step) {
    const int l = (int)(u % p.L);
    const long long b = (u / p.L) * 32 + lane;
    float gv[C];
    bool live = b < p.B;
    float q[3] = {0.f, 0.f, 0.f};
    if (live) {
      q[0] = __ldg(p.x + 3 * b);
      q[1] = __ldg(p.x + 3 * b + 1);
      q[2] = __ldg(p.x + 3 * b + 2);
      live = in_box(q);
    }
    bool any = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gv[c] = live ? ld(g, ((size_t)b * p.L + l) * C + c) : 0.f;
      any |= gv[c] != 0.f;
    }
    // a zero cotangent row adds +-0 to sums that start at +0: skipping it is exact
    const unsigned active = __ballot_sync(0xffffffffu, any);
    if (!any) continue;
    uint32_t i0[3];
    float frac[3];
    level_pos(p, l, q, i0, frac);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float w = corner_weight(frac, k);
      if (kRound) w = round_bf16(w);
      float v[C];
      bool nz = false;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = w * gv[c];
        if (kRound) v[c] = round_bf16(v[c]);
        nz |= v[c] != 0.f;
      }
      const uint32_t row = corner_row(p, l, i0, k);
      // zero rows take part under a key no row has, so the set stays whole
      const unsigned peers = __match_any_sync(active, nz ? row : 0xffffffffu);
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = sum_peers(active, peers, v[c]);
      if (nz && lane == __ffs(peers) - 1) add_row<C>(dtable + (size_t)row * C, v);
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

template <typename TG, int C>
int launch_bwd_c(const GridParams& p, const void* g, float* dtable, cudaStream_t s) {
  const int blocks = blocks_for((p.B + 31) / 32 * p.L * 32);
  grid_bwd_kernel<TG, C><<<blocks, kThreads, 0, s>>>(p, static_cast<const TG*>(g), dtable);
  return (int)cudaGetLastError();
}

template <typename TG>
int launch_bwd(const GridParams& p, int C, const void* g, float* dtable, cudaStream_t s) {
  switch (C) {
    case 1: return launch_bwd_c<TG, 1>(p, g, dtable, s);
    case 2: return launch_bwd_c<TG, 2>(p, g, dtable, s);
    case 4: return launch_bwd_c<TG, 4>(p, g, dtable, s);
    case 8: return launch_bwd_c<TG, 8>(p, g, dtable, s);
    default: return (int)cudaErrorInvalidValue;
  }
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

extern "C" int ngp_grid_encode_bwd(const float* x, long long B, const void* g, int g_bf16,
                                   int C, int L, const float* scales, const int* offsets,
                                   const unsigned* sizes, const unsigned* strides,
                                   const int* hashed, float shift, int smoothstep,
                                   float* dtable, void* stream) {
  GridParams p;
  const int err = fill_params(&p, x, B, L, scales, offsets, sizes, strides, hashed, shift,
                              smoothstep);
  if (err != (int)cudaSuccess || B <= 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g_bf16 ? launch_bwd<__nv_bfloat16>(p, C, g, dtable, s)
                : launch_bwd<float>(p, C, g, dtable, s);
}
