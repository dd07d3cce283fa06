// The hash / tiled grid encoder's gradient in the points, for Hopper
// (sm_90a): what JAX's autodiff of grid_encode gives for x
// (ngp_tpu/ops/hashgrid.py:161-209; XLA computes it there, no Pallas):
//
//   ngp_grid_encode_bwd_x  dx_d = sum over levels of scale_l * dfrac/dpos *
//                          sum over corners k of dw_k/dfrac_d * <g_l, row_k>
//
// D-NeRF's deformation and ambient nets train through it. Instances for
// D = 2, 3 and 4, f32 or bf16 tables and cotangents, 1-8 features a level;
// the geometry, positions (with dfrac/dpos) and corner rows are
// grid_common.cuh's, the forward's own. Per (point, level) with a non-zero
// cotangent row it reads the 2^D corner rows, takes each row's dot product
// with the cotangent, and sums the products' weights' derivatives: d w_k /
// d frac_d is the product of the other dims' factors with the sign of the
// corner's bit d, times dfrac/dpos; floor contributes nothing, and a point
// outside [0, 1]^D gets a zero row (JAX's where(oob, 0, out)). With a bf16
// cotangent the table values and each corner's dot product are rounded to
// bf16 (the einsum's VJP in the weights), the rest is f32.
//
// What bounds it: the bytes are the forward's (the corner rows' sectors read
// once, and x, g and dx), but a thread's 2^D corner loads depend on its
// position and feed its sums, so at a train step's 32,768 points the kernel
// is bound by load latency unless many (point, level) pairs are in flight:
// one thread per point walking the levels (the first design) kept 32,768
// threads busy, 8 of an SM's 64 warp slots. On many random points it is
// bound by the L2's rate of random 32-byte sectors, and by HBM where the
// levels the card works on at once overflow the 50 MB L2 (D-NeRF's 4-D
// table holds 67 MB): there a thread per point, all of them walking the
// levels together, keeps one level's rows hot at a time, and a thread per
// (point, level) over every level at once does not.
//
// So one thread takes one point and one slice of its levels: slice s of S
// walks the levels s, s + S, s + 2 S, ... in ascending order, and S grows
// (1, 2, 4, 8; at most the levels) until B S threads fill the card about
// once: 8 at a step's 32,768 points, 1 (the first design) at 262,144. A
// block is 256 threads: 8 warps, lanes on points and each warp on one slice,
// so the level is uniform across a warp, as in the forward and the table
// gradient. A thread issues its corner loads before its dot products (up to
// 16 values at a time: all 2^D corners at D <= 3 with C = 2, 8 at a time at
// D = 4), one vector load of rows r and r ^ 1 where they form an aligned
// pair (the forward's pair load), and makes its level's
// dfrac_d * dfrac/dpos. After each round of S levels the S slices of a point
// hand these to the slice-0 thread through shared memory, which folds them
// in level order into acc = fmaf(p_l[d], scale_l, acc), skipping the levels
// whose cotangent row is zero; with S = 1 the thread folds its own. These
// are the first design's operations in its order, so dx is bit-equal to it.

#include "grid_common.cuh"

namespace {

constexpr int kBwdXThreads = 256;  // a block: 256 / S points, S slices of their levels
constexpr int kBwdXMaxSlices = 8;
// the slices grow until B S reaches this many threads a SM (4 blocks; the
// D = 4 instances hold about 100 registers a thread, so 2 are resident:
// capping them at 64 spilled and took 2.6x the time at 262,144 points)
constexpr int kBwdXFill = 1024;

// part[d] = dfrac_d * dfrac/dpos of point q (row b) at level l, as the first
// design makes it; false where the level's cotangent row is zero (it adds
// nothing to dx)
template <typename TT, typename TG, int C, int D>
__device__ __forceinline__ bool level_partial(const GridParams& p, const TT* table, const TG* g,
                                              long long b, int l, const float* q, float* part) {
  constexpr bool kRound = sizeof(TG) == 2;
  constexpr int kCorners = 1 << D;
  // corners whose rows are loaded before their dot products: at most 16 values
  constexpr int kGroup = kCorners * C <= 16 ? kCorners : (16 / C >= 2 ? 16 / C : 2);
  float gv[C];
  bool any = false;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gv[c] = ld(g, ((size_t)b * p.L + l) * C + c);
    any |= gv[c] != 0.f;
  }
  if (!any) return false;
  uint32_t i0[D];
  float frac[D], dsm[D];
  level_pos<D>(p, l, q, i0, frac, dsm);
  float dfrac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dfrac[d] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kCorners; k0 += kGroup) {
    float v[kGroup][C];
#pragma unroll
    for (int k = 0; k < kGroup; k += 2) {
      // the x-corners k and k + 1: one load of their aligned pair of rows
      // where the two rows are r and r ^ 1, else one load each
      const uint32_t r0 = corner_row<D>(p, l, i0, k0 + k);
      const uint32_t r1 = corner_row<D>(p, l, i0, k0 + k + 1);
      if (r1 == (r0 ^ 1u)) {
        float vv[2 * C];
        load_vals<TT, 2 * C>(table + (size_t)(r0 & ~1u) * C, vv);
        const bool odd = r0 & 1u;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          v[k][c] = odd ? vv[C + c] : vv[c];
          v[k + 1][c] = odd ? vv[c] : vv[C + c];
        }
      } else {
        load_vals<TT, C>(table + (size_t)r0 * C, v[k]);
        load_vals<TT, C>(table + (size_t)r1 * C, v[k + 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int kk = k0 + k;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) dot = fmaf(gv[c], kRound ? round_bf16(v[k][c]) : v[k][c], dot);
      if (kRound) dot = round_bf16(dot);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float w = 1.f;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          if (e != d) w = __fmul_rn(w, (kk >> e & 1) ? frac[e] : __fsub_rn(1.f, frac[e]));
        }
        dfrac[d] = fmaf((kk >> d & 1) ? w : -w, dot, dfrac[d]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) part[d] = __fmul_rn(dfrac[d], dsm[d]);
  return true;
}

// dx[b] = the VJP of point b's features in the point (see the header): warp
// y of the block is slice y % S of the point-warp y / S
template <typename TT, typename TG, int C, int D>
__global__ void __launch_bounds__(kBwdXThreads)
    grid_bwd_x_kernel(GridParams p, int S, const TT* __restrict__ table,
                      const TG* __restrict__ g, float* __restrict__ dx) {
  __shared__ float slot[D * kBwdXThreads];  // [S][D][points of the block]
  __shared__ uint8_t live[kBwdXThreads];    // [S][points of the block]
  const int s = threadIdx.y % S;
  const int npts = kBwdXThreads / S;
  const int pt = (threadIdx.y / S) * 32 + threadIdx.x;
  const long long b = (long long)blockIdx.x * npts + pt;
  float q[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = acc[d] = 0.f;
  if (b < p.B) {
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = __ldg(p.x + D * b + d);
  }
  const bool inside = b < p.B && in_box<D>(q);
  for (int l0 = 0; l0 < p.L; l0 += S) {
    const int l = l0 + s;
    float part[D];
    const bool on = inside && l < p.L && level_partial<TT, TG, C, D>(p, table, g, b, l, q, part);
    if (S == 1) {
      if (on) {
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(part[d], p.scale[l], acc[d]);
      }
      continue;
    }
    live[s * npts + pt] = on;
    if (on) {
#pragma unroll
      for (int d = 0; d < D; ++d) slot[(s * D + d) * npts + pt] = part[d];
    }
    __syncthreads();
    if (s == 0) {
      for (int j = 0; j < S && l0 + j < p.L; ++j) {
        if (!live[j * npts + pt]) continue;
#pragma unroll
        for (int d = 0; d < D; ++d)
          acc[d] = fmaf(slot[(j * D + d) * npts + pt], p.scale[l0 + j], acc[d]);
      }
    }
    __syncthreads();
  }
  if (s == 0 && b < p.B) {
#pragma unroll
    for (int d = 0; d < D; ++d) dx[D * b + d] = acc[d];
  }
}

template <typename TT, typename TG, int C, int D>
int launch_bwd_x_cd(const GridParams& p, const void* table, const void* g, float* dx,
                    cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  // slices of the levels: B S threads fill the card about once
  int S = 1;
  while (S < kBwdXMaxSlices && S < p.L && p.B * S < (long long)sms * kBwdXFill) S *= 2;
  const int npts = kBwdXThreads / S;
  const long long blocks = (p.B + npts - 1) / npts;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grid_bwd_x_kernel<TT, TG, C, D><<<(unsigned)blocks, dim3(32, kBwdXThreads / 32), 0, s>>>(
      p, S, static_cast<const TT*>(table), static_cast<const TG*>(g), dx);
  return (int)cudaGetLastError();
}

template <typename TT, typename TG, int C>
int launch_bwd_x_c(const GridParams& p, int D, const void* table, const void* g, float* dx,
                   cudaStream_t s) {
  switch (D) {
    case 2: return launch_bwd_x_cd<TT, TG, C, 2>(p, table, g, dx, s);
    case 3: return launch_bwd_x_cd<TT, TG, C, 3>(p, table, g, dx, s);
    case 4: return launch_bwd_x_cd<TT, TG, C, 4>(p, table, g, dx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TT, typename TG>
int launch_bwd_x(const GridParams& p, int C, int D, const void* table, const void* g,
                 float* dx, cudaStream_t s) {
  switch (C) {
    case 1: return launch_bwd_x_c<TT, TG, 1>(p, D, table, g, dx, s);
    case 2: return launch_bwd_x_c<TT, TG, 2>(p, D, table, g, dx, s);
    case 4: return launch_bwd_x_c<TT, TG, 4>(p, D, table, g, dx, s);
    case 8: return launch_bwd_x_c<TT, TG, 8>(p, D, table, g, dx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ngp_grid_encode_bwd_x(const float* x, long long B, int D, const void* table,
                                     int table_bf16, const void* g, int g_bf16, int C, int L,
                                     const float* scales, const int* offsets,
                                     const unsigned* sizes, const unsigned* strides,
                                     const int* hashed, float shift, int smoothstep, float* dx,
                                     void* stream) {
  GridParams p;
  const int err = fill_params(&p, x, B, D, L, scales, offsets, sizes, strides, hashed, shift,
                              smoothstep);
  if (err != (int)cudaSuccess || B <= 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16) {
    return g_bf16 ? launch_bwd_x<__nv_bfloat16, __nv_bfloat16>(p, C, D, table, g, dx, s)
                  : launch_bwd_x<__nv_bfloat16, float>(p, C, D, table, g, dx, s);
  }
  return g_bf16 ? launch_bwd_x<float, __nv_bfloat16>(p, C, D, table, g, dx, s)
                : launch_bwd_x<float, float>(p, C, D, table, g, dx, s);
}
