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
// grid_common.cuh's, the forward's own. One thread per point walking the
// levels, no atomics (each point owns its dx row). Per (point, level) with
// a non-zero cotangent row it reads the 2^D corner rows, takes each row's
// dot product with the cotangent, and sums the products' weights'
// derivatives: d w_k / d frac_d is the product of the other dims' factors
// with the sign of the corner's bit d, times dfrac/dpos; floor contributes
// nothing, and a point outside [0, 1]^D gets a zero row (JAX's
// where(oob, 0, out)). With a bf16 cotangent
// the table values and each corner's dot product are rounded to bf16 (the
// einsum's VJP in the weights), the rest is f32. Its bound is the forward's:
// the corner rows' sectors read once, and x, g and dx. A simple design:
// making it fast is later work.

#include "grid_common.cuh"

namespace {

// dx[b] = the VJP of point b's features in the point: per level with a
// non-zero cotangent row, each corner's <g, row> times the derivative of its
// weight in each frac, times dfrac/dpos (1, or smoothstep's) and the level's
// scale. One thread per point (lane = point, level uniform across a warp).
template <typename TT, typename TG, int C, int D>
__global__ void __launch_bounds__(kFwdThreads)
    grid_bwd_x_kernel(GridParams p, const TT* __restrict__ table, const TG* __restrict__ g,
                      float* __restrict__ dx) {
  constexpr bool kRound = sizeof(TG) == 2;
  const long long b = (long long)blockIdx.x * kFwdThreads + threadIdx.x;
  if (b >= p.B) return;
  float q[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = __ldg(p.x + D * b + d);
    acc[d] = 0.f;
  }
  if (in_box<D>(q)) {
    for (int l = 0; l < p.L; ++l) {
      float gv[C];
      bool any = false;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gv[c] = ld(g, ((size_t)b * p.L + l) * C + c);
        any |= gv[c] != 0.f;
      }
      if (!any) continue;  // a zero cotangent row adds zero to every dx
      uint32_t i0[D];
      float frac[D], dsm[D];
      level_pos<D>(p, l, q, i0, frac, dsm);
      float dfrac[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dfrac[d] = 0.f;
#pragma unroll
      for (int k = 0; k < (1 << D); ++k) {
        float v[C];
        load_vals<TT, C>(table + (size_t)corner_row<D>(p, l, i0, k) * C, v);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) dot = fmaf(gv[c], kRound ? round_bf16(v[c]) : v[c], dot);
        if (kRound) dot = round_bf16(dot);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          float w = 1.f;
#pragma unroll
          for (int e = 0; e < D; ++e) {
            if (e != d) w = __fmul_rn(w, (k >> e & 1) ? frac[e] : __fsub_rn(1.f, frac[e]));
          }
          dfrac[d] = fmaf((k >> d & 1) ? w : -w, dot, dfrac[d]);
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[d] = fmaf(__fmul_rn(dfrac[d], dsm[d]), p.scale[l], acc[d]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dx[D * b + d] = acc[d];
}

template <typename TT, typename TG, int C, int D>
int launch_bwd_x_cd(const GridParams& p, const void* table, const void* g, float* dx,
                    cudaStream_t s) {
  const int blocks = (int)((p.B + kFwdThreads - 1) / kFwdThreads);
  grid_bwd_x_kernel<TT, TG, C, D><<<blocks, kFwdThreads, 0, s>>>(
      p, static_cast<const TT*>(table), static_cast<const TG*>(g), dx);
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
