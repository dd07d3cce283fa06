// The factor taps' forward for Hopper (sm_90a): out[r, n] = the bilinear taps
// of sample n on row r of a factor line [R, D] (coords u [N], 2 taps) or plane
// [R, H, W] (coords (u, v), 4 taps), zero outside the grid.
//
// Replaces no Pallas kernel: it is ngp_tpu/ops/interp.py:sample_1d / sample_2d
// (:27, :45), which the JAX package leaves to XLA (a take per tap, fused with
// its lerp); the port ran it as one index_select, where, mul and add per tap
// (ops/kernels/scatter.py:sample_taps_plain), about 25 launches a line and 80
// a plane. TensoRF and CCNeRF sample their factors through it
// (ops/interp.py:FactorTaps). The taps' cells and weights come from taps.cuh,
// which the factor gradient (scatter_kernels.cu: scatter_add_taps) shares.
// The sum is the plain version's exactly: out = v_0 w_0, then out = out +
// v_t w_t for each later tap, every product and sum rounded on its own (no
// fused multiply-add), so the result is bit-equal to the plain version on the
// card.
//
// The factor is held cell-major (ops/kernels/scatter.py:cell_major): memory
// [H * W, R], a cell's R values contiguous. Layout: a thread per (sample,
// chunk of kRows = 8 rows). It makes its sample's taps once, then reads each
// tap's 8 rows as one 32-byte piece of one L2 sector (two float4s in f32, two
// 8-byte loads in bf16; scalar loads where R % 4 != 0 or the factor's address
// does not allow the vectors), and writes out[r, n] for its rows; a warp's 32
// threads write 32 consecutive samples of a row (coalesced). What bounds it:
// the bytes are the [R, N] f32 output written once and the coords read once
// (the factors, 4.4 MB for a 152^2 plane of rank 48, sit in the 50 MB L2). A
// row-major factor ([R, cells]) costs a 32-byte sector for each 4-byte value
// a tap gathers on a plane; cell-major, the 8 values of a chunk share one. A
// line is the exception: its rows are short (512 bytes at 128 cells), so a
// warp's 32 gathers of one row-major row fall in a few L1 lines, where
// cell-major ones may touch 32: a CCNeRF step's largest line call reads
// ~1.4x slower cell-major (chip_smoke.py, phase 15), and the layout stays
// for the gradient's sake (~6x faster on the same calls).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "taps.cuh"

namespace {

constexpr int kTapsThreads = 128;  // samples a block
constexpr int kRows = 8;           // factor rows a thread

__device__ __forceinline__ float load(const float* p, int k) { return __ldg(p + k); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int k) {
  return __bfloat162float(p[k]);
}

// the chunk's rows at one tap, 4 rows a vector load (R % 4 == 0): f32 as
// float4s, bf16 as 8-byte loads; the rows past the chunk's left out
__device__ __forceinline__ void load_rows(const float* src, int rows, float (&x)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows / 4; ++i) {
    const float4 a = 4 * i < rows ? __ldg(reinterpret_cast<const float4*>(src) + i)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    x[4 * i] = a.x, x[4 * i + 1] = a.y, x[4 * i + 2] = a.z, x[4 * i + 3] = a.w;
  }
}

// a bf16 is the high half of its f32, so each conversion is exact
__device__ __forceinline__ void load_rows(const __nv_bfloat16* src, int rows,
                                          float (&x)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows / 4; ++i) {
    const uint2 w = 4 * i < rows ? __ldg(reinterpret_cast<const uint2*>(src) + i)
                                 : make_uint2(0u, 0u);
    x[4 * i] = __uint_as_float(w.x << 16), x[4 * i + 1] = __uint_as_float(w.x & 0xffff0000u);
    x[4 * i + 2] = __uint_as_float(w.y << 16), x[4 * i + 3] = __uint_as_float(w.y & 0xffff0000u);
  }
}

template <int TAPS, typename T, bool VEC>
__global__ void __launch_bounds__(kTapsThreads)
sample_taps_kernel(const T* __restrict__ f, int R, long long N, const float* __restrict__ u,
                   long long su, const float* __restrict__ v, long long sv, int H, int W,
                   int align, float* __restrict__ out) {
  const long long n = (long long)blockIdx.x * kTapsThreads + threadIdx.x;
  if (n >= N) return;
  int cell[TAPS];
  float wt[TAPS];
  sample_taps<TAPS>(__ldg(u + n * su), TAPS == 4 ? __ldg(v + n * sv) : 0.f, H, W, align, cell,
                    wt);
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, R - r0);
  float val[TAPS][kRows];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    if (cell[t] < 0) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) val[t][k] = 0.f;
      continue;
    }
    const T* src = f + (size_t)cell[t] * R + r0;
    if (VEC) {
      load_rows(src, rows, val[t]);
    } else {
#pragma unroll
      for (int k = 0; k < kRows; ++k) val[t][k] = k < rows ? load(src, k) : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k >= rows) break;
    float acc = __fmul_rn(val[0][k], wt[0]);
#pragma unroll
    for (int t = 1; t < TAPS; ++t) acc = __fadd_rn(acc, __fmul_rn(val[t][k], wt[t]));
    out[(size_t)(r0 + k) * N + n] = acc;
  }
}

template <int TAPS, typename T, bool VEC>
int launch(const T* f, int R, long long N, const float* u, long long su, const float* v,
           long long sv, int H, int W, int align, float* out, cudaStream_t s) {
  const dim3 grid((unsigned)((N + kTapsThreads - 1) / kTapsThreads),
                  (unsigned)((R + kRows - 1) / kRows));
  sample_taps_kernel<TAPS, T, VEC><<<grid, kTapsThreads, 0, s>>>(f, R, N, u, su, v, sv, H, W,
                                                                 align, out);
  return cudaGetLastError();
}

template <typename T>
int launch_any(const T* f, bool vec, int R, long long N, const float* u, long long su,
               const float* v, long long sv, int H, int W, int align, float* out,
               cudaStream_t s) {
  if (v == nullptr) {
    return vec ? launch<2, T, true>(f, R, N, u, su, nullptr, 0, 1, W, align, out, s)
               : launch<2, T, false>(f, R, N, u, su, nullptr, 0, 1, W, align, out, s);
  }
  return vec ? launch<4, T, true>(f, R, N, u, su, v, sv, H, W, align, out, s)
             : launch<4, T, false>(f, R, N, u, su, v, sv, H, W, align, out, s);
}

}  // namespace

// factor [H * W, R] (cell-major), f32 (bf16 = 0) or bf16 (bf16 = 1); u (and v
// for a plane) f32 with strides su, sv in floats; a line when v is null (W =
// D, H = 1); out [R, N] f32 contiguous
extern "C" int ngp_sample_taps_fwd(const void* factor, int bf16, int R, long long N,
                                   const float* u, long long su, const float* v, long long sv,
                                   int H, int W, int align, float* out, void* stream) {
  if (R <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the vector loads: 4 rows each, aligned to their size
  const uintptr_t at = reinterpret_cast<uintptr_t>(factor);
  if (bf16) {
    return launch_any(static_cast<const __nv_bfloat16*>(factor), at % 8 == 0 && R % 4 == 0, R, N,
                      u, su, v, sv, H, W, align, out, s);
  }
  return launch_any(static_cast<const float*>(factor), at % 16 == 0 && R % 4 == 0, R, N, u, su,
                    v, sv, H, W, align, out, s);
}
