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
// Layout: a thread per (sample, chunk of kRows rows). It makes its sample's
// taps once, then for each of its rows gathers the 2 or 4 factor values and
// writes out[r, n]; a warp's 32 threads write 32 consecutive samples of a row
// (coalesced). The rows of a chunk are loaded before they are summed, so each
// thread has up to 8 x 4 independent gathers in flight. What bounds it: the
// bytes are the [R, N] f32 output written once and the coords read once (the
// factors, 4.4 MB for a 152^2 plane of rank 48, sit in the 50 MB L2); what it
// meets first is the gathers' L2 sectors: neighbouring samples of a warp hit
// neighbouring cells on a ray but scattered ones on uniform points, a 32-byte
// sector for each 4-byte value. A factor stored cell-major ([cells, R]) would
// make a sample's rows one contiguous read: later work, it changes the
// parameters' layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "taps.cuh"

namespace {

constexpr int kTapsThreads = 128;  // samples a block
constexpr int kRows = 8;           // factor rows a thread

__device__ __forceinline__ float load(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <int TAPS, typename T>
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
  const size_t cells = (size_t)H * W;
  const int r0 = blockIdx.y * kRows;
  float val[kRows][TAPS];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      val[k][t] = (r0 + k < R && cell[t] >= 0) ? load(f, (size_t)(r0 + k) * cells + cell[t])
                                               : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (r0 + k >= R) break;
    float acc = __fmul_rn(val[k][0], wt[0]);
#pragma unroll
    for (int t = 1; t < TAPS; ++t) acc = __fadd_rn(acc, __fmul_rn(val[k][t], wt[t]));
    out[(size_t)(r0 + k) * N + n] = acc;
  }
}

template <int TAPS, typename T>
int launch(const T* f, int R, long long N, const float* u, long long su, const float* v,
           long long sv, int H, int W, int align, float* out, cudaStream_t s) {
  const dim3 grid((unsigned)((N + kTapsThreads - 1) / kTapsThreads),
                  (unsigned)((R + kRows - 1) / kRows));
  sample_taps_kernel<TAPS, T><<<grid, kTapsThreads, 0, s>>>(f, R, N, u, su, v, sv, H, W, align,
                                                            out);
  return cudaGetLastError();
}

}  // namespace

// factor [R, H * W] contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1); u (and v
// for a plane) f32 with strides su, sv in floats; a line when v is null (W =
// D, H = 1); out [R, N] f32 contiguous
extern "C" int ngp_sample_taps_fwd(const void* factor, int bf16, int R, long long N,
                                   const float* u, long long su, const float* v, long long sv,
                                   int H, int W, int align, float* out, void* stream) {
  if (R <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(factor);
    return v == nullptr ? launch<2>(f, R, N, u, su, nullptr, 0, 1, W, align, out, s)
                        : launch<4>(f, R, N, u, su, v, sv, H, W, align, out, s);
  }
  const float* f = static_cast<const float*>(factor);
  return v == nullptr ? launch<2>(f, R, N, u, su, nullptr, 0, 1, W, align, out, s)
                      : launch<4>(f, R, N, u, su, v, sv, H, W, align, out, s);
}
