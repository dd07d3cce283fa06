// The bilinear taps of a sample on a factor line or plane, shared by the
// taps' forward (taps_kernels.cu: sample_taps_fwd) and their factor gradient
// (scatter_kernels.cu: scatter_add_taps), so that both read and add into the
// same cells with the same weights. ops/kernels/scatter.py:factor_taps is
// their one owner on the torch side: every product and sum here is rounded on
// its own as torch rounds it (no fused multiply-add), or a sample on a cell
// edge lands in another cell. Each source includes it into its own anonymous
// namespace.

#pragma once

#include <cuda_runtime.h>

namespace {

// ops/kernels/scatter.py:_to_pixel, each operation rounded on its own
__device__ __forceinline__ float to_pixel(float u, int size, int align) {
  const float h = __fmul_rn(__fadd_rn(u, 1.f), 0.5f);
  return align ? __fmul_rn(h, (float)(size - 1))
               : __fsub_rn(__fmul_rn(h, (float)size), 0.5f);
}

// the taps of one sample: flat cell (-1 outside the grid) and weight, in
// factor_taps' order; W = D and H = 1 for a line (v unused)
template <int TAPS>
__device__ __forceinline__ void sample_taps(float u, float v, int H, int W, int align,
                                            int* cell, float* wt) {
  const float px = to_pixel(u, W, align);
  const float x0 = floorf(px);
  const float fx = __fsub_rn(px, x0);
  if (TAPS == 2) {
    cell[0] = (x0 >= 0.f && x0 <= (float)(W - 1)) ? (int)x0 : -1;
    cell[1] = (x0 >= -1.f && x0 <= (float)(W - 2)) ? (int)x0 + 1 : -1;
    wt[0] = __fsub_rn(1.f, fx);
    wt[1] = fx;
  } else {
    const float py = to_pixel(v, H, align);
    const float y0 = floorf(py);
    const float fy = __fsub_rn(py, y0);
    const bool xa = x0 >= 0.f && x0 <= (float)(W - 1), xb = x0 >= -1.f && x0 <= (float)(W - 2);
    const bool ya = y0 >= 0.f && y0 <= (float)(H - 1), yb = y0 >= -1.f && y0 <= (float)(H - 2);
    const int xi = (xa || xb) ? (int)x0 : 0, yi = (ya || yb) ? (int)y0 : 0;
    cell[0] = (ya && xa) ? yi * W + xi : -1;
    cell[1] = (ya && xb) ? yi * W + xi + 1 : -1;
    cell[2] = (yb && xa) ? (yi + 1) * W + xi : -1;
    cell[3] = (yb && xb) ? (yi + 1) * W + xi + 1 : -1;
    const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
    wt[0] = __fmul_rn(gx, gy);
    wt[1] = __fmul_rn(fx, gy);
    wt[2] = __fmul_rn(gx, fy);
    wt[3] = __fmul_rn(fx, fy);
  }
}

}  // namespace
