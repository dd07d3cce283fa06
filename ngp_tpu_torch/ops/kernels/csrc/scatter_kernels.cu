// Row scatter-add for Hopper (sm_90a): out[idx[m], :] += rows[m, :].
//
// Replaces scripts/perf_probe2_r2.py:scatter_pallas, the TPU kernel that
// computes zeros[R, W].at[idx].add(rows) with a serial row loop into an
// accumulator held in VMEM across the whole grid. Hopper runs blocks in
// parallel and in no order, so the accumulator becomes f32 atomics into `out`
// in device memory (L2-resident when it is small: 8.4 MB at the probe's
// R = 16,384, W = 128). Rows of W <= 4 columns take one thread each and one
// vector atomic (float2 / float4 atomicAdd, sm_90 and CUDA 12.1 on); wider
// rows take one warp each, lanes on consecutive float4 (or float) columns, so
// a warp's atomics cover whole 128-byte lines of one output row. Indices
// outside [0, R) add nothing, as XLA's scatter drops them.
//
// The bound on this card is reading the rows once (1.07 GB at the probe shape,
// 0.32 ms at 3.35 TB/s); the L2 atomic rate and, for small R, contention on
// the same output lines are what it meets first. Atomics sum in no fixed
// order, so the result varies in the last f32 bits from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900) && (CUDART_VERSION >= 12010)
#define NGP_VECTOR_ATOMICS 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 64;

__device__ __forceinline__ void add2(float* dst, float2 v) {
#ifdef NGP_VECTOR_ATOMICS
  atomicAdd(reinterpret_cast<float2*>(dst), v);
#else
  atomicAdd(dst, v.x);
  atomicAdd(dst + 1, v.y);
#endif
}

__device__ __forceinline__ void add4(float* dst, float4 v) {
#ifdef NGP_VECTOR_ATOMICS
  atomicAdd(reinterpret_cast<float4*>(dst), v);
#else
  atomicAdd(dst, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
#endif
}

// one thread per row (W <= 4); vec: 2 or 4 when the row is one aligned vector
__global__ void scatter_rows_thread(const int* __restrict__ idx, const float* __restrict__ rows,
                                    long long M, int W, int R, int vec,
                                    float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x; m < M; m += stride) {
    const int r = __ldg(idx + m);
    if (r < 0 || r >= R) continue;
    const float* src = rows + m * W;
    float* dst = out + (size_t)r * W;
    if (vec == 4) {
      add4(dst, __ldg(reinterpret_cast<const float4*>(src)));
    } else if (vec == 2) {
      add2(dst, __ldg(reinterpret_cast<const float2*>(src)));
    } else {
      for (int c = 0; c < W; ++c) atomicAdd(dst + c, __ldg(src + c));
    }
  }
}

// one warp per row; vec 4: lanes on consecutive float4 columns, else floats
__global__ void scatter_rows_warp(const int* __restrict__ idx, const float* __restrict__ rows,
                                  long long M, int W, int R, int vec,
                                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long m = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; m < M;
       m += warps) {
    const int r = __ldg(idx + m);
    if (r < 0 || r >= R) continue;
    const float* src = rows + m * W;
    float* dst = out + (size_t)r * W;
    if (vec == 4) {
      for (int v = lane; v < W / 4; v += 32)
        add4(dst + 4 * v, __ldg(reinterpret_cast<const float4*>(src) + v));
    } else {
      for (int c = lane; c < W; c += 32) atomicAdd(dst + c, __ldg(src + c));
    }
  }
}

}  // namespace

extern "C" int ngp_scatter_add_rows(const int* idx, const float* rows, long long M, int W, int R,
                                    float* out, void* stream) {
  if (M <= 0 || W <= 0) return cudaSuccess;
  const uintptr_t align = (uintptr_t)rows | (uintptr_t)out;
  int vec = 1;
  if (W % 4 == 0 && align % 16 == 0) {
    vec = 4;
  } else if (W == 2 && align % 8 == 0) {
    vec = 2;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= 4) {
    long long blocks = (M + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    scatter_rows_thread<<<(int)blocks, kThreads, 0, s>>>(idx, rows, M, W, R, vec, out);
  } else {
    if (vec != 4) vec = 1;
    long long blocks = (M * 32 + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    scatter_rows_warp<<<(int)blocks, kThreads, 0, s>>>(idx, rows, M, W, R, vec, out);
  }
  return cudaGetLastError();
}
