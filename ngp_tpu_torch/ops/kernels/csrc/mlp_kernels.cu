// Bias-free ReLU MLP chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ngp_tpu/ops/pallas/fused_mlp.py:fused_mlp:
//   ngp_fused_mlp  y = W_n . relu(... relu(W_0 . x)), [B, D_in] -> [B, D_out] f32
//
// x and the weights are rounded to bf16, every hidden layer is ReLU'd and
// rounded to bf16, and every product accumulates in f32, as the Pallas kernel
// does on the MXU. The TPU kernel padded every width to 128 lanes for its
// tiling; nothing here needs that. One block owns kRows rows: it copies every
// layer's weights into shared memory as f32 (28 KB at 32-64-64-16), rounds its
// x rows to bf16 into shared memory, and runs the layers back to back with
// the activations in shared memory, so device memory sees x once and y once.
// The products run on the CUDA cores with a register tile of kRowsPerThread
// rows per weight read; at the reference shape (524,288 rows x 32-64-64-16)
// that is 7.5 GFLOP against 100 MB of device traffic, so the FMA rate and the
// shared-memory reads bound it. Tensor-core (mma.sync / wgmma) products are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kRows = 128;          // rows per block
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;   // register tile of the dense loops
constexpr int kMaxSmemBytes = 232448;

struct MlpParams {
  const void* x;  // [B, dims[0]], f32 or bf16
  int x_bf16;
  int B;
  const __nv_bfloat16* w[kMaxLayers];  // [dims[l], dims[l + 1]] each
  int dims[kMaxLayers + 1];
  int n_layers;
  int w_floats;  // sum of dims[l] * dims[l + 1]
  int dmax;      // the widest layer
  float* out;    // [B, dims[n_layers]]
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

// out[m][j] = sum_k in[m][k] * W[k][j] for the block's kRows rows, in, W and
// out in shared memory (row stride `stride`); relu: ReLU, then round to bf16.
__device__ void dense(const float* in, int K, const float* W, int J, float* out, int stride,
                      bool relu) {
  constexpr int groups = kRows / kRowsPerThread;
  for (int item = threadIdx.x; item < J * groups; item += blockDim.x) {
    const int j = item % J;
    const int g = item / J;
    const float* a = in + g * kRowsPerThread * stride;
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = W[k * J + j];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = fmaf(a[r * stride + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      out[(g * kRowsPerThread + r) * stride + j] = relu ? round_bf16(fmaxf(acc[r], 0.f)) : acc[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(MlpParams p) {
  extern __shared__ float smem[];
  float* ws = smem;                      // every layer's weights, f32
  float* buf_a = ws + p.w_floats;        // [kRows, dmax]
  float* buf_b = buf_a + kRows * p.dmax;  // [kRows, dmax]
  int off = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const int n = p.dims[l] * p.dims[l + 1];
    for (int i = threadIdx.x; i < n; i += blockDim.x) ws[off + i] = __bfloat162float(p.w[l][i]);
    off += n;
  }
  const int row0 = blockIdx.x * kRows;
  const int d0 = p.dims[0];
  for (int i = threadIdx.x; i < kRows * d0; i += blockDim.x) {
    const int m = i / d0;
    const int row = row0 + m;
    float v = 0.f;
    if (row < p.B) {
      const size_t at = (size_t)row * d0 + (i - m * d0);
      v = p.x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[at])
                   : round_bf16(static_cast<const float*>(p.x)[at]);
    }
    buf_a[m * p.dmax + (i - m * d0)] = v;
  }
  __syncthreads();
  float* src = buf_a;
  float* dst = buf_b;
  off = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    dense(src, p.dims[l], ws + off, p.dims[l + 1], dst, p.dmax, l != p.n_layers - 1);
    __syncthreads();
    off += p.dims[l] * p.dims[l + 1];
    float* t = src;
    src = dst;
    dst = t;
  }
  const int dout = p.dims[p.n_layers];
  for (int i = threadIdx.x; i < kRows * dout; i += blockDim.x) {
    const int m = i / dout;
    const int row = row0 + m;
    if (row < p.B) p.out[(size_t)row * dout + (i - m * dout)] = src[m * p.dmax + (i - m * dout)];
  }
}

}  // namespace

extern "C" int ngp_fused_mlp(const void* x, int x_bf16, int B, const void* const* weights,
                             const int* dims, int n_layers, float* out, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || B < 0) return cudaErrorInvalidValue;
  MlpParams p;
  p.x = x;
  p.x_bf16 = x_bf16;
  p.B = B;
  p.n_layers = n_layers;
  p.out = out;
  p.w_floats = 0;
  p.dmax = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return cudaErrorInvalidValue;
    p.dims[l] = dims[l];
    p.dmax = dims[l] > p.dmax ? dims[l] : p.dmax;
  }
  for (int l = 0; l < n_layers; ++l) {
    p.w[l] = static_cast<const __nv_bfloat16*>(weights[l]);
    p.w_floats += dims[l] * dims[l + 1];
  }
  // every layer's weights and two activation buffers; wider chains are refused
  const long long bytes = (p.w_floats + 2LL * kRows * p.dmax) * (long long)sizeof(float);
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int blocks = (B + kRows - 1) / kRows;
  fused_mlp_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
