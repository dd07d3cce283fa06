// Bias-free ReLU MLP chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ngp_tpu/ops/pallas/fused_mlp.py:fused_mlp:
//   ngp_fused_mlp  y = W_n . relu(... relu(W_0 . x)), [B, D_in] -> [B, D_out] f32
//
// x and the weights are rounded to bf16, every hidden layer is ReLU'd and
// rounded to bf16, and every product accumulates in f32, as the Pallas kernel
// does on the MXU. The TPU kernel padded every width to 128 lanes for its
// tiling; here widths are padded to 16, the depth of one mma.sync k-step.
//
// Chains whose widths are all <= 128 (every MLP of the package: 32-64-64-16,
// 31-64-64-3, 32-64-16) take fused_mlp_tc_kernel, on the tensor cores
// (mma.sync m16n8k16, bf16 -> f32, the tile code of mma_bf16.cuh that the bf16
// CP heads use). Persistent blocks keep every layer's weights in shared
// memory in fragment order, zero-padded to 16 rows and columns. Each warp owns
// 16-row tiles: it reads its x rows with 16-byte loads into a small shared
// tile (rounded to bf16), takes layer 0's A fragments from it, and from then
// on keeps the activations in registers: the f32 accumulator of layer l,
// ReLU'd and rounded to bf16, is layer l + 1's A fragment (the m16n8 C layout
// of n-tiles 2j and 2j + 1 is the m16k16 A layout of k-step j), and the last
// layer's accumulators go out as 8-byte stores. wgmma is not needed: at
// widths <= 128 a warp's 16-row tile is the whole product of a layer (at most
// 8 k-steps x 16 n-tiles), and 64-row warpgroup tiles would only add a
// shared-memory round trip per layer. The kernel is instanced for 8 and 16
// n-tiles (widths <= 64, 128), the smaller where it holds the widest layer:
// the package's chains (64 wide) keep 69 registers there against 124 and, on
// an H100 SXM, run 1.7x faster; a narrower layer skips the tiles it does not
// have at run time. At the reference shape (524,288 rows x 32-64-64-16) the
// products are 7.5 GFLOP, 0.008 ms at the bf16 tensor-core rate, against
// 100 MB of x and y (0.030 ms at 3.35 TB/s): device memory bounds it.
//
// Wider chains take fused_mlp_kernel, the first design: one block owns kRows
// rows (fewer for chains whose activations would not fit), copies every layer's weights into shared memory as f32, rounds its x
// rows to bf16 into shared memory and runs the layers back to back with the
// activations in shared memory, the products on the CUDA cores with a
// register tile of kRowsPerThread rows per weight read. mlp_tc_route decides
// the route from the shape before the launch; a chain neither kernel's shared
// memory holds is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "resident.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kRows = 128;          // rows per block, fewer where they do not fit
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;   // register tile of the dense loops
constexpr int kMaxSmemBytes = 232448;
constexpr int kUnsupportedShape = -1;  // the wrapper raises ValueError for it
constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcMaxWidth = 128;       // widest layer of the tensor-core route

struct MlpParams {
  const void* x;  // [B, dims[0]], f32 or bf16
  int x_bf16;
  int B;
  const __nv_bfloat16* w[kMaxLayers];  // [dims[l], dims[l + 1]] each
  int dims[kMaxLayers + 1];
  int n_layers;
  int w_floats;  // sum of dims[l] * dims[l + 1]
  int dmax;      // the widest layer
  int rows;      // rows per block of the CUDA-core kernel: kRows, or fewer
  float* out;    // [B, dims[n_layers]]
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

// out[m][j] = sum_k in[m][k] * W[k][j] for the block's rows, in, W and out
// in shared memory (row stride `stride`); relu: ReLU, then round to bf16.
__device__ void dense(const float* in, int K, const float* W, int J, float* out, int stride,
                      bool relu, int rows) {
  const int groups = rows / kRowsPerThread;
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
  float* buf_a = ws + p.w_floats;          // [rows, dmax]
  float* buf_b = buf_a + p.rows * p.dmax;  // [rows, dmax]
  int off = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const int n = p.dims[l] * p.dims[l + 1];
    for (int i = threadIdx.x; i < n; i += blockDim.x) ws[off + i] = __bfloat162float(p.w[l][i]);
    off += n;
  }
  const int row0 = blockIdx.x * p.rows;
  const int d0 = p.dims[0];
  for (int i = threadIdx.x; i < p.rows * d0; i += blockDim.x) {
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
    dense(src, p.dims[l], ws + off, p.dims[l + 1], dst, p.dmax, l != p.n_layers - 1, p.rows);
    __syncthreads();
    off += p.dims[l] * p.dims[l + 1];
    float* t = src;
    src = dst;
    dst = t;
  }
  const int dout = p.dims[p.n_layers];
  for (int i = threadIdx.x; i < p.rows * dout; i += blockDim.x) {
    const int m = i / dout;
    const int row = row0 + m;
    if (row < p.B) p.out[(size_t)row * dout + (i - m * dout)] = src[m * p.dmax + (i - m * dout)];
  }
}

// ---------------------------------------------------------------------------
// the tensor-core chain
// ---------------------------------------------------------------------------

// The padded widths and shared-memory layout of a tensor-core chain, made on
// the host (mlp_tc_route) and passed as a kernel parameter.
struct MlpTc {
  int kp[kMaxLayers + 1];  // widths padded to 16
  int w_at[kMaxLayers];    // layer l's weights: first uint2 (4 bf16) in shared memory
  int x_at;                // byte offset of the warps' x tiles
  int ldx;                 // row stride of an x tile, bf16: kp[0] + 8
  int vec;                 // x rows are whole 16-byte vectors
};

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// the rows m of the warp's 16-row tile at row0, as bf16 (zeros past B), into
// columns 0 .. dims[0] - 1 of the tile
__device__ __forceinline__ void load_x_tile(const MlpParams& p, const MlpTc& t, int row0,
                                            __nv_bfloat16* xt, int lane) {
  const int d0 = p.dims[0];
  if (p.x_bf16) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
    if (t.vec) {
      const int vpr = d0 >> 3;  // 16-byte vectors of 8 columns a row
      for (int i = lane; i < 16 * vpr; i += 32) {
        const int m = i / vpr, v = i - m * vpr;
        const int row = row0 + m;
        const uint4 u = row < p.B
                            ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * d0) + v)
                            : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(xt + m * t.ldx + 8 * v) = u;
      }
    } else {
      for (int i = lane; i < 16 * d0; i += 32) {
        const int m = i / d0, c = i - m * d0;
        const int row = row0 + m;
        xt[m * t.ldx + c] = row < p.B ? x[(size_t)row * d0 + c] : __float2bfloat16(0.f);
      }
    }
  } else {
    const float* x = static_cast<const float*>(p.x);
    if (t.vec) {
      const int vpr = d0 >> 2;  // 16-byte vectors of 4 columns a row
      for (int i = lane; i < 16 * vpr; i += 32) {
        const int m = i / vpr, v = i - m * vpr;
        const int row = row0 + m;
        const float4 f = row < p.B
                             ? __ldg(reinterpret_cast<const float4*>(x + (size_t)row * d0) + v)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<uint2*>(xt + m * t.ldx + 4 * v) =
            make_uint2(pack_bf16x2(f.x, f.y), pack_bf16x2(f.z, f.w));
      }
    } else {
      for (int i = lane; i < 16 * d0; i += 32) {
        const int m = i / d0, c = i - m * d0;
        const int row = row0 + m;
        xt[m * t.ldx + c] = __float2bfloat16(row < p.B ? x[(size_t)row * d0 + c] : 0.f);
      }
    }
  }
}

// NT: the n-tiles of 8 columns of the widest layer the instance takes (8 or 16)
template <int NT>
__global__ void __launch_bounds__(kTcThreads) fused_mlp_tc_kernel(MlpParams p, MlpTc t) {
  extern __shared__ uint4 smem_tc[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_tc);
  __nv_bfloat16* wsh = reinterpret_cast<__nv_bfloat16*>(base);
  for (int l = 0; l < p.n_layers; ++l) {
    const int K = p.dims[l], N = p.dims[l + 1], kp = t.kp[l], np = t.kp[l + 1];
    __nv_bfloat16* dst = wsh + 4 * t.w_at[l];
    for (int i = threadIdx.x; i < kp * np; i += kTcThreads) {
      const int k = i / np, n = i - k * np;
      dst[frag_slot(k, n, np >> 3)] =
          (k < K && n < N) ? p.w[l][(size_t)k * N + n] : __float2bfloat16(0.f);
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(base + t.x_at) + warp * 16 * t.ldx;
  // the tile's padding columns stay zero: the loads write columns < dims[0]
  const int pad = t.kp[0] - p.dims[0];
  for (int i = lane; i < 16 * pad; i += 32) {
    const int m = i / pad;
    xt[m * t.ldx + p.dims[0] + i - m * pad] = __float2bfloat16(0.f);
  }
  __syncthreads();
  const int tiles = (p.B + 15) >> 4;
  const int dout = p.dims[p.n_layers];
  const __nv_bfloat16* x_lo = xt + g * t.ldx + 2 * tq;
  const __nv_bfloat16* x_hi = x_lo + 8 * t.ldx;
  for (int tile = blockIdx.x * kTcWarps + warp; tile < tiles; tile += gridDim.x * kTcWarps) {
    const int row0 = tile << 4;
    load_x_tile(p, t, row0, xt, lane);
    __syncwarp();
    uint32_t a[NT / 2][4];
#pragma unroll
    for (int ks = 0; ks < NT / 2; ++ks) {
      const bool in = ks < (t.kp[0] >> 4);
      a[ks][0] = in ? lds32(x_lo + 16 * ks) : 0u;
      a[ks][1] = in ? lds32(x_hi + 16 * ks) : 0u;
      a[ks][2] = in ? lds32(x_lo + 16 * ks + 8) : 0u;
      a[ks][3] = in ? lds32(x_hi + 16 * ks + 8) : 0u;
    }
    __syncwarp();  // the next tile's loads overwrite the tile
#pragma unroll 1
    for (int l = 0; l < p.n_layers; ++l) {
      const int ks_n = t.kp[l] >> 4, nt_n = t.kp[l + 1] >> 3;
      const uint2* w = reinterpret_cast<const uint2*>(wsh) + t.w_at[l] + lane;
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NT / 2; ++ks) {
        if (ks < ks_n) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (j < nt_n) {
              const uint2 b = w[(ks * nt_n + j) * 32];
              mma_bf16(acc[j], a[ks][0], a[ks][1], a[ks][2], a[ks][3], b.x, b.y);
            }
          }
        }
      }
      if (l + 1 < p.n_layers) {
        // ReLU, bf16: n-tiles 2 ks and 2 ks + 1 are k-step ks of the next layer
#pragma unroll
        for (int ks = 0; ks < NT / 2; ++ks) {
          a[ks][0] = pack_bf16x2(fmaxf(acc[2 * ks][0], 0.f), fmaxf(acc[2 * ks][1], 0.f));
          a[ks][1] = pack_bf16x2(fmaxf(acc[2 * ks][2], 0.f), fmaxf(acc[2 * ks][3], 0.f));
          a[ks][2] = pack_bf16x2(fmaxf(acc[2 * ks + 1][0], 0.f), fmaxf(acc[2 * ks + 1][1], 0.f));
          a[ks][3] = pack_bf16x2(fmaxf(acc[2 * ks + 1][2], 0.f), fmaxf(acc[2 * ks + 1][3], 0.f));
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = 8 * j + 2 * tq;
        if (j >= nt_n || col >= dout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + g + 8 * h;
          if (row >= p.B) continue;
          float* o = p.out + (size_t)row * dout + col;
          if ((dout & 1) == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
          } else {
            o[0] = acc[j][2 * h];
            if (col + 1 < dout) o[1] = acc[j][2 * h + 1];
          }
        }
      }
    }
  }
}

// The one source of the route: the n-tiles of the tensor-core instance that
// takes this chain (with its layout in t and its shared memory in bytes), or
// 0 for the CUDA-core kernel, which takes a layer wider than kTcMaxWidth and
// a chain whose padded bf16 weights do not fit beside the x tiles.
int mlp_tc_route(const MlpParams& p, const void* x, MlpTc* t, size_t* bytes) {
  int widest = 0;
  for (int l = 0; l <= p.n_layers; ++l) {
    if (p.dims[l] > kTcMaxWidth) return 0;
    t->kp[l] = pad16(p.dims[l]);
    widest = t->kp[l] > widest ? t->kp[l] : widest;
  }
  int at = 0;  // in uint2 (4 bf16)
  for (int l = 0; l < p.n_layers; ++l) {
    t->w_at[l] = at;
    at += t->kp[l] * t->kp[l + 1] / 4;
  }
  t->x_at = 8 * at;
  t->ldx = t->kp[0] + 8;
  const int esz = p.x_bf16 ? 2 : 4;
  t->vec = (p.dims[0] * esz) % 16 == 0 && (uintptr_t)x % 16 == 0;
  *bytes = (size_t)t->x_at + (size_t)kTcWarps * 16 * t->ldx * 2;
  if (*bytes > (size_t)kMaxSmemBytes) return 0;
  return widest <= 64 ? 8 : 16;
}

template <int NT>
int launch_tc(const MlpParams& p, const MlpTc& t, size_t bytes, cudaStream_t stream) {
  cudaError_t e = cudaSuccess;
  if (bytes > 48 * 1024 &&
      (e = cudaFuncSetAttribute(fused_mlp_tc_kernel<NT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)) !=
          cudaSuccess)
    return e;
  // as many blocks as are resident at once, each walking 16-row tiles
  int most = 0;
  if ((e = resident_blocks(fused_mlp_tc_kernel<NT>, kTcThreads, bytes, &most)) != cudaSuccess)
    return e;
  const long long want = ((long long)(p.B + 15) / 16 + kTcWarps - 1) / kTcWarps;
  fused_mlp_tc_kernel<NT><<<(int)(want < most ? want : most), kTcThreads, bytes, stream>>>(p, t);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ngp_fused_mlp(const void* x, int x_bf16, int B, const void* const* weights,
                             const int* dims, int n_layers, float* out, int* route,
                             void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MlpTc t;
  size_t tc_bytes = 0;
  // route: the tensor-core instance's n-tiles, or 0 for the CUDA-core kernel
  const int nt = mlp_tc_route(p, x, &t, &tc_bytes);
  *route = nt;
  if (nt > 0) {
    if (B == 0) return cudaSuccess;
    return nt == 8 ? launch_tc<8>(p, t, tc_bytes, s) : launch_tc<16>(p, t, tc_bytes, s);
  }
  // every layer's weights and two activation buffers of kRows rows, or of
  // fewer (down to kRowsPerThread) where those do not fit; wider chains are
  // refused
  auto smem = [&](int rows) {
    return (p.w_floats + 2LL * rows * p.dmax) * (long long)sizeof(float);
  };
  p.rows = kRows;
  while (smem(p.rows) > kMaxSmemBytes && p.rows > kRowsPerThread) p.rows /= 2;
  const long long bytes = smem(p.rows);
  if (bytes > kMaxSmemBytes) return kUnsupportedShape;
  if (B == 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int blocks = (B + p.rows - 1) / p.rows;
  fused_mlp_kernel<<<blocks, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}
