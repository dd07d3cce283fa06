// Bias-free ReLU MLP chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ngp_tpu/ops/pallas/fused_mlp.py:fused_mlp:
//   ngp_fused_mlp      y = W_n . relu(... relu(W_0 . x)), [B, D_in] -> [B, D_out]
//                      f32, or bf16 (the last layer rounded as a bf16 MLP rounds it)
// and adds its backward, which the JAX package leaves to XLA:
//   ngp_fused_mlp_bwd  dW_l and dX of a bf16 chain from x and dY (below)
//
// x (f32 or bf16) and the f32 weights are rounded to bf16, every hidden layer is
// ReLU'd and rounded to bf16, and every product accumulates in f32, as the
// Pallas kernel does on the MXU. The TPU kernel padded every width to 128
// lanes for its tiling; here widths are padded to 16, the depth of one
// mma.sync k-step.
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
// rows (fewer for chains whose activations would not fit), copies every
// layer's weights into shared memory as f32, rounds its x rows to bf16 into
// shared memory and runs the layers back to back with the activations in
// shared memory, the products on the CUDA cores with a register tile of
// kRowsPerThread rows per weight read. mlp_tc_route decides the route from
// the shape before the launch; a chain neither kernel's shared memory holds
// is refused.
//
// The backward (fused_mlp_bwd_kernel, the tensor-core chains whose backward
// layout fits a block) returns what autograd of a bf16 MLP's chain of f32
// products and bf16 casts returns: the output cotangent as its bf16 values,
// dH_l = dY_l . W_l^T accumulated in f32, rounded to bf16 and masked where the
// layer's ReLU output is 0, dW_l = H_l^T . dY_l summed in f32 over the rows and
// rounded to bf16 at the end, dX rounded to bf16; only the order of the f32
// sums differs. It saves no activation: each warp recomputes its 16-row
// tile's forward from x as the forward kernel does, keeping every layer's
// input and output cotangent as bf16 tiles in shared memory, and the block's
// warps then sum dW over their tiles together, each warp owning whole 16 x 16
// fragments of it (so no two warps add into one sum: shared-memory float
// atomics are compare-and-swap loops on sm_90). A tile whose cotangent is all
// zero (the march's empty slots) adds nothing and has a zero dX: a scan skips
// it. Bound: at the hash step's 2,097,152 rows the 32-64-16 and 31-64-64-3
// chains move ~0.9 GB of x, dY, y and dX forward and backward (0.27 ms at
// 3.35 TB/s) for ~0.17 ms of products at the bf16 rate; the warps' serial
// chains of products and shared-memory round trips, at the 8-16 warps a
// block's shared memory lets an SM hold, are what it is short by (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
constexpr int kFragGroup = 4;          // dW fragments a warp of the backward sums together

struct MlpParams {
  const void* x;  // [B, dims[0]], f32 or bf16
  int x_bf16;
  int B;
  const float* w[kMaxLayers];  // [dims[l], dims[l + 1]] each, rounded to bf16 as staged
  int dims[kMaxLayers + 1];
  int n_layers;
  int w_floats;  // sum of dims[l] * dims[l + 1]
  int dmax;      // the widest layer
  int rows;      // rows per block of the CUDA-core kernel: kRows, or fewer
  void* out;     // [B, dims[n_layers]], f32 or bf16
  int out_bf16;  // y rounded to bf16, as a bf16 chain's last layer is
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

// element i of layer l's weights, rounded to bf16
__device__ __forceinline__ __nv_bfloat16 weight_bf16(const MlpParams& p, int l, size_t i) {
  return __float2bfloat16(p.w[l][i]);
}

// y[at] = v, in the output's type
__device__ __forceinline__ void store_out(const MlpParams& p, size_t at, float v) {
  if (p.out_bf16) {
    static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p.out)[at] = v;
  }
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
    for (int i = threadIdx.x; i < n; i += blockDim.x) ws[off + i] = __bfloat162float(weight_bf16(p, l, i));
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
    if (row < p.B) store_out(p, (size_t)row * dout + (i - m * dout), src[m * p.dmax + (i - m * dout)]);
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
  int span;                // x is 16-byte aligned: a full tile of bf16 x is one span of them
};

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// Vector v of a full 16-row tile's span of a [B, d] bf16 array (its 16 d
// values in a row, 2 d vectors of 8) to and from the tile's padded rows
// (row stride ld)
__device__ __forceinline__ void span_to_tile(uint4 u, int v, int d, __nv_bfloat16* tile,
                                             int ld) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  int m = (8 * v) / d, c = 8 * v - m * d;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t bits = w[k >> 1] >> (16 * (k & 1));
    tile[m * ld + c] = __ushort_as_bfloat16(static_cast<unsigned short>(bits));
    if (++c == d) c = 0, ++m;
  }
}

__device__ __forceinline__ uint4 tile_to_span(const __nv_bfloat16* tile, int ld, int v, int d) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  int m = (8 * v) / d, c = 8 * v - m * d;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(tile[m * ld + c])) << (16 * (k & 1));
    if (++c == d) c = 0, ++m;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

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
    } else if (t.span && row0 + 16 <= p.B) {
      // the tile's 16 rows are 16 d0 values in a row: 2 d0 vectors of 8
      const uint4* s = reinterpret_cast<const uint4*>(x + (size_t)row0 * d0);
      for (int v = lane; v < 2 * d0; v += 32) span_to_tile(__ldg(s + v), v, d0, xt, t.ldx);
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
          (k < K && n < N) ? weight_bf16(p, l, (size_t)k * N + n) : __float2bfloat16(0.f);
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
          const size_t at = (size_t)row * dout + col;
          if ((dout & 1) == 0 && p.out_bf16) {
            *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out) + at) =
                pack_bf16x2(acc[j][2 * h], acc[j][2 * h + 1]);
          } else if ((dout & 1) == 0) {
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
          } else {
            store_out(p, at, acc[j][2 * h]);
            if (col + 1 < dout) store_out(p, at + 1, acc[j][2 * h + 1]);
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
  t->span = (uintptr_t)x % 16 == 0;
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


// ---------------------------------------------------------------------------
// the tensor-core chain's backward
// ---------------------------------------------------------------------------

// The backward's shared-memory layout beside the forward's weights (t.w_at):
// the weights again, transposed, in fragment order (the B operand of
// dH = dY . W^T); the block's f32 dW sums, 256 per 16 x 16 fragment of a
// layer's dW (8 accumulators of 32 lanes: two m16n8 C tiles); the scan's
// masks and list of live tiles; per warp its tile of every layer's input
// H_l (16 rows, bf16, row stride ld[l]) and of every layer's output
// cotangent dY_l (row stride ld_dy[l]).
struct MlpBwd {
  const __nv_bfloat16* g;  // [B, dims[n_layers]], the output's cotangent
  __nv_bfloat16* dx;       // [B, dims[0]], or null where x needs no gradient
  float* dw;               // every layer's [dims[l], dims[l + 1]], one after another
  int dw_at[kMaxLayers];   // layer l's first float in dw
  int wt_at[kMaxLayers];   // layer l's transposed weights: first uint2 in shared memory
  int frag_at[kMaxLayers + 1];  // layer l's first 16 x 16 dW fragment; [n_layers]: all
  int acc_bytes;           // byte offset of the f32 dW sums
  int list_bytes;          // byte offset of the scan's masks (warps) and list (32 warps)
  int tiles_at;            // byte offset of the warps' tiles
  int warp_bytes;          // one warp's tiles
  int h_at[kMaxLayers];    // H_l's tile: first bf16 in a warp's tiles
  int ld[kMaxLayers];      // its row stride, bf16: kp[l] + 8
  int dy_at[kMaxLayers];   // dY_l's tile
  int ld_dy[kMaxLayers];   // its row stride: kp[l + 1] + 8
  int g_span, dx_span;     // g's, dx's full tiles are 16-byte aligned spans
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// the bf16 pair d where the pair h (a ReLU's output) is > 0, else 0: the
// cotangent through the ReLU, as autograd's threshold_backward gives it
__device__ __forceinline__ uint32_t relu_mask(uint32_t d, uint32_t h) {
  const uint32_t lo = ((h & 0xffffu) - 1u) < 0x7fffu ? 0x0000ffffu : 0u;
  const uint32_t hi = (((h >> 16) & 0xffffu) - 1u) < 0x7fffu ? 0xffff0000u : 0u;
  return d & (lo | hi);
}

// whether rows row0.. (16, or fewer at B) of a [B, d] bf16 array hold a
// nonzero value (-0 counts as 0), read by one thread
__device__ __forceinline__ bool rows_nonzero(const __nv_bfloat16* src, int B, int d, int span,
                                             int row0) {
  uint32_t any = 0;
  if (span && row0 + 16 <= B) {
    const uint4* s = reinterpret_cast<const uint4*>(src + (size_t)row0 * d);
#pragma unroll 4
    for (int v = 0; v < 2 * d; ++v) {
      const uint4 u = __ldg(s + v);
      any |= (u.x | u.y | u.z | u.w) & 0x7fff7fffu;
    }
  } else {
    const int n = (B - row0 < 16 ? B - row0 : 16) * d;
    for (int i = 0; i < n; ++i)
      any |= static_cast<uint32_t>(__bfloat16_as_ushort(src[(size_t)row0 * d + i])) & 0x7fffu;
  }
  return any != 0u;
}

// zeros into rows row0.. (16, or fewer at B) of a [B, d] bf16 array
__device__ __forceinline__ void zero_rows(__nv_bfloat16* dst, int B, int d, int span, int row0,
                                          int lane) {
  if (span && row0 + 16 <= B) {
    uint4* s = reinterpret_cast<uint4*>(dst + (size_t)row0 * d);
    for (int v = lane; v < 2 * d; v += 32) s[v] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    const int n = (B - row0 < 16 ? B - row0 : 16) * d;
    for (int i = lane; i < n; i += 32) dst[(size_t)row0 * d + i] = __float2bfloat16(0.f);
  }
}

// the A fragments of a 16-row tile in shared memory (row stride ld), k-steps
// below ks_n; zero above
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const __nv_bfloat16* tile, int ld,
                                       int ks_n, int g, int tq) {
  const __nv_bfloat16* lo = tile + g * ld + 2 * tq;
  const __nv_bfloat16* hi = lo + 8 * ld;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bool in = ks < ks_n;
    a[ks][0] = in ? lds32(lo + 16 * ks) : 0u;
    a[ks][1] = in ? lds32(hi + 16 * ks) : 0u;
    a[ks][2] = in ? lds32(lo + 16 * ks + 8) : 0u;
    a[ks][3] = in ? lds32(hi + 16 * ks + 8) : 0u;
  }
}

// the A fragments a (k-steps below ks_n) back into a 16-row tile
template <int KS>
__device__ __forceinline__ void store_a(uint32_t (*a)[4], __nv_bfloat16* tile, int ld,
                                        int ks_n, int g, int tq) {
  __nv_bfloat16* lo = tile + g * ld + 2 * tq;
  __nv_bfloat16* hi = lo + 8 * ld;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks < ks_n) {
      *reinterpret_cast<uint32_t*>(lo + 16 * ks) = a[ks][0];
      *reinterpret_cast<uint32_t*>(hi + 16 * ks) = a[ks][1];
      *reinterpret_cast<uint32_t*>(lo + 16 * ks + 8) = a[ks][2];
      *reinterpret_cast<uint32_t*>(hi + 16 * ks + 8) = a[ks][3];
    }
  }
}

// acc[j] (n-tiles below nt_n) = a . B, B in fragment order at w (this lane's
// uint2 of (k-step 0, n-tile 0)), k-steps below ks_n
template <int NT>
__device__ __forceinline__ void product(float (*acc)[4], uint32_t (*a)[4], const uint2* w,
                                        int ks_n, int nt_n) {
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
}

// n-tiles 2 ks and 2 ks + 1 of acc as k-step ks of a bf16 A operand
// (rounded; ReLU'd first where relu)
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (*a)[4], float (*acc)[4], bool relu) {
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* c = acc[2 * ks + h];
      a[ks][2 * h] = relu ? pack_bf16x2(fmaxf(c[0], 0.f), fmaxf(c[1], 0.f))
                          : pack_bf16x2(c[0], c[1]);
      a[ks][2 * h + 1] = relu ? pack_bf16x2(fmaxf(c[2], 0.f), fmaxf(c[3], 0.f))
                              : pack_bf16x2(c[2], c[3]);
    }
  }
}

// Persistent blocks of W warps, each over a contiguous run of 16-row tiles,
// 32 W tiles at a time:
//  1. scan: each warp tests 32 of them for a nonzero output cotangent g; a
//     tile whose g is all zero adds nothing to dW and has a zero dX, which
//     is written there; the live tiles go into a list in tile order;
//  2. W live tiles at a time, one a warp: g into the dY_{L-1} tile; the
//     forward again from x as the forward kernel runs it, each layer's
//     input kept in its H_l tile; from the last layer down dH = dY_l . W_l^T
//     in f32, rounded to bf16 and masked where H_l is 0: dY_{l-1}, kept as
//     A fragments and in its tile; at layer 0 dH is dX, kept in registers;
//  3. after a barrier each warp owns every W-th 16 x 16 fragment of the
//     layers' dW and adds H_l^T . dY_l over the W tiles into its f32 sums in
//     shared memory (two m16n8k16 products a tile, A and B by ldmatrix.trans
//     from the H_l and dY_l tiles): no two warps add into one sum;
//  4. after a second barrier each warp writes its dX through its H_0 tile,
//     as whole 16-byte vectors.
// At the end each block adds its f32 sums into dw, one atomic add per
// nonzero element.
template <int NT>
__global__ void __launch_bounds__(kTcThreads, 1) fused_mlp_bwd_kernel(MlpParams p, MlpTc t,
                                                                      MlpBwd b) {
  extern __shared__ uint4 smem_tc[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_tc);
  __nv_bfloat16* wsh = reinterpret_cast<__nv_bfloat16*>(base);
  float* acc_sh = reinterpret_cast<float*>(base + b.acc_bytes);
  const int W = blockDim.x >> 5;
  uint32_t* masks = reinterpret_cast<uint32_t*>(base + b.list_bytes);
  int* list = reinterpret_cast<int*>(masks + W);
  const int L = p.n_layers;
  for (int l = 0; l < L; ++l) {
    const int K = p.dims[l], N = p.dims[l + 1], kp = t.kp[l], np = t.kp[l + 1];
    __nv_bfloat16* fwd = wsh + 4 * t.w_at[l];
    __nv_bfloat16* bwd = wsh + 4 * b.wt_at[l];
#pragma unroll 4
    for (int i = threadIdx.x; i < kp * np; i += blockDim.x) {
      const int k = i / np, n = i - k * np;
      const __nv_bfloat16 v =
          (k < K && n < N) ? weight_bf16(p, l, (size_t)k * N + n) : __float2bfloat16(0.f);
      fwd[frag_slot(k, n, np >> 3)] = v;
      bwd[frag_slot(n, k, kp >> 3)] = v;
    }
  }
  for (int i = threadIdx.x; i < 256 * b.frag_at[L]; i += blockDim.x) acc_sh[i] = 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(base + b.tiles_at);
  __nv_bfloat16* mine = tiles + (size_t)warp * (b.warp_bytes / 2);
  // the padding columns of the H_0 and dY_{L-1} tiles stay zero: the loads
  // write the columns below dims[0] and dims[L] only
  __nv_bfloat16* x_tile = mine + b.h_at[0];
  __nv_bfloat16* g_tile = mine + b.dy_at[L - 1];
  for (int i = lane; i < 16 * t.kp[0]; i += 32) x_tile[(i / t.kp[0]) * b.ld[0] + i % t.kp[0]] =
      __float2bfloat16(0.f);
  for (int i = lane; i < 16 * t.kp[L]; i += 32) g_tile[(i / t.kp[L]) * b.ld_dy[L - 1] +
                                                       i % t.kp[L]] = __float2bfloat16(0.f);
  __syncthreads();
  const int tiles_n = (p.B + 15) >> 4;
  const int per_block = (tiles_n + gridDim.x - 1) / gridDim.x;
  const int first = blockIdx.x * per_block;
  const int last = min(first + per_block, tiles_n);
  const int d0 = p.dims[0], dout = p.dims[L];
  // ldmatrix rows: A of H^T (m-tile mt), B of dY (n-tiles 2q, 2q + 1)
  const int a_row = (lane & 7) + ((lane >> 4) << 3), a_col = ((lane >> 3) & 1) << 3;
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_col = (lane >> 4) << 3;
  for (int batch = first; batch < last; batch += 32 * W) {
    // 1. the scan: a tile a lane, then the dead tiles' dX by the warp
    const int mine0 = batch + 32 * warp;
    const bool nz = mine0 + lane < last && rows_nonzero(b.g, p.B, dout, b.g_span,
                                                        (mine0 + lane) << 4);
    const uint32_t live = __ballot_sync(0xffffffffu, nz);
    if (b.dx != nullptr) {
      for (int i = 0; i < 32 && mine0 + i < last; ++i)
        if (!(live >> i & 1u)) zero_rows(b.dx, p.B, d0, b.dx_span, (mine0 + i) << 4, lane);
    }
    if (lane == 0) masks[warp] = live;
    __syncthreads();
    int n_live = 0;
    for (int w = 0; w < W; ++w) {
      const uint32_t m = masks[w];
      if (warp == 0 && (m >> lane & 1u))
        list[n_live + __popc(m & ((1u << lane) - 1u))] = batch + 32 * w + lane;
      n_live += __popc(m);
    }
    __syncthreads();
    for (int j0 = 0; j0 < n_live; j0 += W) {
      // 2. each warp's live tile: the forward again, then dY_l and dX
      const int n_here = min(W, n_live - j0);
      uint32_t dxa[NT / 2][4];
      const bool busy = warp < n_here;
      int row0 = 0;
      if (busy) {
        row0 = list[j0 + warp] << 4;
        load_x_tile(p, t, row0, x_tile, lane);
        {
          const __nv_bfloat16* src = b.g;
          if (b.g_span && row0 + 16 <= p.B) {
            const uint4* s = reinterpret_cast<const uint4*>(src + (size_t)row0 * dout);
            for (int v = lane; v < 2 * dout; v += 32)
              span_to_tile(__ldg(s + v), v, dout, g_tile, b.ld_dy[L - 1]);
          } else {
            for (int i = lane; i < 16 * dout; i += 32) {
              const int m = i / dout, c = i - m * dout;
              g_tile[m * b.ld_dy[L - 1] + c] =
                  row0 + m < p.B ? src[(size_t)(row0 + m) * dout + c] : __float2bfloat16(0.f);
            }
          }
        }
        __syncwarp();
        uint32_t a[NT / 2][4];
        load_a<NT / 2>(a, x_tile, b.ld[0], t.kp[0] >> 4, g, tq);
#pragma unroll 1
        for (int l = 0; l + 1 < L; ++l) {
          float acc[NT][4];
          product<NT>(acc, a, reinterpret_cast<const uint2*>(wsh) + t.w_at[l] + lane,
                      t.kp[l] >> 4, t.kp[l + 1] >> 3);
          acc_to_a<NT>(a, acc, true);
          store_a<NT / 2>(a, mine + b.h_at[l + 1], b.ld[l + 1], t.kp[l + 1] >> 4, g, tq);
        }
        __syncwarp();
        load_a<NT / 2>(a, g_tile, b.ld_dy[L - 1], t.kp[L] >> 4, g, tq);
#pragma unroll 1
        for (int l = L - 1; l >= 0; --l) {
          if (l == 0 && b.dx == nullptr) break;
          float acc[NT][4];
          product<NT>(acc, a, reinterpret_cast<const uint2*>(wsh) + b.wt_at[l] + lane,
                      t.kp[l + 1] >> 4, t.kp[l] >> 3);
          acc_to_a<NT>(a, acc, false);
          if (l == 0) break;
          const int ks_n = t.kp[l] >> 4;
          const __nv_bfloat16* lo = mine + b.h_at[l] + g * b.ld[l] + 2 * tq;
          const __nv_bfloat16* hi = lo + 8 * b.ld[l];
#pragma unroll
          for (int ks = 0; ks < NT / 2; ++ks) {
            if (ks < ks_n) {
              a[ks][0] = relu_mask(a[ks][0], lds32(lo + 16 * ks));
              a[ks][1] = relu_mask(a[ks][1], lds32(hi + 16 * ks));
              a[ks][2] = relu_mask(a[ks][2], lds32(lo + 16 * ks + 8));
              a[ks][3] = relu_mask(a[ks][3], lds32(hi + 16 * ks + 8));
            }
          }
          store_a<NT / 2>(a, mine + b.dy_at[l - 1], b.ld_dy[l - 1], ks_n, g, tq);
        }
#pragma unroll
        for (int ks = 0; ks < NT / 2; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) dxa[ks][e] = a[ks][e];
      }
      __syncthreads();
      // 3. dW: this warp's fragments over the n_here tiles, kFragGroup at a
      // time (independent products to interleave)
      for (int f0 = warp; f0 < b.frag_at[L]; f0 += kFragGroup * W) {
        float c[kFragGroup][8];
        const __nv_bfloat16* h[kFragGroup];
        const __nv_bfloat16* dy[kFragGroup];
#pragma unroll
        for (int u = 0; u < kFragGroup; ++u) {
          const int f = min(f0 + u * W, b.frag_at[L] - 1);  // a repeat past the end is not stored
          int l = 0;
          while (f >= b.frag_at[l + 1]) ++l;
          const int q_n = t.kp[l + 1] >> 4;
          const int mt = (f - b.frag_at[l]) / q_n, q = f - b.frag_at[l] - mt * q_n;
#pragma unroll
          for (int e = 0; e < 8; ++e) c[u][e] = acc_sh[256 * f + 32 * e + lane];
          h[u] = tiles + b.h_at[l] + a_row * b.ld[l] + 16 * mt + a_col;
          dy[u] = tiles + b.dy_at[l] + b_row * b.ld_dy[l] + 16 * q + b_col;
        }
        for (int k = 0; k < n_here; ++k) {
          const size_t off = (size_t)k * (b.warp_bytes / 2);
          uint32_t ah[kFragGroup][4], bq[kFragGroup][4];
#pragma unroll
          for (int u = 0; u < kFragGroup; ++u) {
            ldsm_x4_trans(ah[u], h[u] + off);
            ldsm_x4_trans(bq[u], dy[u] + off);
          }
#pragma unroll
          for (int u = 0; u < kFragGroup; ++u) {
            mma_bf16(c[u], ah[u][0], ah[u][1], ah[u][2], ah[u][3], bq[u][0], bq[u][1]);
            mma_bf16(c[u] + 4, ah[u][0], ah[u][1], ah[u][2], ah[u][3], bq[u][2], bq[u][3]);
          }
        }
#pragma unroll
        for (int u = 0; u < kFragGroup; ++u) {
          const int f = f0 + u * W;
          if (f < b.frag_at[L]) {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc_sh[256 * f + 32 * e + lane] = c[u][e];
          }
        }
      }
      __syncthreads();
      // 4. dX through the H_0 tile (its padding columns get the weights'
      // zero padding rows' products: zero)
      if (busy && b.dx != nullptr) {
        store_a<NT / 2>(dxa, x_tile, b.ld[0], t.kp[0] >> 4, g, tq);
        __syncwarp();
        if (b.dx_span && row0 + 16 <= p.B) {
          uint4* s = reinterpret_cast<uint4*>(b.dx + (size_t)row0 * d0);
          for (int v = lane; v < 2 * d0; v += 32) s[v] = tile_to_span(x_tile, b.ld[0], v, d0);
        } else {
          for (int i = lane; i < 16 * d0; i += 32) {
            const int m = i / d0, cc = i - m * d0;
            if (row0 + m < p.B) b.dx[(size_t)(row0 + m) * d0 + cc] = x_tile[m * b.ld[0] + cc];
          }
        }
        __syncwarp();  // the next tile's x load overwrites the tile
      }
    }
  }
  __syncthreads();
  // the block's sums into dw: element (k, n) of layer l is accumulator
  // e = 4 s + 2 (k % 16 / 8) + n % 2 (s = n % 16 / 8) of lane
  // 4 (k % 8) + (n % 8) / 2 in fragment (k / 16, n / 16)
  for (int l = 0; l < L; ++l) {
    const int K = p.dims[l], N = p.dims[l + 1], q_n = t.kp[l + 1] >> 4;
    for (int i = threadIdx.x; i < K * N; i += blockDim.x) {
      const int k = i / N, n = i - k * N;
      const int kk = k & 15, nn = n & 15;
      const int f = b.frag_at[l] + (k >> 4) * q_n + (n >> 4);
      const int e = 4 * (nn >> 3) + 2 * (kk >> 3) + (nn & 1);
      const float v = acc_sh[256 * f + 32 * e + 4 * (kk & 7) + ((nn & 7) >> 1)];
      if (v != 0.f) atomicAdd(b.dw + b.dw_at[l] + i, v);
    }
  }
}

// dw rounded to bf16 in place (autograd's cast of the weights' gradient to
// the bf16 weights' type and back)
__global__ void round_bf16_kernel(float* v, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    v[i] = round_bf16(v[i]);
}

// The backward's layout (t from mlp_tc_route) and shared memory for blocks of
// `warps` warps. The Python route rule (fused_mlp.bwd_smem_bytes) computes
// the same bytes.
size_t mlp_bwd_layout(const MlpParams& p, const MlpTc& t, int warps, MlpBwd* b) {
  const int L = p.n_layers;
  int at = t.x_at / 8;  // uint2 after the forward's weights
  int frags = 0, dw = 0, tile = 0;
  for (int l = 0; l < L; ++l) {
    b->wt_at[l] = at;
    at += t.kp[l] * t.kp[l + 1] / 4;
    b->frag_at[l] = frags;
    frags += (t.kp[l] >> 4) * (t.kp[l + 1] >> 4);
    b->dw_at[l] = dw;
    dw += p.dims[l] * p.dims[l + 1];
    b->h_at[l] = tile;
    b->ld[l] = t.kp[l] + 8;
    tile += 16 * b->ld[l];
    b->dy_at[l] = tile;
    b->ld_dy[l] = t.kp[l + 1] + 8;
    tile += 16 * b->ld_dy[l];
  }
  b->frag_at[L] = frags;
  b->acc_bytes = 8 * at;
  b->list_bytes = b->acc_bytes + 4 * 256 * frags;
  b->tiles_at = b->list_bytes + ((4 * 33 * warps + 15) & ~15);
  b->warp_bytes = 2 * tile;
  return (size_t)b->tiles_at + (size_t)warps * b->warp_bytes;
}

// the backward kernel's shared-memory limit raised to a block's most, once
// a device (the attribute call costs more host time than the launch)
template <int NT>
cudaError_t bwd_smem_limit() {
  constexpr int kDevices = 64;
  static std::atomic<bool> raised[kDevices];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess || (device < kDevices && raised[device].load())) return e;
  e = cudaFuncSetAttribute(fused_mlp_bwd_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmemBytes);
  if (e == cudaSuccess && device < kDevices) raised[device].store(true);
  return e;
}

template <int NT>
int launch_bwd(const MlpParams& p, const MlpTc& t, MlpBwd* b, cudaStream_t stream) {
  cudaError_t e = bwd_smem_limit<NT>();
  if (e != cudaSuccess) return e;
  // blocks of 8, 4, 2 or 1 warps, whichever keeps the most warps resident
  // (the fewer a block on a tie: its barriers wait on fewer warps)
  int best_warps = 0, best_blocks = 0;
  size_t best_bytes = 0;
  for (int warps = kTcWarps; warps >= 1; warps /= 2) {
    MlpBwd trial = *b;
    const size_t bytes = mlp_bwd_layout(p, t, warps, &trial);
    if (bytes > (size_t)kMaxSmemBytes) continue;
    int blocks = 0;
    if ((e = resident_blocks(fused_mlp_bwd_kernel<NT>, 32 * warps, bytes, &blocks)) !=
        cudaSuccess)
      return e;
    if (best_warps == 0 || blocks * warps >= best_blocks * best_warps) {
      best_warps = warps, best_blocks = blocks, best_bytes = bytes;
    }
  }
  if (best_warps == 0) return kUnsupportedShape;
  mlp_bwd_layout(p, t, best_warps, b);
  const long long tiles = (p.B + 15) / 16;
  const int grid = (int)(tiles < best_blocks ? tiles : best_blocks);
  fused_mlp_bwd_kernel<NT><<<grid, 32 * best_warps, best_bytes, stream>>>(p, t, *b);
  return cudaGetLastError();
}

// the chain's parameters from the C arguments; false on a bad argument
bool mlp_params(MlpParams* p, const void* x, int x_bf16, int B, const float* const* weights,
                const int* dims, int n_layers) {
  if (n_layers < 1 || n_layers > kMaxLayers || B < 0) return false;
  p->x = x;
  p->x_bf16 = x_bf16;
  p->B = B;
  p->n_layers = n_layers;
  p->w_floats = 0;
  p->dmax = 0;
  p->out = nullptr;
  p->out_bf16 = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return false;
    p->dims[l] = dims[l];
    p->dmax = dims[l] > p->dmax ? dims[l] : p->dmax;
  }
  for (int l = 0; l < n_layers; ++l) {
    p->w[l] = weights[l];
    p->w_floats += dims[l] * dims[l + 1];
  }
  return true;
}

}  // namespace

extern "C" int ngp_fused_mlp(const void* x, int x_bf16, int B, const float* const* weights,
                             const int* dims, int n_layers, void* out, int out_bf16, int* route,
                             void* stream) {
  MlpParams p;
  if (!mlp_params(&p, x, x_bf16, B, weights, dims, n_layers))
    return cudaErrorInvalidValue;
  p.out = out;
  p.out_bf16 = out_bf16;
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

// The backward of a bf16 chain on the tensor cores, from its input x (bf16),
// its weights and its output's cotangent g (bf16, [B, dims[n_layers]]):
// dw (f32, every layer's [dims[l], dims[l + 1]] one after another, filled
// here) and, where dx is not null, dx (bf16, [B, dims[0]]). Returns
// kUnsupportedShape for a chain the backward's shared memory does not hold.
extern "C" int ngp_fused_mlp_bwd(const void* x, int B, const float* const* weights,
                                 const int* dims, int n_layers, const void* g, void* dx,
                                 float* dw, void* stream) {
  MlpParams p;
  if (!mlp_params(&p, x, 1, B, weights, dims, n_layers)) return cudaErrorInvalidValue;
  MlpTc t;
  size_t fwd_bytes = 0;
  const int nt = mlp_tc_route(p, x, &t, &fwd_bytes);
  MlpBwd b;
  if (nt == 0 || mlp_bwd_layout(p, t, 1, &b) > (size_t)kMaxSmemBytes) return kUnsupportedShape;
  b.g = static_cast<const __nv_bfloat16*>(g);
  b.dx = static_cast<__nv_bfloat16*>(dx);
  b.dw = dw;
  b.g_span = (uintptr_t)g % 16 == 0;
  b.dx_span = (uintptr_t)dx % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(dw, 0, sizeof(float) * (size_t)p.w_floats, s);
  if (e != cudaSuccess || B == 0) return e;
  const int r = nt == 8 ? launch_bwd<8>(p, t, &b, s) : launch_bwd<16>(p, t, &b, s);
  if (r != cudaSuccess) return r;
  round_bf16_kernel<<<(p.w_floats + 255) / 256, 256, 0, s>>>(dw, p.w_floats);
  return cudaGetLastError();
}
