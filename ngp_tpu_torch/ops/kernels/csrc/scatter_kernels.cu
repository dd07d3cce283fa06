// Scatter-adds for Hopper (sm_90a): rows into a table, and bilinear taps into
// a factor.
//
// 1. scatter_add_rows: out[idx[m], :] += rows[m, :]. Replaces
// scripts/perf_probe2_r2.py:scatter_pallas, the TPU kernel that computes
// zeros[R, W].at[idx].add(rows) with a serial row loop into an accumulator
// held in VMEM across the whole grid; the brick grid's table gradient is this
// function (ops/brickgrid.py, GatherRows). Hopper runs blocks in parallel and
// in no order, so the sum goes to f32 atomics into `out`. What bounds it is
// reading the rows once (0.32 ms at the probe's 2,097,152 x 128 at 3.35 TB/s);
// what it meets first is the L2's atomic rate, so each branch issues as few
// atomics as it can:
//   - rows of W % 4 == 0 floats, 16-byte aligned, W <= 256 (the brick grid's
//     108, the probe's 128): a persistent grid, about as many blocks as the
//     SMs hold; each block stages tiles of T rows into shared memory by
//     cp.async, double-buffered (the next tile's copy runs while the current
//     one is added), sorts the tile's indices (a rank sort: T <= 64 keys),
//     sums each run of equal indices per float4 column in shared memory and
//     issues one vector reduction (red.global.add.v4.f32) per distinct
//     (index, column), none for a float4 that sums to exactly zero (the brick
//     rows carry a non-zero cotangent in 8 of their 27 float4s);
//   - anything else: a thread per row (W <= 4) or a warp per row, one atomic
//     per float4, float2 or float that is not zero.
// Indices outside [0, R) add nothing, as XLA's scatter drops them.
//
// 2. scatter_add_taps: d factor[r, cell_t(n)] += g[r, n] * w_t(n) over the 2
// taps (1-D line [R, D], coords u [N]) or 4 taps (2-D plane [R, H, W], coords
// (u, v)) of each sample: the gradient that XLA's VJP of jnp.take gives in
// ngp_tpu/ops/interp.py:sample_1d / sample_2d (:39, :62), which no Pallas
// kernel computes. The kernel makes each sample's cells and weights itself,
// with the roundings of ops/interp.py's forward (every product and sum
// rounded on its own, no fused multiply-add), so a sample on a cell edge adds
// into the cell the forward read. A block takes a tile of 128 samples; its
// threads write each sample's taps to shared memory once and mark, per tap,
// the runs of consecutive samples that hit one cell (the samples of a ray, and
// the compaction's padded slots, which all sit at one point); then each warp
// walks a row r of g (coalesced: lanes on consecutive samples), sums each run
// by a segmented scan across the lanes (carried from one 32-sample chunk to
// the next) and issues one f32 atomic per run. Rows R of 4 to 288 (CCNeRF's
// rank groups, TensoRF's ranks): when R is under 8 the warps also split the
// tile. Out-of-grid taps add nothing. Bound: reading g and the coords once and
// writing d factor once.
//
// Atomics sum in no fixed order, so both results vary in the last f32 bits
// from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900) && (CUDART_VERSION >= 12010)
#define NGP_VECTOR_ATOMICS 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 64;
constexpr int kTiledMaxW = 256;
constexpr int kKeyNone = 0x7fffffff;
constexpr int kTapTile = 128;

__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
}

__device__ __forceinline__ void add2(float* dst, float2 v) {
  if (v.x == 0.f && v.y == 0.f) return;
#ifdef NGP_VECTOR_ATOMICS
  atomicAdd(reinterpret_cast<float2*>(dst), v);
#else
  atomicAdd(dst, v.x);
  atomicAdd(dst + 1, v.y);
#endif
}

__device__ __forceinline__ void add4(float* dst, float4 v) {
  if (!nonzero(v)) return;
#ifdef NGP_VECTOR_ATOMICS
  atomicAdd(reinterpret_cast<float4*>(dst), v);
#else
  atomicAdd(dst, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
#endif
}

__device__ __forceinline__ void add1(float* dst, float v) {
  if (v != 0.f) atomicAdd(dst, v);
}

// ---------------------------------------------------------------------------
// the per-row branch: one thread per row (W <= 4); vec: 2 or 4 when the row is
// one aligned vector
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
      for (int c = 0; c < W; ++c) add1(dst + c, __ldg(src + c));
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
      for (int c = lane; c < W; c += 32) add1(dst + c, __ldg(src + c));
    }
  }
}

// ---------------------------------------------------------------------------
// the tiled branch
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// T rows a tile (a multiple of 32, at most kThreads); dynamic shared memory:
// two tiles of T x W floats
template <int T>
__global__ void __launch_bounds__(kThreads)
scatter_rows_tiled(const int* __restrict__ idx, const float* __restrict__ rows, long long M,
                   int W, int R, float* __restrict__ out) {
  extern __shared__ float4 tiles[];
  __shared__ int keys[2][T];
  __shared__ int sorted_key[T];
  __shared__ int order[T];
  __shared__ int seg_start[T + 1];
  __shared__ int nseg_s;
  const int tid = threadIdx.x, ncol = W >> 2;
  const long long ntiles = (M + T - 1) / T;

  // copy tile t's rows into buffer b (cp.async) and its indices into keys[b]
  auto issue = [&](long long t, int b) {
    const long long m0 = t * T;
    const int nrows = (int)min((long long)T, M - m0);
    const float4* src = reinterpret_cast<const float4*>(rows + m0 * W);
    float4* dst = tiles + b * T * ncol;
    for (int i = tid; i < nrows * ncol; i += kThreads) cp_async16(dst + i, src + i);
    cp_async_commit();
    if (tid < T) {
      int k = kKeyNone;
      if (tid < nrows) {
        const int r = __ldg(idx + m0 + tid);
        if (r >= 0 && r < R) k = r;
      }
      keys[b][tid] = k;
    }
  };

  long long t = blockIdx.x;
  int b = 0;
  if (t < ntiles) issue(t, 0);
  for (; t < ntiles; t += gridDim.x, b ^= 1) {
    const long long next = t + gridDim.x;
    if (next < ntiles) {
      issue(next, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // a stable rank sort of the tile's keys; dropped rows (kKeyNone) go last
    if (tid < T) {
      const int k = keys[b][tid];
      int rank = 0;
      for (int j = 0; j < T; ++j) {
        const int kj = keys[b][j];
        rank += (kj < k) || (kj == k && j < tid);
      }
      sorted_key[rank] = k;
      order[rank] = tid;
    }
    __syncthreads();
    // the runs of equal keys: their starts, in sorted order
    if (tid < 32) {
      int nseg = 0, nvalid = 0;
      for (int p0 = 0; p0 < T; p0 += 32) {
        const int p = p0 + tid;
        const int k = sorted_key[p];
        const bool valid = k != kKeyNone;
        const bool head = valid && (p == 0 || sorted_key[p - 1] != k);
        const unsigned hm = __ballot_sync(0xffffffffu, head);
        if (head) seg_start[nseg + __popc(hm & ((1u << tid) - 1u))] = p;
        nseg += __popc(hm);
        nvalid += __popc(__ballot_sync(0xffffffffu, valid));
      }
      if (tid == 0) {
        nseg_s = nseg;
        seg_start[nseg] = nvalid;
      }
    }
    __syncthreads();
    // one vector reduction per (run, float4 column) that is not zero
    const float4* cur = tiles + b * T * ncol;
    const int items = nseg_s * ncol;
    for (int it = tid; it < items; it += kThreads) {
      const int s = it / ncol, c = it - s * ncol;
      int p = seg_start[s];
      const int end = seg_start[s + 1];
      const int k = sorted_key[p];
      float4 acc = cur[order[p] * ncol + c];
      for (++p; p < end; ++p) {
        const float4 v = cur[order[p] * ncol + c];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      add4(out + (size_t)k * W + 4 * c, acc);
    }
    __syncthreads();  // buffer b and the sort's arrays are free again
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <int T>
int launch_tiled(const int* idx, const float* rows, long long M, int W, int R, float* out,
                 cudaStream_t s) {
  const size_t smem = 2 * (size_t)T * W * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(scatter_rows_tiled<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_rows_tiled<T>, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long ntiles = (M + T - 1) / T;
  long long blocks = (long long)sm_count() * per_sm;
  if (blocks > ntiles) blocks = ntiles;
  scatter_rows_tiled<T><<<(int)blocks, kThreads, smem, s>>>(idx, rows, M, W, R, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the taps

// ops/kernels/scatter.py:_to_pixel, each operation rounded on its own
__device__ __forceinline__ float to_pixel(float u, int size, int align) {
  const float h = __fmul_rn(__fadd_rn(u, 1.f), 0.5f);
  return align ? __fmul_rn(h, (float)(size - 1))
               : __fsub_rn(__fmul_rn(h, (float)size), 0.5f);
}

// the taps of one sample: flat cell (-1 outside the grid) and weight, in the
// forward's order; W = D and H = 1 for a line (v unused)
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

// S: the sub-ranges a tile is split into (1, 2 or 4; each a multiple of 32
// samples), so that R * S items keep a block's 8 warps busy
template <int TAPS>
__global__ void __launch_bounds__(kThreads)
scatter_taps_kernel(const float* __restrict__ g, int R, long long N,
                    const float* __restrict__ u, long long su, const float* __restrict__ v,
                    long long sv, int H, int W, int align, int S, float* __restrict__ out) {
  __shared__ int cell[TAPS][kTapTile];
  __shared__ float wt[TAPS][kTapTile];
  // per (tap, sample): bits 0-4 the lane where its run starts within its
  // 32-sample chunk, bit 5 the run starts here, bit 6 the run ends here
  __shared__ unsigned char meta[TAPS][kTapTile];
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * kTapTile;
  const int nt = (int)min((long long)kTapTile, N - n0);
  const int L = kTapTile / S;
  if (tid < kTapTile) {
    int c[TAPS];
    float w[TAPS];
    if (tid < nt) {
      const long long n = n0 + tid;
      sample_taps<TAPS>(__ldg(u + n * su), TAPS == 4 ? __ldg(v + n * sv) : 0.f, H, W, align, c,
                        w);
    } else {
#pragma unroll
      for (int j = 0; j < TAPS; ++j) {
        c[j] = -1;
        w[j] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      cell[j][tid] = c[j];
      wt[j][tid] = w[j];
    }
  }
  __syncthreads();
  if (tid < kTapTile) {
    const int c0 = tid & ~31;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const int cj = cell[j][tid];
      const bool head = tid % L == 0 || cell[j][tid - 1] != cj;
      const bool tail = tid + 1 >= nt || (tid + 1) % L == 0 || cell[j][tid + 1] != cj;
      int m = tid;
      while (m > c0 && cell[j][m - 1] == cj) --m;
      meta[j][tid] = (unsigned char)((m - c0) | (head << 5) | (tail << 6));
    }
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  const int cells = H * W;
  for (int item = warp; item < R * S; item += kThreads / 32) {
    const int r = item / S, sub = item - r * S;
    const float* grow = g + (size_t)r * N + n0;
    float* orow = out + (size_t)r * cells;
    float carry[TAPS];
#pragma unroll
    for (int j = 0; j < TAPS; ++j) carry[j] = 0.f;
    const int end = min((sub + 1) * L, nt);
    for (int base = sub * L; base < end; base += 32) {
      const int n = base + lane;
      const float gv = n < nt ? __ldg(grow + n) : 0.f;
#pragma unroll
      for (int j = 0; j < TAPS; ++j) {
        const int cj = cell[j][n];
        const unsigned mj = meta[j][n];
        float val = cj >= 0 ? __fmul_rn(gv, wt[j][n]) : 0.f;
        if (lane == 0 && !(mj & 32u)) val += carry[j];
        const int start = (int)(mj & 31u);
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, val, d);
          if (lane - d >= start) val += up;
        }
        carry[j] = __shfl_sync(0xffffffffu, val, 31);
        if ((mj & 64u) && cj >= 0 && val != 0.f) atomicAdd(orow + cj, val);
      }
    }
  }
}

}  // namespace

extern "C" int ngp_scatter_add_rows(const int* idx, const float* rows, long long M, int W, int R,
                                    float* out, void* stream) {
  if (M <= 0 || W <= 0 || R <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = (uintptr_t)rows | (uintptr_t)out;
  int vec = 1;
  if (W % 4 == 0 && align % 16 == 0) {
    vec = 4;
  } else if (W == 2 && align % 8 == 0) {
    vec = 2;
  }
  if (vec == 4 && W <= kTiledMaxW) {
    return W <= 128 ? launch_tiled<64>(idx, rows, M, W, R, out, s)
                    : launch_tiled<32>(idx, rows, M, W, R, out, s);
  }
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

// g [R, N] f32 contiguous; u (and v for a plane) f32 with strides su, sv in
// floats; a line when v is null (W = D, H = 1); out [R, H * W] f32 contiguous
extern "C" int ngp_scatter_add_taps(const float* g, int R, long long N, const float* u,
                                    long long su, const float* v, long long sv, int H, int W,
                                    int align, float* out, void* stream) {
  if (R <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int S = 1;
  while (R * S < kThreads / 32 && S < kTapTile / 32) S *= 2;
  const long long blocks = (N + kTapTile - 1) / kTapTile;
  if (v == nullptr) {
    scatter_taps_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(g, R, N, u, su, nullptr, 0, 1,
                                                                 W, align, S, out);
  } else {
    scatter_taps_kernel<4><<<(unsigned)blocks, kThreads, 0, s>>>(g, R, N, u, su, v, sv, H, W,
                                                                 align, S, out);
  }
  return cudaGetLastError();
}
