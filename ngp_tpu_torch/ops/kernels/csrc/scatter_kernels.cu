// Scatter-adds for Hopper (sm_90a): rows into a table, and bilinear taps into
// a factor.
//
// 1. scatter_add_rows: out[idx[m], :] += rows[m, :]. Replaces
// scripts/perf_probe2_r2.py:scatter_pallas, the TPU kernel that computes
// zeros[R, W].at[idx].add(rows) with a serial row loop into an accumulator
// held in VMEM across the whole grid; the brick grid's table gradient is this
// function (ops/brickgrid.py, BrickEncode). Hopper runs blocks in parallel and
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
// kernel computes. The kernel makes each sample's cells and weights by
// taps.cuh, which the forward (taps_kernels.cu) shares, so a sample on a cell
// edge adds into the cell the forward read. The d factor is held cell-major,
// as the factor (memory [H * W, R]; ops/kernels/scatter.py:cell_major), so a
// (sample, tap)'s R sums are contiguous. A block walks tiles of 64 samples in
// a grid-stride loop, the next tile's copies in flight while the current one
// is added: it stages the tile's g [rows, 64] in shared memory by coalesced
// 4-byte cp.async copies (rows 65 floats apart: no bank conflicts) and makes
// the tile's taps once. Then one of two accumulators:
//   - a line (ranks in slabs of at most 32 rows, D x rows <= 16,384 floats;
//     152 x 24 and 128 x 32 on the paths): a block-private accumulator in
//     shared memory. A thread per (tap, row, stretch of the tile's samples)
//     walks its samples and adds each run on one cell (a ray's samples, the
//     compaction's padded slots at one point) into it by one shared-memory
//     atomic; at the block's end one 16-byte reduction per non-zero float4.
//     The samples of many rays share a line's few cells, so global atomics
//     would queue on the same addresses. About 8 blocks an SM: the flushes
//     cost little beside the latency that more blocks hide;
//   - a plane (none on the paths fits a block: CCNeRF's smallest is 4 x
//     128^2): the tile's runs of samples on one cell listed per tap, then a
//     thread per (run, 4 rows) sums the run and adds the 4 sums by one
//     16-byte reduction (red.global.add.v4.f32, atomicAdd of a float4): R / 4
//     reductions a run, where a scalar atomic per row issues R; consecutive
//     threads take consecutive float4s of one cell.
// A plane's ranks above 96 are cut into slabs of rows too (gridDim.y); a rank
// that is not a multiple of 4 (or a d factor that is not 16-byte aligned)
// adds scalars.
// Out-of-grid taps add nothing. Bound: reading g and the coords once and
// writing d factor once.
//
// Atomics sum in no fixed order, so both results vary in the last f32 bits
// from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "taps.cuh"

#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900) && (CUDART_VERSION >= 12010)
#define NGP_VECTOR_ATOMICS 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 64;
constexpr int kTiledMaxW = 256;
constexpr int kKeyNone = 0x7fffffff;

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

constexpr int kTapTile = 64;                 // samples a tile
constexpr int kTapStride = kTapTile + 1;     // floats from one staged g row to the next
constexpr int kTapThreads = 256;
constexpr int kSlabRows = 96;                // the most factor rows a block takes
constexpr int kLineSlabRows = 32;            // ... on a line (a smaller accumulator)
constexpr int kAccFloats = 16384;            // the largest block-private accumulator
constexpr int kTapStage = 2 * kSlabRows * kTapStride;  // floats of the two g tiles
constexpr int kTapSmemMax = (kTapStage + kAccFloats) * (int)sizeof(float);

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// the positions p < n whose flag is set, in order, into out[0 ..]; their
// count into *count. Every thread of the block calls it (n <= kTapThreads);
// it ends on a barrier.
__device__ __forceinline__ void compact(bool flag, int n, unsigned* warp_bits,
                                        unsigned char* out, int* count) {
  const int tid = threadIdx.x, lane = tid & 31;
  const bool on = tid < n && flag;
  const unsigned bits = __ballot_sync(0xffffffffu, on);
  if (lane == 0) warp_bits[tid >> 5] = bits;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < (tid >> 5); ++w) base += __popc(warp_bits[w]);
  if (on) out[base + __popc(bits & ((1u << lane) - 1u))] = (unsigned char)tid;
  if (tid == kTapThreads - 1) *count = base + __popc(bits);
  __syncthreads();
}

// ACC: the block-private accumulator (lines); VEC: 4 where the rows add as
// float4s (R % 4 == 0, RS % 4 == 0 and a 16-byte aligned d factor), else 1.
// Block (x, y) takes the rows [y RS, y RS + RS) of every gridDim.x-th tile.
template <int TAPS, bool ACC, int VEC>
__global__ void __launch_bounds__(kTapThreads)
scatter_taps_kernel(const float* __restrict__ g, int R, long long N,
                    const float* __restrict__ u, long long su, const float* __restrict__ v,
                    long long sv, int H, int W, int align, int RS, float* __restrict__ out) {
  constexpr int kEntries = TAPS * kTapTile;  // (tap, sample) entries a tile, tap-major
  extern __shared__ float4 dyn[];
  float* const gs = reinterpret_cast<float*>(dyn);  // two tiles of RS x kTapStride floats
  float* const acc = gs + ((2 * RS * kTapStride + 3) & ~3);  // [cells, rows] (ACC)
  __shared__ int cell_s[kEntries];  // -1 outside the grid
  __shared__ float wt_s[kEntries];
  __shared__ unsigned char run_s[kEntries];  // the runs' first entries, tap-major
  __shared__ unsigned warp_bits[kTapThreads / 32];
  __shared__ int nrun_s;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * RS, rows = min(RS, R - r0);
  const int cells = H * W;
  const long long ntiles = (N + kTapTile - 1) / kTapTile;
  if (ACC) {
    for (int i = tid; i < cells * rows; i += kTapThreads) acc[i] = 0.f;
  }

  // tile t's g rows into buffer b (cp.async, one group), its coords into cu, cv
  float cu = 0.f, cv = 0.f;
  auto issue = [&](long long t, int b) {
    const long long n0 = t * kTapTile;
    const int nt = (int)min((long long)kTapTile, N - n0);
    float* dst = gs + b * RS * kTapStride;
    for (int i = tid; i < rows * kTapTile; i += kTapThreads) {
      const int r = i / kTapTile, j = i % kTapTile;
      if (j < nt) cp_async4(dst + r * kTapStride + j, g + (size_t)(r0 + r) * N + n0 + j);
    }
    cp_async_commit();
    const long long n = n0 + tid;
    if (tid < kTapTile && n < N) {
      cu = __ldg(u + n * su);
      if (TAPS == 4) cv = __ldg(v + n * sv);
    }
  };

  long long t = blockIdx.x;
  int b = 0;
  if (t < ntiles) issue(t, 0);
  for (; t < ntiles; t += gridDim.x, b ^= 1) {
    const int nt = (int)min((long long)kTapTile, N - t * kTapTile);
    if (tid < kTapTile) {
      int c[TAPS];
      float w[TAPS];
      if (tid < nt) {
        sample_taps<TAPS>(cu, cv, H, W, align, c, w);
      } else {
#pragma unroll
        for (int k = 0; k < TAPS; ++k) {
          c[k] = -1;
          w[k] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        cell_s[k * kTapTile + tid] = c[k];
        wt_s[k * kTapTile + tid] = w[k];
      }
    }
    const long long next = t + gridDim.x;
    if (next < ntiles) issue(next, b ^ 1);
    __syncthreads();
    // the runs of the global accumulator: a run starts at an entry whose cell
    // is in the grid and is not the previous sample's (same tap); each run is
    // one cell
    int runs = 0;
    if (!ACC) {
      const int j = tid % kTapTile;
      const int c = tid < kEntries ? cell_s[tid] : -1;
      compact(c >= 0 && (j == 0 || cell_s[tid - 1] != c), kEntries, warp_bits, run_s, &nrun_s);
      runs = nrun_s;
    }
    if (next < ntiles) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cur = gs + b * RS * kTapStride;
    if (ACC) {
      // a thread per (tap, row, stretch of the tile's samples), the rows
      // fastest: it walks its samples in order and adds each run of them on
      // one cell into the accumulator (shared-memory atomics: other threads
      // may add into the same entry)
      const int pairs = TAPS * rows;
      const int stretches = max(1, kTapThreads / pairs);
      const int len = (kTapTile + stretches - 1) / stretches;
      for (int it = tid; it < pairs * stretches; it += kTapThreads) {
        const int st = it / pairs, pr = it - st * pairs;
        const int tap = pr / rows, r = pr - tap * rows;
        const int* cl = cell_s + tap * kTapTile;
        const float* wl = wt_s + tap * kTapTile;
        const float* gr = cur + r * kTapStride;
        const int n1 = min(kTapTile, (st + 1) * len);
        int c = -1;
        float sum = 0.f;
        for (int n = st * len; n < n1; ++n) {
          const int cn = cl[n];
          if (cn != c) {
            if (c >= 0 && sum != 0.f) atomicAdd(acc + c * rows + r, sum);
            c = cn;
            sum = 0.f;
          }
          sum += __fmul_rn(gr[n], wl[n]);
        }
        if (c >= 0 && sum != 0.f) atomicAdd(acc + c * rows + r, sum);
      }
    } else {
      // a thread per (run, VEC rows), the rows fastest
      const int Q = rows / VEC;
      for (int it = tid; it < runs * Q; it += kTapThreads) {
        const int k = it / Q, q = it - k * Q;
        const int e0 = run_s[k], tap0 = e0 - e0 % kTapTile, c = cell_s[e0];
        const float* gq = cur + q * VEC * kTapStride - tap0;
        float sum[VEC] = {};
        for (int e = e0; e < tap0 + kTapTile && cell_s[e] == c; ++e) {
          const float w = wt_s[e];
#pragma unroll
          for (int i = 0; i < VEC; ++i) sum[i] += __fmul_rn(gq[i * kTapStride + e], w);
        }
        float* dst = out + (size_t)c * R + r0 + q * VEC;
        if constexpr (VEC == 4) {
          add4(dst, make_float4(sum[0], sum[1], sum[2], sum[3]));
        } else {
          add1(dst, sum[0]);
        }
      }
    }
    __syncthreads();  // the taps, the runs and buffer b are free again
  }
  if (ACC) {
    // the accumulator into the d factor: one reduction per non-zero float4
    __syncthreads();
    if constexpr (VEC == 4) {
      const float4* a4 = reinterpret_cast<const float4*>(acc);
      const int q4 = rows / 4;
      for (int i = tid; i < cells * q4; i += kTapThreads) {
        const int c = i / q4;
        add4(out + (size_t)c * R + r0 + 4 * (i - c * q4), a4[i]);
      }
    } else {
      for (int i = tid; i < cells * rows; i += kTapThreads) {
        const int c = i / rows;
        add1(out + (size_t)c * R + r0 + (i - c * rows), acc[i]);
      }
    }
  }
}

template <int TAPS, bool ACC, int VEC>
int launch_taps(const float* g, int R, long long N, const float* u, long long su,
                const float* v, long long sv, int H, int W, int align, int RS, int slabs,
                float* out, cudaStream_t s) {
  static bool sized = false;  // once per instance: room for the largest call
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_taps_kernel<TAPS, ACC, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTapSmemMax);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const size_t smem = (size_t)(((2 * RS * kTapStride + 3) & ~3) + (ACC ? H * W * RS : 0)) *
                      sizeof(float);
  const long long ntiles = (N + kTapTile - 1) / kTapTile;
  // as many blocks as the SMs hold (a block-private accumulator's flush is
  // cheap beside the latency that more blocks hide: 8 a SM in all)
  long long blocks = (long long)sm_count() * (ACC ? (8 + slabs - 1) / slabs : 4);
  if (blocks > ntiles) blocks = ntiles;
  scatter_taps_kernel<TAPS, ACC, VEC><<<dim3((unsigned)blocks, (unsigned)slabs), kTapThreads,
                                        smem, s>>>(g, R, N, u, su, v, sv, H, W, align, RS,
                                                   out);
  return cudaGetLastError();
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
// floats; a line when v is null (W = D, H = 1); out [H * W, R] f32 (cell-major)
extern "C" int ngp_scatter_add_taps(const float* g, int R, long long N, const float* u,
                                    long long su, const float* v, long long sv, int H, int W,
                                    int align, float* out, void* stream) {
  if (R <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // slabs of at most kSlabRows rows; a line's slab also fits the accumulator
  int most = kSlabRows;
  const bool acc = v == nullptr && (long long)W * (vec ? 4 : 1) <= kAccFloats;
  if (acc) most = min(kLineSlabRows, kAccFloats / W);
  if (vec) most &= ~3;
  const int slabs = (R + most - 1) / most;
  int RS = (R + slabs - 1) / slabs;
  if (vec) RS = (RS + 3) & ~3;
  if (v == nullptr) {
    return acc ? (vec ? launch_taps<2, true, 4>(g, R, N, u, su, nullptr, 0, 1, W, align, RS,
                                                slabs, out, s)
                      : launch_taps<2, true, 1>(g, R, N, u, su, nullptr, 0, 1, W, align, RS,
                                                slabs, out, s))
               : (vec ? launch_taps<2, false, 4>(g, R, N, u, su, nullptr, 0, 1, W, align, RS,
                                                 slabs, out, s)
                      : launch_taps<2, false, 1>(g, R, N, u, su, nullptr, 0, 1, W, align, RS,
                                                 slabs, out, s));
  }
  return vec ? launch_taps<4, false, 4>(g, R, N, u, su, v, sv, H, W, align, RS, slabs, out, s)
             : launch_taps<4, false, 1>(g, R, N, u, su, v, sv, H, W, align, RS, slabs, out, s);
}
