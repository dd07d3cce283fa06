// Multiresolution hash / tiled grid encoder for Hopper (sm_90a).
//
// The JAX package leaves this encoder to XLA (ngp_tpu/ops/hashgrid.py:
// grid_encode: a take of the table and an einsum with the d-linear weights per
// level, hashgrid.py:203-204); these kernels do that work by hand.
//
//   ngp_grid_encode_fwd  features [B, L*C] from points [B, D] and the table
//   ngp_grid_encode_bwd  the VJP of the take + einsum in one pass: every
//                        (point, level, corner) adds its cotangent row
//                        w * g by f32 atomics into the table gradient
//
// (The gradient in the points is grid_bwd_x_kernels.cu's; the geometry and
// index arithmetic they all share is grid_common.cuh's.) Both are templated
// on the point dimension D, with instances for
// D = 2 (the background net's encoder of sphere coordinates), D = 3 and
// D = 4 (D-NeRF's hyper grid: three space dims and one ambient): a cell
// has 2^D corners, and a level D dense strides. Per-level scale, row
// offset, row count (and its mask where it is a power of two), dense strides
// and the hashed flag sit in the kernel's parameter block; both kernels hold
// the level uniform across a warp, so each is one broadcast read. corner_row
// is the one device copy of the index arithmetic
// (gridencoder.cu:66-84 through hashgrid.py:125-158), in 32 bits: row-major
// dense index over the dims whose stride fits the level, XOR of per-dim primes
// in wrapping uint32 when a hashed level overflows, then % rows (a mask for
// the 2^19-row hashed levels); both kernels call it with the same level_pos
// and corner_weight, so the backward adds into the rows the forward read.
// Positions use separate f32 multiply and add (no FMA contraction), as the JAX
// and PyTorch versions do, so the same points fall into the same cells.
//
// Forward at the train step (1,048,576 points x 16 levels, C = 2): one thread
// per point, a block of kFwdThreads points walking the levels together (the
// coarse levels' tables, 39 and 110 KB, are then served from L1, which no
// shared memory takes), the features of 16 bytes of output row (4 levels in
// bf16) made in registers and stored as one vector. The 134 M corner reads of
// 8 bytes from a 49 MB f32 table that mostly stays in the 50 MB L2 bound it
// (about 4.3 GB of 32-byte L2 sectors on random points, against 12.6 MB in
// and 64 MB (bf16) out): the x-corners of a cell are rows r and r ^ 1 on a
// hashed level when x is even (primes[0] = 1, and the mask keeps bit 0), rows
// r and r + 1 on a dense one, and level offsets are multiples of 8 rows, so
// where the two rows form an aligned pair one vector load (16 bytes at C = 2
// in f32) brings both. None of that depends on D, so the pair load holds at
// D = 2 as at D = 3 (the kernel tests r1 == r0 ^ 1 before it loads a pair);
// and consecutive samples of a ray, neighbouring lanes, share their coarse
// cells. Staging the output rows in shared memory to store them coalesced
// cost more than it saved: it took L1 from the table (PERF.md).
//
// Backward: one warp per (32 points, level), level outside, so the warps of a
// block share their points' x and g rows in L1, and at a coarse level a
// warp's 32 consecutive samples of one ray mostly share a cell. A (point,
// level) whose cotangent row is zero, and a corner whose product row is
// zero, adds nothing: the masked slots of a train step (about 90% late in
// training) cost a load and no atomic. Lanes whose corner row is equal sum
// their products by shuffles (match_any, then a peer reduction) and one lane
// issues the float2 / float4 atomic. The table the wrapper zeroes (49 MB)
// stays mostly in L2; the bound is reading x and g and writing the table
// once (126 MB, 0.04 ms at the train shape), and what it meets first is the
// L2 atomic rate on the non-zero rows. Atomics sum in no fixed order, so the
// result varies in the last f32 bits from run to run; adding +-0 to a sum
// that starts at +0 leaves it unchanged, so skipping zero rows is exact.
//
// Rounding: with a bf16 output (the bf16 compute type) each table value and
// each corner weight is rounded to bf16, the products summed in f32 and the
// feature rounded once, as JAX's bf16 einsum on the CPU does; backward, the
// weight and the product w * g are rounded to bf16 (the einsum's VJP), and
// the gradient then sums in f32 where JAX sums in bf16. Points outside
// [0, 1]^D (a coordinate below 0 or above 1; 0 and 1 are inside) get zero
// features and add nothing.

#include "grid_common.cuh"

#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900) && (CUDART_VERSION >= 12010)
#define NGP_VECTOR_ATOMICS 1
#endif

namespace {

// acc[c] = sum over corners k of round(w_k) * round(table[corner_row(k)][c])
// of the point q at level l (rounding with a bf16 output only); the table
// starts on a pair of rows, so rows and pairs load as vectors
template <typename TT, int C, int D, bool kRound>
__device__ __forceinline__ void level_features(const GridParams& p, const TT* table, int l,
                                               const float* q, float* acc) {
  uint32_t i0[D];
  float frac[D];
  level_pos<D>(p, l, q, i0, frac);
#pragma unroll
  for (int k = 0; k < (1 << D); k += 2) {
    // the x-corners k and k + 1: one load of their aligned pair of rows
    // where the two rows are r and r ^ 1, else one load each
    const uint32_t r0 = corner_row<D>(p, l, i0, k), r1 = corner_row<D>(p, l, i0, k + 1);
    float v0[C], v1[C];
    if (r1 == (r0 ^ 1u)) {
      float v[2 * C];
      load_vals<TT, 2 * C>(table + (size_t)(r0 & ~1u) * C, v);
      const bool odd = r0 & 1u;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v0[c] = odd ? v[C + c] : v[c];
        v1[c] = odd ? v[c] : v[C + c];
      }
    } else {
      load_vals<TT, C>(table + (size_t)r0 * C, v0);
      load_vals<TT, C>(table + (size_t)r1 * C, v1);
    }
    float w0 = corner_weight<D>(frac, k), w1 = corner_weight<D>(frac, k + 1);
    if (kRound) {
      w0 = round_bf16(w0);
      w1 = round_bf16(w1);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(w0, kRound ? round_bf16(v0[c]) : v0[c], acc[c]);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(w1, kRound ? round_bf16(v1[c]) : v1[c], acc[c]);
  }
}

// out[b] = the point's features, level by level. One thread per point (lane =
// point, so the level is uniform across a warp). The features of kG levels
// (16 bytes of the output row, or one level where that is wider) are made in
// registers and stored together: one 16-byte store per thread where the rows
// are whole 16-byte vectors, else element by element.
template <typename TT, typename TO, int C, int D>
__global__ void __launch_bounds__(kFwdThreads)
    grid_fwd_kernel(GridParams p, const TT* __restrict__ table, TO* __restrict__ out) {
  constexpr bool kRound = sizeof(TO) == 2;
  constexpr int kLevelBytes = C * (int)sizeof(TO);
  constexpr int kG = kLevelBytes >= 16 ? 1 : 16 / kLevelBytes;
  constexpr int kWords = (kG * kLevelBytes + 15) / 16;
  const long long b = (long long)blockIdx.x * kFwdThreads + threadIdx.x;
  if (b >= p.B) return;
  float q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = __ldg(p.x + D * b + d);
  const bool live = in_box<D>(q);
  TO* row = out + b * p.L * C;
  const bool vec = (p.L * kLevelBytes) % 16 == 0 && (uintptr_t)out % 16 == 0;
  for (int l0 = 0; l0 < p.L; l0 += kG) {
    union {
      uint4 u[kWords];
      TO e[kG * C];
    } w;
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
      if (live && l0 + j < p.L) level_features<TT, C, D, kRound>(p, table, l0 + j, q, acc);
#pragma unroll
      for (int c = 0; c < C; ++c) st(w.e, j * C + c, acc[c]);
    }
    if (vec) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) reinterpret_cast<uint4*>(row + l0 * C)[i] = w.u[i];
    } else {
      const int n = min(kG, p.L - l0) * C;
      for (int i = 0; i < n; ++i) row[l0 * C + i] = w.e[i];
    }
  }
}

// Sum of x over the lanes of `peers` (a set of lanes of this warp holding the
// same key), left at the lowest lane of the set; the other lanes' results are
// partial. Every lane of `active` calls it together (E. Westphal's peer
// reduction: log2(set size) rounds of a shuffle from the next peer up).
__device__ __forceinline__ float sum_peers(unsigned active, unsigned peers, float x) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(active, above != 0u)) {
    const int next = __ffs(above);
    const float t = __shfl_sync(active, x, next > 0 ? next - 1 : 0);
    if (next > 0 && !(rank & 1)) x += t;
    above &= ~__ballot_sync(active, rank & 1);
    rank >>= 1;
  }
  return x;
}

// dst[0 .. C-1] += v by atomics: one float2 / float4 atomic per 2 / 4 columns
// (sm_90 and CUDA 12.1 on), else one per column
template <int C> __device__ __forceinline__ void add_row(float* dst, const float* v) {
#pragma unroll
  for (int c = 0; c < C; ++c) atomicAdd(dst + c, v[c]);
}
#ifdef NGP_VECTOR_ATOMICS
template <> __device__ __forceinline__ void add_row<2>(float* dst, const float* v) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
}
template <> __device__ __forceinline__ void add_row<4>(float* dst, const float* v) {
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
}
template <> __device__ __forceinline__ void add_row<8>(float* dst, const float* v) {
  add_row<4>(dst, v);
  add_row<4>(dst + 4, v + 4);
}
#endif

// dtable[corner_row(l, k)] += round(round(w_k) * g[b, l]) for every (point b,
// level l, corner k) whose product row is not zero. One warp per (32 points,
// level), lane = point, so the warps of a block walk the levels of the same
// 32 points (their x and g rows meet in L1) and a warp's corner rows at a
// coarse level are mostly equal (consecutive samples of one ray share a
// cell): lanes whose row is equal sum their products by shuffles and one
// lane adds the sum.
template <typename TG, int C, int D>
__global__ void grid_bwd_kernel(GridParams p, const TG* __restrict__ g,
                                float* __restrict__ dtable) {
  constexpr bool kRound = sizeof(TG) == 2;
  const int lane = threadIdx.x & 31;
  const long long units = (p.B + 31) / 32 * p.L;
  const long long step = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long u = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; u < units;
       u += step) {
    const int l = (int)(u % p.L);
    const long long b = (u / p.L) * 32 + lane;
    float gv[C];
    bool live = b < p.B;
    float q[D];
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = live ? __ldg(p.x + D * b + d) : 0.f;
    live = live && in_box<D>(q);
    bool any = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gv[c] = live ? ld(g, ((size_t)b * p.L + l) * C + c) : 0.f;
      any |= gv[c] != 0.f;
    }
    // a zero cotangent row adds +-0 to sums that start at +0: skipping it is exact
    const unsigned active = __ballot_sync(0xffffffffu, any);
    if (!any) continue;
    uint32_t i0[D];
    float frac[D];
    level_pos<D>(p, l, q, i0, frac);
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) {
      float w = corner_weight<D>(frac, k);
      if (kRound) w = round_bf16(w);
      float v[C];
      bool nz = false;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = w * gv[c];
        if (kRound) v[c] = round_bf16(v[c]);
        nz |= v[c] != 0.f;
      }
      const uint32_t row = corner_row<D>(p, l, i0, k);
      // zero rows take part under a key no row has, so the set stays whole
      const unsigned peers = __match_any_sync(active, nz ? row : 0xffffffffu);
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = sum_peers(active, peers, v[c]);
      if (nz && lane == __ffs(peers) - 1) add_row<C>(dtable + (size_t)row * C, v);
    }
  }
}


int blocks_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename TT, typename TO, int C, int D>
int launch_fwd_cd(const GridParams& p, const void* table, void* out, cudaStream_t s) {
  const int blocks = (int)((p.B + kFwdThreads - 1) / kFwdThreads);
  // the kernel loads rows and row pairs as vectors
  if ((uintptr_t)table % (2 * C * sizeof(TT)) != 0) return (int)cudaErrorInvalidValue;
  grid_fwd_kernel<TT, TO, C, D><<<blocks, kFwdThreads, 0, s>>>(
      p, static_cast<const TT*>(table), static_cast<TO*>(out));
  return (int)cudaGetLastError();
}

template <typename TT, typename TO, int C>
int launch_fwd_c(const GridParams& p, int D, const void* table, void* out, cudaStream_t s) {
  switch (D) {
    case 2: return launch_fwd_cd<TT, TO, C, 2>(p, table, out, s);
    case 3: return launch_fwd_cd<TT, TO, C, 3>(p, table, out, s);
    case 4: return launch_fwd_cd<TT, TO, C, 4>(p, table, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TT, typename TO>
int launch_fwd(const GridParams& p, int C, int D, const void* table, void* out,
               cudaStream_t s) {
  switch (C) {
    case 1: return launch_fwd_c<TT, TO, 1>(p, D, table, out, s);
    case 2: return launch_fwd_c<TT, TO, 2>(p, D, table, out, s);
    case 4: return launch_fwd_c<TT, TO, 4>(p, D, table, out, s);
    case 8: return launch_fwd_c<TT, TO, 8>(p, D, table, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TG, int C, int D>
int launch_bwd_cd(const GridParams& p, const void* g, float* dtable, cudaStream_t s) {
  const int blocks = blocks_for((p.B + 31) / 32 * p.L * 32);
  grid_bwd_kernel<TG, C, D><<<blocks, kThreads, 0, s>>>(p, static_cast<const TG*>(g), dtable);
  return (int)cudaGetLastError();
}

template <typename TG, int C>
int launch_bwd_c(const GridParams& p, int D, const void* g, float* dtable, cudaStream_t s) {
  switch (D) {
    case 2: return launch_bwd_cd<TG, C, 2>(p, g, dtable, s);
    case 3: return launch_bwd_cd<TG, C, 3>(p, g, dtable, s);
    case 4: return launch_bwd_cd<TG, C, 4>(p, g, dtable, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TG>
int launch_bwd(const GridParams& p, int C, int D, const void* g, float* dtable,
               cudaStream_t s) {
  switch (C) {
    case 1: return launch_bwd_c<TG, 1>(p, D, g, dtable, s);
    case 2: return launch_bwd_c<TG, 2>(p, D, g, dtable, s);
    case 4: return launch_bwd_c<TG, 4>(p, D, g, dtable, s);
    case 8: return launch_bwd_c<TG, 8>(p, D, g, dtable, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ngp_grid_encode_fwd(const float* x, long long B, int D, const void* table,
                                   int table_bf16, int C, int L, const float* scales,
                                   const int* offsets, const unsigned* sizes,
                                   const unsigned* strides,
                                   const int* hashed, float shift, int smoothstep, void* out,
                                   int out_bf16, void* stream) {
  GridParams p;
  const int err = fill_params(&p, x, B, D, L, scales, offsets, sizes, strides, hashed, shift,
                              smoothstep);
  if (err != (int)cudaSuccess || B <= 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16) {
    return out_bf16 ? launch_fwd<__nv_bfloat16, __nv_bfloat16>(p, C, D, table, out, s)
                    : launch_fwd<__nv_bfloat16, float>(p, C, D, table, out, s);
  }
  return out_bf16 ? launch_fwd<float, __nv_bfloat16>(p, C, D, table, out, s)
                  : launch_fwd<float, float>(p, C, D, table, out, s);
}

extern "C" int ngp_grid_encode_bwd(const float* x, long long B, int D, const void* g,
                                   int g_bf16, int C, int L, const float* scales,
                                   const int* offsets, const unsigned* sizes,
                                   const unsigned* strides,
                                   const int* hashed, float shift, int smoothstep,
                                   float* dtable, void* stream) {
  GridParams p;
  const int err = fill_params(&p, x, B, D, L, scales, offsets, sizes, strides, hashed, shift,
                              smoothstep);
  if (err != (int)cudaSuccess || B <= 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g_bf16 ? launch_bwd<__nv_bfloat16>(p, C, D, g, dtable, s)
                : launch_bwd<float>(p, C, D, g, dtable, s);
}

