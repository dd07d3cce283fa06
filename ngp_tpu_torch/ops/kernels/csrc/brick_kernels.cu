// The brick grid's encoding for Hopper (sm_90a): its forward, its table
// gradient, and the cotangent of the rows it reads.
//
// Replaces no Pallas kernel: it is ngp_tpu/ops/brickgrid.py:brick_encode
// (:143), which the JAX package leaves to XLA (one take of a 27 * C row per
// point and level, three masked selects of the 2x2x2 stencil out of the 3x3x3
// halo, the trilinear weights and a sum; its VJP one scatter-add of all
// levels straight into the table gradient). The port ran it as torch ops
// (ops/brickgrid.py:brick_encode_plain): about 20 int64 ops a level for the
// row index, a gather of whole 432-byte rows, three selects over [N, L, 3, 3,
// 3, C] and autograd through all of it. One table row holds a brick of a
// level's cell grid (stride 2) with its full 3x3x3 halo of C-float cells, so
// a point's stencil lies in one row at the halo offsets (a + i, b + j, c + k),
// i, j, k in {0, 1}, (a, b, c) the low bits of its base cell.
//
// Geometry (brick_stencil, shared by the three kernels): pos = x * scale +
// 0.5 as the two torch ops round it, the floor, the low bits and the brick
// coordinates, the dense or hashed row index in wrapping uint32 (then % the
// level's rows, + its first row: ops/brickgrid.py:_brick_index), the weights
// (1 - f, f) and wxyz = (wx * wy) * wz in the compute type, rounded as the
// torch chain rounds them (in bf16 two at a time, as bf16x2 products). All of
// it is 32-bit: the wrapper checks that N * L and the rows fit int32, and a
// level's rows divide by a mask where they are a power of two (every hashed
// level) and otherwise by a multiply with a reciprocal made on the host (a
// "magic number": ops/brickgrid.py:_divisor_magic), so no kernel calls a
// division routine. The level parameters are read in place (__grid_constant__).
//
// 1. brick_encode_fwd: out [N, L * C] in the compute type (f32 or bf16). A
// block takes 64 consecutive points and its warps take (32 points, level)
// tasks, level-major: a warp's lanes are 32 consecutive points at one level,
// which on the train path are the samples of one ray (the v1 march's [rays,
// samples] slots), so at the coarse levels they share bricks and stencils,
// and the masked slots repeat a point. A lane reads only the 8 stencil cells
// of its row (8 float4 at C = 4: 128 of its 432 bytes). Where at least
// kPairRows of the warp's lanes read distinct rows (the fine levels; random
// points), the lanes work in pairs: each lane reads the 4 cells of its k for
// its own point and for its partner's, so a pair's two 16-byte loads of a
// (point, i, j) are the 32 adjacent bytes of cells k = 0, 1 and meet in one
// or two 32-byte sectors; elsewhere each lane reads its own 8 (the shared
// rows meet in L1). Both forms make the products s * wxyz in the compute type
// and sum the 8 in f32 in (i, j, k) order, so they give the same value, which
// is within one rounding of the compute type of the plain version's (torch
// sums in another order); zeros for a point outside [0, 1]^3. The lanes
// write the block's [64, L * C] output tile into shared memory, and the block
// stores it, one contiguous stretch of out, with 16-byte stores (a lane
// storing its own C values, 8 bytes in bf16 at 64-byte strides, leaves the
// output's sectors partly written by many warps). Bound: reading x and the
// distinct rows' stencil sectors once and writing the output once (PERF.md
// gives the times and what holds the kernel up).
//
// 2. brick_table_grad: d_table [rows, 27 * C] f32 (zeroed by the wrapper) +=
// the table gradient under the output's cotangent g [N, L * C] (f32 or bf16,
// the compute type): for each (point, level) inside the box, the 8 products
// g * wxyz, rounded in the compute type as autograd of the plain chain rounds
// them, into its row's cells (a + i, b + j, c + k). The same blocks and
// level-major tasks as the forward; a block stages its x and its g rows (one
// contiguous stretch of g) in shared memory by 16-byte loads. A (point,
// level) whose cotangent is zero (the v1 march's masked slots, about half a
// step's) adds nothing. Lanes whose (row, stencil) is equal share all 8
// cells (a ray's samples at a coarse level: level 0 has 729 bricks for
// 131,072 points); __match_any_sync finds them, each group sums its 8 C
// products in lane order, a lane per product, through a warp scratch in
// shared memory (cheaper than a tree of shuffles per cell), and one lane
// issues one 16-byte reduction (red.global.add.v4.f32, atomicAdd of a float4)
// per float4 of each cell; none for a sum that is exactly zero. Adding +-0 to
// a sum that starts at +0 leaves it unchanged, so the skips are exact. No
// rows buffer and no index buffer are made. Atomics sum in no fixed order:
// the result is an f32 sum of the same products as the plain version's
// (scatter_add_rows_plain of brick_encode_bwd_plain's rows) in another order.
// Bound: reading x and g once and writing the stencil sectors of the (point,
// level)s whose cotangent is not zero once (the wrapper's zero fill writes
// the dense table once more).
//
// 3. brick_encode_bwd: from x and g, the [N * L, 27 * C] f32 cotangent of the
// gathered rows that autograd of the plain chain hands to the row gather, bit
// for bit: the 8 stencil cells of a row hold the compute-type products g *
// wxyz, rounded as autograd rounds them and cast to f32; every other cell,
// and every row of a point outside the box, is exactly zero. Autograd's
// selects add each product to a zero, which turns a -0 product into +0; so
// does the kernel. It also writes each (point, level)'s row index, -1 outside
// the box. No path runs it since brick_table_grad took its place (it and
// scatter_add_rows made the table gradient through a 453 MB rows buffer at
// --preset tpu's 131,072 points): it stays as the rows' reference on the
// card. A block of 128 (point, level) items makes their products into shared
// memory, then writes its 128 rows as consecutive float4s from consecutive
// threads. Bound: writing the rows once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900) && (CUDART_VERSION >= 12010)
#define NGP_VECTOR_ATOMICS 1
#endif

namespace {

constexpr int kMaxLevels = 32;
constexpr int kBrickThreads = 128;  // items (point, level) a block of the rows kernel
constexpr int kTileThreads = 256;   // a block of the forward or the table gradient
constexpr int kTilePoints = 64;     // its points
constexpr int kChunks = kTilePoints / 32;
// a forward warp reads in lane pairs where at least this many lanes read
// distinct rows
constexpr int kPairRows = 20;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kPrime1 = 2654435761u, kPrime2 = 805459861u;
// dynamic shared memory a block can have without opting in
constexpr int kStaticShared = 48 * 1024;

struct BrickParams {
  int L;
  float scale[kMaxLevels];
  int offset[kMaxLevels];      // first table row of the level
  uint32_t rows[kMaxLevels];   // table rows of the level
  uint32_t side[kMaxLevels];   // bricks along an axis of a dense level
  uint32_t magic[kMaxLevels];  // 0 where rows is a power of two, else h / rows's multiplier
  int shift[kMaxLevels];       // ... and its shift
  int hashed[kMaxLevels];
};

// a value of the compute type, held as a float
template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool BF16>
struct Compute {
  using T = float;
};
template <>
struct Compute<true> {
  using T = __nv_bfloat16;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// C floats of one halo cell
template <int C>
struct Cell {
  float v[C];
};

template <int C>
__device__ __forceinline__ Cell<C> load_cell(const float* p) {
  Cell<C> out;
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
      out.v[4 * q] = t.x;
      out.v[4 * q + 1] = t.y;
      out.v[4 * q + 2] = t.z;
      out.v[4 * q + 3] = t.w;
    }
  } else if constexpr (C == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    out.v[0] = t.x;
    out.v[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) out.v[c] = __ldg(p + c);
  }
  return out;
}

template <int C>
__device__ __forceinline__ void store_cell(float* p, const Cell<C>& c) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(c.v[4 * q], c.v[4 * q + 1], c.v[4 * q + 2], c.v[4 * q + 3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(c.v[0], c.v[1]);
  } else {
#pragma unroll
    for (int c2 = 0; c2 < C; ++c2) p[c2] = c.v[c2];
  }
}

// dst[0 .. C-1] += v by atomics: one float4 (sm_90 and CUDA 12.1 on) or
// float2 reduction per 4 or 2 floats, else one per float
template <int C>
__device__ __forceinline__ void add_cell(float* dst, const float* v) {
#ifdef NGP_VECTOR_ATOMICS
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      atomicAdd(reinterpret_cast<float4*>(dst) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  } else if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    atomicAdd(dst, v[0]);
  }
#else
#pragma unroll
  for (int c = 0; c < C; ++c) atomicAdd(dst + c, v[c]);
#endif
}

__device__ __forceinline__ bool in_box(const float xs[3]) {
  return !(xs[0] < 0.f || xs[0] > 1.f || xs[1] < 0.f || xs[1] > 1.f || xs[2] < 0.f ||
           xs[2] > 1.f);
}

// h % rows of level l, without a division
__device__ __forceinline__ uint32_t level_row(const BrickParams& p, int l, uint32_t h) {
  const uint32_t n = p.rows[l], m = p.magic[l];
  if (m == 0u) return h & (n - 1u);
  const uint32_t t = __umulhi(m, h);
  return h - ((t + ((h - t) >> 1)) >> p.shift[l]) * n;
}

// The stencil of a point xs inside [0, 1]^3 at level l: its table row, the
// low bits (a, b, c) of its base cell and the 8 weights in the compute type,
// (i, j, k) at [(i * 2 + j) * 2 + k]. In bf16 the weights are made two at a
// time (bf16x2 products, each rounded to nearest as the f32 product of two
// bf16 values rounds).
template <bool BF16>
__device__ __forceinline__ void brick_stencil(const float xs[3], const BrickParams& p, int l,
                                              int* row, int lo[3], float wxyz[8]) {
  uint32_t b[3];
  float w[3][2];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(xs[d], p.scale[l]), 0.5f);
    const float x0 = floorf(pos);
    const float f = rnd<BF16>(__fsub_rn(pos, x0));
    const int xi = (int)x0;  // >= 0 inside the box
    lo[d] = xi & 1;
    b[d] = (uint32_t)(xi >> 1);
    w[d][0] = rnd<BF16>(__fsub_rn(1.f, f));
    w[d][1] = f;
  }
  uint32_t h;
  if (p.hashed[l]) {
    h = b[0] ^ (b[1] * kPrime1) ^ (b[2] * kPrime2);
  } else {
    h = (b[0] * p.side[l] + b[1]) * p.side[l] + b[2];
  }
  *row = (int)level_row(p, l, h) + p.offset[l];
  if constexpr (BF16) {
    // (w[d][0], w[d][1]) are bf16 values: exact as bf16x2
    const __nv_bfloat162 wy = __floats2bfloat162_rn(w[1][0], w[1][1]);
    const __nv_bfloat162 wz = __floats2bfloat162_rn(w[2][0], w[2][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 wxy = __hmul2(__float2bfloat162_rn(w[0][i]), wy);  // j = 0, 1
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 r = __bfloat1622float2(
            __hmul2(__bfloat162bfloat162(j ? __high2bfloat16(wxy) : __low2bfloat16(wxy)), wz));
        wxyz[(i * 2 + j) * 2] = r.x;
        wxyz[(i * 2 + j) * 2 + 1] = r.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float wxy = __fmul_rn(w[0][i], w[1][j]);
#pragma unroll
        for (int k = 0; k < 2; ++k) wxyz[(i * 2 + j) * 2 + k] = __fmul_rn(wxy, w[2][k]);
      }
  }
}

// the halo cell of stencil entry s = (i * 2 + j) * 2 + k
__device__ __forceinline__ int halo_cell(const int lo[3], int s) {
  return (lo[0] + (s >> 2)) * 9 + (lo[1] + ((s >> 1) & 1)) * 3 + (lo[2] + (s & 1));
}

// out[c] = rnd(rnd(a[c]) * w) for C values and a weight w of the compute type:
// in bf16 two values a multiply (cvt.rn.bf16x2.f32, then a bf16x2 product,
// rounded to nearest as the f32 product of two bf16 values rounds)
template <int C, bool BF16>
__device__ __forceinline__ void products(const float* a, float w, float* out) {
  if constexpr (BF16 && C % 2 == 0) {
    const __nv_bfloat162 ww = __float2bfloat162_rn(w);
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      const float2 r = __bfloat1622float2(__hmul2(__floats2bfloat162_rn(a[c], a[c + 1]), ww));
      out[c] = r.x;
      out[c + 1] = r.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = rnd<BF16>(__fmul_rn(rnd<BF16>(a[c]), w));
  }
}

// dst[0 .. n) = src[0 .. n) by the whole block: 16-byte copies where both are
// 16-byte aligned, then single elements
template <typename T>
__device__ __forceinline__ void block_copy(T* __restrict__ dst, const T* __restrict__ src,
                                           int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n16 = n * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = n16 * 16 / (int)sizeof(T);
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

template <int C, bool BF16>
__global__ void __launch_bounds__(kTileThreads)
brick_fwd_kernel(const float* __restrict__ x, int N, const float* __restrict__ table,
                 const __grid_constant__ BrickParams p, void* __restrict__ out) {
  using T = typename Compute<BF16>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // [64, L C]
  const int n0 = blockIdx.x * kTilePoints;
  const int np = min(kTilePoints, N - n0);
  const int LC = p.L * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = lane & 1;  // the stencil's k of the cells this lane reads in pairs
  for (int task = warp; task < kChunks * p.L; task += kTileThreads / 32) {
    const int l = task / kChunks;
    const int j = (task - l * kChunks) * 32 + lane;
    const bool valid = j < np;
    float q[3] = {-1.f, 0.f, 0.f};  // outside the box where no point is
    if (valid) {
#pragma unroll
      for (int d = 0; d < 3; ++d) q[d] = __ldg(x + 3 * (size_t)(n0 + j) + d);
    }
    int row = -1, lo[3] = {0, 0, 0};
    float wxyz[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const bool inside = in_box(q);
    if (inside) brick_stencil<BF16>(q, p, l, &row, lo, wxyz);
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    const unsigned firsts =
        __ballot_sync(kFull, lane == __ffs(__match_any_sync(kFull, row)) - 1);
    if (__popc(firsts) >= kPairRows) {
      // the partner lane's row, low bits and the weights of this lane's k
      const int bits = inside ? 8 | lo[0] | lo[1] << 1 | lo[2] << 2 : 0;
      const int row_o = __shfl_xor_sync(kFull, row, 1);
      const int bits_o = __shfl_xor_sync(kFull, bits, 1);
      float w_o[4];
#pragma unroll
      for (int ij = 0; ij < 4; ++ij)
        w_o[ij] = __shfl_xor_sync(kFull, k ? wxyz[2 * ij] : wxyz[2 * ij + 1], 1);
      // round r reads the cells of the pair's lane r, each lane the 4 of its k
      float prod[2][4][C];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool own = r == k;
        const int rr = own ? row : row_o, b = own ? bits : bits_o;
#pragma unroll
        for (int ij = 0; ij < 4; ++ij)
#pragma unroll
          for (int c = 0; c < C; ++c) prod[r][ij][c] = 0.f;
        if (b & 8) {
          const int lr[3] = {b & 1, (b >> 1) & 1, (b >> 2) & 1};
          const float* base = table + (size_t)rr * (27 * C);
#pragma unroll
          for (int ij = 0; ij < 4; ++ij) {
            const Cell<C> v = load_cell<C>(base + halo_cell(lr, 2 * ij + k) * C);
            products<C, BF16>(v.v, own ? (k ? wxyz[2 * ij + 1] : wxyz[2 * ij]) : w_o[ij],
                              prod[r][ij]);
          }
        }
      }
      // this lane's point: its own 4 products (round k) and the partner's 4
#pragma unroll
      for (int ij = 0; ij < 4; ++ij)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float mine = k ? prod[1][ij][c] : prod[0][ij][c];
          const float other = __shfl_xor_sync(kFull, k ? prod[0][ij][c] : prod[1][ij][c], 1);
          acc[c] += k ? other : mine;
          acc[c] += k ? mine : other;
        }
    } else if (inside) {
      const float* base = table + (size_t)row * (27 * C);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const Cell<C> v = load_cell<C>(base + halo_cell(lo, s) * C);
        float pr[C];
        products<C, BF16>(v.v, wxyz[s], pr);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += pr[c];
      }
    }
    if (valid) {
      T* o = tile + j * LC + l * C;
#pragma unroll
      for (int c = 0; c < C; ++c) from_f32(o + c, acc[c]);
    }
  }
  __syncthreads();
  // the block's rows of out are one contiguous stretch
  block_copy(static_cast<T*>(out) + (size_t)n0 * LC, tile, np * LC);
}

// a lane's 8 cells of products in a warp's merge scratch, padded so that 8
// lanes' 16-byte stores meet distinct banks
template <int C>
constexpr int kMergeRow = 8 * C + 4;

template <int C, bool BF16>
__global__ void __launch_bounds__(kTileThreads)
brick_grad_kernel(const float* __restrict__ x, int N, const void* __restrict__ g,
                  const __grid_constant__ BrickParams p, float* __restrict__ d_table) {
  using T = typename Compute<BF16>::T;
  constexpr int kRow = kMergeRow<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kTilePoints;
  const int np = min(kTilePoints, N - n0);
  const int LC = p.L * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // x [64, 3], g [64, L C], then each warp's merge scratch [32, kRow]
  float* xs = reinterpret_cast<float*>(smem);
  T* gs = reinterpret_cast<T*>(smem + kTilePoints * 3 * 4);
  float* part = reinterpret_cast<float*>(smem + kTilePoints * 3 * 4 +
                                         kTilePoints * LC * sizeof(T)) +
                warp * 32 * kRow;
  block_copy(xs, x + 3 * (size_t)n0, 3 * np);
  block_copy(gs, static_cast<const T*>(g) + (size_t)n0 * LC, np * LC);
  __syncthreads();
  for (int task = warp; task < kChunks * p.L; task += kTileThreads / 32) {
    const int l = task / kChunks;
    const int j = (task - l * kChunks) * 32 + lane;
    float q[3] = {0.f, 0.f, 0.f}, gc[C];
    bool live = j < np;
    if (live) {
#pragma unroll
      for (int d = 0; d < 3; ++d) q[d] = xs[3 * j + d];
    }
    live = live && in_box(q);
    bool any = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gc[c] = live ? to_f32(gs[j * LC + l * C + c]) : 0.f;
      any |= gc[c] != 0.f;
    }
    // a zero cotangent adds +-0 to sums that start at +0: skipping it is exact
    if (__ballot_sync(kFull, any) == 0u) continue;
    int row = 0, lo[3] = {0, 0, 0};
    float wxyz[8];
    float v[8][C];
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c) v[s][c] = 0.f;
    if (any) {
      brick_stencil<BF16>(q, p, l, &row, lo, wxyz);
#pragma unroll
      for (int s = 0; s < 8; ++s) products<C, BF16>(gc, wxyz[s], v[s]);
    }
    // lanes of one (row, stencil) share all 8 cells; a lane that adds
    // nothing takes a key no stencil has
    const unsigned peers = __match_any_sync(
        kFull, any ? ((unsigned long long)row << 3 | (unsigned)(lo[0] + 2 * lo[1] + 4 * lo[2]))
                   : ~0ull);
    const bool lead = any && lane == __ffs(peers) - 1;
    const bool merged = any && __popc(peers) > 1;
    const unsigned leaders = __ballot_sync(kFull, lead && merged);
    if (leaders) {
      // each group sums its products in lane order, a lane per product (8 C
      // of them), into its leader's row of the scratch
      if (merged) {
#pragma unroll
        for (int q4 = 0; q4 < 2 * C; ++q4)
          reinterpret_cast<float4*>(part + lane * kRow)[q4] =
              make_float4(v[(4 * q4) / C][(4 * q4) % C], v[(4 * q4 + 1) / C][(4 * q4 + 1) % C],
                          v[(4 * q4 + 2) / C][(4 * q4 + 2) % C],
                          v[(4 * q4 + 3) / C][(4 * q4 + 3) % C]);
      }
      __syncwarp();
      for (unsigned ls = leaders; ls; ls &= ls - 1) {
        const int ld = __ffs(ls) - 1;
        const unsigned members = __shfl_sync(kFull, peers, ld);
        for (int e = lane; e < 8 * C; e += 32) {
          float acc = 0.f;
          for (unsigned m = members; m; m &= m - 1) acc += part[(__ffs(m) - 1) * kRow + e];
          part[ld * kRow + e] = acc;
        }
      }
      __syncwarp();
      if (lead && merged) {
#pragma unroll
        for (int s = 0; s < 8; ++s)
#pragma unroll
          for (int c = 0; c < C; ++c) v[s][c] = part[lane * kRow + s * C + c];
      }
      __syncwarp();
    }
    if (lead) {
      float* base = d_table + (size_t)row * (27 * C);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        bool nz = false;
#pragma unroll
        for (int c = 0; c < C; ++c) nz |= v[s][c] != 0.f;
        if (nz) add_cell<C>(base + halo_cell(lo, s) * C, v[s]);
      }
    }
  }
}

template <int C, bool BF16>
__global__ void __launch_bounds__(kBrickThreads)
brick_bwd_kernel(const float* __restrict__ x, int N, const void* __restrict__ g,
                 const __grid_constant__ BrickParams p, int* __restrict__ idx,
                 float* __restrict__ rows) {
  using T = typename Compute<BF16>::T;
  __shared__ Cell<C> prod[kBrickThreads][8];
  __shared__ int8_t stencil[kBrickThreads];  // a + 2 b + 4 c, or -1 outside the box
  const int tid = threadIdx.x;
  const int item0 = blockIdx.x * kBrickThreads;
  const int nt = min(kBrickThreads, N * p.L - item0);
  if (tid < nt) {
    const int item = item0 + tid;
    const int n = item / p.L;
    const int l = item - n * p.L;
    const float* xn = x + 3 * (size_t)n;
    const float q[3] = {__ldg(xn), __ldg(xn + 1), __ldg(xn + 2)};
    if (in_box(q)) {
      int row, lo[3];
      float wxyz[8];
      brick_stencil<BF16>(q, p, l, &row, lo, wxyz);
      float gc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) gc[c] = to_f32(static_cast<const T*>(g)[(size_t)item * C + c]);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        Cell<C> v;
        // + 0: autograd adds each product to a zero (a -0 becomes +0)
#pragma unroll
        for (int c = 0; c < C; ++c) v.v[c] = __fadd_rn(rnd<BF16>(__fmul_rn(gc[c], wxyz[s])), 0.f);
        prod[tid][s] = v;
      }
      stencil[tid] = (int8_t)(lo[0] + 2 * lo[1] + 4 * lo[2]);
      idx[item] = row;
    } else {
      stencil[tid] = -1;
      idx[item] = -1;
    }
  }
  __syncthreads();
  // the block's rows are contiguous: consecutive threads write consecutive cells
  float* dst = rows + (size_t)item0 * (27 * C);
  for (int q = tid; q < nt * 27; q += kBrickThreads) {
    const int it = q / 27, e = q - it * 27;
    const int st = stencil[it];
    Cell<C> v;
#pragma unroll
    for (int c = 0; c < C; ++c) v.v[c] = 0.f;
    if (st >= 0) {
      const int i = e / 9 - (st & 1), j = (e / 3) % 3 - ((st >> 1) & 1), k = e % 3 - (st >> 2);
      if ((unsigned)i < 2u && (unsigned)j < 2u && (unsigned)k < 2u)
        v = prod[it][(i * 2 + j) * 2 + k];
    }
    store_cell<C>(dst + (size_t)q * C, v);
  }
}

BrickParams params(int L, const float* scale, const int* offset, const unsigned* rows,
                   const unsigned* side, const int* hashed, const unsigned* magic,
                   const int* shift) {
  BrickParams p;
  p.L = L;
  for (int l = 0; l < L; ++l) {
    p.scale[l] = scale[l];
    p.offset[l] = offset[l];
    p.rows[l] = rows[l];
    p.side[l] = side[l];
    p.hashed[l] = hashed[l];
    p.magic[l] = magic[l];
    p.shift[l] = shift[l];
  }
  return p;
}

// a forward or table-gradient kernel's launch: 64 points a block, `smem`
// bytes of dynamic shared memory (opting in above 48 KB)
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, int smem, int N, cudaStream_t s, Args... args) {
  if (smem > kStaticShared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (N + kTilePoints - 1) / kTilePoints;
  kernel<<<blocks, kTileThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <int C>
int launch_fwd(const float* x, int N, const float* table, const BrickParams& p, int bf16,
               void* out, cudaStream_t s) {
  const int smem = kTilePoints * p.L * C * (bf16 ? 2 : 4);  // the output tile
  if (bf16) return launch_tiles(brick_fwd_kernel<C, true>, smem, N, s, x, N, table, p, out);
  return launch_tiles(brick_fwd_kernel<C, false>, smem, N, s, x, N, table, p, out);
}

template <int C>
int launch_grad(const float* x, int N, const void* g, const BrickParams& p, int bf16,
                float* d_table, cudaStream_t s) {
  // x, g and the warps' merge scratch
  const int smem = kTilePoints * 3 * 4 + kTilePoints * p.L * C * (bf16 ? 2 : 4) +
                   kTileThreads * kMergeRow<C> * 4;
  if (bf16) return launch_tiles(brick_grad_kernel<C, true>, smem, N, s, x, N, g, p, d_table);
  return launch_tiles(brick_grad_kernel<C, false>, smem, N, s, x, N, g, p, d_table);
}

template <int C>
int launch_bwd(const float* x, int N, const void* g, const BrickParams& p, int bf16, int* idx,
               float* rows, cudaStream_t s) {
  const int blocks = (N * p.L + kBrickThreads - 1) / kBrickThreads;
  if (bf16) {
    brick_bwd_kernel<C, true><<<blocks, kBrickThreads, 0, s>>>(x, N, g, p, idx, rows);
  } else {
    brick_bwd_kernel<C, false><<<blocks, kBrickThreads, 0, s>>>(x, N, g, p, idx, rows);
  }
  return cudaGetLastError();
}

// what a launcher returns for a shape its kernel does not take
constexpr int kUnsupported = -1;

// N * L items fit int32 (the wrapper checks it, and that the rows do)
bool takes(long long N, int L) {
  return L > 0 && L <= kMaxLevels && N * L < (1ll << 31);
}

}  // namespace

// x [N, 3] f32 contiguous; table [rows, 27 C] f32 contiguous, 16-byte aligned
// (8 at C = 2); per level (L <= 32): scale, first row, rows, dense side,
// hashed, and the rows' divisor magic and shift (ops/brickgrid.py:
// _level_args); out [N, L C] f32 (bf16 = 0) or bf16 (bf16 = 1) contiguous;
// C in {1, 2, 4, 8}
extern "C" int ngp_brick_encode_fwd(const float* x, long long N, const float* table, int C,
                                    int L, const float* scale, const int* offset,
                                    const unsigned* rows, const unsigned* side,
                                    const int* hashed, const unsigned* magic, const int* shift,
                                    int bf16, void* out, void* stream) {
  if (!takes(N, L)) return kUnsupported;
  if (N <= 0) return cudaSuccess;
  const BrickParams p = params(L, scale, offset, rows, side, hashed, magic, shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_fwd<1>(x, (int)N, table, p, bf16, out, s);
    case 2: return launch_fwd<2>(x, (int)N, table, p, bf16, out, s);
    case 4: return launch_fwd<4>(x, (int)N, table, p, bf16, out, s);
    case 8: return launch_fwd<8>(x, (int)N, table, p, bf16, out, s);
    default: return kUnsupported;
  }
}

// x as above; g [N, L C] f32 (bf16 = 0) or bf16 (bf16 = 1) contiguous;
// d_table [rows, 27 C] f32 contiguous, 16-byte aligned, added into
extern "C" int ngp_brick_table_grad(const float* x, long long N, const void* g, int C, int L,
                                    const float* scale, const int* offset, const unsigned* rows,
                                    const unsigned* side, const int* hashed,
                                    const unsigned* magic, const int* shift, int bf16,
                                    float* d_table, void* stream) {
  if (!takes(N, L)) return kUnsupported;
  if (N <= 0) return cudaSuccess;
  const BrickParams p = params(L, scale, offset, rows, side, hashed, magic, shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_grad<1>(x, (int)N, g, p, bf16, d_table, s);
    case 2: return launch_grad<2>(x, (int)N, g, p, bf16, d_table, s);
    case 4: return launch_grad<4>(x, (int)N, g, p, bf16, d_table, s);
    case 8: return launch_grad<8>(x, (int)N, g, p, bf16, d_table, s);
    default: return kUnsupported;
  }
}

// x and g as above; idx [N L] int32 and rows [N L, 27 C] f32 contiguous,
// written whole
extern "C" int ngp_brick_encode_bwd(const float* x, long long N, const void* g, int C, int L,
                                    const float* scale, const int* offset, const unsigned* rows_,
                                    const unsigned* side, const int* hashed,
                                    const unsigned* magic, const int* shift, int bf16, int* idx,
                                    float* rows, void* stream) {
  if (!takes(N, L)) return kUnsupported;
  if (N <= 0) return cudaSuccess;
  const BrickParams p = params(L, scale, offset, rows_, side, hashed, magic, shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_bwd<1>(x, (int)N, g, p, bf16, idx, rows, s);
    case 2: return launch_bwd<2>(x, (int)N, g, p, bf16, idx, rows, s);
    case 4: return launch_bwd<4>(x, (int)N, g, p, bf16, idx, rows, s);
    case 8: return launch_bwd<8>(x, (int)N, g, p, bf16, idx, rows, s);
    default: return kUnsupported;
  }
}
