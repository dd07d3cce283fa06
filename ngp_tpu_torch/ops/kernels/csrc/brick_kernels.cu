// The brick grid's encoding for Hopper (sm_90a): its forward and the
// cotangent of the rows it reads.
//
// Replaces no Pallas kernel: it is ngp_tpu/ops/brickgrid.py:brick_encode
// (:143), which the JAX package leaves to XLA (one take of a 27 * C row per
// point and level, three masked selects of the 2x2x2 stencil out of the 3x3x3
// halo, the trilinear weights and a sum). The port ran it as torch ops
// (ops/brickgrid.py:brick_encode_plain): about 20 int64 ops a level for the
// row index, a gather of whole 432-byte rows, three selects over [N, L, 3, 3,
// 3, C] and autograd through all of it. One table row holds a brick of a
// level's cell grid (stride 2) with its full 3x3x3 halo of C-float cells, so
// a point's stencil lies in one row at the halo offsets (a + i, b + j, c + k),
// i, j, k in {0, 1}, (a, b, c) the low bits of its base cell.
//
// 1. brick_encode_fwd: out [N, L * C] in the compute type (f32 or bf16), a
// thread per (point, level), level fastest. It makes pos = x * scale + 0.5 as
// the two torch ops round it, the floor, the low bits and the brick
// coordinates, the dense or hashed row index in wrapping uint32 (then % the
// level's rows, + its first row: ops/brickgrid.py:_brick_index), and reads
// only the 8 stencil cells of the row (8 float4 at C = 4: 128 of its 432
// bytes). It casts them and the fractions to the compute type and forms the
// weights (1 - f, f), wxyz = (wx * wy) * wz and the products s * wxyz in that
// type, rounded as the torch chain rounds them, sums the 8 products in f32 and
// rounds once; zeros for a point outside [0, 1]^3. The sum's order is not
// torch's, so the output is within one rounding of the compute type of the
// plain version's. Bound: reading x and the distinct rows' stencil cells once
// and writing the output once; a point's 8 cells are 4 pairs of 32 bytes,
// which its thread loads as float4s.
//
// 2. brick_encode_bwd: from x and the output's cotangent g [N, L * C] (the
// compute type), the [N * L, 27 * C] f32 cotangent of the gathered rows that
// autograd of the plain chain hands to the table gradient, bit for bit: the 8
// stencil cells of a row hold the compute-type products g * wxyz, rounded as
// autograd rounds them and cast to f32; every other cell, and every row of a
// point outside the box, is exactly zero. Autograd's selects add each product
// to a zero, which turns a -0 product into +0; so does the kernel. It also
// writes each (point, level)'s row index, -1 outside the box (the rows add
// nothing there). The table gradient stays ops/kernels/scatter_kernels.cu's
// scatter_add_rows, whose tiles skip the zero float4s. A block of 128
// (point, level) items makes their products into shared memory, then writes
// its 128 rows (a contiguous 55 KB at C = 4) as consecutive float4s from
// consecutive threads. Bound: writing the rows once (432 bytes an item, 8
// times the 8 float4s that carry a value): that write, and the scatter's read
// of it, are what a scatter fused into this kernel would save (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kBrickThreads = 128;  // items (point, level) a block
constexpr uint32_t kPrime1 = 2654435761u, kPrime2 = 805459861u;

struct BrickParams {
  int L;
  float scale[kMaxLevels];
  int offset[kMaxLevels];    // first table row of the level
  uint32_t rows[kMaxLevels]; // table rows of the level
  uint32_t side[kMaxLevels]; // bricks along an axis of a dense level
  int hashed[kMaxLevels];
};

// a value of the compute type, held as a float
template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
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

// One item's geometry: whether x lies in [0, 1]^3, its table row, the low
// bits (a, b, c) of its base cell and the 8 stencil weights in the compute
// type, (i, j, k) at [(i * 2 + j) * 2 + k].
template <bool BF16>
__device__ __forceinline__ bool brick_item(const float* __restrict__ x, const BrickParams& p,
                                           long long n, int l, int* row, int lo[3],
                                           float wxyz[8]) {
  float xs[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) xs[d] = __ldg(x + 3 * n + d);
  if (xs[0] < 0.f || xs[0] > 1.f || xs[1] < 0.f || xs[1] > 1.f || xs[2] < 0.f || xs[2] > 1.f)
    return false;
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
  *row = (int)(h % p.rows[l]) + p.offset[l];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float wxy = rnd<BF16>(__fmul_rn(w[0][i], w[1][j]));
#pragma unroll
      for (int k = 0; k < 2; ++k) wxyz[(i * 2 + j) * 2 + k] = rnd<BF16>(__fmul_rn(wxy, w[2][k]));
    }
  return true;
}

template <int C, bool BF16>
__global__ void __launch_bounds__(kBrickThreads)
brick_fwd_kernel(const float* __restrict__ x, long long N, const float* __restrict__ table,
                 BrickParams p, void* __restrict__ out) {
  const long long item = (long long)blockIdx.x * kBrickThreads + threadIdx.x;
  if (item >= N * p.L) return;
  const long long n = item / p.L;
  const int l = (int)(item - n * p.L);
  int row, lo[3];
  float wxyz[8];
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  if (brick_item<BF16>(x, p, n, l, &row, lo, wxyz)) {
    const float* base = table + (size_t)row * (27 * C);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const Cell<C> s = load_cell<C>(
              base + ((lo[0] + i) * 9 + (lo[1] + j) * 3 + (lo[2] + k)) * C);
          const float w = wxyz[(i * 2 + j) * 2 + k];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += rnd<BF16>(__fmul_rn(rnd<BF16>(s.v[c]), w));
        }
  }
  if (BF16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + item * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = __float2bfloat16_rn(acc[c]);
  } else {
    float* o = static_cast<float*>(out) + item * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[c];
  }
}

template <int C, bool BF16>
__global__ void __launch_bounds__(kBrickThreads)
brick_bwd_kernel(const float* __restrict__ x, long long N, const void* __restrict__ g,
                 BrickParams p, int* __restrict__ idx, float* __restrict__ rows) {
  __shared__ Cell<C> prod[kBrickThreads][8];
  __shared__ int8_t stencil[kBrickThreads];  // a + 2 b + 4 c, or -1 outside the box
  const int tid = threadIdx.x;
  const long long item0 = (long long)blockIdx.x * kBrickThreads;
  const long long items = N * p.L;
  const int nt = (int)min((long long)kBrickThreads, items - item0);
  if (tid < nt) {
    const long long item = item0 + tid;
    const long long n = item / p.L;
    const int l = (int)(item - n * p.L);
    int row, lo[3];
    float wxyz[8];
    if (brick_item<BF16>(x, p, n, l, &row, lo, wxyz)) {
      float gc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gc[c] = BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(g)[item * C + c])
                     : static_cast<const float*>(g)[item * C + c];
      }
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
  float* dst = rows + item0 * (27 * C);
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
                   const unsigned* side, const int* hashed) {
  BrickParams p;
  p.L = L;
  for (int l = 0; l < L; ++l) {
    p.scale[l] = scale[l];
    p.offset[l] = offset[l];
    p.rows[l] = rows[l];
    p.side[l] = side[l];
    p.hashed[l] = hashed[l];
  }
  return p;
}

template <int C>
int launch_fwd(const float* x, long long N, const float* table, const BrickParams& p, int bf16,
               void* out, cudaStream_t s) {
  const long long blocks = (N * p.L + kBrickThreads - 1) / kBrickThreads;
  if (bf16) {
    brick_fwd_kernel<C, true><<<(unsigned)blocks, kBrickThreads, 0, s>>>(x, N, table, p, out);
  } else {
    brick_fwd_kernel<C, false><<<(unsigned)blocks, kBrickThreads, 0, s>>>(x, N, table, p, out);
  }
  return cudaGetLastError();
}

template <int C>
int launch_bwd(const float* x, long long N, const void* g, const BrickParams& p, int bf16,
               int* idx, float* rows, cudaStream_t s) {
  const long long blocks = (N * p.L + kBrickThreads - 1) / kBrickThreads;
  if (bf16) {
    brick_bwd_kernel<C, true><<<(unsigned)blocks, kBrickThreads, 0, s>>>(x, N, g, p, idx, rows);
  } else {
    brick_bwd_kernel<C, false><<<(unsigned)blocks, kBrickThreads, 0, s>>>(x, N, g, p, idx, rows);
  }
  return cudaGetLastError();
}

// what a launcher returns for a shape its kernel does not take
constexpr int kUnsupported = -1;

}  // namespace

// x [N, 3] f32 contiguous; table [rows, 27 C] f32 contiguous, 16-byte aligned
// (8 at C = 2); per level (L <= 32): scale, first row, rows, dense side,
// hashed; out [N, L C] f32 (bf16 = 0) or bf16 (bf16 = 1); C in {1, 2, 4, 8}
extern "C" int ngp_brick_encode_fwd(const float* x, long long N, const float* table, int C,
                                    int L, const float* scale, const int* offset,
                                    const unsigned* rows, const unsigned* side,
                                    const int* hashed, int bf16, void* out, void* stream) {
  if (L <= 0 || L > kMaxLevels) return kUnsupported;
  if (N <= 0) return cudaSuccess;
  const BrickParams p = params(L, scale, offset, rows, side, hashed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_fwd<1>(x, N, table, p, bf16, out, s);
    case 2: return launch_fwd<2>(x, N, table, p, bf16, out, s);
    case 4: return launch_fwd<4>(x, N, table, p, bf16, out, s);
    case 8: return launch_fwd<8>(x, N, table, p, bf16, out, s);
    default: return kUnsupported;
  }
}

// x as above; g [N, L C] f32 (bf16 = 0) or bf16 (bf16 = 1) contiguous; idx
// [N L] int32 and rows [N L, 27 C] f32 contiguous, written whole
extern "C" int ngp_brick_encode_bwd(const float* x, long long N, const void* g, int C, int L,
                                    const float* scale, const int* offset, const unsigned* rows_,
                                    const unsigned* side, const int* hashed, int bf16, int* idx,
                                    float* rows, void* stream) {
  if (L <= 0 || L > kMaxLevels) return kUnsupported;
  if (N <= 0) return cudaSuccess;
  const BrickParams p = params(L, scale, offset, rows_, side, hashed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_bwd<1>(x, N, g, p, bf16, idx, rows, s);
    case 2: return launch_bwd<2>(x, N, g, p, bf16, idx, rows, s);
    case 4: return launch_bwd<4>(x, N, g, p, bf16, idx, rows, s);
    case 8: return launch_bwd<8>(x, N, g, p, bf16, idx, rows, s);
    default: return kUnsupported;
  }
}
