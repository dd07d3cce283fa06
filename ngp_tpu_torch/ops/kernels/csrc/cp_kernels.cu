// CP factor-bank density and radiance heads for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of ngp_tpu/ops/pallas/cp_kernels.py:
//   ngp_cp_density_fwd  <- _density_kernel / _cp_density_fwd_impl (forward, with
//                          the feats/h1 residuals when asked for)
//   ngp_cp_sigma_rgb    <- _sigma_rgb_kernel / cp_sigma_rgb
//   ngp_cp_bwd_banks    <- _bwd_kernel / _cp_bwd_banks (factor gradients)
//   ngp_cp_encode_fwd   <- _fwd_kernel / _cp_encode_fwd_impl (the CP features alone)
//
// What the TPU kernel did with a tent-matrix matmul on the MXU (one [TM, res]
// row of lerp weights per axis) is here a two-row gather and lerp per axis:
// Hopper gathers cheaply, and all five factor banks of the flagship config
// (3 x 3968 x 128 bf16, about 3 MB) stay resident in the 50 MB L2.
//
// The bf16 heads (the main path's type) run every MLP product on the tensor
// cores (mma.sync m16n8k16, bf16 -> f32): cp_density_tc_kernel and
// cp_sigma_rgb_tc_kernel share one tile code. A persistent block of 16 warps
// per SM keeps w1 and w2 in shared memory in fragment order for its whole life
// (88 KB at the flagship config, K padded from 679 to 688; a w1 too long for
// that comes in a K chunk at a time beside the chunk's features) and walks
// tiles of 128 rows (64 for H1 <= 128, 32 for H1 <= 256); each tile's features
// are made one bank at a time into a double-buffered shared A tile, by 16-byte
// gathers of 8 rank columns per thread (two items' twelve loads in flight),
// f32 lerps and product, rounded to bf16. What bounds them is the L2 traffic
// of the gathers, 7.7 KB of factor lines per row (1.0 GB for a 131,072-row
// refresh chunk, 189 MB for a 24,576-row eval chunk), not the 11.7 GFLOP of
// products; with residuals, the feats rows (1358 bytes apart at the flagship
// config) go out by 2-byte stores. The radiance kernel then runs the colour
// half on chip: the SH basis and the geo columns into one shared bf16 tile,
// the colour MLP chained through registers, one 16-byte store per row. The
// f32 heads, and bf16 heads wider than the tensor-core tiles take (tc_route),
// keep the first design: one block owns kRows sample rows, its feature rows
// and activations in shared memory as f32, the products on the CUDA cores with
// a register tile of kRowsPerThread rows per weight load (full f32, where TF32
// would break the f32 tolerance). With residuals, each block also writes its
// [rows, D] feature rows and [rows, H1] hidden rows in the weight type, the
// values the backward's MLP products read.
//
// The factor backward (cp_bwd_runs_kernel) replaces the TPU's transposed
// tent matmul (_bwd_kernel / _cp_bwd_banks) with what the tent encodes: each
// row adds (1 - w) * others at i0 and w * others at i0 + 1 of each axis,
// others = g * (the other two axes' lerped values), into f32 accumulators
// that stay in L2 (one allocation for all banks, 3 x 3968 x 128 f32, about
// 6 MB at the flagship config). A warp owns one bank, one group of 128 rank
// columns (4 per lane) and a run of 32 consecutive rows: lane k makes the
// taps of row k once, in 32-bit arithmetic, and the warp reads them by
// shuffles, so the taps are warp-uniform and no index is divided in the row
// loop. Each lane loads its 4 columns of g in one 16-byte load; rows outside
// [0, 1]^3, and rows whose g is zero in all of the warp's columns (most rows
// late in training), add nothing and are skipped before their factor lines
// are read, which is exact. The other rows' lines come in one 8-byte (bf16)
// or 16-byte (f32) load each. Per axis the lane keeps the running sums of
// taps i0 and i0 + 1 of its columns in registers and adds them to the
// accumulators, one 16-byte atomic per tap, only when that axis's tap moves
// from one row to the next (a move by one keeps the sum that lands on the
// new pair) and at the end of the run: along a ray's samples the coarse
// banks' taps repeat, so they flush a few times per ray, and neighbouring
// rows' atomics stay off the same addresses. What bounds it is the L2
// traffic of the gathers and the atomics: at 98,304 rows, 755 MB of factor
// lines and the 252 MB read of g, and 16-byte atomics of 512 bytes a warp,
// 6 per (live row, bank) without merging (1.5 GB on random rows; the fine
// banks' taps rarely repeat). Atomics sum in no fixed order, so the result
// varies in the last f32 bits from run to run.
//
// The encoder forward (cp_encode_runs_kernel, for _fwd_kernel /
// _cp_encode_fwd_impl) writes the CP features alone, [M, nb * R] in the
// output type, zero for rows outside [0, 1]^3, with the same work unit and
// taps, its items ordered so that the card works through the banks one at a
// time: each lane lerps and multiplies 4 columns of a row in f32 and stores
// them in one 8-byte (bf16) or 16-byte (f32) store, four rows' loads in
// flight. Its floor is the L2 traffic of the gathers on random points (30
// lines of 256 bytes a row, 503 MB at the 65,536-row mesh chunk) and the
// write (84 MB of bf16); on the mesh lattice, whose x and y are constant over
// a run, only the z lines change from row to row. Writing the zero and the
// output type here, as the Pallas kernel does, keeps a where/cast pass from
// streaming the output again.
//
// Shapes whose columns cannot be read 4 at a time by one vector access (a
// rank that is no multiple of 4, a g row stride or a bank that does not start
// on one) take the scalar-column instance of the same kernels, chosen from
// the shape before the launch (vec_route); its lanes take columns 32 apart,
// so each of a warp's scalar loads and atomics covers 32 adjacent columns.
//
// Rounding follows the Pallas kernels: features are rounded to the weight
// type before w1, h1 after its ReLU, geo features and the SH basis before the
// color MLP, and each color hidden layer; every product accumulates in f32,
// and sigma = exp(h[:, 0]) is f32. Unlike the Pallas kernel, the lerp runs in
// f32 (as the JAX CPU reference, cp_encode_reference, does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBanks = 8;
constexpr int kMaxColorLayers = 4;
constexpr int kRows = 32;           // sample rows per block
constexpr int kThreads = 128;
constexpr int kRowsPerThread = 8;   // register tile of the dense loops
constexpr int kMaxSmemBytes = 232448;
constexpr int kRunRows = 32;      // rows of a warp's run: lane k makes row k's taps
constexpr int kGroupCols = 128;   // rank columns of a warp: 4 per lane
constexpr int kRunThreads = 128;
constexpr int kRunMaxBlocks = 132 * 64;
constexpr int kBwdBatch = 2;      // rows of the factor backward whose loads are in flight
constexpr int kEncBatch = 4;      // the same for the encoder forward
constexpr unsigned kFull = 0xffffffffu;
constexpr double kPi = 3.14159265358979323846;

struct HeadParams {
  const float* pos;   // [M, 3]
  const float* dirs;  // [M, 3], radiance head only
  int M;
  const void* factors[kMaxBanks];  // [3, res_b, rank] each
  int res[kMaxBanks];
  int nb, rank, freq_degree;
  const void* w1;  // [D, H1]
  const void* w2;  // [H1, OUT]
  int D, H1, OUT;
  const void* wc[kMaxColorLayers];  // color layers, [cdim[l], cdim[l + 1]]
  int cdim[kMaxColorLayers + 1];
  int n_color, sh_degree, cmax;
  float* out;  // [M, OUT] (density) or [M, 4] (radiance)
  void* feats_out;  // [M, D] in the weight type, or null (density only)
  void* h1_out;     // [M, H1] in the weight type, or null (density only)
};

struct BwdParams {
  const float* pos;  // [M, 3]
  int M;
  const float* g;  // [M, g_stride] f32; columns b*rank .. b*rank+rank-1 are bank b's
  int g_stride;
  const void* factors[kMaxBanks];  // [3, res_b, rank] each
  float* dfactors;                 // all banks' [3, res_b, rank] f32 accumulators, zeroed
  int df_at[kMaxBanks];            // bank b's first accumulator in dfactors
  int res[kMaxBanks];
  int nb, rank, groups;            // groups: column groups of kGroupCols
};

struct EncodeParams {
  const float* pos;  // [M, 3]
  int M;
  const void* factors[kMaxBanks];  // [3, res_b, rank] each
  int res[kMaxBanks];
  int nb, rank, groups;
  void* out;  // [M, nb * rank] in the output type
};

__device__ __forceinline__ float ld(const float* p, int i) { return __ldg(p + i); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

__device__ __forceinline__ bool in_box(const float* q) {
  return !(q[0] < 0.f || q[0] > 1.f || q[1] < 0.f || q[1] > 1.f || q[2] < 0.f ||
           q[2] > 1.f);
}

// One axis of one bank: the lower tap i0 of the position x (clamped to
// [0, 1]) on a line of res points, and the weight w of tap i0 + 1.
struct Tap {
  int i0;
  float w;
};

__device__ __forceinline__ Tap tap(float x, int res) {
  const float pa = fminf(fmaxf(x, 0.f), 1.f) * (float)(res - 1);
  const int i0 = min((int)floorf(pa), res - 2);
  return {i0, pa - (float)i0};
}

// the f32 lerp of a factor line pair's values lo (tap i0) and hi (i0 + 1)
__device__ __forceinline__ float lerp(float lo, float hi, float w) {
  return lo * (1.f - w) + hi * w;
}

// f32 lerp of rank column r of a [res, rank] factor line at tap t.
template <typename T>
__device__ __forceinline__ float lerp_line(const T* line, Tap t, int rank, int r) {
  return lerp(ld(line, t.i0 * rank + r), ld(line, (t.i0 + 1) * rank + r), t.w);
}

// The CP feature of rank column r of bank f ([3, res, rank]) at q in [0, 1]^3:
// the product of the three axes' lerped line values.
template <typename T>
__device__ __forceinline__ float cp_value(const float* q, const T* f, int res, int rank,
                                          int r) {
  float acc = 1.f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float v = lerp_line(f + (size_t)ax * res * rank, tap(q[ax], res), rank, r);
    acc = ax == 0 ? v : acc * v;
  }
  return acc;
}

// out[m][j] = sum_k in[m][k] * W[k][j] for the block's kRows rows, W [K, J]
// in device memory. relu: apply ReLU and round to T (a hidden layer);
// otherwise the f32 sum is kept (an output layer).
template <typename T>
__device__ void dense(const float* in, int in_stride, int K, const T* W, int J,
                      float* out, int out_stride, bool relu) {
  constexpr int groups = kRows / kRowsPerThread;
  for (int item = threadIdx.x; item < J * groups; item += blockDim.x) {
    const int j = item % J;
    const int g = item / J;
    const float* a = in + g * kRowsPerThread * in_stride;
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = ld(W, k * J + j);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = fmaf(a[r * in_stride + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float v = relu ? round_to<T>(fmaxf(acc[r], 0.f)) : acc[r];
      out[(g * kRowsPerThread + r) * out_stride + j] = v;
    }
  }
}

// The frequency ladder of one axis of x = 2 pos - 1, in the order of
// ngp_tpu_torch/ops/freq.py: put(j, v) for the ladder's column j of this axis,
// x at 0, sin x at 3 and cos x at 6, then sin and cos of each higher octave
// by the double-angle recurrence, three columns apart (one per axis).
template <typename Put>
__device__ __forceinline__ void freq_ladder(float x, int degree, Put put) {
  put(0, x);
  if (degree == 0) return;
  float s = sinf(x), c = cosf(x);
  put(3, s);
  put(6, c);
  for (int d = 1; d < degree; ++d) {
    const float s2 = 2.f * s * c;
    const float c2 = 1.f - 2.f * s * s;
    s = s2;
    c = c2;
    put(3 * (2 * d + 1), s);
    put(3 * (2 * d + 2), c);
  }
}

// feats[m] = [cp features (zero outside [0,1]^3) | freq ladder of 2*pos - 1],
// rounded to T.
template <typename T>
__device__ void cp_features(const HeadParams& p, int row0, float* feats) {
  const int nbR = p.nb * p.rank;
  for (int item = threadIdx.x; item < kRows * nbR; item += blockDim.x) {
    const int m = item / nbR;
    const int c = item - m * nbR;
    const int b = c / p.rank;
    const int r = c - b * p.rank;
    const int row = row0 + m;
    float val = 0.f;
    if (row < p.M) {
      const float* q = p.pos + 3 * row;
      if (in_box(q))
        val = cp_value(q, static_cast<const T*>(p.factors[b]), p.res[b], p.rank, r);
    }
    feats[m * p.D + c] = round_to<T>(val);
  }
  for (int item = threadIdx.x; item < kRows * 3; item += blockDim.x) {
    const int m = item / 3;
    const int ax = item - 3 * m;
    const int row = row0 + m;
    const float x = row < p.M ? 2.f * p.pos[3 * row + ax] - 1.f : -1.f;
    float* o = feats + m * p.D + nbR + ax;
    freq_ladder(x, p.freq_degree, [&](int j, float v) { o[j] = round_to<T>(v); });
  }
}

// h[kRows][OUT] = relu(feats @ w1) @ w2 for rows row0 .. row0 + kRows - 1.
template <typename T>
__device__ void density_rows(const HeadParams& p, int row0, float* feats, float* h1,
                             float* h) {
  cp_features<T>(p, row0, feats);
  __syncthreads();
  dense<T>(feats, p.D, p.D, static_cast<const T*>(p.w1), p.H1, h1, p.H1, true);
  __syncthreads();
  dense<T>(h1, p.H1, p.H1, static_cast<const T*>(p.w2), p.OUT, h, p.OUT, false);
  __syncthreads();
}

__device__ double factorial(int n) {
  double r = 1.0;
  for (int i = 2; i <= n; ++i) r *= i;
  return r;
}

__device__ double double_factorial(int n) {
  double r = 1.0;
  for (; n > 1; n -= 2) r *= n;
  return r;
}

// Real SH basis, degrees 1-8, in the order and with the operations of
// ngp_tpu_torch/ops/sh.py (Sloan recurrence, Condon-Shortley phase):
// put(j, v) for basis column j.
template <typename Put>
__device__ void sh_row(float x, float y, float z, int degree, Put put) {
  float A = 1.f, B = 0.f;
  for (int m = 0; m < degree; ++m) {
    float p_prev = (float)double_factorial(2 * m - 1);
    float p_curr = 0.f;
    for (int l = m; l < degree; ++l) {
      float p;
      if (l == m) {
        p = p_prev;
      } else if (l == m + 1) {
        p = (float)(2 * m + 1) * z * p_prev;
        p_curr = p;
      } else {
        p = ((float)(2 * l - 1) * z * p_curr - (float)(l + m - 1) * p_prev) / (float)(l - m);
        p_prev = p_curr;
        p_curr = p;
      }
      const double k =
          sqrt((2 * l + 1) / (4.0 * kPi) * factorial(l - m) / factorial(l + m));
      if (m == 0) {
        put(l * l + l, (float)k * p);
      } else {
        const float c = (float)(((m & 1) ? -1.0 : 1.0) * sqrt(2.0) * k);
        put(l * l + l + m, (c * p) * A);
        put(l * l + l - m, (c * p) * B);
      }
    }
    const float An = x * A - y * B;
    const float Bn = x * B + y * A;
    A = An;
    B = Bn;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cp_density_kernel(HeadParams p) {
  extern __shared__ float smem[];
  float* feats = smem;
  float* h1 = feats + kRows * p.D;
  float* h = h1 + kRows * p.H1;
  const int row0 = blockIdx.x * kRows;
  density_rows<T>(p, row0, feats, h1, h);
  for (int i = threadIdx.x; i < kRows * p.OUT; i += blockDim.x) {
    const int m = i / p.OUT;
    const int row = row0 + m;
    if (row < p.M) p.out[(size_t)row * p.OUT + (i - m * p.OUT)] = h[i];
  }
  if (p.feats_out == nullptr) return;
  // the residuals: already rounded to T, so the stores are exact
  T* fo = static_cast<T*>(p.feats_out);
  T* ho = static_cast<T*>(p.h1_out);
  for (int i = threadIdx.x; i < kRows * p.D; i += blockDim.x) {
    const int m = i / p.D;
    if (row0 + m < p.M) st(fo, (size_t)row0 * p.D + i, feats[i]);
  }
  for (int i = threadIdx.x; i < kRows * p.H1; i += blockDim.x) {
    const int m = i / p.H1;
    if (row0 + m < p.M) st(ho, (size_t)row0 * p.H1 + i, h1[i]);
  }
}

// ---------------------------------------------------------------------------
// The factor backward and the encoder forward: a warp per (run of kRunRows
// rows, bank, column group of kGroupCols), 4 rank columns a lane.
// ---------------------------------------------------------------------------

// The taps of one row in one bank. A row that is past M or outside [0, 1]^3
// is not live; its taps still name lines of the bank, so loads through them
// stay inside it.
struct RowTaps {
  int i0[3];
  float w[3];
  int live;
};

__device__ __forceinline__ RowTaps lane_taps(const float* pos, int M, int row, int res) {
  float q[3] = {0.f, 0.f, 0.f};
  bool live = row < M;
  if (live) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) q[ax] = __ldg(pos + 3 * (size_t)row + ax);
    live = in_box(q);
  }
  RowTaps t;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const Tap a = tap(q[ax], res);
    t.i0[ax] = a.i0;
    t.w[ax] = a.w;
  }
  t.live = live;
  return t;
}

// row j of the warp's run: lane j's taps, the same in every lane
__device__ __forceinline__ RowTaps run_taps(const RowTaps& mine, int j) {
  RowTaps t;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    t.i0[ax] = __shfl_sync(kFull, mine.i0[ax], j);
    t.w[ax] = __shfl_sync(kFull, mine.w[ax], j);
  }
  t.live = __shfl_sync(kFull, mine.live, j);
  return t;
}

// 4 rank columns by one 16-byte (f32) or 8-byte (bf16) access
__device__ __forceinline__ void ldv4(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

__device__ __forceinline__ void ldv4(const __nv_bfloat16* p, float (&v)[4]) {
  union {
    uint2 u;
    __nv_bfloat162 h[2];
  } r;
  r.u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(r.h[0]), b = __bfloat1622float2(r.h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void stv4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void stv4(__nv_bfloat16* p, const float (&v)[4]) {
  union {
    uint2 u;
    __nv_bfloat162 h[2];
  } r;
  r.h[0] = __floats2bfloat162_rn(v[0], v[1]);
  r.h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = r.u;
}

// A lane's 4 rank columns: adjacent ones, read by one vector access
// (kVec), or columns 32 apart, so that each scalar access of a warp reads 32
// adjacent columns. p points at the first, n columns of the rank lie from it
// on (none when n <= 0).
template <bool kVec>
constexpr int kColStep = kVec ? 1 : 32;

template <bool kVec, typename T>
__device__ __forceinline__ void ld4(const T* p, int n, float (&v)[4]) {
  if (kVec && n > 0) {
    ldv4(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j * kColStep<kVec> < n ? ld(p, j * kColStep<kVec>) : 0.f;
}

template <bool kVec, typename T>
__device__ __forceinline__ void st4(T* p, int n, const float (&v)[4]) {
  if (kVec && n > 0) {
    stv4(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j * kColStep<kVec> < n) st(p, j * kColStep<kVec>, v[j]);
}

// the columns at p += v by f32 atomics: one 16-byte atomic when kVec
template <bool kVec>
__device__ __forceinline__ void add4(float* p, int n, const float (&v)[4]) {
  if (kVec && n > 0) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j * kColStep<kVec> < n) atomicAdd(p + j * kColStep<kVec>, v[j]);
}

// the f32 lerps of rank columns c .. c+3 of axis ax of a [3, res, rank] bank
// at tap (i0, w)
template <bool kVec, typename T>
__device__ __forceinline__ void lerp4(const T* f, int res, int rank, int ax, int i0, float w,
                                      int c, int n, float (&v)[4]) {
  const T* line = f + (ax * res + i0) * rank + c;
  float lo[4], hi[4];
  ld4<kVec>(line, n, lo);
  ld4<kVec>(line + rank, n, hi);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = lerp(lo[j], hi[j], w);
}

// The item (run, bank, column group) a warp owns, column group fastest, then
// bank (kBankFast: neighbouring warps add to different banks) or run (the
// card gathers from one bank at a time); the lane's first column c (of its
// 4, as ld4 lays them out) and the rank's columns from c on, n.
struct RunItem {
  int row0, b, c, n;
};

template <bool kBankFast, bool kVec>
__device__ __forceinline__ RunItem run_item(int item, int M, int nb, int groups, int rank) {
  const int rb = item / groups;
  const int runs = (M + kRunRows - 1) / kRunRows;
  RunItem it;
  it.b = kBankFast ? rb % nb : rb / runs;
  it.row0 = (kBankFast ? rb / nb : rb - it.b * runs) * kRunRows;
  it.c = (item - rb * groups) * kGroupCols + (kVec ? 4 : 1) * (threadIdx.x & 31);
  it.n = rank - it.c;
  return it;
}

// out[m][b * rank + c] = the product over the axes of the f32 lerps of bank
// b's rank column c at row m, zero outside [0, 1]^3, rounded once to O.
template <typename T, typename O, bool kVec>
__global__ void __launch_bounds__(kRunThreads) cp_encode_runs_kernel(EncodeParams p) {
  const int items = (p.M + kRunRows - 1) / kRunRows * p.nb * p.groups;
  const int warps = gridDim.x * (kRunThreads / 32);
  const int nbR = p.nb * p.rank;
  for (int item = blockIdx.x * (kRunThreads / 32) + (threadIdx.x >> 5); item < items;
       item += warps) {
    const RunItem it = run_item<false, kVec>(item, p.M, p.nb, p.groups, p.rank);
    const int res = p.res[it.b];
    const T* f = static_cast<const T*>(p.factors[it.b]);
    const RowTaps mine = lane_taps(p.pos, p.M, it.row0 + (threadIdx.x & 31), res);
    const int rows = min(kRunRows, p.M - it.row0);
    O* o = static_cast<O*>(p.out) + (size_t)it.row0 * nbR + it.b * p.rank + it.c;
    for (int j0 = 0; j0 < rows; j0 += kEncBatch) {
      RowTaps t[kEncBatch];
      float v[kEncBatch][4];
#pragma unroll
      for (int k = 0; k < kEncBatch; ++k) {
        t[k] = run_taps(mine, j0 + k);
        lerp4<kVec>(f, res, p.rank, 0, t[k].i0[0], t[k].w[0], it.c, it.n, v[k]);
#pragma unroll
        for (int ax = 1; ax < 3; ++ax) {
          float a[4];
          lerp4<kVec>(f, res, p.rank, ax, t[k].i0[ax], t[k].w[ax], it.c, it.n, a);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[k][j] *= a[j];
        }
      }
#pragma unroll
      for (int k = 0; k < kEncBatch; ++k) {
        if (j0 + k >= rows) break;
        if (!t[k].live) {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[k][j] = 0.f;
        }
        st4<kVec>(o + (size_t)(j0 + k) * nbR, it.n, v[k]);
      }
    }
  }
}

// One axis of the factor backward's merge: lo and hi are the lane's running
// sums for taps cur and cur + 1 of its columns (line: the axis's first
// accumulator line). When the row's tap i0 differs from cur, the sums are
// added to the accumulators (one atomic each); after a move by one, the sum
// that lands on the new pair stays in registers.
template <bool kVec>
__device__ __forceinline__ void merge_tap(float* line, int rank, int n, int i0, int& cur,
                                          float (&lo)[4], float (&hi)[4]) {
  if (i0 == cur) return;
  if (cur >= 0) {
    if (i0 == cur + 1) {
      add4<kVec>(line + cur * rank, n, lo);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = hi[j];
        hi[j] = 0.f;
      }
    } else if (i0 == cur - 1) {
      add4<kVec>(line + (cur + 1) * rank, n, hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hi[j] = lo[j];
        lo[j] = 0.f;
      }
    } else {
      add4<kVec>(line + cur * rank, n, lo);
      add4<kVec>(line + (cur + 1) * rank, n, hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) lo[j] = hi[j] = 0.f;
    }
  }
  cur = i0;
}

// dF[b][ax] += tent_ax(m)^T (g_b[m] * prod_{ax' != ax} v_ax'[m]) over the
// warp's run, summed in registers while a tap repeats. Rows outside
// [0, 1]^3 add nothing.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kRunThreads) cp_bwd_runs_kernel(BwdParams p) {
  const int items = (p.M + kRunRows - 1) / kRunRows * p.nb * p.groups;
  const int warps = gridDim.x * (kRunThreads / 32);
  for (int item = blockIdx.x * (kRunThreads / 32) + (threadIdx.x >> 5); item < items;
       item += warps) {
    const RunItem it = run_item<true, kVec>(item, p.M, p.nb, p.groups, p.rank);
    const int res = p.res[it.b];
    const T* f = static_cast<const T*>(p.factors[it.b]);
    const RowTaps mine = lane_taps(p.pos, p.M, it.row0 + (threadIdx.x & 31), res);
    const int rows = min(kRunRows, p.M - it.row0);
    const float* g = p.g + it.b * p.rank + it.c;
    float* acc = p.dfactors + p.df_at[it.b] + it.c;
    int cur[3] = {-1, -1, -1};
    float lo[3][4], hi[3][4];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax)
#pragma unroll
      for (int j = 0; j < 4; ++j) lo[ax][j] = hi[ax][j] = 0.f;
    for (int j0 = 0; j0 < rows; j0 += kBwdBatch) {
      // g first: rows past M or outside the box, and rows whose g is zero
      // in all of the warp's columns, add nothing, and their factor lines
      // are not read (live[k] is the same in every lane)
      RowTaps t[kBwdBatch];
      float gv[kBwdBatch][4], v[kBwdBatch][3][4];
      bool live[kBwdBatch];
#pragma unroll
      for (int k = 0; k < kBwdBatch; ++k) {
        t[k] = run_taps(mine, j0 + k);
        ld4<kVec>(g + (size_t)min(it.row0 + j0 + k, p.M - 1) * p.g_stride, it.n, gv[k]);
      }
#pragma unroll
      for (int k = 0; k < kBwdBatch; ++k) {
        const bool nz = gv[k][0] != 0.f || gv[k][1] != 0.f || gv[k][2] != 0.f || gv[k][3] != 0.f;
        live[k] = __any_sync(kFull, nz) && t[k].live;
        if (!live[k]) continue;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax)
          lerp4<kVec>(f, res, p.rank, ax, t[k].i0[ax], t[k].w[ax], it.c, it.n, v[k][ax]);
      }
#pragma unroll
      for (int k = 0; k < kBwdBatch; ++k) {
        if (!live[k]) continue;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const int a = ax == 0 ? 1 : 0, c = ax == 2 ? 1 : 2;
          merge_tap<kVec>(acc + ax * res * p.rank, p.rank, it.n, t[k].i0[ax], cur[ax], lo[ax],
                          hi[ax]);
          const float w = t[k].w[ax];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float o = gv[k][j] * v[k][a][j] * v[k][c][j];
            lo[ax][j] += (1.f - w) * o;
            hi[ax][j] += w * o;
          }
        }
      }
    }
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      if (cur[ax] < 0) continue;
      float* line = acc + (ax * res + cur[ax]) * p.rank;
      add4<kVec>(line, it.n, lo[ax]);
      add4<kVec>(line + p.rank, it.n, hi[ax]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cp_sigma_rgb_kernel(HeadParams p) {
  extern __shared__ float smem[];
  float* feats = smem;
  float* h1 = feats + kRows * p.D;
  float* h = h1 + kRows * p.H1;
  float* ca = h + kRows * p.OUT;
  float* cb = ca + kRows * p.cmax;
  const int row0 = blockIdx.x * kRows;
  density_rows<T>(p, row0, feats, h1, h);
  // color input, SH first: [SH(dir), geo]
  const int nsh = p.sh_degree * p.sh_degree;
  const int geo = p.OUT - 1;
  for (int m = threadIdx.x; m < kRows; m += blockDim.x) {
    const int row = row0 + m;
    const float* d = p.dirs + 3 * (row < p.M ? row : 0);
    float* o = ca + m * p.cmax;
    sh_row(d[0], d[1], d[2], p.sh_degree, [&](int j, float v) { o[j] = round_to<T>(v); });
  }
  for (int i = threadIdx.x; i < kRows * geo; i += blockDim.x) {
    const int m = i / geo;
    const int g = i - m * geo;
    ca[m * p.cmax + nsh + g] = round_to<T>(h[m * p.OUT + 1 + g]);
  }
  __syncthreads();
  float* src = ca;
  float* dst = cb;
  for (int l = 0; l < p.n_color; ++l) {
    const bool last = l == p.n_color - 1;
    dense<T>(src, p.cmax, p.cdim[l], static_cast<const T*>(p.wc[l]), p.cdim[l + 1], dst,
             p.cmax, !last);
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  for (int m = threadIdx.x; m < kRows; m += blockDim.x) {
    const int row = row0 + m;
    if (row >= p.M) continue;
    float* o = p.out + (size_t)row * 4;
    o[0] = expf(h[m * p.OUT]);
    for (int c = 0; c < 3; ++c) o[1 + c] = 1.f / (1.f + expf(-src[m * p.cmax + c]));
  }
}

// ---------------------------------------------------------------------------
// The bf16 heads on the tensor cores (mma.sync m16n8k16, bf16 -> f32).
//
// A persistent block of 16 warps owns one SM and walks tiles of t.rows sample
// rows. The weights sit in shared memory in mma fragment order (w1 [Kp, H1p],
// K padded per bank to a multiple of 16 and H1 to 16, zeros in the padding),
// so each B fragment is one conflict-free 8-byte load: w1 for the block's life
// where it fits (688 rows at turbo-hq), else each K chunk's rows beside that
// chunk's features. A tile's features are made one K chunk at a time (one
// bank's rank columns, at most kTcChunk of them, then the frequency ladder)
// into a double-buffered [rows, kTcChunk] bf16 A tile whose rows are padded by
// 16 bytes, so the fragment loads of 8 rows x 4 column pairs hit 32 distinct
// banks. The 16 warps split a tile into rows / 16 row groups of 16 rows and
// 256 / rows column groups of at most kTcMaxNtw n-tiles (16 f32 accumulators a
// thread, which keeps the K loop at 128 registers): 128-row tiles take
// H1 <= 64, 64-row tiles H1 <= 128 and 32-row tiles H1 <= 256 (tc_rows). The
// second product reads ReLU(h1), rounded to bf16, from a padded shared tile.
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 512;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcChunk = 128;
constexpr int kTcLda = kTcChunk + 8;
constexpr int kTcMaxNtw = 4;        // n-tiles of 8 columns per warp, first product
constexpr int kTcMaxColor = 64;     // widest colour hidden layer (kept in registers)
constexpr int kTcMaxColorIn = 256;  // widest colour input, padded (one shared tile)
// what a launcher returns for a shape its kernel does not take (cudaError
// codes are >= 0); the wrappers raise ValueError for it
constexpr int kUnsupportedShape = -1;

// rows of a tensor-core tile for H1 hidden units, so that each of the 16
// warps holds at most kTcMaxNtw n-tiles of h1; 0 past 256 (the row-block
// kernel takes those)
__host__ __device__ inline int tc_rows(int H1) {
  const int h1p = (H1 + 15) & ~15;
  return h1p <= 64 ? 128 : h1p <= 128 ? 64 : h1p <= 256 ? 32 : 0;
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Element (k, n) of a [K, N] B operand in fragment order: per (k-step of 16,
// n-tile of 8) 32 lanes x {b0, b1}, b0 = rows 2t, 2t+1 and b1 = rows 2t+8,
// 2t+9 of column g, for lane = 4 g + t.
__device__ __forceinline__ int frag_slot(int k, int n, int n_tiles) {
  const int kk = k & 15;
  const int lane = (n & 7) * 4 + ((kk & 7) >> 1);
  return ((((k >> 4) * n_tiles + (n >> 3)) * 32 + lane) << 2) + ((kk >> 3) << 1) + (kk & 1);
}

// The padded widths, tile rows and shared-memory layout of a tensor-core
// head, made on the host (tc_layout) and passed as a kernel parameter, so
// that the kernel reads them from the constant bank and spends no register
// on them.
struct TcShape {
  int rankp, freq, freqp, Kp, H1p, OUTp, rows;
  int resident;                   // w1 held whole in shared memory (else streamed)
  int w2_at, a_at, h1_at, c_at;   // byte offsets of w2, the A tiles, h1, colour layers
  int ldc;                        // row stride of the colour tile (radiance)
};

__host__ __device__ inline TcShape tc_shape(const HeadParams& p, int rows) {
  TcShape t;
  t.rankp = (p.rank + 15) & ~15;
  t.freq = p.D - p.nb * p.rank;
  t.freqp = (t.freq + 15) & ~15;
  t.Kp = p.nb * t.rankp + t.freqp;
  t.H1p = (p.H1 + 15) & ~15;
  t.OUTp = (p.OUT + 7) & ~7;
  t.rows = rows;
  t.resident = 0;
  t.w2_at = t.a_at = t.h1_at = t.c_at = t.ldc = 0;
  return t;
}

// colour layer l's K and N in fragment order: widths padded to 16 (a hidden
// layer's N is the next layer's K), the 3 colours to one n-tile of 8
__host__ __device__ inline int color_kp(const HeadParams& p, int l) {
  return (p.cdim[l] + 15) & ~15;
}
__host__ __device__ inline int color_np(const HeadParams& p, int l) {
  return l == p.n_color - 1 ? 8 : (p.cdim[l + 1] + 15) & ~15;
}

// rows of w1 in shared memory: all Kp (resident), or two chunks' (streamed)
__host__ __device__ inline int tc_w1_rows(const TcShape& t, bool resident) {
  return resident ? t.Kp : 2 * kTcChunk;
}

// w1, w2, the two A tiles, the h1 tile and (radiance) the colour layers
__host__ __device__ inline size_t tc_smem_bytes(const HeadParams& p, const TcShape& t,
                                                bool resident) {
  size_t color = 0;
  for (int l = 0; l < p.n_color; ++l) color += (size_t)color_kp(p, l) * color_np(p, l);
  return 2 * ((size_t)tc_w1_rows(t, resident) * t.H1p + (size_t)t.H1p * t.OUTp +
              2 * (size_t)t.rows * kTcLda + (size_t)t.rows * (t.H1p + 8) + color);
}

// the shape of a head at these tile rows, with its shared-memory layout in
// the order of tc_smem_bytes (every offset a multiple of 16 bytes)
inline TcShape tc_layout(const HeadParams& p, int rows, bool resident) {
  TcShape t = tc_shape(p, rows);
  t.resident = resident;
  t.w2_at = 2 * tc_w1_rows(t, resident) * t.H1p;
  t.a_at = t.w2_at + 2 * t.H1p * t.OUTp;
  t.h1_at = t.a_at + 2 * 2 * rows * kTcLda;
  t.c_at = t.h1_at + 2 * rows * (t.H1p + 8);
  // the colour tile: the input, then each hidden layer, 16 bytes of padding
  if (p.n_color > 0) t.ldc = (color_kp(p, 0) > kTcMaxColor ? color_kp(p, 0) : kTcMaxColor) + 8;
  return t;
}

// The one source of the route of a bf16 head (density: n_color 0): the rows of
// the tensor-core kernel's tiles, or 0 for the row-block kernel, which takes
// an H1 past 256, a colour hidden layer wider than kTcMaxColor, a colour input
// wider than kTcMaxColorIn, and shapes whose tensor-core layout does not fit
// in shared memory even with w1 streamed.
int tc_route(const HeadParams& p) {
  const int rows = tc_rows(p.H1);
  if (rows == 0) return 0;
  for (int l = 0; l < p.n_color; ++l)
    if (color_kp(p, l) > (l == 0 ? kTcMaxColorIn : kTcMaxColor)) return 0;
  return tc_smem_bytes(p, tc_shape(p, rows), false) <= (size_t)kMaxSmemBytes ? rows : 0;
}

// the block's shared memory: w1 and w2 (and the colour layers) in fragment
// order, the double-buffered A tile, the h1 tile
struct TcSmem {
  uint2* w1s;
  uint2* w2s;
  uint2* cws;
  __nv_bfloat16* abuf;
  __nv_bfloat16* sh1;
};

__device__ inline TcSmem tc_smem(const TcShape& t, unsigned char* base) {
  TcSmem s;
  s.w1s = reinterpret_cast<uint2*>(base);
  s.w2s = reinterpret_cast<uint2*>(base + t.w2_at);
  s.abuf = reinterpret_cast<__nv_bfloat16*>(base + t.a_at);
  s.sh1 = reinterpret_cast<__nv_bfloat16*>(base + t.h1_at);
  s.cws = reinterpret_cast<uint2*>(base + t.c_at);
  return s;
}

// w1's row of padded K index kp, or -1 for a padding row
__device__ __forceinline__ int w1_row(const HeadParams& p, const TcShape& t, int kp) {
  const int nbp = p.nb * t.rankp;
  if (kp < nbp) {
    const int b = kp / t.rankp;
    const int c = kp - b * t.rankp;
    return c < p.rank ? b * p.rank + c : -1;
  }
  return kp - nbp < t.freq ? p.nb * p.rank + kp - nbp : -1;
}

// w1's padded K rows kp0 .. kp0 + nk - 1 (kp0 a multiple of 16) into dst in
// fragment order, zeros in the padding; vec: w1's rows are whole 16-byte
// vectors, so one load brings 8 columns
__device__ void load_w1(const HeadParams& p, const TcShape& t, int kp0, int nk, bool vec,
                        __nv_bfloat16* dst) {
  const __nv_bfloat16* w1 = static_cast<const __nv_bfloat16*>(p.w1);
  const int nt1 = t.H1p >> 3;
  if (vec) {
    const int vpr = t.H1p >> 3;
    for (int i = threadIdx.x; i < nk * vpr; i += kTcThreads) {
      const int k = i / vpr, n0 = 8 * (i - k * vpr);
      const int r = w1_row(p, t, kp0 + k);
      union {
        uint4 u;
        __nv_bfloat16 h[8];
      } v;
      v.u = (r >= 0 && n0 < p.H1)
                ? __ldg(reinterpret_cast<const uint4*>(w1 + (size_t)r * p.H1 + n0))
                : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[frag_slot(k, n0 + j, nt1)] = v.h[j];
    }
  } else {
    for (int i = threadIdx.x; i < nk * t.H1p; i += kTcThreads) {
      const int k = i / t.H1p, n = i - k * t.H1p;
      const int r = w1_row(p, t, kp0 + k);
      dst[frag_slot(k, n, nt1)] =
          (r >= 0 && n < p.H1) ? w1[(size_t)r * p.H1 + n] : __float2bfloat16(0.f);
    }
  }
}

// up to 8 bf16 of a factor line: one 16-byte load, or n scalar loads (the
// rank tail, or lines that are not 16-byte aligned); zeros past n
__device__ __forceinline__ uint4 ld_cols(const __nv_bfloat16* src, int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
  union {
    uint4 u;
    unsigned short s[8];
  } r;
  r.u = make_uint4(0u, 0u, 0u, 0u);
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < n) r.s[j] = __ldg(s16 + j);
  return r.u;
}

// The taps of 8 rank columns of one bank at one row: loaded first, so that a
// thread has two items' twelve loads in flight before it does arithmetic.
struct Gather8 {
  uint4 lo[3], hi[3];
  float w[3];
  bool live;
};

__device__ __forceinline__ void gather_load(const HeadParams& p, int b, int row, int c, bool vec,
                                            Gather8& G) {
  const int n = min(8, p.rank - c);
  G.live = false;
  if (row >= p.M || n <= 0) return;
  const float q[3] = {__ldg(p.pos + 3 * row), __ldg(p.pos + 3 * row + 1),
                      __ldg(p.pos + 3 * row + 2)};
  if (!in_box(q)) return;
  G.live = true;
  const int res = p.res[b];
  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(p.factors[b]);
  const bool v8 = vec && n == 8;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const Tap t = tap(q[ax], res);
    G.w[ax] = t.w;
    const __nv_bfloat16* line = f + ((size_t)ax * res + t.i0) * p.rank + c;
    G.lo[ax] = ld_cols(line, n, v8);
    G.hi[ax] = ld_cols(line + p.rank, n, v8);
  }
}

// the 8 CP features (f32 lerps, product over the axes), rounded to bf16
__device__ __forceinline__ uint4 gather_finish(const Gather8& G) {
  union {
    uint4 u;
    __nv_bfloat162 h[4];
  } lo, hi, out;
  out.u = make_uint4(0u, 0u, 0u, 0u);
  if (!G.live) return out.u;
  float acc[8];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    lo.u = G.lo[ax];
    hi.u = G.hi[ax];
    const float w = G.w[ax];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 l = __bfloat1622float2(lo.h[j]);
      const float2 h = __bfloat1622float2(hi.h[j]);
      const float v0 = lerp(l.x, h.x, w);
      const float v1 = lerp(l.y, h.y, w);
      acc[2 * j] = ax == 0 ? v0 : acc[2 * j] * v0;
      acc[2 * j + 1] = ax == 0 ? v1 : acc[2 * j + 1] * v1;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out.h[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
  return out.u;
}

// A tile columns 0 .. kc-1 = bank b's rank columns c0 .. c0+kc-1 (zero past
// the rank and for rows outside [0, 1]^3 or past M)
__device__ void fill_bank_chunk(const HeadParams& p, const TcShape& t, int row0, int b, int c0,
                                int kc, bool vec, __nv_bfloat16* A) {
  const int groups = kc >> 3;
  const int items = t.rows * groups;
  for (int i = threadIdx.x; i < items; i += 2 * kTcThreads) {
    const int i1 = i + kTcThreads;
    const int m0 = i / groups, g0 = i - m0 * groups;
    const int m1 = i1 / groups, g1 = i1 - m1 * groups;
    Gather8 G0, G1;
    gather_load(p, b, row0 + m0, c0 + 8 * g0, vec, G0);
    if (i1 < items) gather_load(p, b, row0 + m1, c0 + 8 * g1, vec, G1);
    *reinterpret_cast<uint4*>(A + m0 * kTcLda + 8 * g0) = gather_finish(G0);
    if (i1 < items) *reinterpret_cast<uint4*>(A + m1 * kTcLda + 8 * g1) = gather_finish(G1);
  }
}

// chunk column j of an A tile row, if the chunk has it
__device__ __forceinline__ void put_freq(__nv_bfloat16* row, int j, int kc, float v) {
  if (j >= 0 && j < kc) row[j] = __float2bfloat16(v);
}

// A tile columns 0 .. kc-1 = frequency columns c0 .. c0+kc-1 of 2 pos - 1,
// zero past the ladder
__device__ void fill_freq_chunk(const HeadParams& p, const TcShape& t, int row0, int c0, int kc,
                                __nv_bfloat16* A) {
  const int pad0 = max(t.freq - c0, 0);
  for (int i = threadIdx.x; i < t.rows * (kc - pad0); i += kTcThreads) {
    const int m = i / (kc - pad0);
    A[m * kTcLda + pad0 + (i - m * (kc - pad0))] = __float2bfloat16(0.f);
  }
  for (int i = threadIdx.x; i < t.rows * 3; i += kTcThreads) {
    const int m = i / 3;
    const int ax = i - 3 * m;
    const int row = row0 + m;
    const float x = row < p.M ? 2.f * __ldg(p.pos + 3 * row + ax) - 1.f : -1.f;
    // ladder column 3 k + ax lands at chunk column 3 k + ax - c0
    __nv_bfloat16* arow = A + m * kTcLda;
    const int j0 = ax - c0;
    freq_ladder(x, p.freq_degree, [&](int j, float v) { put_freq(arow, j0 + j, kc, v); });
  }
}

// the residual feats columns of this chunk, from the A tile (coalesced 2-byte
// stores: the [M, D] rows are D * 2 bytes apart, 1358 at turbo-hq)
__device__ void store_feats(const HeadParams& p, const TcShape& t, int row0, int seg, int c0,
                            int kc, const __nv_bfloat16* A) {
  const bool freq = seg == p.nb;
  const int ncols = min(kc, (freq ? t.freq : p.rank) - c0);
  const int gcol = (freq ? p.nb * p.rank : seg * p.rank) + c0;
  __nv_bfloat16* fo = static_cast<__nv_bfloat16*>(p.feats_out);
  for (int m = threadIdx.x >> 5; m < t.rows && row0 + m < p.M; m += kTcWarps) {
    __nv_bfloat16* dst = fo + (size_t)(row0 + m) * p.D + gcol;
    for (int j = threadIdx.x & 31; j < ncols; j += 32) dst[j] = A[m * kTcLda + j];
  }
}

// acc[i] += A rows (16 of this warp) x w1 columns of n-tile nt0 + i, over kc
// columns of the chunk whose first padded K row is 16 ks0
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* A, int kc, const uint2* w1s,
                                          int ks0, int n_tiles, int nt0, int ntw,
                                          float (&acc)[kTcMaxNtw][4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* a_lo = A + (lane >> 2) * kTcLda + 2 * (lane & 3);
  const __nv_bfloat16* a_hi = a_lo + 8 * kTcLda;
  for (int k0 = 0; k0 < kc; k0 += 16) {
    const uint32_t a0 = lds32(a_lo + k0), a1 = lds32(a_hi + k0);
    const uint32_t a2 = lds32(a_lo + k0 + 8), a3 = lds32(a_hi + k0 + 8);
    const uint2* bk = w1s + ((ks0 + (k0 >> 4)) * n_tiles + nt0) * 32 + lane;
#pragma unroll
    for (int i = 0; i < kTcMaxNtw; ++i) {
      if (i < ntw) {
        const uint2 bb = bk[32 * i];
        mma_bf16(acc[i], a0, a1, a2, a3, bb.x, bb.y);
      }
    }
  }
}

// The prologue of both kernels: w2 (and a resident w1) into shared memory in
// fragment order, once per block.
__device__ void tc_load_weights(const HeadParams& p, const TcShape& t, const TcSmem& s,
                                int flags) {
  const int nt2 = t.OUTp >> 3;
  const __nv_bfloat16* w2 = static_cast<const __nv_bfloat16*>(p.w2);
  __nv_bfloat16* w2h = reinterpret_cast<__nv_bfloat16*>(s.w2s);
  if (t.resident) load_w1(p, t, 0, t.Kp, flags & 2, reinterpret_cast<__nv_bfloat16*>(s.w1s));
  for (int i = threadIdx.x; i < t.H1p * t.OUTp; i += kTcThreads) {
    const int k = i / t.OUTp, n = i - k * t.OUTp;
    w2h[frag_slot(k, n, nt2)] =
        (k < p.H1 && n < p.OUT) ? w2[(size_t)k * p.OUT + n] : __float2bfloat16(0.f);
  }
}

// h1 = round(relu(feats @ w1)) of the tile at row0 into the shared h1 tile.
// The features are made a K chunk at a time into the A buffer `parity` names
// (with residuals, stored as they are made); warp w multiplies the 16 rows of
// row group w % (rows / 16) into its column group's n-tiles. Ends with a
// barrier, after which every warp may read the h1 tile.
__device__ void tc_tile_h1(const HeadParams& p, const TcShape& t, const TcSmem& s, int row0,
                           int flags, int& parity) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rgs = t.rows >> 4;      // row groups of 16 rows
  const int cgs = kTcWarps / rgs;   // column groups
  const int rg = warp % rgs;
  const int nt1 = t.H1p >> 3;
  const int ntw = (nt1 + cgs - 1) / cgs;  // <= kTcMaxNtw (tc_rows)
  const int nt0 = warp / rgs * ntw;
  const int nth = min(ntw, nt1 - nt0);    // this warp's n-tiles: none past H1p
  const int ldh = t.H1p + 8;
  __nv_bfloat16* w1h = reinterpret_cast<__nv_bfloat16*>(s.w1s);
  float acc[kTcMaxNtw][4];
#pragma unroll
  for (int i = 0; i < kTcMaxNtw; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int seg = 0; seg <= p.nb; ++seg) {
    const int segp = seg == p.nb ? t.freqp : t.rankp;
    for (int c0 = 0; c0 < segp; c0 += kTcChunk) {
      const int kc = min(kTcChunk, segp - c0);
      const int kp0 = seg * t.rankp + c0;  // the chunk's first padded K row
      const int buf = parity;
      parity ^= 1;
      __nv_bfloat16* A = s.abuf + buf * t.rows * kTcLda;
      if (!t.resident) load_w1(p, t, kp0, kc, flags & 2, w1h + buf * kTcChunk * t.H1p);
      if (seg == p.nb)
        fill_freq_chunk(p, t, row0, c0, kc, A);
      else
        fill_bank_chunk(p, t, row0, seg, c0, kc, flags & 1, A);
      // the buffers filled two chunks ago were last read before this barrier
      __syncthreads();
      if (p.feats_out != nullptr) store_feats(p, t, row0, seg, c0, kc, A);
      if (nth <= 0) continue;
      if (t.resident)
        mma_chunk(A + rg * 16 * kTcLda, kc, s.w1s, kp0 >> 4, nt1, nt0, nth, acc);
      else
        mma_chunk(A + rg * 16 * kTcLda, kc, s.w1s + buf * kTcChunk * t.H1p / 4, 0, nt1, nt0,
                  nth, acc);
    }
  }
  // the previous tile's reads of the h1 tile came before this tile's chunk barriers
#pragma unroll
  for (int i = 0; i < kTcMaxNtw; ++i) {
    if (i < nth) {
      __nv_bfloat16* o = s.sh1 + (rg * 16 + g) * ldh + (nt0 + i) * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(o) =
          __floats2bfloat162_rn(fmaxf(acc[i][0], 0.f), fmaxf(acc[i][1], 0.f));
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * ldh) =
          __floats2bfloat162_rn(fmaxf(acc[i][2], 0.f), fmaxf(acc[i][3], 0.f));
    }
  }
  __syncthreads();
}

// d += rows 16 r16 .. 16 r16 + 15 of the h1 tile times n-tile nt of w2
__device__ __forceinline__ void h1_w2_ntile(const TcShape& t, const TcSmem& s, int r16, int nt,
                                            float (&d)[4]) {
  const int lane = threadIdx.x & 31, nt2 = t.OUTp >> 3, ldh = t.H1p + 8;
  const __nv_bfloat16* a_lo = s.sh1 + (r16 * 16 + (lane >> 2)) * ldh + 2 * (lane & 3);
  const __nv_bfloat16* a_hi = a_lo + 8 * ldh;
  for (int k0 = 0; k0 < t.H1p; k0 += 16) {
    const uint2 bb = s.w2s[((k0 >> 4) * nt2 + nt) * 32 + lane];
    mma_bf16(d, lds32(a_lo + k0), lds32(a_hi + k0), lds32(a_lo + k0 + 8), lds32(a_hi + k0 + 8),
             bb.x, bb.y);
  }
}

// The density epilogue of the tile at row0: out = h1 @ w2 in f32, one
// (16-row group, n-tile) item per warp, and the h1 residual rows.
__device__ void tc_density_out(const HeadParams& p, const TcShape& t, const TcSmem& s,
                               int row0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rgs = t.rows >> 4, ldh = t.H1p + 8;
  for (int item = warp; item < rgs * (t.OUTp >> 3); item += kTcWarps) {
    const int r16 = item % rgs, nt = item / rgs;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    h1_w2_ntile(t, s, r16, nt, d);
    const int col = nt * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + r16 * 16 + (lane >> 2) + 8 * h;
      if (row >= p.M) continue;
      float* o = p.out + (size_t)row * p.OUT;
      if (col < p.OUT) o[col] = d[2 * h];
      if (col + 1 < p.OUT) o[col + 1] = d[2 * h + 1];
    }
  }
  if (p.h1_out == nullptr) return;
  __nv_bfloat16* ho = static_cast<__nv_bfloat16*>(p.h1_out);
  if ((p.H1 & 7) == 0) {
    const int vpr = p.H1 >> 3;
    for (int i = threadIdx.x; i < t.rows * vpr; i += kTcThreads) {
      const int m = i / vpr, v = i - m * vpr;
      if (row0 + m < p.M)
        *reinterpret_cast<uint4*>(ho + (size_t)(row0 + m) * p.H1 + 8 * v) =
            *reinterpret_cast<const uint4*>(s.sh1 + m * ldh + 8 * v);
    }
  } else {
    for (int i = threadIdx.x; i < t.rows * p.H1; i += kTcThreads) {
      const int m = i / p.H1, j = i - m * p.H1;
      if (row0 + m < p.M) ho[(size_t)(row0 + m) * p.H1 + j] = s.sh1[m * ldh + j];
    }
  }
}

// the colour layers into shared memory in fragment order, once per block
__device__ void tc_load_color(const HeadParams& p, const TcSmem& s) {
  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(s.cws);
  for (int l = 0; l < p.n_color; ++l) {
    const int kp = color_kp(p, l), np = color_np(p, l);
    const int K = p.cdim[l], N = p.cdim[l + 1];
    const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.wc[l]);
    for (int i = threadIdx.x; i < kp * np; i += kTcThreads) {
      const int k = i / np, n = i - k * np;
      dst[frag_slot(k, n, np >> 3)] =
          (k < K && n < N) ? w[(size_t)k * N + n] : __float2bfloat16(0.f);
    }
    dst += kp * np;
  }
}

// acc[j] += the A fragment (a0 .. a3) times n-tile j < nt of a B operand in
// fragment order (b: this lane's slot in the k-step's first n-tile)
__device__ __forceinline__ void mma_ntiles(float (&acc)[8][4], const uint2* b, int nt,
                                           uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nt) {
      const uint2 bb = b[32 * j];
      mma_bf16(acc[j], a0, a1, a2, a3, bb.x, bb.y);
    }
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The radiance epilogue of the tile at row0, all on chip. Warps w < rows / 16
// take the second product of row group w: sigma = exp(column 0) stays in
// registers, and the geo columns 1 .. OUT-1, rounded to bf16, go into the
// colour tile (in the A buffers, free once the K loop is done) after the SH
// columns, which the other warps make meanwhile, one row per thread; sigma
// waits in the row's 16 bytes of padding, which no product reads. Then each of
// those warps runs its 16 rows through the colour MLP, each layer's A
// fragments from its rows of the tile and its output (ReLU, bf16) back into
// them, and stores (sigma, r, g, b) as one 16-byte row. Ends with a barrier:
// the next tile refills the A buffers.
__device__ void tc_radiance_out(const HeadParams& p, const TcShape& t, const TcSmem& s,
                                int row0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rgs = t.rows >> 4;
  const int nsh = p.sh_degree * p.sh_degree;
  const int cin = p.cdim[0], kc0 = color_kp(p, 0);
  const int ldc = t.ldc;
  __nv_bfloat16* ctile = s.abuf;              // [rows, ldc]
  // sigma of tile row m, in the row's padding (4-byte aligned: ldc is even)
  auto sigma = [&](int m) -> float& {
    return *reinterpret_cast<float*>(ctile + m * ldc + ldc - 8);
  };
  if (warp < rgs) {
    __nv_bfloat16* geo = ctile + (warp * 16 + g) * ldc + nsh - 1;  // geo column c at geo[c]
    for (int nt = 0; nt < (t.OUTp >> 3); ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      h1_w2_ntile(t, s, warp, nt, d);
      if (nt == 0 && tq == 0) {
        sigma(warp * 16 + g) = expf(d[0]);
        sigma(warp * 16 + g + 8) = expf(d[2]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * tq + (e & 1);
        if (c >= 1 && c < p.OUT) geo[(e >> 1) * 8 * ldc + c] = __float2bfloat16(d[e]);
      }
    }
    for (int i = lane; i < 16 * (kc0 - cin); i += 32) {
      const int m = i / (kc0 - cin);
      ctile[(warp * 16 + m) * ldc + cin + i - m * (kc0 - cin)] = __float2bfloat16(0.f);
    }
  } else {
    for (int m = threadIdx.x - 32 * rgs; m < t.rows; m += kTcThreads - 32 * rgs) {
      const int row = row0 + m;
      const bool in = row < p.M;
      const float dx = in ? __ldg(p.dirs + 3 * row) : 0.f;
      const float dy = in ? __ldg(p.dirs + 3 * row + 1) : 0.f;
      const float dz = in ? __ldg(p.dirs + 3 * row + 2) : 0.f;
      __nv_bfloat16* crow = ctile + m * ldc;
      sh_row(dx, dy, dz, p.sh_degree, [crow](int j, float v) { crow[j] = __float2bfloat16(v); });
    }
  }
  __syncthreads();
  if (warp < rgs) {
    __nv_bfloat16* c_lo = ctile + (warp * 16 + g) * ldc + 2 * tq;
    __nv_bfloat16* c_hi = c_lo + 8 * ldc;
    const uint2* wl = s.cws + lane;
    float acc[8][4];
    for (int l = 0; l < p.n_color; ++l) {
      const int ks = color_kp(p, l) >> 4, nt = color_np(p, l) >> 3;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < ks; ++kk) {
        const int k0 = 16 * kk;
        mma_ntiles(acc, wl + kk * nt * 32, nt, lds32(c_lo + k0), lds32(c_hi + k0),
                   lds32(c_lo + k0 + 8), lds32(c_hi + k0 + 8));
      }
      wl += ks * nt * 32;
      if (l == p.n_color - 1) break;
      // ReLU(out), rounded to bf16, over this warp's rows: the next layer's input
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
          *reinterpret_cast<__nv_bfloat162*>(c_lo + 8 * j) =
              __floats2bfloat162_rn(fmaxf(acc[j][0], 0.f), fmaxf(acc[j][1], 0.f));
          *reinterpret_cast<__nv_bfloat162*>(c_hi + 8 * j) =
              __floats2bfloat162_rn(fmaxf(acc[j][2], 0.f), fmaxf(acc[j][3], 0.f));
        }
      }
      __syncwarp();
    }
    // the colours sit in n-tile 0: columns 0, 1 in lanes tq == 0, column 2 in tq == 1
    const float b_lo = __shfl_down_sync(0xffffffffu, acc[0][0], 1);
    const float b_hi = __shfl_down_sync(0xffffffffu, acc[0][2], 1);
    if (tq == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + warp * 16 + g + 8 * h;
        if (row < p.M)
          reinterpret_cast<float4*>(p.out)[row] =
              make_float4(sigma(warp * 16 + g + 8 * h), sigmoid(acc[0][2 * h]),
                          sigmoid(acc[0][2 * h + 1]), sigmoid(h ? b_hi : b_lo));
      }
    }
  }
  __syncthreads();
}

// flags: bit 0, 16-byte factor gathers; bit 1, 16-byte w1 row loads
__global__ void __launch_bounds__(kTcThreads, 1)
    cp_density_tc_kernel(HeadParams p, TcShape t, int flags) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const TcSmem s = tc_smem(t, smem_tc);
  tc_load_weights(p, t, s, flags);
  __syncthreads();
  const int n_tiles = (p.M + t.rows - 1) / t.rows;
  int parity = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    tc_tile_h1(p, t, s, tile * t.rows, flags, parity);
    tc_density_out(p, t, s, tile * t.rows);
  }
}

// the radiance head: the density head's tile code, then tc_radiance_out
__global__ void __launch_bounds__(kTcThreads, 1)
    cp_sigma_rgb_tc_kernel(HeadParams p, TcShape t, int flags) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const TcSmem s = tc_smem(t, smem_tc);
  tc_load_weights(p, t, s, flags);
  tc_load_color(p, s);
  __syncthreads();
  const int n_tiles = (p.M + t.rows - 1) / t.rows;
  int parity = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    tc_tile_h1(p, t, s, tile * t.rows, flags, parity);
    tc_radiance_out(p, t, s, tile * t.rows);
  }
}

// a tensor-core head at the route's tile rows: one persistent block per SM,
// at most one per tile
int launch_tc(void (*kern)(HeadParams, TcShape, int), const HeadParams& p, int rows,
              cudaStream_t stream) {
  const bool resident = tc_smem_bytes(p, tc_shape(p, rows), true) <= (size_t)kMaxSmemBytes;
  const TcShape t = tc_layout(p, rows, resident);
  const size_t bytes = tc_smem_bytes(p, t, resident);
  if (p.M == 0) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = (p.M + rows - 1) / rows;
  int flags = p.rank % 8 == 0;
  for (int b = 0; b < p.nb; ++b) flags &= (uintptr_t)p.factors[b] % 16 == 0;
  flags |= (p.H1 % 8 == 0 && (uintptr_t)p.w1 % 16 == 0) << 1;
  kern<<<tiles < sms ? tiles : sms, kTcThreads, bytes, stream>>>(p, t, flags);
  return cudaGetLastError();
}

size_t smem_bytes(const HeadParams& p, bool radiance) {
  size_t floats = (size_t)kRows * (p.D + p.H1 + p.OUT);
  if (radiance) floats += 2 * (size_t)kRows * p.cmax;
  return floats * sizeof(float);
}

// the row-block heads: the f32 heads, and the bf16 heads tc_route gives them
int launch(void (*kern)(HeadParams), const HeadParams& p, cudaStream_t stream, bool radiance) {
  const size_t bytes = smem_bytes(p, radiance);
  if (bytes > (size_t)kMaxSmemBytes) return kUnsupportedShape;
  if (p.M == 0) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int blocks = (p.M + kRows - 1) / kRows;
  kern<<<blocks, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

bool fill_density(HeadParams& p, const float* pos, int M, const void* const* factors,
                  const int* res, int nb, int rank, int freq_degree, const void* w1,
                  const void* w2, int D, int H1, int OUT, float* out) {
  if (nb < 1 || nb > kMaxBanks || rank < 1 || freq_degree < 0) return false;
  if (D != nb * rank + 3 * (1 + 2 * freq_degree) || H1 < 1 || OUT < 1 || M < 0) return false;
  p.pos = pos;
  p.dirs = nullptr;
  p.M = M;
  for (int b = 0; b < nb; ++b) {
    if (res[b] < 2) return false;
    p.factors[b] = factors[b];
    p.res[b] = res[b];
  }
  p.nb = nb;
  p.rank = rank;
  p.freq_degree = freq_degree;
  p.w1 = w1;
  p.w2 = w2;
  p.D = D;
  p.H1 = H1;
  p.OUT = OUT;
  p.n_color = 0;
  p.sh_degree = 0;
  p.cmax = 0;
  p.out = out;
  p.feats_out = nullptr;
  p.h1_out = nullptr;
  return true;
}

// The one source of the backward's and the encoder's route: the vector
// instance when every row and column group of the banks starts on a 4-column
// access (8 bytes in bf16, 16 in f32), else the scalar-column one.
bool vec_route(const void* const* factors, int nb, int rank, int itemsize) {
  if (rank % 4 != 0) return false;
  for (int b = 0; b < nb; ++b)
    if ((uintptr_t)factors[b] % (4 * itemsize) != 0) return false;
  return true;
}

// the run kernels: one warp per item, at most kRunMaxBlocks blocks
template <typename P>
int launch_runs(void (*kern)(P), const P& p, cudaStream_t stream) {
  const long long items =
      (long long)((p.M + kRunRows - 1) / kRunRows) * p.nb * p.groups;
  if (items == 0) return cudaSuccess;
  if (items > 0x7fffffffLL) return kUnsupportedShape;
  constexpr int kWarps = kRunThreads / 32;
  const long long want = (items + kWarps - 1) / kWarps;
  kern<<<(int)(want < kRunMaxBlocks ? want : kRunMaxBlocks), kRunThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// bank sizes the run kernels index in 32-bit arithmetic
bool fill_banks(const void* const* factors, const int* res, int nb, int rank,
                const void** p_factors, int* p_res) {
  if (nb < 1 || nb > kMaxBanks || rank < 1) return false;
  long long total = 0;
  for (int b = 0; b < nb; ++b) {
    if (res[b] < 2) return false;
    total += 3LL * res[b] * rank;
    p_factors[b] = factors[b];
    p_res[b] = res[b];
  }
  return total <= 0x7fffffffLL;
}

}  // namespace

extern "C" int ngp_cp_density_fwd(const float* pos, int M, const void* const* factors,
                                  const int* res, int nb, int rank, int freq_degree,
                                  const void* w1, const void* w2, int D, int H1, int OUT,
                                  int bf16, float* out, void* feats_out, void* h1_out,
                                  int* route, void* stream) {
  HeadParams p;
  if (!fill_density(p, pos, M, factors, res, nb, rank, freq_degree, w1, w2, D, H1, OUT, out))
    return cudaErrorInvalidValue;
  if ((feats_out == nullptr) != (h1_out == nullptr)) return cudaErrorInvalidValue;
  p.feats_out = feats_out;
  p.h1_out = h1_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // route: the tensor-core kernel's tile rows, or 0 for the row-block kernel
  const int rows = bf16 ? tc_route(p) : 0;
  *route = rows;
  if (rows > 0) return launch_tc(cp_density_tc_kernel, p, rows, s);
  return bf16 ? launch(&cp_density_kernel<__nv_bfloat16>, p, s, false)
              : launch(&cp_density_kernel<float>, p, s, false);
}

extern "C" int ngp_cp_bwd_banks(const float* pos, int M, const float* g, int g_stride,
                                const void* const* factors, const int* res, int nb, int rank,
                                int bf16, float* dfactors, void* stream) {
  BwdParams p;
  if (!fill_banks(factors, res, nb, rank, p.factors, p.res) || M < 0 || g_stride < nb * rank)
    return cudaErrorInvalidValue;
  p.pos = pos;
  p.M = M;
  p.g = g;
  p.g_stride = g_stride;
  p.dfactors = dfactors;
  p.nb = nb;
  p.rank = rank;
  p.groups = (rank + kGroupCols - 1) / kGroupCols;
  for (int b = 0, at = 0; b < nb; at += 3 * res[b] * rank, ++b) p.df_at[b] = at;
  const bool vec = vec_route(factors, nb, rank, bf16 ? 2 : 4) && g_stride % 4 == 0 &&
                   (uintptr_t)g % 16 == 0 && (uintptr_t)dfactors % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return vec ? launch_runs(&cp_bwd_runs_kernel<__nv_bfloat16, true>, p, s)
               : launch_runs(&cp_bwd_runs_kernel<__nv_bfloat16, false>, p, s);
  return vec ? launch_runs(&cp_bwd_runs_kernel<float, true>, p, s)
             : launch_runs(&cp_bwd_runs_kernel<float, false>, p, s);
}

extern "C" int ngp_cp_sigma_rgb(const float* pos, const float* dirs, int M,
                                const void* const* factors, const int* res, int nb, int rank,
                                int freq_degree, const void* w1, const void* w2, int D, int H1,
                                int OUT, const void* const* color_ws, const int* cdims,
                                int n_color, int sh_degree, int bf16, float* out,
                                int* route, void* stream) {
  HeadParams p;
  if (!fill_density(p, pos, M, factors, res, nb, rank, freq_degree, w1, w2, D, H1, OUT, out))
    return cudaErrorInvalidValue;
  if (n_color < 1 || n_color > kMaxColorLayers || sh_degree < 1 || sh_degree > 8 || OUT < 2)
    return cudaErrorInvalidValue;
  if (cdims[0] != sh_degree * sh_degree + OUT - 1 || cdims[n_color] != 3)
    return cudaErrorInvalidValue;
  p.dirs = dirs;
  p.n_color = n_color;
  p.sh_degree = sh_degree;
  int cmax = 0;
  for (int l = 0; l <= n_color; ++l) {
    if (cdims[l] < 1) return cudaErrorInvalidValue;
    p.cdim[l] = cdims[l];
    cmax = cdims[l] > cmax ? cdims[l] : cmax;
  }
  for (int l = 0; l < n_color; ++l) p.wc[l] = color_ws[l];
  p.cmax = cmax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // route: the tensor-core kernel's tile rows, or 0 for the row-block kernel
  const int rows = bf16 ? tc_route(p) : 0;
  *route = rows;
  if (rows > 0) return launch_tc(cp_sigma_rgb_tc_kernel, p, rows, s);
  return bf16 ? launch(&cp_sigma_rgb_kernel<__nv_bfloat16>, p, s, true)
              : launch(&cp_sigma_rgb_kernel<float>, p, s, true);
}

extern "C" int ngp_cp_encode_fwd(const float* pos, int M, const void* const* factors,
                                 const int* res, int nb, int rank, int bf16, int out_bf16,
                                 void* out, void* stream) {
  EncodeParams p;
  if (!fill_banks(factors, res, nb, rank, p.factors, p.res) || M < 0)
    return cudaErrorInvalidValue;
  p.pos = pos;
  p.M = M;
  p.nb = nb;
  p.rank = rank;
  p.groups = (rank + kGroupCols - 1) / kGroupCols;
  p.out = out;
  const bool vec = vec_route(factors, nb, rank, bf16 ? 2 : 4) &&
                   (uintptr_t)out % (out_bf16 ? 8 : 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  if (bf16) {
    if (out_bf16)
      return vec ? launch_runs(&cp_encode_runs_kernel<B, B, true>, p, s)
                 : launch_runs(&cp_encode_runs_kernel<B, B, false>, p, s);
    return vec ? launch_runs(&cp_encode_runs_kernel<B, float, true>, p, s)
               : launch_runs(&cp_encode_runs_kernel<B, float, false>, p, s);
  }
  if (out_bf16)
    return vec ? launch_runs(&cp_encode_runs_kernel<float, B, true>, p, s)
               : launch_runs(&cp_encode_runs_kernel<float, B, false>, p, s);
  return vec ? launch_runs(&cp_encode_runs_kernel<float, float, true>, p, s)
             : launch_runs(&cp_encode_runs_kernel<float, float, false>, p, s);
}
