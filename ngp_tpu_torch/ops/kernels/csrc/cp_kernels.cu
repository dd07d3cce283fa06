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
// The bf16 density head (cp_density_tc_kernel, the main path's type) runs
// both MLP products on the tensor cores (mma.sync m16n8k16, bf16 -> f32). A
// persistent block of 16 warps per SM keeps w1 and w2 in shared memory in
// fragment order for its whole life (88 KB at the flagship config, K padded
// from 679 to 688; a w1 too long for that comes in a K chunk at a time beside
// the chunk's features) and walks 128-row tiles; each tile's features are made
// one bank at a time into a double-buffered shared A tile, by 16-byte
// gathers of 8 rank columns per thread (two items' twelve loads in flight),
// f32 lerps and product, rounded to bf16. What bounds it is the L2 traffic of
// the gathers, 7.7 KB of factor lines per row (1.0 GB for a 131,072-row
// refresh chunk), not the 11.7 GFLOP of products; with residuals, the feats
// rows (1358 bytes apart at the flagship config) go out by 2-byte stores. The
// f32 head and the radiance head keep the first design: one block owns kRows
// sample rows, its feature rows and activations in shared memory as f32, the
// products on the CUDA cores with a register tile of kRowsPerThread rows per
// weight load (full f32, where TF32 would break the f32 tolerance). With
// residuals, each block also writes its [rows, D] feature rows and
// [rows, H1] hidden rows in the weight type, the values the backward's MLP
// products read.
//
// The factor backward replaces the TPU's transposed tent matmul with what the
// tent encodes: each (row, bank, rank) item recomputes its three lerped line
// values and adds (1 - w) * others at i0 and w * others at i0 + 1 of each
// axis, with others = g * (product of the other two axes' values), by f32
// atomics into per-bank accumulators. The accumulators (3 x 3968 x 128 f32,
// about 6 MB at the flagship config) stay in L2, so the bound is the L2 atomic
// rate (6 atomics per item, 377 M per step at 98,304 rows); neighbouring
// threads take neighbouring rank columns, so each warp's atomics hit one or
// two 128-byte lines. A blocked or sorted reduction is later work. Atomics sum
// in no fixed order, so the result varies in the last f32 bits from run to run.
//
// The encoder forward writes the CP features alone, [M, nb * R] in the output
// type, zero for rows outside [0, 1]^3, with the same lerp code as the density
// head (cp_value). One thread per output element, rank columns fastest, so a
// warp's gathers hit one or two 128-byte lines of a factor row and its stores
// are contiguous. At the mesh-export chunk (65,536 rows, turbo-hq) it reads 30
// factor lines per row from banks that stay in L2 (3.05 MB in bf16) and writes
// 84 MB of bf16 features, 0.025 ms at the card's 3.35 TB/s; it takes about ten
// times that on an H100 (PERF.md), so the per-element index arithmetic and the
// six L2 gathers per element bound it, not the write. Writing the zero and the
// output type here, as the Pallas kernel does, keeps a where/cast pass from
// streaming the output through device memory again.
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
constexpr int kBwdThreads = 256;
constexpr int kBwdMaxBlocks = 132 * 64;
constexpr int kEncThreads = 256;
constexpr int kEncMaxBlocks = 132 * 64;
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
  float* dfactors[kMaxBanks];      // [3, res_b, rank] f32 accumulators, zeroed
  int res[kMaxBanks];
  int nb, rank;
};

struct EncodeParams {
  const float* pos;  // [M, 3]
  int M;
  const void* factors[kMaxBanks];  // [3, res_b, rank] each
  int res[kMaxBanks];
  int nb, rank;
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

// f32 lerp of rank column r of a [res, rank] factor line at tap t.
template <typename T>
__device__ __forceinline__ float lerp_line(const T* line, Tap t, int rank, int r) {
  return ld(line, t.i0 * rank + r) * (1.f - t.w) + ld(line, (t.i0 + 1) * rank + r) * t.w;
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
// ngp_tpu_torch/ops/sh.py (Sloan recurrence, Condon-Shortley phase).
template <typename T>
__device__ void sh_row(float x, float y, float z, int degree, float* o) {
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
        o[l * l + l] = round_to<T>((float)k * p);
      } else {
        const float c = (float)(((m & 1) ? -1.0 : 1.0) * sqrt(2.0) * k);
        o[l * l + l + m] = round_to<T>((c * p) * A);
        o[l * l + l - m] = round_to<T>((c * p) * B);
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

// dF[b][ax] += tent_ax(m)^T (g_b[m] * prod_{ax' != ax} v_ax'[m]); one item per
// (row, bank, rank column), rank fastest. Rows outside [0, 1]^3 add nothing.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) cp_bwd_banks_kernel(BwdParams p) {
  const long long total = (long long)p.M * p.nb * p.rank;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x; item < total;
       item += stride) {
    const int r = (int)(item % p.rank);
    const long long mb = item / p.rank;
    const int b = (int)(mb % p.nb);
    const int m = (int)(mb / p.nb);
    const float* q = p.pos + 3 * (size_t)m;
    if (!in_box(q)) continue;
    const T* f = static_cast<const T*>(p.factors[b]);
    const int res = p.res[b];
    Tap t[3];
    float v[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      t[ax] = tap(q[ax], res);
      v[ax] = lerp_line(f + (size_t)ax * res * p.rank, t[ax], p.rank, r);
    }
    const float g = p.g[(size_t)m * p.g_stride + (size_t)b * p.rank + r];
    float* acc = p.dfactors[b];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float o = ax == 0 ? g * v[1] * v[2] : ax == 1 ? g * v[0] * v[2] : g * v[0] * v[1];
      float* a = acc + ((size_t)ax * res + t[ax].i0) * p.rank + r;
      atomicAdd(a, (1.f - t[ax].w) * o);
      atomicAdd(a + p.rank, t[ax].w * o);
    }
  }
}

// out[m][b * rank + r] = cp_value of bank b, rank column r at row m, zero
// outside [0, 1]^3, rounded once to O; one item per output element.
template <typename T, typename O>
__global__ void __launch_bounds__(kEncThreads) cp_encode_kernel(EncodeParams p) {
  const int nbR = p.nb * p.rank;
  const long long total = (long long)p.M * nbR;
  const long long stride = (long long)gridDim.x * blockDim.x;
  O* out = static_cast<O*>(p.out);
  for (long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x; item < total;
       item += stride) {
    const int m = (int)(item / nbR);
    const int c = (int)(item - (long long)m * nbR);
    const int b = c / p.rank;
    const float* q = p.pos + 3 * (size_t)m;
    const float v =
        in_box(q) ? cp_value(q, static_cast<const T*>(p.factors[b]), p.res[b], p.rank,
                             c - b * p.rank)
                  : 0.f;
    st(out, (size_t)item, v);
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
    sh_row<T>(d[0], d[1], d[2], p.sh_degree, ca + m * p.cmax);
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
// The bf16 density head on the tensor cores (mma.sync m16n8k16, bf16 -> f32).
//
// A persistent block of 16 warps owns one SM and walks 128-row tiles. The
// weights sit in shared memory in mma fragment order (w1 [Kp, H1p], K padded
// per bank to a multiple of 16 and H1 to 16, zeros in the padding), so each
// B fragment is one conflict-free 8-byte load: w1 for the block's life where
// it fits (Kp <= 1112 at H1 = 64; 688 at turbo-hq), else each K chunk's rows
// beside that chunk's features. A tile's features are made one K chunk at a
// time (one bank's rank columns, at most kTcChunk of them, then the frequency
// ladder) into a double-buffered [128, kTcChunk] bf16 A tile whose rows are
// padded by 16 bytes, so the fragment loads of 8 rows x 4 column pairs hit 32
// distinct banks; warp w multiplies rows 16 (w % 8) .. +15 of the chunk into
// f32 accumulators of H1 / 2 columns. The second product reads ReLU(h1),
// rounded to bf16, from a padded shared tile.
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;
constexpr int kTcThreads = 512;
constexpr int kTcChunk = 128;
constexpr int kTcLda = kTcChunk + 8;
constexpr int kTcMaxH1 = 64;  // 4 n-tiles of 8 per warp and column half
// what a launcher returns for a shape its kernel does not take (cudaError
// codes are >= 0); the wrappers raise ValueError for it
constexpr int kUnsupportedShape = -1;

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

struct TcShape {
  int rankp, freq, freqp, Kp, H1p, OUTp;
};

__host__ __device__ inline TcShape tc_shape(const HeadParams& p) {
  TcShape t;
  t.rankp = (p.rank + 15) & ~15;
  t.freq = p.D - p.nb * p.rank;
  t.freqp = (t.freq + 15) & ~15;
  t.Kp = p.nb * t.rankp + t.freqp;
  t.H1p = (p.H1 + 15) & ~15;
  t.OUTp = (p.OUT + 7) & ~7;
  return t;
}

// rows of w1 in shared memory: all Kp (resident), or two chunks' (streamed)
__host__ __device__ inline int tc_w1_rows(const TcShape& t, bool resident) {
  return resident ? t.Kp : 2 * kTcChunk;
}

__host__ __device__ inline size_t tc_smem_bytes(const TcShape& t, bool resident) {
  return 2 * ((size_t)tc_w1_rows(t, resident) * t.H1p + (size_t)t.H1p * t.OUTp +
              2 * kTcRows * kTcLda + (size_t)kTcRows * (t.H1p + 8));
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
      const float v0 = l.x * (1.f - w) + h.x * w;
      const float v1 = l.y * (1.f - w) + h.y * w;
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
__device__ void fill_bank_chunk(const HeadParams& p, int row0, int b, int c0, int kc, bool vec,
                                __nv_bfloat16* A) {
  const int groups = kc >> 3;
  const int items = kTcRows * groups;
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
  for (int i = threadIdx.x; i < kTcRows * (kc - pad0); i += kTcThreads) {
    const int m = i / (kc - pad0);
    A[m * kTcLda + pad0 + (i - m * (kc - pad0))] = __float2bfloat16(0.f);
  }
  for (int i = threadIdx.x; i < kTcRows * 3; i += kTcThreads) {
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
  for (int m = threadIdx.x >> 5; m < kTcRows && row0 + m < p.M; m += kTcThreads >> 5) {
    __nv_bfloat16* dst = fo + (size_t)(row0 + m) * p.D + gcol;
    for (int j = threadIdx.x & 31; j < ncols; j += 32) dst[j] = A[m * kTcLda + j];
  }
}

// acc[i] += A rows (16 of this warp) x w1 columns of n-tile nt0 + i, over kc
// columns of the chunk whose first padded K row is 16 ks0
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* A, int kc, const uint2* w1s,
                                          int ks0, int n_tiles, int nt0, int ntw,
                                          float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* a_lo = A + (lane >> 2) * kTcLda + 2 * (lane & 3);
  const __nv_bfloat16* a_hi = a_lo + 8 * kTcLda;
  for (int k0 = 0; k0 < kc; k0 += 16) {
    const uint32_t a0 = lds32(a_lo + k0), a1 = lds32(a_hi + k0);
    const uint32_t a2 = lds32(a_lo + k0 + 8), a3 = lds32(a_hi + k0 + 8);
    const uint2* bk = w1s + ((ks0 + (k0 >> 4)) * n_tiles + nt0) * 32 + lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < ntw) {
        const uint2 bb = bk[32 * i];
        mma_bf16(acc[i], a0, a1, a2, a3, bb.x, bb.y);
      }
    }
  }
}

// flags: bit 0, 16-byte factor gathers; bit 1, 16-byte w1 row loads; bit 2,
// w1 resident in shared memory (else streamed a chunk at a time)
__global__ void __launch_bounds__(kTcThreads, 1) cp_density_tc_kernel(HeadParams p, int flags) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const TcShape t = tc_shape(p);
  const bool resident = flags & 4;
  const int nt1 = t.H1p >> 3, nt2 = t.OUTp >> 3;
  uint2* w1s = reinterpret_cast<uint2*>(smem_tc);
  uint2* w2s = w1s + (size_t)tc_w1_rows(t, resident) * t.H1p / 4;
  __nv_bfloat16* abuf = reinterpret_cast<__nv_bfloat16*>(w2s + t.H1p * t.OUTp / 4);
  __nv_bfloat16* sh1 = abuf + 2 * kTcRows * kTcLda;
  const int ldh = t.H1p + 8;

  // the weights in fragment order: w2 (and a resident w1) once per block
  const __nv_bfloat16* w2 = static_cast<const __nv_bfloat16*>(p.w2);
  __nv_bfloat16* w1h = reinterpret_cast<__nv_bfloat16*>(w1s);
  __nv_bfloat16* w2h = reinterpret_cast<__nv_bfloat16*>(w2s);
  if (resident) load_w1(p, t, 0, t.Kp, flags & 2, w1h);
  for (int i = threadIdx.x; i < t.H1p * t.OUTp; i += kTcThreads) {
    const int k = i / t.OUTp, n = i - k * t.OUTp;
    w2h[frag_slot(k, n, nt2)] =
        (k < p.H1 && n < p.OUT) ? w2[(size_t)k * p.OUT + n] : __float2bfloat16(0.f);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp & 7;           // rows 16 rg .. 16 rg + 15 of the tile
  const int ntw = t.H1p >> 4;        // n-tiles per warp: half of H1p / 8
  const int nt0 = (warp >> 3) * ntw;
  const int n_tiles = (p.M + kTcRows - 1) / kTcRows;
  int parity = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kTcRows;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int seg = 0; seg <= p.nb; ++seg) {
      const int segp = seg == p.nb ? t.freqp : t.rankp;
      for (int c0 = 0; c0 < segp; c0 += kTcChunk) {
        const int kc = min(kTcChunk, segp - c0);
        const int kp0 = seg * t.rankp + c0;  // the chunk's first padded K row
        const int buf = parity;
        parity ^= 1;
        __nv_bfloat16* A = abuf + buf * kTcRows * kTcLda;
        if (!resident) load_w1(p, t, kp0, kc, flags & 2, w1h + buf * kTcChunk * t.H1p);
        if (seg == p.nb)
          fill_freq_chunk(p, t, row0, c0, kc, A);
        else
          fill_bank_chunk(p, row0, seg, c0, kc, flags & 1, A);
        // the buffers filled two chunks ago were last read before this barrier
        __syncthreads();
        if (p.feats_out != nullptr) store_feats(p, t, row0, seg, c0, kc, A);
        if (resident)
          mma_chunk(A + rg * 16 * kTcLda, kc, w1s, kp0 >> 4, nt1, nt0, ntw, acc);
        else
          mma_chunk(A + rg * 16 * kTcLda, kc, w1s + buf * kTcChunk * t.H1p / 4, 0, nt1, nt0,
                    ntw, acc);
      }
    }
    // h1 = round(relu(feats @ w1)) into the shared tile (the next tile's
    // writes come after at least two chunk barriers)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < ntw) {
        __nv_bfloat16* o = sh1 + (rg * 16 + g) * ldh + (nt0 + i) * 8 + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(fmaxf(acc[i][0], 0.f), fmaxf(acc[i][1], 0.f));
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * ldh) =
            __floats2bfloat162_rn(fmaxf(acc[i][2], 0.f), fmaxf(acc[i][3], 0.f));
      }
    }
    __syncthreads();
    // out = h1 @ w2 in f32: one (16-row group, n-tile) item per warp
    for (int item = warp; item < 8 * nt2; item += kTcThreads >> 5) {
      const int r16 = item & 7, nt = item >> 3;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* a_lo = sh1 + (r16 * 16 + g) * ldh + 2 * tq;
      const __nv_bfloat16* a_hi = a_lo + 8 * ldh;
      for (int k0 = 0; k0 < t.H1p; k0 += 16) {
        const uint2 bb = w2s[((k0 >> 4) * nt2 + nt) * 32 + lane];
        mma_bf16(d, lds32(a_lo + k0), lds32(a_hi + k0), lds32(a_lo + k0 + 8),
                 lds32(a_hi + k0 + 8), bb.x, bb.y);
      }
      const int col = nt * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r16 * 16 + g + 8 * h;
        if (row >= p.M) continue;
        float* o = p.out + (size_t)row * p.OUT;
        if (col < p.OUT) o[col] = d[2 * h];
        if (col + 1 < p.OUT) o[col + 1] = d[2 * h + 1];
      }
    }
    if (p.h1_out != nullptr) {
      __nv_bfloat16* ho = static_cast<__nv_bfloat16*>(p.h1_out);
      if ((p.H1 & 7) == 0) {
        const int vpr = p.H1 >> 3;
        for (int i = threadIdx.x; i < kTcRows * vpr; i += kTcThreads) {
          const int m = i / vpr, v = i - m * vpr;
          if (row0 + m < p.M)
            *reinterpret_cast<uint4*>(ho + (size_t)(row0 + m) * p.H1 + 8 * v) =
                *reinterpret_cast<const uint4*>(sh1 + m * ldh + 8 * v);
        }
      } else {
        for (int i = threadIdx.x; i < kTcRows * p.H1; i += kTcThreads) {
          const int m = i / p.H1, j = i - m * p.H1;
          if (row0 + m < p.M) ho[(size_t)(row0 + m) * p.H1 + j] = sh1[m * ldh + j];
        }
      }
    }
  }
}

int launch_density_tc(const HeadParams& p, cudaStream_t stream) {
  if (p.H1 > kTcMaxH1) return kUnsupportedShape;
  const TcShape t = tc_shape(p);
  const bool resident = tc_smem_bytes(t, true) <= (size_t)kMaxSmemBytes;
  const size_t bytes = tc_smem_bytes(t, resident);
  if (bytes > (size_t)kMaxSmemBytes) return kUnsupportedShape;  // w2 alone too wide
  if (p.M == 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(cp_density_tc_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = (p.M + kTcRows - 1) / kTcRows;
  int flags = p.rank % 8 == 0;
  for (int b = 0; b < p.nb; ++b) flags &= (uintptr_t)p.factors[b] % 16 == 0;
  flags |= (p.H1 % 8 == 0 && (uintptr_t)p.w1 % 16 == 0) << 1;
  flags |= resident << 2;
  cp_density_tc_kernel<<<tiles < sms ? tiles : sms, kTcThreads, bytes, stream>>>(p, flags);
  return cudaGetLastError();
}

size_t smem_bytes(const HeadParams& p, bool radiance) {
  size_t floats = (size_t)kRows * (p.D + p.H1 + p.OUT);
  if (radiance) floats += 2 * (size_t)kRows * p.cmax;
  return floats * sizeof(float);
}

// the row-block heads: the f32 density head and the radiance head
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

template <typename T>
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const long long total = (long long)p.M * p.nb * p.rank;
  if (total == 0) return cudaSuccess;
  const long long want = (total + kBwdThreads - 1) / kBwdThreads;
  const int blocks = (int)(want < kBwdMaxBlocks ? want : kBwdMaxBlocks);
  cp_bwd_banks_kernel<T><<<blocks, kBwdThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename O>
int launch_encode(const EncodeParams& p, cudaStream_t stream) {
  const long long total = (long long)p.M * p.nb * p.rank;
  if (total == 0) return cudaSuccess;
  const long long want = (total + kEncThreads - 1) / kEncThreads;
  const int blocks = (int)(want < kEncMaxBlocks ? want : kEncMaxBlocks);
  cp_encode_kernel<T, O><<<blocks, kEncThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ngp_cp_density_fwd(const float* pos, int M, const void* const* factors,
                                  const int* res, int nb, int rank, int freq_degree,
                                  const void* w1, const void* w2, int D, int H1, int OUT,
                                  int bf16, float* out, void* feats_out, void* h1_out,
                                  void* stream) {
  HeadParams p;
  if (!fill_density(p, pos, M, factors, res, nb, rank, freq_degree, w1, w2, D, H1, OUT, out))
    return cudaErrorInvalidValue;
  if ((feats_out == nullptr) != (h1_out == nullptr)) return cudaErrorInvalidValue;
  p.feats_out = feats_out;
  p.h1_out = h1_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_density_tc(p, s) : launch(&cp_density_kernel<float>, p, s, false);
}

// the widest hidden layer (H1) the bf16 density head takes
extern "C" int ngp_cp_density_tc_max_h1() { return kTcMaxH1; }

extern "C" int ngp_cp_bwd_banks(const float* pos, int M, const float* g, int g_stride,
                                const void* const* factors, const int* res, int nb, int rank,
                                int bf16, float* const* dfactors, void* stream) {
  if (nb < 1 || nb > kMaxBanks || rank < 1 || M < 0 || g_stride < nb * rank)
    return cudaErrorInvalidValue;
  BwdParams p;
  p.pos = pos;
  p.M = M;
  p.g = g;
  p.g_stride = g_stride;
  p.nb = nb;
  p.rank = rank;
  for (int b = 0; b < nb; ++b) {
    if (res[b] < 2) return cudaErrorInvalidValue;
    p.factors[b] = factors[b];
    p.dfactors[b] = dfactors[b];
    p.res[b] = res[b];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(p, s) : launch_bwd<float>(p, s);
}

extern "C" int ngp_cp_sigma_rgb(const float* pos, const float* dirs, int M,
                                const void* const* factors, const int* res, int nb, int rank,
                                int freq_degree, const void* w1, const void* w2, int D, int H1,
                                int OUT, const void* const* color_ws, const int* cdims,
                                int n_color, int sh_degree, int bf16, float* out,
                                void* stream) {
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
  return bf16 ? launch(&cp_sigma_rgb_kernel<__nv_bfloat16>, p, s, true)
              : launch(&cp_sigma_rgb_kernel<float>, p, s, true);
}

extern "C" int ngp_cp_encode_fwd(const float* pos, int M, const void* const* factors,
                                 const int* res, int nb, int rank, int bf16, int out_bf16,
                                 void* out, void* stream) {
  if (nb < 1 || nb > kMaxBanks || rank < 1 || M < 0) return cudaErrorInvalidValue;
  EncodeParams p;
  p.pos = pos;
  p.M = M;
  p.nb = nb;
  p.rank = rank;
  p.out = out;
  for (int b = 0; b < nb; ++b) {
    if (res[b] < 2) return cudaErrorInvalidValue;
    p.factors[b] = factors[b];
    p.res[b] = res[b];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return out_bf16 ? launch_encode<__nv_bfloat16, __nv_bfloat16>(p, s)
                    : launch_encode<__nv_bfloat16, float>(p, s);
  return out_bf16 ? launch_encode<float, __nv_bfloat16>(p, s) : launch_encode<float, float>(p, s);
}
