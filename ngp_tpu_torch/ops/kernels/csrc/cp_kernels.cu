// CP factor-bank density and radiance heads for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of ngp_tpu/ops/pallas/cp_kernels.py:
//   ngp_cp_density_fwd  <- _density_kernel / _cp_density_fwd_impl (forward, with
//                          the feats/h1 residuals when asked for)
//   ngp_cp_sigma_rgb    <- _sigma_rgb_kernel / cp_sigma_rgb
//   ngp_cp_bwd_banks    <- _bwd_kernel / _cp_bwd_banks (factor gradients)
//
// What the TPU kernel did with a tent-matrix matmul on the MXU (one [TM, res]
// row of lerp weights per axis) is here a two-row gather and lerp per axis:
// Hopper gathers cheaply, and all five factor banks of the flagship config
// (3 x 3968 x 128 bf16, about 3 MB) stay resident in the 50 MB L2. One block
// owns kRows sample rows. Its feature rows ([kRows, D] float, D = 679 at the
// flagship config) and every later activation stay in shared memory, so the
// only device-memory traffic is pos/dirs in, the output rows out, and the
// factor and weight reads that L2 serves. The MLP products run on the CUDA
// cores with a register tile of kRowsPerThread rows per weight load; the
// bound on this card is those FMAs and the L2 gathers, not device memory.
// Tensor-core (wgmma) products are later work. With residuals, each block also
// writes its [kRows, D] feature rows and [kRows, H1] hidden rows in the weight
// type (about 1.4 KB per bf16 row at the flagship config), the values the
// backward's MLP products read.
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
// Rounding follows the Pallas kernels: features are rounded to the weight
// type before w1, h1 after its ReLU, geo features and the SH basis before the
// color MLP, and each color hidden layer; every product accumulates in f32,
// and sigma = exp(h[:, 0]) is f32. Unlike the Pallas kernel, the lerp runs in
// f32 (as the JAX CPU reference, cp_encode_reference, does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxBanks = 8;
constexpr int kMaxColorLayers = 4;
constexpr int kRows = 32;           // sample rows per block
constexpr int kThreads = 128;
constexpr int kRowsPerThread = 8;   // register tile of the dense loops
constexpr int kMaxSmemBytes = 232448;
constexpr int kBwdThreads = 256;
constexpr int kBwdMaxBlocks = 132 * 64;
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
      const bool oob = q[0] < 0.f || q[0] > 1.f || q[1] < 0.f || q[1] > 1.f ||
                       q[2] < 0.f || q[2] > 1.f;
      if (!oob) {
        const T* f = static_cast<const T*>(p.factors[b]);
        const int res = p.res[b];
        float acc = 1.f;
        for (int ax = 0; ax < 3; ++ax) {
          const float pa = fminf(fmaxf(q[ax], 0.f), 1.f) * (float)(res - 1);
          const int i0 = min((int)floorf(pa), res - 2);
          const float w = pa - (float)i0;
          const T* line = f + (size_t)ax * res * p.rank;
          const float v = ld(line, i0 * p.rank + r) * (1.f - w) +
                          ld(line, (i0 + 1) * p.rank + r) * w;
          acc = ax == 0 ? v : acc * v;
        }
        val = acc;
      }
    }
    feats[m * p.D + c] = round_to<T>(val);
  }
  for (int item = threadIdx.x; item < kRows * 3; item += blockDim.x) {
    const int m = item / 3;
    const int ax = item - 3 * m;
    const int row = row0 + m;
    const float x = row < p.M ? 2.f * p.pos[3 * row + ax] - 1.f : -1.f;
    float* o = feats + m * p.D + nbR + ax;
    o[0] = round_to<T>(x);
    if (p.freq_degree > 0) {
      float s = sinf(x), c = cosf(x);
      o[3] = round_to<T>(s);
      o[6] = round_to<T>(c);
      for (int d = 1; d < p.freq_degree; ++d) {
        const float s2 = 2.f * s * c;
        const float c2 = 1.f - 2.f * s * s;
        s = s2;
        c = c2;
        o[3 * (2 * d + 1)] = round_to<T>(s);
        o[3 * (2 * d + 2)] = round_to<T>(c);
      }
    }
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
    if (q[0] < 0.f || q[0] > 1.f || q[1] < 0.f || q[1] > 1.f || q[2] < 0.f || q[2] > 1.f)
      continue;
    const T* f = static_cast<const T*>(p.factors[b]);
    const int res = p.res[b];
    int i0[3];
    float w[3], v[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float pa = fminf(fmaxf(q[ax], 0.f), 1.f) * (float)(res - 1);
      i0[ax] = min((int)floorf(pa), res - 2);
      w[ax] = pa - (float)i0[ax];
      const T* line = f + (size_t)ax * res * p.rank;
      v[ax] = ld(line, i0[ax] * p.rank + r) * (1.f - w[ax]) +
              ld(line, (i0[ax] + 1) * p.rank + r) * w[ax];
    }
    const float g = p.g[(size_t)m * p.g_stride + (size_t)b * p.rank + r];
    float* acc = p.dfactors[b];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float o = ax == 0 ? g * v[1] * v[2] : ax == 1 ? g * v[0] * v[2] : g * v[0] * v[1];
      float* a = acc + ((size_t)ax * res + i0[ax]) * p.rank + r;
      atomicAdd(a, (1.f - w[ax]) * o);
      atomicAdd(a + p.rank, w[ax] * o);
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

size_t smem_bytes(const HeadParams& p, bool radiance) {
  size_t floats = (size_t)kRows * (p.D + p.H1 + p.OUT);
  if (radiance) floats += 2 * (size_t)kRows * p.cmax;
  return floats * sizeof(float);
}

template <typename T>
int launch(const HeadParams& p, cudaStream_t stream, bool radiance) {
  if (p.M == 0) return cudaSuccess;
  const size_t bytes = smem_bytes(p, radiance);
  if (bytes > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  void (*kern)(HeadParams) = radiance ? &cp_sigma_rgb_kernel<T> : &cp_density_kernel<T>;
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
  return bf16 ? launch<__nv_bfloat16>(p, s, false) : launch<float>(p, s, false);
}

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
  return bf16 ? launch<__nv_bfloat16>(p, s, true) : launch<float>(p, s, true);
}
