// The turbo march and the coarse occupancy-bit lookup, for Hopper (sm_90a).
//
// ngp_march_turbo replaces the turbo march of ngp_tpu/models/occupancy.py:
// march_rays_turbo, whose Pallas kernel (ngp_tpu/ops/pallas/march_kernels.py:
// coarse_lookup_bits) was the coarse test of the [N, K] probe lattice alone.
// The TPU forced the rest of that march into XLA: the first K2 coarse
// survivors by top_k over t-bits keys, the fine payload of each crossing
// routed to the candidates by one-hot einsums, and the first S fine
// survivors by a second top_k. Here one warp marches one ray, and no [N, K]
// or [N, K2] tensor reaches device memory:
//
//  1. Lanes take the lattice probes in rounds of 32, in march order. At
//     dt_gamma = 0 probe k sits at t0 + k * dt_min; at dt_gamma > 0 the
//     probes follow the serial recurrence t += clamp(t * dt_gamma, dt_min,
//     dt_max), which lane l walks l steps from the round's first probe. Each
//     probe makes its point, mip level and cell and reads its coarse bit from
//     the block's copy of the coarse payload, staged in shared memory as bytes
//     (Hc^3 / 8 bytes a cascade: 4 KB at grid 128). The lattice ascends in t,
//     so the ray stops at the first round that starts past its far end.
//  2. __ballot_sync / __popc give each coarse survivor its candidate index in
//     march order, which for positive t is ascending t: the order the top_k
//     over t-bits keys gives. Candidates stop at K2; the count of survivors
//     runs on to the end of the lattice, since n_dropped needs it.
//  3. A candidate starts a crossing where its coarse cell differs from the
//     previous candidate's (by shuffle from the nearest candidate lane below,
//     or carried from the last round); its slot is the prefix count of
//     crossing starts, and it is fine-tested when the slot is below U. Every
//     candidate of a crossing lies in the crossing's coarse cell, so it reads
//     its fine bits from its own cell's payload row: the [N, U + 1] slot table
//     of the plain version, its scatter and its gathers are not needed.
//  4. With t_proxy_thresh, each fine survivor's estimated optical depth
//     (dens * density_scale * dt, from the eroded density codes of its own
//     fine cell) is summed front to back in candidate order, and a survivor
//     whose exclusive sum reaches -log(t_proxy_thresh) is dropped. The sum
//     runs in lane order in double, rounded to f32 at each candidate, as
//     torch.cumsum does on the CPU; the card's cumsum adds in another order,
//     so only there may the two differ, where a sum lies at the threshold.
//  5. The first S fine survivors, by a second ballot, are the samples: t, dt
//     and the mask go out once each, then zeros in the rest of the ray's S
//     slots, and lane 0 writes n_total and the drop estimate
//     n_dropped = untested * (n_pass / max(n_tested, 1)) + max(n_total - S, 0).
//
// The kernel gives the plain version's floats: every product, sum and
// quotient of the lattice, the points, the cells, the slab test and the
// perturbed start is rounded as its own torch op rounds it (__fmul_rn,
// __fadd_rn, __fdiv_rn in the plain version's order, so nvcc contracts
// nothing into an FMA), min / max / clamp propagate NaN as torch's do, and
// mip levels are floor(log2(max(x, 1e-30))) + 1, as _frexp_exponent makes
// them. So ts, mask and n_total are bit-equal to march_turbo_plain on the
// card.
//
// Bound: the bytes are the rays in and the samples out (at 16,384 rays and
// S = 32, 5.5 MB, 1.6 us at 3.35 TB/s), so what bounds it is instruction
// issue: about 200 warp instructions per round of 32 probes (the divisions of
// the cell, two log2f of the mip level, the ballots), over about K / 32 rounds
// per hit ray. Limits: the coarse payload must fit a block's shared memory
// (227 KB: at grid 128, 56 cascades; the package's bounds <= 8 need 4); any
// lattice, K2, U and S <= K2.
//
// ngp_ray_prepass replaces the eval prepass of ngp_tpu/models/occupancy.py:
// ray_prepass around the same Pallas kernel. The TPU forced a dense [N, Kp]
// probe lattice at one coarse cell's spacing, its [N, Kp, 3] points, the mip
// levels and cells of up to three levels and a lookup of each, reduced to
// three values a ray (about 90 XLA ops at one cascade, 210 at two, each a
// launch in the PyTorch composition). Here one warp walks one ray's probes
// in rounds of 32 lanes, and no [N, Kp] tensor reaches device memory: the
// slab test, t = near + h k, the march's dt at t, the clipped point, its mip
// level max(level of |x|, level of dt), and the probe's bits of the dilated
// payload at that level and, with more than one cascade, at the levels
// beside it, read from the block's copy of the payload staged in shared
// memory as bytes (as the march stages its coarse payload). The probes
// ascend in t, so the first occupied one (__ffs of the first non-empty
// ballot) gives t0 and the last (__clz of the last) t1, and the walk stops at
// the first round that starts past far + h / 2. Every product, sum, clamp and
// division is rounded as the plain version's torch op rounds it (as in the
// march), so hit, t0 and t1 are bit-equal to ray_prepass_plain on the card.
// Bound: the rays in and five values out (41 B a ray: 2.7 MB, 0.0008 ms at
// 3.35 TB/s for a 65,536-ray chunk); what bounds it is instruction issue:
// per probe the point, two log2f of the mip level and one to three
// lookups of three divisions each, over Kp / 32 rounds per ray in the box
// (58 probes at bound 1 and grid 128, 113 at bound 2).
//
// ngp_coarse_lookup_bits is the Pallas kernel's port alone, which no path
// calls since the prepass became one kernel. The TPU kernel held the [R, 128]
// byte payload in VMEM and fetched each probe's byte with an unrolled
// lane-local gather over the R rows, because a TPU scalar gather moves a whole
// tile. On Hopper a probe's byte is one load from the payload (resident in
// L1/L2): byte payload[fc >> 3], bit fc & 7. It is bound by device memory:
// 4 B in and 1 B out per probe.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resident.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMarchThreads = 256;
constexpr int kMarchWarps = kMarchThreads / 32;
constexpr int kMaxSmemBytes = 232448;
constexpr int kUnsupportedShape = -1;  // the wrappers raise ValueError for it
constexpr int kCoarseFactor = 4;       // fine cells per coarse cell per axis
constexpr float kMissT = 1e10f;        // near and far of a ray that misses the box

__global__ void coarse_lookup_kernel(const float* __restrict__ payload, int n_bytes,
                                     const int* __restrict__ flatcell, long long n,
                                     uint8_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int fc = flatcell[i];
    const int byte_idx = fc >> 3;
    uint8_t bit = 0;
    // cells past the payload read as empty, as a one-hot row that matches
    // no payload row does in the reference
    if (fc >= 0 && byte_idx < n_bytes) {
      const int byte = (int)__ldg(payload + byte_idx);
      bit = (byte >> (fc & 7)) & 1;
    }
    out[i] = bit;
  }
}

struct MarchParams {
  const float* rays_o;  // [N, 3], element (n, i) at n * o_rs + i * o_cs
  const float* rays_d;  // [N, 3], element (n, i) at n * d_rs + i * d_cs
  long long o_rs, o_cs, d_rs, d_cs;
  int N;
  float box[6];          // the box, unless box_dev holds it on the card
  const float* box_dev;  // [6] or null
  const float* t_range;  // [N, 2] or null
  const float* noise;    // [N] or null
  const float* coarse;   // [coarse_bytes] f32 byte values
  int coarse_bytes;
  const long long* fine;  // [fine_rows, fine_cols] uint32 words in int64
  int fine_rows, fine_cols;
  float dt_min, dt_max, dt_gamma, min_near, bound;
  int H, cas, K, K2, U, S;
  int proxy;
  float proxy_thresh;  // -log(t_proxy_thresh)
  float density_scale;
  float* nears;
  float* fars;
  float* ts;        // [N, S]
  float* deltas;    // [N, S]
  uint8_t* mask;    // [N, S]
  long long* n_total;
  float* n_dropped;
};

// torch's minimum, maximum and clamp: NaN in, NaN out
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// ops/lattice.py:_frexp_exponent
__device__ __forceinline__ int frexp_exponent(float x) {
  const float c = x != x ? x : fmaxf(x, 1e-30f);
  return (int)__fadd_rn(floorf(log2f(c)), 1.f);
}

// the adaptive step at t: clamp(t * dt_gamma, dt_min, dt_max)
__device__ __forceinline__ float dt_of(const MarchParams& p, float t) {
  return nan_clamp(__fmul_rn(t, p.dt_gamma), p.dt_min, p.dt_max);
}

struct Cell {
  int flat;  // flat coarse cell id (level, coarse x, y, z)
  int bit6;  // the fine cell within it, z fastest
};

// ops/lattice.py:_points: o + d t clipped to the bound
__device__ __forceinline__ void clipped_point(const float (&o)[3], const float (&d)[3], float t,
                                              float bound, float (&x)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = nan_clamp(__fadd_rn(o[i], __fmul_rn(d[i], t)), -bound, bound);
}

// ops/lattice.py: max(mip_from_pos(x), mip_from_dt(dt))
__device__ __forceinline__ int mip_level(const float (&x)[3], float dt, int H, int cas) {
  const float mx = nan_max(nan_max(fabsf(x[0]), fabsf(x[1])), fabsf(x[2]));
  const int lvl_pos = clampi(frexp_exponent(mx), 0, cas - 1);
  const int lvl_dt = clampi(frexp_exponent(__fmul_rn(__fmul_rn(dt, (float)H), 0.5f)), 0, cas - 1);
  return max(lvl_pos, lvl_dt);
}

// ops/lattice.py:_cells at a given level: the fine cell coordinates n
__device__ __forceinline__ void fine_cell(const float (&x)[3], int level, float bound, int H,
                                          int (&n)[3]) {
  const float mb = fminf(powf(2.f, (float)level), bound);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    n[i] = clampi((int)__fmul_rn(__fmul_rn(0.5f, __fadd_rn(__fdiv_rn(x[i], mb), 1.f)),
                                 (float)H),
                  0, H - 1);
}

// the flat coarse cell id of fine cell n at a level
__device__ __forceinline__ int coarse_flat(const int (&n)[3], int level, int H) {
  const int Hc = H / kCoarseFactor;
  return ((level * Hc + n[0] / kCoarseFactor) * Hc + n[1] / kCoarseFactor) * Hc +
         n[2] / kCoarseFactor;
}

// bit fc of a byte payload; cells past it read as empty (coarse_lookup_plain)
__device__ __forceinline__ bool payload_bit(const uint8_t* bytes, int n_bytes, int fc) {
  const int byte_idx = fc >> 3;
  return fc >= 0 && byte_idx < n_bytes && ((bytes[byte_idx] >> (fc & 7)) & 1);
}

// ops/lattice.py:_cells of the clipped point o + d t with step dt
__device__ __forceinline__ Cell probe_cell(const MarchParams& p, const float (&o)[3],
                                           const float (&d)[3], float t, float dt) {
  float x[3];
  clipped_point(o, d, t, p.bound, x);
  const int level = mip_level(x, dt, p.H, p.cas);
  int n[3];
  fine_cell(x, level, p.bound, p.H, n);
  Cell c;
  c.flat = coarse_flat(n, level, p.H);
  c.bit6 = ((n[0] % kCoarseFactor) * kCoarseFactor + n[1] % kCoarseFactor) * kCoarseFactor +
           n[2] % kCoarseFactor;
  return c;
}

// the slab test of ops/rays.py:near_far_from_aabb: 1 / d, then products;
// near clamped below by min_near, both 1e10 for a ray that misses the slabs
__device__ __forceinline__ void near_far(const float (&box)[6], const float (&o)[3],
                                         const float (&d)[3], float min_near, float& nr,
                                         float& fr) {
  nr = 0.f;
  fr = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float inv = __fdiv_rn(1.f, d[i]);
    const float lo = __fmul_rn(__fsub_rn(box[i], o[i]), inv);
    const float hi = __fmul_rn(__fsub_rn(box[3 + i], o[i]), inv);
    nr = i == 0 ? nan_min(lo, hi) : nan_max(nr, nan_min(lo, hi));
    fr = i == 0 ? nan_max(lo, hi) : nan_min(fr, nan_max(lo, hi));
  }
  const bool miss = nr > fr;
  nr = nr != nr ? nr : fmaxf(nr, min_near);
  if (miss) nr = fr = kMissT;
}

// a ray's origin and direction, from their strides
__device__ __forceinline__ void load_ray(const float* rays_o, const float* rays_d,
                                         long long o_rs, long long o_cs, long long d_rs,
                                         long long d_cs, int ray, float (&o)[3], float (&d)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = __ldg(rays_o + ray * o_rs + i * o_cs);
    d[i] = __ldg(rays_d + ray * d_rs + i * d_cs);
  }
}

// ray `ray` marched by the calling warp (see the header)
__device__ void march_ray(const MarchParams& p, const uint8_t* occ, const float (&box)[6],
                          int ray, int lane) {
  const unsigned below_me = (1u << lane) - 1u;
  float o[3], d[3];
  load_ray(p.rays_o, p.rays_d, p.o_rs, p.o_cs, p.d_rs, p.d_cs, ray, o, d);
  float nr, fr;
  near_far(box, o, d, p.min_near, nr, fr);
  if (p.t_range != nullptr) {
    nr = nan_max(nr, __ldg(p.t_range + 2 * ray));
    fr = nan_min(fr, __ldg(p.t_range + 2 * ray + 1));
  }
  if (lane == 0) {
    p.nears[ray] = nr;
    p.fars[ray] = fr;
  }
  const bool hit = fr > nr;
  const float far_c = hit ? fr : nr;
  float t0 = nr;
  if (p.noise != nullptr) t0 = __fadd_rn(t0, __fmul_rn(dt_of(p, t0), __ldg(p.noise + ray)));

  // warp-uniform counts: coarse survivors, crossings, fine-tested
  // candidates, fine survivors before and after the proxy
  int n_coarse = 0, n_cross = 0, n_tested = 0, n_pass = 0, n_total = 0;
  int carry_flat = 0;  // the cell of the last candidate so far
  double cum = 0.0;    // the proxy's running sum
  float t_round = t0;  // dt_gamma > 0: the t of the round's first probe
  const size_t row0 = (size_t)ray * p.S;
  for (int base = 0; hit && base < p.K; base += 32) {
    const int k = base + lane;
    float t, dt;
    if (p.dt_gamma == 0.f) {
      t = __fadd_rn(t0, __fmul_rn((float)k, p.dt_min));
      dt = p.dt_min;
    } else {
      t = t_round;
      for (int j = 0; j < lane; ++j) t = __fadd_rn(t, dt_of(p, t));
      dt = dt_of(p, t);
      t_round = __shfl_sync(kFull, __fadd_rn(t, dt), 31);
    }
    // the lattice ascends: a round that starts at or past the far end (or
    // at NaN) holds no probe before it, nor does any later round
    if (!(__shfl_sync(kFull, t, 0) < far_c)) break;
    Cell c = {0, 0};
    bool valid_c = false;
    if (k < p.K && t < far_c) {
      c = probe_cell(p, o, d, t, dt);
      valid_c = payload_bit(occ, p.coarse_bytes, c.flat);
    }
    const unsigned m_c = __ballot_sync(kFull, valid_c);
    const int cand = n_coarse + __popc(m_c & below_me);
    const bool full = n_coarse >= p.K2;
    n_coarse += __popc(m_c);
    if (full) continue;  // the candidates are taken; only the count runs on
    const bool is_cand = valid_c && cand < p.K2;
    const unsigned m_k = __ballot_sync(kFull, is_cand);
    // a crossing starts where the cell differs from the previous candidate's
    const unsigned prev_lanes = m_k & below_me;
    const int prev_flat =
        __shfl_sync(kFull, c.flat, prev_lanes ? 31 - __clz(prev_lanes) : lane);
    const bool change =
        is_cand && (cand == 0 || (prev_lanes ? prev_flat : carry_flat) != c.flat);
    if (m_k) carry_flat = __shfl_sync(kFull, c.flat, 31 - __clz(m_k));
    const unsigned m_ch = __ballot_sync(kFull, change);
    const int slot = n_cross + __popc(m_ch & (below_me | (1u << lane))) - 1;
    n_cross += __popc(m_ch);
    const bool in_budget = is_cand && slot < p.U && c.flat < p.fine_rows;
    n_tested += __popc(__ballot_sync(kFull, is_cand && slot < p.U));
    const long long* fine_row = p.fine + (size_t)c.flat * p.fine_cols;
    bool valid_f = in_budget && ((__ldg(fine_row + (c.bit6 >> 5)) >> (c.bit6 & 31)) & 1);
    n_pass += __popc(__ballot_sync(kFull, valid_f));
    if (p.proxy) {
      float contrib = 0.f;
      if (valid_f) {
        const long long cw = __ldg(fine_row + 2 + (c.bit6 >> 2));
        const float code = (float)((cw >> ((c.bit6 & 3) * 8)) & 0xFF);
        const float dens = code > 0.f ? exp2f(__fsub_rn(__fdiv_rn(code, 8.f), 16.f)) : 0.f;
        contrib = __fmul_rn(__fmul_rn(dens, p.density_scale), dt);
      }
      float cum_ex = 0.f;
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        cum += (double)__shfl_sync(kFull, contrib, j);
        if (j == lane) cum_ex = __fsub_rn((float)cum, contrib);
      }
      valid_f = valid_f && cum_ex < p.proxy_thresh;
    }
    const unsigned m_s = __ballot_sync(kFull, valid_f);
    const int s = n_total + __popc(m_s & below_me);
    if (valid_f && s < p.S) {
      p.ts[row0 + s] = t;
      p.deltas[row0 + s] = dt;
      p.mask[row0 + s] = 1;
    }
    n_total += __popc(m_s);
  }
  for (int s = min(n_total, p.S) + lane; s < p.S; s += 32) {
    p.ts[row0 + s] = 0.f;
    p.deltas[row0 + s] = 0.f;
    p.mask[row0 + s] = 0;
  }
  if (lane == 0) {
    const int kept = min(n_coarse, p.K2);
    const int untested = (n_coarse - kept) + (kept - n_tested);
    const float rate = __fdiv_rn((float)n_pass, (float)max(n_tested, 1));
    p.n_total[ray] = n_total;
    p.n_dropped[ray] = __fadd_rn(__fmul_rn((float)untested, rate), (float)max(n_total - p.S, 0));
  }
}

// Persistent blocks of kMarchWarps warps, one ray per warp at a time; each
// block stages the coarse payload once, as bytes.
__global__ void __launch_bounds__(kMarchThreads) march_turbo_kernel(MarchParams p) {
  extern __shared__ uint8_t occ[];
  for (int i = threadIdx.x; i < p.coarse_bytes; i += kMarchThreads)
    occ[i] = (uint8_t)(int)__ldg(p.coarse + i);
  __syncthreads();
  float box[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) box[i] = p.box_dev != nullptr ? __ldg(p.box_dev + i) : p.box[i];
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kMarchWarps;
  for (int ray = blockIdx.x * kMarchWarps + (threadIdx.x >> 5); ray < p.N; ray += warps)
    march_ray(p, occ, box, ray, lane);
}


struct PrepassParams {
  const float* rays_o;  // [N, 3], element (n, i) at n * o_rs + i * o_cs
  const float* rays_d;  // [N, 3], element (n, i) at n * d_rs + i * d_cs
  long long o_rs, o_cs, d_rs, d_cs;
  int N;
  float box[6];          // the box, unless box_dev holds it on the card
  const float* box_dev;  // [6] or null
  const float* payload;  // [payload_bytes] f32 byte values of the dilated grid
  int payload_bytes;
  float h, half_h;  // the probe spacing and h / 2
  int Kp;           // probes a ray
  float dt_min, dt_max, dt_gamma, min_near, bound;
  int H, cas;
  uint8_t* hit;  // [N] bool
  float* t0;     // [N]
  float* t1;     // [N]
  float* nears;  // [N]
  float* fars;   // [N]
};

// is probe point x (march step dt) occupied: its own mip level's bit of the
// dilated payload and, with more than one cascade, the bits of the levels
// beside it
__device__ __forceinline__ bool prepass_occupied(const PrepassParams& p, const uint8_t* occ,
                                                 const float (&x)[3], float dt) {
  int n[3];
  if (p.cas == 1) {
    fine_cell(x, 0, p.bound, p.H, n);
    return payload_bit(occ, p.payload_bytes, coarse_flat(n, 0, p.H));
  }
  const int level = mip_level(x, dt, p.H, p.cas);
  const int levels[3] = {level, max(level - 1, 0), min(level + 1, p.cas - 1)};
  bool on = false;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    fine_cell(x, levels[j], p.bound, p.H, n);
    on = on || payload_bit(occ, p.payload_bytes, coarse_flat(n, levels[j], p.H));
  }
  return on;
}

// ray `ray` walked by the calling warp (see the header)
__device__ void prepass_ray(const PrepassParams& p, const uint8_t* occ, const float (&box)[6],
                            int ray, int lane) {
  float o[3], d[3];
  load_ray(p.rays_o, p.rays_d, p.o_rs, p.o_cs, p.d_rs, p.d_cs, ray, o, d);
  float nr, fr;
  near_far(box, o, d, p.min_near, nr, fr);
  const float far_lim = __fadd_rn(fr, p.half_h);
  int first = -1, last = -1;  // warp-uniform: the first and last occupied probe
  for (int base = 0; fr > nr && base < p.Kp; base += 32) {
    const int k = base + lane;
    const float t = __fadd_rn(nr, __fmul_rn((float)k, p.h));
    // the probes ascend: a round that starts past far + h / 2 (or at NaN)
    // holds no probe before it, nor does any later round
    if (!(__shfl_sync(kFull, t, 0) <= far_lim)) break;
    bool on = false;
    if (k < p.Kp && t <= far_lim) {
      const float dt =
          p.dt_gamma == 0.f ? p.dt_min : nan_clamp(__fmul_rn(t, p.dt_gamma), p.dt_min, p.dt_max);
      float x[3];
      clipped_point(o, d, t, p.bound, x);
      on = prepass_occupied(p, occ, x, dt);
    }
    const unsigned m = __ballot_sync(kFull, on);
    if (m) {
      if (first < 0) first = base + __ffs(m) - 1;
      last = base + 31 - __clz(m);
    }
  }
  if (lane == 0) {
    float a = nr, b = nr;
    if (first >= 0) {
      a = nan_max(__fsub_rn(__fadd_rn(nr, __fmul_rn((float)first, p.h)), p.half_h), nr);
      b = nan_min(__fadd_rn(__fadd_rn(nr, __fmul_rn((float)last, p.h)), p.half_h), fr);
    }
    p.hit[ray] = first >= 0;
    p.t0[ray] = a;
    p.t1[ray] = b;
    p.nears[ray] = nr;
    p.fars[ray] = fr;
  }
}

// Persistent blocks of kMarchWarps warps, one ray per warp at a time; each
// block stages the dilated payload once, as bytes.
__global__ void __launch_bounds__(kMarchThreads) ray_prepass_kernel(PrepassParams p) {
  extern __shared__ uint8_t occ[];
  for (int i = threadIdx.x; i < p.payload_bytes; i += kMarchThreads)
    occ[i] = (uint8_t)(int)__ldg(p.payload + i);
  __syncthreads();
  float box[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) box[i] = p.box_dev != nullptr ? __ldg(p.box_dev + i) : p.box[i];
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kMarchWarps;
  for (int ray = blockIdx.x * kMarchWarps + (threadIdx.x >> 5); ray < p.N; ray += warps)
    prepass_ray(p, occ, box, ray, lane);
}

// the launch of a persistent kernel of kMarchThreads threads with `bytes` of
// dynamic shared memory over n rays, one warp a ray
template <typename Params>
int launch_per_ray(void (*kernel)(Params), const Params& p, int n, int bytes,
                   cudaStream_t stream) {
  cudaError_t e;
  if (bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  // as many blocks as are resident at once, each walking rays
  int most = 0;
  if ((e = resident_blocks(kernel, kMarchThreads, bytes, &most)) != cudaSuccess) return e;
  const long long want = ((long long)n + kMarchWarps - 1) / kMarchWarps;
  kernel<<<(int)(want < most ? want : most), kMarchThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ngp_coarse_lookup_bits(const float* payload, int n_bytes, const int* flatcell,
                                      long long n, uint8_t* out, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  coarse_lookup_kernel<<<(int)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      payload, n_bytes, flatcell, n, out);
  return cudaGetLastError();
}

extern "C" int ngp_march_turbo(const float* rays_o, const float* rays_d, const long long* strides,
                               int N,
                               const float* box, const float* box_dev, const float* t_range,
                               const float* noise, const float* coarse, int coarse_bytes,
                               const long long* fine, int fine_rows, int fine_cols,
                               float dt_min, float dt_max, float dt_gamma, float min_near,
                               float bound, int H, int cas, int K, int K2, int U, int S,
                               int proxy, float proxy_thresh, float density_scale,
                               float* nears, float* fars, float* ts, float* deltas,
                               uint8_t* mask, long long* n_total, float* n_dropped,
                               void* stream) {
  if (N < 0 || H < kCoarseFactor || H % kCoarseFactor != 0 || cas < 1 || K < 1 || K2 < 1 ||
      U < 1 || S < 1 || S > K2 || fine_cols < (proxy ? 18 : 2) || coarse_bytes < 0)
    return cudaErrorInvalidValue;
  if (coarse_bytes > kMaxSmemBytes) return kUnsupportedShape;
  if (N == 0) return cudaSuccess;
  MarchParams p;
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.o_rs = strides[0];
  p.o_cs = strides[1];
  p.d_rs = strides[2];
  p.d_cs = strides[3];
  p.N = N;
  for (int i = 0; i < 6; ++i) p.box[i] = box[i];
  p.box_dev = box_dev;
  p.t_range = t_range;
  p.noise = noise;
  p.coarse = coarse;
  p.coarse_bytes = coarse_bytes;
  p.fine = fine;
  p.fine_rows = fine_rows;
  p.fine_cols = fine_cols;
  p.dt_min = dt_min;
  p.dt_max = dt_max;
  p.dt_gamma = dt_gamma;
  p.min_near = min_near;
  p.bound = bound;
  p.H = H;
  p.cas = cas;
  p.K = K;
  p.K2 = K2;
  p.U = U;
  p.S = S;
  p.proxy = proxy;
  p.proxy_thresh = proxy_thresh;
  p.density_scale = density_scale;
  p.nears = nears;
  p.fars = fars;
  p.ts = ts;
  p.deltas = deltas;
  p.mask = mask;
  p.n_total = n_total;
  p.n_dropped = n_dropped;
  return launch_per_ray(march_turbo_kernel, p, N, coarse_bytes,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int ngp_ray_prepass(const float* rays_o, const float* rays_d,
                               const long long* strides, int N, const float* box,
                               const float* box_dev, const float* payload, int payload_bytes,
                               float h, float half_h, int Kp, float dt_min, float dt_max,
                               float dt_gamma, float min_near, float bound, int H, int cas,
                               uint8_t* hit, float* t0, float* t1, float* nears, float* fars,
                               void* stream) {
  if (N < 0 || H < kCoarseFactor || H % kCoarseFactor != 0 || cas < 1 || Kp < 1 ||
      payload_bytes < 0)
    return cudaErrorInvalidValue;
  if (payload_bytes > kMaxSmemBytes) return kUnsupportedShape;
  if (N == 0) return cudaSuccess;
  PrepassParams p;
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.o_rs = strides[0];
  p.o_cs = strides[1];
  p.d_rs = strides[2];
  p.d_cs = strides[3];
  p.N = N;
  for (int i = 0; i < 6; ++i) p.box[i] = box[i];
  p.box_dev = box_dev;
  p.payload = payload;
  p.payload_bytes = payload_bytes;
  p.h = h;
  p.half_h = half_h;
  p.Kp = Kp;
  p.dt_min = dt_min;
  p.dt_max = dt_max;
  p.dt_gamma = dt_gamma;
  p.min_near = min_near;
  p.bound = bound;
  p.H = H;
  p.cas = cas;
  p.hit = hit;
  p.t0 = t0;
  p.t1 = t1;
  p.nears = nears;
  p.fars = fars;
  return launch_per_ray(ray_prepass_kernel, p, N, payload_bytes,
                        static_cast<cudaStream_t>(stream));
}
