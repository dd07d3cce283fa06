// Coarse occupancy-bit lookup for the turbo march, for Hopper (sm_90a).
//
// Replaces ngp_tpu/ops/pallas/march_kernels.py:coarse_lookup_bits. The TPU
// kernel held the [R, 128] byte payload in VMEM and fetched each probe's byte
// with an unrolled lane-local gather over the R rows, because a TPU scalar
// gather moves a whole tile. On Hopper a probe's byte is one load from the
// payload (4 KB per cascade at grid 128, resident in L1/L2): byte
// payload[fc >> 3], bit fc & 7. The payload keeps the f32 byte values the
// packing code writes, so no second copy is made per refresh. The kernel is
// bound by device memory: 4 B in and 1 B out per probe.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
