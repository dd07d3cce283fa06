// The grid size of a persistent kernel: the blocks that are resident on the
// current device at once, computed once per (kernel, device, shared memory)
// and kept, since the runtime's occupancy query costs more host time than
// the launch itself.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

// blocks of `kernel` resident at once with `threads` threads and `bytes` of
// dynamic shared memory (at least one per SM); the caller raises the kernel's
// shared-memory limit first where `bytes` passes 48 KB
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t bytes, int* blocks) {
  struct Entry {
    const void* fn;
    int device;
    size_t bytes;
    int blocks;
  };
  constexpr int kEntries = 32;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].fn == fn && cache[i].device == device && cache[i].bytes == bytes) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes)) !=
      cudaSuccess)
    return e;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (used < kEntries) cache[used++] = Entry{fn, device, bytes, *blocks};
  return cudaSuccess;
}

}  // namespace
