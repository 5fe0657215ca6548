// Grid size of a grid-stride launch: one block per `threads` items, capped
// at the blocks resident on the current device at once, so data a block
// stages in shared memory is staged once per resident block.
//
// The cap depends only on the kernel, its dynamic shared-memory ceiling
// and the device, so it is found once per (kernel, device) and kept; that
// first call also raises the kernel's ceiling to `smem_max`.  Every launch
// after it costs one cudaGetDevice and a lookup.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace grid_stride {

struct Entry {
  const void* kernel;
  int device;
  long long resident;
};

// `kernel` is the __global__ function cast to const void*; launches of it
// may use any dynamic shared memory up to `smem_max`.
inline cudaError_t blocks_for(const void* kernel, int threads,
                              size_t smem_max, long long n, int* blocks) {
  constexpr int kMaxEntries = 64;
  static Entry cache[kMaxEntries];
  static int n_cached = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  long long resident = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_cached; ++i) {
      if (cache[i].kernel == kernel && cache[i].device == dev) {
        resident = cache[i].resident;
        break;
      }
    }
    if (resident == 0) {
      int sms = 0, per_sm = 0;
      if (smem_max > 0 &&
          (err = cudaFuncSetAttribute(
               kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
               static_cast<int>(smem_max))) != cudaSuccess) {
        return err;
      }
      if ((err = cudaDeviceGetAttribute(
               &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, threads, smem_max)) != cudaSuccess) {
        return err;
      }
      resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
      if (n_cached < kMaxEntries) cache[n_cached++] = {kernel, dev, resident};
    }
  }
  const long long need = (n + threads - 1) / threads;
  *blocks = static_cast<int>(need < resident ? need : resident);
  return cudaSuccess;
}

}  // namespace grid_stride
