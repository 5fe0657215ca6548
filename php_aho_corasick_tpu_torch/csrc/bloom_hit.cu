// Bit-bloom membership of the anchored candidate filter: for every slot,
//
//   out = (words[slot >> 5] >> (slot & 31)) & 1.
//
// Replaces the TPU kernel `bloom_hit_pallas` of the JAX package
// (php_aho_corasick_tpu/ops/filter_pallas.py, body `_kernel`), whose
// contract is its XLA twin `bloom_hit_take`.  The Pallas body resolves the
// bloom's bank with an unrolled gather + select over every [1, 128] bank
// row, because Mosaic's lane gather reaches one row at a time; a thread
// here reads its word directly.
//
// What bounds it on an H100: each slot is read once and its bit written
// once as an int32, 8 bytes a slot (34.6M slots at the anchored cell:
// ~0.083 ms at 3.35 TB/s), against ~5 integer operations.  So the slots
// stream through coalesced loads and stores and the bloom stays off device
// memory where it can:
//
//   * the bloom is staged in shared memory once per block when it fits the
//     budget (16 KiB at the default 2^17 bits); a larger one is read
//     through the read-only path, where the card's 50 MB L2 holds it;
//   * as many blocks as fit on the card at once, each walking the slots in
//     a grid-stride loop, so the bloom is staged once per resident block
//     (grid_stride.cuh; the grid is found once per device, not per launch).
//
// A slot outside [0, 32 * n_words) reads 0 (the callers' slots are hashes
// shifted into range, so none is).
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_stride.cuh"

namespace {

constexpr int kThreads = 1024;
// two blocks of kThreads per SM fit beside a bloom of this size
constexpr size_t kSmemBloomBudget = 96 * 1024;

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
    bloom_hit_kernel(const int* __restrict__ words, long long n_words,
                     const int* __restrict__ slots, int* __restrict__ out,
                     long long n) {
  extern __shared__ int smem[];
  if (kSmem) {
    for (long long i = threadIdx.x; i < n_words; i += blockDim.x)
      smem[i] = __ldg(words + i);
    __syncthreads();
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const uint32_t s = static_cast<uint32_t>(__ldg(slots + i));
    const uint32_t w = s >> 5;
    uint32_t word = 0u;
    if (w < n_words)
      word = static_cast<uint32_t>(kSmem ? smem[w] : __ldg(words + w));
    out[i] = static_cast<int>((word >> (s & 31u)) & 1u);
  }
}

}  // namespace

extern "C" int bloom_hit_launch(const void* words, long long n_words,
                                const void* slots, void* out, long long n,
                                void* stream) {
  if (n_words < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bloom_bytes = static_cast<size_t>(n_words) * sizeof(int);
  const bool in_smem = bloom_bytes <= kSmemBloomBudget;
  const size_t smem = in_smem ? bloom_bytes : 0;
  auto kernel = in_smem ? bloom_hit_kernel<true> : bloom_hit_kernel<false>;
  int blocks = 0;
  const cudaError_t err = grid_stride::blocks_for(
      reinterpret_cast<const void*>(kernel), kThreads,
      in_smem ? kSmemBloomBudget : 0, n, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(words), n_words, static_cast<const int*>(slots),
      static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
