// Salted bank-bloom probe of the per-row sampled filter: for every gram
// code, the AND over k salts of the hashed (32 / pack)-bit sub-word of its
// salt's probe table,
//
//   row  = ((code ^ salt_p) * 2654435761) >> (32 - log2_rows)
//   word = table[p * N / pack + (row >> 7) / pack * 128 + (row & 127)]
//   sub  = (word >> ((row >> 7) % pack * 32 / pack)) & sub-word mask.
//
// Replaces the TPU kernel `bloom_word_vmem` of the JAX package
// (php_aho_corasick_tpu/ops/filter_pallas.py, body `_vmem_kernel` ->
// `_bank_probe`).  The semantics are those of its XLA mirror
// `_bank_probe_xla`, bit for bit.  The select tree and the per-row
// fori_loop there work around Mosaic's sublane gather, which cannot index
// across more than one [8, 128] tile; a thread here indexes its word
// directly.
//
// What bounds it on an H100: each code is read once and its word written
// once, 8 bytes a code (27.7M codes at the rows cell: ~0.066 ms at
// 3.35 TB/s), against ~8 integer operations per salt.  So the codes stream
// through coalesced loads and stores and the table lookups stay off device
// memory where they can:
//
//   * the k probe tables are staged in shared memory once per block when
//     they fit the budget (28 KiB at the rows cell's plan); larger ones (up
//     to 384 KiB at pack 1, the planner's cap) are read through the
//     read-only path, where the card's 50 MB L2 holds them;
//   * one thread per code, the k salts in registers; the AND stops at 0;
//   * as many blocks as fit on the card at once, each walking the codes in
//     a grid-stride loop, so a table is staged once per resident block
//     (grid_stride.cuh; the grid is found once per device, not per launch).
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "grid_stride.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSalts = 8;
constexpr uint32_t kKnuth = 2654435761u;
// two blocks of kThreads per SM fit beside a table of this size
constexpr size_t kSmemTableBudget = 96 * 1024;

struct Params {
  const int* table;
  long long table_words;
  const int* codes;
  int* out;
  long long n;
  uint32_t salts[kMaxSalts];
  int k;
  int shift;      // 32 - log2_rows
  int log2_phys;  // log2 of the physical words of one probe table
  int pack_log2;  // log2 of the sub-words per physical word
};

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
    bloom_word_vmem_kernel(const __grid_constant__ Params P) {
  extern __shared__ int smem[];
  if (kSmem) {
    for (long long i = threadIdx.x; i < P.table_words; i += blockDim.x)
      smem[i] = __ldg(P.table + i);
    __syncthreads();
  }
  uint32_t salt[kMaxSalts];
#pragma unroll
  for (int p = 0; p < kMaxSalts; ++p) salt[p] = P.salts[p];
  const int sub_bits = 32 >> P.pack_log2;
  const uint32_t sub_mask = P.pack_log2 ? ((1u << sub_bits) - 1u) : ~0u;
  const uint32_t sub_sel = (1u << P.pack_log2) - 1u;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < P.n; i += step) {
    const uint32_t code = static_cast<uint32_t>(__ldg(P.codes + i));
    uint32_t acc = ~0u;
#pragma unroll
    for (int p = 0; p < kMaxSalts; ++p) {
      if (p >= P.k) break;
      const uint32_t row = ((code ^ salt[p]) * kKnuth) >> P.shift;
      const uint32_t bank = row >> 7;
      const uint32_t o = (static_cast<uint32_t>(p) << P.log2_phys) +
                         ((bank >> P.pack_log2) << 7) + (row & 127u);
      const uint32_t got =
          static_cast<uint32_t>(kSmem ? smem[o] : __ldg(P.table + o));
      acc &= (got >> ((bank & sub_sel) * sub_bits)) & sub_mask;
      if (acc == 0u) break;
    }
    P.out[i] = static_cast<int>(acc);
  }
}

}  // namespace

extern "C" int bloom_word_vmem_launch(const void* table, long long table_words,
                                      const void* codes, void* out,
                                      long long n, const void* salts, int k,
                                      int log2_rows, int pack, void* stream) {
  const int pack_log2 = pack == 1 ? 0 : pack == 2 ? 1 : pack == 4 ? 2 : -1;
  if (k < 1 || k > kMaxSalts || pack_log2 < 0 || log2_rows < 7 + pack_log2 ||
      log2_rows > 31 || n < 1 ||
      table_words != (static_cast<long long>(k) << (log2_rows - pack_log2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P;
  memset(&P, 0, sizeof(P));
  P.table = static_cast<const int*>(table);
  P.table_words = table_words;
  P.codes = static_cast<const int*>(codes);
  P.out = static_cast<int*>(out);
  P.n = n;
  memcpy(P.salts, salts, sizeof(uint32_t) * k);
  P.k = k;
  P.shift = 32 - log2_rows;
  P.log2_phys = log2_rows - pack_log2;
  P.pack_log2 = pack_log2;

  const size_t table_bytes = static_cast<size_t>(table_words) * sizeof(int);
  const bool in_smem = table_bytes <= kSmemTableBudget;
  const size_t smem = in_smem ? table_bytes : 0;
  auto kernel = in_smem ? bloom_word_vmem_kernel<true>
                        : bloom_word_vmem_kernel<false>;
  int blocks = 0;
  const cudaError_t err = grid_stride::blocks_for(
      reinterpret_cast<const void*>(kernel), kThreads,
      in_smem ? kSmemTableBudget : 0, n, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
