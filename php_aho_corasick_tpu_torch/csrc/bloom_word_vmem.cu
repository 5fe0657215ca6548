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
// across more than one [8, 128] tile; a thread here indexes its entry
// directly.
//
// What bounds it on an H100: each code is read once and its word written
// once, 8 bytes a code (27.7M codes at the rows cell: ~0.066 ms at
// 3.35 TB/s).  The salted probes come close to that: ~2.9 a code there,
// each a hash and one random gather from shared memory (~3.5-way bank
// conflicts across a warp).  So the codes stream through 16-byte loads
// and stores while a probe costs as few instructions as it can:
//
//   * a thread takes 4 consecutive codes through one 16-byte load and
//     writes their 4 words with one 16-byte store; the next group's load
//     is issued before this group's probes.  The codes before the first
//     16-byte boundary and after the last whole group (at most 3 each)
//     are probed one a thread by block 0.  `codes` and `out` must share
//     their offset within 16 bytes (the wrapper allocates `out` so);
//   * the k probe tables are staged in shared memory once per block when
//     they fit the budget (28 KiB at the rows cell's plan), one entry a
//     bloom row: salt p's row r at entry (p << log2_rows) + r, entries of
//     32 / pack bits, the sub-words of each physical word spread over
//     their banks' rows with byte permutes.  A probe is then an xor, a
//     multiply, one funnel shift ((p : hash) >> (32 - log2_rows)) and one
//     load of the sub-word itself: no address or sub-word arithmetic.
//     The permute rules out raw asynchronous copies; the table's words
//     are loaded after the first group's codes, so the staging overlaps
//     that load.  Larger tables (up to 384 KiB at pack 1, the planner's
//     cap) are read in their own layout through the read-only path,
//     where the card's 50 MB L2 holds them;
//   * the first kFirstProbes probes of the 4 codes are made
//     unconditionally, their 4 * kFirstProbes loads independent; after
//     them each probe is made only for a code whose AND is still nonzero,
//     and a thread stops when all 4 are zero.  At the rows plan 91% of
//     the codes survive the first probe, 55% the second and 11% the
//     fourth: the unconditional probes cost little, and the later ones
//     gather from few lanes, which conflict less in the banks;
//   * as many blocks of 1024 threads as fit on the card at once (two an
//     SM at <= 32 registers), each walking work items of 1024 groups in
//     a grid-stride loop, so a table is staged once per resident block
//     (grid_stride.cuh; the grid is found once per device, not per
//     launch).  Indices inside an item are 32-bit.
//
// On an H100 at the rows cell this runs within ~10% of a device copy of
// the same bytes, and the probes add ~5% to a table of zeros (PERF.md).
// Measured and dropped: all k probes unconditional, a per-warp queue of
// the codes alive after the first probes drained one lane a code (the
// form of fused_sampled_extract.cu), a cp.async ring of codes in shared
// memory, and 512-thread blocks; each was slower.

// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "grid_stride.cuh"

// the staged table (dynamic shared memory)
extern __shared__ uint4 bwv_smem[];

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSalts = 8;
constexpr int kFirstProbes = 2;
constexpr uint32_t kKnuth = 2654435761u;
// two blocks of kThreads per SM fit beside a table of this size
constexpr size_t kSmemTableBudget = 96 * 1024;

struct Params {
  const int* table;
  const int* codes;
  int* out;
  long long table_words;
  long long head;      // codes before the first 16-byte boundary (0-3)
  long long n_groups;  // whole groups of 4 codes after the head
  int tail;            // codes after the last group (0-3)
  unsigned n_items;    // work items of kThreads groups
  unsigned last;       // groups in the last item
  uint32_t salts[kMaxSalts];
  int k;
  int shift;      // 32 - log2_rows
  int log2_phys;  // log2 of the physical words of one probe table
};

// A table entry in shared memory: one bloom row's sub-word.
template <int kPackLog2>
struct Entry {
  using T = uint32_t;
};
template <>
struct Entry<1> {
  using T = uint16_t;
};
template <>
struct Entry<2> {
  using T = uint8_t;
};

// The sub-word of `code` under salt p: from the staged entries, or from
// the table in device memory in its own layout.
template <int kPackLog2, bool kSmem>
__device__ __forceinline__ uint32_t probe(const Params& P, int p,
                                          uint32_t code) {
  const uint32_t h = (code ^ P.salts[p]) * kKnuth;
  if constexpr (kSmem) {
    // (p << log2_rows) + row, row = h >> shift
    const uint32_t e = __funnelshift_r(h, static_cast<uint32_t>(p), P.shift);
    return reinterpret_cast<const typename Entry<kPackLog2>::T*>(
        bwv_smem)[e];
  } else {
    constexpr int kSubBits = 32 >> kPackLog2;
    constexpr uint32_t kSubMask = kPackLog2 ? (1u << kSubBits) - 1u : ~0u;
    const uint32_t row = h >> P.shift;
    const uint32_t bank = row >> 7;
    const size_t o = (static_cast<size_t>(p) << P.log2_phys) +
                     ((bank >> kPackLog2) << 7) + (row & 127u);
    const uint32_t got = static_cast<uint32_t>(__ldg(P.table + o));
    return (got >> ((bank & ((1u << kPackLog2) - 1u)) * kSubBits)) &
           kSubMask;
  }
}

// AND over the k salts of each of 4 codes' sub-words.
template <int kPackLog2, bool kSmem>
__device__ __forceinline__ uint4 and_four(const Params& P, uint4 c) {
  uint32_t a0 = probe<kPackLog2, kSmem>(P, 0, c.x);
  uint32_t a1 = probe<kPackLog2, kSmem>(P, 0, c.y);
  uint32_t a2 = probe<kPackLog2, kSmem>(P, 0, c.z);
  uint32_t a3 = probe<kPackLog2, kSmem>(P, 0, c.w);
#pragma unroll
  for (int p = 1; p < kFirstProbes; ++p) {
    if (p < P.k) {
      a0 &= probe<kPackLog2, kSmem>(P, p, c.x);
      a1 &= probe<kPackLog2, kSmem>(P, p, c.y);
      a2 &= probe<kPackLog2, kSmem>(P, p, c.z);
      a3 &= probe<kPackLog2, kSmem>(P, p, c.w);
    }
  }
#pragma unroll
  for (int p = kFirstProbes; p < kMaxSalts; ++p) {
    if (p >= P.k || (a0 | a1 | a2 | a3) == 0u) break;
    if (a0 != 0u) a0 &= probe<kPackLog2, kSmem>(P, p, c.x);
    if (a1 != 0u) a1 &= probe<kPackLog2, kSmem>(P, p, c.y);
    if (a2 != 0u) a2 &= probe<kPackLog2, kSmem>(P, p, c.z);
    if (a3 != 0u) a3 &= probe<kPackLog2, kSmem>(P, p, c.w);
  }
  return make_uint4(a0, a1, a2, a3);
}

// Table words s .. s+3 (lanes l .. l+3 of one physical row of salt p) to
// their shared-memory entries: sub-word j of word s + i is row
// ((s >> 7 within the salt) * pack + j) * 128 + l + i of salt p, at entry
// (s & ~127) * pack + 128 * j + (s & 127) + i.
template <int kPackLog2>
__device__ __forceinline__ void stage_table(const Params& P) {
  const uint32_t n4 = static_cast<uint32_t>(P.table_words) / 4u;
  for (uint32_t g = threadIdx.x; g < n4; g += kThreads) {
    const uint32_t s = 4u * g;
    const uint32_t w0 = static_cast<uint32_t>(__ldg(P.table + s));
    const uint32_t w1 = static_cast<uint32_t>(__ldg(P.table + s + 1));
    const uint32_t w2 = static_cast<uint32_t>(__ldg(P.table + s + 2));
    const uint32_t w3 = static_cast<uint32_t>(__ldg(P.table + s + 3));
    const uint32_t e = ((s & ~127u) << kPackLog2) + (s & 127u);
    if constexpr (kPackLog2 == 0) {
      bwv_smem[g] = make_uint4(w0, w1, w2, w3);
    } else if constexpr (kPackLog2 == 1) {
      uint16_t* t = reinterpret_cast<uint16_t*>(bwv_smem) + e;
      *reinterpret_cast<uint2*>(t) =
          make_uint2(__byte_perm(w0, w1, 0x5410), __byte_perm(w2, w3, 0x5410));
      *reinterpret_cast<uint2*>(t + 128) =
          make_uint2(__byte_perm(w0, w1, 0x7632), __byte_perm(w2, w3, 0x7632));
    } else {
      uint8_t* t = reinterpret_cast<uint8_t*>(bwv_smem) + e;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = j | ((j + 4) << 4);
        *reinterpret_cast<uint32_t*>(t + 128 * j) =
            __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel),
                        0x5410);
      }
    }
  }
}

template <int kPackLog2, bool kSmem>
__global__ void __launch_bounds__(kThreads, 2)
    bloom_word_vmem_kernel(const __grid_constant__ Params P) {
  const uint4* src = reinterpret_cast<const uint4*>(P.codes + P.head);
  uint4* dst = reinterpret_cast<uint4*>(P.out + P.head);
  const size_t step = static_cast<size_t>(gridDim.x) * kThreads;
  src += static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  dst += static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  // group threadIdx.x of item `it` exists
  auto has = [&](unsigned it) {
    return it + 1u < P.n_items ||
           (it + 1u == P.n_items && threadIdx.x < P.last);
  };
  unsigned item = blockIdx.x;
  uint4 cur = has(item) ? __ldcs(src) : make_uint4(0u, 0u, 0u, 0u);
  if (kSmem) {
    stage_table<kPackLog2>(P);
    __syncthreads();
  }
  for (; has(item); item += gridDim.x) {
    const bool more = has(item + gridDim.x);
    const uint4 next = more ? __ldcs(src + step) : make_uint4(0u, 0u, 0u, 0u);
    __stcs(dst, and_four<kPackLog2, kSmem>(P, cur));
    cur = next;
    src += step;
    dst += step;
  }
  // the head and the tail, one code a thread
  const int n_edge = static_cast<int>(P.head) + P.tail;
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < n_edge) {
    const long long i = threadIdx.x < P.head
                            ? static_cast<long long>(threadIdx.x)
                            : threadIdx.x + 4 * P.n_groups;
    const uint32_t code = static_cast<uint32_t>(__ldg(P.codes + i));
    uint32_t acc = probe<kPackLog2, kSmem>(P, 0, code);
#pragma unroll
    for (int p = 1; p < kMaxSalts; ++p) {
      if (p >= P.k || acc == 0u) break;
      acc &= probe<kPackLog2, kSmem>(P, p, code);
    }
    P.out[i] = static_cast<int>(acc);
  }
}

using KernelFn = void (*)(Params);

KernelFn pick(int pack_log2, bool smem) {
  switch (pack_log2) {
    case 0: return smem ? bloom_word_vmem_kernel<0, true>
                        : bloom_word_vmem_kernel<0, false>;
    case 1: return smem ? bloom_word_vmem_kernel<1, true>
                        : bloom_word_vmem_kernel<1, false>;
    default: return smem ? bloom_word_vmem_kernel<2, true>
                         : bloom_word_vmem_kernel<2, false>;
  }
}

int pack_log2_of(int pack) {
  return pack == 1 ? 0 : pack == 2 ? 1 : pack == 4 ? 2 : -1;
}

// Resident blocks for `groups` groups of 4 codes (at least one block, for
// the head and tail).
cudaError_t grid_of(KernelFn kernel, bool in_smem, long long groups,
                    int* blocks) {
  return grid_stride::blocks_for(reinterpret_cast<const void*>(kernel),
                                 kThreads, in_smem ? kSmemTableBudget : 0,
                                 groups > 0 ? groups : 1, blocks);
}

}  // namespace

extern "C" int bloom_word_vmem_launch(const void* table, long long table_words,
                                      const void* codes, void* out,
                                      long long n, const void* salts, int k,
                                      int log2_rows, int pack, void* stream) {
  const int pack_log2 = pack_log2_of(pack);
  if (k < 1 || k > kMaxSalts || pack_log2 < 0 || log2_rows < 7 + pack_log2 ||
      log2_rows > 31 || n < 1 ||
      table_words != (static_cast<long long>(k) << (log2_rows - pack_log2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t c_addr = reinterpret_cast<uintptr_t>(codes);
  if (c_addr % 4 != 0 || c_addr % 16 != reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  Params P;
  memset(&P, 0, sizeof(P));
  P.table = static_cast<const int*>(table);
  P.codes = static_cast<const int*>(codes);
  P.out = static_cast<int*>(out);
  P.table_words = table_words;
  const long long head = static_cast<long long>((16 - c_addr % 16) % 16 / 4);
  P.head = head < n ? head : n;
  P.n_groups = (n - P.head) / 4;
  P.tail = static_cast<int>((n - P.head) % 4);
  const long long n_items = (P.n_groups + kThreads - 1) / kThreads;
  if (n_items >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  P.n_items = static_cast<unsigned>(n_items);
  P.last = static_cast<unsigned>(P.n_groups - (n_items - 1) * kThreads);
  memcpy(P.salts, salts, sizeof(uint32_t) * k);
  P.k = k;
  P.shift = 32 - log2_rows;
  P.log2_phys = log2_rows - pack_log2;

  const size_t table_bytes = static_cast<size_t>(table_words) * sizeof(int);
  const bool in_smem = table_bytes <= kSmemTableBudget;
  const KernelFn kernel = pick(pack_log2, in_smem);
  int blocks = 0;
  const cudaError_t err = grid_of(kernel, in_smem, P.n_groups, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, in_smem ? table_bytes : 0,
           static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// Grid, block and resident blocks per SM of the launch for n codes at
// these arguments (for reports; launches nothing).
extern "C" int bloom_word_vmem_shape(long long table_words, int pack,
                                     long long n, int* grid, int* block,
                                     int* per_sm) {
  const int pack_log2 = pack_log2_of(pack);
  if (pack_log2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t table_bytes = static_cast<size_t>(table_words) * sizeof(int);
  const bool in_smem = table_bytes <= kSmemTableBudget;
  const KernelFn kernel = pick(pack_log2, in_smem);
  cudaError_t err = grid_of(kernel, in_smem, n / 4, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  *block = kThreads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, kThreads, in_smem ? table_bytes : 0);
  return static_cast<int>(err);
}
