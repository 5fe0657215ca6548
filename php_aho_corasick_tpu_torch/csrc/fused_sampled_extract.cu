// Fused sampled filter of the resident-corpus cascade: gram codes, salted
// bank-bloom probe, prefix-window hash, per-column rank extraction and
// prefix-bloom refinement, in one pass over the corpus word phases.
//
// Replaces the TPU kernel `fused_sampled_extract` of the JAX package
// (php_aho_corasick_tpu/ops/filter_pallas.py, body `_fused_kernel`).  The
// semantics are those of its XLA mirror `_fused_extract_xla`, bit for bit;
// the lane/sublane rolls and the select tree there are TPU layout devices
// this card does not need.
//
// What bounds it on an H100: the phases are read once (4 * spc bytes per
// grid cell, ~140 MB for a 128 MiB corpus, ~42 us at 3.35 TB/s), and each
// cell does roughly 150 integer operations (code assembly, k salted hashes,
// k shared-memory lookups), ~2.6e9 operations for the same corpus.  The
// two floors are of one order, so the design keeps every table lookup in
// shared memory and touches device memory only for the phase words, the
// short-pattern words and the few survivor slots:
//
//   * one block of 1024 threads per 1024 x 128-cell grid block; thread
//     (segment, lane) owns rows [128 * segment, 128 * segment + 128) of its
//     lane, so a warp reads 32 neighbouring cells: coalesced phase loads;
//   * the bank tables (32 KiB at the headline plan) and the prefix bit
//     bloom (<= 16 KiB) are staged in shared memory once per block;
//   * pass 1 computes each cell's hit bit into a 128-bit register mask and
//     counts hits; an exclusive scan over the 8 segments of a lane gives each
//     segment's first rank; pass 2 recomputes only the hits of rank < mpr
//     (survivors are rare) and writes their slots.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlockR = 1024;  // rows of 128 lanes per grid block
constexpr int kLanes = 128;
constexpr int kSegs = 8;  // row segments per block: kLanes * kSegs threads
constexpr int kSegRows = kBlockR / kSegs;
constexpr int kMaxSalts = 8;
constexpr int kMaxQ = 16;
constexpr int kMaxL16 = 20;
constexpr int kMaxPrefixSalts = 2;
constexpr uint32_t kKnuth = 2654435761u;
// shared memory for the staged tables; larger tables are read from device
// memory through the read-only cache instead
constexpr size_t kSmemTableBudget = 160 * 1024;

struct Params {
  const int* table;
  long long table_words;
  const int* phases;  // [spc][phase_words]
  long long phase_words;
  int spc;
  const int* sw;    // [R_pad * 128] or null
  const int* ptab;  // prefix bit bloom or null
  long long ptab_words;
  const int* mll;  // [1] min_long_len
  uint32_t salts[kMaxSalts];
  int k;
  int log2_rows;
  int pack;
  uint32_t gram_w[kMaxQ];
  int q;
  int mpr;
  int n_grid;
  uint32_t pref_w[kMaxL16];
  int l16;
  int prefix_on;
  uint32_t psalts[kMaxPrefixSalts];
  int n_psalts;
  int prefix_log2;
  int smem_tables;
  int* r_s;
  int* w_s;
  int* swo_s;
  int* h_s;
  int* cnt;
};

struct Consts {
  uint32_t salts[kMaxSalts];
  uint32_t gram_w[kMaxQ];
  uint32_t pref_w[kMaxL16];
  uint32_t psalts[kMaxPrefixSalts];
};

// Word c of grid cell g: phase (c mod spc) shifted by floor(c / spc) cells.
// The corpus has no words before cell 0.
__device__ __forceinline__ uint32_t plane(const Params& P, int c, int g) {
  int d = c >= 0 ? c / P.spc : -((-c + P.spc - 1) / P.spc);
  int ph = c - d * P.spc;
  int idx = g + d;
  if (idx < 0) return 0u;
  return static_cast<uint32_t>(
      __ldg(P.phases + static_cast<size_t>(ph) * P.phase_words + idx));
}

// sum_j byte_j * GRAM_BASE^(q-1-j), wrapping in 32 bits.
__device__ __forceinline__ uint32_t gram_code(const Params& P,
                                              const Consts& C, int g) {
  uint32_t code = 0;
  const int n_words = (P.q - 1) / 4 + 1;
  for (int c = 0; c < n_words; ++c) {
    const uint32_t word = plane(P, c, g);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * c + k;
      if (j < P.q) code += ((word >> (8 * k)) & 0xFFu) * C.gram_w[j];
    }
  }
  return code;
}

// AND over the salts of the hashed bank word (pack sub-words per physical
// word).  An AND that reached 0 stays 0, so the loop may stop there.
__device__ __forceinline__ uint32_t bank_probe(const Params& P,
                                               const Consts& C,
                                               const int* tab,
                                               uint32_t code) {
  const uint32_t n_phys = (1u << P.log2_rows) / P.pack;
  const int sub_bits = 32 / P.pack;
  const uint32_t sub_mask = P.pack > 1 ? ((1u << sub_bits) - 1u) : ~0u;
  const int shift = 32 - P.log2_rows;
  uint32_t acc = ~0u;
  for (int p = 0; p < P.k; ++p) {
    const uint32_t row = ((code ^ C.salts[p]) * kKnuth) >> shift;
    const uint32_t lane = row & 127u;
    const uint32_t bank = row >> 7;
    const uint32_t phys = (bank / P.pack) * 128u + lane;
    const uint32_t got = static_cast<uint32_t>(tab[p * n_phys + phys]);
    acc &= (got >> ((bank % P.pack) * sub_bits)) & sub_mask;
    if (acc == 0u) break;
  }
  return acc;
}

// l16-byte polynomial hash of the candidate window of the lowest set
// alignment bit of w (0 when none of the 4 * spc alignment bits is set).
// Equal mod 2^32 to the rolling hash of the reference.
__device__ __forceinline__ uint32_t prefix_hash(const Params& P,
                                                const Consts& C, int g,
                                                uint32_t w) {
  const int s = 4 * P.spc;
  const uint32_t smask = s < 32 ? ((1u << s) - 1u) : ~0u;
  const uint32_t w8 = w & smask;
  if (w8 == 0u) return 0u;
  const int j = __ffs(static_cast<int>(w8)) - 1;
  const int c_min = -((s - 1 + 3) / 4);
  const int x0 = -4 * c_min - j;  // >= 1: window start as a byte offset
  uint32_t h = 0;
  for (int i = 0; i < P.l16; ++i) {
    const int x = x0 + i;
    const uint32_t word = plane(P, c_min + x / 4, g);
    h += ((word >> (8 * (x % 4))) & 0xFFu) * C.pref_w[i];
  }
  return h;
}

__global__ void __launch_bounds__(kLanes * kSegs, 1)
    fused_sampled_extract_kernel(const __grid_constant__ Params P) {
  extern __shared__ int smem[];
  __shared__ Consts C;
  __shared__ int seg_hits[kSegs][kLanes];
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kMaxSalts; ++i) C.salts[i] = P.salts[i];
#pragma unroll
    for (int i = 0; i < kMaxQ; ++i) C.gram_w[i] = P.gram_w[i];
#pragma unroll
    for (int i = 0; i < kMaxL16; ++i) C.pref_w[i] = P.pref_w[i];
#pragma unroll
    for (int i = 0; i < kMaxPrefixSalts; ++i) C.psalts[i] = P.psalts[i];
  }
  const int* tab = P.table;
  const int* ptab = P.ptab;
  if (P.smem_tables) {
    for (long long i = tid; i < P.table_words; i += blockDim.x)
      smem[i] = P.table[i];
    tab = smem;
    if (ptab != nullptr) {
      int* sp = smem + P.table_words;
      for (long long i = tid; i < P.ptab_words; i += blockDim.x)
        sp[i] = P.ptab[i];
      ptab = sp;
    }
  }
  __syncthreads();

  const int lane = tid % kLanes;
  const int seg = tid / kLanes;
  const int blk = blockIdx.x;
  const int row0 = blk * kBlockR + seg * kSegRows;
  const bool long_on = *P.mll > 0;

  // pass 1: hit bits of this thread's 128 cells, in row order
  uint32_t mask[kSegRows / 32];
  int n_hit = 0;
#pragma unroll
  for (int wi = 0; wi < kSegRows / 32; ++wi) {
    uint32_t m = 0;
    for (int b = 0; b < 32; ++b) {
      const int g = (row0 + wi * 32 + b) * kLanes + lane;
      if (g >= P.n_grid) break;  // later rows of this lane are padding too
      const uint32_t w =
          long_on ? bank_probe(P, C, tab, gram_code(P, C, g)) : 0u;
      const uint32_t sw =
          P.sw != nullptr ? static_cast<uint32_t>(__ldg(P.sw + g)) : 0u;
      if ((w | sw) != 0u) m |= 1u << b;
    }
    mask[wi] = m;
    n_hit += __popc(m);
  }
  seg_hits[seg][lane] = n_hit;
  __syncthreads();

  int rank = 0, total = 0;
#pragma unroll
  for (int s = 0; s < kSegs; ++s) {
    const int c = seg_hits[s][lane];
    if (s < seg) rank += c;
    total += c;
  }
  const size_t slot0 = static_cast<size_t>(blk) * P.mpr;
  if (seg == 0) {
    P.cnt[blk * kLanes + lane] = total;
    for (int k = total < P.mpr ? total : P.mpr; k < P.mpr; ++k) {
      const size_t o = (slot0 + k) * kLanes + lane;
      P.r_s[o] = -1;
      P.w_s[o] = 0;
      P.swo_s[o] = 0;
      P.h_s[o] = 0;
    }
  }

  // pass 2: slots of the hits of rank < mpr
  const int stride = 4 * P.spc;
  const uint32_t amask = stride < 32 ? ((1u << stride) - 1u) : ~0u;
#pragma unroll
  for (int wi = 0; wi < kSegRows / 32; ++wi) {
    uint32_t m = mask[wi];
    while (m != 0u && rank < P.mpr) {
      const int r = wi * 32 + __ffs(static_cast<int>(m)) - 1;
      m &= m - 1u;
      const int g = (row0 + r) * kLanes + lane;
      const uint32_t code = gram_code(P, C, g);
      uint32_t w = long_on ? bank_probe(P, C, tab, code) : 0u;
      const uint32_t sw =
          P.sw != nullptr ? static_cast<uint32_t>(__ldg(P.sw + g)) : 0u;
      const uint32_t h = P.prefix_on ? prefix_hash(P, C, g, w) : code;
      if (ptab != nullptr && P.prefix_on) {
        uint32_t ok = 1u;
        for (int p = 0; p < P.n_psalts; ++p) {
          const uint32_t slot =
              ((h ^ C.psalts[p]) * kKnuth) >> (32 - P.prefix_log2);
          ok &= (static_cast<uint32_t>(ptab[slot >> 5]) >> (slot & 31u)) & 1u;
        }
        const uint32_t v = w & amask;
        const bool single = v != 0u && (v & (v - 1u)) == 0u;
        if (single && ok == 0u) w = 0u;
      }
      const size_t o = (slot0 + rank) * kLanes + lane;
      P.r_s[o] = seg * kSegRows + r;
      P.w_s[o] = static_cast<int>(w);
      P.swo_s[o] = static_cast<int>(sw);
      P.h_s[o] = static_cast<int>(h);
      ++rank;
    }
  }
}

}  // namespace

extern "C" int fused_sampled_extract_launch(
    const void* table, long long table_words, const void* phases,
    long long phase_words, int spc, const void* sw, const void* ptab,
    long long ptab_words, const void* mll, const void* salts, int k,
    int log2_rows, int pack, const void* gram_w, int q, int mpr, int n_blocks,
    int n_grid, const void* pref_w, int l16, int prefix_on,
    const void* psalts, int n_psalts, int prefix_log2, void* r_s, void* w_s,
    void* swo_s, void* h_s, void* cnt, void* stream) {
  if (k < 1 || k > kMaxSalts || q < 1 || q > kMaxQ || l16 < 0 ||
      l16 > kMaxL16 || n_psalts < 0 || n_psalts > kMaxPrefixSalts ||
      n_blocks < 1 || spc < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P;
  memset(&P, 0, sizeof(P));
  P.table = static_cast<const int*>(table);
  P.table_words = table_words;
  P.phases = static_cast<const int*>(phases);
  P.phase_words = phase_words;
  P.spc = spc;
  P.sw = static_cast<const int*>(sw);
  P.ptab = static_cast<const int*>(ptab);
  P.ptab_words = ptab != nullptr ? ptab_words : 0;
  P.mll = static_cast<const int*>(mll);
  memcpy(P.salts, salts, sizeof(uint32_t) * k);
  P.k = k;
  P.log2_rows = log2_rows;
  P.pack = pack;
  memcpy(P.gram_w, gram_w, sizeof(uint32_t) * q);
  P.q = q;
  P.mpr = mpr;
  P.n_grid = n_grid;
  memcpy(P.pref_w, pref_w, sizeof(uint32_t) * l16);
  P.l16 = l16;
  P.prefix_on = prefix_on;
  memcpy(P.psalts, psalts, sizeof(uint32_t) * n_psalts);
  P.n_psalts = n_psalts;
  P.prefix_log2 = prefix_log2;
  P.r_s = static_cast<int*>(r_s);
  P.w_s = static_cast<int*>(w_s);
  P.swo_s = static_cast<int*>(swo_s);
  P.h_s = static_cast<int*>(h_s);
  P.cnt = static_cast<int*>(cnt);

  const size_t table_bytes =
      static_cast<size_t>(table_words + P.ptab_words) * sizeof(int);
  P.smem_tables = table_bytes <= kSmemTableBudget;
  const size_t smem = P.smem_tables ? table_bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_sampled_extract_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_sampled_extract_kernel<<<n_blocks, kLanes * kSegs, smem,
                                 static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
