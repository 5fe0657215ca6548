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
// grid cell, ~145 MB with the outputs at the headline's 128 MiB corpus,
// ~43 us at 3.35 TB/s), but each cell also needs its q-gram code (four
// dp4a a word and six joins, 18 integer operations at q = 9) and ~12
// operations per salted probe made (~3.4 probes a code there): ~1.0e9
// operations, ~60 us at the card's 16.7e12 int32 operations a second.  So
// the design spends as few instructions a cell as it can and keeps every
// SM issuing:
//
//   * no division: the wrapper passes, for every word offset c a cell
//     reads, the flat offset of its phase word (phase c mod spc, c div spc
//     cells on); pack enters as its log2, so a probe is shifts and masks;
//   * the q-gram code by four dp4a byte products a word: the weights
//     GRAM_BASE^(q-1-j) are split into their four bytes, and the partial
//     sums meet with shifts (exact mod 2^32); the kernel is a template on
//     the number of words (1-4), so no loop bound is a runtime q;
//   * every constant (salts, weight bytes, offsets) lives in the kernel's
//     parameter space, read as an operand of the instruction that uses it;
//   * work item = (1024-row grid block, 32 of its 128 lanes), four per
//     grid block; a block of 1024 threads is 32 warps, warp = 32 rows of
//     the column, lane = one lane, so a warp's phase loads are 128
//     contiguous bytes; at <= 32 registers two blocks share an SM
//     (64 warps), and the blocks loop over the items (grid_stride.cuh), so
//     the tables are staged once per resident block;
//   * pass 1 computes each cell's hit bit into a 32-bit mask; the exclusive
//     scan over the 32 warps of a lane gives each warp's first rank; pass 2
//     recomputes only the hits of rank < mpr (survivors are rare) and
//     writes their slots, so slot k of a column is its (k+1)-th hit in row
//     order and cnt counts every hit;
//   * the bank tables and the prefix bit bloom sit in shared memory up to
//     80 KiB (two blocks an SM), and are read through the read-only path
//     from L2 above that.
//
// The salted probes, one random shared-memory load each (~3.5-way bank
// conflicts), are most of the time.  A warp that stops each code's AND at
// its first zero word makes as many probes as its slowest lane, near all
// 8 at the headline, where a code needs ~3.4 on average.  So the first
// kFirstProbes probes of every code are made unconditionally; a code still
// alive after them (and not a hit by its short word already) goes to its
// warp's queue in shared memory with its partial AND, and each time 32 are
// queued one lane per code makes the rest of its probes, stopping at zero,
// and sets the hit bit of the cell's owner.  A warp then makes about as
// many probes as the codes need.  kFirstProbes trades unconditional probes
// against queue traffic; 4 suits the headline's tables (PERF.md has the
// times of this form against a stop at the first zero and against all k
// probes).
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "grid_stride.cuh"

namespace {

constexpr int kBlockR = 1024;  // rows of 128 lanes per grid block
constexpr int kLanes = 128;
constexpr int kGroup = 32;  // lanes of one work item
constexpr int kGroups = kLanes / kGroup;
constexpr int kThreads = 1024;  // 32 warps of kBlockR / 32 rows each
constexpr int kSegRows = kBlockR / (kThreads / kGroup);  // 32: one mask
constexpr int kMaxSalts = 8;
constexpr int kMaxWords = 4;  // q <= 16
constexpr int kMaxL16 = 20;
constexpr int kMaxPrefixSalts = 2;
constexpr int kOffBias = 8;  // word offsets c in [-8, 8)
constexpr int kMaxOff = 16;
constexpr uint32_t kKnuth = 2654435761u;
// two blocks of kThreads per SM fit beside tables of this size (and the
// ~28 KiB of static shared memory each)
constexpr size_t kSmemTableBudget = 80 * 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kQueueLen = 64;  // entries of a warp's survivor queue
constexpr int kFirstProbes = 4;

struct Params {
  const int* table;
  long long table_words;
  const int* phases;  // [spc][phase_words]
  long long woff[kMaxOff];  // word c of cell g: phases[woff[c + bias] + g]
  int dcell[kMaxOff];  // its cell offset (c div spc): < -g means "before 0"
  int c_min;  // first word offset of the prefix windows (-spc)
  int stride;  // bytes per cell, 4 * spc
  const int* sw;  // [R_pad * 128] or null
  const int* ptab;  // prefix bit bloom or null
  long long ptab_words;
  const int* mll;  // [1] min_long_len
  uint32_t salts[kMaxSalts];
  int k;
  int shift;  // 32 - log2_rows
  int log2_phys;  // log2 of the physical words of one probe table
  int pack_log2;
  // sub-word of a probe: (word >> ((row >> sub_sh) & amt_mask)) & sub_mask
  int sub_sh;
  uint32_t amt_mask;
  uint32_t sub_mask;
  uint32_t gram_b[kMaxWords][4];  // byte m of the weights of word c's bytes
  int mpr;
  int n_grid;
  int n_items;  // n_blocks * kGroups
  uint32_t pref_w[kMaxL16];
  int l16;
  int prefix_on;
  uint32_t psalts[kMaxPrefixSalts];
  int n_psalts;
  int prefix_log2;
  int* r_s;
  int* w_s;
  int* swo_s;
  int* h_s;
  int* cnt;
};

template <bool kSmem>
__device__ __forceinline__ int tab_at(const int* tab, uint32_t i) {
  return kSmem ? tab[i] : __ldg(tab + i);
}

// sum_j byte_j * GRAM_BASE^(q-1-j) mod 2^32 from a cell's first kNW
// words, word c at word_c[off].
template <int kNW>
__device__ __forceinline__ uint32_t gram_code(const Params& P,
                                              const int* const* word_c,
                                              int off) {
  uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
  for (int c = 0; c < kNW; ++c) {
    const uint32_t word = static_cast<uint32_t>(__ldg(word_c[c] + off));
    a0 = __dp4a(word, P.gram_b[c][0], a0);
    a1 = __dp4a(word, P.gram_b[c][1], a1);
    a2 = __dp4a(word, P.gram_b[c][2], a2);
    a3 = __dp4a(word, P.gram_b[c][3], a3);
  }
  return a0 + (a1 << 8) + (a2 << 16) + (a3 << 24);
}

// acc AND over the salts p in [kP0, kP1) (and < k) of the hashed
// (32 >> pack_log2)-bit bank sub-word; with kStop the loop ends at zero.
template <bool kSmem, bool kStop, int kP0 = 0, int kP1 = kMaxSalts>
__device__ __forceinline__ uint32_t bank_probe(const Params& P,
                                               const int* tab,
                                               uint32_t code,
                                               uint32_t acc = ~0u) {
#pragma unroll
  for (int p = kP0; p < kP1; ++p) {
    if (p < P.k) {
      // row = bank * 128 + lane; the bank's physical word is bank / pack
      // (row >> pack_log2 keeps it above bit 7, no carry from the lane),
      // its sub-word bank % pack
      const uint32_t row = ((code ^ P.salts[p]) * kKnuth) >> P.shift;
      const uint32_t o = (static_cast<uint32_t>(p) << P.log2_phys) +
                         (((row >> P.pack_log2) & ~127u) | (row & 127u));
      const uint32_t got = static_cast<uint32_t>(tab_at<kSmem>(tab, o));
      acc &= (got >> ((row >> P.sub_sh) & P.amt_mask)) & P.sub_mask;
      if (kStop && acc == 0u) break;
    }
  }
  return acc;
}

// Word c (any offset the windows need) of cell g; 0 before the corpus.
__device__ __forceinline__ uint32_t word_at(const Params& P, int c,
                                            long long g) {
  const int i = c + kOffBias;
  if (g + P.dcell[i] < 0) return 0u;
  return static_cast<uint32_t>(__ldg(P.phases + P.woff[i] + g));
}

// l16-byte polynomial hash of the candidate window of the lowest set
// alignment bit of w (0 when none of the stride alignment bits is set).
// Equal mod 2^32 to the rolling hash of the reference.  The window's <= 6
// words are loaded together, not one dependent load a byte.
__device__ __forceinline__ uint32_t prefix_hash(const Params& P,
                                                long long g, uint32_t w) {
  const uint32_t smask = P.stride < 32 ? ((1u << P.stride) - 1u) : ~0u;
  const uint32_t w8 = w & smask;
  if (w8 == 0u) return 0u;
  const int j = __ffs(static_cast<int>(w8)) - 1;
  const int x0 = -4 * P.c_min - j;  // >= 1: window start as a byte offset
  const int c0 = P.c_min + (x0 >> 2), sh = x0 & 3;
  uint32_t h = 0;
#pragma unroll
  for (int m = 0; m < (kMaxL16 + 3) / 4 + 1; ++m) {
    if (4 * m - sh < P.l16) {
      const uint32_t word = word_at(P, c0 + m, g);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * m + b - sh;  // byte of the window
        if (i >= 0 && i < P.l16)
          h += ((word >> (8 * b)) & 0xFFu) * P.pref_w[i];
      }
    }
  }
  return h;
}

template <int kNW, bool kSmem>
__global__ void __launch_bounds__(kThreads, 2)
    fused_sampled_extract_kernel(const __grid_constant__ Params P) {
  extern __shared__ int smem[];
  __shared__ int seg_hits[kThreads / kGroup][kGroup];
  // each warp's survivors (code, partial AND, lane * 32 + row) and the
  // hit bits they set, per lane
  __shared__ uint32_t q_code[kWarps][kQueueLen];
  __shared__ uint32_t q_acc[kWarps][kQueueLen];
  __shared__ uint16_t q_id[kWarps][kQueueLen];
  __shared__ uint32_t late[kWarps][kGroup];
  const int* tab = P.table;
  const int* ptab = P.ptab;
  if (kSmem) {
    for (long long i = threadIdx.x; i < P.table_words; i += kThreads)
      smem[i] = __ldg(P.table + i);
    tab = smem;
    if (ptab != nullptr) {
      int* sp = smem + P.table_words;
      for (long long i = threadIdx.x; i < P.ptab_words; i += kThreads)
        sp[i] = __ldg(P.ptab + i);
      ptab = sp;
    }
  }
  const bool long_on = __ldg(P.mll) > 0;
  const int lane = threadIdx.x % kGroup;
  const int seg = threadIdx.x / kGroup;
  const uint32_t amask = P.stride < 32 ? ((1u << P.stride) - 1u) : ~0u;

  for (int item = blockIdx.x; item < P.n_items; item += gridDim.x) {
    const int blk = item / kGroups;
    const int col = (item % kGroups) * kGroup + lane;
    const long long g0 =
        (static_cast<long long>(blk) * kBlockR + seg * kSegRows) * kLanes +
        col;
    __syncthreads();  // tables staged; the last item's ranks read

    // pass 1: hit bits of this thread's 32 cells, in row order.  Cells
    // past n_grid lie inside the padded phases: read, dropped at the end.
    const int* word_c[kNW];
#pragma unroll
    for (int c = 0; c < kNW; ++c)
      word_c[c] = P.phases + P.woff[c + kOffBias] + g0;
    const int* sw_col = P.sw != nullptr ? P.sw + g0 : nullptr;
    const long long n_valid = (P.n_grid - g0 + kLanes - 1) / kLanes;
    const uint32_t valid = n_valid >= kSegRows ? ~0u
                           : n_valid <= 0      ? 0u
                                               : (1u << n_valid) - 1u;
    uint32_t mask = 0;
    uint32_t* my_code = q_code[seg];
    uint32_t* my_acc = q_acc[seg];
    uint16_t* my_id = q_id[seg];
    uint32_t* my_late = late[seg];
    my_late[lane] = 0u;
    // the rest of the probes of queue entries [base, base + n)
    auto drain = [&](int base, int n) {
      __syncwarp();
      if (lane < n) {
        const int e = base + lane;
        const uint32_t acc = bank_probe<kSmem, true, kFirstProbes>(
            P, tab, my_code[e], my_acc[e]);
        const int id = my_id[e];
        if (acc != 0u) atomicOr(my_late + (id >> 5), 1u << (id & 31));
      }
      __syncwarp();
    };
    int qn = 0;  // queued entries, the same in every lane
#pragma unroll 2
    for (int r = 0; r < kSegRows; ++r) {
      uint32_t code = 0u, acc = 0u;
      if (long_on) {
        code = gram_code<kNW>(P, word_c, r * kLanes);
        acc = bank_probe<kSmem, false, 0, kFirstProbes>(P, tab, code);
      }
      const uint32_t sw =
          sw_col ? static_cast<uint32_t>(__ldg(sw_col + r * kLanes)) : 0u;
      // acc is final when k <= kFirstProbes, and decides nothing when
      // zero or when the short word hits anyway
      const bool more = acc != 0u && sw == 0u && P.k > kFirstProbes;
      if (!more && (acc | sw) != 0u) mask |= 1u << r;
      const uint32_t vote = __ballot_sync(0xFFFFFFFFu, more);
      if (more) {
        const int e = qn + __popc(vote & ((1u << lane) - 1u));
        my_code[e] = code;
        my_acc[e] = acc;
        my_id[e] = static_cast<uint16_t>(lane * 32 + r);
      }
      qn += __popc(vote);
      if (qn >= 32) {
        qn -= 32;
        drain(qn, 32);
      }
    }
    if (qn > 0) drain(0, qn);
    mask |= my_late[lane];
    mask &= valid;
    seg_hits[seg][lane] = __popc(mask);
    __syncthreads();

    int rank = 0, total = 0;
#pragma unroll
    for (int s = 0; s < kThreads / kGroup; ++s) {
      const int c = seg_hits[s][lane];
      if (s < seg) rank += c;
      total += c;
    }
    const long long slot0 = static_cast<long long>(blk) * P.mpr;
    if (seg == 0) {
      P.cnt[blk * kLanes + col] = total;
      for (int k = total < P.mpr ? total : P.mpr; k < P.mpr; ++k) {
        const long long o = (slot0 + k) * kLanes + col;
        P.r_s[o] = -1;
        P.w_s[o] = 0;
        P.swo_s[o] = 0;
        P.h_s[o] = 0;
      }
    }

    // pass 2: slots of the hits of rank < mpr
    while (mask != 0u && rank < P.mpr) {
      const int r = __ffs(static_cast<int>(mask)) - 1;
      mask &= mask - 1u;
      const long long g = g0 + static_cast<long long>(r) * kLanes;
      const uint32_t code = gram_code<kNW>(P, word_c, r * kLanes);
      // a hit's AND is rarely zero: all k probes, loads in parallel
      uint32_t w = long_on ? bank_probe<kSmem, false>(P, tab, code) : 0u;
      const uint32_t sw =
          P.sw != nullptr ? static_cast<uint32_t>(__ldg(P.sw + g)) : 0u;
      const uint32_t h = P.prefix_on ? prefix_hash(P, g, w) : code;
      if (ptab != nullptr && P.prefix_on) {
        uint32_t ok = 1u;
        for (int p = 0; p < P.n_psalts; ++p) {
          const uint32_t slot =
              ((h ^ P.psalts[p]) * kKnuth) >> (32 - P.prefix_log2);
          ok &= (static_cast<uint32_t>(tab_at<kSmem>(ptab, slot >> 5)) >>
                 (slot & 31u)) & 1u;
        }
        const uint32_t v = w & amask;
        const bool single = v != 0u && (v & (v - 1u)) == 0u;
        if (single && ok == 0u) w = 0u;
      }
      const long long o = (slot0 + rank) * kLanes + col;
      P.r_s[o] = seg * kSegRows + r;
      P.w_s[o] = static_cast<int>(w);
      P.swo_s[o] = static_cast<int>(sw);
      P.h_s[o] = static_cast<int>(h);
      ++rank;
    }
  }
}

using KernelFn = void (*)(Params);

template <int kNW>
KernelFn pick_smem(bool smem) {
  return smem ? fused_sampled_extract_kernel<kNW, true>
              : fused_sampled_extract_kernel<kNW, false>;
}

KernelFn pick(int n_words, bool smem) {
  switch (n_words) {
    case 1: return pick_smem<1>(smem);
    case 2: return pick_smem<2>(smem);
    case 3: return pick_smem<3>(smem);
    default: return pick_smem<4>(smem);
  }
}

}  // namespace

// woff / dcell: kMaxOff entries for word offsets c in [-8, 8) (index
// c + 8), from the wrapper; gram_b: kMaxWords x 4 weight bytes.
extern "C" int fused_sampled_extract_launch(
    const void* table, long long table_words, const void* phases,
    const void* woff, const void* dcell, int spc, const void* sw,
    const void* ptab, long long ptab_words, const void* mll,
    const void* salts, int k, int log2_rows, int pack, const void* gram_b,
    int q, int mpr, int n_blocks, int n_grid, const void* pref_w, int l16,
    int prefix_on, const void* psalts, int n_psalts, int prefix_log2,
    void* r_s, void* w_s, void* swo_s, void* h_s, void* cnt,
    void* stream) {
  const int pack_log2 = pack == 1 ? 0 : pack == 2 ? 1 : pack == 4 ? 2 : -1;
  if (k < 1 || k > kMaxSalts || q < 1 || q > 4 * kMaxWords || l16 < 0 ||
      l16 > kMaxL16 || n_psalts < 0 || n_psalts > kMaxPrefixSalts ||
      n_blocks < 1 || spc < 1 || spc > kOffBias || pack_log2 < 0 ||
      log2_rows < 7 + pack_log2 || log2_rows > 31 ||
      table_words != (static_cast<long long>(k) << (log2_rows - pack_log2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P;
  memset(&P, 0, sizeof(P));
  P.table = static_cast<const int*>(table);
  P.table_words = table_words;
  P.phases = static_cast<const int*>(phases);
  memcpy(P.woff, woff, sizeof(P.woff));
  memcpy(P.dcell, dcell, sizeof(P.dcell));
  P.c_min = -spc;
  P.stride = 4 * spc;
  P.sw = static_cast<const int*>(sw);
  P.ptab = static_cast<const int*>(ptab);
  P.ptab_words = ptab != nullptr ? ptab_words : 0;
  P.mll = static_cast<const int*>(mll);
  memcpy(P.salts, salts, sizeof(uint32_t) * k);
  P.k = k;
  P.shift = 32 - log2_rows;
  P.log2_phys = log2_rows - pack_log2;
  P.pack_log2 = pack_log2;
  P.sub_sh = 7 - (5 - pack_log2);
  P.amt_mask = static_cast<uint32_t>((1 << pack_log2) - 1) << (5 - pack_log2);
  P.sub_mask = pack_log2 ? (1u << (32 >> pack_log2)) - 1u : ~0u;
  memcpy(P.gram_b, gram_b, sizeof(P.gram_b));
  P.mpr = mpr;
  P.n_grid = n_grid;
  P.n_items = n_blocks * kGroups;
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
  const bool in_smem = table_bytes <= kSmemTableBudget;
  const KernelFn kernel = pick((q - 1) / 4 + 1, in_smem);
  int blocks = 0;
  const cudaError_t err = grid_stride::blocks_for(
      reinterpret_cast<const void*>(kernel), kThreads,
      in_smem ? kSmemTableBudget : 0,
      static_cast<long long>(P.n_items) * kThreads, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, in_smem ? table_bytes : 0,
           static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// Grid, block and resident blocks per SM of the launch at these arguments
// (for reports; launches nothing).
extern "C" int fused_sampled_extract_shape(int q, long long table_bytes,
                                           int n_blocks,
                                           int* grid, int* block,
                                           int* per_sm) {
  const bool in_smem = table_bytes <= static_cast<long long>(kSmemTableBudget);
  const KernelFn kernel = pick((q - 1) / 4 + 1, in_smem);
  cudaError_t err = grid_stride::blocks_for(
      reinterpret_cast<const void*>(kernel), kThreads,
      in_smem ? kSmemTableBudget : 0,
      static_cast<long long>(n_blocks) * kGroups * kThreads, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  *block = kThreads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, kThreads, in_smem ? table_bytes : 0);
  return static_cast<int>(err);
}
