// Grid stage of the grouped take filter: q-gram codes from the packed
// corpus, the first salt's probe of the flat positional bloom, rank
// extraction of the survivors per (block_r-row group, lane) column, and
// the per-slot re-probes, in one pass over the corpus words.
//
// Its reference is XLA code, not a Pallas kernel: stages A and B1 of
// filter_hits_sampled_grouped (php_aho_corasick_tpu/ops/filter_jax.py),
// whose rank extraction is group_rank_extract (ops/filter_pallas.py), the
// mirror of the fused kernel's stage 4.  The semantics are those of the
// plain version _grouped_extract_torch (ops/filter_cuda.py), bit for bit:
//
//   code  = sum_j byte[p + j] * GRAM_BASE^(q-1-j) mod 2^32 over the cell's
//           row words (zeros past the row's end, never the next row's);
//   w     = min_long_len > 0 ? words[((code ^ salt0) * KNUTH) >> shift] : 0;
//   hit   = (w | sw) != 0 for cells < n_grid;
//   slot k of column (group i, lane l) = its (k+1)-th hit in row order,
//   with w ANDed by the other salts' words of code, or with words2 under
//   SALT2 of the GRAM_BASE2 code c (then c_s = c, else c_s = code).
//
// What bounds it on an H100: the corpus is read once (stride bytes a
// cell) and the bloom once a cell, a 4-byte word at a random address of
// a bloom of 2^21-2^28 words: at the signature cells (1 GiB) the probe
// misses L2, and each one moves a 32-byte sector.  The slot arrays are a
// few percent of the grid.  So the design keeps many probes in flight
// and touches nothing twice that it can avoid:
//
//   * work item = (group, 32 of its 128 lanes); a block of 1024 threads is
//     32 warps, warp = a segment of the column's rows, lane = one lane, so
//     a warp's corpus loads are 32 consecutive cells; the blocks loop over
//     the items (grid_stride.cuh);
//   * pass 1 takes the rows of a segment kBatch at a time: the corpus
//     words of kBatch cells, their codes (dp4a byte products, as in the
//     fused kernel), then their kBatch bloom loads together, so each
//     thread has kBatch gathers in flight;
//   * the hit bits go into a 32-bit mask; an exclusive scan over the 32
//     warps of a lane gives each warp's first rank; pass 2 recomputes
//     only the hits of rank < mpr (survivors are rare by the group size
//     the model picks) and makes their re-probes as it writes their slots.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "grid_stride.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kGroup = 32;  // lanes of one work item
constexpr int kGroups = kLanes / kGroup;
constexpr int kThreads = 1024;  // 32 warps: one row segment each
constexpr int kSegs = kThreads / kGroup;
constexpr int kMaxBlockR = kSegs * 32;  // 32 rows a segment: one mask
constexpr int kMaxSalts = 8;
constexpr int kMaxWords = 4;  // q <= 16
constexpr int kBatch = 4;  // bloom gathers in flight a thread
constexpr uint32_t kKnuth = 2654435761u;
constexpr uint32_t kSalt2 = 0x6A09E667u;

struct Params {
  const int* wc;  // [B * row_words] packed corpus words
  int spc;  // words a grid cell
  int M;  // cells a row
  const int* words;  // [2^log2_words] positional bloom
  int shift;  // 32 - log2_words
  uint32_t salts[kMaxSalts];
  int k;
  const int* words2;  // second-family bloom or null
  const int* sw;  // [n_grid] short-start words or null
  const int* mll;  // [1] min_long_len
  uint32_t gram_b[kMaxWords][4];  // byte m of word c's GRAM_BASE weights
  uint32_t gram_b2[kMaxWords][4];  // the same for GRAM_BASE2
  int mpr;
  int block_r;
  int seg_rows;  // rows of one segment, ceil(block_r / 32)
  int n_grid;
  int n_items;  // n_blocks * kGroups
  int* r_s;
  int* w_s;
  int* swo_s;
  int* c_s;
  int* cnt;
};

// The first kNW corpus words of cell g, zeros past the end of its row.
template <int kNW>
__device__ __forceinline__ void cell_words(const Params& P, int g,
                                           uint32_t (&wd)[kNW]) {
  const long long base = static_cast<long long>(g) * P.spc;
  int left = kNW;
  if (kNW > P.spc) {
    // the gram reaches into later cells: stop at the row's end
    const int rem = P.M - g % P.M;
    left = rem >= kNW ? kNW : rem * P.spc;
  }
#pragma unroll
  for (int c = 0; c < kNW; ++c)
    wd[c] = c < left ? static_cast<uint32_t>(__ldg(P.wc + base + c)) : 0u;
}

// sum_j byte_j * base^(q-1-j) mod 2^32 by four dp4a a word: gb[c][m]
// packs byte m of the weights of word c's four bytes.
template <int kNW>
__device__ __forceinline__ uint32_t gram_code(const uint32_t (&gb)[kMaxWords][4],
                                              const uint32_t (&wd)[kNW]) {
  uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
  for (int c = 0; c < kNW; ++c) {
    a0 = __dp4a(wd[c], gb[c][0], a0);
    a1 = __dp4a(wd[c], gb[c][1], a1);
    a2 = __dp4a(wd[c], gb[c][2], a2);
    a3 = __dp4a(wd[c], gb[c][3], a3);
  }
  return a0 + (a1 << 8) + (a2 << 16) + (a3 << 24);
}

__device__ __forceinline__ uint32_t probe(const int* bloom, uint32_t code,
                                          uint32_t salt, int shift) {
  return static_cast<uint32_t>(__ldg(bloom + (((code ^ salt) * kKnuth) >> shift)));
}

template <int kNW>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_take_extract_kernel(const __grid_constant__ Params P) {
  __shared__ int seg_hits[kSegs][kGroup];
  const bool long_on = __ldg(P.mll) > 0;
  const int lane = threadIdx.x % kGroup;
  const int seg = threadIdx.x / kGroup;
  const int row0 = seg * P.seg_rows;
  int nr = P.block_r - row0;  // rows of this segment
  nr = nr < 0 ? 0 : nr > P.seg_rows ? P.seg_rows : nr;

  for (int item = blockIdx.x; item < P.n_items; item += gridDim.x) {
    const int blk = item / kGroups;
    const int col = (item % kGroups) * kGroup + lane;
    const int g0 = (blk * P.block_r + row0) * kLanes + col;
    __syncthreads();  // the last item's ranks read

    // pass 1: hit bits of this thread's cells, in row order
    uint32_t mask = 0;
    for (int r0 = 0; r0 < nr; r0 += kBatch) {
      uint32_t code[kBatch];
      bool in[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + (r0 + u) * kLanes;
        in[u] = r0 + u < nr && g < P.n_grid;
        code[u] = 0u;
        if (in[u] && long_on) {
          uint32_t wd[kNW];
          cell_words<kNW>(P, g, wd);
          code[u] = gram_code<kNW>(P.gram_b, wd);
        }
      }
      uint32_t hit[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + (r0 + u) * kLanes;
        const uint32_t w =
            in[u] && long_on ? probe(P.words, code[u], P.salts[0], P.shift)
                             : 0u;
        const uint32_t s =
            in[u] && P.sw != nullptr ? static_cast<uint32_t>(__ldg(P.sw + g))
                                     : 0u;
        hit[u] = w | s;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (hit[u] != 0u) mask |= 1u << (r0 + u);
    }
    seg_hits[seg][lane] = __popc(mask);
    __syncthreads();

    int rank = 0, total = 0;
#pragma unroll
    for (int s = 0; s < kSegs; ++s) {
      const int c = seg_hits[s][lane];
      if (s < seg) rank += c;
      total += c;
    }
    const long long slot0 = static_cast<long long>(blk) * P.mpr;
    if (seg == 0) P.cnt[blk * kLanes + col] = total;
    const int used = total < P.mpr ? total : P.mpr;
    for (int k = seg; k < P.mpr; k += kSegs) {
      if (k >= used) {
        const long long o = (slot0 + k) * kLanes + col;
        P.r_s[o] = -1;
        P.w_s[o] = 0;
        P.swo_s[o] = 0;
        P.c_s[o] = 0;
      }
    }

    // pass 2: slots of the hits of rank < mpr, with their re-probes
    while (mask != 0u && rank < P.mpr) {
      const int r = __ffs(static_cast<int>(mask)) - 1;
      mask &= mask - 1u;
      const int g = g0 + r * kLanes;
      uint32_t wd[kNW];
      cell_words<kNW>(P, g, wd);
      const uint32_t code = gram_code<kNW>(P.gram_b, wd);
      const uint32_t c =
          P.words2 != nullptr ? gram_code<kNW>(P.gram_b2, wd) : code;
      uint32_t w = long_on ? probe(P.words, code, P.salts[0], P.shift) : 0u;
      if (w != 0u) {
        if (P.words2 != nullptr) {
          w &= probe(P.words2, c, kSalt2, P.shift);
        } else {
          for (int p = 1; p < P.k; ++p)
            w &= probe(P.words, code, P.salts[p], P.shift);
        }
      }
      const uint32_t s =
          P.sw != nullptr ? static_cast<uint32_t>(__ldg(P.sw + g)) : 0u;
      const long long o = (slot0 + rank) * kLanes + col;
      P.r_s[o] = row0 + r;
      P.w_s[o] = static_cast<int>(w);
      P.swo_s[o] = static_cast<int>(s);
      P.c_s[o] = static_cast<int>(c);
      ++rank;
    }
  }
}

using KernelFn = void (*)(Params);

KernelFn pick(int n_words) {
  switch (n_words) {
    case 1: return grouped_take_extract_kernel<1>;
    case 2: return grouped_take_extract_kernel<2>;
    case 3: return grouped_take_extract_kernel<3>;
    default: return grouped_take_extract_kernel<4>;
  }
}

}  // namespace

// gram_b / gram_b2: kMaxWords x 4 weight bytes of GRAM_BASE / GRAM_BASE2.
extern "C" int grouped_take_extract_launch(
    const void* wc, long long row_words, int spc, int M, const void* words,
    int log2_words, const void* salts, int k, const void* words2,
    const void* sw, const void* mll, const void* gram_b, const void* gram_b2,
    int q, int mpr, int block_r, int n_blocks, int n_grid, void* r_s,
    void* w_s, void* swo_s, void* c_s, void* cnt, void* stream) {
  if (k < 1 || k > kMaxSalts || q < 1 || q > 4 * kMaxWords || spc < 1 ||
      M < 0 || row_words != static_cast<long long>(M) * spc ||
      log2_words < 5 || log2_words > 31 || mpr < 1 || mpr > kLanes ||
      block_r < 1 || block_r > kMaxBlockR || n_blocks < 1 || n_grid < 0 ||
      static_cast<long long>(n_blocks) * block_r * kLanes >= (1LL << 31) ||
      n_grid > n_blocks * block_r * kLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P;
  memset(&P, 0, sizeof(P));
  P.wc = static_cast<const int*>(wc);
  P.spc = spc;
  P.M = M > 0 ? M : 1;
  P.words = static_cast<const int*>(words);
  P.shift = 32 - log2_words;
  memcpy(P.salts, salts, sizeof(uint32_t) * k);
  P.k = k;
  P.words2 = static_cast<const int*>(words2);
  P.sw = static_cast<const int*>(sw);
  P.mll = static_cast<const int*>(mll);
  memcpy(P.gram_b, gram_b, sizeof(P.gram_b));
  memcpy(P.gram_b2, gram_b2, sizeof(P.gram_b2));
  P.mpr = mpr;
  P.block_r = block_r;
  P.seg_rows = (block_r + kSegs - 1) / kSegs;
  P.n_grid = n_grid;
  P.n_items = n_blocks * kGroups;
  P.r_s = static_cast<int*>(r_s);
  P.w_s = static_cast<int*>(w_s);
  P.swo_s = static_cast<int*>(swo_s);
  P.c_s = static_cast<int*>(c_s);
  P.cnt = static_cast<int*>(cnt);

  const KernelFn kernel = pick((q - 1) / 4 + 1);
  int blocks = 0;
  const cudaError_t err = grid_stride::blocks_for(
      reinterpret_cast<const void*>(kernel), kThreads, 0,
      static_cast<long long>(P.n_items) * kThreads, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
