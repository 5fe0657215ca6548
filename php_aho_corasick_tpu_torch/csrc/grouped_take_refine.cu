// Refinement of the grouped take filter's compacted hits: for every entry
// of the compaction, in slot order, the gathers of its slot's cell, long
// and short word, the prefix hash of its window and that hash's bit in
// the prefix bit bloom under every salt, in one thread.
//
// Its reference is XLA code: stage B2 of filter_hits_sampled_grouped
// (php_aho_corasick_tpu/ops/filter_jax.py), whose bit test is
// bloom_hit_take.  It takes the place of the bloom_hit launches (one a
// prefix salt) that the grouped filter made before: at its shapes (a few
// thousand entries) a launch of its own costs more than the whole test,
// so the test runs in the pass that computes the hash.  The semantics are
// those of the plain version _grouped_refine_torch (ops/filter_cuda.py),
// bit for bit:
//
//   entry i, slot s = slot[i] (INT32_MAX: none):
//     cell = ((s / 128 / mpr) * block_r + r_s[s]) * 128 + s % 128
//     lw = w_s[s], swo = swo_s[s]
//   with a prefix bloom, j = the lowest set alignment bit of lw (of the
//   stride's bits): h = sum_i byte[4 * cell * spc - j + i] *
//   GRAM_BASE^(l16-1-i) mod 2^32 over the flat corpus words, each word
//   index clamped to the corpus (a window may cross rows); ok = AND over
//   the salts of bit slot & 31 of word slot >> 5, slot = ((h ^ salt) *
//   KNUTH) >> (32 - prefix_log2); a single-alignment lw whose ok is 0 is
//   dropped, and an entry left with no word is INT32_MAX with zeros.
//
// What bounds it: each entry reads its slot number and writes three words
// (16 bytes), and a live one gathers three slot words, its <= 6 window
// words and one prefix-bloom word a salt.  A few thousand entries are
// under a microsecond of memory time, so one launch a call is the point.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "grid_stride.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kMaxPrefixSalts = 8;
constexpr int kMaxL16 = 20;
constexpr int kInt32Max = 0x7FFFFFFF;
constexpr uint32_t kKnuth = 2654435761u;

struct Params {
  const int* slot;
  long long n;
  const int* r_s;
  const int* w_s;
  const int* swo_s;
  long long n_cells;  // slot cells (n_blocks * mpr * 128)
  int mpr;
  int block_r;
  int spc;
  const int* wc;  // flat packed corpus words
  long long n_words;
  const int* pw;  // prefix bit bloom or null (no refinement)
  uint32_t psalts[kMaxPrefixSalts];
  int n_psalts;
  int prefix_log2;
  uint32_t pref_w[kMaxL16];  // GRAM_BASE^(l16-1-i)
  int l16;
  int* idx;
  int* lw;
  int* swo;
};

// The l16-byte hash of the window of alignment j of the cell whose first
// word is first_word: its bytes start 4 * spc - j bytes into word -spc.
__device__ __forceinline__ uint32_t window_hash(const Params& P,
                                               long long first_word, int j) {
  const int x0 = 4 * P.spc - j;
  const long long c0 = first_word - P.spc + (x0 >> 2);
  const int sh = x0 & 3;
  uint32_t h = 0;
#pragma unroll
  for (int m = 0; m < (kMaxL16 + 3) / 4 + 1; ++m) {
    if (4 * m - sh < P.l16) {
      long long wi = c0 + m;
      wi = wi < 0 ? 0 : wi >= P.n_words ? P.n_words - 1 : wi;
      const uint32_t word = static_cast<uint32_t>(__ldg(P.wc + wi));
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * m + b - sh;
        if (i >= 0 && i < P.l16) h += ((word >> (8 * b)) & 0xFFu) * P.pref_w[i];
      }
    }
  }
  return h;
}

__global__ void __launch_bounds__(kThreads)
    grouped_take_refine_kernel(const __grid_constant__ Params P) {
  const int stride = 4 * P.spc;
  const uint32_t smask = stride < 32 ? ((1u << stride) - 1u) : ~0u;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < P.n; i += step) {
    const int s = __ldg(P.slot + i);
    int idx = kInt32Max;
    uint32_t lw = 0u, swo = 0u;
    if (s != kInt32Max) {
      const long long sf = s < 0 ? 0 : s >= P.n_cells ? P.n_cells - 1 : s;
      const int blk = static_cast<int>((sf / kLanes) / P.mpr);
      idx = (blk * P.block_r + __ldg(P.r_s + sf)) * kLanes +
            static_cast<int>(sf % kLanes);
      lw = static_cast<uint32_t>(__ldg(P.w_s + sf));
      swo = static_cast<uint32_t>(__ldg(P.swo_s + sf));
    }
    if (P.pw != nullptr) {
      const uint32_t v = lw & smask;
      if (v != 0u && (v & (v - 1u)) == 0u) {
        // a single alignment: its window's hash must pass every salt
        const uint32_t h = window_hash(
            P, static_cast<long long>(idx) * P.spc, __ffs(static_cast<int>(v)) - 1);
        uint32_t ok = 1u;
        for (int p = 0; p < P.n_psalts; ++p) {
          const uint32_t slot =
              ((h ^ P.psalts[p]) * kKnuth) >> (32 - P.prefix_log2);
          ok &= (static_cast<uint32_t>(__ldg(P.pw + (slot >> 5))) >>
                 (slot & 31u)) & 1u;
        }
        if (ok == 0u && swo == 0u) {
          idx = kInt32Max;
          lw = 0u;
        }
      } else if (lw == 0u && swo == 0u) {
        idx = kInt32Max;
      }
    }
    P.idx[i] = idx;
    P.lw[i] = static_cast<int>(lw);
    P.swo[i] = static_cast<int>(swo);
  }
}

}  // namespace

extern "C" int grouped_take_refine_launch(
    const void* slot, long long n, const void* r_s, const void* w_s,
    const void* swo_s, long long n_cells, int mpr, int block_r, int spc,
    const void* wc, long long n_words, const void* pw, const void* psalts,
    int n_psalts, int prefix_log2, const void* pref_w, int l16, void* idx,
    void* lw, void* swo, void* stream) {
  if (n < 1 || n_cells < 1 || mpr < 1 || block_r < 1 || spc < 1 ||
      spc > 8 || n_words < 0 ||
      (pw != nullptr && (n_psalts < 1 || n_psalts > kMaxPrefixSalts ||
                         prefix_log2 < 5 || prefix_log2 > 31 || l16 < 1 ||
                         l16 > kMaxL16 || n_words < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P;
  memset(&P, 0, sizeof(P));
  P.slot = static_cast<const int*>(slot);
  P.n = n;
  P.r_s = static_cast<const int*>(r_s);
  P.w_s = static_cast<const int*>(w_s);
  P.swo_s = static_cast<const int*>(swo_s);
  P.n_cells = n_cells;
  P.mpr = mpr;
  P.block_r = block_r;
  P.spc = spc;
  P.wc = static_cast<const int*>(wc);
  P.n_words = n_words;
  P.pw = static_cast<const int*>(pw);
  if (pw != nullptr) {
    memcpy(P.psalts, psalts, sizeof(uint32_t) * n_psalts);
    memcpy(P.pref_w, pref_w, sizeof(uint32_t) * l16);
  }
  P.n_psalts = n_psalts;
  P.prefix_log2 = prefix_log2;
  P.l16 = l16;
  P.idx = static_cast<int*>(idx);
  P.lw = static_cast<int*>(lw);
  P.swo = static_cast<int*>(swo);

  int blocks = 0;
  const cudaError_t err = grid_stride::blocks_for(
      reinterpret_cast<const void*>(grouped_take_refine_kernel), kThreads, 0,
      n, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_take_refine_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
