// Flat take filter of the sampled cascade: every grid cell's q-gram code,
// its probes of the positional bloom, the AND of the salts' words, the
// min_long_len gate, the hit test and the hits' compaction in ascending
// cell order, in two launches (and the zeroing of a 4-byte block counter).
//
// Its reference is XLA code, not a Pallas kernel: filter_hits_sampled of
// php_aho_corasick_tpu/ops/filter_jax.py (line 214), whose gather runs as
// a lax.scan over slabs of the grid and whose compaction is a nonzero.
// The semantics are those of the plain version _flat_extract_torch
// (ops/filter_torch.py), bit for bit:
//
//   cell g = b * M + m < n_grid, M = ceil(L / stride), p = m * stride;
//   code  = sum_j byte[b, p + j] * GRAM_BASE^(q-1-j) mod 2^32, j < q, the
//           bytes past the row's end (p + j >= L) read as zeros, never the
//           next row's;
//   w     = min_long_len > 0 ? AND over salts s of
//           words[((code ^ s) * KNUTH) >> (32 - log2_words)] : 0;
//   hit   = (w | sw[g]) != 0 (sw: the short-start words, 0 without);
//   the hits in ascending g, the first `capacity` of them, are (g, w,
//   sw[g]), with (INT32_MAX, 0, 0) after them; n_hits counts them all.
//
// The torch code this replaces ran ~100 int64 passes over the grid a
// chromosome of the genome cell (the codes' adds, multiplies and casts,
// a gather a salt, the gate, a blocked nonzero and the survivor gathers).
//
// What bounds it on an H100: the corpus is read once (stride bytes a cell,
// 133 MB for one of the genome's 129 MB chromosomes) and the bloom once a
// cell and salt.  The roofline counts a probe as its 4-byte word, but a
// bloom of 2^21-2^28 words (up to 1 GiB) misses the 50 MB L2 and each
// probe moves a 32-byte sector from HBM: 22.2M cells a chromosome move
// ~710 MB of sectors, so the sector floor, not the 4-byte count, bounds
// it (~26% of the counted roofline at most).  The design keeps as many
// sector reads in flight as it can and does nothing else twice:
//
//   * grid pass (flat_take_grid_kernel): a block takes a tile of `tile`
//     consecutive cells (tile * stride <= 32 KB of corpus); its bytes are
//     staged in shared memory with 16-byte loads, and each cell's q <= 16
//     bytes are cut from the staged words by funnel shifts (zeros past the
//     row's end by a mask), the code by dp4a as in the fused kernel;
//   * a thread takes kBatch cells at once: their codes, then their kBatch
//     first-salt gathers together, then the further salts where a word is
//     still nonzero, so each thread has kBatch gathers in flight;
//   * the hit of each cell goes into a warp ballot, one 32-bit word of a
//     hit mask a 32 cells (one bit a cell, 2.8 MB a chromosome), and each
//     tile's count is kept; the last block to finish (a counter taken
//     after a memory fence) scans the counts into the tiles' offsets and
//     writes n_hits;
//   * compaction pass (flat_take_compact_kernel): a block a tile ranks the
//     tile's mask words by a block scan, and each hit of rank < capacity
//     re-reads its cell's q bytes and re-probes the bloom (~0.7% of the
//     cells at the genome's density) as it writes its slot; the slots past
//     the hits are padded.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the caller gives flat_take_extract_scratch_words(...) words of
// scratch), does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "grid_stride.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;  // bloom gathers in flight a thread
constexpr int kMaxSalts = 8;
constexpr int kMaxWords = 4;  // q <= 16
constexpr int kMaxStride = 32;
constexpr int kStep = kThreads * kBatch;  // cells a pass of a block
constexpr int kStageBudget = kStep * kMaxStride;  // corpus bytes a tile
// shared memory a block: a tile's bytes from a 16-byte boundary up to 15
// bytes below its first, its last gram, and the 5-word reads past it
constexpr int kStageBytes = kStageBudget + 64;
constexpr int kInt32Max = 0x7FFFFFFF;
constexpr uint32_t kKnuth = 2654435761u;

struct Params {
  const uint8_t* chunks;  // [rows, row_len]
  long long n_bytes;  // rows * row_len
  int row_len;
  int M;  // cells a row, ceil(row_len / stride) (1 for an empty grid)
  int stride;
  int q;
  const int* words;  // [2^log2_words] positional bloom
  int shift;  // 32 - log2_words
  uint32_t salts[kMaxSalts];
  int k;
  const int* sw;  // [n_grid] short-start words or null
  const int* mll;  // [1] min_long_len
  uint32_t gram_b[kMaxWords][4];  // byte m of word c's GRAM_BASE weights
  int n_grid;
  int tile;  // cells a tile, a multiple of kStep
  int n_tiles;
  int capacity;
  uint32_t* mask;  // [n_tiles * tile / 32] hit bits, cell order
  int* counts;  // [n_tiles] hits a tile
  int* offsets;  // [n_tiles] hits before a tile
  unsigned int* done;  // blocks finished (zeroed before the launch)
  int* n_hits;
  int* idx;  // [capacity]
  int* lw;
  int* swo;
};

// sum_j byte_j * base^(q-1-j) mod 2^32 by four dp4a a word: gb[c][m]
// packs byte m of the weights of word c's four bytes.
template <int kNW>
__device__ __forceinline__ uint32_t gram_code(
    const uint32_t (&gb)[kMaxWords][4], const uint32_t (&wd)[kNW]) {
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

// Word c of a gram with `left` bytes before its row's end: the bytes past
// it zeroed.
__device__ __forceinline__ uint32_t row_masked(uint32_t w, int left) {
  return left >= 4 ? w : left <= 0 ? 0u : w & ((1u << (8 * left)) - 1u);
}

// The bloom word of `code` under `salt`: one gather.
__device__ __forceinline__ uint32_t probe(const Params& P, uint32_t code,
                                          uint32_t salt) {
  return static_cast<uint32_t>(
      __ldg(P.words + (((code ^ salt) * kKnuth) >> P.shift)));
}

// First byte of cell g in the flat corpus, and the bytes its row has from
// there on.
__device__ __forceinline__ long long cell_byte(const Params& P, int g,
                                               int* left) {
  const int b = g / P.M;
  const int p = (g - b * P.M) * P.stride;
  *left = P.row_len - p;
  return static_cast<long long>(b) * P.row_len + p;
}

// Stage the corpus bytes [lo, hi) in shared memory from the 16-byte
// boundary at or below byte lo; returns the offset of byte lo in it.
__device__ __forceinline__ int stage_tile(const Params& P, uint4* stage,
                                          long long lo, long long hi) {
  const uintptr_t begin = reinterpret_cast<uintptr_t>(P.chunks);
  const uintptr_t end = begin + static_cast<uintptr_t>(P.n_bytes);
  const uintptr_t a_lo = (begin + lo) & ~static_cast<uintptr_t>(15);
  const uintptr_t a_hi = (begin + hi + 15) & ~static_cast<uintptr_t>(15);
  const int nv = static_cast<int>((a_hi - a_lo) >> 4);
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    const uintptr_t a = a_lo + 16 * static_cast<uintptr_t>(v);
    uint4 x;
    if (a >= begin && a + 16 <= end) {
      x = __ldg(reinterpret_cast<const uint4*>(a));
    } else {  // the corpus's first or last partial 16 bytes
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (int e = 0; e < 16; ++e) {
        if (a + e >= begin && a + e < end)
          w[e >> 2] |= static_cast<uint32_t>(
                           __ldg(reinterpret_cast<const uint8_t*>(a + e)))
                       << (8 * (e & 3));
      }
      x = make_uint4(w[0], w[1], w[2], w[3]);
    }
    stage[v] = x;
  }
  return static_cast<int>(begin + lo - a_lo);
}

// The code of the cell whose first byte is staged at offset r, with
// `left` bytes before its row's end.
template <int kNW>
__device__ __forceinline__ uint32_t staged_code(const Params& P,
                                                const uint32_t* st, int r,
                                                int left) {
  const int a = r >> 2;
  const unsigned sh = 8u * static_cast<unsigned>(r & 3);
  uint32_t x[kNW + 1];
#pragma unroll
  for (int c = 0; c <= kNW; ++c) x[c] = st[a + c];
  uint32_t wd[kNW];
#pragma unroll
  for (int c = 0; c < kNW; ++c)
    wd[c] = row_masked(__funnelshift_r(x[c], x[c + 1], sh), left - 4 * c);
  return gram_code<kNW>(P.gram_b, wd);
}

// The code of cell g from device memory (the compaction's few hits).
template <int kNW>
__device__ __forceinline__ uint32_t cell_code(const Params& P, int g) {
  int left;
  const long long pos = cell_byte(P, g, &left);
  const int n = left < P.q ? left : P.q;
  uint32_t wd[kNW];
#pragma unroll
  for (int c = 0; c < kNW; ++c) wd[c] = 0u;
  for (int j = 0; j < n; ++j)
    wd[j >> 2] |= static_cast<uint32_t>(__ldg(P.chunks + pos + j))
                  << (8 * (j & 3));
  return gram_code<kNW>(P.gram_b, wd);
}

template <int kNW>
__global__ void __launch_bounds__(kThreads, 4)
    flat_take_grid_kernel(const __grid_constant__ Params P) {
  extern __shared__ uint4 stage[];
  __shared__ int warp_n[kWarps];
  __shared__ bool last;
  const uint32_t* st = reinterpret_cast<const uint32_t*>(stage);
  const bool long_on = __ldg(P.mll) > 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const int g0 = tile * P.tile;
    const int g_end = min(g0 + P.tile, P.n_grid);
    __syncthreads();  // the last tile's staged bytes read
    long long lo = 0;
    int base = 0;
    if (long_on && g0 < g_end) {
      int left;
      lo = cell_byte(P, g0, &left);
      const long long last_b = cell_byte(P, g_end - 1, &left);
      const long long hi = last_b + (left < P.q ? left : P.q);
      base = stage_tile(P, stage, lo, hi);
    }
    __syncthreads();

    int n = 0;
    for (int i0 = 0; i0 < P.tile; i0 += kStep) {
      uint32_t w[kBatch];
      uint32_t code[kBatch];
      bool in[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + i0 + u * kThreads + threadIdx.x;
        in[u] = g < g_end;
        code[u] = 0u;
        if (in[u] && long_on) {
          int left;
          const long long pos = cell_byte(P, g, &left);
          code[u] = staged_code<kNW>(P, st, static_cast<int>(pos - lo) + base,
                                     left);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        w[u] = in[u] && long_on ? probe(P, code[u], P.salts[0]) : 0u;
      for (int s = 1; s < P.k; ++s) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (w[u] != 0u) w[u] &= probe(P, code[u], P.salts[s]);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + i0 + u * kThreads + threadIdx.x;
        const uint32_t s =
            in[u] && P.sw != nullptr ? static_cast<uint32_t>(__ldg(P.sw + g))
                                     : 0u;
        const uint32_t hits = __ballot_sync(0xFFFFFFFFu, (w[u] | s) != 0u);
        if (lane == 0)
          P.mask[static_cast<long long>(g - lane) >> 5] = hits;
        n += __popc(hits);
      }
    }
    if (lane == 0) warp_n[warp] = n;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) total += warp_n[v];
      P.counts[tile] = total;
    }
  }

  // the last block to finish scans the tiles' counts into their offsets
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(P.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int per = (P.n_tiles + kThreads - 1) / kThreads;
  const int t0 = threadIdx.x * per;
  const int t1 = min(t0 + per, P.n_tiles);
  int sum = 0;
  for (int t = t0; t < t1; ++t) sum += __ldcg(P.counts + t);
  int x = sum;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_n[warp] = x;
  __syncthreads();
  int run = x - sum, total = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const int s = warp_n[v];
    run += v < warp ? s : 0;
    total += s;
  }
  for (int t = t0; t < t1; ++t) {
    P.offsets[t] = run;
    run += __ldcg(P.counts + t);
  }
  if (threadIdx.x == 0) *P.n_hits = total;
}

template <int kNW>
__global__ void __launch_bounds__(kThreads)
    flat_take_compact_kernel(const __grid_constant__ Params P) {
  __shared__ int warp_n[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool long_on = __ldg(P.mll) > 0;
  const int total = *P.n_hits;
  const int limit = total < P.capacity ? total : P.capacity;
  const int words_a_tile = P.tile / 32;

  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const int off = P.offsets[tile];
    if (P.counts[tile] == 0 || off >= limit) continue;  // the whole block
    const uint32_t* mask = P.mask + static_cast<long long>(tile) * words_a_tile;
    int carry = off;
    for (int j0 = 0; j0 < words_a_tile; j0 += kThreads) {
      const int j = j0 + threadIdx.x;
      uint32_t bits = j < words_a_tile ? mask[j] : 0u;
      const int n = __popc(bits);
      int x = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
        if (lane >= o) x += y;
      }
      __syncthreads();  // the last chunk's warp sums read
      if (lane == 31) warp_n[warp] = x;
      __syncthreads();
      int rank = carry + x - n, chunk = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const int s = warp_n[v];
        rank += v < warp ? s : 0;
        chunk += s;
      }
      carry += chunk;
      while (bits != 0u && rank < limit) {
        const int bit = __ffs(static_cast<int>(bits)) - 1;
        bits &= bits - 1u;
        const int g = tile * P.tile + 32 * j + bit;
        uint32_t w = 0u;
        if (long_on) {
          const uint32_t code = cell_code<kNW>(P, g);
          w = probe(P, code, P.salts[0]);
          for (int s = 1; s < P.k && w != 0u; ++s)
            w &= probe(P, code, P.salts[s]);
        }
        P.idx[rank] = g;
        P.lw[rank] = static_cast<int>(w);
        P.swo[rank] = P.sw != nullptr ? __ldg(P.sw + g) : 0;
        ++rank;
      }
      if (carry >= limit) break;  // uniform: carry is the block's
    }
  }
  for (long long i = static_cast<long long>(limit) + blockIdx.x * kThreads +
                     threadIdx.x;
       i < P.capacity; i += static_cast<long long>(gridDim.x) * kThreads) {
    P.idx[i] = kInt32Max;
    P.lw[i] = 0;
    P.swo[i] = 0;
  }
}

using KernelFn = void (*)(Params);

KernelFn pick_grid(int n_words) {
  switch (n_words) {
    case 1: return flat_take_grid_kernel<1>;
    case 2: return flat_take_grid_kernel<2>;
    case 3: return flat_take_grid_kernel<3>;
    default: return flat_take_grid_kernel<4>;
  }
}

KernelFn pick_compact(int n_words) {
  switch (n_words) {
    case 1: return flat_take_compact_kernel<1>;
    case 2: return flat_take_compact_kernel<2>;
    case 3: return flat_take_compact_kernel<3>;
    default: return flat_take_compact_kernel<4>;
  }
}

// Cells a tile at `stride`: at most kStageBudget bytes of corpus, a
// multiple of the cells one pass of the block takes.
int tile_cells(int stride) { return kStageBudget / stride / kStep * kStep; }

// Tiles, and scratch words: the hit mask, the counts and offsets, the
// block counter.
void layout(long long n_grid, int stride, long long* n_tiles,
            long long* words) {
  const long long tile = tile_cells(stride);
  *n_tiles = n_grid > 0 ? (n_grid + tile - 1) / tile : 1;
  *words = *n_tiles * (tile / 32) + 2 * *n_tiles + 1;
}

}  // namespace

// Words (int32) of scratch a launch over `n_grid` cells at `stride` takes.
extern "C" long long flat_take_extract_scratch_words(long long n_grid,
                                                     int stride) {
  if (stride < 1 || stride > kMaxStride || n_grid < 0) return -1;
  long long n_tiles, words;
  layout(n_grid, stride, &n_tiles, &words);
  return words;
}

// gram_b: kMaxWords x 4 weight bytes of GRAM_BASE (gram_weight_bytes).
extern "C" int flat_take_extract_launch(
    const void* chunks, long long rows, int row_len, const void* words,
    int log2_words, const void* salts, int k, const void* sw, const void* mll,
    const void* gram_b, int q, int stride, int capacity, void* scratch,
    void* n_hits, void* idx, void* lw, void* swo, void* stream) {
  const int M = row_len > 0 ? (row_len + stride - 1) / stride : 0;
  const long long n_grid = rows * M;
  if (k < 1 || k > kMaxSalts || q < 1 || q > 4 * kMaxWords || stride < 1 ||
      stride > kMaxStride || rows < 0 || row_len < 0 || log2_words < 5 ||
      log2_words > 31 || capacity < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long n_tiles, n_words;
  layout(n_grid, stride, &n_tiles, &n_words);
  const int tile = tile_cells(stride);
  if (n_tiles * tile >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P;
  memset(&P, 0, sizeof(P));
  P.chunks = static_cast<const uint8_t*>(chunks);
  P.n_bytes = rows * row_len;
  P.row_len = row_len;
  P.M = M > 0 ? M : 1;
  P.stride = stride;
  P.q = q;
  P.words = static_cast<const int*>(words);
  P.shift = 32 - log2_words;
  memcpy(P.salts, salts, sizeof(uint32_t) * k);
  P.k = k;
  P.sw = static_cast<const int*>(sw);
  P.mll = static_cast<const int*>(mll);
  memcpy(P.gram_b, gram_b, sizeof(P.gram_b));
  P.n_grid = static_cast<int>(n_grid);
  P.tile = tile;
  P.n_tiles = static_cast<int>(n_tiles);
  P.capacity = capacity;
  int* s = static_cast<int*>(scratch);
  P.mask = reinterpret_cast<uint32_t*>(s);
  P.counts = s + n_tiles * (tile / 32);
  P.offsets = P.counts + n_tiles;
  P.done = reinterpret_cast<unsigned int*>(P.offsets + n_tiles);
  P.n_hits = static_cast<int*>(n_hits);
  P.idx = static_cast<int*>(idx);
  P.lw = static_cast<int*>(lw);
  P.swo = static_cast<int*>(swo);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_words_q = (q - 1) / 4 + 1;
  const KernelFn grid = pick_grid(n_words_q);
  const KernelFn compact = pick_compact(n_words_q);
  long long c_items = (capacity + kThreads - 1) / kThreads;
  c_items = (c_items > n_tiles ? c_items : n_tiles) * kThreads;
  int blocks = 0, c_blocks = 0;
  cudaError_t err = grid_stride::blocks_for(
      reinterpret_cast<const void*>(grid), kThreads, kStageBytes,
      n_tiles * kThreads, &blocks);
  if (err == cudaSuccess) {
    err = grid_stride::blocks_for(reinterpret_cast<const void*>(compact),
                                  kThreads, 0, c_items, &c_blocks);
  }
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(P.done, 0, sizeof(unsigned int), st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  grid<<<blocks, kThreads, kStageBytes, st>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact<<<c_blocks, kThreads, 0, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}
