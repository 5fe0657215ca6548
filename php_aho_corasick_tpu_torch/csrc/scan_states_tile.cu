// Tile-engine DFA scan for small automata: every row of the batch walks
// its bytes through a transition table that lives in shared memory.
//
// Replaces the TPU kernel `scan_states_tile` of the JAX package
// (php_aho_corasick_tpu/ops/scan_pallas.py, body `_kernel`).  Same
// contract: states[b, t] = table[states[b, t-1] * C + class(chunks[b, t])]
// from init_state[b], and carry[b] = states[b, lengths[b] - 1]
// (init_state[b] for an empty row; states[b, L-1] without lengths).  The
// TPU kernel's [n_blocks, L, 8, 128] timestep-major layout and its
// bank-select gather are devices of the TPU's lane gather; this card has a
// real gather from shared memory, so rows stay row-major.
//
// What bounds it on an H100: the bytes are read once and the int32 states
// written once (5 bytes per corpus byte, ~178 MB for a 32 MiB corpus, ~53
// us at 3.35 TB/s); the walk is ~5 integer and shared-memory operations a
// byte.  A row walked by one thread is one dependent chain of table loads
// (~30 cycles a byte), and 16,384 rows are too few chains to cover that
// latency, so the design cuts rows into many chains:
//
//   * segments: row b is cut into n_seg segments of seg_len bytes, one
//     chain (thread) each.  Segment 0 walks from init_state[b].  Segment
//     k >= 1 walks from state 0 over the `warm` bytes before it, writing
//     nothing, then over its own bytes.  This is exact for an Aho-Corasick
//     DFA whose patterns are at most `warm` bytes long: its state after any
//     text is the longest suffix of the text that is a trie node, so it
//     depends only on the last max_len bytes, whatever the start.  The
//     wrapper plans the segments and passes n_seg = 1 unless the caller
//     vouches for the table (`sync_len`);
//   * the table (<= 4096 entries, widened to int32: <= 16 KiB) and the
//     256-entry byte -> class map are staged in shared memory once per
//     resident block (a grid-stride loop over the chains,
//     grid_stride.cuh); classifying through the map equals the reference's
//     compare-select, since byte_class[used_bytes[i]] == i + 1 and 0
//     elsewhere;
//   * a thread reads its bytes 16 at a time straight into registers
//     (one 16-byte load where L % 16 == 0), the next 16 loaded before the
//     walk of these, so the load overlaps the walk;
//   * each warp stages its 32 chains' 16 states a step in its own shared
//     buffer (rows of 20 words: conflict-free 16-byte stores) and writes
//     them back itself, 64 contiguous bytes per chain, so the int32 states,
//     four fifths of the bytes, leave in whole sectors; no block-wide
//     barrier after the staging of the tables.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_stride.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps of 32 chains
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 16;  // bytes a chain walks between write-backs
constexpr int kBufStride = 20;  // words per chain row of a warp's buffer
constexpr int kMaxEntries = 4096;

// words of the staged table, rounded up so the warps' buffers that follow
// it stay 16-byte aligned
__host__ __device__ inline int table_words(int n_entries) {
  return (n_entries + 3) & ~3;
}

size_t smem_bytes(int n_entries) {
  return sizeof(int) * (static_cast<size_t>(table_words(n_entries)) + 256 +
                        kWarps * 32 * kBufStride);
}

struct Params {
  const int* table;
  int n_entries;
  const int* byte_class;
  const uint8_t* chunks;
  const int* init_state;
  const int* lengths;  // null: every row is L bytes
  long long n_chains;  // B * n_seg
  int L;
  int n_classes;
  int seg_len;  // bytes per segment; a multiple of kStep when n_seg > 1
  int n_seg;
  int warm;  // bytes walked from state 0 before a segment k >= 1
  int* states;
  int* carry;
};

// The 16 bytes of row `row` at [t, t + 16), zero past `end`.
template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* row, int t, int end) {
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(row + t));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kStep; ++j) {
    if (t + j < end)
      w[j >> 2] |= static_cast<uint32_t>(__ldg(row + t + j)) << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Walk the 4 bytes of `word` from state s; returns the 4 states.
__device__ __forceinline__ int4 walk4(const int* s_table,
                                      const int* s_class, int n_classes,
                                      uint32_t word, int& s) {
  int out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = s_class[(word >> (8 * k)) & 0xFFu];
    s = s_table[s * n_classes + c];
    out[k] = s;
  }
  return make_int4(out[0], out[1], out[2], out[3]);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
    scan_states_tile_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) int smem[];
  int* s_table = smem;
  int* s_class = s_table + table_words(P.n_entries);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* buf = s_class + 256 + warp * 32 * kBufStride;
  for (int i = threadIdx.x; i < P.n_entries; i += kThreads)
    s_table[i] = __ldg(P.table + i);
  for (int i = threadIdx.x; i < 256; i += kThreads)
    s_class[i] = __ldg(P.byte_class + i);
  __syncthreads();

  const int C = P.n_classes;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  // warp-uniform loop: every lane runs every iteration, so the warp's
  // write-back may synchronise it
  for (long long base =
           static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
       base < P.n_chains; base += step) {
    const long long chain = base + lane;
    const bool live = chain < P.n_chains;
    const long long b = live ? chain / P.n_seg : 0;
    const int k = live ? static_cast<int>(chain - b * P.n_seg) : 0;
    const int t0 = k * P.seg_len;
    const int t1 = live ? min(P.L, t0 + P.seg_len) : 0;
    const int len =
        live ? (P.lengths ? min(max(P.lengths[b], 0), P.L) : P.L) : 0;
    const int last = len - 1;  // the carry's byte; -1: an empty row
    const uint8_t* row = P.chunks + b * P.L;
    int* out_row = P.states + b * P.L;
    int s = 0;
    if (live && k == 0) {
      s = P.init_state[b];
      if (last < 0) P.carry[b] = s;
    }
    // warm-up of segments k >= 1 (t0 - warm >= 0 by the plan)
    if (live && k > 0) {
      for (int t = t0 - P.warm; t < t0; t += kStep) {
        const uint4 v = load16<kVec>(row, t, t0);
        const int n = min(kStep, t0 - t);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < kStep; ++j) {
          if (j < n) {
            const int c = s_class[(w[j >> 2] >> (8 * (j & 3))) & 0xFFu];
            s = s_table[s * C + c];
          }
        }
      }
    }
    int n_steps = live ? (t1 - t0 + kStep - 1) / kStep : 0;
    const int max_steps = __reduce_max_sync(0xFFFFFFFFu, n_steps);
    uint4 nxt = n_steps > 0 ? load16<kVec>(row, t0, t1) : make_uint4(0, 0, 0, 0);
    for (int i = 0; i < max_steps; ++i) {
      const int t = t0 + i * kStep;
      const bool mine = i < n_steps;
      if (mine) {
        const uint4 v = nxt;
        if (i + 1 < n_steps) nxt = load16<kVec>(row, t + kStep, t1);
        int4* dst = reinterpret_cast<int4*>(buf + lane * kBufStride);
        dst[0] = walk4(s_table, s_class, C, v.x, s);
        dst[1] = walk4(s_table, s_class, C, v.y, s);
        dst[2] = walk4(s_table, s_class, C, v.z, s);
        dst[3] = walk4(s_table, s_class, C, v.w, s);
        if (last >= t && last < t + kStep && last < t1)
          P.carry[b] = buf[lane * kBufStride + (last - t)];
      }
      __syncwarp();
      // write-back: each chain's states of this step go to out_row + t
      const long long dst_off =
          mine ? (out_row - P.states) + t : -1;  // -1: nothing this step
      const int n_valid = mine ? min(kStep, t1 - t) : 0;
      if (kVec) {
        // 8 chains a pass, 4 lanes of 16 bytes each
#pragma unroll
        for (int pass = 0; pass < 4; ++pass) {
          const int src = pass * 8 + (lane >> 2), q = lane & 3;
          const long long o = __shfl_sync(0xFFFFFFFFu, dst_off, src);
          if (o >= 0) {
            const int4 val = *reinterpret_cast<const int4*>(
                buf + src * kBufStride + 4 * q);
            *reinterpret_cast<int4*>(P.states + o + 4 * q) = val;
          }
        }
      } else {
        // 2 chains a pass, 16 lanes of 4 bytes each
        for (int pass = 0; pass < 16; ++pass) {
          const int src = pass * 2 + (lane >> 4), j = lane & 15;
          const long long o = __shfl_sync(0xFFFFFFFFu, dst_off, src);
          const int nv = __shfl_sync(0xFFFFFFFFu, n_valid, src);
          if (o >= 0 && j < nv) P.states[o + j] = buf[src * kBufStride + j];
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int scan_states_tile_launch(const int* table, int n_entries,
                                       const int* byte_class,
                                       const uint8_t* chunks,
                                       const int* init_state,
                                       const int* lengths, int B, int L,
                                       int n_classes, int seg_len, int n_seg,
                                       int warm, int* states, int* carry,
                                       void* stream) {
  if (n_entries < 1 || n_entries > kMaxEntries || B < 0 || L < 0 ||
      n_classes < 1 || n_seg < 1 || warm < 0 || seg_len < 0 ||
      static_cast<long long>(seg_len) * n_seg < L ||
      (n_seg > 1 && (seg_len % kStep || warm % kStep || warm > seg_len)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  Params P;
  P.table = table;
  P.n_entries = n_entries;
  P.byte_class = byte_class;
  P.chunks = chunks;
  P.init_state = init_state;
  P.lengths = lengths;
  P.n_chains = static_cast<long long>(B) * n_seg;
  P.L = L;
  P.n_classes = n_classes;
  P.seg_len = seg_len;
  P.n_seg = n_seg;
  P.warm = warm;
  P.states = states;
  P.carry = carry;
  // 16-byte loads and stores need every step to start 16-byte aligned
  const bool vec = L % kStep == 0 &&
                   reinterpret_cast<uintptr_t>(chunks) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(states) % 16 == 0;
  auto kernel = vec ? scan_states_tile_kernel<true>
                    : scan_states_tile_kernel<false>;
  int blocks = 0;
  const cudaError_t err = grid_stride::blocks_for(
      reinterpret_cast<const void*>(kernel), kThreads,
      smem_bytes(kMaxEntries), P.n_chains, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem_bytes(n_entries),
           static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// Grid, block and resident blocks per SM of the launch at these arguments
// (for reports; launches nothing).
extern "C" int scan_states_tile_shape(int n_entries, long long n_chains,
                                      int vec, int* grid, int* block,
                                      int* per_sm) {
  auto kernel = vec ? scan_states_tile_kernel<true>
                    : scan_states_tile_kernel<false>;
  cudaError_t err = grid_stride::blocks_for(
      reinterpret_cast<const void*>(kernel), kThreads,
      smem_bytes(kMaxEntries), n_chains, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  *block = kThreads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, kThreads, smem_bytes(n_entries));
  return static_cast<int>(err);
}
