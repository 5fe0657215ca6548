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
// us at 3.35 TB/s).  But each row is one dependent chain of table loads,
// one per byte, and only as many chains run as there are rows (~124 per SM
// at 16384 rows), so the walk itself (~30 cycles per step) sits above the
// memory floor.  The design keeps that chain in shared memory and off
// device memory:
//
//   * the table (<= 4096 entries, widened to int32: <= 16 KiB) and the
//     256-entry byte -> class map are staged in shared memory once per
//     block; classifying through the map equals the reference's
//     compare-select, since byte_class[used_bytes[i]] == i + 1 and 0
//     elsewhere;
//   * one thread per row, 128 rows per block; the rows' bytes come through
//     shared memory in tiles of 128 rows x 64 bytes with coalesced 16-byte
//     loads (byte loads where L is not a multiple of 16);
//   * each thread walks its 64 bytes with one dependent shared-memory load
//     per byte and writes its states into a shared tile, which goes back to
//     device memory coalesced (a warp stores 32 neighbouring states).
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows (threads) per block
constexpr int kTile = 64;  // bytes per row per tile
constexpr int kByteStride = kTile / 4 + 1;  // words per staged byte row (odd:
// no bank conflicts between neighbouring rows)
constexpr int kStateStride = kTile + 1;  // words per staged state row
constexpr int kMaxEntries = 4096;

size_t smem_bytes(int n_entries) {
  return sizeof(int) * (static_cast<size_t>(n_entries) + 256 +
                        kRows * kByteStride + kRows * kStateStride);
}

__global__ void __launch_bounds__(kRows)
    scan_states_tile_kernel(const int* __restrict__ table, int n_entries,
                            const int* __restrict__ byte_class,
                            const uint8_t* __restrict__ chunks,
                            const int* __restrict__ init_state,
                            const int* __restrict__ lengths, int B, int L,
                            int n_classes, int vec16, int* __restrict__ states,
                            int* __restrict__ carry) {
  extern __shared__ int smem[];
  int* s_table = smem;
  int* s_class = s_table + n_entries;
  uint32_t* s_bytes = reinterpret_cast<uint32_t*>(s_class + 256);
  int* s_states = reinterpret_cast<int*>(s_bytes + kRows * kByteStride);

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  for (int i = tid; i < n_entries; i += kRows) s_table[i] = table[i];
  for (int i = tid; i < 256; i += kRows) s_class[i] = byte_class[i];

  const long long b = row0 + tid;
  const bool live = b < B;
  int s = live ? init_state[b] : 0;
  const int len = live ? (lengths ? min(lengths[b], L) : L) : 0;
  int c_out = s;  // carry: state after the last valid byte
  const int n_rows = min(kRows, B - static_cast<int>(row0));

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int w = min(kTile, L - t0);  // valid bytes of this tile
    __syncthreads();  // previous tile's states written back; tables staged
    if (vec16 && w == kTile) {
      // 4 threads per row, one 16-byte load each
      for (int i = tid; i < n_rows * 4; i += kRows) {
        const int r = i >> 2, q = i & 3;
        const uint4 v = *reinterpret_cast<const uint4*>(
            chunks + (row0 + r) * L + t0 + q * 16);
        uint32_t* dst = s_bytes + r * kByteStride + q * 4;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
      for (int i = tid; i < n_rows * (kTile / 4); i += kRows) {
        const int r = i / (kTile / 4), q = i % (kTile / 4);
        uint32_t word = 0;
        for (int k = 0; k < 4; ++k) {
          const int t = q * 4 + k;
          if (t < w)
            word |= static_cast<uint32_t>(chunks[(row0 + r) * L + t0 + t])
                    << (8 * k);
        }
        s_bytes[r * kByteStride + q] = word;
      }
    }
    __syncthreads();
    if (live) {
      const uint32_t* my = s_bytes + tid * kByteStride;
      int* out = s_states + tid * kStateStride;
      for (int q = 0; q < kTile / 4; ++q) {
        const uint32_t word = my[q];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = s_class[(word >> (8 * k)) & 0xFF];
          s = s_table[s * n_classes + c];
          out[q * 4 + k] = s;
        }
      }
      const int last = len - 1 - t0;
      if (last >= 0 && last < w) c_out = out[last];
    }
    __syncthreads();
    // coalesced write-back: a warp stores 32 neighbouring states of a row
    for (int i = tid; i < n_rows * kTile; i += kRows) {
      const int r = i / kTile, j = i % kTile;
      if (j < w) states[(row0 + r) * L + t0 + j] = s_states[r * kStateStride + j];
    }
  }
  if (live) carry[b] = c_out;
}

}  // namespace

extern "C" int scan_states_tile_launch(const int* table, int n_entries,
                                       const int* byte_class,
                                       const uint8_t* chunks,
                                       const int* init_state,
                                       const int* lengths, int B, int L,
                                       int n_classes, int* states, int* carry,
                                       void* stream) {
  if (n_entries < 1 || n_entries > kMaxEntries || B < 0 || L < 0 ||
      n_classes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = smem_bytes(n_entries);
  cudaError_t err = cudaFuncSetAttribute(
      scan_states_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec16 = (L % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(chunks) % 16 == 0);
  const int grid = (B + kRows - 1) / kRows;
  scan_states_tile_kernel<<<grid, kRows, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      table, n_entries, byte_class, chunks, init_state, lengths, B, L,
      n_classes, vec16, states, carry);
  return static_cast<int>(cudaGetLastError());
}
