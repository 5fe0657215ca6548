// Records verify of the sampled cascade: for every hit slot of the filter,
// the exact DFA walk over its candidate window and the window's match
// records, then the records of all slots compacted in slot-major order,
// in one launch.
//
// Its reference is XLA code, not a Pallas kernel: verify_windows_records
// and verify_windows_records2 of php_aho_corasick_tpu/ops/filter_jax.py,
// with their compaction (jnp.nonzero over the [KR+1, H] record flags).
// The semantics are those of the plain version _verify_records_torch
// (ops/filter_torch.py), bit for bit:
//
//   slot h < H, g = grid_idx[h] (INT32_MAX: an empty slot, no records):
//     b = g / M, w0 = (g % M) * stride - (stride - 1), M = ceil(L / stride);
//     position j < W of the window is byte b * L + w0 + j (clamped to the
//     corpus); one outside [0, lengths[b]) or of an empty slot takes
//     class 0; a byte's class is byte_class[byte] (which the automaton
//     builds from used_bytes: byte used[i] is class i + 1, the others 0,
//     so both class routes of the plain version give it);
//     step 1: state = table[state * C + class], from state 0;
//     step 2: e = table2[state * C*C + c_j * C + c_j+1] = s2 | s1 << 15,
//     s1 the state at j and s2 at j + 1 (the dead half-step past W takes
//     class 0 and never emits);
//     a state >= final_start at an in-row position j with w0 + j >=
//     emit_from[b] is a record state * 32 + j: the first KR = 4 of them
//     fill record slots 0..3, and slot 4 holds the REC_OVERFLOW_J = 31
//     sentinel when there were more;
//   record (k, h) is live while cnt[h] > k.  The live records in the order
//   k * H + h, the first `capacity` of them, are (grid_idx[h], pack), with
//   (INT32_MAX, 0) after them; n_rec counts them all.
//
// The torch loop this replaces issued ~820 small launches a chain (a few
// dozen a window position, then the compaction's), and on the card the
// chain followed the host's enqueue of them.  Here the whole verify is one
// launch (and the zeroing of its 4-byte block counter).
//
// What bounds it on an H100: not bytes (a few KB of hit slots and windows;
// the table stays in the 50 MB L2: 0.4 MB dense, 5 MB 2-step for 2048
// needles of 16 bytes) and not operations, but each slot's walk: W
// dependent gathers of the table (W / 2 with the 2-step table), each an L2
// round trip.  So every slot gets a thread, the window's bytes are loaded
// and classified (through a 256-entry class table in shared memory)
// before the walk, all independent of it, the walk stops after the last
// position that could emit, and the state, the record count and the
// record slots stay in registers.
//
// Compaction: each block ranks its live records per slot k (warp ballots)
// and stages them densely in scratch memory with its counts; the last
// block to finish (a counter taken after a memory fence) scans the counts
// in (k, block) order, copies each (k, block) run to its offset, up to
// `capacity`, pads the rest and writes n_rec.  Blocks are never waited on,
// so any number of them may run.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the caller gives verify_records_scratch_words(H) words of
// scratch), does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWin = 31;           // REC_OVERFLOW_J is reserved
constexpr int kSlots = 4;             // VERIFY_KR
constexpr int kRecords = kSlots + 1;  // and the overflow sentinel
constexpr int kOverflowJ = 31;        // REC_OVERFLOW_J
constexpr int kRec2Bits = 15;         // REC2_BITS
constexpr int kInt32Max = 0x7FFFFFFF;

struct Params {
  const void* table;      // dense [S * C] (int16 or int32) or 2-step [S*C*C]
  const int* byte_class;  // [256]
  const uint8_t* chunks;  // [rows, row_len]
  long long n_bytes;      // rows * row_len
  int row_len;
  int cells;  // grid cells a row, ceil(row_len / stride)
  const int* lengths;
  const int* emit_from;
  const int* grid_idx;
  const int* final_start;
  int n_classes;
  int stride;
  int win_len;
  int h;  // hit slots
  int capacity;
  int2* stage;          // [kRecords * blocks * kThreads] (cell, pack)
  int* counts;          // [kRecords * blocks] live records, (k, block) order
  int* offsets;         // [kRecords * blocks]
  unsigned int* done;   // blocks finished; zero at the launch
  int* rec_cell;        // [capacity]
  int* rec_pack;        // [capacity]
  int* n_rec;           // scalar
};

__device__ __forceinline__ void record(int& cnt, int (&slot)[kSlots],
                                       int pack) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    if (cnt == k) slot[k] = pack;
  ++cnt;
}

// The walk of the window of slot `cell`: its record count and slots.
template <typename T, int kStep>
__device__ __forceinline__ void walk(const Params& p, const int* cls_of,
                                     int cell, int& cnt,
                                     int (&slot)[kSlots]) {
  if (cell == kInt32Max) return;  // an empty slot emits nothing
  const int b = cell / p.cells;
  const int w0 = (cell % p.cells) * p.stride - (p.stride - 1);
  const int row_end = __ldg(p.lengths + b);
  const int row_emit = __ldg(p.emit_from + b);
  const long long base = static_cast<long long>(b) * p.row_len + w0;
  int cls[kMaxWin];
  unsigned emit = 0u;  // bit j: position j lies in its row, at or after
                       // the row's emit_from
#pragma unroll
  for (int j = 0; j < kMaxWin; ++j) {
    const int pos = w0 + j;
    int c = 0;
    if (j < p.win_len && pos >= 0 && pos < row_end) {
      long long at = base + j;
      at = at < 0 ? 0 : (at >= p.n_bytes ? p.n_bytes - 1 : at);
      c = cls_of[__ldg(p.chunks + at)];
      if (pos >= row_emit) emit |= 1u << j;
    }
    cls[j] = c;
  }
  const int fs = __ldg(p.final_start);
  const T* table = static_cast<const T*>(p.table);
  int state = 0;
  if (kStep == 1) {
#pragma unroll
    for (int j = 0; j < kMaxWin; ++j) {
      if ((emit >> j) == 0u) break;  // no record past the last emitting j
      if (j < p.win_len) {
        state = static_cast<int>(__ldg(
            table + static_cast<long long>(state) * p.n_classes + cls[j]));
        if (((emit >> j) & 1u) && state >= fs)
          record(cnt, slot, state * 32 + j);
      }
    }
  } else {
    const long long c2 = static_cast<long long>(p.n_classes) * p.n_classes;
#pragma unroll
    for (int j = 0; j < kMaxWin; j += 2) {
      if ((emit >> j) == 0u) break;
      if (j < p.win_len) {
        const int cb = j + 1 < kMaxWin ? cls[j + 1] : 0;  // 0 past W
        const int e = static_cast<int>(__ldg(
            table + static_cast<long long>(state) * c2 +
            static_cast<long long>(cls[j]) * p.n_classes + cb));
        const int s1 = e >> kRec2Bits;
        const int s2 = e & ((1 << kRec2Bits) - 1);
        if (((emit >> j) & 1u) && s1 >= fs) record(cnt, slot, s1 * 32 + j);
        if (j + 1 < p.win_len && ((emit >> (j + 1)) & 1u) && s2 >= fs)
          record(cnt, slot, s2 * 32 + j + 1);
        state = s2;
      }
    }
  }
}

template <typename T, int kStep>
__global__ void __launch_bounds__(kThreads)
    verify_records_kernel(const Params p) {
  __shared__ int cls_of[256];
  __shared__ int warp_n[kRecords][kWarps];
  __shared__ int carry;
  __shared__ bool last;
  for (int t = threadIdx.x; t < 256; t += kThreads)
    cls_of[t] = __ldg(p.byte_class + t);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long blocks = gridDim.x;
  const int h = blockIdx.x * kThreads + threadIdx.x;
  int cnt = 0;
  int slot[kSlots] = {0, 0, 0, 0};
  int cell = kInt32Max;
  if (h < p.h) {
    cell = __ldg(p.grid_idx + h);
    walk<T, kStep>(p, cls_of, cell, cnt, slot);
  }

  // stage this block's live records of each slot k, densely, in h order
  unsigned live[kRecords];
#pragma unroll
  for (int k = 0; k < kRecords; ++k) {
    live[k] = __ballot_sync(0xFFFFFFFFu, cnt > k);
    if (lane == 0) warp_n[k][warp] = __popc(live[k]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRecords; ++k) {
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = warp_n[k][w];
      before += w < warp ? n : 0;
      total += n;
    }
    const long long run = k * blocks + blockIdx.x;
    if (cnt > k) {
      const int r = before + __popc(live[k] & ((1u << lane) - 1u));
      p.stage[run * kThreads + r] =
          make_int2(cell, k < kSlots ? slot[k] : kOverflowJ);
    }
    if (threadIdx.x == 0) p.counts[run] = total;
  }

  // the last block to finish compacts every block's runs
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  const long long runs = kRecords * blocks;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long first = 0; first < runs; first += kThreads) {
    const long long i = first + threadIdx.x;
    const int n = i < runs ? __ldcg(p.counts + i) : 0;
    int x = n;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_n[0][warp] = x;
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = warp_n[0][w];
      before += w < warp ? s : 0;
      chunk += s;
    }
    if (i < runs) p.offsets[i] = carry + before + x - n;
    __syncthreads();
    if (threadIdx.x == 0) carry += chunk;
    __syncthreads();
  }
  const int total = carry;
  if (threadIdx.x == 0) *p.n_rec = total;
  // a warp a run: its records to [offset, offset + n), cut at capacity
  for (long long i = warp; i < runs; i += kWarps) {
    const int off = __ldcg(p.offsets + i);
    if (off >= p.capacity) continue;
    const int n = __ldcg(p.counts + i);
    const int2* src = p.stage + i * kThreads;
    for (int r = lane; r < n && off + r < p.capacity; r += 32) {
      const int2 e = __ldcg(src + r);
      p.rec_cell[off + r] = e.x;
      p.rec_pack[off + r] = e.y;
    }
  }
  for (long long i = static_cast<long long>(total) + threadIdx.x;
       i < p.capacity; i += kThreads) {
    p.rec_cell[i] = kInt32Max;
    p.rec_pack[i] = 0;
  }
}

long long blocks_for(long long h) { return (h + kThreads - 1) / kThreads; }

}  // namespace

// Words (int32) of scratch a launch over `h` hit slots takes.
extern "C" long long verify_records_scratch_words(long long h) {
  const long long blocks = blocks_for(h);
  return 2LL * kRecords * blocks * kThreads + 2LL * kRecords * blocks + 1;
}

extern "C" int verify_records_launch(
    const void* table, int entry_bytes, int step, const void* byte_class,
    const void* chunks,
    long long rows, int row_len, const void* lengths, const void* emit_from,
    const void* grid_idx, const void* final_start, int n_classes, int stride,
    int win_len, int h, int capacity, void* scratch, void* rec_cell,
    void* rec_pack, void* n_rec, void* stream) {
  const bool table_ok = (entry_bytes == 2 && step == 1) ||
                        (entry_bytes == 4 && (step == 1 || step == 2));
  if (!table_ok || h < 1 || capacity < 1 || win_len < 1 ||
      win_len > kMaxWin || stride < 1 || n_classes < 1 || rows < 1 ||
      row_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = blocks_for(h);
  int* s = static_cast<int*>(scratch);
  Params p;
  p.table = table;
  p.byte_class = static_cast<const int*>(byte_class);
  p.chunks = static_cast<const uint8_t*>(chunks);
  p.n_bytes = rows * row_len;
  p.row_len = row_len;
  p.cells = (row_len + stride - 1) / stride;
  p.lengths = static_cast<const int*>(lengths);
  p.emit_from = static_cast<const int*>(emit_from);
  p.grid_idx = static_cast<const int*>(grid_idx);
  p.final_start = static_cast<const int*>(final_start);
  p.n_classes = n_classes;
  p.stride = stride;
  p.win_len = win_len;
  p.h = h;
  p.capacity = capacity;
  p.stage = reinterpret_cast<int2*>(s);
  p.counts = s + 2LL * kRecords * blocks * kThreads;
  p.offsets = p.counts + kRecords * blocks;
  p.done = reinterpret_cast<unsigned int*>(p.offsets + kRecords * blocks);
  p.rec_cell = static_cast<int*>(rec_cell);
  p.rec_pack = static_cast<int*>(rec_pack);
  p.n_rec = static_cast<int*>(n_rec);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(p.done, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(blocks));
  if (entry_bytes == 2) {
    verify_records_kernel<int16_t, 1><<<grid, kThreads, 0, st>>>(p);
  } else if (step == 1) {
    verify_records_kernel<int, 1><<<grid, kThreads, 0, st>>>(p);
  } else {
    verify_records_kernel<int, 2><<<grid, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
