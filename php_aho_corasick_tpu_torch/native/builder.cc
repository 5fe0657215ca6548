// Native automaton builder — the fast-path equivalent of
// core/trie.py + core/automaton.py for million-pattern (signature-scale)
// workloads, where the Python trie loop dominates build time.
//
// Produces BIT-IDENTICAL tables to the Python builder (same node ids =
// creation order, same level-order failure computation, same
// final-states-last renumbering, same CSR emit order own-pattern-first) so
// the two can be fuzz-checked against each other.
//
// Capability analog of the reference's MultiFast build path
// (ac_trie_add, src/multifast/ahocorasick.c:91-131; ac_trie_finalize,
// ahocorasick.c:143-155) — but compiles the goto/fail closure into a dense
// byte-class table instead of keeping a pointer trie.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this
// environment).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <queue>
#include <vector>

namespace {
// build-stage wall timer, enabled by AHO_NATIVE_TIMING=1 (perf probing)
struct StageTimer {
  bool on;
  struct timespec last;
  StageTimer() : on(getenv("AHO_NATIVE_TIMING") != nullptr) {
    clock_gettime(CLOCK_MONOTONIC, &last);
  }
  void mark(const char* name) {
    if (!on) return;
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    double dt = (now.tv_sec - last.tv_sec) + 1e-9 * (now.tv_nsec - last.tv_nsec);
    fprintf(stderr, "[aho_native] %-24s %.3fs\n", name, dt);
    last = now;
  }
};
}  // namespace

namespace {

struct Node {
  // trie edges; linear scan is fine (small per-node fan-out, and the
  // builder is I/O-bound on pattern bytes at scale)
  std::vector<std::pair<uint8_t, int32_t>> edges;
  int32_t own = -1;   // accepted pattern id ending exactly here
  int32_t depth = 0;
  int32_t fail = 0;
};

struct Builder {
  std::vector<Node> nodes;
  std::vector<int32_t> pat_lens;
  int max_pattern_length = 1024;
  bool closed = false;
  int max_len = 0;

  // set by compile():
  int n_classes = 0;
  int32_t byte_class[256];
  std::vector<int32_t> table;       // [S * C], renumbered
  std::vector<int64_t> emit_start;  // [S + 1]
  std::vector<int32_t> emit_pats;
  std::vector<int32_t> state_depth; // [S], renumbered
  int64_t final_start = 0;

  // set by compile_compressed() (core/tables.CompressedAutomaton layout):
  std::vector<int32_t> comp_dense;  // [D * C] dense-bank rows, renumbered
  std::vector<int32_t> comp_meta;   // [S - D] skip * 512 + exc_class + 1
  std::vector<int32_t> comp_tgt;    // [S - D]
  int64_t comp_n_dense = 0;
  int64_t comp_dense_final_start = 0;

  Builder() { nodes.emplace_back(); }

  int32_t find_edge(const Node& n, uint8_t b) const {
    for (const auto& e : n.edges)
      if (e.first == b) return e.second;
    return -1;
  }
};

enum AddStatus : int {
  kSuccess = 0,
  kDuplicate = 1,
  kLong = 2,
  kZero = 3,
  kClosed = 4,
};

}  // namespace

extern "C" {

Builder* aho_builder_new(int max_pattern_length) {
  Builder* b = new Builder();
  b->max_pattern_length = max_pattern_length;
  return b;
}

void aho_builder_free(Builder* b) { delete b; }

int aho_builder_add(Builder* b, const uint8_t* pat, int64_t len) {
  if (b->closed) return kClosed;
  if (len == 0) return kZero;
  if (len > b->max_pattern_length) return kLong;
  int32_t s = 0;
  for (int64_t i = 0; i < len; ++i) {
    int32_t nxt = b->find_edge(b->nodes[s], pat[i]);
    if (nxt < 0) {
      nxt = static_cast<int32_t>(b->nodes.size());
      b->nodes[s].edges.emplace_back(pat[i], nxt);
      Node n;
      n.depth = b->nodes[s].depth + 1;
      b->nodes.push_back(std::move(n));
    }
    s = nxt;
  }
  if (b->nodes[s].own >= 0) return kDuplicate;
  b->nodes[s].own = static_cast<int32_t>(b->pat_lens.size());
  b->pat_lens.push_back(static_cast<int32_t>(len));
  if (len > b->max_len) b->max_len = static_cast<int>(len);
  return kSuccess;
}

// Compile trie -> dense classed table + CSR emit, final states renumbered
// last.  Returns 0 on success.
int aho_builder_compile(Builder* b) {
  b->closed = true;
  const int64_t S = static_cast<int64_t>(b->nodes.size());

  // byte classes: 0 = unused-by-any-pattern (always -> root)
  bool used[256] = {false};
  for (const auto& n : b->nodes)
    for (const auto& e : n.edges) used[e.first] = true;
  int c = 1;
  for (int i = 0; i < 256; ++i) b->byte_class[i] = used[i] ? c++ : 0;
  const int C = c;
  b->n_classes = C;

  // group states by depth, ids ascending (matches the numpy level order)
  int max_depth = 0;
  for (const auto& n : b->nodes)
    if (n.depth > max_depth) max_depth = n.depth;
  std::vector<std::vector<int32_t>> by_level(max_depth + 1);
  for (int64_t s = 0; s < S; ++s)
    by_level[b->nodes[s].depth].push_back(static_cast<int32_t>(s));

  // level-order closure: table rows + failure links (see automaton.py for
  // the identities; rows referenced are always from shallower levels)
  std::vector<int32_t> table(static_cast<size_t>(S) * C, 0);
  for (int d = 0; d <= max_depth; ++d) {
    for (int32_t s : by_level[d]) {
      Node& n = b->nodes[s];
      int32_t* row = &table[static_cast<size_t>(s) * C];
      if (d > 0)
        std::memcpy(row, &table[static_cast<size_t>(n.fail) * C],
                    sizeof(int32_t) * C);
      for (const auto& e : n.edges) row[b->byte_class[e.first]] = e.second;
    }
    for (int32_t s : by_level[d]) {
      const Node& n = b->nodes[s];
      for (const auto& e : n.edges) {
        if (d == 0)
          b->nodes[e.second].fail = 0;
        else
          b->nodes[e.second].fail =
              table[static_cast<size_t>(n.fail) * C + b->byte_class[e.first]];
      }
    }
  }

  // match counts along failure chains (chain is strictly decreasing depth,
  // already complete when a node is reached in level order)
  std::vector<int64_t> counts(S, 0);
  for (int d = 1; d <= max_depth; ++d)
    for (int32_t s : by_level[d])
      counts[s] = (b->nodes[s].own >= 0 ? 1 : 0) + counts[b->nodes[s].fail];

  // renumber: non-final first (old-id ascending), finals last
  std::vector<int32_t> perm(S), inv(S);
  int64_t next_id = 0;
  for (int64_t s = 0; s < S; ++s)
    if (counts[s] == 0) perm[s] = static_cast<int32_t>(next_id++);
  b->final_start = next_id;
  for (int64_t s = 0; s < S; ++s)
    if (counts[s] > 0) perm[s] = static_cast<int32_t>(next_id++);
  for (int64_t s = 0; s < S; ++s) inv[perm[s]] = static_cast<int32_t>(s);

  b->table.resize(static_cast<size_t>(S) * C);
#pragma omp parallel for schedule(static)
  for (int64_t ns = 0; ns < S; ++ns) {
    const int32_t* src = &table[static_cast<size_t>(inv[ns]) * C];
    int32_t* dst = &b->table[static_cast<size_t>(ns) * C];
    for (int j = 0; j < C; ++j) dst[j] = perm[src[j]];
  }

  b->state_depth.resize(S);
  for (int64_t ns = 0; ns < S; ++ns)
    b->state_depth[ns] = b->nodes[inv[ns]].depth;

  // CSR emit: own pattern first, then failure chain (decreasing length)
  b->emit_start.assign(S + 1, 0);
  for (int64_t ns = 0; ns < S; ++ns)
    b->emit_start[ns + 1] = b->emit_start[ns] + counts[inv[ns]];
  b->emit_pats.resize(b->emit_start[S]);
#pragma omp parallel for schedule(static)
  for (int64_t ns = 0; ns < S; ++ns) {
    int64_t w = b->emit_start[ns];
    for (int32_t s = inv[ns]; ; s = b->nodes[s].fail) {
      if (b->nodes[s].own >= 0) b->emit_pats[w++] = b->nodes[s].own;
      if (s == 0) break;
    }
  }
  return 0;
}

// Compile trie -> compressed (dense bank + single-exception sparse rows)
// automaton — the signature-scale format (see core/tables.py
// CompressedAutomaton and core/automaton.py compile_trie_compressed, to
// which this is bit-identical).  Never materializes the dense [S, C]
// table: each state is either a bank row or one (class -> target)
// exception over its nearest dense failure ancestor's row.
static constexpr int32_t kExcPack = 512;  // tables.EXC_PACK

int aho_builder_compile_compressed(Builder* b) {
  StageTimer t;
  b->closed = true;
  const int64_t S = static_cast<int64_t>(b->nodes.size());

  bool used[256] = {false};
  for (const auto& n : b->nodes)
    for (const auto& e : n.edges) used[e.first] = true;
  int c = 1;
  for (int i = 0; i < 256; ++i) b->byte_class[i] = used[i] ? c++ : 0;
  const int C = c;
  b->n_classes = C;

  int max_depth = 0;
  for (const auto& n : b->nodes)
    if (n.depth > max_depth) max_depth = n.depth;
  std::vector<std::vector<int32_t>> by_level(max_depth + 1);
  for (int64_t s = 0; s < S; ++s)
    by_level[b->nodes[s].depth].push_back(static_cast<int32_t>(s));
  t.mark("classes+levels");

  std::vector<int64_t> counts(S, 0);
  std::vector<uint8_t> is_dense(S, 0);
  std::vector<int32_t> exc_cls(S, -1), exc_tgt(S, 0), skip(S, 0);
  std::vector<int64_t> dense_slot(S, -1);
  std::vector<int32_t> bank;  // [n_bank * C]
  int64_t n_bank = 0;

  auto delta = [&](int32_t u, int32_t cl) -> int32_t {
    if (is_dense[u]) return bank[dense_slot[u] * C + cl];
    if (cl == exc_cls[u]) return exc_tgt[u];
    return bank[dense_slot[skip[u]] * C + cl];
  };

  // root: always dense
  {
    bank.assign(C, 0);
    for (const auto& e : b->nodes[0].edges)
      bank[b->byte_class[e.first]] = e.second;
    is_dense[0] = 1;
    dense_slot[0] = 0;
    n_bank = 1;
    for (const auto& e : b->nodes[0].edges) b->nodes[e.second].fail = 0;
  }

  for (int d = 1; d <= max_depth; ++d) {
    for (int32_t s : by_level[d]) {
      Node& n = b->nodes[s];
      const int32_t f = n.fail;
      counts[s] = (n.own >= 0 ? 1 : 0) + counts[f];

      const int64_t n_own = static_cast<int64_t>(n.edges.size());
      const int32_t inh_cls = is_dense[f] ? -1 : exc_cls[f];
      const int32_t inh_tgt = exc_tgt[f];
      const int32_t base_skip = is_dense[f] ? f : skip[f];
      bool shadow = false;
      if (n_own == 1 && inh_cls >= 0 &&
          b->byte_class[n.edges[0].first] == inh_cls)
        shadow = true;
      const int64_t n_exc = n_own + ((inh_cls >= 0 && !shadow) ? 1 : 0);

      if (n_exc <= 1) {  // sparse
        if (n_own == 1) {
          exc_cls[s] = b->byte_class[n.edges[0].first];
          exc_tgt[s] = n.edges[0].second;
        } else if (inh_cls >= 0) {
          exc_cls[s] = inh_cls;
          exc_tgt[s] = inh_tgt;
        }
        skip[s] = base_skip;
      } else {  // promote to dense
        const size_t off = bank.size();
        bank.resize(off + C);
        std::memcpy(&bank[off], &bank[dense_slot[base_skip] * C],
                    sizeof(int32_t) * C);
        if (inh_cls >= 0) bank[off + inh_cls] = inh_tgt;
        for (const auto& e : n.edges)
          bank[off + b->byte_class[e.first]] = e.second;
        is_dense[s] = 1;
        dense_slot[s] = n_bank++;
      }
    }
    const int64_t ln = static_cast<int64_t>(by_level[d].size());
#pragma omp parallel for schedule(static)
    for (int64_t li = 0; li < ln; ++li) {
      const int32_t s = by_level[d][li];
      for (const auto& e : b->nodes[s].edges)
        b->nodes[e.second].fail =
            delta(b->nodes[s].fail, b->byte_class[e.first]);
    }
  }

  t.mark("closure");
  if (n_bank >= (int64_t{1} << 31) / kExcPack) return 1;  // meta overflow

  // renumber [dense nonfinal][dense final][sparse nonfinal][sparse final]
  std::vector<int32_t> perm(S), new_order(S);
  int64_t next_id = 0;
  for (int pass = 0; pass < 4; ++pass) {
    const bool want_dense = pass < 2;
    const bool want_final = (pass % 2) == 1;
    for (int64_t s = 0; s < S; ++s)
      if ((is_dense[s] != 0) == want_dense &&
          (counts[s] > 0) == want_final) {
        perm[s] = static_cast<int32_t>(next_id);
        new_order[next_id++] = static_cast<int32_t>(s);
      }
    if (pass == 0) b->comp_dense_final_start = next_id;
    if (pass == 1) b->comp_n_dense = next_id;
    if (pass == 2) b->final_start = next_id;
  }
  const int64_t D = b->comp_n_dense;
  t.mark("renumber");

  b->comp_dense.resize(D * C);
#pragma omp parallel for schedule(static)
  for (int64_t ns = 0; ns < D; ++ns) {
    const int32_t* src = &bank[dense_slot[new_order[ns]] * C];
    int32_t* dst = &b->comp_dense[ns * C];
    for (int j = 0; j < C; ++j) dst[j] = perm[src[j]];
  }
  b->comp_meta.resize(S - D);
  b->comp_tgt.resize(S - D);
#pragma omp parallel for schedule(static)
  for (int64_t ns = D; ns < S; ++ns) {
    const int32_t s = new_order[ns];
    b->comp_meta[ns - D] = perm[skip[s]] * kExcPack + exc_cls[s] + 1;
    b->comp_tgt[ns - D] = exc_cls[s] >= 0 ? perm[exc_tgt[s]] : 0;
  }

  t.mark("export-tables");
  b->state_depth.resize(S);
  for (int64_t ns = 0; ns < S; ++ns)
    b->state_depth[ns] = b->nodes[new_order[ns]].depth;

  b->emit_start.assign(S + 1, 0);
  for (int64_t ns = 0; ns < S; ++ns)
    b->emit_start[ns + 1] = b->emit_start[ns] + counts[new_order[ns]];
  b->emit_pats.resize(b->emit_start[S]);
#pragma omp parallel for schedule(static)
  for (int64_t ns = 0; ns < S; ++ns) {
    int64_t w = b->emit_start[ns];
    for (int32_t s = new_order[ns]; ; s = b->nodes[s].fail) {
      if (b->nodes[s].own >= 0) b->emit_pats[w++] = b->nodes[s].own;
      if (s == 0) break;
    }
  }
  t.mark("emit-csr");
  return 0;
}

int64_t aho_comp_n_dense(const Builder* b) { return b->comp_n_dense; }
int64_t aho_comp_dense_final_start(const Builder* b) {
  return b->comp_dense_final_start;
}

void aho_export_compressed(const Builder* b, int32_t* dense_table,
                           int32_t* meta, int32_t* exc_target,
                           int32_t* byte_class, int64_t* emit_start,
                           int32_t* emit_pats, int32_t* pat_lens,
                           int32_t* state_depth) {
  std::memcpy(dense_table, b->comp_dense.data(),
              b->comp_dense.size() * sizeof(int32_t));
  if (!b->comp_meta.empty()) {
    std::memcpy(meta, b->comp_meta.data(),
                b->comp_meta.size() * sizeof(int32_t));
    std::memcpy(exc_target, b->comp_tgt.data(),
                b->comp_tgt.size() * sizeof(int32_t));
  }
  std::memcpy(byte_class, b->byte_class, sizeof(b->byte_class));
  std::memcpy(emit_start, b->emit_start.data(),
              b->emit_start.size() * sizeof(int64_t));
  if (!b->emit_pats.empty())
    std::memcpy(emit_pats, b->emit_pats.data(),
                b->emit_pats.size() * sizeof(int32_t));
  if (!b->pat_lens.empty())
    std::memcpy(pat_lens, b->pat_lens.data(),
                b->pat_lens.size() * sizeof(int32_t));
  std::memcpy(state_depth, b->state_depth.data(),
              b->state_depth.size() * sizeof(int32_t));
}

int64_t aho_n_states(const Builder* b) {
  return static_cast<int64_t>(b->nodes.size());
}
int aho_n_classes(const Builder* b) { return b->n_classes; }
int64_t aho_emit_size(const Builder* b) {
  return static_cast<int64_t>(b->emit_pats.size());
}
int64_t aho_final_start(const Builder* b) { return b->final_start; }
int aho_max_len(const Builder* b) { return b->max_len; }
int64_t aho_n_patterns(const Builder* b) {
  return static_cast<int64_t>(b->pat_lens.size());
}

void aho_export(const Builder* b, int32_t* table, int32_t* byte_class,
                int64_t* emit_start, int32_t* emit_pats, int32_t* pat_lens,
                int32_t* state_depth) {
  std::memcpy(table, b->table.data(), b->table.size() * sizeof(int32_t));
  std::memcpy(byte_class, b->byte_class, sizeof(b->byte_class));
  std::memcpy(emit_start, b->emit_start.data(),
              b->emit_start.size() * sizeof(int64_t));
  std::memcpy(emit_pats, b->emit_pats.data(),
              b->emit_pats.size() * sizeof(int32_t));
  std::memcpy(pat_lens, b->pat_lens.data(),
              b->pat_lens.size() * sizeof(int32_t));
  std::memcpy(state_depth, b->state_depth.data(),
              b->state_depth.size() * sizeof(int32_t));
}

// ---------------------------------------------------------------------------
// Batch pattern insertion: one ctypes crossing for the whole pattern
// list (1M individual aho_builder_add calls cost ~4.6 s of pure ctypes
// marshaling at signature scale — round-5 build profile).  ``flat`` is
// the concatenation of all patterns, ``lens[i]`` each length;
// per-pattern AddStatus values are written to ``statuses``.

void aho_builder_add_batch(Builder* b, const uint8_t* flat,
                           const int64_t* lens, int64_t n,
                           int32_t* statuses) {
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    statuses[i] = aho_builder_add(b, flat + off, lens[i]);
    off += lens[i];
  }
}

// ---------------------------------------------------------------------------
// Bloom scatter-OR: words[idx[i]] |= bits[i].  numpy's np.bitwise_or.at
// runs ~100 ns/element (10+ s for the 12M-entry signature blooms,
// round-5 build profile); this is a plain store loop.

void aho_scatter_or(uint32_t* words, const int64_t* idx,
                    const uint32_t* bits, int64_t n) {
  for (int64_t i = 0; i < n; ++i) words[idx[i]] |= bits[i];
}

// Same with one constant bit value (bit blooms: prefix bloom).
void aho_scatter_or_bit(uint32_t* words, const int64_t* slots, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    words[slots[i] >> 5] |= uint32_t{1} << (slots[i] & 31);
}

// ---------------------------------------------------------------------------
// k-gram super-transition composition (see models/kgram_dfa.py for the
// table semantics: entry = end_state | (mid_final_flag << 30)).  The numpy
// composition materializes multi-hundred-MB intermediates; this streams the
// final table in one pass per level.

static constexpr int32_t kKgramStateMask = (1 << 30) - 1;
static constexpr int32_t kKgramMidFlag = 1 << 30;

extern "C" void aho_kgram_build(const int32_t* table1, int64_t S, int C,
                                int64_t final_start, int k, int32_t* out) {
  // level 1: plain transitions, no flag
  int64_t cols = C;
  std::vector<int32_t> cur(table1, table1 + S * C);
  for (int level = 2; level <= k; ++level) {
    const int64_t next_cols = cols * C;
    std::vector<int32_t> nxt(static_cast<size_t>(S) * next_cols);
    for (int64_t s = 0; s < S; ++s) {
      const int32_t* row = &cur[s * cols];
      int32_t* orow = &nxt[s * next_cols];
      for (int64_t code = 0; code < cols; ++code) {
        const int32_t e = row[code];
        const int32_t mid = e & kKgramMidFlag;
        const int32_t st = e & kKgramStateMask;
        const int32_t flag =
            mid | (st >= final_start ? kKgramMidFlag : 0);
        const int32_t* t1row = &table1[static_cast<int64_t>(st) * C];
        int32_t* dst = &orow[code * C];
        for (int c = 0; c < C; ++c) dst[c] = t1row[c] | flag;
      }
    }
    cur.swap(nxt);
    cols = next_cols;
  }
  std::memcpy(out, cur.data(), cur.size() * sizeof(int32_t));
}

}  // extern "C"
