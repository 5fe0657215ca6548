// CPU oracle scanner — a scalar table-walk over the compiled automaton,
// used to (a) cross-check device kernels at fuzz scale and (b) provide a
// fast host path for huge one-off scans without a device.
//
// Semantics mirror the reference's hot loop (ac_trie_search,
// src/multifast/ahocorasick.c:199-234) expressed over the precomposed
// table: one lookup per byte, emit when the reached state is final.

#include <cstdint>

extern "C" {

// Scans `text[0..n)` from `init_state`; records final positions with
// in-buffer index >= emit_from.  Writes up to `cap` (position, state)
// pairs; returns the TRUE number of final positions (may exceed cap — the
// caller must re-run with a larger buffer; results are never silently
// truncated).  `*out_carry` receives the end state (streaming carry).
int64_t aho_oracle_scan(const int32_t* table, int n_classes,
                        const int32_t* byte_class, int64_t final_start,
                        const uint8_t* text, int64_t n, int64_t init_state,
                        int64_t emit_from, int64_t* out_pos,
                        int32_t* out_state, int64_t cap,
                        int64_t* out_carry) {
  int64_t s = init_state;
  int64_t found = 0;
  for (int64_t t = 0; t < n; ++t) {
    s = table[s * n_classes + byte_class[text[t]]];
    if (s >= final_start && t >= emit_from) {
      if (found < cap) {
        out_pos[found] = t;
        out_state[found] = static_cast<int32_t>(s);
      }
      ++found;
    }
  }
  *out_carry = s;
  return found;
}

// int16 table variant (the compiler emits int16 tables when states fit).
int64_t aho_oracle_scan16(const int16_t* table, int n_classes,
                          const int32_t* byte_class, int64_t final_start,
                          const uint8_t* text, int64_t n, int64_t init_state,
                          int64_t emit_from, int64_t* out_pos,
                          int32_t* out_state, int64_t cap,
                          int64_t* out_carry) {
  int64_t s = init_state;
  int64_t found = 0;
  for (int64_t t = 0; t < n; ++t) {
    s = table[s * n_classes + byte_class[text[t]]];
    if (s >= final_start && t >= emit_from) {
      if (found < cap) {
        out_pos[found] = t;
        out_state[found] = static_cast<int32_t>(s);
      }
      ++found;
    }
  }
  *out_carry = s;
  return found;
}

}  // extern "C"
