// Self-test binary for the native layer — run under ASAN/UBSAN via
// `make asan` (the reference relied on external valgrind/Coverity; here the
// sanitizer run is part of the build).

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

struct Builder;
extern "C" {
Builder* aho_builder_new(int);
void aho_builder_free(Builder*);
int aho_builder_add(Builder*, const uint8_t*, int64_t);
int aho_builder_compile(Builder*);
int64_t aho_n_states(const Builder*);
int aho_n_classes(const Builder*);
int64_t aho_emit_size(const Builder*);
int64_t aho_final_start(const Builder*);
int aho_max_len(const Builder*);
int64_t aho_n_patterns(const Builder*);
void aho_export(const Builder*, int32_t*, int32_t*, int64_t*, int32_t*,
                int32_t*, int32_t*);
int64_t aho_oracle_scan(const int32_t*, int, const int32_t*, int64_t,
                        const uint8_t*, int64_t, int64_t, int64_t, int64_t*,
                        int32_t*, int64_t, int64_t*);
void aho_kgram_build(const int32_t*, int64_t, int, int64_t, int, int32_t*);
}

static void add(Builder* b, const char* s) {
  int rc = aho_builder_add(b, reinterpret_cast<const uint8_t*>(s),
                           static_cast<int64_t>(strlen(s)));
  assert(rc == 0);
}

int main() {
  Builder* b = aho_builder_new(1024);
  add(b, "he");
  add(b, "she");
  add(b, "his");
  add(b, "hers");
  // duplicate and overlong rejections
  assert(aho_builder_add(b, reinterpret_cast<const uint8_t*>("he"), 2) == 1);
  std::vector<uint8_t> big(2000, 'x');
  assert(aho_builder_add(b, big.data(), big.size()) == 2);
  assert(aho_builder_compile(b) == 0);

  const int64_t S = aho_n_states(b);
  const int C = aho_n_classes(b);
  assert(S == 10 && C == 6);

  std::vector<int32_t> table(S * C), byte_class(256), emit_pats(aho_emit_size(b));
  std::vector<int64_t> emit_start(S + 1);
  std::vector<int32_t> pat_lens(aho_n_patterns(b)), depth(S);
  aho_export(b, table.data(), byte_class.data(), emit_start.data(),
             emit_pats.data(), pat_lens.data(), depth.data());

  const char* text = "ushers and his shells";
  std::vector<int64_t> pos(64);
  std::vector<int32_t> st(64);
  int64_t carry = 0;
  int64_t n = aho_oracle_scan(
      table.data(), C, byte_class.data(), aho_final_start(b),
      reinterpret_cast<const uint8_t*>(text),
      static_cast<int64_t>(strlen(text)), 0, 0, pos.data(), st.data(), 64,
      &carry);
  // ushers: she@3, he@3(same pos, same state), hers@5; his@13; she@17, he@17
  assert(n == 4);
  assert(pos[0] == 3 && pos[1] == 5 && pos[2] == 13 && pos[3] == 17);

  // k-gram composition smoke (k=2): walk equivalence on a few inputs
  std::vector<int32_t> kt(S * C * C);
  aho_kgram_build(table.data(), S, C, aho_final_start(b), 2, kt.data());
  for (int64_t s = 0; s < S; ++s)
    for (int c0 = 0; c0 < C; ++c0)
      for (int c1 = 0; c1 < C; ++c1) {
        int32_t mid = table[s * C + c0];
        int32_t want = table[mid * C + c1] |
                       (mid >= aho_final_start(b) ? (1 << 30) : 0);
        assert(kt[(s * C + c0) * C + c1] == want);
      }

  aho_builder_free(b);
  printf("native selftest ok: S=%lld C=%d matches=%lld\n",
         static_cast<long long>(S), C, static_cast<long long>(n));
  return 0;
}
