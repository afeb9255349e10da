// Sanitizer self-test harness for the native host runtime.
//
// SURVEY.md §5.2: the only host native code of the package is this
// C++ runtime, which the tests exercise under ASan/UBSan via this
// standalone binary (tests/test_torch_native.py::test_sanitizer_clean
// builds and runs it when g++ is available).
//
// Checks, against values cross-validated with R and the NumPy oracle:
//   * set.seed(1991) first runif draws,
//   * sample.int determinism and bounds under both sample kinds,
//   * CSV reader on a temp file with NA/blank/short rows.

#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {
void* rcompat_new(uint32_t seed, int sample_kind);
void rcompat_free(void* h);
void rcompat_runif(void* h, double* out, int64_t n);
void rcompat_sample_int(void* h, int64_t n, int64_t size, int replace, int64_t* out);
int csv_dims(const char* path, int64_t* rows, int64_t* cols);
int csv_header(const char* path, char* buf, int64_t buflen);
int csv_read_f64(const char* path, double* out, int64_t rows, int64_t cols);
}

static int failures = 0;
#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      ++failures;                                                      \
    }                                                                  \
  } while (0)

int main() {
  // set.seed(1991) first draws, per the NumPy oracle implementation of
  // R's RNG.c semantics (utils/rrandom.py — the ctypes tests prove the
  // two streams bit-match end to end).
  void* h = rcompat_new(1991, 0);
  double u[1000];
  rcompat_runif(h, u, 3);
  CHECK(std::fabs(u[0] - 0.15062308) < 1e-7);
  CHECK(std::fabs(u[1] - 0.23083080) < 1e-7);
  CHECK(std::fabs(u[2] - 0.01348260) < 1e-7);
  // Cross a regeneration boundary.
  rcompat_runif(h, u, 1000);
  for (int i = 0; i < 1000; ++i) CHECK(u[i] > 0.0 && u[i] < 1.0);
  rcompat_free(h);

  for (int kind = 0; kind < 2; ++kind) {
    void* a = rcompat_new(42, kind);
    void* b = rcompat_new(42, kind);
    int64_t sa[500], sb[500];
    rcompat_sample_int(a, 10000, 500, 1, sa);
    rcompat_sample_int(b, 10000, 500, 1, sb);
    CHECK(std::memcmp(sa, sb, sizeof sa) == 0);
    for (int i = 0; i < 500; ++i) CHECK(sa[i] >= 0 && sa[i] < 10000);
    // Without replacement: distinct, in range.
    rcompat_sample_int(a, 600, 500, 0, sa);
    bool seen[600] = {false};
    for (int i = 0; i < 500; ++i) {
      CHECK(sa[i] >= 0 && sa[i] < 600);
      CHECK(!seen[sa[i]]);
      seen[sa[i]] = true;
    }
    rcompat_free(a);
    rcompat_free(b);
  }

  // CSV reader on a temp file with NA, blank line, and a short row.
  char path[] = "/tmp/rcompat_selftest_XXXXXX";
  int fd = mkstemp(path);
  CHECK(fd >= 0);
  FILE* f = fdopen(fd, "w");
  std::fputs("a,b,c\n1,NA,3\n\n4,5\n7,8,9\n", f);
  std::fclose(f);
  int64_t rows = 0, cols = 0;
  CHECK(csv_dims(path, &rows, &cols) == 0);
  CHECK(rows == 3 && cols == 3);
  char hdr[64];
  CHECK(csv_header(path, hdr, sizeof hdr) == 0);
  CHECK(std::strcmp(hdr, "a,b,c") == 0);
  double m[9];
  CHECK(csv_read_f64(path, m, rows, cols) == 0);
  CHECK(m[0] == 1.0 && std::isnan(m[1]) && m[2] == 3.0);
  CHECK(m[3] == 4.0 && m[4] == 5.0 && std::isnan(m[5]));
  CHECK(m[6] == 7.0 && m[7] == 8.0 && m[8] == 9.0);
  std::remove(path);

  if (failures) {
    std::fprintf(stderr, "%d check(s) failed\n", failures);
    return 1;
  }
  std::puts("rcompat_selftest: all checks passed");
  return 0;
}
