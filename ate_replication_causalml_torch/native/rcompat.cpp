// Host-side native core: R-compatible RNG + numeric CSV ingest.
//
// The reference's host runtime is R's C internals: the MT19937 stream
// behind set.seed/runif/sample (R RNG.c semantics; invoked at
// ate_replication.Rmd:41-44 and ate_functions.R:269) and read.csv
// (ate_replication.Rmd:33). This library is the PyTorch port's
// equivalent of those native cores (a copy of the JAX package's
// native/rcompat.cpp): it feeds the host data pipeline; the card's
// compute path never calls into it.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).
// The Python class utils/rrandom.py::RCompatRNG implements the same
// stream and doubles as the cross-validation oracle for this code.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kN = 624;
constexpr int kM = 397;
constexpr uint32_t kMatrixA = 0x9908b0dfu;
constexpr uint32_t kUpperMask = 0x80000000u;
constexpr uint32_t kLowerMask = 0x7fffffffu;
// R scales MT output by 1/(2^32-1), then nudges endpoints into (0,1).
constexpr double kI2_32m1 = 2.3283064365386963e-10;

struct RCompatState {
  uint32_t mt[kN];
  int mti;            // position in the tempered block; kN => regenerate
  int sample_kind;    // 0 = rounding (R < 3.6), 1 = rejection (R >= 3.6)
};

void set_seed(RCompatState* s, uint32_t seed) {
  // R RNG_Init: 50 LCG warm-ups, then 625 LCG words; word 0 is the
  // position counter which FixupSeeds forces to kN (regenerate first).
  for (int i = 0; i < 50; ++i) seed = 69069u * seed + 1u;
  seed = 69069u * seed + 1u;  // word 0 (dummy position slot)
  for (int j = 0; j < kN; ++j) {
    seed = 69069u * seed + 1u;
    s->mt[j] = seed;
  }
  s->mti = kN;
}

void regenerate(RCompatState* s) {
  uint32_t* mt = s->mt;
  uint32_t y;
  for (int kk = 0; kk < kN - kM; ++kk) {
    y = (mt[kk] & kUpperMask) | (mt[kk + 1] & kLowerMask);
    mt[kk] = mt[kk + kM] ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
  }
  for (int kk = kN - kM; kk < kN - 1; ++kk) {
    y = (mt[kk] & kUpperMask) | (mt[kk + 1] & kLowerMask);
    mt[kk] = mt[kk + (kM - kN)] ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
  }
  y = (mt[kN - 1] & kUpperMask) | (mt[0] & kLowerMask);
  mt[kN - 1] = mt[kM - 1] ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
  s->mti = 0;
}

inline double next_unif(RCompatState* s) {
  if (s->mti >= kN) regenerate(s);
  uint32_t t = s->mt[s->mti++];
  t ^= t >> 11;
  t ^= (t << 7) & 0x9d2c5680u;
  t ^= (t << 15) & 0xefc60000u;
  t ^= t >> 18;
  double u = t * kI2_32m1;
  // R fixup(): open interval.
  if (u <= 0.0) u = 0.5 * kI2_32m1;
  if (1.0 - u <= 0.0) u = 1.0 - 0.5 * kI2_32m1;
  return u;
}

// R_unif_index (R >= 3.6): draw ceil(log2(dn)) random bits in 16-bit
// chunks, reject values >= dn.
inline int64_t unif_index(RCompatState* s, int64_t dn) {
  if (dn <= 0) return 0;
  int bits = (int)std::ceil(std::log2((double)dn));
  int64_t dv;
  do {
    dv = 0;
    for (int nb = 0; nb <= bits; nb += 16)
      dv = 65536 * dv + (int64_t)(next_unif(s) * 65536.0);
    dv &= ((int64_t)1 << bits) - 1;
  } while (dv >= dn);
  return dv;
}

}  // namespace

extern "C" {

void* rcompat_new(uint32_t seed, int sample_kind) {
  RCompatState* s = new RCompatState();
  s->sample_kind = sample_kind;
  set_seed(s, seed);
  return s;
}

void rcompat_free(void* h) { delete static_cast<RCompatState*>(h); }

void rcompat_runif(void* h, double* out, int64_t n) {
  RCompatState* s = static_cast<RCompatState*>(h);
  for (int64_t i = 0; i < n; ++i) out[i] = next_unif(s);
}

// R sample.int(n, size, replace) with 0-based output indices.
void rcompat_sample_int(void* h, int64_t n, int64_t size, int replace,
                        int64_t* out) {
  RCompatState* s = static_cast<RCompatState*>(h);
  if (replace) {
    if (s->sample_kind == 0) {
      for (int64_t i = 0; i < size; ++i)
        out[i] = (int64_t)(n * next_unif(s));
    } else {
      for (int64_t i = 0; i < size; ++i) out[i] = unif_index(s, n);
    }
    return;
  }
  // SampleNoReplace: partial Fisher-Yates over a shrinking pool.
  std::vector<int64_t> x((size_t)n);
  for (int64_t i = 0; i < n; ++i) x[(size_t)i] = i;
  int64_t m = n;
  for (int64_t i = 0; i < size; ++i) {
    int64_t j = (s->sample_kind == 0) ? (int64_t)(m * next_unif(s))
                                      : unif_index(s, m);
    out[i] = x[(size_t)j];
    x[(size_t)j] = x[(size_t)--m];
  }
}

// ---------------------------------------------------------------------
// Numeric CSV ingest (read.csv equivalent for the GGL panel layout:
// one header row, comma-separated numeric fields, empty/NA -> NaN).
// Two-call protocol: csv_dims sizes the output, csv_read_f64 fills a
// row-major (rows x cols) buffer. Header names are returned as one
// comma-joined string for the Python side to split.
// ---------------------------------------------------------------------

int csv_dims(const char* path, int64_t* rows, int64_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t r = 0, c = 1;
  int ch;
  bool first_line = true, line_has_data = false;
  while ((ch = std::fgetc(f)) != EOF) {
    if (first_line && ch == ',') ++c;
    if (ch == '\n') {
      if (first_line) first_line = false;
      else if (line_has_data) ++r;  // blank lines are not rows (genfromtxt semantics)
      line_has_data = false;
    } else if (ch != '\r') {
      line_has_data = true;
    }
  }
  if (line_has_data && !first_line) ++r;  // unterminated last line
  std::fclose(f);
  *rows = r;
  *cols = c;
  return 0;
}

int csv_header(const char* path, char* buf, int64_t buflen) {
  // Returns 0 on success, -1 if unreadable, -2 if the header line did
  // not fit in buflen (truncated output — callers must not trust it).
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t i = 0;
  int ch;
  while ((ch = std::fgetc(f)) != EOF && ch != '\n') {
    if (ch == '\r' || ch == '"') continue;
    if (i >= buflen - 1) {  // would overflow: report truncation
      buf[i] = '\0';
      std::fclose(f);
      return -2;
    }
    buf[i++] = (char)ch;
  }
  buf[i] = '\0';
  std::fclose(f);
  return 0;
}

int csv_read_f64(const char* path, double* out, int64_t rows, int64_t cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // Short/ragged rows must read as missing, not heap garbage.
  const double nan = std::nan("");
  for (int64_t i = 0; i < rows * cols; ++i) out[i] = nan;
  // Skip header.
  int ch;
  while ((ch = std::fgetc(f)) != EOF && ch != '\n') {
  }
  std::vector<char> field;
  field.reserve(64);
  int64_t r = 0, c = 0;
  bool line_has_data = false;
  auto flush = [&](int64_t rr, int64_t cc) {
    if (rr >= rows || cc >= cols) {
      field.clear();
      return;
    }
    field.push_back('\0');
    const char* p = field.data();
    char* end = nullptr;
    double v = std::strtod(p, &end);
    bool ok = end != p && field.size() > 1;
    // Trailing non-whitespace after the number ("1x") is non-numeric —
    // NaN, matching np.genfromtxt (plain strtod would accept 1.0).
    for (; ok && *end != '\0'; ++end) {
      if (*end != ' ' && *end != '\t') ok = false;
    }
    out[rr * cols + cc] = ok ? v : nan;  // "NA", "", non-numeric -> NaN
    field.clear();
  };
  while ((ch = std::fgetc(f)) != EOF) {
    if (ch == ',') {
      flush(r, c);
      ++c;
      line_has_data = true;  // ",," lines are data (all-missing fields)
    } else if (ch == '\n') {
      if (line_has_data) {   // blank lines are not rows (matches csv_dims)
        flush(r, c);
        ++r;
      }
      c = 0;
      line_has_data = false;
    } else if (ch != '\r' && ch != '"') {
      field.push_back((char)ch);
      line_has_data = true;
    }
  }
  if (line_has_data) flush(r, c);
  std::fclose(f);
  return 0;
}

}  // extern "C"
