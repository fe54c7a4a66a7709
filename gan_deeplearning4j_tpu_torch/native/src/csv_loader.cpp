// Native CSV parser/writer of the PyTorch port (the JAX package keeps its own
// copy of this file): a small C ABI library that parses numeric CSVs into a
// dense float32 matrix (and writes them back), multithreaded over row
// chunks, in place of DataVec's CSVRecordReader of the reference. Python
// binds it with ctypes (gan_deeplearning4j_tpu_torch/native/csv_loader.py)
// and falls back to numpy where no g++ is present.
//
// Error codes: 0 ok, 1 cannot open/read, 2 ragged rows, 3 parse failure,
// 4 empty input.

#include <atomic>
#include <cmath>
#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Buffer {
  std::string data;
};

bool read_file(const char* path, std::string* out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(&(*out)[0], 1, static_cast<size_t>(size), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(size);
}

// Offsets of line starts for non-empty lines (handles \n and \r\n endings).
void line_offsets(const std::string& text, std::vector<size_t>* starts,
                  std::vector<size_t>* ends) {
  size_t pos = 0;
  const size_t n = text.size();
  while (pos < n) {
    size_t eol = text.find('\n', pos);
    size_t end = (eol == std::string::npos) ? n : eol;
    size_t trimmed = end;
    while (trimmed > pos && (text[trimmed - 1] == '\r' || text[trimmed - 1] == ' '))
      --trimmed;
    if (trimmed > pos) {
      starts->push_back(pos);
      ends->push_back(trimmed);
    }
    if (eol == std::string::npos) break;
    pos = eol + 1;
  }
}

long count_fields(const char* p, const char* end, char delim) {
  long fields = 1;
  for (; p < end; ++p)
    if (*p == delim) ++fields;
  return fields;
}

const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                         1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                         1e16, 1e17, 1e18};

// Fast decimal parser for the common CSV shapes ("0.27", "-1.5", "666",
// "1e-3"); ~10x strtof, which locks the locale per call. Returns the cursor
// after the number, or nullptr to signal "let strtof try" (covers nan/inf/
// overlong digit runs).
const char* parse_float_fast(const char* p, const char* end, float* out) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  double val = 0.0;
  int digits = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    val = val * 10.0 + (*p++ - '0');
    ++digits;
  }
  if (p < end && *p == '.') {
    ++p;
    int frac = 0;
    double f = 0.0;
    while (p < end && *p >= '0' && *p <= '9') {
      f = f * 10.0 + (*p++ - '0');
      ++frac;
    }
    if (frac > 18) return nullptr;
    val += f / kPow10[frac];
    digits += frac;
  }
  if (digits == 0 || digits > 18) return nullptr;
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) eneg = (*p++ == '-');
    long ex = 0;
    int edigits = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      ex = ex * 10 + (*p++ - '0');
      ++edigits;
    }
    if (edigits == 0 || ex > 300) return nullptr;
    const double scale =
        (ex <= 18) ? kPow10[ex] : std::pow(10.0, static_cast<double>(ex));
    val = eneg ? val / scale : val * scale;
  }
  *out = static_cast<float>(neg ? -val : val);
  return p;
}

// Process-lifetime "C" locale so the strtof fallback is deterministic under
// any LC_NUMERIC (a comma-decimal locale would otherwise parse "3.14" as 3).
locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", static_cast<locale_t>(0));
  return loc;
}

// Parse one line of `cols` floats into out; returns false on error.
bool parse_line(const char* p, const char* end, char delim, long cols, float* out) {
  for (long c = 0; c < cols; ++c) {
    while (p < end && *p == ' ') ++p;
    const char* next = parse_float_fast(p, end, &out[c]);
    if (next == nullptr) {  // rare shapes (nan/inf/huge) -> strtof fallback
      // Bounded: copy the field into a NUL-terminated scratch buffer first —
      // strtof on the raw pointer would scan the whole null-terminated file
      // buffer past the logical field end.
      const char* fend = p;
      while (fend < end && *fend != delim) ++fend;
      char scratch[64];
      const size_t len = static_cast<size_t>(fend - p);
      if (len == 0 || len >= sizeof(scratch)) return false;
      std::memcpy(scratch, p, len);
      scratch[len] = '\0';
      char* sn = nullptr;
      errno = 0;
      out[c] = strtof_l(scratch, &sn, c_locale());
      if (sn == scratch) return false;
      next = p + (sn - scratch);
    }
    p = next;
    while (p < end && *p == ' ') ++p;
    if (c + 1 < cols) {
      if (p >= end || *p != delim) return false;
      ++p;
    }
  }
  while (p < end && (*p == ' ' || *p == '\r')) ++p;
  return p == end;  // trailing garbage -> error
}

}  // namespace

extern "C" {

int gdt_csv_read(const char* path, long skip_lines, char delim, float** out_data,
                 long* out_rows, long* out_cols) {
  std::string text;
  if (!read_file(path, &text)) return 1;
  std::vector<size_t> starts, ends;
  line_offsets(text, &starts, &ends);
  if (skip_lines < 0) skip_lines = 0;
  if (static_cast<size_t>(skip_lines) >= starts.size()) return 4;

  const size_t first = static_cast<size_t>(skip_lines);
  const long rows = static_cast<long>(starts.size() - first);
  const long cols =
      count_fields(text.data() + starts[first], text.data() + ends[first], delim);
  float* data = static_cast<float*>(std::malloc(sizeof(float) * rows * cols));
  if (!data) return 1;

  std::atomic<int> status{0};
  long nthreads = static_cast<long>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > rows) nthreads = rows;
  std::vector<std::thread> workers;
  const long chunk = (rows + nthreads - 1) / nthreads;
  for (long t = 0; t < nthreads; ++t) {
    const long r0 = t * chunk;
    const long r1 = (r0 + chunk < rows) ? r0 + chunk : rows;
    if (r0 >= r1) break;
    workers.emplace_back([&, r0, r1]() {
      for (long r = r0; r < r1 && status.load(std::memory_order_relaxed) == 0; ++r) {
        const char* p = text.data() + starts[first + r];
        const char* end = text.data() + ends[first + r];
        if (count_fields(p, end, delim) != cols) {
          status.store(2, std::memory_order_relaxed);
          return;
        }
        if (!parse_line(p, end, delim, cols, data + r * cols)) {
          status.store(3, std::memory_order_relaxed);
          return;
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  if (int s = status.load()) {
    std::free(data);
    return s;
  }
  *out_data = data;
  *out_rows = rows;
  *out_cols = cols;
  return 0;
}

void gdt_csv_free(float* ptr) { std::free(ptr); }

}  // extern "C"

namespace {

// Fixed-precision float -> decimal text, round-half-away-from-zero (printf
// semantics for the values seen here); ~10x snprintf. Falls back to snprintf
// outside the fast range.
inline char* emit_fixed(char* out, double v, int precision) {
  // fast path only when v * 10^precision fits an unsigned long long; NaN,
  // inf, and huge values take the printf path (bounded, length-checked)
  const double mag = (v < 0 ? -v : v) * kPow10[precision];
  if (!(mag < 1.8e19)) {
    char tmp[96];
    int n = std::snprintf(tmp, sizeof(tmp), "%.*f", precision, v);
    if (n < 0) n = 0;
    if (n > static_cast<int>(sizeof(tmp)) - 1) n = sizeof(tmp) - 1;
    std::memcpy(out, tmp, static_cast<size_t>(n));
    return out + n;
  }
  if (v < 0 || (v == 0.0 && std::signbit(v))) {
    *out++ = '-';
    v = -v;
  }
  const double scaled = v * kPow10[precision] + 0.5;
  unsigned long long units = static_cast<unsigned long long>(scaled);
  char digits[32];
  int n = 0;
  unsigned long long ip = units;
  for (int i = 0; i < precision; ++i) {
    digits[n++] = static_cast<char>('0' + ip % 10);
    ip /= 10;
  }
  char frac_sep = precision ? '.' : '\0';
  char idigits[24];
  int ni = 0;
  do {
    idigits[ni++] = static_cast<char>('0' + ip % 10);
    ip /= 10;
  } while (ip);
  while (ni) *out++ = idigits[--ni];
  if (frac_sep) {
    *out++ = frac_sep;
    while (n) *out++ = digits[--n];
  }
  return out;
}

// Shared writer body over the element type: f32 exports come straight from
// device fetches; f64 exists so the native path formats the same digits as
// the numpy fallback for double input (no silent downcast).
template <typename T>
int write_csv_impl(const char* path, const T* data, long rows, long cols,
                   char delim, int precision) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  if (precision < 0 || precision > 17) precision = 6;
  std::string buf;
  // worst case per field: 95 chars (printf fallback buffer) + delimiter
  const size_t row_cap = static_cast<size_t>(cols) * 96 + 2;
  buf.resize(row_cap * 256);  // flush every 256 rows
  char* cur = &buf[0];
  long pending = 0;
  for (long r = 0; r < rows; ++r) {
    for (long c = 0; c < cols; ++c) {
      if (c) *cur++ = delim;
      cur = emit_fixed(cur, static_cast<double>(data[r * cols + c]), precision);
    }
    *cur++ = '\n';
    if (++pending == 256 || r + 1 == rows) {
      const size_t len = static_cast<size_t>(cur - buf.data());
      if (std::fwrite(buf.data(), 1, len, f) != len) {
        std::fclose(f);
        return 1;
      }
      cur = &buf[0];
      pending = 0;
    }
  }
  return std::fclose(f) == 0 ? 0 : 1;  // flush failure = write failure
}

}  // namespace

extern "C" {

// Write a dense float32 matrix as fixed-precision CSV (the export path,
// reference :550-598, without per-scalar host reads). Returns 0 on success.
int gdt_csv_write(const char* path, const float* data, long rows, long cols,
                  char delim, int precision) {
  return write_csv_impl(path, data, rows, cols, delim, precision);
}

// Same, formatting from float64 (keeps the native writer digit-identical to
// the numpy fallback when callers hand in doubles).
int gdt_csv_write_f64(const char* path, const double* data, long rows,
                      long cols, char delim, int precision) {
  return write_csv_impl(path, data, rows, cols, delim, precision);
}

}  // extern "C"
