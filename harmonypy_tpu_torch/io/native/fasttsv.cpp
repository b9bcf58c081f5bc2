// fasttsv — multithreaded (gzip-)TSV float-matrix parser for the harmonypy-tpu
// data loader.
//
// Role in the framework: the reference loads its PC matrices with
// pandas.read_csv (reference tests/test_harmony.py:81-90), whose native
// engine parses every column generically. TPU pods are fed per-host: each
// host process reads only its own contiguous cell range of the embedding
// (harmonypy_tpu/io/loader.py), and this parser is the native fast path for
// that read — stream-decompress with zlib, split rows across threads, and
// parse fixed-width float rows straight into a float32 buffer. This copy is
// the PyTorch port's (harmonypy_tpu_torch/io/loader.py builds and loads it).
//
// C ABI (consumed via ctypes from harmonypy_tpu_torch/io/loader.py):
//   TsvHandle* fasttsv_load(path, n_threads, err, errlen)
//   long fasttsv_rows(h) / fasttsv_cols(h) / fasttsv_has_header(h)
//                        / fasttsv_has_rownames(h)
//   void fasttsv_copy(h, out, row_start, row_end)  // rows [start, end)
//   void fasttsv_free(h)
//
// Layout rules (matching the reference's bundled .tsv.gz data files):
//   - optional single header line (detected: first field of first line does
//     not parse as a float),
//   - optional leading row-name string column (detected on the first data
//     line; skipped on every row),
//   - '\t' separators, '\n' line ends (trailing '\r' tolerated).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct TsvHandle {
  std::vector<float> data;  // n_rows * n_cols, row-major
  int64_t n_rows = 0;
  int64_t n_cols = 0;
  bool has_header = false;
  bool has_rownames = false;
};

// Read an entire file (gzip or plain; gzread handles both) into memory.
bool slurp(const char* path, std::vector<char>& out, std::string& err) {
  gzFile f = gzopen(path, "rb");
  if (!f) {
    err = "cannot open file";
    return false;
  }
  gzbuffer(f, 1 << 20);
  constexpr size_t kChunk = 16 << 20;
  size_t size = 0;
  for (;;) {
    out.resize(size + kChunk);
    int n = gzread(f, out.data() + size, kChunk);
    if (n < 0) {
      int zerr = 0;
      err = std::string("gzread: ") + gzerror(f, &zerr);
      gzclose(f);
      return false;
    }
    size += static_cast<size_t>(n);
    if (static_cast<size_t>(n) < kChunk) break;
  }
  gzclose(f);
  out.resize(size);
  return true;
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\r')) ++p;
  return p;
}

// Fast float parse: hand-rolled mantissa/exponent scan (covers the fixed
// "-0.123456789" style of the data files), falling back to strtof for
// anything unusual (inf/nan/hex). Returns nullptr on failure.
const char* parse_float(const char* p, const char* end, float* out) {
  p = skip_ws(p, end);
  if (p >= end) return nullptr;
  const char* start = p;
  bool neg = false;
  if (*p == '-' || *p == '+') {
    neg = (*p == '-');
    ++p;
  }
  double mant = 0.0;
  int digits = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    mant = mant * 10.0 + (*p - '0');
    ++p;
    ++digits;
  }
  int frac = 0;
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      mant = mant * 10.0 + (*p - '0');
      ++p;
      ++digits;
      ++frac;
    }
  }
  if (digits == 0) return nullptr;  // "nan", "inf", text...
  int exp10 = -frac;
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) {
      eneg = (*p == '-');
      ++p;
    }
    int e = 0;
    int edigits = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      e = e * 10 + (*p - '0');
      ++p;
      ++edigits;
    }
    if (edigits == 0) return nullptr;
    exp10 += eneg ? -e : e;
  }
  if (digits > 17 || exp10 > 30 || exp10 < -30) {
    // Precision-critical corner: defer to libc.
    char* endp = nullptr;
    float v = strtof(start, &endp);
    if (endp == start) return nullptr;
    *out = v;
    return endp;
  }
  static const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,
                                  1e7,  1e8,  1e9,  1e10, 1e11, 1e12, 1e13,
                                  1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20,
                                  1e21, 1e22, 1e23, 1e24, 1e25, 1e26, 1e27,
                                  1e28, 1e29, 1e30};
  double v = mant;
  if (exp10 >= 0)
    v *= kPow10[exp10];
  else
    v /= kPow10[-exp10];
  *out = static_cast<float>(neg ? -v : v);
  return p;
}

bool field_is_float(const char* p, const char* end) {
  float v;
  const char* q = parse_float(p, end, &v);
  if (!q) return false;
  q = skip_ws(q, end);
  return q == end || *q == '\t' || *q == '\n';
}

// Parse one data line into row (n_cols floats), honoring has_rownames.
bool parse_line(const char* p, const char* end, bool has_rownames,
                float* row, int64_t n_cols) {
  if (has_rownames) {
    while (p < end && *p != '\t') ++p;
    if (p < end) ++p;
  }
  for (int64_t c = 0; c < n_cols; ++c) {
    const char* q = parse_float(p, end, row + c);
    if (!q) return false;
    p = skip_ws(q, end);
    if (c + 1 < n_cols) {
      if (p >= end || *p != '\t') return false;
      ++p;
    }
  }
  // Ragged rows with EXTRA fields must fail too, not silently truncate.
  return p == end || *p == '\n';
}

int64_t count_fields(const char* p, const char* end) {
  int64_t n = 1;
  for (; p < end; ++p)
    if (*p == '\t') ++n;
  return n;
}

}  // namespace

extern "C" {

TsvHandle* fasttsv_load(const char* path, int n_threads, char* err,
                        int errlen) {
  auto fail = [&](const std::string& msg) -> TsvHandle* {
    if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
    return nullptr;
  };
  std::vector<char> buf;
  std::string msg;
  if (!slurp(path, buf, msg)) return fail(msg);
  if (buf.empty()) return fail("empty file");
  // NUL sentinel: the strtof fallback in parse_float scans from a raw
  // pointer; without a terminator a final field lacking a trailing newline
  // could read past the buffer.
  buf.push_back('\0');

  const char* base = buf.data();
  const char* end = base + buf.size() - 1;  // exclude the sentinel

  // Index line starts.
  std::vector<const char*> lines;
  lines.reserve(buf.size() / 64);
  const char* p = base;
  while (p < end) {
    lines.push_back(p);
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    p = nl ? nl + 1 : end;
  }
  // Drop a trailing blank line.
  while (!lines.empty()) {
    const char* s = lines.back();
    const char* e = static_cast<const char*>(
        memchr(s, '\n', static_cast<size_t>(end - s)));
    if (!e) e = end;
    if (skip_ws(s, e) != e) break;
    lines.pop_back();
  }
  if (lines.empty()) return fail("no data lines");

  auto line_end = [&](size_t i) -> const char* {
    const char* s = lines[i];
    const char* e = static_cast<const char*>(
        memchr(s, '\n', static_cast<size_t>(end - s)));
    return e ? e : end;
  };

  auto h = std::make_unique<TsvHandle>();
  h->has_header = !field_is_float(lines[0], line_end(0));
  size_t first_data = h->has_header ? 1 : 0;
  if (first_data >= lines.size()) return fail("header only, no data rows");

  const char* d0 = lines[first_data];
  const char* d0e = line_end(first_data);
  const char* tab = static_cast<const char*>(
      memchr(d0, '\t', static_cast<size_t>(d0e - d0)));
  h->has_rownames = !field_is_float(d0, tab ? tab : d0e);
  int64_t fields = count_fields(d0, d0e);
  h->n_cols = fields - (h->has_rownames ? 1 : 0);
  if (h->n_cols <= 0) return fail("no numeric columns");
  h->n_rows = static_cast<int64_t>(lines.size() - first_data);
  h->data.resize(static_cast<size_t>(h->n_rows) * h->n_cols);

  if (n_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = hc ? static_cast<int>(hc) : 1;
  }
  n_threads = static_cast<int>(
      std::min<int64_t>(n_threads, std::max<int64_t>(h->n_rows, 1)));

  std::atomic<int64_t> bad_row{-1};
  auto worker = [&](int t) {
    int64_t lo = h->n_rows * t / n_threads;
    int64_t hi = h->n_rows * (t + 1) / n_threads;
    for (int64_t r = lo; r < hi; ++r) {
      size_t li = first_data + static_cast<size_t>(r);
      if (!parse_line(lines[li], line_end(li), h->has_rownames,
                      h->data.data() + r * h->n_cols, h->n_cols)) {
        bad_row.store(r, std::memory_order_relaxed);
        return;
      }
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  int64_t bad = bad_row.load();
  if (bad >= 0)
    return fail("parse error at data row " + std::to_string(bad));
  return h.release();
}

long fasttsv_rows(TsvHandle* h) { return static_cast<long>(h->n_rows); }
long fasttsv_cols(TsvHandle* h) { return static_cast<long>(h->n_cols); }
int fasttsv_has_header(TsvHandle* h) { return h->has_header ? 1 : 0; }
int fasttsv_has_rownames(TsvHandle* h) { return h->has_rownames ? 1 : 0; }

void fasttsv_copy(TsvHandle* h, float* out, long row_start, long row_end) {
  if (row_start < 0) row_start = 0;
  if (row_end > h->n_rows) row_end = static_cast<long>(h->n_rows);
  if (row_end <= row_start) return;
  memcpy(out, h->data.data() + static_cast<size_t>(row_start) * h->n_cols,
         static_cast<size_t>(row_end - row_start) * h->n_cols *
             sizeof(float));
}

void fasttsv_free(TsvHandle* h) { delete h; }

}  // extern "C"
