// Tab-separated rows of scores, formatted as printf's "%.9g" formats them.
//
// The prediction matrices hold one row per protein and one score per GO
// term (bp alone has 3,992). Formatting those cells one Python object at a
// time set the pace of predict-function; here a whole block of rows is
// written into one byte buffer.
//
// std::to_chars(first, last, value, std::chars_format::general, precision)
// is specified to give what printf("%.*g", precision, value) gives in the C
// locale, so every cell is byte-equal to Python's "%.9g" % value, with one
// exception that is handled here: Python writes every NaN as "nan", where
// to_chars writes a NaN with its sign bit set as "-nan". Nine significant
// digits round-trip a float32 exactly.
//
// Build: python -m metagenomic_deepfri_tpu_torch.native.build

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

template <typename T>
int64_t format_rows(const T* x, int64_t rows, int64_t cols,
                    const char* prefix, const int64_t* prefix_off, char* out,
                    int64_t cap) {
  char* p = out;
  char* const end = out + cap;
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t plen = prefix_off[r + 1] - prefix_off[r];
    if (end - p < plen) return -1;
    std::memcpy(p, prefix + prefix_off[r], plen);
    p += plen;
    const T* row = x + r * cols;
    for (int64_t c = 0; c < cols; ++c) {
      if (c) {
        if (p == end) return -1;
        *p++ = '\t';
      }
      const double v = static_cast<double>(row[c]);
      if (std::isnan(v)) {
        if (end - p < 3) return -1;
        std::memcpy(p, "nan", 3);
        p += 3;
        continue;
      }
      const std::to_chars_result res =
          std::to_chars(p, end, v, std::chars_format::general, 9);
      if (res.ec != std::errc()) return -1;
      p = res.ptr;
    }
    if (p == end) return -1;
    *p++ = '\n';
  }
  return p - out;
}

}  // namespace

extern "C" {

// Writes, for each of `rows` rows, its prefix (bytes prefix_off[r] up to
// prefix_off[r + 1] of `prefix`), the row's `cols` values of the row-major
// block `x` joined by tabs, and a newline, into `out`. Returns the bytes
// written, or -1 when `cap` bytes are not enough.
int64_t tsv_format_rows_f32(const float* x, int64_t rows, int64_t cols,
                            const char* prefix, const int64_t* prefix_off,
                            char* out, int64_t cap) {
  return format_rows(x, rows, cols, prefix, prefix_off, out, cap);
}

int64_t tsv_format_rows_f64(const double* x, int64_t rows, int64_t cols,
                            const char* prefix, const int64_t* prefix_off,
                            char* out, int64_t cap) {
  return format_rows(x, rows, cols, prefix, prefix_off, out, cap);
}

}  // extern "C"
