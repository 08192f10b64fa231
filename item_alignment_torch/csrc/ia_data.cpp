// Host-side data kernels of the PyTorch port: the TSV offset scan, the
// fp32 embedding formatter, the embedding-JSON span scan and a byte
// counter.  A copy of the four C functions of the JAX package's loader,
// kept here so that the port builds from its own files.
//
//   - tsv_index:   one-pass mmap scan giving per-field (start, end) byte
//                  offsets, so Python slices strings without a copy
//   - count_char:  counts one byte (newlines) over a mapped file
//   - format_float_rows: [n, d] float32 -> ASCII decimal rows (%.9g, which
//                  gives every fp32 value back; NaN, Infinity and
//                  -Infinity as json.dump spells them)
//   - emb_json_spans: offset scan of an {"id": [floats...]} JSON map, so
//                  Python slices the ids and the arrays' own text
//
// Built by g++ at first use into build/native/ and bound with ctypes by
// item_alignment_torch/data/native_loader.py.  No dependencies.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  void* raw = nullptr;
  int error = 0;
};

Mapped map_file(const char* path) {
  Mapped m;
  int fd = open(path, O_RDONLY);
  if (fd < 0) { m.error = -1; return m; }
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); m.error = -2; return m; }
  m.size = static_cast<size_t>(st.st_size);
  if (m.size == 0) { close(fd); return m; }
  m.raw = mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (m.raw == MAP_FAILED) { m.raw = nullptr; m.error = -3; return m; }
  m.data = static_cast<const char*>(m.raw);
  return m;
}

}  // namespace

extern "C" {

// Two-pass protocol: first call with null output pointers to obtain
// (n_lines, n_fields); allocate; call again to fill
//   field_starts[n_fields], field_ends[n_fields]  (byte offsets)
//   field_counts[n_lines]                          (fields per line)
// Returns 0 on success, negative on failure.
int64_t tsv_index(const char* path, int64_t* n_lines, int64_t* n_fields,
                  int64_t* field_starts, int64_t* field_ends,
                  int64_t* field_counts) {
  Mapped m = map_file(path);
  if (m.error) return m.error;
  int64_t lines = 0, fields = 0;
  size_t pos = 0;
  while (pos < m.size) {
    const char* nl = static_cast<const char*>(
        memchr(m.data + pos, '\n', m.size - pos));
    size_t line_end = nl ? static_cast<size_t>(nl - m.data) : m.size;
    int64_t line_fields = 0;
    size_t field_start = pos;
    while (true) {
      const char* tab = static_cast<const char*>(
          memchr(m.data + field_start, '\t', line_end - field_start));
      size_t field_end = tab ? static_cast<size_t>(tab - m.data) : line_end;
      if (field_starts != nullptr) {
        field_starts[fields] = static_cast<int64_t>(field_start);
        field_ends[fields] = static_cast<int64_t>(field_end);
      }
      ++fields;
      ++line_fields;
      if (!tab) break;
      field_start = field_end + 1;
    }
    if (field_counts != nullptr) field_counts[lines] = line_fields;
    ++lines;
    pos = line_end + 1;
  }
  if (m.raw) munmap(m.raw, m.size);
  *n_lines = lines;
  *n_fields = fields;
  return 0;
}

// [n, d] float32 row-major -> sep-joined ASCII decimal rows written
// back-to-back into buf (caller slices rows via row_ends).  %.9g is the
// shortest printf format that round-trips every fp32 exactly.  Returns
// total bytes written, or -1 if cap would be exceeded (callers chunk rows
// and size cap at 16 bytes per value, which %.9g never exceeds).
int64_t format_float_rows(const float* emb, int64_t n, int64_t d, char sep,
                          char* buf, int64_t cap, int64_t* row_ends) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* row = emb + i * d;
    for (int64_t j = 0; j < d; ++j) {
      if (cap - pos < 32) return -1;
      if (j) buf[pos++] = sep;
      float v = row[j];
      if (v != v) {  // non-finite: keep json.dump's token spelling so the
        pos += snprintf(buf + pos, 32, "NaN");  // json.load fallback and
      } else if (v > 3.4028235e38f) {           // external tools can still
        pos += snprintf(buf + pos, 32, "Infinity");  // parse the dump
      } else if (v < -3.4028235e38f) {
        pos += snprintf(buf + pos, 32, "-Infinity");
      } else {
        pos += snprintf(buf + pos, 32, "%.9g", static_cast<double>(v));
      }
    }
    row_ends[i] = pos;
  }
  return pos;
}

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end &&
         (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  return p;
}

}  // namespace

// Offset scan of an {"id": [v, v, ...], ...} JSON map (the shape both our
// writer and the reference's json.dump produce).  Per entry it records the
// byte span of the key (WITHOUT quotes) and of the array body (between the
// brackets, exclusive), so Python can slice both from the mapped text with
// no float parsing here and no boxed floats there.
//
// Two-pass protocol like tsv_index: null output pointers -> count only.
// Returns 0 on success; any structural surprise (escaped key, nesting,
// non-array value) returns negative and the caller falls back to
// json.load.
int64_t emb_json_spans(const char* path, int64_t* n_out,
                       int64_t* key_starts, int64_t* key_ends,
                       int64_t* val_starts, int64_t* val_ends) {
  Mapped m = map_file(path);
  if (m.error) return m.error;
  const char* base = m.data;
  const char* end = base + m.size;
  const char* p = skip_ws(base, end);
  int64_t n = 0;
  int64_t rc = 0;
  if (p >= end || *p != '{') rc = -10;
  if (rc == 0) {
    ++p;
    p = skip_ws(p, end);
    if (p < end && *p == '}') {
      // empty map
    } else {
      while (true) {
        p = skip_ws(p, end);
        if (p >= end || *p != '"') { rc = -10; break; }
        ++p;
        const char* ks = p;
        while (p < end && *p != '"') {
          if (*p == '\\') { rc = -12; break; }  // escaped key: bail
          ++p;
        }
        if (rc != 0 || p >= end) { if (rc == 0) rc = -10; break; }
        if (key_starts != nullptr) {
          key_starts[n] = ks - base;
          key_ends[n] = p - base;
        }
        ++p;
        p = skip_ws(p, end);
        if (p >= end || *p != ':') { rc = -10; break; }
        ++p;
        p = skip_ws(p, end);
        if (p >= end || *p != '[') { rc = -10; break; }
        ++p;
        const char* vs = p;
        while (p < end && *p != '[' && *p != ']' && *p != '{') ++p;
        if (p >= end || *p != ']') { rc = -11; break; }  // nested: bail
        if (val_starts != nullptr) {
          val_starts[n] = vs - base;
          val_ends[n] = p - base;
        }
        ++p;
        ++n;
        p = skip_ws(p, end);
        if (p < end && *p == ',') { ++p; continue; }
        if (p < end && *p == '}') break;
        rc = -10;
        break;
      }
    }
  }
  if (m.raw) munmap(m.raw, m.size);
  if (rc != 0) return rc;
  *n_out = n;
  return 0;
}

int64_t count_char(const char* path, char needle) {
  Mapped m = map_file(path);
  if (m.error) return m.error;
  int64_t count = 0;
  const char* p = m.data;
  size_t left = m.size;
  while (left > 0) {
    const char* hit = static_cast<const char*>(memchr(p, needle, left));
    if (!hit) break;
    ++count;
    left -= static_cast<size_t>(hit - p) + 1;
    p = hit + 1;
  }
  if (m.raw) munmap(m.raw, m.size);
  return count;
}

}  // extern "C"
