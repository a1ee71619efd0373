// fpcr_io — native data-layer primitives for fpcr_tpu.
//
// Native counterpart of the reference's C++ data layer: the CSV cloud
// tokenizer (readData, /root/reference/src/CUDA/GPU_point_to_point_bunny.cu:463-497)
// and the Ouster packet byte-stream reader feeding Read_data
// (/root/reference/src/CUDA/GPU_point_to_plane_real.cu:677-733). Host-side
// ingest is the one place Python is measurably slow (hundreds of thousands
// of ASCII tokens), so these hot parsers are C++; everything downstream is
// jnp/Pallas on device.
//
// Exposed via the CPython C API (no pybind11 in this image):
//   parse_floats(path: str) -> bytes   # little-endian f32 tokens
//   parse_ints(path: str)   -> bytes   # little-endian i64 tokens
// The Python wrapper (fpcr_tpu/utils/native.py) wraps the bytes in numpy
// arrays with zero additional parsing. Separators: whitespace, ';', ','.
//
// Error contract (review r3 — the native path must never SILENTLY diverge
// from the numpy fallback): an unparsable token, an out-of-range value, or
// a short read raises; it never returns a truncated result as success.
// Parsing is LC_NUMERIC-independent (an embedding app's setlocale() must
// not change what '1.5' means) and runs with the GIL released.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cerrno>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <locale.h>

namespace {

locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return loc;
}

enum class IoError {
  kNone = 0,
  kOpen,        // fopen failed
  kRead,        // short read / ftell failure
  kNoMemory,    // malloc/realloc failed
  kBadToken,    // unparsable token mid-file
  kRange,       // token out of range for the type
};

char *read_whole_file(const char *path, size_t *size_out, IoError *err) {
  FILE *fh = std::fopen(path, "rb");
  if (!fh) {
    *err = IoError::kOpen;
    return nullptr;
  }
  std::fseek(fh, 0, SEEK_END);
  long size = std::ftell(fh);
  std::fseek(fh, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(fh);
    *err = IoError::kRead;
    return nullptr;
  }
  char *buf = static_cast<char *>(std::malloc(static_cast<size_t>(size) + 1));
  if (!buf) {
    std::fclose(fh);
    *err = IoError::kNoMemory;
    return nullptr;
  }
  size_t got = std::fread(buf, 1, static_cast<size_t>(size), fh);
  bool bad = (got != static_cast<size_t>(size)) || std::ferror(fh);
  std::fclose(fh);
  if (bad) {  // a TRUNCATED buffer must not parse as success
    std::free(buf);
    *err = IoError::kRead;
    return nullptr;
  }
  buf[got] = '\0';
  *size_out = got;
  return buf;
}

// Replace the non-whitespace separators the reference's datasets use
// (';' in Bunny.csv, ',' defensively) so the strto*_l calls can walk the
// buffer.
void normalize_separators(char *buf, size_t size) {
  for (size_t i = 0; i < size; ++i) {
    char c = buf[i];
    if (c == ';' || c == ',') buf[i] = ' ';
  }
}

bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

// Pure-C parse (GIL released by the caller). On success fills vals_out /
// count_out (caller frees vals_out); on failure returns the error kind and
// the byte offset of the offending token.
template <typename T, typename ParseFn>
IoError parse_buffer(char *buf, size_t size, ParseFn parse, T **vals_out,
                     size_t *count_out, size_t *bad_offset) {
  normalize_separators(buf, size);
  size_t cap = 1 << 16;
  size_t count = 0;
  T *vals = static_cast<T *>(std::malloc(cap * sizeof(T)));
  if (!vals) return IoError::kNoMemory;

  const char *p = buf;
  const char *end = buf + size;
  for (;;) {
    while (p < end && is_space(*p)) ++p;
    if (p >= end) break;  // clean end of tokens
    char *next = nullptr;
    errno = 0;
    bool range_bad = false;
    T v = parse(p, &next, &range_bad);
    if (next == p) {  // a non-numeric token mid-file: ERROR, not truncation
      std::free(vals);
      *bad_offset = static_cast<size_t>(p - buf);
      return IoError::kBadToken;
    }
    if (range_bad) {
      std::free(vals);
      *bad_offset = static_cast<size_t>(p - buf);
      return IoError::kRange;
    }
    if (count == cap) {
      cap *= 2;
      T *grown = static_cast<T *>(std::realloc(vals, cap * sizeof(T)));
      if (!grown) {
        std::free(vals);
        return IoError::kNoMemory;
      }
      vals = grown;
    }
    vals[count++] = v;
    p = next;
  }
  *vals_out = vals;
  *count_out = count;
  return IoError::kNone;
}

PyObject *raise_io_error(IoError err, const char *path, size_t bad_offset) {
  switch (err) {
    case IoError::kOpen:
      return PyErr_Format(PyExc_FileNotFoundError, "cannot open '%s'", path);
    case IoError::kRead:
      return PyErr_Format(PyExc_OSError, "short/failed read of '%s'", path);
    case IoError::kNoMemory:
      return PyErr_NoMemory();
    case IoError::kBadToken:
      return PyErr_Format(PyExc_ValueError,
                          "'%s': unparsable token at byte %zu", path,
                          bad_offset);
    case IoError::kRange:
      return PyErr_Format(PyExc_ValueError,
                          "'%s': token out of range at byte %zu", path,
                          bad_offset);
    default:
      return PyErr_Format(PyExc_RuntimeError, "fpcr_io internal error");
  }
}

template <typename T, typename ParseFn>
PyObject *parse_tokens(const char *path, ParseFn parse) {
  size_t size = 0;
  IoError err = IoError::kNone;
  char *buf = nullptr;
  T *vals = nullptr;
  size_t count = 0;
  size_t bad_offset = 0;

  // the whole read+parse is pure C — release the GIL so parsing the
  // 806,912-line packet dump doesn't stall other Python threads
  Py_BEGIN_ALLOW_THREADS
  buf = read_whole_file(path, &size, &err);
  if (buf) {
    err = parse_buffer<T>(buf, size, parse, &vals, &count, &bad_offset);
    std::free(buf);
  }
  Py_END_ALLOW_THREADS

  if (err != IoError::kNone) return raise_io_error(err, path, bad_offset);

  PyObject *bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(vals),
      static_cast<Py_ssize_t>(count * sizeof(T)));
  std::free(vals);
  return bytes;
}

PyObject *py_parse_floats(PyObject *, PyObject *args) {
  const char *path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  return parse_tokens<float>(
      path, [](const char *p, char **next, bool *range_bad) {
        errno = 0;
        float v = strtof_l(p, next, c_locale());
        // ERANGE on underflow returns a denormal/0 — acceptable; only
        // overflow (±HUGE_VALF) silently fabricates geometry
        *range_bad = (errno == ERANGE && std::isinf(v));
        return v;
      });
}

PyObject *py_parse_ints(PyObject *, PyObject *args) {
  const char *path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  return parse_tokens<long long>(
      path, [](const char *p, char **next, bool *range_bad) {
        errno = 0;
        long long v = strtoll_l(p, next, 10, c_locale());
        *range_bad = (errno == ERANGE);
        return v;
      });
}

PyMethodDef kMethods[] = {
    {"parse_floats", py_parse_floats, METH_VARARGS,
     "Parse all float tokens in a file -> little-endian f32 bytes."},
    {"parse_ints", py_parse_ints, METH_VARARGS,
     "Parse all integer tokens in a file -> little-endian i64 bytes."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_fpcr_io",
    "Native CSV/packet tokenizers for fpcr_tpu's data layer.", -1, kMethods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__fpcr_io(void) { return PyModule_Create(&kModule); }
