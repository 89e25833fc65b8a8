// C ABI for pcodec_tpu_torch — the pco_c equivalent.
//
// Mirrors the reference's caller-allocates C surface
// (ref: pco_c/src/lib.rs:128-195, pco_c/include/cpcodec_generated.h):
//   pco_standalone_guarantee_file_size
//   pco_standalone_simple_compress_into
//   pco_standalone_simple_decompress_into
// plus init/teardown. The reference's pco_c is a thin wrapper over the Rust
// core; this is the same thin wrapper over the pcodec_tpu_torch runtime via
// an embedded CPython interpreter (the codec core is Python, PyTorch, CUDA
// kernels and C++ host kernels). Decompression runs on the card (capi.py:
// K1-K4 through the standalone plan); a process without a CUDA device gets
// PCO_DECOMPRESSION_ERROR. The first decode builds the CUDA kernels (nvcc)
// into the repository's build/pcodec_tpu_torch/, reused by later processes.
//
// Build: g++ -O2 -shared -fPIC cpcodec.cpp $(python3-config --includes) \
//            $(python3-config --ldflags --embed) -o libcpcodec.so
// Header: cpcodec.h. Test: test_cpcodec.c.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>

#include "cpcodec.h"

static std::once_flag g_init_once;
static PyObject* g_mod = nullptr;  // pcodec_tpu_torch.capi

static void ensure_init() {
  std::call_once(g_init_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    g_mod = PyImport_ImportModule("pcodec_tpu_torch.capi");
    if (!g_mod) {
      PyErr_Print();
    }
    PyGILState_Release(gil);
  });
}

extern "C" {

int pco_init(void) {
  ensure_init();
  return g_mod ? PCO_SUCCESS : PCO_INVALID_ARGUMENT;
}

size_t pco_standalone_guarantee_file_size(unsigned char number_type_byte,
                                          size_t n) {
  ensure_init();
  if (!g_mod) return 0;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g_mod, "guarantee_file_size", "bn",
                                    number_type_byte, (Py_ssize_t)n);
  size_t out = 0;
  if (r) {
    out = (size_t)PyLong_AsSize_t(r);
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  PyGILState_Release(gil);
  return out;
}

int pco_standalone_simple_compress_into(
    const void* src, size_t n, unsigned char number_type_byte,
    unsigned int compression_level, unsigned char* dst, size_t dst_capacity,
    size_t* dst_written) {
  ensure_init();
  if (!g_mod || !src || !dst || !dst_written) return PCO_INVALID_ARGUMENT;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r2 = PyObject_CallMethod(
      g_mod, "simple_compress_ptr", "KnbI", (unsigned long long)(uintptr_t)src,
      (Py_ssize_t)n, number_type_byte, compression_level);
  int code = PCO_INVALID_ARGUMENT;
  if (r2 && PyBytes_Check(r2)) {
    size_t len = (size_t)PyBytes_GET_SIZE(r2);
    if (len <= dst_capacity) {
      std::memcpy(dst, PyBytes_AS_STRING(r2), len);
      *dst_written = len;
      code = PCO_SUCCESS;
    } else {
      code = PCO_INSUFFICIENT_DATA;
    }
  } else if (!r2) {
    PyErr_Print();
    code = PCO_COMPRESSION_ERROR;
  }
  Py_XDECREF(r2);
  PyGILState_Release(gil);
  return code;
}

int pco_standalone_simple_decompress_into(
    const unsigned char* src, size_t src_len, unsigned char number_type_byte,
    void* dst, size_t dst_capacity_elems, size_t* n_written) {
  ensure_init();
  if (!g_mod || !src || !dst || !n_written) return PCO_INVALID_ARGUMENT;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(
      g_mod, "simple_decompress_ptr", "y#bKn", (const char*)src,
      (Py_ssize_t)src_len, number_type_byte,
      (unsigned long long)(uintptr_t)dst, (Py_ssize_t)dst_capacity_elems);
  int code = PCO_INVALID_ARGUMENT;
  if (r && PyLong_Check(r)) {
    long long wrote = PyLong_AsLongLong(r);
    if (wrote >= 0) {
      *n_written = (size_t)wrote;
      code = PCO_SUCCESS;
    } else {
      code = (int)-wrote;  // negative python result encodes the error code
    }
  } else if (!r) {
    PyErr_Print();
    code = PCO_DECOMPRESSION_ERROR;
  }
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return code;
}

int pco_standalone_simple_decompress_alloc(
    const unsigned char* src, size_t src_len, unsigned char* out_type_byte,
    void** out_data, size_t* out_n) {
  ensure_init();
  if (!g_mod || !src || !out_type_byte || !out_data || !out_n)
    return PCO_INVALID_ARGUMENT;
  *out_data = nullptr;
  *out_n = 0;
  *out_type_byte = 0;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g_mod, "peek_and_decompress", "y#",
                                    (const char*)src, (Py_ssize_t)src_len);
  int code = PCO_DECOMPRESSION_ERROR;
  if (r && PyTuple_Check(r) && PyTuple_GET_SIZE(r) == 2) {
    long tb = PyLong_AsLong(PyTuple_GET_ITEM(r, 0));
    PyObject* data = PyTuple_GET_ITEM(r, 1);
    if (tb > 0 && PyBytes_Check(data)) {
      // element size from the type byte (dtypes.py NUMBER_TYPE_BYTE, same
      // values as ref: pco/src/data_types/{signed,unsigned,float}.rs):
      // u32=1 u64=2 i32=3 i64=4 f32=5 f64=6 u16=7 i16=8 f16=9 u8=10 i8=11
      size_t esize;
      switch (tb) {
        case 10: case 11: esize = 1; break;           /* u8, i8 */
        case 7: case 8: case 9: esize = 2; break;     /* u16, i16, f16 */
        case 1: case 3: case 5: esize = 4; break;     /* u32, i32, f32 */
        default: esize = 8; break;                    /* u64, i64, f64 */
      }
      size_t len = (size_t)PyBytes_GET_SIZE(data);
      void* buf = malloc(len ? len : 1);
      if (buf) {
        std::memcpy(buf, PyBytes_AS_STRING(data), len);
        *out_data = buf;
        *out_n = len / esize;
        *out_type_byte = (unsigned char)tb;
        code = PCO_SUCCESS;
      }
    } else if (tb == 0) {
      code = PCO_SUCCESS;  // empty file: type unknowable
    }
  } else if (!r) {
    PyErr_Print();
  }
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return code;
}

void pco_free(void* p) { free(p); }

}  // extern "C"
