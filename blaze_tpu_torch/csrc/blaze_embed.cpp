// In-process embedding of the blaze-tpu engine behind a C ABI.
//
// Role parity: the reference ships libblaze.so, which a JVM host loads
// and drives through two JNI entry points; finished batches cross as
// Arrow C-Data pointer pairs in the SAME process (exec.rs:118-255,
// NativeSupports.scala:241-323). Here the engine tier is Python/PyTorch, so
// this library hosts CPython inside the embedder process and exposes
// the same surface:
//
//   blz_embed_init(repo_path)        ~ JniBridge.initNative
//   blz_embed_execute(blob, len)     ~ JniBridge.callNative (decode
//                                      TaskDefinition, start stream)
//   blz_embed_next(h, schema, array) ~ the nextBatch(schemaPtr,
//                                      arrayPtr) handshake - exports
//                                      one batch as Arrow C-Data, zero
//                                      copies, zero IPC
//   blz_embed_close / blz_embed_last_error / blz_embed_shutdown
//
// Batches are produced by pyarrow's _export_to_c: the embedder receives
// raw buffer pointers owned by the engine plus a release callback, the
// exact ownership protocol FFIHelper implements on the JVM side.
//
// The port's copy of cpp/blaze_embed.cpp, with the module re-pointed to
// blaze_tpu_torch.runtime.embed. Built with blaze_embed_main.cpp by
// blaze_tpu_torch/runtime/embed.py (build_host):
//   g++ -O2 -std=c++17 blaze_embed_main.cpp blaze_embed.cpp \
//       $(python3-config --includes) $(python3-config --embed --ldflags)

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include "arrow_c_data.h"

namespace {

std::string g_error;  // guarded by the GIL: all entry points hold it
PyObject* g_module = nullptr;   // blaze_tpu_torch.runtime.embed
PyThreadState* g_main_ts = nullptr;

void set_error_from_python() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_error = "python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) g_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

struct Gil {
  PyGILState_STATE st;
  Gil() : st(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(st); }
};

}  // namespace

extern "C" {

// Returns 0 on success. repo_path is prepended to sys.path so
// blaze_tpu_torch resolves; pass nullptr if the embedder already set
// PYTHONPATH.
int blz_embed_init(const char* repo_path) {
  if (Py_IsInitialized() == 0) {
    Py_InitializeEx(0);
    g_main_ts = PyEval_SaveThread();
  }
  Gil gil;
  if (repo_path != nullptr) {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* p = PyUnicode_FromString(repo_path);
    if (sys_path == nullptr || p == nullptr ||
        PyList_Insert(sys_path, 0, p) != 0) {
      Py_XDECREF(p);
      set_error_from_python();
      return -1;
    }
    Py_DECREF(p);
  }
  PyObject* mod = PyImport_ImportModule("blaze_tpu_torch.runtime.embed");
  if (mod == nullptr) {
    set_error_from_python();
    return -1;
  }
  Py_XDECREF(g_module);
  g_module = mod;
  return 0;
}

// Decode + start a TaskDefinition; returns an opaque stream handle or
// nullptr (see blz_embed_last_error).
void* blz_embed_execute(const uint8_t* blob, int64_t len) {
  Gil gil;
  if (g_module == nullptr) {
    g_error = "blz_embed_init not called";
    return nullptr;
  }
  PyObject* bytes =
      PyBytes_FromStringAndSize(reinterpret_cast<const char*>(blob),
                                static_cast<Py_ssize_t>(len));
  if (bytes == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  PyObject* stream =
      PyObject_CallMethod(g_module, "open_stream", "O", bytes);
  Py_DECREF(bytes);
  if (stream == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  return stream;  // new reference carried by the handle
}

// 1 = batch exported into (schema, array); 0 = end of stream;
// -1 = error. The caller owns the structs' release callbacks.
int blz_embed_next(void* handle, struct ArrowSchema* schema,
                   struct ArrowArray* array) {
  Gil gil;
  if (handle == nullptr || g_module == nullptr) {
    g_error = "bad handle";
    return -1;
  }
  memset(schema, 0, sizeof(*schema));
  memset(array, 0, sizeof(*array));
  PyObject* r = PyObject_CallMethod(
      g_module, "export_next", "OKK", static_cast<PyObject*>(handle),
      static_cast<unsigned long long>(
          reinterpret_cast<uintptr_t>(schema)),
      static_cast<unsigned long long>(
          reinterpret_cast<uintptr_t>(array)));
  if (r == nullptr) {
    set_error_from_python();
    return -1;
  }
  long got = PyLong_AsLong(r);
  Py_DECREF(r);
  return got == 1 ? 1 : 0;
}

void blz_embed_close(void* handle) {
  if (handle == nullptr) return;
  Gil gil;
  Py_DECREF(static_cast<PyObject*>(handle));
}

const char* blz_embed_last_error(void) { return g_error.c_str(); }

void blz_embed_shutdown(void) {
  if (g_main_ts != nullptr) {
    PyEval_RestoreThread(g_main_ts);
    Py_XDECREF(g_module);
    g_module = nullptr;
    Py_Finalize();
    g_main_ts = nullptr;
  }
}

}  // extern "C"
