// The inference C ABI over the port's Predictor: the counterpart of
// paddle_tpu/core_native/c_api.cc, name for name and return code for
// return code, and of Paddle's inference C API
// (paddle/fluid/inference/capi/c_api.cc) that its Go and R bindings wrap.
// Any FFI-capable language (C, Go cgo, R .C, Rust) links this library and
// serves an exported model (inference.save_inference_model: <prefix>.pt2
// + <prefix>.json) with no Python in its own source: the interpreter is
// embedded behind the ABI.  The model runs on the device it was exported
// on; its kernels launch on the card inside PT_PredictorRun.
//
// Surface:
//   PT_Init(repo_path)            – start the embedded interpreter and put
//                                   repo_path on sys.path (no-op when the
//                                   host already runs Python)
//   PT_NewPredictor(prefix)       – load <prefix>.pt2 + manifest; NULL and
//                                   the last error on a bad prefix
//   PT_PredictorRun(...)          – one f32 input -> one f32 output
//   PT_DeletePredictor, PT_GetLastError
//
// Host C++, built by g++ (paddle_tpu_torch.core_native.build_c_api) into
// paddle_tpu_torch/_build/:
//   g++ -O2 -shared -fPIC -std=c++17 c_api.cc $(python3-config --includes)
//       -o libpaddle_tpu_torch_c.so
//   (+ $(python3-config --embed --ldflags) for a pure-C host; inside a
//   Python process the symbols resolve against the running interpreter)

#include <Python.h>

#include <cstdint>
#include <mutex>
#include <string>

namespace {

std::mutex g_err_mu;
std::string g_last_error;

void set_error(const std::string& msg) {
  std::lock_guard<std::mutex> lk(g_err_mu);
  g_last_error = msg;
}

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    const char* text = s ? PyUnicode_AsUTF8(s) : nullptr;
    if (text) msg = text;
    Py_XDECREF(s);
  }
  PyErr_Clear();
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

struct GIL {
  PyGILState_STATE st;
  GIL() : st(PyGILState_Ensure()) {}
  ~GIL() { PyGILState_Release(st); }
};

}  // namespace

extern "C" {

typedef struct PT_Predictor {
  PyObject* pred;    // paddle_tpu_torch.inference.Predictor
  PyObject* bridge;  // paddle_tpu_torch.inference.c_bridge module
} PT_Predictor;

const char* PT_GetLastError() {
  std::lock_guard<std::mutex> lk(g_err_mu);
  return g_last_error.c_str();
}

// Bootstrap for pure-C hosts: start the embedded interpreter and put
// `repo_path` on sys.path.  The interpreter's lock is released before
// returning, so any thread of the host may call PT_* after this.  When
// the host process already runs Python (ctypes, or Go loaded into a
// Python service), only the sys.path entry is added.
int PT_Init(const char* repo_path) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    PyEval_SaveThread();
  }
  GIL gil;
  if (repo_path && *repo_path) {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* p = PyUnicode_FromString(repo_path);
    if (!sys_path || !p || PyList_Insert(sys_path, 0, p) != 0) {
      Py_XDECREF(p);
      set_error_from_python();
      return -1;
    }
    Py_DECREF(p);
  }
  return 0;
}

PT_Predictor* PT_NewPredictor(const char* model_prefix) {
  if (!model_prefix) {
    set_error("bad arguments");
    return nullptr;
  }
  GIL gil;
  PyObject* bridge =
      PyImport_ImportModule("paddle_tpu_torch.inference.c_bridge");
  if (!bridge) {
    set_error_from_python();
    return nullptr;
  }
  PyObject* pred = PyObject_CallMethod(bridge, "new_predictor", "s",
                                       model_prefix);
  if (!pred) {
    Py_DECREF(bridge);
    set_error_from_python();
    return nullptr;
  }
  return new PT_Predictor{pred, bridge};
}

void PT_DeletePredictor(PT_Predictor* h) {
  if (!h) return;
  GIL gil;
  Py_XDECREF(h->pred);
  Py_XDECREF(h->bridge);
  delete h;
}

// Run one float32 input through the model.  `out_buf` must hold
// `out_capacity` floats; the real element count lands in *out_count and
// the shape (up to 8 dims) in out_shape/out_ndim.  Returns 0 on
// success, -1 on error (PT_GetLastError), -2 if out_buf is too small
// (with *out_count set to the required size).  The input is read in
// place and the output copied once, from the device straight into
// out_buf (inference.c_bridge.run_f32_into).
int PT_PredictorRun(PT_Predictor* h, const float* data,
                    const int64_t* shape, int ndim, float* out_buf,
                    int64_t out_capacity, int64_t* out_count,
                    int64_t* out_shape, int* out_ndim) {
  if (!h || !data || !shape || ndim <= 0) {
    set_error("bad arguments");
    return -1;
  }
  GIL gil;
  PyObject* shp = PyList_New(ndim);
  if (!shp) {
    set_error_from_python();
    return -1;
  }
  for (int i = 0; i < ndim; ++i) {
    PyObject* d = PyLong_FromLongLong(shape[i]);
    if (!d) {
      Py_DECREF(shp);
      set_error_from_python();
      return -1;
    }
    PyList_SET_ITEM(shp, i, d);  // steals d
  }
  PyObject* res = PyObject_CallMethod(
      h->bridge, "run_f32_into", "OKOKL", h->pred,
      (unsigned long long)(uintptr_t)data, shp,
      (unsigned long long)(uintptr_t)out_buf,
      (long long)(out_buf ? out_capacity : 0));
  Py_DECREF(shp);
  if (!res) {
    set_error_from_python();
    return -1;
  }
  // res = (count, [dims...]); the bridge wrote the output into out_buf
  // when it fit
  PyObject* pcount = PyTuple_Check(res) ? PyTuple_GetItem(res, 0) : nullptr;
  PyObject* oshape = PyTuple_Check(res) ? PyTuple_GetItem(res, 1) : nullptr;
  if (!pcount || !oshape || !PyList_Check(oshape)) {
    if (PyErr_Occurred()) set_error_from_python();
    else set_error("run_f32_into returned no (count, shape)");
    Py_DECREF(res);
    return -1;
  }
  int64_t count = PyLong_AsLongLong(pcount);
  if (out_count) *out_count = count;
  int nd = (int)PyList_Size(oshape);
  if (out_ndim) *out_ndim = nd;
  if (out_shape) {
    for (int i = 0; i < nd && i < 8; ++i) {
      out_shape[i] = PyLong_AsLongLong(PyList_GetItem(oshape, i));
    }
  }
  Py_DECREF(res);
  if (count > out_capacity || (count > 0 && !out_buf)) {
    set_error("output buffer too small");
    return -2;
  }
  return 0;
}

}  // extern "C"
