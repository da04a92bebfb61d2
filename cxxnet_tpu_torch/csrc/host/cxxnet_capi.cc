/*!
 * C ABI implementation for the PyTorch port: embedded-CPython
 * forwarding to cxxnet_tpu_torch.capi_shim (see cxxnet_capi.h for the
 * contract, the same CXN* functions as the JAX package's library).
 *
 * Design: the reference's wrapper (cxxnet_wrapper.cc) linked the whole
 * C++ engine into the shared object; here the engine is PyTorch and the
 * port's kernels, so the native binding is an embedded interpreter
 * owning the framework, with the C layer doing handle + buffer
 * marshalling only.
 *
 * Linking: the library leaves the Python C API's symbols undefined and
 * takes them from the process that loads it — a Python interpreter that
 * opens it with ctypes (its own interpreter, never a second copy of
 * libpython), or a C host linked against libpython (capi_smoke.c).
 * cxxnet_tpu_torch/ops/_build.py builds both.
 * Each handle owns: the Python object, plus references to the arrays /
 * strings most recently returned through it (keeps the C pointers
 * alive until the next call on the same handle — the reference's
 * temp-buffer lifetime rule).
 *
 * Threading: every entry point takes the GIL (PyGILState_Ensure), so
 * the ABI is safe to call from any host thread; calls serialize on the
 * interpreter, which matches the single-stream trainer model.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "cxxnet_capi.h"

#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

struct Handle {
  PyObject *obj = nullptr;        // DataIter or Net instance
  PyObject *kept_data = nullptr;  // last data array returned
  PyObject *kept_label = nullptr; // last label/weight/pred array
  std::string kept_str;           // last evaluate() line
};

std::once_flag g_init_once;
PyObject *g_shim = nullptr;  // cxxnet_tpu_torch.capi_shim module

void init_interpreter() {
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    we_initialized = true;
  }
  PyGILState_STATE st = PyGILState_Ensure();
  // Make the package importable relative to this shared object:
  // CXXNET_TPU_HOME names the repo root to put on sys.path.
  PyRun_SimpleString(
      "import os, sys\n"
      "try:\n"
      "    import cxxnet_tpu_torch  # already on path\n"
      "except Exception:\n"
      "    here = os.environ.get('CXXNET_TPU_HOME')\n"
      "    if here and here not in sys.path:\n"
      "        sys.path.insert(0, here)\n");
  g_shim = PyImport_ImportModule("cxxnet_tpu_torch.capi_shim");
  if (g_shim == nullptr) {
    PyErr_Print();
  }
  // release the GIL so host threads can enter via PyGILState_Ensure —
  // but ONLY the GIL that OUR Py_InitializeEx left held; if the host
  // process had Python running already (e.g. loaded via ctypes), the
  // GIL seen here is the caller's and must stay theirs
  PyGILState_Release(st);
  if (we_initialized && PyGILState_Check()) {
    PyEval_SaveThread();
  }
}

class Gil {
 public:
  Gil() {
    std::call_once(g_init_once, init_interpreter);
    st_ = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(st_); }

 private:
  PyGILState_STATE st_;
};

bool capture_error(const char *where) {
  if (!PyErr_Occurred()) return false;
  PyObject *type = nullptr, *val = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &val, &tb);
  PyObject *s = val ? PyObject_Str(val) : nullptr;
  const char *msg = s ? PyUnicode_AsUTF8(s) : nullptr;
  if (msg == nullptr) {
    PyErr_Clear();  // AsUTF8 can itself fail (e.g. lone surrogates)
    msg = "unknown python error";
  }
  g_last_error = std::string(where) + ": " + msg;
  Py_XDECREF(s);
  Py_XDECREF(type);
  Py_XDECREF(val);
  Py_XDECREF(tb);
  return true;
}

PyObject *shim_call(const char *fn, PyObject *args) {
  if (g_shim == nullptr) {
    g_last_error = "cxxnet_tpu_torch.capi_shim failed to import (set "
                   "CXXNET_TPU_HOME or PYTHONPATH to the repo root)";
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *f = PyObject_GetAttrString(g_shim, fn);
  if (f == nullptr) {
    capture_error(fn);
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (r == nullptr) capture_error(fn);
  return r;
}

// Build a numpy f32 array from a C buffer: one copy into a bytearray,
// then np.frombuffer/reshape over it.  A bytearray (not bytes) keeps the
// array writable, which torch.as_tensor expects of what it wraps.
PyObject *make_array(const float *data, const std::vector<long> &shape) {
  long n = 1;
  for (long d : shape) n *= d;
  PyObject *np = PyImport_ImportModule("numpy");
  if (np == nullptr) return nullptr;
  PyObject *bytes =
      PyByteArray_FromStringAndSize(reinterpret_cast<const char *>(data),
                                    n * static_cast<long>(sizeof(float)));
  PyObject *frombuffer = PyObject_GetAttrString(np, "frombuffer");
  PyObject *arr =
      PyObject_CallFunction(frombuffer, "Os", bytes, "float32");
  Py_XDECREF(frombuffer);
  Py_XDECREF(bytes);
  Py_DECREF(np);
  if (arr == nullptr) return nullptr;
  PyObject *shp = PyTuple_New(shape.size());
  for (size_t i = 0; i < shape.size(); ++i) {
    PyTuple_SET_ITEM(shp, i, PyLong_FromLong(shape[i]));
  }
  PyObject *reshaped = PyObject_CallMethod(arr, "reshape", "O", shp);
  Py_DECREF(shp);
  Py_DECREF(arr);
  return reshaped;
}

const float *array_data(PyObject *arr) {
  // C-contiguous float32 guaranteed by the shim's _c_f32
  PyObject *iface = PyObject_GetAttrString(arr, "ctypes");
  if (iface == nullptr) return nullptr;
  PyObject *ptr = PyObject_GetAttrString(iface, "data");
  Py_DECREF(iface);
  if (ptr == nullptr) return nullptr;
  const float *p =
      reinterpret_cast<const float *>(PyLong_AsUnsignedLongLong(ptr));
  Py_DECREF(ptr);
  return p;
}

bool array_shape(PyObject *arr, unsigned *out, int want_nd) {
  PyObject *shp = PyObject_GetAttrString(arr, "shape");
  if (shp == nullptr) return false;
  Py_ssize_t nd = PyTuple_Size(shp);
  for (int i = 0; i < want_nd; ++i) {
    out[i] = 1;
  }
  // right-align trailing dims (e.g. (n, d) label into oshape[2])
  for (Py_ssize_t i = 0; i < nd && i < want_nd; ++i) {
    out[i] = static_cast<unsigned>(
        PyLong_AsLong(PyTuple_GetItem(shp, i)));
  }
  Py_DECREF(shp);
  return true;
}

}  // namespace

extern "C" {

const char *CXNGetLastError(void) { return g_last_error.c_str(); }

/* ------------------------------------------------------ data iterator */
void *CXNIOCreateFromConfig(const char *cfg) {
  Gil gil;
  PyObject *r = shim_call("io_create", Py_BuildValue("(s)", cfg));
  if (r == nullptr) return nullptr;
  Handle *h = new Handle();
  h->obj = r;
  return h;
}

int CXNIONext(void *handle) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = shim_call("io_next", Py_BuildValue("(O)", h->obj));
  if (r == nullptr) return -1;
  int v = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return v;
}

void CXNIOBeforeFirst(void *handle) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = shim_call("io_before_first", Py_BuildValue("(O)", h->obj));
  Py_XDECREF(r);
}

const cxx_real_t *CXNIOGetData(void *handle, cxx_uint oshape[4],
                               cxx_uint *ostride) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = shim_call("io_get_data", Py_BuildValue("(O)", h->obj));
  if (r == nullptr) return nullptr;
  Py_XDECREF(h->kept_data);
  h->kept_data = r;
  array_shape(r, oshape, 4);
  if (ostride) *ostride = oshape[1] * oshape[2] * oshape[3];
  return array_data(r);
}

const cxx_real_t *CXNIOGetLabel(void *handle, cxx_uint oshape[2],
                                cxx_uint *ostride) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = shim_call("io_get_label", Py_BuildValue("(O)", h->obj));
  if (r == nullptr) return nullptr;
  Py_XDECREF(h->kept_label);
  h->kept_label = r;
  array_shape(r, oshape, 2);
  if (ostride) *ostride = oshape[1];
  return array_data(r);
}

void CXNIOFree(void *handle) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  Py_XDECREF(h->obj);
  Py_XDECREF(h->kept_data);
  Py_XDECREF(h->kept_label);
  delete h;
}

/* -------------------------------------------------------------- net */
void *CXNNetCreate(const char *device, const char *cfg) {
  Gil gil;
  PyObject *r = shim_call(
      "net_create",
      device ? Py_BuildValue("(ss)", device, cfg)
             : Py_BuildValue("(Os)", Py_None, cfg));
  if (r == nullptr) return nullptr;
  Handle *h = new Handle();
  h->obj = r;
  return h;
}

void CXNNetFree(void *handle) { CXNIOFree(handle); }

static int void_call(const char *fn, PyObject *args) {
  PyObject *r = shim_call(fn, args);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int CXNNetSetParam(void *handle, const char *name, const char *val) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  return void_call("net_set_param",
                   Py_BuildValue("(Oss)", h->obj, name, val));
}

int CXNNetInitModel(void *handle) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  return void_call("net_init_model", Py_BuildValue("(O)", h->obj));
}

int CXNNetSaveModel(void *handle, const char *fname) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  return void_call("net_save_model", Py_BuildValue("(Os)", h->obj, fname));
}

int CXNNetLoadModel(void *handle, const char *fname) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  return void_call("net_load_model", Py_BuildValue("(Os)", h->obj, fname));
}

int CXNNetStartRound(void *handle, int round) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  return void_call("net_start_round", Py_BuildValue("(Oi)", h->obj, round));
}

int CXNNetUpdateBatch(void *handle, const cxx_real_t *p_data,
                      const cxx_uint dshape[4], const cxx_real_t *p_label,
                      const cxx_uint lshape[2]) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *d = make_array(
      p_data, {static_cast<long>(dshape[0]), static_cast<long>(dshape[1]),
               static_cast<long>(dshape[2]), static_cast<long>(dshape[3])});
  PyObject *l = make_array(
      p_label,
      {static_cast<long>(lshape[0]), static_cast<long>(lshape[1])});
  if (d == nullptr || l == nullptr) {
    capture_error("net_update_batch");
    Py_XDECREF(d);
    Py_XDECREF(l);
    return -1;
  }
  int rc = void_call("net_update_batch",
                     Py_BuildValue("(OOO)", h->obj, d, l));
  Py_DECREF(d);
  Py_DECREF(l);
  return rc;
}

int CXNNetUpdateIter(void *handle, void *data_handle) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  Handle *it = static_cast<Handle *>(data_handle);
  return void_call("net_update_iter",
                   Py_BuildValue("(OO)", h->obj, it->obj));
}

static const cxx_real_t *keep_pred(Handle *h, PyObject *r,
                                   cxx_uint *out_size) {
  if (r == nullptr) return nullptr;
  Py_XDECREF(h->kept_label);
  h->kept_label = r;
  unsigned shp[2] = {0, 1};
  array_shape(r, shp, 1);
  if (out_size) *out_size = shp[0];
  return array_data(r);
}

const cxx_real_t *CXNNetPredictBatch(void *handle, const cxx_real_t *p_data,
                                     const cxx_uint dshape[4],
                                     cxx_uint *out_size) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *d = make_array(
      p_data, {static_cast<long>(dshape[0]), static_cast<long>(dshape[1]),
               static_cast<long>(dshape[2]), static_cast<long>(dshape[3])});
  if (d == nullptr) {
    capture_error("net_predict_batch");
    return nullptr;
  }
  PyObject *r = shim_call("net_predict_batch",
                          Py_BuildValue("(OO)", h->obj, d));
  Py_DECREF(d);
  return keep_pred(h, r, out_size);
}

const cxx_real_t *CXNNetPredictIter(void *handle, void *data_handle,
                                    cxx_uint *out_size) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  Handle *it = static_cast<Handle *>(data_handle);
  PyObject *r = shim_call("net_predict_iter",
                          Py_BuildValue("(OO)", h->obj, it->obj));
  return keep_pred(h, r, out_size);
}

static const cxx_real_t *keep_2d(Handle *h, PyObject *r,
                                 cxx_uint oshape[2]) {
  if (r == nullptr) return nullptr;
  if (r == Py_None) {  // missing weight -> NULL (reference behavior)
    Py_DECREF(r);
    g_last_error = "no such weight";
    oshape[0] = oshape[1] = 0;
    return nullptr;
  }
  Py_XDECREF(h->kept_data);
  h->kept_data = r;
  array_shape(r, oshape, 2);
  return array_data(r);
}

const cxx_real_t *CXNNetExtractBatch(void *handle, const cxx_real_t *p_data,
                                     const cxx_uint dshape[4],
                                     const char *node_name,
                                     cxx_uint oshape[2]) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *d = make_array(
      p_data, {static_cast<long>(dshape[0]), static_cast<long>(dshape[1]),
               static_cast<long>(dshape[2]), static_cast<long>(dshape[3])});
  if (d == nullptr) {
    capture_error("net_extract_batch");
    return nullptr;
  }
  PyObject *r = shim_call("net_extract_batch",
                          Py_BuildValue("(OOs)", h->obj, d, node_name));
  Py_DECREF(d);
  return keep_2d(h, r, oshape);
}

const cxx_real_t *CXNNetExtractIter(void *handle, void *data_handle,
                                    const char *node_name,
                                    cxx_uint oshape[2]) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  Handle *it = static_cast<Handle *>(data_handle);
  PyObject *r = shim_call(
      "net_extract_iter",
      Py_BuildValue("(OOs)", h->obj, it->obj, node_name));
  return keep_2d(h, r, oshape);
}

const char *CXNNetEvaluate(void *handle, void *data_handle,
                           const char *data_name) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  Handle *it = static_cast<Handle *>(data_handle);
  PyObject *r = shim_call(
      "net_evaluate", Py_BuildValue("(OOs)", h->obj, it->obj, data_name));
  if (r == nullptr) return nullptr;
  const char *s = PyUnicode_AsUTF8(r);
  h->kept_str = s ? s : "";
  Py_DECREF(r);
  return h->kept_str.c_str();
}

int CXNNetSetWeight(void *handle, const cxx_real_t *p_weight,
                    cxx_uint size_weight, const char *layer_name,
                    const char *wtag) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *w =
      make_array(p_weight, {static_cast<long>(size_weight)});
  if (w == nullptr) {
    capture_error("net_set_weight");
    return -1;
  }
  int rc = void_call(
      "net_set_weight",
      Py_BuildValue("(OOss)", h->obj, w, layer_name, wtag));
  Py_DECREF(w);
  return rc;
}

const cxx_real_t *CXNNetGetWeight(void *handle, const char *layer_name,
                                  const char *wtag, cxx_uint oshape[2]) {
  Gil gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = shim_call(
      "net_get_weight",
      Py_BuildValue("(Oss)", h->obj, layer_name, wtag));
  return keep_2d(h, r, oshape);
}

}  // extern "C"
