/*!
 * Shared scaffolding for the C ABI translation units (c_api.cc,
 * c_predict_api.cc): embedded-interpreter bootstrap, GIL guard, thread-local
 * error + stable-address return arena (reference analogue:
 * src/c_api/c_api_error.cc and the thread-local return stores in c_api.cc).
 * C++17 inline variables let both TUs share one definition when linked into
 * the same shared object.
 */
#ifndef MXTPU_C_API_COMMON_H_
#define MXTPU_C_API_COMMON_H_

#include <Python.h>

#include <cstdint>
#include <deque>
#include <mutex>
#include <set>
#include <string>
#include <vector>

namespace mxtpu_capi {

inline thread_local std::string last_error;

/* Stable-address return storage: deques never move elements on push_back,
 * so pointers handed to the caller stay valid until the next API call on
 * this thread that returns pointers. */
struct ReturnArena {
  std::deque<std::string> strs;
  std::deque<std::vector<const char *>> cstr_arrays;
  std::deque<std::vector<uint32_t>> uint_arrays;
  std::deque<std::vector<const uint32_t *>> uintptr_arrays;
  std::deque<std::vector<void *>> handle_arrays;
  std::deque<std::vector<int>> int_arrays;
  std::deque<std::vector<uint64_t>> u64_arrays;
  std::deque<std::vector<float>> float_arrays;
  void clear() {
    strs.clear(); cstr_arrays.clear(); uint_arrays.clear();
    uintptr_arrays.clear(); handle_arrays.clear(); int_arrays.clear();
    u64_arrays.clear(); float_arrays.clear();
  }
};
inline thread_local ReturnArena arena;

inline std::set<std::string> &InternedSet() {
  static std::set<std::string> s;
  return s;
}
inline std::mutex &InternedMu() {
  static std::mutex mu;
  return mu;
}
inline const char *Intern(const std::string &s) {
  std::lock_guard<std::mutex> lk(InternedMu());
  return InternedSet().insert(s).first->c_str();
}

inline void EnsurePython() {
  static std::once_flag once;
  std::call_once(once, []() {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      PyEval_SaveThread();  // release the GIL taken by initialization
    }
  });
}

class Gil {
 public:
  Gil() { EnsurePython(); state_ = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(state_); }
 private:
  PyGILState_STATE state_;
};

/* Message CaptureError assigns for a clean SystemExit(0) crossing the
 * ABI — the kvstore server/scheduler end-of-job path
 * (kvstore_server.py sys.exit(0)).  Frontends match THIS sentinel to
 * distinguish normal job completion from real bridge failures. */
constexpr const char *kEndOfJobError = "mxnet-tpu: end of job (SystemExit 0)";

inline void CaptureError() {
  PyObject *ptype, *pvalue, *ptrace;
  PyErr_Fetch(&ptype, &pvalue, &ptrace);
  PyErr_NormalizeException(&ptype, &pvalue, &ptrace);
  last_error = "unknown python error";
  if (pvalue != nullptr) {
    bool clean_exit = false;
    if (ptype != nullptr &&
        PyErr_GivenExceptionMatches(ptype, PyExc_SystemExit)) {
      PyObject *code = PyObject_GetAttrString(pvalue, "code");
      if (code != nullptr) {
        clean_exit = (code == Py_None) ||
                     (PyLong_Check(code) && PyLong_AsLong(code) == 0);
        Py_DECREF(code);
      }
      PyErr_Clear();  // GetAttrString may set its own error
    }
    if (clean_exit) {
      last_error = kEndOfJobError;
    } else {
      PyObject *s = PyObject_Str(pvalue);
      if (s != nullptr) {
        const char *msg = PyUnicode_AsUTF8(s);
        if (msg != nullptr) last_error = msg;
        Py_DECREF(s);
      }
    }
  }
  Py_XDECREF(ptype); Py_XDECREF(pvalue); Py_XDECREF(ptrace);
}

/* Call mxnet_tpu_torch.capi_bridge.<fn>(*args); steals `args` (which may be NULL
 * on allocation failure). Returns new ref or NULL with last_error set. */
inline PyObject *BridgeCall(const char *fn, PyObject *args) {
  static PyObject *bridge = nullptr;
  if (bridge == nullptr) {
    bridge = PyImport_ImportModule("mxnet_tpu_torch.capi_bridge");
    if (bridge == nullptr) { CaptureError(); Py_XDECREF(args); return nullptr; }
  }
  if (args == nullptr) { CaptureError(); return nullptr; }
  PyObject *f = PyObject_GetAttrString(bridge, fn);
  if (f == nullptr) { CaptureError(); Py_DECREF(args); return nullptr; }
  PyObject *ret = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_DECREF(args);
  if (ret == nullptr) CaptureError();
  return ret;
}

inline int64_t H(const void *handle) {
  return static_cast<int64_t>(reinterpret_cast<intptr_t>(handle));
}
inline void *ToHandle(int64_t id) {
  return reinterpret_cast<void *>(static_cast<intptr_t>(id));
}

inline PyObject *IntList(const int64_t *data, size_t n) {
  PyObject *l = PyList_New(n);
  for (size_t i = 0; i < n; ++i)
    PyList_SetItem(l, i, PyLong_FromLongLong(data[i]));
  return l;
}
inline PyObject *HandleList(void *const *h, size_t n) {
  PyObject *l = PyList_New(n);
  for (size_t i = 0; i < n; ++i)
    PyList_SetItem(l, i, PyLong_FromLongLong(h == nullptr ? 0 : H(h[i])));
  return l;
}
inline PyObject *UIntList(const uint32_t *d, size_t n) {
  PyObject *l = PyList_New(n);
  for (size_t i = 0; i < n; ++i)
    PyList_SetItem(l, i, PyLong_FromUnsignedLong(d[i]));
  return l;
}
inline PyObject *CIntList(const int *d, size_t n) {
  PyObject *l = PyList_New(n);
  for (size_t i = 0; i < n; ++i)
    PyList_SetItem(l, i, PyLong_FromLong(d[i]));
  return l;
}
inline PyObject *FloatList(const float *d, size_t n) {
  PyObject *l = PyList_New(n);
  for (size_t i = 0; i < n; ++i)
    PyList_SetItem(l, i, PyFloat_FromDouble(d[i]));
  return l;
}
inline PyObject *StrList(const char **d, size_t n) {
  PyObject *l = PyList_New(n);
  for (size_t i = 0; i < n; ++i)
    PyList_SetItem(l, i, PyUnicode_FromString(d == nullptr ? "" : d[i]));
  return l;
}

/* Copy a python list[str] into the arena; returns const char** */
inline const char **ArenaStrArray(PyObject *list, uint32_t *out_size) {
  arena.cstr_arrays.emplace_back();
  auto &ptrs = arena.cstr_arrays.back();
  Py_ssize_t n = PyList_Size(list);
  for (Py_ssize_t i = 0; i < n; ++i) {
    arena.strs.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(list, i)));
    ptrs.push_back(arena.strs.back().c_str());
  }
  *out_size = static_cast<uint32_t>(n);
  return ptrs.data();
}

inline void **ArenaHandleArray(PyObject *list, uint32_t *out_size) {
  arena.handle_arrays.emplace_back();
  auto &ptrs = arena.handle_arrays.back();
  Py_ssize_t n = PyList_Size(list);
  for (Py_ssize_t i = 0; i < n; ++i)
    ptrs.push_back(ToHandle(PyLong_AsLongLong(PyList_GetItem(list, i))));
  *out_size = static_cast<uint32_t>(n);
  return ptrs.data();
}

/* Expand list[list[int]] into (ndim array, data-pointer array) pairs the
 * way MXSymbolInferShape returns shapes. */
inline void ArenaShapeGroup(PyObject *group, uint32_t *size,
                            const uint32_t **ndims, const uint32_t ***data) {
  Py_ssize_t n = PyList_Size(group);
  arena.uint_arrays.emplace_back();           // ndim array
  auto &nd = arena.uint_arrays.back();
  arena.uintptr_arrays.emplace_back();        // per-shape data ptr array
  auto &dp = arena.uintptr_arrays.back();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *shape = PyList_GetItem(group, i);
    Py_ssize_t ndim = PyList_Size(shape);
    arena.uint_arrays.emplace_back();
    auto &sd = arena.uint_arrays.back();
    for (Py_ssize_t j = 0; j < ndim; ++j)
      sd.push_back(static_cast<uint32_t>(
          PyLong_AsUnsignedLong(PyList_GetItem(shape, j))));
    nd.push_back(static_cast<uint32_t>(ndim));
    dp.push_back(sd.data());
  }
  *size = static_cast<uint32_t>(n);
  *ndims = nd.data();
  *data = dp.data();
}

/* Convert a CSR-encoded shape batch (indptr + flat dims, the MXSymbolInfer-
 * Shape / MXPredCreate input convention) into a Python list-of-lists. */
inline PyObject *ShapesFromCSR(uint32_t num, const uint32_t *indptr,
                               const uint32_t *data) {
  PyObject *shapes = PyList_New(num);
  for (uint32_t i = 0; i < num; ++i) {
    uint32_t lo = indptr[i], hi = indptr[i + 1];
    PyObject *s = PyList_New(hi - lo);
    for (uint32_t j = lo; j < hi; ++j)
      PyList_SetItem(s, j - lo, PyLong_FromUnsignedLong(data[j]));
    PyList_SetItem(shapes, i, s);
  }
  return shapes;
}

/* Shared body of MXListFunctions/MXSymbolListAtomicSymbolCreators/
 * MXListDataIters: fetch a list[str] of registry names from the bridge and
 * return them as interned stable pointers usable as opaque creator handles. */
inline int InternedListCall(const char *bridge_fn, uint32_t *out_size,
                            const void ***out_array) {
  PyObject *ret = BridgeCall(bridge_fn, PyTuple_New(0));
  if (ret == nullptr) return -1;
  arena.clear();
  arena.handle_arrays.emplace_back();
  auto &ptrs = arena.handle_arrays.back();
  Py_ssize_t n = PyList_Size(ret);
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char *name = PyUnicode_AsUTF8(PyList_GetItem(ret, i));
    ptrs.push_back(const_cast<char *>(Intern(name == nullptr ? "" : name)));
  }
  Py_DECREF(ret);
  *out_size = static_cast<uint32_t>(n);
  *out_array = const_cast<const void **>(
      reinterpret_cast<void **>(ptrs.data()));
  return 0;
}

inline int ReturnHandleImpl(PyObject *ret, void **out) {
  if (ret == nullptr) return -1;
  *out = ToHandle(PyLong_AsLongLong(ret));
  Py_DECREF(ret);
  return 0;
}

inline int ReturnStringImpl(PyObject *ret, const char **out) {
  if (ret == nullptr) return -1;
  arena.clear();
  arena.strs.emplace_back(PyUnicode_AsUTF8(ret));
  *out = arena.strs.back().c_str();
  Py_DECREF(ret);
  return 0;
}

}  // namespace mxtpu_capi

#define API_BEGIN() ::mxtpu_capi::Gil gil_; try {
#define API_END()                                               \
  } catch (const std::exception &e) {                           \
    ::mxtpu_capi::last_error = e.what(); return -1;             \
  }                                                             \
  return 0;
#define CHECK_CALL(expr)                                        \
  do { PyObject *r_ = (expr);                                   \
       if (r_ == nullptr) return -1;                            \
       Py_DECREF(r_); } while (0)

#endif  /* MXTPU_C_API_COMMON_H_ */
