/*!
 * C ABI implementation over the embedded CPython/PyTorch runtime.
 *
 * Reference analogue: src/c_api/c_api.cc — there the C ABI fronts the C++
 * core (engine/ndarray/symbol/executor); here the core is PyTorch on the
 * card, reached through the mxnet_tpu_torch Python package, so each MX*
 * call acquires the GIL and forwards to mxnet_tpu_torch.capi_bridge
 * (plain-typed functions over a process-wide handle table).  Error
 * handling mirrors src/c_api/c_api_error.cc: thread-local last-error
 * string, 0/-1 returns.  The declarations are the repository's
 * include/c_api.h, unchanged: one ABI, two implementations.
 *
 * Handles are the bridge's integer ids cast to void*; id 0 is NULL.
 */
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <unordered_map>

#include "c_api.h"
#include "c_api_common.h"

using namespace mxtpu_capi;  // NOLINT

namespace {

/* Host mirrors for MXNDArrayGetData: one buffer per (handle, byte-length),
 * refreshed in place on each call — handed-out pointers stay valid until
 * MXNDArrayFree, see updated contents like the reference's live data
 * pointer, and memory is O(1) per handle (plus one buffer per distinct
 * reshape length). */
std::unordered_map<void *, std::deque<std::string>> host_mirror;
std::mutex host_mirror_mu;

}  // namespace

const char *MXGetLastError() { return last_error.c_str(); }

int MXRandomSeed(int seed) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("random_seed", Py_BuildValue("(i)", seed)));
  API_END();
}

int MXNotifyShutdown() {
  API_BEGIN();
  CHECK_CALL(BridgeCall("notify_shutdown", PyTuple_New(0)));
  API_END();
}

/* -------------------- NDArray -------------------- */

/* shared arena-contract helpers from c_api_common.h */
static inline int ReturnHandle(PyObject *ret, void **out) {
  return ReturnHandleImpl(ret, out);
}
static inline int ReturnString(PyObject *ret, const char **out) {
  return ReturnStringImpl(ret, out);
}

int MXNDArrayCreateNone(NDArrayHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("ndarray_create_none", PyTuple_New(0)), out))
    return -1;
  API_END();
}

int MXNDArrayCreateEx(const mx_uint *shape, mx_uint ndim, int dev_type,
                      int dev_id, int delay_alloc, int dtype,
                      NDArrayHandle *out) {
  (void)delay_alloc;  // torch allocates at creation
  API_BEGIN();
  PyObject *args = Py_BuildValue("(Niii)", UIntList(shape, ndim), dev_type,
                                 dev_id, dtype);
  if (ReturnHandle(BridgeCall("ndarray_create", args), out)) return -1;
  API_END();
}

int MXNDArrayCreate(const mx_uint *shape, mx_uint ndim, int dev_type,
                    int dev_id, int delay_alloc, NDArrayHandle *out) {
  return MXNDArrayCreateEx(shape, ndim, dev_type, dev_id, delay_alloc, 0, out);
}

/* Validate `size` (an ELEMENT count) against the array and return the
 * dtype's bytes-per-element; the bridge answers both (numpy knows the
 * itemsize — no table here to drift out of sync with _DTYPE_TO_CODE).
 * MUST run before touching the caller's buffer so a wrong size becomes a
 * clean error, not an out-of-bounds read. */
static int CheckCopySize(NDArrayHandle handle, size_t size) {
  PyObject *ret = BridgeCall("ndarray_check_copy_size",
                             Py_BuildValue("(Ln)", H(handle),
                                           static_cast<Py_ssize_t>(size)));
  if (ret == nullptr) return -1;
  int itemsize = static_cast<int>(PyLong_AsLong(ret));
  Py_DECREF(ret);
  return itemsize;
}

/* `size` is the ELEMENT count, matching the reference ABI
 * (c_api.h MXNDArraySyncCopyFromCPU: "size - the memory size in elements");
 * a mismatch with the array's size is an error, never a silent clamp. */
int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const void *data,
                             size_t size) {
  API_BEGIN();
  int itemsize = CheckCopySize(handle, size);
  if (itemsize < 0) return -1;
  PyObject *bytes = PyBytes_FromStringAndSize(
      static_cast<const char *>(data),
      static_cast<Py_ssize_t>(size) * itemsize);
  CHECK_CALL(BridgeCall("ndarray_sync_copy_from",
                        Py_BuildValue("(LNn)", H(handle), bytes,
                                      static_cast<Py_ssize_t>(size))));
  API_END();
}

int MXNDArraySyncCopyToCPU(NDArrayHandle handle, void *data, size_t size) {
  API_BEGIN();
  PyObject *ret = BridgeCall("ndarray_sync_copy_to",
                             Py_BuildValue("(Ln)", H(handle),
                                           static_cast<Py_ssize_t>(size)));
  if (ret == nullptr) return -1;
  char *buf; Py_ssize_t n;
  PyBytes_AsStringAndSize(ret, &buf, &n);
  std::memcpy(data, buf, static_cast<size_t>(n));
  Py_DECREF(ret);
  API_END();
}

int MXNDArrayWaitToRead(NDArrayHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("ndarray_wait_to_read", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXNDArrayWaitToWrite(NDArrayHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("ndarray_wait_to_write", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXNDArrayWaitAll() {
  API_BEGIN();
  CHECK_CALL(BridgeCall("ndarray_wait_all", PyTuple_New(0)));
  API_END();
}

int MXNDArrayFree(NDArrayHandle handle) {
  API_BEGIN();
  {
    std::lock_guard<std::mutex> lk(host_mirror_mu);
    host_mirror.erase(handle);
  }
  CHECK_CALL(BridgeCall("free_handle", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXNDArraySlice(NDArrayHandle handle, mx_uint begin, mx_uint end,
                   NDArrayHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("ndarray_slice",
                              Py_BuildValue("(LII)", H(handle), begin, end)),
                   out))
    return -1;
  API_END();
}

int MXNDArrayAt(NDArrayHandle handle, mx_uint idx, NDArrayHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("ndarray_at",
                              Py_BuildValue("(LI)", H(handle), idx)), out))
    return -1;
  API_END();
}

int MXNDArrayReshape(NDArrayHandle handle, int ndim, int *dims,
                     NDArrayHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(LN)", H(handle), CIntList(dims, ndim));
  if (ReturnHandle(BridgeCall("ndarray_reshape", args), out)) return -1;
  API_END();
}

int MXNDArrayGetShape(NDArrayHandle handle, mx_uint *out_dim,
                      const mx_uint **out_pdata) {
  API_BEGIN();
  PyObject *ret = BridgeCall("ndarray_get_shape", Py_BuildValue("(L)", H(handle)));
  if (ret == nullptr) return -1;
  arena.clear();
  arena.uint_arrays.emplace_back();
  auto &shape = arena.uint_arrays.back();
  Py_ssize_t n = PyList_Size(ret);
  for (Py_ssize_t i = 0; i < n; ++i)
    shape.push_back(static_cast<mx_uint>(
        PyLong_AsUnsignedLong(PyList_GetItem(ret, i))));
  Py_DECREF(ret);
  *out_dim = static_cast<mx_uint>(n);
  *out_pdata = shape.data();
  API_END();
}

int MXNDArrayGetData(NDArrayHandle handle, void **out_pdata) {
  API_BEGIN();
  PyObject *ret = BridgeCall("ndarray_sync_copy_to",
                             Py_BuildValue("(L)", H(handle)));
  if (ret == nullptr) return -1;
  char *buf; Py_ssize_t n;
  PyBytes_AsStringAndSize(ret, &buf, &n);
  {
    std::lock_guard<std::mutex> lk(host_mirror_mu);
    auto &mirrors = host_mirror[handle];
    // one live mirror per byte-length: same-size refreshes copy INTO the
    // existing buffer (no realloc since capacity is equal), so previously
    // handed-out pointers stay valid, see updated bytes like the
    // reference's live data pointer, and memory stays O(1) per handle;
    // a new length (reshape) appends a fresh buffer.
    std::string *slot = nullptr;
    for (auto &m : mirrors)
      if (m.size() == static_cast<size_t>(n)) { slot = &m; break; }
    if (slot == nullptr) {
      mirrors.emplace_back(static_cast<size_t>(n), '\0');
      slot = &mirrors.back();
    }
    std::memcpy(&(*slot)[0], buf, static_cast<size_t>(n));
    *out_pdata = const_cast<char *>(slot->data());
  }
  Py_DECREF(ret);
  API_END();
}

int MXNDArrayGetDType(NDArrayHandle handle, int *out_dtype) {
  API_BEGIN();
  PyObject *ret = BridgeCall("ndarray_get_dtype", Py_BuildValue("(L)", H(handle)));
  if (ret == nullptr) return -1;
  *out_dtype = static_cast<int>(PyLong_AsLong(ret));
  Py_DECREF(ret);
  API_END();
}

int MXNDArrayGetContext(NDArrayHandle handle, int *out_dev_type,
                        int *out_dev_id) {
  API_BEGIN();
  PyObject *ret = BridgeCall("ndarray_get_context", Py_BuildValue("(L)", H(handle)));
  if (ret == nullptr) return -1;
  *out_dev_type = static_cast<int>(PyLong_AsLong(PyList_GetItem(ret, 0)));
  *out_dev_id = static_cast<int>(PyLong_AsLong(PyList_GetItem(ret, 1)));
  Py_DECREF(ret);
  API_END();
}

int MXNDArraySave(const char *fname, mx_uint num_args, NDArrayHandle *args,
                  const char **keys) {
  API_BEGIN();
  PyObject *pyargs = Py_BuildValue(
      "(sNN)", fname, HandleList(args, num_args),
      keys == nullptr ? PyList_New(0) : StrList(keys, num_args));
  CHECK_CALL(BridgeCall("ndarray_save", pyargs));
  API_END();
}

int MXNDArraySaveRawBytes(NDArrayHandle handle, size_t *out_size,
                          const char **out_buf) {
  API_BEGIN();
  PyObject *ret = BridgeCall("ndarray_save_raw",
                             Py_BuildValue("(L)", H(handle)));
  if (ret == nullptr) return -1;
  char *data = nullptr;
  Py_ssize_t n = 0;
  if (PyBytes_AsStringAndSize(ret, &data, &n) != 0) {
    CaptureError();
    Py_DECREF(ret);
    return -1;
  }
  arena.clear();
  arena.strs.emplace_back(data, static_cast<size_t>(n));
  *out_buf = arena.strs.back().data();
  *out_size = static_cast<size_t>(n);
  Py_DECREF(ret);
  API_END();
}

int MXNDArrayLoadFromRawBytes(const void *buf, size_t size,
                              NDArrayHandle *out) {
  API_BEGIN();
  PyObject *bytes = PyBytes_FromStringAndSize(
      static_cast<const char *>(buf), static_cast<Py_ssize_t>(size));
  if (ReturnHandle(BridgeCall("ndarray_load_raw",
                              Py_BuildValue("(N)", bytes)), out))
    return -1;
  API_END();
}

int MXNDArrayLoad(const char *fname, mx_uint *out_size,
                  NDArrayHandle **out_arr, mx_uint *out_name_size,
                  const char ***out_names) {
  API_BEGIN();
  PyObject *ret = BridgeCall("ndarray_load", Py_BuildValue("(s)", fname));
  if (ret == nullptr) return -1;
  arena.clear();
  *out_arr = ArenaHandleArray(PyTuple_GetItem(ret, 0), out_size);
  *out_names = ArenaStrArray(PyTuple_GetItem(ret, 1), out_name_size);
  Py_DECREF(ret);
  API_END();
}

/* -------------------- NDArray function registry -------------------- */

int MXListFunctions(mx_uint *out_size, FunctionHandle **out_array) {
  API_BEGIN();
  if (InternedListCall("list_functions", out_size,
                       reinterpret_cast<const void ***>(out_array)))
    return -1;
  API_END();
}

int MXGetFunction(const char *name, FunctionHandle *out) {
  API_BEGIN();
  *out = Intern(name);
  API_END();
}

int MXFuncGetInfo(FunctionHandle fun, const char **name,
                  const char **description, mx_uint *num_args,
                  const char ***arg_names, const char ***arg_type_infos,
                  const char ***arg_descriptions) {
  API_BEGIN();
  PyObject *ret = BridgeCall(
      "func_get_info", Py_BuildValue("(s)", static_cast<const char *>(fun)));
  if (ret == nullptr) return -1;
  arena.clear();
  arena.strs.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(ret, 0)));
  *name = arena.strs.back().c_str();
  arena.strs.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(ret, 1)));
  *description = arena.strs.back().c_str();
  Py_DECREF(ret);
  *num_args = 0;
  static const char *empty[] = {nullptr};
  *arg_names = empty; *arg_type_infos = empty; *arg_descriptions = empty;
  API_END();
}

int MXFuncDescribe(FunctionHandle fun, mx_uint *num_use_vars,
                   mx_uint *num_scalars, mx_uint *num_mutate_vars,
                   int *type_mask) {
  API_BEGIN();
  PyObject *ret = BridgeCall(
      "func_describe", Py_BuildValue("(s)", static_cast<const char *>(fun)));
  if (ret == nullptr) return -1;
  *num_use_vars = PyLong_AsUnsignedLong(PyList_GetItem(ret, 0));
  *num_scalars = PyLong_AsUnsignedLong(PyList_GetItem(ret, 1));
  *num_mutate_vars = PyLong_AsUnsignedLong(PyList_GetItem(ret, 2));
  *type_mask = static_cast<int>(PyLong_AsLong(PyList_GetItem(ret, 3)));
  Py_DECREF(ret);
  API_END();
}

int MXFuncInvoke(FunctionHandle fun, NDArrayHandle *use_vars,
                 mx_float *scalar_args, NDArrayHandle *mutate_vars) {
  API_BEGIN();
  mx_uint nuse, nscalar, nmutate; int mask;
  if (MXFuncDescribe(fun, &nuse, &nscalar, &nmutate, &mask) != 0) return -1;
  PyObject *args = Py_BuildValue(
      "(sNNN)", static_cast<const char *>(fun), HandleList(use_vars, nuse),
      FloatList(scalar_args, nscalar), HandleList(mutate_vars, nmutate));
  CHECK_CALL(BridgeCall("func_invoke", args));
  API_END();
}

int MXFuncInvokeEx(FunctionHandle fun, NDArrayHandle *use_vars,
                   mx_float *scalar_args, NDArrayHandle *mutate_vars,
                   int num_params, char **param_keys, char **param_vals) {
  API_BEGIN();
  mx_uint nuse, nscalar, nmutate; int mask;
  if (MXFuncDescribe(fun, &nuse, &nscalar, &nmutate, &mask) != 0) return -1;
  PyObject *args = Py_BuildValue(
      "(sNNNNN)", static_cast<const char *>(fun), HandleList(use_vars, nuse),
      FloatList(scalar_args, nscalar), HandleList(mutate_vars, nmutate),
      StrList(const_cast<const char **>(param_keys), num_params),
      StrList(const_cast<const char **>(param_vals), num_params));
  CHECK_CALL(BridgeCall("func_invoke", args));
  API_END();
}

/* -------------------- Symbol -------------------- */

int MXSymbolListAtomicSymbolCreators(mx_uint *out_size,
                                     AtomicSymbolCreator **out_array) {
  API_BEGIN();
  if (InternedListCall("symbol_list_creators", out_size,
                       reinterpret_cast<const void ***>(out_array)))
    return -1;
  API_END();
}

int MXSymbolGetAtomicSymbolInfo(AtomicSymbolCreator creator, const char **name,
                                const char **description, mx_uint *num_args,
                                const char ***arg_names,
                                const char ***arg_type_infos,
                                const char ***arg_descriptions,
                                const char **key_var_num_args) {
  API_BEGIN();
  PyObject *ret = BridgeCall(
      "symbol_get_creator_info",
      Py_BuildValue("(s)", static_cast<const char *>(creator)));
  if (ret == nullptr) return -1;
  arena.clear();
  PyObject *meta = PyTuple_GetItem(ret, 0);
  arena.strs.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(meta, 0)));
  *name = arena.strs.back().c_str();
  arena.strs.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(meta, 1)));
  *description = arena.strs.back().c_str();
  arena.strs.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(meta, 2)));
  *key_var_num_args = arena.strs.back().c_str();
  mx_uint n1, n2, n3;
  *arg_names = ArenaStrArray(PyTuple_GetItem(ret, 1), &n1);
  *arg_type_infos = ArenaStrArray(PyTuple_GetItem(ret, 2), &n2);
  *arg_descriptions = ArenaStrArray(PyTuple_GetItem(ret, 3), &n3);
  *num_args = n1;
  Py_DECREF(ret);
  API_END();
}

int MXSymbolCreateAtomicSymbol(AtomicSymbolCreator creator, mx_uint num_param,
                               const char **keys, const char **vals,
                               SymbolHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue(
      "(sNN)", static_cast<const char *>(creator), StrList(keys, num_param),
      StrList(vals, num_param));
  if (ReturnHandle(BridgeCall("symbol_create_atomic", args), out)) return -1;
  API_END();
}

int MXSymbolCreateVariable(const char *name, SymbolHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("symbol_create_variable",
                              Py_BuildValue("(s)", name)), out))
    return -1;
  API_END();
}

int MXSymbolCreateGroup(mx_uint num_symbols, SymbolHandle *symbols,
                        SymbolHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("symbol_create_group",
                              Py_BuildValue("(N)", HandleList(symbols,
                                                              num_symbols))),
                   out))
    return -1;
  API_END();
}

int MXSymbolCreateFromJSON(const char *json, SymbolHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("symbol_from_json", Py_BuildValue("(s)", json)),
                   out))
    return -1;
  API_END();
}

int MXSymbolCreateFromFile(const char *fname, SymbolHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("symbol_from_file", Py_BuildValue("(s)", fname)),
                   out))
    return -1;
  API_END();
}

int MXSymbolSaveToJSON(SymbolHandle symbol, const char **out_json) {
  API_BEGIN();
  if (ReturnString(BridgeCall("symbol_to_json", Py_BuildValue("(L)", H(symbol))),
                   out_json))
    return -1;
  API_END();
}

int MXSymbolSaveToFile(SymbolHandle symbol, const char *fname) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("symbol_save_file",
                        Py_BuildValue("(Ls)", H(symbol), fname)));
  API_END();
}

int MXSymbolFree(SymbolHandle symbol) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("free_handle", Py_BuildValue("(L)", H(symbol))));
  API_END();
}

int MXSymbolCopy(SymbolHandle symbol, SymbolHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("symbol_copy", Py_BuildValue("(L)", H(symbol))),
                   out))
    return -1;
  API_END();
}

int MXSymbolPrint(SymbolHandle symbol, const char **out_str) {
  API_BEGIN();
  if (ReturnString(BridgeCall("symbol_print", Py_BuildValue("(L)", H(symbol))),
                   out_str))
    return -1;
  API_END();
}

int MXSymbolGetAttr(SymbolHandle symbol, const char *key, const char **out,
                    int *success) {
  API_BEGIN();
  PyObject *ret = BridgeCall("symbol_get_attr",
                             Py_BuildValue("(Ls)", H(symbol), key));
  if (ret == nullptr) return -1;
  if (ret == Py_None) {
    *success = 0; *out = nullptr;
  } else {
    arena.clear();
    arena.strs.emplace_back(PyUnicode_AsUTF8(ret));
    *out = arena.strs.back().c_str();
    *success = 1;
  }
  Py_DECREF(ret);
  API_END();
}

int MXSymbolSetAttr(SymbolHandle symbol, const char *key, const char *value) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("symbol_set_attr",
                        Py_BuildValue("(Lss)", H(symbol), key, value)));
  API_END();
}

static int ListAttrCall(SymbolHandle symbol, int recursive, mx_uint *out_size,
                        const char ***out) {
  PyObject *ret = BridgeCall("symbol_list_attr",
                             Py_BuildValue("(Li)", H(symbol), recursive));
  if (ret == nullptr) return -1;
  arena.clear();
  mx_uint flat_size;
  *out = ArenaStrArray(ret, &flat_size);
  /* reference contract: out_size = #attributes, out holds 2*out_size
   * strings (key/value pairs) */
  *out_size = flat_size / 2;
  Py_DECREF(ret);
  return 0;
}

int MXSymbolListAttr(SymbolHandle symbol, mx_uint *out_size,
                     const char ***out) {
  API_BEGIN();
  if (ListAttrCall(symbol, 1, out_size, out)) return -1;
  API_END();
}

int MXSymbolListAttrShallow(SymbolHandle symbol, mx_uint *out_size,
                            const char ***out) {
  API_BEGIN();
  if (ListAttrCall(symbol, 0, out_size, out)) return -1;
  API_END();
}

int MXSymbolGetName(SymbolHandle symbol, const char **out, int *success) {
  API_BEGIN();
  PyObject *ret = BridgeCall("symbol_get_name",
                             Py_BuildValue("(L)", H(symbol)));
  if (ret == nullptr) return -1;
  if (ret == Py_None) {
    *success = 0;
    *out = nullptr;
  } else {
    arena.clear();
    arena.strs.emplace_back(PyUnicode_AsUTF8(ret));
    *out = arena.strs.back().c_str();
    *success = 1;
  }
  Py_DECREF(ret);
  API_END();
}

int MXSymbolGetAtomicSymbolName(AtomicSymbolCreator creator,
                                const char **name) {
  API_BEGIN();
  /* creator handles ARE interned op-name strings (MXGetFunction /
   * InternedListCall contract) */
  *name = static_cast<const char *>(creator);
  API_END();
}

static int ListStrCall(const char *fn, SymbolHandle symbol, mx_uint *out_size,
                       const char ***out_str_array) {
  PyObject *ret = BridgeCall(fn, Py_BuildValue("(L)", H(symbol)));
  if (ret == nullptr) return -1;
  arena.clear();
  *out_str_array = ArenaStrArray(ret, out_size);
  Py_DECREF(ret);
  return 0;
}

int MXSymbolListArguments(SymbolHandle symbol, mx_uint *out_size,
                          const char ***out_str_array) {
  API_BEGIN();
  if (ListStrCall("symbol_list_arguments", symbol, out_size, out_str_array))
    return -1;
  API_END();
}

int MXSymbolListOutputs(SymbolHandle symbol, mx_uint *out_size,
                        const char ***out_str_array) {
  API_BEGIN();
  if (ListStrCall("symbol_list_outputs", symbol, out_size, out_str_array))
    return -1;
  API_END();
}

int MXSymbolListAuxiliaryStates(SymbolHandle symbol, mx_uint *out_size,
                                const char ***out_str_array) {
  API_BEGIN();
  if (ListStrCall("symbol_list_aux", symbol, out_size, out_str_array))
    return -1;
  API_END();
}

int MXSymbolGetInternals(SymbolHandle symbol, SymbolHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("symbol_get_internals",
                              Py_BuildValue("(L)", H(symbol))), out))
    return -1;
  API_END();
}

int MXSymbolGetOutput(SymbolHandle symbol, mx_uint index, SymbolHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("symbol_get_output",
                              Py_BuildValue("(LI)", H(symbol), index)), out))
    return -1;
  API_END();
}

int MXSymbolCompose(SymbolHandle sym, const char *name, mx_uint num_args,
                    const char **keys, SymbolHandle *args) {
  API_BEGIN();
  PyObject *pyargs = Py_BuildValue(
      "(LsNN)", H(sym), name == nullptr ? "" : name,
      keys == nullptr ? PyList_New(0) : StrList(keys, num_args),
      HandleList(args, num_args));
  CHECK_CALL(BridgeCall("symbol_compose", pyargs));
  API_END();
}

int MXSymbolGrad(SymbolHandle sym, mx_uint num_wrt, const char **wrt,
                 SymbolHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("symbol_grad",
                              Py_BuildValue("(LN)", H(sym),
                                            StrList(wrt, num_wrt))), out))
    return -1;
  API_END();
}

static int InferShapeImpl(SymbolHandle sym, mx_uint num_args,
                          const char **keys, const mx_uint *arg_ind_ptr,
                          const mx_uint *arg_shape_data, mx_uint *in_size,
                          const mx_uint **in_ndim, const mx_uint ***in_data,
                          mx_uint *out_size, const mx_uint **out_ndim,
                          const mx_uint ***out_data, mx_uint *aux_size,
                          const mx_uint **aux_ndim, const mx_uint ***aux_data,
                          int *complete, int partial) {
  /* shapes arrive CSR-style: arg_ind_ptr[i]..arg_ind_ptr[i+1] spans shape i */
  PyObject *shapes = ShapesFromCSR(num_args, arg_ind_ptr, arg_shape_data);
  PyObject *args = Py_BuildValue("(LNNi)", H(sym), StrList(keys, num_args),
                                 shapes, partial);
  PyObject *ret = BridgeCall("symbol_infer_shape", args);
  if (ret == nullptr) return -1;
  arena.clear();
  ArenaShapeGroup(PyTuple_GetItem(ret, 0), in_size, in_ndim, in_data);
  ArenaShapeGroup(PyTuple_GetItem(ret, 1), out_size, out_ndim, out_data);
  ArenaShapeGroup(PyTuple_GetItem(ret, 2), aux_size, aux_ndim, aux_data);
  *complete = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(ret, 3)));
  Py_DECREF(ret);
  return 0;
}

int MXSymbolInferShape(SymbolHandle sym, mx_uint num_args, const char **keys,
                       const mx_uint *arg_ind_ptr,
                       const mx_uint *arg_shape_data, mx_uint *in_shape_size,
                       const mx_uint **in_shape_ndim,
                       const mx_uint ***in_shape_data, mx_uint *out_shape_size,
                       const mx_uint **out_shape_ndim,
                       const mx_uint ***out_shape_data, mx_uint *aux_shape_size,
                       const mx_uint **aux_shape_ndim,
                       const mx_uint ***aux_shape_data, int *complete) {
  API_BEGIN();
  if (InferShapeImpl(sym, num_args, keys, arg_ind_ptr, arg_shape_data,
                     in_shape_size, in_shape_ndim, in_shape_data,
                     out_shape_size, out_shape_ndim, out_shape_data,
                     aux_shape_size, aux_shape_ndim, aux_shape_data, complete,
                     0))
    return -1;
  API_END();
}

int MXSymbolInferShapePartial(SymbolHandle sym, mx_uint num_args,
                              const char **keys, const mx_uint *arg_ind_ptr,
                              const mx_uint *arg_shape_data,
                              mx_uint *in_shape_size,
                              const mx_uint **in_shape_ndim,
                              const mx_uint ***in_shape_data,
                              mx_uint *out_shape_size,
                              const mx_uint **out_shape_ndim,
                              const mx_uint ***out_shape_data,
                              mx_uint *aux_shape_size,
                              const mx_uint **aux_shape_ndim,
                              const mx_uint ***aux_shape_data, int *complete) {
  API_BEGIN();
  if (InferShapeImpl(sym, num_args, keys, arg_ind_ptr, arg_shape_data,
                     in_shape_size, in_shape_ndim, in_shape_data,
                     out_shape_size, out_shape_ndim, out_shape_data,
                     aux_shape_size, aux_shape_ndim, aux_shape_data, complete,
                     1))
    return -1;
  API_END();
}

int MXSymbolInferType(SymbolHandle sym, mx_uint num_args, const char **keys,
                      const int *arg_type_data, mx_uint *in_type_size,
                      const int **in_type_data, mx_uint *out_type_size,
                      const int **out_type_data, mx_uint *aux_type_size,
                      const int **aux_type_data, int *complete) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(LNN)", H(sym), StrList(keys, num_args),
                                 CIntList(arg_type_data, num_args));
  PyObject *ret = BridgeCall("symbol_infer_type", args);
  if (ret == nullptr) return -1;
  arena.clear();
  auto fill = [&](PyObject *group, mx_uint *size, const int **data) {
    arena.int_arrays.emplace_back();
    auto &v = arena.int_arrays.back();
    Py_ssize_t n = PyList_Size(group);
    for (Py_ssize_t i = 0; i < n; ++i)
      v.push_back(static_cast<int>(PyLong_AsLong(PyList_GetItem(group, i))));
    *size = static_cast<mx_uint>(n);
    *data = v.data();
  };
  fill(PyTuple_GetItem(ret, 0), in_type_size, in_type_data);
  fill(PyTuple_GetItem(ret, 1), out_type_size, out_type_data);
  fill(PyTuple_GetItem(ret, 2), aux_type_size, aux_type_data);
  *complete = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(ret, 3)));
  Py_DECREF(ret);
  API_END();
}

/* -------------------- Executor -------------------- */

int MXExecutorFree(ExecutorHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("free_handle", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXExecutorPrint(ExecutorHandle handle, const char **out_str) {
  API_BEGIN();
  if (ReturnString(BridgeCall("executor_print", Py_BuildValue("(L)", H(handle))),
                   out_str))
    return -1;
  API_END();
}

int MXExecutorForward(ExecutorHandle handle, int is_train) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("executor_forward",
                        Py_BuildValue("(Li)", H(handle), is_train)));
  API_END();
}

int MXExecutorBackward(ExecutorHandle handle, mx_uint len,
                       NDArrayHandle *head_grads) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("executor_backward",
                        Py_BuildValue("(LN)", H(handle),
                                      HandleList(head_grads, len))));
  API_END();
}

int MXExecutorOutputs(ExecutorHandle handle, mx_uint *out_size,
                      NDArrayHandle **out) {
  API_BEGIN();
  PyObject *ret = BridgeCall("executor_outputs", Py_BuildValue("(L)", H(handle)));
  if (ret == nullptr) return -1;
  arena.clear();
  *out = ArenaHandleArray(ret, out_size);
  Py_DECREF(ret);
  API_END();
}

int MXExecutorSetMonitorCallback(ExecutorHandle handle,
                                 ExecutorMonitorCallback callback,
                                 void *callback_handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall(
      "executor_set_monitor_addr",
      Py_BuildValue("(LLL)", H(handle),
                    static_cast<long long>(
                        reinterpret_cast<intptr_t>(callback)),
                    H(callback_handle))));
  API_END();
}

int MXExecutorBindEX(SymbolHandle symbol_handle, int dev_type, int dev_id,
                     mx_uint num_map_keys, const char **map_keys,
                     const int *map_dev_types, const int *map_dev_ids,
                     mx_uint len, NDArrayHandle *in_args,
                     NDArrayHandle *arg_grad_store, mx_uint *grad_req_type,
                     mx_uint aux_states_len, NDArrayHandle *aux_states,
                     ExecutorHandle shared_exec, ExecutorHandle *out) {
  API_BEGIN();
  PyObject *reqs = PyList_New(len);
  for (mx_uint i = 0; i < len; ++i)
    PyList_SetItem(reqs, i, PyLong_FromUnsignedLong(grad_req_type[i]));
  PyObject *args = Py_BuildValue(
      "(LiiNNNNNNNL)", H(symbol_handle), dev_type, dev_id,
      StrList(map_keys, num_map_keys), CIntList(map_dev_types, num_map_keys),
      CIntList(map_dev_ids, num_map_keys), HandleList(in_args, len),
      HandleList(arg_grad_store, len), reqs,
      HandleList(aux_states, aux_states_len), H(shared_exec));
  if (ReturnHandle(BridgeCall("executor_bind", args), out)) return -1;
  API_END();
}

int MXExecutorBindX(SymbolHandle symbol_handle, int dev_type, int dev_id,
                    mx_uint num_map_keys, const char **map_keys,
                    const int *map_dev_types, const int *map_dev_ids,
                    mx_uint len, NDArrayHandle *in_args,
                    NDArrayHandle *arg_grad_store, mx_uint *grad_req_type,
                    mx_uint aux_states_len, NDArrayHandle *aux_states,
                    ExecutorHandle *out) {
  return MXExecutorBindEX(symbol_handle, dev_type, dev_id, num_map_keys,
                          map_keys, map_dev_types, map_dev_ids, len, in_args,
                          arg_grad_store, grad_req_type, aux_states_len,
                          aux_states, nullptr, out);
}

int MXExecutorBind(SymbolHandle symbol_handle, int dev_type, int dev_id,
                   mx_uint len, NDArrayHandle *in_args,
                   NDArrayHandle *arg_grad_store, mx_uint *grad_req_type,
                   mx_uint aux_states_len, NDArrayHandle *aux_states,
                   ExecutorHandle *out) {
  return MXExecutorBindEX(symbol_handle, dev_type, dev_id, 0, nullptr, nullptr,
                          nullptr, len, in_args, arg_grad_store, grad_req_type,
                          aux_states_len, aux_states, nullptr, out);
}

/* -------------------- Data iterators -------------------- */

int MXListDataIters(mx_uint *out_size, DataIterCreator **out_array) {
  API_BEGIN();
  if (InternedListCall("list_data_iters", out_size,
                       reinterpret_cast<const void ***>(out_array)))
    return -1;
  API_END();
}

int MXDataIterGetIterInfo(DataIterCreator creator, const char **name,
                          const char **description, mx_uint *num_args,
                          const char ***arg_names,
                          const char ***arg_type_infos,
                          const char ***arg_descriptions) {
  API_BEGIN();
  arena.clear();
  arena.strs.emplace_back(static_cast<const char *>(creator));
  *name = arena.strs.back().c_str();
  arena.strs.emplace_back("data iterator");
  *description = arena.strs.back().c_str();
  *num_args = 0;
  static const char *empty[] = {nullptr};
  *arg_names = empty; *arg_type_infos = empty; *arg_descriptions = empty;
  API_END();
}

int MXDataIterCreateIter(DataIterCreator handle, mx_uint num_param,
                         const char **keys, const char **vals,
                         DataIterHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue(
      "(sNN)", static_cast<const char *>(handle), StrList(keys, num_param),
      StrList(vals, num_param));
  if (ReturnHandle(BridgeCall("data_iter_create", args), out)) return -1;
  API_END();
}

int MXDataIterFree(DataIterHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("free_handle", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXDataIterNext(DataIterHandle handle, int *out) {
  API_BEGIN();
  PyObject *ret = BridgeCall("data_iter_next", Py_BuildValue("(L)", H(handle)));
  if (ret == nullptr) return -1;
  *out = static_cast<int>(PyLong_AsLong(ret));
  Py_DECREF(ret);
  API_END();
}

int MXDataIterBeforeFirst(DataIterHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("data_iter_before_first", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXDataIterGetData(DataIterHandle handle, NDArrayHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("data_iter_get_data",
                              Py_BuildValue("(L)", H(handle))), out))
    return -1;
  API_END();
}

int MXDataIterGetLabel(DataIterHandle handle, NDArrayHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("data_iter_get_label",
                              Py_BuildValue("(L)", H(handle))), out))
    return -1;
  API_END();
}

int MXDataIterGetIndex(DataIterHandle handle, uint64_t **out_index,
                       uint64_t *out_size) {
  API_BEGIN();
  PyObject *ret = BridgeCall("data_iter_get_index",
                             Py_BuildValue("(L)", H(handle)));
  if (ret == nullptr) return -1;
  arena.clear();
  arena.u64_arrays.emplace_back();
  auto &v = arena.u64_arrays.back();
  Py_ssize_t n = PyList_Size(ret);
  for (Py_ssize_t i = 0; i < n; ++i)
    v.push_back(PyLong_AsUnsignedLongLong(PyList_GetItem(ret, i)));
  Py_DECREF(ret);
  *out_size = static_cast<uint64_t>(n);
  *out_index = v.data();
  API_END();
}

int MXDataIterGetPadNum(DataIterHandle handle, int *pad) {
  API_BEGIN();
  PyObject *ret = BridgeCall("data_iter_get_pad", Py_BuildValue("(L)", H(handle)));
  if (ret == nullptr) return -1;
  *pad = static_cast<int>(PyLong_AsLong(ret));
  Py_DECREF(ret);
  API_END();
}

/* -------------------- KVStore -------------------- */

int MXKVStoreCreate(const char *type, KVStoreHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("kvstore_create", Py_BuildValue("(s)", type)),
                   out))
    return -1;
  API_END();
}

int MXKVStoreFree(KVStoreHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("free_handle", Py_BuildValue("(L)", H(handle))));
  API_END();
}

static int KVTriple(const char *fn, KVStoreHandle handle, mx_uint num,
                    const int *keys, NDArrayHandle *vals, int priority,
                    int with_priority) {
  PyObject *pykeys = CIntList(keys, num);
  PyObject *pyvals = HandleList(vals, num);
  PyObject *args =
      with_priority
          ? Py_BuildValue("(LNNi)", H(handle), pykeys, pyvals, priority)
          : Py_BuildValue("(LNN)", H(handle), pykeys, pyvals);
  PyObject *ret = BridgeCall(fn, args);
  if (ret == nullptr) return -1;
  Py_DECREF(ret);
  return 0;
}

int MXKVStoreInit(KVStoreHandle handle, mx_uint num, const int *keys,
                  NDArrayHandle *vals) {
  API_BEGIN();
  if (KVTriple("kvstore_init", handle, num, keys, vals, 0, 0)) return -1;
  API_END();
}

int MXKVStorePush(KVStoreHandle handle, mx_uint num, const int *keys,
                  NDArrayHandle *vals, int priority) {
  API_BEGIN();
  if (KVTriple("kvstore_push", handle, num, keys, vals, priority, 1))
    return -1;
  API_END();
}

int MXKVStorePull(KVStoreHandle handle, mx_uint num, const int *keys,
                  NDArrayHandle *vals, int priority) {
  API_BEGIN();
  if (KVTriple("kvstore_pull", handle, num, keys, vals, priority, 1))
    return -1;
  API_END();
}

int MXKVStoreSetUpdater(KVStoreHandle handle, MXKVStoreUpdater updater,
                        void *updater_handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall(
      "kvstore_set_updater_addr",
      Py_BuildValue("(LLL)", H(handle),
                    static_cast<long long>(
                        reinterpret_cast<intptr_t>(updater)),
                    H(updater_handle))));
  API_END();
}

/* Role queries (reference c_api.h:1218-1238): pure env reads — same
 * contract ps-lite derives its roles from (DMLC_ROLE, tools/launch.py);
 * no bridge call so they work before any kvstore exists. */
static int RoleIs(const char *want) {
  const char *role = getenv("DMLC_ROLE");
  if (role == nullptr) role = "worker";
  return strcmp(role, want) == 0 ? 1 : 0;
}

int MXKVStoreIsWorkerNode(int *ret) {
  API_BEGIN();
  /* reference semantics: worker = not a server, not a scheduler */
  *ret = (RoleIs("server") || RoleIs("scheduler")) ? 0 : 1;
  API_END();
}

int MXKVStoreIsServerNode(int *ret) {
  API_BEGIN();
  *ret = RoleIs("server");
  API_END();
}

int MXKVStoreIsSchedulerNode(int *ret) {
  API_BEGIN();
  *ret = RoleIs("scheduler");
  API_END();
}

int MXKVStoreGetType(KVStoreHandle handle, const char **type) {
  API_BEGIN();
  if (ReturnString(BridgeCall("kvstore_get_type", Py_BuildValue("(L)", H(handle))),
                   type))
    return -1;
  API_END();
}

static int KVInt(const char *fn, KVStoreHandle handle, int *ret_out) {
  PyObject *ret = BridgeCall(fn, Py_BuildValue("(L)", H(handle)));
  if (ret == nullptr) return -1;
  *ret_out = static_cast<int>(PyLong_AsLong(ret));
  Py_DECREF(ret);
  return 0;
}

int MXKVStoreGetRank(KVStoreHandle handle, int *ret) {
  API_BEGIN();
  if (KVInt("kvstore_get_rank", handle, ret)) return -1;
  API_END();
}

int MXKVStoreGetGroupSize(KVStoreHandle handle, int *ret) {
  API_BEGIN();
  if (KVInt("kvstore_get_group_size", handle, ret)) return -1;
  API_END();
}

int MXKVStoreBarrier(KVStoreHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("kvstore_barrier", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXKVStoreRunServer(KVStoreHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("kvstore_run_server", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXKVStoreSendCommmandToServers(KVStoreHandle handle, int cmd_id,
                                   const char *cmd_body) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("kvstore_send_command",
                        Py_BuildValue("(Lis)", H(handle), cmd_id, cmd_body)));
  API_END();
}

int MXInitPSEnv(mx_uint num_vars, const char **keys, const char **vals) {
  API_BEGIN();
  for (mx_uint i = 0; i < num_vars; ++i) setenv(keys[i], vals[i], 1);
  API_END();
}

/* -------------------- RecordIO -------------------- */

int MXRecordIOWriterCreate(const char *uri, RecordIOHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("recordio_writer_create",
                              Py_BuildValue("(s)", uri)), out))
    return -1;
  API_END();
}

int MXRecordIOWriterFree(RecordIOHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("recordio_close", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXRecordIOWriterWriteRecord(RecordIOHandle handle, const char *buf,
                                size_t size) {
  API_BEGIN();
  PyObject *bytes = PyBytes_FromStringAndSize(buf,
                                              static_cast<Py_ssize_t>(size));
  CHECK_CALL(BridgeCall("recordio_write",
                        Py_BuildValue("(LN)", H(handle), bytes)));
  API_END();
}

int MXRecordIOReaderCreate(const char *uri, RecordIOHandle *out) {
  API_BEGIN();
  if (ReturnHandle(BridgeCall("recordio_reader_create",
                              Py_BuildValue("(s)", uri)), out))
    return -1;
  API_END();
}

int MXRecordIOReaderFree(RecordIOHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("recordio_close", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXRecordIOReaderReadRecord(RecordIOHandle handle, char const **buf,
                               size_t *size) {
  API_BEGIN();
  PyObject *ret = BridgeCall("recordio_read", Py_BuildValue("(L)", H(handle)));
  if (ret == nullptr) return -1;
  if (ret == Py_None) {
    *buf = nullptr; *size = 0;
  } else {
    char *data; Py_ssize_t n;
    PyBytes_AsStringAndSize(ret, &data, &n);
    arena.clear();
    arena.strs.emplace_back(data, static_cast<size_t>(n));
    *buf = arena.strs.back().data();
    *size = static_cast<size_t>(n);
  }
  Py_DECREF(ret);
  API_END();
}

/* -------------------- Rtc -------------------- */

int MXRtcCreate(char *name, mx_uint num_input, mx_uint num_output,
                char **input_names, char **output_names, NDArrayHandle *inputs,
                NDArrayHandle *outputs, char *kernel, RtcHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue(
      "(sNNNNs)", name,
      StrList(const_cast<const char **>(input_names), num_input),
      HandleList(inputs, num_input),
      StrList(const_cast<const char **>(output_names), num_output),
      HandleList(outputs, num_output), kernel);
  if (ReturnHandle(BridgeCall("rtc_create", args), out)) return -1;
  API_END();
}

int MXRtcPush(RtcHandle handle, mx_uint num_input, mx_uint num_output,
              NDArrayHandle *inputs, NDArrayHandle *outputs, mx_uint gridDimX,
              mx_uint gridDimY, mx_uint gridDimZ, mx_uint blockDimX,
              mx_uint blockDimY, mx_uint blockDimZ) {
  API_BEGIN();
  int64_t grid[3] = {gridDimX, gridDimY, gridDimZ};
  int64_t block[3] = {blockDimX, blockDimY, blockDimZ};
  PyObject *args = Py_BuildValue("(LNNNN)", H(handle),
                                 HandleList(inputs, num_input),
                                 HandleList(outputs, num_output),
                                 IntList(grid, 3), IntList(block, 3));
  CHECK_CALL(BridgeCall("rtc_push", args));
  API_END();
}

int MXRtcFree(RtcHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("free_handle", Py_BuildValue("(L)", H(handle))));
  API_END();
}

/* -------------------- Optimizer -------------------- */

int MXOptimizerFindCreator(const char *key, OptimizerCreator *out) {
  API_BEGIN();
  PyObject *ret = BridgeCall("optimizer_find_creator", Py_BuildValue("(s)", key));
  if (ret == nullptr) return -1;
  long found = PyLong_AsLong(ret);
  Py_DECREF(ret);
  if (found == 0) { last_error = std::string("unknown optimizer ") + key;
                    return -1; }
  *out = Intern(key);
  API_END();
}

int MXOptimizerCreateOptimizer(OptimizerCreator creator, mx_uint num_param,
                               const char **keys, const char **vals,
                               OptimizerHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue(
      "(sNN)", static_cast<const char *>(creator), StrList(keys, num_param),
      StrList(vals, num_param));
  if (ReturnHandle(BridgeCall("optimizer_create", args), out)) return -1;
  API_END();
}

int MXOptimizerFree(OptimizerHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("free_handle", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXOptimizerUpdate(OptimizerHandle handle, int index, NDArrayHandle weight,
                      NDArrayHandle grad, mx_float lr, mx_float wd) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("optimizer_update",
                        Py_BuildValue("(LiLLff)", H(handle), index, H(weight),
                                      H(grad), lr, wd)));
  API_END();
}

/* -------------------- Custom operators -------------------- */

int MXCustomOpRegister(const char *op_type, CustomOpPropCreator creator) {
  API_BEGIN();
  CHECK_CALL(BridgeCall(
      "custom_op_register",
      Py_BuildValue("(sL)", op_type,
                    static_cast<long long>(
                        reinterpret_cast<intptr_t>(creator)))));
  API_END();
}
