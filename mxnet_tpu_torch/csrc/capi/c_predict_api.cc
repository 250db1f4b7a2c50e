/*!
 * Predict-only mini-ABI implementation (reference src/c_api/c_predict_api.cc,
 * 305 LoC): create a predictor from symbol JSON + param blob, set input,
 * forward, read output.  Forwards to mxnet_tpu_torch.capi_bridge.pred_* over
 * the embedded interpreter; compiled both into libmxtpu_torch_capi.so and
 * standalone into libmxtpu_torch_predict.so (the amalgamation-style
 * deployment build, reference amalgamation/).
 */
#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>

#include "c_predict_api.h"
#include "c_api_common.h"

using namespace mxtpu_capi;  // NOLINT

namespace {

/* Per-NDList return storage: pointers from MXNDListGet stay valid until
 * MXNDListFree (the reference contract), NOT merely until the next Get —
 * callers commonly collect pointers for every index before reading any. */
std::unordered_map<void *, ReturnArena> ndlist_store;
std::mutex ndlist_mu;

/* Build the bridge args shared by MXPredCreate / MXPredCreatePartialOut. */
PyObject *PredArgs(const char *symbol_json_str, const void *param_bytes,
                   int param_size, int dev_type, int dev_id,
                   mx_uint num_input_nodes, const char **input_keys,
                   const mx_uint *input_shape_indptr,
                   const mx_uint *input_shape_data,
                   mx_uint num_output_nodes, const char **output_keys) {
  PyObject *shapes = ShapesFromCSR(num_input_nodes, input_shape_indptr,
                                   input_shape_data);
  PyObject *blob = PyBytes_FromStringAndSize(
      static_cast<const char *>(param_bytes), param_size);
  PyObject *outputs = output_keys == nullptr
                          ? (Py_INCREF(Py_None), Py_None)
                          : StrList(output_keys, num_output_nodes);
  return Py_BuildValue("(sNiiNNN)", symbol_json_str, blob, dev_type, dev_id,
                       StrList(input_keys, num_input_nodes), shapes, outputs);
}

}  // namespace

/* MXGetLastError is defined in c_api.cc for the combined build; the
 * standalone predict build defines it here. */
#ifdef MXTPU_PREDICT_STANDALONE
const char *MXGetLastError() { return last_error.c_str(); }
#endif

int MXPredCreatePartialOut(const char *symbol_json_str,
                           const void *param_bytes, int param_size,
                           int dev_type, int dev_id, mx_uint num_input_nodes,
                           const char **input_keys,
                           const mx_uint *input_shape_indptr,
                           const mx_uint *input_shape_data,
                           mx_uint num_output_nodes, const char **output_keys,
                           PredictorHandle *out) {
  API_BEGIN();
  PyObject *args = PredArgs(symbol_json_str, param_bytes, param_size, dev_type,
                            dev_id, num_input_nodes, input_keys,
                            input_shape_indptr, input_shape_data,
                            num_output_nodes, output_keys);
  if (ReturnHandleImpl(BridgeCall("pred_create", args), out)) return -1;
  API_END();
}

int MXPredCreate(const char *symbol_json_str, const void *param_bytes,
                 int param_size, int dev_type, int dev_id,
                 mx_uint num_input_nodes, const char **input_keys,
                 const mx_uint *input_shape_indptr,
                 const mx_uint *input_shape_data, PredictorHandle *out) {
  return MXPredCreatePartialOut(symbol_json_str, param_bytes, param_size,
                                dev_type, dev_id, num_input_nodes, input_keys,
                                input_shape_indptr, input_shape_data, 0,
                                nullptr, out);
}

int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                         mx_uint **shape_data, mx_uint *shape_ndim) {
  API_BEGIN();
  PyObject *ret = BridgeCall("pred_get_output_shape",
                             Py_BuildValue("(LI)", H(handle), index));
  if (ret == nullptr) return -1;
  arena.clear();
  arena.uint_arrays.emplace_back();
  auto &shape = arena.uint_arrays.back();
  Py_ssize_t n = PyList_Size(ret);
  for (Py_ssize_t i = 0; i < n; ++i)
    shape.push_back(static_cast<mx_uint>(
        PyLong_AsUnsignedLong(PyList_GetItem(ret, i))));
  Py_DECREF(ret);
  *shape_ndim = static_cast<mx_uint>(n);
  *shape_data = shape.data();
  API_END();
}

int MXPredSetInput(PredictorHandle handle, const char *key,
                   const mx_float *data, mx_uint size) {
  API_BEGIN();
  PyObject *bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(data),
      static_cast<Py_ssize_t>(size) * sizeof(mx_float));
  CHECK_CALL(BridgeCall("pred_set_input",
                        Py_BuildValue("(LsN)", H(handle), key, bytes)));
  API_END();
}

int MXPredForward(PredictorHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("pred_forward", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXPredPartialForward(PredictorHandle handle, int step, int *step_left) {
  API_BEGIN();
  PyObject *ret = BridgeCall("pred_partial_forward",
                             Py_BuildValue("(Li)", H(handle), step));
  if (ret == nullptr) return -1;
  *step_left = static_cast<int>(PyLong_AsLong(ret));
  Py_DECREF(ret);
  API_END();
}

int MXPredGetOutput(PredictorHandle handle, mx_uint index, mx_float *data,
                    mx_uint size) {
  API_BEGIN();
  PyObject *ret = BridgeCall("pred_get_output",
                             Py_BuildValue("(LI)", H(handle), index));
  if (ret == nullptr) return -1;
  char *buf; Py_ssize_t n;
  PyBytes_AsStringAndSize(ret, &buf, &n);
  size_t want = static_cast<size_t>(size) * sizeof(mx_float);
  if (static_cast<size_t>(n) != want) {
    Py_DECREF(ret);
    last_error = "MXPredGetOutput size mismatch: output has " +
                 std::to_string(n / sizeof(mx_float)) +
                 " elements, caller asked for " + std::to_string(size);
    return -1;
  }
  std::memcpy(data, buf, want);
  Py_DECREF(ret);
  API_END();
}

int MXPredFree(PredictorHandle handle) {
  API_BEGIN();
  CHECK_CALL(BridgeCall("free_handle", Py_BuildValue("(L)", H(handle))));
  API_END();
}

int MXNDListCreate(const char *nd_file_bytes, int nd_file_size,
                   NDListHandle *out, mx_uint *out_length) {
  API_BEGIN();
  PyObject *blob = PyBytes_FromStringAndSize(nd_file_bytes, nd_file_size);
  PyObject *ret = BridgeCall("ndlist_create", Py_BuildValue("(N)", blob));
  if (ret == nullptr) return -1;
  *out = ToHandle(PyLong_AsLongLong(PyTuple_GetItem(ret, 0)));
  *out_length = static_cast<mx_uint>(PyList_Size(PyTuple_GetItem(ret, 1)));
  Py_DECREF(ret);
  API_END();
}

int MXNDListGet(NDListHandle handle, mx_uint index, const char **out_key,
                const mx_float **out_data, const mx_uint **out_shape,
                mx_uint *out_ndim) {
  API_BEGIN();
  PyObject *ret = BridgeCall("ndlist_get",
                             Py_BuildValue("(LI)", H(handle), index));
  if (ret == nullptr) return -1;
  std::lock_guard<std::mutex> lk(ndlist_mu);
  ReturnArena &store = ndlist_store[handle];
  store.strs.emplace_back(PyUnicode_AsUTF8(PyTuple_GetItem(ret, 0)));
  *out_key = store.strs.back().c_str();
  char *buf; Py_ssize_t n;
  PyBytes_AsStringAndSize(PyTuple_GetItem(ret, 1), &buf, &n);
  store.float_arrays.emplace_back();
  auto &fdata = store.float_arrays.back();
  fdata.resize(static_cast<size_t>(n) / sizeof(float));
  std::memcpy(fdata.data(), buf, fdata.size() * sizeof(float));
  *out_data = fdata.data();
  PyObject *shape = PyTuple_GetItem(ret, 2);
  store.uint_arrays.emplace_back();
  auto &sd = store.uint_arrays.back();
  Py_ssize_t ndim = PyList_Size(shape);
  for (Py_ssize_t i = 0; i < ndim; ++i)
    sd.push_back(static_cast<mx_uint>(
        PyLong_AsUnsignedLong(PyList_GetItem(shape, i))));
  *out_shape = sd.data();
  *out_ndim = static_cast<mx_uint>(ndim);
  Py_DECREF(ret);
  API_END();
}

int MXNDListFree(NDListHandle handle) {
  API_BEGIN();
  {
    std::lock_guard<std::mutex> lk(ndlist_mu);
    ndlist_store.erase(handle);
  }
  CHECK_CALL(BridgeCall("free_handle", Py_BuildValue("(L)", H(handle))));
  API_END();
}
