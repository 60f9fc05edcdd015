/* The port's C API: embeds CPython and delegates to mlsl_tpu_torch.c_shim.
 *
 * A copy of native/c_api.cpp (the JAX package's entry) that imports the
 * port's shim instead of mlsl_tpu.c_shim. Compiled against the unchanged
 * include/mlsl_tpu.h, it exports the same mlsl_* symbols, so the consumer
 * programs (native/test_c_api.c, native/test_cpp_api.cpp and the mlsl.hpp
 * surface of native/mlsl_compat.cpp) link against it unchanged
 * (mlsl_tpu_torch/capi/build.py builds them). Every entry point takes the
 * GIL, calls one flat shim function and converts the result; no Python
 * types leak to callers. It never calls Py_Finalize: tearing down torch's
 * CUDA state at interpreter exit is a known source of crashes.
 */

#include "mlsl_tpu.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <mutex>

#include <string>

namespace {

PyObject* g_shim = nullptr;
std::once_flag g_init_flag;
bool g_owns_interpreter = false;
std::mutex g_err_mu;
std::string g_last_error;

void record_error_locked_gil() {
  /* Capture the pending Python exception as a string (GIL must be held). */
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    const char* tname = "";
    if (type != nullptr && PyType_Check(type))
      tname = reinterpret_cast<PyTypeObject*>(type)->tp_name;
    const char* text = nullptr;
    if (s != nullptr) text = PyUnicode_AsUTF8(s);
    {
      std::lock_guard<std::mutex> lk(g_err_mu);
      g_last_error = std::string(tname) + ": " +
                     (text != nullptr ? text : "<unprintable error>");
    }
    Py_XDECREF(s);
  }
  PyErr_Restore(type, value, tb);
  PyErr_Print();
}

void interpreter_init() {
  /* an interpreter that is already running (a Python program that loaded
   * this library with ctypes) is reused */
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_owns_interpreter = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  g_shim = PyImport_ImportModule("mlsl_tpu_torch.c_shim");
  if (g_shim == nullptr) {
    record_error_locked_gil();  // the most common failure: module not on path
    std::fprintf(stderr,
                 "mlsl_tpu_torch: failed to import mlsl_tpu_torch.c_shim "
                 "(is the repository root on PYTHONPATH?)\n");
  }
  PyGILState_Release(gil);
  if (g_owns_interpreter) {
    // Py_InitializeEx leaves this thread holding the GIL; release it so other
    // threads' PyGILState_Ensure can acquire (async start/test/wait from
    // multiple threads is the expected usage pattern).
    PyEval_SaveThread();
  }
}

/* Call shim.<name>(args...) where every arg and the result are int64. */
int64_t call_i(const char* name, std::initializer_list<int64_t> args,
               int64_t fail = MLSL_TPU_FAILURE) {
  std::call_once(g_init_flag, interpreter_init);
  if (g_shim == nullptr) return fail;
  PyGILState_STATE gil = PyGILState_Ensure();
  int64_t result = fail;
  PyObject* tuple = PyTuple_New(static_cast<Py_ssize_t>(args.size()));
  if (tuple == nullptr) {
    record_error_locked_gil();
    PyGILState_Release(gil);
    return fail;
  }
  Py_ssize_t i = 0;
  for (int64_t a : args) {
    PyObject* item = PyLong_FromLongLong(a);
    if (item == nullptr) {
      record_error_locked_gil();
      Py_DECREF(tuple);
      PyGILState_Release(gil);
      return fail;
    }
    PyTuple_SET_ITEM(tuple, i++, item);
  }
  PyObject* fn = PyObject_GetAttrString(g_shim, name);
  if (fn != nullptr) {
    PyObject* res = PyObject_CallObject(fn, tuple);
    if (res != nullptr) {
      result = PyLong_AsLongLong(res);
      if (PyErr_Occurred()) {
        record_error_locked_gil();
        result = fail;
      }
      Py_DECREF(res);
    } else {
      record_error_locked_gil();
    }
    Py_DECREF(fn);
  } else {
    record_error_locked_gil();
  }
  Py_DECREF(tuple);
  PyGILState_Release(gil);
  return result;
}

/* shim.dist_collective_start(dist, kind, addr, count, dt, op, root, group) */
mlsl_handle_t collective_start(mlsl_handle_t dist, const char* kind,
                               const void* send, int64_t count, int64_t dt,
                               int64_t op, int64_t root, int64_t group) {
  std::call_once(g_init_flag, interpreter_init);
  if (g_shim == nullptr) return 0;
  PyGILState_STATE gil = PyGILState_Ensure();
  mlsl_handle_t handle = 0;
  PyObject* res = PyObject_CallMethod(
      g_shim, "dist_collective_start", "LsLLLLLL", (long long)dist, kind,
      (long long)(intptr_t)send, (long long)count, (long long)dt, (long long)op,
      (long long)root, (long long)group);
  if (res != nullptr) {
    handle = (mlsl_handle_t)PyLong_AsUnsignedLongLong(res);
    if (PyErr_Occurred()) {
      record_error_locked_gil();
      handle = 0;
    }
    Py_DECREF(res);
  } else {
    record_error_locked_gil();
  }
  PyGILState_Release(gil);
  return handle;
}

}  // namespace

extern "C" {

int mlsl_environment_init(void) {
  return (int)call_i("env_init", {});
}

int mlsl_environment_finalize(void) {
  return (int)call_i("env_finalize", {});
}

int64_t mlsl_environment_get_process_count(void) {
  return call_i("env_process_count", {});
}

mlsl_handle_t mlsl_environment_create_distribution(int64_t d, int64_t m,
                                                   int64_t s) {
  return (mlsl_handle_t)call_i("env_create_distribution", {d, m, s}, 0);
}

mlsl_handle_t mlsl_environment_create_session(void) {
  return (mlsl_handle_t)call_i("env_create_session", {}, 0);
}

mlsl_handle_t mlsl_environment_create_distribution_with_colors(
    const int64_t* data_colors, const int64_t* model_colors, int64_t n) {
  return (mlsl_handle_t)call_i(
      "env_create_distribution_with_colors",
      {(int64_t)(intptr_t)data_colors, (int64_t)(intptr_t)model_colors, n}, 0);
}

int mlsl_environment_set_quantization_params(
    const char* lib_path, const char* quant_name, const char* dequant_name,
    const char* reduce_name, int64_t block_size, int64_t elem_in_block) {
  std::call_once(g_init_flag, interpreter_init);
  if (g_shim == nullptr) return MLSL_TPU_FAILURE;
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = MLSL_TPU_FAILURE;
  /* "z" maps NULL -> None, so absent names reach the core as defaults */
  PyObject* res = PyObject_CallMethod(
      g_shim, "env_set_quantization_params", "zzzzLL", lib_path, quant_name,
      dequant_name, reduce_name, (long long)block_size,
      (long long)elem_in_block);
  if (res != nullptr) {
    rc = (int)PyLong_AsLongLong(res);
    if (PyErr_Occurred()) {
      record_error_locked_gil();
      rc = MLSL_TPU_FAILURE;
    }
    Py_DECREF(res);
  } else {
    record_error_locked_gil();
  }
  PyGILState_Release(gil);
  return rc;
}

int64_t mlsl_distribution_get_process_count(mlsl_handle_t dist,
                                            mlsl_group_type_t group) {
  return call_i("dist_process_count", {(int64_t)dist, (int64_t)group});
}

int64_t mlsl_distribution_get_process_idx(mlsl_handle_t dist,
                                          mlsl_group_type_t group,
                                          int64_t global_idx) {
  return call_i("dist_process_idx", {(int64_t)dist, (int64_t)group, global_idx});
}

mlsl_handle_t mlsl_distribution_all_reduce(mlsl_handle_t dist, const void* send,
                                           int64_t count, mlsl_data_type_t dt,
                                           mlsl_reduction_t op,
                                           mlsl_group_type_t group) {
  return collective_start(dist, "allreduce", send, count, dt, op, 0, group);
}

mlsl_handle_t mlsl_distribution_bcast(mlsl_handle_t dist, const void* send,
                                      int64_t count, mlsl_data_type_t dt,
                                      int64_t root, mlsl_group_type_t group) {
  return collective_start(dist, "bcast", send, count, dt, 0, root, group);
}

mlsl_handle_t mlsl_distribution_all_gather(mlsl_handle_t dist, const void* send,
                                           int64_t send_count,
                                           mlsl_data_type_t dt,
                                           mlsl_group_type_t group) {
  return collective_start(dist, "allgather", send, send_count, dt, 0, 0, group);
}

mlsl_handle_t mlsl_distribution_reduce_scatter(
    mlsl_handle_t dist, const void* send, int64_t send_count,
    mlsl_data_type_t dt, mlsl_reduction_t op, mlsl_group_type_t group) {
  return collective_start(dist, "reduce_scatter", send, send_count, dt, op, 0,
                          group);
}

mlsl_handle_t mlsl_distribution_all_to_all(mlsl_handle_t dist, const void* send,
                                           int64_t send_count,
                                           mlsl_data_type_t dt,
                                           mlsl_group_type_t group) {
  return collective_start(dist, "alltoall", send, send_count, dt, 0, 0, group);
}

mlsl_handle_t mlsl_distribution_reduce(mlsl_handle_t dist, const void* send,
                                       int64_t count, mlsl_data_type_t dt,
                                       mlsl_reduction_t op, int64_t root,
                                       mlsl_group_type_t group) {
  return collective_start(dist, "reduce", send, count, dt, op, root, group);
}

mlsl_handle_t mlsl_distribution_gather(mlsl_handle_t dist, const void* send,
                                       int64_t send_count, mlsl_data_type_t dt,
                                       int64_t root, mlsl_group_type_t group) {
  return collective_start(dist, "gather", send, send_count, dt, 0, root, group);
}

mlsl_handle_t mlsl_distribution_scatter(mlsl_handle_t dist, const void* send,
                                        int64_t send_count, mlsl_data_type_t dt,
                                        int64_t root, mlsl_group_type_t group) {
  return collective_start(dist, "scatter", send, send_count, dt, 0, root, group);
}

mlsl_handle_t mlsl_distribution_send_recv_list(mlsl_handle_t dist,
                                               const void* send, int64_t count,
                                               mlsl_data_type_t dt,
                                               const int64_t* pairs,
                                               int64_t n_pairs,
                                               mlsl_group_type_t group) {
  return (mlsl_handle_t)call_i(
      "dist_send_recv_list",
      {(int64_t)dist, (int64_t)(intptr_t)send, count, (int64_t)dt,
       (int64_t)(intptr_t)pairs, n_pairs, (int64_t)group},
      0);
}

int mlsl_distribution_barrier(mlsl_handle_t dist, mlsl_group_type_t group) {
  return (int)call_i("dist_barrier", {(int64_t)dist, (int64_t)group});
}

int mlsl_request_wait(mlsl_handle_t req, void* recv, int64_t recv_count,
                      mlsl_data_type_t dt) {
  return (int)call_i("request_wait",
                     {(int64_t)req, (int64_t)(intptr_t)recv, recv_count,
                      (int64_t)dt});
}

int mlsl_request_test(mlsl_handle_t req) {
  return (int)call_i("request_test", {(int64_t)req});
}

int mlsl_session_set_global_minibatch_size(mlsl_handle_t sess, int64_t size) {
  return (int)call_i("session_set_minibatch", {(int64_t)sess, size});
}

mlsl_handle_t mlsl_session_create_operation_reg_info(mlsl_handle_t sess,
                                                     mlsl_op_type_t op_type) {
  return (mlsl_handle_t)call_i("session_create_reginfo",
                               {(int64_t)sess, (int64_t)op_type}, 0);
}

int64_t mlsl_operation_reg_info_add_input(mlsl_handle_t reg, int64_t count,
                                          int64_t size, mlsl_data_type_t dt) {
  return call_i("reginfo_add_input", {(int64_t)reg, count, size, (int64_t)dt});
}

int64_t mlsl_operation_reg_info_add_output(mlsl_handle_t reg, int64_t count,
                                           int64_t size, mlsl_data_type_t dt) {
  return call_i("reginfo_add_output", {(int64_t)reg, count, size, (int64_t)dt});
}

int64_t mlsl_operation_reg_info_add_parameter_set(
    mlsl_handle_t reg, int64_t kernel_count, int64_t kernel_size,
    mlsl_data_type_t dt, int dist_update, mlsl_compression_t comp) {
  return call_i("reginfo_add_parameter_set",
                {(int64_t)reg, kernel_count, kernel_size, (int64_t)dt,
                 (int64_t)dist_update, (int64_t)comp});
}

mlsl_handle_t mlsl_session_add_operation(mlsl_handle_t sess, mlsl_handle_t reg,
                                         mlsl_handle_t dist) {
  return (mlsl_handle_t)call_i(
      "session_add_operation", {(int64_t)sess, (int64_t)reg, (int64_t)dist}, 0);
}

int mlsl_session_commit(mlsl_handle_t sess) {
  return (int)call_i("session_commit", {(int64_t)sess});
}

int mlsl_operation_set_next(mlsl_handle_t op, mlsl_handle_t next,
                            int64_t out_idx, int64_t in_idx) {
  return (int)call_i("operation_set_next",
                     {(int64_t)op, (int64_t)next, out_idx, in_idx});
}

int mlsl_operation_set_prev(mlsl_handle_t op, mlsl_handle_t prev,
                            int64_t in_idx, int64_t prev_out_idx) {
  return (int)call_i("operation_set_prev",
                     {(int64_t)op, (int64_t)prev, in_idx, prev_out_idx});
}

int64_t mlsl_operation_get_local_minibatch_size(mlsl_handle_t op) {
  return call_i("operation_local_minibatch", {(int64_t)op});
}

int64_t mlsl_operation_get_global_minibatch_size(mlsl_handle_t op) {
  return call_i("operation_global_minibatch", {(int64_t)op});
}

int64_t mlsl_operation_get_parameter_local_count(mlsl_handle_t op,
                                                 int64_t idx) {
  return call_i("operation_param_local_count", {(int64_t)op, idx});
}

int64_t mlsl_operation_get_parameter_owned_count(mlsl_handle_t op,
                                                 int64_t idx) {
  return call_i("operation_param_owned_count", {(int64_t)op, idx});
}

mlsl_handle_t mlsl_distribution_all_gatherv(mlsl_handle_t dist,
                                            const void* send,
                                            int64_t send_count,
                                            const int64_t* recv_counts,
                                            mlsl_data_type_t dt,
                                            mlsl_group_type_t group) {
  return (mlsl_handle_t)call_i(
      "dist_all_gatherv",
      {(int64_t)dist, (int64_t)(intptr_t)send, send_count,
       (int64_t)(intptr_t)recv_counts, (int64_t)dt, (int64_t)group},
      0);
}

mlsl_handle_t mlsl_distribution_all_to_allv(mlsl_handle_t dist,
                                            const void* send, int64_t send_len,
                                            const int64_t* send_counts,
                                            const int64_t* send_offsets,
                                            const int64_t* recv_offsets,
                                            mlsl_data_type_t dt,
                                            mlsl_group_type_t group) {
  return (mlsl_handle_t)call_i(
      "dist_all_to_allv",
      {(int64_t)dist, (int64_t)(intptr_t)send, send_len,
       (int64_t)(intptr_t)send_counts, (int64_t)(intptr_t)send_offsets,
       (int64_t)(intptr_t)recv_offsets, (int64_t)dt, (int64_t)group},
      0);
}

mlsl_handle_t mlsl_distribution_all_to_allv_full(
    mlsl_handle_t dist, const void* send, int64_t send_len,
    const int64_t* send_counts, const int64_t* send_offsets,
    const int64_t* recv_counts, const int64_t* recv_offsets,
    mlsl_data_type_t dt, mlsl_group_type_t group) {
  return (mlsl_handle_t)call_i(
      "dist_all_to_allv_full",
      {(int64_t)dist, (int64_t)(intptr_t)send, send_len,
       (int64_t)(intptr_t)send_counts, (int64_t)(intptr_t)send_offsets,
       (int64_t)(intptr_t)recv_counts, (int64_t)(intptr_t)recv_offsets,
       (int64_t)dt, (int64_t)group},
      0);
}

int64_t mlsl_operation_get_input_count(mlsl_handle_t op) {
  return call_i("operation_input_count", {(int64_t)op});
}

int64_t mlsl_operation_get_output_count(mlsl_handle_t op) {
  return call_i("operation_output_count", {(int64_t)op});
}

mlsl_handle_t mlsl_operation_get_input(mlsl_handle_t op, int64_t idx) {
  return (mlsl_handle_t)call_i("operation_get_input", {(int64_t)op, idx}, 0);
}

mlsl_handle_t mlsl_operation_get_output(mlsl_handle_t op, int64_t idx) {
  return (mlsl_handle_t)call_i("operation_get_output", {(int64_t)op, idx}, 0);
}

int64_t mlsl_activation_get_global_fm_count(mlsl_handle_t act) {
  return call_i("activation_query", {(int64_t)act, 0});
}

int64_t mlsl_activation_get_local_fm_count(mlsl_handle_t act) {
  return call_i("activation_query", {(int64_t)act, 1});
}

int64_t mlsl_activation_get_fm_size(mlsl_handle_t act) {
  return call_i("activation_query", {(int64_t)act, 2});
}

int64_t mlsl_activation_get_global_fm_offset(mlsl_handle_t act,
                                             int64_t model_idx) {
  return call_i("activation_fm_offset", {(int64_t)act, model_idx});
}

int mlsl_activation_needs_comm(mlsl_handle_t act) {
  return (int)call_i("activation_query", {(int64_t)act, 6});
}

int64_t mlsl_activation_get_wire_count(mlsl_handle_t act) {
  return call_i("activation_query", {(int64_t)act, 7});
}

int64_t mlsl_activation_get_recv_count(mlsl_handle_t act) {
  return call_i("activation_query", {(int64_t)act, 8});
}

int64_t mlsl_activation_get_pack_block_count(mlsl_handle_t act) {
  return call_i("activation_query", {(int64_t)act, 3});
}

int64_t mlsl_activation_get_unpack_block_count(mlsl_handle_t act) {
  return call_i("activation_query", {(int64_t)act, 4});
}

int64_t mlsl_activation_get_pack_block(mlsl_handle_t act, int64_t idx,
                                       int field) {
  return call_i("activation_block_query", {(int64_t)act, 0, idx, (int64_t)field});
}

int64_t mlsl_activation_get_unpack_block(mlsl_handle_t act, int64_t idx,
                                         int field) {
  return call_i("activation_block_query", {(int64_t)act, 1, idx, (int64_t)field});
}

int mlsl_activation_start_comm(mlsl_handle_t act, const void* buf,
                               mlsl_data_type_t dt) {
  return (int)call_i("activation_start_comm",
                     {(int64_t)act, (int64_t)(intptr_t)buf, (int64_t)dt});
}

int64_t mlsl_activation_wait_comm(mlsl_handle_t act, void* recv,
                                  mlsl_data_type_t dt) {
  return call_i("activation_wait_comm",
                {(int64_t)act, (int64_t)(intptr_t)recv, (int64_t)dt});
}

int mlsl_parameter_set_test_gradient_comm(mlsl_handle_t op, int64_t ps_idx) {
  return (int)call_i("param_test_gradient_comm", {(int64_t)op, ps_idx});
}

int mlsl_parameter_set_start_increment_comm(mlsl_handle_t op, int64_t ps_idx,
                                            const void* incs,
                                            mlsl_data_type_t dt) {
  return (int)call_i(
      "param_start_increment_comm",
      {(int64_t)op, ps_idx, (int64_t)(intptr_t)incs, (int64_t)dt});
}

int64_t mlsl_parameter_set_wait_increment_comm(mlsl_handle_t op, int64_t ps_idx,
                                               void* recv,
                                               mlsl_data_type_t dt) {
  return call_i("param_wait_increment_comm",
                {(int64_t)op, ps_idx, (int64_t)(intptr_t)recv, (int64_t)dt});
}

int64_t mlsl_parameter_set_get_global_kernel_count(mlsl_handle_t op,
                                                   int64_t ps_idx) {
  return call_i("param_query", {(int64_t)op, ps_idx, 0});
}

int64_t mlsl_parameter_set_get_local_kernel_count(mlsl_handle_t op,
                                                  int64_t ps_idx) {
  return call_i("param_query", {(int64_t)op, ps_idx, 1});
}

int64_t mlsl_parameter_set_get_owned_kernel_count(mlsl_handle_t op,
                                                  int64_t ps_idx) {
  return call_i("param_query", {(int64_t)op, ps_idx, 2});
}

int64_t mlsl_parameter_set_get_owned_kernel_offset(mlsl_handle_t op,
                                                   int64_t ps_idx,
                                                   int64_t data_idx) {
  return call_i("param_owned_offset", {(int64_t)op, ps_idx, data_idx});
}

int64_t mlsl_parameter_set_get_kernel_size(mlsl_handle_t op, int64_t ps_idx) {
  return call_i("param_query", {(int64_t)op, ps_idx, 3});
}

int mlsl_parameter_set_is_distributed_update(mlsl_handle_t op, int64_t ps_idx) {
  return (int)call_i("param_query", {(int64_t)op, ps_idx, 4});
}

mlsl_handle_t mlsl_session_get_stats(mlsl_handle_t sess) {
  return (mlsl_handle_t)call_i("session_get_stats", {(int64_t)sess}, 0);
}

int mlsl_statistics_start(mlsl_handle_t stats) {
  return (int)call_i("stats_control", {(int64_t)stats, 0});
}

int mlsl_statistics_stop(mlsl_handle_t stats) {
  return (int)call_i("stats_control", {(int64_t)stats, 1});
}

int mlsl_statistics_reset(mlsl_handle_t stats) {
  return (int)call_i("stats_control", {(int64_t)stats, 2});
}

int mlsl_statistics_is_enabled(mlsl_handle_t stats) {
  return (int)call_i("stats_control", {(int64_t)stats, 3});
}

int mlsl_statistics_is_started(mlsl_handle_t stats) {
  return (int)call_i("stats_control", {(int64_t)stats, 4});
}

int64_t mlsl_statistics_get_comm_size(mlsl_handle_t stats, int64_t op_idx) {
  return call_i("stats_query", {(int64_t)stats, 0, op_idx});
}

int64_t mlsl_statistics_get_comm_cycles(mlsl_handle_t stats, int64_t op_idx) {
  return call_i("stats_query", {(int64_t)stats, 1, op_idx});
}

int64_t mlsl_statistics_get_compute_cycles(mlsl_handle_t stats,
                                           int64_t op_idx) {
  return call_i("stats_query", {(int64_t)stats, 2, op_idx});
}

int64_t mlsl_statistics_get_isolation_comm_cycles(mlsl_handle_t stats,
                                                  int64_t op_idx) {
  return call_i("stats_query", {(int64_t)stats, 3, op_idx});
}

int64_t mlsl_statistics_get_total_comm_size(mlsl_handle_t stats) {
  return call_i("stats_query", {(int64_t)stats, 0, -1});
}

int64_t mlsl_statistics_get_total_comm_cycles(mlsl_handle_t stats) {
  return call_i("stats_query", {(int64_t)stats, 1, -1});
}

int64_t mlsl_statistics_get_total_compute_cycles(mlsl_handle_t stats) {
  return call_i("stats_query", {(int64_t)stats, 2, -1});
}

int64_t mlsl_statistics_get_total_isolation_comm_cycles(mlsl_handle_t stats) {
  return call_i("stats_query", {(int64_t)stats, 3, -1});
}

int64_t mlsl_statistics_get_overlap_permille(mlsl_handle_t stats,
                                              int64_t op_idx) {
  return call_i("stats_query", {(int64_t)stats, 4, op_idx}, -1);
}

int mlsl_statistics_print(mlsl_handle_t stats) {
  return (int)call_i("stats_print", {(int64_t)stats});
}

int mlsl_parameter_set_start_gradient_comm(mlsl_handle_t op, int64_t ps_idx,
                                           const void* grads,
                                           mlsl_data_type_t dt) {
  return (int)call_i(
      "param_start_gradient_comm",
      {(int64_t)op, ps_idx, (int64_t)(intptr_t)grads, (int64_t)dt});
}

int64_t mlsl_parameter_set_wait_gradient_comm(mlsl_handle_t op, int64_t ps_idx,
                                              void* recv, mlsl_data_type_t dt) {
  return call_i("param_wait_gradient_comm",
                {(int64_t)op, ps_idx, (int64_t)(intptr_t)recv, (int64_t)dt});
}

int mlsl_handle_release(mlsl_handle_t h) {
  return (int)call_i("handle_release", {(int64_t)h});
}

const char* mlsl_get_last_error(void) {
  // Copy under the lock into a thread-local so the returned pointer stays
  // valid for this thread even if another thread's failure reassigns the
  // shared string concurrently.
  static thread_local std::string tl_copy;
  {
    std::lock_guard<std::mutex> lk(g_err_mu);
    tl_copy = g_last_error;
  }
  return tl_copy.c_str();
}

}  /* extern "C" */
