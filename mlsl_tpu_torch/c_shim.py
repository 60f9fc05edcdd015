"""Flat-function shim behind the port's C entry (mlsl_tpu_torch/capi/c_api.cpp).

Counterpart of ``mlsl_tpu.c_shim``, function for function and under the same
names and signatures: the C entry calls them by name. Handles are integers
into a registry. A C caller hands the whole world's buffer, logical shape
(world, count), as a raw address, and receives results the same way.

Buffers cross the boundary as copies. Start copies the caller's buffer into
a tensor on the Environment's device, so the caller may overwrite it before
Wait: on the card the host -> card copy from pageable memory has read the
host buffer when ``.to()`` returns, and on the CPU the rows are cloned. Wait
copies the result card -> host into the caller's buffer, synchronously.
``MLSL_DT_BF16`` has no numpy type: it crosses as ``int16`` and is re-viewed
as ``torch.bfloat16``.

``TIMINGS`` accumulates the host seconds spent in those two copies, to split
a C call's time into the copies and the collective.
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.types import (
    CompressionType,
    DataType,
    GroupType,
    OpType,
    QuantParams,
    ReductionType,
    torch_dtype,
)

_registry: dict = {}
_next_id = 1
_lock = threading.Lock()

# host seconds in the copies of world buffers: into the device at Start,
# out of it at Wait
TIMINGS = {"h2d_s": 0.0, "d2h_s": 0.0}


def reset_timings() -> None:
    for k in TIMINGS:
        TIMINGS[k] = 0.0


def _put(obj) -> int:
    global _next_id
    with _lock:
        hid = _next_id
        _next_id += 1
        _registry[hid] = obj
    return hid


def _get(hid: int):
    return _registry[int(hid)]


def _release(hid: int) -> int:
    _registry.pop(int(hid), None)
    return 0


# ---- environment ----

def env_init() -> int:
    from mlsl_tpu_torch.sysinfo import platform_override

    Environment.get_env().init(device=platform_override())
    return 0


def env_finalize() -> int:
    Environment.get_env().finalize()
    return 0


def env_process_count() -> int:
    return Environment.get_env().get_process_count()


def env_create_distribution(data_parts: int, model_parts: int, seq_parts: int) -> int:
    env = Environment.get_env()
    return _put(env.create_distribution(data_parts, model_parts, seq_parts=seq_parts))


def env_create_distribution_with_colors(
    data_addr: int, model_addr: int, n: int
) -> int:
    """Color-defined process groups (reference CreateDistributionWithColors,
    include/mlsl.hpp:864): int64[n] per-rank color vectors at the given
    addresses; ranks sharing a data/model color form that group."""
    data = tuple(int(c) for c in _read_i64_array(data_addr, int(n)))
    model = tuple(int(c) for c in _read_i64_array(model_addr, int(n)))
    env = Environment.get_env()
    return _put(env.create_distribution_with_colors(data, model))


def env_create_session() -> int:
    return _put(Environment.get_env().create_session())


def env_set_quantization_params(
    lib_path, quant_name, dequant_name, reduce_name,
    block_size: int, elem_in_block: int,
) -> int:
    """Register codec parameters (reference src/mlsl.cpp:798): the built-in
    int8 codec's geometry, or with ``lib_path`` a library of the reference's
    ABI, loaded by ``comm.codec.load_library_codec``. A library that cannot
    be opened, resolved or probed raises ``MLSLError``, which reaches the
    caller as MLSL_TPU_FAILURE with the message in mlsl_get_last_error()."""
    Environment.get_env().set_quantization_params(QuantParams(
        block_size=int(block_size) if block_size else 256,
        elem_in_block=int(elem_in_block) if elem_in_block else 256,
        lib_path=lib_path or None,
        quant_buffer_func_name=quant_name or None,
        dequant_buffer_func_name=dequant_name or None,
        reduce_sum_func_name=reduce_name or None,
    ))
    return 0


# ---- buffers: address <-> tensor ----

def _host_rows(addr: int, world: int, count: int, data_type: int) -> torch.Tensor:
    """The caller's memory at ``addr`` as a (world, count) CPU tensor of the
    data type, aliasing it (no copy)."""
    dt = torch_dtype(DataType(data_type))
    carrier = np.int16 if dt == torch.bfloat16 else torch.empty((), dtype=dt).numpy().dtype
    nbytes = world * count * np.dtype(carrier).itemsize
    raw = np.ctypeslib.as_array(ctypes.cast(int(addr), ctypes.POINTER(ctypes.c_char)),
                                shape=(nbytes,))
    rows = torch.from_numpy(raw.view(carrier)).view(world, count)
    return rows.view(torch.bfloat16) if dt == torch.bfloat16 else rows


def _read_world_buffer(dist, addr: int, count: int, data_type: int) -> torch.Tensor:
    """C buffer at ``addr``, logical shape (world, count) -> a distributed
    buffer (R, D, S, M, count) of its own on the Environment's device."""
    t0 = time.perf_counter()
    rows = _host_rows(addr, dist.get_process_count_global(), count, data_type)
    rows = rows.reshape(*dist.world_shape, count)
    out = rows.clone() if dist.device.type == "cpu" else rows.to(dist.device)
    TIMINGS["h2d_s"] += time.perf_counter() - t0
    return out


def _write_world_buffer(dist, result, addr: int, count: int, data_type: int) -> int:
    """The first ``count`` elements of each rank's row of ``result`` into the
    caller's (world, count) buffer at ``addr``, synchronously."""
    world = dist.get_process_count_global()
    rows = result.reshape(world, -1)
    if rows.is_cuda:
        # the copy waits for the collective anyway: wait first, so that
        # TIMINGS["d2h_s"] holds the copy alone
        torch.cuda.current_stream(rows.device).synchronize()
    t0 = time.perf_counter()
    out = _host_rows(addr, world, count, data_type)
    n = min(count, rows.shape[1])
    out[:, :n].copy_(rows[:, :n].to(out.dtype))
    TIMINGS["d2h_s"] += time.perf_counter() - t0
    return 0


# ---- distribution collectives (sync + async) ----

def dist_collective_start(
    dist_h: int, kind: str, addr: int, count: int, data_type: int,
    op: int, root: int, group: int,
) -> int:
    dist = _get(dist_h)
    buf = _read_world_buffer(dist, addr, count, data_type)
    gt = GroupType(group)
    if kind == "allreduce":
        req = dist.all_reduce(buf, count, data_type, ReductionType(op), gt)
    elif kind == "bcast":
        req = dist.bcast(buf, count, data_type, root, gt)
    elif kind == "reduce":
        req = dist.reduce(buf, count, data_type, ReductionType(op), root, gt)
    elif kind == "allgather":
        req = dist.all_gather(buf, count, data_type, gt)
    elif kind == "gather":
        req = dist.gather(buf, count, data_type, root, gt)
    elif kind in ("scatter", "reduce_scatter", "alltoall"):
        gsize = dist.get_process_count(gt)
        mlsl_assert(
            count % gsize == 0,
            "%s send count %d must be divisible by group size %d",
            kind, count, gsize,
        )
        per = count // gsize
        if kind == "scatter":
            req = dist.scatter(buf, per, data_type, root, gt)
        elif kind == "reduce_scatter":
            req = dist.reduce_scatter(buf, per, data_type, ReductionType(op), gt)
        else:
            req = dist.all_to_all(buf, per, data_type, gt)
    else:
        raise ValueError(f"unknown collective {kind}")
    return _put((dist, req))


def request_wait(req_h: int, out_addr: int, out_count: int, data_type: int) -> int:
    dist, req = _get(req_h)
    result = Environment.get_env().wait(req)
    _write_world_buffer(dist, result, out_addr, out_count, data_type)
    _release(req_h)
    return 0


def request_test(req_h: int) -> int:
    """1 if complete, 0 otherwise. Non-consuming: a later request_wait still
    delivers the result (the request keeps it on test completion)."""
    dist, req = _get(req_h)
    done, _ = req.test()
    return 1 if done else 0


def dist_send_recv_list(
    dist_h: int, addr: int, count: int, data_type: int,
    pairs_addr: int, n_pairs: int, group: int,
) -> int:
    """pairs_addr: int64 array [src0, dst0, src1, dst1, ...] of length 2*n_pairs."""
    dist = _get(dist_h)
    flat = _read_i64_array(pairs_addr, 2 * int(n_pairs))
    pairs = [(int(flat[2 * i]), int(flat[2 * i + 1])) for i in range(int(n_pairs))]
    buf = _read_world_buffer(dist, addr, count, data_type)
    req = dist.send_recv_list(buf, count, data_type, pairs, GroupType(group))
    return _put((dist, req))


def dist_barrier(dist_h: int, group: int) -> int:
    _get(dist_h).barrier(GroupType(group))
    return 0


def dist_process_count(dist_h: int, group: int) -> int:
    return _get(dist_h).get_process_count(GroupType(group))


def dist_process_idx(dist_h: int, group: int, global_idx: int) -> int:
    """Member index of world rank ``global_idx`` within the group -- the
    per-rank GetProcessIdx (reference include/mlsl.hpp:361) with the rank
    explicit."""
    return _get(dist_h).get_process_idx(GroupType(group), global_idx)


# ---- session graph ----

def session_set_minibatch(sess_h: int, size: int) -> int:
    _get(sess_h).set_global_minibatch_size(size)
    return 0


def session_create_reginfo(sess_h: int, op_type: int) -> int:
    return _put(_get(sess_h).create_operation_reg_info(OpType(op_type)))


def reginfo_add_input(reg_h: int, count: int, size: int, data_type: int) -> int:
    return _get(reg_h).add_input(count, size, DataType(data_type))


def reginfo_add_output(reg_h: int, count: int, size: int, data_type: int) -> int:
    return _get(reg_h).add_output(count, size, DataType(data_type))


def reginfo_add_parameter_set(
    reg_h: int, count: int, size: int, data_type: int, dist_update: int, compression: int
) -> int:
    return _get(reg_h).add_parameter_set(
        count, size, DataType(data_type),
        distributed_update=bool(dist_update),
        compression_type=CompressionType(compression),
    )


def session_add_operation(sess_h: int, reg_h: int, dist_h: int) -> int:
    sess = _get(sess_h)
    idx = sess.add_operation(_get(reg_h), _get(dist_h))
    return _put(sess.get_operation(idx))


def session_commit(sess_h: int) -> int:
    _get(sess_h).commit()
    return 0


def operation_set_next(op_h: int, next_h: int, out_idx: int, in_idx: int) -> int:
    _get(op_h).set_next(_get(next_h), out_idx, in_idx)
    return 0


def operation_set_prev(op_h: int, prev_h: int, in_idx: int, prev_out_idx: int) -> int:
    _get(op_h).set_prev(_get(prev_h), in_idx, prev_out_idx)
    return 0


def operation_local_minibatch(op_h: int) -> int:
    return _get(op_h).get_local_minibatch_size()


def operation_global_minibatch(op_h: int) -> int:
    return _get(op_h).get_global_minibatch_size()


def operation_param_local_count(op_h: int, ps_idx: int) -> int:
    ps = _get(op_h).get_parameter_set(ps_idx)
    return ps.get_local_kernel_count() * ps.get_kernel_size()


def operation_param_owned_count(op_h: int, ps_idx: int) -> int:
    ps = _get(op_h).get_parameter_set(ps_idx)
    return ps.get_owned_kernel_count() * ps.get_kernel_size()


# ---- activations (reference c_bind.cpp activation wrappers over
# include/mlsl.hpp:210-268) ----

def operation_get_input(op_h: int, idx: int) -> int:
    return _put(_get(op_h).get_input(idx))


def operation_get_output(op_h: int, idx: int) -> int:
    return _put(_get(op_h).get_output(idx))


def operation_input_count(op_h: int) -> int:
    return _get(op_h).get_input_count()


def operation_output_count(op_h: int) -> int:
    return _get(op_h).get_output_count()


def activation_query(act_h: int, what: int) -> int:
    """what: 0=global_fm_count 1=local_fm_count 2=fm_size 3=pack_block_count
    4=unpack_block_count 5=comm_buf_size 6=need_comm 7=send_count
    8=recv_count."""
    act = _get(act_h)
    queries = (
        act.get_global_fm_count, act.get_local_fm_count, act.get_fm_size,
        act.get_pack_block_count, act.get_unpack_block_count, act.get_comm_buf_size,
        lambda: int(act.need_comm), lambda: _act_wire_count(act),
        lambda: _act_recv_count(act),
    )
    if not 0 <= what < len(queries):
        raise ValueError(f"unknown activation query {what}")
    return queries[what]()


def _group_size(group) -> int:
    return 1 if group.is_self else group.size


def _act_wire_count(act) -> int:
    """Per-rank wire-buffer element count of this activation's request (an
    alltoall request's ``desc.count`` is the per-member block; the buffer
    holds one block per group member)."""
    req = act.comm_req
    if req is None:
        return 0
    if req.desc.kind == "alltoall":
        return req.desc.count * _group_size(req.desc.group)
    return req.desc.count


def _act_recv_count(act) -> int:
    """Per-rank element count of this activation's request result (what the
    peer's wait_comm delivers): sizes the C caller's receive buffer."""
    req = act.comm_req
    if req is None:
        return 0
    kind = req.desc.kind
    if kind in ("allgather", "alltoall"):
        return req.desc.count * _group_size(req.desc.group)
    if kind == "reduce_scatter":
        return req.desc.recv_count
    return req.desc.count  # allreduce


def activation_fm_offset(act_h: int, model_idx: int) -> int:
    """Per-rank GetGlobalFmOffset (reference include/mlsl.hpp:219) with the
    rank's model-group index explicit."""
    return _get(act_h).get_global_fm_offset(model_idx)


def activation_block_query(act_h: int, is_unpack: int, idx: int, field: int) -> int:
    """field: 0=mb_offset 1=mb_count 2=fm_offset 3=fm_count 4=fm_size
    5=buf_offset (reference CommBlockInfo include/mlsl.hpp:177-204)."""
    act = _get(act_h)
    b = (act.unpack_blocks if is_unpack else act.pack_blocks)[idx]
    return (b.mb_offset, b.mb_count, b.fm_offset, b.fm_count,
            b.fm_size, b.buf_offset)[field]


def activation_start_comm(act_h: int, addr: int, data_type: int) -> int:
    act = _get(act_h)
    n = _act_wire_count(act)
    if n == 0:
        return 0  # no comm on this edge (reference: no-op start)
    buf = _read_world_buffer(act.dist, addr, n, data_type)
    act.start_comm(buf)
    return 0


def activation_wait_comm(act_h: int, out_addr: int, data_type: int) -> int:
    """Waits the PEER's transfer (reference invariant) and writes (world, n);
    returns per-rank n (0 = no comm on this edge)."""
    act = _get(act_h)
    out = act.wait_comm()
    if out is None:
        return 0
    n = int(out.shape[-1])
    peer = act.peer_act
    dist = peer.dist if peer is not None else act.dist
    _write_world_buffer(dist, out, out_addr, n, data_type)
    return n


# ---- v-collectives (reference mlsl.hpp:418-471 AllGatherv/AlltoAllv) ----

def _read_i64_array(addr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array(
        ctypes.cast(int(addr), ctypes.POINTER(ctypes.c_int64)), shape=(int(n),)
    ).copy()


def dist_all_gatherv(dist_h: int, addr: int, send_count: int,
                     recv_counts_addr: int, data_type: int, group: int) -> int:
    """recv_counts: int64[group_size], the same on every rank (MPI
    semantics); the send buffer is (world, send_count) with rank p's first
    recv_counts[member_idx(p)] elements valid."""
    dist = _get(dist_h)
    gt = GroupType(group)
    counts = tuple(int(c) for c in _read_i64_array(recv_counts_addr,
                                                   dist.get_process_count(gt)))
    buf = _read_world_buffer(dist, addr, send_count, data_type)
    req = dist.all_gatherv(buf, send_count, counts, data_type, gt)
    return _put((dist, req))


def dist_all_to_allv(dist_h: int, addr: int, send_len: int,
                     send_counts_addr: int, send_offsets_addr: int,
                     recv_offsets_addr: int, data_type: int, group: int) -> int:
    """MPI AlltoAllv with rank-uniform int64[group_size] count/displacement
    arrays (the 1-D 'same on every rank' mode, comm.request.normalize_alltoallv).
    Pass 0 for an offsets addr to use the packed default."""
    dist = _get(dist_h)
    gt = GroupType(group)
    gsize = dist.get_process_count(gt)
    counts = _read_i64_array(send_counts_addr, gsize)
    soff = _read_i64_array(send_offsets_addr, gsize) if send_offsets_addr else None
    roff = _read_i64_array(recv_offsets_addr, gsize) if recv_offsets_addr else None
    buf = _read_world_buffer(dist, addr, send_len, data_type)
    req = dist.all_to_allv(buf, counts, soff, None, roff, data_type, gt)
    return _put((dist, req))


def dist_all_to_allv_full(dist_h: int, addr: int, send_len: int,
                          send_counts_addr: int, send_offsets_addr: int,
                          recv_counts_addr: int, recv_offsets_addr: int,
                          data_type: int, group: int) -> int:
    """General per-rank AlltoAllv: int64[world * group] row-major tables, row
    w = world rank w's own count/displacement vectors. 0 addr = packed
    default offsets / derived recv counts."""
    dist = _get(dist_h)
    gt = GroupType(group)
    gsize = dist.get_process_count(gt)
    w = dist.topology.world_size

    def rd(a):
        return _read_i64_array(a, w * gsize).reshape(w, gsize) if a else None

    buf = _read_world_buffer(dist, addr, send_len, data_type)
    req = dist.all_to_allv(
        buf, rd(send_counts_addr), rd(send_offsets_addr),
        rd(recv_counts_addr), rd(recv_offsets_addr), data_type, gt,
    )
    return _put((dist, req))


# ---- statistics (reference mlsl.hpp:651-726, c_bind stats wrappers) ----

def session_get_stats(sess_h: int) -> int:
    return _put(_get(sess_h).get_stats())


def stats_control(stats_h: int, what: int) -> int:
    """what: 0=start 1=stop 2=reset 3=is_enabled 4=is_started."""
    st = _get(stats_h)
    if what == 0:
        st.start()
    elif what == 1:
        st.stop()
    elif what == 2:
        st.reset()
    elif what == 3:
        return int(st.is_enabled())
    elif what == 4:
        return int(st.is_started())
    else:
        raise ValueError(f"unknown stats control {what}")
    return 0


def stats_query(stats_h: int, what: int, op_idx: int) -> int:
    """what: 0=comm_size 1=comm_cycles 2=compute_cycles 3=isolation_comm_cycles
    4=overlap_permille (hidden/isolation x 1000; -1 until isolation stats and
    accounted steps exist). Per-op with op_idx >= 0, totals with op_idx < 0.
    Cycles are nanoseconds."""
    st = _get(stats_h)
    if what == 4:
        f = st.get_overlap_fraction(None if op_idx < 0 else int(op_idx))
        return -1 if f is None else int(round(f * 1000))
    if op_idx < 0:
        return (st.get_total_comm_size(), st.get_total_comm_cycles(),
                st.get_total_compute_cycles(),
                st.get_total_isolation_comm_cycles())[what]
    return (st.get_comm_size(op_idx), st.get_comm_cycles(op_idx),
            st.get_compute_cycles(op_idx),
            st.get_isolation_comm_cycles(op_idx))[what]


def stats_print(stats_h: int) -> int:
    _get(stats_h).print_()
    return 0


# ---- parameter sets (cont.) ----

def param_query(op_h: int, ps_idx: int, what: int) -> int:
    """what: 0=global_kernel_count 1=local_kernel_count 2=owned_kernel_count
    3=kernel_size 4=is_distributed_update."""
    ps = _get(op_h).get_parameter_set(ps_idx)
    return (ps.get_global_kernel_count(), ps.get_local_kernel_count(),
            ps.get_owned_kernel_count(), ps.get_kernel_size(),
            int(ps.is_distributed_update()))[what]


def param_owned_offset(op_h: int, ps_idx: int, data_idx: int) -> int:
    """Per-rank GetOwnedKernelOffset (reference include/mlsl.hpp:298) with the
    rank's data-group index explicit."""
    return _get(op_h).get_parameter_set(ps_idx).get_owned_kernel_offset(data_idx)


def param_test_gradient_comm(op_h: int, ps_idx: int) -> int:
    done, _ = _get(op_h).get_parameter_set(ps_idx).test_gradient_comm()
    return 1 if done else 0


def _param_start(op_h: int, ps_idx: int, addr: int, data_type: int, increment: bool) -> int:
    op = _get(op_h)
    ps = op.get_parameter_set(ps_idx)
    kernels = ps.get_owned_kernel_count() if increment else ps.get_local_kernel_count()
    buf = _read_world_buffer(op.distribution, addr, kernels * ps.get_kernel_size(),
                             data_type)
    if increment:
        ps.start_increment_comm(buf)
    else:
        ps.start_gradient_comm(buf)
    return 0


def _param_wait(op_h: int, ps_idx: int, out_addr: int, data_type: int,
                increment: bool) -> int:
    """-> the per-rank element count written (0 if no comm was needed)."""
    op = _get(op_h)
    ps = op.get_parameter_set(ps_idx)
    out = ps.wait_increment_comm() if increment else ps.wait_gradient_comm()
    if out is None:
        return 0
    n = int(out.shape[-1])
    _write_world_buffer(op.distribution, out, out_addr, n, data_type)
    return n


def param_start_increment_comm(op_h: int, ps_idx: int, addr: int, data_type: int) -> int:
    return _param_start(op_h, ps_idx, addr, data_type, increment=True)


def param_wait_increment_comm(op_h: int, ps_idx: int, out_addr: int, data_type: int) -> int:
    """Returns the per-rank element count written (0 if no comm was needed)."""
    return _param_wait(op_h, ps_idx, out_addr, data_type, increment=True)


def param_start_gradient_comm(op_h: int, ps_idx: int, addr: int, data_type: int) -> int:
    return _param_start(op_h, ps_idx, addr, data_type, increment=False)


def param_wait_gradient_comm(op_h: int, ps_idx: int, out_addr: int, data_type: int) -> int:
    """Returns the per-rank element count written (0 if no comm was needed)."""
    return _param_wait(op_h, ps_idx, out_addr, data_type, increment=False)


def handle_release(hid: int) -> int:
    return _release(hid)

