"""The port's C shim (mlsl_tpu_torch.c_shim) against the JAX package's
(mlsl_tpu.c_shim), function by function: the same numpy world buffers go to
both as raw addresses (``arr.ctypes.data``), as the C entry hands them, and
each shim writes into a result buffer of its own. 8 virtual ranks; the
collectives on a (4, 2) grid's data, model and global groups.

Tolerances: int32 and int8 payloads bit for bit; float32 sums on ``lax`` (the
default off the TPU, and the port's on the CPU) bit for bit, since both add
the members one by one in member order (ROADMAP C, sum orders); the ring
(``pallas_ring``, JAX under the Pallas interpreter) within rtol 1e-6; int8
gradient sums within one quantization step of default JAX (XLA's CPU
compiler rounds the codec's scale another way, ROADMAP C).
"""

import zlib

import numpy as np
import pytest
import torch

from mlsl_tpu import c_shim as jshim
from mlsl_tpu_torch import c_shim as tshim
from mlsl_tpu_torch.log import MLSLError

torch.set_num_threads(2)

WORLD = 8
FLOAT, INT8, INT32 = 0, 5, 6
SUM, MIN, MAX = 0, 1, 2
DATA, MODEL, GLOBAL = 0, 1, 2
GROUPS = {"data": DATA, "model": MODEL, "global": GLOBAL}
DTYPES = {FLOAT: np.float32, INT8: np.int8, INT32: np.int32}
CC, ACT = 0, 2
NONE, QUANT = 0, 1


class Pair:
    """One handle of each shim: the same object in the two registries."""

    def __init__(self, j, t):
        self.j, self.t = j, t


def call(name, *args):
    """``name`` on both shims; a Pair argument gives each shim its own half.
    -> (JAX's result, the port's)."""
    j = getattr(jshim, name)(*(a.j if isinstance(a, Pair) else a for a in args))
    t = getattr(tshim, name)(*(a.t if isinstance(a, Pair) else a for a in args))
    return j, t


def handle(name, *args):
    return Pair(*call(name, *args))


def same(name, *args):
    j, t = call(name, *args)
    assert j == t, (name, args, j, t)
    return t


@pytest.fixture()
def shims(monkeypatch):
    monkeypatch.setenv("MLSL_TPU_PLATFORM", "cpu")
    call("env_init")
    assert same("env_process_count") == WORLD
    yield
    call("env_finalize")


def _fill(shape, dt, seed):
    rng = np.random.default_rng(seed)
    if dt == FLOAT:
        return rng.standard_normal(shape).astype(np.float32)
    info = np.iinfo(DTYPES[dt])
    lo, hi = (info.min, info.max) if dt == INT8 else (-1000, 1000)
    return rng.integers(lo, hi, size=shape, endpoint=True).astype(DTYPES[dt])


def _outs(n, dt, fill=0):
    return [np.full((WORLD, n), fill, dtype=DTYPES[dt]) for _ in range(2)]


def _start_wait(start_name, start_args, out_n, dt):
    """Start on both shims (the handles differ), wait each into its own
    buffer. -> (JAX's result, the port's)."""
    req = handle(start_name, *start_args)
    assert req.j and req.t
    outs = _outs(out_n, dt, fill=-7)
    for side, out in zip(("j", "t"), outs):
        shim = jshim if side == "j" else tshim
        assert shim.request_wait(getattr(req, side), out.ctypes.data, out_n, dt) == 0
    return outs


def _assert_equal(j, t, what):
    np.testing.assert_array_equal(t.view(np.uint8), j.view(np.uint8), err_msg=what)


def _collective(dist, kind, group, dt, n=12, op=SUM, root=0):
    gsize = same("dist_process_count", dist, group)
    x = _fill((WORLD, n * gsize), dt, seed=zlib.crc32(repr((kind, group, dt, op)).encode()))
    if kind in ("scatter", "reduce_scatter", "alltoall"):
        count, out_n = n * gsize, n if kind != "alltoall" else n * gsize
    elif kind in ("allgather", "gather"):
        count, out_n = n, n * gsize
    else:
        count, out_n = n, n
    return _start_wait("dist_collective_start",
                       (dist, kind, x.ctypes.data, count, dt, op, root, group), out_n, dt)


KINDS = [("allreduce", SUM), ("allreduce", MIN), ("allreduce", MAX), ("bcast", SUM),
         ("reduce", SUM), ("allgather", SUM), ("gather", SUM), ("scatter", SUM),
         ("reduce_scatter", SUM), ("alltoall", SUM)]


@pytest.mark.parametrize("dt", [FLOAT, INT32], ids=["float32", "int32"])
@pytest.mark.parametrize("group", list(GROUPS), ids=list(GROUPS))
def test_collectives_match_jax(shims, group, dt):
    """Eight of the eleven kinds (allreduce with each op) through
    dist_collective_start; sendrecv, allgatherv and alltoallv below."""
    dist = handle("env_create_distribution", 4, 2, 1)
    for kind, op in KINDS:
        root = 1 if kind in ("bcast", "scatter") else 0
        j, t = _collective(dist, kind, GROUPS[group], dt, op=op, root=root)
        _assert_equal(j, t, f"{kind} op {op} on {group}")


def test_ring_allreduce_within_rtol(monkeypatch):
    """MLSL_ALGO=pallas_ring: JAX's kernel under the Pallas interpreter, the
    port's plain version of B3; float32 sums in the ring's order, within
    rtol 1e-6 of each other, integers bit for bit."""
    monkeypatch.setenv("MLSL_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("MLSL_ALGO", "pallas_ring")
    monkeypatch.setenv("MLSL_PALLAS_INTERPRET", "1")
    call("env_init")
    try:
        dist = handle("env_create_distribution", 4, 2, 1)
        for group in (DATA, MODEL):
            j, t = _collective(dist, "allreduce", group, FLOAT, n=1024)
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
            j, t = _collective(dist, "allreduce", group, INT32, n=1024)
            _assert_equal(j, t, "ring int32")
    finally:
        call("env_finalize")


@pytest.mark.parametrize("group", ["data", "model"])
def test_send_recv_list_matches_jax(shims, group):
    dist = handle("env_create_distribution", 4, 2, 1)
    g = same("dist_process_count", dist, GROUPS[group])
    pairs = np.array([v for i in range(g) for v in (i, (i + 1) % g)], dtype=np.int64)
    x = _fill((WORLD, 10), INT32, seed=3)
    j, t = _start_wait("dist_send_recv_list",
                       (dist, x.ctypes.data, 10, INT32, pairs.ctypes.data, g, GROUPS[group]),
                       10, INT32)
    _assert_equal(j, t, "sendrecv")


def test_v_collectives_match_jax(shims):
    """all_gatherv and all_to_allv (rank-uniform counts, with and without
    offsets) on the data group, and all_to_allv_full with per-rank tables on
    the model group, test_c_api.c's geometry."""
    dist = handle("env_create_distribution", 4, 2, 1)
    counts = np.array([3, 1, 4, 2], dtype=np.int64)
    x = _fill((WORLD, 4), FLOAT, seed=4)
    j, t = _start_wait("dist_all_gatherv",
                       (dist, x.ctypes.data, 4, counts.ctypes.data, FLOAT, DATA),
                       int(counts.sum()), FLOAT)
    _assert_equal(j, t, "allgatherv")

    a2a = np.array([2, 1, 3, 1], dtype=np.int64)
    send_len = int(a2a.sum())
    y = _fill((WORLD, send_len), INT32, seed=5)
    j, t = _start_wait("dist_all_to_allv",
                       (dist, y.ctypes.data, send_len, a2a.ctypes.data, 0, 0, INT32, DATA),
                       4 * int(a2a.max()), INT32)
    _assert_equal(j, t, "alltoallv packed")
    soff = np.array([0, 2, 3, 6], dtype=np.int64)
    roff = np.array([0, 4, 8, 12], dtype=np.int64)
    z = _fill((WORLD, 7), INT32, seed=6)
    j, t = _start_wait("dist_all_to_allv",
                       (dist, z.ctypes.data, 7, a2a.ctypes.data, soff.ctypes.data,
                        roff.ctypes.data, INT32, DATA), 16, INT32)
    _assert_equal(j, t, "alltoallv with offsets")

    g = 2
    s = np.array([[(3 * w + i) % 2 + 1 for i in range(g)] for w in range(WORLD)], np.int64)
    r = np.array([[s[w - w % g + i, w % g] for i in range(g)] for w in range(WORLD)], np.int64)
    send_slot, recv_slot = int(s.sum(1).max()), int(r.sum(1).max())
    f = _fill((WORLD, send_slot), FLOAT, seed=7)
    j, t = _start_wait("dist_all_to_allv_full",
                       (dist, f.ctypes.data, send_slot, s.ctypes.data, 0, r.ctypes.data, 0,
                        FLOAT, MODEL), recv_slot, FLOAT)
    _assert_equal(j, t, "alltoallv_full")


def test_colored_distribution_matches_jax(shims):
    """env_create_distribution_with_colors: equal and ragged color groups,
    their sizes, member indices and an allreduce and allgather on each."""
    for data, model in (([p % 2 for p in range(WORLD)], [p // 4 for p in range(WORLD)]),
                        ([0] * 3 + [1] * 5, [p % 2 for p in range(WORLD)])):
        dc, mc = np.array(data, np.int64), np.array(model, np.int64)
        dist = handle("env_create_distribution_with_colors", dc.ctypes.data, mc.ctypes.data,
                      WORLD)
        for group in (DATA, MODEL):
            same("dist_process_count", dist, group)
            for p in range(WORLD):
                same("dist_process_idx", dist, group, p)
            j, t = _collective(dist, "allreduce", group, FLOAT)
            _assert_equal(j, t, f"colored allreduce {data} {model}")
            j, t = _collective(dist, "allgather", group, INT32)
            _assert_equal(j, t, f"colored allgather {data} {model}")


def test_world_buffer_is_copied_at_start(shims):
    """A C caller may overwrite its buffer between Start and Wait: the
    request owns a copy taken at Start (the port on any device; JAX through
    device_put)."""
    dist = handle("env_create_distribution", WORLD, 1, 1)
    x = _fill((WORLD, 16), INT32, seed=8)
    want = np.broadcast_to(x.astype(np.int64).sum(0).astype(np.int32), x.shape)
    req = handle("dist_collective_start", dist, "allreduce", x.ctypes.data, 16, INT32, SUM,
                 0, DATA)
    x[:] = 12345
    for side, shim in (("j", jshim), ("t", tshim)):
        out = np.zeros_like(x)
        assert shim.request_wait(getattr(req, side), out.ctypes.data, 16, INT32) == 0
        np.testing.assert_array_equal(out, want, err_msg=side)


def test_bf16_crosses_as_int16(shims):
    """MLSL_DT_BF16 (3) has no numpy type: the port carries it as int16 and
    re-views it as bfloat16; an allgather moves the bits unchanged."""
    dist = handle("env_create_distribution", WORLD, 1, 1)
    bits = _fill((WORLD, 8), INT32, seed=9).astype(np.int16)
    out = np.zeros((WORLD, 8 * WORLD), np.int16)
    req = tshim.dist_collective_start(dist.t, "allgather", bits.ctypes.data, 8, 3, 0, 0, DATA)
    assert tshim.request_wait(req, out.ctypes.data, 8 * WORLD, 3) == 0
    np.testing.assert_array_equal(out, np.tile(bits.reshape(1, -1), (WORLD, 1)))


def _session(reg_specs, dists):
    """A session of one operation per (dist, inputs, outputs, param sets)."""
    sess = handle("env_create_session")
    same("session_set_minibatch", sess, 8)
    ops = []
    for d, (ins, outs, sets) in zip(dists, reg_specs):
        reg = handle("session_create_reginfo", sess, CC if sets else ACT)
        for fm, size in ins:
            same("reginfo_add_input", reg, fm, size, FLOAT)
        for fm, size in outs:
            same("reginfo_add_output", reg, fm, size, FLOAT)
        for count, du, comp in sets:
            same("reginfo_add_parameter_set", reg, count, 1, FLOAT, du, comp)
        ops.append(handle("session_add_operation", sess, reg, d))
    return sess, ops


@pytest.mark.parametrize("case", ["case1", "case2", "case3", "case4", "case5"])
def test_activation_peer_cases_match_jax(shims, case):
    """The five peer-connection cases of tests/test_torch_activation.py
    through the shim: every activation query and block, then FPROP (the
    output's Start, the input's Wait) and BPROP (the reverse)."""
    fm1, fm2, size = 16, 8, 4
    if case == "case1":
        d = handle("env_create_distribution", 4, 2, 1)
        specs, dists = [([(fm1, size)], [(fm2, size)], [(fm1 * fm2, 0, NONE)]),
                        ([(fm2, size)], [(fm1, size)], [(fm2 * fm1, 0, NONE)])], [d, d]
    else:
        grids = {"case2": ((4, 2), (4, 1)), "case3": ((4, 2), (8, 1)),
                 "case4": ((8, 1), (2, 4)), "case5": ((2, 4), (8, 1))}[case]
        dists = [handle("env_create_distribution", a, b, 1) for a, b in grids]
        fm = fm2 if case in ("case2", "case3") else fm1
        cc = case in ("case2", "case3")
        specs = [([(fm1, size)], [(fm, size)], [(fm1 * fm, 0, NONE)] if cc else []),
                 ([(fm, size)], [(fm, size)], [])]
    sess, (op1, op2) = _session(specs, dists)
    same("operation_set_next", op1, op2, 0, 0)
    same("session_commit", sess)
    out_act = handle("operation_get_output", op1, 0)
    in_act = handle("operation_get_input", op2, 0)
    for act in (out_act, in_act):
        for what in range(9):
            same("activation_query", act, what)
        for is_unpack, count_q in ((0, 3), (1, 4)):
            for idx in range(same("activation_query", act, count_q)):
                for field in range(6):
                    same("activation_block_query", act, is_unpack, idx, field)
        for m in range(same("dist_process_count", dists[0], MODEL)):
            same("activation_fm_offset", act, m)
    for src, dst, seed in ((out_act, in_act, 10), (in_act, out_act, 11)):
        n = same("activation_query", src, 7)
        if not n:
            continue
        recv = same("activation_query", src, 8)
        x = _fill((WORLD, n), FLOAT, seed=seed)
        call("activation_start_comm", src, x.ctypes.data, FLOAT)
        outs = _outs(max(recv, n), FLOAT, fill=-7)
        got = [shim.activation_wait_comm(getattr(dst, side), o.ctypes.data, FLOAT)
               for side, shim, o in (("j", jshim, outs[0]), ("t", tshim, outs[1]))]
        assert got[0] == got[1] == recv
        _assert_equal(outs[0][:, :recv], outs[1][:, :recv], f"{case} {n}")


@pytest.mark.parametrize("dist_update", [0, 1], ids=["replicated", "distributed_update"])
def test_gradient_and_increment_comm_match_jax(shims, dist_update):
    """test_c_api.c's two-operation session on (4, 2): each parameter set's
    counts and offsets, then gradient Start/Test/Wait and, under the
    distributed update, the increment Start/Wait."""
    d = handle("env_create_distribution", 4, 2, 1)
    specs = [([(8, 4)], [(8, 4)], [(64, 0, NONE)]),
             ([(8, 4)], [(8, 4)], [(64, dist_update, NONE), (30, dist_update, NONE)])]
    sess, (op1, op2) = _session(specs, [d, d])
    same("operation_set_next", op1, op2, 0, 0)
    same("session_commit", sess)
    for op in (op1, op2):
        same("operation_local_minibatch", op)
        same("operation_global_minibatch", op)
        same("operation_input_count", op)
        same("operation_output_count", op)
    for op, ps in ((op1, 0), (op2, 0), (op2, 1)):
        for what in range(5):
            same("param_query", op, ps, what)
        for di in range(4):
            same("param_owned_offset", op, ps, di)
        local = same("operation_param_local_count", op, ps)
        owned = same("operation_param_owned_count", op, ps)
        g = _fill((WORLD, local), INT32, seed=12 + ps).astype(np.float32)
        call("param_start_gradient_comm", op, ps, g.ctypes.data, FLOAT)
        outs = _outs(local, FLOAT, fill=-7)
        n = [shim.param_wait_gradient_comm(getattr(op, side), ps, o.ctypes.data, FLOAT)
             for side, shim, o in (("j", jshim, outs[0]), ("t", tshim, outs[1]))]
        assert n[0] == n[1]
        _assert_equal(outs[0], outs[1], f"gradient {ps}")
        same("param_test_gradient_comm", op, ps)
        if dist_update and op is op2:
            inc = _fill((WORLD, owned), INT32, seed=20 + ps).astype(np.float32)
            call("param_start_increment_comm", op, ps, inc.ctypes.data, FLOAT)
            outs = _outs(local, FLOAT, fill=-7)
            n = [shim.param_wait_increment_comm(getattr(op, side), ps, o.ctypes.data, FLOAT)
                 for side, shim, o in (("j", jshim, outs[0]), ("t", tshim, outs[1]))]
            assert n[0] == n[1] == local
            _assert_equal(outs[0], outs[1], f"increment {ps}")


def test_int8_gradients_within_one_quantization_step(shims):
    """A QUANTIZATION parameter set through the shim over two rounds (the
    residual carries): the port against default JAX within one step of the
    int8 codec (each block's amax / 127, times the 8 ranks' contributions
    and the two codec passes of a ring)."""
    same("env_set_quantization_params", None, None, None, None, 256, 256)
    d = handle("env_create_distribution", WORLD, 1, 1)
    sess, (op,) = _session([([(1, 1)], [(1, 1)], [(4096, 0, QUANT)])], [d])
    same("session_commit", sess)
    for r in range(2):
        g = _fill((WORLD, 4096), FLOAT, seed=30 + r)
        call("param_start_gradient_comm", op, 0, g.ctypes.data, FLOAT)
        outs = _outs(4096, FLOAT)
        for side, shim, o in (("j", jshim, outs[0]), ("t", tshim, outs[1])):
            assert shim.param_wait_gradient_comm(getattr(op, side), 0, o.ctypes.data,
                                                 FLOAT) == 4096
        step = np.abs(g).reshape(WORLD, -1, 256).max(-1).max(0) / 127.0
        bound = 2 * WORLD * np.repeat(step, 256)
        assert (np.abs(outs[1] - outs[0]) <= bound).all(), r
        exact = g.sum(0)
        assert np.linalg.norm(outs[1][0] - exact) / np.linalg.norm(exact) < 0.02


def test_stats_queries_match_jax(shims, monkeypatch):
    """The statistics queries with MLSL_STATS=1: controls, per-operation and
    total sizes; cycle counts are timings, so only their signs agree."""
    call("env_finalize")
    monkeypatch.setenv("MLSL_STATS", "1")
    call("env_init")
    d = handle("env_create_distribution", WORLD, 1, 1)
    specs = [([(8, 4)], [(8, 4)], [(64, 0, NONE)]), ([(8, 4)], [(8, 4)], [(64, 0, NONE)])]
    sess, ops = _session(specs, [d, d])
    same("operation_set_next", ops[0], ops[1], 0, 0)
    same("session_commit", sess)
    for op in ops:
        g = _fill((WORLD, 64), INT32, seed=40).astype(np.float32)
        call("param_start_gradient_comm", op, 0, g.ctypes.data, FLOAT)
        outs = _outs(64, FLOAT)
        for side, shim, o in (("j", jshim, outs[0]), ("t", tshim, outs[1])):
            shim.param_wait_gradient_comm(getattr(op, side), 0, o.ctypes.data, FLOAT)
    st = handle("session_get_stats", sess)
    for what in (3, 4):
        same("stats_control", st, what)
    for op_idx in (0, 1, -1):
        same("stats_query", st, 0, op_idx)
        for what in (1, 2, 3):
            j, t = call("stats_query", st, what, op_idx)
            assert (j > 0) == (t > 0), (what, op_idx, j, t)
    j, t = call("stats_query", st, 4, 99)
    assert j == t == -1
    for what in (1, 0, 2):
        same("stats_control", st, what)
    same("stats_query", st, 0, -1)


def test_custom_codec_and_bad_input_raise(shims):
    """A lib_path codec that cannot be opened raises MLSLError in the port's
    loader (comm.codec.load_library_codec), which the C entry returns as
    MLSL_TPU_FAILURE; an indivisible scatter count raises in both packages."""
    with pytest.raises(MLSLError, match="can't be opened"):
        tshim.env_set_quantization_params("/nonexistent/libcodec.so", "c", "d", "r", 256, 256)
    d = handle("env_create_distribution", WORLD, 1, 1)
    x = np.zeros((WORLD, 10), np.float32)
    with pytest.raises(MLSLError, match="divisible"):
        tshim.dist_collective_start(d.t, "scatter", x.ctypes.data, 10, FLOAT, 0, 0, DATA)
    assert tshim.handle_release(d.t) == 0
