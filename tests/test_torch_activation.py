"""The DL-semantics core of the port against the JAX package: CommBlockInfo
layouts, the five InitPeerConnection cases with their FPROP/BPROP exchanges,
the reference's training loop and its configuration matrix
(tests/test_e2e_graph.py of the JAX package), on the 8-device CPU mesh and
on 8 virtual ranks with ``device="cpu"``.

Tolerances: block lists, request descriptors and every move (allgather,
alltoall, unpacking) bit-exact; sums of the closed-form fills p * 1000 + i
(integers, exact in float32) bit-exact; sums of scaled fills within rtol 1e-6
of JAX's and of the float64 sum; the int8 matrix rows, as in the JAX test,
within 2 % relative L2 of the exact sum."""

import numpy as np
import pytest
import torch

from mlsl_tpu.core.activation import pack_local as jpack
from mlsl_tpu.core.activation import unpack_local as junpack
from mlsl_tpu.log import MLSLError as JMLSLError
from mlsl_tpu_torch.core.activation import pack_local, unpack_local
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.types import CompressionType, OpType

torch.set_num_threads(2)

MB = 8
FM1, FM2 = 16, 8
FM_SIZE = 4
RTOL = 1e-6


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _rank_fill(p, n):
    return (p * 1000.0 + np.arange(n, dtype=np.float64)).astype(np.float32)


def _build_net(e, dist, distributed_update=False, compression=CompressionType.NONE):
    """tests/test_e2e_graph.py's two CC ops, FM1 -> FM2 -> FM1."""
    s = e.create_session()
    s.set_global_minibatch_size(MB)
    r1 = s.create_operation_reg_info(OpType.CC)
    r1.add_input(FM1, FM_SIZE)
    r1.add_output(FM2, FM_SIZE)
    r1.add_parameter_set(FM1 * FM2, 1, distributed_update=distributed_update,
                         compression_type=compression)
    op1 = s.get_operation(s.add_operation(r1, dist))
    r2 = s.create_operation_reg_info(OpType.CC)
    r2.add_input(FM2, FM_SIZE)
    r2.add_output(FM1, FM_SIZE)
    r2.add_parameter_set(FM2 * FM1, 1, distributed_update=distributed_update,
                         compression_type=compression)
    op2 = s.get_operation(s.add_operation(r2, dist))
    op1.set_next(op2, 0, 0)
    s.commit()
    return s, op1, op2


def _build_edge(e, dist_a, dist_b, fm_out, op_type_a=OpType.CC):
    s = e.create_session()
    s.set_global_minibatch_size(MB)
    r1 = s.create_operation_reg_info(op_type_a)
    r1.add_input(FM1, FM_SIZE)
    r1.add_output(fm_out, FM_SIZE)
    op1 = s.get_operation(s.add_operation(r1, dist_a))
    r2 = s.create_operation_reg_info(OpType.ACT)
    r2.add_input(fm_out, FM_SIZE)
    r2.add_output(fm_out, FM_SIZE)
    op2 = s.get_operation(s.add_operation(r2, dist_b))
    op1.set_next(op2, 0, 0)
    s.commit()
    return op1.get_output(0), op2.get_input(0), op1, op2


# (case, model_parts) -> how to build the edge in one package
def _edge(e, case, model_parts):
    d = 8 // model_parts
    if case == "case1":
        dist = e.create_distribution(d, model_parts)
        _, op1, op2 = _build_net(e, dist)
        return op1.get_output(0), op2.get_input(0), op1, op2, dist, dist
    if case == "case2":
        a, b = e.create_distribution(d, model_parts), e.create_distribution(d, 1)
    elif case == "case3":
        a, b = e.create_distribution(d, model_parts), e.create_distribution(8, 1)
    elif case == "case4":
        a, b = e.create_distribution(8, 1), e.create_distribution(2, 4)
    else:
        a, b = e.create_distribution(2, 4), e.create_distribution(8, 1)
    cc = case in ("case2", "case3")
    out_act, in_act, op1, op2 = _build_edge(e, a, b, FM2 if cc else FM1,
                                            OpType.CC if cc else OpType.ACT)
    return out_act, in_act, op1, op2, a, b


CASES = [("case1", 1), ("case1", 2), ("case1", 4), ("case2", 2), ("case2", 4),
         ("case3", 2), ("case3", 4), ("case4", 4), ("case5", 4)]


def _blocks(bs):
    return [(b.mb_offset, b.mb_count, b.fm_offset, b.fm_count, b.fm_size, int(b.data_type),
             b.buf_offset) for b in bs]


def _desc(req):
    if req is None:
        return None
    d = req.desc
    g = d.group
    return (d.kind, d.count, d.recv_count, int(d.compute_type), g.axes,
            1 if g.is_self else g.size, None if d.op is None else int(d.op))


@pytest.mark.parametrize("case,model_parts", CASES)
def test_block_lists_and_requests_match_jax(env, tenv, case, model_parts):
    """Each peer-connection case builds JAX's requests and JAX's block lists,
    word for word."""
    j = _edge(env, case, model_parts)
    t = _edge(tenv, case, model_parts)
    for ja, ta in ((j[0], t[0]), (j[1], t[1])):
        assert ta.need_comm == ja.need_comm
        assert ta.local_fm_count == ja.local_fm_count and ta.need_reduce == ja.need_reduce
        assert _blocks(ta.pack_blocks) == _blocks(ja.pack_blocks)
        assert _blocks(ta.unpack_blocks) == _blocks(ja.unpack_blocks)
        assert ta.tmp_buf_offset == ja.tmp_buf_offset
        assert _desc(ta.comm_req) == _desc(ja.comm_req)
        assert ta.get_comm_buf_size() == ja.get_comm_buf_size()
        assert ta.get_pack_block_count() == len(ja.pack_blocks)
        assert ta.get_unpack_block_count() == len(ja.unpack_blocks)
        for m in range(max(model_parts, 1)):
            assert ta.get_global_fm_offset(m) == ja.get_global_fm_offset(m)
    if t[0].comm_req is not None:
        assert t[0].comm_req.name == f"{t[2].name}/{t[0].comm_req.desc.kind}"


def _members(p, group):
    """World ranks of p's group instance, in member order."""
    for row in group.member_table():
        if p in row:
            return list(row)
    return [p]


def _wires(out_act, op, n, scale=1.0):
    mb = op.get_local_minibatch_size()
    return {p: jpack((scale * _rank_fill(p, n)).reshape(mb, out_act.local_fm_count,
                                                        FM_SIZE),
                     out_act.pack_blocks, mb, out_act.local_fm_count, FM_SIZE)
            for p in range(8)}


def _exchange(jstart, tstart, jwait, twait, jd, td, wires, n):
    """Start the same wire buffers in both packages and return both results."""
    mk = lambda p: np.asarray(wires[p])  # noqa: E731
    jstart(jd.make_buffer(mk, n))
    tstart(td.make_buffer(mk, n))
    want, got = jwait(), twait()
    assert (want is None) == (got is None)
    if want is None:
        return None, None
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("model_parts", [1, 2, 4])
def test_case1_exchange_matches_jax(env, tenv, model_parts):
    """Case 1: pack -> ReduceScatter over the model group -> unpack forward;
    AllGather backward (the input owns BPROP, the output waits on it)."""
    jo, ji, jop1, _, jd, _ = _edge(env, "case1", model_parts)
    to, ti, top1, _, td, _ = _edge(tenv, "case1", model_parts)
    if model_parts == 1:
        assert not to.need_comm and to.comm_req is None
        return
    mb = top1.get_local_minibatch_size()
    n = mb * to.local_fm_count * FM_SIZE
    wires = _wires(jo, jop1, n)
    want, got = _exchange(jo.start_comm, to.start_comm, ji.wait_comm, ti.wait_comm, jd, td,
                          wires, n)
    np.testing.assert_array_equal(got, want)
    g = td.model_group
    rc = n // model_parts
    for p in range(8):
        summed = sum(np.asarray(wires[q], np.float64) for q in _members(p, g))
        my = g.group_idx_of(p)
        row = td.local_part(torch.from_numpy(got), p)
        np.testing.assert_array_equal(row, summed[my * rc:(my + 1) * rc].astype(np.float32))
        np.testing.assert_array_equal(
            unpack_local(row, ti.unpack_blocks, mb, ti.local_fm_count, FM_SIZE),
            junpack(row, ji.unpack_blocks, mb, ji.local_fm_count, FM_SIZE))
    # backward
    nb = mb * ti.local_fm_count * FM_SIZE
    grads = {p: _rank_fill(p, nb) for p in range(8)}
    want, got = _exchange(ji.start_comm, ti.start_comm, jo.wait_comm, to.wait_comm, jd, td,
                          grads, nb)
    np.testing.assert_array_equal(got, want)
    for p in range(8):
        np.testing.assert_array_equal(
            td.local_part(torch.from_numpy(got), p),
            np.concatenate([grads[q] for q in _members(p, g)]))


@pytest.mark.parametrize("model_parts", [2, 4])
def test_case2_allreduce_exchange_matches_jax(env, tenv, model_parts):
    jo, ji, jop1, _, ja, _ = _edge(env, "case2", model_parts)
    to, ti, top1, _, ta, _ = _edge(tenv, "case2", model_parts)
    assert ti.comm_req is None
    mb = top1.get_local_minibatch_size()
    n = mb * FM2 * FM_SIZE
    wires = _wires(jo, jop1, n)
    want, got = _exchange(jo.start_comm, to.start_comm, ji.wait_comm, ti.wait_comm, ja, ta,
                          wires, n)
    np.testing.assert_array_equal(got, want)
    g = ta.model_group
    for p in range(8):
        summed = sum(np.asarray(wires[q], np.float64) for q in _members(p, g))
        row = ta.local_part(torch.from_numpy(got), p)
        np.testing.assert_array_equal(row, summed.astype(np.float32))
        np.testing.assert_array_equal(
            unpack_local(row, ti.unpack_blocks, mb, FM2, FM_SIZE).reshape(-1), row)
    # no backward comm, by design
    assert to.wait_comm() is None and jo.wait_comm() is None


@pytest.mark.parametrize("model_parts", [2, 4])
def test_case3_mixed_grid_exchange_matches_jax(env, tenv, model_parts):
    jo, ji, jop1, jop2, ja, jb = _edge(env, "case3", model_parts)
    to, ti, top1, top2, ta, tb = _edge(tenv, "case3", model_parts)
    out_mb, in_mb = top1.get_local_minibatch_size(), top2.get_local_minibatch_size()
    assert in_mb * model_parts == out_mb
    n_out, n_in = out_mb * FM2 * FM_SIZE, in_mb * FM2 * FM_SIZE
    wires = _wires(jo, jop1, n_out)
    want, got = _exchange(jo.start_comm, to.start_comm, ji.wait_comm, ti.wait_comm, ja, ta,
                          wires, n_out)
    np.testing.assert_array_equal(got, want)
    g = ta.model_group
    for p in range(8):
        summed = sum(np.asarray(wires[q], np.float64) for q in _members(p, g))
        my = g.group_idx_of(p)
        np.testing.assert_array_equal(ta.local_part(torch.from_numpy(got), p),
                                      summed[my * n_in:(my + 1) * n_in].astype(np.float32))
    grads = {p: _rank_fill(p, n_in) for p in range(8)}
    want, got = _exchange(ji.start_comm, ti.start_comm, jo.wait_comm, to.wait_comm, jb, tb,
                          grads, n_in)
    np.testing.assert_array_equal(got, want)
    for p in range(8):
        members = _members(p, g)
        row = ta.local_part(torch.from_numpy(got), p)
        np.testing.assert_array_equal(row, np.concatenate([grads[q] for q in members]))
        np.testing.assert_array_equal(
            unpack_local(row, to.unpack_blocks, out_mb, FM2, FM_SIZE),
            np.concatenate([grads[q].reshape(in_mb, FM2, FM_SIZE) for q in members]))


@pytest.mark.parametrize("case", ["case4", "case5"])
def test_alltoall_cases_exchange_match_jax(env, tenv, case):
    """Cases 4 and 5: the out op's buffer is laid out on one grid and the
    request runs over the other's model group; forward and backward."""
    jo, ji, jop1, jop2, ja, jb = _edge(env, case, 4)
    to, ti, top1, top2, ta, tb = _edge(tenv, case, 4)
    assert to.comm_req.desc.kind == ti.comm_req.desc.kind == "alltoall"
    g = 4
    blk = to.comm_req.desc.count
    n_wire = g * blk
    out_mb, in_mb = top1.get_local_minibatch_size(), top2.get_local_minibatch_size()
    acts = {p: _rank_fill(p, out_mb * to.local_fm_count * FM_SIZE) for p in range(8)}
    wires = {p: pack_local(acts[p], to.pack_blocks, out_mb, to.local_fm_count, FM_SIZE)
             for p in range(8)}
    for p in range(8):
        np.testing.assert_array_equal(
            wires[p], jpack(acts[p], jo.pack_blocks, out_mb, jo.local_fm_count, FM_SIZE))
    assert wires[0].shape[0] == n_wire
    want, got = _exchange(jo.start_comm, to.start_comm, ji.wait_comm, ti.wait_comm, ja, ta,
                          wires, n_wire)
    np.testing.assert_array_equal(got, want)
    grp = (tb if case == "case4" else ta).model_group
    for p in range(8):
        m = grp.group_idx_of(p)
        members = _members(p, grp)
        row = got.reshape(8, -1)[p]
        np.testing.assert_array_equal(
            row, np.concatenate([wires[q][m * blk:(m + 1) * blk] for q in members]))
        np.testing.assert_array_equal(
            unpack_local(row, ti.unpack_blocks, in_mb, ti.local_fm_count, FM_SIZE),
            junpack(row, ji.unpack_blocks, in_mb, ji.local_fm_count, FM_SIZE))
    grads = {p: _rank_fill(p, n_wire) for p in range(8)}
    want, got = _exchange(ji.start_comm, ti.start_comm, jo.wait_comm, to.wait_comm, jb, tb,
                          grads, n_wire)
    np.testing.assert_array_equal(got, want)


def test_pack_local_batched_tensor_matches_numpy(tenv):
    """pack_local / unpack_local on a distributed tensor pack every rank at
    once, as the per-rank numpy loop does."""
    to, ti, top1, top2, _, _ = _edge(tenv, "case4", 4)
    mb = top1.get_local_minibatch_size()
    n = mb * to.local_fm_count * FM_SIZE
    acts = np.stack([_rank_fill(p, n) for p in range(8)]).reshape(1, 8, 1, 1, n)
    batched = pack_local(torch.from_numpy(acts), to.pack_blocks, mb, to.local_fm_count,
                         FM_SIZE)
    for p in range(8):
        np.testing.assert_array_equal(
            batched[0, p, 0, 0].numpy(),
            jpack(acts[0, p, 0, 0], to.pack_blocks, mb, to.local_fm_count, FM_SIZE))
    back = unpack_local(batched, to.pack_blocks, mb, to.local_fm_count, FM_SIZE)
    np.testing.assert_array_equal(back.reshape(1, 8, 1, 1, n).numpy(), acts)


@pytest.mark.parametrize("model_parts", [2, 4])
def test_full_reference_loop_matches_jax(env, tenv, model_parts):
    """mlsl_test.cpp:660-698 in one piece, two iterations: Forward (pack,
    start FPROP), Wait, Backward1 (start BPROP, wait), Backward2 + Update
    (each parameter set's gradient request, newest first), in both packages
    on the same fills."""
    d = 8 // model_parts
    jd, td = env.create_distribution(d, model_parts), tenv.create_distribution(d, model_parts)
    _, jop1, jop2 = _build_net(env, jd)
    _, top1, top2 = _build_net(tenv, td)
    jo, ji, to, ti = jop1.get_output(0), jop2.get_input(0), top1.get_output(0), top2.get_input(0)
    mb = top1.get_local_minibatch_size()
    n_wire = mb * to.local_fm_count * FM_SIZE
    n_bwd = mb * ti.local_fm_count * FM_SIZE
    for it in range(2):
        wires = _wires(jo, jop1, n_wire, scale=it + 1.0)
        want, got = _exchange(jo.start_comm, to.start_comm, ji.wait_comm, ti.wait_comm,
                              jd, td, wires, n_wire)
        np.testing.assert_array_equal(got, want)
        grads_a = {p: (it + 2.0) * _rank_fill(p, n_bwd) for p in range(8)}
        want, got = _exchange(ji.start_comm, ti.start_comm, jo.wait_comm, to.wait_comm,
                              jd, td, grads_a, n_bwd)
        np.testing.assert_array_equal(got, want)
        for jop, top in ((jop2, top2), (jop1, top1)):
            jps, tps = jop.get_parameter_set(0), top.get_parameter_set(0)
            n_k = tps.get_local_kernel_count() * tps.get_kernel_size()
            grads_w = {p: (it + 3.0) * _rank_fill(p, n_k) for p in range(8)}
            want, got = _exchange(jps.start_gradient_comm, tps.start_gradient_comm,
                                  jps.wait_gradient_comm, tps.wait_gradient_comm,
                                  jd, td, grads_w, n_k)
            np.testing.assert_allclose(got, want, rtol=RTOL)
            gd = td.grad_group
            for p in range(8):
                exact = sum(np.asarray(grads_w[q], np.float64)
                            for q in _members(p, gd))
                np.testing.assert_allclose(td.local_part(torch.from_numpy(got), p), exact,
                                           rtol=RTOL)


# the reference exercises int8 on the plain allreduce path only
MATRIX = [(m, du, q) for m in (1, 2, 4) for du in (False, True) for q in (False, True)
          if not (du and q)]


@pytest.mark.parametrize("model_parts,dist_update,quant", MATRIX)
def test_training_phases_matrix_matches_jax(env, tenv, model_parts, dist_update, quant):
    """The reference's matrix (Makefile run loop): 2 epochs x 3 minibatches of
    backward-order gradient requests over model parts x distributed update x
    int8, against the closed form and JAX's results."""
    d = 8 // model_parts
    comp = CompressionType.QUANTIZATION if quant else CompressionType.NONE
    jd, td = env.create_distribution(d, model_parts), tenv.create_distribution(d, model_parts)
    _, jop1, jop2 = _build_net(env, jd, dist_update, comp)
    _, top1, top2 = _build_net(tenv, td, dist_update, comp)
    for epoch in range(2):
        for mb in range(3):
            for jop, top in ((jop2, top2), (jop1, top1)):
                jps, tps = jop.get_parameter_set(0), top.get_parameter_set(0)
                assert tps.get_owned_kernel_count() == jps.get_owned_kernel_count()
                n = tps.get_local_kernel_count() * tps.get_kernel_size()
                scale = 1.0 + epoch + 0.1 * mb
                grads = {p: scale * _rank_fill(p, n) for p in range(8)}
                want, got = _exchange(jps.start_gradient_comm, tps.start_gradient_comm,
                                      jps.wait_gradient_comm, tps.wait_gradient_comm,
                                      jd, td, grads, n)
                if d == 1:
                    assert got is None
                    continue
                g = td.grad_group
                for p in range(8):
                    full = sum(np.asarray(grads[q], np.float64)
                               for q in _members(p, g))
                    row = td.local_part(torch.from_numpy(got), p).astype(np.float64)
                    if dist_update:
                        my = g.group_idx_of(p)
                        owned = tps.get_owned_kernel_count() * tps.get_kernel_size()
                        full = full[my * owned:(my + 1) * owned]
                    if quant:
                        rel = np.linalg.norm(row - full) / (np.linalg.norm(full) + 1e-9)
                        assert rel < 0.02, rel
                    else:
                        np.testing.assert_allclose(row, full, rtol=RTOL)
                if not quant:
                    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("spec,want", [
    ("pallas_ring", {"reduce_scatter": "pallas_ring", "allreduce": "pallas_ring"}),
    ("allreduce=pallas_rhd,reduce_scatter=pallas_ring",
     {"reduce_scatter": "pallas_ring", "allreduce": "pallas_rhd"}),
    ("alltoall=pallas_a2a", {"alltoall": "pallas_a2a"}),
])
def test_activation_requests_take_the_engine_kernels(env, tenv, monkeypatch, spec, want):
    """Activation requests select through the engine: under MLSL_ALGO they
    take B3, B5 or B6 (plain versions on the CPU) and give the lax results
    bit for bit on integer payloads."""
    monkeypatch.setenv("MLSL_ALGO", spec)
    monkeypatch.setenv("MLSL_PALLAS_A2A_QUANT", "0")
    Environment.get_env().finalize()
    kenv = Environment.get_env().init(device="cpu", world_size=8)
    for case, m in (("case1", 2), ("case2", 2), ("case3", 4), ("case4", 4), ("case5", 4)):
        ko, ki, kop1, _, ka, kb = _edge(kenv, case, m)
        jo, ji, jop1, _, ja, jb = _edge(env, case, m)
        kind = ko.comm_req.desc.kind
        assert ko.comm_req.algo == want.get(kind, "lax"), (case, kind)
        n = ko.comm_req.desc.send_len()
        wires = {p: _rank_fill(p, n) for p in range(8)}
        want_, got = _exchange(jo.start_comm, ko.start_comm, ji.wait_comm, ki.wait_comm,
                               ja, ka, wires, n)
        np.testing.assert_array_equal(got, want_)
        # the plain version of the same plan, which the card's checks use
        twin, _ = ko.comm_req.plain_result(ka.make_buffer(lambda p: wires[p], n))
        np.testing.assert_array_equal(twin.numpy(), got)
    kenv.finalize()


def test_unsupported_topology_case_raises(env, tenv):
    """A CC output into another distribution with model parts on both sides
    fits none of the five cases: both packages refuse it at commit."""
    for e, err in ((env, JMLSLError), (tenv, MLSLError)):
        a, b = e.create_distribution(4, 2), e.create_distribution(2, 4)
        with pytest.raises(err, match="not supported"):
            _build_edge(e, a, b, FM2)


def test_commit_precompiles_and_keeps_round_state(tenv, monkeypatch):
    """MLSL_PRECOMPILE=1 runs every request once at commit and leaves no
    round started or completed."""
    monkeypatch.setenv("MLSL_PRECOMPILE", "1")
    tenv.finalize()
    e = Environment.get_env().init(device="cpu", world_size=8)
    dist = e.create_distribution(4, 2)
    s, op1, op2 = _build_net(e, dist, distributed_update=True)
    # the edge's reduce_scatter and allgather, each set's gradient and increment
    assert s.precompile_collectives() == 6
    for req in (op1.get_output(0).comm_req, op2.get_input(0).comm_req,
                op1.get_parameter_set(0).grad_req, op1.get_parameter_set(0).inc_req):
        assert not req.is_started and req._result is None
    s.delete_operation_reg_info(None)
    e.finalize()


def test_wait_comm_without_start_returns_none(tenv):
    dist = tenv.create_distribution(4, 2)
    _, op1, op2 = _build_net(tenv, dist)
    assert op2.get_input(0).wait_comm() is None
    assert op1.get_output(0).get_comm_buf() is None


def test_walkthrough_runs_on_cpu_as_the_jax_example_does():
    """The port's walkthrough (tools/mlsl_example.py): the JAX package's
    examples/mlsl_example.py calls on a data 4 x model 2 grid, with the same
    closed-form results (the global allreduce of p + 1 is 36; the gradient
    sums are data_parts * (it + 1))."""
    from mlsl_tpu_torch.tools import mlsl_example

    Environment.get_env().finalize()
    out = mlsl_example.main(device="cpu", log=lambda s: None)
    assert out["data_parts"] == 4 and out["case"] == "reduce_scatter"
    np.testing.assert_array_equal(out["allreduce"], np.full(4, 36.0))
    # rank 0 receives model position 0's slice of sum over its model pair (0 + 1)
    assert out["fprop"][0] == 1.0
    assert out["reduced"] == {(it, name): 4.0 * (it + 1) for it in range(3)
                              for name in ("op0", "op1")}
    assert "GRAD0" in out["table"] and "OA0" in out["table"]
    assert not Environment.is_initialized()
