"""The activation exchanges and the remaining collectives on the card.

Each of the five peer-connection cases (core/activation.py) runs its FPROP
and BPROP requests at a small size with the engine kernel MLSL_ALGO selects
-- B3 (``pallas_ring``), B5 (``pallas_rhd``), B6 (``pallas_a2a``, dense and
int8) -- and each round is held bit for bit to the plain version of the same
plan (``CommRequest.plain_result``). The collectives that are plain tensor
work (scatter, sendrecv, allgatherv, alltoallv, every kind on equal and
ragged color groups) are held bit for bit to the same function on the host.
"""

import numpy as np
import pytest
import torch

from mlsl_tpu_torch import CompressionType, DataType, GroupType, OpType, ReductionType, get_env
from mlsl_tpu_torch.comm import collectives as coll
from mlsl_tpu_torch.ops import a2a_kernels, rhd_kernels, ring_kernels

MB = 16
FM_IN, FM_OUT = 32, 64
DEV = torch.device("cuda")


def _sync():
    if DEV.type == "cuda":
        torch.cuda.synchronize()


@pytest.fixture()
def card_env(monkeypatch):
    made = []

    def init(**env_vars):
        get_env().finalize()
        for k in ("MLSL_ALGO", "MLSL_PALLAS_A2A_QUANT"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env_vars.items():
            monkeypatch.setenv(k, v)
        e = get_env().init(device=DEV, world_size=8)
        made.append(e)
        return e

    yield init
    get_env().finalize()


def _edge(e, case, model_parts):
    d = 8 // model_parts
    if case == "case1":
        a = b = e.create_distribution(d, model_parts)
    elif case == "case2":
        a, b = e.create_distribution(d, model_parts), e.create_distribution(d, 1)
    elif case == "case3":
        a, b = e.create_distribution(d, model_parts), e.create_distribution(8, 1)
    elif case == "case4":
        a, b = e.create_distribution(8, 1), e.create_distribution(8 // model_parts,
                                                                   model_parts)
    else:
        a, b = e.create_distribution(8 // model_parts, model_parts), e.create_distribution(8, 1)
    cc = case in ("case1", "case2", "case3")
    s = e.create_session()
    s.set_global_minibatch_size(MB)
    r1 = s.create_operation_reg_info(OpType.CC if cc else OpType.ACT)
    r1.add_input(FM_IN, 1)
    r1.add_output(FM_OUT, 1)
    r1.add_parameter_set(FM_IN * FM_OUT, 1)
    op1 = s.get_operation(s.add_operation(r1, a))
    r2 = s.create_operation_reg_info(OpType.ACT)
    r2.add_input(FM_OUT, 1)
    r2.add_output(FM_OUT, 1)
    op2 = s.get_operation(s.add_operation(r2, b))
    op1.set_next(op2, 0, 0)
    s.commit()
    return op1.get_output(0), op2.get_input(0), a, b


def _launches():
    return {**ring_kernels.LAUNCHES, **rhd_kernels.LAUNCHES, **a2a_kernels.LAUNCHES}


def _round(act, peer, dist, key, gen):
    """One request of an edge on random data: it must launch ``key`` and
    equal its plain version bit for bit."""
    req = act.comm_req
    n = req.desc.send_len()
    buf = torch.randn((*dist.world_shape, n), generator=gen, device=DEV)
    before = _launches()
    act.start_comm(buf)
    got = peer.wait_comm()
    _sync()
    after = _launches()
    assert after[key] == before[key] + 1, (req.desc.kind, req.algo, key)
    want, _ = req.plain_result(buf)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (req.desc.kind,
                                                                        req.algo)


EDGES = [
    ("case1", 2, "pallas_ring", {"reduce_scatter": "dense_ring"}),
    ("case1", 4, "pallas_ring", {"reduce_scatter": "dense_ring"}),
    ("case2", 2, "pallas_ring", {"allreduce": "dense_ring"}),
    ("case2", 4, "allreduce=pallas_rhd", {"allreduce": "rhd_allreduce"}),
    ("case3", 2, "pallas_ring", {"reduce_scatter": "dense_ring"}),
    ("case3", 4, "pallas_ring", {"reduce_scatter": "dense_ring"}),
    ("case4", 4, "alltoall=pallas_a2a", {"alltoall": "a2a_dense"}),
    ("case5", 4, "alltoall=pallas_a2a", {"alltoall": "a2a_dense"}),
    ("case4", 2, "alltoall=pallas_a2a", {"alltoall": "a2a_quant"}),
    ("case5", 2, "alltoall=pallas_a2a", {"alltoall": "a2a_quant"}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,model_parts,spec,keys", EDGES,
                         ids=[f"{c}-m{m}-{k[next(iter(k))]}" for c, m, _, k in EDGES])
def test_cuda_activation_cases_match_plain(card_env, case, model_parts, spec, keys):
    quant = "1" if next(iter(keys.values())) == "a2a_quant" else "0"
    e = card_env(MLSL_ALGO=spec, MLSL_PALLAS_A2A_QUANT=quant)
    out_act, in_act, a, b = _edge(e, case, model_parts)
    gen = torch.Generator(device=DEV).manual_seed(sum(map(ord, case)) + model_parts)
    kind = out_act.comm_req.desc.kind
    assert out_act.comm_req.algo == spec.split("=")[-1], out_act.comm_req.algo
    _round(out_act, in_act, a, keys[kind], gen)
    if in_act.comm_req is not None and in_act.comm_req.desc.kind in keys:
        _round(in_act, out_act, b, keys[in_act.comm_req.desc.kind], gen)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,key", [("pallas_ring", "quant_ring"), ("lax", None)])
def test_cuda_int8_gradient_set_matches_plain(card_env, algo, key):
    """An int8 gradient set over the data group: B1 (+ B4 on the fused ring)
    against the plain versions, residuals carried over two rounds."""
    e = card_env(MLSL_ALGO=algo)
    dist = e.create_distribution(4, 2)
    s = e.create_session()
    s.set_global_minibatch_size(MB)
    r = s.create_operation_reg_info(OpType.CC)
    r.add_input(FM_IN, 1)
    r.add_output(FM_OUT, 1)
    r.add_parameter_set(FM_IN * FM_OUT * 8, 1, compression_type=CompressionType.QUANTIZATION)
    ps = s.get_operation(s.add_operation(r, dist)).get_parameter_set(0)
    s.commit()
    req = ps.grad_req
    gen = torch.Generator(device=DEV).manual_seed(7)
    errs = None
    for _ in range(2):
        n = ps.get_local_kernel_count()
        buf = torch.randn((*dist.world_shape, n), generator=gen, device=DEV)
        before = dict(ring_kernels.LAUNCHES)
        ps.start_gradient_comm(buf)
        got = ps.wait_gradient_comm()
        _sync()
        if key:
            assert ring_kernels.LAUNCHES[key] == before[key] + 1
        want, errs = req.plain_result(buf, errs)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        for mine, twin in zip(req._errs, errs):
            assert torch.equal(mine.view(torch.int32), twin.view(torch.int32))


# -- the plain collectives: card against host, bit for bit -----------------------


def _colors(name):
    return {"axis": None, "even_odd": tuple(p % 2 for p in range(8)),
            "ragged": (0, 0, 0, 1, 1, 1, 1, 1)}[name]


def _groups(e, name):
    c = _colors(name)
    if c is None:
        d = e.create_distribution(4, 2)
        return d, [d.data_group, d.model_group]
    d = e.create_distribution_with_colors(c, tuple(p // 4 for p in range(8)))
    return d, [d.data_group]


def _kinds(group, n):
    g = group.size
    gmin = min(group.group_sizes) if group.colors is not None else g
    rc = n // g
    out = [("allreduce", {"op": op}) for op in ReductionType]
    out += [("bcast", {"root": gmin - 1}), ("allgather", {}), ("gather", {"root": 0}),
            ("scatter", {"root": gmin - 1, "recv_count": rc}),
            ("reduce_scatter", {"op": ReductionType.SUM, "recv_count": rc}),
            ("alltoall", {"send_count": rc}),
            ("sendrecv", {"pairs": tuple((i, (i + 1) % gmin) for i in range(gmin))})]
    if group.is_uniform:
        out.append(("allgatherv", {"recv_counts": tuple(1 + i for i in range(g))}))
        s = np.random.default_rng(g).integers(0, 4, size=(g, g))
        out.append(("alltoallv", _a2av(group, s)))
        sw = np.random.default_rng(g + 1).integers(0, 4, size=(8, g))
        out.append(("alltoallv", _a2av(group, sw)))
    return out


def _a2av(group, s):
    from mlsl_tpu_torch.comm.request import CommDesc, normalize_alltoallv

    return normalize_alltoallv(CommDesc("alltoallv", group, 0, DataType.FLOAT,
                                        send_counts=tuple(map(tuple, s.tolist()))))


@pytest.mark.cuda
@pytest.mark.parametrize("groups", ["axis", "even_odd", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_cuda_collectives_match_host(card_env, groups, dtype):
    e = card_env()
    dist, gs = _groups(e, groups)
    n = 8 * 5 * 4
    rng = np.random.default_rng(3)
    host = (rng.normal(size=(*dist.world_shape, n)).astype(np.float32) if dtype == "float32"
            else rng.integers(-1000, 1000, size=(*dist.world_shape, n)).astype(np.int32))
    x_h = torch.from_numpy(host)
    x_d = x_h.to(DEV)
    for group in gs:
        for kind, kw in _kinds(group, n):
            fn = coll.build_collective(kind, group, **kw)
            got = fn(x_d).cpu()
            want = fn(x_h)
            if kind in ("allreduce", "reduce_scatter") and kw.get("op") == ReductionType.SUM \
                    and dtype == "float32":
                # the card's one-pass sum and the host's member loop differ
                # in order (comm/collectives._reduce): within 1e-6
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
            else:
                assert torch.equal(got, want), (groups, kind, kw)


@pytest.mark.cuda
def test_cuda_distribution_gather_to_host_and_barrier(card_env):
    e = card_env()
    dist = e.create_distribution_with_colors((0, 0, 0, 1, 1, 1, 1, 1), (0,) * 8)
    buf = dist.make_buffer(lambda p: p * 1000.0 + np.arange(6), 6)
    out = dist.gather_to_host(buf, 6, DataType.FLOAT, 0, GroupType.DATA)
    assert sorted(out) == [0, 3]
    np.testing.assert_array_equal(out[3], np.concatenate([p * 1000.0 + np.arange(6)
                                                          for p in range(3, 8)]))
    dist.barrier(GroupType.DATA)
