"""The port's collectives over virtual ranks against the JAX package's
``build_collective`` on the 8-device CPU mesh, and its request engine.

Integer-valued payloads reduce exactly in any order, so they must agree bit
for bit. Random floats are compared at rtol=1e-6: the port sums the members in
another order than XLA does."""

import numpy as np
import pytest
import torch

from mlsl_tpu.comm import collectives as jcoll
from mlsl_tpu_torch.comm import collectives as tcoll
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.types import DataType, GroupType, ReductionType

torch.set_num_threads(2)

N = 24  # elements per rank


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _payload(kind_of_data, seed=0):
    if kind_of_data == "int":
        return np.stack([p * 1000.0 + np.arange(N) for p in range(8)]).astype(np.float32)
    rng = np.random.default_rng(seed)
    return rng.normal(size=(8, N)).astype(np.float32)


def _variants(g):
    """(kind, kwargs) for every ported collective on a group of size g."""
    out = [("allreduce", {"op": op}) for op in ReductionType]
    out += [("reduce", {"op": ReductionType.SUM, "root": g - 1}),
            ("bcast", {"root": 0}), ("bcast", {"root": g - 1}),
            ("allgather", {}), ("gather", {"root": 0})]
    out += [("reduce_scatter", {"op": op, "recv_count": N // g}) for op in ReductionType]
    return out


@pytest.mark.parametrize("grid", [(8, 1), (4, 2)])
@pytest.mark.parametrize("gt", [GroupType.DATA, GroupType.MODEL, GroupType.GLOBAL])
@pytest.mark.parametrize("data", ["int", "float"])
def test_collectives_match_build_collective(env, tenv, grid, gt, data):
    jd = env.create_distribution(*grid)
    td = tenv.create_distribution(*grid)
    jg, tg = jd._group(gt), td._group(gt)
    g = tg.size
    x = _payload(data, seed=grid[0] * 10 + int(gt)).reshape(*td.world_shape, N)
    for kind, kw in _variants(g):
        want = np.asarray(jcoll.build_collective(kind, jg, np.float32, **kw)(
            jd.topology.shard_buffer(x)))
        got = tcoll.build_collective(kind, tg, **kw)(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape, (kind, kw)
        if data == "int":
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} {kw}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{kind} {kw}")


@pytest.mark.parametrize("dtype", [DataType.INT32, DataType.BFLOAT16])
def test_other_dtypes_allreduce(tenv, dtype):
    td = tenv.create_distribution(8, 1)
    buf = td.make_buffer(lambda p: np.full(N, p + 1), N, dtype)
    out = tenv.wait(td.all_reduce(buf, N, dtype, ReductionType.SUM, GroupType.DATA))
    assert out.dtype == buf.dtype
    np.testing.assert_array_equal(td.local_part(out, 5).astype(np.float64), 36.0)


def test_distribution_mlsl_test_oracle(tenv):
    """The reference test's closed form on a flat Distribution(8, 1): rank p
    sends p*1000 + i, every rank receives sum_p(p*1000 + i)."""
    td = tenv.create_distribution(8, 1)
    buf = td.make_buffer(lambda p: p * 1000.0 + np.arange(N), N)
    req = td.all_reduce(buf, N, DataType.FLOAT, ReductionType.SUM, GroupType.DATA)
    out = tenv.wait(req)
    want = 28000.0 + 8 * np.arange(N)
    for p in range(8):
        np.testing.assert_array_equal(td.local_part(out, p), want)
    assert len(tenv.request_storage) == 0


def test_grid_oracles_through_distribution(tenv):
    td = tenv.create_distribution(4, 2)
    buf = td.make_buffer(lambda p: p * 1000.0 + np.arange(N), N)
    ag = tenv.wait(td.all_gather(buf, N, DataType.FLOAT, GroupType.MODEL))
    bc = tenv.wait(td.bcast(buf, N, DataType.FLOAT, 2, GroupType.DATA))
    rs = tenv.wait(td.reduce_scatter(buf, N // 4, DataType.FLOAT, ReductionType.SUM,
                                     GroupType.DATA))
    for p in range(8):
        r, d, s, m = td.topology.coords(p)
        model_peers = [td.topology.global_idx(r, d, s, j) for j in range(2)]
        np.testing.assert_array_equal(
            td.local_part(ag, p),
            np.concatenate([q * 1000.0 + np.arange(N) for q in model_peers]))
        np.testing.assert_array_equal(
            td.local_part(bc, p), td.topology.global_idx(r, 2, s, m) * 1000.0 + np.arange(N))
        data_peers = [td.topology.global_idx(r, j, s, m) for j in range(4)]
        full = sum(q * 1000.0 + np.arange(N) for q in data_peers)
        np.testing.assert_array_equal(td.local_part(rs, p), full[d * 6:(d + 1) * 6])


def test_barrier_and_misuse(tenv):
    td = tenv.create_distribution(8, 1)
    td.barrier(GroupType.GLOBAL)
    with pytest.raises(MLSLError):
        td.all_reduce(torch.zeros((8, N)), N, DataType.FLOAT, ReductionType.SUM,
                      GroupType.DATA)                       # not a grid buffer
    with pytest.raises(MLSLError):
        td.reduce_scatter(torch.zeros((1, 8, 1, 1, N + 1)), N // 8, DataType.FLOAT,
                          ReductionType.SUM, GroupType.DATA)
    with pytest.raises(MLSLError):
        tcoll.build_collective("alltoallv", td.data_group)  # not ported yet


def _allreduce_req(tenv, td, count, **kw):
    req = CommRequest(CommDesc("allreduce", td.data_group, count, DataType.FLOAT,
                               op=ReductionType.SUM, **kw), tenv.dispatcher)
    req.setup()
    return req


def test_large_message_chunking(tenv, monkeypatch):
    td = tenv.create_distribution(8, 1)
    count = 4096
    tenv.config.large_msg_size_mb = 0
    plain = _allreduce_req(tenv, td, count)
    tenv.config.large_msg_size_mb = 1          # 1 MiB threshold, 4 chunks
    tenv.config.large_msg_chunks = 4
    count = 2 ** 19                            # 2 MiB per rank
    chunked = _allreduce_req(tenv, td, count)
    assert len(chunked._chunk_slices) == 4 and sum(
        s.stop - s.start for s in chunked._chunk_slices) == count
    buf = td.make_buffer(lambda p: np.full(count, p, np.float32), count)
    out = chunked.start(buf).wait()
    assert out.shape == buf.shape
    np.testing.assert_array_equal(td.local_part(out, 3), 28.0)
    assert len(plain._chunk_slices) == 1


def test_newest_first_deferral(tenv):
    td = tenv.create_distribution(8, 1)
    tenv.config.msg_priority = True
    tenv.config.msg_priority_threshold = 16
    # a window far longer than the test: the progress thread stays out of it
    tenv.config.msg_priority_flush_ms = 600_000.0
    order = []
    reqs = [_allreduce_req(tenv, td, 64) for _ in range(3)]
    for r in reqs:
        orig = r._dispatch
        r._dispatch = (lambda buf, *a, _r=r, _o=orig: (order.append(_r.uid), _o(buf, *a)))
    small = _allreduce_req(tenv, td, 2)        # 8 bytes: below the threshold
    buf = td.make_buffer(lambda p: np.ones(64, np.float32), 64)
    for r in reqs:
        r.start(buf)
    assert tenv.dispatcher.pending_count == 3 and not order
    small.start(buf[..., :2])
    assert small._dispatched                   # small messages go at once
    out = reqs[0].wait()                       # a wait flushes the stack, LIFO
    assert order == [r.uid for r in reversed(reqs)]
    np.testing.assert_array_equal(td.local_part(out, 0), 8.0)
    for r in reqs[1:]:
        done, res = r.test()
        assert done and res is not None


@pytest.mark.parametrize("grid", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("gt", [GroupType.DATA, GroupType.MODEL, GroupType.GLOBAL])
@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter"])
def test_sum_is_jax_psum_bit_for_bit(env, tenv, grid, gt, kind):
    """On the CPU the SUM adds the members one by one in member order, the
    order of JAX's CPU psum: random floats agree bit for bit, and an
    element's sum does not depend on its offset in the payload (a gradient
    bucket's concatenated request gives each member its own request's
    bits). The card's one-pass sum is held to the second property by
    chip_smoke.py."""
    jd, td = env.create_distribution(*grid), tenv.create_distribution(*grid)
    jg, tg = jd._group(gt), td._group(gt)
    n = 8 * 500
    x = np.random.default_rng(grid[0] + int(gt)).normal(
        size=(*td.world_shape, n)).astype(np.float32)
    kw = {"recv_count": n // tg.size} if kind == "reduce_scatter" else {}
    want = np.asarray(jcoll.build_collective(kind, jg, np.float32, op=ReductionType.SUM, **kw)(
        jd.topology.shard_buffer(x)))
    fn = tcoll.build_collective(kind, tg, op=ReductionType.SUM, **kw)
    got = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "allreduce":
        part = tcoll.build_collective(kind, tg, op=ReductionType.SUM)(
            torch.from_numpy(np.ascontiguousarray(x[..., 3:n - 5]))).numpy()
        np.testing.assert_array_equal(part, got[..., 3:n - 5])
