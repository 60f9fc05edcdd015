"""Color groups and the remaining collectives of the port against the JAX
package on the 8-device CPU mesh: the group tables (comm/mesh.py), every
collective kind on axis, equal-color and ragged-color groups
(comm/collectives.py), alltoallv's matrices (comm/request.py), the
Distribution methods and the Environment surface.

Tolerances: integer-valued payloads (p * 1000 + i, and int32) and every move
(bcast, gathers, scatter, sendrecv, alltoall, alltoallv) must agree bit for
bit; random float sums within rtol 1e-6 (the port sums the members in another
order than XLA)."""

import numpy as np
import pytest
import torch

from mlsl_tpu.comm import collectives as jcoll
from mlsl_tpu.comm import request as jreq
from mlsl_tpu.log import MLSLError as JMLSLError
from mlsl_tpu_torch.comm import algos as talgos
from mlsl_tpu_torch.comm import collectives as tcoll
from mlsl_tpu_torch.comm import request as treq
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.types import DataType, GroupType, OpType, QuantParams, ReductionType

torch.set_num_threads(2)

N = 12
RTOL = 1e-6

EVEN_ODD = tuple(p % 2 for p in range(8))       # two strided groups of 4
BLOCKED = tuple(p // 4 for p in range(8))       # two blocked groups of 4
RAGGED = (0, 0, 0, 1, 1, 1, 1, 1)               # sizes 3 and 5
COLORS = {"even_odd": EVEN_ODD, "blocked": BLOCKED, "ragged": RAGGED,
          "pairs": tuple(p // 2 for p in range(8)), "ragged_2_6": (1, 0, 0, 0, 1, 0, 0, 0)}


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _payload(data, n, seed, dtype=np.float32):
    if data == "int":
        return np.stack([p * 1000.0 + np.arange(n) for p in range(8)]).astype(dtype)
    rng = np.random.default_rng(seed)
    return rng.normal(size=(8, n)).astype(np.float32)


#: the kinds that move elements without arithmetic: bit-exact on any payload
MOVES = ("bcast", "allgather", "allgatherv", "gather", "scatter", "sendrecv", "alltoall",
         "alltoallv")


def _compare(got, want, data, msg, kind=""):
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if data == "int" or kind in MOVES:
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6, err_msg=msg)


def _run_both(jd, td, jg, tg, kind, x, data, dtype=np.float32, **kw):
    """The same input through JAX's and the port's build_collective."""
    xg = x.reshape(*td.world_shape, x.shape[-1])
    want = np.asarray(jcoll.build_collective(kind, jg, dtype, **kw)(
        jd.topology.shard_buffer(xg)))
    got = tcoll.build_collective(kind, tg, **kw)(torch.from_numpy(xg)).numpy()
    _compare(got, want, data, f"{kind} {kw}", kind)
    return got


def _a2av_matrix(g, seed, zero_every=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(1, 4, size=(g, g))
    if zero_every:
        s[::zero_every, 1::zero_every] = 0
    return s


def _a2av_kw(group_t, group_j, desc_kw):
    """Normalize the same alltoallv arguments in both packages; they must
    give the same matrices."""
    td = treq.CommDesc("alltoallv", group_t, 0, DataType.FLOAT, **desc_kw)
    jd = jreq.CommDesc("alltoallv", group_j, 0, DataType.FLOAT, **desc_kw)
    tk, jk = treq.normalize_alltoallv(td), jreq._normalize_alltoallv(jd)
    assert tk == jk
    return tk


def _tup(a):
    a = np.asarray(a)
    if a.ndim == 1:
        return tuple(int(v) for v in a)
    return tuple(tuple(int(v) for v in r) for r in a)


# -- the group tables ------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(COLORS))
def test_color_group_tables_match_jax(env, tenv, name):
    colors = COLORS[name]
    jd = env.create_distribution_with_colors(colors, BLOCKED)
    td = tenv.create_distribution_with_colors(colors, BLOCKED)
    jg, tg = jd.data_group, td.data_group
    assert tg.group_sizes == jg.group_sizes
    assert tg.is_uniform == jg.is_uniform
    assert tg.size == jg.size and not tg.is_self
    assert td.is_ragged == jd.is_ragged
    assert (td.data_parts, td.model_parts, td.replica_count) == (
        jd.data_parts, jd.model_parts, jd.replica_count)
    assert td.world_shape == jd.world_shape
    for c in sorted(set(colors)):
        assert tg.member_world_ranks(c) == jg.member_world_ranks(c)
    assert tg.member_table() == jcoll._color_groups_tbl(jg)
    for p in range(8):
        assert tg.group_idx_of(p) == jg.group_idx_of(p)
        assert td.get_process_idx(GroupType.DATA, p) == jd.get_process_idx(GroupType.DATA, p)
    for gt in GroupType:
        assert td.get_process_count(gt) == jd.get_process_count(gt)
    if tg.is_uniform:
        np.testing.assert_array_equal(tcoll.member_world_table(tg),
                                      jcoll._member_world_table(jg))
    assert talgos.group_shape(tg) == (-tg.size,)


@pytest.mark.parametrize("grid", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("gt", [GroupType.DATA, GroupType.MODEL, GroupType.GLOBAL])
def test_member_world_table_axis_groups(env, tenv, grid, gt):
    jd, td = env.create_distribution(*grid), tenv.create_distribution(*grid)
    np.testing.assert_array_equal(tcoll.member_world_table(td._group(gt)),
                                  jcoll._member_world_table(jd._group(gt)))


# -- the new kinds on axis groups ------------------------------------------------


def _new_kind_variants(g, n):
    out = [("scatter", {"root": 0, "recv_count": n // g}),
           ("scatter", {"root": g - 1, "recv_count": n // g}),
           ("sendrecv", {"pairs": tuple((i, (i + 1) % g) for i in range(g))}),
           ("sendrecv", {"pairs": ((0, g - 1),)}),
           ("allgatherv", {"recv_counts": tuple(1 + (3 * i) % n for i in range(g))})]
    return out


@pytest.mark.parametrize("grid", [(8, 1), (4, 2), (2, 4), (1, 8)])
@pytest.mark.parametrize("gt", [GroupType.DATA, GroupType.MODEL, GroupType.GLOBAL])
@pytest.mark.parametrize("data", ["int", "float"])
def test_new_kinds_axis_groups_match_jax(env, tenv, grid, gt, data):
    jd, td = env.create_distribution(*grid), tenv.create_distribution(*grid)
    jg, tg = jd._group(gt), td._group(gt)
    g = 1 if tg.is_self else tg.size
    n = 24
    x = _payload(data, n, seed=grid[0] * 7 + int(gt))
    for kind, kw in _new_kind_variants(g, n):
        _run_both(jd, td, jg, tg, kind, x, data, **kw)
    # alltoallv in matrix form, every member sending each a few elements
    s = _a2av_matrix(g, seed=grid[0] + int(gt))
    akw = _a2av_kw(tg, jg, {"send_counts": _tup(s)})
    xa = _payload(data, int(s.sum(axis=1).max()) + 2, seed=5)
    _run_both(jd, td, jg, tg, "alltoallv", xa, data, **akw)


@pytest.mark.parametrize("grid", [(4, 2), (2, 4)])
def test_int32_moves_axis_groups(env, tenv, grid):
    jd, td = env.create_distribution(*grid), tenv.create_distribution(*grid)
    x = _payload("int", 24, 0).astype(np.int32)
    for gt in (GroupType.DATA, GroupType.MODEL):
        jg, tg = jd._group(gt), td._group(gt)
        g = tg.size
        for kind, kw in _new_kind_variants(g, 24) + [
                ("allreduce", {"op": ReductionType.SUM}),
                ("reduce_scatter", {"op": ReductionType.MAX, "recv_count": 24 // g})]:
            _run_both(jd, td, jg, tg, kind, x, "int", dtype=np.int32, **kw)


# -- equal color groups: all eleven kinds ---------------------------------------


def _all_kinds(g, n):
    out = [("allreduce", {"op": op}) for op in ReductionType]
    out += [("reduce", {"op": ReductionType.SUM, "root": 1}),
            ("bcast", {"root": 0}), ("bcast", {"root": g - 1}),
            ("allgather", {}), ("gather", {"root": min(2, g - 1)}),
            ("alltoall", {"send_count": n // g})]
    out += [("reduce_scatter", {"op": op, "recv_count": n // g}) for op in ReductionType]
    return out + _new_kind_variants(g, n)


@pytest.mark.parametrize("colors", ["even_odd", "blocked", "pairs"])
@pytest.mark.parametrize("data", ["int", "float"])
def test_all_kinds_equal_color_groups_match_jax(env, tenv, colors, data):
    c = COLORS[colors]
    jd = env.create_distribution_with_colors(c, BLOCKED)
    td = tenv.create_distribution_with_colors(c, BLOCKED)
    jg, tg = jd.data_group, td.data_group
    g = tg.size
    n = 24
    x = _payload(data, n, seed=len(colors))
    for kind, kw in _all_kinds(g, n):
        _run_both(jd, td, jg, tg, kind, x, data, **kw)
    # alltoallv: the instance matrix and the per-rank (W, G) form
    s = _a2av_matrix(g, seed=3)
    xa = _payload(data, int(s.sum(axis=1).max()), seed=4)
    _run_both(jd, td, jg, tg, "alltoallv", xa, data,
              **_a2av_kw(tg, jg, {"send_counts": _tup(s)}))
    sw = np.random.default_rng(6).integers(0, 4, size=(8, g))
    xw = _payload(data, int(sw.sum(axis=1).max()) + 1, seed=7)
    _run_both(jd, td, jg, tg, "alltoallv", xw, data,
              **_a2av_kw(tg, jg, {"send_counts": _tup(sw)}))


def test_barrier_on_color_groups(env, tenv):
    td = tenv.create_distribution_with_colors(EVEN_ODD, RAGGED)
    td.barrier(GroupType.DATA)
    td.barrier(GroupType.MODEL)
    td.barrier(GroupType.GLOBAL)


# -- ragged color groups ---------------------------------------------------------


def _ragged_kinds(gmax, gmin, n):
    out = [("allreduce", {"op": op}) for op in ReductionType]
    out += [("reduce", {"op": ReductionType.SUM, "root": 0}),
            ("bcast", {"root": 1}), ("allgather", {}), ("gather", {"root": 0}),
            ("sendrecv", {"pairs": tuple((i, (i + 1) % gmin) for i in range(gmin))}),
            ("scatter", {"root": gmin - 1, "recv_count": n // gmax}),
            ("alltoall", {"send_count": n // gmax})]
    out += [("reduce_scatter", {"op": op, "recv_count": n // gmax}) for op in ReductionType]
    return out


@pytest.mark.parametrize("colors", ["ragged", "ragged_2_6"])
@pytest.mark.parametrize("data", ["int", "float"])
def test_ragged_color_groups_match_jax(env, tenv, colors, data):
    """Unequal partitions pad to the largest group: absent members are zeros
    (or the op's neutral value), allgather and alltoall deliver zeros from
    absent positions, scatter and reduce_scatter read a Gmax-wide buffer."""
    c = COLORS[colors]
    jd = env.create_distribution_with_colors(c, (0,) * 8)
    td = tenv.create_distribution_with_colors(c, (0,) * 8)
    jg, tg = jd.data_group, td.data_group
    gmax, gmin = tg.size, min(tg.group_sizes)
    n = gmax * 6
    x = _payload(data, n, seed=11)
    for kind, kw in _ragged_kinds(gmax, gmin, n):
        _run_both(jd, td, jg, tg, kind, x, data, **kw)
    xi = _payload("int", n, 0).astype(np.int32)
    for kind, kw in _ragged_kinds(gmax, gmin, n):
        _run_both(jd, td, jg, tg, kind, xi, "int", dtype=np.int32, **kw)


def test_ragged_refusals_match_jax(env, tenv):
    jd = env.create_distribution_with_colors(RAGGED, (0,) * 8)
    td = tenv.create_distribution_with_colors(RAGGED, (0,) * 8)
    jg, tg = jd.data_group, td.data_group
    rc = 4
    small = _payload("int", rc * 3, 0).reshape(*td.world_shape, rc * 3)
    for kind in ("scatter", "reduce_scatter"):
        kw = {"recv_count": rc, "root": 1} if kind == "scatter" else {
            "recv_count": rc, "op": ReductionType.SUM}
        with pytest.raises(JMLSLError, match="Gmax"):
            jcoll.build_collective(kind, jg, np.float32, **kw)(
                jd.topology.shard_buffer(small))
        with pytest.raises(MLSLError, match="Gmax"):
            tcoll.build_collective(kind, tg, **kw)(torch.from_numpy(small))
    # alltoallv and allgatherv are refused on ragged groups
    with pytest.raises(JMLSLError, match="unequal-sized"):
        jcoll.build_collective("alltoallv", jg, np.float32, S=((1,) * 5,) * 5,
                               Soff=((0,) * 5,) * 5, Roff=((0,) * 5,) * 5, recv_len=5)
    with pytest.raises(MLSLError, match="unequal-sized"):
        tcoll.build_collective("alltoallv", tg, S=((1,) * 5,) * 5, Soff=((0,) * 5,) * 5,
                               Roff=((0,) * 5,) * 5, recv_len=5)
    with pytest.raises(JMLSLError):
        jcoll.build_collective("allgatherv", jg, np.float32, recv_counts=(1,) * 5)
    with pytest.raises(MLSLError, match="unequal-sized"):
        tcoll.build_collective("allgatherv", tg, recv_counts=(1,) * 5)
    # a root or pair beyond the smallest group
    with pytest.raises(JMLSLError):
        jcoll.build_collective("bcast", jg, np.float32, root=3)
    with pytest.raises(MLSLError, match="smallest"):
        tcoll.build_collective("bcast", tg, root=3)
    with pytest.raises(MLSLError, match="smallest"):
        tcoll.build_collective("sendrecv", tg, pairs=((0, 4),))
    # the Distribution entry points raise the same
    buf = td.make_buffer(lambda p: np.arange(40.0), 40)
    with pytest.raises(MLSLError):
        td.all_to_allv(buf, [8] * 5, None, None, None, DataType.FLOAT, GroupType.DATA)
    with pytest.raises(JMLSLError):
        env.wait(jd.all_to_allv(jd.make_buffer(lambda p: np.arange(40.0), 40), [8] * 5,
                                None, None, None, DataType.FLOAT, GroupType.DATA))
    # per-rank alltoallv needs equal groups, with JAX's message
    with pytest.raises(MLSLError, match="per-rank alltoallv requires equal-size groups"):
        treq.normalize_alltoallv(treq.CommDesc(
            "alltoallv", tg, 0, DataType.FLOAT, send_counts=_tup(np.ones((8, 5), int))))
    with pytest.raises(JMLSLError, match="per-rank alltoallv requires equal-size groups"):
        jreq._normalize_alltoallv(jreq.CommDesc(
            "alltoallv", jg, 0, DataType.FLOAT, send_counts=_tup(np.ones((8, 5), int))))
    # operations need equal groups
    for e, d, err in ((env, jd, JMLSLError), (tenv, td, MLSLError)):
        s = e.create_session()
        s.set_global_minibatch_size(40)
        r = s.create_operation_reg_info(OpType.CC)
        r.add_input(8, 4)
        r.add_output(8, 4)
        with pytest.raises(err):
            s.add_operation(r, d)


# -- alltoallv through Distribution (tests/test_collectives.py:233-393, 663) -------


@pytest.fixture()
def tenv4():
    Environment.get_env().finalize()
    e = Environment.get_env().init(device="cpu", world_size=4)
    yield e
    e.finalize()


def _a2av_dists(env, tenv4, g=4):
    return (env.create_distribution(1, g, devices=env.devices[:g]),
            tenv4.create_distribution(1, g))


def _packed(m):
    return np.hstack([np.zeros((m.shape[0], 1), int), np.cumsum(m, axis=1)[:, :-1]])


def _dist_a2av(env, e2, jd, td, s, soff, r, roff, send_len, gt=GroupType.MODEL):
    mk = lambda p: p * 100.0 + np.arange(send_len, dtype=np.float64)  # noqa: E731
    want = np.asarray(env.wait(jd.all_to_allv(jd.make_buffer(mk, send_len), s, soff, r,
                                              roff, DataType.FLOAT, gt)))
    got = e2.wait(td.all_to_allv(td.make_buffer(mk, send_len), s, soff, r, roff,
                                 DataType.FLOAT, gt)).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def test_alltoallv_matrix_and_explicit_recv_counts(env, tenv4):
    g = 4
    jd, td = _a2av_dists(env, tenv4)
    s = np.array([[(i + j) % 3 + 1 for j in range(g)] for i in range(g)])
    soff, roff = _packed(s), _packed(s.T)
    send_len = int(s.sum(axis=1).max())
    for r in (None, s.T):
        got = torch.from_numpy(_dist_a2av(env, tenv4, jd, td, s, soff, r, roff, send_len))
        for p in range(g):
            expected = np.zeros(got.shape[-1], np.float32)
            for j in range(g):
                src = (j * 100.0 + np.arange(send_len)).astype(np.float32)
                expected[roff[p, j]:roff[p, j] + s[j, p]] = src[soff[j, p]:soff[j, p] + s[j, p]]
            np.testing.assert_array_equal(td.local_part(got, p), expected)
    buf = td.make_buffer(lambda p: np.arange(send_len, dtype=np.float64), send_len)
    with pytest.raises(MLSLError, match="transposed"):
        td.all_to_allv(buf, s, soff, np.ones((g, g), int), roff, DataType.FLOAT,
                       GroupType.MODEL)


def test_alltoallv_zero_counts_emulate_subgroups(env, tenv4):
    g = 4
    jd, td = _a2av_dists(env, tenv4)
    half = lambda i: i // 2  # noqa: E731
    s = np.array([[(i + j) % 2 + 1 if half(i) == half(j) else 0 for j in range(g)]
                  for i in range(g)])
    _dist_a2av(env, tenv4, jd, td, s, _packed(s), s.T, _packed(s.T), int(s.sum(1).max()))


def _per_rank(dist, gt, s):
    g = dist._group(gt)
    w = 8
    members = tcoll.member_world_table(g)
    pos = np.array([g.group_idx_of(p) for p in range(w)])
    r = np.array([[s[members[p][j], pos[p]] for j in range(members.shape[1])]
                  for p in range(w)])
    return r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alltoallv_per_rank_random_matrices(env, tenv, seed):
    """Random per-rank counts with zeros and non-packed send offsets, on the
    2-instance model groups of (2, 4)."""
    w, g = 8, 4
    rng = np.random.default_rng(seed)
    jd, td = env.create_distribution(2, g), tenv.create_distribution(2, g)
    s = rng.integers(0, 5, size=(w, g))
    gaps = rng.integers(0, 3, size=(w, g))
    soff = np.zeros((w, g), dtype=int)
    for q in range(w):
        off = 0
        for j in range(g):
            off += gaps[q, j]
            soff[q, j] = off
            off += s[q, j]
    r = _per_rank(td, GroupType.MODEL, s)
    roff = _packed(r)
    send_len = int((soff + s).max()) + 1
    _dist_a2av(env, tenv, jd, td, s, soff, r, roff, send_len)
    bad = r.copy()
    bad[3, 1] += 1
    with pytest.raises(MLSLError, match="pairwise invariant"):
        td.all_to_allv(td.make_buffer(lambda p: np.arange(send_len, dtype=np.float64),
                                      send_len), s, soff, bad, roff, DataType.FLOAT,
                       GroupType.MODEL)


def test_alltoallv_per_rank_color_groups(env, tenv):
    w, g = 8, 4
    jd = env.create_distribution_with_colors(EVEN_ODD, BLOCKED)
    td = tenv.create_distribution_with_colors(EVEN_ODD, BLOCKED)
    s = np.array([[(q + 2 * j) % 3 + (q % 2) for j in range(g)] for q in range(w)])
    r = _per_rank(td, GroupType.DATA, s)
    _dist_a2av(env, tenv, jd, td, s, _packed(s), r, _packed(r), int(s.sum(axis=1).max()),
               gt=GroupType.DATA)


# -- the Distribution's other new methods -------------------------------------------


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (1, 8)])
def test_distribution_new_methods_match_jax(env, tenv, grid):
    jd, td = env.create_distribution(*grid), tenv.create_distribution(*grid)
    mk = lambda p: p * 1000.0 + np.arange(32, dtype=np.float64)  # noqa: E731
    jb, tb = jd.make_buffer(mk, 32), td.make_buffer(mk, 32)
    for gt in (GroupType.MODEL, GroupType.DATA, GroupType.GLOBAL):
        g = td.get_process_count(gt)
        rc = 32 // g
        cases = [
            (jd.scatter(jb, rc, DataType.FLOAT, g - 1, gt),
             td.scatter(tb, rc, DataType.FLOAT, g - 1, gt)),
            (jd.all_gatherv(jb, 32, [1 + i for i in range(g)], DataType.FLOAT, gt),
             td.all_gatherv(tb, 32, [1 + i for i in range(g)], DataType.FLOAT, gt)),
        ]
        if g > 1:
            pairs = [(i, (i + 1) % g) for i in range(g)]
            cases.append((jd.send_recv_list(jb, 32, DataType.FLOAT, pairs, gt),
                          td.send_recv_list(tb, 32, DataType.FLOAT, pairs, gt)))
        for jr, tr in cases:
            np.testing.assert_array_equal(tenv.wait(tr).numpy(), np.asarray(env.wait(jr)))
        for root in (0, g - 1):
            jh = jd.gather_to_host(jb, 32, DataType.FLOAT, root, gt)
            th = td.gather_to_host(tb, 32, DataType.FLOAT, root, gt)
            assert sorted(jh) == sorted(th)
            for k in jh:
                np.testing.assert_array_equal(th[k], jh[k])


def test_gather_to_host_ragged_and_limits(env, tenv):
    td = tenv.create_distribution_with_colors(RAGGED, (0,) * 8)
    jd = env.create_distribution_with_colors(RAGGED, (0,) * 8)
    mk = lambda p: p * 1000.0 + np.arange(N, dtype=np.float64)  # noqa: E731
    th = td.gather_to_host(td.make_buffer(mk, N), N, DataType.FLOAT, 0, GroupType.DATA)
    jh = jd.gather_to_host(jd.make_buffer(mk, N), N, DataType.FLOAT, 0, GroupType.DATA)
    assert sorted(th) == sorted(jh) == [0, 3]
    for k in jh:
        np.testing.assert_array_equal(th[k], jh[k])
    assert th[0].shape == (3 * N,) and th[3].shape == (5 * N,)
    # the device gather's cap points to gather_to_host
    d = tenv.create_distribution(1, 8)
    buf = d.make_buffer(lambda p: np.zeros(40_000), 40_000)
    tenv.config.gather_device_limit_mb = 1
    with pytest.raises(MLSLError, match="gather_to_host"):
        d.gather(buf, 40_000, DataType.FLOAT, 0, GroupType.MODEL)
    assert d.gather_to_host(buf, 40_000, DataType.FLOAT, 0, GroupType.MODEL)[0].shape == (
        8 * 40_000,)


def test_send_recv_list_validation(tenv):
    td = tenv.create_distribution(2, 4)
    buf = td.make_buffer(lambda p: np.zeros(4), 4)
    for pairs in (((0, 4),), ((0, 1), (0, 2)), ((0, 1), (2, 1))):
        with pytest.raises(MLSLError):
            td.send_recv_list(buf, 4, DataType.FLOAT, pairs, GroupType.MODEL)


def test_colors_mode_global_and_model_collectives(env, tenv):
    data_colors = tuple(p % 4 for p in range(8))
    model_colors = tuple(p // 2 for p in range(8))
    td = tenv.create_distribution_with_colors(data_colors, model_colors)
    jd = env.create_distribution_with_colors(data_colors, model_colors)
    mk = lambda p: np.full(4, float(p))  # noqa: E731
    for gt in (GroupType.GLOBAL, GroupType.MODEL, GroupType.DATA):
        got = tenv.wait(td.all_reduce(td.make_buffer(mk, 4), 4, DataType.FLOAT,
                                      ReductionType.SUM, gt)).numpy()
        want = np.asarray(env.wait(jd.all_reduce(jd.make_buffer(mk, 4), 4, DataType.FLOAT,
                                                 ReductionType.SUM, gt)))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(td.local_part(tenv.wait(td.all_reduce(
        td.make_buffer(mk, 4), 4, DataType.FLOAT, ReductionType.SUM, GroupType.MODEL)), 4),
        np.full(4, 9.0))


# -- the engine on color groups -------------------------------------------------------


@pytest.mark.parametrize("algo", ["lax", "rhd", "pallas_ring", "pallas_rhd", "ring2d"])
@pytest.mark.parametrize("colors", ["even_odd", "ragged"])
def test_color_group_selection_matches_jax(env, tenv, monkeypatch, algo, colors):
    """MLSL_ALGO on a color group selects as in the JAX package: only the
    baseline and, on equal groups, ``rhd`` lower it; the staged form takes
    none."""
    from mlsl_tpu.comm import algos as jalgos

    monkeypatch.setenv("MLSL_ALGO", algo)
    monkeypatch.setenv("MLSL_PALLAS_INTERPRET", "1")
    jenv = type(env).get_env()
    jenv.finalize()
    jenv = type(env).get_env().init()
    Environment.get_env().finalize()
    tenv = Environment.get_env().init(device="cpu", world_size=8)
    c = COLORS[colors]
    jd = jenv.create_distribution_with_colors(c, BLOCKED)
    td = tenv.create_distribution_with_colors(c, BLOCKED)
    for kind in ("allreduce", "reduce_scatter"):
        jsel = jalgos.select(kind, jd.data_group, 4096, 0, jenv.config,
                             op=ReductionType.SUM)
        tsel = talgos.select(kind, td.data_group, 4096, 0, tenv.config,
                             op=ReductionType.SUM)
        assert tsel == jsel, (kind, algo, colors)
        assert not talgos.inline_eligible(tsel, kind, td.data_group, ReductionType.SUM)
    if algo == "rhd" and colors == "even_odd":
        # rhd over the equal color groups gives the JAX program's sums
        mk = lambda p: p * 1000.0 + np.arange(N, dtype=np.float64)  # noqa: E731
        tr = td.all_reduce(td.make_buffer(mk, N), N, DataType.FLOAT, ReductionType.SUM,
                           GroupType.DATA)
        jr = jd.all_reduce(jd.make_buffer(mk, N), N, DataType.FLOAT, ReductionType.SUM,
                           GroupType.DATA)
        assert tr.algo == jr.algo == "rhd"
        np.testing.assert_array_equal(tenv.wait(tr).numpy(), np.asarray(jenv.wait(jr)))
    tenv.finalize()


# -- the Environment surface ------------------------------------------------------------


def test_configure_color_list_restricts_world(env, tenv):
    env.configure("color=0,0,0,0,1,1,1,1")
    tenv.configure("color=0,0,0,0,1,1,1,1")
    assert tenv.get_process_count() == len(env.devices) == 4
    jd, td = env.create_distribution(4, 1), tenv.create_distribution(4, 1)
    assert td.get_process_count(GroupType.GLOBAL) == jd.get_process_count(GroupType.GLOBAL)
    mk = lambda p: np.full(4, float(p + 1))  # noqa: E731
    got = tenv.wait(td.all_reduce(td.make_buffer(mk, 4), 4, DataType.FLOAT,
                                  ReductionType.SUM, GroupType.DATA))
    np.testing.assert_array_equal(td.local_part(got, 0), np.full(4, 10.0))
    with pytest.raises(MLSLError):
        tenv.configure("colour=1")
    with pytest.raises(MLSLError):
        tenv.configure("color=0,1,0")


def test_configure_uniform_color_is_full_world(env, tenv):
    env.configure("color=3")
    tenv.configure("color=3")
    assert tenv.get_process_count() == len(env.devices) == 8


def test_environment_alloc_version_and_quant_params(env, tenv):
    a, b = tenv.alloc(16, DataType.INT32), env.alloc(16, DataType.INT32)
    assert tuple(a.shape) == b.shape and a.dtype == torch.int32 and not a.any()
    assert tenv.alloc(4, DataType.BFLOAT16).dtype == torch.bfloat16
    assert tenv.free(a) is None
    assert tenv.get_version() == tenv.GetVersion()
    assert tenv.get_quantization_params() is None
    qp = QuantParams(elem_in_block=128)
    tenv.set_quantization_params(qp)
    assert tenv.get_quantization_params() is qp and tenv.config.quant_block_elems == 128
    with pytest.raises(MLSLError, match="can't be opened"):
        tenv.set_quantization_params(QuantParams(lib_path="libquant.so",
                                                 quant_buffer_func_name="c",
                                                 dequant_buffer_func_name="d",
                                                 reduce_sum_func_name="r"))
    assert tenv.get_quantization_params() is qp and tenv.config.custom_codec is None
    custom = QuantParams(elem_in_block=128, compress_fn=lambda x: x,
                         decompress_fn=lambda x, n: x)
    tenv.set_quantization_params(custom)
    assert tenv.get_quantization_params() is custom and tenv.config.custom_codec is not None
    tenv.set_quantization_params(qp)
    assert tenv.config.custom_codec is None
    with pytest.raises(MLSLError):
        tenv.set_quantization_params(QuantParams(elem_in_block=100))
    assert tenv.config.quant_block_elems == 128
    # parameters set before init apply at init
    tenv.finalize()
    e = Environment.get_env()
    e.set_quantization_params(QuantParams(elem_in_block=512))
    e.init(device="cpu", world_size=8)
    try:
        assert e.config.quant_block_elems == 512
    finally:
        e.finalize()   # the fixture finalizes the first Environment only
