"""The port's gradient bucketing (mlsl_tpu_torch.core.bucketing) against the
JAX package's (mlsl_tpu.core.bucketing), mirroring tests/test_bucketing.py and
tests/test_quant_bucket.py.

Each test builds the same operations on both sides (the JAX package on the
8-device CPU mesh, the port on 8 CPU virtual ranks) and feeds them the same
numpy-seeded buffers. Tolerances:

- bucket membership, kinds, slots, offsets and totals: equal;
- uncompressed collectives on ``lax``: equal bit for bit to the port's own
  unbucketed requests (each element's sum runs over the same member dim
  whatever its offset in the bucket), and, on integer-valued payloads,
  bit for bit to the JAX package; the MLP trainer against JAX's within
  rtol/atol 1e-6, as tests/test_torch_zero1.py holds it;
- the int8 bucket: within one quantization step (max|result| / 127) of
  JAX's bucket on the same inputs over 3 rounds, the bound
  tests/test_torch_quant_ring.py states against XLA's default arithmetic,
  and within 2 % relative L2 of the exact sum (mlsl_test.cpp:407-428);
- ``BUCKET_COUNTERS``: the round counts equal JAX's after the same calls.
"""

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.core import bucketing as jb
from mlsl_tpu.core import stats as jstats
from mlsl_tpu.models.mlp import LAYERS, get_layer as jget_layer, init as mlp_init
from mlsl_tpu.models.mlp import loss_fn as jmlp_loss
from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
from mlsl_tpu.types import CompressionType as JComp, DataType as JDT, OpType as JOp
from mlsl_tpu_torch.comm import quant_ring as tqr
from mlsl_tpu_torch.comm.request import CommRequest
from mlsl_tpu_torch.config import Config as TConfig
from mlsl_tpu_torch.core import bucketing as tb
from mlsl_tpu_torch.core import stats as tstats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import mlp as tmlp
from mlsl_tpu_torch.models.convert import params_from_jax, params_to_jax
from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer
from mlsl_tpu_torch.ops import ring_kernels as trk
from mlsl_tpu_torch.types import CompressionType, DataType, OpType

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)
MIB = 1024 * 1024
COUNTERS = ("rounds_dispatched", "rounds_fallback", "member_abandons", "bytes_coalesced")


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


@pytest.fixture(autouse=True)
def _fresh_counters():
    jstats.reset_bucket_counters()
    tstats.reset_bucket_counters()
    yield
    jstats.reset_bucket_counters()
    tstats.reset_bucket_counters()


def _sets(env, tenv, specs, bucket_mb, data_parts=8):
    """The same operations on both sides: ``specs`` is a list of (count,
    distributed_update, compression, dtype) -> (jdist, jpss, tdist, tpss)."""
    out = []
    for e, op_t, dt_t, comp_t in ((env, JOp, JDT, JComp), (tenv, OpType, DataType,
                                                           CompressionType)):
        e.config.grad_bucket_mb = bucket_mb
        try:
            dist = e.create_distribution(data_parts, 8 // data_parts)
            s = e.create_session()
            s.set_global_minibatch_size(8)
            pss = []
            for count, du, comp, dtype in specs:
                r = s.create_operation_reg_info(op_t.CC)
                r.add_input(8, 4)
                r.add_output(8, 4)
                r.add_parameter_set(count, 1, data_type=dt_t(int(dtype)),
                                    distributed_update=du, compression_type=comp_t(int(comp)))
                pss.append(s.get_operation(s.add_operation(r, dist)).get_parameter_set(0))
            s.commit()
        finally:
            e.config.grad_bucket_mb = 0
        out += [dist, pss]
    return out


def _plain(counts, du=False, comp=CompressionType.NONE, dtype=DataType.FLOAT):
    return [(c, du, comp, dtype) for c in counts]


def _groups(pss, attr="bucket"):
    """Bucket membership as sorted lists of set indices."""
    seen = {}
    for i, ps in enumerate(pss):
        b = getattr(ps, attr)
        if b is not None:
            seen.setdefault(id(b), []).append(i)
    return sorted(seen.values())


def _counters(mod):
    return {k: mod.BUCKET_COUNTERS[k] for k in COUNTERS}


def _int_bufs(jdist, tdist, pss, seed):
    """Integer-valued float32 buffers (exact sums in any order), one a set."""
    rng = np.random.default_rng(seed)
    out = []
    for ps in pss:
        n = ps.get_local_kernel_count()
        vals = rng.integers(-50, 50, size=(8, n)).astype(np.float32)
        out.append((jdist.make_buffer(lambda p, v=vals: v[p], n),
                    tdist.make_buffer(lambda p, v=vals: v[p], n), vals))
    return out


def _row(t, p=0):
    return t.reshape(8, -1)[p].numpy() if torch.is_tensor(t) else np.asarray(t).reshape(8, -1)[p]


# -- the packing policy ------------------------------------------------------------


class _Sized:
    def __init__(self, n):
        self.n = n


@pytest.mark.parametrize("limit", [100, 1000, 5000, 1 << 20])
def test_pack_by_size_matches_jax(limit):
    rng = np.random.default_rng(limit)
    items = [_Sized(int(n)) for n in rng.integers(1, 3000, size=40)]
    idx = {id(x): i for i, x in enumerate(items)}
    want = [[idx[id(x)] for x in g] for g in jb.pack_by_size(items, limit, lambda x: x.n)]
    got = [[idx[id(x)] for x in g] for g in tb.pack_by_size(items, limit, lambda x: x.n)]
    assert got == want
    assert all(len(g) > 1 for g in got)


SPECS = {
    "plain": _plain([64, 300, 1000, 5000, 200, 7, 90]),
    "zero1": _plain([64 * 8, 300, 1000, 5000, 200, 7, 90], du=True),
    "int8": _plain([64, 300, 1000, 2000, 200, 7], comp=CompressionType.QUANTIZATION),
    "zero1-int8": _plain([512, 300, 1000, 3000, 200], du=True,
                         comp=CompressionType.QUANTIZATION),
    "mixed": [(100, False, CompressionType.NONE, DataType.FLOAT),
              (200, False, CompressionType.QUANTIZATION, DataType.FLOAT),
              (300, True, CompressionType.QUANTIZATION, DataType.FLOAT),
              (400, False, CompressionType.NONE, DataType.BFLOAT16),
              (500, True, CompressionType.NONE, DataType.FLOAT),
              (600, False, CompressionType.NONE, DataType.FLOAT),
              (700, False, CompressionType.QUANTIZATION, DataType.FLOAT),
              (800, True, CompressionType.QUANTIZATION, DataType.FLOAT),
              (900, False, CompressionType.NONE, DataType.BFLOAT16),
              (1000, True, CompressionType.NONE, DataType.FLOAT)],
}


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("bucket_mb", [8192 / MIB, 4])
def test_build_buckets_matches_jax(env, tenv, name, bucket_mb):
    _, jpss, _, tpss = _sets(env, tenv, SPECS[name], bucket_mb)
    for attr in ("bucket", "inc_bucket"):
        assert _groups(tpss, attr) == _groups(jpss, attr), attr
        for jp, tp in zip(jpss, tpss):
            jbk, tbk = getattr(jp, attr), getattr(tp, attr)
            if tbk is None:
                continue
            assert tbk.kind == jbk.kind
            assert int(tbk.compression) == int(jbk.compression)
            assert tbk.counts == jbk.counts and tbk.slots == jbk.slots
            assert tbk.offsets == jbk.offsets
            assert tbk.req.desc.count == jbk.req.desc.count
            assert tbk.req.desc.recv_count == jbk.req.desc.recv_count
    assert any(ps.bucket is not None for ps in tpss)


def test_eligibility(env, tenv):
    """Singletons stay individual, dtypes and compressions never mix, the
    increment bucket coalesces across compressions, and TOPK stays
    individual, as in JAX (the sparse wire has no coalesced form)."""
    specs = [(64, False, CompressionType.NONE, DataType.FLOAT),
             (64, True, CompressionType.NONE, DataType.FLOAT),
             (64, False, CompressionType.QUANTIZATION, DataType.FLOAT),
             (64, False, CompressionType.QUANTIZATION, DataType.FLOAT),
             (64, False, CompressionType.NONE, DataType.BFLOAT16),
             (64, False, CompressionType.NONE, DataType.BFLOAT16),
             (64, True, CompressionType.QUANTIZATION, DataType.FLOAT)]
    _, jpss, _, tpss = _sets(env, tenv, specs, 4)
    assert _groups(tpss) == _groups(jpss) == [[2, 3], [4, 5]]
    assert _groups(tpss, "inc_bucket") == _groups(jpss, "inc_bucket") == [[1, 6]]
    assert tpss[0].bucket is None and tpss[1].bucket is None and tpss[6].bucket is None
    assert [c.name for c in tb._BUCKETABLE] == [c.name for c in jb._BUCKETABLE]
    assert CompressionType.TOPK not in tb._BUCKETABLE
    s = tenv.create_session()
    s.set_global_minibatch_size(8)
    r = s.create_operation_reg_info(OpType.CC)
    r.add_parameter_set(64, 1, compression_type=CompressionType.TOPK)
    op = s.get_operation(s.add_operation(r, tenv.create_distribution(8, 1)))
    assert op.get_parameter_set(0).grad_req.algo == "topk"


def test_config_knob(monkeypatch):
    monkeypatch.setenv("MLSL_GRAD_BUCKET_MB", "25")
    c = TConfig.from_env()
    assert c.grad_bucket_mb == 25 and "grad_bucket_mb" in c._explicit
    c.validate()
    c.grad_bucket_mb = -1
    with pytest.raises(MLSLError, match="MLSL_GRAD_BUCKET_MB"):
        c.validate()
    assert TConfig().grad_bucket_mb == 0


def test_ring_alignment_matches_jax():
    from mlsl_tpu.comm import quant_ring as jqr
    from mlsl_tpu.comm.mesh import ProcessGroup as JGroup, Topology as JTopo

    jg = JGroup(JTopo(8, 1), ("data",))
    for block in (128, 256):
        for rc in (1, 255, 256, 257, 8000, 8 * block * 1024, 8 * block * 1024 + 1):
            assert tqr.ring_aligned_rc(rc, block, False) == jqr.ring_aligned_rc(jg, rc, block)
            for pallas in (False, True):
                assert tqr._chunk_unit(rc, pallas, block) == jqr._chunk_unit(rc, pallas, block)


# -- the collectives of a round ------------------------------------------------------


def _round(pss, bufs):
    for ps, b in zip(reversed(pss), reversed(bufs)):
        ps.start_gradient_comm(b)
    return [ps.wait_gradient_comm() for ps in pss]


@pytest.mark.parametrize("du", [False, True], ids=["allreduce", "zero1"])
def test_lax_bucket_equals_individual_and_jax(env, tenv, du):
    """Both phases on lax: the bucket's results equal the unbucketed port
    requests' and, on integer payloads, JAX's bucket bit for bit."""
    counts = [64 * 8, 301 * 8, 1000, 77]
    jdist, jpss, tdist, tpss = _sets(env, tenv, _plain(counts, du=du), 4)
    _, _, udist, upss = _sets(env, tenv, _plain(counts, du=du), 0)
    assert len(_groups(tpss)) == 1 and all(ps.bucket is None for ps in upss)
    for rnd in range(2):
        bufs = _int_bufs(jdist, tdist, tpss, seed=rnd)
        want = _round(jpss, [b[0] for b in bufs])
        got = _round(tpss, [b[1] for b in bufs])
        ind = _round(upss, [b[1].clone() for b in bufs])
        for w, g, u in zip(want, got, ind):
            np.testing.assert_array_equal(g.numpy(), u.numpy())
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert all(ps._bucket_round for ps in tpss)
        if du:
            # the owned shards go back as the increments
            for pss, incs in ((jpss, want), (tpss, got), (upss, got)):
                for ps, inc in zip(pss, incs):
                    ps.start_increment_comm(inc)
            for jp, tp, up in zip(jpss, tpss, upss):
                tw = tp.wait_increment_comm()
                np.testing.assert_array_equal(tw.numpy(), np.asarray(jp.wait_increment_comm()))
                np.testing.assert_array_equal(tw.numpy(), up.wait_increment_comm().numpy())
            assert all(ps._inc_bucket_round for ps in tpss)
    assert _counters(tstats) == _counters(jstats)
    assert tstats.BUCKET_COUNTERS["rounds_dispatched"] == (4 if du else 2)


@pytest.mark.parametrize("du", [False, True], ids=["allreduce", "zero1"])
def test_int8_bucket_matches_jax_within_one_step(env, tenv, du):
    """The int8 bucket (one residual buffer, block-aligned member slots, the
    ring-aligned total) against JAX's over 3 rounds, residuals carried."""
    counts = [3000 * 8, 700 * 8, 4100 * 8] if du else [3000, 700, 4100, 257]
    specs = _plain(counts, du=du, comp=CompressionType.QUANTIZATION)
    jdist, jpss, tdist, tpss = _sets(env, tenv, specs, 4)
    assert len(_groups(tpss)) == 1
    assert tpss[0].bucket.compression == CompressionType.QUANTIZATION
    rng = np.random.default_rng(7)
    for rnd in range(3):
        bufs = []
        for ps in tpss:
            n = ps.get_local_kernel_count()
            # tests/test_quant_bucket.py's distribution, which its 2 % oracle assumes
            v = rng.normal(size=(8, n)).astype(np.float32)
            bufs.append((jdist.make_buffer(lambda p, v=v: v[p], n),
                         tdist.make_buffer(lambda p, v=v: v[p], n), v))
        want = _round(jpss, [b[0] for b in bufs])
        got = _round(tpss, [b[1] for b in bufs])
        for ps, w, g, (_, _, v) in zip(tpss, want, got, bufs):
            w = np.asarray(w)
            step = np.abs(w).max() / 127.0
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=step)
            exact = v.sum(axis=0)
            if du:
                exact = exact.reshape(8, -1)
            got0 = g.numpy().reshape(8, -1) if du else _row(g)
            assert np.linalg.norm(got0 - exact) / np.linalg.norm(exact) < 0.02
    assert all(ps._bucket_round for ps in tpss)
    assert _counters(tstats) == _counters(jstats)


def test_int8_bucket_on_the_fused_ring_is_chunk_aligned(monkeypatch):
    """With MLSL_ALGO=pallas_ring the int8 bucket sizes its total for the
    fused ring's chunk unit (block * ROW_TILE), so the ring adds no padding
    inside a chunk; the result stays within 2 % of the exact sum."""
    monkeypatch.setenv("MLSL_ALGO", "pallas_ring")
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        env.config.grad_bucket_mb = 4
        dist = env.create_distribution(8, 1)
        s = env.create_session()
        s.set_global_minibatch_size(8)
        counts = [3000, 700, 4100]
        pss = []
        for c in counts:
            r = s.create_operation_reg_info(OpType.CC)
            r.add_parameter_set(c, 1, compression_type=CompressionType.QUANTIZATION)
            pss.append(s.get_operation(s.add_operation(r, dist)).get_parameter_set(0))
        s.commit()
        bucket = pss[0].bucket
        assert bucket.req.algo == "pallas_ring"
        block = env.config.quant_block_elems
        _, rc, chunk, _ = trk.quant_geometry("allreduce", dist.grad_group, bucket.total, block)
        assert rc == chunk and rc % (block * trk.ROW_TILE) == 0
        rng = np.random.default_rng(3)
        vals = [rng.normal(size=(8, c)).astype(np.float32) for c in counts]
        outs = _round(pss, [dist.make_buffer(lambda p, v=v: v[p], c)
                            for v, c in zip(vals, counts)])
        for v, o in zip(vals, outs):
            exact = v.sum(axis=0)
            assert np.linalg.norm(_row(o) - exact) / np.linalg.norm(exact) < 0.02
    finally:
        env.finalize()


# -- the round state machine -----------------------------------------------------------


def test_partial_round_falls_back(env, tenv):
    """A Wait before the bucket fills runs the registered members'
    individual requests; the next complete round is the bucket's again. The
    results equal JAX's for the same calls, and so do the counters."""
    jdist, jpss, tdist, tpss = _sets(env, tenv, _plain([64, 64, 64]), 4)
    assert len(_groups(tpss)) == 1
    bufs = _int_bufs(jdist, tdist, tpss, seed=1)
    for pss, k in ((jpss, 0), (tpss, 1)):
        pss[0].start_gradient_comm(bufs[0][k])
        pss[1].start_gradient_comm(bufs[1][k])
    for i in (0, 1):
        w, g = jpss[i].wait_gradient_comm(), tpss[i].wait_gradient_comm()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(_row(g), bufs[i][2].sum(axis=0))
        assert not tpss[i]._bucket_round
    bufs = _int_bufs(jdist, tdist, tpss, seed=2)
    want = _round(jpss, [b[0] for b in bufs])
    got = _round(tpss, [b[1] for b in bufs])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(ps._bucket_round for ps in tpss)
    assert _counters(tstats) == _counters(jstats)
    assert tstats.BUCKET_COUNTERS["rounds_fallback"] == 1


def test_member_restarted_in_flight_is_abandoned(env, tenv):
    """A member restarted after the bucket dispatched abandons its slot and
    runs its individual request on the new buffer; the others keep the
    bucket's results."""
    jdist, jpss, tdist, tpss = _sets(env, tenv, _plain([64, 96, 32]), 4)
    first = _int_bufs(jdist, tdist, tpss, seed=3)
    again = _int_bufs(jdist, tdist, tpss, seed=4)[1]
    for pss, k in ((jpss, 0), (tpss, 1)):
        for ps, b in zip(pss, first):
            ps.start_gradient_comm(b[k])
        pss[1].start_gradient_comm(again[k])   # restart mid-flight
    assert not tpss[1]._bucket_round
    for i in range(3):
        w, g = jpss[i].wait_gradient_comm(), tpss[i].wait_gradient_comm()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        src = again if i == 1 else first[i]
        np.testing.assert_array_equal(_row(g), src[2].sum(axis=0))
    assert _counters(tstats) == _counters(jstats)
    assert tstats.BUCKET_COUNTERS["member_abandons"] == 1
    # the bucket re-armed: the next full round is its own
    got = _round(tpss, [b[1] for b in first])
    assert all(ps._bucket_round for ps in tpss)
    for g, b in zip(got, first):
        np.testing.assert_array_equal(_row(g), b[2].sum(axis=0))


def _boom(*_a, **_k):
    raise RuntimeError("bucket collective failed")


def test_wait_error_reaches_every_member(tenv, monkeypatch):
    """A failed bucket collective raises at EVERY member's wait, once each
    (tests/test_bucketing.py:201-273); the next complete round supersedes
    the error; a member that retries alone falls back; a member that never
    collected its error and restarts supersedes it."""
    dist = tenv.create_distribution(8, 1)
    tenv.config.grad_bucket_mb = 4
    s = tenv.create_session()
    s.set_global_minibatch_size(8)
    pss = []
    for _ in range(2):
        r = s.create_operation_reg_info(OpType.CC)
        r.add_parameter_set(64, 1)
        pss.append(s.get_operation(s.add_operation(r, dist)).get_parameter_set(0))
    s.commit()
    bucket = pss[0].bucket
    assert bucket is pss[1].bucket
    buf = dist.make_buffer(lambda p: p * 1.0 + np.arange(64, dtype=np.float64), 64)
    want = sum(p * 1.0 + np.arange(64, dtype=np.float32) for p in range(8))

    def fail_round():
        monkeypatch.setattr(bucket.req, "wait", _boom)
        pss[0].start_gradient_comm(buf)
        pss[1].start_gradient_comm(buf)

    fail_round()
    for ps in pss:
        with pytest.raises(RuntimeError, match="bucket collective failed"):
            ps.wait_gradient_comm()
    monkeypatch.undo()
    out = _round(pss, [buf, buf])
    np.testing.assert_allclose(_row(out[0]), want, rtol=1e-6)

    fail_round()
    with pytest.raises(RuntimeError, match="bucket collective failed"):
        pss[0].wait_gradient_comm()
    monkeypatch.undo()
    pss[0].start_gradient_comm(buf)          # solo retry: partial round
    np.testing.assert_allclose(_row(pss[0].wait_gradient_comm()), want, rtol=1e-6)
    with pytest.raises(RuntimeError, match="bucket collective failed"):
        pss[1].wait_gradient_comm()          # member 1 still collects it once

    fail_round()
    with pytest.raises(RuntimeError, match="bucket collective failed"):
        pss[0].wait_gradient_comm()
    monkeypatch.undo()
    pss[1].start_gradient_comm(buf)          # member 1 restarts instead
    np.testing.assert_allclose(_row(pss[1].wait_gradient_comm()), want, rtol=1e-6)


def test_start_error_reaches_every_member(tenv, monkeypatch):
    """A bucket collective that fails as the last member's Start dispatches
    it (a kernel that does not launch) raises there and at every other
    member's Wait and Test: no member falls back to its individual request.
    The next round is served by the bucket."""
    dist = tenv.create_distribution(8, 1)
    tenv.config.grad_bucket_mb = 4
    s = tenv.create_session()
    s.set_global_minibatch_size(8)
    pss = []
    for _ in range(3):
        r = s.create_operation_reg_info(OpType.CC)
        r.add_parameter_set(64, 1)
        pss.append(s.get_operation(s.add_operation(r, dist)).get_parameter_set(0))
    s.commit()
    bucket = pss[0].bucket
    individual = []
    monkeypatch.setattr(CommRequest, "start", lambda self, b, _s=CommRequest.start: (
        individual.append(self.name) if self is not bucket.req else None, _s(self, b))[1])
    monkeypatch.setattr(bucket.req, "_run", _boom)
    buf = dist.make_buffer(lambda p: np.full(64, p, dtype=np.float64), 64)
    pss[2].start_gradient_comm(buf)
    pss[1].start_gradient_comm(buf)
    with pytest.raises(RuntimeError, match="bucket collective failed"):
        pss[0].start_gradient_comm(buf)
    with pytest.raises(RuntimeError, match="bucket collective failed"):
        pss[1].wait_gradient_comm()
    with pytest.raises(RuntimeError, match="bucket collective failed"):
        pss[2].test_gradient_comm()
    assert individual == []
    monkeypatch.delattr(bucket.req, "_run")
    out = _round(pss, [buf] * 3)
    assert all(ps._bucket_round for ps in pss) and individual == []
    np.testing.assert_array_equal(_row(out[0]), np.full(64, 28.0, np.float32))


@pytest.mark.parametrize("seed", [42, 7])
def test_random_round_patterns_match_jax(env, tenv, seed):
    """Random subsets of members start (sometimes twice), some are tested
    before their wait, in random order: every result equals the closed-form
    sum and JAX's, whichever rounds bucket and which fall back, and the
    counters equal JAX's (tests/test_bucketing.py:408-454)."""
    jdist, jpss, tdist, tpss = _sets(env, tenv, _plain([32] * 4), 4)
    assert len(_groups(tpss)) == 1
    rng = np.random.default_rng(seed)
    for rnd in range(12):
        k = int(rng.integers(1, 5))
        members = list(rng.choice(4, size=k, replace=False))
        vals = {}
        for m in members:
            for _ in range(2 if rng.random() < 0.25 else 1):   # occasional restart
                v = rng.integers(-9, 9, size=(8, 32)).astype(np.float32)
                vals[m] = v
                jpss[m].start_gradient_comm(jdist.make_buffer(lambda p, v=v: v[p], 32))
                tpss[m].start_gradient_comm(tdist.make_buffer(lambda p, v=v: v[p], 32))
        rng.shuffle(members)
        for m in members:
            if rng.random() < 0.3:
                done, out = tpss[m].test_gradient_comm()
                jdone, _ = jpss[m].test_gradient_comm()
                if done:
                    np.testing.assert_array_equal(_row(out), vals[m].sum(axis=0))
            got, want = tpss[m].wait_gradient_comm(), jpss[m].wait_gradient_comm()
            np.testing.assert_array_equal(_row(got), vals[m].sum(axis=0),
                                          err_msg=f"round {rnd} member {m}")
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _counters(tstats) == _counters(jstats)


def test_priority_deferral_carries_the_bucket(tenv, monkeypatch):
    """The bucket's request rides the newest-first deferral queue and its
    progress thread like any large request (MLSL_MSG_PRIORITY): the
    deferral engages and the results equal the unbucketed requests'."""
    from mlsl_tpu_torch.comm.request import Dispatcher

    tenv.config.msg_priority = True
    tenv.config.msg_priority_threshold = 512
    deferred = []
    real = Dispatcher.submit

    def submit(self, req, buf):
        if req._payload > self.config.msg_priority_threshold:
            deferred.append(req.name)
        return real(self, req, buf)

    monkeypatch.setattr(Dispatcher, "submit", submit)
    dist = tenv.create_distribution(8, 1)
    outs = []
    for mb in (4, 0):
        tenv.config.grad_bucket_mb = mb
        s = tenv.create_session()
        s.set_global_minibatch_size(8)
        pss = []
        for c in (100, 200, 300):
            r = s.create_operation_reg_info(OpType.CC)
            r.add_parameter_set(c, 1)
            pss.append(s.get_operation(s.add_operation(r, dist)).get_parameter_set(0))
        s.commit()
        rng = np.random.default_rng(5)
        bufs = [dist.make_buffer(lambda p, c=c, v=rng.normal(size=(8, c)): v[p], c)
                for c in (100, 200, 300)]
        outs.append(_round(pss, bufs))
    assert any(n.startswith("bucket-allreduce") for n in deferred), deferred
    for g, u in zip(*outs):
        np.testing.assert_array_equal(g.numpy(), u.numpy())


def test_stats_stay_per_layer(tenv):
    """Each op's comm bytes are its own gradient's, not the bucket's."""
    tenv.config.enable_stats = True
    tenv.config.grad_bucket_mb = 4
    dist = tenv.create_distribution(8, 1)
    s = tenv.create_session()
    s.set_global_minibatch_size(8)
    ops = []
    for c in (64, 192):
        r = s.create_operation_reg_info(OpType.CC)
        r.add_parameter_set(c, 1)
        ops.append(s.get_operation(s.add_operation(r, dist)))
    s.commit()
    pss = [op.get_parameter_set(0) for op in ops]
    assert pss[0].bucket is pss[1].bucket is not None
    st = s.get_stats()
    st.reset()
    _round(pss, [dist.make_buffer(lambda p, c=c: np.arange(c) + p, c) for c in (64, 192)])
    assert st.get_comm_size(ops[0].op_idx) == 64 * 4
    assert st.get_comm_size(ops[1].op_idx) == 192 * 4
    assert st.get_total_comm_size() == (64 + 192) * 4


# -- the trainers ----------------------------------------------------------------------


def _mlp_pair(env, tenv, *, du, bucket_mb, opt=None):
    params = mlp_init(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    env.config.grad_bucket_mb = tenv.config.grad_bucket_mb = bucket_mb
    try:
        jd, td = env.create_distribution(8, 1), tenv.create_distribution(8, 1)
        js, ts = env.create_session(), tenv.create_session()
        js.set_global_minibatch_size(32)
        ts.set_global_minibatch_size(32)
        jt = JTrainer(env, jd, js, params, jmlp_loss, LAYERS, jget_layer, lr=0.1,
                      force_graph_path=True, distributed_update=du, donate_params=False)
        tt = TTrainer(tenv, td, ts, tmlp.MLP(device="cpu", params=params_from_jax(host, "cpu")),
                      tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1, force_graph_path=True,
                      distributed_update=du)
    finally:
        env.config.grad_bucket_mb = tenv.config.grad_bucket_mb = 0
    return jt, tt


@pytest.mark.parametrize("du", [False, True], ids=["plain", "zero1"])
def test_bucketed_training_matches_unbucketed_and_jax(env, tenv, du):
    """tests/test_bucketing.py:41-96 on the port: the MLP fits one 4 MiB
    bucket; bucketed training equals the unbucketed port run bit for bit and
    JAX's bucketed run within 1e-6, with one dispatch a phase and step."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(32,)).astype(np.int32)
    jt, tt = _mlp_pair(env, tenv, du=du, bucket_mb=4)
    _, tu = _mlp_pair(env, tenv, du=du, bucket_mb=0)
    pss = [tt.ops[n].get_parameter_set(0) for n in LAYERS]
    assert len(_groups(pss)) == 1 and len(pss) > 1
    assert pss[0].bucket.kind == ("reduce_scatter" if du else "allreduce")
    if du:
        assert len(_groups(pss, "inc_bucket")) == 1
    for _ in range(3):
        jt.step(jt.shard_batch(x, y))
        tt.step(tt.shard_batch(x, y))
        tu.step(tu.shard_batch(x, y))
    got, plain, want = params_to_jax(tt.model), params_to_jax(tu.model), jax.device_get(jt.params)
    for layer in LAYERS:
        for g, u, w in zip(jax.tree.leaves(got[layer]), jax.tree.leaves(plain[layer]),
                           jax.tree.leaves(want[layer])):
            np.testing.assert_array_equal(g, u, err_msg=layer)
            np.testing.assert_allclose(g, np.asarray(w), err_msg=layer, **TOL)
    assert tstats.BUCKET_COUNTERS["rounds_dispatched"] == 3 * (2 if du else 1)
    assert _counters(tstats) == _counters(jstats)
