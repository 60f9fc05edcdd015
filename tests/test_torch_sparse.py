"""The port's top-k sparse wire (mlsl_tpu_torch.comm.sparse) against the JAX
package's (mlsl_tpu.comm.sparse), mirroring tests/test_sparse.py.

The same numpy-seeded buffers go through JAX on the 8-device CPU mesh and
through the port on 8 CPU virtual ranks. Tolerances:

- the selected indices: the same in both packages, ties included (both take
  the largest magnitudes and, among equal ones, the lower index: ``lax.top_k``
  and the port's stable descending sort); the integer-valued case has many
  ties and must agree bit for bit;
- the all-gather format against JAX's: bit for bit (both add each element's
  terms member 0 first, one add a member); against the float64 sum of the
  sparsified contributions: rtol 1e-5, as tests/test_sparse.py states;
- the ring format against the all-gather format: rtol 1e-6 (other order of
  the same terms); against JAX's ring: bit for bit (the same order);
- error feedback telescoping over 30 rounds: rtol 1e-4 / atol 1e-3, the
  reference's bound; the residuals against JAX's: bit for bit;
- the MLP trainers (TOPK and TOPK under ZeRO-1): the first step's loss and
  gradients within 1e-6 of JAX's, and convergence as the reference asserts.
"""

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.comm import sparse as jsparse
from mlsl_tpu.comm.request import CommDesc as JDesc, CommRequest as JReq
from mlsl_tpu.log import MLSLError as JError
from mlsl_tpu.models.mlp import LAYERS, get_layer as jget_layer, init as mlp_init
from mlsl_tpu.models.mlp import loss_fn as jmlp_loss
from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
from mlsl_tpu.types import CompressionType as JComp, DataType as JDT, ReductionType as JRed
from mlsl_tpu_torch.comm import sparse as tsparse
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import mlp as tmlp
from mlsl_tpu_torch.models.convert import params_from_jax
from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer
from mlsl_tpu_torch.types import CompressionType, DataType, ReductionType

torch.set_num_threads(2)


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _topk_sparsify(x, k):
    idx = np.argsort(-np.abs(x), kind="stable")[:k]
    out = np.zeros_like(x, dtype=np.float64)
    out[idx] = x[idx]
    return out


def _vals(n, seed, ints=False):
    rng = np.random.default_rng(seed)
    if ints:
        return {p: rng.integers(-8, 8, size=n).astype(np.float32) for p in range(8)}
    return {p: rng.normal(size=n).astype(np.float32) for p in range(8)}


def _pair(env, tenv, kind, n, recv_count=None, op=ReductionType.SUM):
    """The same TOPK request on both sides -> (jdist, jreq, tdist, treq)."""
    jd, td = env.create_distribution(8, 1), tenv.create_distribution(8, 1)
    jr = JReq(JDesc(kind, jd.data_group, n, JDT.FLOAT, op=JRed(int(op)), recv_count=recv_count,
                    compression=JComp.TOPK), env.dispatcher)
    tr = CommRequest(CommDesc(kind, td.data_group, n, DataType.FLOAT, op=op,
                              recv_count=recv_count, compression=CompressionType.TOPK),
                     tenv.dispatcher)
    return jd, jr, td, tr


def _round(dist, req, vals, n):
    req.start(dist.make_buffer(lambda p: vals[p], n))
    return req.wait()


@pytest.mark.parametrize("ints", [False, True], ids=["normal", "integer-ties"])
def test_sparse_allreduce_matches_sparsified_sum(env, tenv, ints):
    """First round (zero feedback): every rank's result is the sum of the
    ranks' top-k contributions, bit for bit JAX's."""
    n, ratio = 1000, 0.1
    env.config.topk_ratio = tenv.config.topk_ratio = ratio
    jd, jr, td, tr = _pair(env, tenv, "allreduce", n)
    jr.setup()
    tr.setup()
    assert tr.algo == "topk" and tr._wire_rec == ("topk", 8 * 100)
    vals = _vals(n, 0, ints)
    jout, tout = _round(jd, jr, vals, n), _round(td, tr, vals, n)
    want = sum(_topk_sparsify(vals[p], int(n * ratio)) for p in range(8))
    for p in range(8):
        got = td.local_part(tout, p)
        np.testing.assert_array_equal(got, np.asarray(jd.local_part(jout, p)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sparse_error_feedback_telescopes(env, tenv):
    """Nothing is lost, only deferred: outputs plus residuals sum to T times
    the exact sum, and the residuals are JAX's bit for bit."""
    n, steps = 512, 30
    env.config.topk_ratio = tenv.config.topk_ratio = 0.05
    jd, jr, td, tr = _pair(env, tenv, "allreduce", n)
    jr.setup()
    tr.setup()
    vals = _vals(n, 1)
    total = np.zeros(n, np.float64)
    for _ in range(steps):
        _round(jd, jr, vals, n)
        total += td.local_part(_round(td, tr, vals, n), 0).astype(np.float64)
    exact = steps * sum(vals[p].astype(np.float64) for p in range(8))
    err = tr._errs[0].numpy()
    np.testing.assert_array_equal(err, np.asarray(jr._err))
    err_sum = err.reshape(-1, n).sum(axis=0).astype(np.float64)
    np.testing.assert_allclose(total + err_sum, exact, rtol=1e-4, atol=1e-3)
    assert np.abs(err_sum).max() > 0


def test_sparse_reduce_scatter_placement(env, tenv):
    """Member p receives slice p of the sparsified sum."""
    n_owned = 64
    env.config.topk_ratio = tenv.config.topk_ratio = 0.25
    jd, jr, td, tr = _pair(env, tenv, "reduce_scatter", n_owned * 8, recv_count=n_owned)
    jr.setup()
    tr.setup()
    vals = _vals(n_owned * 8, 3)
    jout, tout = _round(jd, jr, vals, n_owned * 8), _round(td, tr, vals, n_owned * 8)
    want = sum(_topk_sparsify(vals[p], n_owned * 2) for p in range(8))
    for p in range(8):
        got = td.local_part(tout, p)
        np.testing.assert_array_equal(got, np.asarray(jd.local_part(jout, p)))
        np.testing.assert_allclose(got, want[p * n_owned:(p + 1) * n_owned], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter"])
def test_ring_merge_matches_allgather_format(env, tenv, kind):
    """The ring format against the all-gather one (rtol 1e-6) and against
    JAX's ring (bit for bit), results and residuals."""
    n = 800
    jd, td = env.create_distribution(8, 1), tenv.create_distribution(8, 1)
    vals = _vals(n, 11)
    jbuf, tbuf = jd.make_buffer(lambda p: vals[p], n), td.make_buffer(lambda p: vals[p], n)
    jtopo = jd.topology
    jerr = jtopo.shard_buffer(np.zeros((*jtopo.grid_shape, n), np.float32))
    terr = torch.zeros((*td.topology.grid_shape, n))
    out = {}
    for ring in (False, True):
        jfn, _ = jsparse.build_sparse_collective(kind, jd.data_group, n, 0.1, use_ring=ring)
        tfn, el = tsparse.build_sparse_collective(kind, td.data_group, n, 0.1, use_ring=ring)
        assert el == n
        (jo, je), (to, te) = jfn(jbuf, jerr), tfn(tbuf, terr)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        if ring:
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        out[ring] = to.numpy()
    np.testing.assert_allclose(out[True], out[False], rtol=1e-6, atol=1e-7)


def test_ring_auto_selection(tenv, monkeypatch):
    """Below RING_THRESHOLD the all-gather format, at or above it the ring;
    the ring's reduce_scatter places slice p on member p."""
    td = tenv.create_distribution(8, 1)
    n = 256
    vals = _vals(n, 12)
    buf = td.make_buffer(lambda p: vals[p], n)
    err = torch.zeros((*td.topology.grid_shape, n))
    fn_g, _ = tsparse.build_sparse_collective("allreduce", td.data_group, n, 0.1)
    monkeypatch.setattr(tsparse, "RING_THRESHOLD", 4)
    monkeypatch.setattr(tsparse, "_cache", {})
    fn_r, _ = tsparse.build_sparse_collective("allreduce", td.data_group, n, 0.1)
    fn_ring, _ = tsparse.build_sparse_collective("allreduce", td.data_group, n, 0.1,
                                                 use_ring=True)
    assert fn_r is fn_ring and fn_r is not fn_g
    want = sum(_topk_sparsify(vals[p], 25) for p in range(8))
    np.testing.assert_allclose(td.local_part(fn_r(buf, err)[0], 0), want, rtol=1e-5, atol=1e-6)


def test_sparse_rejects_non_sum_and_ring_on_multiaxis(env, tenv):
    _, jr, _, tr = _pair(env, tenv, "allreduce", 64, op=ReductionType.MAX)
    with pytest.raises(JError):
        jr.setup()
    with pytest.raises(MLSLError, match="SUM only"):
        tr.setup()
    jd, td = env.create_distribution(2, 2), tenv.create_distribution(2, 2)
    with pytest.raises(JError):
        jsparse.build_sparse_collective("allreduce", jd.global_group, 64, 0.1, use_ring=True)
    with pytest.raises(MLSLError, match="single-axis"):
        tsparse.build_sparse_collective("allreduce", td.global_group, 64, 0.1, use_ring=True)


def test_sparse_on_multiaxis_group_matches_jax(env, tenv):
    """A two-axis group takes the all-gather format over all its members."""
    n = 300
    jd, td = env.create_distribution(2, 2), tenv.create_distribution(2, 2)
    vals = _vals(n, 13)
    jfn, _ = jsparse.build_sparse_collective("allreduce", jd.global_group, n, 0.2)
    tfn, _ = tsparse.build_sparse_collective("allreduce", td.global_group, n, 0.2)
    jt = jd.topology
    jo, je = jfn(jd.make_buffer(lambda p: vals[p], n),
                 jt.shard_buffer(np.zeros((*jt.grid_shape, n), np.float32)))
    to, te = tfn(td.make_buffer(lambda p: vals[p], n), torch.zeros((*td.topology.grid_shape, n)))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("du,ratio,steps,drop", [(False, 0.25, 40, 0.04), (True, 0.5, 12, 0.02)],
                         ids=["plain", "zero1"])
def test_sparse_training_converges(env, tenv, du, ratio, steps, drop):
    """tests/test_sparse.py's two trainers: the first step's loss and every
    layer's synchronized gradient within 1e-6 of JAX's, then convergence as
    the reference asserts it (the averaged tail for the plain run, which
    delivers deferred coordinates in bursts)."""
    env.config.topk_ratio = tenv.config.topk_ratio = ratio
    params = mlp_init(jax.random.PRNGKey(1 if not du else 2))
    host = jax.tree.map(np.asarray, params)
    jd, td = env.create_distribution(8, 1), tenv.create_distribution(8, 1)
    js, ts = env.create_session(), tenv.create_session()
    js.set_global_minibatch_size(32)
    ts.set_global_minibatch_size(32)
    jt = JTrainer(env, jd, js, params, jmlp_loss, LAYERS, jget_layer, lr=0.1,
                  distributed_update=du, compression=JComp.TOPK, donate_params=False)
    tt = TTrainer(tenv, td, ts, tmlp.MLP(device="cpu", params=params_from_jax(host, "cpu")),
                  tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1, distributed_update=du,
                  compression=CompressionType.TOPK)
    assert all(tt.ops[n].get_parameter_set(0).grad_req.algo == "topk" for n in LAYERS)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(32,)).astype(np.int32)
    jl = float(np.asarray(jt.step(jt.shard_batch(x, y))).reshape(-1)[0])
    losses = [float(np.asarray(tt.step(tt.shard_batch(x, y))).reshape(-1)[0])]
    np.testing.assert_allclose(losses[0], jl, rtol=1e-6)
    for name in LAYERS:
        jreq = jt.ops[name].get_parameter_set(0).grad_req
        treq = tt.ops[name].get_parameter_set(0).grad_req
        np.testing.assert_allclose(treq._result.numpy(), np.asarray(jreq._result), rtol=1e-6,
                                   atol=1e-6)
    for _ in range(steps - 1):
        losses.append(float(np.asarray(tt.step(tt.shard_batch(x, y))).reshape(-1)[0]))
    tail = sum(losses[-5:]) / 5 if not du else losses[-1]
    assert tail < losses[0] - drop, losses
