"""The port's DataParallelTrainer (per-layer Start/Wait over virtual ranks)
against the JAX package's, on the MLP of tests/test_train.py with 8 data
ranks.

Uncompressed: parameters at atol=2e-5, rtol=2e-4, the bound
tests/test_train.py holds the JAX trainer to against its single-device
oracle (float32 products and sums in another order).

Quantized: the int8 ring rounds every hop, so a last-bit difference in a
gradient can move a value by one quantization step. Over 3 steps at lr 0.1
the parameters stay within 1e-3 of JAX's and the losses within 1e-4 (a step
of the largest gradient block is about 1e-3 here); the loss must also fall as
tests/test_train.py requires of the JAX trainer.
"""

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.models.mlp import LAYERS, get_layer as jget_layer, init as mlp_init
from mlsl_tpu.models.mlp import loss_fn as jmlp_loss
from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.models import mlp as tmlp
from mlsl_tpu_torch.models.convert import params_from_jax, params_to_jax
from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer
from mlsl_tpu_torch.ops import quant_kernels as tqk
from mlsl_tpu_torch.types import CompressionType

torch.set_num_threads(2)


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _make_data(b=32):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(b,)).astype(np.int32)
    return x, y


def _pair(env, tenv, compression, key, data_parts=8, **kw):
    params = mlp_init(jax.random.PRNGKey(key))
    host = jax.tree.map(np.asarray, params)
    jd, td = env.create_distribution(data_parts, 1), tenv.create_distribution(data_parts, 1)
    js, ts = env.create_session(), tenv.create_session()
    js.set_global_minibatch_size(32)
    ts.set_global_minibatch_size(32)
    jt = JTrainer(env, jd, js, params, jmlp_loss, LAYERS, jget_layer,
                  compression=compression, lr=0.1)
    model = tmlp.MLP(device="cpu", params=params_from_jax(host, device="cpu"))
    tt = TTrainer(tenv, td, ts, model, tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer,
                  compression=compression, lr=0.1, **kw)
    return jt, tt


def _run(jt, tt, steps):
    x, y = _make_data()
    jl, tl = [], []
    for _ in range(steps):
        jl.append(np.asarray(jt.step(jt.shard_batch(x, y))).reshape(-1))
        tl.append(tt.step(tt.shard_batch(x, y)).reshape(-1).numpy())
    return np.array(jl), np.array(tl)


def _compare_params(jt, tt, atol, rtol):
    want = jax.device_get(jt.params)
    got = params_to_jax(tt.model)
    for name in LAYERS:
        for g, w in zip(jax.tree.leaves(got[name]), jax.tree.leaves(want[name])):
            np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=rtol)


def test_dp_training_matches_jax(env, tenv):
    jt, tt = _pair(env, tenv, CompressionType.NONE, key=0)
    assert not tt.fused
    jl, tl = _run(jt, tt, 3)
    np.testing.assert_allclose(tl, jl, atol=2e-5, rtol=2e-4)
    _compare_params(jt, tt, atol=2e-5, rtol=2e-4)


def test_quantized_dp_training_matches_jax(env, tenv):
    jt, tt = _pair(env, tenv, CompressionType.QUANTIZATION, key=1)
    assert all(tt.ops[n].get_parameter_set(0).grad_req.algo == "quant_ring" for n in LAYERS)
    jl, tl = _run(jt, tt, 3)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    _compare_params(jt, tt, atol=1e-3, rtol=0)


def test_quantized_dp_training_converges(tenv):
    """tests/test_train.py's convergence check, on the port alone."""
    params = params_from_jax(jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(1))),
                             device="cpu")
    dist = tenv.create_distribution(8, 1)
    sess = tenv.create_session()
    sess.set_global_minibatch_size(32)
    tt = TTrainer(tenv, dist, sess, tmlp.MLP(device="cpu", params=params), tmlp.loss_fn,
                  tmlp.LAYERS, tmlp.get_layer, compression=CompressionType.QUANTIZATION,
                  lr=0.1)
    x, y = _make_data()
    losses = [float(tt.step(tt.shard_batch(x, y))[0, 0, 0, 0, 0]) for _ in range(10)]
    assert losses[-1] < losses[0] - 0.03, losses
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_fused_path_without_communication(env):
    """One data rank: no parameter set communicates, so the step is fused
    (as at train.py:388-391) -- unless force_graph_path asks for the graph."""
    params = mlp_init(jax.random.PRNGKey(5))
    jd = env.create_distribution(1, 1, devices=env.devices[:1])
    js = env.create_session()
    js.set_global_minibatch_size(8)
    jt = JTrainer(env, jd, js, params, jmlp_loss, LAYERS, jget_layer, lr=0.1)
    tenv = Environment.get_env().init(device="cpu", world_size=1)
    try:
        td = tenv.create_distribution(1, 1)
        ts = tenv.create_session()
        ts.set_global_minibatch_size(8)
        model = tmlp.MLP(device="cpu",
                         params=params_from_jax(jax.tree.map(np.asarray, params), device="cpu"))
        tt = TTrainer(tenv, td, ts, model, tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1)
        assert tt.fused
        x, y = _make_data(8)
        for _ in range(3):
            jl = np.asarray(jt.step(jt.shard_batch(x, y))).reshape(-1)[0]
            tl = float(tt.step(tt.shard_batch(x, y)))
            np.testing.assert_allclose(tl, jl, atol=2e-5, rtol=2e-4)
        _compare_params(jt, tt, atol=2e-5, rtol=2e-4)
        ts2 = tenv.create_session()
        ts2.set_global_minibatch_size(8)
        graph = TTrainer(tenv, td, ts2, tmlp.MLP(device="cpu"), tmlp.loss_fn, tmlp.LAYERS,
                         tmlp.get_layer, force_graph_path=True)
        assert not graph.fused
        loss = graph.step(graph.shard_batch(x, y))
        assert loss.shape == (1, 1, 1, 1, 1) and torch.isfinite(loss).all()
    finally:
        tenv.finalize()


def test_graph_path_counts_one_entry_quantize_per_layer_and_hop(tenv):
    """On the CPU the codec's plain version runs and the kernel counts stay at
    0; the number of quantize calls per step is what chip_smoke.py expects of
    the kernel: (1 entry + G-1 hops + 1 all-gather) per layer."""
    calls = []
    orig = tqk.quantize_blocks

    def counting(x):
        calls.append(tuple(x.shape))
        return orig(x)

    from mlsl_tpu_torch.comm import quant_ring
    dist = tenv.create_distribution(8, 1)
    sess = tenv.create_session()
    sess.set_global_minibatch_size(32)
    tt = TTrainer(tenv, dist, sess, tmlp.MLP(device="cpu"), tmlp.loss_fn, tmlp.LAYERS,
                  tmlp.get_layer, compression=CompressionType.QUANTIZATION, lr=0.1)
    qk_before = dict(tqk.LAUNCHES)
    try:
        quant_ring.qk.quantize_blocks = counting
        # the ring looked its quantize up at setup; rebuild the requests
        for n in tmlp.LAYERS:
            tt.ops[n].get_parameter_set(0).grad_req.setup()
        x, y = _make_data()
        tt.step(tt.shard_batch(x, y))
    finally:
        quant_ring.qk.quantize_blocks = orig
    assert len(calls) == 9 * len(tmlp.LAYERS)
    assert tqk.LAUNCHES == qk_before


def test_stats_count_what_jax_counts(env, tenv):
    """Statistics, started by hand as the reference allows, count the same
    gradient bytes per operation as the JAX package's on the same graph, and
    one start and one wait per layer and step."""
    jt, tt = _pair(env, tenv, CompressionType.QUANTIZATION, key=2)
    for t in (jt, tt):
        t.session.get_stats().start()
    _run(jt, tt, 2)
    js, ts = jt.session.get_stats(), tt.session.get_stats()
    for i, name in enumerate(LAYERS):
        assert ts.get_comm_size(i) == js.get_comm_size(i) == 2 * 4 * tt.layer_counts[name]
        assert ts.get_start_count(i) == ts.get_wait_count(i) == 2
    assert ts.get_total_comm_size() == js.get_total_comm_size()
