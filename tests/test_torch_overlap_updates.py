"""The port's test-driven per-layer update loop (DataParallelTrainer
``overlap_updates=True``: each layer polled with TestGradientComm and updated
as its collective lands) against the JAX package's, on the MLP with 8 data
ranks and lr 0.1: losses within rtol 1e-6 and parameters within 1e-6 after 3
steps, uncompressed and int8; and against the port's own barrier path, which
must give the same bits.
"""

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.models.mlp import LAYERS, get_layer as jget_layer, init as mlp_init
from mlsl_tpu.models.mlp import loss_fn as jmlp_loss
from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
from mlsl_tpu.types import CompressionType as JComp
from mlsl_tpu_torch import optim
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import mlp as tmlp
from mlsl_tpu_torch.models.convert import params_from_jax, params_to_jax
from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer
from mlsl_tpu_torch.types import CompressionType as TComp

torch.set_num_threads(2)


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(32,)).astype(np.int32)
    return x, y


def _torch_trainer(tenv, host, **kw):
    dist = tenv.create_distribution(8, 1)
    s = tenv.create_session()
    s.set_global_minibatch_size(32)
    model = tmlp.MLP(device="cpu", params=params_from_jax(host, device="cpu"))
    return TTrainer(tenv, dist, s, model, tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1,
                    **kw)


def _params(tt):
    tree = params_to_jax(tt.model)
    return [np.asarray(l) for n in LAYERS for l in jax.tree.leaves(tree[n])]


@pytest.mark.parametrize("quantized", [False, True], ids=["plain", "int8"])
def test_overlap_updates_match_jax(env, tenv, quantized):
    params = mlp_init(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    dist = env.create_distribution(8, 1)
    s = env.create_session()
    s.set_global_minibatch_size(32)
    jt = JTrainer(env, dist, s, params, jmlp_loss, LAYERS, jget_layer, lr=0.1,
                  compression=JComp.QUANTIZATION if quantized else JComp.NONE,
                  overlap_updates=True, donate_params=False)
    comp = TComp.QUANTIZATION if quantized else TComp.NONE
    tt = _torch_trainer(tenv, host, compression=comp, overlap_updates=True)
    barrier = _torch_trainer(tenv, host, compression=comp)
    assert tt.overlap_updates and tt._overlap is None and not tt.fused
    x, y = _batch()
    for _ in range(3):
        lj = np.asarray(jt.step(jt.shard_batch(x, y))).reshape(-1)
        lt = tt.step(tt.shard_batch(x, y))
        lb = barrier.step(barrier.shard_batch(x, y))
    np.testing.assert_allclose(lt.reshape(-1).numpy(), lj, rtol=1e-6)
    want = jax.device_get(jt.params)
    for g, w in zip(_params(tt), [np.asarray(l) for n in LAYERS
                                  for l in jax.tree.leaves(want[n])]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert torch.equal(lt, lb)
    for g, b in zip(_params(tt), _params(barrier)):
        np.testing.assert_array_equal(g, b)


def test_overlap_updates_poll_every_layer(tenv):
    """Each step tests every layer's request at least once and waits none
    of them blocking on the CPU, where a request completes inside start."""
    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    tt = _torch_trainer(tenv, host, overlap_updates=True)
    calls = []
    for name in tt.layers:
        ps = tt._pset(name)
        for meth in ("test_gradient_comm", "wait_gradient_comm"):
            orig = getattr(ps, meth)

            def spy(*a, _orig=orig, _tag=(name, meth)):
                calls.append(_tag)
                return _orig(*a)
            setattr(ps, meth, spy)
    x, y = _batch()
    tt.step(tt.shard_batch(x, y))
    assert calls == [(n, "test_gradient_comm") for n in tt.layers]


@pytest.mark.parametrize("kw", [dict(optimizer=True), dict(distributed_update=True)],
                         ids=["optimizer", "distributed_update"])
def test_overlap_updates_asserts(tenv, kw):
    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    if kw.get("optimizer"):
        kw = dict(optimizer=optim.sgd(0.1))
    with pytest.raises(MLSLError):
        _torch_trainer(tenv, host, overlap_updates=True, **kw)
