"""The port's Adafactor (``mlsl_tpu_torch.optim``: ``adafactor``,
``ShardedAdafactor`` and its ZeRO-1 form) and the owned-state reshard
(``gather_owned_full``, ``place_owned_vector``) against the JAX package's.

- ``optim.adafactor`` against ``optax.adafactor`` on a tree of leaves with
  factored and unfactored shapes (2-D, conv-like 4-D, vectors), every knob,
  5 updates: updates and state within rtol 1e-5 / atol 1e-7 (float32, the
  same operations; the means reduce in another order).
- ``build_adafactor_layout`` equals the JAX package's arrays exactly.
- ``DataParallelTrainer`` with ``ShardedAdafactor`` on the MLP, 8 virtual
  ranks, 4 steps, against the JAX trainer with the same config (which runs
  ``optax.adafactor`` on the plain path and its cross-shard form under
  distributed update): the plain and ZeRO-1 paths, the six variants of
  ``tests/test_optimizers.py:428-446``, the composition with
  ``clip_global_norm``, a fully factored layer (its elementwise moment a (1,)
  dummy). Parameters within atol 2e-5 / rtol 2e-4, the reference tests'
  bound (``tests/test_optimizers.py:423``); the ZeRO-1 state against JAX's
  ``_du_opt_state`` at the same bound.
- The refusals: ``HybridTrainer`` and a grid with a model or seq axis.
- The reshard: a ZeRO-1 buffer gathered to the host and placed onto a
  4-rank world, bit for bit against JAX's functions, on the plain gather
  and on B3-AG's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlsl_tpu import optim as joptim
from mlsl_tpu.comm.mesh import Topology as JTopo
from mlsl_tpu.models.mlp import LAYERS, get_layer as jget_layer, init as mlp_init
from mlsl_tpu.models.mlp import loss_fn as jmlp_loss
from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
from mlsl_tpu_torch import optim
from mlsl_tpu_torch.comm.mesh import Topology as TTopo
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import mlp as tmlp
from mlsl_tpu_torch.models.convert import (
    adafactor_state_from_optax,
    adafactor_state_to_optax,
    params_from_jax,
    params_to_jax,
)
from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-4)
UTOL = dict(rtol=1e-5, atol=1e-7)
BATCH, STEPS = 16, 4


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _data():
    rng = np.random.default_rng(42)
    xs = [rng.normal(size=(BATCH, 8)).astype(np.float32) for _ in range(STEPS)]
    ys = [rng.integers(0, 4, size=(BATCH,)).astype(np.int32) for _ in range(STEPS)]
    return xs, ys


def _af(**kw):
    # min_dim_size_to_factor=4: the MLP's (8, 16) and (16, 4) weights factor,
    # the biases stay elementwise, and owned shards cross leaf boundaries
    return dict(learning_rate=0.01, **{"min_dim_size_to_factor": 4, **kw})


# -- the transform ---------------------------------------------------------------

KNOBS = [{}, {"momentum": 0.9}, {"weight_decay_rate": 1e-3}, {"clipping_threshold": None},
         {"multiply_by_parameter_scale": False}, {"decay_offset": 2, "decay_rate": 0.7},
         {"momentum": 0.9, "weight_decay_rate": 1e-3, "min_dim_size_to_factor": 1024}]
SHAPES = [(24, 40), (3, 3, 16, 32), (40,), (5, 24, 24), (7,), (1, 1, 48, 36)]


@pytest.mark.parametrize("kw", KNOBS, ids=lambda k: "-".join(k) or "defaults")
def test_adafactor_transform_matches_optax(kw):
    kw = {"learning_rate": 0.05, "min_dim_size_to_factor": 16, **kw}
    rng = np.random.default_rng(len(kw))
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
              for s in SHAPES] for _ in range(5)]
    jopt = optax.adafactor(**kw)
    topt = optim.adafactor(**kw)
    jstate = jopt.init(params)
    tparams = [torch.from_numpy(p) for p in params]
    tstate = topt.init(tparams)
    for g in grads:
        ju, jstate = jopt.update(g, jstate, params)
        tu, tstate = topt.update([torch.from_numpy(x) for x in g], tstate, tparams)
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **UTOL)
    got = adafactor_state_to_optax(tstate)
    fs = jstate[0]
    assert got["count"] == int(fs.count) == 5
    for key in ("v_row", "v_col", "v"):
        for a, b in zip(got[key], jax.tree.leaves(getattr(fs, key))):
            np.testing.assert_allclose(a, np.asarray(b), **UTOL, err_msg=key)


def test_layout_equals_jax():
    shapes = [(8, 16), (16,), (3, 3, 8, 24), (24, 4), (5,)]
    for min_dim in (4, 8, 128):
        want = joptim.build_adafactor_layout(shapes, 8 * 310, 8, min_dim)
        got = optim.build_adafactor_layout(shapes, 8 * 310, 8, min_dim)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(w), err_msg=key)


# -- the trainer -----------------------------------------------------------------


def _jax_train(env, cfg, du, clip=None, init=None, loss=jmlp_loss, layers=LAYERS,
               get_layer=jget_layer):
    dist = env.create_distribution(8, 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(BATCH)
    jt = JTrainer(env, dist, sess, init if init is not None else mlp_init(jax.random.PRNGKey(0)),
                  loss, layers, get_layer, distributed_update=du, optimizer=cfg,
                  clip_global_norm=clip, donate_params=False)
    for x, y in zip(*_data()):
        jt.step(jt.shard_batch(x, y))
    return jt


def _port_train(tenv, cfg, du, clip=None, model=None, layers=tmlp.LAYERS,
                get_layer=tmlp.get_layer, loss=tmlp.loss_fn):
    dist = tenv.create_distribution(8, 1)
    sess = tenv.create_session()
    sess.set_global_minibatch_size(BATCH)
    if model is None:
        host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
        model = tmlp.MLP(device="cpu", params=params_from_jax(host, "cpu"))
    tt = TTrainer(tenv, dist, sess, model, loss, layers, get_layer, distributed_update=du,
                  optimizer=cfg, clip_global_norm=clip)
    for x, y in zip(*_data()):
        tt.step(tt.shard_batch(x, y))
    return tt


def _assert_params(tt, jt, layers=LAYERS):
    got = params_to_jax(tt.model)
    for name in layers:
        for a, w in zip(jax.tree.leaves(got[name]), jax.tree.leaves(jt.params[name])):
            np.testing.assert_allclose(a, np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize("du", [False, True], ids=["plain", "zero1"])
def test_adafactor_matches_jax_trainer(env, tenv, du):
    """Both update paths: parameters, and the state (the plain path's per
    layer FactoredState against optax's tree, ZeRO-1's buffers against the
    JAX trainer's)."""
    jt = _jax_train(env, joptim.ShardedAdafactor(**_af()), du)
    tt = _port_train(tenv, optim.ShardedAdafactor(**_af()), du)
    _assert_params(tt, jt)
    if du:
        for name in LAYERS:
            want = adafactor_state_from_optax(jax.device_get(jt._du_opt_state[name]), "cpu")
            for key, w in want.items():
                np.testing.assert_allclose(tt.opt_state[name][key].numpy(), w.numpy(), **TOL,
                                           err_msg=f"{name}/{key}")
    else:
        want = adafactor_state_from_optax(jax.device_get(jt._opt_state), "cpu", layers=LAYERS,
                                          get_layer=jget_layer)
        for name in LAYERS:
            assert int(tt.opt_state[name].count) == int(want[name].count) == STEPS
            for key in ("v_row", "v_col", "v"):
                for a, w in zip(getattr(tt.opt_state[name], key), getattr(want[name], key)):
                    np.testing.assert_allclose(a.numpy(), w.numpy(), **TOL, err_msg=key)


@pytest.mark.parametrize(
    "kw",
    [{"momentum": 0.9}, {"weight_decay_rate": 1e-3}, {"clipping_threshold": None},
     {"multiply_by_parameter_scale": False}, {"min_dim_size_to_factor": 128},
     {"momentum": 0.9, "weight_decay_rate": 1e-3}],
    ids=["momentum", "weight_decay", "no_clip", "no_param_scale", "unfactored",
         "momentum_weight_decay"])
def test_adafactor_variants_match_jax_trainer(env, tenv, kw):
    """Every optional leg of the chain under distributed update
    (tests/test_optimizers.py:428-446)."""
    jt = _jax_train(env, joptim.ShardedAdafactor(**_af(**kw)), True)
    tt = _port_train(tenv, optim.ShardedAdafactor(**_af(**kw)), True)
    _assert_params(tt, jt)


def test_adafactor_with_global_norm_clip(env, tenv):
    """clip_global_norm composes with Adafactor as optax.chain(
    clip_by_global_norm, adafactor) does, on both paths."""
    cfg = _af()
    jt = _jax_train(env, joptim.ShardedAdafactor(**cfg), True, clip=0.05)
    for du in (False, True):
        _assert_params(_port_train(tenv, optim.ShardedAdafactor(**cfg), du, clip=0.05), jt)


class _BiasFree(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.from_numpy(np.array(init["w1"]["w"])))
        self.w2 = torch.nn.Parameter(torch.from_numpy(np.array(init["w2"]["w"])))

    def jax_tree(self):
        return {"w1": {"w": self.w1}, "w2": {"w": self.w2}}


def _bias_free_init(key):
    k1, k2 = jax.random.split(key)
    return {"w1": {"w": jax.random.normal(k1, (8, 16)) * 0.3},
            "w2": {"w": jax.random.normal(k2, (16, 4)) * 0.3}}


def _bias_free_jax_loss(params, batch):
    x, y = batch
    logits = jnp.tanh(x @ params["w1"]["w"]) @ params["w2"]["w"]
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], axis=1))


def _bias_free_port_loss(model, batch):
    x, y = batch
    logp = torch.log_softmax(torch.tanh(x @ model.w1) @ model.w2, dim=-1)
    return -torch.gather(logp, 1, y.long()[:, None]).mean()


def test_adafactor_fully_factored_layer_skips_elementwise_state(env, tenv):
    """A layer whose leaves all factor keeps v as a (1,) dummy, and still
    matches the JAX trainer."""
    init = _bias_free_init(jax.random.PRNGKey(3))
    cfg = _af()
    jt = _jax_train(env, joptim.ShardedAdafactor(**cfg), True, init=init,
                    loss=_bias_free_jax_loss, layers=["w1", "w2"],
                    get_layer=lambda p, n: p[n])
    tt = _port_train(tenv, optim.ShardedAdafactor(**cfg), True,
                     model=_BiasFree(jax.tree.map(np.asarray, init)), layers=["w1", "w2"],
                     get_layer=lambda m, n: m.jax_tree()[n], loss=_bias_free_port_loss)
    assert tt.opt_state["w1"]["v"].shape[-1] == 1
    assert tt.opt_state["w1"]["v"].shape == jt._du_opt_state["w1"]["v"].shape
    _assert_params(tt, jt, layers=["w1", "w2"])


def test_hybrid_rejects_sharded_adafactor(tenv):
    from mlsl_tpu_torch.models.transformer import HybridTrainer, TransformerConfig

    with pytest.raises(MLSLError, match="ShardedAdafactor"):
        HybridTrainer(tenv, TransformerConfig(vocab=32, d_model=16, n_heads=2, head_dim=8,
                                              n_blocks=1, seq_len=8),
                      dp=2, sp=1, tp=2, optimizer=optim.ShardedAdafactor(**_af()))


def test_sharded_adafactor_rejects_hybrid_grid(tenv):
    """The ownership layout follows the data axis only: the optimizer's guard
    and the trainer's both refuse a model axis; a tree transform refuses the
    flat owned shards of ZeRO-1."""
    dist = tenv.create_distribution(4, 2)
    with pytest.raises(MLSLError, match="pure data-parallel"):
        optim._shard_ids(dist.topology, {"row_ids": np.zeros(8, np.int32)}, data_size=4)
    sess = tenv.create_session()
    sess.set_global_minibatch_size(BATCH)
    with pytest.raises(MLSLError, match="model=seq=1"):
        TTrainer(tenv, dist, sess, tmlp.MLP(device="cpu"), tmlp.loss_fn, tmlp.LAYERS,
                 tmlp.get_layer, distributed_update=True,
                 optimizer=optim.ShardedAdafactor(**_af()))
    dist = tenv.create_distribution(8, 1)
    sess = tenv.create_session()
    sess.set_global_minibatch_size(BATCH)
    with pytest.raises(MLSLError, match="tree transform"):
        TTrainer(tenv, dist, sess, tmlp.MLP(device="cpu"), tmlp.loss_fn, tmlp.LAYERS,
                 tmlp.get_layer, distributed_update=True,
                 optimizer=optim.adafactor(0.01))


# -- the reshard -----------------------------------------------------------------


@pytest.mark.parametrize("algo", [None, "pallas_ring"], ids=["plain_gather", "b3_ag_plain"])
def test_reshard_round_trip_matches_jax(env, tenv, algo, monkeypatch):
    """An owned-shard buffer of 8 ranks (count 1,001, padded 1,008) drains to
    the host and lands on a 4-rank world (padded 1,004), bit for bit against
    JAX's ``gather_owned_full`` / ``place_owned_vector``; gathering the placed
    buffer gives back the truncated, re-padded vector."""
    count, k = 1001, 126
    rng = np.random.default_rng(9)
    flat = rng.normal(size=8 * k).astype(np.float32)
    flat[count:] = 0.0
    buf = flat.reshape(1, 8, 1, 1, k)
    jtopo = JTopo(8, 1, devices=env.devices)
    want = joptim.gather_owned_full(jtopo, jtopo.shard_buffer(buf))
    if algo is not None:
        monkeypatch.setattr(tenv.config, "_forced_algos", {"*": algo})
    ttopo = TTopo(8, 1, 8)
    got = optim.gather_owned_full(ttopo, torch.from_numpy(buf))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, flat)

    jnew = JTopo(4, 1, devices=env.devices[:4])
    jplaced = np.asarray(joptim.place_owned_vector(jnew, want, count, 1004, 4))
    tnew = TTopo(4, 1, 4)
    placed = optim.place_owned_vector(tnew, got, count, 1004, 4, device="cpu")
    assert tuple(placed.shape) == (1, 4, 1, 1, 251)
    np.testing.assert_array_equal(placed.numpy(), jplaced)
    back = optim.gather_owned_full(tnew, placed)
    np.testing.assert_array_equal(back, np.pad(flat[:count], (0, 1004 - count)))
    with pytest.raises(MLSLError, match="geometry"):
        optim.place_owned_vector(tnew, got, count, 1002, 4, device="cpu")
    with pytest.raises(MLSLError, match="pure data-parallel"):
        optim.place_owned_vector(TTopo(2, 2, 4), got, count, 1004, 2, device="cpu")
