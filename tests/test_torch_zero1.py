"""The port's ZeRO-1 distributed update against the JAX package's.

- ``comm.overlap.build_zero1_update`` against ``mlsl_tpu.comm.overlap``'s on
  tests/test_overlap_compiled.py's inputs (integer payloads, lr 0.5, denom 8,
  every group of the grids, stages 1 and 3): bit-exact. ``lax``, ``rhd`` and
  ``ring2d`` must also have JAX's phase counts. The kernel algorithms run
  their plain versions here; JAX runs them as ``lax`` off the TPU (a
  standing difference: its in-graph kernels need a chip), and the results
  agree bit for bit all the same.
- ``DataParallelTrainer`` on the MLP with 8 CPU virtual ranks against JAX's
  on the 8-device CPU mesh, 3 steps from the same weights: ZeRO-1 with Adam
  (``optim.adam`` / ``optax.adam``), with and without ``clip_global_norm``,
  with ``step_accum`` over 2 micro-batches, uncompressed and int8; ZeRO-1
  with SGD; and replicated Adam. Parameters and Adam moments within
  rtol 1e-6 / atol 1e-6: the two compute the same float32 operations, and
  only the order of the sums inside a matrix product or a reduction differs.
- The owned-shard geometry (``get_owned_kernel_count`` / ``_offset``) equals
  JAX's for ragged counts.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from mlsl_tpu.comm import overlap as joverlap
from mlsl_tpu.comm.mesh import ProcessGroup as JGroup, Topology as JTopo
from mlsl_tpu.models.mlp import LAYERS, get_layer as jget_layer, init as mlp_init
from mlsl_tpu.models.mlp import loss_fn as jmlp_loss
from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
from mlsl_tpu.types import CompressionType as JComp, DataType as JDT, OpType as JOp
from mlsl_tpu_torch import optim
from mlsl_tpu_torch.comm import overlap as toverlap
from mlsl_tpu_torch.comm.mesh import ProcessGroup as TGroup, Topology as TTopo
from mlsl_tpu_torch.config import Config as TConfig
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.models import mlp as tmlp
from mlsl_tpu_torch.models.convert import adam_state_from_optax, params_from_jax, params_to_jax
from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer
from mlsl_tpu_torch.types import CompressionType, DataType, OpType

torch.set_num_threads(2)

COUNTS = [8 * 96, 13, 8, 100]
LR, DENOM = 0.5, 8.0
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


# -- the staged update -----------------------------------------------------------


def _grids(env):
    return [(JTopo(8, 1, devices=env.devices), TTopo(8, 1, 8), ("data",)),
            (JTopo(4, 2, devices=env.devices), TTopo(4, 2, 8), ("data", "model")),
            (JTopo(6, 1, devices=env.devices[:6]), TTopo(6, 1, 6), ("data",))]


@pytest.mark.parametrize("algo", ["lax", "rhd", "ring2d", "pallas_ring", "pallas_ring2d",
                                  "pallas_rhd"])
def test_zero1_update_matches_jax(env, algo):
    for jtopo, ttopo, axes in _grids(env):
        jg, tg = JGroup(jtopo, axes), TGroup(ttopo, axes)
        w = ttopo.world_size
        rngs = [np.random.default_rng(i) for i, _ in enumerate(COUNTS)]
        params = [r.integers(-40, 40, size=c).astype(np.float32) for r, c in zip(rngs, COUNTS)]
        grads = [r.integers(-8, 8, size=(w, c)).astype(np.float32)
                 for r, c in zip(rngs, COUNTS)]
        pnp = [np.tile(p, (w, 1)).reshape(*ttopo.grid_shape, c) for p, c in zip(params, COUNTS)]
        gnp = [g.reshape(*ttopo.grid_shape, c) for g, c in zip(grads, COUNTS)]
        for stages in (1, 3):
            jfn, junits = joverlap.build_zero1_update(
                jg, COUNTS, lr=LR, denom=DENOM, algo=algo, config=env.config, stages=stages)
            tfn, tunits = toverlap.build_zero1_update(
                tg, COUNTS, lr=LR, denom=DENOM, algo=algo, config=TConfig(), stages=stages)
            want = [np.asarray(o) for o in jfn([jtopo.shard_buffer(p) for p in pnp],
                                               [jtopo.shard_buffer(g) for g in gnp])]
            got = tfn([torch.from_numpy(p) for p in pnp], [torch.from_numpy(g) for g in gnp])
            tag = f"{algo} on {axes} of {ttopo.grid_shape}, stages {stages}"
            for c, p, g, o, wo in zip(COUNTS, params, grads, got, want):
                np.testing.assert_array_equal(o.numpy(), wo, err_msg=tag)
                np.testing.assert_array_equal(o.numpy().reshape(w, c)[0],
                                              p - LR * (g.sum(axis=0) / DENOM), err_msg=tag)
            if algo.startswith("pallas"):
                # JAX off the TPU serves no kernel in stages; the port runs
                # the kernel's plain version wherever the group qualifies
                assert [u.algo for u in junits] == ["lax"] * len(COUNTS)
                assert {u.algo for u in tunits} <= {algo, "lax"}
            else:
                assert [u.algo for u in tunits] == [u.algo for u in junits], tag
                assert [u.nphases for u in tunits] == [u.nphases for u in junits], tag
            assert [u.per_tick for u in tunits] == [
                max(1, -(-u.nphases // stages)) for u in tunits]


def test_zero1_kernel_phases_select_the_ring():
    """With pallas_ring forced on the data group, every unit's two wire
    phases are one ring launch each: B3 reduce_scatter and B3-AG."""
    from mlsl_tpu_torch.ops import ring_kernels as trk

    tg = TGroup(TTopo(8, 1, 8), ("data",))
    calls = []
    real = trk.dense_ring_ref

    def counting(x, plan):
        calls.append(plan.kind)
        return real(x, plan)

    trk.dense_ring_ref = counting
    try:
        fn, units = toverlap.build_zero1_update(tg, COUNTS, lr=LR, denom=DENOM,
                                                algo="pallas_ring", stages=2)
        p = [torch.zeros((1, 8, 1, 1, c)) for c in COUNTS]
        fn(p, [torch.ones((1, 8, 1, 1, c)) for c in COUNTS])
    finally:
        trk.dense_ring_ref = real
    assert [u.algo for u in units] == ["pallas_ring"] * 4
    assert [u.nphases for u in units] == [3] * 4
    assert sorted(calls) == ["all_gather"] * 4 + ["reduce_scatter"] * 4


# -- the trainer -------------------------------------------------------------------


def _batches(k):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32 * k, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(32 * k,)).astype(np.int32)
    return [(x[32 * i:32 * (i + 1)], y[32 * i:32 * (i + 1)]) for i in range(k)]


def _pair(env, tenv, *, du, opt, clip, comp):
    params = mlp_init(jax.random.PRNGKey(3))
    host = jax.tree.map(np.asarray, params)
    jd, td = env.create_distribution(8, 1), tenv.create_distribution(8, 1)
    js, ts = env.create_session(), tenv.create_session()
    js.set_global_minibatch_size(32)
    ts.set_global_minibatch_size(32)
    jopt = optax.adam(5e-3) if opt == "adam" else None
    topt = optim.adam(5e-3) if opt == "adam" else None
    jt = JTrainer(env, jd, js, params, jmlp_loss, LAYERS, jget_layer, distributed_update=du,
                  compression=JComp(int(comp)), lr=0.1, optimizer=jopt,
                  clip_global_norm=clip, donate_params=False)
    tt = TTrainer(tenv, td, ts, tmlp.MLP(device="cpu", params=params_from_jax(host, "cpu")),
                  tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, distributed_update=du,
                  compression=comp, lr=0.1, optimizer=topt, clip_global_norm=clip)
    return jt, tt


def _moments(jt, tt, du):
    """-> [(port array, JAX array)] of every layer's Adam mu and nu."""
    out = []
    for name in LAYERS:
        ts = tt.opt_state[name]
        if du:
            js = jt._du_opt_state[name][0]
            out += [(ts.mu.numpy(), np.asarray(js.mu)), (ts.nu.numpy(), np.asarray(js.nu))]
            assert int(ts.count) == int(np.asarray(js.count).reshape(-1)[0])
        else:
            js = jt._opt_state[0]
            flat = lambda tree: np.concatenate(  # noqa: E731
                [np.asarray(a).reshape(-1) for a in jax.tree.leaves(jget_layer(tree, name))])
            out += [(ts.mu.numpy(), flat(js.mu)), (ts.nu.numpy(), flat(js.nu))]
            assert int(ts.count) == int(js.count)
    return out


CASES = [
    # name, distributed_update, optimizer, clip_global_norm, step_accum, compression
    ("zero1-adam", True, "adam", None, False, CompressionType.NONE),
    ("zero1-adam-clip", True, "adam", 0.05, False, CompressionType.NONE),
    ("zero1-adam-accum", True, "adam", None, True, CompressionType.NONE),
    ("zero1-adam-clip-accum-int8", True, "adam", 0.05, True, CompressionType.QUANTIZATION),
    ("zero1-adam-int8", True, "adam", None, False, CompressionType.QUANTIZATION),
    ("zero1-sgd", True, None, None, False, CompressionType.NONE),
    ("zero1-sgd-clip-accum", True, None, 0.05, True, CompressionType.NONE),
    ("replicated-adam", False, "adam", None, False, CompressionType.NONE),
    ("replicated-adam-clip-accum", False, "adam", 0.05, True, CompressionType.NONE),
]


@pytest.mark.parametrize("name,du,opt,clip,accum,comp", CASES, ids=[c[0] for c in CASES])
def test_trainer_matches_jax(env, tenv, name, du, opt, clip, accum, comp):
    jt, tt = _pair(env, tenv, du=du, opt=opt, clip=clip, comp=comp)
    assert not tt.fused
    k = 2 if accum else 1
    data = _batches(k)
    for _ in range(3):
        jb = [jt.shard_batch(x, y) for x, y in data]
        tb = [tt.shard_batch(x, y) for x, y in data]
        if accum:
            jl, tl = jt.step_accum(jb), tt.step_accum(tb)
        else:
            jl, tl = jt.step(jb[0]), tt.step(tb[0])
        np.testing.assert_allclose(tl.reshape(-1).numpy(), np.asarray(jl).reshape(-1), **TOL)
    want = jax.device_get(jt.params)
    got = params_to_jax(tt.model)
    for layer in LAYERS:
        for g, w in zip(jax.tree.leaves(got[layer]), jax.tree.leaves(want[layer])):
            np.testing.assert_allclose(g, np.asarray(w), err_msg=layer, **TOL)
    if opt == "adam":
        for g, w in _moments(jt, tt, du):
            np.testing.assert_allclose(g, w, **TOL)


def test_zero1_adam_state_is_owned_only(tenv):
    """Under ZeRO-1 each rank's Adam moments cover its owned shard only."""
    td = tenv.create_distribution(8, 1)
    ts = tenv.create_session()
    ts.set_global_minibatch_size(32)
    tt = TTrainer(tenv, td, ts, tmlp.MLP(device="cpu"), tmlp.loss_fn, tmlp.LAYERS,
                  tmlp.get_layer, distributed_update=True, optimizer=optim.adam(1e-3))
    for name in LAYERS:
        ps = tt.ops[name].get_parameter_set(0)
        owned = ps.get_owned_kernel_count()
        assert owned == -(-tt.layer_counts[name] // 8)
        assert tt.opt_state[name].mu.shape == (1, 8, 1, 1, owned)
        assert ps.get_local_kernel_count() == 8 * owned
        assert ps.grad_req.desc.kind == "reduce_scatter" and ps.inc_req.desc.kind == "allgather"


def test_state_conversion_starts_both_from_the_same_state(env, tenv):
    """A JAX ZeRO-1 Adam state after 2 steps, carried into the port, then
    one more step on each: parameters and moments agree."""
    jt, tt = _pair(env, tenv, du=True, opt="adam", clip=None, comp=CompressionType.NONE)
    (x, y), = _batches(1)
    for _ in range(2):
        jt.step(jt.shard_batch(x, y))
    from mlsl_tpu_torch.models.convert import load_params

    load_params(tt.model, jax.tree.map(np.array, jax.device_get(jt.params)))
    for name in LAYERS:
        s = jt._du_opt_state[name][0]
        tt.opt_state[name] = adam_state_from_optax(np.asarray(s.mu), np.asarray(s.nu),
                                                   np.asarray(s.count), "cpu")
    jt.step(jt.shard_batch(x, y))
    tt.step(tt.shard_batch(x, y))
    for g, w in _moments(jt, tt, True):
        np.testing.assert_allclose(g, w, **TOL)
    got, want = params_to_jax(tt.model), jax.device_get(jt.params)
    for layer in LAYERS:
        for g, w in zip(jax.tree.leaves(got[layer]), jax.tree.leaves(want[layer])):
            np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("data_parts,model_parts", [(8, 1), (4, 2)])
def test_owned_geometry_matches_jax(env, tenv, data_parts, model_parts):
    counts = [c * model_parts for c in (13, 100, 1000, 2049, 8 * 96)]
    jd = env.create_distribution(data_parts, model_parts)
    td = tenv.create_distribution(data_parts, model_parts)
    js, ts = env.create_session(), tenv.create_session()
    js.set_global_minibatch_size(32)
    ts.set_global_minibatch_size(32)
    for du in (True, False):
        jops, tops = [], []
        for c in counts:
            for sess, ops, dist, dt, optype in ((js, jops, jd, JDT.FLOAT, JOp.CC),
                                                (ts, tops, td, DataType.FLOAT, OpType.CC)):
                reg = sess.create_operation_reg_info(optype)
                reg.add_parameter_set(c, 1, dt, distributed_update=du)
                ops.append(sess.get_operation(sess.add_operation(reg, dist)))
        js.commit()
        ts.commit()
        for jo, to in zip(jops, tops):
            jp, tp = jo.get_parameter_set(0), to.get_parameter_set(0)
            assert tp.get_owned_kernel_count() == jp.get_owned_kernel_count()
            assert tp.get_local_kernel_count() == jp.get_local_kernel_count()
            assert tp.is_distributed_update() == jp.is_distributed_update() == du
            for i in range(data_parts):
                assert tp.get_owned_kernel_offset(i) == jp.get_owned_kernel_offset(i)
            for m in range(model_parts):
                assert tp.get_global_kernel_offset(m) == jp.get_global_kernel_offset(m)
        js.remove_operations()
        ts.remove_operations()


@pytest.mark.parametrize("accum", [False, True], ids=["step", "step_accum"])
def test_zero1_and_replicated_clip_by_the_same_bits(tenv, accum):
    """With global-norm clipping, ZeRO-1 Adam and replicated Adam give the
    same parameters bit for bit: both sum the norm in sharded_sq_norm's
    order, lax reduces each element in member order on both, and the
    division by 8 ranks is exact."""
    from mlsl_tpu_torch.models.train import sharded_sq_norm

    params = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(3)))
    out = []
    for du in (True, False):
        td = tenv.create_distribution(8, 1)
        ts = tenv.create_session()
        ts.set_global_minibatch_size(32)
        tt = TTrainer(tenv, td, ts, tmlp.MLP(device="cpu", params=params_from_jax(params, "cpu")),
                      tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, distributed_update=du,
                      lr=0.1, optimizer=optim.adam(5e-3), clip_global_norm=0.05)
        data = _batches(2 if accum else 1)
        for _ in range(3):
            tb = [tt.shard_batch(x, y) for x, y in data]
            tt.step_accum(tb) if accum else tt.step(tb[0])
        out.append(params_to_jax(tt.model))
    for layer in LAYERS:
        for a, b in zip(jax.tree.leaves(out[0][layer]), jax.tree.leaves(out[1][layer])):
            np.testing.assert_array_equal(a, b, err_msg=layer)
    g = {"a": torch.arange(13.0), "b": torch.ones(100)}
    want = sum(float((v.double() ** 2).sum()) for v in g.values())
    assert abs(float(sharded_sq_norm(g, 8)) - want) <= 1e-6 * want
