"""The port's pipeline schedules (mlsl_tpu_torch.parallel.pipeline) and
``algos.inline_allreduce`` against the JAX package's, after
tests/test_pipeline.py.

The same seeded numpy stage weights and microbatches go through both: the
JAX bodies inside ``shard_map`` over a 4-device model axis of the CPU mesh,
the port over virtual ranks whose stage dim is a rank dim (the stage-only
layout (S, ...) and the whole (R, D, S, M) grid).

Tolerances: the forward and the losses within 1e-5 (rtol) of JAX and of the
dense oracle, as the JAX tests hold their schedules to the oracle; gradients
within 3e-4 (atol and rtol), the JAX tests' bound, which covers float32 sums
over the microbatches and stages taken in another order. The schedule tables
equal JAX's array for array, and the data-parallel reduction of the dense
kernels' plain versions equals the baseline collective within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mlsl_tpu.models.train import smap
from mlsl_tpu.parallel import pipeline as jpp
from mlsl_tpu_torch.comm import algos as talgos
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.parallel import pipeline as tpp
from mlsl_tpu_torch.types import CompressionType, ReductionType

torch.set_num_threads(2)

N_STAGES = 4
MB, D = 2, 8
M_COUNT = 6
V_CHUNKS = 2
RTOL_LOSS = 1e-5
TOL_GRAD = 3e-4


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


@pytest.fixture()
def pipe_mesh(env):
    dist = env.create_distribution(1, N_STAGES, devices=env.devices[:N_STAGES])
    return dist.topology.mesh


def _stage_params(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(N_STAGES, D, D)).astype(np.float32) * 0.5,
        "b": rng.normal(size=(N_STAGES, D)).astype(np.float32) * 0.1,
    }


def _jstage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _tstage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _jloss(out, target):
    return jnp.sum((out - target) ** 2)


def _tloss(out, target):
    return ((out - target) ** 2).sum()


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


def _layouts(a, lead=()):
    """A (*lead, S, ...) array in both port layouts: (stage-only, axis 0) and
    the (R, D, S, M) grid (axis 3, the model dim)."""
    nl = len(lead)
    grid = a.reshape(*a.shape[:nl], 1, 1, 1, N_STAGES, *a.shape[nl + 1:])
    return [(a, 0), (grid, 3)]


def _rep(x, nr_shape):
    """Microbatches (M, mb, d) replicated over the rank dims."""
    return torch.from_numpy(x).expand(*nr_shape, *x.shape)


def _dense_loss(params, x, y):
    h = x.reshape(-1, D)
    for s in range(N_STAGES):
        h = _tstage({"w": params["w"][s], "b": params["b"][s]}, h)
    return ((h.reshape(y.shape) - y) ** 2).sum()


def _dense_grads(params, x, y):
    p = {k: _t(v, grad=True) for k, v in params.items()}
    loss = _dense_loss(p, _t(x), _t(y))
    g = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), {k: gk.numpy() for k, gk in zip(p, g)}


# -- GPipe ---------------------------------------------------------------------


@pytest.mark.parametrize("layout", [0, 1], ids=["stages", "grid"])
def test_gpipe_forward_matches_jax_and_oracle(pipe_mesh, layout):
    all_params = _stage_params(0)
    x = np.random.default_rng(1).normal(size=(M_COUNT, MB, D)).astype(np.float32)

    def body(params, x_micro):
        my = {"w": params["w"].reshape(D, D), "b": params["b"].reshape(D)}
        return jpp.gpipe_forward(_jstage, my, x_micro, "model", N_STAGES)

    spec_p = {"w": P("model", None, None), "b": P("model", None)}
    fn = jax.jit(smap(body, pipe_mesh, in_specs=(spec_p, P()), out_specs=P("model"),
                      check=False))
    jout = np.asarray(fn(all_params, jnp.asarray(x))).reshape(N_STAGES, M_COUNT, MB, D)
    (w, axis), = [_layouts(all_params["w"])[layout]]
    (b, _), = [_layouts(all_params["b"])[layout]]
    ranks = w.shape[:axis + 1]
    out = tpp.gpipe_forward(_tstage, {"w": _t(w), "b": _t(b)}, _rep(x, ranks), axis,
                            N_STAGES).reshape(N_STAGES, M_COUNT, MB, D).numpy()
    np.testing.assert_allclose(out, jout, rtol=RTOL_LOSS, atol=1e-6)
    oracle = x.reshape(-1, D)
    for s in range(N_STAGES):
        oracle = np.tanh(oracle @ all_params["w"][s] + all_params["b"][s])
    np.testing.assert_allclose(out[-1], oracle.reshape(M_COUNT, MB, D), rtol=1e-5, atol=1e-5)
    # stages other than the last bank nothing
    np.testing.assert_array_equal(out[:-1], 0.0)


def test_gpipe_heterogeneous_widths():
    """Stages of different widths through pad_stage_weights (equal to JAX's
    padding); the padded lanes stay exactly zero."""
    dims = [8, 16, 4, 12, 8]
    rng = np.random.default_rng(5)
    weights = [rng.normal(size=(dims[s], dims[s + 1])).astype(np.float32) * 0.4
               for s in range(N_STAGES)]
    biases = [rng.normal(size=(dims[s + 1],)).astype(np.float32) * 0.1
              for s in range(N_STAGES)]
    w_pad, b_pad, d_wire = tpp.pad_stage_weights(weights, biases, dims)
    jw, jb, jd = jpp.pad_stage_weights(weights, biases, dims)
    assert d_wire == jd
    np.testing.assert_array_equal(w_pad, jw)
    np.testing.assert_array_equal(b_pad, jb)
    x = rng.normal(size=(M_COUNT, MB, dims[0])).astype(np.float32)
    x_pad = np.zeros((M_COUNT, MB, d_wire), np.float32)
    x_pad[..., :dims[0]] = x
    out = tpp.gpipe_forward(_tstage, {"w": _t(w_pad), "b": _t(b_pad)},
                            _rep(x_pad, (N_STAGES,)), 0, N_STAGES).numpy()[-1]
    ref = x.reshape(-1, dims[0])
    for s in range(N_STAGES):
        ref = np.tanh(ref @ weights[s] + biases[s])
    np.testing.assert_allclose(out[..., :dims[-1]], ref.reshape(M_COUNT, MB, dims[-1]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(out[..., dims[-1]:], 0.0)


def test_gpipe_width_mismatch_raises():
    from mlsl_tpu_torch.log import MLSLError

    w = torch.zeros(N_STAGES, D, D + 1)
    with pytest.raises(MLSLError, match="boundary width mismatch"):
        tpp.gpipe_forward(lambda p, x: x @ p["w"], {"w": w}, torch.zeros(N_STAGES, 2, MB, D),
                          0, N_STAGES)


@pytest.mark.parametrize("remat", [False, True])
def test_gpipe_gradients_match_jax_and_oracle(pipe_mesh, remat):
    """autograd through the schedule is the pipelined backward: equal to
    JAX's jax.grad of the same loss and to the dense oracle, remat or not."""
    all_params = _stage_params(2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(M_COUNT, MB, D)).astype(np.float32)
    y = rng.normal(size=(M_COUNT, MB, D)).astype(np.float32)
    spec_p = {"w": P("model", None, None), "b": P("model", None)}

    def sharded_loss(params):
        def body(params, xm, ym):
            my = {"w": params["w"].reshape(D, D), "b": params["b"].reshape(D)}
            return jpp.pipeline_loss(_jstage, _jloss, my, xm, ym, "model", N_STAGES,
                                     remat=remat)[None]

        fn = smap(body, pipe_mesh, in_specs=(spec_p, P(), P()), out_specs=P("model"),
                  check=False)
        return jnp.sum(fn(params, jnp.asarray(x), jnp.asarray(y))) / N_STAGES

    jl, jg = jax.value_and_grad(sharded_loss)(all_params)
    p = {k: _t(v, grad=True) for k, v in all_params.items()}
    loss = tpp.pipeline_loss(_tstage, _tloss, p, _rep(x, (N_STAGES,)), _rep(y, (N_STAGES,)),
                             0, N_STAGES, remat=remat)
    assert loss.shape == (N_STAGES,)
    assert len(set(loss.tolist())) == 1  # every stage holds the sum
    g = torch.autograd.grad(loss.sum() / N_STAGES, list(p.values()))
    dl, dg = _dense_grads(all_params, x, y)
    np.testing.assert_allclose(float(loss[0]), float(jl), rtol=RTOL_LOSS)
    np.testing.assert_allclose(float(loss[0]), dl, rtol=RTOL_LOSS)
    for k, gk in zip(p, g):
        np.testing.assert_allclose(gk.numpy(), np.asarray(jg[k]), atol=TOL_GRAD, rtol=TOL_GRAD)
        np.testing.assert_allclose(gk.numpy(), dg[k], atol=TOL_GRAD, rtol=TOL_GRAD)


# -- 1F1B ----------------------------------------------------------------------


def _jax_f1b(pipe_mesh):
    spec_p = {"w": P("model", None, None), "b": P("model", None)}

    def body(params, xm, ym):
        my = {"w": params["w"].reshape(D, D), "b": params["b"].reshape(D)}
        loss, grads = jpp.one_f1b_step(_jstage, _jloss, my, xm, ym, "model", N_STAGES)
        return loss[None], jax.tree.map(lambda g: g[None], grads)

    return jax.jit(smap(body, pipe_mesh, in_specs=(spec_p, P(), P()),
                        out_specs=(P("model"), spec_p), check=False))


@pytest.mark.parametrize("layout", [0, 1], ids=["stages", "grid"])
def test_one_f1b_matches_jax_gpipe_and_oracle(pipe_mesh, layout):
    """1F1B at M = 2 x stages: the loss and per-stage gradients equal JAX's
    1F1B, the port's GPipe and the dense oracle."""
    m_count = 2 * N_STAGES
    all_params = _stage_params(7)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(m_count, MB, D)).astype(np.float32)
    y = rng.normal(size=(m_count, MB, D)).astype(np.float32)
    jl, jg = _jax_f1b(pipe_mesh)(all_params, jnp.asarray(x), jnp.asarray(y))
    (w, axis), = [_layouts(all_params["w"])[layout]]
    (b, _), = [_layouts(all_params["b"])[layout]]
    ranks = w.shape[:axis + 1]
    loss, grads = tpp.one_f1b_step(_tstage, _tloss, {"w": _t(w), "b": _t(b)},
                                   _rep(x, ranks), _rep(y, ranks), axis, N_STAGES)
    assert loss.shape == ranks and grads["w"].shape == w.shape
    np.testing.assert_allclose(loss.reshape(-1).numpy(), np.asarray(jl), rtol=RTOL_LOSS)
    p = {k: _t(v, grad=True) for k, v in all_params.items()}
    gl = tpp.pipeline_loss(_tstage, _tloss, p, _rep(x, (N_STAGES,)), _rep(y, (N_STAGES,)),
                           0, N_STAGES, remat=True)
    gg = torch.autograd.grad(gl.sum() / N_STAGES, list(p.values()))
    np.testing.assert_allclose(float(loss.reshape(-1)[0]), float(gl[0]), rtol=RTOL_LOSS)
    dl, dg = _dense_grads(all_params, x, y)
    np.testing.assert_allclose(float(loss.reshape(-1)[0]), dl, rtol=RTOL_LOSS)
    for k, gk in zip(("w", "b"), gg):
        got = grads[k].reshape(N_STAGES, *grads[k].shape[axis + 1:]).numpy()
        np.testing.assert_allclose(got, np.asarray(jg[k]), atol=TOL_GRAD, rtol=TOL_GRAD)
        np.testing.assert_allclose(got, gk.numpy(), atol=TOL_GRAD, rtol=TOL_GRAD)
        np.testing.assert_allclose(got, dg[k], atol=TOL_GRAD, rtol=TOL_GRAD)


@pytest.mark.parametrize("s, m", [(4, 8), (4, 32), (2, 5), (8, 8)])
def test_f1b_schedule_facts_match_jax(s, m):
    assert tpp.f1b_schedule(s, m) == jpp.f1b_schedule(s, m)
    sched = tpp.f1b_schedule(4, 8)
    assert sched["ticks"] == 2 * 8 + 2 * 4 - 2
    assert sched["peak_in_flight"] == [4, 3, 2, 1]
    assert tpp.f1b_schedule(4, 32)["bubble_fraction"] < sched["bubble_fraction"]


# -- interleaved 1F1B ----------------------------------------------------------


@pytest.mark.parametrize("s, v, m", [(4, 1, 8), (4, 2, 8), (4, 2, 16), (4, 4, 8), (2, 3, 5),
                                     (4, 2, 7), (4, 3, 8)])
def test_interleaved_schedule_tables_match_jax(s, v, m):
    got, want = tpp.interleaved_schedule(s, v, m), jpp.interleaved_schedule(s, v, m)
    assert set(got) == set(want)
    for k in ("k_f", "k_b", "k_s", "ticks", "utilization", "bubble_fraction"):
        assert got[k] == want[k], k
    for k in ("t_f", "t_b"):
        np.testing.assert_array_equal(got[k], want[k])
    assert set(got["tables"]) == set(want["tables"])
    for k, a in got["tables"].items():
        assert a.dtype == want["tables"][k].dtype
        np.testing.assert_array_equal(a, want["tables"][k])


def _dense_chunk(params, x, y, v, s_count):
    p = {k: _t(a, grad=True) for k, a in params.items()}
    total = 0.0
    for m in range(x.shape[0]):
        h = _t(x[m])
        for k in range(v * s_count):
            c, d = k // s_count, k % s_count
            h = _tstage({"w": p["w"][c, d], "b": p["b"][c, d]}, h)
        total = total + _tloss(h, _t(y[m]))
    g = torch.autograd.grad(total, list(p.values()))
    return float(total), {k: gk.numpy() for k, gk in zip(p, g)}


@pytest.mark.parametrize("m_count", [8, 7])
@pytest.mark.parametrize("layout", [0, 1], ids=["stages", "grid"])
def test_interleaved_1f1b_matches_jax_and_dense_oracle(pipe_mesh, m_count, layout):
    """Interleaved 1F1B at M = 8 and at the S-indivisible M = 7: the loss and
    per-chunk gradients equal JAX's and the dense oracle's."""
    rng = np.random.default_rng(11)
    w = (rng.normal(size=(V_CHUNKS, N_STAGES, D, D)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(V_CHUNKS, N_STAGES, D)) * 0.1).astype(np.float32)
    x = rng.normal(size=(m_count, MB, D)).astype(np.float32)
    y = rng.normal(size=(m_count, MB, D)).astype(np.float32)

    def body(p, xm, ym):
        my = {"w": p["w"].reshape(V_CHUNKS, D, D), "b": p["b"].reshape(V_CHUNKS, D)}
        loss, grads = jpp.interleaved_1f1b_step(_jstage, _jloss, my, xm, ym, "model",
                                                N_STAGES, V_CHUNKS)
        return loss[None], jax.tree.map(lambda g: g[:, None], grads)

    spec_p = {"w": P(None, "model", None, None), "b": P(None, "model", None)}
    fn = jax.jit(smap(body, pipe_mesh, in_specs=(spec_p, P(), P()),
                      out_specs=(P("model"), spec_p), check=False))
    jl, jg = fn({"w": w, "b": b}, jnp.asarray(x), jnp.asarray(y))
    (tw, axis), = [_layouts(w, lead=(V_CHUNKS,))[layout]]
    (tb, _), = [_layouts(b, lead=(V_CHUNKS,))[layout]]
    ranks = tw.shape[1:axis + 2]
    loss, grads = tpp.interleaved_1f1b_step(_tstage, _tloss, {"w": _t(tw), "b": _t(tb)},
                                            _rep(x, ranks), _rep(y, ranks), axis, N_STAGES,
                                            V_CHUNKS)
    assert grads["w"].shape == tw.shape
    dl, dg = _dense_chunk({"w": w, "b": b}, x, y, V_CHUNKS, N_STAGES)
    np.testing.assert_allclose(loss.reshape(-1).numpy(), np.asarray(jl), rtol=RTOL_LOSS)
    np.testing.assert_allclose(float(loss.reshape(-1)[0]), dl, rtol=RTOL_LOSS)
    for k in ("w", "b"):
        got = grads[k].reshape(V_CHUNKS, N_STAGES, *grads[k].shape[axis + 2:]).numpy()
        np.testing.assert_allclose(got, np.asarray(jg[k]), atol=TOL_GRAD, rtol=TOL_GRAD)
        np.testing.assert_allclose(got, dg[k], atol=TOL_GRAD, rtol=TOL_GRAD)


def test_interleaved_one_chunk_is_one_f1b():
    """V = 1 runs the classic schedule: the same loss and gradients as
    one_f1b_step."""
    all_params = _stage_params(12)
    rng = np.random.default_rng(13)
    x = rng.normal(size=(8, MB, D)).astype(np.float32)
    y = rng.normal(size=(8, MB, D)).astype(np.float32)
    xs, ys = _rep(x, (N_STAGES,)), _rep(y, (N_STAGES,))
    l1, g1 = tpp.one_f1b_step(_tstage, _tloss, {k: _t(v) for k, v in all_params.items()},
                              xs, ys, 0, N_STAGES)
    l2, g2 = tpp.interleaved_1f1b_step(
        _tstage, _tloss, {k: _t(v[None]) for k, v in all_params.items()}, xs, ys, 0,
        N_STAGES, 1)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(g1[k].numpy(), g2[k][0].numpy(), atol=1e-6, rtol=1e-6)


# -- data parallel x pipeline ----------------------------------------------------


@pytest.mark.parametrize("route", ["lax", "pallas_ring", "pallas_rhd", "int8"])
def test_pipeline_composes_with_data_parallel(env, tenv, route):
    """dp 2 x pp 4: each data shard runs 1F1B on its own microbatches over the
    model dim, then reduce_microbatch_grads sums the stage gradients over the
    data group on the compiled overlap engine. Dense routes: within 3e-4 of
    the dense full-batch oracle and of JAX's composition (its request layer's
    allreduce), every data rank the same bits; int8: within the codec's step
    of the dense result."""
    from mlsl_tpu.parallel.pipeline import one_f1b_step as jf1b
    from mlsl_tpu.types import DataType, GroupType, ReductionType as JRed

    DPAR, M_LOCAL = 2, 4
    all_params = _stage_params(11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(DPAR, M_LOCAL, MB, D)).astype(np.float32)
    y = rng.normal(size=(DPAR, M_LOCAL, MB, D)).astype(np.float32)
    count = D * D + D

    # the JAX composition (tests/test_pipeline.py)
    jdist = env.create_distribution(DPAR, N_STAGES)
    spec_p = {"w": P("model", None, None), "b": P("model", None)}

    def body(params, xm, ym):
        my = {"w": params["w"].reshape(D, D), "b": params["b"].reshape(D)}
        loss, grads = jf1b(_jstage, _jloss, my, xm.reshape(M_LOCAL, MB, D),
                           ym.reshape(M_LOCAL, MB, D), "model", N_STAGES)
        flat = jnp.concatenate([grads["w"].reshape(-1), grads["b"].reshape(-1)])
        return loss[None], flat[None]

    fn = jax.jit(smap(body, jdist.topology.mesh, in_specs=(spec_p, P("data"), P("data")),
                      out_specs=(P(("data", "model")), P(("data", "model"))), check=False))
    _, jflat = fn(all_params, jnp.asarray(x), jnp.asarray(y))
    jsynced = np.asarray(env.wait(jdist.all_reduce(
        jdist.shard_buffer(np.asarray(jflat).reshape(1, DPAR, 1, N_STAGES, count)), count,
        DataType.FLOAT, JRed.SUM, GroupType.DATA)))

    # the port: (R, D, S, M) = (1, 2, 1, 4); stage weights broadcast over data
    if route in ("pallas_ring", "pallas_rhd"):
        tenv.config.collective_algo = route
        tenv.config.validate()
    tdist = tenv.create_distribution(DPAR, N_STAGES)
    w = _t(all_params["w"].reshape(1, 1, 1, N_STAGES, D, D))
    b = _t(all_params["b"].reshape(1, 1, 1, N_STAGES, D))
    xt = _t(x.reshape(1, DPAR, 1, 1, M_LOCAL, MB, D)).expand(1, DPAR, 1, N_STAGES, M_LOCAL,
                                                             MB, D)
    yt = _t(y.reshape(1, DPAR, 1, 1, M_LOCAL, MB, D)).expand(1, DPAR, 1, N_STAGES, M_LOCAL,
                                                             MB, D)
    loss, grads = tpp.one_f1b_step(_tstage, _tloss, {"w": w, "b": b}, xt, yt, 3, N_STAGES)
    flat = torch.cat([grads["w"].reshape(1, DPAR, 1, N_STAGES, -1),
                      grads["b"].reshape(1, DPAR, 1, N_STAGES, -1)], dim=-1)
    comp = CompressionType.QUANTIZATION if route == "int8" else None
    red, plan = tpp.reduce_microbatch_grads(tdist.data_group, [count],
                                            config=tenv.config, compression=comp)
    out = red([flat])
    synced = (out[0][0] if route == "int8" else out[0]).numpy()
    want_algo = {"lax": "lax", "pallas_ring": "pallas_ring", "pallas_rhd": "pallas_rhd",
                 "int8": None}[route]
    if want_algo:
        assert plan.units[0].algo == want_algo

    x_all = x.reshape(-1, MB, D)
    dl, dg = _dense_grads(all_params, x_all, y.reshape(-1, MB, D))
    np.testing.assert_allclose(float(loss[0, 0, 0, 0] + loss[0, 1, 0, 0]), dl, rtol=RTOL_LOSS)
    for s in range(N_STAGES):
        want = np.concatenate([dg["w"][s].reshape(-1), dg["b"][s].reshape(-1)])
        got = synced[0, 0, 0, s]
        np.testing.assert_array_equal(got.view(np.uint32), synced[0, 1, 0, s].view(np.uint32))
        if route == "int8":
            step = np.abs(flat.numpy()[0, :, 0, s]).max() / 127.0
            np.testing.assert_allclose(got, want, atol=2 * step + TOL_GRAD)
        else:
            np.testing.assert_allclose(got, want, atol=TOL_GRAD, rtol=TOL_GRAD)
            np.testing.assert_allclose(got, jsynced[0, 0, 0, s], atol=TOL_GRAD, rtol=TOL_GRAD)


def test_reduce_microbatch_grads_kernels_match_baseline(tenv):
    """The dense kernel routes' plain versions reduce the stage gradients to
    the baseline's result within 1e-6, newest-first over several tensors."""
    dist = tenv.create_distribution(2, 4)
    rng = np.random.default_rng(30)
    counts = [72, 1000, 5]
    bufs = [torch.from_numpy(rng.normal(size=(1, 2, 1, 4, c)).astype(np.float32))
            for c in counts]
    base, _ = tpp.reduce_microbatch_grads(dist.data_group, counts, config=tenv.config)
    want = base(bufs)
    for algo in ("pallas_ring", "pallas_rhd", "rhd"):
        fn, plan = tpp.reduce_microbatch_grads(dist.data_group, counts, config=tenv.config,
                                               algo=algo, stages=1)
        assert {u.algo for u in plan.units} == {algo}
        for a, b in zip(fn(bufs), want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


# -- inline_allreduce ----------------------------------------------------------------


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_inline_allreduce_along_a_dim_matches_jax(pipe_mesh, op):
    """Without a group: along the rank dim, every rank receiving the result,
    equal to JAX's psum / pmin / pmax over the model axis (SUM member by
    member on the CPU)."""
    from mlsl_tpu.comm import algos as jalgos
    from mlsl_tpu.types import ReductionType as JRed

    rng = np.random.default_rng(31)
    v = rng.normal(size=(N_STAGES, 3, 5)).astype(np.float32)
    rop = {"sum": ReductionType.SUM, "min": ReductionType.MIN, "max": ReductionType.MAX}[op]
    jop = {"sum": JRed.SUM, "min": JRed.MIN, "max": JRed.MAX}[op]
    fn = jax.jit(smap(lambda a: jalgos.inline_allreduce(a, "model", op=jop), pipe_mesh,
                      in_specs=(P("model"),), out_specs=P("model"), check=False))
    want = np.asarray(fn(jnp.asarray(v.reshape(N_STAGES * 3, 5)))).reshape(N_STAGES, 3, 5)
    got = talgos.inline_allreduce(_t(v), 0, op=rop).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if op == "sum":
        member = v[0]
        for j in range(1, N_STAGES):
            member = member + v[j]
        np.testing.assert_array_equal(got, np.broadcast_to(member, v.shape))
    # on the grid layout too: a rank dim other than the first
    g = talgos.inline_allreduce(_t(v.reshape(1, 1, 1, N_STAGES, 3, 5)), 3, op=rop)
    np.testing.assert_array_equal(g.numpy().reshape(v.shape), got)


def test_inline_allreduce_autograd():
    v = _t(np.arange(8, dtype=np.float32).reshape(4, 2), grad=True)
    out = talgos.inline_allreduce(v, 0)
    (g,) = torch.autograd.grad(out.sum(), v)
    np.testing.assert_array_equal(g.numpy(), np.full((4, 2), 4.0, np.float32))


@pytest.mark.parametrize("algo", ["lax", "rhd", "pallas_ring", "pallas_rhd"])
def test_inline_allreduce_with_a_group(tenv, algo):
    """With a group and a config the table picks the lowering: a forced
    kernel algorithm runs through inline_plan (its plain version here), every
    route equal to the baseline collective within 1e-6."""
    from mlsl_tpu_torch.comm import collectives

    tenv.config.collective_algo = algo
    tenv.config.validate()
    dist = tenv.create_distribution(2, 4)
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.normal(size=(1, 2, 1, 4, 3, 7)).astype(np.float32))
    got = talgos.inline_allreduce(x, 1, group=dist.data_group, config=tenv.config)
    assert talgos.select("allreduce", dist.data_group, 21 * 4, CompressionType.NONE,
                         tenv.config) == algo
    want = collectives.build_collective("allreduce", dist.data_group, op=ReductionType.SUM)(
        x.reshape(1, 2, 1, 4, 21)).reshape(x.shape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0, 0].numpy(), (x[0, 0] + x[0, 1]).numpy(), rtol=1e-6)
    # a one-member group reduces along dim instead
    one = talgos.inline_allreduce(x, 3, group=dist.seq_group, config=tenv.config)
    np.testing.assert_allclose(one.numpy(),
                               x.sum(dim=3, keepdim=True).expand_as(x).numpy(), rtol=1e-6)
