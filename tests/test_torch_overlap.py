"""The port's compiled overlap engine (mlsl_tpu_torch.comm.overlap and
DataParallelTrainer(overlap_compiled=True)) against the JAX package's.

- Plan parity: the same (name, count, compression) lists give the same
  units, counts, phases, ticks, residual lengths, rounds and breakdown. Off
  the TPU the JAX engine embeds no kernel algorithm (``inline_ok``) and falls
  back to ``lax``; the port runs B3 and B5 wherever they are eligible (their
  plain versions on the CPU), so a forced kernel algorithm reads ``lax`` on
  the JAX side.
- ``build_multi_reduce``: integer-valued payloads bit-exact against JAX's and
  against the port's own host requests; float payloads within 1e-6; the
  quantized units over 3 rounds bit-exact, results and residuals, against JAX
  run with the two XLA rewrites switched off that tests/test_torch_quant_ring.py
  explains, and within one quantization step of JAX as it runs by default.
- Trainer twins on the MLP, 8 ranks, lr 0.1: losses within rtol 1e-6 and
  parameters within 1e-6 of JAX's engine and of the port's own host path.
- The contracts: the constructor's asserts, the environment knob, staging,
  the single-rank fused path, the counters, and ``precompile`` on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.comm import overlap as jov
from mlsl_tpu.comm.mesh import ProcessGroup as JGroup, Topology as JTopo
from mlsl_tpu.core import stats as jstats
from mlsl_tpu.models.mlp import LAYERS, get_layer as jget_layer, init as mlp_init
from mlsl_tpu.models.mlp import loss_fn as jmlp_loss
from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
from mlsl_tpu.types import CompressionType as JComp
from mlsl_tpu_torch import optim
from mlsl_tpu_torch.comm import algos as talgos
from mlsl_tpu_torch.comm import overlap as tov
from mlsl_tpu_torch.comm.mesh import ProcessGroup as TGroup, Topology as TTopo
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest, Dispatcher
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.core import stats as tstats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import mlp as tmlp
from mlsl_tpu_torch.models.convert import params_from_jax, params_to_jax
from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer
from mlsl_tpu_torch.types import CompressionType as TComp, DataType, ReductionType

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
KERNEL_ALGOS = ("pallas_ring", "pallas_rhd")
N, Q = TComp.NONE, TComp.QUANTIZATION

# (tag, data parts, model parts, world, group axes): tests/test_overlap_compiled.py:157-162
GROUPS = [("8", 8, 1, 8, ("data",)), ("4x2", 4, 2, 8, ("data", "model")),
          ("6", 6, 1, 6, ("data",))]

# forward order; with 4 MiB buckets: [h, f] and [d, c, a] coalesce (the int8
# layers never bucket with dense ones), e is bandwidth-sized and stays alone
PLAN_LAYERS = [("a", 37, N), ("b", 256, Q), ("c", 1000, N), ("d", 13, N),
               ("e", 1_100_000, N), ("f", 700, N), ("g", 300, Q), ("h", 64, N)]


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _groups(tag, d, m, w, axes, jenv):
    jtopo = JTopo(d, m, devices=jenv.devices[:w])
    return JGroup(jtopo, axes), TGroup(TTopo(d, m, w), axes)


def _unit_rows(plan, canon=lambda a: a):
    return [(u.names, u.counts, canon(u.algo), u.nphases, u.per_tick, u.err_len, u.key)
            for u in plan.units]


# -- plan parity ---------------------------------------------------------------------


@pytest.mark.parametrize("bucket_mb", [0, 4])
@pytest.mark.parametrize("forced", [None, "lax", "rhd", "ring2d", *KERNEL_ALGOS])
@pytest.mark.parametrize("tag,d,m,w,axes", GROUPS, ids=[g[0] for g in GROUPS])
def test_plan_matches_jax(env, tenv, tag, d, m, w, axes, forced, bucket_mb):
    jg, tg = _groups(tag, d, m, w, axes, env)
    jlayers = [(n, c, JComp(int(comp))) for n, c, comp in PLAN_LAYERS]
    for stages in (1, 2, 3):
        jp = jov.build_plan(jg, jlayers, env.config, stages=stages, bucket_mb=bucket_mb,
                            block=256, algo=forced)
        tp = tov.build_plan(tg, PLAN_LAYERS, tenv.config, stages=stages, bucket_mb=bucket_mb,
                            block=256, algo=forced)
        # the JAX engine embeds no kernel off the TPU; the port runs the forced
        # kernel wherever it can serve the group in stages
        kernel = forced in KERNEL_ALGOS and talgos.inline_eligible(
            forced, "allreduce", tg, ReductionType.SUM)
        for u in tp.units:
            if u.key is None:
                assert u.algo == (forced if kernel else "lax" if forced in KERNEL_ALGOS
                                  else u.algo)
        canon = (lambda a: "lax" if a in KERNEL_ALGOS else a)
        assert _unit_rows(tp, canon) == _unit_rows(jp), (tag, forced, bucket_mb, stages)
        assert tp.err_lens == jp.err_lens
        assert tp.rounds == jp.rounds and tp.total_bytes == jp.total_bytes
        merged = {}
        for (k, a), n in tp.breakdown.items():
            merged[(k, canon(a))] = merged.get((k, canon(a)), 0) + n
        assert merged == jp.breakdown
        assert tp.quant_units == jp.quant_units == 2
        if bucket_mb:
            assert [u.names for u in tp.units if len(u.names) > 1] == [("h", "f"),
                                                                        ("d", "c", "a")]


def test_plan_describe_matches_jax(env, tenv):
    jg, tg = _groups(*GROUPS[0], env)
    jlayers = [(n, c, JComp(int(comp))) for n, c, comp in PLAN_LAYERS]
    jp = jov.build_plan(jg, jlayers, env.config, bucket_mb=4, block=256)
    tp = tov.build_plan(tg, PLAN_LAYERS, tenv.config, bucket_mb=4, block=256)
    assert tp.describe() == jp.describe()
    assert tp.algos_summary() == jp.algos_summary()


# -- build_multi_reduce --------------------------------------------------------------

COUNTS = [37, 256, 1000]


def _int_bufs(grid, counts):
    return [np.random.default_rng(i).integers(-40, 40, size=(*grid, c)).astype(np.float32)
            for i, c in enumerate(counts)]


def _host_request(tg, count, algo):
    """The port's host CommRequest for one buffer, with ``algo`` forced."""
    cfg = Config()
    cfg.collective_algo = algo
    cfg.validate()
    req = CommRequest(CommDesc("allreduce", tg, count, DataType.FLOAT, op=ReductionType.SUM),
                      Dispatcher(cfg))
    req.setup()
    return req


# every (group, algorithm) pair the algorithm can serve in stages (ring2d needs
# two live axes, pallas_ring one)
INT_CASES = [(*g, a) for g in GROUPS for a in ("lax", "rhd", "ring2d", *KERNEL_ALGOS)
             if talgos.inline_eligible(a, "allreduce", TGroup(TTopo(*g[1:4]), g[4]),
                                       ReductionType.SUM)]


@pytest.mark.parametrize("tag,d,m,w,axes,algo", INT_CASES,
                         ids=[f"{c[0]}-{c[5]}" for c in INT_CASES])
def test_multi_reduce_int_bit_exact(env, tag, d, m, w, axes, algo):
    jg, tg = _groups(tag, d, m, w, axes, env)
    grid = tg.topology.grid_shape
    bufs = _int_bufs(grid, COUNTS)
    for stages in (1, 3):
        jfn, _ = jov.build_multi_reduce(jg, COUNTS, algo=algo, stages=stages)
        tfn, tplan = tov.build_multi_reduce(tg, COUNTS, algo=algo, stages=stages)
        assert all(u.algo == algo for u in tplan.units)
        jouts = jfn([jg.topology.shard_buffer(b) for b in bufs])
        touts = tfn([torch.from_numpy(b) for b in bufs])
        for c, b, j, t in zip(COUNTS, bufs, jouts, touts):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"{algo} {tag} stages={stages} count={c}")
            req = _host_request(tg, c, algo)
            assert req.algo == algo
            host = req.start(torch.from_numpy(b)).wait()
            np.testing.assert_array_equal(t.numpy(), host.numpy())


@pytest.mark.parametrize("algo", ["lax", "rhd", *KERNEL_ALGOS])
def test_multi_reduce_float_within_1e6(env, algo):
    jg, tg = _groups(*GROUPS[0], env)
    counts = [129, 512]
    bufs = [np.random.default_rng(i).normal(size=(*tg.topology.grid_shape, c))
            .astype(np.float32) for i, c in enumerate(counts)]
    jfn, _ = jov.build_multi_reduce(jg, counts, algo=algo)
    tfn, _ = tov.build_multi_reduce(tg, counts, algo=algo)
    for j, t in zip(jfn([jg.topology.shard_buffer(b) for b in bufs]),
                    tfn([torch.from_numpy(b) for b in bufs])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


def test_multi_reduce_bucketed_matches_unbucketed(env):
    """A bucketed plan coalesces the counts into one unit; integer sums are
    the same bits as JAX's bucketed plan and as the unbucketed one."""
    jg, tg = _groups(*GROUPS[0], env)
    bufs = _int_bufs(tg.topology.grid_shape, COUNTS)
    tfn, tplan = tov.build_multi_reduce(tg, COUNTS, algo="rhd", bucket_mb=4)
    assert len(tplan.units) == 1 and tplan.units[0].names == ("t2", "t1", "t0")
    jfn, _ = jov.build_multi_reduce(jg, COUNTS, algo="rhd", bucket_mb=4)
    ufn, _ = tov.build_multi_reduce(tg, COUNTS, algo="rhd")
    ins = [torch.from_numpy(b) for b in bufs]
    for t, j, u in zip(tfn(ins), jfn([jg.topology.shard_buffer(b) for b in bufs]), ufn(ins)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(t.numpy(), u.numpy())


QCOUNTS = [300, 1000, 2049]
QROUNDS = 3
QGROUPS = [("g8", 8, 1, ("data",)), ("g4x2_data", 4, 2, ("data",)),
           ("g4x2_global", 4, 2, ("data", "model"))]


def _qinputs(tag, grid, r):
    rng = np.random.default_rng(sum(map(ord, tag)) + 97 * r)
    return [(rng.normal(size=(*grid, c)) * rng.uniform(0.1, 10, size=(*grid, 1)) + r)
            .astype(np.float32) for c in QCOUNTS]


_JAX_EXACT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from tests.test_torch_overlap import QCOUNTS, QGROUPS, QROUNDS, _qinputs
from mlsl_tpu.comm import overlap
from mlsl_tpu.comm.mesh import ProcessGroup, Topology
from mlsl_tpu.types import CompressionType
out = {}
for tag, d, m, axes in QGROUPS:
    topo = Topology(d, m)
    fn, plan = overlap.build_multi_reduce(ProcessGroup(topo, axes), QCOUNTS,
                                          compression=CompressionType.QUANTIZATION, block=256)
    res = None
    for r in range(QROUNDS):
        outs, res = fn([topo.shard_buffer(x) for x in _qinputs(tag, topo.grid_shape, r)], res)
        for i, o in enumerate(outs):
            out[f"{tag}/{r}/out{i}"] = np.asarray(o)
        for k, v in res.items():
            out[f"{tag}/{r}/res/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_exact(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_exact") / "multi.npz"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_EXACT, str(ROOT), str(path)],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _port_quant_rounds(tag, d, m, axes):
    tg = TGroup(TTopo(d, m, 8), axes)
    fn, plan = tov.build_multi_reduce(tg, QCOUNTS, compression=Q, block=256)
    res, rounds = None, []
    for r in range(QROUNDS):
        outs, res = fn([torch.from_numpy(x) for x in _qinputs(tag, tg.topology.grid_shape, r)],
                       res)
        rounds.append(([o.numpy() for o in outs], {k: v.numpy() for k, v in res.items()}))
    return plan, rounds


@pytest.mark.parametrize("tag,d,m,axes", QGROUPS, ids=[g[0] for g in QGROUPS])
def test_multi_reduce_quantized_bit_exact_vs_jax(jax_exact, tag, d, m, axes):
    plan, rounds = _port_quant_rounds(tag, d, m, axes)
    assert plan.quant_units == len(QCOUNTS)
    for r, (outs, res) in enumerate(rounds):
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, jax_exact[f"{tag}/{r}/out{i}"],
                                          err_msg=f"round {r} out {i}")
        assert sorted(res) == sorted(k.split("/res/")[1] for k in jax_exact
                                     if k.startswith(f"{tag}/{r}/res/"))
        for k, v in res.items():
            np.testing.assert_array_equal(v, jax_exact[f"{tag}/{r}/res/{k}"],
                                          err_msg=f"round {r} residual {k}")


def test_multi_reduce_quantized_vs_default_jax_within_one_step(env):
    tag, d, m, axes = QGROUPS[0]
    jg = JGroup(JTopo(d, m), axes)
    jfn, _ = jov.build_multi_reduce(jg, QCOUNTS, compression=JComp.QUANTIZATION, block=256)
    _, rounds = _port_quant_rounds(tag, d, m, axes)
    res = None
    for r in range(QROUNDS):
        outs, res = jfn([jg.topology.shard_buffer(x)
                         for x in _qinputs(tag, jg.topology.grid_shape, r)], res)
        for o, t in zip(outs, rounds[r][0]):
            o = np.asarray(o)
            np.testing.assert_allclose(t, o, rtol=0, atol=np.abs(o).max() / 127.0)
        for k, v in res.items():
            step = np.abs(np.asarray(v)).max() / 127.0 + np.abs(rounds[r][0][0]).max() / 127.0
            np.testing.assert_allclose(rounds[r][1][k], np.asarray(v), rtol=0, atol=step)


def test_stages_change_ticks_not_results(tenv):
    tg = TGroup(TTopo(6, 1, 6), ("data",))
    bufs = [torch.from_numpy(b) for b in _int_bufs(tg.topology.grid_shape, COUNTS)]
    outs = {}
    for stages in (1, 2, 3):
        fn, plan = tov.build_multi_reduce(tg, COUNTS, algo="rhd", stages=stages)
        assert [u.per_tick for u in plan.units] == [-(-u.nphases // stages)
                                                     for u in plan.units]
        outs[stages] = fn(bufs)
    assert outs[1][0].shape == outs[3][0].shape
    assert {u.nphases for u in plan.units} == {6}     # pre-fold, 2 + 2 rounds, post-fold
    for s in (2, 3):
        for a, b in zip(outs[1], outs[s]):
            assert torch.equal(a, b)


def test_trainer_stages_change_ticks_not_results(tenv):
    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    x, y = _batch()
    runs = []
    for stages in (1, 3):
        tenv.config.overlap_stages = stages
        tenv.config.collective_algo = "rhd"
        tenv.config.validate()
        tt = _torch_trainer(tenv, host, True)
        # rhd on 8 members: 3 halving and 3 doubling rounds a unit
        assert [(u.nphases, u.per_tick) for u in tt._overlap.plan.units] == \
            [(6, -(-6 // stages))] * 2
        runs.append((tt, [tt.step(tt.shard_batch(x, y)) for _ in range(3)]))
    (a, la), (b, lb) = runs
    assert all(torch.equal(p, q) for p, q in zip(la, lb))
    assert _max_param_delta(a, b) == 0.0


def test_graphs_the_engine_cannot_take_ride_the_host_path(tenv, monkeypatch):
    """A custom codec, TOPK compression and a color group send the graph
    back to the host path (overlap.py:891-905). The port has none of the
    three yet, so each is planted on a plain trainer's graph."""
    import types

    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    tt = _torch_trainer(tenv, host, False)
    assert tov.engine_for_trainer(tt, tenv.config) is not None
    assert tov.engine_for_trainer(tt, types.SimpleNamespace(custom_codec=object())) is None
    with monkeypatch.context() as mp:
        mp.setattr(TGroup, "colors", property(lambda self: (0, 0, 0, 0, 1, 1, 1, 1)))
        assert not talgos.inline_eligible("lax", "allreduce", tt.dist.grad_group)
        assert tov.engine_for_trainer(tt, tenv.config) is None
    with monkeypatch.context() as mp:
        mp.setattr(tt._pset(LAYERS[0]), "compression", TComp.TOPK)
        assert tov.engine_for_trainer(tt, tenv.config) is None
        with pytest.raises(MLSLError):
            tov.build_plan(tt.dist.grad_group, [("l1", 144, TComp.TOPK)], tenv.config)


# -- trainer twins -------------------------------------------------------------------


def _batch(scale=1.0):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(32, 8)) * scale).astype(np.float32)
    y = rng.integers(0, 4, size=(32,)).astype(np.int32)
    return x, y


def _jax_trainer(env, params, engine, **kw):
    dist = env.create_distribution(8, 1)
    s = env.create_session()
    s.set_global_minibatch_size(32)
    return JTrainer(env, dist, s, params, jmlp_loss, LAYERS, jget_layer, lr=0.1,
                    overlap_compiled=engine, force_graph_path=not engine,
                    donate_params=False, **kw)


def _torch_trainer(tenv, host_params, engine, **kw):
    dist = tenv.create_distribution(8, 1)
    s = tenv.create_session()
    s.set_global_minibatch_size(32)
    model = tmlp.MLP(device="cpu", params=params_from_jax(host_params, device="cpu"))
    return TTrainer(tenv, dist, s, model, tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1,
                    overlap_compiled=engine, **kw)


def _max_param_delta(tt, other):
    got = params_to_jax(tt.model)
    want = (params_to_jax(other.model) if isinstance(other, TTrainer)
            else jax.device_get(other.params))
    return max(float(np.max(np.abs(np.asarray(g) - np.asarray(w))))
               for name in LAYERS
               for g, w in zip(jax.tree.leaves(got[name]), jax.tree.leaves(want[name])))


TWINS = {
    "plain": dict(steps=4),
    "int8": dict(steps=5, compression="q"),
    "bucketed": dict(steps=4, bucket_mb=4),
    "rhd": dict(steps=4, algo="rhd"),
    "lax": dict(steps=4, algo="lax"),
    "pallas_ring": dict(steps=4, algo="pallas_ring"),
    "clip": dict(steps=4, clip=0.25),
    "step_accum": dict(steps=3, accum=True),
}


def _configure(cfg, case):
    cfg.grad_bucket_mb = case.get("bucket_mb", 0)
    cfg.collective_algo = case.get("algo", "")
    cfg.validate()


@pytest.mark.parametrize("oracle", ["jax", "host"])
@pytest.mark.parametrize("name", list(TWINS))
def test_trainer_twins(env, tenv, name, oracle):
    case = TWINS[name]
    q = case.get("compression") == "q"
    kw = {}
    if "clip" in case:
        kw["clip_global_norm"] = case["clip"]
    _configure(tenv.config, case)
    params = mlp_init(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    tc = _torch_trainer(tenv, host, True, compression=Q if q else N, **kw)
    assert tc._overlap is not None, "the compiled overlap engine did not engage"
    if oracle == "jax":
        _configure(env.config, case)
        other = _jax_trainer(env, params, True,
                             compression=JComp.QUANTIZATION if q else JComp.NONE, **kw)
        assert other._overlap is not None
    else:
        other = _torch_trainer(tenv, host, False, compression=Q if q else N, **kw)
        assert other._overlap is None
    x, y = _batch()
    for _ in range(case["steps"]):
        if case.get("accum"):
            lc = tc.step_accum([tc.shard_batch(x, y), tc.shard_batch(x * 0.5, y)])
            lo = other.step_accum([other.shard_batch(x, y), other.shard_batch(x * 0.5, y)])
        else:
            lc, lo = tc.step(tc.shard_batch(x, y)), other.step(other.shard_batch(x, y))
    np.testing.assert_allclose(lc.reshape(-1).numpy(), np.asarray(lo).reshape(-1), rtol=1e-6)
    assert _max_param_delta(tc, other) <= 1e-6
    plan = tc._overlap.plan
    if q:
        assert plan.quant_units == len(LAYERS) and tc._overlap.residuals
        assert all(u.algo == "quant_ring" for u in plan.units)
    if "bucket_mb" in case:
        assert len(plan.units) < len(LAYERS)
    if "algo" in case:
        assert all(u.algo == case["algo"] for u in plan.units)


def test_int8_on_the_fused_ring_matches_host(tenv):
    """MLSL_ALGO=pallas_ring: each quantized unit takes B1 + B4 with the host
    request's geometry; the twins stay bitwise alike on the CPU."""
    _configure(tenv.config, {"algo": "pallas_ring"})
    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    tc = _torch_trainer(tenv, host, True, compression=Q)
    th = _torch_trainer(tenv, host, False, compression=Q)
    units = tc._overlap.plan.units
    assert [u.algo for u in units] == ["pallas_ring"] * len(LAYERS)
    for u in units:
        req = th._pset(u.names[0]).grad_req
        assert req.algo == "pallas_ring" and [u.err_len] == req._err_lens
    x, y = _batch()
    for _ in range(4):
        lc, lh = tc.step(tc.shard_batch(x, y)), th.step(th.shard_batch(x, y))
    assert torch.equal(lc, lh)
    assert _max_param_delta(tc, th) == 0.0
    for u in units:
        assert torch.equal(tc._overlap.residuals[u.key], th._pset(u.names[0]).grad_req._errs[0])


# -- contracts -----------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(optimizer="sgd"), dict(distributed_update=True),
                                dict(overlap_updates=True)],
                         ids=["optimizer", "distributed_update", "overlap_updates"])
def test_constructor_asserts(tenv, kw):
    kw = dict(kw)
    if kw.get("optimizer") == "sgd":
        kw["optimizer"] = optim.sgd(0.1)
    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    with pytest.raises(MLSLError):
        _torch_trainer(tenv, host, True, **kw)


def test_env_knob_arms_plain_and_skips_others(monkeypatch):
    monkeypatch.setenv("MLSL_OVERLAP_COMPILED", "1")
    tenv = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert tenv.config.overlap_compiled
        host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
        assert _torch_trainer(tenv, host, None)._overlap is not None
        assert _torch_trainer(tenv, host, None, optimizer=optim.sgd(0.1))._overlap is None
        assert _torch_trainer(tenv, host, None, distributed_update=True)._overlap is None
        assert _torch_trainer(tenv, host, None, overlap_updates=True)._overlap is None
        assert _torch_trainer(tenv, host, False)._overlap is None
    finally:
        tenv.finalize()


def test_single_rank_world_takes_the_fused_path():
    tenv = Environment.get_env().init(device="cpu", world_size=1)
    try:
        dist = tenv.create_distribution(1, 1)
        s = tenv.create_session()
        s.set_global_minibatch_size(8)
        tt = TTrainer(tenv, dist, s, tmlp.MLP(device="cpu"), tmlp.loss_fn, tmlp.LAYERS,
                      tmlp.get_layer, lr=0.1, overlap_compiled=True)
        assert tt.fused and tt._overlap is None
        x, y = _batch()
        loss = tt.step(tt.shard_batch(x[:8], y[:8]))
        assert loss.dim() == 0 and torch.isfinite(loss)
    finally:
        tenv.finalize()


@pytest.mark.parametrize("engine", [True, False], ids=["engine", "host"])
def test_counters_match_jax(env, tenv, engine):
    """The engine's steps feed OVERLAP_COUNTERS and, per unit, ALGO_COUNTERS;
    the host path's requests feed ALGO_COUNTERS one dispatch each."""
    params = mlp_init(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    jt = _jax_trainer(env, params, engine, compression=JComp.QUANTIZATION)
    tt = _torch_trainer(tenv, host, engine, compression=Q)
    x, y = _batch()
    jstats.reset_overlap_counters()
    jstats.reset_algo_counters()
    tstats.reset_overlap_counters()
    tstats.reset_algo_counters()
    for _ in range(3):
        jt.step(jt.shard_batch(x, y))
        tt.step(tt.shard_batch(x, y))
    jt.step_accum([jt.shard_batch(x, y)])
    tt.step_accum([tt.shard_batch(x, y)])
    assert tstats.OVERLAP_COUNTERS == jstats.OVERLAP_COUNTERS
    assert tstats.OVERLAP_COUNTERS["steps"] == (4 if engine else 0)
    assert tstats.OVERLAP_COUNTERS["split_steps"] == (1 if engine else 0)
    assert tstats.ALGO_COUNTERS == jstats.ALGO_COUNTERS == {("allreduce", "quant_ring"): 8}


def test_precompile_on_cpu_leaves_the_trainer_as_it_was(tenv):
    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    tc = _torch_trainer(tenv, host, True, compression=Q)
    twin = _torch_trainer(tenv, host, True, compression=Q)
    x, y = _batch()
    for t in (tc, twin):
        t.step(t.shard_batch(x, y))       # residuals no longer zero
    engine = tc._overlap
    params = [p.detach().clone() for p in tc.model.parameters()]
    buffers = [b.clone() for b in tc.model.buffers()]
    res = {k: v.clone() for k, v in engine.residuals.items()}
    assert any(bool(v.abs().sum() > 0) for v in res.values())
    step_no = tc._step_no
    tstats.reset_overlap_counters()
    tc.precompile(tc.shard_batch(x * 2.0, y))
    assert all(torch.equal(a, b) for a, b in zip(tc.model.parameters(), params))
    assert all(torch.equal(a, b) for a, b in zip(tc.model.buffers(), buffers))
    assert all(torch.equal(engine.residuals[k], v) for k, v in res.items())
    assert tc._step_no == step_no and engine.graphs == {}
    assert tstats.OVERLAP_COUNTERS["steps"] == 0
    lc, lt = tc.step(tc.shard_batch(x, y)), twin.step(twin.shard_batch(x, y))
    assert torch.equal(lc, lt) and _max_param_delta(tc, twin) == 0.0
