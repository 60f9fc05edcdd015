"""The port's elastic mesh over virtual ranks (mlsl_tpu_torch.elastic) against
the JAX package's (mlsl_tpu.elastic): tests/test_elastic.py, the fast elastic
soak and the straggler shed hand-off of tests/test_soak.py.

- The survivor sets, the tiers of a survivor world, the reshard plans and
  ``verify_reshard``'s codes on broken plans equal the JAX package's on the
  same world (the JAX devices' ids are the port's virtual ranks).
- The live ZeRO-1 reshard moves bytes and computes nothing: every owned
  leaf on the survivor world equals the host re-slice of the old world's
  shards bit for bit, and the step after a shrink (or a grow) is bit for bit
  a twin trainer built directly on that world from the same state.
- The admission audit rejects a corrupted rejoiner, re-syncs and admits it,
  or abandons the grow; the capacity budget escalates to the restart rung.

Tolerance: bit for bit throughout (both sides of each comparison compute in
the same order); the elastic soak's losses against its uninterrupted twin
within rtol/atol 2e-3, as the JAX soak holds them (another global batch
partition, the same global mean).
"""

import json

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu import chaos as jchaos
from mlsl_tpu import elastic as jelastic
from mlsl_tpu import supervisor as jsup
from mlsl_tpu.core.environment import Environment as JEnvironment
from mlsl_tpu_torch import chaos, elastic, optim, supervisor
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLDeviceLossError, MLSLError, MLSLKernelError

torch.set_num_threads(2)


def _finalize():
    if JEnvironment._instance is not None:
        JEnvironment._instance.finalize()
    if Environment._instance is not None:
        Environment._instance.finalize()


@pytest.fixture(autouse=True)
def _isolated():
    jchaos.clear()
    jelastic.reset()
    supervisor.reset_all()
    yield
    _finalize()
    supervisor.reset_all()
    jchaos.clear()
    jelastic.reset()


def _ids(devs):
    return tuple(d.id for d in devs)


# -- survivor sets and tiers (comm/mesh.py) ---------------------------------------------


def test_survivor_devices_flat():
    from mlsl_tpu.comm.mesh import survivor_devices as jsurv
    from mlsl_tpu_torch.comm.mesh import survivor_devices

    devs = jax.devices()
    assert survivor_devices([2, 5], range(8)) == _ids(jsurv([devs[2], devs[5]])) == \
        (0, 1, 3, 4, 6, 7)


@pytest.mark.parametrize("lost", [5, 0, 3])
def test_survivor_devices_tiered_drops_whole_slice(monkeypatch, lost):
    from mlsl_tpu.comm.mesh import survivor_devices as jsurv
    from mlsl_tpu_torch.comm.mesh import survivor_devices

    monkeypatch.setenv("MLSL_MESH_TIERS", "2x4")
    want = _ids(jsurv([jax.devices()[lost]]))
    assert survivor_devices([lost], range(8)) == want == \
        ((0, 1, 2, 3) if lost >= 4 else (4, 5, 6, 7))


def test_survivor_devices_nothing_left_raises():
    from mlsl_tpu_torch.comm.mesh import survivor_devices

    with pytest.raises(MLSLError, match="no survivors"):
        survivor_devices(range(8), range(8))


def test_survivor_world_keeps_its_tiers(monkeypatch):
    """A survivor world's ranks keep their tiers by identity, as a device
    keeps its slice: one tier left is one tier."""
    from mlsl_tpu.comm.mesh import world_tier_ids as jids
    from mlsl_tpu_torch.comm.mesh import world_tier_ids, world_tiers

    monkeypatch.setenv("MLSL_MESH_TIERS", "2x4")
    for surv in ((4, 5, 6, 7), (0, 1, 2, 3)):
        elastic._set_active(surv)
        assert world_tier_ids(4) == jids([jax.devices()[i] for i in surv]) == (0, 0, 0, 0)
        assert world_tiers(4) == (1, 4)
    assert world_tier_ids(8, ranks=range(8)) == jids() == (0,) * 4 + (1,) * 4


# -- the taxonomy and the chaos site --------------------------------------------------


def test_device_loss_class_and_recoverability():
    from mlsl_tpu_torch.resilience import RECOVERABLE

    e = MLSLDeviceLossError("host preempted", devices=(7,))
    assert supervisor.classify(e) is supervisor.ErrorClass.DEVICE_LOSS
    assert isinstance(e, RECOVERABLE) and e.devices == (7,)


def test_device_lost_site_default_exception():
    p = chaos.plan("device.lost", "error")
    assert p.exc is MLSLDeviceLossError
    with pytest.raises(MLSLDeviceLossError):
        chaos.inject("device.lost")
    chaos.clear()
    assert chaos.plan("device.lost", "error", exc=OSError).exc is OSError
    chaos.clear()
    assert chaos.plan("device.lost", "error", exc=chaos.ChaosError).exc is chaos.ChaosError


def test_device_lost_env_grammar_matches_jax():
    (p,) = chaos.refresh_from_env("device.lost:error@2x3%0.5")
    (j,) = jchaos.refresh_from_env("device.lost:error@2x3%0.5")
    assert (p.site, p.exc.__name__, p.after, p.times, p.prob) == \
        (j.site, j.exc.__name__, j.after, j.times, j.prob) == \
        ("device.lost", "MLSLDeviceLossError", 2, 3, 0.5)


def test_dispatch_site_does_not_consume_silent_plan():
    """The collective dispatch passes only error-shaped device.lost plans; a
    'silent' plan is the grow's (the rejoiner corruption)."""
    from mlsl_tpu_torch.comm.collectives import _ChaosDispatch

    d = _ChaosDispatch(lambda *bufs: "ok", "allreduce")
    p = chaos.plan("device.lost", "silent")
    assert d() == "ok" and p.hits == 0 and p.fires == 0
    assert chaos.inject("device.lost", phase="admit") is p and p.fires == 1
    chaos.clear()
    chaos.plan("device.lost", "error")
    with pytest.raises(MLSLDeviceLossError):
        d()


# -- the A140/A141 reshard-plan verifier --------------------------------------------


def _plans_8_to_6():
    args = ({"l1": 100, "l2": 7}, {"l1": 104, "l2": 8}, {"l1": 102, "l2": 12}, 8, 6)
    return elastic.build_reshard_plan(*args), jelastic.build_reshard_plan(*args)


def _tamper(kind, p):
    if kind == "gap":
        del p["layers"][0]["sources"][3]
    elif kind == "overlap":
        r, lo, hi = p["layers"][0]["sources"][2]
        p["layers"][0]["sources"][2] = (r, lo - 2, hi)
    elif kind == "target":
        p["layers"][0]["padded_new"] = 90
    elif kind == "zero_k_old":
        p.update({"d_old": 8, "d_new": 6, "layers": [{
            "name": "l", "count": 5, "padded_old": 0, "padded_new": 6, "k_old": 0,
            "k_new": 1, "sources": [(0, 0, 5)],
            "targets": [(r, r, r + 1) for r in range(6)]}]})
    elif kind == "worlds":
        p["d_new"] = 0
    return p


def test_reshard_plan_equals_jax_and_is_green():
    from mlsl_tpu.analysis import plan as jplan
    from mlsl_tpu_torch.analysis import plan as tplan

    t, j = _plans_8_to_6()
    assert t == j
    rt, rj = tplan.verify_reshard(t), jplan.verify_reshard(j)
    assert rt.errors == [] and rt.warnings == [] and rj.errors == []


@pytest.mark.parametrize("kind", ["gap", "overlap", "target", "zero_k_old", "worlds"])
def test_broken_reshard_plans_report_jax_codes(kind):
    """Each broken plan gets the JAX package's codes and messages (A140 a
    gap or an overlap, A141 a target geometry, both for a k_old of 0)."""
    from mlsl_tpu.analysis import plan as jplan
    from mlsl_tpu_torch.analysis import plan as tplan

    t, j = (_tamper(kind, p) for p in _plans_8_to_6())
    rt, rj = tplan.verify_reshard(t), jplan.verify_reshard(j)
    assert rt.codes() == rj.codes() and rt.errors
    assert [d.format() for d in rt.diagnostics] == [d.format() for d in rj.diagnostics]
    want = {"gap": {"MLSL-A140"}, "overlap": {"MLSL-A140"}, "target": {"MLSL-A141"},
            "zero_k_old": {"MLSL-A140", "MLSL-A141"}, "worlds": {"MLSL-A141"}}[kind]
    assert set(rt.codes()) == want


# -- config, status, the registry -----------------------------------------------------


def test_elastic_knob_validation(monkeypatch):
    for var, val, ok in (("MLSL_CAPACITY_BUDGET", "-1", "2"),
                         ("MLSL_ELASTIC_GROW_AFTER", "-3", "0"),
                         ("MLSL_ELASTIC_ADMIT_RETRIES", "-1", "1"),
                         ("MLSL_RESTART_BUDGET", "-1", "20"),
                         ("MLSL_CKPT_SAVE_RETRIES", "-1", "3")):
        monkeypatch.setenv(var, val)
        with pytest.raises(MLSLError, match=var):
            Environment.get_env().init(device="cpu")
        monkeypatch.setenv(var, ok)
    env = Environment.get_env().init(device="cpu")
    assert (env.config.capacity_budget, env.config.elastic_admit_retries) == (2, 1)


def test_config_knobs_match_jax():
    """The A.7c knobs: the JAX package's names, defaults and variables."""
    from mlsl_tpu.config import Config as JConfig
    from mlsl_tpu_torch.config import Config

    names = ("ckpt_save_retries", "ckpt_retry_backoff_s", "restart_budget", "preemption_file",
             "elastic", "elastic_admit_retries", "elastic_grow_after", "capacity_budget",
             "control_addrs", "control_port", "control_rank", "control_world",
             "heartbeat_grace_s", "heartbeat_interval_s", "heartbeat_misses")
    assert {n: getattr(Config(), n) for n in names} == {n: getattr(JConfig(), n) for n in names}


def test_status_entry_matches_jax(env):
    Environment.get_env().init(device="cpu", world_size=8)
    st, js = supervisor.status()["elastic"], jsup.status()["elastic"]
    assert st == js
    assert st["state"] == "full" and st["world_size"] == st["active_size"] == 8


def test_zero_shed_loss_escalates_to_restart():
    elastic._set_active(tuple(range(6)))
    coord = elastic.ElasticCoordinator(capacity_budget=4)
    with pytest.raises(MLSLError, match="nothing to shed"):
        coord.shrink(None, None, error=MLSLDeviceLossError("stale", devices=(6, 7)), step=3)
    assert stats.ELASTIC_COUNTERS["restart_fallbacks"] == 1
    assert stats.ELASTIC_COUNTERS["shrinks"] == 0


def test_drain_failure_counts_restart_fallback():
    Environment.get_env().init(device="cpu", world_size=8)
    coord = elastic.ElasticCoordinator(capacity_budget=4)
    with pytest.raises(MLSLError, match="restart rung"):
        coord.shrink(object(), None, error=MLSLDeviceLossError("preempted", devices=(7,)),
                     step=1)
    assert stats.ELASTIC_COUNTERS["restart_fallbacks"] == 1
    assert elastic.active_devices() is None


def test_programmatic_config_arms_elastic(tmp_path, monkeypatch):
    """Config(elastic=True, capacity_budget=N) set in code arms the loop's
    coordinator and binds the budget, at construction and again at run()."""
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    monkeypatch.delenv("MLSL_ELASTIC", raising=False)
    monkeypatch.delenv("MLSL_CAPACITY_BUDGET", raising=False)
    env = Environment.get_env().init(device="cpu")
    env.config.elastic = True
    env.config.capacity_budget = 3
    loop = FaultTolerantLoop(lambda: None, str(tmp_path / "ck"))
    assert loop.elastic is not None and loop.elastic.capacity_budget == 3
    env.finalize()
    loop = FaultTolerantLoop(lambda: None, str(tmp_path / "ck2"))
    assert loop.elastic is None
    env = Environment.get_env().init(device="cpu")
    env.config.elastic = True
    env.config.capacity_budget = 2
    loop._arm_elastic_if_configured()
    assert loop.elastic is not None and loop.elastic.capacity_budget == 2


def test_reset_clears_budget_snapshot():
    elastic.ElasticCoordinator(capacity_budget=3)
    assert supervisor.status()["elastic"]["capacity_budget"] == 3
    elastic.reset()
    st = supervisor.status()["elastic"]
    assert st["capacity_budget"] is None and st["budget_remaining"] is None


def test_du_leaf_roles_match_jax():
    import jax.numpy as jnp
    import optax

    class J:
        optimizer = optax.adam(1e-2)

    class T:
        optimizer = optim.adam(1e-2)

    jstate = J.optimizer.init(jnp.zeros((1,), jnp.float32))
    assert elastic._du_leaf_roles(T(), T.optimizer.init(1)) == \
        jelastic._du_leaf_roles(J(), jstate) == [False, True, True]
    state = {"count": 0, "v_row": 0, "v_col": 0, "v": 0, "m": 0}
    assert elastic._du_leaf_roles(object(), state) == jelastic._du_leaf_roles(object(), state) \
        == [False, True, True, False, False]
    assert elastic._du_leaf_roles(object(), (np.zeros(3),)) is None


# -- the trainer harness --------------------------------------------------------------


def _make_trainer(batch=24, params=None, **kw):
    from mlsl_tpu.models.mlp import init
    from mlsl_tpu_torch.models import mlp as tmlp
    from mlsl_tpu_torch.models.convert import params_from_jax
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    if params is None:
        params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    env = Environment.get_env().init(device="cpu")
    dist = env.create_distribution(env.get_process_count(), 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(batch)
    return DataParallelTrainer(env, dist, sess,
                               tmlp.MLP(device="cpu", params=params_from_jax(params, "cpu")),
                               tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1, **kw)


def _batch(trainer, step, batch=24):
    rng = np.random.default_rng(step)
    return trainer.shard_batch(rng.normal(size=(batch, 8)).astype(np.float32),
                               rng.integers(0, 4, size=(batch,)).astype(np.int32))


def _adam_factory(batch=24, **kw):
    return lambda: _make_trainer(batch=batch, distributed_update=True,
                                 optimizer=optim.adam(1e-2), **kw)


def _owned_full(trainer):
    """Host oracle: every rank's owned shard of every ZeRO-1 leaf in rank order."""
    from mlsl_tpu_torch.sentinel import tree_leaves

    return {n: [leaf.detach().reshape(-1).numpy().copy() for leaf in tree_leaves(st)]
            for n, st in trainer.opt_state.items()}


def _params(trainer):
    return [p.detach().clone() for n in trainer.layers for p in trainer.layer_params[n]]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- the live ZeRO-1 reshard --------------------------------------------------------


def test_reshard_plan_of_the_trainers_equals_jax():
    """On the same world, the trainers' counts give the JAX package's plan."""
    from mlsl_tpu.models.mlp import LAYERS, get_layer, init, loss_fn
    from mlsl_tpu.models.train import DataParallelTrainer as JTrainer

    def jtrainer():
        env = JEnvironment.get_env().init()
        dist = env.create_distribution(env.get_process_count(), 1)
        sess = env.create_session()
        sess.set_global_minibatch_size(24)
        return JTrainer(env, dist, sess, init(jax.random.PRNGKey(0)), loss_fn, LAYERS,
                        get_layer, lr=0.1, distributed_update=True)

    shapes = {}
    for world in (8, 6):
        jelastic._set_active(tuple(jax.devices()[:world]) if world < 8 else None)
        elastic._set_active(tuple(range(world)) if world < 8 else None)
        jt, tt = jtrainer(), _make_trainer(distributed_update=True)
        assert (jt.layer_counts, jt.padded_counts) == (tt.layer_counts, tt.padded_counts)
        shapes[world] = (dict(tt.layer_counts), dict(tt.padded_counts))
        _finalize()
    (counts, p8), (_, p6) = shapes[8], shapes[6]
    assert elastic.build_reshard_plan(counts, p8, p6, 8, 6) == \
        jelastic.build_reshard_plan(counts, p8, p6, 8, 6)


def test_zero1_reshard_moves_state_exactly():
    """Shrink 8 -> 6 mid-run: every owned leaf on the survivor world equals
    the host re-slice of the old world's shards, the step count carries, the
    parameters carry, and the next step is a 6-rank twin's bit for bit."""
    factory = _adam_factory()
    trainer = factory()
    for s in range(2):
        trainer.step(_batch(trainer, s))
    truth, params = _owned_full(trainer), _params(trainer)
    counts, d_old = dict(trainer.layer_counts), trainer.data_size
    coord = elastic.ElasticCoordinator(capacity_budget=4)
    new = coord.shrink(trainer, factory, error=MLSLDeviceLossError("2 lost", devices=(6, 7)),
                       step=2)
    assert new.data_size == 6 and elastic.active_devices() == tuple(range(6))
    _same(_params(new), params)
    got = _owned_full(new)
    for name in truth:
        count_old, mu_old, nu_old = truth[name]
        count_new, mu_new, nu_new = got[name]
        assert count_new == count_old == 2
        for old, full in ((mu_old, mu_new), (nu_old, nu_new)):
            want = np.pad(old[:counts[name]], (0, new.padded_counts[name] - counts[name]))
            np.testing.assert_array_equal(full, want)
    assert stats.ELASTIC_COUNTERS["reshard_buffers"] == 3 * len(truth)
    assert d_old == 8
    # the 6-rank twin from the same state
    state = {n: [t.clone() for t in st] for n, st in
             ((n, optim.AdamState(*new.opt_state[n])) for n in new.layers)}
    twin_params = _params(new)
    new.step(_batch(new, 2))
    after = _params(new)
    Environment.get_env().finalize()
    twin = factory()
    with torch.no_grad():
        for p, v in zip([p for n in twin.layers for p in twin.layer_params[n]], twin_params):
            p.copy_(v)
        for n in twin.layers:
            for d, s in zip(twin.opt_state[n], state[n]):
                d.copy_(s)
    twin.step(_batch(twin, 2))
    _same(_params(twin), after)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.b = torch.nn.Parameter(torch.zeros(4))


def test_tiny_layer_state_survives_reshard():
    """A layer with fewer parameters than the world has ranks (k == 1 on both
    sides): the step count carries, the moments reshard."""
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    def factory():
        env = Environment.get_env().init(device="cpu")
        dist = env.create_distribution(env.get_process_count(), 1)
        sess = env.create_session()
        sess.set_global_minibatch_size(24)
        return DataParallelTrainer(env, dist, sess, _Tiny(),
                                   lambda m, b: ((m.b - 1.0) ** 2).mean() + 0 * b[0].sum(),
                                   ["t"], lambda m, n: [m.b], lr=0.1, distributed_update=True,
                                   optimizer=optim.adam(1e-2))

    trainer = factory()
    for s in range(2):
        trainer.step(_batch(trainer, s))
    count, mu, nu = _owned_full(trainer)["t"]
    trainer = elastic.ElasticCoordinator(capacity_budget=4).shrink(
        trainer, factory, error=MLSLDeviceLossError("preempted", devices=(6, 7)), step=2)
    assert trainer.data_size == 6
    c2, mu2, nu2 = _owned_full(trainer)["t"]
    assert count == c2 == 2
    np.testing.assert_array_equal(mu2, np.pad(mu[:4], (0, 2)))
    np.testing.assert_array_equal(nu2, np.pad(nu[:4], (0, 2)))
    assert np.isfinite(float(trainer.step(_batch(trainer, 2)).mean()))


def test_tiered_shrink_and_grow_are_twins(monkeypatch):
    """chip_smoke.py's run (ab2) at the MLP's size: on MLSL_MESH_TIERS=2x4 a
    loss in tier 1 drops the whole tier (8 -> 4), the drain and placement
    move the owned Adam state exactly, and the step after the shrink and the
    step after the grow are bit for bit twins built on 4 and 8 ranks from the
    same state."""
    monkeypatch.setenv("MLSL_MESH_TIERS", "2x4")
    monkeypatch.setenv("MLSL_ALGO", "pallas_ring")
    factory = _adam_factory(batch=64)

    def twin_step(world_ranks, params, opt, step):
        elastic._set_active(world_ranks)
        t = factory()
        with torch.no_grad():
            for p, v in zip([p for n in t.layers for p in t.layer_params[n]], params):
                p.copy_(v)
            for n in t.layers:
                for d, s in zip(t.opt_state[n], opt[n]):
                    d.copy_(s)
        t.step(_batch(t, step, 64))
        out = _params(t)
        Environment.get_env().finalize()
        return out

    def state(t):
        return _params(t), {n: [x.clone() for x in t.opt_state[n]] for n in t.layers}

    trainer = factory()
    for s in range(3):
        trainer.step(_batch(trainer, s, 64))
    coord = elastic.ElasticCoordinator(capacity_budget=4)
    trainer = coord.shrink(trainer, factory, error=MLSLDeviceLossError("x", devices=(5,)),
                           step=3)
    assert trainer.data_size == 4 and elastic.active_devices() == (0, 1, 2, 3)
    p, o = state(trainer)
    trainer.step(_batch(trainer, 3, 64))
    after = _params(trainer)
    Environment.get_env().finalize()
    _same(twin_step((0, 1, 2, 3), p, o, 3), after)
    elastic._set_active((0, 1, 2, 3))
    trainer = factory()
    with torch.no_grad():
        for dst, v in zip([q for n in trainer.layers for q in trainer.layer_params[n]], after):
            dst.copy_(v)
    coord.announce_return()
    trainer = coord.maybe_grow(trainer, factory, 4)
    assert trainer.data_size == 8 and elastic.active_devices() is None
    p, o = state(trainer)
    trainer.step(_batch(trainer, 4, 64))
    after = _params(trainer)
    Environment.get_env().finalize()
    _same(twin_step(None, p, o, 4), after)
    c = stats.ELASTIC_COUNTERS
    assert (c["shrinks"], c["grows"], c["admits"], c["admit_rejects"]) == (1, 1, 1, 0)


# -- the admission audit --------------------------------------------------------------


def test_admission_rejects_corrupted_rejoiner(caplog):
    factory = _adam_factory()
    trainer = factory()
    trainer.step(_batch(trainer, 0))
    coord = elastic.ElasticCoordinator(capacity_budget=4, admit_retries=1)
    trainer = coord.shrink(trainer, factory, error=MLSLDeviceLossError("x", devices=(6, 7)),
                           step=1)
    trainer.step(_batch(trainer, 1))
    before = _params(trainer)
    chaos.plan("device.lost", "silent")
    trainer = coord.grow(trainer, factory, step=2)
    c = stats.ELASTIC_COUNTERS
    assert c["admit_rejects"] == 1 and c["resyncs"] == 1 and c["admits"] == 1
    assert trainer.dist.topology.world_size == 8
    _same(_params(trainer), before)   # the rejoiner's copy never reached the state
    from mlsl_tpu_torch import sentinel as sentinel_mod

    res = sentinel_mod.Sentinel(trainer.dist.topology.grid_shape).audit_now(trainer, step=2)
    assert res.equal
    assert "admission audit REJECTED" in caplog.text


def test_admission_persistent_divergence_abandons_grow():
    factory = _adam_factory()
    trainer = factory()
    trainer.step(_batch(trainer, 0))
    coord = elastic.ElasticCoordinator(capacity_budget=4, admit_retries=0)
    trainer = coord.shrink(trainer, factory, error=MLSLDeviceLossError("x", devices=(6, 7)),
                           step=1)
    truth = _params(trainer)
    chaos.plan("device.lost", "silent")
    trainer = coord.grow(trainer, factory, step=2)
    assert trainer.data_size == 6 and elastic.active_devices() == tuple(range(6))
    assert coord._pending_return is False and coord._return_due is None
    c = stats.ELASTIC_COUNTERS
    assert c["grows"] == 0 and c["grow_abandons"] == 1
    assert supervisor.status()["elastic"]["last_reshard"]["verdict"] == "abandoned"
    _same(_params(trainer), truth)
    coord.announce_return()
    trainer = coord.maybe_grow(trainer, factory, step=3)
    assert trainer.dist.topology.world_size == 8
    assert c["grows"] == 1 and c["admits"] == 1


# -- the loop's rungs -----------------------------------------------------------------


def _elastic_batch(trainer, step):
    return _batch(trainer, step, 56)


def test_persistent_divergence_in_loop_stays_shrunk_no_restart(tmp_path):
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    armed = [0]

    def hook(step, attempt):
        if step == 2 and armed[0] == 0:
            armed[0] = 1
            chaos.plan("device.lost", "error")
        if step == 4 and armed[0] == 1:
            armed[0] = 2
            chaos.plan("device.lost", "silent")

    coord = elastic.ElasticCoordinator(capacity_budget=4, grow_after=3, admit_retries=0)
    loop = FaultTolerantLoop(lambda: _make_trainer(batch=56), str(tmp_path / "ck"),
                             save_every=50, fault_hook=hook, elastic=coord)
    trainer = loop.run(_elastic_batch, steps=8)
    c = stats.ELASTIC_COUNTERS
    assert c["shrinks"] == 1 and c["grow_abandons"] == 1
    assert loop.recoveries == 0 and c["restart_fallbacks"] == 0
    assert trainer.dist.topology.world_size == 7 and elastic.active_devices() is not None


def test_capacity_budget_escalates_to_restart(tmp_path):
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    armed = [0]

    def hook(step, attempt):
        if step == 2 and armed[0] == 0:
            armed[0] = 1
            raise MLSLDeviceLossError("half the pod preempted", devices=range(3, 8))

    coord = elastic.ElasticCoordinator(capacity_budget=2)
    loop = FaultTolerantLoop(lambda: _make_trainer(batch=24), str(tmp_path / "ck"),
                             save_every=2, fault_hook=hook, elastic=coord)
    trainer = loop.run(lambda t, s: _batch(t, s), steps=4)
    assert loop.recoveries == 1 and trainer.dist.topology.world_size == 8
    c = stats.ELASTIC_COUNTERS
    assert c["restart_fallbacks"] == 1 and c["shrinks"] == 0
    assert elastic.active_devices() is None


def test_kernel_error_in_the_drain_raises_out_of_the_loop(tmp_path, monkeypatch):
    """A drain whose kernel cannot launch raises MLSLKernelError: no restart
    rung, no plain version in its place."""
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    def broken(*a, **k):
        raise MLSLKernelError("dense_ring_gather: launch failed")

    monkeypatch.setattr(optim, "gather_owned_full", broken)

    def hook(step, attempt):
        if step == 1 and attempt == 0:
            raise MLSLDeviceLossError("lost", devices=(7,))

    loop = FaultTolerantLoop(_adam_factory(batch=56), str(tmp_path / "ck"), save_every=1,
                             fault_hook=hook, elastic=elastic.ElasticCoordinator(4))
    with pytest.raises(MLSLKernelError):
        loop.run(_elastic_batch, steps=3)
    assert loop.recoveries == 0 and stats.ELASTIC_COUNTERS["shrinks"] == 0


def test_elastic_soak_fast(tmp_path, monkeypatch):
    """tests/test_soak.py::test_elastic_soak_fast on the port: one device.lost
    at step 3, a shrink at that step, a grow 3 steps later, zero restores;
    each step's global-mean loss tracks the uninterrupted twin's."""
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    monkeypatch.setenv("MLSL_ELASTIC", "1")
    monkeypatch.setenv("MLSL_ELASTIC_GROW_AFTER", "3")

    def run(tag, fault_step=None):
        losses, armed = {}, [False]

        def hook(step, attempt):
            if fault_step is not None and step == fault_step and not armed[0]:
                armed[0] = True
                chaos.plan("device.lost", "error")

        loop = FaultTolerantLoop(lambda: _make_trainer(batch=56), str(tmp_path / tag),
                                 save_every=50, fault_hook=hook)
        trainer = loop.run(_elastic_batch, steps=9, on_step=lambda s, l: losses.__setitem__(
            s, float(l.mean())))
        world = trainer.dist.topology.world_size
        _finalize()
        return loop, losses, world

    _, base, world = run("twin")
    assert world == 8 and stats.ELASTIC_COUNTERS["shrinks"] == 0
    stats.reset_elastic_counters()
    elastic.reset()
    loop, losses, world = run("elastic", fault_step=3)
    c = stats.ELASTIC_COUNTERS
    assert loop.recoveries == 0 and world == 8
    assert (c["device_losses"], c["shrinks"], c["grows"]) == (1, 1, 1) and c["admits"] >= 1
    ks = sorted(losses)
    assert ks == sorted(base) == list(range(9))
    np.testing.assert_allclose([losses[k] for k in ks], [base[k] for k in ks],
                               rtol=2e-3, atol=2e-3)
    text = open(stats.stats_path()).read()
    for word in ("DEVICE_LOSSES", "SHRINKS", "GROWS", "ADMITS"):
        assert word in text


def test_straggler_shed_handoff_into_elastic(tmp_path, monkeypatch):
    """tests/test_soak.py::test_straggler_shed_handoff_into_elastic on the
    port, its timing made deterministic: replica 1 (this process) against a
    replica 0 fed a step time 1e6 times shorter is confirmed slow and handed
    to the elastic coordinator -- world 8 -> 7, zero restores."""
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    monkeypatch.setenv("MLSL_ELASTIC", "1")
    monkeypatch.setenv("MLSL_STRAGGLER_SKEW", "1.5")
    monkeypatch.setenv("MLSL_STRAGGLER_EVERY", "6")
    monkeypatch.setenv("MLSL_STRAGGLER_SUSTAIN", "1")
    monkeypatch.setenv("MLSL_STRAGGLER_SHED", "1")
    box = [None]

    def make_trainer():
        t = _make_trainer(batch=56)
        t._replica_id = 1
        box[0] = t
        return t

    losses = {}

    def on_step(step, loss):
        losses[step] = float(loss.mean())
        t = box[0]
        if t.straggler is not None and t.dist.topology.world_size == 8:
            t.straggler.observe(0, 1e-6)

    loop = FaultTolerantLoop(make_trainer, str(tmp_path / "shed"), save_every=50)
    final = loop.run(_elastic_batch, steps=10, on_step=on_step)
    assert final.dist.topology.world_size == 7 and loop.recoveries == 0
    assert elastic.active_devices() == (0, 2, 3, 4, 5, 6, 7)
    assert stats.STRAGGLER_COUNTERS["sheds"] == 1 and stats.ELASTIC_COUNTERS["shrinks"] == 1
    assert sorted(losses) == list(range(10))
    text = open(stats.stats_path()).read()
    assert "STRAGGLER" in text and "SHEDS" in text.upper() and "ELASTIC" in text


# -- the tuned profile and the checkpoint across a world change -----------------------


def test_stale_profile_rejected_after_world_change(tmp_path, monkeypatch, caplog):
    from mlsl_tpu_torch import sysinfo

    full_fp = sysinfo.topology_fingerprint(8, "cpu")
    path = tmp_path / "prof.json"
    path.write_text(json.dumps({"version": 1, "fingerprint": full_fp, "created": "",
                                "cells": [{"kind": "allreduce", "shape": [8],
                                           "compression": "none", "max_bytes": None,
                                           "algo": "rhd"}], "knobs": {}}))
    monkeypatch.setenv("MLSL_TUNE_PROFILE", str(path))
    env = Environment.get_env().init(device="cpu")
    assert env.config.tuned_profile is not None
    env.finalize()
    elastic._set_active(tuple(range(6)))
    env = Environment.get_env().init(device="cpu")
    assert env.world_size == 6 and env.config.tuned_profile is None
    assert "different topology" in caplog.text


def test_fingerprint_tracks_the_active_world():
    from mlsl_tpu_torch import sysinfo

    assert sysinfo.topology_fingerprint(8, "cpu")["num_devices"] == 8
    assert sysinfo.topology_fingerprint(6, "cpu") != sysinfo.topology_fingerprint(8, "cpu")


def test_checkpoint_records_world_and_warns_on_mismatch(tmp_path, caplog):
    from mlsl_tpu_torch.checkpoint import CheckpointManager, restore_trainer, save_trainer

    trainer = _make_trainer()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    save_trainer(mgr, trainer, step=0, wait=True)
    assert mgr.recorded_world(0) == 8
    Environment.get_env().finalize()
    elastic._set_active((0, 1, 2, 3))
    t2 = _make_trainer(batch=16)
    assert restore_trainer(CheckpointManager(str(tmp_path / "ck")), t2) == 0
    assert "world size 8" in caplog.text and "active world is 4" in caplog.text
