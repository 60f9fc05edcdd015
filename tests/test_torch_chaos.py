"""The port's fault injection (mlsl_tpu_torch.chaos) and its sites against
the JAX package's, mirroring tests/test_chaos.py (its checkpoint tests,
:269-382, are tests/test_torch_checkpoint.py; the loop matrix's checkpoint
rows tests/test_torch_resilience.py; the control sites'
tests/test_torch_control.py).

- The registry, kinds, grammar and parsed plans equal the JAX package's.
- The fault matrix: a fault at every site of a training step, armed at a
  step of an MLP training run, is recovered by restarting the run from its
  initial state (a fresh Environment and trainer), and the final parameters equal the
  fault-free run's bit for bit; the fault-free port run is held to the JAX
  package's within rtol/atol 1e-6, as tests/test_torch_bucketing.py holds the
  trainer.
- The watchdog trips on a hang at the dispatch layer within the configured
  timeout (an injected schedule: the timeout 0.5 s, the hang 8 s, the trip
  asserted under 4 s, an eightfold margin), keeps the event record and writes
  the flight record.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu import chaos as jchaos
from mlsl_tpu.models.mlp import LAYERS, get_layer as jget_layer, init as mlp_init
from mlsl_tpu.models.mlp import loss_fn as jmlp_loss
from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
from mlsl_tpu_torch import chaos, supervisor
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLDeviceLossError, MLSLTimeoutError
from mlsl_tpu_torch.models import mlp as tmlp
from mlsl_tpu_torch.models.convert import params_from_jax, params_to_jax
from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer
from mlsl_tpu_torch.types import CompressionType

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _isolated():
    jchaos.clear()
    supervisor.reset_all()
    yield
    supervisor.reset_all()
    jchaos.clear()


# -- the registry ------------------------------------------------------------------


def test_registry_matches_jax():
    assert chaos.SITES == jchaos.SITES
    assert chaos.KINDS == jchaos.KINDS
    assert set(chaos._EXC_NAMES) == set(jchaos._EXC_NAMES)


SPECS = [
    "request.start:error=oserror@2x3,checkpoint.save:bitrot,"
    "request.wait:delay=0.25x*,collective.dispatch:hang=8",
    "collective.dispatch:error%0.05,request.wait:error=oserrorx*%0.5,"
    "data.prefetch:delay=0.01@2x3%0.25",
    "train.grads:silent=nan,device.lost:error@1x2,serve.decode:error=runtimeerrorx*",
]


@pytest.mark.parametrize("spec", SPECS, ids=["basic", "prob", "sites"])
def test_env_spec_round_trip_matches_jax(spec):
    def key(p):
        mag = None if p.mag is None or p.mag != p.mag else p.mag
        return (p.site, p.kind, p.exc.__name__, p.seconds, p.after, p.times, p.prob,
                mag, p.mag is not None and p.mag != p.mag)

    assert sorted(map(key, chaos.refresh_from_env(spec))) == \
        sorted(map(key, jchaos.refresh_from_env(spec)))
    chaos.clear()
    assert not chaos.active()


def test_refresh_from_env_reads_the_variable(monkeypatch):
    monkeypatch.setenv("MLSL_CHAOS", "request.start:error=oserror@2x3")
    monkeypatch.setenv("MLSL_CHAOS_SEED", "5")
    (p,) = chaos.refresh_from_env()
    assert (p.site, p.exc, p.after, p.times) == ("request.start", OSError, 2, 3)


def test_unknown_site_and_kind_rejected():
    with pytest.raises(ValueError, match="unknown chaos site"):
        chaos.plan("request.strat")
    with pytest.raises(ValueError, match="unknown chaos kind"):
        chaos.plan("request.start", kind="explode")
    with pytest.raises(ValueError, match="unknown exception"):
        chaos.refresh_from_env("request.start:error=kaboom")


def test_device_lost_defaults_to_device_loss():
    p = chaos.plan("device.lost", "error")
    assert p.exc is MLSLDeviceLossError
    with pytest.raises(MLSLDeviceLossError):
        chaos.inject("device.lost")


def test_after_times_and_kind_filter():
    """``@after`` skips hits, ``xN`` caps fires, ``kinds`` leaves another
    consumer's plan untouched -- counted as the JAX registry counts."""
    for mod in (chaos, jchaos):
        p = mod.plan("request.start", "error", after=2, times=2)
        s = mod.plan("request.start", "silent")
        raised = []
        for _ in range(6):
            try:
                mod.inject("request.start", kinds=("error",))
                raised.append(0)
            except mod.ChaosError:
                raised.append(1)
        assert raised == [0, 0, 1, 1, 0, 0]
        assert (p.hits, p.fires, s.hits, s.fires) == (6, 2, 0, 0)
        mod.clear()


def test_quiet_and_delay_hang():
    p = chaos.plan("request.start", "error", times=None)
    with chaos.quiet():
        assert chaos.inject("request.start") is None
    assert p.hits == 0
    chaos.clear()
    with chaos.injected("request.wait", "delay", seconds=0.01) as d:
        t0 = time.monotonic()
        assert chaos.inject("request.wait") is d
        assert time.monotonic() - t0 >= 0.01
    h = chaos.plan("request.wait", "hang", seconds=30)
    chaos.remove(h)   # a cancelled hang returns at once
    t0 = time.monotonic()
    assert chaos.inject("request.wait") is None
    assert time.monotonic() - t0 < 3


def test_fired_site_lands_on_the_timeline():
    from mlsl_tpu_torch import obs

    obs.enable(capacity=64)
    chaos.plan("request.start", "delay", seconds=0.0)
    chaos.inject("request.start")
    ev = [e for e in obs.get_tracer().snapshot() if e[1] == "chaos.fired"]
    assert ev and ev[0][7]["site"] == "request.start"


# -- the fault matrix --------------------------------------------------------------

# site -> (trainer config, the step at which the fault is armed), as
# SITE_CONFIGS of tests/test_chaos.py for the sites this slice wires
SITE_CONFIGS = {
    "request.start": ("plain", 3),
    "request.wait": ("plain", 3),
    "request.test": ("overlap", 3),
    "collective.dispatch": ("plain", 3),
    "codec.roundtrip": ("quant", 0),
    "data.prefetch": ("plain", 3),
    "device.lost": ("plain", 3),
}
# consumed by the trainer (train.*: tests/test_torch_integrity.py), by the
# recovery and control layers (tests/test_torch_resilience.py,
# tests/test_torch_control.py) and by the serving engine
# (tests/test_torch_serve.py)
LATER_SITES = {"checkpoint.save", "checkpoint.restore", "train.params", "train.opt_state",
               "train.grads", "control.heartbeat", "control.notice"}
SERVE_SITES = {"serve.admit", "serve.decode"}
STEPS = 8


def test_matrix_covers_every_registered_site():
    assert set(SITE_CONFIGS) | LATER_SITES | SERVE_SITES == set(chaos.SITES)
    assert not (set(SITE_CONFIGS) & (LATER_SITES | SERVE_SITES))


def _host_batch(step):
    rng = np.random.default_rng(step)
    return (rng.normal(size=(16, 8)).astype(np.float32),
            rng.integers(0, 4, size=(16,)).astype(np.int32))


def _make_trainer(cfg):
    env = Environment.get_env().init(device="cpu", world_size=8)
    dist = env.create_distribution(8, 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(16)
    kw = {}
    if cfg == "quant":
        kw["compression"] = CompressionType.QUANTIZATION
    elif cfg == "overlap":
        kw["overlap_updates"] = True
    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    return TTrainer(env, dist, sess, tmlp.MLP(device="cpu", params=params_from_jax(host, "cpu")),
                    tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1, force_graph_path=True,
                    **kw)


def _loader(trainer, start):
    from mlsl_tpu_torch.data import AsyncLoader

    box = {"i": start}

    def read():
        x, y = _host_batch(box["i"])
        box["i"] += 1
        return x, y

    return AsyncLoader(read, place=lambda x, y: trainer.shard_batch(x, y), depth=2)


def _run(cfg, arm=None, via_loader=False, max_restarts=3):
    """STEPS steps; a failure restarts the run from its initial state (a
    fresh Environment and trainer, the step-0 checkpoint). ``arm(step,
    attempt)`` is called before each step. -> (final params, restarts)."""
    restarts = 0
    while True:
        trainer = _make_trainer(cfg)
        loader = _loader(trainer, 0) if via_loader else None
        try:
            for step in range(STEPS):
                if arm is not None:
                    arm(step, restarts)
                batch = next(loader) if loader else trainer.shard_batch(*_host_batch(step))
                trainer.step(batch)
            out = params_to_jax(trainer.model)
            return out, restarts
        except (RuntimeError, OSError) as e:
            restarts += 1
            assert restarts <= max_restarts, f"unrecovered: {e!r}"
        finally:
            if loader is not None:
                loader.close()
            Environment.get_env().finalize()


_BASE = {}


def _baseline(cfg):
    if cfg not in _BASE:
        _BASE[cfg] = _run(cfg)[0]
    return _BASE[cfg]


def _assert_params_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_fault_free_baseline_matches_jax(env):
    """The matrix's fault-free port run against the JAX package's trainer on
    the same batches (rtol/atol 1e-6)."""
    dist = env.create_distribution(8, 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(16)
    jt = JTrainer(env, dist, sess, mlp_init(jax.random.PRNGKey(0)), jmlp_loss, LAYERS,
                  jget_layer, lr=0.1, force_graph_path=True, donate_params=False)
    for step in range(STEPS):
        jt.step(jt.shard_batch(*_host_batch(step)))
    want = jax.device_get(jt.params)
    got = _baseline("plain")
    for layer in LAYERS:
        for g, w in zip(jax.tree.leaves(got[layer]), jax.tree.leaves(want[layer])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("site", sorted(SITE_CONFIGS))
def test_fault_matrix(site):
    """A fault injected at every site this slice wires is recovered by a
    restart and the final parameters equal the fault-free run's bit for bit."""
    cfg, arm_step = SITE_CONFIGS[site]
    base = _baseline(cfg)
    armed = {"plan": None}

    def arm(step, attempt):
        if step == arm_step and attempt == 0 and armed["plan"] is None:
            armed["plan"] = chaos.plan(site, "error")

    try:
        got, restarts = _run(cfg, arm, via_loader=site == "data.prefetch")
    finally:
        if site == "data.prefetch":
            # the loader's stall and back-pressure waits are process-wide
            # FEED counts: leave none for a later test's table
            from mlsl_tpu_torch.core import stats

            stats.reset_feed_counters()
    assert armed["plan"] is not None and armed["plan"].fires == 1
    assert restarts >= 1, f"fault at {site} never took the recovery path"
    _assert_params_equal(base, got)


# -- the watchdog ------------------------------------------------------------------


def test_watchdog_trips_on_synthetic_hang(tmp_path):
    """A hang at the dispatch layer, on the progress thread, trips the
    watchdog within the timeout: MLSLTimeoutError, the stuck descriptor in
    the event record and the WATCHDOG line, and -- the tracer armed -- a
    flight record that holds the request's spans and the trip."""
    from mlsl_tpu_torch import obs
    from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
    from mlsl_tpu_torch.core import stats
    from mlsl_tpu_torch.types import DataType, ReductionType

    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        env.config.msg_priority = True
        env.config.msg_priority_threshold = 0    # defer everything
        env.config.msg_priority_flush_ms = 1.0   # the progress thread takes it fast
        env.config.watchdog_timeout_s = 0.5
        dist = env.create_distribution(8, 1)
        req = CommRequest(CommDesc("allreduce", dist.data_group, 4, DataType.FLOAT,
                                   op=ReductionType.SUM), env.dispatcher, name="hangcheck")
        req.setup()
        buf = dist.make_buffer(lambda p: np.full(4, 1.0), 4)
        obs.enable(capacity=4096)
        before = len(stats.WATCHDOG_EVENTS)
        with chaos.injected("collective.dispatch", "hang", seconds=8):
            req.start(buf)
            time.sleep(0.3)
            t0 = time.monotonic()
            with pytest.raises(MLSLTimeoutError, match="watchdog"):
                req.wait()
            assert time.monotonic() - t0 < 4
        evts = list(stats.WATCHDOG_EVENTS)[before:]
        assert evts and "allreduce" in evts[-1]["descriptor"]
        assert "hangcheck" in evts[-1]["descriptor"] and evts[-1]["phase"] == "dispatch"
        doc = json.loads(open(evts[-1]["flight_record"]).read())
        names = [e["name"] for e in doc["traceEvents"]]
        assert "watchdog.trip" in names and "submit" in names and "chaos.fired" in names
        assert doc["otherData"]["kind"] == "flight_record"
        assert "WATCHDOG" in (tmp_path / "mlsl_stats.log").read_text()
    finally:
        env.config.msg_priority = False
        env.finalize()


def test_watchdog_off_by_default_and_describe():
    from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
    from mlsl_tpu_torch.types import DataType, ReductionType

    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        dist = env.create_distribution(8, 1)
        req = CommRequest(CommDesc("allreduce", dist.data_group, 4, DataType.FLOAT,
                                   op=ReductionType.SUM), env.dispatcher, name="d")
        req.setup()
        assert req._watchdog_deadline(None) is None
        assert req.describe() == (
            f"allreduce name=d algo=lax count=4 dtype=FLOAT axes={dist.data_group.axes} "
            f"payload=16B epoch=0")
    finally:
        env.finalize()


def test_profile_on_trip_writes_a_torch_profiler_trace(monkeypatch, tmp_path):
    """MLSL_PROFILE_ON_TRIP=1: a short torch.profiler trace beside the flight
    record; off by default."""
    from mlsl_tpu_torch.core import stats

    monkeypatch.setenv("MLSL_TRACE_DIR", str(tmp_path))
    assert stats._profile_on_trip("x") is None
    monkeypatch.setenv("MLSL_PROFILE_ON_TRIP", "1")
    out = stats._profile_on_trip("x")
    assert out is not None and json.loads(open(f"{out}/trace.json").read())


def test_profile_failure_never_replaces_the_timeout(monkeypatch):
    from mlsl_tpu_torch.core import stats

    monkeypatch.setenv("MLSL_PROFILE_ON_TRIP", "1")
    monkeypatch.setattr("torch.profiler.profile", None)
    assert stats._profile_on_trip("x") is None
