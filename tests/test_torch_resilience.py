"""The port's FaultTolerantLoop and PreemptionGuard (mlsl_tpu_torch.resilience)
against the JAX package's: tests/test_resilience.py (5), the loop matrix's
checkpoint rows (tests/test_chaos.py SITE_CONFIGS), the integrity layer's
hooks in the loop (the per-step audit, the verified checkpoint, the
post-restore re-audit) and the fast soaks of tests/test_soak.py that drive
the loop.

On the same fault schedule both loops take the same recoveries, resume at
the same step and fire ``on_step`` in the same sequence; the final
parameters agree within rtol/atol 1e-6 (the two packages sum in another
order), and each package's recovered run is bit for bit its own fault-free
twin. The soaks hold the port's seeded chaotic run bit for bit against the
port's own fault-free twin, as the JAX soaks hold theirs.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu import chaos as jchaos
from mlsl_tpu.core import stats as jstats
from mlsl_tpu.core.environment import Environment as JEnvironment
from mlsl_tpu_torch import chaos, supervisor
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError, MLSLIntegrityError, MLSLKernelError

torch.set_num_threads(2)

#: the two packages' parameters after the same steps (sums in another order)
RTOL = ATOL = 1e-6


def _finalize():
    if JEnvironment._instance is not None:
        JEnvironment._instance.finalize()
    if Environment._instance is not None:
        Environment._instance.finalize()


@pytest.fixture(autouse=True)
def _isolated():
    jchaos.clear()
    supervisor.reset_all()
    jstats.reset_sentinel_counters()
    yield
    _finalize()
    supervisor.reset_all()
    jchaos.clear()
    jstats.reset_sentinel_counters()


def _jfactory(optimizer=None, batch=16):
    from mlsl_tpu.models.mlp import LAYERS, get_layer, init, loss_fn
    from mlsl_tpu.models.train import DataParallelTrainer

    def make():
        env = JEnvironment.get_env().init()
        dist = env.create_distribution(env.get_process_count(), 1)
        sess = env.create_session()
        sess.set_global_minibatch_size(batch)
        kw = {"optimizer": optimizer()} if optimizer else {}
        return DataParallelTrainer(env, dist, sess, init(jax.random.PRNGKey(0)), loss_fn,
                                   LAYERS, get_layer, lr=0.1, **kw)

    return make


def _tfactory(optimizer=None, batch=16, **kw):
    from mlsl_tpu.models.mlp import init
    from mlsl_tpu_torch.models import mlp as tmlp
    from mlsl_tpu_torch.models.convert import params_from_jax
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    host = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))

    def make():
        env = Environment.get_env().init(device="cpu")
        dist = env.create_distribution(env.get_process_count(), 1)
        sess = env.create_session()
        sess.set_global_minibatch_size(batch)
        if optimizer:
            kw["optimizer"] = optimizer()
        return DataParallelTrainer(env, dist, sess,
                                   tmlp.MLP(device="cpu", params=params_from_jax(host, "cpu")),
                                   tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1, **kw)

    return make


def _batch_fn(trainer, step, batch=16):
    rng = np.random.default_rng(step)
    return trainer.shard_batch(rng.normal(size=(batch, 8)).astype(np.float32),
                               rng.integers(0, 4, size=(batch,)).astype(np.int32))


def _jparams(trainer):
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(trainer.params))]


def _tparams(trainer):
    from mlsl_tpu_torch.models.convert import params_to_jax

    return [np.asarray(x) for x in jax.tree.leaves(params_to_jax(trainer.model))]


def _both(tmp_path, steps, optimizer=None, batch_fn=_batch_fn, tag="", **kw):
    """The same loop in both packages -> {pkg: (loop, on_step seq, params)}."""
    from mlsl_tpu.resilience import FaultTolerantLoop as JLoop
    from mlsl_tpu_torch.resilience import FaultTolerantLoop as TLoop

    jopt = topt = None
    if optimizer == "adam":
        import optax

        from mlsl_tpu_torch import optim

        jopt, topt = (lambda: optax.adam(1e-3)), (lambda: optim.adam(1e-3))
    out = {}
    for name, cls, factory, params in (("jax", JLoop, _jfactory(jopt), _jparams),
                                       ("port", TLoop, _tfactory(topt), _tparams)):
        loop = cls(factory, str(tmp_path / f"{name}{tag}"), **kw)
        seen = []
        trainer = loop.run(batch_fn, steps=steps, on_step=lambda s, l: seen.append(s))
        out[name] = (loop, seen, params(trainer))
        _finalize()
    return out


def _agree(out):
    (jl, js, jp), (tl, ts, tp) = out["jax"], out["port"]
    assert ts == js
    assert tl.recoveries == jl.recoveries
    assert tl.preempted == jl.preempted
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# -- tests/test_resilience.py ---------------------------------------------------------


def test_recovers_from_transient_fault(tmp_path):
    def fault_once(step, attempt):
        if step == 5 and attempt == 0:
            raise RuntimeError("injected transient device loss")

    out = _both(tmp_path, 8, save_every=2, fault_hook=fault_once)
    _agree(out)
    loop, seen, params = out["port"]
    assert loop.recoveries == 1
    # restored from the step-4 checkpoint and replayed step 5
    assert seen.count(5) == 1 and seen[-1] == 7
    assert all(np.isfinite(p).all() for p in params)


def test_persistent_poison_reraises(tmp_path):
    from mlsl_tpu.log import MLSLError as JMLSLError

    def always_fault(step, attempt):
        if step == 3:
            raise (JMLSLError if always_fault.jax else MLSLError)("deterministic poison")

    from mlsl_tpu.resilience import FaultTolerantLoop as JLoop
    from mlsl_tpu_torch.resilience import FaultTolerantLoop as TLoop

    rec = {}
    for name, cls, factory, exc in (("jax", JLoop, _jfactory(), JMLSLError),
                                    ("port", TLoop, _tfactory(), MLSLError)):
        always_fault.jax = name == "jax"
        loop = cls(factory, str(tmp_path / name), save_every=1, max_retries=2,
                   fault_hook=always_fault)
        with pytest.raises(exc):
            loop.run(_batch_fn, steps=6)
        rec[name] = loop.recoveries
        _finalize()
    assert rec["port"] == rec["jax"] == 2   # retried max_retries times


def test_poison_far_from_checkpoint_no_livelock(tmp_path):
    """Deterministic poison several steps past the last checkpoint re-raises
    after max_retries in both packages (retries keyed to the failing step)."""
    def poison(step, attempt):
        if step == 5:
            raise RuntimeError("deterministic poison far from checkpoint")

    from mlsl_tpu.resilience import FaultTolerantLoop as JLoop
    from mlsl_tpu_torch.resilience import FaultTolerantLoop as TLoop

    rec = {}
    for name, cls, factory in (("jax", JLoop, _jfactory()), ("port", TLoop, _tfactory())):
        loop = cls(factory, str(tmp_path / name), save_every=10, max_retries=2,
                   fault_hook=poison)
        with pytest.raises(RuntimeError, match="poison"):
            loop.run(_batch_fn, steps=8)
        rec[name] = loop.recoveries
        _finalize()
    assert rec["port"] == rec["jax"] == 2


def test_replayed_steps_not_rereported(tmp_path):
    def fault_once(step, attempt):
        if step == 5 and attempt == 0:
            raise RuntimeError("transient, far from checkpoint")

    out = _both(tmp_path, 8, save_every=4, fault_hook=fault_once)
    _agree(out)
    assert out["port"][1] == list(range(8))
    assert out["port"][0].recoveries == 1


def test_resume_across_loop_instances(tmp_path):
    first = _both(tmp_path, 4, save_every=1)
    second = _both(tmp_path, 7, save_every=1)
    _agree(first)
    _agree(second)
    assert first["port"][1] == [0, 1, 2, 3]
    assert second["port"][1] == [4, 5, 6]   # resumed after the last checkpoint


# -- the loop matrix's checkpoint rows (tests/test_chaos.py SITE_CONFIGS) -------------


@pytest.mark.parametrize("site", ["checkpoint.save", "checkpoint.restore"])
def test_fault_matrix_checkpoint_sites(tmp_path, site):
    """An error at the checkpoint sites, armed at step 3 from the fault hook,
    is recovered by the loop (a restore-site fault during the recovery it
    triggers falls back to the next verified step) and both packages end on
    the same trajectory; each recovered run is bit for bit its fault-free
    twin."""
    armed = {"jax": False, "port": False}

    def hook_for(name, mod):
        def arm(step, attempt):
            if step == 3 and attempt == 0 and not armed[name]:
                armed[name] = True
                mod.plan(site, "error")
                if site == "checkpoint.restore":
                    raise RuntimeError("trigger recovery to reach restore")
        return arm

    from mlsl_tpu.resilience import FaultTolerantLoop as JLoop
    from mlsl_tpu_torch.resilience import FaultTolerantLoop as TLoop

    base = _both(tmp_path, 8, save_every=2, tag="base")
    out = {}
    for name, cls, factory, params, mod in (
            ("jax", JLoop, _jfactory(), _jparams, jchaos),
            ("port", TLoop, _tfactory(), _tparams, chaos)):
        loop = cls(factory, str(tmp_path / name), save_every=2, max_retries=3,
                   fault_hook=hook_for(name, mod))
        seen = []
        trainer = loop.run(_batch_fn, steps=8, on_step=lambda s, l: seen.append(s))
        out[name] = (loop, seen, params(trainer))
        _finalize()
        assert loop.recoveries >= 1, f"fault at {site} never took the recovery path"
        for a, b in zip(out[name][2], base[name][2]):
            np.testing.assert_array_equal(a, b)
    _agree(out)


# -- the integrity layer in the loop (A.7b's hooks) -----------------------------------


def test_audit_each_step_verified_manifests_and_reaudit(tmp_path, monkeypatch):
    """MLSL_SENTINEL_EVERY=1: the loop audits every step, every checkpoint's
    manifest records the passing audit's fingerprint (a VERIFIED step), and
    the restore after a fault is re-audited against it -- the same counts,
    manifest keys and verdicts in both packages."""
    monkeypatch.setenv("MLSL_SENTINEL_EVERY", "1")

    def fault_once(step, attempt):
        if step == 5 and attempt == 0:
            raise RuntimeError("transient")

    out = _both(tmp_path, 8, save_every=2, fault_hook=fault_once)
    _agree(out)
    counts = {}
    for name, mod in (("jax", jstats), ("port", stats)):
        loop = out[name][0]
        c = mod.SENTINEL_COUNTERS
        counts[name] = (c["audits"], c["verified_saves"], c["reaudits"], c["audit_mismatch"])
        mans = {}
        for s in loop.ckpt.all_steps():
            with open(loop.ckpt._manifest_path(s)) as f:
                m = json.load(f)
            mans[s] = (sorted(m), loop.ckpt.verify(s), len(m["sentinel"]["fingerprint"]))
        counts[name] += (mans,)
    assert counts["port"] == counts["jax"]
    audits, verified, reaudits, mismatch, mans = counts["port"]
    assert reaudits == 1 and mismatch == 0 and verified == 4   # saves at 0, 2, 4, 6
    assert all(keys == ["files", "sentinel", "step", "world", "written_at"]
               for keys, _, _ in mans.values())


def test_reaudit_refuses_a_restore_that_misses_its_fingerprint(tmp_path, monkeypatch):
    """A checkpoint whose recorded fingerprint no longer matches what it
    restores is refused with MLSLIntegrityError in both packages."""
    from mlsl_tpu.log import MLSLIntegrityError as JIntegrity
    from mlsl_tpu.resilience import FaultTolerantLoop as JLoop
    from mlsl_tpu_torch.resilience import FaultTolerantLoop as TLoop

    monkeypatch.setenv("MLSL_SENTINEL_EVERY", "1")
    for name, cls, factory, exc in (("jax", JLoop, _jfactory(), JIntegrity),
                                    ("port", TLoop, _tfactory(), MLSLIntegrityError)):
        def hook(step, attempt, box={}):
            if step == 3 and attempt == 0:
                loop = box["loop"]
                loop.ckpt.wait()
                for s in loop.ckpt.all_steps():
                    p = loop.ckpt._manifest_path(s)
                    m = json.load(open(p))
                    m["sentinel"]["fingerprint"] = "0" * 64
                    json.dump(m, open(p, "w"))
                raise RuntimeError("transient")

        loop = cls(factory, str(tmp_path / name), save_every=2, fault_hook=hook)
        hook.__defaults__[0]["loop"] = loop
        with pytest.raises(exc, match="post-restore re-audit failed"):
            loop.run(_batch_fn, steps=6)
        _finalize()


def test_restart_budget_from_the_environment(tmp_path, monkeypatch):
    """MLSL_RESTART_BUDGET bounds the run's recoveries (a fault on a new step
    each time), and an invalid value raises MLSLError, in both packages."""
    from mlsl_tpu.log import MLSLError as JMLSLError
    from mlsl_tpu.resilience import FaultTolerantLoop as JLoop
    from mlsl_tpu_torch.resilience import FaultTolerantLoop as TLoop

    monkeypatch.setenv("MLSL_RESTART_BUDGET", "-1")
    for cls, exc in ((JLoop, JMLSLError), (TLoop, MLSLError)):
        with pytest.raises(exc, match="MLSL_RESTART_BUDGET"):
            cls(lambda: None, str(tmp_path / "bad"))
    monkeypatch.setenv("MLSL_RESTART_BUDGET", "1")

    def fault_twice(step, attempt):
        if step in (2, 4) and attempt == 0:
            raise RuntimeError(f"fault at {step}")

    rec = {}
    for name, cls, factory in (("jax", JLoop, _jfactory()), ("port", TLoop, _tfactory())):
        loop = cls(factory, str(tmp_path / name), save_every=1, fault_hook=fault_twice)
        assert loop.max_total_recoveries == 1
        with pytest.raises(RuntimeError, match="fault at 4"):
            loop.run(_batch_fn, steps=6)
        rec[name] = loop.recoveries
        _finalize()
    assert rec["port"] == rec["jax"] == 1


def test_kernel_error_is_never_recovered(tmp_path):
    """MLSLKernelError (a kernel that cannot be built or launched) raises out
    of the loop at once: no restart replays it, no plain version serves."""
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    def hook(step, attempt):
        if step == 2:
            raise MLSLKernelError("dense_ring: launch failed")

    loop = FaultTolerantLoop(_tfactory(), str(tmp_path / "ck"), save_every=1,
                             fault_hook=hook)
    with pytest.raises(MLSLKernelError):
        loop.run(_batch_fn, steps=4)
    assert loop.recoveries == 0


def test_abort_leaves_a_flight_record(tmp_path, caplog):
    """An exhausted ladder logs the error class and the breaker states and,
    with the tracer armed, writes a flight record."""
    from mlsl_tpu_torch import obs
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    obs.enable(capacity=4096)

    def poison(step, attempt):
        if step == 1:
            raise RuntimeError("poison")

    loop = FaultTolerantLoop(_tfactory(), str(tmp_path / "ck"), save_every=1, max_retries=0,
                             fault_hook=poison)
    with pytest.raises(RuntimeError):
        loop.run(_batch_fn, steps=3)
    err = caplog.text
    assert "recovery ladder exhausted at step 1" in err and "class=persistent" in err
    assert "abort flight record written" in err


def test_preemption_guard_restores_the_handler():
    import signal

    from mlsl_tpu_torch.resilience import PreemptionGuard

    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert signal.getsignal(signal.SIGTERM) == g._on_signal
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.triggered
    assert signal.getsignal(signal.SIGTERM) == before


# -- tests/test_soak.py's fast soaks that drive the loop --------------------------------


@pytest.fixture()
def soak_env(monkeypatch):
    monkeypatch.setenv("MLSL_GRAD_BUCKET_MB", "1")
    monkeypatch.setenv("MLSL_COMM_RETRIES", "2")
    monkeypatch.setenv("MLSL_COMM_RETRY_BACKOFF_S", "0.01")
    monkeypatch.setenv("MLSL_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("MLSL_BREAKER_WINDOW_S", "120")
    monkeypatch.setenv("MLSL_BREAKER_COOLDOWN_S", "0.2")


def _soak_run(tmp_path, tag, steps, budget=40):
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    losses = {}
    loop = FaultTolerantLoop(_tfactory(), str(tmp_path / tag), save_every=5, max_retries=8,
                             max_total_recoveries=budget)
    trainer = loop.run(_batch_fn, steps=steps,
                       on_step=lambda s, l: losses.__setitem__(s, float(l.reshape(-1)[0])))
    params = _tparams(trainer)
    _finalize()
    return loop, params, losses


SOAK_PLANS = (
    dict(site="collective.dispatch", kind="error", exc=OSError, times=None, prob=0.10),
    dict(site="request.wait", kind="error", exc=OSError, times=None, prob=0.04),
    dict(site="request.start", kind="error", times=None, prob=0.01),
    dict(site="checkpoint.save", kind="error", exc=OSError, times=None, prob=0.10),
)


def test_soak_fast_bounded(tmp_path, soak_env):
    """tests/test_soak.py::test_soak_fast_bounded on the port: a seeded mix
    at four sites, the checkpoint save among them; the run completes and its
    losses and parameters are bit for bit the fault-free twin's."""
    _, base_params, base_losses = _soak_run(tmp_path, "base", 30)
    stats.reset_degrade_counters()
    supervisor.reset()
    chaos.seed(1234)
    plans = [chaos.plan(**kw) for kw in SOAK_PLANS]
    try:
        loop, params, losses = _soak_run(tmp_path, "soak", 30)
    finally:
        chaos.clear()
    assert sum(p.fires for p in plans) > 0
    assert losses == base_losses
    for a, b in zip(params, base_params):
        np.testing.assert_array_equal(a, b)
    c = stats.DEGRADE_COUNTERS
    assert c["comm_retries"] > 0
    assert loop.recoveries == c["recoveries"]


def test_silent_soak_fast(tmp_path, monkeypatch):
    """tests/test_soak.py::test_silent_soak_fast on the port, its gate half:
    NaN gradients under ``rollback``; every detection restores a VERIFIED
    step and is re-audited, and the run ends bit for bit on the fault-free
    twin. The JAX soak's second plan (a perturbed replica caught by the
    audit) has no counterpart: the port keeps one copy of the replicated
    parameters, which the audit's per-rank comparison cannot find apart
    (ROADMAP, standing differences; tests/test_torch_integrity.py)."""
    monkeypatch.setenv("MLSL_SENTINEL_GATE", "rollback")
    monkeypatch.setenv("MLSL_SENTINEL_EVERY", "1")
    monkeypatch.setenv("MLSL_SENTINEL_SPIKE", "1e6")
    monkeypatch.setenv("MLSL_SENTINEL_ZMAX", "50")
    _, base_params, base_losses = _soak_run(tmp_path, "base", 13)
    c = stats.SENTINEL_COUNTERS
    assert c["gate_rollback"] == c["audit_mismatch"] == 0 and c["screened"] >= 13
    stats.reset_sentinel_counters()
    chaos.seed(2718)
    plan = chaos.plan("train.grads", "silent", mag=float("nan"), times=None, prob=0.08)
    try:
        loop, params, losses = _soak_run(tmp_path, "silent", 13)
    finally:
        chaos.clear()
    assert plan.fires > 0
    assert c["gate_rollback"] == plan.fires == loop.recoveries
    assert c["reaudits"] == loop.recoveries and c["audit_mismatch"] == 0
    assert losses == base_losses
    for a, b in zip(params, base_params):
        np.testing.assert_array_equal(a, b)
