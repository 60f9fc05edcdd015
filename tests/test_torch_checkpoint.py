"""The port's checkpoints (mlsl_tpu_torch.checkpoint) against the JAX
package's (mlsl_tpu.checkpoint): tests/test_aux.py::TestCheckpoint and
tests/test_chaos.py:269-382, each run through both packages on the same MLP,
the same batches and the same fault schedule.

- The resume steps, the ``on_step`` sequences, the recovery counts and the
  manifests' keys and ``verify`` verdicts are equal; restored parameters are
  bit for bit the saved ones in each package, and the two packages'
  parameters agree within rtol/atol 1e-6 (their sums run in another order).
- The port's own: an async save taken before an in-place Adam step holds the
  pre-step state bit for bit although the step ran before the write ended;
  a failed background write surfaces at the next save; ``max_to_keep`` reaps
  steps and their manifests as the JAX package's does.

The JAX package writes through orbax, the port through ``torch.save``: the
file lists inside the manifests differ by design (ROADMAP, standing
differences), and neither package loads the other's checkpoints.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu import chaos as jchaos
from mlsl_tpu.core.environment import Environment as JEnvironment
from mlsl_tpu_torch import chaos, supervisor
from mlsl_tpu_torch.core.environment import Environment

torch.set_num_threads(2)

#: the two packages' parameters after the same steps (sums in another order)
RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True)
def _isolated():
    jchaos.clear()
    supervisor.reset_all()
    yield
    supervisor.reset_all()
    jchaos.clear()
    if Environment._instance is not None:
        Environment._instance.finalize()


def _host_params():
    from mlsl_tpu.models.mlp import init

    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _jfactory(optimizer=None):
    from mlsl_tpu.models.mlp import LAYERS, get_layer, init, loss_fn
    from mlsl_tpu.models.train import DataParallelTrainer

    def make():
        env = JEnvironment.get_env().init()
        dist = env.create_distribution(8, 1)
        sess = env.create_session()
        sess.set_global_minibatch_size(16)
        kw = {"optimizer": optimizer()} if optimizer else {}
        return DataParallelTrainer(env, dist, sess, init(jax.random.PRNGKey(0)), loss_fn,
                                   LAYERS, get_layer, lr=0.1, **kw)

    return make


def _tfactory(optimizer=None, **kw):
    from mlsl_tpu_torch.models import mlp as tmlp
    from mlsl_tpu_torch.models.convert import params_from_jax
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    host = _host_params()

    def make():
        env = Environment.get_env().init(device="cpu")
        dist = env.create_distribution(env.get_process_count(), 1)
        sess = env.create_session()
        sess.set_global_minibatch_size(16)
        if optimizer:
            kw["optimizer"] = optimizer()
        return DataParallelTrainer(env, dist, sess,
                                   tmlp.MLP(device="cpu", params=params_from_jax(host, "cpu")),
                                   tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1, **kw)

    return make


def _host_batch(step):
    rng = np.random.default_rng(step)
    return (rng.normal(size=(16, 8)).astype(np.float32),
            rng.integers(0, 4, size=(16,)).astype(np.int32))


def _batch_fn(trainer, step):
    return trainer.shard_batch(*_host_batch(step))


def _jparams(trainer):
    return jax.tree.map(np.asarray, jax.device_get(trainer.params))


def _tparams(trainer):
    from mlsl_tpu_torch.models.convert import params_to_jax

    return jax.tree.map(np.asarray, params_to_jax(trainer.model))


def _close(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


def _equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _loops(d, **kw):
    from mlsl_tpu.resilience import FaultTolerantLoop as JLoop
    from mlsl_tpu_torch.resilience import FaultTolerantLoop as TLoop

    opt = kw.pop("optimizer", None)
    jopt = topt = None
    if opt == "adam":
        import optax

        from mlsl_tpu_torch import optim

        jopt, topt = (lambda: optax.adam(1e-3)), (lambda: optim.adam(1e-3))
    return (JLoop(_jfactory(jopt), str(d / "jax"), **kw),
            TLoop(_tfactory(topt), str(d / "port"), **kw))


def _finalize():
    if JEnvironment._instance is not None:
        JEnvironment._instance.finalize()
    if Environment._instance is not None:
        Environment._instance.finalize()


# -- tests/test_aux.py::TestCheckpoint ------------------------------------------------


def test_roundtrip_trainer_state_matches_jax(tmp_path):
    """Save at step 2, train on, restore: both packages roll back exactly,
    and the rolled-back parameters agree."""
    from mlsl_tpu.checkpoint import CheckpointManager as JMgr
    from mlsl_tpu.checkpoint import restore_trainer as jrestore
    from mlsl_tpu.checkpoint import save_trainer as jsave
    from mlsl_tpu_torch.checkpoint import CheckpointManager, restore_trainer, save_trainer

    out = {}
    for name, factory, mgr_cls, save, restore, params in (
            ("jax", _jfactory(), JMgr, jsave, jrestore, _jparams),
            ("port", _tfactory(), CheckpointManager, save_trainer, restore_trainer, _tparams)):
        trainer = factory()
        batch = trainer.shard_batch(*_host_batch(0))
        for _ in range(2):
            trainer.step(batch)
        before = params(trainer)
        mgr = mgr_cls(str(tmp_path / name))
        save(mgr, trainer, step=2, wait=True)
        trainer.step(batch)
        assert restore(mgr, trainer) == 2
        after = params(trainer)
        _equal(before, after)
        mgr.close()
        out[name] = after
    _finalize()
    _close(out["port"], out["jax"])


# -- tests/test_chaos.py:269-382 ------------------------------------------------------


def _manifests(loop):
    out = {}
    for s in loop.ckpt.all_steps():
        with open(loop.ckpt._manifest_path(s)) as f:
            m = json.load(f)
        out[s] = (sorted(m), loop.ckpt.verify(s), m.get("world"))
    return out


def test_corrupt_latest_checkpoint_falls_back(tmp_path):
    """Rotted bytes in the newest step: restore skips it by its manifest and
    resumes from the previous verified step, in both packages."""
    seen = {}
    for loop in _loops(tmp_path, save_every=1):
        loop.run(_batch_fn, steps=4)
        _finalize()
    from mlsl_tpu.resilience import FaultTolerantLoop as JLoop
    from mlsl_tpu_torch.resilience import FaultTolerantLoop as TLoop

    for name, cls, factory in (("jax", JLoop, _jfactory()), ("port", TLoop, _tfactory())):
        loop2 = cls(factory, str(tmp_path / name), save_every=1)
        step_dir = loop2.ckpt._step_dir(3)
        assert step_dir is not None and loop2.ckpt.verify(3) is True
        loop2.ckpt._apply_bitrot(3, step_dir)
        assert loop2.ckpt.verify(3) is False
        seen[name] = []
        loop2.run(_batch_fn, steps=6, on_step=lambda s, l, n=name: seen[n].append(s))
        _finalize()
    assert seen["port"] == seen["jax"] == [3, 4, 5]


def test_chaos_bitrot_manifests_match_jax(tmp_path):
    """The chaos 'bitrot' kind corrupts a committed step AFTER its manifest;
    the manifests carry the same keys and the same verdicts in both
    packages, and the next run falls back past the rotted step."""
    j, t = _loops(tmp_path, save_every=1)
    for loop, mod in ((j, jchaos), (t, chaos)):
        with mod.injected("checkpoint.save", "bitrot", after=3, times=1):
            loop.run(_batch_fn, steps=4)
        _finalize()
    jm, tm = _manifests(j), _manifests(t)
    assert tm == jm
    assert [v for _, v, _ in tm.values()] == [True, True, False]   # steps 1, 2, 3
    assert [k for k, _, _ in tm.values()][0] == ["files", "step", "world", "written_at"]
    seen = {}
    for tag, loop in zip(("jax", "port"), _loops(tmp_path, save_every=1)):
        seen[tag] = []
        loop.run(_batch_fn, steps=6, on_step=lambda s, l, n=tag: seen[n].append(s))
        _finalize()
    assert seen["port"] == seen["jax"] == [3, 4, 5]


def test_save_retries_transient_io_error(tmp_path):
    """Two injected OSErrors at the save site are absorbed by the retries:
    no recovery, the checkpoints land."""
    j, t = _loops(tmp_path, save_every=1)
    for loop, mod in ((j, jchaos), (t, chaos)):
        with mod.injected("checkpoint.save", "error", exc=OSError, times=2):
            loop.run(_batch_fn, steps=3)
        _finalize()
        assert loop.recoveries == 0
        assert loop.ckpt.latest_step() == 2


def test_save_retry_exhaustion_raises(tmp_path):
    """A persistent IO failure exhausts the retries and surfaces as OSError,
    in both packages."""
    j, t = _loops(tmp_path, save_every=1)
    for loop, mod in ((j, jchaos), (t, chaos)):
        with mod.injected("checkpoint.save", "error", exc=OSError, times=None):
            with pytest.raises(OSError):
                loop.run(_batch_fn, steps=3)
        _finalize()
        assert loop.recoveries == 0


def test_async_save_errors_surface(tmp_path, monkeypatch):
    """A failed background write is never mistaken for a committed resume
    point: the next save raises it."""
    from mlsl_tpu_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, {"a": torch.zeros(4)}, wait=True)

    def boom(*a, **k):
        raise RuntimeError("async save failed")

    monkeypatch.setattr(mgr, "_write", boom)
    mgr.save(1, {"a": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="async save failed"):
        mgr.save(2, {"a": torch.zeros(4)})
    assert mgr.all_steps() == [0]


def test_sigterm_drains_and_writes_final_checkpoint(tmp_path):
    """SIGTERM mid-run: one final save at the preempted step, drained and
    verified; a new loop resumes right after it -- in both packages."""
    seen = {}
    j, t = _loops(tmp_path, save_every=10)
    for name, loop in (("jax", j), ("port", t)):
        def on_step(s, l):
            if s == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        loop.run(_batch_fn, steps=8, on_step=on_step)
        assert loop.preempted
        assert loop.ckpt.all_steps() == [0, 2]
        assert loop.ckpt.verify(2) is True
        _finalize()
    j2, t2 = _loops(tmp_path, save_every=10)
    for name, loop in (("jax", j2), ("port", t2)):
        seen[name] = []
        loop.run(_batch_fn, steps=5, on_step=lambda s, l, n=name: seen[n].append(s))
        assert not loop.preempted
        _finalize()
    assert seen["port"] == seen["jax"] == [3, 4]
    _close(_tparams_of(t2), _jparams_of(j2))


def _tparams_of(loop):
    trainer = loop.make_trainer()
    from mlsl_tpu_torch.checkpoint import restore_trainer

    restore_trainer(loop.ckpt, trainer)
    out = _tparams(trainer)
    _finalize()
    return out


def _jparams_of(loop):
    from mlsl_tpu.checkpoint import restore_trainer

    trainer = loop.make_trainer()
    restore_trainer(loop.ckpt, trainer)
    out = _jparams(trainer)
    _finalize()
    return out


# -- the port's own -------------------------------------------------------------------


def test_async_save_holds_the_pre_step_state(tmp_path, monkeypatch):
    """Adam updates its moments in place (optim.py): a save dispatched before
    a step, whose write ends only after the step ran, holds the pre-step
    parameters and Adam state bit for bit (the host snapshot), under ZeRO-1
    and replicated."""
    import threading

    from mlsl_tpu_torch import checkpoint as ck
    from mlsl_tpu_torch import optim
    from mlsl_tpu_torch.sentinel import tree_leaves

    gate = threading.Event()
    real_save = torch.save

    def slow_save(obj, f):
        assert gate.wait(30), "the step never ran"
        real_save(obj, f)

    monkeypatch.setattr(ck.torch, "save", slow_save)
    for zero1 in (True, False):
        trainer = _tfactory(lambda: optim.adam(1e-2), distributed_update=zero1)()
        for s in range(2):
            trainer.step(_batch_fn(trainer, s))
        before = [t.detach().clone() for t in tree_leaves(ck._trainer_state(trainer, 2))
                  if isinstance(t, torch.Tensor)]
        mgr = ck.CheckpointManager(str(tmp_path / f"ck{zero1}"))
        gate.clear()
        ck.save_trainer(mgr, trainer, step=2)
        assert mgr._pending is not None and not mgr._pending.done()
        trainer.step(_batch_fn(trainer, 2))   # Adam in place, during the write
        after = [t for t in tree_leaves(ck._trainer_state(trainer, 2))
                 if isinstance(t, torch.Tensor)]
        assert not all(torch.equal(a, b) for a, b in zip(after, before))
        gate.set()
        mgr.wait()
        fresh = _tfactory(lambda: optim.adam(1e-2), distributed_update=zero1)()
        assert ck.restore_trainer(mgr, fresh) == 2
        got = [t for t in tree_leaves(ck._trainer_state(fresh, 2))
               if isinstance(t, torch.Tensor)]
        assert len(got) == len(before)
        for g, b in zip(got, before):
            assert torch.equal(g, b)
        assert mgr.timings["bytes"] == sum(b.numel() * b.element_size() for b in before)
        mgr.close()
        _finalize()


def test_max_to_keep_reaps_steps_and_manifests_like_jax(tmp_path):
    """Five saves with max_to_keep 3: the same steps and manifests remain."""
    from mlsl_tpu.checkpoint import CheckpointManager as JMgr
    from mlsl_tpu_torch.checkpoint import CheckpointManager

    import jax.numpy as jnp

    jm, tm = JMgr(str(tmp_path / "jax")), CheckpointManager(str(tmp_path / "port"))
    for s in range(5):
        jm.save(s, {"a": jnp.full((4,), float(s))})
        tm.save(s, {"a": torch.full((4,), float(s))})
        jm.wait()
        tm.wait()
    assert tm.all_steps() == sorted(jm.all_steps()) == [2, 3, 4]
    names = sorted(n for n in os.listdir(tm.directory) if n.startswith("manifest-"))
    assert names == sorted(n for n in os.listdir(jm.directory) if n.startswith("manifest-"))
    assert [tm.verify(s) for s in (2, 3, 4)] == [jm.verify(s) for s in (2, 3, 4)] == [True] * 3
    state = tm.restore(3, template={"a": torch.zeros(4)})
    assert torch.equal(state["a"], torch.full((4,), 3.0))
    jm.close()
    tm.close()


def test_restore_lands_on_the_template_device(tmp_path):
    """map_location follows the template: a restore with no tensor in the
    template lands on the CPU; a layout that does not match raises in
    ``_apply_state`` (``restore_trainer`` then falls back)."""
    from mlsl_tpu_torch import checkpoint as ck
    from mlsl_tpu_torch.log import MLSLError

    trainer = _tfactory()()
    mgr = ck.CheckpointManager(str(tmp_path / "ck"))
    ck.save_trainer(mgr, trainer, step=0, wait=True)
    state = mgr.restore(0)
    assert all(t.device.type == "cpu" for t in
               jax.tree.leaves(state["params"], is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert mgr.recorded_world(0) == 8
    state["params"]["l1"] = state["params"]["l1"][:1]
    with pytest.raises(MLSLError, match="layout"):
        ck._apply_state(trainer, state)
    mgr.close()
