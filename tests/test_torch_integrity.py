"""The port's integrity layer (mlsl_tpu_torch.checker, mlsl_tpu_torch.sentinel,
the trainer's hooks) against the JAX package's, after tests/test_aux.py's
TestChecker and tests/test_sentinel.py (its A.7c tests of checkpoints and
rollback loops, :311-416, wait for that slice; its bench smoke times the CPU
and has no counterpart).

The same numpy-seeded inputs go through both packages: the JAX side on the
8-device CPU mesh, the port with ``device="cpu"`` (8 virtual ranks).

- The checker raises where the JAX checker raises and at the same boundary
  (the Start for a layout, length or dtype fault; the round's first Wait for
  a non-finite payload), with the same counters.
- ``_leaf_blocks`` and the audit's digest: bit for bit the JAX package's on
  the same leaves, for float32, bf16, f16, float64 and integer leaves, over
  replicated copies, diverged per-rank copies and per-rank shards.
- The gate: the JAX ``Sentinel`` and the port's fed the same scripted
  (loss, gradients) sequences give the same verdicts step for step, the same
  counters, and EMA state within rtol 1e-6 (float32 sums in another order).
- The trainer: a skipped step is bit for bit a step that never ran (params,
  residuals, its twin); the counters of the JAX trainer on the same MLP and
  batches (tests/test_sentinel.py's sequences, no hard-coded counts for the
  loss-outlier case: ROADMAP C.4).

Every test resets the checker's queue, the sentinel's counters and last
audit, the log level and the whole fault plane (``supervisor.reset_all()``)
before and after it, and clears the JAX chaos registry: this state is
process-wide and the tests share workers with the JAX package's.
"""

import hashlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsl_tpu import chaos as jchaos
from mlsl_tpu import sentinel as jsentinel
from mlsl_tpu.core import stats as jstats
from mlsl_tpu.models.mlp import LAYERS, get_layer as jget_layer, init as mlp_init
from mlsl_tpu.models.mlp import loss_fn as jmlp_loss
from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
from mlsl_tpu.types import DataType as JDT, GroupType as JGT, ReductionType as JRed
from mlsl_tpu_torch import chaos, checker, sentinel, supervisor
from mlsl_tpu_torch import log as tlog
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLCorruptionError, MLSLError, MLSLIntegrityError
from mlsl_tpu_torch.models import mlp as tmlp
from mlsl_tpu_torch.models.convert import params_from_jax
from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer
from mlsl_tpu_torch.types import (CompressionType, DataType, GroupType, ReductionType)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _isolated():
    jchaos.clear()
    supervisor.reset_all()
    tlog.set_log_level(tlog.LogLevel.ERROR)
    yield
    if Environment._instance is not None:
        Environment._instance.finalize()
    supervisor.reset_all()
    tlog.set_log_level(tlog.LogLevel.ERROR)
    jchaos.clear()


def _tenv(monkeypatch=None, **vars_):
    for k, v in vars_.items():
        monkeypatch.setenv(k, str(v))
    return Environment.get_env().init(device="cpu", world_size=8)


def _jenv(monkeypatch, **vars_):
    from mlsl_tpu.core.environment import Environment as JEnv

    for k, v in vars_.items():
        monkeypatch.setenv(k, str(v))
    return JEnv.get_env().init()


def _batch(step):
    rng = np.random.default_rng(step)
    return (rng.normal(size=(16, 8)).astype(np.float32),
            rng.integers(0, 4, size=(16,)).astype(np.int32))


def _ttrainer(env, key=0, **kw):
    dist = env.create_distribution(8, 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(16)
    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(key)))
    kw.setdefault("lr", 0.1)
    return TTrainer(env, dist, sess, tmlp.MLP(device="cpu", params=params_from_jax(host, "cpu")),
                    tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, **kw)


def _jtrainer(env, key=0, **kw):
    dist = env.create_distribution(8, 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(16)
    kw.setdefault("lr", 0.1)
    return JTrainer(env, dist, sess, mlp_init(jax.random.PRNGKey(key)), jmlp_loss, LAYERS,
                    jget_layer, **kw)


def _params(tr):
    return [p.detach().clone() for p in tr._all_params()]


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y) or (torch.isnan(x).any() and torch.equal(
            torch.nan_to_num(x), torch.nan_to_num(y)))


# -- the buffer checker (tests/test_aux.py::TestChecker) ------------------------------


def _allreduce(env, dist, buf, count, port):
    if port:
        return dist.all_reduce(buf, count, DataType.FLOAT, ReductionType.SUM, GroupType.DATA)
    return dist.all_reduce(buf, count, JDT.FLOAT, JRed.SUM, JGT.DATA)


@pytest.mark.parametrize("fault", ["layout", "short", "dtype"])
def test_checker_refuses_at_start_as_jax(env, monkeypatch, fault):
    """MLSL_CHKP=1: a buffer laid out for another grid, shorter than the
    descriptor's count, or of another dtype is refused at the Start, by both
    packages, with the same violation counts."""
    from mlsl_tpu.log import MLSLError as JMLSLError

    monkeypatch.setenv("MLSL_CHKP", "1")
    tenv = _tenv()
    for port, e, err in ((False, env, JMLSLError), (True, tenv, MLSLError)):
        dist = e.create_distribution(8, 1)
        if fault == "layout":
            buf = e.create_distribution(4, 2).make_buffer(lambda p: np.zeros(8), 8)
        elif fault == "short":
            buf = dist.make_buffer(lambda p: np.zeros(4), 4)
        else:
            buf = dist.make_buffer(lambda p: np.zeros(8, np.int32), 8,
                                   DataType.INT32 if port else JDT.INT32)
        with pytest.raises(err, match="CHKP"):
            _allreduce(e, dist, buf, 8, port)
    assert stats.CHKP_COUNTERS == jstats.CHKP_COUNTERS
    assert stats.CHKP_COUNTERS["violations"] == 1


def test_checker_catches_nonfinite_at_the_first_wait(env, monkeypatch):
    """MLSL_CHKP=2: the verdict is queued at Start (no sync) and raised at the
    round's first wait, naming the offending buffer, as in the JAX package."""
    from mlsl_tpu.log import MLSLError as JMLSLError

    monkeypatch.setenv("MLSL_CHKP", "2")
    tenv = _tenv()
    msgs = []
    for port, e, err in ((False, env, JMLSLError), (True, tenv, MLSLError)):
        dist = e.create_distribution(8, 1)
        buf = dist.make_buffer(lambda p: np.full(8, np.nan), 8)
        req = _allreduce(e, dist, buf, 8, port)          # queued, not raised
        with pytest.raises(err, match="non-finite") as ei:
            e.wait(req)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "allreduce[8]" in msgs[1]
    assert not checker._pending


def test_checker_passes_valid(env, monkeypatch):
    monkeypatch.setenv("MLSL_CHKP", "2")
    tenv = _tenv()
    outs = []
    for port, e in ((False, env), (True, tenv)):
        dist = e.create_distribution(8, 1)
        buf = dist.make_buffer(lambda p: np.full(8, float(p)), 8)
        out = e.wait(_allreduce(e, dist, buf, 8, port))
        outs.append(np.asarray(dist.local_part(out, 0)))
    np.testing.assert_array_equal(outs[1], np.full(8, 28.0))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_checker_counters_and_batched_sync(env, monkeypatch):
    """Two Starts queue two verdicts; the round pays ONE host read, as the
    JAX package's one device sync."""
    monkeypatch.setenv("MLSL_CHKP", "2")
    tenv = _tenv()
    for port, e in ((False, env), (True, tenv)):
        dist = e.create_distribution(8, 1)
        b1 = dist.make_buffer(lambda p: np.full(8, 1.0), 8)
        b2 = dist.make_buffer(lambda p: np.full(8, 2.0), 8)
        r1, r2 = _allreduce(e, dist, b1, 8, port), _allreduce(e, dist, b2, 8, port)
        e.wait(r1)
        e.wait(r2)
    assert stats.CHKP_COUNTERS == jstats.CHKP_COUNTERS == {
        "checks": 2, "violations": 0, "value_checks": 2, "value_syncs": 1}
    text = tenv.create_session().get_stats().print_()
    assert "CHKP" in text and "value_syncs 1" in text


def test_checker_names_every_bad_buffer_of_the_round(monkeypatch):
    monkeypatch.setenv("MLSL_CHKP", "2")
    tenv = _tenv()
    dist = tenv.create_distribution(8, 1)
    good = dist.make_buffer(lambda p: np.ones(8), 8)
    bad4 = dist.make_buffer(lambda p: np.full(4, np.inf), 4)
    bad8 = dist.make_buffer(lambda p: np.full(8, -np.inf if p == 3 else 1.0), 8)
    reqs = [_allreduce(tenv, dist, b, n, True) for b, n in ((good, 8), (bad4, 4), (bad8, 8))]
    with pytest.raises(MLSLError) as ei:
        reqs[0].wait()
    assert "allreduce[4]" in str(ei.value) and "allreduce[8]" in str(ei.value)
    assert stats.CHKP_COUNTERS["violations"] == 2 and stats.CHKP_COUNTERS["value_syncs"] == 1
    for r in reqs[1:]:
        r.wait()                                       # the round's verdicts are spent


def test_checker_flushes_at_test(monkeypatch):
    monkeypatch.setenv("MLSL_CHKP", "2")
    tenv = _tenv()
    dist = tenv.create_distribution(8, 1)
    req = _allreduce(tenv, dist, dist.make_buffer(lambda p: np.full(8, np.nan), 8), 8, True)
    with pytest.raises(MLSLError, match="non-finite"):
        while not req.test()[0]:
            pass


def test_checker_failed_round_does_not_leak_verdicts(env, monkeypatch):
    """A round that fails before its flush drains its verdicts into the log
    (the round's own error stays the one raised); a later healthy round does
    not inherit them. The same counters as the JAX package."""
    from mlsl_tpu import chaos as jc

    monkeypatch.setenv("MLSL_CHKP", "2")
    tenv = _tenv()
    outs = []
    for port, e, mod in ((False, env, jc), (True, tenv, chaos)):
        dist = e.create_distribution(8, 1)
        bad = dist.make_buffer(lambda p: np.full(8, np.nan), 8)
        mod.plan("request.wait", "error", exc=RuntimeError)
        req = _allreduce(e, dist, bad, 8, port)
        with pytest.raises(RuntimeError, match="chaos injected"):
            e.wait(req)
        mod.clear()
        good = dist.make_buffer(lambda p: np.full(8, 1.0), 8)
        outs.append(np.asarray(dist.local_part(e.wait(_allreduce(e, dist, good, 8, port)), 0)))
    np.testing.assert_array_equal(outs[1], np.full(8, 8.0))
    assert stats.CHKP_COUNTERS["violations"] == jstats.CHKP_COUNTERS["violations"] == 1


def test_checker_validates_bucket_members(env, monkeypatch):
    """Through the bucket pack: a member buffer that violates its own
    descriptor is refused as it registers, named OUT_OF_RANGE, in both
    packages."""
    from mlsl_tpu.core.environment import Environment as JEnv
    from mlsl_tpu.log import MLSLError as JMLSLError

    env.finalize()
    monkeypatch.setenv("MLSL_GRAD_BUCKET_MB", "1")
    for port in (False, True):
        e = _tenv() if port else JEnv.get_env().init()
        tr = _ttrainer(e) if port else _jtrainer(e)
        ps = tr.ops[LAYERS[0]].get_parameter_set(0)
        assert ps.bucket is not None
        monkeypatch.setenv("MLSL_CHKP", "1")
        dist = tr.dist
        bad = dist.make_buffer(lambda p: np.zeros(4, np.float32), 4)
        with pytest.raises(MLSLError if port else JMLSLError, match="OUT_OF_RANGE"):
            ps.start_gradient_comm(bad)
        monkeypatch.setenv("MLSL_CHKP", "0")
        e.finalize()
    assert stats.CHKP_COUNTERS == jstats.CHKP_COUNTERS


def test_checker_feed_domain_is_separate(monkeypatch):
    """A feed batch's verdicts never surface at a comm wait, nor the
    reverse."""
    monkeypatch.setenv("MLSL_CHKP", "2")
    tenv = _tenv()
    dist = tenv.create_distribution(8, 1)
    req = _allreduce(tenv, dist, dist.make_buffer(lambda p: np.full(8, np.nan), 8), 8, True)
    checker.check_feed_batch((torch.ones(4), torch.arange(3)))        # feed: clean
    with pytest.raises(MLSLError, match="non-finite"):
        checker.check_feed_batch({"x": torch.tensor([1.0, float("nan")])})
    with pytest.raises(MLSLError, match=r"allreduce\[8\]") as ei:
        req.wait()
    assert "feed" not in str(ei.value)


# -- the fingerprint: _leaf_blocks and the digest, bit for bit ------------------------


def _leaf(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return (rng.normal(size=shape) * 3).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -2 ** 62), min(info.max, 2 ** 62), size=shape,
                        dtype=dtype, endpoint=False)


DTYPES = [("float32", np.float32), ("bfloat16", "bf16"), ("float16", np.float16),
          ("float64", np.float64), ("int32", np.int32), ("int64", np.int64),
          ("uint8", np.uint8), ("int16", np.int16)]


def _torch_of(a, kind):
    if kind == "bf16":
        return torch.from_numpy(a).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_of(a, kind):
    if kind == "bf16":
        return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return jnp.asarray(a)


@pytest.mark.parametrize("name,kind", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("block,shape", [(64, (3, 50)), (4096, (1000,)), (7, (13,))])
def test_leaf_blocks_bit_exact_vs_jax(name, kind, block, shape):
    a = _leaf(np.float32 if kind == "bf16" else kind, shape, seed=block)
    with jax.enable_x64(True):
        want = np.asarray(jsentinel.Sentinel(None, block=block)._leaf_blocks(_jax_of(a, kind)))
    got = sentinel.Sentinel(block=block)._leaf_blocks(_torch_of(a, kind)).numpy()
    assert got.dtype == np.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _jax_audit(env, rep, sh, block, corrupt_device=None):
    """The JAX package's audit program on ``rep`` (replicated over the mesh;
    ``corrupt_device`` = (device, element) flips a bit of that device's copy
    of rep's l1 weight) and ``sh`` ((R, D, S, M, ...)
    sharded). -> (equal, digest)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mlsl_tpu.comm.mesh import GRID_AXES

    mesh = env.create_distribution(8, 1).topology.mesh
    s = jsentinel.Sentinel(mesh, every=1, block=block)

    def put_rep(a, corrupt):
        sharding = NamedSharding(mesh, P())
        arrs = []
        for i, d in enumerate(mesh.devices.reshape(-1)):
            c = np.array(a)
            if corrupt is not None and i == corrupt[0]:
                c.reshape(-1).view(np.uint32)[corrupt[1]] ^= np.uint32(1 << 7)
            arrs.append(jax.device_put(c, d))
        return jax.make_array_from_single_device_arrays(a.shape, sharding, arrs)

    jrep = jax.tree.map(lambda a: put_rep(a, None), rep)
    if corrupt_device is not None:
        jrep["params"]["l1"]["w"] = put_rep(rep["params"]["l1"]["w"], corrupt_device)
    jsh = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(mesh, P(*GRID_AXES))), sh)
    equal, fp = s._build_audit_fn(jrep, jsh)(jrep, jsh)
    fp = np.asarray(jax.device_get(fp), dtype="<i4")
    return bool(jax.device_get(equal)), hashlib.sha256(fp.tobytes()).hexdigest()


@pytest.mark.parametrize("block", [64, 4096])
def test_digest_bit_exact_vs_jax(env, block):
    """Replicated leaves, per-rank shards (the ZeRO-1 sum over ranks), and a
    replicated leaf whose copy on one rank has one flipped bit: the same
    equal verdict and digest as the JAX package's pmin/pmax/psum program."""
    rep = {"params": {"l1": {"b": _leaf(np.float32, (16,), 1), "w": _leaf(np.float32, (8, 16), 2)},
                      "l2": {"w": _leaf(np.float32, (300,), 3)}}}
    sh = {"du": [_leaf(np.float32, (1, 8, 1, 1, 40), 4), _leaf(np.float32, (1, 8, 1, 1, 9), 5)]}
    t = sentinel.Sentinel((1, 8, 1, 1), every=1, block=block)

    def to_t(tree):
        return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)

    jeq, jd = _jax_audit(env, rep, sh, block)
    res = t.audit_tree(to_t(rep), to_t(sh), step=1)
    assert (res.equal, res.digest) == (jeq, jd) == (True, jd)
    # one rank's copy of the l1 weight diverged by one bit: the port holds the
    # copies per rank (PerRank) as the JAX devices hold theirs
    jeq2, jd2 = _jax_audit(env, rep, sh, block, corrupt_device=(5, 17))
    w = np.broadcast_to(rep["params"]["l1"]["w"], (1, 8, 1, 1, 8, 16)).copy()
    w[0, 5, 0, 0].reshape(-1).view(np.uint32)[17] ^= np.uint32(1 << 7)
    trep = to_t(rep)
    trep["params"]["l1"]["w"] = sentinel.PerRank(torch.from_numpy(w))
    res2 = t.audit_tree(trep, to_t(sh), step=2)
    assert (res2.equal, res2.digest) == (jeq2, jd2) and not jeq2
    assert jd2 != jd
    assert stats.SENTINEL_COUNTERS["audit_mismatch"] == 1
    assert supervisor.status()["sentinel"]["state"] == "tripped"
    assert supervisor.status()["sentinel"]["last_audit"] == {"step": 2, "equal": False,
                                                             "digest": jd2}


# -- the gate against the JAX Sentinel on scripted sequences --------------------------


def _script(seed, n=12):
    """(loss per rank (8,), gradient leaves per rank) for n healthy steps of
    slowly varying scale, seeded."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        scale = 1.0 + 0.05 * rng.normal()
        loss = (2.0 - 0.02 * i + 0.01 * rng.normal(size=8)).astype(np.float32)
        grads = {"a": (scale * rng.normal(size=(1, 8, 1, 1, 37))).astype(np.float32),
                 "b": (scale * rng.normal(size=(1, 8, 1, 1, 5))).astype(np.float32)}
        out.append((loss, grads))
    return out


def _fault(loss, grads, kind):
    loss, grads = loss.copy(), {k: v.copy() for k, v in grads.items()}
    if kind == "spike":
        grads["a"] *= 100.0
    elif kind == "outlier":
        loss[:] += 50.0
    elif kind == "nan_grad":
        grads["b"][0, 3, 0, 0, 2] = np.nan
    elif kind == "inf_loss_rank":
        loss[6] = np.inf
    return loss, grads


SEQUENCES = {
    "warmup_then_spike": [None] * 6 + ["spike"] + [None] * 2 + ["spike"],
    "outlier": [None] * 7 + ["outlier", None],
    "nonfinite_during_warmup": [None, "nan_grad", None, "inf_loss_rank", None],
    "mixed": [None] * 5 + ["outlier", "spike", None, "nan_grad", None, "outlier"],
}


@pytest.mark.parametrize("response", ["warn", "skip_step", "rollback"])
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_gate_verdicts_match_jax(env, response, seq):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mlsl_tpu.comm.mesh import GRID_AXES
    from mlsl_tpu.log import MLSLIntegrityError as JIntegrity

    mesh = env.create_distribution(8, 1).topology.mesh
    kw = dict(gate=response, spike=5.0, zmax=4.0, warmup=3)
    js = jsentinel.Sentinel(mesh, **kw)
    ts = sentinel.Sentinel((1, 8, 1, 1), **kw)
    shard = NamedSharding(mesh, P(*GRID_AXES))
    script = _script(len(seq) + SEQUENCES[seq].count(None))
    for step, fault in enumerate(SEQUENCES[seq]):
        loss, grads = script[step]
        if fault is not None:
            loss, grads = _fault(loss, grads, fault)
        loss = loss.reshape(1, 8, 1, 1, 1)
        jl = jax.device_put(loss, shard)
        jg = {k: jax.device_put(v, shard) for k, v in grads.items()}
        tg = {k: torch.from_numpy(v) for k, v in grads.items()}
        verdicts = []
        for s, args, err in ((js, (jl, jg), JIntegrity),
                             (ts, (torch.from_numpy(loss), tg), MLSLIntegrityError)):
            try:
                verdicts.append(s.gate(args[0], args[1], None, step))
            except err:
                verdicts.append("raised")
        assert verdicts[0] == verdicts[1], (step, fault, verdicts)
        if fault is not None:
            assert verdicts[1] == {"warn": True, "skip_step": False,
                                   "rollback": "raised"}[response], (step, fault)
        assert ts._n == js._n
        for a in ("_ema_norm", "_loss_mean", "_loss_var"):
            x, y = getattr(ts, a), getattr(js, a)
            assert (x is None and y is None) or math.isclose(x, y, rel_tol=1e-6,
                                                             abs_tol=1e-9), (step, a, x, y)
    assert stats.SENTINEL_COUNTERS == jstats.SENTINEL_COUNTERS


def test_gate_one_host_read_a_step(monkeypatch):
    """The screen's two (W,) vectors cross in one read: counted at the
    tensor's ``.cpu()``; a healthy step reads nothing else."""
    ts = sentinel.Sentinel((1, 8, 1, 1), gate="skip_step", warmup=1)
    script = _script(3, 4)
    reads = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        reads.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    for step, (loss, grads) in enumerate(script):
        assert ts.gate(torch.from_numpy(loss.reshape(1, 8, 1, 1, 1)),
                       {k: torch.from_numpy(v) for k, v in grads.items()}, None, step)
    assert reads == [(2, 8)] * 4


# -- the trainer's hooks (tests/test_sentinel.py) -------------------------------------


def test_gate_nonfinite_warn_continues(env, monkeypatch):
    """warn goes on: the poisoned update is applied, so the next step fires
    again, in both packages."""
    env.finalize()
    counts = []
    for port in (False, True):
        e = (_tenv if port else _jenv)(monkeypatch, MLSL_SENTINEL_GATE="warn")
        mod = chaos if port else jchaos
        tr = _ttrainer(e) if port else _jtrainer(e)
        p = mod.plan("train.grads", "silent", mag=float("nan"))
        tr.step(tr.shard_batch(*_batch(0)))
        assert p.fires == 1
        tr.step(tr.shard_batch(*_batch(1)))
        counts.append(dict((stats if port else jstats).SENTINEL_COUNTERS))
        mod.clear()
        e.finalize()
    assert counts[0] == counts[1]
    assert counts[1]["gate_warn"] == 2


@pytest.mark.parametrize("compression", [CompressionType.NONE, CompressionType.QUANTIZATION])
def test_gate_skip_lockstep_twin_parity(monkeypatch, compression):
    """A skipped step equals a step that never happened: the faulted trainer
    (skip at step 2) and a twin never fed batch 2 land on bit-identical
    parameters; on the int8 path the error-feedback residuals did not move
    either."""
    e = _tenv(monkeypatch, MLSL_SENTINEL_GATE="skip_step")
    tr_a, tr_b = _ttrainer(e, compression=compression), _ttrainer(e, compression=compression)
    for s in range(2):
        tr_a.step(tr_a.shard_batch(*_batch(s)))
        tr_b.step(tr_b.shard_batch(*_batch(s)))
    before = _params(tr_a)
    res = {n: [x.clone() for x in (tr_a._pset(n).grad_req._errs or [])] for n in tr_a.layers}
    chaos.plan("train.grads", "silent", mag=float("inf"))
    tr_a.step(tr_a.shard_batch(*_batch(2)))
    assert stats.SENTINEL_COUNTERS["gate_skip"] == 1
    _same(before, _params(tr_a))
    for n in tr_a.layers:
        for x, y in zip(res[n], tr_a._pset(n).grad_req._errs or []):
            assert torch.equal(x, y)
    if compression == CompressionType.QUANTIZATION:
        assert any(res.values())
    for s in range(3, 5):
        tr_a.step(tr_a.shard_batch(*_batch(s)))
        tr_b.step(tr_b.shard_batch(*_batch(s)))
    _same(_params(tr_a), _params(tr_b))


def test_gate_rollback_raises_and_preserves_state(monkeypatch):
    e = _tenv(monkeypatch, MLSL_SENTINEL_GATE="rollback")
    tr = _ttrainer(e)
    tr.step(tr.shard_batch(*_batch(0)))
    before = _params(tr)
    chaos.plan("train.grads", "silent", mag=float("nan"))
    with pytest.raises(MLSLIntegrityError) as ei:
        tr.step(tr.shard_batch(*_batch(1)))
    assert isinstance(ei.value, MLSLCorruptionError)
    assert supervisor.classify(ei.value) is supervisor.ErrorClass.CORRUPTION
    assert stats.SENTINEL_COUNTERS["gate_rollback"] == 1
    _same(before, _params(tr))
    assert supervisor.status()["sentinel"]["state"] == "tripped"


def test_gate_grad_norm_spike(env, monkeypatch):
    """A large finite perturbation: the non-finite screen stays silent, the
    spike screen fires, the parameters are untouched; the JAX trainer's
    counters alike."""
    env.finalize()
    counts = []
    for port in (False, True):
        e = (_tenv if port else _jenv)(monkeypatch, MLSL_SENTINEL_GATE="skip_step",
                                       MLSL_SENTINEL_WARMUP="2", MLSL_SENTINEL_SPIKE="5")
        mod = chaos if port else jchaos
        tr = _ttrainer(e) if port else _jtrainer(e)
        for s in range(3):
            tr.step(tr.shard_batch(*_batch(s)))
        before = _params(tr) if port else None
        mod.plan("train.grads", "silent", mag=1e8)
        tr.step(tr.shard_batch(*_batch(3)))
        if port:
            _same(before, _params(tr))
        counts.append(dict((stats if port else jstats).SENTINEL_COUNTERS))
        mod.clear()
        e.finalize()
    assert counts[0] == counts[1] and counts[1]["gate_skip"] == 1


def test_gate_loss_outlier(env, monkeypatch):
    """tests/test_sentinel.py:173-186 with the port's counters held to the
    JAX trainer's on the same inputs, no count hard-coded: the JAX package's
    gate fires once during the three healthy steps (ROADMAP C.4: the z-score
    against a variance from one deviation after a one-step warmup), and the
    port reproduces it; then the pinned EMA makes step 4 an outlier in both."""
    env.finalize()
    seen = []
    for port in (False, True):
        e = (_tenv if port else _jenv)(monkeypatch, MLSL_SENTINEL_GATE="skip_step",
                                       MLSL_SENTINEL_WARMUP="1", MLSL_SENTINEL_ZMAX="3")
        tr = _ttrainer(e) if port else _jtrainer(e)
        st = stats if port else jstats
        for s in range(3):
            tr.step(tr.shard_batch(*_batch(s)))
        healthy = dict(st.SENTINEL_COUNTERS)
        tr.sentinel._loss_mean = 1e6
        tr.sentinel._loss_var = 1.0
        tr.step(tr.shard_batch(*_batch(3)))
        seen.append((healthy, dict(st.SENTINEL_COUNTERS)))
        e.finalize()
    assert seen[0] == seen[1]
    assert seen[1][1]["gate_skip"] == seen[1][0]["gate_skip"] + 1


def test_gate_spans_on_timeline(monkeypatch):
    from mlsl_tpu_torch import obs

    e = _tenv(monkeypatch, MLSL_SENTINEL_GATE="skip_step", MLSL_SENTINEL_EVERY="1")
    tr = _ttrainer(e)
    obs.enable()
    tr.step(tr.shard_batch(*_batch(0)))
    chaos.plan("train.grads", "silent", mag=float("nan"))
    tr.step(tr.shard_batch(*_batch(1)))
    assert tr.sentinel.audit_now(tr, step=2).equal
    names = {ev[1] for ev in obs.get_tracer().snapshot()}
    assert {"sentinel.gate", "sentinel.audit", "integrity.gate"} <= names


def test_armed_gate_turns_the_fused_step_off(monkeypatch):
    """On one data rank the step is fused, except with an armed gate (it
    needs the gradients); an audit alone keeps the fused step."""
    for gate, fused in (("", True), ("warn", False)):
        monkeypatch.setenv("MLSL_SENTINEL_GATE", gate)
        monkeypatch.setenv("MLSL_SENTINEL_EVERY", "1")
        e = Environment.get_env().init(device="cpu", world_size=1)
        dist = e.create_distribution(1, 1)
        sess = e.create_session()
        sess.set_global_minibatch_size(16)
        tr = TTrainer(e, dist, sess, tmlp.MLP(device="cpu"), tmlp.loss_fn, tmlp.LAYERS,
                      tmlp.get_layer, lr=0.1)
        assert tr.fused is fused and tr.sentinel is not None
        tr.step(tr.shard_batch(*_batch(0)))
        assert stats.SENTINEL_COUNTERS["screened"] == (0 if fused else 1)
        e.finalize()
        stats.reset_sentinel_counters()


def test_unarmed_trainer_is_untouched(monkeypatch):
    """Nothing armed: no sentinel, no straggler, the same step as before."""
    e = _tenv()
    tr = _ttrainer(e)
    assert tr.sentinel is None and tr.straggler is None
    tr.step(tr.shard_batch(*_batch(0)))
    assert not any(stats.SENTINEL_COUNTERS.values())


# -- the audit through the trainer -------------------------------------------------------


def test_audit_passes_on_healthy_state_and_matches_jax(env, monkeypatch):
    """Healthy state audits equal and deterministic; on the same initial
    parameters the port's digest is the JAX trainer's, bit for bit."""
    env.finalize()
    jenv = _jenv(monkeypatch, MLSL_SENTINEL_EVERY="1")
    jd = _jtrainer(jenv).sentinel.audit_now(_jtrainer(jenv), step=0).digest
    jenv.finalize()
    e = _tenv(monkeypatch, MLSL_SENTINEL_EVERY="1")
    tr = _ttrainer(e)
    assert tr.sentinel.audit_now(tr, step=0).digest == jd
    tr.step(tr.shard_batch(*_batch(0)))
    r1, r2 = tr.sentinel.audit_now(tr, step=1), tr.sentinel.audit_now(tr, step=1)
    assert r1.equal and r2.equal and r1.digest == r2.digest and r1.blocks > 0
    assert tr.sentinel.maybe_audit(tr, step=1).equal
    assert stats.SENTINEL_COUNTERS["audits"] == 4


@pytest.mark.parametrize("site", ["train.params", "train.opt_state"])
def test_silent_state_plans_change_the_digest(monkeypatch, site):
    """A silent plan at the state sites corrupts the copy every virtual rank
    reads: the min/max comparison cannot see it (one copy), the digest does
    (ROADMAP, standing difference)."""
    from mlsl_tpu_torch import optim

    e = _tenv(monkeypatch, MLSL_SENTINEL_EVERY="1")
    kw = {"optimizer": optim.adam(1e-3)} if site == "train.opt_state" else {}
    tr_a, tr_b = _ttrainer(e, **kw), _ttrainer(e, **kw)
    for tr in (tr_a, tr_b):
        tr.step(tr.shard_batch(*_batch(0)))
    p = chaos.plan(site, "silent", mag=0.01)
    for tr in (tr_a, tr_b):
        tr.step(tr.shard_batch(*_batch(1)))
    assert p.fires == 1
    ra, rb = tr_a.sentinel.audit_now(tr_a, 2), tr_b.sentinel.audit_now(tr_b, 2)
    assert ra.equal and rb.equal and ra.digest != rb.digest


def test_audit_zero1_sums_owned_shards(monkeypatch):
    """Under ZeRO-1 the owned Adam moments enter as the exact integer sum over
    the ranks: one rank's shard hit by a silent plan moves the digest, and the
    audit of the replicated and ZeRO-1 trainers on the same step share no
    digest (their state differs in layout)."""
    from mlsl_tpu_torch import optim

    e = _tenv(monkeypatch, MLSL_SENTINEL_EVERY="1")
    tr = _ttrainer(e, distributed_update=True, optimizer=optim.adam(1e-3))
    tr.step(tr.shard_batch(*_batch(0)))
    rep, sh = tr._audit_state()
    assert len(sh["du_opt_state"]) == 2 * len(tr.layers)         # mu, nu a layer
    assert all(t.shape[:4] == (1, 8, 1, 1) for t in sh["du_opt_state"])
    d0 = tr.sentinel.audit_now(tr, 1).digest
    chaos.plan("train.opt_state", "silent")
    tr._step_no += 1
    tr._chaos_state_sites()
    d1 = tr.sentinel.audit_now(tr, 1)
    assert d1.equal and d1.digest != d0


def test_audit_fingerprint_stable_across_bucket_path(monkeypatch):
    """The plain and bucketed gradient paths give bit-identical parameters on
    the CPU, so their digests are equal; two identical int8 runs too."""
    digests = []
    for bucket in ("0", "1"):
        e = _tenv(monkeypatch, MLSL_SENTINEL_EVERY="1", MLSL_GRAD_BUCKET_MB=bucket)
        tr = _ttrainer(e)
        for s in range(3):
            tr.step(tr.shard_batch(*_batch(s)))
        digests.append(tr.sentinel.audit_now(tr, step=3).digest)
        e.finalize()
    assert digests[0] == digests[1]
    quant = []
    for _ in range(2):
        e = _tenv(monkeypatch, MLSL_SENTINEL_EVERY="1", MLSL_GRAD_BUCKET_MB="0")
        tr = _ttrainer(e, compression=CompressionType.QUANTIZATION)
        for s in range(2):
            tr.step(tr.shard_batch(*_batch(s)))
        quant.append(tr.sentinel.audit_now(tr, step=2).digest)
        e.finalize()
    assert quant[0] == quant[1] != digests[0]


def test_checkpoint_fingerprint_records_a_verified_save(monkeypatch):
    e = _tenv(monkeypatch, MLSL_SENTINEL_EVERY="1")
    tr = _ttrainer(e)
    res = tr.sentinel.audit_now(tr, step=4)
    assert tr.sentinel.checkpoint_fingerprint(tr, 4) == res.digest
    assert stats.SENTINEL_COUNTERS["audits"] == 1                 # reused, not rerun
    assert stats.SENTINEL_COUNTERS["verified_saves"] == 1
    tr.sentinel._last = sentinel.AuditResult(False, "0" * 64, 5, 1)
    with pytest.raises(MLSLIntegrityError, match="refusing to checkpoint"):
        tr.sentinel.checkpoint_fingerprint(tr, 5)


def test_maybe_audit_raises_on_divergence_and_keeps_cadence():
    s = sentinel.Sentinel((1, 8, 1, 1), every=2, block=16)

    class _T:
        def __init__(self, bad):
            w = torch.ones(1, 8, 1, 1, 40)
            if bad:
                w[0, 2, 0, 0, 7] = 2.0
            self.state = ({"w": sentinel.PerRank(w)}, {})

        def _audit_state(self):
            return self.state

    assert s.maybe_audit(_T(True), 3) is None                  # off cadence
    assert s.maybe_audit(_T(False), 4).equal
    with pytest.raises(MLSLIntegrityError, match="diverge"):
        s.maybe_audit(_T(True), 6)
    assert stats.SENTINEL_COUNTERS["audit_mismatch"] == 1


# -- silent corruption ---------------------------------------------------------------------


def test_corrupt_silent_one_element_of_one_rank_seeded():
    grads = {"a": torch.zeros(1, 8, 1, 1, 30), "b": torch.zeros(1, 8, 1, 1, 3)}
    p = chaos.Plan(site="train.grads", kind="silent")
    chaos.seed(7)
    sentinel.corrupt_silent(grads, p, (1, 8, 1, 1))
    hit = [(k, torch.nonzero(v).tolist()) for k, v in grads.items() if v.any()]
    assert len(hit) == 1 and len(hit[0][1]) == 1
    again = {"a": torch.zeros(1, 8, 1, 1, 30), "b": torch.zeros(1, 8, 1, 1, 3)}
    chaos.seed(7)
    sentinel.corrupt_silent(again, p, (1, 8, 1, 1))
    for k in grads:
        assert torch.equal(grads[k], again[k])
    # a bit flip on a one-copy leaf: exactly one element, one bit
    w = torch.randn(64, generator=torch.Generator().manual_seed(1))
    clean = w.clone()
    sentinel.corrupt_silent([w], p)
    diff = (w.view(torch.int32) ^ clean.view(torch.int32)).tolist()
    assert sum(bin(x & 0xFFFFFFFF).count("1") for x in diff) == 1


@pytest.mark.parametrize("mag", [float("nan"), float("inf"), 0.5])
def test_corrupt_silent_magnitudes_and_bf16(mag):
    t = {"w": torch.ones(16, dtype=torch.bfloat16)}
    sentinel.corrupt_silent(t, chaos.Plan(site="train.params", kind="silent", mag=mag))
    v = t["w"].float()
    changed = v[v != 1.0] if not math.isnan(mag) else v[torch.isnan(v)]
    assert changed.numel() == 1
    if math.isfinite(mag):
        assert float(changed[0]) == 2.0                          # 1 + 0.5 * (1 + 1)
    assert sentinel.corrupt_silent([torch.arange(4)], chaos.Plan(site="x", kind="silent"))


def test_corrupt_replica_targets_the_given_rank():
    w = torch.zeros(1, 8, 1, 1, 10)
    sentinel.corrupt_replica({"w": w, "c": torch.zeros(3)}, [6], chaos.Plan(
        site="x", kind="silent", mag=1.0), (1, 8, 1, 1))
    assert torch.nonzero(w).tolist()[0][1] == 6


# -- status, stats, knobs ---------------------------------------------------------------


def test_integrity_error_breaker_interaction():
    err = MLSLIntegrityError("divergence")
    assert isinstance(err, MLSLCorruptionError) and isinstance(err, MLSLError)
    assert supervisor.classify(err) is supervisor.ErrorClass.CORRUPTION
    supervisor.configure(threshold=2, window_s=60.0, cooldown_s=60.0)
    br = supervisor.breaker("quant")
    assert not br.record_failure(err)
    assert br.record_failure(err)
    assert br.state == supervisor.OPEN


def test_sentinel_stats_line_and_families(monkeypatch):
    from mlsl_tpu_torch.obs import metrics

    e = _tenv(monkeypatch, MLSL_SENTINEL_GATE="skip_step", MLSL_SENTINEL_EVERY="1")
    tr = _ttrainer(e)
    tr.step(tr.shard_batch(*_batch(0)))
    tr.sentinel.audit_now(tr, step=1)
    text = tr.session.get_stats().print_()
    assert "SENTINEL" in text and "audits 1" in text and "screened 1" in text
    m = metrics.enable(every=1)
    m.sample_families()
    assert m.find("mlsl_sentinel_screened").value == 1.0
    assert m.find("mlsl_chkp_checks") is not None
    st = supervisor.status()["sentinel"]
    assert st["state"] == "armed" and st["last_audit"]["step"] == 1


def test_status_matches_jax_after_the_same_events(env):
    for mod, st in ((sentinel, stats), (jsentinel, jstats)):
        st.record_sentinel("screened")
        st.record_sentinel("gate_skip")
        st.record_sentinel("audits")
    assert sentinel.status() == jsentinel.status()
    jstats.reset_sentinel_counters()


def test_sentinel_every_in_tuner_knob_ranges():
    from mlsl_tpu.tuner import KNOB_RANGES as JRANGES
    from mlsl_tpu_torch.tuner import TUNABLE_KNOBS
    from mlsl_tpu_torch.tuner.profile import KNOB_RANGES

    assert KNOB_RANGES["sentinel_every"] == JRANGES["sentinel_every"]
    assert "sentinel_every" in TUNABLE_KNOBS


# -- the trainer's telemetry and the straggler arming -----------------------------------


def _reset_counter_families():
    """Every core/stats counter family of both packages back to 0."""
    for st in (jstats, stats):
        for name in dir(st):
            if name.startswith("reset_") and name.endswith("_counters"):
                getattr(st, name)()


def _cadence_run(tr, m, path):
    """Four steps on batches 0-3 with the registry ticking every 2 steps; ->
    (loss, grad norm, step_ms count, the set of JSONL series)."""
    import json

    for s in range(4):
        tr.step(tr.shard_batch(*_batch(s)))
    recs = [json.loads(l) for l in open(path) if l.strip()]
    return (m.find("mlsl_loss").value, m.find("mlsl_grad_norm").value,
            m.find("mlsl_step_ms").count, {r["series"] for r in recs})


def test_trainer_step_feeds_and_cadence(env, monkeypatch, tmp_path):
    """tests/test_metrics.py:209-232 held against the JAX trainer: the same
    MLP, the same batches, MLSL_METRICS on (every=2) in both packages. The
    cadence tick's loss (the mean over the ranks) and gradient norm (over
    every rank's local gradients, before any comm) agree within float32
    rtol 1e-5 (sums in another order); the step's wall time is observed once
    a step; the JSONL holds the same series, the elastic family's included."""
    from mlsl_tpu.obs import metrics as jmetrics
    from mlsl_tpu_torch.obs import metrics

    env.finalize()
    out = []
    try:
        # the families with keyed series (algo dispatches, codec wire bytes,
        # fallbacks) hold what earlier tests in this worker counted
        _reset_counter_families()
        for port, mod in ((False, jmetrics), (True, metrics)):
            d = tmp_path / ("port" if port else "jax")
            d.mkdir()
            monkeypatch.setenv("MLSL_STATS_DIR", str(d))
            e = (_tenv if port else _jenv)(monkeypatch)
            tr = (_ttrainer if port else _jtrainer)(e, force_graph_path=True)
            m = mod.enable(every=2)
            out.append(_cadence_run(tr, m, mod.jsonl_path()))
            assert m.find("mlsl_input_stall_ms").value == 0.0
            assert m.find("mlsl_sentinel_screened") is not None
            mod.disable()
            e.finalize()
    finally:
        jmetrics.disable()
        metrics.disable()
        _reset_counter_families()
    (jl, jg, jn, jser), (tl, tg, tn, tser) = out
    assert tl == pytest.approx(jl, rel=1e-5) and tl > 0
    assert tg == pytest.approx(jg, rel=1e-5) and tg > 0
    assert tn == jn == 4
    assert tser == jser
    assert {"mlsl_step_ms", "mlsl_loss", "mlsl_grad_norm"} <= tser


def test_straggler_armed_from_config(env, monkeypatch):
    """MLSL_STRAGGLER_* arm the straggler sentinel from the Config in both
    packages with the same skew, window, sustain and shed; after one window
    (``every`` steps) both ran exactly one audit over the one replica, flagged
    nothing and reset the window, with the same counters."""
    from mlsl_tpu.obs import straggler as jstraggler
    from mlsl_tpu_torch.obs import straggler as tstraggler

    env.finalize()
    seen = []
    knobs = dict(MLSL_STRAGGLER_SKEW="2.0", MLSL_STRAGGLER_EVERY="3",
                 MLSL_STRAGGLER_SUSTAIN="2", MLSL_STRAGGLER_SHED="1")
    try:
        for port in (False, True):
            (stats if port else jstats).reset_straggler_counters()
            e = (_tenv if port else _jenv)(monkeypatch, **knobs)
            tr = (_ttrainer if port else _jtrainer)(e)
            sg = tr.straggler
            assert sg is not None
            row = [(sg.skew, sg.every, sg.sustain, sg.shed)]
            for s in range(2):
                tr.step(tr.shard_batch(*_batch(s)))
            row.append((sg._audits, len(sg._win_step.get(0, []))))
            tr.step(tr.shard_batch(*_batch(2)))
            row.append((sg._audits, dict(sg._win_step), sorted(sg._flagged)))
            row.append(dict((stats if port else jstats).STRAGGLER_COUNTERS))
            seen.append(row)
            e.finalize()
    finally:
        jstraggler.reset()
        tstraggler.reset()
        jstats.reset_straggler_counters()
    assert seen[0] == seen[1]
    assert seen[1][0] == (2.0, 3, 2, True)
    assert seen[1][1] == (0, 2)
    assert seen[1][2] == (1, {}, [])
    assert seen[1][3]["audits"] == 1 and seen[1][3]["flags"] == 0


# -- the compiled engine under the gate ---------------------------------------------------


def test_gated_engine_takes_the_split_program_and_skips_like_its_twin(monkeypatch):
    """With the gate armed the engine runs the split program (gradients on
    the host path, then its comm and update); a skipped step leaves the
    parameters and the int8 residuals as a twin that never saw it."""
    e = _tenv(monkeypatch, MLSL_SENTINEL_GATE="skip_step", MLSL_OVERLAP_COMPILED="1")
    kw = dict(compression=CompressionType.QUANTIZATION)
    tr_a, tr_b = _ttrainer(e, **kw), _ttrainer(e, **kw)
    assert tr_a._overlap is not None
    stats.reset_overlap_counters()
    for s in range(2):
        tr_a.step(tr_a.shard_batch(*_batch(s)))
        tr_b.step(tr_b.shard_batch(*_batch(s)))
    assert stats.OVERLAP_COUNTERS["split_steps"] == stats.OVERLAP_COUNTERS["steps"] == 4
    before = _params(tr_a)
    res = {k: v.clone() for k, v in tr_a._overlap.residuals.items()}
    chaos.plan("train.grads", "silent", mag=1e30)
    chaos.plan("train.grads", "silent", mag=float("nan"), after=0)
    tr_a.step(tr_a.shard_batch(*_batch(2)))
    assert stats.SENTINEL_COUNTERS["gate_skip"] == 1
    _same(before, _params(tr_a))
    for k, v in tr_a._overlap.residuals.items():
        assert torch.equal(v, res[k])
    for s in range(3, 5):
        tr_a.step(tr_a.shard_batch(*_batch(s)))
        tr_b.step(tr_b.shard_batch(*_batch(s)))
    _same(_params(tr_a), _params(tr_b))
