"""The port's recovery supervisor (mlsl_tpu_torch.supervisor, the ladder in
comm/request.py and core/bucketing.py) against the JAX package's, mirroring
tests/test_supervisor.py.

Each ladder test drives the port (8 CPU virtual ranks) and the JAX package
(the 8-device CPU mesh) through the same fault schedule on the same
numpy-seeded buffers. Tolerances:

- breaker states, transitions, trip / probe / reset counts, retry counts and
  degraded-dispatch counts: equal to the JAX package's;
- a degraded ``lax`` or plain float32 SUM, and every uncompressed round:
  bit for bit the JAX package's result (both sum the members in member order
  on the CPU) and the port's own healthy twin;
- a degraded round that flushes a live int8 residual: within 1e-5 relative
  of sum(x_r + residual_r), as the JAX test holds it (the two packages'
  residuals differ by XLA's codec arithmetic, ROADMAP "XLA's CPU compiler
  changes the codec's arithmetic");
- the DEGRADE lines of mlsl_stats.log: the same events in the same order.
"""

import random

import numpy as np
import pytest
import torch

from mlsl_tpu import chaos as jchaos
from mlsl_tpu import supervisor as jsup
from mlsl_tpu.comm.request import CommDesc as JDesc, CommRequest as JReq
from mlsl_tpu.config import Config as JConfig
from mlsl_tpu.core import stats as jstats
from mlsl_tpu.types import (CompressionType as JComp, DataType as JDT, OpType as JOp,
                            ReductionType as JRed)
from mlsl_tpu_torch import chaos, supervisor
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError, MLSLKernelError
from mlsl_tpu_torch.types import CompressionType, DataType, OpType, ReductionType

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _isolated():
    """The port's fault plane and the JAX chaos registry as a fresh process
    has them, before and after every test (the JAX conftest resets the JAX
    breakers)."""
    jchaos.clear()
    supervisor.reset_all()
    yield
    supervisor.reset_all()
    jchaos.clear()


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


# -- taxonomy, backoff, the breaker state machine ---------------------------------


def test_classification_table_matches_jax():
    from mlsl_tpu import log as jlog
    from mlsl_tpu_torch import log as tlog

    pairs = [(OSError("disk"), OSError("disk")), (ConnectionError(), ConnectionError()),
             (TimeoutError(), TimeoutError()),
             (jlog.MLSLCorruptionError("rot"), tlog.MLSLCorruptionError("rot")),
             (FloatingPointError(), FloatingPointError()),
             (jlog.MLSLTimeoutError("stuck"), tlog.MLSLTimeoutError("stuck")),
             (jlog.MLSLError("a"), tlog.MLSLError("a")), (RuntimeError("x"), RuntimeError("x")),
             (jchaos.ChaosError("b"), chaos.ChaosError("b")), (ValueError(), ValueError()),
             (TypeError(), TypeError()), (MemoryError(), MemoryError()),
             (KeyboardInterrupt(), KeyboardInterrupt()),
             (jlog.MLSLDeviceLossError("x"), tlog.MLSLDeviceLossError("x"))]
    for je, te in pairs:
        assert supervisor.classify(te).value == jsup.classify(je).value, (je, te)


def test_jittered_backoff_matches_jax():
    for attempt in range(5):
        a, b = random.Random(7 + attempt), random.Random(7 + attempt)
        for _ in range(20):
            assert supervisor.jittered_backoff(0.1, attempt, rng=a) == \
                jsup.jittered_backoff(0.1, attempt, rng=b)


class _Clock:
    """An injected monotonic clock: breaker timing without sleeping."""

    def __init__(self, monkeypatch, mods):
        self.t = 1000.0
        for m in mods:
            monkeypatch.setattr(m.time, "monotonic", lambda: self.t)

    def advance(self, s):
        self.t += s


def _drive(br, clock, schedule):
    """Run a schedule of ('f' failure | 's' success | 'a' allow | ('t', s))
    on a breaker -> the observable trace."""
    out = []
    for ev in schedule:
        if ev == "f":
            out.append(("f", br.record_failure(RuntimeError("x")), br.state))
        elif ev == "s":
            br.record_success()
            out.append(("s", br.state))
        elif ev == "a":
            out.append(("a", br.allow(), br.state))
        else:
            clock.advance(ev[1])
    st = br.status()
    out.append((st["state"], st["failures_in_window"], st["trips"]))
    return out


SCHEDULES = {
    "trip_probe_close": ["f", "f", "f", "a", ("t", 0.2), "a", "s", "a"],
    "probe_fails_reopens": ["f", "f", "f", ("t", 0.2), "a", "f", "a", ("t", 0.2), "a", "s"],
    "window_prunes": ["f", "f", ("t", 11.0), "f", "f", "a"],
    "closed_success_noop": ["s", "f", "s", "f", "f", "a"],
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_breaker_transitions_match_jax(name, monkeypatch):
    """The same schedule on both breakers (an injected clock, threshold 3,
    window 10 s, cooldown 0.15 s) gives the same states, verdicts and
    counts, and the same DEGRADE events."""
    import mlsl_tpu.supervisor as jmod
    import mlsl_tpu_torch.supervisor as tmod

    clock = _Clock(monkeypatch, [jmod, tmod])
    jstats.reset_degrade_counters()
    stats.reset_degrade_counters()
    jb = jsup.CircuitBreaker("t", threshold=3, window_s=10, cooldown_s=0.15)
    tb = supervisor.CircuitBreaker("t", threshold=3, window_s=10, cooldown_s=0.15)
    assert _drive(tb, clock, SCHEDULES[name]) == _drive(jb, clock, SCHEDULES[name])
    assert stats.DEGRADE_COUNTERS == jstats.DEGRADE_COUNTERS
    assert [(e["subsystem"], e["event"]) for e in stats.DEGRADE_EVENTS] == \
        [(e["subsystem"], e["event"]) for e in jstats.DEGRADE_EVENTS]
    jstats.reset_degrade_counters()


def test_registry_status_and_configure():
    br = supervisor.breaker("quant")
    br.record_success()
    assert supervisor.breaker("quant") is br
    st = supervisor.status()
    assert set(supervisor.SUBSYSTEMS) == set(jsup.SUBSYSTEMS) <= set(st)
    assert st["quant"]["state"] == supervisor.CLOSED and not supervisor.degraded("quant")
    supervisor.configure(threshold=7, window_s=11.0, cooldown_s=13.0)
    assert (br.threshold, br.window_s, br.cooldown_s) == (7, 11.0, 13.0)
    supervisor._breakers.pop("_fresh", None)
    assert supervisor.breaker("_fresh").threshold == 7
    supervisor._breakers.pop("_fresh", None)


def test_status_keys_match_jax(tenv, env):
    """``status()`` carries the JAX package's keys; the subsystems the port
    has not ported report what the JAX package reports with them never
    armed."""
    js, ts = jsup.status(), supervisor.status()
    assert set(ts) == set(js)
    for key in supervisor.SUBSYSTEMS:
        assert {k: ts[key][k] for k in ("state", "failures_in_window", "trips")} == \
            {k: js[key][k] for k in ("state", "failures_in_window", "trips")}, key
    for key in ("sentinel", "control", "straggler", "metrics", "analysis", "serve"):
        assert ts[key] == js[key], key
    assert ts["elastic"] == js["elastic"]
    assert set(ts["codecs"]) == set(js["codecs"])


def test_reset_all_restores_a_fresh_fault_plane(tmp_path):
    from mlsl_tpu_torch import obs
    from mlsl_tpu_torch.analysis import witness

    chaos.plan("request.start", "error", times=None)
    supervisor.configure(threshold=9, cooldown_s=0.0)
    br = supervisor.breaker("algo")
    for _ in range(9):
        br.record_failure(RuntimeError("x"))
    obs.enable()
    obs.enable_metrics()
    srv = obs.start_server(port=0, addr="127.0.0.1")
    assert srv is not None
    obs.StragglerSentinel(skew=2.0)
    supervisor.reset_all()
    c = Config()
    assert not chaos.active() and br.state == supervisor.CLOSED
    assert (br.threshold, br.window_s, br.cooldown_s) == (
        c.breaker_threshold, c.breaker_window_s, c.breaker_cooldown_s)
    assert not obs.enabled() and not obs.metrics.enabled()
    assert obs.serve.get_server() is None and obs.straggler.get_active() is None
    assert not any(stats.DEGRADE_COUNTERS.values()) and witness.report()["edges"] == {}


# -- the comm fixtures -------------------------------------------------------------


def _quick(env, tenv, cooldown=60.0):
    """A cooldown long enough that no load spike half-opens a breaker
    mid-test; ``_admit_probe`` makes the next allow() the probe."""
    env.config.breaker_cooldown_s = tenv.config.breaker_cooldown_s = cooldown
    jsup.configure(env.config)
    supervisor.configure(tenv.config)


def _admit_probe():
    jsup.configure(cooldown_s=0.0)
    supervisor.configure(cooldown_s=0.0)


def _reqs(env, tenv, n, name, kind="allreduce", comp=0, recv_count=None):
    jd = env.create_distribution(8, 1)
    td = tenv.create_distribution(8, 1)
    jr = JReq(JDesc(kind, jd.data_group, n, JDT.FLOAT, op=JRed.SUM,
                    compression=JComp(comp), recv_count=recv_count), env.dispatcher, name=name)
    tr = CommRequest(CommDesc(kind, td.data_group, n, DataType.FLOAT, op=ReductionType.SUM,
                              compression=CompressionType(comp), recv_count=recv_count),
                     tenv.dispatcher, name=name)
    jr.setup()
    tr.setup()
    return jd, td, jr, tr


def _bufs(jd, td, n, seed, integer=False):
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-40, 40, size=(8, n)) if integer
            else rng.normal(size=(8, n))).astype(np.float32)
    return (jd.make_buffer(lambda p: vals[p], n), td.make_buffer(lambda p: vals[p], n), vals)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _both(jr, tr, jb, tb, expect=None):
    """One round on each side -> (jax out or the exception type, port out or
    the exception type)."""
    res = []
    for r, b, mod in ((jr, jb, jchaos), (tr, tb, chaos)):
        try:
            res.append(_np(r.start(b).wait()))
        except Exception as e:   # the schedule's raise, compared by type name
            res.append(type(e).__name__)
    return res


def _plan_both(site, kind="error", **kw):
    jkw = dict(kw)
    if kw.get("exc") is chaos.ChaosError:
        jkw["exc"] = jchaos.ChaosError
    jchaos.plan(site, kind, **jkw)
    chaos.plan(site, kind, **kw)


def _ladder_counts():
    t = dict(stats.DEGRADE_COUNTERS), dict(stats.DEGRADE_FALLBACKS)
    j = dict(jstats.DEGRADE_COUNTERS), dict(jstats.DEGRADE_FALLBACKS)
    return t, j


# -- rung 2: transient retries -----------------------------------------------------


def test_transient_dispatch_failure_retried_in_place(env, tenv):
    jd, td, jr, tr = _reqs(env, tenv, 256, "r1")
    jb, tb, vals = _bufs(jd, td, 256, 0, integer=True)
    base = _both(jr, tr, jb, tb)
    np.testing.assert_array_equal(base[0], base[1])
    _plan_both("collective.dispatch", exc=OSError, times=2)
    out = _both(jr, tr, jb, tb)
    np.testing.assert_array_equal(out[1], base[1])
    np.testing.assert_array_equal(out[0], out[1])
    t, j = _ladder_counts()
    assert t == j and t[0]["comm_retries"] == 2
    assert supervisor.breaker("algo").state == supervisor.CLOSED


def test_transient_wait_failure_redispatches(env, tenv):
    jd, td, jr, tr = _reqs(env, tenv, 256, "r2")
    jb, tb, _ = _bufs(jd, td, 256, 1, integer=True)
    base = _both(jr, tr, jb, tb)
    _plan_both("request.wait", exc=OSError, times=1)
    out = _both(jr, tr, jb, tb)
    np.testing.assert_array_equal(out[1], base[1])
    np.testing.assert_array_equal(out[0], out[1])
    assert _ladder_counts()[0] == _ladder_counts()[1]


def test_wait_retry_rewinds_quant_residual(tenv):
    """A wait-side retry re-dispatches a round whose first dispatch already
    advanced the residual: the replay rewinds to the Start snapshot, so the
    request stays in lockstep with a fault-free twin, bit for bit."""
    td = tenv.create_distribution(8, 1)
    mk = lambda name: CommRequest(CommDesc(  # noqa: E731
        "allreduce", td.data_group, 384, DataType.FLOAT, op=ReductionType.SUM,
        compression=CompressionType.QUANTIZATION), tenv.dispatcher, name=name)
    req, ref = mk("wres"), mk("wref")
    req.setup()
    ref.setup()
    vals = np.random.default_rng(7).normal(size=(8, 384)).astype(np.float32)
    buf = td.make_buffer(lambda p: vals[p], 384)
    torch.testing.assert_close(req.start(buf).wait(), ref.start(buf).wait(), rtol=0, atol=0)
    assert req._errs[0].abs().max() > 0
    with chaos.injected("request.wait", "error", exc=OSError, times=1):
        out2 = req.start(buf).wait()
    torch.testing.assert_close(out2, ref.start(buf).wait(), rtol=0, atol=0)
    torch.testing.assert_close(req.start(buf).wait(), ref.start(buf).wait(), rtol=0, atol=0)
    assert stats.DEGRADE_COUNTERS["comm_retries"] == 1


def test_retry_exhaustion_raises_and_counts(env, tenv):
    env.config.comm_retries = tenv.config.comm_retries = 1
    jd, td, jr, tr = _reqs(env, tenv, 64, "r3")
    jb, tb, _ = _bufs(jd, td, 64, 2)
    _plan_both("collective.dispatch", exc=OSError, times=None)
    assert _both(jr, tr, jb, tb) == ["OSError", "OSError"]
    t, j = _ladder_counts()
    assert t == j and t[0]["comm_retries"] == 1


def test_fatal_errors_bypass_retry_and_breaker(env, tenv):
    jd, td, jr, tr = _reqs(env, tenv, 64, "r4", comp=int(CompressionType.QUANTIZATION))
    jb, tb, _ = _bufs(jd, td, 64, 3)
    _plan_both("codec.roundtrip", exc=ValueError)
    assert _both(jr, tr, jb, tb) == ["ValueError", "ValueError"]
    assert stats.DEGRADE_COUNTERS["comm_retries"] == 0
    assert supervisor.breaker("quant").status()["failures_in_window"] == 0


@pytest.mark.parametrize("quant", [False, True], ids=["dense_ring", "quant_ring"])
def test_kernel_failure_raises_every_round_and_never_trips_a_breaker(tenv, monkeypatch,
                                                                     quant):
    """A kernel that fails to launch is FATAL: a forced ``pallas_ring``
    request (B3, or B4 with the int8 wire) raises MLSLKernelError at every
    round, past the breaker's threshold, and no round is served degraded on
    the plain version. The wrapper's own ``_check_launch`` raises, as on the
    card; the JAX package has no such error."""
    from mlsl_tpu_torch.ops import ring_kernels as rk

    def failing(*_a, **_k):
        rk._check_launch(719, "int8 ring" if quant else "dense ring")

    monkeypatch.setattr(rk, "quant_ring" if quant else "dense_ring", failing)
    assert supervisor.classify(MLSLKernelError("x")) is supervisor.ErrorClass.FATAL
    tenv.config.collective_algo = "pallas_ring"
    tenv.config.validate()
    td = tenv.create_distribution(8, 1)
    comp = CompressionType.QUANTIZATION if quant else CompressionType.NONE
    req = CommRequest(CommDesc("allreduce", td.data_group, 256, DataType.FLOAT,
                               op=ReductionType.SUM, compression=comp),
                      tenv.dispatcher, name="kfail")
    req.setup()
    assert req.algo == "pallas_ring"
    buf = td.make_buffer(lambda p: np.full(256, float(p)), 256)
    br = supervisor.breaker("quant" if quant else "algo")
    for _ in range(2 * br.threshold + 1):
        with pytest.raises(MLSLKernelError, match="launch failed"):
            req.start(buf).wait()
    assert br.state == supervisor.CLOSED and br.status()["failures_in_window"] == 0
    assert stats.DEGRADE_FALLBACKS == {} and stats.DEGRADE_COUNTERS["comm_retries"] == 0
    # the breaker gate still builds a new request on the kernel
    req2 = CommRequest(CommDesc("allreduce", td.data_group, 128, DataType.FLOAT,
                                op=ReductionType.SUM, compression=comp),
                       tenv.dispatcher, name="kfail2")
    req2.setup()
    assert req2.algo == "pallas_ring"


def test_residual_snapshot_released_once_the_dispatch_succeeds(tenv):
    """The retry buffer and the residuals' Start snapshot outlive a
    successful dispatch only while a ``request.wait`` plan could make the
    wait retry the round; otherwise the previous residual is freed at once."""
    td = tenv.create_distribution(8, 1)
    req = CommRequest(CommDesc("allreduce", td.data_group, 384, DataType.FLOAT,
                               op=ReductionType.SUM,
                               compression=CompressionType.QUANTIZATION),
                      tenv.dispatcher, name="snap")
    req.setup()
    vals = np.random.default_rng(9).normal(size=(8, 384)).astype(np.float32)
    buf = td.make_buffer(lambda p: vals[p], 384)
    req.start(buf).wait()
    req.start(buf)
    assert req._dispatched and req._ef_snapshot is None and req._last_buf is None
    req.wait()
    with chaos.injected("request.wait", "error", exc=OSError, times=1):
        req.start(buf)
        assert req._ef_snapshot is not None and req._last_buf is buf
        req.wait()
    assert stats.DEGRADE_COUNTERS["comm_retries"] == 1
    assert req._ef_snapshot is None and req._last_buf is None


def test_device_loss_raises_without_counting(env, tenv):
    """A lost device is never retried in place nor absorbed by a breaker:
    the dispatch raises and the algo breaker counts nothing."""
    for e in (env, tenv):
        e.config.collective_algo = "rhd"
        e.config.validate()
    jd, td, jr, tr = _reqs(env, tenv, 64, "r5")
    jb, tb, _ = _bufs(jd, td, 64, 4)
    _plan_both("device.lost", times=1)
    assert _both(jr, tr, jb, tb) == ["MLSLDeviceLossError", "MLSLDeviceLossError"]
    assert supervisor.breaker("algo").status()["failures_in_window"] == 0
    assert _ladder_counts()[0] == _ladder_counts()[1]


# -- rung 3: the quant breaker -----------------------------------------------------


def _trip_rounds(jr, tr, jb, tb, site):
    """Arm ``threshold`` one-shot faults at ``site`` and run that many
    rounds on each side -> each side's outcomes."""
    thr = supervisor.breaker("quant").threshold
    for _ in range(thr):
        _plan_both(site)
    outs = [_both(jr, tr, jb, tb) for _ in range(thr)]
    jchaos.clear()
    chaos.clear()
    return outs


def test_quant_degrades_to_plain_bit_exact(env, tenv):
    """Trip the quant breaker; until the probe every round is the plain
    float32 SUM -- bit for bit the plain request's, and the JAX package's
    degraded round; the probe re-engages the codec."""
    _quick(env, tenv)
    jd, td, jr, tr = _reqs(env, tenv, 512, "qd", comp=int(CompressionType.QUANTIZATION))
    _, _, jp, tp = _reqs(env, tenv, 512, "pd")
    jb, tb, vals = _bufs(jd, td, 512, 1)
    base_q = _both(jr, tr, jb, tb)
    base_p = _both(jp, tp, jb, tb)
    np.testing.assert_array_equal(base_p[0], base_p[1])
    outs = _trip_rounds(jr, tr, jb, tb, "codec.roundtrip")
    thr = supervisor.breaker("quant").threshold
    assert [o[1] for o in outs[:-1]] == ["ChaosError"] * (thr - 1)
    assert [o[0] for o in outs[:-1]] == ["ChaosError"] * (thr - 1)
    assert supervisor.breaker("quant").state == jsup.breaker("quant").state == supervisor.OPEN
    out_d = _both(jr, tr, jb, tb)
    np.testing.assert_array_equal(out_d[1], base_p[1])
    np.testing.assert_array_equal(out_d[0], out_d[1])
    assert out_d[1].dtype == np.float32
    assert stats.DEGRADE_FALLBACKS == jstats.DEGRADE_FALLBACKS == {"quant": 2}
    assert "breaker=quant:open" in tr.describe()
    _admit_probe()
    out_h = _both(jr, tr, jb, tb)
    assert supervisor.breaker("quant").state == supervisor.CLOSED
    np.testing.assert_array_equal(out_h[1], base_q[1])
    assert "breaker" not in tr.describe()
    assert _ladder_counts()[0] == _ladder_counts()[1]


def test_quant_mid_step_fallback_flushes_live_residual(env, tenv):
    """A degrade while the request carries a live residual delivers
    sum(x_r + residual_r) once; the next degraded round is bit for bit the
    plain request's, as in the JAX package."""
    from mlsl_tpu_torch.comm.quant_ring import logical_residual

    _quick(env, tenv)
    jd, td, jr, tr = _reqs(env, tenv, 384, "qres", comp=int(CompressionType.QUANTIZATION))
    jb, tb, vals = _bufs(jd, td, 384, 2)
    _both(jr, tr, jb, tb)
    err = tr._errs[0]
    assert err.abs().max() > 0
    g = 8
    expected = (vals + logical_residual(err, g, err.shape[-1] // g, -(-384 // g),
                                        384).reshape(8, 384).numpy()).sum(axis=0)
    outs = _trip_rounds(jr, tr, jb, tb, "codec.roundtrip")
    np.testing.assert_allclose(outs[-1][1].reshape(8, -1)[0], expected, rtol=1e-5)
    np.testing.assert_allclose(outs[-1][0].reshape(8, -1)[0], expected, rtol=1e-5)
    _, _, jp, tp = _reqs(env, tenv, 384, "pres")
    plain = _both(jp, tp, jb, tb)
    again = _both(jr, tr, jb, tb)
    np.testing.assert_array_equal(again[1], plain[1])
    np.testing.assert_array_equal(again[0], again[1])


def test_degraded_dispatch_retry_flushes_residual_once(env, tenv):
    """A transiently failing degraded dispatch retries from the Start
    residuals: the residual is flushed exactly once."""
    from mlsl_tpu_torch.comm.quant_ring import logical_residual

    _quick(env, tenv)
    jd, td, jr, tr = _reqs(env, tenv, 384, "dres", comp=int(CompressionType.QUANTIZATION))
    jb, tb, vals = _bufs(jd, td, 384, 8)
    _both(jr, tr, jb, tb)
    err = tr._errs[0]
    flushed = vals + logical_residual(err, 8, err.shape[-1] // 8, 48,
                                      384).reshape(8, 384).numpy()
    expected = flushed[0]
    for p in range(1, 8):      # member order, as the plain SUM adds them
        expected = expected + flushed[p]
    for br in (supervisor.breaker("quant"), jsup.breaker("quant")):
        for _ in range(br.threshold):
            br.record_failure(RuntimeError("poisoned codec"))
    _plan_both("collective.dispatch", exc=OSError)
    out = _both(jr, tr, jb, tb)
    assert stats.DEGRADE_COUNTERS["comm_retries"] == jstats.DEGRADE_COUNTERS["comm_retries"] == 1
    np.testing.assert_array_equal(out[1].reshape(8, -1)[0], expected)
    np.testing.assert_allclose(out[0].reshape(8, -1)[0], expected, rtol=1e-5, atol=1e-6)


def test_quant_reduce_scatter_degrades_bit_exact(env, tenv):
    _quick(env, tenv)
    jd, td, jr, tr = _reqs(env, tenv, 512, "qrs", kind="reduce_scatter",
                           comp=int(CompressionType.QUANTIZATION))
    _, _, jp, tp = _reqs(env, tenv, 512, "prs", kind="reduce_scatter", recv_count=64)
    jb, tb, _ = _bufs(jd, td, 512, 3)
    base_p = _both(jp, tp, jb, tb)
    _trip_rounds(jr, tr, jb, tb, "codec.roundtrip")
    out = _both(jr, tr, jb, tb)
    np.testing.assert_array_equal(out[1], base_p[1])
    np.testing.assert_array_equal(out[0], out[1])


def test_topk_degrades_to_plain_with_flat_residual(env, tenv):
    _quick(env, tenv)
    env.config.topk_ratio = tenv.config.topk_ratio = 0.25
    jd, td, jr, tr = _reqs(env, tenv, 256, "tk", comp=int(CompressionType.TOPK))
    jb, tb, vals = _bufs(jd, td, 256, 4)
    _both(jr, tr, jb, tb)
    err = tr._errs[0].reshape(8, -1).numpy()
    assert err.shape[-1] == 256
    expected = (vals + err).sum(axis=0)
    outs = _trip_rounds(jr, tr, jb, tb, "codec.roundtrip")
    np.testing.assert_allclose(outs[-1][1].reshape(8, -1)[0], expected, rtol=1e-5)
    np.testing.assert_allclose(outs[-1][0].reshape(8, -1)[0], expected, rtol=1e-5)
    assert stats.DEGRADE_FALLBACKS == jstats.DEGRADE_FALLBACKS


def test_forced_algo_degrades_to_lax_bit_exact(env, tenv):
    _quick(env, tenv)
    for e in (env, tenv):
        e.config.collective_algo = "rhd"
        e.config.validate()
    jd, td, jr, tr = _reqs(env, tenv, 256, "fa")
    assert jr.algo == tr.algo == "rhd"
    jb, tb, _ = _bufs(jd, td, 256, 5, integer=True)
    base = _both(jr, tr, jb, tb)
    thr = supervisor.breaker("algo").threshold
    for _ in range(thr - 1):
        _plan_both("collective.dispatch")
        assert _both(jr, tr, jb, tb) == ["ChaosError", "ChaosError"]
        jchaos.clear()
        chaos.clear()
    _plan_both("collective.dispatch")
    out = _both(jr, tr, jb, tb)
    chaos.clear()
    jchaos.clear()
    np.testing.assert_array_equal(out[1], base[1])
    np.testing.assert_array_equal(out[0], out[1])
    assert supervisor.breaker("algo").state == supervisor.OPEN
    assert stats.ALGO_COUNTERS.get(("allreduce", "lax"), 0) >= 1
    _, _, _, tr2 = _reqs(env, tenv, 128, "fa2")
    assert tr2.algo == "lax"
    _admit_probe()
    out_h = _both(jr, tr, jb, tb)
    np.testing.assert_array_equal(out_h[1], base[1])
    assert supervisor.breaker("algo").state == supervisor.CLOSED
    assert _ladder_counts()[0] == _ladder_counts()[1]


# -- rung 3: bucketed -> individual ------------------------------------------------


def _bucket_session(e, dist, op_t, n=1024, layers=3):
    s = e.create_session()
    s.set_global_minibatch_size(8)
    ops = []
    for _ in range(layers):
        r = s.create_operation_reg_info(op_t.CC)
        r.add_input(8, 4)
        r.add_output(8, 4)
        r.add_parameter_set(n, 1)
        ops.append(s.get_operation(s.add_operation(r, dist)))
    s.commit()
    return s, [op.get_parameter_set(0) for op in ops]


def test_bucket_degrades_to_individual_bit_exact(env, tenv):
    _quick(env, tenv)
    env.config.grad_bucket_mb = tenv.config.grad_bucket_mb = 1
    jd, td = env.create_distribution(8, 1), tenv.create_distribution(8, 1)
    _, jpss = _bucket_session(env, jd, JOp)
    _, tpss = _bucket_session(tenv, td, OpType)
    assert tpss[0].bucket is not None
    jb, tb, _ = _bufs(jd, td, 1024, 5)

    def round_all(pss, buf):
        for ps in reversed(pss):
            ps.start_gradient_comm(buf)
        return [_np(ps.wait_gradient_comm()) for ps in pss]

    base = round_all(tpss, tb)
    for a, b in zip(round_all(jpss, jb), base):
        np.testing.assert_array_equal(a, b)
    d0 = stats.BUCKET_COUNTERS["rounds_dispatched"]
    thr = supervisor.breaker("bucket").threshold
    served = {"j": 0, "t": 0}
    for _ in range(thr):
        for key, mod, pss, buf in (("j", jchaos, jpss, jb), ("t", chaos, tpss, tb)):
            mod.plan("collective.dispatch", "error")
            try:
                r = round_all(pss, buf)
                served[key] += 1
                for a, b in zip(base, r):
                    np.testing.assert_array_equal(a, b)
            except mod.ChaosError:
                pass
            mod.clear()
    assert served == {"j": 1, "t": 1}
    assert supervisor.breaker("bucket").state == supervisor.OPEN
    for a, b in zip(base, round_all(tpss, tb)):
        np.testing.assert_array_equal(a, b)
    assert stats.BUCKET_COUNTERS["rounds_dispatched"] == d0
    _admit_probe()
    for a, b in zip(base, round_all(tpss, tb)):
        np.testing.assert_array_equal(a, b)
    round_all(jpss, jb)
    assert supervisor.breaker("bucket").state == supervisor.CLOSED
    assert stats.BUCKET_COUNTERS["rounds_dispatched"] > d0
    assert _ladder_counts()[0] == _ladder_counts()[1]


# -- rung 3: the tracer ------------------------------------------------------------


def test_tracer_breaker_degrades_exports(tmp_path, monkeypatch):
    from mlsl_tpu_torch import obs
    from mlsl_tpu_torch.obs import export

    obs.enable(capacity=1024)
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    monkeypatch.setenv("MLSL_TRACE_DIR", str(blocker / "sub"))
    br = supervisor.breaker("tracer")
    supervisor.configure(cooldown_s=60.0)
    for _ in range(br.threshold - 1):
        with pytest.raises(OSError):
            export.write_trace()
    assert export.write_trace() is None
    assert br.state == supervisor.OPEN
    assert export.write_trace() is None
    assert export.flight_record(window_s=5.0) is None
    monkeypatch.setenv("MLSL_TRACE_DIR", str(tmp_path))
    _admit_probe()
    assert export.write_trace() is not None
    assert br.state == supervisor.CLOSED


# -- the DEGRADE lines -------------------------------------------------------------


def _degrade_lines(path):
    return [" ".join(line.split()[:3]) for line in path.read_text().splitlines()
            if line.startswith("DEGRADE")]


def test_degrade_lines_match_jax(env, tenv, tmp_path, monkeypatch):
    """The same fault schedule writes the same DEGRADE lines (event and
    subsystem) in both packages' stats logs, and the printers' LADDER
    summaries agree."""
    _quick(env, tenv)
    env.config.enable_stats = tenv.config.enable_stats = True
    out = {}
    for key, e, op_t, mod in (("j", env, JOp, jchaos), ("t", tenv, OpType, chaos)):
        d = tmp_path / key
        d.mkdir()
        monkeypatch.setenv("MLSL_STATS_DIR", str(d))
        dist = e.create_distribution(8, 1)
        s, _ = _bucket_session(e, dist, op_t, n=256, layers=2)
        if key == "j":
            req = JReq(JDesc("allreduce", dist.data_group, 256, JDT.FLOAT, op=JRed.SUM,
                             compression=JComp.QUANTIZATION), e.dispatcher, name="obs1")
        else:
            req = CommRequest(CommDesc("allreduce", dist.data_group, 256, DataType.FLOAT,
                                       op=ReductionType.SUM,
                                       compression=CompressionType.QUANTIZATION),
                              e.dispatcher, name="obs1")
        req.setup()
        buf = dist.make_buffer(lambda p: np.full(256, p, np.float32), 256)
        thr = (jsup if key == "j" else supervisor).breaker("quant").threshold
        for _ in range(thr):
            mod.plan("codec.roundtrip", "error")
        for _ in range(thr - 1):
            with pytest.raises(mod.ChaosError):
                req.start(buf).wait()
        req.start(buf).wait()
        mod.clear()
        text = s.get_stats().print_(str(d / "stats_out.log"))
        out[key] = (_degrade_lines(d / "mlsl_stats.log"),
                    [line for line in text.splitlines() if line.startswith("DEGRADE")])
    assert out["t"][0] == out["j"][0] == ["DEGRADE TRIP quant"]
    assert out["t"][1] == out["j"][1]
    assert "trips 1" in out["t"][1][0] and "fallbacks quant=1" in out["t"][1][0]
    assert "quant:open" in out["t"][1][0]


def test_codec_demotion_is_a_degrade_event(tenv, tmp_path, monkeypatch):
    """A guardrail demotion is filed as a DEGRADE event (codec_demote) as
    well as in the CODEC lines, as in the JAX package."""
    monkeypatch.setenv("MLSL_STATS_DIR", str(tmp_path))
    stats.reset_codec_counters()
    stats.record_codec_demotion("ps0", "codec:vq", "guardrail")
    jstats.reset_codec_counters()
    jstats.record_codec_demotion("ps0", "codec:vq", "guardrail")
    assert [(e["subsystem"], e["event"], e["detail"]) for e in stats.DEGRADE_EVENTS] == \
        [(e["subsystem"], e["event"], e["detail"]) for e in jstats.DEGRADE_EVENTS]
    assert "DEGRADE          CODEC_DEMOTE quant" in (tmp_path / "mlsl_stats.log").read_text()
    jstats.reset_codec_counters()
    jstats.reset_degrade_counters()
    stats.reset_codec_counters()


# -- the knobs ---------------------------------------------------------------------


KNOBS = {
    "MLSL_COMM_RETRIES": ("comm_retries", "5"),
    "MLSL_COMM_RETRY_BACKOFF_S": ("comm_retry_backoff_s", "0.5"),
    "MLSL_BREAKER_THRESHOLD": ("breaker_threshold", "9"),
    "MLSL_BREAKER_WINDOW_S": ("breaker_window_s", "60"),
    "MLSL_BREAKER_COOLDOWN_S": ("breaker_cooldown_s", "2.5"),
    "MLSL_WATCHDOG_TIMEOUT": ("watchdog_timeout_s", "1.5"),
    "MLSL_TRACE": ("trace", "1"),
    "MLSL_TRACE_DIR": ("trace_dir", "/x"),
    "MLSL_TRACE_CAPACITY": ("trace_capacity", "1024"),
    "MLSL_METRICS": ("metrics", "1"),
    "MLSL_METRICS_EVERY": ("metrics_every", "5"),
    "MLSL_METRICS_PORT": ("metrics_port", "9091"),
    "MLSL_METRICS_RETENTION": ("metrics_retention", "64"),
    "MLSL_CHAOS": ("chaos_spec", "request.wait:error"),
    "MLSL_LOCK_WITNESS": ("lock_witness", "1"),
    "MLSL_LOCK_WITNESS_BUDGET_MS": ("lock_witness_budget_ms", "40"),
    "MLSL_STRAGGLER_SKEW": ("straggler_skew", "1.5"),
    "MLSL_STRAGGLER_EVERY": ("straggler_every", "7"),
    "MLSL_STRAGGLER_SUSTAIN": ("straggler_sustain", "3"),
    "MLSL_STRAGGLER_SHED": ("straggler_shed", "1"),
    "MLSL_PROFILE_ON_TRIP": ("profile_on_trip", "1"),
}


@pytest.mark.parametrize("var", sorted(KNOBS))
def test_knob_from_env_matches_jax(var, monkeypatch):
    field, value = KNOBS[var]
    assert getattr(Config(), field) == getattr(JConfig(), field)
    monkeypatch.setenv(var, value)
    assert getattr(Config.from_env(), field) == getattr(JConfig.from_env(), field)


BAD = [("MLSL_BREAKER_THRESHOLD", "0"), ("MLSL_BREAKER_WINDOW_S", "-1"),
       ("MLSL_WATCHDOG_TIMEOUT", "-2"), ("MLSL_METRICS_EVERY", "0"),
       ("MLSL_METRICS_PORT", "70000"), ("MLSL_METRICS_RETENTION", "1"),
       ("MLSL_STRAGGLER_SKEW", "0.5"), ("MLSL_STRAGGLER_EVERY", "2"),
       ("MLSL_STRAGGLER_SUSTAIN", "0"), ("MLSL_LOCK_WITNESS_BUDGET_MS", "0")]


@pytest.mark.parametrize("var,value", BAD)
def test_knob_validation_matches_jax(var, value, monkeypatch):
    from mlsl_tpu.log import MLSLError as JError

    monkeypatch.setenv(var, value)
    with pytest.raises(JError):
        JConfig.from_env().validate()
    with pytest.raises(MLSLError, match=var):
        Config.from_env().validate()


def test_env_init_configures_breakers(monkeypatch):
    monkeypatch.setenv("MLSL_BREAKER_THRESHOLD", "5")
    br = supervisor.breaker("algo")
    e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert br.threshold == 5
    finally:
        e.finalize()


def test_env_init_hands_the_fault_plane_its_config(monkeypatch, tmp_path):
    """Environment.init hands its Config to the modules that act on the
    fault plane's knobs; they read the live Config (a change to it takes
    effect), and finalize hands them back to their environment variables.
    A rebuilt Environment does not re-arm a spent chaos budget."""
    from mlsl_tpu_torch import obs
    from mlsl_tpu_torch.analysis import witness
    from mlsl_tpu_torch.obs import straggler

    for var, value in (("MLSL_TRACE", "1"), ("MLSL_TRACE_CAPACITY", "1024"),
                       ("MLSL_TRACE_DIR", str(tmp_path)), ("MLSL_CHAOS", "request.start:error"),
                       ("MLSL_LOCK_WITNESS", "1"), ("MLSL_LOCK_WITNESS_BUDGET_MS", "40"),
                       ("MLSL_STRAGGLER_SKEW", "1.5"), ("MLSL_STRAGGLER_EVERY", "7"),
                       ("MLSL_STRAGGLER_SUSTAIN", "3"), ("MLSL_STRAGGLER_SHED", "1"),
                       ("MLSL_PROFILE_ON_TRIP", "1")):
        monkeypatch.setenv(var, value)
    e = Environment.get_env().init(device="cpu", world_size=8)
    for var in ("MLSL_TRACE_DIR", "MLSL_LOCK_WITNESS", "MLSL_LOCK_WITNESS_BUDGET_MS",
                "MLSL_STRAGGLER_SKEW", "MLSL_STRAGGLER_EVERY", "MLSL_STRAGGLER_SUSTAIN",
                "MLSL_STRAGGLER_SHED", "MLSL_PROFILE_ON_TRIP"):
        monkeypatch.delenv(var)
    try:
        tr = obs.get_tracer()
        assert tr is not None and tr.capacity == 1024
        assert obs.trace_dir() == str(tmp_path)
        (armed,) = chaos._plans["request.start"]
        assert witness.armed() and witness._budget_s() == pytest.approx(0.04)
        assert straggler.armed()
        s = straggler.StragglerSentinel()
        assert (s.skew, s.every, s.sustain, s.shed) == (1.5, 7, 3, True)
        from mlsl_tpu_torch.core import stats as tstats

        assert tstats._config is e.config
        e.config.lock_witness_budget_ms = 80.0
        e.config.straggler_skew = 0.0
        assert witness._budget_s() == pytest.approx(0.08) and not straggler.armed()
        with pytest.raises(chaos.ChaosError):
            chaos.inject("request.start")
        chaos.inject("request.start")     # its budget of one is spent
    finally:
        e.finalize()
    assert obs.trace_dir() == "." and not witness.armed() and not straggler.armed()
    e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        chaos.inject("request.start")     # not armed again
        assert armed.fires == 1
    finally:
        e.finalize()


# -- the %p grammar ----------------------------------------------------------------


def test_probabilistic_grammar_matches_jax():
    spec = ("collective.dispatch:error%0.05,request.wait:error=oserror"
            "x*%0.5,data.prefetch:delay=0.01@2x3%0.25")
    tp = chaos.refresh_from_env(spec)
    jp = jchaos.refresh_from_env(spec)
    key = lambda p: (p.site, p.kind, p.exc.__name__, p.after, p.times, p.prob)  # noqa: E731
    assert sorted(map(key, tp)) == sorted(map(key, jp))


def test_probabilistic_fire_schedule_matches_jax():
    """The same seed gives the same fire schedule in both registries."""
    fires = {}
    for key, mod in (("t", chaos), ("j", jchaos)):
        mod.seed(1234)
        p = mod.plan("request.start", "error", prob=0.3, times=None)
        sched = []
        for _ in range(400):
            try:
                mod.inject("request.start")
                sched.append(0)
            except mod.ChaosError:
                sched.append(1)
        assert p.hits == 400 and p.fires == sum(sched)
        fires[key] = sched
        mod.clear()
    assert fires["t"] == fires["j"]
    assert 60 <= sum(fires["t"]) <= 180


def test_probability_validated():
    for bad in (1.5, 0.0):
        with pytest.raises(ValueError, match="probability"):
            chaos.plan("request.start", "error", prob=bad)


def test_hier_quant_degrades_with_the_tier_residual(monkeypatch):
    """The breaker's degrade of a ``hier`` request (MLSL_MESH_TIERS=2x4,
    MLSL_ALGO=hier): the tripped round flushes each member's own-shard
    residual (``hier.flush_residual``) into the plain float32 SUM, within
    1e-5 relative of the JAX package's degraded round; the next degraded
    round, its residual consumed, is the plain SUM bit for bit on both."""
    from mlsl_tpu.comm import collectives as jcoll
    from mlsl_tpu.core.environment import Environment as JEnv

    monkeypatch.setenv("MLSL_MESH_TIERS", "2x4")
    monkeypatch.setenv("MLSL_ALGO", "hier")
    JEnv.get_env().finalize()
    jcoll.clear_cache()
    jenv = JEnv.get_env().init()
    tenv = Environment.get_env().init(device="cpu", world_size=8)
    try:
        n = 8 * 1024
        jd, td, jr, tr = _reqs(jenv, tenv, n, "hq", comp=int(CompressionType.QUANTIZATION))
        assert jr.algo == tr.algo == "hier" and tr._err_layout == "hier"
        jb, tb, vals = _bufs(jd, td, n, 11)
        _both(jr, tr, jb, tb)
        assert tr._errs[0].abs().max() > 0
        for br in (supervisor.breaker("quant"), jsup.breaker("quant")):
            for _ in range(br.threshold):
                br.record_failure(RuntimeError("poisoned dcn codec"))
        out = _both(jr, tr, jb, tb)
        np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-5)
        assert stats.DEGRADE_FALLBACKS == jstats.DEGRADE_FALLBACKS == {"quant": 1}
        again = _both(jr, tr, jb, tb)
        exact = vals[0]
        for p in range(1, 8):
            exact = exact + vals[p]
        np.testing.assert_array_equal(again[1].reshape(8, -1)[0], exact)
        np.testing.assert_array_equal(again[0], again[1])
    finally:
        tenv.finalize()
        jenv.finalize()
        jcoll.clear_cache()
