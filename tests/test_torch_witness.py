"""The port's runtime lock witness (mlsl_tpu_torch.analysis.witness) and the
shared diagnostic format against the JAX package's, mirroring the witness
tests of tests/test_concurrency.py (:210-368).

Each test runs the same lock schedule under both witnesses (armed through
``MLSL_LOCK_WITNESS``, set with monkeypatch) and compares what they report:
the order edges, the cycles, the over-budget holds and the LOCKWITNESS
counters, equal. The static halves of the agreement tests (the A21x lock
analyzer) wait for ROADMAP A.7d; here the dynamic half runs alone. Timing:
the over-budget holds sleep five times the budget, the Condition waiter
waits with a 5 s timeout for a notify issued at once.
"""

import json
import threading
import time

import pytest

from mlsl_tpu.analysis import diagnostics as jdiag
from mlsl_tpu.analysis import witness as jwitness
from mlsl_tpu.core import stats as jstats
from mlsl_tpu_torch import supervisor
from mlsl_tpu_torch.analysis import diagnostics, witness
from mlsl_tpu_torch.core import stats

MODS = ((witness, stats), (jwitness, jstats))


@pytest.fixture(autouse=True)
def _isolated():
    supervisor.reset_all()
    yield
    supervisor.reset_all()
    jwitness.reset()
    jstats.reset_lock_witness_counters()
    jstats.reset_analysis_counters()
    jdiag.reset()


@pytest.fixture()
def armed(monkeypatch):
    monkeypatch.setenv(witness.ENV_ARM, "1")
    monkeypatch.delenv(witness.ENV_BUDGET_MS, raising=False)
    monkeypatch.delenv(witness.ENV_SINK, raising=False)
    for w, s in MODS:
        w.reset()
        s.reset_lock_witness_counters()


def _strip(rep):
    """A report without its times and thread names."""
    return {
        "armed": rep["armed"],
        "edges": sorted(rep["edges"]),
        "cycles": [c["cycle"] for c in rep["cycles"]],
        "over_budget": sorted(rep["over_budget"]),
    }


def _both(fn):
    """Run ``fn(witness module)`` on each package -> (port, jax) stripped
    reports with the counters."""
    out = []
    for w, s in MODS:
        fn(w)
        out.append((_strip(w.report()), dict(s.LOCKWITNESS_COUNTERS)))
    return out


def test_disarmed_returns_plain_primitives(monkeypatch):
    monkeypatch.delenv(witness.ENV_ARM, raising=False)
    assert type(witness.named_lock("x")) is type(threading.Lock())
    assert type(witness.named_rlock("x")) is type(threading.RLock())
    assert isinstance(witness.named_condition("x"), threading.Condition)
    assert not witness.armed()


def test_records_edges(armed):
    def run(w):
        a, b = w.named_lock("a"), w.named_lock("b")
        with a:
            with b:
                pass

    t, j = _both(run)
    assert t == j
    assert t[0]["edges"] == ["a->b"] and not t[0]["cycles"]
    assert t[1]["acquisitions"] == 2 and t[1]["edges_observed"] == 1


def test_detects_cross_order_cycle(armed):
    def run(w):
        a, b = w.named_lock("cyc.a"), w.named_lock("cyc.b")
        with a:
            with b:
                pass

        def other():
            with b:
                with a:
                    pass

        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=5)
        assert not th.is_alive()

    t, j = _both(run)
    assert t == j
    assert t[0]["cycles"] and {"cyc.a", "cyc.b"} <= set(t[0]["cycles"][0])
    assert t[1]["cycles_detected"] == 1


def test_over_budget_hold(armed, monkeypatch):
    monkeypatch.setenv(witness.ENV_BUDGET_MS, "10")

    def run(w):
        with w.named_lock("slowpoke"):
            time.sleep(0.05)

    t, j = _both(run)
    assert t == j and t[0]["over_budget"] == ["slowpoke"]
    assert witness.report()["over_budget"]["slowpoke"]["held_ms"] >= 10
    assert t[1]["over_budget_holds"] == 1


def test_reentrant_counts_one_acquisition(armed):
    def run(w):
        rl = w.named_rlock("re")
        with rl:
            with rl:
                pass

    t, j = _both(run)
    assert t == j and not t[0]["cycles"] and t[1]["acquisitions"] == 1


def test_condition_wrapping(armed):
    cv = witness.named_condition("cond")
    hit = []

    def waiter():
        with cv:
            while not hit:
                cv.wait(timeout=5)

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    with cv:
        hit.append(True)
        cv.notify()
    th.join(timeout=5)
    assert not th.is_alive()


def test_sink_jsonl(armed, monkeypatch, tmp_path):
    sink = tmp_path / "witness.jsonl"
    monkeypatch.setenv(witness.ENV_SINK, str(sink))
    monkeypatch.setenv(witness.ENV_BUDGET_MS, "1")
    with witness.named_lock("sinky"):
        time.sleep(0.02)
    lines = [json.loads(x) for x in sink.read_text().splitlines()]
    assert any(e["kind"] == "over_budget" and e["lock"] == "sinky" for e in lines)


def test_lockwitness_metrics_family(armed):
    from mlsl_tpu_torch.obs import metrics

    reg = metrics.enable(every=1)
    with witness.named_lock("fam"):
        pass
    reg.sample_families()
    text = reg.to_prometheus()
    for name in ("mlsl_lockwitness_acquisitions", "mlsl_lockwitness_edges_observed",
                 "mlsl_lockwitness_cycles_detected", "mlsl_lockwitness_over_budget_holds"):
        assert name in text, name


def test_lockwitness_line_in_stats_log(armed, tmp_path):
    a, b = witness.named_lock("l.a"), witness.named_lock("l.b")
    with a:
        with b:
            pass
    assert "LOCKWITNESS      EDGES_OBSERVED   l.a->l.b" in (tmp_path / "mlsl_stats.log").read_text()


def test_the_ports_named_locks_record_no_cycle(armed):
    """The shipped locks under the witness: the breaker registry and the
    breakers (created armed), driven as the ladder drives them, record edges
    but no cycle."""
    supervisor._breakers.clear()
    for name in ("quant", "bucket"):
        br = supervisor.breaker(name)
        assert isinstance(br._lock, witness.WitnessLock)
        br.record_failure(RuntimeError("x"))
        br.record_success()
    supervisor.reset()
    assert not witness.report()["cycles"]
    assert stats.LOCKWITNESS_COUNTERS["acquisitions"] >= 4
    supervisor._breakers.clear()


# -- the diagnostic format -------------------------------------------------------------


def test_codes_and_report_match_jax():
    assert diagnostics.CODES == jdiag.CODES
    reps = []
    for d in (diagnostics, jdiag):
        r = d.Report("lint")
        r.add("A201", "raw collective", "x.py:3")
        r.add("MLSL-A103", "budget", "graph:op0")
        reps.append(r)
    t, j = reps
    assert t.format() == j.format() and t.summary() == j.summary()
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    assert [x.code for x in t.errors] == ["MLSL-A201"]
    assert [x.code for x in t.warnings] == ["MLSL-A103"]


def test_record_and_status_match_jax(tmp_path):
    from mlsl_tpu_torch import obs

    obs.enable(capacity=64)
    for d in (diagnostics, jdiag):
        r = d.Report("plan")
        r.add("A110", "straddle", "graph:ps1")
        d.record(r, duration_s=0.001)
    strip = lambda st: {k: {kk: vv for kk, vv in v.items() if kk != "at"}  # noqa: E731
                        for k, v in st.items()}
    assert strip(diagnostics.status()) == strip(jdiag.status())
    assert supervisor.status()["analysis"]["plan"]["verdict"] == "fail"
    assert stats.ANALYSIS_COUNTERS == jstats.ANALYSIS_COUNTERS
    assert "ANALYSIS         plan     FAIL" in (tmp_path / "mlsl_stats.log").read_text()
    names = [e[1] for e in obs.get_tracer().snapshot()]
    assert names == ["analysis.finding", "analysis.verdict"]
