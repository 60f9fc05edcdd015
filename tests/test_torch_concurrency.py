"""The port's lock-order analyzer (mlsl_tpu_torch.analysis.locks) and
protocol model checker (mlsl_tpu_torch.analysis.protocol) against the JAX
package's, anchored on the static and protocol tests of
tests/test_concurrency.py (:80-193, :394-476).

- The A21x fixtures and rule units: the same source goes to both analyzers,
  which must report the same codes at the same lines (anchors). The torch
  forms of the blocking and dispatch markers (``synchronize``, ``replay``, a
  CUDA event's ``wait()``) are stated apart: the reference has no such
  calls.
- The shipped tree: ``locks.analyze_tree()`` over ``mlsl_tpu_torch/`` at 0
  errors and 0 warnings; static and runtime witness agree on the cycle
  fixture and on the shipped breaker and elastic registries.
- A15x: for each shipped model and each fixture model, ``explore`` reaches
  the same verdict over the same number of states and the same depth in
  both packages; the memo, the truncation warning and the commit gate.
"""

import importlib.util
import threading
import time
from pathlib import Path

import pytest
import torch

from mlsl_tpu.analysis import diagnostics as jdiag
from mlsl_tpu.analysis import locks as jlocks
from mlsl_tpu.analysis import protocol as jprotocol
from mlsl_tpu.core import stats as jstats
from mlsl_tpu_torch import supervisor
from mlsl_tpu_torch.analysis import diagnostics, locks, protocol, witness
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.types import CompressionType, OpType

torch.set_num_threads(2)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "analysis"

LOCK_FIXTURES = (
    ("lock_order_cycle", "MLSL-A210"),
    ("lock_held_blocking", "MLSL-A211"),
    ("unlocked_thread_state", "MLSL-A212"),
    ("cond_wait_no_loop", "MLSL-A213"),
    ("daemon_no_join", "MLSL-A214"),
)

PROTOCOL_FIXTURES = (
    ("deadlocking_protocol", "MLSL-A150"),
    ("dual_leader_protocol", "MLSL-A151"),
    ("lost_drain_ack_protocol", "MLSL-A152"),
)


def _source(name):
    return (FIXTURES / f"{name}.py").read_text()


def load_fixture(name):
    spec = importlib.util.spec_from_file_location(f"torch_concurrency_fixture_{name}",
                                                  FIXTURES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _isolated():
    supervisor.reset_all()
    protocol.reset()
    yield
    supervisor.reset_all()
    protocol.reset()
    jprotocol.reset()
    jdiag.reset()
    jstats.reset_analysis_counters()


@pytest.fixture()
def armed_witness(monkeypatch):
    monkeypatch.setenv(witness.ENV_ARM, "1")
    monkeypatch.delenv(witness.ENV_BUDGET_MS, raising=False)
    monkeypatch.delenv(witness.ENV_SINK, raising=False)
    witness.reset()
    stats.reset_lock_witness_counters()
    yield
    witness.reset()
    stats.reset_lock_witness_counters()


def both(src, rel):
    """-> (port, reference) findings as [(code, severity, anchor)]."""
    out = []
    for mod in (locks, jlocks):
        rep = mod.analyze_source(src, rel)
        out.append([(d.code, d.severity, d.anchor) for d in rep.diagnostics])
    return out


# -- A21x: the fixtures and rule units on the same sources -------------------------------


@pytest.mark.parametrize("name,code", LOCK_FIXTURES, ids=[n for n, _ in LOCK_FIXTURES])
def test_lock_fixture_pinned(name, code):
    got, want = both(_source(name), name + ".py")
    assert got == want
    assert [c for c, _, _ in got] == [code] * len(got) and got
    assert all(sev == diagnostics.CODES[code][0] for _, sev, _ in got)


def test_a210_cycle_names_both_locks():
    rep = locks.analyze_source(_source("lock_order_cycle"), "lock_order_cycle.py")
    (d,) = rep.diagnostics
    assert "_state_lock" in d.message and "_queue_lock" in d.message


def test_a211_reports_each_blocking_site_once():
    rep = locks.analyze_source(_source("lock_held_blocking"), "lock_held_blocking.py")
    assert len(rep.errors) == 2, rep.format()
    assert sorted(d.message.split("'")[1] for d in rep.errors) == ["get", "time.sleep"]


UNIT_SOURCES = {
    "bounded_variants": (
        "import threading\n"
        "import queue\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._q = queue.Queue()\n"
        "    def pump(self, d):\n"
        "        with self._lock:\n"
        "            x = self._q.get(timeout=0.1)\n"
        "            k = d.get('key')\n"
        "            s = ','.join(['a'])\n"
        "            return x, k, s\n"),
    "wait_in_while": (
        "import threading\n"
        "class M:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._cv = threading.Condition(self._lock)\n"
        "        self._item = None\n"
        "    def take(self):\n"
        "        with self._cv:\n"
        "            while self._item is None:\n"
        "                self._cv.wait()\n"
        "            return self._item\n"),
    "joined_daemon": (
        "import threading\n"
        "class F:\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=self._loop, daemon=True)\n"
        "        self._t.start()\n"
        "    def _loop(self):\n"
        "        pass\n"
        "    def shutdown(self):\n"
        "        self._t.join(timeout=5)\n"),
    "pragma": (
        "import threading\n"
        "import time\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def hold(self):\n"
        "        with self._lock:\n"
        "            # mlsl-lint: disable=A211 -- deliberate test hold\n"
        "            time.sleep(0.5)\n"),
    "witness_factory": (
        "import time\n"
        "from mlsl_tpu_torch.analysis import witness\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        self._lock = witness.named_lock('w')\n"
        "    def hold(self):\n"
        "        with self._lock:\n"
        "            time.sleep(0.5)\n"),
    "reference_dispatch_marker": (
        "import threading, jax\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def drain(self, x):\n"
        "        with self._lock:\n"
        "            jax.block_until_ready(x)\n"),
}


@pytest.mark.parametrize("name", list(UNIT_SOURCES))
def test_lock_rule_units_match_reference(name):
    got, want = both(UNIT_SOURCES[name], "w.py")
    assert got == want
    assert bool(got) == (name in ("witness_factory", "reference_dispatch_marker"))


TORCH_MARKERS = [
    # host blocking on the card under a lock: A211
    ("        with self._lock:\n            torch.cuda.synchronize()\n", [9]),
    ("        with self._lock:\n            self._ev.synchronize()\n", [9]),
    ("        with self._lock:\n            torch.cuda.current_stream().synchronize()\n", [9]),
    # a CUDA graph's replay is a dispatch: A211
    ("        with self._lock:\n            self._graph.replay()\n", [9]),
    # a CUDA event's wait() is a stream wait: the host does not block
    ("        with self._lock:\n            self._ev.wait()\n", []),
    ("        ev = torch.cuda.current_stream().record_event()\n"
     "        with self._lock:\n            ev.wait(torch.cuda.current_stream())\n"
     "            ev.wait()\n", []),
    # a threading.Event's zero-argument wait() still blocks: A211
    ("        with self._lock:\n            self._stop.wait()\n", [9]),
]


@pytest.mark.parametrize("body,lines", TORCH_MARKERS,
                         ids=["synchronize", "event_sync", "stream_sync", "replay",
                              "cuda_event_wait", "record_event_wait", "thread_event_wait"])
def test_torch_blocking_markers(body, lines):
    """The torch forms of the reference's markers, stated apart: the
    reference has no synchronize, replay or CUDA event."""
    src = ("import threading, torch\n"
           "class W:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "        self._ev = torch.cuda.Event()\n"
           "        self._stop = threading.Event()\n"
           "    def run(self):\n"
           + body)
    rep = locks.analyze_source(src, "w.py")
    assert [(d.code, d.anchor) for d in rep.diagnostics] == \
        [("MLSL-A211", f"w.py:{n}") for n in lines], src + rep.format()


def test_torch_blocking_propagates_through_calls():
    """A call, under a lock, into a function that synchronizes with the
    card is A211 at the call, as a call into a reference dispatch is."""
    src = ("import threading, torch\n"
           "class W:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "    def _drain(self):\n"
           "        torch.cuda.synchronize()\n"
           "    def run(self):\n"
           "        with self._lock:\n"
           "            self._drain()\n")
    rep = locks.analyze_source(src, "w.py")
    assert [(d.code, d.anchor) for d in rep.diagnostics] == [("MLSL-A211", "w.py:9")]
    assert "synchronize" in rep.diagnostics[0].message


def test_shipped_tree_locks_clean():
    """The port's whole package at 0 errors / 0 warnings: every deliberate
    hold carries a same-line pragma with its reason."""
    rep = locks.analyze_tree()
    assert not rep.diagnostics, rep.format()


def test_locks_in_codes_table_and_status():
    for code in ("MLSL-A210", "MLSL-A211", "MLSL-A212", "MLSL-A213", "MLSL-A214",
                 "MLSL-A150", "MLSL-A151", "MLSL-A152", "MLSL-A153"):
        assert diagnostics.CODES[code] == jdiag.CODES[code]
    rep = locks.analyze_tree()
    diagnostics.record(rep)
    st = diagnostics.status()
    assert st["locks"]["verdict"] == "pass"
    assert st["protocol"]["verdict"] == "never_ran"


def test_agreement_on_the_cycle_fixture(armed_witness):
    rep = locks.analyze_source(_source("lock_order_cycle"), "lock_order_cycle.py")
    assert rep.codes() == ["MLSL-A210"]
    state_lock = witness.named_lock("fixture.state")
    queue_lock = witness.named_lock("fixture.queue")
    with state_lock:
        with queue_lock:
            pass

    def snapshot():
        with queue_lock:
            with state_lock:
                pass

    t = threading.Thread(target=snapshot)
    t.start()
    t.join(timeout=5)
    dyn = witness.report()
    assert dyn["cycles"], "the witness must confirm the static A210 finding"
    assert {"fixture.state", "fixture.queue"} <= set(dyn["cycles"][0]["cycle"])


def test_agreement_on_the_shipped_tree(armed_witness):
    static = locks.analyze_tree()
    assert not any(d.code == "MLSL-A210" for d in static.diagnostics)
    from mlsl_tpu_torch import elastic

    for name in ("quant", "bucket"):
        br = supervisor.breaker(name)
        br.record_failure()
        br.record_success()
    elastic._set_active([0, 1])
    elastic._set_active(None)
    supervisor.reset()
    assert not witness.report()["cycles"]


# -- A15x: the protocol model checker ---------------------------------------------------


def _port_model(jm):
    """The reference fixture's model as the port's Model (same functions)."""
    return protocol.Model(jm.name, jm.initial, jm.transitions, invariant=jm.invariant,
                          done=jm.done, quiescence=jm.quiescence)


def _explored(rep):
    return rep.explored_states, rep.explored_depth, sorted(findings_of(rep))


def findings_of(rep):
    return {(d.code, d.severity, d.anchor) for d in rep.diagnostics}


@pytest.mark.parametrize("name,code", PROTOCOL_FIXTURES, ids=[n for n, _ in PROTOCOL_FIXTURES])
def test_protocol_fixture_pinned(name, code):
    fx = load_fixture(name)
    want = jprotocol.explore(fx.build_model())
    got = protocol.explore(_port_model(fx.build_model()))
    assert got.codes() == [code], got.format()
    assert all("[trace:" in d.message for d in got.diagnostics)
    assert _explored(got) == _explored(want)
    assert [d.message for d in got.diagnostics] == [d.message for d in want.diagnostics]


@pytest.mark.parametrize("model", ["membership_drain_model", "elastic_model"])
def test_shipped_models_match_reference(model):
    got = protocol.explore(getattr(protocol, model)())
    want = jprotocol.explore(getattr(jprotocol, model)())
    assert not got.diagnostics, got.format()
    assert _explored(got) == _explored(want)
    assert got.explored_states > 1


def test_shipped_protocols_exhaustively_clean():
    protocol.reset()
    rep = protocol.check_protocols()
    assert not rep.diagnostics, rep.format()
    assert rep.explored_states >= 100
    assert rep.explored_depth < protocol.DEFAULT_MAX_DEPTH
    jprotocol.reset()
    want = jprotocol.check_protocols()
    assert (rep.explored, rep.explored_states, rep.explored_depth) == \
        (want.explored, want.explored_states, want.explored_depth)


@pytest.mark.parametrize("max_depth,max_states", [(2, None), (None, 3)])
def test_protocol_truncation_warns(max_depth, max_states):
    fx = load_fixture("deadlocking_protocol")
    got = protocol.explore(_port_model(fx.build_model()), max_states=max_states,
                           max_depth=max_depth)
    want = jprotocol.explore(fx.build_model(), max_states=max_states, max_depth=max_depth)
    assert any(d.severity == "warn" and d.code == "MLSL-A153" for d in got.diagnostics)
    assert _explored(got) == _explored(want)
    m = protocol.membership_drain_model()
    got = protocol.explore(m, max_states=max_states, max_depth=max_depth)
    want = jprotocol.explore(jprotocol.membership_drain_model(), max_states=max_states,
                             max_depth=max_depth)
    assert "MLSL-A153" in got.codes() and _explored(got) == _explored(want)


def test_protocol_bounds_from_the_environment(monkeypatch):
    monkeypatch.setenv(protocol.ENV_MAX_STATES, "40")
    monkeypatch.setenv(protocol.ENV_MAX_DEPTH, "64")
    got = protocol.check_protocols()
    assert "MLSL-A153" in got.codes()
    jprotocol.reset()
    want = jprotocol.check_protocols()
    assert (got.explored, sorted(findings_of(got))) == (want.explored, sorted(findings_of(want)))


def test_protocol_memoized_across_commits():
    protocol.reset()
    t0 = time.perf_counter()
    first = protocol.check_protocols()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = protocol.check_protocols()
    second_s = time.perf_counter() - t0
    assert second is first
    assert second_s < max(0.01, first_s / 10)


def _commit(env, verify):
    s = env.create_session()
    s.set_global_minibatch_size(8)
    r = s.create_operation_reg_info(OpType.CC)
    r.set_name("op0")
    r.add_output(8, 4)
    r.add_parameter_set(2048, 1, distributed_update=False,
                        compression_type=CompressionType.NONE)
    s.get_operation(s.add_operation(r, env.create_distribution(8, 1)))
    env.config.verify = verify
    s.commit()
    return s


def test_commit_gate_runs_protocol_check():
    """MLSL_VERIFY=1 at Session.commit runs the protocol checker next to the
    plan verifier: both verdicts land in supervisor.status()'s analysis key,
    and a second commit reads the memo."""
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        _commit(env, False)
        assert diagnostics.status()["protocol"]["verdict"] == "never_ran"
        _commit(env, True)
        st = supervisor.status()["analysis"]
        assert st["plan"]["verdict"] == "pass" and st["protocol"]["verdict"] == "pass"
        memo = protocol.check_protocols()
        _commit(env, True)
        assert protocol.check_protocols() is memo
    finally:
        env.finalize()


def test_shipped_membership_model_lossy_but_acked():
    rep = protocol.explore(protocol.membership_drain_model())
    assert not rep.diagnostics, rep.format()


def test_membership_mirror_matches_the_port_plane():
    """The models mirror control/plane.py's rules: the commit fence
    (strictly newer epoch AND the lowest surviving sender), the commit and
    drain application and the drain decision. The port's plane holds them
    line for line as the reference does, so one mirror stands for both."""
    import inspect

    from mlsl_tpu.control import plane as jplane
    from mlsl_tpu_torch.control import plane

    for name in ("_fence", "_apply_commit", "_propose_to", "_maybe_commit", "_on_notice",
                 "_decide_drain", "_apply_drain", "_flush_notice"):
        src = inspect.getsource(getattr(plane.ControlPlane, name))
        jsrc = inspect.getsource(getattr(jplane.ControlPlane, name))
        assert src.replace("mlsl_tpu_torch", "mlsl_tpu") == jsrc, name
