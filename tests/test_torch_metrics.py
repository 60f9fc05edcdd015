"""The port's telemetry plane (mlsl_tpu_torch.obs.metrics / serve /
straggler) against the JAX package's, mirroring tests/test_metrics.py.

- The registry: the same operations on both registries give the same
  values, percentiles, Prometheus text and JSON-lines snapshot (timestamps
  aside), equal.
- The straggler sentinel: the same observation schedule gives the same
  verdicts, flags, candidates and counters.
- The scrape surface: the port's server on 127.0.0.1, port 0; /metrics
  parses as Prometheus text, /healthz is ``supervisor.status()`` verbatim.
- The trainer's per-step feed and its straggler arming are held in
  tests/test_torch_integrity.py; the elastic shed hand-off waits for ROADMAP
  A.7c (tests/test_metrics.py:430-496); the JAX package's bench and
  trace_view smokes test its harness.
"""

import json
import os
import re
import tracemalloc
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mlsl_tpu.core import stats as jstats
from mlsl_tpu.obs import metrics as jmetrics
from mlsl_tpu.obs import straggler as jstraggler
from mlsl_tpu_torch import supervisor
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.obs import metrics as metrics_mod
from mlsl_tpu_torch.obs import serve as serve_mod
from mlsl_tpu_torch.obs import straggler as straggler_mod
from mlsl_tpu_torch.types import DataType, ReductionType

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _isolated():
    supervisor.reset_all()
    yield
    supervisor.reset_all()
    jmetrics.disable()
    jstraggler.reset()
    jstats.reset_straggler_counters()


@pytest.fixture()
def registries():
    """Fresh armed registries -> (port, jax)."""
    metrics_mod.disable()
    jmetrics.disable()
    return (metrics_mod.enable(every=2, retention=16), jmetrics.enable(every=2, retention=16))


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _feed(r):
    r.inc("c", 2)
    r.inc("c")
    r.set("g", 1.5)
    r.set("g", 2.5)
    r.inc("dispatches", 1, algo="lax")
    r.inc("dispatches", 5, algo="rhd")
    r.inc("d2", 1, a="1", b="2")
    r.inc("d2", 1, b="2", a="1")
    h = r.histogram("lat", buckets=(1.0, 2.0, 4.0, 8.0))
    for v in (0.5, 1.5, 3.0, 3.5, 7.0, 1e9):
        h.observe(v)
    r.histogram("empty")
    r.set("mlsl_gauge", -1.25, shard="0")
    h = r.histogram("mlsl_lat_ms", labels_x="a b")
    for v in (0.05, 3.0, 77.0, 1e6):
        h.observe(v)
    r.set("odd-name.x", 3.0, **{"lab-el": 'q"u\\o'})


def test_registry_matches_jax(registries):
    t, j = registries
    _feed(t)
    _feed(j)
    assert t.find("c").value == j.find("c").value == 3
    assert t.find("dispatches", algo="rhd").value == 5 and t.find("dispatches") is None
    assert t.find("d2", a="1", b="2").value == 2
    for name, kw in (("lat", {}), ("empty", {}), ("mlsl_lat_ms", {"labels_x": "a b"})):
        th, jh = t.find(name, **kw), j.find(name, **kw)
        for pct in (50, 95, 99, 99.9):
            assert th.percentile(pct) == jh.percentile(pct)
        assert th.snapshot() == jh.snapshot()
    assert t.find("lat").percentile(99.9) == 8.0 and t.find("empty").percentile(99) == 0.0
    assert t.to_prometheus() == j.to_prometheus()
    strip = lambda s: [{k: v for k, v in json.loads(line).items() if k != "t"}  # noqa: E731
                       for line in s.splitlines()]
    assert strip(t.jsonl_snapshot()) == strip(j.jsonl_snapshot())
    ts, js = t.sample(ts=100.0), j.sample(ts=100.0)
    assert ts == js
    assert {k: v for k, v in t.status().items() if k != "last_sample_at"} == \
        {k: v for k, v in j.status().items() if k != "last_sample_at"}


def _assert_valid_prometheus(text):
    metric = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.e+\-]+$|'
                        r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [+-]?Inf$')
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            assert line.split()[3] in ("counter", "gauge", "histogram")
            continue
        assert metric.match(line), line


def test_prometheus_exposition_valid(registries):
    t, _ = registries
    _feed(t)
    text = t.to_prometheus()
    _assert_valid_prometheus(text)
    lines = text.splitlines()
    vals = [int(x.rsplit(" ", 1)[1]) for x in lines if x.startswith("mlsl_lat_ms_bucket")]
    assert vals == sorted(vals) and vals[-1] == 4
    assert any(x.startswith("mlsl_lat_ms_count") and x.endswith(" 4") for x in lines)


def test_sample_ring_retention(registries):
    t, _ = registries
    g = t.gauge("g")
    for i in range(40):
        g.set(float(i))
        t.sample()
    assert len(g._msamples) == 16


def test_enable_idempotent_and_env_knobs(monkeypatch):
    metrics_mod.disable()
    monkeypatch.setenv("MLSL_METRICS_EVERY", "7")
    monkeypatch.setenv("MLSL_METRICS_RETENTION", "33")
    r = metrics_mod.enable()
    assert (r.every, r.retention) == (7, 33)
    assert metrics_mod.enable() is r
    assert metrics_mod.enable(every=3).every == 3
    assert metrics_mod.status()["armed"] is True
    metrics_mod.disable()
    assert metrics_mod.status() == jmetrics.status() == {"armed": False}


def test_jsonl_write_and_summary_match_jax(registries, tmp_path):
    t, j = registries
    lines = []
    for r in (t, j):
        for i in range(5):
            r.set("g", float(i))
            r.observe("h", float(i * 3))
            r.write_jsonl(str(tmp_path / ("t" if r is t else "j")), r.sample(ts=10.0 + i))
    for key in ("t", "j"):
        lines.append((tmp_path / key).read_text().splitlines())
    assert lines[0] == lines[1]
    ts, js = metrics_mod.summarize_jsonl(lines[0]), jmetrics.summarize_jsonl(lines[1])
    assert ts == js
    assert metrics_mod.render_summary(ts) == jmetrics.render_summary(js)
    assert t.write_jsonl() == str(tmp_path / "mlsl_metrics.jsonl")   # MLSL_STATS_DIR


def test_sample_families_covers_the_ports_counters(registries):
    t, _ = registries
    stats.record_degrade("quant", "fallback")
    stats.record_algo_dispatch("allreduce", "lax")
    t.sample_families()
    assert t.find("mlsl_degrade_fallback", subsystem="quant").value == 1.0
    assert t.find("mlsl_algo_dispatches", kind="allreduce", algo="lax").value >= 1.0
    for fam in ("bucket", "feed", "degrade", "overlap", "analysis", "straggler", "serve",
                "codec", "lockwitness"):
        assert any(s.name.startswith(f"mlsl_{fam}_") for s in t.series()), fam


def _request(tenv, name="m"):
    td = tenv.create_distribution(8, 1)
    req = CommRequest(CommDesc("allreduce", td.data_group, 64, DataType.FLOAT,
                               op=ReductionType.SUM), tenv.dispatcher, name=name)
    req.setup()
    return req, td.make_buffer(lambda p: np.full(64, 1.0), 64)


def test_request_feeds_dispatch_wait_and_algbw(tenv, registries):
    t, _ = registries
    req, buf = _request(tenv)
    for _ in range(3):
        req.start(buf).wait()
    assert t.find("mlsl_dispatch_wait_ms", kind="allreduce").count == 3
    h = t.find("mlsl_algbw_gbps", algo="lax", tier="flat")
    assert h.count == 3 and h.buckets == metrics_mod.ALGBW_BUCKETS_GBPS
    done, _ = req.start(buf).test()
    assert done and t.find("mlsl_dispatch_wait_ms", kind="allreduce").count == 4


def test_disabled_path_zero_alloc_request_round(tenv):
    metrics_mod.disable()
    req, buf = _request(tenv, "off")
    req.start(buf).wait()
    obs_dir = os.path.dirname(os.path.abspath(metrics_mod.__file__))
    tracemalloc.start()
    try:
        req.start(buf).wait()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert not snap.filter_traces(
        [tracemalloc.Filter(True, os.path.join(obs_dir, "*"))]).statistics("filename")


# -- the scrape surface ------------------------------------------------------------


def test_http_round_trip(tenv, registries):
    """/metrics parses as Prometheus text, /healthz IS supervisor.status()
    as JSON, /statusz renders, an unknown path is 404."""
    req, buf = _request(tenv, "h")
    for _ in range(3):
        req.start(buf).wait()
    srv = serve_mod.start_server(port=0, addr="127.0.0.1")
    assert srv is not None and srv.port > 0 and srv.addr == "127.0.0.1"
    base = f"http://127.0.0.1:{srv.port}"
    prom = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
    _assert_valid_prometheus(prom)
    assert "mlsl_dispatch_wait_ms" in prom and "mlsl_algbw_gbps_bucket" in prom
    body = urllib.request.urlopen(base + "/healthz", timeout=10).read().decode()
    assert json.loads(body) == json.loads(json.dumps(supervisor.status()))
    sz = urllib.request.urlopen(base + "/statusz", timeout=10).read().decode()
    assert "mlsl_tpu_torch statusz" in sz and "metrics: armed" in sz
    assert "subsystems: algo:closed" in sz
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/nope", timeout=10)
    assert ei.value.code == 404
    serve_mod.stop_server()
    assert serve_mod.get_server() is None


def test_start_server_idempotent_and_env_gate(monkeypatch):
    monkeypatch.delenv("MLSL_METRICS_PORT", raising=False)
    assert serve_mod.start_server() is None
    monkeypatch.setenv("MLSL_METRICS_PORT", "0")
    assert serve_mod.start_server() is None
    monkeypatch.setenv("MLSL_METRICS_PORT", "zero")
    assert serve_mod.start_server() is None
    srv = serve_mod.start_server(port=0, addr="127.0.0.1")
    assert srv is not None and serve_mod.start_server(port=0) is srv
    assert metrics_mod.enabled()   # a scrape surface arms the registry


def test_env_init_arms_registry_and_server(monkeypatch):
    monkeypatch.setenv("MLSL_METRICS", "1")
    monkeypatch.setenv("MLSL_METRICS_EVERY", "4")
    monkeypatch.setenv("MLSL_METRICS_ADDR", "127.0.0.1")
    e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert metrics_mod.get_registry().every == 4
        assert serve_mod.get_server() is None   # no port, no server
    finally:
        e.finalize()


def test_healthz_json_round_trip_under_armed_subsystems(tenv):
    doc = supervisor.status()
    assert json.loads(json.dumps(doc)) == doc
    metrics_mod.enable(every=2, retention=8)
    s = straggler_mod.StragglerSentinel(skew=1.2, every=3, sustain=1, shed=True)
    for _ in range(3):
        s.observe(0, 10.0)
        s.observe(1, 100.0, wait_ms=5.0)
    s.maybe_audit(step=3)
    supervisor.breaker("quant").record_failure(RuntimeError("boom"))
    doc = supervisor.status()
    assert doc["straggler"]["state"] == "flagged" and doc["straggler"]["shed_candidate"] == 1
    assert doc["metrics"]["armed"] is True
    assert json.loads(json.dumps(doc)) == doc


# -- the straggler sentinel --------------------------------------------------------


def _schedule(mod, kw, windows, audit="maybe"):
    """Feed ``windows`` [[(replica, step_ms, wait_ms)...], ...] to a fresh
    sentinel of ``mod``, one audit after each -> the observable trace."""
    s = mod.StragglerSentinel(**kw)
    out = []
    for i, win in enumerate(windows):
        for r, ms, w in win:
            s.observe(r, ms, wait_ms=w)
        v = s.maybe_audit(step=i) if audit == "maybe" else s.audit_now(step=i)
        out.append(v)
        if i == 1 and kw.get("shed"):
            out.append(s.shed_candidate())
            s.clear_candidate()
        out.append(s.shed_candidate())
    st = s.status()
    st.pop("remote_replicas")
    return out, st


SCHEDS = {
    "peer_baseline": (dict(skew=1.5, every=3, sustain=1),
                      [[(0, 10.0, None), (1, 11.0, None), (2, 35.0, 2.0)] * 3]),
    "skew_free": (dict(skew=1.5, every=4, sustain=1),
                  [[(0, 10.0 + 0.1 * i, None) for i in range(4)]
                   + [(1, 10.0 - 0.1 * i, None) for i in range(4)]]),
    "single_replica": (dict(skew=1.2, every=4, sustain=1), [[(0, 100.0, None)] * 8]),
    "sustain": (dict(skew=1.5, every=6, sustain=2),
                [[(0, 10.0, None), (1, 40.0, None)] * 3, [(0, 10.0, None), (1, 10.0, None)] * 3,
                 [(0, 10.0, None), (1, 40.0, None)] * 3, [(0, 10.0, None), (1, 40.0, None)] * 3]),
    "candidate": (dict(skew=1.2, every=3, sustain=1, shed=True),
                  [[(0, 10.0, None), (1, 50.0, None)] * 3] * 3),
}


@pytest.mark.parametrize("name", sorted(SCHEDS))
def test_straggler_matches_jax(name):
    kw, windows = SCHEDS[name]
    audit = "now" if name == "sustain" else "maybe"
    got = _schedule(straggler_mod, kw, windows, audit)
    t_counts = dict(stats.STRAGGLER_COUNTERS)
    want = _schedule(jstraggler, kw, windows, audit)
    assert got == want
    assert t_counts == jstats.STRAGGLER_COUNTERS


def test_straggler_verdicts():
    """The verdicts tests/test_metrics.py pins, on the port."""
    kw, windows = SCHEDS["peer_baseline"]
    (v, cand), st = _schedule(straggler_mod, kw, windows)
    assert v["confirmed"] == [2] and cand is None and st["flagged"]["2"]["skew"] > 3.0
    (v, _), st = _schedule(straggler_mod, *SCHEDS["skew_free"])
    assert v["suspects"] == [] and st["state"] == "watching"
    out, _ = _schedule(straggler_mod, *SCHEDS["sustain"], audit="now")
    assert out[0]["suspects"] == [1] and out[0]["confirmed"] == []
    assert out[-2]["confirmed"] == [1]


def test_straggler_feeds_registry_histograms(registries):
    t, _ = registries
    s = straggler_mod.StragglerSentinel(skew=2.0, every=100, sustain=1)
    s.observe(3, 12.5, wait_ms=1.5)
    assert t.find("mlsl_replica_step_ms", replica=3).count == 1
    assert t.find("mlsl_replica_wait_ms", replica=3).count == 1


def test_straggler_arming_and_env(monkeypatch):
    monkeypatch.setenv("MLSL_STRAGGLER_SKEW", "1.5")
    monkeypatch.setenv("MLSL_STRAGGLER_EVERY", "5")
    assert straggler_mod.armed() and straggler_mod.armed() == jstraggler.armed()
    s = straggler_mod.StragglerSentinel()
    assert (s.skew, s.every, s.sustain, s.shed) == (1.5, 5, 2, False)
    assert straggler_mod.get_active() is s and supervisor.status()["straggler"]["every"] == 5


def test_straggler_stats_line_and_degrade_vocabulary(tenv):
    s = straggler_mod.StragglerSentinel(skew=1.2, every=3, sustain=1)
    stats.record_degrade("quant", "fallback")
    sess = tenv.create_session()
    text = sess.get_stats().print_()
    assert "straggler:" not in text
    for _ in range(3):
        s.observe(0, 10.0)
        s.observe(1, 50.0)
    s.maybe_audit(step=3)
    text = sess.get_stats().print_()
    assert "STRAGGLER" in text and "flags 1" in text and "straggler:flagged" in text
