"""The port's comm-timeline tracer (mlsl_tpu_torch.obs) against the JAX
package's, mirroring tests/test_trace.py.

Each lifecycle test runs the same request or bucket round in both packages
with both tracers armed and compares what lands on the request's track: the
(phase, name, category) sequence and the arguments that describe the request
(bytes, members, algorithm) are equal; durations are host times and are only
held positive. The exporter's documents are compared key for key on the
same synthetic events. The port does not print the span-derived wait-stall
fields of the OVERLAP and BUCKET lines (tests/test_trace.py:299-365); the
JAX package's compile-counter and bench smokes test its own harness.
"""

import json
import os
import time
import tracemalloc

import numpy as np
import pytest
import torch

from mlsl_tpu import chaos as jchaos
from mlsl_tpu import obs as jobs
from mlsl_tpu.comm.request import CommDesc as JDesc, CommRequest as JReq
from mlsl_tpu.types import (CompressionType as JComp, DataType as JDT, OpType as JOp,
                            ReductionType as JRed)
from mlsl_tpu_torch import chaos, obs, supervisor
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLTimeoutError
from mlsl_tpu_torch.obs import export
from mlsl_tpu_torch.obs import tracer as tracer_mod
from mlsl_tpu_torch.obs.tracer import ARGS, CAT, DUR, NAME, PH, TRACK
from mlsl_tpu_torch.types import CompressionType, DataType, OpType, ReductionType

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _isolated():
    jobs.disable()
    jchaos.clear()
    supervisor.reset_all()
    yield
    supervisor.reset_all()
    jobs.disable()
    jchaos.clear()


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


@pytest.fixture()
def tracing():
    """Both tracers armed, fresh rings -> (jax tracer, port tracer)."""
    return jobs.enable(capacity=8192), obs.enable(capacity=8192)


def _requests(env, tenv, count=64, name="t", comp=0):
    jd, td = env.create_distribution(8, 1), tenv.create_distribution(8, 1)
    jr = JReq(JDesc("allreduce", jd.data_group, count, JDT.FLOAT, op=JRed.SUM,
                    compression=JComp(comp)), env.dispatcher, name=name)
    tr = CommRequest(CommDesc("allreduce", td.data_group, count, DataType.FLOAT,
                              op=ReductionType.SUM, compression=CompressionType(comp)),
                     tenv.dispatcher, name=name)
    jr.setup()
    tr.setup()
    return (jr, jd.make_buffer(lambda p: np.full(count, float(p + 1)), count),
            tr, td.make_buffer(lambda p: np.full(count, float(p + 1)), count))


def _track(tr, track, keys=("req", "bytes", "algo", "members", "kind")):
    return [(e[PH], e[NAME], e[CAT], {k: v for k, v in (e[ARGS] or {}).items() if k in keys})
            for e in tr.snapshot() if e[TRACK] == track]


def _names(tr, cat=None):
    return [(e[PH], e[NAME], e[CAT]) for e in tr.snapshot() if cat is None or e[CAT] == cat]


# -- span lifecycle through the real paths ------------------------------------------


def test_plain_request_lifecycle(env, tenv, tracing):
    jtr, ttr = tracing
    jr, jb, tr, tb = _requests(env, tenv, name="plainreq")
    jr.start(jb).wait()
    tr.start(tb).wait()
    track = "mlsl:allreduce:plainreq"
    got = _track(ttr, track)
    assert got == _track(jtr, track)
    assert [n for _, n, _, _ in got] == ["submit", "dispatch", "wait"]
    assert got[0][3]["bytes"] == 64 * 4
    disp = [e for e in ttr.snapshot() if e[NAME] == "dispatch"][0]
    wait = [e for e in ttr.snapshot() if e[NAME] == "wait"][0]
    sub = [e for e in ttr.snapshot() if e[NAME] == "submit"][0]
    assert disp[DUR] > 0 and sub[tracer_mod.TS] <= disp[tracer_mod.TS] + disp[DUR]
    assert wait[tracer_mod.TS] + wait[DUR] >= disp[tracer_mod.TS]


def test_chunked_request_lifecycle(env, tenv, tracing):
    """A chunked allreduce is ONE dispatch span over its chunk programs."""
    jtr, ttr = tracing
    for e in (env, tenv):
        e.config.large_msg_size_mb = 1
        e.config.large_msg_chunks = 4
    jr, jb, tr, tb = _requests(env, tenv, count=1 << 19, name="bigreq")
    assert len(tr._chunk_slices) == len(jr._chunk_slices) == 4
    jr.start(jb).wait()
    tr.start(tb).wait()
    track = "mlsl:allreduce:bigreq"
    assert _track(ttr, track) == _track(jtr, track)


def test_quant_request_lifecycle(env, tenv, tracing):
    jtr, ttr = tracing
    jr, jb, tr, tb = _requests(env, tenv, count=1024, name="quantreq",
                               comp=int(CompressionType.QUANTIZATION))
    jr.start(jb).wait()
    tr.start(tb).wait()
    track = "mlsl:allreduce:quantreq"
    assert _track(ttr, track) == _track(jtr, track)
    assert _names(ttr, "quant") == _names(jtr, "quant") == [("X", "quant.roundtrip", "quant")]
    rt = [e for e in ttr.snapshot() if e[NAME] == "quant.roundtrip"][0]
    assert rt[ARGS] == {"elems": 1024, "algo": "quant_ring"}


def test_deferred_request_records_defer(env, tenv, tracing):
    jtr, ttr = tracing
    for e in (env, tenv):
        e.config.msg_priority = True
        e.config.msg_priority_threshold = 0
    jr, jb, tr, tb = _requests(env, tenv, name="defreq")
    tr.start(tb).wait()
    track = "mlsl:allreduce:defreq"
    defers = [e for e in ttr.snapshot() if e[NAME] == "defer" and e[TRACK] == track]
    assert defers and defers[0][PH] == "i" and defers[0][ARGS]["bytes"] == 256
    assert [n for _, n, _, _ in _track(ttr, track)] == ["submit", "defer", "dispatch", "wait"]
    tenv.config.msg_priority = False
    env.config.msg_priority = False


def _bucket_round(e, op_t, counts=(512, 512)):
    e.config.grad_bucket_mb = 4
    try:
        dist = e.create_distribution(8, 1)
        s = e.create_session()
        s.set_global_minibatch_size(8)
        ops = []
        for i, c in enumerate(counts):
            r = s.create_operation_reg_info(op_t.CC)
            r.set_name(f"blayer{i}")
            r.add_input(8, 4)
            r.add_output(8, 4)
            r.add_parameter_set(c, 1)
            ops.append(s.get_operation(s.add_operation(r, dist)))
        s.commit()
        pss = [op.get_parameter_set(0) for op in ops]
        bufs = [dist.make_buffer(lambda p: np.full(512, float(p + 1)), 512) for _ in pss]
        for ps, b in zip(reversed(pss), reversed(bufs)):
            ps.start_gradient_comm(b)
        for ps in pss:
            assert ps.wait_gradient_comm() is not None
    finally:
        e.config.grad_bucket_mb = 0
    return pss[0].bucket.req._trace_name


def test_bucketed_request_lifecycle(env, tenv, tracing):
    """A full bucket round: a bucket.pack span and a bucket.dispatched
    instant, the coalesced request's lifecycle on its own track."""
    jtr, ttr = tracing
    jtrack = _bucket_round(env, JOp)
    ttrack = _bucket_round(tenv, OpType)
    assert ttrack == jtrack and ttrack.startswith("mlsl:allreduce:bucket-")
    assert _track(ttr, ttrack) == _track(jtr, jtrack)
    packs = [e for e in ttr.snapshot() if e[NAME] == "bucket.pack"]
    assert len(packs) == 1 and packs[0][ARGS]["members"] == 2
    assert _names(ttr, "bucket") == _names(jtr, "bucket")


# -- the disabled path ----------------------------------------------------------------


def test_disabled_path_records_nothing_and_allocates_nothing(tenv):
    """With the tracer off the request paths allocate nothing in obs/ and
    record nothing (tracemalloc attributes every allocation to its frame)."""
    obs.disable()
    td = tenv.create_distribution(8, 1)
    req = CommRequest(CommDesc("allreduce", td.data_group, 64, DataType.FLOAT,
                               op=ReductionType.SUM), tenv.dispatcher, name="offreq")
    req.setup()
    buf = td.make_buffer(lambda p: np.full(64, 1.0), 64)
    req.start(buf).wait()
    obs_dir = os.path.dirname(os.path.abspath(obs.__file__))
    tracemalloc.start()
    try:
        req.start(buf).wait()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    allocs = snap.filter_traces([tracemalloc.Filter(True, os.path.join(obs_dir, "*"))])
    assert not allocs.statistics("filename")
    assert obs.get_tracer() is None


# -- the ring ------------------------------------------------------------------------


def test_ring_buffer_wraparound_matches_jax():
    out = []
    for mod in (obs, jobs):
        mod.disable()
        tr = mod.enable(capacity=32)
        for i in range(100):
            tr.instant(f"ev{i}", "t")
        out.append([e[1] for e in tr.snapshot()])
        assert tr.capacity == 32
        mod.disable()
    assert out[0] == out[1] and out[0][0] == "ev68" and out[0][-1] == "ev99"


def test_enable_is_idempotent_and_env_capacity(monkeypatch):
    obs.disable()
    monkeypatch.setenv(tracer_mod.ENV_CAPACITY, "64")
    tr = obs.enable()
    assert tr.capacity == 64 and obs.enable() is tr
    tr.clear()
    assert tr.snapshot() == []


def test_span_context_and_queries():
    tr = obs.enable(capacity=64)
    with obs.span("load", "data", shard=3):
        pass
    tr.complete("wait", "req", tr.now(), req="a")
    tr.complete("wait", "req", tr.now(), req="a")
    tr.complete("h2d.transfer", "feed", tr.now())
    assert [e[NAME] for e in tr.snapshot()][0] == "load"
    assert len(tr.span_durations("h2d.transfer", "feed")) == 1
    assert set(tr.wait_stall_stats()["a"]) == {"n", "p50_ms", "p95_ms", "max_ms"}
    assert len(tr.window(60.0)) == 4


# -- the exporter --------------------------------------------------------------------


def _synthetic(mod):
    """The same events on a fresh ring of ``mod`` with fixed timestamps."""
    tr = mod.Tracer(64)
    t0 = 1_000_000
    tr.events.append(("X", "dispatch", "req", t0, 5_000, 11, "mlsl:allreduce:r",
                      {"req": "r", "algo": "lax"}))
    tr.events.append(("i", "submit", "req", t0 - 100, 0, 11, "mlsl:allreduce:r", {"bytes": 8}))
    tr.events.append(("X", "step.overlap", "step", t0 + 10_000, 70_000, 12, None, None))
    tr.events.append(("i", "watchdog.trip", "watchdog", t0 + 90_000, 0, 12, None,
                      {"phase": "wait"}))
    tr.thread_names.update({11: "mlsl-dispatch", 12: "MainThread"})
    return tr


def test_exporter_document_matches_jax():
    from mlsl_tpu.obs import export as jexport
    from mlsl_tpu.obs import tracer as jtracer

    t, j = _synthetic(tracer_mod), _synthetic(jtracer)
    td = export.render(t.snapshot(), t.thread_names, meta={"kind": "full"})
    jd = jexport.render(j.snapshot(), j.thread_names, meta={"kind": "full"})

    def norm(doc):
        out = []
        for e in doc["traceEvents"]:
            e = {k: v for k, v in e.items() if k != "pid"}
            if e.get("name") == "process_name":
                e["args"] = {}
            out.append(e)
        return out

    assert norm(td) == norm(jd)
    assert td["displayTimeUnit"] == "ms" and td["otherData"] == {"kind": "full"}
    assert export.summarize(td) == jexport.summarize(jd)


def test_exporter_emits_valid_perfetto_json(tenv, tmp_path):
    obs.enable(capacity=1024)
    td = tenv.create_distribution(8, 1)
    req = CommRequest(CommDesc("allreduce", td.data_group, 64, DataType.FLOAT,
                               op=ReductionType.SUM), tenv.dispatcher, name="expreq")
    req.setup()
    req.start(td.make_buffer(lambda p: np.full(64, 1.0), 64)).wait()
    path = obs.write_trace(path=str(tmp_path / "t.json"))
    doc = json.loads(open(path).read())
    evs = doc["traceEvents"]
    for e in evs:
        assert "ph" in e and "pid" in e and "tid" in e
        if e["ph"] != "M":
            assert "ts" in e
    assert any(e["ph"] == "X" and "dur" in e for e in evs)
    assert any(e["ph"] == "i" and e.get("s") == "t" for e in evs)
    names = [e["args"]["name"] for e in evs if e["ph"] == "M" and e["name"] == "thread_name"]
    assert "mlsl:allreduce:expreq" in names
    assert "wait" in obs.summarize(doc)
    assert obs.write_trace() is not None   # the default path: MLSL_TRACE_DIR


# -- the flight recorder -------------------------------------------------------------


def test_flight_recorder_on_watchdog_trip(tenv, tmp_path, monkeypatch):
    """A hung dispatch (armed through the MLSL_CHAOS grammar) with the tracer
    on and a watchdog timeout writes a trace-crash-*.json that loads, names
    the stuck request's track and holds its trip."""
    from mlsl_tpu_torch.core import stats

    obs.enable(capacity=8192)
    monkeypatch.setenv("MLSL_TRACE_DIR", str(tmp_path))
    chaos.refresh_from_env("collective.dispatch:hang=8")
    tenv.config.msg_priority = True
    tenv.config.msg_priority_threshold = 0
    tenv.config.msg_priority_flush_ms = 1.0
    tenv.config.watchdog_timeout_s = 0.5
    td = tenv.create_distribution(8, 1)
    req = CommRequest(CommDesc("allreduce", td.data_group, 64, DataType.FLOAT,
                               op=ReductionType.SUM), tenv.dispatcher, name="flightcheck")
    req.setup()
    try:
        req.start(td.make_buffer(lambda p: np.full(64, 1.0), 64))
        time.sleep(0.3)
        with pytest.raises(MLSLTimeoutError, match="watchdog"):
            req.wait()
    finally:
        chaos.clear()
        tenv.config.msg_priority = False
    crashes = sorted(tmp_path.glob("trace-crash-*.json"))
    assert crashes
    doc = json.loads(crashes[-1].read_text())
    assert doc["otherData"]["kind"] == "flight_record"
    assert "flightcheck" in doc["otherData"]["reason"]
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"]
    assert "mlsl:allreduce:flightcheck" in names
    trips = [e for e in doc["traceEvents"] if e["name"] == "watchdog.trip"]
    assert trips and "flightcheck" in trips[-1]["args"]["descriptor"]
    assert stats.WATCHDOG_EVENTS[-1].get("flight_record") == str(crashes[-1])


def test_flight_record_is_none_when_disarmed_and_falls_back_to_the_ring(tmp_path):
    assert export.flight_record(5.0) is None
    tr = obs.enable(capacity=16)
    tr.events.append(("i", "old", "t", 1, 0, 1, None, None))   # outside any window
    path = export.flight_record(0.001, reason="r", path=str(tmp_path / "f.json"))
    doc = json.loads(open(path).read())
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "i"] == ["old"]


def test_stats_log_routed_through_stats_dir(tmp_path, monkeypatch):
    from mlsl_tpu_torch.core import stats

    monkeypatch.setenv("MLSL_STATS_DIR", str(tmp_path))
    assert stats.stats_path() == str(tmp_path / "mlsl_stats.log")
    monkeypatch.delenv("MLSL_STATS_DIR")
    assert stats.stats_path() == "mlsl_stats.log"
