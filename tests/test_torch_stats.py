"""The port's Statistics against the JAX package's (tests/test_stats.py of
the JAX package): online accounting and its queries, the isolation replay at
commit, the overlap report, and the ``mlsl_stats.log`` table.

Byte counts, start and wait counts, and the printed table on the same slot
values must agree exactly; times are host clocks and are compared only for
being positive and consistent."""

import numpy as np
import pytest
import torch

from mlsl_tpu.core import stats as jstats
from mlsl_tpu_torch.core import stats as tstats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.types import CompressionType, OpType

torch.set_num_threads(2)

#: table lines of subsystems the port has not ported (core/stats.py): none
#: left; the families below are compared line for line
NOT_PORTED_LINES = ()


def _reset_families(mod):
    """Every process-wide counter family the two tables read, at 0: an
    earlier test in the same worker (a loader's stall, a breaker's trip)
    must show on neither side."""
    for name in ("bucket", "algo", "overlap", "codec", "feed", "serve", "degrade",
                 "straggler", "sentinel", "chkp", "elastic", "control"):
        getattr(mod, f"reset_{name}_counters")()


def _record_families(mod):
    """One event of each family the later slices ported (FEED, SERVE,
    DEGRADE, STRAGGLER, SENTINEL, CHKP, ELASTIC, CONTROL), the same values on
    both sides."""
    mod.record_feed_stage(3 << 20, 12 << 20)
    mod.record_feed_cache("hit")
    mod.record_feed_stall(0.625)
    mod.record_feed_wait(37.75)
    mod.record_feed_retry()
    mod.record_serve("admitted", 3)
    mod.record_serve("tokens_out", 96)
    mod.record_degrade("loop", "recover", detail="#1/20 RuntimeError: x")
    mod.record_straggler("audits")
    mod.record_sentinel("screened")
    mod.record_sentinel("verified_saves")
    mod.record_chkp("checks", 4)
    mod.record_elastic("device_losses", "step=3 world 8->4")
    mod.record_elastic("shrinks", "step=3 world 8->4")
    mod.record_elastic("reshard_buffers", n=12)
    mod.record_control("deaths_detected", "rank=2")
    mod.record_control("epochs_committed", "epoch=1")
    mod.record_control("heartbeats_sent", line=False)


@pytest.fixture()
def stats_env(env, monkeypatch):
    env.config.enable_stats = True
    monkeypatch.setenv("MLSL_STATS", "1")
    t = Environment.get_env().init(device="cpu", world_size=8)
    yield env, t
    env.config.enable_stats = False
    t.finalize()


def _grad_session(e, dist, count=256, n_ops=1, compression=CompressionType.NONE):
    s = e.create_session()
    s.set_global_minibatch_size(8)
    ops = []
    for _ in range(n_ops):
        r = s.create_operation_reg_info(OpType.CC)
        r.add_input(8, 4)
        r.add_output(8, 4)
        r.add_parameter_set(count, 1, compression_type=compression)
        ops.append(s.get_operation(s.add_operation(r, dist)))
    s.commit()
    return s, ops[0] if n_ops == 1 else ops


def _both(stats_env, grid=(8, 1), **kw):
    env, t = stats_env
    return _grad_session(env, env.create_distribution(*grid), **kw), _grad_session(
        t, t.create_distribution(*grid), **kw)


def _ones(dist, n):
    return dist.make_buffer(lambda p: np.ones(n, np.float32), n)


def test_online_accounting_and_queries(stats_env):
    (js, jop), (ts, top) = _both(stats_env)
    for s, op in ((js, jop), (ts, top)):
        ps = op.get_parameter_set(0)
        buf = _ones(op.get_distribution(), 256)
        for _ in range(3):
            ps.start_gradient_comm(buf)
            ps.wait_gradient_comm()
    st, sj = ts.get_stats(), js.get_stats()
    assert st.get_comm_size(top.op_idx) == sj.get_comm_size(jop.op_idx) == 3 * 256 * 4
    assert st.get_total_comm_size() == sj.get_total_comm_size()
    assert st.get_start_count(top.op_idx) == st.get_wait_count(top.op_idx) == 3
    assert st.get_comm_cycles(top.op_idx) > 0
    assert st.get_total_comm_cycles() == st.get_comm_cycles(top.op_idx)
    assert st.get_total_compute_cycles() >= 0
    assert st.get_compute_cycles(top.op_idx) == st.get_total_compute_cycles()


def test_isolation_replay_runs_at_commit(stats_env):
    (js, jop), (ts, top) = _both(stats_env)
    st = ts.get_stats()
    assert st.get_isolation_comm_cycles(top.op_idx) > 0
    assert st.get_total_isolation_comm_cycles() == st.get_isolation_comm_cycles(top.op_idx)
    assert st.isolation_s > 0
    assert st._isolation_bytes == js.get_stats()._isolation_bytes
    assert sorted(st._isolation_slot_ns) == sorted(js.get_stats()._isolation_slot_ns)
    # the replay leaves no round started
    assert not top.get_parameter_set(0).grad_req.is_started


def test_printer_and_reset(stats_env, tmp_path):
    (_, _), (ts, top) = _both(stats_env)
    ps = top.get_parameter_set(0)
    ps.start_gradient_comm(_ones(top.get_distribution(), 256))
    ps.wait_gradient_comm()
    text = ts.get_stats().print_(str(tmp_path / "stats.log"))
    assert "GRAD0" in text and "ISOLATE" in text
    assert (tmp_path / "stats.log").read_text() == text
    ts.get_stats().reset()
    assert ts.get_stats().get_total_comm_size() == 0


def test_stats_dir_routes_the_log(stats_env, tmp_path, monkeypatch):
    (_, _), (ts, _) = _both(stats_env)
    monkeypatch.setenv("MLSL_STATS_DIR", str(tmp_path))
    assert tstats.stats_path() == jstats.stats_path() == str(tmp_path / "mlsl_stats.log")
    ts.get_stats().Print()
    assert (tmp_path / "mlsl_stats.log").exists()


def test_start_stop_gating(stats_env):
    (_, _), (ts, top) = _both(stats_env)
    ps = top.get_parameter_set(0)
    buf = _ones(top.get_distribution(), 256)
    st = ts.get_stats()
    st.reset()
    st.stop()
    assert not st.is_started() and st.is_enabled()
    ps.start_gradient_comm(buf)
    ps.wait_gradient_comm()
    assert st.get_total_comm_size() == 0
    st.start()
    ps.start_gradient_comm(buf)
    ps.wait_gradient_comm()
    assert st.get_total_comm_size() == 256 * 4


def _edge_session(e, dist):
    s = e.create_session()
    s.set_global_minibatch_size(8)

    def mk(fm_in, fm_out):
        r = s.create_operation_reg_info(OpType.CC)
        r.add_input(fm_in, 4)
        r.add_output(fm_out, 4)
        r.add_parameter_set(fm_in * fm_out, 1)
        return s.get_operation(s.add_operation(r, dist))

    op1, op2 = mk(16, 32), mk(32, 8)
    op1.set_next(op2, 0, 0)
    s.commit()
    return s, op1, op2


def test_peer_op_redirection(stats_env):
    """WaitComm on op2's input charges the comm time to op1 (the FPROP owner)."""
    _, t = stats_env
    dist = t.create_distribution(2, 4)
    s, op1, op2 = _edge_session(t, dist)
    out_act, in_act = op1.get_output(0), op2.get_input(0)
    n = out_act.comm_req.desc.count
    s.get_stats().reset()
    out_act.start_comm(_ones(dist, n))
    before = s.get_stats().get_comm_cycles(op1.op_idx)
    in_act.wait_comm()
    assert s.get_stats().get_comm_cycles(op1.op_idx) > before
    assert s.get_stats().get_comm_cycles(op2.op_idx) == 0


def test_activation_graph_accounting_matches_jax(stats_env):
    """The reference loop on a case-1 graph with statistics: the same bytes,
    starts and waits per operation and slot as the JAX package's."""
    env, t = stats_env
    runs = []
    for e in (env, t):
        dist = e.create_distribution(2, 4)
        s, op1, op2 = _edge_session(e, dist)
        s.get_stats().reset()
        out_act, in_act = op1.get_output(0), op2.get_input(0)
        for _ in range(2):
            out_act.start_comm(_ones(dist, out_act.comm_req.desc.count))
            in_act.wait_comm()
            in_act.start_comm(_ones(dist, in_act.comm_req.desc.count))
            out_act.wait_comm()
            for op in (op2, op1):
                ps = op.get_parameter_set(0)
                ps.start_gradient_comm(_ones(dist, ps.get_local_kernel_count()))
                ps.wait_gradient_comm()
        st = s.get_stats()
        runs.append(({k: (v.bytes, v.starts, v.events) for k, v in st._slots.items()},
                     [st.get_comm_size(i) for i in range(2)], st.get_overlap_fraction()))
    (jslots, jsizes, jfrac), (tslots, tsizes, tfrac) = runs
    assert tslots == jslots
    assert tsizes == jsizes
    assert tfrac is not None and 0.0 <= tfrac <= 1.0 and jfrac is not None


def _fill(st, mod, slots, iso, iso_bytes):
    st._slots = {}
    for key, vals in slots.items():
        slot = mod._Slot()
        slot.bytes, slot.comm_ns, slot.comp_ns, slot.events, slot.starts = vals
        st._slots[key] = slot
    st._isolation_slot_ns = {k: v for k, v in iso.items()}
    st._isolation_ns = {}
    for (oi, _), v in iso.items():
        st._isolation_ns[oi] = st._isolation_ns.get(oi, 0) + v
    st._isolation_bytes = dict(iso_bytes)


SLOTS = {
    (0, ("OA", 0)): (4096, 1_500_000, 300_000, 8, 2),
    (0, ("GRAD", 0)): (2048, 700_000, 90_000, 8, 2),
    (1, ("IA", 0)): (1024, 250_000, 4_000_000, 8, 2),
    (1, ("GRAD", 0)): (512, 0, 120_000, 8, 2),
}
ISO = {(0, ("OA", 0)): 900_000, (0, ("GRAD", 0)): 200_000, (1, ("IA", 0)): 400_000,
       (1, ("GRAD", 0)): 50_000}


def _check_tables(stats_env, tmp_path, counters):
    env, t = stats_env
    sessions = []
    for e, mod in ((env, jstats), (t, tstats)):
        s, _ = _grad_session(e, e.create_distribution(8, 1), n_ops=2)
        _fill(s.get_stats(), mod, SLOTS, ISO, {0: 6144, 1: 1536})
        sessions.append(s)
    for mod in (jstats, tstats):
        _reset_families(mod)
        if counters in ("codec", "all"):
            mod.record_codec_wire("prune", 1234)
            mod.record_codec_wire("int8", 99)
            mod.record_codec("calibrations")
            mod.record_codec("guard_breaches")
            mod.record_codec_demotion("l1/grad0", "codec:prune", "test")
        if counters in ("bucket", "all"):
            mod.record_bucket_round("dispatched", *(("allreduce",) if mod is jstats else ()),
                                    members=3, coalesced=3 << 20, wire_saved=9 << 10)
            mod.record_bucket_round("fallback", *(("allreduce",) if mod is jstats else ()),
                                    members=2)
        if counters in ("algo", "all"):
            mod.record_algo_dispatch("allreduce", "pallas_ring")
            mod.record_algo_dispatch("reduce_scatter", "lax")
        if counters in ("engine", "all"):
            mod.record_overlap_step(5, 9, 123_456_789, split=True,
                                    breakdown={("allreduce", "quant_ring"): 5})
        if counters in ("families", "all"):
            _record_families(mod)
    try:
        js, ts = (s.get_stats() for s in sessions)
        assert ts.overlap_report() == js.overlap_report()
        assert ts.get_overlap_fraction() == js.get_overlap_fraction()
        for i in (0, 1):
            assert ts.get_overlap_fraction(i) == js.get_overlap_fraction(i)
            assert ts.get_isolation_comm_cycles(i) == js.get_isolation_comm_cycles(i)
            assert ts.get_comm_cycles(i) == js.get_comm_cycles(i)
            assert ts.get_compute_cycles(i) == js.get_compute_cycles(i)
        want = [ln for ln in js.print_(str(tmp_path / "j.log")).splitlines()
                if ln.split()[0] not in NOT_PORTED_LINES]
        got = ts.print_(str(tmp_path / "t.log")).splitlines()
        assert got == want
        if counters in ("families", "all"):
            heads = {ln.split()[0] for ln in got}
            assert {"FEED", "SERVE", "DEGRADE", "STRAGGLER", "SENTINEL", "CHKP", "ELASTIC",
                    "CONTROL"} <= heads
    finally:
        for mod in (jstats, tstats):
            _reset_families(mod)


@pytest.mark.parametrize("counters",
                         ["none", "bucket", "algo", "engine", "codec", "families", "all"])
def test_overlap_report_and_table_match_jax(stats_env, tmp_path, counters):
    """On the same slot values, isolation times and process-wide counters,
    the overlap report, the fractions and every table line the port prints
    are the JAX package's, in its order: every counter family both tables
    read is reset on both sides before and after, so what an earlier test
    left behind shows on neither."""
    _check_tables(stats_env, tmp_path, counters)


def test_table_matches_jax_after_the_chaos_loader_row(stats_env, tmp_path):
    """The order that once failed under ``--dist loadfile``: the chaos
    matrix's ``data.prefetch`` row (an AsyncLoader whose stall and
    back-pressure waits land in FEED_COUNTERS) and then the table
    comparison, in one process."""
    import importlib.util
    import pathlib

    from mlsl_tpu_torch import supervisor

    path = pathlib.Path(__file__).with_name("test_torch_chaos.py")
    spec = importlib.util.spec_from_file_location("_torch_chaos_rows", path)
    rows = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rows)
    env, t = stats_env
    t.finalize()
    try:
        supervisor.reset_all()
        rows.test_fault_matrix("data.prefetch")
        assert not any(tstats.FEED_COUNTERS.values()), "the loader row left FEED counts"
        tstats.record_feed_stall(0.6)    # and a stall the row might still leave
        tstats.record_feed_wait(37.7)
    finally:
        supervisor.reset_all()
    t = Environment.get_env().init(device="cpu", world_size=8)
    _check_tables((env, t), tmp_path, "all")


def test_bucket_wire_saved_matches_jax(stats_env):
    """The BUCKET line's wire_saved estimate for an int8 bucket is the JAX
    package's."""
    env, t = stats_env
    env.config.grad_bucket_mb = t.config.grad_bucket_mb = 1
    try:
        for mod in (jstats, tstats):
            mod.reset_bucket_counters()
        for e in (env, t):
            dist = e.create_distribution(8, 1)
            _, ops = _grad_session(e, dist, count=1024, n_ops=3,
                                   compression=CompressionType.QUANTIZATION)
            pss = [op.get_parameter_set(0) for op in ops]
            for ps in pss:
                ps.start_gradient_comm(_ones(dist, 1024))
            for ps in pss:
                ps.wait_gradient_comm()
        for key in ("rounds_dispatched", "bytes_coalesced", "wire_bytes_saved"):
            assert tstats.BUCKET_COUNTERS[key] == jstats.BUCKET_COUNTERS[key], key
        assert tstats.BUCKET_COUNTERS["wire_bytes_saved"] > 0
    finally:
        env.config.grad_bucket_mb = t.config.grad_bucket_mb = 0
        for mod in (jstats, tstats):
            mod.reset_bucket_counters()
