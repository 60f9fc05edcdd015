"""The port's pod control plane (mlsl_tpu_torch.control) against the JAX
package's (mlsl_tpu.control): tests/test_control.py's 22 tests on the port's
planes, with the JAX package's planes beside them where a verdict is
compared (the status document's keys, the fence's verdicts on the same
frames, the drain decision).

All pods here are in-process -- N ControlPlane instances over real localhost
TCP sockets, each standing in for one host; tests/test_torch_pod.py runs real
OS processes. A committed loss names virtual ranks (``device_map`` holds
ints), and in the loop test it drives the elastic coordinator's shrink of a
CPU trainer with zero restores.

Timing: 0.1 s heartbeats and 3 misses keep each wait under a second;
in-process planes share the interpreter with the trainer, so the loop test
runs 0.25 s / 4 misses, as the JAX file does.
"""

import json
import os
import time
import contextlib

import numpy as np
import pytest
import torch

from mlsl_tpu.control import status as jcontrol_status
from mlsl_tpu.control.plane import ControlPlane as JControlPlane
from mlsl_tpu_torch import chaos, control, elastic, supervisor
from mlsl_tpu_torch.control import channel
from mlsl_tpu_torch.control.plane import ControlPlane
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLDeviceLossError, MLSLError

torch.set_num_threads(2)

INTERVAL = 0.1
MISSES = 3
BUDGET = INTERVAL * MISSES


@pytest.fixture(autouse=True)
def _clear():
    supervisor.reset_all()
    yield
    if Environment._instance is not None:
        Environment._instance.finalize()
    supervisor.reset_all()


@contextlib.contextmanager
def _pod(n, interval=INTERVAL, misses=MISSES, device_maps=None, cls=ControlPlane, **kw):
    """N in-process planes bound to ephemeral ports, address tables patched
    after bind (the port-0 bootstrap a real pod does via its hostfile)."""
    planes = [
        cls(
            r, [("127.0.0.1", 0)] * n,
            device_map=(device_maps or {}).get(r),
            interval_s=interval, misses=misses, **kw,
        )
        for r in range(n)
    ]
    try:
        for p in planes:
            p.start()
        addrs = [("127.0.0.1", p.listen_port) for p in planes]
        for p in planes:
            p.addrs = addrs
        yield planes
    finally:
        for p in planes:
            p.stop()


def _wait(cond, timeout=8.0, poll=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll)
    return False


# -- membership + heartbeat ---------------------------------------------------


def test_bootstrap_membership_and_status_shape():
    with _pod(3) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 2 for p in planes
        ))
        for p in planes:
            st = p.status()
            assert st["alive"] == [0, 1, 2] and st["epoch"] == 0
            assert st["leader"] == 0 and st["dead"] == []
            assert st["interval_s"] == INTERVAL and st["misses"] == MISSES
            json.dumps(st)  # the /healthz contract: serializable throughout
        assert planes[0].status()["state"] == "leader"
        assert planes[1].status()["state"] == "member"
        assert planes[0].is_leader() and planes[0].may_decide()
        assert not planes[1].is_leader()


def test_kill_detected_within_miss_budget_one_commit():
    """SIGKILL analog: a silently stopped member is declared dead within the
    miss budget, survivors agree on ONE epoch-fenced survivor set, and the
    committed loss surfaces as the device-loss error the elastic path
    reshards around (virtual ranks in this plane's device_map)."""
    devs = tuple(range(8))
    dmap = {0: tuple(devs[:4]), 1: tuple(devs[4:6]), 2: tuple(devs[6:8])}
    with _pod(3, device_maps={0: dmap}) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 2 for p in planes
        ))
        planes[2].kill()
        assert _wait(lambda: planes[0].status()["alive"] == [0, 1]
                     and planes[1].status()["alive"] == [0, 1])
        for p in planes[:2]:
            st = p.status()
            assert st["epoch"] == 1 and st["dead"] == [2]
            assert st["leader"] == 0 and not st["evicted"]
        # exactly one committed membership event, identical on survivors
        ev0 = [e for e in planes[0].events if e["kind"] == "commit"]
        ev1 = [e for e in planes[1].events if e["kind"] == "commit"]
        assert ev0 == ev1 and len(ev0) == 1
        assert ev0[0]["dead"] == [2] and ev0[0]["survivors"] == [0, 1]
        # detection bounded: suspicion->commit spans at most the miss budget
        # plus one barrier window (plus generous GIL slack)
        assert ev0[0]["detect_s"] <= 2 * BUDGET + 2.0
        assert stats.CONTROL_COUNTERS["deaths_detected"] >= 1
        assert stats.CONTROL_COUNTERS["epochs_committed"] >= 2
        # the loss is locally actionable where the device_map says so...
        err = planes[0].take_loss()
        assert isinstance(err, MLSLDeviceLossError)
        assert tuple(err.devices) == tuple(devs[6:8])
        assert planes[0].take_loss() is None  # consumed once
        # ...and pure bookkeeping where it carries no local devices
        assert planes[1].take_loss() is None


def test_leader_death_elects_next_lowest_rank():
    with _pod(3) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 2 for p in planes
        ))
        planes[0].kill()
        assert _wait(lambda: planes[1].status()["alive"] == [1, 2]
                     and planes[2].status()["alive"] == [1, 2])
        assert planes[1].status()["state"] == "leader"
        assert planes[1].is_leader() and planes[1].may_decide()
        assert planes[2].status()["state"] == "member"
        assert not planes[2].may_decide()
        assert planes[1].status()["leader"] == 1
        assert planes[2].status()["leader"] == 1
        assert stats.CONTROL_COUNTERS["elections"] >= 1


def test_resurrection_before_commit_clears_suspicion():
    """A rank that resumes heartbeating before any commit removed it (GC
    pause, loaded link) recovers WITHOUT a reshard: suspicion clears, the
    epoch never moves."""
    with _pod(2) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 1 for p in planes
        ))
        with planes[0]._lock:
            planes[0]._observed_dead.add(1)
            planes[0]._suspected_at[1] = time.monotonic()
        assert _wait(lambda: not planes[0]._observed_dead)
        assert planes[0].status()["alive"] == [0, 1]
        assert planes[0].status()["epoch"] == 0
        assert stats.CONTROL_COUNTERS["epochs_committed"] == 0


# -- epoch fencing ------------------------------------------------------------


def test_fence_rejects_stale_epoch_and_wrong_leader():
    with _pod(2) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 1 for p in planes
        ))
        addr = planes[0].addrs[0]
        # stale epoch: not strictly newer than the receiver's
        channel.send_frame(addr, {
            "t": "commit", "epoch": 0, "leader": 0,
            "survivors": [0], "dead": [1],
        })
        # wrong leader: epoch is newer but the signer is not the minimum
        # surviving rank of any view
        channel.send_frame(addr, {
            "t": "commit", "epoch": 5, "leader": 1,
            "survivors": [0, 1], "dead": [],
        })
        assert _wait(
            lambda: stats.CONTROL_COUNTERS["stale_rejected"] >= 2
        )
        st = planes[0].status()
        assert st["epoch"] == 0 and st["alive"] == [0, 1]


def test_fence_accepts_leader_death_commit_net_of_removed():
    """The regression the fence rule exists for: a commit REMOVING the dead
    leader is signed by the next-lowest survivor, who is only the minimum
    once the dead leader is out — the fence must judge leadership net of
    the ranks the order itself removes, or the very commit that removes a
    dead leader self-rejects everywhere."""
    with _pod(3) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 2 for p in planes
        ))
        channel.send_frame(planes[2].addrs[2], {
            "t": "commit", "epoch": 1, "leader": 1,
            "survivors": [1, 2], "dead": [0], "reason": "heartbeat-miss",
        })
        assert _wait(lambda: planes[2].status()["epoch"] == 1)
        st = planes[2].status()
        assert st["alive"] == [1, 2] and st["leader"] == 1
        assert stats.CONTROL_COUNTERS["stale_rejected"] == 0


def test_eviction_disables_pod_decisions():
    """A rank the pod declared dead (partition healed late) must stop
    making pod-level decisions: may_decide() is false forever after."""
    with _pod(2) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 1 for p in planes
        ))
        channel.send_frame(planes[0].addrs[0], {
            "t": "commit", "epoch": 1, "leader": 1,
            "survivors": [1], "dead": [0],
        })
        assert _wait(lambda: planes[0].status()["evicted"])
        assert not planes[0].may_decide()
        assert stats.CONTROL_COUNTERS["evicted"] == 1


# -- coordinated preemption drain ---------------------------------------------


def test_save_drain_reaches_whole_pod_exactly_one_decision(monkeypatch):
    monkeypatch.delenv("MLSL_ELASTIC", raising=False)
    with _pod(3) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 2 for p in planes
        ))
        d = planes[2].coordinate_preemption("scheduler", timeout_s=6)
        assert d is not None and d["mode"] == "save" and d["rank"] == 2
        assert d["survivors"] == [0, 1, 2]  # a save drains, nobody sheds
        assert _wait(lambda: all(
            p.status()["drained"] == [2] for p in planes
        ))
        # every member got the one decision; the pod never resharded
        assert planes[0].take_drain() is not None
        assert all(p.status()["alive"] == [0, 1, 2] for p in planes)
        assert stats.CONTROL_COUNTERS["drain_decisions"] == 1
        assert stats.CONTROL_COUNTERS["notices"] == 1


def test_shrink_drain_sheds_draining_rank(monkeypatch):
    monkeypatch.setenv("MLSL_ELASTIC", "1")
    devs = tuple(range(8))
    with _pod(3, device_maps={0: {1: tuple(devs[4:6])}}) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 2 for p in planes
        ))
        d = planes[1].coordinate_preemption("scheduler", timeout_s=6)
        assert d is not None and d["mode"] == "shrink" and d["rank"] == 1
        assert d["survivors"] == [0, 2]
        assert _wait(lambda: planes[0].status()["alive"] == [0, 2]
                     and planes[2].status()["alive"] == [0, 2])
        # the drained rank heard the verdict even though the shrink removed
        # it from the live set before the broadcast (regression)
        assert planes[1].status()["drained"] == [1]
        assert not planes[1].status()["evicted"]  # drained, not declared dead
        assert stats.CONTROL_COUNTERS["drain_decisions"] == 1
        # survivors reshard around the drained rank's devices...
        err = planes[0].take_loss()
        assert isinstance(err, MLSLDeviceLossError)
        assert tuple(err.devices) == tuple(devs[4:6])
        # ...the drained rank itself is exiting, not suffering a loss
        assert planes[1].take_loss() is None


def test_duplicate_notices_one_decision(monkeypatch):
    monkeypatch.delenv("MLSL_ELASTIC", raising=False)
    with _pod(2) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 1 for p in planes
        ))
        planes[1].submit_notice("first")
        planes[1].submit_notice("second")  # idempotent at the sender
        assert _wait(lambda: planes[1].take_drain() is not None,
                     timeout=6)
        # a replayed notice frame (retry racing the decision) dedups at the
        # leader: the decision already stands
        channel.send_frame(planes[0].addrs[0], {
            "t": "notice", "rank": 1, "reason": "replay", "ts": 0,
        })
        time.sleep(4 * INTERVAL)
        assert stats.CONTROL_COUNTERS["drain_decisions"] == 1
        assert stats.CONTROL_COUNTERS["notices"] == 1


def test_notice_file_poll_triggers_drain(tmp_path, monkeypatch):
    """The cluster-scheduler hook: MLSL_PREEMPTION_FILE appearing IS the
    preemption notice — no signal delivery needed."""
    monkeypatch.delenv("MLSL_ELASTIC", raising=False)
    nf = str(tmp_path / "preempt-notice")
    with _pod(2, notice_file=nf) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 1 for p in planes
        ))
        assert stats.CONTROL_COUNTERS["notices"] == 0
        with open(nf, "w") as f:
            f.write("preempted\n")
        assert _wait(lambda: planes[1].take_drain() is not None,
                     timeout=6)
        assert stats.CONTROL_COUNTERS["drain_decisions"] >= 1


# -- chaos sites --------------------------------------------------------------


def test_chaos_sites_registered():
    for site in ("control.heartbeat", "control.notice"):
        assert site in chaos.SITES
        # standard grammar parses for both sites
        plans = chaos.refresh_from_env(f"{site}:error@1x2%0.5")
        assert plans[0].site == site and plans[0].prob == 0.5
        chaos.clear()


def test_chaos_heartbeat_loss_within_budget_no_reshard():
    """Dropped heartbeat frames BELOW the consecutive-miss budget are
    absorbed: send failures count, nobody dies, the epoch never moves."""
    with _pod(2) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 1 for p in planes
        ))
        chaos.plan("control.heartbeat", "error", times=2)
        assert _wait(
            lambda: stats.CONTROL_COUNTERS["send_failures"] >= 2
        )
        time.sleep(2 * BUDGET)
        assert all(p.status()["epoch"] == 0 for p in planes)
        assert all(p.status()["alive"] == [0, 1] for p in planes)


def test_chaos_notice_error_degrades_to_retry(monkeypatch):
    """A lost preemption notice (error at control.notice) is retried every
    tick: the drain decision arrives late, never not at all."""
    monkeypatch.delenv("MLSL_ELASTIC", raising=False)
    with _pod(2) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 1 for p in planes
        ))
        chaos.plan("control.notice", "error", times=2)
        d = planes[1].coordinate_preemption("scheduler", timeout_s=8)
        assert d is not None and d["mode"] == "save" and d["rank"] == 1
        assert stats.CONTROL_COUNTERS["drain_decisions"] == 1


def test_chaos_heartbeat_hang_is_detected_as_death():
    """A hang at the heartbeat site stalls one member's sender thread past
    the miss budget: the pod treats it exactly like a dead host — detection,
    one commit, shrunken survivor set — and the stallee learns it was
    evicted when it wakes."""
    with _pod(3) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 2 for p in planes
        ))
        chaos.plan("control.heartbeat", "hang", seconds=4 * BUDGET, times=1)
        assert _wait(lambda: any(
            len(p.status()["alive"]) == 2 and p.status()["epoch"] >= 1
            for p in planes
        ))
        assert _wait(lambda: stats.CONTROL_COUNTERS["evicted"] >= 1,
                     timeout=10)


# -- config + arming ----------------------------------------------------------


def test_control_knob_validation(monkeypatch):
    """The JAX package's checks; MLSL_DIST_INIT_RETRIES, the distributed
    bootstrap's knob, is A.8's (ROADMAP)."""
    monkeypatch.setenv("MLSL_HEARTBEAT_INTERVAL_S", "0")
    with pytest.raises(MLSLError, match="MLSL_HEARTBEAT_INTERVAL_S"):
        Environment.get_env().init(device="cpu")
    monkeypatch.setenv("MLSL_HEARTBEAT_INTERVAL_S", "0.5")
    monkeypatch.setenv("MLSL_HEARTBEAT_MISSES", "0")
    with pytest.raises(MLSLError, match="MLSL_HEARTBEAT_MISSES"):
        Environment.get_env().init(device="cpu")
    monkeypatch.setenv("MLSL_HEARTBEAT_MISSES", "3")
    monkeypatch.setenv("MLSL_HEARTBEAT_GRACE_S", "-1")
    with pytest.raises(MLSLError, match="MLSL_HEARTBEAT_GRACE_S"):
        Environment.get_env().init(device="cpu")
    monkeypatch.setenv("MLSL_HEARTBEAT_GRACE_S", "30")
    monkeypatch.setenv("MLSL_CONTROL_ADDRS", "127.0.0.1:1,127.0.0.1:2")
    monkeypatch.setenv("MLSL_CONTROL_WORLD", "2")
    with pytest.raises(MLSLError, match="mutually exclusive"):
        Environment.get_env().init(device="cpu")
    monkeypatch.delenv("MLSL_CONTROL_WORLD")
    monkeypatch.setenv("MLSL_CONTROL_RANK", "5")
    with pytest.raises(MLSLError, match="MLSL_CONTROL_RANK"):
        Environment.get_env().init(device="cpu")
    monkeypatch.setenv("MLSL_CONTROL_PORT", "70000")
    monkeypatch.delenv("MLSL_CONTROL_ADDRS")
    with pytest.raises(MLSLError, match="MLSL_CONTROL_PORT"):
        Environment.get_env().init(device="cpu")


def test_ensure_started_arms_from_config_and_status_plumbs():
    from mlsl_tpu_torch.config import Config
    from mlsl_tpu_torch.obs import serve

    cfg = Config()
    cfg.control_addrs = "127.0.0.1:0"
    cfg.control_rank = 0
    plane = control.ensure_started(cfg)
    assert plane is not None and control.armed()
    assert control.ensure_started(cfg) is plane  # idempotent
    assert control.replica_id(7) == 0
    # a world of one: this member leads, and the leader's /healthz carries
    # the merged pod view alongside the standard supervisor doc
    st = supervisor.status()
    assert st["control"]["state"] == "leader"
    plane.push_status(st, step=12, step_ms=8.5)
    doc = serve.healthz_doc()
    assert doc["pod"]["leader"] == 0
    assert doc["pod"]["members"]["0"]["step"] == 12
    txt = serve.statusz_text()
    assert "pod:" in txt
    control.reset()
    assert supervisor.status()["control"] == {"state": "off"}
    assert control.replica_id(7) == 7


def test_ensure_started_bad_rank_warns_not_raises(caplog):
    from mlsl_tpu_torch.config import Config

    cfg = Config()
    cfg.control_addrs = "127.0.0.1:0"
    cfg.control_rank = 3
    assert control.ensure_started(cfg) is None
    assert not control.armed()
    assert "MLSL_CONTROL_RANK" in caplog.text


def test_non_leader_healthz_has_no_pod_key():
    from mlsl_tpu_torch.obs import serve

    plane = ControlPlane(1, [("127.0.0.1", 0)] * 2,
                         interval_s=INTERVAL, misses=MISSES)
    control.set_active(plane.start())
    try:
        assert "pod" not in serve.healthz_doc()  # rank 0 leads, not us
    finally:
        control.reset()


def test_status_off_is_default():
    assert supervisor.status()["control"] == jcontrol_status() == {"state": "off"}


# -- pod-wide straggler feed --------------------------------------------------


def test_remote_step_times_feed_local_straggler_sentinel():
    from mlsl_tpu_torch.obs import straggler

    sent = straggler.StragglerSentinel(skew=2.0, every=4)  # self-installs
    with _pod(2) as planes:
        assert _wait(lambda: all(
            len(p.status()["hb_age_s"]) == 1 for p in planes
        ))
        # rank 1's training thread publishes step times; they ride its
        # heartbeat frames into rank 0's LOCAL sentinel windows
        for _ in range(6):
            planes[1].push_status(step_ms=10.0)
        assert _wait(
            lambda: 1 in sent.status().get("remote_replicas", []),
            timeout=6,
        )
        # drained-not-resent: the total fed never exceeds what was pushed
        # (heartbeats drain the sample buffer instead of re-sending it)
        time.sleep(4 * INTERVAL)
        with sent._lock:
            n = len(sent._win_step.get(1, ()))
        assert 0 < n <= 6


# -- training-loop integration ------------------------------------------------


def _make_trainer(batch=24):
    from mlsl_tpu.models.mlp import init
    from mlsl_tpu_torch.models import mlp as tmlp
    from mlsl_tpu_torch.models.convert import params_from_jax
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    import jax

    host = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    env = Environment.get_env().init(device="cpu")
    dist = env.create_distribution(env.get_process_count(), 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(batch)
    return DataParallelTrainer(env, dist, sess,
                               tmlp.MLP(device="cpu", params=params_from_jax(host, "cpu")),
                               tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1)


def test_loop_reshards_on_pod_commit_zero_restores(tmp_path):
    """A pod member dies (its plane killed); the survivors' committed loss
    surfaces in FaultTolerantLoop as the device-loss error, and the elastic
    rung reshards 8 -> 6 virtual ranks with ZERO checkpoint restores and an
    unbroken trajectory; the leader's merged /healthz shows the shrunk pod."""
    from mlsl_tpu_torch.obs import serve
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    dmap = {0: (0, 1, 2, 3), 1: (4, 5), 2: (6, 7)}
    n = 3
    planes = [ControlPlane(r, [("127.0.0.1", 0)] * n, device_map=(dmap if r == 0 else None),
                           interval_s=0.25, misses=4) for r in range(n)]
    for p in planes:
        p.start()
    addrs = [("127.0.0.1", p.listen_port) for p in planes]
    for p in planes:
        p.addrs = addrs
    control.set_active(planes[0])  # this process IS pod rank 0
    try:
        assert _wait(lambda: all(len(p.status()["hb_age_s"]) == 2 for p in planes))
        losses = []
        killed = [False]

        def hook(step, attempt):
            if step == 3 and not killed[0]:
                killed[0] = True
                planes[1].kill()  # "host 1" dies mid-run

        def batch_fn(trainer, step):
            # pace the full world so detection (~2 s) lands mid-run
            if trainer.dist.topology.world_size == 8:
                time.sleep(0.03)
            rng = np.random.default_rng(step)
            return trainer.shard_batch(rng.normal(size=(24, 8)).astype(np.float32),
                                       rng.integers(0, 4, size=(24,)).astype(np.int32))

        loop = FaultTolerantLoop(_make_trainer, str(tmp_path / "ck"), save_every=50,
                                 fault_hook=hook,
                                 elastic=elastic.ElasticCoordinator(capacity_budget=4))
        trainer = loop.run(batch_fn, steps=400,
                           on_step=lambda s, l: losses.append(float(l.mean())))
        assert trainer.dist.topology.world_size == 6
        assert elastic.active_devices() == (0, 1, 2, 3, 6, 7)
        assert loop.recoveries == 0
        assert stats.ELASTIC_COUNTERS["shrinks"] == 1
        assert stats.ELASTIC_COUNTERS["restart_fallbacks"] == 0
        assert len(losses) == 400 and np.isfinite(losses).all()
        assert planes[0].status()["alive"] == [0, 2]
        assert planes[2].status()["alive"] == [0, 2]
        doc = serve.healthz_doc()
        assert doc["pod"]["survivors"] == [0, 2]
        assert doc["pod"]["members"]["1"]["alive"] is False
        assert doc["pod"]["members"]["0"]["status"] is not None
        assert doc["control"]["state"] == "leader"
        assert doc["elastic"]["state"] == "shrunk" and doc["elastic"]["active_size"] == 6
        json.dumps(doc)
    finally:
        for p in planes:
            p.stop()
        control.reset()


# -- the port against the JAX package's planes ----------------------------------------


def test_status_document_and_fence_match_jax():
    """A 2-member pod of each package: the same status keys and values
    (heartbeat ages aside), and the same fence verdicts on the same stale
    and wrong-leader frames."""
    docs = {}
    for name, cls in (("jax", JControlPlane), ("port", ControlPlane)):
        stats.reset_control_counters()
        from mlsl_tpu.core import stats as jstats

        jstats.reset_control_counters()
        with _pod(2, cls=cls) as planes:
            assert _wait(lambda: all(len(p.status()["hb_age_s"]) == 1 for p in planes))
            for frame in ({"t": "commit", "epoch": 0, "leader": 0, "survivors": [0],
                           "dead": [1]},
                          {"t": "commit", "epoch": 5, "leader": 1, "survivors": [0, 1],
                           "dead": []}):
                assert planes[0]._apply_commit(frame) is False
            st = planes[0].status()
            st.pop("hb_age_s")
            docs[name] = (st, sorted(planes[0].pod_status()))
        jstats.reset_control_counters()
    assert docs["port"] == docs["jax"]
