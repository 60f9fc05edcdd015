"""The port's pod sim (``python -m mlsl_tpu_torch.control.sim``) as real OS
processes: tests/test_pod.py's four tests -- a SIGKILL detected within the
miss budget, one epoch, the leader's merged /healthz scraped over HTTP; a
SIGTERM turned into ONE coordinated drain; the soak of sequential kills
(``slow``, as in the JAX file); an NTP step that kills nobody -- against the
same protocol bounds. Each worker initializes its Environment with
``--device cpu``: the sim never falls back to the CPU on its own, and the
last test pins that a worker asked for the card on a machine without one
exits with an error.

The fast variants run in tier-1 under the ``pod`` marker."""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from mlsl_tpu_torch import supervisor

pytestmark = pytest.mark.pod

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _isolated():
    supervisor.reset_all()
    yield
    supervisor.reset_all()

INTERVAL = 0.25
MISSES = 3
BUDGET = INTERVAL * MISSES


def _free_base(n: int) -> int:
    """A base port with n consecutive free ports (probe-and-release; the
    race window is acceptable in a test container)."""
    for _ in range(50):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            base = probe.getsockname()[1]
        if base + n >= 65535:
            continue
        try:
            socks = []
            try:
                for r in range(n):
                    s = socket.socket()
                    s.bind(("127.0.0.1", base + r))
                    socks.append(s)
            finally:
                for s in socks:
                    s.close()
            return base
        except OSError:
            continue
    raise RuntimeError("no consecutive free ports found")


class _Pod:
    """Spawn N sim workers; collect their stdout to files (pipe buffers
    deadlock a chatty worker); expose kill/signal/wait/parse helpers."""

    def __init__(self, tmp_path, n, steps=400, step_s=0.05, extra_env=None):
        self.n = n
        self.dir = tmp_path / "pod"
        self.dir.mkdir()
        base = _free_base(n)
        self.procs = []
        self.outs = []
        for r in range(n):
            statsdir = tmp_path / f"stats{r}"
            statsdir.mkdir()
            env = dict(
                os.environ,
                OMP_NUM_THREADS="1",
                MLSL_CONTROL_PORT=str(base),
                MLSL_CONTROL_WORLD=str(n),
                MLSL_CONTROL_RANK=str(r),
                MLSL_HEARTBEAT_INTERVAL_S=str(INTERVAL),
                MLSL_HEARTBEAT_MISSES=str(MISSES),
                MLSL_STATS_DIR=str(statsdir),
                MLSL_TRACE_DIR=str(statsdir),
            )
            env.pop("MLSL_ELASTIC", None)
            env.update(extra_env or {})
            out = open(self.dir / f"rank{r}.out", "w")
            self.outs.append(out)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "mlsl_tpu_torch.control.sim",
                 "--steps", str(steps), "--step-s", str(step_s),
                 "--dir", str(self.dir), "--device", "cpu"],
                stdout=out, stderr=subprocess.STDOUT, env=env,
                cwd=os.path.dirname(os.path.dirname(__file__)),
            ))

    def wait_ready(self, timeout=90):
        """All members up AND heartbeating (rank files written post-init)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all((self.dir / f"rank{r}.pid").exists()
                   for r in range(self.n)):
                return
            dead = [r for r, p in enumerate(self.procs)
                    if p.poll() is not None]
            assert not dead, (
                f"worker(s) {dead} died during startup:\n"
                + "".join(self.out(r) for r in dead)
            )
            time.sleep(0.1)
        raise AssertionError("pod never became ready:\n" + self.out(0))

    def http_port(self, r) -> int:
        return int((self.dir / f"rank{r}.port").read_text())

    def sigkill(self, r):
        os.kill(self.procs[r].pid, signal.SIGKILL)

    def sigterm(self, r):
        os.kill(self.procs[r].pid, signal.SIGTERM)

    def wait_all(self, timeout=120):
        for p in self.procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                raise
        for f in self.outs:
            f.close()

    def cleanup(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.outs:
            if not f.closed:
                f.close()

    def out(self, r) -> str:
        if not self.outs[r].closed:
            self.outs[r].flush()
        return (self.dir / f"rank{r}.out").read_text()

    def events(self, r, kind=None):
        evs = []
        for line in self.out(r).splitlines():
            if line.startswith("EVENT "):
                ev = dict(kv.split("=", 1) for kv in line.split()[1:])
                if kind is None or ev["kind"] == kind:
                    evs.append(ev)
        return evs

    def stats_lines(self, tmp_path, r, event):
        log = tmp_path / f"stats{r}" / "mlsl_stats.log"
        if not log.exists():
            return []
        pat = re.compile(rf"^CONTROL\s+{event.upper()}\s+(.*)$")
        return [m.group(1) for line in log.read_text().splitlines()
                if (m := pat.match(line))]


@pytest.fixture()
def pod_factory(tmp_path):
    pods = []

    def make(n, **kw):
        pod = _Pod(tmp_path, n, **kw)
        pods.append(pod)
        return pod

    make.tmp_path = tmp_path
    yield make
    for pod in pods:
        pod.cleanup()


def _scrape(port, path="/healthz", timeout=5):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=timeout
    ) as resp:
        return json.loads(resp.read().decode())


def test_sigkill_detected_one_epoch_merged_healthz(pod_factory):
    """The acceptance soak, fast variant: SIGKILL one of three OS processes;
    the survivors must detect it within the miss budget, agree on ONE
    epoch-fenced survivor set, keep stepping with a continuous trajectory,
    and the leader's merged /healthz must show the shrunken world with
    per-host status."""
    pod = pod_factory(3)
    pod.wait_ready()
    time.sleep(4 * INTERVAL)  # everyone heartbeating
    t_kill = time.monotonic()
    pod.sigkill(2)

    # the leader's merged /healthz flips to the shrunken world
    port = pod.http_port(0)
    deadline = time.monotonic() + 30
    doc = None
    while time.monotonic() < deadline:
        doc = _scrape(port)
        if doc.get("pod", {}).get("survivors") == [0, 1]:
            break
        time.sleep(0.2)
    assert doc is not None and doc["pod"]["survivors"] == [0, 1], doc
    detect_wall = time.monotonic() - t_kill
    assert doc["pod"]["members"]["2"]["alive"] is False
    assert doc["pod"]["members"]["1"]["alive"] is True
    assert doc["pod"]["members"]["1"]["status"] is not None  # per-host view
    assert doc["control"]["state"] == "leader"
    assert doc["control"]["epoch"] == 1

    pod.sigterm(0)
    pod.sigterm(1)
    pod.procs[2].wait()
    pod.wait_all()

    tmp = pod_factory.tmp_path
    for r in (0, 1):
        out = pod.out(r)
        # exactly ONE membership commit, identical on both survivors
        commits = pod.events(r, kind="commit")
        assert len(commits) == 1, out
        assert commits[0]["dead"] == "2"
        assert commits[0]["survivors"] == "0,1"
        assert commits[0]["epoch"] == "1"
        assert commits[0]["leader"] == "0"
        # continuous trajectory: the step counter never skipped or reset
        steps = [int(m.group(1)) for m in
                 re.finditer(r"STEP rank=\d+ step=(\d+)", out)]
        assert steps == list(range(len(steps))) and len(steps) > 5
        # detection attributable in mlsl_stats.log, within the miss budget
        # (real processes — no GIL coupling — so the bound is sharp; slack
        # covers one tick of scheduling)
        det = pod.stats_lines(tmp, r, "deaths_detected")
        assert len(det) == 1 and "rank=2" in det[0], det
        age = float(re.search(r"last_hb_age=([\d.]+)s", det[0]).group(1))
        assert age <= BUDGET + 2 * INTERVAL, det[0]
        assert len(pod.stats_lines(tmp, r, "epochs_committed")) >= 1
    # end-to-end wall time from kill to a scraped shrunken /healthz stays
    # within detection + barrier + scrape slack
    assert detect_wall <= 2 * BUDGET + 5.0


def test_sigterm_one_coordinated_drain(pod_factory):
    """Preemption notice to ONE process -> exactly one pod-wide drain
    decision (made by the leader, attributable in its stats log), executed
    by every member as a verified save — never N racing local handlers."""
    pod = pod_factory(3)
    pod.wait_ready()
    time.sleep(4 * INTERVAL)
    pod.sigterm(1)  # a follower gets the scheduler's notice
    pod.wait_all()

    tmp = pod_factory.tmp_path
    # exactly ONE decision pod-wide, and it lives at the leader
    decisions = [pod.stats_lines(tmp, r, "drain_decisions")
                 for r in range(3)]
    assert [len(d) for d in decisions] == [1, 0, 0], decisions
    assert "rank=1" in decisions[0][0] and "mode=save" in decisions[0][0]
    for r in range(3):
        out = pod.out(r)
        assert re.search(r"DRAIN rank=%d mode=save target=1" % r, out), out
        assert re.search(r"DRAINED rank=%d mode=save" % r, out), out
        # every member executed its part: state file written, exit clean
        assert (pod.dir / f"rank{r}.state").exists()
        assert pod.procs[r].returncode == 0
        assert len(pod.stats_lines(tmp, r, "drains_executed")) == 1
        # nobody shed capacity for a save-mode drain
        assert pod.events(r, kind="commit") == []


@pytest.mark.slow
def test_pod_soak_sequential_kills(pod_factory):
    """Full variant (scripts/run_pod_sim.sh / run_soak.sh): two sequential
    SIGKILLs on a 4-member pod — each detected, each committed as its own
    epoch, leadership surviving the loss of the leader itself, and the
    final survivors still stepping with an unbroken trajectory."""
    pod = pod_factory(4, steps=1200, step_s=0.05)
    pod.wait_ready()
    time.sleep(4 * INTERVAL)
    pod.sigkill(3)
    # wait for epoch 1 before the second fault: sequential, not concurrent
    port = pod.http_port(0)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if _scrape(port).get("pod", {}).get("survivors") == [0, 1, 2]:
            break
        time.sleep(0.2)
    pod.sigkill(0)  # the LEADER dies; rank 1 must take over
    port = pod.http_port(1)
    deadline = time.monotonic() + 30
    doc = None
    while time.monotonic() < deadline:
        doc = _scrape(port)
        if doc.get("pod", {}).get("survivors") == [1, 2]:
            break
        time.sleep(0.2)
    assert doc is not None and doc["pod"]["survivors"] == [1, 2], doc
    assert doc["pod"]["leader"] == 1
    pod.sigterm(1)
    pod.sigterm(2)
    pod.procs[0].wait()
    pod.procs[3].wait()
    pod.wait_all()
    tmp = pod_factory.tmp_path
    for r in (1, 2):
        out = pod.out(r)
        commits = pod.events(r, kind="commit")
        assert [c["epoch"] for c in commits] == ["1", "2"], out
        assert commits[0]["dead"] == "3" and commits[1]["dead"] == "0"
        assert commits[1]["leader"] == "1"
        steps = [int(m.group(1)) for m in
                 re.finditer(r"STEP rank=\d+ step=(\d+)", out)]
        assert steps == list(range(len(steps)))
        assert len(pod.stats_lines(tmp, r, "elections")) == 1


def test_ntp_step_does_not_kill():
    """Regression pin for the wall-clock liveness contract
    (control/plane.py): heartbeat ``ts`` stamps are display-only, and ALL
    miss/grace accounting compares the receiver's own ``time.monotonic()``
    stamps. A ±1h NTP step of ``time.time()`` mid-run — on every member at
    once, the worst case — must not fabricate a death, an election, or an
    epoch commit while heartbeats keep flowing.

    In-process planes (like tests/test_control.py) rather than the
    subprocess pod: the step must hit the *running* interpreter, which
    monkeypatching ``time.time`` can only do in-process."""
    from unittest import mock

    from mlsl_tpu_torch.control.plane import ControlPlane
    from mlsl_tpu_torch.core import stats

    # The miss budget (interval * misses) is real time the scheduler can eat:
    # on a loaded box a heartbeat thread stalling past it fabricates exactly
    # the death this test pins to zero. 1s of budget keeps the test about the
    # wall-clock step, not about CPU contention.
    interval, misses = 0.25, 4
    stats.reset_control_counters()
    planes = [
        ControlPlane(r, [("127.0.0.1", 0)] * 3,
                     interval_s=interval, misses=misses)
        for r in range(3)
    ]
    real_time = time.time
    offset = [0.0]
    try:
        for p in planes:
            p.start()
        addrs = [("127.0.0.1", p.listen_port) for p in planes]
        for p in planes:
            p.addrs = addrs
        # settle: everyone heartbeating, full membership, epoch 0
        time.sleep(4 * interval)
        with mock.patch("time.time", lambda: real_time() + offset[0]):
            for step_s in (3600.0, -7200.0):  # forward, then back past 0
                offset[0] += step_s
                time.sleep((misses + 2) * interval)  # > full miss budget
        for p in planes:
            st = p.status()
            assert st["alive"] == [0, 1, 2], st
            assert st["epoch"] == 0, st
    finally:
        for p in planes:
            p.stop()
    assert stats.CONTROL_COUNTERS["deaths_detected"] == 0
    assert stats.CONTROL_COUNTERS["epochs_committed"] == 0
    assert stats.CONTROL_COUNTERS["elections"] == 0


def test_sim_never_falls_back_to_the_cpu(tmp_path):
    """Without ``--device cpu`` a worker initializes its Environment on the
    card; where there is none it exits with an error and steps nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the worker would run on it")
    env = dict(os.environ, MLSL_CONTROL_PORT=str(_free_base(1)), MLSL_CONTROL_WORLD="1",
               MLSL_CONTROL_RANK="0", MLSL_STATS_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "mlsl_tpu_torch.control.sim", "--steps", "3"],
                          capture_output=True, text=True, env=env, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "STEP" not in proc.stdout
