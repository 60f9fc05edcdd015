"""Pod membership, heartbeat failure detection, election, and drain.

Counterpart of ``mlsl_tpu.control.plane``, by adapted copy: a committed loss
names the lost members' virtual ranks (``device_map`` holds ints where the
JAX package holds devices), and the loss error it raises feeds
``mlsl_tpu_torch.elastic``'s shrink.

One :class:`ControlPlane` per process turns N single-process fault-tolerance
stacks into one pod-wide contract (ROADMAP #2):

- **Membership + heartbeat.** Every member heartbeats a tiny liveness/status
  frame to every live peer at ``MLSL_HEARTBEAT_INTERVAL_S``;
  ``MLSL_HEARTBEAT_MISSES`` consecutive missed intervals declare a peer
  locally dead. Local suspicion is NOT a reshard: survivors converge on one
  plan through a loss-epoch barrier (below), then every survivor synthesizes
  ``MLSLDeviceLossError(devices=<dead host's devices>)`` into its training
  loop, feeding the elastic shrink path (PR 14) with cross-process agreement
  on the survivor set.

- **Election + epoch fencing.** The lowest surviving rank leads. Membership
  changes are *committed* only by the member that believes it leads, after a
  barrier-with-timeout (one miss budget) that unions every survivor's
  observed losses into ONE survivor set — two hosts observing different
  losses converge on one reshard plan instead of split-brain meshes. Every
  commit carries ``(epoch, leader)``; a receiver rejects any order whose
  epoch is not strictly newer or whose leader is not its current minimum
  live rank, so a deposed leader's stale reshard order dies at the fence.
  Leader death needs no special machinery: it is one more membership event,
  and the next-lowest survivor commits it.

- **Coordinated preemption drain.** A SIGTERM (resilience.PreemptionGuard)
  or the appearance of ``MLSL_PREEMPTION_FILE`` submits a structured notice
  to the leader; the leader makes exactly ONE pod-wide drain decision —
  ``shrink`` (survivors absorb the draining host's shards, elastic armed) or
  ``save`` (pod-wide verified checkpoint) — and broadcasts it epoch-fenced,
  instead of N racing local SIGTERM handlers.

- **Pod observability.** Heartbeat frames carry each member's pushed
  supervisor-status snapshot and its recent per-step times; the leader's
  merged ``/healthz`` (obs/serve.py) reports per-host status + heartbeat
  ages, and remote step times are fed into the local straggler sentinel so
  cross-host stragglers are judged against true pod-wide peer medians.

Threading contract (the A202 rule, by construction): the heartbeat and
listener threads touch host state only — membership dicts, JSON documents
pushed from the training thread, socket IO, stats appends. Device dispatch
stays on the consumer thread; losses surface there via :meth:`take_loss`.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from mlsl_tpu_torch import chaos
from mlsl_tpu_torch.analysis import witness
from mlsl_tpu_torch.control import channel
from mlsl_tpu_torch.log import MLSLDeviceLossError, log_info, log_warning

ENV_INTERVAL = "MLSL_HEARTBEAT_INTERVAL_S"
ENV_MISSES = "MLSL_HEARTBEAT_MISSES"
ENV_GRACE = "MLSL_HEARTBEAT_GRACE_S"
ENV_NOTICE_FILE = "MLSL_PREEMPTION_FILE"

DEFAULT_INTERVAL_S = 2.0
DEFAULT_MISSES = 3
DEFAULT_GRACE_S = 30.0

#: commit/drain frames retry (losing one is an availability event);
#: heartbeats never do (a miss IS the signal)
COMMIT_SEND_RETRIES = 2


def _tracer_instant(name: str, **fields) -> None:
    from mlsl_tpu_torch.obs import tracer as obs

    if obs._tracer is not None:
        obs._tracer.instant(name, "control", **fields)


class ControlPlane:
    """One process's endpoint in the pod control plane.

    ``rank``: this process's pod rank (0-based, dense).
    ``addrs``: rank -> (host, port) for every member, identical on all
        members (the membership bootstrap — on a real pod this comes from
        the scheduler's hostfile; the CPU sim derives it from
        ``MLSL_CONTROL_PORT`` + world size).
    ``device_map``: rank -> the virtual ranks that member contributes to
        the pod world. Integer entries make a committed loss locally
        actionable (:meth:`take_loss` raises the device-loss error the
        elastic coordinator reshards around); plain-string labels record the
        pod transition only (the multi-process sim, where a survivor's world
        never contained the dead member's ranks).
    """

    def __init__(
        self,
        rank: int,
        addrs: Sequence[Tuple[str, int]],
        device_map: Optional[Dict[int, tuple]] = None,
        interval_s: Optional[float] = None,
        misses: Optional[int] = None,
        grace_s: Optional[float] = None,
        notice_file: Optional[str] = None,
    ):
        from mlsl_tpu_torch.config import _env_float, _env_int

        if interval_s is None:
            interval_s = _env_float(ENV_INTERVAL, DEFAULT_INTERVAL_S)
        if misses is None:
            misses = _env_int(ENV_MISSES, DEFAULT_MISSES)
        if grace_s is None:
            grace_s = _env_float(ENV_GRACE, DEFAULT_GRACE_S)
        if notice_file is None:
            notice_file = os.environ.get(ENV_NOTICE_FILE, "")
        self.rank = int(rank)
        self.addrs = [tuple(a) for a in addrs]
        if not 0 <= self.rank < len(self.addrs):
            raise ValueError(
                f"control rank {rank} outside the address table "
                f"(world {len(self.addrs)})"
            )
        self.world = len(self.addrs)
        self.device_map = dict(device_map or {})
        self.interval_s = max(0.01, float(interval_s))
        self.misses = max(1, int(misses))
        self.grace_s = max(0.0, float(grace_s))
        self.notice_file = notice_file or ""

        self._lock = witness.named_lock("control.plane")
        self.epoch = 0
        self.alive = set(range(self.world))
        self._last_seen: Dict[int, float] = {}
        self._peer_status: Dict[int, dict] = {}
        self._peer_step: Dict[int, int] = {}
        self._observed_dead: set = set()
        self._suspected_at: Dict[int, float] = {}
        self._proposals: Dict[int, set] = {}
        self._barrier_deadline: Optional[float] = None
        self._barrier_extensions = 0
        self._drained: set = set()
        self._evicted = False
        self._leader_last = 0  # rank 0 leads epoch 0 by construction
        self._pending_losses: deque = deque()
        self._pending_drain: Optional[dict] = None
        self._notice_out: Optional[dict] = None
        self._decided_notices: set = set()
        self._pushed_status: Optional[dict] = None
        self._local_step: Optional[int] = None
        self._step_samples: List[float] = []
        #: committed membership/drain events, newest last (sim + tests read
        #: these; bounded so a long soak cannot grow without bound)
        self.events: deque = deque(maxlen=64)

        self._stop = threading.Event()
        self._listener: Optional[channel.Listener] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._started_at: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ControlPlane":
        """Bind the listener and start heartbeating. Connect-side failures
        during bootstrap are absorbed by the grace window (peers may still
        be importing its packages)."""
        if self._listener is not None:
            return self
        self._listener = channel.Listener(
            self.addrs[self.rank], self._on_frame
        )
        self._started_at = time.monotonic()
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name=f"mlsl-control-hb:{self.rank}",
            daemon=True,
        )
        self._hb_thread.start()
        log_info(
            "control plane up: rank %d/%d on %s:%d (interval %.3gs, "
            "miss budget %d)", self.rank, self.world,
            self.addrs[self.rank][0] or "0.0.0.0", self.listen_port,
            self.interval_s, self.misses,
        )
        return self

    @property
    def listen_port(self) -> int:
        return self._listener.port if self._listener is not None else 0

    def stop(self) -> None:
        """Graceful stop: peers keep their own miss accounting; a stopped
        member that was not drained first will be detected as dead (that is
        the correct reading of an unannounced exit)."""
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            if self._hb_thread.is_alive():  # pragma: no cover - defensive
                log_warning("control heartbeat thread did not stop within 5s")
            self._hb_thread = None
        if self._listener is not None:
            self._listener.stop()
            self._listener = None

    def kill(self) -> None:
        """Abrupt stop (tests): identical to stop() on purpose — from the
        peers' side there is no difference between a SIGKILLed process and
        one that silently stopped heartbeating."""
        self.stop()

    # -- feed from the training thread ------------------------------------

    def push_status(self, status: Optional[dict] = None,
                    step: Optional[int] = None,
                    step_ms: Optional[float] = None) -> None:
        """Publish this member's health snapshot for the next heartbeat
        frame. Called from the training thread (the loop pushes
        ``supervisor.status()`` + the step clock); the heartbeat thread only
        serializes what was pushed — host-read scalars, the A202 contract."""
        with self._lock:
            if status is not None:
                self._pushed_status = status
            if step is not None:
                self._local_step = int(step)
            if step_ms is not None:
                self._step_samples.append(float(step_ms))
                del self._step_samples[:-32]

    # -- consumed by the training thread ----------------------------------

    def take_loss(self) -> Optional[MLSLDeviceLossError]:
        """The next committed membership loss that is LOCALLY actionable,
        as the device-loss error the elastic coordinator reshards around
        (FaultTolerantLoop raises it inside its recovery try). Commits whose
        devices are not in this process's world (the multi-process sim, a
        remote host's slice) are consumed as bookkeeping — the pod epoch
        advanced, the local mesh did not change."""
        while True:
            with self._lock:
                if not self._pending_losses:
                    return None
                ev = self._pending_losses.popleft()
            devices: list = []
            for r in ev["dead"]:
                devices.extend(self.device_map.get(r, ()))
            local = tuple(d for d in devices if not isinstance(d, str))
            if local:
                return MLSLDeviceLossError(
                    f"pod control plane: rank(s) {ev['dead']} lost at epoch "
                    f"{ev['epoch']} ({ev['reason']})", devices=local,
                )

    def take_drain(self) -> Optional[dict]:
        """The pending pod drain decision (once), or None."""
        with self._lock:
            d, self._pending_drain = self._pending_drain, None
            return d

    def submit_notice(self, reason: str) -> None:
        """A preemption notice for THIS rank (SIGTERM guard, notice file,
        or the embedder). Delivery to the leader happens on the heartbeat
        thread and is retried every tick until a drain decision covers this
        rank, so a dropped/delayed notice (the ``control.notice`` chaos
        site) degrades to latency, not to a lost drain."""
        with self._lock:
            if self._notice_out is None and self.rank not in self._drained:
                # "ts" is display-only forensics (who noticed first, in
                # human time, across hosts). Liveness NEVER reads it: all
                # miss/grace accounting compares the receiver's OWN
                # time.monotonic() stamps (_on_heartbeat/_detect_misses), so
                # an NTP step on either host cannot fabricate or mask a
                # death (tests/test_torch_pod.py::test_ntp_step_does_not_kill)
                self._notice_out = {
                    "t": "notice", "rank": self.rank, "reason": str(reason),
                    "ts": time.time(),
                }
                self._record("notices",
                             f"rank={self.rank} reason={reason}")
                _tracer_instant("control.notice", rank=self.rank,
                                reason=str(reason))

    def coordinate_preemption(self, reason: str,
                              timeout_s: Optional[float] = None
                              ) -> Optional[dict]:
        """Submit a notice and wait (bounded) for the pod's drain decision.
        Returns the decision dict, or None on timeout — the caller falls
        back to a local drain, because a partitioned leader must not turn a
        grace window into a hang."""
        if timeout_s is None:
            timeout_s = 2.0 * self.interval_s * self.misses + 1.0
        self.submit_notice(reason)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            d = self.take_drain()
            if d is not None:
                return d
            time.sleep(min(0.05, self.interval_s / 4))
        return None

    def record_drain_executed(self, step: int, mode: str) -> None:
        """The local loop finished its part of the pod drain (final save
        written / shrink handed to the survivors)."""
        self._record("drains_executed",
                     f"rank={self.rank} mode={mode} step={step}")
        _tracer_instant("control.drain_executed", rank=self.rank,
                        mode=mode, step=step)

    # -- leadership --------------------------------------------------------

    def leader(self) -> int:
        with self._lock:
            return min(self.alive) if self.alive else self.rank

    def is_leader(self) -> bool:
        return self.leader() == self.rank

    def may_decide(self) -> bool:
        """May this process make pod-level elastic decisions (grow
        re-admission, straggler shed)? The elastic coordinator's
        single-controller assumptions are re-homed behind the elected
        leader; followers apply committed epochs instead of originating
        them."""
        return not self._evicted and self.is_leader()

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """JSON-serializable local summary (supervisor.status()['control'],
        the /healthz contract)."""
        now = time.monotonic()
        with self._lock:
            ages = {
                str(r): round(now - t, 3)
                for r, t in self._last_seen.items() if r in self.alive
            }
            return {
                "state": "leader" if (
                    self.alive and min(self.alive) == self.rank
                ) else "member",
                "rank": self.rank,
                "world": self.world,
                "epoch": self.epoch,
                "leader": min(self.alive) if self.alive else None,
                "alive": sorted(self.alive),
                "dead": sorted(set(range(self.world)) - self.alive),
                "drained": sorted(self._drained),
                "evicted": self._evicted,
                "interval_s": self.interval_s,
                "misses": self.misses,
                "hb_age_s": ages,
            }

    def pod_status(self) -> dict:
        """The leader's merged view: every member's last pushed
        supervisor-status snapshot + heartbeat age (obs/serve.py merges
        this into /healthz on the leader)."""
        now = time.monotonic()
        with self._lock:
            members = {}
            for r in range(self.world):
                if r == self.rank:
                    members[str(r)] = {
                        "alive": r in self.alive, "hb_age_s": 0.0,
                        "step": self._local_step,
                        "status": self._pushed_status,
                    }
                else:
                    seen = self._last_seen.get(r)
                    members[str(r)] = {
                        "alive": r in self.alive,
                        "hb_age_s": round(now - seen, 3)
                        if seen is not None else None,
                        "step": self._peer_step.get(r),
                        "status": self._peer_status.get(r),
                    }
            return {
                "epoch": self.epoch,
                "leader": min(self.alive) if self.alive else None,
                "survivors": sorted(self.alive),
                "members": members,
            }

    # -- heartbeat thread --------------------------------------------------

    def _hb_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception as e:  # pragma: no cover - defensive
                log_warning("control tick failed: %s: %s",
                            type(e).__name__, e)

    def _tick(self) -> None:
        now = time.monotonic()
        self._poll_notice_file()
        self._flush_notice()
        self._send_heartbeats()
        self._detect_misses(now)
        self._maybe_commit(now)

    def _poll_notice_file(self) -> None:
        """The cluster-scheduler hook (ROADMAP #2a): a scheduler that cannot
        signal writes ``MLSL_PREEMPTION_FILE``; its appearance is a
        preemption notice for this host."""
        if self.notice_file and os.path.exists(self.notice_file):
            self.submit_notice(f"notice-file:{self.notice_file}")

    def _flush_notice(self) -> None:
        with self._lock:
            notice = self._notice_out
            if notice is None or self.rank in self._drained:
                return
            target = min(self.alive - self._observed_dead, default=self.rank)
        try:
            # injectable: a lost/delayed notice or a partitioned leader
            # (error/delay/hang at this site) degrades to retry-next-tick
            chaos.inject("control.notice", kinds=("error", "delay", "hang"))
            if target == self.rank:
                self._decide_drain(notice)
            else:
                channel.send_frame(self.addrs[target], notice, retries=1)
        except Exception as e:
            self._record("send_failures", line=False)
            log_warning("preemption notice delivery failed (retrying next "
                        "tick): %s: %s", type(e).__name__, e)

    def _send_heartbeats(self) -> None:
        with self._lock:
            # step samples are DRAINED, not re-sent: the remote sentinel's
            # windows must see each observation once, or duplicates would
            # skew the very medians the pod feed exists to widen
            samples, self._step_samples = self._step_samples, []
            # "ts" is display-only (log correlation across hosts); the
            # receiver stamps its own monotonic arrival time and liveness
            # compares monotonic-vs-monotonic only — sender wall-clock is
            # untrusted by contract (NTP steps, skewed hosts)
            frame = {
                "t": "hb", "rank": self.rank, "epoch": self.epoch,
                "step": self._local_step, "status": self._pushed_status,
                "steps_ms": samples[-16:], "ts": time.time(),
            }
            peers = sorted(
                (self.alive - self._observed_dead) - {self.rank}
            )
        for p in peers:
            try:
                # injectable: error = frame lost, delay/hang = late frame ->
                # the PEER's miss accounting sees it, which is the point
                chaos.inject("control.heartbeat",
                             kinds=("error", "delay", "hang"))
                channel.send_frame(self.addrs[p], frame, retries=0)
                self._record("heartbeats_sent", line=False)
            except Exception:
                self._record("send_failures", line=False)

    def _detect_misses(self, now: float) -> None:
        budget = self.interval_s * self.misses
        with self._lock:
            peers = sorted(self.alive - {self.rank} - self._observed_dead)
            newly_dead = []
            for p in peers:
                seen = self._last_seen.get(p)
                if seen is None:
                    # never heard from: the boot grace window applies (a
                    # peer may still be importing its packages); after it, silence
                    # is death like anywhere else
                    deadline = (self._started_at or now) + max(
                        self.grace_s, budget
                    )
                else:
                    deadline = seen + budget
                if now >= deadline:
                    self._observed_dead.add(p)
                    self._suspected_at[p] = seen if seen is not None else now
                    newly_dead.append((p, now - (seen if seen is not None
                                                 else now)))
            if newly_dead:
                candidate = min(self.alive - self._observed_dead,
                                default=self.rank)
        for p, age in newly_dead:
            self._record(
                "deaths_detected",
                f"rank={p} last_hb_age={age:.3f}s budget={budget:.3f}s "
                f"observer={self.rank}",
            )
            _tracer_instant("control.death_detected", rank=p,
                            observer=self.rank, age_s=round(age, 3))
        if not newly_dead:
            return
        if candidate == self.rank:
            with self._lock:
                self._proposals.setdefault(self.rank, set()).update(
                    self._observed_dead
                )
                if self._barrier_deadline is None:
                    self._barrier_deadline = now + budget
                    self._barrier_extensions = 0
        else:
            self._propose_to(candidate)

    def _propose_to(self, candidate: int) -> None:
        with self._lock:
            dead = sorted(self._observed_dead)
        if not dead:
            return
        try:
            channel.send_frame(
                self.addrs[candidate],
                {"t": "propose", "rank": self.rank, "dead": dead,
                 "epoch": self.epoch},
                retries=1,
            )
        except OSError:
            # the candidate may be freshly dead too; the next tick's miss
            # accounting will move the candidacy down the rank order
            self._record("send_failures", line=False)

    def _maybe_commit(self, now: float) -> None:
        """Close the loss-epoch barrier: the member that believes it leads
        waits one miss budget for peers' proposals, then commits the union
        it can itself corroborate — one reshard plan, not N."""
        with self._lock:
            if self._barrier_deadline is None or now < self._barrier_deadline:
                return
            union = set()
            for s in self._proposals.values():
                union |= s
            union &= self.alive
            # corroboration: commit only losses this member observed too (a
            # peer's false alarm about a rank we still hear from must not
            # shed live capacity); give uncorroborated proposals one more
            # barrier window to become observable before dropping them
            dead = union & self._observed_dead
            if not dead:
                if union and self._barrier_extensions < 1:
                    self._barrier_extensions += 1
                    self._barrier_deadline = (
                        now + self.interval_s * self.misses
                    )
                else:
                    self._barrier_deadline = None
                    self._proposals.clear()
                return
            if min(self.alive - dead, default=self.rank) != self.rank:
                # someone lower still lives: not ours to commit
                self._barrier_deadline = None
                return
            survivors = sorted(self.alive - dead)
            epoch = self.epoch + 1
            detect_s = max(
                (now - self._suspected_at.get(p, now) for p in dead),
                default=0.0,
            )
            commit = {
                "t": "commit", "epoch": epoch, "leader": self.rank,
                "survivors": survivors, "dead": sorted(dead),
                "reason": "heartbeat-miss",
                "detect_s": round(detect_s, 3),
            }
            self._barrier_deadline = None
            self._proposals.clear()
        if self._apply_commit(commit):
            # include the removed ranks: to a truly dead host this is a
            # refused connect and a warning, but a STALLED one (GC pause,
            # partition healed late) must hear it was evicted or it would
            # keep making pod decisions on a stale membership
            self._broadcast(commit, to=set(survivors) | dead,
                            best_effort=dead)

    def _broadcast(self, frame: dict,
                   to: Optional[Sequence[int]] = None,
                   best_effort: Sequence[int] = ()) -> None:
        """Fan ``frame`` out to ``to`` (default: current live peers). Drain
        orders pass an explicit recipient list: a shrink-mode apply removes
        the draining rank from ``alive`` BEFORE the broadcast, and that rank
        is precisely the one that must hear the verdict. ``best_effort``
        recipients (the ranks a commit itself removed — probably corpses)
        get ONE unretried attempt: retry backoff to a dead host would stall
        this thread past the miss budget and get the SENDER declared dead."""
        with self._lock:
            peers = sorted(
                (set(to) if to is not None else self.alive) - {self.rank}
            )
        for p in peers:
            try:
                channel.send_frame(
                    self.addrs[p], frame,
                    retries=0 if p in best_effort else COMMIT_SEND_RETRIES,
                )
            except OSError as e:
                self._record("send_failures", line=False)
                if p not in best_effort:
                    log_warning(
                        "control broadcast to rank %d failed: %s: %s",
                        p, type(e).__name__, e,
                    )

    # -- listener thread ---------------------------------------------------

    def _on_frame(self, frame: dict) -> None:
        t = frame.get("t")
        if t == "hb":
            self._on_heartbeat(frame)
        elif t == "propose":
            self._on_propose(frame)
        elif t == "commit":
            self._apply_commit(frame)
        elif t == "notice":
            self._on_notice(frame)
        elif t == "drain":
            self._apply_drain(frame)

    def _on_heartbeat(self, frame: dict) -> None:
        r = int(frame["rank"])
        now = time.monotonic()
        feed: List[float] = []
        with self._lock:
            if r not in self.alive:
                return  # removed by a committed epoch; re-admission is grow
            self._last_seen[r] = now
            if frame.get("status") is not None:
                self._peer_status[r] = frame["status"]
            if frame.get("step") is not None:
                self._peer_step[r] = int(frame["step"])
            if r in self._observed_dead:
                # heard from again before any commit removed it: a false
                # alarm (GC pause, loaded link) recovers without resharding
                self._observed_dead.discard(r)
                self._suspected_at.pop(r, None)
                log_info("control: rank %d resumed heartbeats before "
                         "commit; suspicion cleared", r)
            samples = frame.get("steps_ms") or ()
            if r != self.rank:
                feed = [float(x) for x in samples][-16:]
        self._record("heartbeats_recv", line=False)
        if feed:
            # pod-wide straggler judgment (ROADMAP #2b): remote replicas'
            # step times enter the LOCAL sentinel's windows, so the peer
            # median a replica is judged against spans the whole pod.
            # Host-side list appends only — safe on this thread.
            from mlsl_tpu_torch.obs import straggler as straggler_mod

            sent = straggler_mod.get_active()
            if sent is not None:
                sent.observe_remote(r, feed)

    def _on_propose(self, frame: dict) -> None:
        r = int(frame["rank"])
        dead = set(int(d) for d in frame.get("dead", ()))
        now = time.monotonic()
        with self._lock:
            if r not in self.alive or not dead:
                return
            # accept into the barrier only while this member is the lowest
            # rank OUTSIDE the proposed dead set (i.e. the candidate the
            # proposer elected); otherwise the proposal is for someone else
            if min(self.alive - dead, default=self.rank) != self.rank:
                return
            self._proposals[r] = dead & self.alive
            if self._barrier_deadline is None:
                self._barrier_deadline = (
                    now + self.interval_s * self.misses
                )
                self._barrier_extensions = 0

    def _fence(self, frame: dict, kind: str) -> bool:
        """Epoch + leadership fence (caller holds no lock). True = accept.

        The leadership check is evaluated NET OF the ranks the order itself
        removes: a leader-death commit is signed by the next-lowest
        survivor, who only becomes the minimum once the dead leader is out
        — judging it against the pre-commit membership would reject the
        very order that removes the dead leader. A deposed leader's stale
        order still dies here: it was already removed from the receiver's
        membership by the newer epoch, so it is never the minimum of any
        view, removed-set or not."""
        with self._lock:
            epoch = int(frame.get("epoch", -1))
            leader = frame.get("leader")
            removed = (
                set(int(d) for d in frame.get("dead", ()))
                if kind == "commit" else set()
            )
            expected = min(self.alive - removed, default=None)
            if epoch <= self.epoch or leader != expected:
                stale = (
                    f"{kind} epoch={epoch} leader={leader} rejected at "
                    f"rank={self.rank} (local epoch={self.epoch} "
                    f"expected leader={expected})"
                )
            else:
                return True
        self._record("stale_rejected", stale)
        _tracer_instant("control.stale_rejected", kind=kind,
                        epoch=epoch, rank=self.rank)
        return False

    def _apply_commit(self, frame: dict) -> bool:
        if not self._fence(frame, "commit"):
            return False
        with self._lock:
            epoch = int(frame["epoch"])
            survivors = set(int(s) for s in frame["survivors"])
            dead = sorted(int(d) for d in frame.get("dead", ()))
            prev_leader = min(self.alive) if self.alive else None
            self.epoch = epoch
            self.alive = survivors
            for d in dead:
                self._observed_dead.discard(d)
                self._suspected_at.pop(d, None)
                self._proposals.pop(d, None)
            for prop in self._proposals.values():
                prop.difference_update(dead)
            self._proposals = {r: s for r, s in self._proposals.items()
                               if s and r in survivors}
            if not self._proposals:
                self._barrier_deadline = None
            new_leader = min(survivors) if survivors else None
            elected = new_leader != prev_leader
            if self.rank not in survivors:
                self._evicted = True
            ev = {
                "kind": "commit", "epoch": epoch, "dead": dead,
                "survivors": sorted(survivors), "leader": new_leader,
                "reason": frame.get("reason", "heartbeat-miss"),
                "detect_s": frame.get("detect_s"),
            }
            self.events.append(ev)
            self._pending_losses.append({
                "epoch": epoch, "dead": dead,
                "reason": ev["reason"],
            })
        self._record(
            "epochs_committed",
            f"epoch={epoch} dead={','.join(map(str, dead))} "
            f"survivors={','.join(map(str, sorted(survivors)))} "
            f"leader={new_leader} reason={ev['reason']} "
            f"detect_s={ev.get('detect_s')}",
        )
        _tracer_instant("control.epoch", epoch=epoch,
                        dead=",".join(map(str, dead)),
                        leader=new_leader)
        if elected:
            self._record(
                "elections",
                f"epoch={epoch} leader={new_leader} deposed={prev_leader}",
            )
        if self._evicted:
            self._record("evicted", f"rank={self.rank} epoch={epoch}")
            log_warning(
                "control: rank %d was declared dead by the pod at epoch %d "
                "(partition?) — this process no longer makes pod decisions",
                self.rank, epoch,
            )
        return True

    # -- drain -------------------------------------------------------------

    def _on_notice(self, frame: dict) -> None:
        with self._lock:
            am_leader = bool(self.alive) and min(self.alive) == self.rank
        if am_leader:
            self._decide_drain(frame)
        # else: the sender's leader view is stale; its next tick re-targets

    def _decide_drain(self, notice: dict) -> None:
        """Leader only: exactly ONE pod-wide drain decision per noticed
        rank — shrink onto the survivors when the elastic coordinator is
        armed and survivors remain, else a pod-wide verified save."""
        r = int(notice["rank"])
        from mlsl_tpu_torch import elastic as elastic_mod

        with self._lock:
            if r in self._decided_notices or r not in self.alive:
                return  # duplicate notice: the decision already stands
            self._decided_notices.add(r)
            shrinkable = elastic_mod.armed() and len(self.alive) > 1
            mode = "shrink" if shrinkable else "save"
            epoch = self.epoch + 1
            survivors = sorted(self.alive - {r}) if mode == "shrink" \
                else sorted(self.alive)
            drain = {
                "t": "drain", "epoch": epoch, "leader": self.rank,
                "mode": mode, "rank": r, "survivors": survivors,
                "reason": notice.get("reason", "preemption"),
            }
        self._record(
            "drain_decisions",
            f"epoch={epoch} rank={r} mode={mode} leader={self.rank} "
            f"reason={drain['reason']}",
        )
        _tracer_instant("control.drain", epoch=epoch, rank=r, mode=mode)
        try:
            # the decision broadcast is notice-path traffic too: a delayed
            # or dropped order is the injectable failure mode here
            chaos.inject("control.notice", kinds=("error", "delay", "hang"))
        except Exception as e:
            log_warning("drain broadcast perturbed by chaos (%s); "
                        "proceeding: %s", type(e).__name__, e)
        if self._apply_drain(drain):
            self._broadcast(drain, to=set(survivors) | {r})

    def _apply_drain(self, frame: dict) -> bool:
        if not self._fence(frame, "drain"):
            return False
        r = int(frame["rank"])
        mode = frame["mode"]
        with self._lock:
            epoch = int(frame["epoch"])
            self.epoch = epoch
            self._drained.add(r)
            self._decided_notices.add(r)
            if r == self.rank:
                self._notice_out = None
            if mode == "shrink":
                self.alive.discard(r)
                self._observed_dead.discard(r)
                if r != self.rank:
                    # survivors reshard around the drained rank; the rank
                    # itself is exiting, not suffering a device loss
                    self._pending_losses.append({
                        "epoch": epoch, "dead": [r], "reason": "drain",
                    })
            ev = {
                "kind": "drain", "epoch": epoch, "rank": r, "mode": mode,
                "survivors": sorted(self.alive),
                "leader": frame.get("leader"),
                "reason": frame.get("reason"),
            }
            self.events.append(ev)
            self._pending_drain = dict(frame)
        self._record(
            "epochs_committed",
            f"epoch={epoch} drain rank={r} mode={mode} "
            f"survivors={','.join(map(str, ev['survivors']))} "
            f"leader={frame.get('leader')}",
        )
        return True

    # -- stats -------------------------------------------------------------

    @staticmethod
    def _record(event: str, detail: str = "", line: bool = True,
                count: bool = True) -> None:
        from mlsl_tpu_torch.core import stats as stats_mod

        stats_mod.record_control(event, detail, line=line, count=count)
