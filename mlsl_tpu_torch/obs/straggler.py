"""Straggler sentinel: cross-replica step-time/wait-latency skew detection.

Counterpart of ``mlsl_tpu.obs.straggler``, by adapted copy. With
``MLSL_STRAGGLER_SHED`` armed, ``resilience.FaultTolerantLoop`` hands
:meth:`StragglerSentinel.shed_candidate` to the elastic coordinator
(``ElasticCoordinator.shed``) between steps; remote pod members' step times
arrive through the control plane (:meth:`StragglerSentinel.observe_remote`).

The integrity sentinel (the JAX package's sentinel) catches replicas whose *state*
diverges; nothing catches a replica whose *speed* diverges — a thermally
throttled chip, a host with a noisy neighbor, a degrading ICI link. In a
synchronous data-parallel step every replica waits for the slowest one, so a
persistent straggler taxes the whole world its full skew, and before this
module the only evidence was a post-hoc log read. The sentinel closes the
loop from measurement to action:

1. **Measure** — :meth:`observe` feeds one replica's step wall time (and
   optionally its request wait latency) into per-replica
   :class:`~mlsl_tpu_torch.obs.metrics.Histogram` pairs, windowed per audit
   interval. Each process feeds its OWN replica id; on the port's one-process world
   of virtual ranks that is one replica, and tests feed multiple ids
   explicitly — the compare
   path is id-agnostic by design, so the multi-host plumb (ROADMAP #4's
   remaining work) only has to deliver observations, not new logic.
2. **Compare** — every ``MLSL_STRAGGLER_EVERY`` observed steps per replica
   (the window closes when the fastest-reporting replica has a full one),
   :meth:`maybe_audit` takes each replica's window median and compares it
   to the median-of-medians baseline. A replica past
   ``MLSL_STRAGGLER_SKEW`` x baseline is suspect; ``MLSL_STRAGGLER_SUSTAIN``
   consecutive suspect audits make it a confirmed straggler (one slow GC
   pause must not shed a replica).
3. **Act** — a confirmed straggler fires a DEGRADE-style event
   (core/stats.record_straggler: STRAGGLER line + counters + an obs
   timeline instant) and, when ``MLSL_STRAGGLER_SHED`` arms it, is exposed
   as :meth:`shed_candidate` — FaultTolerantLoop hands it to the elastic
   coordinator (``ElasticCoordinator.shed``) as a synthetic DEVICE_LOSS, so
   the same shrink/budget/grow machinery that answers a preemption answers
   a chronic straggler.

Wait latency rides along because it separates the two straggler classes:
a slow-compute replica has high step time and LOW wait (everyone waits for
it); a slow-link replica has high wait. The fired event carries both.

Process-wide module state mirrors the other sentinels: the armed instance
registers itself so ``supervisor.status()['straggler']`` (and /healthz)
reports it without a trainer handle.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from mlsl_tpu_torch.log import log_warning
from mlsl_tpu_torch.obs import metrics as metrics_mod
from mlsl_tpu_torch.obs import tracer as obs

ENV_SKEW = "MLSL_STRAGGLER_SKEW"
ENV_EVERY = "MLSL_STRAGGLER_EVERY"
ENV_SUSTAIN = "MLSL_STRAGGLER_SUSTAIN"
ENV_SHED = "MLSL_STRAGGLER_SHED"

DEFAULT_EVERY = 20
DEFAULT_SUSTAIN = 2
#: minimum per-replica observations inside a window before it may be judged
#: (a replica that contributed one sample to this window is data, not a
#: distribution)
MIN_WINDOW_SAMPLES = 3


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class StragglerSentinel:
    """Per-replica skew monitor. Constructed explicitly (tests, soaks) or by
    ``DataParallelTrainer`` when ``straggler_skew`` arms it. A knob left at
    None takes the Config that
    ``Environment.init`` handed over (:func:`configure`), else its
    environment variable."""

    def __init__(self, skew: Optional[float] = None,
                 every: Optional[int] = None,
                 sustain: Optional[int] = None,
                 shed: Optional[bool] = None):
        from mlsl_tpu_torch.config import _env_bool, _env_float, _env_int

        c = _config
        if c is not None:
            skew = c.straggler_skew if skew is None else skew
            every = c.straggler_every if every is None else every
            sustain = c.straggler_sustain if sustain is None else sustain
            shed = c.straggler_shed if shed is None else shed
        if skew is None:
            skew = _env_float(ENV_SKEW, 0.0)
        if every is None:
            every = _env_int(ENV_EVERY, DEFAULT_EVERY)
        if sustain is None:
            sustain = _env_int(ENV_SUSTAIN, DEFAULT_SUSTAIN)
        if shed is None:
            shed = _env_bool(ENV_SHED, False)
        self.skew = float(skew)
        # a window below the judgeable minimum would close before any
        # replica reaches MIN_WINDOW_SAMPLES and silently disable detection
        # (Config.validate enforces the same floor for the env knob)
        self.every = max(int(every), MIN_WINDOW_SAMPLES)
        self.sustain = max(int(sustain), 1)
        self.shed = bool(shed)
        # lifetime distributions (scrape surface): per-replica histograms in
        # the process registry when armed, so /metrics exposes
        # mlsl_replica_step_ms{replica=...} without extra bookkeeping
        self._win_step: Dict[int, List[float]] = {}
        self._win_wait: Dict[int, List[float]] = {}
        self._suspect_streak: Dict[int, int] = {}
        self._remote_replicas: set = set()
        self._audits = 0
        self._flagged: Dict[int, dict] = {}
        self._candidate: Optional[int] = None
        self._lock = threading.Lock()
        _set_active(self)

    # -- feed --------------------------------------------------------------

    def observe(self, replica: int, step_ms: float,
                wait_ms: Optional[float] = None) -> None:
        """One replica-step observation (trainer hot path; cheap: two list
        appends, plus registry histogram upserts when metrics is armed)."""
        replica = int(replica)
        with self._lock:
            self._win_step.setdefault(replica, []).append(float(step_ms))
            if wait_ms is not None:
                self._win_wait.setdefault(replica, []).append(float(wait_ms))
        m = metrics_mod._registry
        if m is not None:
            m.observe("mlsl_replica_step_ms", step_ms, replica=replica)
            if wait_ms is not None:
                m.observe("mlsl_replica_wait_ms", wait_ms, replica=replica)

    def observe_remote(self, replica: int, samples) -> None:
        """Feed a REMOTE rank's step times (delivered over control-plane
        heartbeat frames — ROADMAP #2b closed: the multi-host plumb only
        had to deliver observations). Runs on the control listener thread:
        host-side list appends under the same lock as :meth:`observe`, no
        device work (the A202 contract). Remote ranks are tracked so
        /healthz shows the audit baseline truly spans the pod."""
        replica = int(replica)
        with self._lock:
            self._remote_replicas.add(replica)
        for ms in samples:
            self.observe(replica, float(ms))

    # -- compare -----------------------------------------------------------

    def maybe_audit(self, step: int) -> Optional[dict]:
        """Run the cross-replica comparison when a full window has
        accumulated; returns the audit verdict dict when an audit ran (None
        otherwise). Called by the trainer each step. ``every`` is
        observations PER REPLICA (= steps, at one observe per step): the
        window closes when the fastest-reporting replica has a full one —
        counting TOTAL observations would shrink every replica's window as
        the world grows, until past ``every/MIN_WINDOW_SAMPLES`` replicas
        nobody ever reaches the judgeable minimum and detection silently
        turns off."""
        with self._lock:
            if not self._win_step or max(
                    len(v) for v in self._win_step.values()) < self.every:
                return None
        return self.audit_now(step)

    def audit_now(self, step: int = 0) -> dict:
        """One cross-replica comparison over the current windows (the
        windows reset afterwards). With fewer than two replicas reporting
        there is no baseline — the audit records itself and clears, firing
        nothing (zero false positives on a world that cannot skew)."""
        from mlsl_tpu_torch.core import stats as stats_mod

        with self._lock:
            win_step = {r: v for r, v in self._win_step.items()
                        if len(v) >= MIN_WINDOW_SAMPLES}
            win_wait = {r: list(v) for r, v in self._win_wait.items()}
            self._win_step = {}
            self._win_wait = {}
            self._audits += 1
            # a replica absent from (or data-starved in) this window was
            # not JUDGED, so it cannot extend a suspect streak — without
            # this, two suspect audits any distance apart would read as
            # "consecutive" and confirm a replica that was slow twice in a
            # month (the one-GC-pause class sustain exists to filter)
            for r in list(self._suspect_streak):
                if r not in win_step:
                    self._suspect_streak.pop(r)
        stats_mod.record_straggler("audits")
        verdict = {"step": step, "replicas": sorted(win_step),
                   "suspects": [], "confirmed": []}
        if len(win_step) < 2:
            return verdict
        medians = {r: _median(v) for r, v in win_step.items()}
        verdict["baseline_ms"] = _median(list(medians.values()))
        for r, med in medians.items():
            # a replica is judged against its PEERS' median, never a pool
            # that includes itself — with two replicas a 3x straggler would
            # otherwise drag the baseline up and read as only 1.5x
            peers = [m for rr, m in medians.items() if rr != r]
            baseline = _median(peers)
            if baseline <= 0:
                continue
            ratio = med / baseline
            if self.skew > 0 and ratio > self.skew:
                verdict["suspects"].append(r)
                with self._lock:
                    streak = self._suspect_streak.get(r, 0) + 1
                    self._suspect_streak[r] = streak
                if streak >= self.sustain:
                    self._fire(r, step, med, baseline, ratio,
                               _median(win_wait.get(r, [])))
                    verdict["confirmed"].append(r)
            else:
                with self._lock:
                    self._suspect_streak.pop(r, None)
        return verdict

    # -- act ---------------------------------------------------------------

    def _fire(self, replica: int, step: int, med_ms: float,
              baseline_ms: float, ratio: float, wait_med_ms: float) -> None:
        from mlsl_tpu_torch.core import stats as stats_mod

        detail = (f"replica={replica} step={step} p50={med_ms:.2f}ms "
                  f"baseline={baseline_ms:.2f}ms skew={ratio:.2f}x "
                  f"wait_p50={wait_med_ms:.2f}ms "
                  f"({'shed-armed' if self.shed else 'observe-only'})")
        sets_candidate = False
        with self._lock:
            # the write must hold the lock: status() (the /healthz scrape
            # thread) iterates _flagged under it, and an unlocked insert
            # here would 500 the scrape mid-incident
            first = replica not in self._flagged
            self._flagged[replica] = {
                "step": step, "skew": round(ratio, 3),
                "p50_ms": round(med_ms, 3),
                "baseline_ms": round(baseline_ms, 3),
                "wait_p50_ms": round(wait_med_ms, 3),
            }
            if self.shed and self._candidate is None:
                self._candidate = replica
                sets_candidate = True
        # one FLAGS event per confirmation that is NEWS: the first time a
        # replica is confirmed, or a re-confirmation that arms a fresh shed
        # candidate (post clear_candidate). Shed-armed with the candidate
        # still pending un-consumed (no elastic coordinator in the loop)
        # must NOT re-record every audit — flags counts stragglers, not
        # audit intervals, and one chronic straggler must not fill the log
        if not (first or sets_candidate):
            return
        stats_mod.record_straggler("flags", detail)
        log_warning("straggler sentinel: %s", detail)
        tr = obs._tracer
        if tr is not None:
            # DEGRADE-style timeline annotation: the straggler interval
            # starts here; a shed (resilience loop) closes it with an
            # elastic.shrink span
            tr.instant("straggler.flag", "straggler", replica=replica,
                       step=step, skew=round(ratio, 3),
                       p50_ms=round(med_ms, 3),
                       baseline_ms=round(baseline_ms, 3))

    def shed_candidate(self) -> Optional[int]:
        """The confirmed straggler awaiting an elastic shed (None when shed
        is unarmed or nothing is confirmed). FaultTolerantLoop polls this
        between steps and hands it to ``ElasticCoordinator.shed``."""
        return self._candidate

    def clear_candidate(self) -> None:
        """The loop took (or refused) the candidate; a later audit must
        re-confirm before another shed fires."""
        with self._lock:
            self._candidate = None
            self._suspect_streak.clear()

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """JSON-serializable summary for supervisor.status()['straggler']
        (the /healthz contract). ``state`` uses its own vocabulary
        ('watching'/'flagged') — stats.print_ lists it in the DEGRADE line
        only when flagged, the elastic/'full' lesson."""
        with self._lock:
            return {
                "state": "flagged" if self._flagged else "watching",
                "skew_threshold": self.skew,
                "every": self.every,
                "sustain": self.sustain,
                "shed_armed": self.shed,
                "audits": self._audits,
                "flagged": {str(r): dict(v)
                            for r, v in self._flagged.items()},
                "shed_candidate": self._candidate,
                "remote_replicas": sorted(self._remote_replicas),
            }


#: the armed process-wide instance (the sentinel/elastic registry pattern:
#: supervisor.status() must report it with no trainer handle in scope)
_active: Optional[StragglerSentinel] = None


def _set_active(s: Optional[StragglerSentinel]) -> None:
    global _active
    _active = s


def get_active() -> Optional[StragglerSentinel]:
    return _active


def reset() -> None:
    """Drop the active instance (tests)."""
    _set_active(None)


#: the live Environment's Config (:func:`configure`)
_config = None


def configure(config=None) -> None:
    """Take ``Config.straggler_*`` as the sentinel's defaults
    (``Environment.init`` hands over its Config, ``finalize`` takes it back
    with ``None``); without one, the environment variables."""
    global _config
    _config = config


def armed(config=None) -> bool:
    """Is the straggler sentinel armed (``Config.straggler_skew`` > 0 of
    ``config``, else of the Config handed over at init, else
    MLSL_STRAGGLER_SKEW)?"""
    if config is None:
        config = _config
    if config is not None:
        return float(getattr(config, "straggler_skew", 0.0) or 0.0) > 0
    try:
        return float(os.environ.get(ENV_SKEW) or 0.0) > 0
    except ValueError:
        return False


def status() -> dict:
    """Module-level summary for supervisor.status()."""
    if _active is None:
        return {"state": "off"}
    return _active.status()
