"""Recovery supervisor: error taxonomy, retry policy and circuit breakers.

Counterpart of ``mlsl_tpu.supervisor``: the four-rung escalation ladder.

1. **Classify** (:func:`classify`): every exception at an instrumented site
   maps to an :class:`ErrorClass` that selects the recovery policy.
2. **Retry** (``MLSL_COMM_RETRIES`` / ``MLSL_COMM_RETRY_BACKOFF_S``):
   TRANSIENT failures of collective dispatch and wait retry in place with
   exponential backoff and jitter (:func:`jittered_backoff`); the device
   feed's reads and the serving engine's decode step use the same gate.
3. **Degrade** (:class:`CircuitBreaker`): PERSISTENT and CORRUPTION failures
   (and exhausted retries) count against a per-subsystem breaker. After
   ``MLSL_BREAKER_THRESHOLD`` classified failures inside a sliding
   ``MLSL_BREAKER_WINDOW_S`` window the breaker trips OPEN and the subsystem
   runs its always-correct path instead of dying: the quantized ring the
   plain float32 SUM (error-feedback residual flushed once), coalesced
   buckets the members' own requests, a forced or tuned algorithm ``lax``
   (torch's own reduction, on the card), the trace exporter a no-op. Each
   degraded dispatch is counted (``stats.DEGRADE_FALLBACKS``) and filed as a
   DEGRADE event; it runs on the same device as the healthy path. After
   ``MLSL_BREAKER_COOLDOWN_S`` the breaker goes HALF_OPEN and lets the
   healthy path probe; one success re-closes it, one failure re-opens.
4. **Restart**: what rungs 1-3 could not absorb raises to the caller:
   ``resilience.FaultTolerantLoop`` restores the newest verified checkpoint
   within its restart budget, or, with the elastic mesh armed, answers a
   DEVICE_LOSS by shrinking to the survivor ranks (``elastic.py``).

Breakers are process-wide: subsystem health survives an Environment
rebuild. Knobs are (re)applied from :class:`mlsl_tpu_torch.config.Config`
at ``Environment.init`` via :func:`configure`; tests reset with :func:`reset`
(breakers) or :func:`reset_all` (the whole fault plane).

Hot-path contract: a closed breaker's ``allow()`` is one attribute compare;
requests with no degradable subsystem hold no breaker at all.
"""

from __future__ import annotations

import collections
import enum
import os
import random
import time
from typing import Deque, Dict, Optional

from mlsl_tpu_torch.analysis import witness
from mlsl_tpu_torch.log import (
    MLSLCorruptionError,
    MLSLDeviceLossError,
    MLSLError,
    MLSLKernelError,
    MLSLTimeoutError,
    log_warning,
)


class ErrorClass(enum.Enum):
    """Recovery policy classes."""

    #: flaky IO / timing: retry in place with backoff
    TRANSIENT = "transient"
    #: data integrity (bitrot, codec round-trip mismatch)
    CORRUPTION = "corruption"
    #: dispatch, compile or device failure
    PERSISTENT = "persistent"
    #: capacity left the world: never retried in place
    DEVICE_LOSS = "device_loss"
    #: caller bugs and resource exhaustion: surface immediately
    FATAL = "fatal"


# Ordered (exception type, class) table: the first isinstance match wins, so
# subclasses precede their bases (MLSLTimeoutError < MLSLError < RuntimeError;
# TimeoutError < OSError). A timeout of the watchdog already waited its whole
# budget, so it is PERSISTENT, not TRANSIENT. A kernel that cannot be built,
# loaded or launched is FATAL: no breaker ever serves its request on the plain
# version in its place (the JAX package has no such error).
_TAXONOMY = (
    (MLSLKernelError, ErrorClass.FATAL),
    (MLSLCorruptionError, ErrorClass.CORRUPTION),
    (MLSLDeviceLossError, ErrorClass.DEVICE_LOSS),
    (MLSLTimeoutError, ErrorClass.PERSISTENT),
    (MLSLError, ErrorClass.PERSISTENT),
    (TimeoutError, ErrorClass.TRANSIENT),
    (ConnectionError, ErrorClass.TRANSIENT),
    (OSError, ErrorClass.TRANSIENT),
    (MemoryError, ErrorClass.FATAL),
    (ArithmeticError, ErrorClass.CORRUPTION),
    (RuntimeError, ErrorClass.PERSISTENT),
)


def classify(exc: BaseException) -> ErrorClass:
    """Map an exception to its recovery class; anything outside the table
    (ValueError, TypeError, KeyboardInterrupt, ...) is FATAL."""
    for typ, cls in _TAXONOMY:
        if isinstance(exc, typ):
            return cls
    return ErrorClass.FATAL


# -- retry policy (rung 2) ----------------------------------------------------

# process-wide jitter source
_rng = random.Random()


def jittered_backoff(base_s: float, attempt: int,
                     rng: Optional[random.Random] = None) -> float:
    """Delay before retry ``attempt`` (0-based): ``base * 2**attempt`` scaled
    by a uniform jitter in [0.5, 1.5), so that workers retrying the same
    transient fault do not collide again in lockstep:
    0.5 * base * 2^a <= delay < 1.5 * base * 2^a."""
    r = rng if rng is not None else _rng
    return base_s * (2.0 ** attempt) * (0.5 + r.random())


# -- circuit breakers (rung 3) ------------------------------------------------

#: breaker states
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

#: the subsystems the ladder knows how to degrade (breakers are created on
#: demand, but status()/reset() always report the full set)
SUBSYSTEMS = ("quant", "bucket", "algo", "tracer")

# module defaults, overridden by configure() at Environment.init
_DEFAULT_THRESHOLD = int(os.environ.get("MLSL_BREAKER_THRESHOLD") or 3)
_DEFAULT_WINDOW_S = float(os.environ.get("MLSL_BREAKER_WINDOW_S") or 30.0)
_DEFAULT_COOLDOWN_S = float(os.environ.get("MLSL_BREAKER_COOLDOWN_S") or 10.0)


class CircuitBreaker:
    """closed -> open -> half_open -> closed, with a sliding failure window.

    - CLOSED: healthy. ``record_failure`` appends a timestamp; when
      ``threshold`` failures land inside the trailing ``window_s`` the
      breaker trips OPEN (the tripping call site degrades that very
      dispatch, so the Nth failure is served by the fallback, not raised).
    - OPEN: ``allow()`` is False — call sites skip the subsystem and run its
      degraded path. After ``cooldown_s`` the next ``allow()`` transitions
      to HALF_OPEN and returns True (the probe).
    - HALF_OPEN: the healthy path runs. One ``record_success`` re-closes
      (window cleared); one ``record_failure`` re-opens with a fresh
      cooldown.

    All transitions are recorded via core/stats.record_degrade (DEGRADE
    lines in mlsl_stats.log + breaker.* instants on the obs timeline).
    """

    def __init__(self, name: str, threshold: Optional[int] = None,
                 window_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None):
        self.name = name
        self.threshold = _DEFAULT_THRESHOLD if threshold is None else threshold
        self.window_s = _DEFAULT_WINDOW_S if window_s is None else window_s
        self.cooldown_s = (
            _DEFAULT_COOLDOWN_S if cooldown_s is None else cooldown_s
        )
        self._state = CLOSED
        self._failures: Deque[float] = collections.deque()
        self._opened_at = 0.0
        self._trips = 0
        self._last_error: Optional[str] = None
        self._lock = witness.named_lock(f"supervisor.breaker.{name}")

    # -- hot-path query ----------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def allow(self) -> bool:
        """May the healthy path run now? One attribute compare while CLOSED
        (the only state a healthy run ever sees); the OPEN->HALF_OPEN
        transition happens here, on the first call past the cooldown."""
        if self._state == CLOSED:
            return True
        with self._lock:
            if self._state == OPEN:
                if time.monotonic() - self._opened_at < self.cooldown_s:
                    return False
                self._state = HALF_OPEN
            # HALF_OPEN: let the probe(s) through; the first recorded
            # outcome decides (a multi-member bucket round is one probe)
        if self._state == HALF_OPEN:
            self._record("probe")
        return True

    # -- transitions -------------------------------------------------------

    def record_failure(self, error: Optional[BaseException] = None) -> bool:
        """One classified failure of the subsystem. Returns True when the
        breaker is OPEN afterwards (the call site should degrade)."""
        now = time.monotonic()
        with self._lock:
            if error is not None:
                self._last_error = f"{type(error).__name__}: {error}"
            if self._state == HALF_OPEN:
                # failed probe: straight back to OPEN, fresh cooldown
                self._state = OPEN
                self._opened_at = now
                self._trips += 1
                tripped = True
            else:
                self._failures.append(now)
                self._prune_locked(now)
                if self._state == CLOSED and len(self._failures) >= self.threshold:
                    self._state = OPEN
                    self._opened_at = now
                    self._trips += 1
                    tripped = True
                else:
                    tripped = False
            is_open = self._state == OPEN
        if tripped:
            self._record("trip")
        return is_open

    def record_success(self) -> None:
        """One healthy-path success. Meaningful in HALF_OPEN (closes the
        breaker); in CLOSED it is a no-op so call sites may report success
        unconditionally."""
        if self._state == CLOSED:
            return
        with self._lock:
            if self._state != HALF_OPEN:
                return  # OPEN: a stale success from before the trip
            self._state = CLOSED
            self._failures.clear()
        self._record("reset")

    def reset(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._failures.clear()
            self._opened_at = 0.0
            self._trips = 0
            self._last_error = None

    def _prune_locked(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._failures and self._failures[0] < cutoff:
            self._failures.popleft()

    def _record(self, event: str) -> None:
        # lazy: the breaker must stay importable from anywhere below stats
        from mlsl_tpu_torch.core import stats as stats_mod

        stats_mod.record_degrade(self.name, event, detail=self._last_error or "")
        if event == "trip":
            log_warning(
                "circuit breaker %r tripped OPEN (%d failures in %.0fs "
                "window; cooldown %.1fs; last: %s): subsystem degrades to "
                "its fallback path",
                self.name, len(self._failures) or self.threshold,
                self.window_s, self.cooldown_s, self._last_error,
            )

    def status(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "failures_in_window": len(self._failures),
                "threshold": self.threshold,
                "window_s": self.window_s,
                "cooldown_s": self.cooldown_s,
                "trips": self._trips,
                "last_error": self._last_error,
            }


# -- registry ----------------------------------------------------------------

_breakers: Dict[str, CircuitBreaker] = {}
_registry_lock = witness.named_lock("supervisor.registry")


def breaker(name: str) -> CircuitBreaker:
    """The process-wide breaker for ``name`` (created on first use with the
    configured defaults)."""
    br = _breakers.get(name)
    if br is None:
        with _registry_lock:
            br = _breakers.get(name)
            if br is None:
                br = CircuitBreaker(name)
                _breakers[name] = br
    return br


def degraded(name: str) -> bool:
    """Is ``name`` currently running its fallback path? (False for a breaker
    that was never created — no failure ever recorded.)"""
    br = _breakers.get(name)
    return br is not None and br.state != CLOSED


def configure(config=None, threshold: Optional[int] = None,
              window_s: Optional[float] = None,
              cooldown_s: Optional[float] = None) -> None:
    """(Re)apply breaker knobs — from a Config (Environment.init) or
    explicitly (tests). Existing breakers keep their STATE (health survives
    an Environment rebuild) but adopt the new thresholds."""
    global _DEFAULT_THRESHOLD, _DEFAULT_WINDOW_S, _DEFAULT_COOLDOWN_S
    if config is not None:
        threshold = getattr(config, "breaker_threshold", threshold)
        window_s = getattr(config, "breaker_window_s", window_s)
        cooldown_s = getattr(config, "breaker_cooldown_s", cooldown_s)
    if threshold is not None:
        _DEFAULT_THRESHOLD = int(threshold)
    if window_s is not None:
        _DEFAULT_WINDOW_S = float(window_s)
    if cooldown_s is not None:
        _DEFAULT_COOLDOWN_S = float(cooldown_s)
    with _registry_lock:
        for br in _breakers.values():
            if threshold is not None:
                br.threshold = int(threshold)
            if window_s is not None:
                br.window_s = float(window_s)
            if cooldown_s is not None:
                br.cooldown_s = float(cooldown_s)


def status() -> Dict[str, dict]:
    """Per-subsystem breaker status (subsystems never touched report a
    virgin closed breaker), plus every plane ``/healthz`` reports, under the
    JAX package's keys. JSON-serializable: this dict IS the /healthz body.

    - ``analysis``: the last verdict of each analysis pass;
    - ``straggler``, ``metrics``: the telemetry plane;
    - ``serve``: the live serving engine's SLA ladder ({"state": "off"} with
      none);
    - ``codecs``: the codec registry, its guardrail and demotions;
    - ``sentinel``: the integrity sentinel's counters and last audit
      (``sentinel.status()``);
    - ``elastic``: the active and full world, the capacity budget, the
      ELASTIC counters and the last reshard (``elastic.status()``);
    - ``control``: the pod control plane's membership view
      (``control.status()``, {"state": "off"} unarmed)."""
    out = {}
    for name in sorted(set(SUBSYSTEMS) | set(_breakers)):
        br = _breakers.get(name)
        out[name] = br.status() if br is not None else {
            "state": CLOSED, "failures_in_window": 0, "trips": 0,
        }
    from mlsl_tpu_torch.analysis import diagnostics as _analysis
    from mlsl_tpu_torch.obs import metrics as _metrics
    from mlsl_tpu_torch.obs import straggler as _straggler
    from mlsl_tpu_torch import codecs as _codecs
    from mlsl_tpu_torch import control as _control
    from mlsl_tpu_torch import elastic as _elastic
    from mlsl_tpu_torch import sentinel as _sentinel
    from mlsl_tpu_torch.serve import sla as _sla

    out["sentinel"] = _sentinel.status()
    out["analysis"] = _analysis.status()
    out["elastic"] = _elastic.status()
    out["straggler"] = _straggler.status()
    out["metrics"] = _metrics.status()
    out["control"] = _control.status()
    out["serve"] = _sla.status()
    out["codecs"] = _codecs.status()
    return out


def reset() -> None:
    """Close every breaker and clear its history (tests; a production run
    never resets -- health carries across recovery cycles by design)."""
    with _registry_lock:
        for br in _breakers.values():
            br.reset()


def configure_fault_plane(config=None) -> None:
    """Hand ``config`` to the modules that act on the fault plane's knobs
    (``Environment.init`` with its Config; ``finalize`` and
    :func:`reset_all` take it back with ``None``). They read its fields at
    each use, so a change to the live Config takes effect: ``chaos_spec`` is
    armed now (chaos.configure), ``trace`` / ``trace_capacity`` arm the
    tracer now and ``trace_dir`` is where it exports, ``lock_witness`` /
    ``lock_witness_budget_ms`` rule the witness, ``straggler_*`` are the
    straggler sentinel's defaults, ``profile_on_trip`` the watchdog's. With
    no Config handed over, each module reads its environment variables."""
    from mlsl_tpu_torch import chaos
    from mlsl_tpu_torch.analysis import witness as _witness
    from mlsl_tpu_torch.core import stats as stats_mod
    from mlsl_tpu_torch.obs import straggler as obs_straggler
    from mlsl_tpu_torch.obs import tracer as obs_tracer

    if config is not None:
        chaos.configure(config)
    obs_tracer.configure(config)
    _witness.configure(config)
    obs_straggler.configure(config)
    stats_mod.configure(config)


def reset_all() -> None:
    """Put the whole fault plane back as a fresh process has it: every chaos
    plan disarmed, the breakers closed and configured from ``Config()``'s
    defaults, the tracer and the metrics registry off, the scrape server
    stopped, the straggler sentinel, the lock witness and the analysis
    verdicts dropped, and the fault plane's counters at 0. The port's tests
    call it after every test (they share worker processes with the JAX
    package's tests) and ``chip_smoke.py`` between the parts of runs (z),
    (aa) and (ab). The integrity layer goes back too: the sentinel's counters
    and last audit, the checker's queued verdicts and counters; and the
    recovery layer: the elastic registry (the active world, the last
    reshard, the capacity budget) with the ELASTIC counters, and the control
    plane, stopped, with the CONTROL counters."""
    from mlsl_tpu_torch import chaos, checker, control, elastic, sentinel
    from mlsl_tpu_torch.analysis import diagnostics, witness as _witness
    from mlsl_tpu_torch.config import Config
    from mlsl_tpu_torch.core import stats as stats_mod
    from mlsl_tpu_torch.obs import metrics as obs_metrics
    from mlsl_tpu_torch.obs import serve as obs_serve
    from mlsl_tpu_torch.obs import straggler as obs_straggler
    from mlsl_tpu_torch.obs import tracer as obs_tracer

    chaos.reset()
    configure_fault_plane(None)
    reset()
    c = Config()
    configure(threshold=c.breaker_threshold, window_s=c.breaker_window_s,
              cooldown_s=c.breaker_cooldown_s)
    obs_serve.stop_server()
    obs_metrics.disable()
    obs_tracer.disable()
    obs_straggler.reset()
    _witness.reset()
    diagnostics.reset()
    stats_mod.reset_degrade_counters()
    stats_mod.reset_straggler_counters()
    stats_mod.reset_lock_witness_counters()
    stats_mod.reset_analysis_counters()
    stats_mod.reset_watchdog_events()
    sentinel.reset()
    checker.clear()
    stats_mod.reset_chkp_counters()
    elastic.reset()
    stats_mod.reset_elastic_counters()
    control.reset()
    stats_mod.reset_control_counters()
