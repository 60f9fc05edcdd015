"""Process-wide low-overhead span tracer: the comm timeline's event source.

Counterpart of ``mlsl_tpu.obs.tracer``, by adapted copy. Spans are host
time: nothing here synchronizes the card.

The aggregate counters in ``core/stats.py`` answer *how much* time went to
communication; this module answers *which request stalled, when a bucket
deferred, and why a watchdog tripped*. Every instrumented layer — request
Start/dispatch/wait (comm/request.py), bucket rounds (core/bucketing.py),
quant ring round-trips (comm/quant_ring.py), the compiled overlap step
(comm/overlap.py), the serving engine (serve/), the device feed pipeline (data/: ``h2d.transfer`` +
``feed.decode`` spans, ``feed.cache_hit`` instants), chaos injections
(chaos.py) — appends typed events to one
bounded ring buffer, which ``obs.export`` renders as Chrome/Perfetto
``trace_event`` JSON and the watchdog dumps as a flight record on a trip.

Hot-path contract (mirrors the chaos-site ``if chaos._plans:`` pattern):
instrumented code reads the module global once per operation and guards with
``tr = tracer._tracer`` / ``if tr is not None:`` — when tracing is off that is
ONE attribute load and a None test, with zero allocations (asserted by
tests/test_torch_trace.py). Nothing else in this module runs until tracing is armed
via ``MLSL_TRACE=1`` or :func:`enable`.

Event record (a plain tuple, one allocation per event when enabled)::

    (ph, name, cat, ts_ns, dur_ns, thread_ident, track, args)

``ph`` is the Chrome trace phase ('X' complete span, 'i' instant); ``ts_ns``
is ``time.perf_counter_ns()`` (monotonic — the flight recorder windows on it);
``track`` optionally names a logical timeline (one per request / bucket) that
the exporter renders as its own row, separate from the emitting thread's.

Ring buffer: ``collections.deque(maxlen=capacity)`` — append is GIL-atomic
(no lock on the record path) and wraparound drops the oldest event, so a
long-running trainer keeps the most recent window rather than growing without
bound. Capacity comes from ``MLSL_TRACE_CAPACITY`` (default 65536 events).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

ENV_TRACE = "MLSL_TRACE"
ENV_DIR = "MLSL_TRACE_DIR"
ENV_CAPACITY = "MLSL_TRACE_CAPACITY"
DEFAULT_CAPACITY = 65536

# tuple indices of one event record (kept flat: field access in the exporter
# and the percentile scans without per-event object overhead)
PH, NAME, CAT, TS, DUR, TID, TRACK, ARGS = range(8)


class Tracer:
    """The ring buffer and its append paths. One instance per process
    (module global ``_tracer``); instrumented code never constructs one."""

    __slots__ = ("capacity", "events", "t0_ns", "thread_names")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(int(capacity), 16)
        self.events: collections.deque = collections.deque(maxlen=self.capacity)
        self.t0_ns = time.perf_counter_ns()
        # ident -> name, for the exporter's thread_name metadata; written
        # lazily on first event from each thread (dict set is GIL-atomic)
        self.thread_names: Dict[int, str] = {}

    # -- record paths (the only methods on the enabled hot path) -----------

    @staticmethod
    def now() -> int:
        return time.perf_counter_ns()

    def _tid(self) -> int:
        t = threading.current_thread()
        ident = t.ident or 0
        if ident not in self.thread_names:
            self.thread_names[ident] = t.name
        return ident

    def complete(self, name: str, cat: str, t0_ns: int,
                 track: Optional[str] = None, **args) -> None:
        """Record a complete span that began at ``t0_ns`` and ends now."""
        end = time.perf_counter_ns()
        self.events.append(
            ("X", name, cat, t0_ns, end - t0_ns, self._tid(), track,
             args or None)
        )

    def instant(self, name: str, cat: str, track: Optional[str] = None,
                **args) -> None:
        self.events.append(
            ("i", name, cat, time.perf_counter_ns(), 0, self._tid(), track,
             args or None)
        )

    # -- queries ------------------------------------------------------------

    def snapshot(self) -> List[tuple]:
        """Consistent copy of the ring (deque iteration under the GIL)."""
        return list(self.events)

    def clear(self) -> None:
        self.events.clear()

    def window(self, seconds: float) -> List[tuple]:
        """Events whose END falls within the trailing ``seconds`` window —
        the flight recorder's view of 'what just happened'."""
        cutoff = time.perf_counter_ns() - int(seconds * 1e9)
        return [ev for ev in self.snapshot() if ev[TS] + ev[DUR] >= cutoff]

    def wait_stall_durations(self) -> Dict[str, List[int]]:
        """Raw 'wait' span durations (ns) grouped by request name — the
        per-request wait-stall distributions. Statistics.overlap_report
        re-groups these by op ('<op>/' name prefix) for its span-derived
        p50/p95 fields."""
        groups: Dict[str, List[int]] = {}
        for ev in self.snapshot():
            if ev[PH] == "X" and ev[NAME] == "wait" and ev[CAT] == "req":
                key = str((ev[ARGS] or {}).get("req") or ev[TRACK] or "?")
                groups.setdefault(key, []).append(ev[DUR])
        return groups

    def span_durations(self, name: str, cat: Optional[str] = None
                       ) -> List[int]:
        """Raw durations (ns) of every complete span named ``name``
        (optionally filtered by category) still in the ring — e.g.
        ``span_durations("h2d.transfer", "feed")`` for the staging-time
        distribution the input-pipeline bench reports."""
        return [
            ev[DUR]
            for ev in self.snapshot()
            if ev[PH] == "X" and ev[NAME] == name
            and (cat is None or ev[CAT] == cat)
        ]

    def wait_stall_stats(self) -> Dict[str, dict]:
        """Per-request wait-stall summary:
        ``{request_name: {n, p50_ms, p95_ms, max_ms}}``."""
        out = {}
        for key, durs in self.wait_stall_durations().items():
            durs.sort()
            out[key] = {
                "n": len(durs),
                "p50_ms": _percentile(durs, 50) / 1e6,
                "p95_ms": _percentile(durs, 95) / 1e6,
                "max_ms": durs[-1] / 1e6,
            }
        return out


def _percentile(sorted_vals: List[int], pct: float) -> float:
    """Nearest-rank percentile of an already-sorted list (stdlib-only; the
    tracer must not import numpy on the record path)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(pct / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[k])


#: THE hot-path guard: None = disabled. Instrumented code reads this once per
#: operation (``tr = tracer._tracer``) and does nothing when it is None.
_tracer: Optional[Tracer] = None


def enabled() -> bool:
    return _tracer is not None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def enable(capacity: Optional[int] = None) -> Tracer:
    """Arm tracing (idempotent). Capacity defaults to MLSL_TRACE_CAPACITY."""
    global _tracer
    if _tracer is None:
        if capacity is None:
            capacity = int(os.environ.get(ENV_CAPACITY) or DEFAULT_CAPACITY)
        _tracer = Tracer(capacity)
    return _tracer


def disable() -> None:
    """Disarm tracing; the buffer is dropped (export first if needed)."""
    global _tracer
    _tracer = None


#: the live Environment's Config (:func:`configure`)
_config = None


def configure(config=None) -> None:
    """Take the tracer's knobs from ``config`` (``Environment.init`` hands
    over its own, ``finalize`` takes it back with ``None``): ``trace`` arms
    the tracer with ``trace_capacity`` slots (one already armed keeps its
    ring); ``trace_dir`` is read at each export."""
    global _config
    _config = config
    if config is not None and config.trace:
        enable(config.trace_capacity)


def trace_dir() -> str:
    """Where trace-*.json files land: the live Config's ``trace_dir``, else
    MLSL_TRACE_DIR, default CWD."""
    configured = _config.trace_dir if _config is not None else ""
    return configured or os.environ.get(ENV_DIR) or "."


class span:
    """Context-manager convenience for user code and cold paths::

        with obs.span("load", "data", shard=3):
            ...

    Captures the tracer ONCE at __enter__ (a disable mid-block records
    nothing; an enable mid-block records nothing — consistent either way).
    Instrumented framework hot paths use the explicit ``_tracer`` guard
    instead: this object allocates even when tracing is off.
    """

    __slots__ = ("name", "cat", "track", "args", "_t0", "_tr")

    def __init__(self, name: str, cat: str = "user",
                 track: Optional[str] = None, **args):
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args

    def __enter__(self) -> "span":
        self._tr = _tracer
        self._t0 = self._tr.now() if self._tr is not None else 0
        return self

    def __exit__(self, *exc) -> None:
        if self._tr is not None:
            self._tr.complete(self.name, self.cat, self._t0,
                              track=self.track, **self.args)


def _env_truthy(v: Optional[str]) -> bool:
    return (v or "").strip().lower() not in ("", "0", "false", "no", "off")


# Arm from the environment at import: instrumented modules import this module,
# so MLSL_TRACE=1 on the launch command works with no code changes (the same
# contract as MLSL_CHAOS in chaos.py).
if _env_truthy(os.environ.get(ENV_TRACE)):
    enable()
