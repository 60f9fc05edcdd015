"""Trace export: Chrome/Perfetto ``trace_event`` JSON and the flight recorder.

Counterpart of ``mlsl_tpu.obs.export``, by adapted copy.

Renders the tracer ring (obs/tracer.py) in the JSON Array-of-objects format
both chrome://tracing and ui.perfetto.dev load directly
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):
each event carries ``ph``/``ts``/``pid``/``tid`` (+ ``dur`` for complete
spans), with ``M``-phase metadata naming the tracks.

Track model: one track per OS thread that emitted events (the dispatcher
progress thread, trainer thread, checkpoint workers — thread-scoped spans like
step phases land there), PLUS one synthetic track per logical timeline — a
request or bucket (events recorded with ``track=``). A request's
submit→defer→dispatch→wait lifecycle then reads as one row regardless of
which thread touched it, which is the whole point: the dispatch may run on
``mlsl-dispatch`` while the wait blocks the trainer thread.

The flight recorder is the crash-path consumer: on an ``MLSLTimeoutError``
the watchdog (core/stats.record_watchdog_event) calls :func:`flight_record`,
which dumps the trailing window of the ring to ``trace-crash-<ts>.json`` in
``MLSL_TRACE_DIR`` — a wedged-wait report arrives with the timeline that led
to it, including the stuck request's own track.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from mlsl_tpu_torch.obs import tracer as tracer_mod
from mlsl_tpu_torch.obs.tracer import ARGS, CAT, DUR, NAME, PH, TID, TRACK

#: synthetic track tids start here; real thread tids are remapped to 0..N-1
TRACK_TID_BASE = 1000


def to_trace_events(events: List[tuple],
                    thread_names: Optional[Dict[int, str]] = None,
                    pid: Optional[int] = None) -> List[dict]:
    """Event tuples -> Chrome trace_event dicts (µs timestamps, one ``M``
    metadata row per named track/thread). Timestamps are rebased to the
    earliest event so the viewer opens at t=0."""
    if pid is None:
        pid = os.getpid()
    thread_names = thread_names or {}
    base_ns = min((ev[tracer_mod.TS] for ev in events), default=0)

    tid_of_thread: Dict[int, int] = {}
    tid_of_track: Dict[str, int] = {}
    out: List[dict] = []

    def thread_tid(ident: int) -> int:
        if ident not in tid_of_thread:
            tid = len(tid_of_thread)
            tid_of_thread[ident] = tid
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": thread_names.get(ident, f"thread-{ident}")},
            })
        return tid_of_thread[ident]

    def track_tid(track: str) -> int:
        if track not in tid_of_track:
            tid = TRACK_TID_BASE + len(tid_of_track)
            tid_of_track[track] = tid
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": track},
            })
        return tid_of_track[track]

    out.append({
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": "mlsl_tpu_torch"},
    })
    for ev in events:
        tid = (track_tid(ev[TRACK]) if ev[TRACK] is not None
               else thread_tid(ev[TID]))
        rec = {
            "ph": ev[PH],
            "name": ev[NAME],
            "cat": ev[CAT],
            "ts": (ev[tracer_mod.TS] - base_ns) / 1e3,
            "pid": pid,
            "tid": tid,
        }
        if ev[PH] == "X":
            rec["dur"] = ev[DUR] / 1e3
        elif ev[PH] == "i":
            rec["s"] = "t"  # instant scope: thread
        if ev[ARGS]:
            rec["args"] = dict(ev[ARGS])
        out.append(rec)
    return out


def render(events: List[tuple],
           thread_names: Optional[Dict[int, str]] = None,
           meta: Optional[dict] = None) -> dict:
    """The full JSON-object trace document."""
    doc = {
        "traceEvents": to_trace_events(events, thread_names),
        "displayTimeUnit": "ms",
    }
    if meta:
        doc["otherData"] = meta
    return doc


def _write(doc: dict, path: str) -> Optional[str]:
    """Atomic JSON write, gated by the tracer circuit breaker
    (supervisor.py): repeated IO failures (full disk, revoked
    credentials on a network mount) trip it and exports become no-ops —
    observability degrades instead of taking the training loop down with it
    — until the half-open probe write succeeds again. Returns None when the
    breaker is open; IO errors below the trip threshold propagate (callers
    on error paths already swallow them — flight_record — and interactive
    callers should see the real failure)."""
    from mlsl_tpu_torch import supervisor

    br = supervisor.breaker("tracer")
    if not br.allow():
        from mlsl_tpu_torch.core import stats as stats_mod

        stats_mod.record_degrade("tracer", "fallback", detail=path)
        return None
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except OSError as e:
        if br.record_failure(e):
            # tripping (or probe-failing) write: served by the fallback —
            # a no-op export — per the rung-3 contract, not raised
            from mlsl_tpu_torch.core import stats as stats_mod

            stats_mod.record_degrade("tracer", "fallback", detail=path)
            return None
        raise
    br.record_success()  # no-op unless HALF_OPEN (the probe write)
    return path


def write_trace(path: Optional[str] = None,
                tracer: Optional[tracer_mod.Tracer] = None) -> Optional[str]:
    """Dump the whole ring to ``path`` (default:
    ``MLSL_TRACE_DIR/trace-<unix_ts>.json``). Returns the written path, or
    None when tracing is disabled."""
    tr = tracer if tracer is not None else tracer_mod._tracer
    if tr is None:
        return None
    if path is None:
        path = os.path.join(tracer_mod.trace_dir(), f"trace-{int(time.time())}.json")
    return _write(
        render(tr.snapshot(), tr.thread_names,
               meta={"kind": "full", "written_at": time.time()}),
        path,
    )


def flight_record(window_s: float, reason: str = "",
                  path: Optional[str] = None) -> Optional[str]:
    """Dump the trailing ``window_s`` seconds of spans to
    ``trace-crash-<unix_ts>.json`` — the watchdog's post-mortem timeline.
    Falls back to the full ring if the window turns out empty (a stall longer
    than the window must still produce evidence). Returns the path, or None
    when tracing is disabled. Never raises: the caller is already on an error
    path and the trip itself must not be masked by a recorder failure."""
    tr = tracer_mod._tracer
    if tr is None:
        return None
    try:
        events = tr.window(window_s)
        if not events:
            events = tr.snapshot()
        if path is None:
            path = os.path.join(
                tracer_mod.trace_dir(), f"trace-crash-{int(time.time())}.json"
            )
        return _write(
            render(events, tr.thread_names,
                   meta={"kind": "flight_record", "reason": reason,
                         "window_s": window_s, "written_at": time.time()}),
            path,
        )
    except Exception:  # pragma: no cover - defensive (error path)
        return None


def summarize(doc: dict, top: int = 10) -> str:
    """Terminal-friendly text summary of a trace document : per-(cat, name) span statistics, the busiest
    tracks, and the slowest individual spans."""
    events = doc.get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"]
    instants = [e for e in events if e.get("ph") == "i"]
    names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names[e["tid"]] = e.get("args", {}).get("name", str(e["tid"]))

    lines = [
        f"{len(spans)} spans, {len(instants)} instants, "
        f"{len(names)} tracks"
    ]
    groups: Dict[tuple, List[float]] = {}
    for e in spans:
        groups.setdefault((e.get("cat", "?"), e["name"]), []).append(
            e.get("dur", 0.0) / 1e3  # µs -> ms
        )
    if groups:
        lines.append("")
        lines.append(f"{'cat':<12} {'name':<24} {'n':>6} {'total ms':>10} "
                     f"{'p50 ms':>9} {'p95 ms':>9} {'max ms':>9}")
        for (cat, name), durs in sorted(
            groups.items(), key=lambda kv: -sum(kv[1])
        ):
            durs.sort()
            lines.append(
                f"{cat:<12} {name:<24} {len(durs):>6} {sum(durs):>10.2f} "
                f"{tracer_mod._percentile(durs, 50):>9.3f} "
                f"{tracer_mod._percentile(durs, 95):>9.3f} "
                f"{durs[-1]:>9.3f}"
            )
    # per-algorithm attribution: dispatch/wait spans carry the selected
    # collective algorithm (comm/algos) in their args, so a tuned profile's
    # program switch is visible directly in the trace summary
    by_algo: Dict[str, List[float]] = {}
    for e in spans:
        algo = (e.get("args") or {}).get("algo")
        if algo:
            by_algo.setdefault(str(algo), []).append(e.get("dur", 0.0) / 1e3)
    if by_algo:
        lines.append("")
        lines.append(f"{'algorithm':<14} {'spans':>6} {'total ms':>10} "
                     f"{'p95 ms':>9}")
        for algo, durs in sorted(by_algo.items(), key=lambda kv: -sum(kv[1])):
            durs.sort()
            lines.append(
                f"{algo:<14} {len(durs):>6} {sum(durs):>10.2f} "
                f"{tracer_mod._percentile(durs, 95):>9.3f}"
            )
    busiest: Dict[int, float] = {}
    for e in spans:
        busiest[e["tid"]] = busiest.get(e["tid"], 0.0) + e.get("dur", 0.0)
    if busiest:
        lines.append("")
        lines.append("busiest tracks:")
        for tid, total in sorted(busiest.items(), key=lambda kv: -kv[1])[:top]:
            lines.append(f"  {names.get(tid, tid)}: {total / 1e3:.2f} ms")
    slowest = sorted(spans, key=lambda e: -e.get("dur", 0.0))[:top]
    if slowest:
        lines.append("")
        lines.append("slowest spans:")
        for e in slowest:
            args = e.get("args")
            lines.append(
                f"  {e.get('dur', 0.0) / 1e3:9.3f} ms  {e.get('cat', '?')}:"
                f"{e['name']} @ {names.get(e['tid'], e['tid'])}"
                + (f"  {args}" if args else "")
            )
    if instants:
        lines.append("")
        lines.append("instants:")
        counts: Dict[tuple, int] = {}
        for e in instants:
            key = (e.get("cat", "?"), e["name"])
            counts[key] = counts.get(key, 0) + 1
        for (cat, name), n in sorted(counts.items()):
            lines.append(f"  {cat}:{name} x{n}")
    # static-analysis findings ride the trace as instants (analysis/
    # record()); the aggregated count above hides WHICH invariant fired, so
    # list them individually — a rejected plan's codes belong in the same
    # summary an operator reads for the stall it would have caused
    findings = [e for e in instants if e["name"] == "analysis.finding"]
    if findings:
        lines.append("")
        lines.append("analysis findings:")
        for e in findings[:top]:
            a = e.get("args") or {}
            lines.append(
                f"  {a.get('severity', '?'):<5} {a.get('code', '?')} "
                f"@ {a.get('anchor', '?')}"
            )
        if len(findings) > top:
            lines.append(f"  ... {len(findings) - top} more")
    return "\n".join(lines)
