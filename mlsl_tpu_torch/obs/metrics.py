"""Process-wide typed time-series metrics: the telemetry plane's data model.

Counterpart of ``mlsl_tpu.obs.metrics``, by adapted copy. The sampler reads
the counter families the port keeps (BUCKET, FEED, SENTINEL, DEGRADE,
OVERLAP, ANALYSIS, CHKP, STRAGGLER, SERVE, CODEC, LOCKWITNESS); the ELASTIC
family waits for its subsystem (ROADMAP A.7c).

The span tracer (``obs/tracer.py``) answers *which request stalled and when*;
the ``core/stats.py`` counter families answer *how much, in total, since
start*. Neither gives a scrape surface or a trend: there is no way to ask a
running trainer "what is step p99 right now" without stopping it and reading
a log. This module closes that gap with a typed registry —

- :class:`Counter` — monotone total (dispatches, bytes, events);
- :class:`Gauge`   — last-written scalar (loss, budget remaining);
- :class:`Histogram` — fixed-bucket latency/size distribution with
  bucket-interpolated p50/p95/p99 (step_ms, dispatch→wait latency, achieved
  algbw);

each retaining a bounded ring of timestamped samples (``MLSL_METRICS_RETENTION``
samples per series, the tracer's deque(maxlen) discipline: a week-long run
keeps the trailing window, not an unbounded log). The sampler
(:func:`sample_families`) snapshots every existing ``core/stats`` counter
family (BUCKET/ALGO/FEED/SENTINEL/DEGRADE/OVERLAP/ELASTIC/ANALYSIS/CHKP/
STRAGGLER/CODEC) into gauges, so one registry covers the whole stack; the trainer
feeds per-step scalars on the ``MLSL_METRICS_EVERY`` cadence
(models/train.py) and the request layer feeds per-request latency on every
completed wait (comm/request.py).

Exports: :meth:`MetricsRegistry.to_prometheus` (text exposition format —
``obs/serve.py`` serves it on ``/metrics``) and
:meth:`MetricsRegistry.jsonl_snapshot` (JSON-lines, one line per live
series, appended to ``mlsl_metrics.jsonl`` under ``MLSL_STATS_DIR`` on each
sampler tick; ``scripts/trace_view.py --metrics`` summarizes the file).

Hot-path contract (the tracer/chaos precedent, pinned by tracemalloc in
tests/test_metrics.py and benchmarks/metrics_overhead_bench.py):
instrumented code reads the module global once per operation —
``m = metrics._registry`` / ``if m is not None:`` — so the disabled path is
ONE attribute load and a None test with zero allocations. Series internals
deliberately carry distinctive ``_m*`` names (``_mval``/``_mcounts``/
``_msum``/``_mn``/``_msamples``/``_mseries``): lint rule A207
(analysis/lint.py) rejects any mutation of them outside this module's
record/observe/sample paths — the A203 single-mutation-discipline contract,
extended to the registry.

Thread-safety: series creation takes the registry lock; the record paths are
lock-free (int/float upserts and deque appends under the GIL — a racing
increment can lose a count, never corrupt a structure; the same trade the
tracer and ALGO_COUNTERS already make).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

ENV_METRICS = "MLSL_METRICS"
ENV_EVERY = "MLSL_METRICS_EVERY"
ENV_RETENTION = "MLSL_METRICS_RETENTION"

DEFAULT_EVERY = 20
DEFAULT_RETENTION = 512

#: default histogram bucket upper bounds, ms-scale (latency series); an
#: explicit ``buckets=`` at first creation wins (algbw series pass GB/s-scale
#: bounds). Fixed buckets keep ``observe`` O(log B) with zero allocations
#: beyond the deque sample ring.
DEFAULT_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

#: GB/s-scale bounds for the achieved-algbw series (ICI sits at tens-of-GB/s,
#: DCN and the CPU proof mesh orders below)
ALGBW_BUCKETS_GBPS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 25.0,
    50.0, 100.0, 200.0, 400.0,
)

COUNTER, GAUGE, HISTOGRAM = "counter", "gauge", "histogram"

LabelsT = Tuple[Tuple[str, str], ...]


def _labels_key(labels: dict) -> LabelsT:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone total. ``inc`` is the only mutation path (A207)."""

    __slots__ = ("name", "labels", "_mval", "_msamples")
    kind = COUNTER

    def __init__(self, name: str, labels: LabelsT, retention: int):
        self.name = name
        self.labels = labels
        self._mval = 0.0
        self._msamples = collections.deque(maxlen=retention)

    def inc(self, v: float = 1.0) -> None:
        self._mval += v

    @property
    def value(self) -> float:
        return self._mval

    def record_sample(self, ts: float) -> dict:
        snap = {"t": ts, "value": self._mval}
        self._msamples.append(snap)
        return snap

    def snapshot(self) -> dict:
        return {"value": self._mval}


class Gauge:
    """Last-written scalar. ``set`` is the only mutation path (A207)."""

    __slots__ = ("name", "labels", "_mval", "_msamples")
    kind = GAUGE

    def __init__(self, name: str, labels: LabelsT, retention: int):
        self.name = name
        self.labels = labels
        self._mval = 0.0
        self._msamples = collections.deque(maxlen=retention)

    def set(self, v: float) -> None:
        self._mval = float(v)

    @property
    def value(self) -> float:
        return self._mval

    def record_sample(self, ts: float) -> dict:
        snap = {"t": ts, "value": self._mval}
        self._msamples.append(snap)
        return snap

    def snapshot(self) -> dict:
        return {"value": self._mval}


class Histogram:
    """Fixed-bucket distribution; ``observe`` is the only mutation path
    (A207). ``buckets`` are upper bounds; one overflow bucket (+Inf) rides at
    the end. Percentiles interpolate linearly inside the winning bucket —
    exact enough for p50/p95/p99 dashboards at ~16 buckets, allocation-free
    on the observe path."""

    __slots__ = ("name", "labels", "buckets", "_mcounts", "_msum", "_mn",
                 "_msamples")
    kind = HISTOGRAM

    def __init__(self, name: str, labels: LabelsT, retention: int,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.labels = labels
        self.buckets = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS_MS))
        self._mcounts = [0] * (len(self.buckets) + 1)
        self._msum = 0.0
        self._mn = 0
        self._msamples = collections.deque(maxlen=retention)

    def observe(self, v: float) -> None:
        self._mcounts[bisect.bisect_left(self.buckets, v)] += 1
        self._msum += v
        self._mn += 1

    @property
    def count(self) -> int:
        return self._mn

    @property
    def sum(self) -> float:
        return self._msum

    def percentile(self, pct: float) -> float:
        """Bucket-interpolated percentile over everything observed so far.
        0.0 with no observations; the overflow bucket reports its lower
        bound (the largest finite boundary)."""
        n = self._mn
        if n <= 0:
            return 0.0
        rank = pct / 100.0 * n
        acc = 0
        for i, c in enumerate(self._mcounts):
            if c == 0:
                continue
            if acc + c >= rank:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (rank - acc) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            acc += c
        return self.buckets[-1]

    def record_sample(self, ts: float) -> dict:
        snap = {
            "t": ts, "n": self._mn, "sum": round(self._msum, 6),
            "p50": round(self.percentile(50), 6),
            "p95": round(self.percentile(95), 6),
            "p99": round(self.percentile(99), 6),
        }
        self._msamples.append(snap)
        return snap

    def snapshot(self) -> dict:
        return {
            "n": self._mn, "sum": self._msum,
            "p50": self.percentile(50), "p95": self.percentile(95),
            "p99": self.percentile(99),
            "buckets": list(zip(self.buckets, self._mcounts)),
            "overflow": self._mcounts[-1],
        }


class MetricsRegistry:
    """The process-wide series table. One instance per process (module
    global ``_registry``); instrumented code never constructs one."""

    def __init__(self, every: int = DEFAULT_EVERY,
                 retention: int = DEFAULT_RETENTION):
        self.every = max(int(every), 1)
        self.retention = max(int(retention), 2)
        self.created_at = time.time()
        self.samples_taken = 0
        self.last_sample_at: Optional[float] = None
        self._mseries: Dict[Tuple[str, LabelsT], object] = {}
        self._lock = threading.Lock()

    # -- series access (get-or-create; creation under the lock) -----------

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, _labels_key(labels))
        s = self._mseries.get(key)
        if s is None:
            with self._lock:
                s = self._mseries.get(key)
                if s is None:
                    s = cls(name, key[1], self.retention, **kw)
                    self._mseries[key] = s
        return s

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    # -- hot-path shorthands ----------------------------------------------

    def inc(self, name: str, v: float = 1.0, **labels) -> None:
        self.counter(name, **labels).inc(v)

    def set(self, name: str, v: float, **labels) -> None:
        self.gauge(name, **labels).set(v)

    def observe(self, name: str, v: float,
                buckets: Optional[Tuple[float, ...]] = None,
                **labels) -> None:
        self.histogram(name, buckets=buckets, **labels).observe(v)

    # -- queries ------------------------------------------------------------

    def series(self) -> List[object]:
        return list(self._mseries.values())

    def find(self, name: str, **labels):
        return self._mseries.get((name, _labels_key(labels)))

    def status(self) -> dict:
        """Registry summary for supervisor.status()['metrics'] — deliberately
        NOT breaker-shaped (no 'state' key: the DEGRADE-line and abort-log
        consumers iterate breaker entries by that key)."""
        return {
            "armed": True,
            "series": len(self._mseries),
            "every": self.every,
            "retention": self.retention,
            "samples_taken": self.samples_taken,
            "last_sample_at": self.last_sample_at,
        }

    # -- sampling ------------------------------------------------------------

    def sample_families(self) -> None:
        """Snapshot every core/stats counter family into gauges: one
        registry covers the whole stack's totals, time-stamped on the
        sampler cadence so trends (and the straggler/SLA dashboards) see
        rates, not just lifetime sums. Lazy import: core.stats imports
        obs.tracer through the obs package, so a module-level import here
        would cycle."""
        from mlsl_tpu_torch.core import stats as st

        for fam, d in (
            ("bucket", st.BUCKET_COUNTERS),
            ("feed", st.FEED_COUNTERS),
            ("sentinel", st.SENTINEL_COUNTERS),
            ("degrade", st.DEGRADE_COUNTERS),
            ("overlap", st.OVERLAP_COUNTERS),
            ("analysis", st.ANALYSIS_COUNTERS),
            ("chkp", st.CHKP_COUNTERS),
            ("straggler", st.STRAGGLER_COUNTERS),
            ("serve", st.SERVE_COUNTERS),
            ("codec", st.CODEC_COUNTERS),
            ("lockwitness", st.LOCKWITNESS_COUNTERS),
        ):
            for k, v in d.items():
                self.set(f"mlsl_{fam}_{k}", float(v))
        for (kind, algo), n in list(st.ALGO_COUNTERS.items()):
            self.set("mlsl_algo_dispatches", float(n), kind=kind, algo=algo)
        for subsystem, n in list(st.DEGRADE_FALLBACKS.items()):
            self.set("mlsl_degrade_fallback", float(n), subsystem=subsystem)
        for codec, n in list(st.CODEC_WIRE_BYTES.items()):
            self.set("mlsl_codec_wire_bytes", float(n), codec=codec)

    def sample(self, ts: Optional[float] = None) -> List[dict]:
        """One sampler tick: append a timestamped sample to every live
        series' ring and return the JSONL-shaped records."""
        ts = time.time() if ts is None else ts
        out = []
        for (name, labels), s in list(self._mseries.items()):
            rec = {"series": name, "kind": s.kind}
            if labels:
                rec["labels"] = dict(labels)
            rec.update(s.record_sample(round(ts, 3)))
            out.append(rec)
        self.samples_taken += 1
        self.last_sample_at = ts
        return out

    # -- exports -------------------------------------------------------------

    def jsonl_snapshot(self) -> str:
        """Current value of every series, one JSON object per line (the
        ``mlsl_metrics.jsonl`` record shape; does not advance the rings)."""
        ts = round(time.time(), 3)
        lines = []
        for (name, labels), s in sorted(self._mseries.items()):
            rec = {"t": ts, "series": name, "kind": s.kind}
            if labels:
                rec["labels"] = dict(labels)
            for k, v in s.snapshot().items():
                if k != "buckets":  # bucket arrays stay scrape-only
                    rec[k] = round(v, 6) if isinstance(v, float) else v
            lines.append(json.dumps(rec))
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path: Optional[str] = None,
                    records: Optional[List[dict]] = None) -> Optional[str]:
        """Append a snapshot (or the given sampler records) to the metrics
        JSONL file (``MLSL_STATS_DIR``-routed like mlsl_stats.log). Returns
        the path, or None when the write failed (IO must never take the
        training loop down — the tracer-exporter contract)."""
        if path is None:
            path = jsonl_path()
        try:
            with open(path, "a") as f:
                if records is None:
                    f.write(self.jsonl_snapshot())
                else:
                    for rec in records:
                        f.write(json.dumps(rec) + "\n")
            return path
        except OSError:
            return None

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (served on ``/metrics``).
        Series names are sanitized to the metric-name grammar; histogram
        series render the standard ``_bucket``/``_sum``/``_count`` triple
        with cumulative ``le`` bounds."""
        by_name: Dict[str, List[Tuple[LabelsT, object]]] = {}
        for (name, labels), s in sorted(self._mseries.items()):
            by_name.setdefault(name, []).append((labels, s))
        lines: List[str] = []
        for name, entries in by_name.items():
            pname = _prom_name(name)
            kind = entries[0][1].kind
            lines.append(f"# TYPE {pname} {kind}")
            for labels, s in entries:
                lab = _prom_labels(labels)
                if kind == HISTOGRAM:
                    acc = 0
                    for bound, c in zip(s.buckets, s._mcounts):
                        acc += c
                        lines.append(
                            f"{pname}_bucket"
                            f"{_prom_labels(labels, ('le', _fmt(bound)))}"
                            f" {acc}"
                        )
                    lines.append(
                        f"{pname}_bucket"
                        f"{_prom_labels(labels, ('le', '+Inf'))} {s._mn}"
                    )
                    lines.append(f"{pname}_sum{lab} {_fmt(s._msum)}")
                    lines.append(f"{pname}_count{lab} {s._mn}")
                else:
                    lines.append(f"{pname}{lab} {_fmt(s._mval)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        ok = ch.isalnum() or ch in ("_", ":")
        if i == 0 and ch.isdigit():
            ok = False
        out.append(ch if ok else "_")
    return "".join(out)


def _prom_labels(labels: LabelsT, extra: Optional[Tuple[str, str]] = None
                 ) -> str:
    items = list(labels)
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (
            _prom_name(k),
            str(v).replace("\\", "\\\\").replace('"', '\\"'),
        )
        for k, v in items
    )
    return "{" + body + "}"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def jsonl_path() -> str:
    """Where the sampler's JSON-lines snapshots land: MLSL_STATS_DIR
    (default CWD), the mlsl_stats.log routing contract."""
    d = os.environ.get("MLSL_STATS_DIR")
    name = "mlsl_metrics.jsonl"
    return os.path.join(d, name) if d else name


#: THE hot-path guard: None = disabled. Instrumented code reads this once
#: per operation (``m = metrics._registry``) and does nothing when None.
_registry: Optional[MetricsRegistry] = None


def enabled() -> bool:
    return _registry is not None


def get_registry() -> Optional[MetricsRegistry]:
    return _registry


def enable(every: Optional[int] = None,
           retention: Optional[int] = None) -> MetricsRegistry:
    """Arm the registry (idempotent). Knobs default to MLSL_METRICS_EVERY /
    MLSL_METRICS_RETENTION. An EXPLICIT knob always binds, even when the
    registry is already armed — MLSL_METRICS=1 arms at import with the env
    defaults, and Environment.init re-enables with the validated (possibly
    tuner-profiled) Config values, which must not be silently dropped.
    ``retention`` applies to series created afterwards (existing rings keep
    their maxlen — a ring cannot be resized in place)."""
    global _registry
    if _registry is None:
        if every is None:
            every = int(os.environ.get(ENV_EVERY) or DEFAULT_EVERY)
        if retention is None:
            retention = int(os.environ.get(ENV_RETENTION)
                            or DEFAULT_RETENTION)
        _registry = MetricsRegistry(every=every, retention=retention)
    else:
        if every is not None:
            _registry.every = max(int(every), 1)
        if retention is not None:
            _registry.retention = max(int(retention), 2)
    return _registry


def disable() -> None:
    """Disarm; the series table is dropped (export first if needed)."""
    global _registry
    _registry = None


def status() -> dict:
    """Module-level summary for supervisor.status()['metrics']."""
    if _registry is None:
        return {"armed": False}
    return _registry.status()


# -- JSONL summarization (trace_view --metrics / the statusz text) -----------


def summarize_jsonl(lines) -> Dict[Tuple[str, str], dict]:
    """Aggregate a metrics JSONL stream into per-series summaries:
    ``{(series, labels_repr): {kind, n_samples, last, p50, p95, p99, max}}``.
    Gauge/counter percentiles are over the sampled VALUES (the time series);
    histogram lines carry their own percentiles — the summary reports the
    latest plus the max-seen p99."""
    acc: Dict[Tuple[str, str], dict] = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        name = rec.get("series")
        if not name:
            continue
        lkey = ",".join(
            f"{k}={v}" for k, v in sorted((rec.get("labels") or {}).items())
        )
        ent = acc.setdefault((name, lkey), {
            "kind": rec.get("kind", "?"), "n_samples": 0, "values": [],
            "last": None, "p99_max": 0.0,
        })
        ent["n_samples"] += 1
        if rec.get("kind") == HISTOGRAM:
            ent["last"] = {k: rec.get(k) for k in
                           ("n", "sum", "p50", "p95", "p99")}
            ent["p99_max"] = max(ent["p99_max"], float(rec.get("p99") or 0.0))
        else:
            v = rec.get("value")
            if v is not None:
                ent["values"].append(float(v))
                ent["last"] = float(v)
    for ent in acc.values():
        vals = sorted(ent.pop("values"))
        if vals:
            ent["min"] = vals[0]
            ent["max"] = vals[-1]
            for pct, key in ((50, "p50"), (95, "p95"), (99, "p99")):
                k = max(0, min(len(vals) - 1,
                               int(round(pct / 100.0 * (len(vals) - 1)))))
                ent[key] = vals[k]
    return acc


def render_summary(acc: Dict[Tuple[str, str], dict], top: int = 0) -> str:
    """Terminal table for :func:`summarize_jsonl` output (shared by
    trace_view --metrics and the statusz renderer)."""
    rows = []
    for (name, lkey), ent in sorted(acc.items()):
        label = f"{name}{{{lkey}}}" if lkey else name
        if ent["kind"] == HISTOGRAM and isinstance(ent.get("last"), dict):
            last = ent["last"]
            rows.append(
                f"  {label:<44} hist  n={last.get('n', 0):>8} "
                f"p50={last.get('p50', 0):>10.3f} "
                f"p95={last.get('p95', 0):>10.3f} "
                f"p99={last.get('p99', 0):>10.3f} "
                f"p99_max={ent.get('p99_max', 0):>10.3f}"
            )
        else:
            p50 = ent.get("p50", ent.get("last") or 0.0)
            p99 = ent.get("p99", ent.get("last") or 0.0)
            rows.append(
                f"  {label:<44} {ent['kind']:<5} "
                f"last={ent.get('last') if ent.get('last') is not None else 0:>10.3f} "
                f"p50={p50:>10.3f} p99={p99:>10.3f} "
                f"({ent['n_samples']} samples)"
            )
    if top:
        rows = rows[:top]
    return "\n".join(rows)


# Arm from the environment at import (the MLSL_TRACE/MLSL_CHAOS contract):
# instrumented modules import this module, so MLSL_METRICS=1 on the launch
# command works with no code changes. The truthy table is the tracer's —
# MLSL_TRACE and MLSL_METRICS must parse a value identically.
from mlsl_tpu_torch.obs.tracer import _env_truthy  # noqa: E402

if _env_truthy(os.environ.get(ENV_METRICS)):
    enable()
