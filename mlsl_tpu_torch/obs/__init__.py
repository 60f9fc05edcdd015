"""mlsl_tpu_torch.obs -- the comm timeline's span tracer and the telemetry
plane. Counterpart of ``mlsl_tpu.obs``, by adapted copy.

Quick start::

    MLSL_TRACE=1 python train.py        # arm at launch
    # or programmatically:
    from mlsl_tpu_torch import obs
    obs.enable()
    ... run ...
    path = obs.write_trace()            # load in ui.perfetto.dev

Env knobs: ``MLSL_TRACE`` (arm), ``MLSL_TRACE_DIR`` (output directory,
default CWD), ``MLSL_TRACE_CAPACITY`` (ring size in events, default 65536).
Spans are host time (``time.perf_counter_ns``): a span never synchronizes
the card, which would change the path it measures.

On a watchdog trip (``MLSLTimeoutError``) the flight recorder dumps the
trailing window of spans to ``trace-crash-<ts>.json`` automatically (and,
with ``MLSL_PROFILE_ON_TRIP=1``, a ``torch.profiler`` trace next to it).

The telemetry plane rides in the same package: ``obs.metrics`` (typed
time-series registry, ``MLSL_METRICS=1``), ``obs.serve`` (``/metrics`` +
``/healthz`` + ``/statusz`` on ``MLSL_METRICS_PORT``), ``obs.straggler``
(cross-replica skew sentinel, ``MLSL_STRAGGLER_SKEW``)::

    MLSL_METRICS=1 MLSL_METRICS_PORT=9090 python train.py
    curl localhost:9090/metrics   # Prometheus text
    curl localhost:9090/healthz   # supervisor.status() as JSON
"""

from mlsl_tpu_torch.obs.tracer import (  # noqa: F401
    DEFAULT_CAPACITY,
    Tracer,
    disable,
    enable,
    enabled,
    get_tracer,
    span,
    trace_dir,
)
from mlsl_tpu_torch.obs.export import (  # noqa: F401
    flight_record,
    render,
    summarize,
    to_trace_events,
    write_trace,
)
from mlsl_tpu_torch.obs import metrics  # noqa: F401
from mlsl_tpu_torch.obs import serve  # noqa: F401
from mlsl_tpu_torch.obs import straggler  # noqa: F401
from mlsl_tpu_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    enable as enable_metrics,
    disable as disable_metrics,
    get_registry,
)
from mlsl_tpu_torch.obs.serve import start_server, stop_server  # noqa: F401
from mlsl_tpu_torch.obs.straggler import StragglerSentinel  # noqa: F401

__all__ = [
    "DEFAULT_CAPACITY",
    "Tracer",
    "disable",
    "enable",
    "enabled",
    "get_tracer",
    "span",
    "trace_dir",
    "flight_record",
    "render",
    "summarize",
    "to_trace_events",
    "write_trace",
    "metrics",
    "serve",
    "straggler",
    "MetricsRegistry",
    "StragglerSentinel",
    "enable_metrics",
    "disable_metrics",
    "get_registry",
    "start_server",
    "stop_server",
]
