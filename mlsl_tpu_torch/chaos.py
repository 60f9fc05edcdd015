"""Process-wide fault injection: named sites threaded through the real stack.

Counterpart of ``mlsl_tpu.chaos``, by adapted copy (the reference is
fail-stop, SURVEY.md §5.3; here every layer that can fail -- request
dispatch, collective launch, the quantized codec round-trip, data prefetch,
the serving engine's admission and decode -- passes a named injection
*site*, and this registry decides whether that pass raises, stalls, hangs or
rots bytes). Tests and the ``MLSL_CHAOS`` env var arm faults without touching
the code under test.

Sites (see ``SITES``) are compiled into the registry, not discovered, so a
typo in a plan is an error instead of a fault that never fires. The registry
is the reference's whole table, so every plan the JAX package parses parses
here too. The ``train.*`` sites' ``silent`` plans are applied by the trainer
(``sentinel.corrupt_silent``) and ``data.prefetch``'s ``bitrot`` by the feed;
the ``checkpoint.*`` and ``control.*`` sites are registered and wait for the
recovery layer that consumes them (ROADMAP A.7c).

Python API::

    chaos.plan("request.wait", "error", exc=OSError, after=2, times=1)
    with chaos.injected("request.wait", "delay", seconds=0.1):
        ...
    chaos.clear()

Env config (comma-separated)::

    MLSL_CHAOS="request.wait:error@6,collective.dispatch:hang=30,data.prefetch:delay=0.05x*"

Grammar per entry: ``site:kind[=value][@after][xN][%p]`` -- *value* is the
exception name for ``error`` (oserror, runtimeerror, mlslerror, ...),
seconds for ``delay``/``hang``, or the corruption magnitude for ``silent``;
``@after`` skips the first N hits; ``xN`` fires at most N times (default 1;
``x*`` = unlimited); ``%p`` makes each eligible hit fire with probability
*p*. At the ``device.lost`` site an ``error`` plan raises
:class:`MLSLDeviceLossError` by default. The fire decisions come from a
module RNG seeded by ``MLSL_CHAOS_SEED`` (or :func:`seed`), so a
probabilistic soak replays exactly.

CUDA graphs: Python that a graph records runs once, at the capture, and
never at a replay. So a pass is idle -- no hit counted, nothing fired --
while the calling thread's current CUDA stream is capturing, and inside
:func:`quiet` (``core/graph_capture.capture`` runs its eager warm-up and its
recording there). A site that must fire every step sits on the host before
the replay (the compiled overlap engine's ``step``, the serving engine's
decode step).

Hot-path contract: instrumented code guards with ``if chaos._plans:`` (one
dict truthiness test when idle) or calls ``inject`` directly (one call + one
check). Nothing else happens until a plan is armed.
"""

from __future__ import annotations

import dataclasses
import os
import random
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from mlsl_tpu_torch.log import (
    MLSLCorruptionError,
    MLSLDeviceLossError,
    MLSLError,
    log_info,
    log_warning,
)


class ChaosError(RuntimeError):
    """Default injected fault: recoverable (RuntimeError) by FaultTolerantLoop."""


#: Every legal injection site and where it lives in the stack.
SITES: Dict[str, str] = {
    "request.start": "CommRequest.start (comm/request.py): before dispatch",
    "request.wait": "CommRequest.wait (comm/request.py): before completion wait",
    "request.test": "CommRequest.test (comm/request.py): before completion poll",
    "collective.dispatch": "compiled collective invocation (comm/collectives.py)",
    "codec.roundtrip": "quantized ring codec round-trip (comm/quant_ring.py)",
    "checkpoint.save": "CheckpointManager.save (checkpoint.py); supports bitrot",
    "checkpoint.restore": "CheckpointManager.restore (checkpoint.py)",
    "data.prefetch": "feed batch read (data/: AsyncLoader worker and "
                     "DeviceFeed source reads; bitrot rots the encoded "
                     "wire payload through the codec + cache paths)",
    # SILENT corruption sites (models/train.py): the fired plan is returned
    # and the trainer applies the corruption via sentinel.corrupt_silent —
    # state/payload is flipped or perturbed WITHOUT raising, the class of
    # fault only the integrity sentinel (mlsl_tpu.sentinel) can catch. The
    # per-layer graph path applies them; the no-comm fused shortcut has no
    # gradient boundary to corrupt (and an armed sentinel gate disables it).
    "train.params": "trainer parameters at step entry (models/train.py); "
                    "silent corrupts ONE replica's copy (audit quarry)",
    "train.opt_state": "optimizer state at step entry (models/train.py); "
                       "silent corrupts one replica/shard copy",
    "train.grads": "local gradients before the quality gate and gradient "
                   "comm (models/train.py); silent=nan/inf poisons an "
                   "element the gate's nonfinite screen must catch",
    # Elastic-mesh fault (comm/collectives.py dispatch + mlsl_tpu/elastic.py
    # admission): an 'error' plan raises MLSLDeviceLossError (the default
    # exception at THIS site) — routed to the elastic reshard rung when a
    # coordinator is armed, to checkpoint restart otherwise. A 'silent' plan
    # is consulted by ElasticCoordinator.grow: it corrupts the REJOINING
    # replica's copy of the params so the sentinel admission audit has
    # something to reject (the re-admission quarry).
    "device.lost": "device/slice loss at collective dispatch "
                   "(comm/collectives.py) and at elastic re-admission "
                   "(elastic.py grow; silent corrupts the rejoining copy)",
    # Pod-control-plane faults (control/plane.py): fired on the SENDER's
    # heartbeat/notice paths — error = frame lost, delay = late frame,
    # hang = wedged sender. A lost heartbeat feeds the PEER's miss
    # accounting (which is the machinery under test); a lost/delayed
    # notice degrades to retry-next-tick, never to a lost drain.
    "control.heartbeat": "heartbeat fan-out tick (control/plane.py): one "
                         "inject per peer send; error drops the frame, "
                         "delay/hang stall the sender into a miss",
    "control.notice": "preemption-notice delivery and drain-order "
                      "broadcast (control/plane.py): error/delay/hang "
                      "model a lost notice, a late drain order, and a "
                      "partitioned leader",
    # Serving-engine faults (serve/engine.py): fired inside the scheduler
    # loop. admit fires per admission attempt (error = a request the
    # engine must reject-not-crash); decode fires per decode step on the
    # in-flight batch — error/delay/hang model a failed, late, and wedged
    # decode program, the tail-latency quarry the SLA ladder must absorb
    # (degraded throughput, never lost availability). An error classified
    # DEVICE_LOSS models replica loss mid-serve.
    "serve.admit": "admission attempt (serve/engine.py): error = a "
                   "request the engine must fail closed, not crash on",
    "serve.decode": "decode step over the in-flight batch "
                    "(serve/engine.py): error/delay/hang = failed, "
                    "late, wedged decode; DEVICE_LOSS = replica loss",
}

KINDS = ("error", "delay", "hang", "bitrot", "silent")

_EXC_NAMES = {
    "chaoserror": ChaosError,
    "runtimeerror": RuntimeError,
    "mlslerror": MLSLError,
    "corruptionerror": MLSLCorruptionError,
    "devicelosserror": MLSLDeviceLossError,
    "oserror": OSError,
    "ioerror": OSError,
    "valueerror": ValueError,
    "timeouterror": TimeoutError,
}

# Probabilistic-fire RNG (the %p grammar). Module-level and seedable so a
# randomized soak run is replayable: MLSL_CHAOS_SEED=42 (or seed(42)) makes
# the same fault schedule fire against the same workload.
_rng = random.Random(
    int(os.environ["MLSL_CHAOS_SEED"])
    if os.environ.get("MLSL_CHAOS_SEED") else None
)


def seed(n: Optional[int]) -> None:
    """Re-seed the probabilistic-fire RNG (tests / soak reproducibility)."""
    _rng.seed(n)


@dataclasses.dataclass
class Plan:
    """One armed fault. ``after`` hits are skipped, then it fires ``times``
    times (None = unlimited). ``hits``/``fires`` are the observable counters."""

    site: str
    kind: str = "error"
    exc: type = ChaosError
    seconds: float = 0.1
    after: int = 0
    times: Optional[int] = 1
    prob: float = 1.0
    #: 'silent' corruption magnitude: None = flip one random bit in one
    #: element; a finite value adds mag * (|x| + 1); nan/inf overwrite the
    #: element (the applier is sentinel.corrupt_silent)
    mag: Optional[float] = None
    hits: int = 0
    fires: int = 0
    cancelled: bool = False

    def _should_fire(self) -> bool:
        # caller holds _lock
        self.hits += 1
        if self.cancelled or self.hits <= self.after:
            return False
        if self.times is not None and self.fires >= self.times:
            return False
        if self.prob < 1.0 and _rng.random() >= self.prob:
            # probabilistic plan (%p): an eligible hit that rolled a miss —
            # counts as a hit, never as a fire, and never burns `times`
            return False
        self.fires += 1
        return True


_lock = threading.Lock()
_plans: Dict[str, List[Plan]] = {}  # site -> armed plans (empty dict = idle)
_quiet = threading.local()          # per-thread depth of quiet() blocks


class quiet:
    """Context manager: every site passed by this thread inside the block is
    idle (a graph's warm-up and recording, a precompile warm)."""

    def __enter__(self) -> "quiet":
        _quiet.depth = getattr(_quiet, "depth", 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        _quiet.depth -= 1


def _idle() -> bool:
    """True inside quiet() or while this thread's CUDA stream captures."""
    if getattr(_quiet, "depth", 0):
        return True
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return False
    return torch.cuda.is_current_stream_capturing()


def plan(
    site: str,
    kind: str = "error",
    exc: Optional[type] = None,
    seconds: float = 0.1,
    after: int = 0,
    times: Optional[int] = 1,
    prob: float = 1.0,
    mag: Optional[float] = None,
) -> Plan:
    """Arm a fault at ``site``. Returns the Plan (counters readable by tests).
    ``prob`` < 1 makes each eligible hit fire with that probability (the
    ``%p`` grammar — randomized soak faults with no hand-scheduled
    budgets); pair it with ``times=None`` for an indefinitely flaky site.
    ``mag`` applies to ``kind='silent'`` only (see Plan.mag)."""
    if site not in SITES:
        raise ValueError(f"unknown chaos site {site!r}; known: {sorted(SITES)}")
    if kind not in KINDS:
        raise ValueError(f"unknown chaos kind {kind!r}; known: {KINDS}")
    if not 0.0 < prob <= 1.0:
        raise ValueError(f"chaos probability must be in (0, 1] (got {prob!r})")
    if exc is None:
        # per-site semantic default (None = caller named nothing, so an
        # EXPLICIT exc=ChaosError still wins for cross-class tests): a lost
        # device IS a device-loss error — grammar
        # `device.lost:error[@after][xN][%p]` carries no exception name
        exc = MLSLDeviceLossError if site == "device.lost" else ChaosError
    p = Plan(site=site, kind=kind, exc=exc, seconds=seconds, after=after,
             times=times, prob=prob, mag=mag)
    with _lock:
        _plans.setdefault(site, []).append(p)
    log_info("chaos armed: %s %s after=%d times=%s prob=%s",
             site, kind, after, times, prob)
    return p


class injected:
    """Context manager: arm a plan on entry, remove it (and wake any hang) on
    exit. ``with chaos.injected("request.wait", "delay", seconds=0.1): ...``"""

    def __init__(self, site: str, kind: str = "error", **kw):
        self._args = (site, kind)
        self._kw = kw
        self.plan: Optional[Plan] = None

    def __enter__(self) -> Plan:
        self.plan = plan(*self._args, **self._kw)
        return self.plan

    def __exit__(self, *exc) -> None:
        remove(self.plan)


def remove(p: Plan) -> None:
    p.cancelled = True
    with _lock:
        site_plans = _plans.get(p.site)
        if site_plans is not None:
            try:
                site_plans.remove(p)
            except ValueError:
                pass
            if not site_plans:
                del _plans[p.site]


def clear() -> None:
    """Disarm everything and wake any in-progress hang sleeps."""
    with _lock:
        for plans_ in _plans.values():
            for p in plans_:
                p.cancelled = True
        _plans.clear()


def active() -> bool:
    return bool(_plans)


def inject(site: str, kinds: Optional[Tuple[str, ...]] = None,
           **ctx) -> Optional[Plan]:
    """Pass ``site``. No-op (one dict check) unless a plan is armed there.

    ``error`` raises the plan's exception, ``delay`` sleeps, ``hang`` sleeps
    until its duration elapses or the plan is cancelled (clear()/remove()).
    Site-specific kinds (``bitrot``, ``silent``) don't act here -- the fired
    Plan is returned and the call site applies the effect. ``ctx`` is
    free-form, logged for diagnosis. Idle (returns None, counts no hit)
    while a CUDA graph captures on this thread's stream, and inside
    :func:`quiet`.

    ``kinds`` restricts which plan kinds this pass may fire (and therefore
    consume): a site with two consumers — collective dispatch fires
    ``device.lost`` error-shaped loss, elastic grow applies the ``silent``
    rejoiner corruption — must not burn the other consumer's ``times``
    budget. A plan whose kind is filtered out stays armed, untouched.
    """
    if not _plans:
        return None
    site_plans = _plans.get(site)
    if not site_plans or _idle():
        return None
    fired: Optional[Plan] = None
    for p in list(site_plans):
        if kinds is not None and p.kind not in kinds:
            continue
        with _lock:
            go = p._should_fire()
        if not go:
            continue
        log_warning("chaos fired: %s %s (hit %d) ctx=%s", site, p.kind, p.hits, ctx)
        from mlsl_tpu_torch.obs import tracer as _obs  # lazy: cold (fired) path only

        if _obs._tracer is not None:
            # injections land on the comm timeline so a trace of a chaos run
            # shows WHERE the fault hit relative to the spans it perturbed
            _obs._tracer.instant("chaos.fired", "chaos", site=site,
                                 kind=p.kind, hit=p.hits)
        if p.kind == "error":
            raise p.exc(f"chaos injected at {site} (hit {p.hits})")
        if p.kind == "delay":
            time.sleep(p.seconds)
        elif p.kind == "hang":
            end = time.monotonic() + p.seconds
            while time.monotonic() < end and not p.cancelled:
                time.sleep(0.01)
        fired = p
    return fired


#: the spec the plans were last armed from (import, refresh_from_env or
#: configure)
_spec = ""


def configure(config) -> None:
    """Arm ``config.chaos_spec`` (MLSL_CHAOS as ``Environment.init`` read it)
    unless it is the spec the plans were last armed from: a rebuilt
    Environment does not re-arm a spent budget, nor clear plans armed
    through the API when no spec is given."""
    if config.chaos_spec != _spec:
        refresh_from_env(config.chaos_spec)


def reset() -> None:
    """Disarm every plan and forget the spec they were armed from (tests)."""
    global _spec
    clear()
    _spec = ""


def refresh_from_env(spec: Optional[str] = None) -> List[Plan]:
    """(Re)arm plans from ``MLSL_CHAOS`` (or an explicit spec). Replaces any
    previously env-armed plans; API-armed plans are cleared too — the env spec
    is authoritative when used."""
    global _spec
    if spec is None:
        spec = os.environ.get("MLSL_CHAOS", "")
    s = os.environ.get("MLSL_CHAOS_SEED")
    if s:
        # re-arming from the env restarts the reproducible fault schedule
        _rng.seed(int(s))
    clear()
    out = []
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        out.append(plan(**_parse_entry(entry)))
    _spec = spec
    return out


def _parse_entry(entry: str) -> dict:
    """``site:kind[=value][@after][xN][%p]`` -> plan() kwargs."""
    site, sep, rest = entry.partition(":")
    if not sep:
        raise ValueError(f"bad MLSL_CHAOS entry {entry!r}: expected site:kind[...]")
    kw: dict = {"site": site}
    if "%" in rest:
        rest, _, pr = rest.rpartition("%")
        kw["prob"] = float(pr)
    times: Optional[int] = 1
    if "x" in rest:
        rest, _, t = rest.rpartition("x")
        times = None if t == "*" else int(t)
    kw["times"] = times
    if "@" in rest:
        rest, _, a = rest.partition("@")
        kw["after"] = int(a)
    kind, _, value = rest.partition("=")
    kw["kind"] = kind
    if value:
        if kind == "error":
            try:
                kw["exc"] = _EXC_NAMES[value.lower()]
            except KeyError:
                raise ValueError(
                    f"unknown exception {value!r} in MLSL_CHAOS entry {entry!r}; "
                    f"known: {sorted(_EXC_NAMES)}"
                ) from None
        elif kind == "silent":
            # silent corruption magnitude ('nan'/'inf' accepted — they
            # overwrite the element); no value = flip one random bit
            kw["mag"] = float(value)
        else:
            kw["seconds"] = float(value)
    return kw


# Arm from the environment at import: instrumented modules import this module,
# so MLSL_CHAOS=... on the launch command works with no code changes.
if os.environ.get("MLSL_CHAOS"):
    refresh_from_env()
