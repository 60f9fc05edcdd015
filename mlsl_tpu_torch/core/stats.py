"""Statistics: online comm/compute accounting, the isolation replay and the
``mlsl_stats.log`` table.

Counterpart of ``mlsl_tpu.core.stats`` (reference Statistics,
include/mlsl.hpp:651-726, src/mlsl_impl_stats.cpp):

- online accounting: every Start/Wait/Test of an activation or a parameter
  set emits a pre-event and a post-event; the time since the previous event is
  compute on a pre-event and comm on a post-event, and bytes count on Start
  (reference UpdateStats :564-668). A wait on an activation completes its
  peer's request, so its time goes to the peer's slot. "Cycles" are host
  nanoseconds (``time.perf_counter_ns``);
- the isolation replay at Commit: every registered request runs
  ``ISOLATION_ITERS`` times on zero buffers, the first ``ISOLATION_SKIP``
  dropped, for its pure communication time a round (reference
  CollectIsolationStats :387-562); on the card each round ends with the
  stream synchronized, so the time is the collective's, not its launch's;
- the overlap report: isolation time times starts against the comm time the
  host spent blocked, per operation and in total;
- ``print_``: the table appended to ``mlsl_stats.log`` (``MLSL_STATS_DIR``,
  default the working directory; reference :226-363), for the counters this
  package keeps: per-slot rows, ISOLATE, OVERLAP, BUCKET, FEED, ALGO,
  OVERLAP ENGINE, SENTINEL, CODEC, SERVE ENGINE and CHKP lines.

Also the process-wide counters of the dispatch layer: bucket rounds of
gradient bucketing (stats.py:131-175), launches per (kind, algorithm) and the
compiled overlap engine's steps (stats.py:640-695), the codec registry's
wire bytes a codec and its calibration and guardrail events (stats.py:268-310),
the device feed's staged bytes, cache outcomes, stalls and retries
(stats.py:537-590), and the serving engine's admissions, decode progress,
KV paging and SLA ladder transitions (stats.py:592-640; each transition also
appends an immediate SERVE line), and the fault plane's (stats.py:49-130,
180-245, 377-535): the watchdog record with its flight record and
``torch.profiler`` trace on a trip, the recovery ladder (DEGRADE: breaker
transitions, degraded dispatches, retries; a guardrail demotion is filed
there too), straggler audits (STRAGGLER), the lock witness (LOCKWITNESS) and
analysis verdicts (ANALYSIS), and the integrity layer's (stats.py:239-270,
355-373): the sentinel's gate and audits (SENTINEL) and the buffer
checker's checks (CHKP). The JAX package's table also prints the elastic
mesh (ELASTIC) and the control plane (CONTROL); those subsystems are not
ported yet (ROADMAP A.7c), so their counters and lines are left out, as are
the span tracer's wait-stall percentiles in the OVERLAP and BUCKET lines.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from mlsl_tpu_torch.log import log_warning
from mlsl_tpu_torch.obs import tracer as obs

ISOLATION_ITERS = 10
ISOLATION_SKIP = 4
STATS_OUTPUT_FILE = "mlsl_stats.log"


def stats_path(name: str = STATS_OUTPUT_FILE) -> str:
    """Where the table lands: ``MLSL_STATS_DIR`` (default the working
    directory), read at each call."""
    d = os.environ.get("MLSL_STATS_DIR")
    return os.path.join(d, name) if d else name


# Bucket-round accounting (core/bucketing.py): process-wide, as in the JAX
# package -- buckets fire from the request layer with no Session handle. The
# JAX package's event ring is left out: nothing here reads it.
BUCKET_COUNTERS: Dict[str, int] = {
    "rounds_dispatched": 0,   # full rounds served by one coalesced dispatch
    "rounds_fallback": 0,     # early-Wait rounds run as individual requests
    "member_abandons": 0,     # members restarted mid-flight (ran individually)
    "bytes_coalesced": 0,     # member payload bytes carried by bucket rounds
    "wire_bytes_saved": 0,    # est. wire bytes the int8 codec saved vs float32
}


def record_bucket_round(event: str, members: int = 0, coalesced: int = 0,
                        wire_saved: int = 0, *, kind: str = "") -> None:
    """Called by GradBucket at every round transition (dispatch, early-Wait
    fallback, member-restart abandon); a ``bucket.<event>`` instant on the
    tracer's timeline."""
    if event == "dispatched":
        BUCKET_COUNTERS["rounds_dispatched"] += 1
        BUCKET_COUNTERS["bytes_coalesced"] += coalesced
        BUCKET_COUNTERS["wire_bytes_saved"] += wire_saved
    elif event == "fallback":
        BUCKET_COUNTERS["rounds_fallback"] += 1
    else:  # abandon
        BUCKET_COUNTERS["member_abandons"] += max(members, 1)
    if obs._tracer is not None:
        obs._tracer.instant(f"bucket.{event}", "bucket", kind=kind, members=members)


def reset_bucket_counters() -> None:
    for k in BUCKET_COUNTERS:
        BUCKET_COUNTERS[k] = 0


# Per-algorithm dispatch accounting (comm/algos): process-wide like the
# bucket counters. Key = (kind, algorithm name); value = launches, from the
# host requests (CommRequest) and, in bulk per step, the compiled overlap
# engine's units.
ALGO_COUNTERS: Dict[Tuple[str, str], int] = {}


def record_algo_dispatch(kind: str, algo: str) -> None:
    """One collective launch under ``algo`` (called by CommRequest._launch)."""
    key = (kind, algo)
    ALGO_COUNTERS[key] = ALGO_COUNTERS.get(key, 0) + 1


def reset_algo_counters() -> None:
    ALGO_COUNTERS.clear()


# Compiled-overlap engine accounting (comm/overlap.py): its units never
# construct a CommRequest, so their attribution lands here and, per
# algorithm, in ALGO_COUNTERS.
OVERLAP_COUNTERS: Dict[str, int] = {
    "steps": 0,          # compiled-overlap steps run
    "split_steps": 0,    # of which ran the split program (step_accum)
    "units": 0,          # reduction units run (cumulative)
    "rounds": 0,         # collective phases run
    "bytes": 0,          # logical gradient bytes reduced
}


def record_overlap_step(units: int, rounds: int, nbytes: int, *, split: bool = False,
                        breakdown: Optional[Dict[Tuple[str, str], int]] = None) -> None:
    """One compiled-overlap step, attributed in bulk. ``breakdown`` maps
    (kind, algo) -> unit count and feeds ALGO_COUNTERS."""
    OVERLAP_COUNTERS["steps"] += 1
    if split:
        OVERLAP_COUNTERS["split_steps"] += 1
    OVERLAP_COUNTERS["units"] += units
    OVERLAP_COUNTERS["rounds"] += rounds
    OVERLAP_COUNTERS["bytes"] += nbytes
    for key, n in (breakdown or {}).items():
        ALGO_COUNTERS[key] = ALGO_COUNTERS.get(key, 0) + n


def reset_overlap_counters() -> None:
    for k in OVERLAP_COUNTERS:
        OVERLAP_COUNTERS[k] = 0


# The codec registry's accounting (codecs/): wire bytes a codec (the
# compressed image of each started round's payload) and the calibration and
# guardrail events; process-wide, as the guardrail fires with no Session at
# hand. Demotions also keep a bounded list of who, which codec and why.
CODEC_WIRE_BYTES: Dict[str, int] = {}
CODEC_COUNTERS: Dict[str, int] = {
    "calibrations": 0,     # calibration passes run (Session.commit)
    "assignments": 0,      # requests routed to a calibrated codec
    "guard_breaches": 0,   # loss breaches while a calibrated codec is guarded
    "demotions": 0,        # guardrail demotions to int8
}
CODEC_DEMOTIONS: List[str] = []
_CODEC_DEMOTIONS_MAX = 64


def record_codec(event: str) -> None:
    """One codec event: a key of CODEC_COUNTERS."""
    CODEC_COUNTERS[event] += 1


def record_codec_wire(codec: str, nbytes: int) -> None:
    """One started compressed round: ``nbytes`` of wire image under ``codec``
    (called by CommRequest.start)."""
    CODEC_WIRE_BYTES[codec] = CODEC_WIRE_BYTES.get(codec, 0) + int(nbytes)


def record_codec_demotion(request: str, codec: str, reason: str) -> None:
    """A guardrail demotion: the counter, the bounded attribution row and the
    DEGRADE ladder event (``codec_demote``)."""
    CODEC_COUNTERS["demotions"] += 1
    if len(CODEC_DEMOTIONS) < _CODEC_DEMOTIONS_MAX:
        CODEC_DEMOTIONS.append(f"{request}: {codec} -> int8 ({reason})")
    record_degrade("quant", "codec_demote", f"{request} {codec}->int8 {reason}")


def reset_codec_counters() -> None:
    for k in CODEC_COUNTERS:
        CODEC_COUNTERS[k] = 0
    CODEC_WIRE_BYTES.clear()
    CODEC_DEMOTIONS.clear()


# Watchdog event record: every request the watchdog declared stuck, with its
# descriptor and how long it had been in flight. Process-wide (the watchdog
# fires from the request layer, which has no Session handle); bounded so a
# recurrently flaky interconnect cannot grow memory across recoveries — the
# full history lives in STATS_OUTPUT_FILE, appended per event below.
WATCHDOG_EVENTS: Deque[dict] = collections.deque(maxlen=256)


def record_watchdog_event(descriptor: str, phase: str, waited_s: float) -> None:
    """Called by CommRequest._watchdog_trip just before it raises
    MLSLTimeoutError."""
    evt = {
        "descriptor": descriptor,
        "phase": phase,
        "waited_s": waited_s,
        "at": time.time(),
    }
    WATCHDOG_EVENTS.append(evt)
    log_warning(
        "watchdog: request stuck in %s for %.2fs: %s", phase, waited_s, descriptor
    )
    if obs._tracer is not None:
        # flight recorder: dump the trailing window of spans around the stall
        # (the stuck epoch plus margin) so the timeout report carries the
        # timeline that led to it — the stuck request's own watchdog.trip
        # instant is already in the ring (CommRequest._watchdog_trip)
        from mlsl_tpu_torch.obs import export as obs_export

        path = obs_export.flight_record(
            window_s=max(2 * waited_s, 30.0),
            reason=f"watchdog {phase}: {descriptor}",
        )
        if path:
            evt["flight_record"] = path
            log_warning("watchdog flight record written: %s", path)
    prof = _profile_on_trip(descriptor)
    if prof:
        evt["device_profile"] = prof
    try:
        with open(stats_path(), "a") as f:
            f.write(
                f"{'WATCHDOG':<16} {phase:<8} waited {waited_s:>10.2f} s  "
                f"{descriptor}\n"
            )
    except OSError:
        pass


#: how long the on-trip device profile samples the wedged state (seconds):
#: long enough for the profiler to catch the in-flight executable / idle
#: devices, short enough that the trip still raises promptly
PROFILE_ON_TRIP_WINDOW_S = 0.25


#: the live Environment's Config (:func:`configure`)
_config = None


def configure(config=None) -> None:
    """Read ``profile_on_trip`` from ``config`` (``Environment.init`` hands
    over its own, ``finalize`` takes it back with ``None``) or from
    MLSL_PROFILE_ON_TRIP."""
    global _config
    _config = config


def _profile_on_trip(reason: str) -> Optional[str]:
    """``MLSL_PROFILE_ON_TRIP=1``: capture a short ``torch.profiler`` trace
    of the wedged state (the card's activity where CUDA is up, else the
    CPU's), exported as a Chrome trace next to the flight record -- the host
    timeline says WHERE the wait stuck, the device profile what the card was
    doing under it. Best-effort by contract: a profiler failure (already
    active, no CUPTI) must never replace the MLSLTimeoutError the watchdog
    exists to raise."""
    v = (os.environ.get("MLSL_PROFILE_ON_TRIP") or "").strip().lower()
    armed = _config is not None and _config.profile_on_trip
    if not armed and v in ("", "0", "false", "no", "off"):
        return None
    out_dir = os.path.join(
        obs.trace_dir(), f"profile-trip-{time.time_ns() // 1_000_000}"
    )
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            time.sleep(PROFILE_ON_TRIP_WINDOW_S)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    except Exception as e:  # profiler busy/unsupported: keep the trip primary
        log_warning(
            "MLSL_PROFILE_ON_TRIP capture failed (%s: %s); continuing with "
            "the host flight record only (%s)", type(e).__name__, e, reason,
        )
        return None
    log_warning("watchdog device profile written: %s", out_dir)
    return out_dir


# Degradation-ladder accounting (supervisor.py): breaker transitions,
# degraded dispatches, comm retries, and supervised recoveries — process-wide
# like the watchdog record (breakers fire from the request layer with no
# Session handle). Breaker transitions append a DEGRADE line to
# STATS_OUTPUT_FILE immediately (cold path — trips are rare by construction);
# per-dispatch fallbacks and retries only bump counters + the obs timeline
# (an OPEN breaker degrades every dispatch, and a file append per layer per
# step would be the new bottleneck). Statistics.print_ renders the counter
# totals as the DEGRADE summary line.
DEGRADE_EVENTS: Deque[dict] = collections.deque(maxlen=256)
DEGRADE_COUNTERS: Dict[str, int] = {
    "breaker_trips": 0,     # closed/half_open -> open transitions
    "breaker_probes": 0,    # open -> half_open probe admissions
    "breaker_resets": 0,    # half_open -> closed (healthy path re-engaged)
    "comm_retries": 0,      # rung-2 transient retries (dispatch + wait)
    "recoveries": 0,        # rung-4 supervised checkpoint restarts
}
#: degraded dispatches per subsystem (quant->plain, bucket->individual,
#: algo->lax, tracer->no-op)
DEGRADE_FALLBACKS: Dict[str, int] = {}


def record_degrade(subsystem: str, event: str, detail: str = "") -> None:
    """One ladder event: ``event`` is a breaker transition ('trip' /
    'probe' / 'reset'), a degraded dispatch ('fallback'), or a supervised
    restart ('recover'). Called by supervisor.CircuitBreaker and the
    degraded call sites."""
    if event == "trip":
        DEGRADE_COUNTERS["breaker_trips"] += 1
    elif event == "probe":
        DEGRADE_COUNTERS["breaker_probes"] += 1
    elif event == "reset":
        DEGRADE_COUNTERS["breaker_resets"] += 1
    elif event == "recover":
        DEGRADE_COUNTERS["recoveries"] += 1
    elif event == "codec_demote":
        # guardrail demotion (mlsl_tpu.codecs): counted in its own family
        # (CODEC_COUNTERS, via record_codec_demotion) — here it only joins
        # the event deque + DEGRADE file line, not the fallback counter
        pass
    else:  # fallback: one dispatch served by the degraded path
        DEGRADE_FALLBACKS[subsystem] = DEGRADE_FALLBACKS.get(subsystem, 0) + 1
    DEGRADE_EVENTS.append(
        {"subsystem": subsystem, "event": event, "detail": detail,
         "at": time.time()}
    )
    if obs._tracer is not None:
        # trip/reset instants bracket the degraded interval on the timeline;
        # fallback instants attribute each degraded dispatch
        name = f"breaker.{event}" if event != "fallback" else "degrade.fallback"
        obs._tracer.instant(name, "degrade", subsystem=subsystem,
                            detail=detail or None)
    if event in ("trip", "probe", "reset", "recover", "codec_demote"):
        try:
            with open(stats_path(), "a") as f:
                f.write(
                    f"{'DEGRADE':<16} {event.upper():<8} {subsystem:<10} "
                    f"{detail}\n"
                )
        except OSError:
            pass


# Static-analysis accounting (analysis/): verifier/linter runs and
# their finding counts. Process-wide like the other event families (the
# verifier fires from Session.commit, which may run for several sessions in
# one process); each run also appends an immediate ANALYSIS line below.
ANALYSIS_COUNTERS: Dict[str, int] = {
    "runs": 0,       # verify/lint passes completed
    "errors": 0,     # error-severity findings across all runs
    "warnings": 0,   # warn-severity findings across all runs
}


def record_analysis(kind: str, errors: int, warnings: int,
                    codes: List[str], duration_s: float = 0.0) -> None:
    """One finished static-analysis pass (called by analysis.diagnostics
    .record): counters plus an immediate ANALYSIS line in the stats log —
    the verifier's verdict belongs next to the DEGRADE/WATCHDOG history it
    exists to prevent."""
    ANALYSIS_COUNTERS["runs"] += 1
    ANALYSIS_COUNTERS["errors"] += int(errors)
    ANALYSIS_COUNTERS["warnings"] += int(warnings)
    verdict = "FAIL" if errors else "PASS"
    try:
        with open(stats_path(), "a") as f:
            f.write(
                f"{'ANALYSIS':<16} {kind:<8} {verdict:<5} "
                f"errors={errors} warnings={warnings} "
                f"dt={duration_s * 1e3:.2f}ms"
                + (f"  codes={','.join(codes)}" if codes else "") + "\n"
            )
    except OSError:
        pass


def reset_analysis_counters() -> None:
    for k in ANALYSIS_COUNTERS:
        ANALYSIS_COUNTERS[k] = 0


# Integrity-sentinel accounting (sentinel.py; stats.py:239-270 of the JAX
# package): gate screens and fires, consistency audits -- process-wide like
# the degrade counters (the sentinel fires from the trainer with no Session
# handle); the SENTINEL line of print_ and the mlsl_sentinel_* family.
SENTINEL_COUNTERS: Dict[str, int] = {
    "screened": 0,        # steps the quality gate inspected
    "gate_warn": 0,       # gate fired with response 'warn' (the run went on)
    "gate_skip": 0,       # gate fired with response 'skip_step'
    "gate_rollback": 0,   # gate fired with response 'rollback' (raised)
    "audits": 0,          # consistency audits run
    "audit_mismatch": 0,  # audits that found per-rank copies diverged
    "verified_saves": 0,  # checkpoint fingerprints given with a passing audit
    "reaudits": 0,        # post-restore re-audits (A.7c's recovery)
}


def record_sentinel(event: str) -> None:
    """One sentinel event: a key of SENTINEL_COUNTERS."""
    SENTINEL_COUNTERS[event] += 1


def reset_sentinel_counters() -> None:
    for k in SENTINEL_COUNTERS:
        SENTINEL_COUNTERS[k] = 0


# Buffer-checker accounting (checker.py; stats.py:355-373 of the JAX
# package): buffers checked, violations, and the host reads the batched
# finiteness verdicts paid (value_checks >> value_syncs on a many-request
# round); the CHKP line of print_ and the mlsl_chkp_* family.
CHKP_COUNTERS: Dict[str, int] = {
    "checks": 0,        # buffers checked (layout, length, dtype)
    "violations": 0,    # checks that raised (either level)
    "value_checks": 0,  # finiteness verdicts queued (MLSL_CHKP=2)
    "value_syncs": 0,   # host reads paid to resolve them
}


def record_chkp(event: str, n: int = 1) -> None:
    CHKP_COUNTERS[event] += n


def reset_chkp_counters() -> None:
    for k in CHKP_COUNTERS:
        CHKP_COUNTERS[k] = 0


# Straggler-sentinel accounting (obs/straggler.py): cross-replica
# skew audits, confirmed-straggler flags, and elastic sheds — process-wide
# like the degrade counters (the sentinel is fed from the trainer with no
# Session handle). Flags and sheds are cold (a confirmed straggler is rarer
# than a breaker trip) and append an immediate STRAGGLER line, the DEGRADE
# transition contract; per-audit bookkeeping only bumps the counter.
STRAGGLER_COUNTERS: Dict[str, int] = {
    "audits": 0,          # cross-replica comparisons run
    "flags": 0,           # confirmed stragglers (sustained skew) flagged
    "sheds": 0,           # flagged replicas handed to the elastic coordinator
    "shed_fallbacks": 0,  # shed handoffs the coordinator refused/failed
}


def record_straggler(event: str, detail: str = "") -> None:
    """One straggler-sentinel event (see STRAGGLER_COUNTERS keys)."""
    STRAGGLER_COUNTERS[event] += 1
    if event != "audits":  # audits are the per-interval heartbeat, not news
        try:
            with open(stats_path(), "a") as f:
                f.write(f"{'STRAGGLER':<16} {event.upper():<8} {detail}\n")
        except OSError:
            pass


def reset_straggler_counters() -> None:
    for k in STRAGGLER_COUNTERS:
        STRAGGLER_COUNTERS[k] = 0


# Runtime lock-witness accounting (analysis/witness.py,
# MLSL_LOCK_WITNESS=1): the dynamic half of the A21x concurrency suite.
# Acquisitions are the hot path (every witnessed critical section) and only
# bump the counter; edges/cycles/over-budget holds are cold findings and
# append an immediate LOCKWITNESS line — a witnessed order cycle must be
# readable from mlsl_stats.log next to the CONTROL story it would deadlock.
LOCKWITNESS_COUNTERS: Dict[str, int] = {
    "acquisitions": 0,       # witnessed acquisitions (hot: counter only)
    "edges_observed": 0,     # distinct acquisition-order edges seen
    "cycles_detected": 0,    # runtime lock-order cycles (potential deadlock)
    "over_budget_holds": 0,  # holds past MLSL_LOCK_WITNESS_BUDGET_MS
}

_LOCKWITNESS_HOT = ("acquisitions",)


def record_lock_witness(event: str, detail: str = "") -> None:
    """One lock-witness event (see LOCKWITNESS_COUNTERS keys)."""
    LOCKWITNESS_COUNTERS[event] += 1
    if event not in _LOCKWITNESS_HOT:
        try:
            with open(stats_path(), "a") as f:
                f.write(f"{'LOCKWITNESS':<16} {event.upper():<16} {detail}\n")
        except OSError:
            pass


def reset_lock_witness_counters() -> None:
    for k in LOCKWITNESS_COUNTERS:
        LOCKWITNESS_COUNTERS[k] = 0


def record_comm_retry(phase: str, request: str, error: BaseException,
                      attempt: int, delay_s: float) -> None:
    """One rung-2 retry of a transient dispatch/wait failure (called by
    CommRequest before it backs off)."""
    DEGRADE_COUNTERS["comm_retries"] += 1
    if obs._tracer is not None:
        obs._tracer.instant(f"{phase}.retry", "degrade", request=request,
                            attempt=attempt, delay_s=round(delay_s, 4),
                            error=repr(error))


def reset_degrade_counters() -> None:
    for k in DEGRADE_COUNTERS:
        DEGRADE_COUNTERS[k] = 0
    DEGRADE_FALLBACKS.clear()
    DEGRADE_EVENTS.clear()


# Device-feed accounting (data/): process-wide, as in the JAX package -- the
# feed stages batches from a loader thread with no Session handle. Wire bytes
# are what crossed the host->device copy; bytes_saved is the full-width
# float32 baseline minus that; stall_ms is time the training loop blocked on
# an empty prefetch queue, producer_wait_ms the worker's wait on a full one.
# Several loaders' worker threads and the consumer add to it at once: every
# update holds the lock (a dict's += is a read, an add and a write).
_FEED_LOCK = threading.Lock()
FEED_COUNTERS: Dict[str, float] = {
    "batches_staged": 0,     # batches that crossed the host->device copy
    "wire_bytes": 0,         # bytes shipped (payload + scales)
    "bytes_saved": 0,        # float32-baseline bytes minus wire bytes
    "cache_hits": 0,         # batches served from the device cache
    "cache_misses": 0,
    "cache_rejects": 0,      # batches the cache budget refused to keep
    "stall_ms": 0.0,         # consumer blocked on an empty prefetch queue
    "producer_wait_ms": 0.0,  # worker blocked on a full queue (backpressure)
    "retries": 0,            # TRANSIENT source-read retries
}


def _feed_add(key: str, v) -> None:
    with _FEED_LOCK:
        FEED_COUNTERS[key] += v


def record_feed_stage(wire_bytes: int, full_bytes: int) -> None:
    """One batch staged over the wire (FeedCodec.stage)."""
    with _FEED_LOCK:
        FEED_COUNTERS["batches_staged"] += 1
        FEED_COUNTERS["wire_bytes"] += wire_bytes
        FEED_COUNTERS["bytes_saved"] += max(0, full_bytes - wire_bytes)


def record_feed_cache(event: str) -> None:
    """One cache lookup outcome: 'hit' / 'miss' / 'reject'."""
    _feed_add("cache_misses" if event == "miss" else f"cache_{event}s", 1)


def record_feed_stall(ms: float) -> None:
    """Consumer blocked on the prefetch queue for ``ms`` (AsyncLoader)."""
    _feed_add("stall_ms", ms)


def record_feed_wait(ms: float) -> None:
    """Producer backpressure wait (AsyncLoader worker, full queue)."""
    _feed_add("producer_wait_ms", ms)


def record_feed_retry() -> None:
    """One TRANSIENT source-read retry (MLSL_FEED_RETRIES)."""
    _feed_add("retries", 1)


def reset_feed_counters() -> None:
    with _FEED_LOCK:
        for k in FEED_COUNTERS:
            FEED_COUNTERS[k] = 0 if isinstance(FEED_COUNTERS[k], int) else 0.0


# Serving-engine accounting (serve/): process-wide like the feed counters --
# the engine admits requests from callers' threads with no Session handle.
# Statistics.print_ renders the totals as the SERVE ENGINE line.
SERVE_COUNTERS: Dict[str, float] = {
    "admitted": 0,        # requests accepted into the admission queue
    "rejected": 0,        # 429-style admission rejections
    "completed": 0,       # sequences that finished (eos or max_new_tokens)
    "failed": 0,          # sequences abandoned by a fault
    "prefills": 0,        # prefills run
    "decode_steps": 0,    # decode steps over the batch
    "tokens_out": 0,      # generated tokens over all sequences
    "retries": 0,         # TRANSIENT decode-step retries
    "kv_pages_alloc": 0,  # KV pages taken off the free-list
    "kv_pages_freed": 0,  # KV pages returned
    "kv_evictions": 0,    # sequences evicted to reclaim pages
    "kv_rejects": 0,      # admissions or extensions refused for want of pages
    "shed_batch": 0,      # SLA ladder: batch sheds (rung 1)
    "shed_precision": 0,  # SLA ladder: precision sheds (rung 2)
    "shed_admission": 0,  # SLA ladder: admission sheds (rung 3)
    "recoveries": 0,      # ladder steps back toward healthy
}


def record_serve(event: str, n: int = 1) -> None:
    """One serving-engine event (a ``SERVE_COUNTERS`` key)."""
    SERVE_COUNTERS[event] += n


def record_serve_shed(rung: str, detail: str = "") -> None:
    """One SLA-ladder transition ('batch' / 'precision' / 'admission' /
    'recovery'): counted, and appended at once to ``mlsl_stats.log`` as a
    SERVE line, so that the log shows when the engine degraded."""
    key = "recoveries" if rung == "recovery" else f"shed_{rung}"
    SERVE_COUNTERS[key] += 1
    try:
        with open(stats_path(), "a") as f:
            f.write(f"{'SERVE':<16} {rung.upper():<10} {detail}\n")
    except OSError:
        pass


def reset_serve_counters() -> None:
    for k in SERVE_COUNTERS:
        SERVE_COUNTERS[k] = 0 if isinstance(SERVE_COUNTERS[k], int) else 0.0


class _Slot:
    __slots__ = ("bytes", "comm_ns", "comp_ns", "events", "starts", "waits")

    def __init__(self):
        self.bytes = 0
        self.comm_ns = 0
        self.comp_ns = 0
        self.events = 0
        self.starts = 0
        self.waits = 0


def _entity_key(entity, is_param: bool, is_increment: bool) -> Tuple:
    if is_param:
        return ("INC" if is_increment else "GRAD", entity.param_index)
    return ("IA" if entity.is_input else "OA", entity.act_index)


class Statistics:
    def __init__(self, session):
        self.session = session
        self._started = False
        self._last_event_ns: Optional[int] = None
        self._slots: Dict[Tuple[int, Tuple], _Slot] = {}
        self._isolation_ns: Dict[int, int] = {}      # op_idx -> comm ns a round
        self._isolation_bytes: Dict[int, int] = {}
        # (op_idx, entity key) -> comm ns a round, for the overlap report
        self._isolation_slot_ns: Dict[Tuple[int, Tuple], int] = {}
        self.isolation_s = 0.0                       # wall seconds of the replay

    # -- lifecycle ---------------------------------------------------------

    def is_enabled(self) -> bool:
        cfg = self.session.env.config
        return bool(cfg is not None and cfg.enable_stats)

    def is_started(self) -> bool:
        return self._started

    def initialize(self) -> None:
        """Called at Commit: MLSL_STATS=1 starts accounting."""
        self._slots.clear()
        if self.is_enabled():
            self.start()

    def start(self) -> None:
        self._started = True
        self._last_event_ns = time.perf_counter_ns()

    def stop(self) -> None:
        self._started = False

    def reset(self) -> None:
        self._slots.clear()
        self._last_event_ns = time.perf_counter_ns()

    # -- online accounting -------------------------------------------------

    def _slot(self, op_idx: int, key: Tuple) -> _Slot:
        s = self._slots.get((op_idx, key))
        if s is None:
            s = self._slots[(op_idx, key)] = _Slot()
        return s

    def update(self, entity, action: str, is_param: bool, is_increment: bool) -> None:
        """Pre-events ('start', 'wait', 'test') charge the time since the
        last event to compute, post-events ('*_done') to comm; bytes count on
        start. A wait on an activation is charged to its peer's slot, whose
        request it completes."""
        if not self._started:
            return
        now = time.perf_counter_ns()
        delta = now - (self._last_event_ns or now)
        self._last_event_ns = now
        target = entity
        if (not is_param and action in ("wait", "wait_done")
                and getattr(entity, "peer_act", None) is not None):
            target = entity.peer_act
        slot = self._slot(target.op.op_idx, _entity_key(target, is_param, is_increment))
        if action.endswith("_done"):
            slot.comm_ns += delta
        else:
            slot.comp_ns += delta
        if action == "start":
            slot.starts += 1
            req = _entity_request(entity, is_param, is_increment)
            if req is not None:
                slot.bytes += req.desc.payload_bytes()
        elif action == "wait":
            slot.waits += 1
        slot.events += 1

    # -- the isolation replay ------------------------------------------------

    def collect_isolation_stats(self) -> None:
        """Replay every registered request with compute off (reference
        :387-562); ``isolation_s`` keeps the replay's wall seconds."""
        t0 = time.perf_counter()
        for op in self.session.operations:
            total_ns = total_bytes = 0
            for key, req in _op_request_slots(op):
                ns, nbytes = isolation_time_request(req)
                total_ns += ns
                total_bytes += nbytes
                self._isolation_slot_ns[(op.op_idx, key)] = ns
            self._isolation_ns[op.op_idx] = total_ns
            self._isolation_bytes[op.op_idx] = total_bytes
        self.isolation_s = time.perf_counter() - t0

    # -- overlap -------------------------------------------------------------

    def _overlap_slots(self):
        """(op_idx, true comm ns, exposed ns) per slot replayed in isolation
        and started online: true = isolation ns a round x starts, exposed =
        the online comm ns (the host blocked in Start/Wait/Test)."""
        for (oi, key), iso in self._isolation_slot_ns.items():
            slot = self._slots.get((oi, key))
            if slot is None or slot.starts == 0 or iso <= 0:
                continue
            yield oi, iso * slot.starts, slot.comm_ns

    def overlap_report(self) -> dict:
        """Hidden against exposed communication time, per operation (by name)
        and in total: hidden = max(0, true - exposed), overlap fraction =
        hidden / true (``Statistics.overlap_report``, stats.py:872-935)."""
        ops: Dict[str, dict] = {}
        tot_iso = tot_exposed = 0
        for op_idx, iso, exposed in self._overlap_slots():
            name = self.session.operations[op_idx].name
            ent = ops.setdefault(name, {"iso_ns": 0, "exposed_ns": 0})
            ent["iso_ns"] += iso
            ent["exposed_ns"] += exposed
            tot_iso += iso
            tot_exposed += exposed
        for ent in ops.values():
            ent["hidden_ns"] = max(0, ent["iso_ns"] - ent["exposed_ns"])
            ent["overlap_fraction"] = ent["hidden_ns"] / ent["iso_ns"]
        total = {
            "iso_ns": tot_iso,
            "exposed_ns": tot_exposed,
            "hidden_ns": max(0, tot_iso - tot_exposed),
            "overlap_fraction": (max(0, tot_iso - tot_exposed) / tot_iso
                                 if tot_iso > 0 else None),
        }
        return {"ops": ops, "total": total}

    def get_overlap_fraction(self, op_idx: Optional[int] = None) -> Optional[float]:
        """Fraction of the pure comm time hidden behind compute, for the
        session or one operation; None before an isolation replay and an
        accounted step."""
        iso = exposed = 0
        for oi, slot_iso, slot_exposed in self._overlap_slots():
            if op_idx is not None and oi != op_idx:
                continue
            iso += slot_iso
            exposed += slot_exposed
        return None if iso == 0 else max(0, iso - exposed) / iso

    # -- queries (reference include/mlsl.hpp:680-725) ----------------------

    def _sum(self, field: str, op_idx: Optional[int] = None) -> int:
        return sum(getattr(s, field) for (oi, _), s in self._slots.items()
                   if op_idx is None or oi == op_idx)

    def get_isolation_comm_cycles(self, op_idx: int) -> int:
        return self._isolation_ns.get(op_idx, 0)

    def get_comm_size(self, op_idx: int) -> int:
        """Bytes started by ``op_idx``'s requests."""
        return self._sum("bytes", op_idx)

    def get_comm_cycles(self, op_idx: int) -> int:
        return self._sum("comm_ns", op_idx)

    def get_compute_cycles(self, op_idx: int) -> int:
        return self._sum("comp_ns", op_idx)

    def get_start_count(self, op_idx: Optional[int] = None) -> int:
        return self._sum("starts", op_idx)

    def get_wait_count(self, op_idx: Optional[int] = None) -> int:
        return self._sum("waits", op_idx)

    def get_total_isolation_comm_cycles(self) -> int:
        return sum(self._isolation_ns.values())

    def get_total_comm_size(self) -> int:
        return self._sum("bytes")

    def get_total_comm_cycles(self) -> int:
        return self._sum("comm_ns")

    def get_total_compute_cycles(self) -> int:
        return self._sum("comp_ns")

    # -- the table (reference :226-363) --------------------------------------

    def print_(self, path: Optional[str] = None) -> str:
        """Append the table to ``path`` (default ``stats_path()``) and return
        it: the lines of the JAX package's ``print_`` for the counters this
        package keeps."""
        if path is None:
            path = stats_path()
        lines = []
        mb = max(self.session.global_minibatch_size, 1)
        lines.append(
            f"{'op':<16} {'entity':<8} {'KB':>12} {'comm Kns/img':>14} "
            f"{'comp Kns/img':>14} {'events':>8}"
        )
        for (op_idx, key), slot in sorted(self._slots.items()):
            op = self.session.operations[op_idx]
            lines.append(
                f"{op.name:<16} {key[0] + str(key[1]):<8} "
                f"{slot.bytes / 1024.0:>12.1f} {slot.comm_ns / 1e3 / mb:>14.2f} "
                f"{slot.comp_ns / 1e3 / mb:>14.2f} {slot.events:>8}"
            )
        for op_idx, ns in sorted(self._isolation_ns.items()):
            op = self.session.operations[op_idx]
            lines.append(
                f"{op.name:<16} {'ISOLATE':<8} "
                f"{self._isolation_bytes.get(op_idx, 0) / 1024.0:>12.1f} "
                f"{ns / 1e3 / mb:>14.2f} {'-':>14} {'-':>8}"
            )
        rep = self.overlap_report()
        if rep["total"]["overlap_fraction"] is not None:
            lines.append(
                f"{'OVERLAP':<16} {'TOTAL':<8} hidden "
                f"{rep['total']['hidden_ns'] / 1e3:>10.1f} Kns / iso "
                f"{rep['total']['iso_ns'] / 1e3:>10.1f} Kns = "
                f"{rep['total']['overlap_fraction']:.3f}"
            )
            for name, ent in sorted(rep["ops"].items()):
                lines.append(
                    f"{name:<16} {'OVERLAP':<8} hidden "
                    f"{ent['hidden_ns'] / 1e3:>10.1f} Kns / iso "
                    f"{ent['iso_ns'] / 1e3:>10.1f} Kns = "
                    f"{ent['overlap_fraction']:.3f}"
                )
        c = BUCKET_COUNTERS
        if c["rounds_dispatched"] or c["rounds_fallback"] or c["member_abandons"]:
            lines.append(
                f"{'BUCKET':<16} {'ROUNDS':<8} dispatched {c['rounds_dispatched']} "
                f"fallback {c['rounds_fallback']} abandoned {c['member_abandons']} "
                f"coalesced {c['bytes_coalesced'] / 1024.0:.1f} KB "
                f"wire_saved {c['wire_bytes_saved'] / 1024.0:.1f} KB"
            )
        fc = FEED_COUNTERS
        if (fc["batches_staged"] or fc["cache_hits"] or fc["cache_misses"]
                or fc["stall_ms"] or fc["retries"]):
            # a stall alone surfaces the line too: a plain AsyncLoader that
            # kept the training loop waiting is an input-bound run
            staged = max(int(fc["batches_staged"]), 1)
            lines.append(
                f"{'FEED':<16} {'PIPELINE':<8} "
                f"staged {int(fc['batches_staged'])} "
                f"wire {fc['wire_bytes'] / 1e6:.1f} MB "
                f"({fc['wire_bytes'] / 1e6 / staged:.2f} MB/batch) "
                f"saved {fc['bytes_saved'] / 1e6:.1f} MB "
                f"cache {int(fc['cache_hits'])}h/{int(fc['cache_misses'])}m/"
                f"{int(fc['cache_rejects'])}r "
                f"stall {fc['stall_ms']:.1f} ms "
                f"bp_wait {fc['producer_wait_ms']:.1f} ms "
                f"retries {int(fc['retries'])}"
            )
        if ALGO_COUNTERS:
            parts = [f"{kind}:{algo}={n}" for (kind, algo), n in sorted(ALGO_COUNTERS.items())]
            lines.append(f"{'ALGO':<16} {'DISPATCH':<8} " + " ".join(parts))
        oc = OVERLAP_COUNTERS
        if oc["steps"]:
            lines.append(
                f"{'OVERLAP':<16} {'ENGINE':<8} "
                f"steps {oc['steps']} (split {oc['split_steps']}) "
                f"units {oc['units']} rounds {oc['rounds']} "
                f"bytes {oc['bytes'] / 1e6:.1f} MB"
            )
        sc = SENTINEL_COUNTERS
        if any(sc.values()):
            # one grep ('SENTINEL') answers "did this run's state stay
            # trustworthy"
            lines.append(
                f"{'SENTINEL':<16} {'GATE':<8} "
                f"screened {sc['screened']} "
                f"warn {sc['gate_warn']} skip {sc['gate_skip']} "
                f"rollback {sc['gate_rollback']} audits {sc['audits']} "
                f"mismatch {sc['audit_mismatch']} "
                f"verified_saves {sc['verified_saves']} "
                f"reaudits {sc['reaudits']}"
            )
        xc = CODEC_COUNTERS
        if any(xc.values()) or CODEC_WIRE_BYTES:
            wire = " ".join(f"{name}={n}" for name, n in sorted(CODEC_WIRE_BYTES.items()))
            lines.append(
                f"{'CODEC':<16} {'LAB':<8} "
                f"calibrations {xc['calibrations']} "
                f"assignments {xc['assignments']} "
                f"breaches {xc['guard_breaches']} "
                f"demotions {xc['demotions']}"
                + (f" wire_bytes {wire}" if wire else "")
            )
            for row in CODEC_DEMOTIONS:
                lines.append(f"{'CODEC':<16} {'DEMOTE':<8} {row}")
        vc = SERVE_COUNTERS
        if any(vc.values()):
            lines.append(
                f"{'SERVE':<16} {'ENGINE':<10} "
                f"admitted {int(vc['admitted'])} "
                f"rejected {int(vc['rejected'])} "
                f"completed {int(vc['completed'])} "
                f"failed {int(vc['failed'])} "
                f"tokens {int(vc['tokens_out'])} "
                f"steps {int(vc['decode_steps'])} "
                f"retries {int(vc['retries'])} "
                f"kv {int(vc['kv_pages_alloc'])}a/{int(vc['kv_pages_freed'])}f/"
                f"{int(vc['kv_evictions'])}e/{int(vc['kv_rejects'])}r "
                f"sheds {int(vc['shed_batch'])}b/{int(vc['shed_precision'])}p/"
                f"{int(vc['shed_admission'])}a "
                f"recoveries {int(vc['recoveries'])}"
            )
        kc = CHKP_COUNTERS
        if any(kc.values()):
            lines.append(
                f"{'CHKP':<16} {'BUFFERS':<8} checks {kc['checks']} "
                f"violations {kc['violations']} "
                f"value_checks {kc['value_checks']} "
                f"value_syncs {kc['value_syncs']}"
            )
        gc = STRAGGLER_COUNTERS
        if any(gc.values()):
            lines.append(
                f"{'STRAGGLER':<16} {'SKEW':<8} "
                f"audits {gc['audits']} flags {gc['flags']} "
                f"sheds {gc['sheds']} "
                f"shed_fallbacks {gc['shed_fallbacks']}"
            )
        dc = DEGRADE_COUNTERS
        if any(dc.values()) or DEGRADE_FALLBACKS:
            # the ladder summary: every trip, probe, reset, retry and degraded
            # dispatch of this run, and the breakers that left CLOSED
            from mlsl_tpu_torch import supervisor  # lazy: supervisor imports stats

            states = " ".join(
                f"{name}:{st['state']}"
                for name, st in supervisor.status().items()
                if "state" in st
                and (st["state"] == "tripped" if name == "sentinel"
                     else st["state"] == "shrunk" if name == "elastic"
                     else st["state"] == "flagged" if name == "straggler"
                     else bool(st.get("dead")) or st.get("evicted")
                     if name == "control"
                     else st["state"] not in ("off", "healthy")
                     if name == "serve"
                     else st.get("trips") or st["state"] != supervisor.CLOSED)
            )
            fb = " ".join(f"{name}={n}" for name, n in sorted(DEGRADE_FALLBACKS.items()))
            lines.append(
                f"{'DEGRADE':<16} {'LADDER':<8} retries {dc['comm_retries']} "
                f"trips {dc['breaker_trips']} probes {dc['breaker_probes']} "
                f"resets {dc['breaker_resets']} "
                f"recoveries {dc['recoveries']}"
                + (f" fallbacks {fb}" if fb else "")
                + (f" breakers {states}" if states else "")
            )
        text = "\n".join(lines) + "\n"
        try:
            with open(path, "a") as f:
                f.write(text)
        except OSError:
            pass
        return text

    # PascalCase parity aliases
    Start = start
    Stop = stop
    Reset = reset
    IsStarted = is_started
    IsEnabled = is_enabled
    Print = print_
    GetIsolationCommCycles = get_isolation_comm_cycles
    GetCommSize = get_comm_size
    GetCommCycles = get_comm_cycles
    GetComputeCycles = get_compute_cycles
    GetTotalIsolationCommCycles = get_total_isolation_comm_cycles
    GetTotalCommSize = get_total_comm_size
    GetTotalCommCycles = get_total_comm_cycles
    GetTotalComputeCycles = get_total_compute_cycles
    OverlapReport = overlap_report
    GetOverlapFraction = get_overlap_fraction


# -- helpers -----------------------------------------------------------------


def _entity_request(entity, is_param: bool, is_increment: bool):
    if is_param:
        return entity.inc_req if is_increment else entity.grad_req
    return entity.comm_req


def _op_request_slots(op) -> List[Tuple[Tuple, object]]:
    """(entity key, request) for every registered request of one operation,
    keyed as the online slots are."""
    out = []
    for act in op.inputs + op.outputs:
        if act.comm_req is not None:
            out.append((("IA" if act.is_input else "OA", act.act_index), act.comm_req))
    for ps in op.parameter_sets:
        if ps.grad_req is not None:
            out.append((("GRAD", ps.param_index), ps.grad_req))
        if ps.inc_req is not None:
            out.append((("INC", ps.param_index), ps.inc_req))
    return out


def isolation_time_request(req) -> Tuple[int, int]:
    """(ns a round, payload bytes) of one request alone, on a zero buffer:
    host ``perf_counter_ns`` around Start + Wait, the stream synchronized on
    the card."""
    import torch

    from mlsl_tpu_torch.types import torch_dtype

    d = req.desc
    topo = d.group.topology
    dev = req.dispatcher.device
    buf = torch.zeros((*topo.grid_shape, max(d.send_len(), 1)),
                      dtype=torch_dtype(d.data_type), device=dev)
    cuda = dev is not None and dev.type == "cuda"
    times = []
    for _ in range(ISOLATION_ITERS):
        t0 = time.perf_counter_ns()
        req.start(buf)
        req.wait()
        if cuda:
            torch.cuda.current_stream(dev).synchronize()
        times.append(time.perf_counter_ns() - t0)
    good = times[ISOLATION_SKIP:]
    return int(sum(good) / max(len(good), 1)), d.payload_bytes()
