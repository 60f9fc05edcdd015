"""Fault-tolerant training: checkpoint-backed recovery and preemption.

Counterpart of ``mlsl_tpu.resilience``, by adapted copy. The reference is
fail-stop (SURVEY.md §5.3). :class:`FaultTolerantLoop` checkpoints on a
cadence (async, ``checkpoint.py``), catches recoverable failures, tears the
Environment down, rebuilds the trainer through a user factory, restores the
newest verified checkpoint and resumes; with the elastic mesh armed a
DEVICE_LOSS shrinks to the survivor ranks instead (``elastic.py``), and a
pod control plane's committed losses and drain decisions arrive here
(``control/``). Each step it calls the trainer's integrity sentinel
(``sentinel.maybe_audit``), records the passing audit's fingerprint in every
checkpoint's manifest and re-audits after a restore; a confirmed straggler is
handed to the elastic coordinator (``_maybe_shed_straggler``).

The loop waits for the card at the end of each step (``torch.cuda.synchronize``
where the trainer runs on one), as the JAX loop blocks on its parameters. A
kernel that cannot be built or launched (``MLSLKernelError``, classed FATAL)
is never recovered by a restart or a reshard: it raises out of the loop, and
no plain version serves in its place.
"""

from __future__ import annotations

import contextlib
import signal
import threading
import time as _time
from typing import Callable, Optional

from mlsl_tpu_torch import supervisor
from mlsl_tpu_torch.checkpoint import CheckpointManager, restore_trainer, save_trainer
from mlsl_tpu_torch.elastic import _sync
from mlsl_tpu_torch.log import (
    MLSLError,
    MLSLIntegrityError,
    MLSLKernelError,
    log_error,
    log_info,
    log_warning,
)
from mlsl_tpu_torch.obs import tracer as obs


# MLSLError subclasses RuntimeError; ValueError is deliberately NOT recoverable
# (caller bugs should surface, not trigger teardown/rebuild cycles).
# MLSLTimeoutError (the request watchdog) is RuntimeError too: a hung
# collective tears down and resumes like any other device fault.
RECOVERABLE = (RuntimeError,)

_NULL_GUARD = contextlib.nullcontext()


class PreemptionGuard:
    """SIGTERM -> graceful drain: the handler only sets a flag; the training
    loop checks it between steps, drains in-flight async saves, writes a final
    checkpoint, and returns — the pod preemption contract (the reference's
    signal handlers just killed the endpoint servers, SURVEY §5.3).

    Installed only on the main thread (CPython restricts signal.signal);
    elsewhere it degrades to an inert flag the embedder can set directly."""

    SIGNALS = (signal.SIGTERM,)

    def __init__(self):
        self.triggered = False
        self._old: dict = {}
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self.SIGNALS:
                self._old[s] = signal.signal(s, self._on_signal)
            self._installed = True
        return self

    def _on_signal(self, signum, frame) -> None:
        # async-signal context: flag only, no IO beyond the (line-buffered) log
        self.triggered = True
        log_warning(
            "received signal %d: draining saves and checkpointing before exit",
            signum,
        )

    def __exit__(self, *exc) -> None:
        if self._installed:
            for s, h in self._old.items():
                signal.signal(s, h)
            self._installed = False


class FaultTolerantLoop:
    """Supervised training loop with checkpoint/restore recovery.

    make_trainer: factory returning a fresh trainer (called at start and after
        every recovery — it must re-create the Environment/Session/Distribution).
    batch_fn(trainer, step) -> batch: MUST be step-deterministic — recovery
        replays every step since the last checkpoint (not just the failed one),
        and exact resume depends on replaying the same data.
    save_every: checkpoint cadence in steps (also the maximum replay window).
    max_retries: failures tolerated AT THE SAME STEP before re-raising (guards
        against deterministic poison even when the resume point is several steps
        behind the failure).
    max_total_recoveries: the restart budget — checkpoint recoveries across
        the WHOLE run (rung 4 of the supervisor ladder; the lower rungs —
        comm retries and circuit breakers, mlsl_tpu_torch.supervisor — absorb what
        they can before a failure ever reaches this loop). None reads
        ``MLSL_RESTART_BUDGET`` (default 20). Exhausting it aborts with a
        flight record (tracing armed) and the breaker status in the log.
    on_step fires exactly once per step: replayed steps below the furthest
        reported step are recomputed silently.
    fault_hook(step, attempt): optional test hook, called before each step attempt;
        raise from it to inject a fault (the chaos layer, mlsl_tpu_torch.chaos, injects
        at specific sites INSIDE the stack instead — use it for layer faults).
    handle_preemption: install a SIGTERM handler for the duration of run()
        (main thread only): on signal the loop finishes the current step,
        drains in-flight saves, writes a final checkpoint, and returns early
        with ``self.preempted`` set.
    elastic: an :class:`mlsl_tpu_torch.elastic.ElasticCoordinator` (None constructs
        one when ``MLSL_ELASTIC`` arms it). With a coordinator, DEVICE_LOSS
        faults (preemption, the chaos ``device.lost`` site) take the reshard
        rung — shrink to the survivor mesh, re-shard ZeRO-1 state live, and
        CONTINUE at the interrupted step with no checkpoint restore and no
        recovery counted — and returned capacity is re-admitted between
        steps through the sentinel fingerprint admission audit
        (``maybe_grow``). A failed/refused reshard (capacity budget, drain
        failure) falls back to this loop's restart rung. Elastic factories
        must size their Distribution from ``env.get_process_count()``.
    """

    def __init__(
        self,
        make_trainer: Callable,
        ckpt_dir: str,
        save_every: int = 10,
        max_retries: int = 2,
        max_total_recoveries: Optional[int] = None,
        fault_hook: Optional[Callable] = None,
        handle_preemption: bool = True,
        elastic: Optional[object] = None,
    ):
        self.make_trainer = make_trainer
        self.ckpt = CheckpointManager(ckpt_dir)
        self.save_every = max(1, save_every)
        self.max_retries = max_retries
        # bound on recoveries across the whole run: a flaky fault that lands on a
        # DIFFERENT step each cycle resets the per-step count, and without this
        # cap the loop would recover/replay forever
        if max_total_recoveries is None:
            # through Config's parser/default so the knob is defined in
            # exactly one place, with the init-time MLSLError contract
            from mlsl_tpu_torch.config import Config, _env_int

            try:
                max_total_recoveries = _env_int(
                    "MLSL_RESTART_BUDGET", Config.restart_budget
                )
            except ValueError as e:
                raise MLSLError(f"invalid MLSL_RESTART_BUDGET: {e}") from e
            if max_total_recoveries < 0:
                raise MLSLError(
                    f"MLSL_RESTART_BUDGET must be >= 0 "
                    f"(got {max_total_recoveries})"
                )
        self.max_total_recoveries = max_total_recoveries
        self.fault_hook = fault_hook
        self.handle_preemption = handle_preemption
        self.preempted = False
        self.recoveries = 0
        self.elastic = elastic
        self._arm_elastic_if_configured()

    def _arm_elastic_if_configured(self) -> None:
        """Auto-arm the coordinator from the live config (which Config.load
        folds MLSL_ELASTIC into) or, with no initialized Environment, from
        the env var alone. Called at __init__ AND again at run() after the
        factory built the trainer: the documented pattern constructs the
        loop BEFORE any Environment exists, so a programmatic
        Config(elastic=True) is only visible post-init."""
        if self.elastic is not None:
            return
        from mlsl_tpu_torch import elastic as elastic_mod
        from mlsl_tpu_torch.core.environment import Environment

        cfg = (Environment._instance.config
               if Environment.is_initialized() else None)
        if elastic_mod.armed(cfg):  # cfg None -> MLSL_ELASTIC fallback
            self.elastic = elastic_mod.ElasticCoordinator()

    def _recover(self, trainer, error) -> tuple:
        """Tear down, rebuild, restore. -> (trainer, resume_step)."""
        self.recoveries += 1
        tr = obs._tracer
        t0 = tr.now() if tr is not None else 0
        log_info("recovering from %s: %s", type(error).__name__, error)
        from mlsl_tpu_torch.core import stats as stats_mod

        # rung-4 accounting: the recovery lands in the same DEGRADE record
        # as breaker trips, so mlsl_stats.log tells the whole ladder's story
        stats_mod.record_degrade(
            "loop", "recover",
            detail=f"#{self.recoveries}/{self.max_total_recoveries} "
                   f"{type(error).__name__}: {error}",
        )
        # drain in-flight async saves first: restoring from a half-committed step
        # (or re-saving a step whose original write is still in flight) corrupts
        # the resume point
        try:
            self.ckpt.wait()
        except Exception as e:
            # suppressed (the restore below decides what is usable) but logged:
            # an invisible drain failure makes the eventual double-fault
            # undiagnosable
            log_warning(
                "checkpoint drain during recovery failed: %s: %s",
                type(e).__name__, e,
            )
        from mlsl_tpu_torch.core.environment import Environment

        try:
            Environment.get_env().finalize()
        except Exception as e:
            # teardown of an already-faulted environment may fail; continue to
            # the rebuild, but keep the evidence
            log_warning(
                "environment teardown during recovery failed "
                "(continuing with rebuild): %s: %s",
                type(e).__name__, e,
            )
        trainer = self.make_trainer()
        restored = restore_trainer(self.ckpt, trainer)
        # Post-restore re-audit (integrity sentinel): a rollback answering a
        # CORRUPTION fault must PROVE the restored state is the verified one
        # — replicas consistent AND the fingerprint bit-exact against what
        # the manifest recorded at save time. A failure here means even the
        # rollback substrate is compromised; surface it rather than resume.
        sent = getattr(trainer, "sentinel", None)
        if sent is not None and restored is not None:
            res = sent.audit_now(trainer, step=restored)
            stats_mod.record_sentinel("reaudits")
            want = self.ckpt.recorded_fingerprint(restored)
            if not res.equal or (want is not None and res.digest != want):
                raise MLSLIntegrityError(
                    f"post-restore re-audit failed at step {restored}: "
                    f"replicas_equal={res.equal}, digest "
                    f"{res.digest[:16]} vs recorded "
                    f"{(want or '<unverified>')[:16]} — the restored "
                    "checkpoint does not reproduce its verified state"
                ) from error
            log_info(
                "post-restore re-audit passed at step %d (digest %s%s)",
                restored, res.digest[:16],
                ", matches manifest" if want is not None else "",
            )
        if tr is not None:
            # one span per recovery cycle: drain + teardown + rebuild +
            # restore — on the timeline this is the gap a fault cost the run
            tr.complete("recover", "resilience", t0,
                        error=type(error).__name__, recovery=self.recoveries,
                        resumed_step=restored if restored is not None else -1)
        return trainer, (restored + 1 if restored is not None else 0)

    def _warn_if_sentinel_unwired(self, trainer) -> None:
        """MLSL_SENTINEL_* armed but the trainer type carries no sentinel
        (only DataParallelTrainer is wired): say so LOUDLY — an
        operator who exported the knobs believes the integrity layer is on,
        and a silent no-op is exactly the failure mode this subsystem
        exists to eliminate."""
        if getattr(trainer, "sentinel", None) is not None:
            return
        from mlsl_tpu_torch import sentinel as sentinel_mod
        from mlsl_tpu_torch.core.environment import Environment

        env = Environment._instance
        cfg = env.config if env is not None else None
        if cfg is not None and sentinel_mod.armed(cfg):
            log_warning(
                "MLSL_SENTINEL_* is armed but %s carries no integrity "
                "sentinel — gates, audits, and verified checkpoints are "
                "INACTIVE for this run (sentinel wiring currently covers "
                "DataParallelTrainer only)", type(trainer).__name__,
            )

    def _maybe_shed_straggler(self, trainer, step: int):
        """Between-steps poll of the trainer's straggler sentinel
        (obs/straggler.py): a confirmed straggler with ``MLSL_STRAGGLER_SHED``
        armed is handed to the elastic coordinator as a synthetic device
        loss (``ElasticCoordinator.shed``) — measurement closed into action.
        A refused/failed shed (capacity budget, mapping failure) logs and
        keeps the full world: shedding a slow replica is an optimization,
        never worth availability. Returns the (possibly shrunk) trainer."""
        strag = getattr(trainer, "straggler", None)
        if strag is None or self.elastic is None:
            return trainer
        cand = strag.shed_candidate()
        if cand is None:
            return trainer
        try:
            new_trainer = self.elastic.shed(
                trainer, self.make_trainer, replica=cand, step=step
            )
        except Exception as e:
            log_warning(
                "straggler shed of replica %s refused (%s: %s); continuing "
                "on the full world", cand, type(e).__name__, e,
            )
            strag.clear_candidate()
            return trainer
        strag.clear_candidate()
        return new_trainer

    def _abort(self, step: int, error: BaseException, why: str) -> None:
        """The ladder's last rung is exhausted: every retry and breaker
        fallback failed to absorb this fault, and ``why`` names the bound
        that actually stopped the loop (same-step retry bound vs run-wide
        restart budget — a post-mortem must point at the right knob).
        Leave maximal evidence — the error's class, the breaker states, and
        (when tracing is armed) a flight record of the trailing timeline —
        then the caller re-raises. Never raises itself: the original error
        must surface, not an abort-path artifact."""
        try:
            cls = supervisor.classify(error)
            status = supervisor.status()
            states = {
                # breaker-shaped entries only: 'analysis' (verdict-shaped),
                # 'elastic' (mesh-shaped, 'full'/'shrunk'), 'straggler'
                # ('off'/'watching'/'flagged') and 'control' (membership-
                # shaped, 'off'/'member'/'leader') have their own stats
                # lines and their own fields below — not breakers
                name: st["state"]
                for name, st in status.items()
                if "state" in st
                and name not in ("elastic", "straggler", "control")
            }
            log_error(
                "recovery ladder exhausted at step %d (%s; %d/%d recoveries "
                "spent): %s: %s [class=%s] breakers=%s elastic=%s "
                "straggler=%s",
                step, why, self.recoveries, self.max_total_recoveries,
                type(error).__name__, error, cls.value, states,
                status.get("elastic", {}).get("state", "?"),
                status.get("straggler", {}).get("state", "?"),
            )
            if obs._tracer is not None:
                from mlsl_tpu_torch.obs import export as obs_export

                path = obs_export.flight_record(
                    window_s=60.0,
                    reason=f"{why} at step {step}: "
                           f"{type(error).__name__}: {error}",
                )
                if path:
                    log_warning("abort flight record written: %s", path)
        except Exception as e:  # pragma: no cover - defensive (abort path)
            log_warning("abort diagnostics failed: %s: %s", type(e).__name__, e)

    def run(self, batch_fn: Callable, steps: int, on_step: Optional[Callable] = None):
        """Train for ``steps`` steps; returns the final trainer.

        Returns early (with ``self.preempted`` set and a final checkpoint on
        disk) when a handled preemption signal arrives mid-run."""
        trainer = self.make_trainer()
        self._arm_elastic_if_configured()  # the factory just ran env init
        self._warn_if_sentinel_unwired(trainer)
        restored = restore_trainer(self.ckpt, trainer)
        step = restored + 1 if restored is not None else 0
        # retry accounting is keyed to the step that failed: resuming several
        # steps behind the failure must not reset the count (deterministic
        # poison would otherwise livelock through recover/replay cycles)
        failed_step = None
        attempts = 0
        reported = step - 1  # on_step fires once per step, replays stay silent
        last_saved = restored
        self.preempted = False
        # pod control plane (mlsl_tpu_torch.control): committed membership losses
        # surface HERE, on the dispatch thread, as the device-loss error the
        # reshard rung below absorbs — the control threads only queue (the
        # A202 contract). Pod-level elastic decisions (grow re-admission,
        # straggler shed) are re-homed behind the elected leader; followers
        # apply committed epochs instead of originating them.
        from mlsl_tpu_torch import control as control_mod

        plane = control_mod.get_active()
        guard = PreemptionGuard() if self.handle_preemption else None
        with guard if guard is not None else _NULL_GUARD:
            while step < steps:
                try:
                    if plane is not None:
                        pod_fault = plane.take_loss()
                        if pod_fault is not None:
                            raise pod_fault
                    if self.elastic is not None and (
                        plane is None or plane.may_decide()
                    ):
                        # between-steps growth poll: returned capacity is
                        # re-admitted (through the fingerprint admission
                        # audit) before the step runs; failures route
                        # through the standard ladder below
                        trainer = self.elastic.maybe_grow(
                            trainer, self.make_trainer, step
                        )
                    if self.fault_hook is not None:
                        self.fault_hook(
                            step, attempts if step == failed_step else 0
                        )
                    _t0 = _time.monotonic()
                    loss = trainer.step(batch_fn(trainer, step))
                    _sync(trainer)
                    if plane is not None:
                        # publish this member's health + step clock for the
                        # next heartbeat frame (host-read scalars only)
                        plane.push_status(
                            supervisor.status(), step=step,
                            step_ms=(_time.monotonic() - _t0) * 1e3,
                        )
                    sent = getattr(trainer, "sentinel", None)
                    if sent is not None:
                        # cadence audit (MLSL_SENTINEL_EVERY): divergence
                        # raises MLSLIntegrityError -> the recovery path
                        # below, where restore prefers verified steps
                        sent.maybe_audit(trainer, step)
                    # straggler shed poll (obs/straggler.py): a confirmed
                    # slow replica becomes a synthetic DEVICE_LOSS through
                    # the elastic coordinator; failures keep the full world.
                    # Leader-only in a pod: a shed is a pod-level decision.
                    if plane is None or plane.may_decide():
                        trainer = self._maybe_shed_straggler(trainer, step)
                    if step % self.save_every == 0:
                        # inside the try: a device fault surfacing during the save's
                        # device read must take the recovery path too
                        fp = None
                        if sent is not None:
                            # audit at the checkpoint boundary: a passing
                            # digest marks the step VERIFIED in its manifest;
                            # divergence raises instead of poisoning the
                            # checkpoint history
                            fp = sent.checkpoint_fingerprint(trainer, step)
                        save_trainer(self.ckpt, trainer, step=step,
                                     fingerprint=fp)
                        last_saved = step
                except RECOVERABLE as e:
                    if isinstance(e, MLSLKernelError):
                        # a kernel that cannot be built or launched is never
                        # answered by a replay or a reshard
                        self._abort(step, e, "kernel error (FATAL)")
                        raise
                    if (
                        self.elastic is not None
                        and supervisor.classify(e)
                        is supervisor.ErrorClass.DEVICE_LOSS
                    ):
                        # the reshard rung: shrink to the survivor mesh and
                        # CONTINUE at this very step — the failed step never
                        # applied its update, so the loss trajectory stays
                        # continuous with zero checkpoint restores and no
                        # recovery spent. A refused/failed shrink (capacity
                        # budget, drain failure) falls through to restart.
                        try:
                            trainer = self.elastic.shrink(
                                trainer, self.make_trainer, error=e,
                                step=step,
                            )
                        except MLSLKernelError:
                            raise
                        except Exception as ee:
                            log_warning(
                                "elastic reshard failed (%s: %s); device "
                                "loss falls back to the restart rung",
                                type(ee).__name__, ee,
                            )
                        else:
                            continue
                    if step == failed_step:
                        attempts += 1
                    else:
                        failed_step, attempts = step, 1
                    if (
                        attempts > self.max_retries
                        or self.recoveries >= self.max_total_recoveries
                    ):
                        self._abort(
                            step, e,
                            "same-step retry bound exceeded"
                            if attempts > self.max_retries
                            else "restart budget exhausted",
                        )
                        raise
                    trainer, step = self._recover(trainer, e)
                    last_saved = step - 1 if step > 0 else None
                    continue
                if on_step is not None and step > reported:
                    on_step(step, loss)
                    reported = step
                # pod drain decisions arrive out-of-band (the leader
                # broadcasts one verdict per noticed rank): consume any
                # pending one; a shrink aimed at ANOTHER rank is the
                # survivors' business (their loss event reshards the mesh)
                drain = plane.take_drain() if plane is not None else None
                if (
                    guard is not None and guard.triggered
                    and drain is None and plane is not None
                ):
                    # coordinated drain: submit the SIGTERM as a structured
                    # notice and wait (bounded) for the pod's ONE decision;
                    # a timeout (partitioned leader) falls back to the
                    # local drain below rather than hanging the grace window
                    drain = plane.coordinate_preemption("sigterm")
                if (guard is not None and guard.triggered) or (
                    drain is not None
                    and (drain["mode"] == "save"
                         or drain["rank"] == plane.rank)
                ):
                    # drain in-flight saves and leave a final resume point; a
                    # failure here must not abort the graceful exit — the last
                    # cadence checkpoint remains the resume point
                    self.preempted = True
                    if obs._tracer is not None:
                        obs._tracer.instant("preemption", "resilience",
                                            step=step)
                    try:
                        if last_saved != step:
                            log_info(
                                "preemption: writing final checkpoint at step %d",
                                step,
                            )
                            sent = getattr(trainer, "sentinel", None)
                            save_trainer(
                                self.ckpt, trainer, step=step, wait=True,
                                fingerprint=(
                                    sent.checkpoint_fingerprint(trainer, step)
                                    if sent is not None else None
                                ),
                            )
                        self.ckpt.wait()
                        log_info(
                            "preemption drain complete; stopping at step %d", step
                        )
                    except Exception as e:
                        log_warning(
                            "preemption drain failed (%s: %s); resume point is "
                            "the last committed checkpoint",
                            type(e).__name__, e,
                        )
                    if plane is not None:
                        plane.record_drain_executed(
                            step, drain["mode"] if drain is not None
                            else "local",
                        )
                    break
                step += 1
        self.ckpt.wait()
        return trainer
