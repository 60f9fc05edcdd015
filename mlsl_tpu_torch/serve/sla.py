"""SLA governor: the degradation ladder at SLO granularity.

Counterpart of ``mlsl_tpu.serve.sla`` (which imports no JAX), adapted to the
port. Under sustained queue growth or a p99 TPOT breach the engine sheds
work in a fixed order, and takes it back rung by rung once the pressure
clears:

    healthy -> shed_batch -> shed_precision -> shed_admission

- **shed_batch** halves the continuous batch's slot ceiling: fewer sequences
  a decode step, a shorter step.
- **shed_precision** runs the decode step in bf16 (the KV at rest keeps its
  dtype): on the card a second captured graph, as the JAX engine compiles a
  second program.
- **shed_admission** closes the front door: ``submit()`` rejects 429-style
  with a retry-after hint while the queue drains. The engine itself never
  dies.

Escalation needs ``breach_ticks`` consecutive pressured scheduler ticks;
recovery needs ``recover_ticks`` clear ticks a rung (hysteresis). A
straggler signal counts as pressure (``observe(straggler=True)``); the port
has no straggler sentinel yet (ROADMAP A.7), so only a caller sets it.

Every transition is recorded through ``stats.record_serve_shed`` (an
immediate SERVE line in ``mlsl_stats.log``). :func:`status` is what the JAX
package's ``supervisor.status()`` reports; the port's supervisor has no
``status()`` yet (A.7).
"""

from __future__ import annotations

import collections
from typing import List, Optional

from mlsl_tpu_torch.log import MLSLError, log_warning

#: ladder rungs, in shed order; index = rung number
RUNGS = ("healthy", "shed_batch", "shed_precision", "shed_admission")


class ServeOverloadError(MLSLError):
    """429-style admission rejection: the engine is shedding load (full
    queue or an SLA ladder at the admission rung). ``retry_after_s`` is the
    client backoff hint — the request was never admitted, retrying after
    the hint is safe and expected."""

    def __init__(self, msg: str, retry_after_s: float = 0.5):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class SLAGovernor:
    """The ladder state machine. The engine calls :meth:`observe` with queue
    depth / per-step decode latency / straggler signals, then :meth:`tick`
    once per scheduler iteration; :attr:`batch_limit`,
    :attr:`precision_shed` and :attr:`admission_open` are the levers the
    engine reads back. :meth:`force_shed` is the fault path (a classified
    decode failure escalates immediately — no breach accumulation)."""

    def __init__(self, *, max_batch: int, queue_depth: int,
                 tpot_p99_ms: float = 0.0, breach_ticks: int = 3,
                 recover_ticks: int = 16, window: int = 64,
                 queue_frac: float = 0.75, retry_after_s: float = 0.5):
        self.max_batch = int(max_batch)
        self.queue_depth = int(queue_depth)
        #: p99 decode-step budget in ms (0 = no latency SLO, queue-only)
        self.tpot_p99_ms = float(tpot_p99_ms)
        self.breach_ticks = int(breach_ticks)
        self.recover_ticks = int(recover_ticks)
        self.queue_frac = float(queue_frac)
        self.retry_after_s = float(retry_after_s)
        self.rung = 0
        self.sheds = 0
        self.recoveries = 0
        self.last_reason = ""
        self._tpot: collections.deque = collections.deque(maxlen=int(window))
        self._queue = 0
        self._straggler = False
        self._hot = 0
        self._cool = 0

    # -- inputs ------------------------------------------------------------

    def observe(self, *, queue_len: Optional[int] = None,
                tpot_ms: Optional[float] = None,
                straggler: Optional[bool] = None) -> None:
        if queue_len is not None:
            self._queue = int(queue_len)
        if tpot_ms is not None:
            self._tpot.append(float(tpot_ms))
        if straggler is not None:
            self._straggler = bool(straggler)

    def p99_tpot_ms(self) -> Optional[float]:
        """p99 over the recent decode-step window (None below 8 samples —
        an unjudgeable tail must not shed)."""
        if len(self._tpot) < 8:
            return None
        vals: List[float] = sorted(self._tpot)
        return vals[min(len(vals) - 1, int(0.99 * len(vals)))]

    # -- the ladder --------------------------------------------------------

    def _pressure(self) -> Optional[str]:
        if self._queue > self.queue_frac * self.queue_depth:
            return f"queue {self._queue}/{self.queue_depth}"
        if self._straggler:
            return "straggler flagged"
        p99 = self.p99_tpot_ms()
        if self.tpot_p99_ms > 0 and p99 is not None and p99 > self.tpot_p99_ms:
            return f"p99 TPOT {p99:.1f} ms > {self.tpot_p99_ms:.1f} ms"
        return None

    def tick(self) -> int:
        """Evaluate pressure once per scheduler iteration; maybe transition.
        Returns the current rung."""
        reason = self._pressure()
        if reason is not None:
            self._cool = 0
            self._hot += 1
            if self._hot >= self.breach_ticks and self.rung < len(RUNGS) - 1:
                self._shed(reason)
        else:
            self._hot = 0
            self._cool += 1
            if self._cool >= self.recover_ticks and self.rung > 0:
                self._recover()
        return self.rung

    def force_shed(self, reason: str) -> None:
        """Immediate escalation (classified decode fault): the engine skips
        the breach accumulation — a replica loss is not a trend."""
        if self.rung < len(RUNGS) - 1:
            self._shed(reason)

    def _shed(self, reason: str) -> None:
        self.rung += 1
        self._hot = 0
        self._cool = 0
        self.sheds += 1
        self.last_reason = reason
        from mlsl_tpu_torch.core import stats

        stats.record_serve_shed(
            ("batch", "precision", "admission")[self.rung - 1],
            f"-> {RUNGS[self.rung]} ({reason})",
        )
        log_warning("serve SLA shed -> %s (%s)", RUNGS[self.rung], reason)

    def _recover(self) -> None:
        self.rung -= 1
        self._cool = 0
        self.recoveries += 1
        from mlsl_tpu_torch.core import stats

        stats.record_serve_shed("recovery", f"-> {RUNGS[self.rung]}")
        log_warning("serve SLA recovery -> %s", RUNGS[self.rung])

    # -- the levers --------------------------------------------------------

    @property
    def batch_limit(self) -> int:
        """Continuous-batching slot ceiling at the current rung."""
        return self.max_batch if self.rung < 1 else max(1, self.max_batch // 2)

    @property
    def precision_shed(self) -> bool:
        return self.rung >= 2

    @property
    def admission_open(self) -> bool:
        return self.rung < 3

    def status(self) -> dict:
        """The ladder's status as a JSON-serializable dict."""
        p99 = self.p99_tpot_ms()
        return {
            "state": RUNGS[self.rung],
            "rung": self.rung,
            "batch_limit": self.batch_limit,
            "queue": self._queue,
            "queue_depth": self.queue_depth,
            "p99_tpot_ms": round(p99, 3) if p99 is not None else None,
            "sheds": self.sheds,
            "recoveries": self.recoveries,
            "reason": self.last_reason,
        }


# -- module registry (status() and tests) -------------------------------------

_active: Optional[SLAGovernor] = None


def _set_active(g: Optional[SLAGovernor]) -> None:
    global _active
    _active = g


def get_active() -> Optional[SLAGovernor]:
    return _active


def reset() -> None:
    """Drop the active governor (tests)."""
    _set_active(None)


def status() -> dict:
    """The active engine's ladder status, ``{"state": "off"}`` when no engine
    is live."""
    if _active is None:
        return {"state": "off"}
    return _active.status()
