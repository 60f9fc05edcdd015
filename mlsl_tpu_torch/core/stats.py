"""Per-session communication counters.

The core of ``mlsl_tpu.core.stats``: the counters that ``Session._stat_event``
feeds (session.py:440) -- starts, waits and bytes per request, keyed by
operation and parameter set -- and the process-wide counters of the dispatch
layer: bucket rounds of gradient bucketing (stats.py:131-175), launches per
(kind, algorithm) and the compiled overlap engine's steps (stats.py:640-695).
The JAX package's ``mlsl_stats.log`` table and the isolation replay at
commit come later.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# Bucket-round accounting (core/bucketing.py): process-wide, as in the JAX
# package -- buckets fire from the request layer with no Session handle. The
# JAX package's event ring and wire-saved estimate are left out: nothing here
# reads them.
BUCKET_COUNTERS: Dict[str, int] = {
    "rounds_dispatched": 0,   # full rounds served by one coalesced dispatch
    "rounds_fallback": 0,     # early-Wait rounds run as individual requests
    "member_abandons": 0,     # members restarted mid-flight (ran individually)
    "bytes_coalesced": 0,     # member payload bytes carried by bucket rounds
}


def record_bucket_round(event: str, members: int = 0, coalesced: int = 0) -> None:
    """Called by GradBucket at every round transition (dispatch, early-Wait
    fallback, member-restart abandon)."""
    if event == "dispatched":
        BUCKET_COUNTERS["rounds_dispatched"] += 1
        BUCKET_COUNTERS["bytes_coalesced"] += coalesced
    elif event == "fallback":
        BUCKET_COUNTERS["rounds_fallback"] += 1
    else:  # abandon
        BUCKET_COUNTERS["member_abandons"] += max(members, 1)


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


class _Slot:
    __slots__ = ("starts", "waits", "tests", "bytes")

    def __init__(self):
        self.starts = 0
        self.waits = 0
        self.tests = 0
        self.bytes = 0


def _entity_key(entity, is_param: bool, is_increment: bool) -> Tuple:
    if is_param:
        return ("param", entity.param_index, bool(is_increment))
    return ("act", entity.act_index, bool(entity.is_input))


class Statistics:
    def __init__(self, session):
        self.session = session
        self._started = False
        self._slots: Dict[int, Dict[Tuple, _Slot]] = {}

    def is_enabled(self) -> bool:
        cfg = self.session.env.config
        return bool(cfg is not None and cfg.enable_stats)

    def is_started(self) -> bool:
        return self._started

    def initialize(self) -> None:
        """Called at Commit: MLSL_STATS=1 starts accounting."""
        if self.is_enabled():
            self.start()

    def start(self) -> None:
        self._started = True

    def stop(self) -> None:
        self._started = False

    def reset(self) -> None:
        self._slots.clear()

    def _slot(self, op_idx: int, key: Tuple) -> _Slot:
        per_op = self._slots.setdefault(op_idx, {})
        s = per_op.get(key)
        if s is None:
            s = per_op[key] = _Slot()
        return s

    def update(self, entity, action: str, is_param: bool, is_increment: bool) -> None:
        slot = self._slot(entity.op.op_idx, _entity_key(entity, is_param, is_increment))
        if action == "start":
            slot.starts += 1
            req = entity.inc_req if is_increment else entity.grad_req
            if req is not None:
                slot.bytes += req.desc.payload_bytes()
        elif action == "wait":
            slot.waits += 1
        elif action == "test":
            slot.tests += 1

    def _total(self, field: str, op_idx: Optional[int] = None) -> int:
        ops = [op_idx] if op_idx is not None else list(self._slots)
        return sum(getattr(s, field)
                   for o in ops for s in self._slots.get(o, {}).values())

    def get_start_count(self, op_idx: Optional[int] = None) -> int:
        return self._total("starts", op_idx)

    def get_wait_count(self, op_idx: Optional[int] = None) -> int:
        return self._total("waits", op_idx)

    def get_comm_size(self, op_idx: int) -> int:
        """Bytes started by ``op_idx``'s requests."""
        return self._total("bytes", op_idx)

    def get_total_comm_size(self) -> int:
        return self._total("bytes")

    # PascalCase parity aliases
    IsEnabled = is_enabled
    IsStarted = is_started
    Start = start
    Stop = stop
    Reset = reset
    GetCommSize = get_comm_size
    GetTotalCommSize = get_total_comm_size
