"""Runtime lock witness: the dynamic half of the A21x concurrency suite.

Counterpart of ``mlsl_tpu.analysis.witness``, by adapted copy. The port's
named locks: ``serve.engine``, ``supervisor.breaker.<name>`` and
``supervisor.registry``.

TSan-lite: ``MLSL_LOCK_WITNESS=1`` routes the named locks of the threaded
subsystems (supervisor breakers, the pod control plane, the serving engine,
the elastic registry) through an instrumented wrapper that records, per
thread, the set of witness locks held and, globally, every acquisition-order
edge (lock A held while acquiring lock B). A new edge that closes a cycle in
the order graph is a *witnessed* potential deadlock — the dynamic
confirmation (or refutation) of a static A210 finding. Releases are timed
against a hold budget (``MLSL_LOCK_WITNESS_BUDGET_MS``): an over-budget hold
is the runtime shadow of A211 (something slow ran inside the critical
section).

Disarmed (the default) the factories return plain ``threading`` primitives —
zero wrappers, zero overhead, nothing to misreport. The arming check runs at
*creation* time: subsystems create their locks in ``__init__``/import, so a
soak run arms the environment variable before building the stack
(scripts/run_soak.sh does).

Findings surface three ways: ``report()`` (the agreement tests),
``core/stats`` ``LOCKWITNESS`` counters (the ``lockwitness`` metrics family
exported by ``obs/metrics``), and an optional JSONL sink
(``MLSL_LOCK_WITNESS_SINK``) for post-mortem soak forensics.

stdlib-only, like the rest of ``analysis/``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

ENV_ARM = "MLSL_LOCK_WITNESS"
ENV_BUDGET_MS = "MLSL_LOCK_WITNESS_BUDGET_MS"
ENV_SINK = "MLSL_LOCK_WITNESS_SINK"

#: default hold budget: generous for test boxes under load — the witness
#: flags *pathological* holds (I/O, sleeps, dispatch), not slow Python
_DEFAULT_BUDGET_MS = 250.0

# -- global witness state (guarded by a PLAIN lock: the witness must not
# -- witness itself) ---------------------------------------------------------

_guard = threading.Lock()
#: acquisition-order edges: (held name, acquired name) -> first-seen info
_edges: Dict[Tuple[str, str], dict] = {}
#: cycles found (each recorded once, keyed by its canonical node tuple)
_cycles: Dict[Tuple[str, ...], dict] = {}
#: over-budget holds: lock name -> worst observed
_over_budget: Dict[str, dict] = {}
#: per-thread stack of held witness-lock names
_tls = threading.local()


#: the live Environment's Config (:func:`configure`): its
#: ``lock_witness`` and ``lock_witness_budget_ms`` are read at each use
_config = None


def configure(config=None) -> None:
    """Read the knobs from ``config`` (``Environment.init`` hands over its
    own, ``finalize`` takes it back with ``None``); without one, from the
    environment variables."""
    global _config
    _config = config


def armed() -> bool:
    """Whether lock creation routes through the witness *right now*: the
    live Config's ``lock_witness`` or MLSL_LOCK_WITNESS."""
    if _config is not None and _config.lock_witness:
        return True
    return os.environ.get(ENV_ARM, "") in ("1", "true", "yes", "on")


def _budget_s() -> float:
    if _config is not None:
        return float(_config.lock_witness_budget_ms) / 1e3
    try:
        return float(os.environ.get(ENV_BUDGET_MS, _DEFAULT_BUDGET_MS)) / 1e3
    except ValueError:
        return _DEFAULT_BUDGET_MS / 1e3


def _held_stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _record_stat(event: str, detail: str = "") -> None:
    try:
        from mlsl_tpu_torch.core import stats as stats_mod

        stats_mod.record_lock_witness(event, detail)
    except Exception:  # mlsl-lint: disable=A205 -- witness must survive a
        pass           # bare pre-commit env without the stats stack


def _sink(kind: str, payload: dict) -> None:
    path = os.environ.get(ENV_SINK, "")
    if not path:
        return
    try:
        with open(path, "a") as f:
            f.write(json.dumps({"kind": kind, **payload}) + "\n")
    except OSError:
        pass


def _find_cycle(start: str, target: str) -> Optional[List[str]]:
    """DFS: a path start -> ... -> target in the edge graph (caller holds
    ``_guard``). Adding edge (target, start) would close the cycle."""
    adj: Dict[str, Set[str]] = {}
    for a, b in _edges:
        adj.setdefault(a, set()).add(b)
    stack = [(start, [start])]
    seen = set()
    while stack:
        node, path = stack.pop()
        if node == target:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in sorted(adj.get(node, ())):
            stack.append((nxt, path + [nxt]))
    return None


def _note_acquired(name: str) -> None:
    """Called after the inner lock is taken (first acquisition only for
    reentrant locks)."""
    stack = _held_stack()
    tname = threading.current_thread().name
    if stack:
        held = stack[-1]
        edge = (held, name)
        with _guard:
            fresh = edge not in _edges
            if fresh:
                _edges[edge] = {"thread": tname, "at": time.time()}
                # does name -> ... -> held already exist? then held -> name
                # closes a cycle: two threads can take them in opposite order
                path = _find_cycle(name, held)
                if path is not None:
                    cyc = path + [name]
                    key = tuple(sorted(set(cyc)))
                    if key not in _cycles:
                        _cycles[key] = {
                            "cycle": cyc, "thread": tname,
                            "at": time.time(),
                        }
                        fresh_cycle = dict(_cycles[key])
                    else:
                        fresh_cycle = None
                else:
                    fresh_cycle = None
            else:
                fresh_cycle = None
        if fresh:
            _record_stat("edges_observed", f"{held}->{name}")
        if fresh_cycle is not None:
            _record_stat("cycles_detected",
                         "->".join(fresh_cycle["cycle"]))
            _sink("cycle", fresh_cycle)
    stack.append(name)
    _record_stat("acquisitions")


def _note_released(name: str, held_s: float) -> None:
    stack = _held_stack()
    if name in stack:
        stack.reverse()
        stack.remove(name)   # innermost occurrence
        stack.reverse()
    if held_s > _budget_s():
        info = {"lock": name, "held_ms": round(held_s * 1e3, 3),
                "budget_ms": round(_budget_s() * 1e3, 3),
                "thread": threading.current_thread().name}
        with _guard:
            worst = _over_budget.get(name)
            if worst is None or info["held_ms"] > worst["held_ms"]:
                _over_budget[name] = info
        _record_stat("over_budget_holds",
                     f"{name} held {info['held_ms']:.1f}ms")
        _sink("over_budget", info)


class WitnessLock:
    """An instrumented ``Lock``/``RLock``: records held-sets, order edges,
    and hold times. Presents the full acquire/release/context protocol so
    ``threading.Condition`` can wrap it."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        # per-thread reentry depth + first-acquire stamp
        self._depth = threading.local()

    # -- lock protocol ----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            d = getattr(self._depth, "n", 0)
            if d == 0:
                self._depth.t0 = time.monotonic()
                _note_acquired(self.name)
            self._depth.n = d + 1
        return got

    def release(self) -> None:
        d = getattr(self._depth, "n", 0)
        if d <= 1:
            self._depth.n = 0
            held_s = time.monotonic() - getattr(self._depth, "t0",
                                                time.monotonic())
            _note_released(self.name, held_s)
        else:
            self._depth.n = d - 1
        self._inner.release()

    def __enter__(self) -> "WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked() if hasattr(self._inner, "locked") \
            else getattr(self._depth, "n", 0) > 0

    # threading.Condition introspection hooks (RLock only)
    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"<WitnessLock {self.name} reentrant={self.reentrant}>"


def named_lock(name: str):
    """A ``threading.Lock`` — or a :class:`WitnessLock` when the witness is
    armed at creation time."""
    if armed():
        return WitnessLock(name, reentrant=False)
    return threading.Lock()


def named_rlock(name: str):
    if armed():
        return WitnessLock(name, reentrant=True)
    return threading.RLock()


def named_condition(name: str, lock=None):
    """A ``threading.Condition`` over a witnessed (or supplied) lock."""
    if lock is None and armed():
        lock = WitnessLock(name, reentrant=True)
    return threading.Condition(lock)


# -- reporting ---------------------------------------------------------------


def report() -> dict:
    """Snapshot of everything witnessed so far (the agreement tests and the
    soak forensics read this)."""
    with _guard:
        return {
            "armed": armed(),
            "edges": {f"{a}->{b}": dict(v)
                      for (a, b), v in sorted(_edges.items())},
            "cycles": [dict(v) for _, v in sorted(_cycles.items())],
            "over_budget": {k: dict(v)
                            for k, v in sorted(_over_budget.items())},
        }


def reset() -> None:
    """Clear witnessed state (tests; thread-local held stacks clear as their
    threads release)."""
    with _guard:
        _edges.clear()
        _cycles.clear()
        _over_budget.clear()
