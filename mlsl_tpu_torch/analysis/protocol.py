"""Explicit-state protocol model checker: the A15x rule family.

Counterpart of ``mlsl_tpu.analysis.protocol``, by copy: the models mirror
``mlsl_tpu_torch/control/plane.py``, whose membership, fence and drain rules
are the JAX package's line for line, and ``mlsl_tpu_torch/elastic.py``, so
both packages explore the same states and reach the same verdicts.

The control plane and the elastic coordinator are
distributed state machines — membership epochs fenced by leadership,
preemption notices retried toward a moving leader, drain verdicts that must
survive the decider's own death. Runtime tests sample a handful of
interleavings; this pass enumerates *all* of them over small declarative
models of those protocols and checks the safety properties the runtime
story depends on:

- **A150** reachable deadlock: a state with no enabled transition that the
  model does not accept as a completed run.
- **A151** invariant violation (the flagship: *dual coordinator* — two live
  ranks simultaneously holding committed leadership at the same epoch).
- **A152** lost drain-ack: a completed run in which a preemption notice was
  raised by a still-live rank but its drain never reached the acked state.
- **A153** (warn) exploration truncated at the state/depth bound: the
  verdict covers only the explored prefix.

Models are *mirrors*, not imports: they re-state the commit/fence/drain
rules of ``control/plane.py`` (leadership = lowest surviving rank; a commit
is applied iff its epoch is strictly newer AND its sender is the lowest
rank net of the removals it carries; notices are re-sent toward the
current leader view until a drain is ordered; drain acks are re-sent until
acknowledged) in ~40 lines of transition function. Keeping them here keeps
``analysis/`` import-light (the ``static_accounting``-next-to-the-kernel
precedent was considered and rejected: plane.py must not import a model
checker); the cross-check is the fixture suite pinning each code plus the
commit-gate run proving the SHIPPED models safe.

Wired at ``Session.commit`` next to the A1xx plan verifier (same
``MLSL_VERIFY`` gate, same ``plan.enforce`` severity behavior), and into
``python -m mlsl_tpu_torch.analysis --concurrency``. The exploration result is
memoized process-wide: the models are constants, so one exhaustive run per
process covers every commit.

stdlib-only, like the rest of ``analysis/``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from mlsl_tpu_torch.analysis.diagnostics import Report

ENV_MAX_STATES = "MLSL_PROTOCOL_MAX_STATES"
ENV_MAX_DEPTH = "MLSL_PROTOCOL_MAX_DEPTH"

#: exhaustive-exploration bounds: the shipped models reach quiescence well
#: inside both (the stated bound the acceptance story quotes); a model that
#: hits either reports A153 and the verdict covers only the prefix
DEFAULT_MAX_STATES = 200_000
DEFAULT_MAX_DEPTH = 64


class Model:
    """A small declarative protocol model.

    ``transitions(state) -> [(label, next_state)]`` (self-loops are ignored
    by the explorer); ``invariant(state)`` returns ``None`` or
    ``(code, message)``; ``done(state)`` says whether a transition-free
    state is an accepted completed run; ``quiescence(state)`` runs extra
    checks on completed runs and returns ``None`` or ``(code, message)``.
    States must be hashable.
    """

    def __init__(self, name: str, initial: Iterable,
                 transitions: Callable,
                 invariant: Optional[Callable] = None,
                 done: Optional[Callable] = None,
                 quiescence: Optional[Callable] = None):
        self.name = name
        self.initial = list(initial)
        self.transitions = transitions
        self.invariant = invariant or (lambda s: None)
        self.done = done or (lambda s: True)
        self.quiescence = quiescence or (lambda s: None)


def _trace(parents: Dict, state) -> str:
    """Reconstruct the (label) path from an initial state, newest last."""
    labels: List[str] = []
    while True:
        got = parents.get(state)
        if got is None:
            break
        state, label = got
        labels.append(label)
    labels.reverse()
    if len(labels) > 12:
        labels = labels[:4] + [f"... {len(labels) - 8} steps ..."] + \
            labels[-4:]
    return " -> ".join(labels) if labels else "<initial>"


def explore(model: Model,
            max_states: Optional[int] = None,
            max_depth: Optional[int] = None) -> Report:
    """Exhaustive BFS over ``model``'s reachable states. Every finding is
    anchored ``model:<name>`` with a counterexample trace in the message."""
    if max_states is None:
        max_states = int(os.environ.get(ENV_MAX_STATES, DEFAULT_MAX_STATES))
    if max_depth is None:
        max_depth = int(os.environ.get(ENV_MAX_DEPTH, DEFAULT_MAX_DEPTH))
    rep = Report("protocol")
    anchor = f"model:{model.name}"
    visited = set(model.initial)
    frontier = list(model.initial)
    parents: Dict = {}
    depth = 0
    truncated = False
    # one report per code keeps the output readable; every violating state
    # would otherwise repeat the same story
    seen_codes = set()

    def emit(code: str, message: str, state) -> None:
        if code in seen_codes:
            return
        seen_codes.add(code)
        rep.add(code, f"{message} [trace: {_trace(parents, state)}]", anchor)

    while frontier:
        if depth >= max_depth:
            truncated = True
            break
        nxt: List = []
        for s in frontier:
            viol = model.invariant(s)
            if viol is not None:
                emit(viol[0], viol[1], s)
            moves = [(lb, t2) for lb, t2 in model.transitions(s) if t2 != s]
            if not moves:
                if not model.done(s):
                    emit("A150",
                         "reachable deadlock: no transition enabled and the "
                         "run is not complete", s)
                else:
                    q = model.quiescence(s)
                    if q is not None:
                        emit(q[0], q[1], s)
                continue
            for label, t in moves:
                if t in visited:
                    continue
                if len(visited) >= max_states:
                    truncated = True
                    break
                visited.add(t)
                parents[t] = (s, label)
                nxt.append(t)
        frontier = nxt
        depth += 1
    if truncated:
        rep.add("A153",
                f"exploration truncated at {len(visited)} states / depth "
                f"{depth} (bounds: {max_states} states, {max_depth} deep): "
                "the verdict covers only the explored prefix", anchor)
    rep.explored_states = len(visited)   # type: ignore[attr-defined]
    rep.explored_depth = depth           # type: ignore[attr-defined]
    return rep


# ---------------------------------------------------------------------------
# The shipped models
# ---------------------------------------------------------------------------

_RANKS = (0, 1, 2)

# membership/drain state:
# (crashed fs, epochs 3-tuple, removed 3-tuple of fs, detected 3-tuple of
#  fs, msgs fs, notice_rank, drain_state, crash_budget)
# drain_state: 0 notice unserved / 1 drain ordered / 2 drained locally
#              (ack in flight) / 3 acked. -1 = no notice in this run.
_D_NONE, _D_UNSERVED, _D_ORDERED, _D_DRAINED, _D_ACKED = -1, 0, 1, 2, 3


def _leader_view(state, r: int) -> int:
    """plane.py's candidate rule: the lowest rank not removed or locally
    suspected."""
    _, _, removed, detected, _, _, _, _ = state
    alive_known = [p for p in _RANKS
                   if p not in removed[r] and p not in detected[r]]
    return min(alive_known) if alive_known else r


def _committed_leader(state, r: int) -> int:
    """Leadership by committed membership only (the A151 invariant uses
    this: commits are what carries authority)."""
    _, _, removed, _, _, _, _, _ = state
    alive = [p for p in _RANKS if p not in removed[r]]
    return min(alive) if alive else r


def _membership_transitions(state) -> List[Tuple[str, tuple]]:
    (crashed, epochs, removed, detected, msgs, notice_rank, drain,
     budget) = state
    out: List[Tuple[str, tuple]] = []
    live = [r for r in _RANKS if r not in crashed]

    def repl(seq, i, v):
        t = list(seq)
        t[i] = v
        return tuple(t)

    # 1. crash (at most `budget` in a run)
    if budget > 0:
        for r in live:
            out.append((f"crash({r})",
                        (crashed | {r}, epochs, removed, detected, msgs,
                         notice_rank, drain, budget - 1)))
    # 2. heartbeat-miss detection: a live rank locally suspects a corpse
    for p in live:
        for c in crashed:
            if c in detected[p] or c in removed[p]:
                continue
            out.append((f"detect({p},{c})",
                        (crashed, epochs, removed,
                         repl(detected, p, detected[p] | {c}), msgs,
                         notice_rank, drain, budget)))
    # 3. act on detection: the view-leader commits the loss epoch (the
    #    barrier's corroborated union — in-model every detection IS
    #    corroborated); a non-leader's proposal is subsumed by the
    #    leader's own detection transition
    for p in live:
        pend = detected[p] - removed[p]
        if not pend:
            continue
        if _leader_view(state, p) != p:
            continue
        new_removed = removed[p] | pend
        new_epoch = epochs[p] + 1
        commit_msgs = msgs | {
            ("commit", p, q, (new_epoch, frozenset(new_removed)))
            for q in _RANKS if q != p
        }
        out.append((f"commit({p},e{new_epoch})",
                    (crashed, repl(epochs, p, new_epoch),
                     repl(removed, p, new_removed),
                     repl(detected, p, detected[p] - new_removed),
                     commit_msgs, notice_rank, drain, budget)))
    # 4. preemption notice: re-sent toward the current leader view until a
    #    drain is ordered (plane retries next tick; the target moves as
    #    deaths are detected)
    if drain == _D_UNSERVED and notice_rank not in crashed:
        tgt = _leader_view(state, notice_rank)
        m = ("notice", notice_rank, tgt, None)
        if m not in msgs:
            out.append((f"send_notice({notice_rank}->{tgt})",
                        (crashed, epochs, removed, detected, msgs | {m},
                         notice_rank, drain, budget)))
    # 4b. drain-ack re-send (the heartbeat-carried status): until acked,
    #     the drained rank keeps telling its current leader view
    if drain == _D_DRAINED and notice_rank not in crashed:
        tgt = _leader_view(state, notice_rank)
        m = ("drained", notice_rank, tgt, None)
        if m not in msgs:
            out.append((f"resend_drained({notice_rank}->{tgt})",
                        (crashed, epochs, removed, detected, msgs | {m},
                         notice_rank, drain, budget)))
    # 5. message delivery (any order; delivery to a corpse consumes the
    #    frame — TCP to a dead host is an error at the sender, the retry
    #    is modeled by the re-send transitions above)
    for m in msgs:
        kind, src, dst, data = m
        rest = msgs - {m}
        if dst in crashed:
            out.append((f"lose({kind}->{dst})",
                        (crashed, epochs, removed, detected, rest,
                         notice_rank, drain, budget)))
            continue
        if kind == "commit":
            e, rem = data
            # plane._fence: strictly newer epoch AND the sender must lead
            # the world net of the removals it announces
            if e > epochs[dst] and src == min(set(_RANKS) - rem):
                out.append((f"apply_commit({dst},e{e})",
                            (crashed, repl(epochs, dst, e),
                             repl(removed, dst, frozenset(rem)),
                             repl(detected, dst, detected[dst] - rem),
                             rest, notice_rank, drain, budget)))
            else:
                out.append((f"reject_commit({dst},e{e})",
                            (crashed, epochs, removed, detected, rest,
                             notice_rank, drain, budget)))
        elif kind == "notice":
            nd = _D_ORDERED if drain == _D_UNSERVED else drain
            extra = ({("drain", dst, notice_rank, None)}
                     if drain == _D_UNSERVED else set())
            out.append((f"decide_drain({dst})",
                        (crashed, epochs, removed, detected, rest | extra,
                         notice_rank, nd, budget)))
        elif kind == "drain":
            nd = _D_DRAINED if drain == _D_ORDERED else drain
            extra = ({("drained", dst, _leader_view(state, dst), None)}
                     if drain == _D_ORDERED else set())
            out.append((f"execute_drain({dst})",
                        (crashed, epochs, removed, detected, rest | extra,
                         notice_rank, nd, budget)))
        elif kind == "drained":
            nd = _D_ACKED if drain in (_D_DRAINED, _D_ORDERED) else drain
            out.append((f"ack_drain({dst})",
                        (crashed, epochs, removed, detected, rest,
                         notice_rank, nd, budget)))
    return out


def _membership_invariant(state):
    crashed, epochs, removed, _, _, _, _, _ = state
    leaders = [r for r in _RANKS if r not in crashed
               and _committed_leader(state, r) == r]
    for i, a in enumerate(leaders):
        for b in leaders[i + 1:]:
            if epochs[a] == epochs[b]:
                return ("A151",
                        f"dual coordinator: ranks {a} and {b} both hold "
                        f"committed leadership at epoch {epochs[a]}")
    return None


def _membership_done(state) -> bool:
    crashed, epochs, removed, detected, msgs, notice_rank, drain, _ = state
    if msgs:
        return False
    live = [r for r in _RANKS if r not in crashed]
    if not live:
        return True
    # converged membership: every survivor agrees, and agrees with reality
    if any(removed[r] != frozenset(crashed) for r in live):
        return False
    if any(epochs[r] != epochs[live[0]] for r in live):
        return False
    if any(detected[r] - removed[r] for r in live):
        return False
    return True


def _membership_quiescence(state):
    crashed, _, _, _, _, notice_rank, drain, _ = state
    if notice_rank >= 0 and notice_rank not in crashed \
            and drain != _D_ACKED:
        return ("A152",
                f"lost drain-ack: rank {notice_rank}'s preemption notice "
                f"ended the run at drain state {drain} (never acked by a "
                "live coordinator)")
    return None


def membership_drain_model() -> Model:
    """The control-plane membership/heartbeat/drain mirror: 3 ranks, at
    most one crash, at most one preemption notice per run."""
    empty = frozenset()
    base = (frozenset(), (0, 0, 0), (empty,) * 3, (empty,) * 3,
            frozenset(), _D_NONE, _D_NONE, 1)
    inits = [base]
    for r in _RANKS:
        inits.append((frozenset(), (0, 0, 0), (empty,) * 3, (empty,) * 3,
                      frozenset(), r, _D_UNSERVED, 1))
    return Model("control.membership_drain", inits,
                 _membership_transitions,
                 invariant=_membership_invariant,
                 done=_membership_done,
                 quiescence=_membership_quiescence)


# elastic shrink/grow state:
# (world, cap, op, audit_fails) — op: '' | 'shrink' | 'grow'
def _elastic_transitions(state) -> List[Tuple[str, tuple]]:
    world, cap, op, fails = state
    out: List[Tuple[str, tuple]] = []
    if op == "":
        if world > 1:
            out.append(("device_loss", (world, cap, "shrink", fails)))
        if world < cap:
            out.append(("grow_request", (world, cap, "grow", 0)))
    elif op == "shrink":
        out.append(("reshard_commit", (world - 1, cap, "", fails)))
    elif op == "grow":
        # the admit audit can pass, fail-then-retry once, or abandon
        out.append(("admit_pass", (world + 1, cap, "", 0)))
        if fails < 1:
            out.append(("admit_fail_retry", (world, cap, "grow", fails + 1)))
        out.append(("admit_abandon", (world, cap, "", 0)))
    return out


def _elastic_invariant(state):
    world, cap, _, _ = state
    if world < 1 or world > cap:
        return ("A151",
                f"elastic world size {world} outside [1, {cap}]: the "
                "capacity budget / last-replica floor was violated")
    return None


def elastic_model() -> Model:
    """The elastic coordinator mirror: capacity-bounded shrink/grow with a
    bounded admit-audit retry. Every state with an in-flight op can finish
    it, so the model is deadlock-free by the A150 check (quiescent states
    are the op=='' ones, all accepted)."""
    return Model("elastic.shrink_grow", [(3, 3, "", 0)],
                 _elastic_transitions,
                 invariant=_elastic_invariant,
                 done=lambda s: s[2] == "")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

#: process-wide memo: the models are constants, one exhaustive run covers
#: every commit in the process (the <5%-of-commit overhead bound)
_memo: Dict[Tuple[int, int], Report] = {}


def check_protocols(max_states: Optional[int] = None,
                    max_depth: Optional[int] = None) -> Report:
    """Explore every shipped model; one combined 'protocol' report."""
    if max_states is None:
        max_states = int(os.environ.get(ENV_MAX_STATES, DEFAULT_MAX_STATES))
    if max_depth is None:
        max_depth = int(os.environ.get(ENV_MAX_DEPTH, DEFAULT_MAX_DEPTH))
    key = (max_states, max_depth)
    got = _memo.get(key)
    if got is not None:
        return got
    rep = Report("protocol")
    explored = []
    states = depth = 0
    for model in (membership_drain_model(), elastic_model()):
        sub = explore(model, max_states, max_depth)
        rep.extend(sub)
        states += sub.explored_states
        depth = max(depth, sub.explored_depth)
        explored.append(
            f"{model.name}: {sub.explored_states} states / depth "
            f"{sub.explored_depth}")
    rep.explored = "; ".join(explored)       # type: ignore[attr-defined]
    rep.explored_states = states             # type: ignore[attr-defined]
    rep.explored_depth = depth               # type: ignore[attr-defined]
    _memo[key] = rep
    return rep


def reset() -> None:
    """Drop the memoized verdict (tests that vary the bounds)."""
    _memo.clear()


def run_commit_protocol_check(session) -> Report:
    """Session.commit's protocol-model entry point: same MLSL_VERIFY gate
    and severity behavior as the A1xx plan verifier."""
    from mlsl_tpu_torch.analysis.plan import enforce

    cfg = session.env.config
    t0 = time.perf_counter()
    return enforce(check_protocols(), cfg,
                   "control/elastic protocol models at commit", t0)
