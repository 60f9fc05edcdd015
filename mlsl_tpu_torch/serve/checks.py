"""Checks of a serving engine against its references, shared by
``chip_smoke.py`` and the card tests (``cuda_tests/test_serve.py``).

- :class:`Probe` watches an engine without changing what it computes: the
  logits each request's tokens were picked from, when each token was picked,
  each prefill's span and each decode step's host time.
- :func:`oracle_rule` -- the card's rule against the unpaged oracle. On the
  card the paged and unpaged programs sum their products in other orders
  (cuBLAS takes another algorithm for a 2,048-row prefill than for a
  few-row decode step, and the bf16 products round after it), so their
  logits differ in the last bits and the JAX package's bit-exact token
  contract cannot hold. The rule runs the oracle on the engine's own token
  stream and holds every step's logits within ``delta`` of the oracle's.
  Where the engine's token is not the oracle's top one, the oracle's margin
  between the two is then at most ``2 * delta``: the streams may part only
  at near-ties, and every step after a parting is held all the same.
- :func:`decode_twin` -- the decode step's graph replay against the same
  step run eagerly from the same pools.
- :func:`planted` -- a deliberately wrong engine, to show that the rule
  fails it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from mlsl_tpu_torch.serve.engine import oracle_generate


class Probe:
    """Watches one engine: ``logits[req.id]`` the host logits each token was
    picked from (only for the ids in ``keep``, all when it is None),
    ``stamps[req.id]`` the host clock (``time.monotonic``) when each token
    was picked, ``prefills`` each prefill's (start, end) and ``step_ms``
    each decode step's host milliseconds (what the SLA governor observes)."""

    def __init__(self, eng, keep=None):
        self.keep = keep
        self.logits: Dict[int, List[np.ndarray]] = {}
        self.stamps: Dict[int, List[float]] = {}
        self.prefills: List[Tuple[float, float]] = []
        self.step_ms: List[float] = []
        pick, observe, prefill = eng._pick, eng.governor.observe, eng._prefill_seq

        def keep_pick(logits, reqs):
            now = time.monotonic()
            for i, r in enumerate(reqs):
                self.stamps.setdefault(r.id, []).append(now)
                if self.keep is None or r.id in self.keep:
                    self.logits.setdefault(r.id, []).append(np.array(logits[i]))
            return pick(logits, reqs)

        def seen(**kw):
            if kw.get("tpot_ms") is not None:
                self.step_ms.append(kw["tpot_ms"])
            return observe(**kw)

        def timed_prefill(*args, **kw):
            t0 = time.monotonic()
            try:
                return prefill(*args, **kw)
            finally:
                self.prefills.append((t0, time.monotonic()))

        eng._pick, eng.governor.observe, eng._prefill_seq = keep_pick, seen, timed_prefill

    def gaps(self, ids) -> Tuple[List[float], List[bool]]:
        """The host milliseconds between consecutive tokens of each request
        in ``ids``, and for each gap whether a prefill started inside it
        (continuous batching stalls every live sequence for a joining
        request's prefill)."""
        starts = np.sort(np.asarray([s for s, _ in self.prefills], np.float64))
        ms, stalled = [], []
        for i in ids:
            t = self.stamps.get(i, [])
            for a, b in zip(t, t[1:]):
                ms.append((b - a) * 1e3)
                lo, hi = np.searchsorted(starts, [a, b], side="right")
                stalled.append(bool(hi > lo))
        return ms, stalled


def oracle_rule(eng, req, logits: List[np.ndarray], delta: float) -> dict:
    """The card's rule for one finished request (module docstring), given
    the logits the engine picked its tokens from. -> a record: ``ok``, the
    largest |logit - oracle logit| over every step, the first step where the
    engine's token is not the oracle's top one (None if there is none), the
    oracle's margin there, and the count of such steps."""
    tokens = [int(t) for t in req.tokens]
    top, want = oracle_generate(eng, req.prompt, len(tokens), follow=tokens,
                                return_logits=True)
    worst = max(float(np.abs(np.asarray(a, np.float64) - b).max())
                for a, b in zip(logits, want))
    differ = [j for j, (t, o) in enumerate(zip(tokens, top)) if t != o]
    first: Optional[int] = differ[0] if differ else None
    margin = (float(want[first][top[first]] - want[first][tokens[first]])
              if differ else None)
    return {"request": req.id, "ok": len(want) == len(tokens) and worst <= delta,
            "max_abs_delta": worst, "first_differing_step": first, "margin": margin,
            "differing_steps": len(differ), "of": len(tokens)}


def decode_twin(eng):
    """One decode step of the live batch as the graph's replay and run
    eagerly from the same pools. -> (graph logits, eager logits, on the live
    slots; whether every pool page but the garbage page 0 came out equal;
    the live slots). Page 0 takes every inactive slot's write, in an order
    ``index_put_`` leaves open. As a step does, a slot whose write crosses
    into a new page gets that page first: else it too would write page 0 and
    read back whichever write ``index_put_`` kept. The pools are left as the
    eager step wrote them."""
    import torch

    from mlsl_tpu_torch.core import graph_capture

    eng._ensure_capacity()
    live, arrays = eng._batch()
    dtype = "bfloat16" if eng.governor.precision_shed else eng.cfg.dtype
    args = [torch.from_numpy(a).to(eng.device) for a in arrays]
    state = eng._pools()
    with graph_capture.restored(state) as saved:
        g = eng._decode(dtype, *arrays)[:len(live)]
        g_pools = [t[:, :, :, :, :, 1:].clone() for t in state]
        graph_capture.put_back(state, saved)
        e = eng._decode_fn(dtype)(*args)[0, 0, 0, 0, :len(live)].cpu().numpy()
        same = all(torch.equal(a, t[:, :, :, :, :, 1:]) for a, t in zip(g_pools, state))
    return g, e, same, len(live)


@contextlib.contextmanager
def planted(eng, fault: str):
    """Serve with a deliberate fault, to show that :func:`oracle_rule` fails
    a wrong engine. ``"position+1"``: every live slot's position one past its
    own (its K/V written one slot late, its mask one wider, its position
    embedding off by one). ``"drop_kv:<block>"``: that block's K/V write of
    every decode step is lost. The decode step runs eagerly meanwhile; the
    captured graphs stay as they were."""
    batch, decode = eng._batch, eng._decode

    def late_batch():
        live, (tokens, positions, pt) = batch()
        positions = positions.copy()
        positions[:len(live)] += 1
        return live, (tokens, positions, pt)

    def eager(dtype, tokens, positions, pt):
        import torch

        args = [torch.from_numpy(a).to(eng.device) for a in (tokens, positions, pt)]
        pools = eng._pools()
        keep = [p[:, :, :, :, blk].clone() for p in pools] if blk is not None else []
        logits = eng._decode_fn(dtype)(*args)
        for p, k in zip(pools, keep):
            p[:, :, :, :, blk].copy_(k)
        return logits[0, 0, 0, 0].cpu().numpy()

    blk = None
    if fault.startswith("drop_kv:"):
        blk = int(fault.split(":", 1)[1])
    elif fault == "position+1":
        eng._batch = late_batch
    else:
        raise ValueError(f"unknown fault {fault!r}")
    eng._decode = eager
    try:
        yield eng
    finally:
        eng._batch, eng._decode = batch, decode
