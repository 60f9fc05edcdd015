"""Buffer checker: validation of every buffer handed to a collective.

Counterpart of ``mlsl_tpu.checker`` (the reference's PointerChecker,
src/pointer_checker.{hpp,cpp}: an allocator-range tracker consulted before
every MPI call under ENABLE_CHKP_INT). ``MLSL_CHKP`` is read fresh at each
check (off by default):

- ``MLSL_CHKP=1`` checks a buffer's layout, its payload length and its
  dtype against the request's descriptor, on the host, with no sync. On
  virtual ranks a buffer's "sharding" is its leading ``(R, D, S, M)`` grid
  dims, which must be those of the request's topology.
- ``MLSL_CHKP=2`` adds the finiteness of float payloads. Each Start queues
  one on-device ``isfinite(...).all()`` a buffer, in its domain (``comm``,
  ``feed``), and :func:`flush_values` resolves every verdict of a domain
  with one host read, at the round's first Wait or Test, naming every
  offending buffer. The check therefore raises at the round's first Wait,
  not at the Start that queued it.

Three boundaries call it, as in the JAX package: a request's Start
(comm/request.py), the bucket pack, where each member buffer is checked
against its own request's descriptor before it joins the coalesced round
(core/bucketing.py), and the feed's decode (data/feed.py via
:func:`check_feed_batch`).

Inside a CUDA-graph capture no finiteness verdict is queued or resolved: a
host read cannot run in a capture, and the captured program replays without
Python. The capture's eager warm-up runs the same Python and is checked.

Counters: ``core.stats.CHKP_COUNTERS`` (the CHKP line of ``mlsl_stats.log``
and the ``mlsl_chkp_*`` metric family).
"""

from __future__ import annotations

import math
import threading
from typing import List, Tuple

import torch

from mlsl_tpu_torch.config import _env_int
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.types import torch_dtype

CHKP_OFF = 0
CHKP_SHAPE = 1   # layout, length and dtype (no sync)
CHKP_VALUES = 2  # + finiteness (one host read a round)


def level() -> int:
    # read at each Start: tests and the smoke toggle the variable at run time
    return _env_int("MLSL_CHKP", 0)


# queued finiteness verdicts: (domain, label, on-device bool scalar). Starts
# and waits can come from different threads (the dispatcher's progress
# thread). The domain keeps the comm rounds and the feed's batches apart: a
# comm wait never drains (and raises) a feed batch's verdict, or the reverse.
_pending: List[Tuple[str, str, torch.Tensor]] = []
_plock = threading.Lock()


def _record(event: str, n: int = 1) -> None:
    from mlsl_tpu_torch.core import stats as stats_mod

    stats_mod.record_chkp(event, n)


def _violation(msg: str, *args) -> None:
    _record("violations")
    raise MLSLError(msg % args if args else msg)


def _capturing(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def check_buffer(buf, desc, lvl: int = None) -> None:
    """Check a distributed buffer against its request's descriptor; raises
    ``MLSLError`` on a mismatch. At ``CHKP_VALUES`` the finiteness verdict is
    queued and raises at the round's :func:`flush_values`."""
    if lvl is None:
        lvl = level()
    if lvl == CHKP_OFF:
        return
    _record("checks")
    topo = desc.group.topology
    if not (isinstance(buf, torch.Tensor) and buf.dim() >= 5):
        _violation("CHKP: buffer must be a distributed (R,D,S,M,n) tensor, got %r",
                   type(buf).__name__)
    if tuple(buf.shape[:4]) != topo.grid_shape:
        _violation("CHKP: buffer grid %s does not match topology %s",
                   tuple(buf.shape[:4]), topo.grid_shape)
    got = math.prod(buf.shape[4:])
    if got < desc.count:
        _violation("CHKP: buffer payload %d < descriptor count %d (OUT_OF_RANGE)",
                   got, desc.count)
    want = torch_dtype(desc.data_type)
    if buf.dtype != want:
        _violation("CHKP: buffer dtype %s != descriptor dtype %s", buf.dtype, want)
    if lvl >= CHKP_VALUES and buf.is_floating_point() and not _capturing(buf):
        _queue_finite("comm", f"{desc.kind}[{desc.count}]", torch.isfinite(buf).all())


def _queue_finite(domain: str, label: str, verdict: torch.Tensor) -> None:
    _record("value_checks")
    with _plock:
        _pending.append((domain, label, verdict))


def flush_values(domain: str = "comm") -> None:
    """Resolve the queued finiteness verdicts of ``domain`` with one host
    read; raises ``MLSLError`` naming every offending buffer. Called at a
    round's completion (CommRequest.wait/test) and by
    :func:`check_feed_batch`. No-op (one length check) with nothing queued;
    deferred while this thread's stream captures a graph."""
    if not _pending:
        return
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return
    with _plock:
        batch = [e for e in _pending if e[0] == domain]
        _pending[:] = [e for e in _pending if e[0] != domain]
    if not batch:
        return
    _record("value_syncs")
    verdicts = torch.stack([v.to(batch[0][2].device) for _, _, v in batch]).cpu().tolist()
    bad = [label for (_, label, _), ok in zip(batch, verdicts) if not ok]
    if bad:
        _record("violations", len(bad))
        raise MLSLError("CHKP: buffer contains non-finite values: " + ", ".join(bad))


def clear() -> None:
    """Drop every queued verdict (tests; a process that starts over)."""
    with _plock:
        _pending.clear()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def check_feed_batch(batch, lvl: int = None) -> None:
    """Check one decoded feed batch (data/feed.py): at ``CHKP_VALUES`` every
    float leaf must be finite, so that a wire or cache fault surfaces at the
    decode and not as a poisoned step. One host read a batch, in the 'feed'
    domain."""
    if lvl is None:
        lvl = level()
    if lvl < CHKP_VALUES:
        return
    n = 0
    for i, leaf in enumerate(_leaves(batch)):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                and not _capturing(leaf):
            _record("checks")
            _queue_finite("feed", f"feed.decode[leaf{i}]", torch.isfinite(leaf).all())
            n += 1
    if n:
        flush_values("feed")
