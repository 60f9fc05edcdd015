"""Top-k sparse allreduce and reduce_scatter with error feedback.

Counterpart of ``mlsl_tpu.comm.sparse`` (sparse.py:47-140). Each rank
contributes only its k largest-magnitude elements of ``x + err`` (k =
``max(1, int(count * ratio))``); what it did not send stays in its
error-feedback residual for the next round.

Wire formats, over the group's (C, G, n) view (comm/collectives.py):

- all-gather (groups below ``RING_THRESHOLD``): every member's (k values,
  k indices) pair is gathered and scatter-added into a zero vector, member 0
  first (the JAX package's scatter order); within one member the indices
  are distinct, so each pass is one add an element and deterministic on the
  card too;
- ring (at or above ``RING_THRESHOLD``, or forced on a single-axis group):
  each member's pair travels the ring, ``torch.roll`` on the member dim as
  ``lax.ppermute``, and each arrival is scatter-added into the member's own
  sparse vector.

Exactness contract: the result is the sum of every member's top-k-sparsified
contribution. The two formats add an element's terms in different orders
(member 0 up, against the member's own first, then its ring predecessors),
so they agree to float32 rounding, not bit for bit.

The selection is ``lax.top_k``'s: the largest magnitudes, equal magnitudes
in index order (``codecs._stable_topk``, a stable descending sort), so the
two packages, and the CPU and the card, send the same indices.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from mlsl_tpu_torch.codecs import _stable_topk
from mlsl_tpu_torch.comm.collectives import group_key, group_unview, group_view
from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import mlsl_assert

_cache: dict = {}

# at or above this group size the ring format replaces the all-gather: the
# gathered (G, k) pairs stop being small, the ring holds one pair a rank
RING_THRESHOLD = 16


def _sparse_body(x, err, *, k: int, n: int, recv_count: Optional[int], use_ring: bool):
    """(C, G, n), (C, G, n) -> (result, new_err): the dense sum of the
    sparsified contributions (allreduce), or member i's slice i of it
    (reduce_scatter, ``recv_count`` set)."""
    c, g, _ = x.shape
    xq = x.to(torch.float32) + err
    idx = _stable_topk(xq.abs().reshape(c * g, n), k).reshape(c, g, k)
    vals = xq.gather(2, idx)
    sparse_mine = torch.zeros_like(xq).scatter_(2, idx, vals)
    new_err = xq - sparse_mine
    if g > 1 and use_ring:
        out, v, i = sparse_mine.clone(), vals, idx
        for _ in range(g - 1):
            v = torch.roll(v, shifts=1, dims=1)          # member j -> j + 1
            i = torch.roll(i, shifts=1, dims=1)
            out.scatter_add_(2, i, v)
    elif g > 1:
        acc = torch.zeros((c, 1, n), dtype=torch.float32, device=x.device)
        for j in range(g):
            acc.scatter_add_(2, idx[:, j:j + 1], vals[:, j:j + 1])
        out = acc.expand(c, g, n)
    else:
        out = sparse_mine
    if recv_count is not None:
        me = torch.arange(g, device=x.device)
        out = out.reshape(c, g, g, recv_count)[:, me, me]
    return out, new_err


def build_sparse_collective(kind: str, group: ProcessGroup, count: int, ratio: float,
                            use_ring: Optional[bool] = None) -> Tuple[Callable, int]:
    """-> (fn (buf, err) -> (result, new_err), error-feedback length).

    ``kind``: 'allreduce' or 'reduce_scatter' (MPI slice placement); SUM
    only, axis-aligned groups. ``use_ring``: None picks the ring for
    single-axis groups of ``RING_THRESHOLD`` members or more. The function
    is plain tensor work on the buffer's device: no kernel."""
    mlsl_assert(kind in ("allreduce", "reduce_scatter"),
                "sparse collectives support allreduce/reduce_scatter (got %s)", kind)
    mlsl_assert(group.colors is None, "sparse collectives require axis-aligned groups")
    mlsl_assert(0.0 < ratio <= 1.0, "topk ratio must be in (0, 1], got %s", ratio)
    g = 1 if group.is_self else group.size
    if use_ring is None:
        use_ring = g >= RING_THRESHOLD and len(group.axes) == 1
    elif use_ring:
        mlsl_assert(len(group.axes) == 1 and g > 1,
                    "ring wire format requires a single-axis group of size > 1 "
                    "(got axes=%s, size=%d)", group.axes, g)
    recv_count = None
    if kind == "reduce_scatter":
        mlsl_assert(count % g == 0, "reduce_scatter count %d %% group %d", count, g)
        recv_count = count // g
    k = max(1, int(count * ratio))
    key = (kind, group_key(group), count, k, use_ring)
    fn = _cache.get(key)
    if fn is not None:
        return fn, count

    def fn(buf: torch.Tensor, err: torch.Tensor):
        mlsl_assert(buf.shape[-1] == count, "buffer count %d != request count %d",
                    buf.shape[-1], count)
        out, new_err = _sparse_body(group_view(buf, group), group_view(err, group), k=k,
                                    n=count, recv_count=recv_count, use_ring=use_ring)
        return group_unview(out, group), group_unview(new_err, group)

    _cache[key] = fn
    return fn, count
