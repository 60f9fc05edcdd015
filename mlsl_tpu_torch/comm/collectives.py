"""The collective library over virtual ranks on one device.

Counterpart of ``mlsl_tpu.comm.collectives``. A distributed buffer is one
tensor of shape (R, D, S, M, n) (see comm/mesh.py). Each collective views it
as (C, G, n) -- C group instances of G members -- reduces, gathers or moves
over the member dim, and writes the result back to every member. The
semantics are the JAX package's ``_body_*`` functions (collectives.py:111-
224): rooted reductions and gathers return the result on every member, a
strict superset of MPI's root-only delivery.

The (C, G, n) view of an axis group is a permute of the grid dims. A color
group's is a gather of world rows by its member table (``group_view``): rows
of the (W, n) world view picked with ``index_select`` and written back with
``index_copy_``, then the same bodies. Ragged color groups pad to the largest
group, Gmax, as ``_make_ragged_body`` (collectives.py:453-589) does: an
absent member is a row of zeros (the op's neutral value for MIN and MAX),
allgather and alltoall deliver zeros from absent positions, scatter and
reduce_scatter read a buffer laid out for Gmax members, and allgatherv and
alltoallv are refused. ``alltoallv`` is one gather through a table built on
the host from its static count matrices (``_alltoallv_table``): every output
element names the world row and offset it comes from, or none (a zero); the
last few tables stay on the device. ``allgatherv`` is one cat of the
members' prefixes.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from mlsl_tpu_torch.comm.mesh import GRID_AXES, NUM_GRID_AXES, ProcessGroup
from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.types import ReductionType


def _layout(group: ProcessGroup) -> Tuple[List[int], List[int]]:
    """-> (complementary grid dims, group grid dims in member order)."""
    gdims = [GRID_AXES.index(a) for a in group.axes]
    comp = [i for i in range(NUM_GRID_AXES) if i not in gdims]
    return comp, gdims


def _check_grid(x: torch.Tensor, topo) -> None:
    mlsl_assert(
        x.dim() == NUM_GRID_AXES + 1 and tuple(x.shape[:NUM_GRID_AXES]) == topo.grid_shape,
        "buffer must have shape (R=%d, D=%d, S=%d, M=%d, n), got %s",
        *topo.grid_shape, tuple(x.shape),
    )


# (group, device) -> the padded member table as an index tensor, and the
# flat positions of the real members in it
_INDEX: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def padded_members(group: ProcessGroup) -> np.ndarray:
    """(C, Gmax) world ranks of a color group's members, one row per color
    (colors ascending, members in world-rank order); -1 where a ragged
    group has no member at that position."""
    rows = group.member_table()
    gmax = max(len(r) for r in rows)
    tbl = np.full((len(rows), gmax), -1, dtype=np.int64)
    for i, row in enumerate(rows):
        tbl[i, :len(row)] = row
    return tbl


def _color_index(group: ProcessGroup, device) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (group, str(device))
    hit = _INDEX.get(key)
    if hit is None:
        tbl = padded_members(group)
        w = group.topology.world_size
        # absent members read the extra row W that padded_view appends
        rows = np.where(tbl >= 0, tbl, w).reshape(-1)
        valid = np.flatnonzero(tbl.reshape(-1) >= 0)
        hit = (torch.from_numpy(rows).to(device),
               (torch.from_numpy(valid).to(device), torch.from_numpy(tbl.reshape(-1)[valid])
                .to(device)))
        _INDEX[key] = hit
    return hit


def padded_view(x: torch.Tensor, group: ProcessGroup, fill=0) -> torch.Tensor:
    """(R, D, S, M, n) -> (C, Gmax, n) for a color group: world rows gathered
    by the member table; an absent member of a ragged group is a row of
    ``fill``."""
    topo = group.topology
    _check_grid(x, topo)
    rows, _ = _color_index(group, x.device)
    w = x.reshape(topo.world_size, x.shape[-1])
    if not group.is_uniform:
        w = torch.cat([w, w.new_full((1, x.shape[-1]), fill)])
    c = len(group.member_table())
    return w.index_select(0, rows).reshape(c, -1, x.shape[-1])


def padded_unview(y: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Inverse of ``padded_view``: the rows of real members back to their
    world ranks -> contiguous (R, D, S, M, n')."""
    topo = group.topology
    _, (pos, ranks) = _color_index(group, y.device)
    flat = y.reshape(-1, y.shape[-1])
    out = y.new_empty((topo.world_size, y.shape[-1]))
    out.index_copy_(0, ranks, flat.index_select(0, pos))
    return out.reshape(*topo.grid_shape, y.shape[-1])


def group_view(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """(R, D, S, M, n) -> (C, G, n): instances x members x payload. An axis
    group's view is a permute; a color group's a gather of world rows (equal
    groups only: a ragged group's collectives pad, ``padded_view``)."""
    topo = group.topology
    if group.colors is not None:
        mlsl_assert(group.is_uniform, "unequal-sized color groups have no (C, G, n) view; "
                    "their collectives pad to the largest group")
        return padded_view(x, group)
    _check_grid(x, topo)
    comp, gdims = _layout(group)
    g = group.size
    return x.permute(*comp, *gdims, NUM_GRID_AXES).reshape(
        topo.world_size // g, g, x.shape[-1]
    )


def group_unview(y: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Inverse of ``group_view``: (C, G, n') -> contiguous (R, D, S, M, n')."""
    if group.colors is not None:
        return padded_unview(y, group)
    grid = group.topology.grid_shape
    comp, gdims = _layout(group)
    perm = comp + gdims + [NUM_GRID_AXES]
    z = y.reshape(*(grid[i] for i in comp), *(grid[i] for i in gdims), y.shape[-1])
    inv = sorted(range(len(perm)), key=perm.__getitem__)
    return z.permute(*inv).contiguous()


def world_view(x: torch.Tensor, topo) -> torch.Tensor:
    """(R, D, S, M, n) -> (W, n): row p is world rank p's buffer (the rank
    formula is the row-major order of the grid). A view where the strides
    allow it, so a chunk slice of a wider buffer is not copied."""
    mlsl_assert(
        x.dim() == NUM_GRID_AXES + 1 and tuple(x.shape[:NUM_GRID_AXES]) == topo.grid_shape,
        "buffer must have shape (R=%d, D=%d, S=%d, M=%d, n), got %s",
        *topo.grid_shape, tuple(x.shape),
    )
    return x.reshape(topo.world_size, x.shape[-1])


def group_key(group: ProcessGroup, device=None) -> Tuple:
    """A group's identity for partitioning requests (``_group_key``,
    collectives.py:691-696 of the JAX package, which keys on the mesh's
    shape and device ids): the world's grid shape, the device its virtual
    ranks live on, the group's axes and its colors."""
    return (group.topology.grid_shape, str(device), group.axes, group.colors)


def _ordered_sum(y: torch.Tensor) -> torch.Tensor:
    """(C, G, n) -> (C, 1, n): the members added one by one in member order,
    JAX's CPU psum order bit for bit. Half precisions accumulate in float32
    and round once."""
    low = y.dtype in (torch.bfloat16, torch.float16)
    acc = y[:, 0].float() if low else y[:, 0]
    for j in range(1, y.shape[1]):
        acc = acc + y[:, j]
    return acc.to(y.dtype).unsqueeze(1)


def _reduce(y: torch.Tensor, op: ReductionType) -> torch.Tensor:
    """(C, G, n) -> (C, 1, n), reduced over the members.

    A SUM must order each element's terms alike wherever the element sits in
    the payload, so that a gradient bucket's concatenated request gives each
    member the bits of its own request. Torch's CPU reduction over a middle
    dim orders them by the element's offset, so the CPU takes the member
    loop (G - 1 passes, and JAX's order); torch's CUDA reduction sums every
    element in one order fixed by G alone (a tree for G = 8, not member
    order) in one pass, and ``chip_smoke.py`` holds a bucket to its members'
    own requests bit for bit on the card."""
    op = ReductionType(op)
    if op == ReductionType.SUM:
        if y.is_cuda:
            return y.sum(dim=1, keepdim=True, dtype=y.dtype)
        return _ordered_sum(y)
    if op == ReductionType.MIN:
        return y.amin(dim=1, keepdim=True)
    return y.amax(dim=1, keepdim=True)


def _allreduce(y, *, op, **_):
    return _reduce(y, op).expand_as(y)


def _bcast(y, *, root, **_):
    return y[:, root:root + 1].expand_as(y)


def _allgather(y, **_):
    c, g, n = y.shape
    return y.reshape(c, 1, g * n).expand(c, g, g * n)


def _reduce_scatter(y, *, op, recv_count, **_):
    c, g, n = y.shape
    mlsl_assert(n == g * recv_count,
                "reduce_scatter count %d != group %d * recv_count %d", n, g, recv_count)
    # member i receives slice i of the group reduction
    return _reduce(y, op).reshape(c, g, recv_count)


def _alltoall(y, *, send_count, **_):
    c, g, n = y.shape
    mlsl_assert(n == g * send_count,
                "alltoall count %d != group %d * send_count %d", n, g, send_count)
    # member j receives chunk j of every member, in member order
    return y.reshape(c, g, g, send_count).transpose(1, 2).reshape(c, g, n)


def _scatter(y, *, root, recv_count, **_):
    # member i receives root's segment i (the masked reduce-scatter's result,
    # collectives.py:149-159 of the JAX package)
    c, g, n = y.shape
    mlsl_assert(n == g * recv_count,
                "scatter count %d != group %d * recv_count %d", n, g, recv_count)
    return y[:, root].reshape(c, g, recv_count)


def _sendrecv(y, *, pairs, **_):
    # member dst receives member src's buffer for each (src, dst) pair;
    # members that receive nothing get zeros (lax.ppermute's semantics)
    c, g, n = y.shape
    src = [0] * g
    recv = [False] * g
    for s_, d in pairs:
        src[int(d)], recv[int(d)] = int(s_), True
    moved = y.index_select(1, torch.tensor(src, device=y.device))
    mask = torch.tensor(recv, device=y.device).view(1, g, 1)
    return torch.where(mask, moved, torch.zeros((), dtype=y.dtype, device=y.device))


def _allgatherv(y, *, recv_counts, **_):
    # member i's first recv_counts[i] elements, concatenated in member order:
    # one cat over the members' prefix views
    c, g, n = y.shape
    mlsl_assert(len(recv_counts) == g, "allgatherv needs %d recv_counts, got %d", g,
                len(recv_counts))
    out = torch.cat([y[:, i, :min(int(k), n)] for i, k in enumerate(recv_counts)], dim=1)
    return out.unsqueeze(1).expand(c, g, out.shape[-1])


_BODIES = {
    "allreduce": _allreduce,
    "reduce": _allreduce,      # result on every member (superset of MPI's root-only)
    "bcast": _bcast,
    "allgather": _allgather,
    "allgatherv": _allgatherv,
    "gather": _allgather,      # likewise
    "scatter": _scatter,
    "reduce_scatter": _reduce_scatter,
    "alltoall": _alltoall,
    "sendrecv": _sendrecv,
}

KINDS = tuple(_BODIES) + ("alltoallv", "barrier")

#: the kinds a ragged color group serves (``_make_ragged_body``)
RAGGED_KINDS = ("allreduce", "reduce", "bcast", "allgather", "gather", "sendrecv",
                "scatter", "reduce_scatter", "alltoall")

#: the build keywords each kind takes
BUILD_KW = ("op", "root", "recv_count", "send_count", "recv_counts", "pairs", "S", "Soff",
            "Roff", "recv_len", "Sw", "Swoff", "Rwoff")


# -- alltoallv ---------------------------------------------------------------------


def member_world_table(group: ProcessGroup) -> np.ndarray:
    """(W, G) table: row w = the world ranks of w's group-instance members, in
    group-rank order (``_member_world_table``, collectives.py:284-297).
    Equal groups only."""
    w = group.topology.world_size
    if group.is_self:
        return np.arange(w, dtype=np.int64)[:, None]
    rows = group.member_table()
    tbl = np.zeros((w, len(rows[0])), dtype=np.int64)
    for row in rows:
        for p in row:
            tbl[p] = row
    return tbl


def _alltoallv_table(group: ProcessGroup, kw: dict) -> Tuple[np.ndarray, np.ndarray]:
    """-> (src_rank, src_off), each (W, recv_len): the world row and offset
    every output element of every rank comes from, -1 for an element no
    segment writes (a zero). Segments land in member order, a later one over
    an earlier one, as ``_alltoallv_core`` merges them (collectives.py:334-
    358). Matrix form (S, Soff, Roff: (G, G), the same for every instance) or
    per-rank form (Sw, Swoff, Rwoff: (W, G), row w what world rank w sends to
    each member of its own instance)."""
    w = group.topology.world_size
    recv_len = int(kw["recv_len"])
    members = member_world_table(group)
    g = members.shape[1]
    pos = np.array([list(members[p]).index(p) for p in range(w)])
    src_rank = np.full((w, recv_len), -1, dtype=np.int64)
    src_off = np.zeros((w, recv_len), dtype=np.int64)
    per_rank = "Sw" in kw
    if per_rank:
        sw, swoff, rwoff = (np.asarray(kw[k], dtype=np.int64) for k in ("Sw", "Swoff", "Rwoff"))
    else:
        sm, soffm, roffm = (np.asarray(kw[k], dtype=np.int64) for k in ("S", "Soff", "Roff"))
    for p in range(w):
        me = pos[p]
        for j in range(g):
            q = members[p, j]
            if per_rank:
                cnt, soff, roff = sw[q, me], swoff[q, me], rwoff[p, j]
            else:
                cnt, soff, roff = sm[j, me], soffm[j, me], roffm[me, j]
            cnt = min(int(cnt), recv_len - int(roff))
            if cnt <= 0:
                continue
            src_rank[p, roff:roff + cnt] = q
            src_off[p, roff:roff + cnt] = soff + np.arange(cnt)
    return src_rank, src_off


# (group, matrices, buffer length, device) -> (flat source index, valid mask):
# the last few tables on the device, so that repeated requests of one geometry
# build theirs once (the JAX package caches the compiled program per key)
_A2AV_TABLES: "OrderedDict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = OrderedDict()
_A2AV_KEEP = 4


def clear_cache() -> None:
    """Drop the color groups' index tensors and alltoallv's tables
    (``mlsl_tpu.comm.collectives.clear_cache``)."""
    _INDEX.clear()
    _A2AV_TABLES.clear()


def _alltoallv_index(group: ProcessGroup, kw: dict, n: int, device):
    key = (group, tuple(sorted(kw.items())), n, str(device))
    hit = _A2AV_TABLES.get(key)
    if hit is not None:
        _A2AV_TABLES.move_to_end(key)
        return hit
    src_rank, src_off = _alltoallv_table(group, kw)
    # an offset past the buffer reads the JAX program's zero padding
    valid = (src_rank >= 0) & (src_off < n)
    flat = np.where(valid, src_rank * n + src_off, 0)
    idx_dtype = np.int32 if group.topology.world_size * n < 2 ** 31 else np.int64
    hit = (torch.from_numpy(flat.reshape(-1).astype(idx_dtype)).to(device),
           torch.from_numpy(valid.reshape(-1)).to(device))
    _A2AV_TABLES[key] = hit
    while len(_A2AV_TABLES) > _A2AV_KEEP:
        _A2AV_TABLES.popitem(last=False)
    return hit


def _build_alltoallv(group: ProcessGroup, kw: dict) -> Callable:
    for k in ("recv_len",) + (("Sw", "Swoff", "Rwoff") if "Sw" in kw else ("S", "Soff", "Roff")):
        mlsl_assert(k in kw, "alltoallv needs its count matrices (S, Soff, Roff or the "
                             "per-rank Sw, Swoff, Rwoff) and recv_len; %s is missing", k)
    topo = group.topology
    recv_len = int(kw["recv_len"])
    if group.colors is None and group.size == 1 and "Sw" not in kw:
        # a one-member group: the JAX program returns the buffer's head
        return lambda x: x[..., :recv_len].contiguous()

    def fn(x: torch.Tensor) -> torch.Tensor:
        _check_grid(x, topo)
        flat, valid = _alltoallv_index(group, kw, x.shape[-1], x.device)
        moved = x.reshape(-1).index_select(0, flat)
        out = torch.where(valid, moved, torch.zeros((), dtype=x.dtype, device=x.device))
        return out.reshape(*topo.grid_shape, recv_len)

    return fn


# -- building ----------------------------------------------------------------------


def _neutral(dtype: torch.dtype, op: ReductionType):
    """The fill of an absent member in a ragged group's reduction."""
    if op == ReductionType.SUM:
        return 0
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    if op == ReductionType.MIN:
        return float("inf") if dtype.is_floating_point else info.max
    return float("-inf") if dtype.is_floating_point else info.min


def _identity_body(kind: str, kw: dict) -> Callable:
    """A one-member group: every collective is the identity or a head slice
    (collectives.py:718-737 of the JAX package)."""
    if kind in ("scatter", "reduce_scatter"):
        n = int(kw["recv_count"])
    elif kind == "allgatherv":
        n = int(kw["recv_counts"][0])
    else:
        return lambda x: x
    return lambda x: x[..., :n].contiguous()


def _build_ragged(kind: str, group: ProcessGroup, body: Callable, kw: dict) -> Callable:
    """A body over an unequal color partition, padded to Gmax
    (``_make_ragged_body``)."""
    mlsl_assert(kind != "alltoallv",
                "alltoallv is not supported on unequal-sized color groups: its count "
                "matrix already expresses per-pair raggedness -- spell the exchange with "
                "zero counts on an equal-size group instead")
    mlsl_assert(kind in RAGGED_KINDS,
                "%s is not supported on unequal-sized color groups (per-rank result sizes "
                "would be ragged, but buffers are rank-uniform)", kind)
    gmin, gmax = min(group.group_sizes), group.size
    if kw.get("root") is not None:
        mlsl_assert(kw["root"] < gmin, "root member index %d out of range for the smallest "
                    "group (size %d)", kw["root"], gmin)
    if kw.get("pairs"):
        mlsl_assert(max(max(int(a), int(b)) for a, b in kw["pairs"]) < gmin,
                    "sendrecv pair member index out of range for the smallest group")
    if kind in ("scatter", "reduce_scatter"):
        mlsl_assert(kw.get("recv_count") is not None, "%s on color groups needs recv_count",
                    kind)
    op = ReductionType(kw.get("op") or ReductionType.SUM)

    def fn(x: torch.Tensor) -> torch.Tensor:
        if kind in ("scatter", "reduce_scatter"):
            rc = int(kw["recv_count"])
            mlsl_assert(x.shape[-1] >= gmax * rc,
                        "%s on unequal color groups needs a buffer spanning the largest "
                        "group: count %d < Gmax (%d) * recv_count (%d)",
                        kind, x.shape[-1], gmax, rc)
            x = x[..., :gmax * rc]
        fill = _neutral(x.dtype, op) if kind in ("allreduce", "reduce", "reduce_scatter") else 0
        return padded_unview(body(padded_view(x, group, fill), **kw), group)

    return fn


class _ChaosDispatch:
    """A built collective whose every call passes the ``collective.dispatch``
    and ``device.lost`` chaos sites first (collectives.py:634-670 of the JAX
    package): one armed-check when idle. ``_mlsl_inner`` is the function
    beneath, for the callers that must not pass the sites: a precompile warm,
    the sweep's timing, a plain-version check, and the collectives composed
    into a larger program (the staged phases of comm/algos, ring2d), which
    the JAX package runs inside one compiled program. While a CUDA graph
    captures, the sites are idle (chaos.inject): a fault there would break
    the capture, and a delay would be paid once, not every replay."""

    __slots__ = ("_fn", "_kind")

    def __init__(self, fn: Callable, kind: str):
        self._fn = fn
        self._kind = kind

    def __call__(self, *bufs):
        from mlsl_tpu_torch import chaos

        if chaos._plans:
            chaos.inject("collective.dispatch", kind=self._kind)
            # a vanished peer surfaces at dispatch; 'silent' plans are the
            # elastic rejoin's (ROADMAP A.7c) and must not be spent here
            chaos.inject("device.lost", kinds=("error", "delay", "hang"), kind=self._kind)
        return self._fn(*bufs)

    @property
    def _mlsl_inner(self) -> Callable:
        return self._fn


def chaos_dispatch(fn: Callable, kind: str) -> Callable:
    """``fn`` behind the dispatch chaos sites (once: a wrapped function is
    returned as it is)."""
    return fn if isinstance(fn, _ChaosDispatch) else _ChaosDispatch(fn, kind)


def unwrap_chaos(fn: Callable) -> Callable:
    """The function beneath the chaos instrumentation (itself when bare)."""
    return getattr(fn, "_mlsl_inner", fn)


def build_plain_fallback(kind: str, group: ProcessGroup, count: int) -> Callable:
    """The always-correct SUM a degraded compressed request falls back to
    (the supervisor's rung 3, collectives.py:676-688 of the JAX package): the
    ``build_collective`` program the uncompressed request runs, over the
    float32 payload the flush hands it."""
    kw = {"op": ReductionType.SUM}
    if kind == "reduce_scatter":
        kw["recv_count"] = count // (1 if group.is_self else group.size)
    return build_collective(kind, group, **kw)


def build_collective(kind: str, group: ProcessGroup, **kw) -> Callable:
    """The collective behind the ``collective.dispatch`` / ``device.lost``
    chaos sites (``_ChaosDispatch``); ``build_raw`` is the bare function."""
    return chaos_dispatch(build_raw(kind, group, **kw), kind)


def build_raw(kind: str, group: ProcessGroup, **kw) -> Callable:
    """-> fn: distributed buffer (R, D, S, M, n) -> result buffer (R, D, S, M, n').

    kw per kind: op (allreduce/reduce/reduce_scatter), root (bcast/reduce/
    gather/scatter), recv_count (scatter/reduce_scatter), send_count
    (alltoall: the elements each member sends each member), recv_counts
    (allgatherv), pairs (sendrecv: (src, dst) member pairs), and alltoallv's
    matrices from ``request.normalize_alltoallv``. The functions are plain
    tensor work, so autograd runs through them.

    In a world of several processes the buffer is this process's box: a
    process-local group runs on it as on a world of its own
    (``ProcessGroup.localize``), a spanning one through the transport's
    spanning form (comm/transport.py)."""
    mlsl_assert(kind in KINDS and kind != "barrier", "collective %r is not ported yet", kind)
    kw = {k: v for k, v in kw.items() if v is not None}
    if group.topology.num_procs > 1:
        # alltoallv's per-rank tables name world ranks: it takes the world form
        local = group.localize() if kind != "alltoallv" else None
        if local is not None:
            return _build_raw(kind, local, kw)
        from mlsl_tpu_torch.comm import transport

        return transport.build_spanning(kind, group, _build_raw(kind, group, kw), **kw)
    return _build_raw(kind, group, kw)


def _build_raw(kind: str, group: ProcessGroup, kw: dict) -> Callable:
    """``build_raw`` over one process's whole grid."""
    if kind == "alltoallv":
        if group.colors is not None and not group.is_uniform:
            _build_ragged(kind, group, None, kw)
        return _build_alltoallv(group, kw)
    body = _BODIES[kind]
    if group.colors is not None and not group.is_uniform:
        return _build_ragged(kind, group, body, kw)
    if "root" in kw:
        mlsl_assert(0 <= kw["root"] < group.size,
                    "root member index %d out of range for group size %d",
                    kw["root"], group.size)
    if kind == "sendrecv":
        g = group.size
        srcs = [int(a) for a, _ in kw["pairs"]]
        dsts = [int(b) for _, b in kw["pairs"]]
        mlsl_assert(all(0 <= v < g for v in srcs + dsts),
                    "SendRecvList pairs %s out of range for group size %d", kw["pairs"], g)
        mlsl_assert(len(set(dsts)) == len(dsts),
                    "SendRecvList destinations must be unique")
    if group.is_self or (group.colors is None and group.size == 1):
        return _identity_body(kind, kw)

    def fn(x: torch.Tensor) -> torch.Tensor:
        return group_unview(body(group_view(x, group), **kw), group)

    return fn


def build_barrier(group: ProcessGroup) -> Callable:
    """A one-element SUM; waiting on its result is the barrier (every virtual
    rank's earlier work on the stream is done by then). A color group's
    barrier, like JAX's, sums over the whole world."""
    if group.colors is not None or not group.axes:
        group = ProcessGroup(group.topology, GRID_AXES)
    fn = build_raw("allreduce", group, op=ReductionType.SUM)
    if group.topology.num_procs > 1 and group.spans:
        from mlsl_tpu_torch.comm import transport

        inner = fn

        def fn(x):
            transport.barrier(transport.subgroup(group.process_partition()))
            return inner(x)
    return chaos_dispatch(fn, "barrier")
