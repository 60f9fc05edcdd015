"""The collective library over virtual ranks on one device.

Counterpart of ``mlsl_tpu.comm.collectives``. A distributed buffer is one
tensor of shape (R, D, S, M, n) (see comm/mesh.py). Each collective views it
as (C, G, n) -- C group instances (the complementary grid dims, in grid order)
of G members (the group's axes, major -> minor) -- reduces or gathers over the
member dim, and writes the result back to every member. The semantics are the
JAX package's ``_body_*`` functions (collectives.py:111-195): rooted
reductions and gathers return the result on every member, a strict superset
of MPI's root-only delivery. ``alltoallv`` is not ported yet.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from mlsl_tpu_torch.comm.mesh import GRID_AXES, NUM_GRID_AXES, ProcessGroup
from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.types import ReductionType


def _layout(group: ProcessGroup) -> Tuple[List[int], List[int]]:
    """-> (complementary grid dims, group grid dims in member order)."""
    gdims = [GRID_AXES.index(a) for a in group.axes]
    comp = [i for i in range(NUM_GRID_AXES) if i not in gdims]
    return comp, gdims


def group_view(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """(R, D, S, M, n) -> (C, G, n): instances x members x payload."""
    topo = group.topology
    mlsl_assert(
        x.dim() == NUM_GRID_AXES + 1 and tuple(x.shape[:NUM_GRID_AXES]) == topo.grid_shape,
        "buffer must have shape (R=%d, D=%d, S=%d, M=%d, n), got %s",
        *topo.grid_shape, tuple(x.shape),
    )
    comp, gdims = _layout(group)
    g = group.size
    return x.permute(*comp, *gdims, NUM_GRID_AXES).reshape(
        topo.world_size // g, g, x.shape[-1]
    )


def group_unview(y: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Inverse of ``group_view``: (C, G, n') -> contiguous (R, D, S, M, n')."""
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


_BODIES = {
    "allreduce": _allreduce,
    "reduce": _allreduce,      # result on every member (superset of MPI's root-only)
    "bcast": _bcast,
    "allgather": _allgather,
    "gather": _allgather,      # likewise
    "reduce_scatter": _reduce_scatter,
    "alltoall": _alltoall,
}

KINDS = tuple(_BODIES) + ("barrier",)


def build_collective(kind: str, group: ProcessGroup, **kw) -> Callable:
    """-> fn: distributed buffer (R, D, S, M, n) -> result buffer (R, D, S, M, n').

    kw per kind: op (allreduce/reduce/reduce_scatter), root (bcast/reduce/gather),
    recv_count (reduce_scatter), send_count (alltoall: the elements each member
    sends each member). The functions are plain tensor work, so autograd runs
    through them."""
    mlsl_assert(kind in _BODIES, "collective %r is not ported yet", kind)
    if "root" in kw:
        mlsl_assert(0 <= kw["root"] < group.size,
                    "root member index %d out of range for group size %d",
                    kw["root"], group.size)
    body = _BODIES[kind]

    def fn(x: torch.Tensor) -> torch.Tensor:
        return group_unview(body(group_view(x, group), **kw), group)

    return fn


def build_barrier(group: ProcessGroup) -> Callable:
    """A one-element SUM over the group; waiting on its result is the barrier
    (every virtual rank's earlier work on the stream is done by then)."""
    return build_collective("allreduce", group, op=ReductionType.SUM)
