"""Hierarchical ring-of-rings allreduce and reduce-scatter, composed.

Counterpart of ``mlsl_tpu.comm.algos.ring2d``. SUM only, for groups over two
or more live grid axes:

- allreduce: reduce-scatter along the minor live axis, reduce over the
  remaining group axes, all-gather along the minor axis; as tensor work, a
  sum over the minor axis and then over the rest;
- reduce_scatter (exactly two live axes a0, a1): the chunks are relabelled
  a1-major, then reduce-scattered along a1 and along a0, so member
  (i0, i1) receives group chunk i0 * |a1| + i1 (ring2d.py:13-18), the
  flattened group position; as tensor work, a sum over a1 and then over a0.

Plain PyTorch: the JAX version is composed of ``lax.psum_scatter`` /
``psum`` / ``all_gather`` phases, whose summation order inside a phase is
XLA's; float results agree with it to rounding.

``steps`` is the staged form: the JAX schedule's phases, each one collective
over one set of axes (``psum_scatter`` along an axis is the baseline
reduce_scatter over that axis' subgroup).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from mlsl_tpu_torch.comm.collectives import build_collective, group_unview, group_view
from mlsl_tpu_torch.comm.mesh import NUM_GRID_AXES, ProcessGroup
from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.types import ReductionType


def build(kind: str, group: ProcessGroup, *, op=None, recv_count=None, **_) -> Callable:
    """-> fn: distributed buffer (R, D, S, M, n) -> result buffer."""
    topo = group.topology
    live = group.live_axes()
    mlsl_assert(len(live) >= 2, "ring2d needs a group spanning >= 2 live axes (got %s)",
                group.axes)
    g = group.size
    a_minor = topo.axis_size(live[-1])

    if kind == "reduce_scatter":
        mlsl_assert(len(live) == 2, "ring2d reduce_scatter is 2-D only")
        a0, a1 = topo.axis_size(live[0]), topo.axis_size(live[1])

        def fn(buf: torch.Tensor) -> torch.Tensor:
            y = group_view(buf, group)
            c_inst, _, n = y.shape
            mlsl_assert(recv_count is not None and n == g * recv_count,
                        "ring2d reduce_scatter needs count == G*recv_count (count %d, G %d, "
                        "recv_count %s)", n, g, recv_count)
            z = y.reshape(c_inst, a0, a1, a0, a1, recv_count)   # [i0, i1, chunk j0, j1]
            out = z.sum(dim=2, dtype=y.dtype).sum(dim=1, dtype=y.dtype)   # a1, then a0
            return group_unview(out.reshape(c_inst, g, recv_count), group)

        return fn

    def fn(buf: torch.Tensor) -> torch.Tensor:
        y = group_view(buf, group)
        c_inst, _, n = y.shape
        red = y.reshape(c_inst, g // a_minor, a_minor, n).sum(dim=2, dtype=y.dtype)
        red = red.sum(dim=1, dtype=y.dtype)
        return group_unview(red[:, None].expand(c_inst, g, n), group)

    return fn


def steps(kind: str, group: ProcessGroup, n: int, *, op=None,
          recv_count=None) -> Tuple[Callable, List[Callable], Callable]:
    """The staged ring-of-rings (``mlsl_tpu.comm.algos.ring2d.steps``):
    ``(prep, phases, finish)`` over distributed buffers (R, D, S, M, n).
    reduce_scatter: the a1-major relabelling, then one scatter phase along
    a1 and one along a0; allreduce: a scatter along the minor live axis, a
    reduction over the other group axes (when there are any) and a gather
    along the minor axis."""
    topo = group.topology
    live = group.live_axes()
    mlsl_assert(len(live) >= 2, "ring2d needs a group spanning >= 2 live axes (got %s)",
                group.axes)

    def sub(axes):
        return ProcessGroup(topo, tuple(axes))

    def scatter(axis, width):
        fn = build_collective("reduce_scatter", sub([axis]), op=ReductionType.SUM,
                              recv_count=width // topo.axis_size(axis))
        return fn

    if kind == "reduce_scatter":
        mlsl_assert(len(live) == 2, "ring2d reduce_scatter is 2-D only")
        a0, a1 = live
        s0, s1 = topo.axis_size(a0), topo.axis_size(a1)
        mlsl_assert(recv_count is not None and n == s0 * s1 * recv_count,
                    "ring2d reduce_scatter needs count == G*recv_count (count %d, G %d, "
                    "recv_count %s)", n, s0 * s1, recv_count)

        def prep_rs(buf):
            # a1-major chunk order, so the two scatters land group chunk
            # i0 * |a1| + i1 on member (i0, i1): a local relabelling
            grid = buf.shape[:NUM_GRID_AXES]
            return buf.reshape(*grid, s0, s1, recv_count).transpose(-3, -2).reshape(*grid, n)

        rs_a1, rs_a0 = scatter(a1, n), scatter(a0, n // s1)
        return prep_rs, [rs_a1, rs_a0], lambda buf: buf

    minor = live[-1]
    rest = tuple(a for a in group.axes if a != minor)
    a_minor = topo.axis_size(minor)
    m = -(-n // a_minor) * a_minor

    def prep(buf):
        return torch.nn.functional.pad(buf, (0, m - n)) if m != n else buf

    phases = [scatter(minor, m)]
    if rest:
        phases.append(build_collective("allreduce", sub(rest), op=ReductionType.SUM))
    phases.append(build_collective("allgather", sub([minor])))
    return prep, phases, lambda buf: buf[..., :n]
