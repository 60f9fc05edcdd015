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
"""

from __future__ import annotations

from typing import Callable

import torch

from mlsl_tpu_torch.comm.collectives import group_unview, group_view
from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import mlsl_assert


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
