"""The ``pallas_ring2d`` lowering: the fused ring over a 2-D group.

Counterpart of ``mlsl_tpu.comm.algos.pallas_ring2d``. The same kernel as
``pallas_ring`` (B3); only the ring order changes. The ring is the snake
(boustrophedon) cycle of a group over two live axes: even major rows walk the
minor axis up, odd rows down. Chunks enter in ring order (``_snake_perm``)
and leave in logical order, so each member's reduce_scatter slice is its own
group-position chunk, as with the baseline.
"""

from __future__ import annotations

from typing import Callable

from mlsl_tpu_torch.comm.algos.pallas_ring import build_ring
from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import mlsl_assert


def eligible(kind: str, group: ProcessGroup, op=None) -> bool:
    from mlsl_tpu_torch.ops import ring_kernels

    return ring_kernels.eligible_dense2d(kind, group, op)


def steps(kind: str, group: ProcessGroup, count: int, *, op=None, recv_count=None,
          bidir: bool = False, plain: bool = False):
    """The staged form: one phase, one launch over the snake cycle."""
    from mlsl_tpu_torch.ops import ring_kernels

    mlsl_assert(eligible(kind, group, op), "pallas_ring2d cannot lower %s on this group",
                kind)
    return ring_kernels.steps(kind, group, count, recv_count=recv_count, bidir=bidir,
                              snake=True, plain=plain)


def build(kind: str, group: ProcessGroup, *, op=None, recv_count=None, bidir: bool = False,
          plain: bool = False, **_) -> Callable:
    mlsl_assert(eligible(kind, group, op), "pallas_ring2d cannot lower %s on this group",
                kind)
    return build_ring(kind, group, snake=True, recv_count=recv_count, bidir=bidir,
                      plain=plain)
