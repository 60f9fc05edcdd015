"""The ``pallas_ring`` lowering: the fused ring, CUDA kernel B3.

Counterpart of ``mlsl_tpu.comm.algos.pallas_ring`` (:40-59). The dense
allreduce / reduce_scatter of a single-live-axis group runs as one launch of
``ops.ring_kernels.dense_ring`` over the world buffer. The int8 variant (B4)
is a compressed wire and rides ``quant_ring.build_quantized_collective``
(``ring="pallas"``), which the request layer selects through the same table.
The name is the JAX registry's.
"""

from __future__ import annotations

from typing import Callable

from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import mlsl_assert


def eligible(kind: str, group: ProcessGroup, op=None) -> bool:
    from mlsl_tpu_torch.ops import ring_kernels

    return ring_kernels.eligible_dense(kind, group, op)


def steps(kind: str, group: ProcessGroup, count: int, *, op=None, recv_count=None,
          bidir: bool = False, plain: bool = False):
    """The staged form: one phase, one launch (``ops.ring_kernels.steps``)."""
    from mlsl_tpu_torch.ops import ring_kernels

    mlsl_assert(eligible(kind, group, op), "pallas_ring cannot lower %s on this group", kind)
    return ring_kernels.steps(kind, group, count, recv_count=recv_count, bidir=bidir,
                              plain=plain)


def build_ring(kind: str, group: ProcessGroup, *, snake: bool, recv_count=None,
               bidir: bool = False, plain: bool = False) -> Callable:
    """-> fn: distributed buffer -> result buffer through the dense ring
    kernel (``plain``: its plain version). The geometry resolves from the
    buffer length, one plan per length."""
    from mlsl_tpu_torch.comm.collectives import world_view
    from mlsl_tpu_torch.ops import ring_kernels as rk

    topo = group.topology
    run = rk.dense_ring_ref if plain else rk.dense_ring
    plans = {}

    def fn(buf):
        x = world_view(buf, topo)
        n = x.shape[1]
        plan = plans.get(n)
        if plan is None:
            plan = plans[n] = rk.dense_plan(kind, group, n, snake=snake, bidir=bidir,
                                            recv_count=recv_count)
        out = run(x, plan)
        return out.reshape(*topo.grid_shape, out.shape[-1])

    return fn


def build(kind: str, group: ProcessGroup, *, op=None, recv_count=None, bidir: bool = False,
          plain: bool = False, **_) -> Callable:
    mlsl_assert(eligible(kind, group, op), "pallas_ring cannot lower %s on this group", kind)
    return build_ring(kind, group, snake=False, recv_count=recv_count, bidir=bidir,
                      plain=plain)
