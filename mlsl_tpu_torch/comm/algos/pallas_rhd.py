"""The ``pallas_rhd`` lowering: the latency-class allreduce, CUDA kernel B5.

Counterpart of ``mlsl_tpu.comm.algos.pallas_rhd``. Recursive
halving/doubling as one launch of ``ops.rhd_kernels.rhd_allreduce`` over the
world buffer. Selected when forced, by a tuned cell, or by the heuristic rung
for dense SUM allreduces inside the small-message band once
``MLSL_PALLAS_RHD`` armed it. The result is float32 whatever the input type,
as on the TPU.
"""

from __future__ import annotations

from typing import Callable

from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import mlsl_assert


def eligible(kind: str, group: ProcessGroup, op=None) -> bool:
    from mlsl_tpu_torch.ops import rhd_kernels

    return rhd_kernels.eligible(kind, group, op)


def steps(kind: str, group: ProcessGroup, count: int, *, op=None, plain: bool = False,
          **_):
    """The staged form: one phase, one launch, over distributed buffers."""
    mlsl_assert(eligible(kind, group, op), "pallas_rhd cannot lower %s on this group", kind)
    fn = build(kind, group, op=op, plain=plain)
    return (lambda buf: buf), [fn], (lambda buf: buf)


def build(kind: str, group: ProcessGroup, *, op=None, plain: bool = False, **_) -> Callable:
    """-> fn: distributed buffer -> float32 result buffer (``plain``: the
    kernel's plain version)."""
    from mlsl_tpu_torch.comm.collectives import world_view
    from mlsl_tpu_torch.ops import rhd_kernels

    mlsl_assert(eligible(kind, group, op), "pallas_rhd cannot lower %s on this group", kind)
    topo = group.topology
    plan = rhd_kernels.RhdPlan(group)
    run = rhd_kernels.rhd_allreduce_ref if plain else rhd_kernels.rhd_allreduce

    def fn(buf):
        out = run(world_view(buf, topo), plan)
        return out.reshape(*topo.grid_shape, out.shape[-1])

    return fn
