"""The ``pallas_a2a`` lowering: the fused all-to-all, CUDA kernel B6.

Counterpart of ``mlsl_tpu.comm.algos.pallas_a2a`` (:24-69), the ``alltoall``
kind's kernel algorithm: MoE dispatch and combine (models/moe.py, through
``algos.inline_alltoall``) and ``Distribution.all_to_all`` requests, with the
int8 blockwise codec (``Config.pallas_a2a_quant``, on by default) or dense.
``build`` gives the host-path program over distributed buffers; ``ef=True``
gives the stateful ``(buf, err) -> (out, new_err)`` entry error-feedback
form. The name is the JAX registry's.
"""

from __future__ import annotations

from typing import Callable

from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import mlsl_assert


def eligible(kind: str, group: ProcessGroup, op=None) -> bool:
    from mlsl_tpu_torch.ops import a2a_kernels

    return a2a_kernels.eligible(kind, group, op=op)


def build(kind: str, group: ProcessGroup, *, op=None, block: int = 256, quantized: bool = True,
          ef: bool = False, plain: bool = False, **_) -> Callable:
    """-> fn: distributed buffer (R, D, S, M, count) -> (R, D, S, M, count)
    float32, or with ``ef`` fn(buf, err) -> (out, new_err) with err (R, D, S,
    M, err_len). The geometry resolves from the buffer length, one body per
    length. ``plain`` runs the kernels' plain versions on any device."""
    from mlsl_tpu_torch.comm.collectives import world_view
    from mlsl_tpu_torch.ops import a2a_kernels

    mlsl_assert(eligible(kind, group, op), "pallas_a2a cannot lower %s on this group", kind)
    mlsl_assert(quantized or not ef, "the error-feedback form is quantized-only")
    topo = group.topology
    bodies = {}

    def body_for(n):
        body = bodies.get(n)
        if body is None:
            body, _ = a2a_kernels.alltoall_body_ef(group, n, block=block, quantized=quantized,
                                                   plain=plain)
            bodies[n] = body
        return body

    def fn(buf, err=None):
        out, new_err = body_for(buf.shape[-1])(
            world_view(buf, topo), None if err is None else world_view(err, topo))
        out = out.reshape(*topo.grid_shape, out.shape[-1])
        if not ef:
            return out
        return out, new_err.reshape(*topo.grid_shape, new_err.shape[-1])

    return fn
