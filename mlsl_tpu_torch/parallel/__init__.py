"""Parallelism schedules beyond the grid: sequence/context parallelism primitives.

Counterpart of ``mlsl_tpu.parallel``: all-to-all head/sequence re-sharding
(Ulysses) and neighbour-exchange rings (ring and zigzag attention), over the
virtual ranks of one device. The pipeline schedules come later.
"""

from mlsl_tpu_torch.parallel.sequence import (
    ring_attention,
    ulysses_attention,
    zigzag_ring_attention,
)

__all__ = ["ring_attention", "ulysses_attention", "zigzag_ring_attention"]
