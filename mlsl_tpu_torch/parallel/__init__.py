"""Parallelism schedules beyond the grid: sequence/context parallelism and
pipeline parallelism.

Counterpart of ``mlsl_tpu.parallel``, over the virtual ranks of one device:
all-to-all head/sequence re-sharding (Ulysses) and neighbour-exchange rings
(ring and zigzag attention), and the pipeline schedules (GPipe, 1F1B,
interleaved 1F1B) with the data-parallel reduction of their stage gradients.
"""

from mlsl_tpu_torch.parallel.pipeline import (
    f1b_schedule,
    gpipe_forward,
    interleaved_1f1b_step,
    interleaved_schedule,
    one_f1b_step,
    pad_stage_weights,
    pipeline_loss,
    reduce_microbatch_grads,
)
from mlsl_tpu_torch.parallel.sequence import (
    ring_attention,
    ulysses_attention,
    zigzag_ring_attention,
)

__all__ = [
    "f1b_schedule",
    "gpipe_forward",
    "interleaved_1f1b_step",
    "interleaved_schedule",
    "one_f1b_step",
    "pad_stage_weights",
    "pipeline_loss",
    "reduce_microbatch_grads",
    "ring_attention",
    "ulysses_attention",
    "zigzag_ring_attention",
]
