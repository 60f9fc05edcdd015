"""Mixture-of-experts helpers.

Counterpart of the part of ``mlsl_tpu.models.moe`` that the dense
transformer uses: ``mxu_einsum``. ``moe_ffn``, its routing and the expert
all-to-all (kernel B6) come with the MoE slice.
"""

from __future__ import annotations

import torch


def mxu_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Einsum with a float32 result from (possibly) bfloat16 operands.

    On the TPU this is the matrix unit's contract, bf16 in and f32 out. A
    PyTorch bf16 product returns bf16, rounding its float32 sum once more, so
    the operands are upcast and the product runs in float32 (full float32 on
    the card: TF32 is off by default for matrix products)."""
    return torch.einsum(spec, a.float(), b.float())
