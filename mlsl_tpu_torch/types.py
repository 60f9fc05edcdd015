"""Public enums and small value types.

The PyTorch counterpart of ``mlsl_tpu.types`` (reference API surface
include/mlsl.hpp:88-172). The enum values are identical to the JAX package's,
so a ``DataType`` or ``CompressionType`` number means the same thing in both;
only the dtype table maps to ``torch`` dtypes instead of ``jnp`` ones.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class DataType(enum.IntEnum):
    """Element types for activations and parameters (reference include/mlsl.hpp:88-93)."""

    FLOAT = 0
    DOUBLE = 1
    BYTE = 2
    BFLOAT16 = 3
    FLOAT16 = 4
    INT8 = 5
    INT32 = 6


_TORCH_DTYPES = {
    DataType.FLOAT: torch.float32,
    DataType.DOUBLE: torch.float64,
    DataType.BYTE: torch.uint8,
    DataType.BFLOAT16: torch.bfloat16,
    DataType.FLOAT16: torch.float16,
    DataType.INT8: torch.int8,
    DataType.INT32: torch.int32,
}

_DTYPE_SIZES = {
    DataType.FLOAT: 4,
    DataType.DOUBLE: 8,
    DataType.BYTE: 1,
    DataType.BFLOAT16: 2,
    DataType.FLOAT16: 2,
    DataType.INT8: 1,
    DataType.INT32: 4,
}


def torch_dtype(dt: DataType) -> torch.dtype:
    """DataType -> torch dtype."""
    return _TORCH_DTYPES[DataType(dt)]


def dtype_size(dt: DataType) -> int:
    """Element size in bytes (reference: dataTypeSize in src/mlsl_impl.cpp:251)."""
    return _DTYPE_SIZES[DataType(dt)]


class PhaseType(enum.IntEnum):
    """Training vs testing phase (reference include/mlsl.hpp:96-100)."""

    TRAIN = 0
    TEST = 1


class GroupType(enum.IntEnum):
    """Process-group selector (reference include/mlsl.hpp:114-119), plus SEQ for
    the sequence axis of the (replica, data, seq, model) grid."""

    DATA = 0
    MODEL = 1
    GLOBAL = 2
    SEQ = 3


class ReductionType(enum.IntEnum):
    """Reduction ops for Reduce/AllReduce/ReduceScatter (reference include/mlsl.hpp:122-127)."""

    SUM = 0
    MIN = 1
    MAX = 2


class OpType(enum.IntEnum):
    """Compute-operation kinds (reference include/mlsl.hpp:136-148)."""

    CC = 0      # cross-correlation: IA and OA independent, has parameters
    BIAS = 1    # same IA/OA, has parameters
    ACT = 2     # same IA/OA, no parameters
    POOL = 3    # same IA/OA, no parameters
    SPLIT = 4   # OA depends on IA (=OA1+OA2...), no parameters
    CONCAT = 5  # OA = concat(IA1, IA2, ...), no parameters
    BCAST = 6   # OA1 = IA, OA2 = IA, ...
    REDUCE = 7  # OA = IA1 + IA2 + ...
    DATA = 8    # only OA (input layer)
    EVAL = 9    # only IA (loss layer)


class CompressionType(enum.IntEnum):
    """Gradient-compression selector (reference include/mlsl.hpp:151-155).

    QUANTIZATION is the int8 block codec with error feedback. TOPK keeps its
    number for parity with the JAX package; its sparse wire is not part of
    this package yet, and a request that asks for it is refused at setup."""

    NONE = 0
    QUANTIZATION = 1
    TOPK = 2


@dataclasses.dataclass
class QuantParams:
    """Quantization configuration (reference include/mlsl.hpp:162-171), the
    fields of ``mlsl_tpu.types.QuantParams``: the built-in int8 block
    codec's geometry (``elem_in_block``), or a user codec given as
    callables on torch tensors (``compress_fn`` ...) or as a library of the
    reference's ABI (``lib_path`` + symbol names); see comm/codec.py."""

    block_size: int = 256        # bytes per quantized block (scale + int8 payload)
    elem_in_block: int = 256     # elements quantized per block (one shared scale)
    lib_path: str | None = None
    quant_buffer_func_name: str | None = None
    dequant_buffer_func_name: str | None = None
    reduce_sum_func_name: str | None = None
    compress_fn: object = None
    decompress_fn: object = None
    reduce_sum_fn: object = None
