"""mlsl_tpu_torch -- the PyTorch/CUDA port of mlsl_tpu.

The same semantic model as ``mlsl_tpu`` (Intel MLSL's API: ``Environment`` /
``Session`` + ``Operation`` graph / ``Distribution`` grid / ``Activation`` +
``ParameterSet`` handles with asynchronous Start/Wait/Test collectives),
written in PyTorch for an NVIDIA H100. A world of virtual ranks lives in one
process on one card; collectives are tensor work over the grid dims of a
distributed buffer, and the int8 gradient codec runs as hand-written CUDA
kernels. The package imports neither ``jax`` nor ``mlsl_tpu``.
"""

from mlsl_tpu_torch.types import (
    CompressionType,
    DataType,
    GroupType,
    OpType,
    PhaseType,
    QuantParams,
    ReductionType,
)
from mlsl_tpu_torch.log import (
    MLSLCorruptionError,
    MLSLDeviceLossError,
    MLSLError,
    MLSLIntegrityError,
    MLSLTimeoutError,
)
from mlsl_tpu_torch.core.environment import Environment, get_env
from mlsl_tpu_torch.core.distribution import Distribution
from mlsl_tpu_torch.core.session import Operation, OperationRegInfo, Session
from mlsl_tpu_torch.core.activation import Activation
from mlsl_tpu_torch.core.parameter_set import ParameterSet
from mlsl_tpu_torch.core.stats import Statistics

__version__ = "0.1.0"

__all__ = [
    "DataType",
    "PhaseType",
    "GroupType",
    "ReductionType",
    "OpType",
    "CompressionType",
    "QuantParams",
    "Environment",
    "get_env",
    "Distribution",
    "Session",
    "Operation",
    "OperationRegInfo",
    "Activation",
    "ParameterSet",
    "Statistics",
    "MLSLError",
    "MLSLTimeoutError",
    "MLSLCorruptionError",
    "MLSLDeviceLossError",
    "MLSLIntegrityError",
]
