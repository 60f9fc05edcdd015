"""Session, OperationRegInfo, Operation: graph registration and commit.

Counterpart of ``mlsl_tpu.core.session`` (reference include/mlsl.hpp:510-798,
src/mlsl_impl.cpp:540-600): a Session collects Operations sharing a global
minibatch size; each Operation is registered from an OperationRegInfo
(activation shapes + parameter sets) against a Distribution; Commit
finalizes every edge (the peer-connection case of each, core/activation.py),
calibrates the gradient sets' codecs under ``MLSL_TUNE_CODEC``
(tuner/calibrate.py), forms the gradient buckets (``MLSL_GRAD_BUCKET_MB``,
core/bucketing.py), runs every request once under ``MLSL_PRECOMPILE`` and,
with statistics on (``MLSL_STATS``), replays every request in isolation
(core/stats.py). The plan verifier of the JAX package is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from mlsl_tpu_torch.core.activation import Activation
from mlsl_tpu_torch.core.parameter_set import ParameterSet
from mlsl_tpu_torch.core.stats import Statistics
from mlsl_tpu_torch.log import log_debug, mlsl_assert
from mlsl_tpu_torch.types import CompressionType, DataType, OpType, PhaseType


@dataclasses.dataclass
class _RegEntry:
    count: int
    size: int
    data_type: DataType
    distributed_update: bool = False
    compression: CompressionType = CompressionType.NONE


class OperationRegInfo:
    """Shape registration for one Operation (reference include/mlsl.hpp:510-556)."""

    def __init__(self, op_type: OpType):
        self.op_type = OpType(op_type)
        self.name = ""
        self.inputs: List[_RegEntry] = []
        self.outputs: List[_RegEntry] = []
        self.parameter_sets: List[_RegEntry] = []

    def set_name(self, name: str) -> None:
        self.name = name

    def add_input(self, count: int, size: int, data_type=DataType.FLOAT) -> int:
        self.inputs.append(_RegEntry(int(count), int(size), DataType(data_type)))
        return len(self.inputs) - 1

    def add_output(self, count: int, size: int, data_type=DataType.FLOAT) -> int:
        self.outputs.append(_RegEntry(int(count), int(size), DataType(data_type)))
        return len(self.outputs) - 1

    def add_parameter_set(
        self,
        kernel_count: int,
        kernel_size: int,
        data_type=DataType.FLOAT,
        distributed_update: bool = False,
        compression_type=CompressionType.NONE,
    ) -> int:
        self.parameter_sets.append(
            _RegEntry(
                int(kernel_count),
                int(kernel_size),
                DataType(data_type),
                bool(distributed_update),
                CompressionType(compression_type),
            )
        )
        return len(self.parameter_sets) - 1

    def validate(self) -> None:
        if self.op_type == OpType.DATA:
            mlsl_assert(not self.inputs, "DATA op cannot have inputs")
        if self.op_type == OpType.EVAL:
            mlsl_assert(not self.outputs, "EVAL op cannot have outputs")

    # PascalCase parity aliases
    SetName = set_name
    AddInput = add_input
    AddOutput = add_output
    AddParameterSet = add_parameter_set


_RAGGED_MSG = ("operations require equal-sized color groups: the minibatch/kernel "
               "partitioning assumes a uniform group size (ragged partitions support "
               "Distribution collectives only)")


class Operation:
    """One graph node (reference include/mlsl.hpp:564-645)."""

    def __init__(self, reg: OperationRegInfo, session: "Session", distribution, op_idx: int):
        reg.validate()
        self.session = session
        self.distribution = None
        self._reg = reg
        self.op_type = reg.op_type
        self.name = reg.name or f"op{op_idx}"
        self.op_idx = op_idx
        self.inputs: List[Activation] = []
        self.outputs: List[Activation] = []
        self.parameter_sets: List[ParameterSet] = []
        if distribution is not None:
            self.set_distribution(distribution)

    def set_distribution(self, distribution) -> None:
        """Bind the parallelism layout; activations and parameter sets are
        derived here because their partitioning depends on the grid."""
        mlsl_assert(self.distribution is None, "distribution can be set only once")
        mlsl_assert(not getattr(distribution, "is_ragged", False), _RAGGED_MSG)
        self.distribution = distribution
        reg = self._reg
        data_size = distribution.get_process_count_data()
        global_mb = self.session.global_minibatch_size
        mlsl_assert(
            global_mb % data_size == 0,
            "global minibatch %d not divisible by data parts %d",
            global_mb,
            data_size,
        )
        self.global_minibatch_size = global_mb
        self.local_minibatch_size = global_mb // data_size
        self.inputs = [Activation(self, r, True, i) for i, r in enumerate(reg.inputs)]
        self.outputs = [Activation(self, r, False, i) for i, r in enumerate(reg.outputs)]
        self.parameter_sets = [
            ParameterSet(self, r, i) for i, r in enumerate(reg.parameter_sets)
        ]

    def get_op_type(self) -> OpType:
        return self.op_type

    def get_name(self) -> str:
        return self.name

    def get_distribution(self):
        return self.distribution

    def get_session(self):
        return self.session

    def get_global_minibatch_size(self) -> int:
        return self.global_minibatch_size

    def get_local_minibatch_size(self) -> int:
        return self.local_minibatch_size

    def get_global_minibatch_offset(self, data_idx: int = 0) -> int:
        return self.local_minibatch_size * data_idx

    def get_input_count(self) -> int:
        return len(self.inputs)

    def get_input(self, idx: int) -> Activation:
        return self.inputs[idx]

    def get_output_count(self) -> int:
        return len(self.outputs)

    def get_output(self, idx: int) -> Activation:
        return self.outputs[idx]

    def get_parameter_set_count(self) -> int:
        return len(self.parameter_sets)

    def has_parameter_sets(self) -> bool:
        return bool(self.parameter_sets)

    def get_parameter_set(self, idx: int) -> ParameterSet:
        return self.parameter_sets[idx]

    def set_prev(self, prev: Optional["Operation"], input_idx: int, prev_out_idx: int) -> None:
        act = self.inputs[input_idx]
        if prev is None:
            act.set_peer(None)
            return
        mlsl_assert(prev.session is self.session, "different sessions")
        prev.outputs[prev_out_idx].set_peer(act)

    def set_next(self, nxt: Optional["Operation"], output_idx: int, next_in_idx: int) -> None:
        act = self.outputs[output_idx]
        if nxt is None:
            act.set_peer(None)
            return
        mlsl_assert(nxt.session is self.session, "different sessions")
        act.set_peer(nxt.inputs[next_in_idx])

    # PascalCase parity aliases
    GetOpType = get_op_type
    GetName = get_name
    GetDistribution = get_distribution
    GetSession = get_session
    GetGlobalMinibatchSize = get_global_minibatch_size
    GetLocalMinibatchSize = get_local_minibatch_size
    GetGlobalMinibatchOffset = get_global_minibatch_offset
    GetInputCount = get_input_count
    GetInput = get_input
    GetOutputCount = get_output_count
    GetOutput = get_output
    GetParameterSetCount = get_parameter_set_count
    GetParameterSet = get_parameter_set
    HasParameterSets = has_parameter_sets
    SetDistribution = set_distribution
    SetPrev = set_prev
    SetNext = set_next


class Session:
    """A collection of Operations with one global minibatch size
    (reference include/mlsl.hpp:731-797)."""

    def __init__(self, env, phase_type: PhaseType = PhaseType.TRAIN):
        self.env = env
        self.phase_type = PhaseType(phase_type)
        self.global_minibatch_size = 0
        self.operations: List[Operation] = []
        self.stats = Statistics(self)
        self._committed = False
        self._valid = True

    def _invalidate(self):
        self._valid = False

    def set_global_minibatch_size(self, size: int) -> None:
        mlsl_assert(size > 0, "global minibatch size must be positive")
        self.global_minibatch_size = int(size)

    def get_global_minibatch_size(self) -> int:
        return self.global_minibatch_size

    def get_phase_type(self) -> PhaseType:
        return self.phase_type

    def create_operation_reg_info(self, op_type: OpType) -> OperationRegInfo:
        return OperationRegInfo(op_type)

    def delete_operation_reg_info(self, reg: OperationRegInfo) -> None:
        """The collector owns a reg info; kept for the reference API."""
        return None

    def add_operation(self, reg: OperationRegInfo, distribution=None) -> int:
        """Register an operation; ``distribution`` may be bound later with
        Operation.set_distribution, before Commit."""
        mlsl_assert(self.global_minibatch_size > 0, "set global minibatch size first")
        mlsl_assert(distribution is None or not getattr(distribution, "is_ragged", False),
                    _RAGGED_MSG)
        op = Operation(reg, self, distribution, len(self.operations))
        self.operations.append(op)
        return len(self.operations) - 1

    add_operation_with_distribution = add_operation

    def remove_operations(self) -> None:
        self.operations.clear()
        self._committed = False

    def get_operation_count(self) -> int:
        return len(self.operations)

    def get_operation(self, idx: int) -> Operation:
        return self.operations[idx]

    def get_stats(self) -> Statistics:
        return self.stats

    def commit(self) -> None:
        """Finalize all graph edges (reference SessionImpl::Commit,
        src/mlsl_impl.cpp:567-578): the peer connection over both ends of
        every edge; then, with ``tune_codec``, the codec calibration; with
        ``grad_bucket_mb`` > 0, the gradient buckets;
        with ``precompile``, one run of every request; then the statistics,
        and with them on the isolation replay (session.py:287-335 of the JAX
        package). Gradient requests were set up when their operations bound a
        distribution."""
        for op in self.operations:
            mlsl_assert(
                op.distribution is not None,
                "operation %s has no distribution bound at Commit", op.name,
            )
        for op in self.operations:
            for act in op.outputs + op.inputs:
                act.init_peer_connection()
        self._committed = True
        cfg = self.env.config
        if cfg is not None and cfg.tune_codec:
            # MLSL_TUNE_CODEC=1: assign each set its codec before the
            # buckets form, so that they partition on the calibrated codecs
            from mlsl_tpu_torch.tuner.calibrate import calibrate_session

            calibrate_session(self)
        if cfg is not None and cfg.grad_bucket_mb > 0:
            from mlsl_tpu_torch.core.bucketing import build_buckets

            build_buckets(self, cfg.grad_bucket_mb)
        if cfg is not None and cfg.precompile:
            self.precompile_collectives()
        self.stats.initialize()
        if cfg is not None and cfg.enable_stats:
            self.stats.collect_isolation_stats()

    def precompile_collectives(self) -> int:
        """Run every request of the committed graph once on zero buffers --
        activation edges, gradient and increment requests, and the buckets'
        coalesced requests -- so that the first step builds no kernel, table
        or plan (``Session.precompile_collectives``, session.py:336-380 of
        the JAX package). Round state is left as it was. -> the number of
        programs run. The JAX package keys its plan cache by each request's
        algorithm, and a ``hier`` request also by its DCN codec and tier
        split, so that a changed codec is warmed again; the port keeps no
        plan cache and warms every request of the graph at each commit,
        under the codec it was built with (``req._hier_meta``)."""
        n = 0
        seen = set()

        def warm(req):
            nonlocal n
            if req is None or not req.is_setup or id(req) in seen:
                return
            seen.add(id(req))
            n += req.precompile()

        for op in self.operations:
            for act in op.inputs + op.outputs:
                warm(act.comm_req)
            for ps in op.parameter_sets:
                warm(ps.grad_req)
                warm(ps.inc_req)
                for b in (ps.bucket, ps.inc_bucket):
                    if b is not None and id(b.req) not in seen:
                        seen.add(id(b.req))
                        n += b.precompile()
        if n:
            log_debug("precompile: %d collective program(s) run at commit", n)
        return n

    def _stat_event(self, entity, action: str, is_param: bool = False,
                    is_increment: bool = False):
        if self.stats.is_started():
            self.stats.update(entity, action, is_param, is_increment)

    # PascalCase parity aliases
    SetGlobalMinibatchSize = set_global_minibatch_size
    GetGlobalMinibatchSize = get_global_minibatch_size
    GetPhaseType = get_phase_type
    CreateOperationRegInfo = create_operation_reg_info
    DeleteOperationRegInfo = delete_operation_reg_info
    AddOperation = add_operation
    RemoveOperations = remove_operations
    GetOperationCount = get_operation_count
    GetOperation = get_operation
    GetStats = get_stats
    Commit = commit
    PrecompileCollectives = precompile_collectives
