"""Activations: the structure ``Session.commit`` builds for an operation's
inputs and outputs.

The part of ``mlsl_tpu.core.activation`` (reference ActivationImpl,
src/mlsl_impl.cpp:36-66) that a pure data-parallel graph needs: feature-map
partitioning and the peer pairing. In such a graph no activation crosses
ranks. The five peer-connection cases and the CommBlockInfo pack/unpack
layouts come later; an edge that would need one of them is refused at commit.
"""

from __future__ import annotations

from typing import Optional

from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.types import DataType, OpType


class Activation:
    """An operation's input or output activation handle
    (reference include/mlsl.hpp:210-268)."""

    def __init__(self, op, reg, is_input: bool, index: int):
        self.op = op
        self.is_input = is_input
        self.act_index = index
        self.dist = op.distribution
        self.global_fm_count = reg.count
        self.fm_size = reg.size
        self.data_type = DataType(reg.data_type)
        self.need_comm = False
        self.peer_act: Optional["Activation"] = None
        self.comm_req = None

        model_size = self.dist.get_process_count_model()
        if (not is_input) and op.op_type == OpType.CC:
            # CC outputs hold partial sums over the full fm range
            # (reference src/mlsl_impl.cpp:44-51).
            self.local_fm_count = self.global_fm_count
            self.need_reduce = model_size > 1
        else:
            mlsl_assert(
                self.global_fm_count % model_size == 0,
                "feature-map count %d not divisible by model parts %d",
                self.global_fm_count,
                model_size,
            )
            self.local_fm_count = self.global_fm_count // model_size
            self.need_reduce = False

    def get_global_fm_offset(self, model_idx: int = 0) -> int:
        if (not self.is_input) and self.op.op_type == OpType.CC:
            return 0
        return self.local_fm_count * model_idx

    def get_global_fm_count(self) -> int:
        return self.global_fm_count

    def get_local_fm_count(self) -> int:
        return self.local_fm_count

    def get_fm_size(self) -> int:
        return self.fm_size

    def get_data_type(self) -> DataType:
        return self.data_type

    def is_need_comm(self) -> bool:
        return self.need_comm

    def set_peer(self, act: Optional["Activation"]) -> None:
        if act is None:
            self.peer_act = None
            self.need_comm = False
            return
        mlsl_assert(
            act.global_fm_count * act.fm_size == self.global_fm_count * self.fm_size,
            "prev output activation size must match current input activation size",
        )
        mlsl_assert(self.is_input != act.is_input, "input-output doesn't pair")
        mlsl_assert(self.data_type == act.data_type, "datatype must match")
        mlsl_assert(
            self.peer_act is None or self.peer_act is act, "peer can be set only once"
        )
        mlsl_assert(
            act.peer_act is None or act.peer_act is self,
            "peer activation is already paired with another edge",
        )
        self.peer_act = act
        act.peer_act = self

    def init_peer_connection(self) -> None:
        """Decide whether this edge communicates (reference
        src/mlsl_impl.cpp:139-241). Only the no-communication case is built."""
        if self.peer_act is None:
            return
        out_act = self.peer_act if self.is_input else self
        in_act = self if self.is_input else self.peer_act
        world = out_act.dist.get_process_count_global()
        needs = world > 1 and (out_act.need_reduce or out_act.dist is not in_act.dist)
        mlsl_assert(
            not needs,
            "activation edge %s -> %s needs a redistribution collective, which "
            "is not ported yet (pure data-parallel graphs only)",
            out_act.op.name, in_act.op.name,
        )

    # PascalCase parity aliases
    GetGlobalFmCount = get_global_fm_count
    GetGlobalFmOffset = get_global_fm_offset
    GetLocalFmCount = get_local_fm_count
    GetFmSize = get_fm_size
    GetDataType = get_data_type
    IsNeedComm = is_need_comm
