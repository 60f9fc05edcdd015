"""Activations, CommBlockInfo pack/unpack layouts, and the five peer-connection cases.

Counterpart of ``mlsl_tpu.core.activation`` (reference ActivationImpl,
src/mlsl_impl.cpp:36-347):

- feature-map partitioning: inputs and non-CC outputs hold
  globalFmCount / modelParts feature maps; a CC output holds ALL feature maps
  as partial sums and needs a reduction over the model group (needReduce);
- ``init_peer_connection`` picks one of five topology cases for each graph
  edge (:139-241): ReduceScatter + AllGather within one grid, AllReduce into a
  pure-data grid, the mixed-grid ReduceScatter, or AlltoAll either way;
- the ``_bi_pack_*`` / ``_bi_unpack_*`` functions give the CommBlockInfo
  layout that maps the rank-local activation (localMb, localFm, fmSize) to
  and from the wire buffer (:243-347).

Every activation request is a CommRequest through the algorithm engine, as in
the JAX package: case 1's and case 3's reduce_scatter and case 2's allreduce
take the fused ring (B3) or halving/doubling (B5) where selected, and the
alltoall of cases 4 and 5 the fused all-to-all (B6). The wire buffer is a
distributed tensor of the packed layout; ``pack_local`` / ``unpack_local``
build and read it, for one rank (numpy or torch) or for every rank of a
distributed tensor at once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from mlsl_tpu_torch.comm.request import CommDesc, CommRequest, ComputeType
from mlsl_tpu_torch.log import log_debug, mlsl_assert
from mlsl_tpu_torch.types import DataType, OpType


@dataclasses.dataclass(frozen=True)
class CommBlockInfo:
    """One pack/unpack block (reference include/mlsl.hpp:177-204)."""

    mb_offset: int
    mb_count: int
    fm_offset: int
    fm_count: int
    fm_size: int
    data_type: DataType
    buf_offset: int  # element offset into the wire buffer

    def get_mb_offset(self):
        return self.mb_offset

    def get_mb_count(self):
        return self.mb_count

    def get_fm_offset(self):
        return self.fm_offset

    def get_fm_count(self):
        return self.fm_count

    def get_fm_size(self):
        return self.fm_size

    def get_data_type(self):
        return self.data_type

    def get_buf_offset(self):
        return self.buf_offset

    GetMbOffset = get_mb_offset
    GetMbCount = get_mb_count
    GetFmOffset = get_fm_offset
    GetFmCount = get_fm_count
    GetFmSize = get_fm_size
    GetDataType = get_data_type
    GetBufOffset = get_buf_offset


def _lead(x, local_mb: int, local_fm: int, fm_size: int):
    """The leading (rank) dims of an activation: () for one rank's
    activation, flat or (localMb, localFm, fmSize), else every dim before the
    last (a distributed buffer (R, D, S, M, localMb * localFm * fmSize))."""
    if x.ndim == 1 or tuple(x.shape) == (local_mb, local_fm, fm_size):
        return ()
    mlsl_assert(x.shape[-1] == local_mb * local_fm * fm_size,
                "activation of shape %s does not hold %d x %d x %d elements a rank",
                tuple(x.shape), local_mb, local_fm, fm_size)
    return tuple(x.shape[:-1])


def pack_local(act_local, blocks: List[CommBlockInfo], local_mb: int, local_fm: int,
               fm_size: int):
    """Pack a local activation (localMb, localFm, fmSize) into the wire layout:
    the reference test's PackBuffer loop (mlsl_test.cpp:214-233). Takes a
    numpy array or a tensor; a tensor (*ranks, localMb * localFm * fmSize)
    packs every rank at once into (*ranks, wire)."""
    lead = _lead(act_local, local_mb, local_fm, fm_size)
    a = act_local.reshape(*lead, local_mb, local_fm, fm_size)
    total = sum(b.mb_count * b.fm_count * b.fm_size for b in blocks)
    if isinstance(a, np.ndarray):
        out = np.zeros((*lead, total), dtype=a.dtype)
    else:
        out = a.new_zeros((*lead, total))
    for b in blocks:
        n = b.mb_count * b.fm_count * b.fm_size
        out[..., b.buf_offset:b.buf_offset + n] = a[
            ..., b.mb_offset:b.mb_offset + b.mb_count,
            b.fm_offset:b.fm_offset + b.fm_count, :b.fm_size,
        ].reshape(*lead, n)
    return out


def unpack_local(wire, blocks: List[CommBlockInfo], local_mb: int, local_fm: int,
                 fm_size: int):
    """Inverse of ``pack_local``: wire layout -> (localMb, localFm, fmSize), or
    (*ranks, localMb, localFm, fmSize) for a tensor (*ranks, wire)."""
    lead = tuple(wire.shape[:-1])
    if isinstance(wire, np.ndarray):
        a = np.zeros((*lead, local_mb, local_fm, fm_size), dtype=wire.dtype)
    else:
        a = wire.new_zeros((*lead, local_mb, local_fm, fm_size))
    for b in blocks:
        n = b.mb_count * b.fm_count * b.fm_size
        a[..., b.mb_offset:b.mb_offset + b.mb_count,
          b.fm_offset:b.fm_offset + b.fm_count, :b.fm_size] = wire[
            ..., b.buf_offset:b.buf_offset + n].reshape(*lead, b.mb_count, b.fm_count,
                                                        b.fm_size)
    return a


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
        self.comm_req: Optional[CommRequest] = None
        self.pack_blocks: List[CommBlockInfo] = []
        self.unpack_blocks: List[CommBlockInfo] = []
        self.tmp_buf_offset = 0

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

    def get_pack_block_count(self) -> int:
        return len(self.pack_blocks)

    def get_pack_block(self, idx: int) -> CommBlockInfo:
        return self.pack_blocks[idx]

    def get_unpack_block_count(self) -> int:
        return len(self.unpack_blocks)

    def get_unpack_block(self, idx: int) -> CommBlockInfo:
        return self.unpack_blocks[idx]

    # -- graph wiring -----------------------------------------------------

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

    # -- the five cases (reference src/mlsl_impl.cpp:139-241) --------------

    def init_peer_connection(self) -> None:
        if self.peer_act is None:
            return
        out_act = self.peer_act if self.is_input else self
        in_act = self if self.is_input else self.peer_act
        if out_act.comm_req is not None or in_act.comm_req is not None:
            return  # already connected from the other side
        out_dist = out_act.dist
        in_dist = in_act.dist
        world = out_dist.get_process_count_global()

        if world > 1 and (out_act.need_reduce or out_dist is not in_dist):
            out_act.need_comm = True
            in_act.need_comm = True
        if not out_act.need_comm:
            return

        env = out_act.op.session.env
        out_model = out_dist.get_process_count_model()
        in_model = in_dist.get_process_count_model()
        out_data = out_dist.get_process_count_data()
        in_data = in_dist.get_process_count_data()
        dt = out_act.data_type

        def mk(kind, group, **kw):
            # op-attributed name, as the JAX package's '<op>/<kind>'
            req = CommRequest(
                CommDesc(kind, group, kw.pop("count"), dt, **kw), env.dispatcher,
                name=f"{out_act.op.name}/{kind}",
            )
            req.setup()
            return req

        if out_act.need_reduce and out_dist is in_dist:
            log_debug("peer connection case 1 (ReduceScatter fwd / AllGather bwd)")
            n = in_act.local_fm_count * self.op.get_local_minibatch_size() * in_act.fm_size
            out_act.comm_req = mk(
                "reduce_scatter",
                in_dist.model_group,
                count=n * in_model,
                compute_type=ComputeType.FPROP,
                op=0,
                recv_count=n,
            )
            out_act._bi_pack_reduce_scatter()
            in_act._bi_unpack_reduce_scatter()
            in_act.comm_req = mk(
                "allgather",
                in_dist.model_group,
                count=n,
                compute_type=ComputeType.BPROP,
            )
            in_act._bi_pack_allgather()
            out_act._bi_unpack_allgather()
        elif (
            out_act.need_reduce
            and in_model == 1
            and out_data == in_data
        ):
            log_debug("peer connection case 2 (AllReduce fwd / no bwd comm)")
            n = (
                out_act.local_fm_count
                * out_act.op.get_local_minibatch_size()
                * out_act.fm_size
            )
            out_act.comm_req = mk(
                "allreduce",
                out_dist.model_group,
                count=n,
                compute_type=ComputeType.FPROP,
                op=0,
            )
            out_act._bi_pack_allreduce()
            in_act._bi_unpack_allreduce()
            in_act.comm_req = None  # reference: empty request (no ops)
        elif (
            out_act.need_reduce
            and in_model == 1
            and in_data % out_data == 0
            and in_data == out_model * out_data
        ):
            log_debug("peer connection case 3 (mixed-grid ReduceScatter/AllGather)")
            n = in_act.local_fm_count * in_act.op.get_local_minibatch_size() * in_act.fm_size
            out_act.comm_req = mk(
                "reduce_scatter",
                out_dist.model_group,
                count=n * out_model,
                compute_type=ComputeType.FPROP,
                op=0,
                recv_count=n,
            )
            out_act._bi_pack_reduce_scatter2()
            in_act._bi_unpack_reduce_scatter()
            in_act.comm_req = mk(
                "allgather",
                out_dist.model_group,
                count=n,
                compute_type=ComputeType.BPROP,
            )
            in_act._bi_pack_allgather()
            out_act._bi_unpack_allgather2()
        elif (not out_act.need_reduce) and out_model == 1:
            log_debug("peer connection case 4 (AlltoAll over in model group)")
            n = in_act.local_fm_count * out_act.op.get_local_minibatch_size() * in_act.fm_size
            out_act.comm_req = mk(
                "alltoall",
                in_dist.model_group,
                count=n,
                compute_type=ComputeType.FPROP,
            )
            out_act._bi_build_alltoall(in_act)
            in_act.comm_req = mk(
                "alltoall",
                in_dist.model_group,
                count=n,
                compute_type=ComputeType.BPROP,
            )
            in_act._bi_build_alltoall(out_act)
        elif (not out_act.need_reduce) and in_model == 1:
            log_debug("peer connection case 5 (AlltoAll over out model group)")
            n = out_act.local_fm_count * in_act.op.get_local_minibatch_size() * out_act.fm_size
            out_act.comm_req = mk(
                "alltoall",
                out_dist.model_group,
                count=n,
                compute_type=ComputeType.FPROP,
            )
            out_act._bi_build_alltoall(in_act)
            in_act.comm_req = mk(
                "alltoall",
                out_dist.model_group,
                count=n,
                compute_type=ComputeType.BPROP,
            )
            in_act._bi_build_alltoall(out_act)
        else:
            mlsl_assert(False, "this activation topology case is not supported yet")

    # -- block-layout math (reference src/mlsl_impl.cpp:243-347) ----------

    def _bi_pack_reduce_scatter(self):
        model_parts = self.dist.get_process_count_model()
        local_mb = self.op.get_local_minibatch_size()
        fm = self.local_fm_count // model_parts
        self.pack_blocks = [
            CommBlockInfo(0, local_mb, i * fm, fm, self.fm_size, self.data_type,
                          i * local_mb * fm * self.fm_size)
            for i in range(model_parts)
        ]
        self.tmp_buf_offset = model_parts * local_mb * fm * self.fm_size

    def _bi_pack_reduce_scatter2(self):
        model_parts = self.dist.get_process_count_model()
        local_mb = self.op.get_local_minibatch_size() // model_parts
        fm = self.local_fm_count
        self.pack_blocks = [
            CommBlockInfo(i * local_mb, local_mb, 0, fm, self.fm_size, self.data_type,
                          i * local_mb * fm * self.fm_size)
            for i in range(model_parts)
        ]
        self.tmp_buf_offset = model_parts * local_mb * fm * self.fm_size

    def _bi_unpack_reduce_scatter(self):
        self.unpack_blocks = [
            CommBlockInfo(0, self.op.get_local_minibatch_size(), 0,
                          self.local_fm_count, self.fm_size, self.data_type, 0)
        ]

    def _bi_pack_allreduce(self):
        local_mb = self.op.get_local_minibatch_size()
        self.pack_blocks = [
            CommBlockInfo(0, local_mb, 0, self.local_fm_count, self.fm_size,
                          self.data_type, 0)
        ]
        self.tmp_buf_offset = local_mb * self.local_fm_count * self.fm_size

    def _bi_unpack_allreduce(self):
        self.unpack_blocks = [
            CommBlockInfo(0, self.op.get_local_minibatch_size(), 0,
                          self.local_fm_count, self.fm_size, self.data_type, 0)
        ]

    def _bi_pack_allgather(self):
        # offset 0 on the wire: the gather's member order places each rank's
        # block, where the reference needs the explicit fmIdx offset
        # (src/mlsl_impl.cpp:287-294)
        local_mb = self.op.get_local_minibatch_size()
        self.pack_blocks = [
            CommBlockInfo(0, local_mb, 0, self.local_fm_count, self.fm_size,
                          self.data_type, 0)
        ]

    def _bi_unpack_allgather(self):
        model_parts = self.dist.get_process_count_model()
        local_mb = self.op.get_local_minibatch_size()
        fm = self.local_fm_count // model_parts
        self.unpack_blocks = [
            CommBlockInfo(0, local_mb, i * fm, fm, self.fm_size, self.data_type,
                          i * local_mb * fm * self.fm_size)
            for i in range(model_parts)
        ]

    def _bi_unpack_allgather2(self):
        model_parts = self.dist.get_process_count_model()
        local_mb = self.op.get_local_minibatch_size() // model_parts
        fm = self.local_fm_count
        self.unpack_blocks = [
            CommBlockInfo(i * local_mb, local_mb, 0, fm, self.fm_size, self.data_type,
                          i * local_mb * fm * self.fm_size)
            for i in range(model_parts)
        ]

    def _bi_build_alltoall(self, other: "Activation"):
        """Blocked AlltoAll layout for redistribution (reference :313-347)."""
        out_act = self
        in_act = other
        out_model = out_act.dist.get_process_count_model()
        in_model = in_act.dist.get_process_count_model()
        mlsl_assert(
            out_model == 1 or in_model == 1, "one of the model group sizes should be 1"
        )
        local_mb = min(
            out_act.op.get_local_minibatch_size(), in_act.op.get_local_minibatch_size()
        )
        fmx = min(
            out_act.local_fm_count * out_act.fm_size,
            in_act.local_fm_count * in_act.fm_size,
        )
        my_fm = fmx // self.fm_size
        blocks = []
        idx = 0
        for i in range(0, self.op.get_local_minibatch_size(), local_mb):
            for j in range(0, self.local_fm_count, my_fm):
                blocks.append(
                    CommBlockInfo(i, local_mb, j, my_fm, self.fm_size, self.data_type,
                                  idx * local_mb * fmx)
                )
                idx += 1
        if self.is_input:
            self.unpack_blocks = blocks
        else:
            self.pack_blocks = blocks
        group = in_act.dist.model_group if out_model == 1 else out_act.dist.model_group
        self.tmp_buf_offset = group.size * local_mb * fmx

    # -- runtime ----------------------------------------------------------

    def get_comm_buf_size(self) -> int:
        """The element count a rank's packed wire buffer has for this
        activation's request."""
        if self.comm_req is None:
            return 0
        return self.comm_req.desc.count

    def get_comm_buf(self):
        """The last result of this activation's request, or None (the
        reference returns its staging buffer)."""
        if self.comm_req is None:
            return None
        return self.comm_req._result

    def start_comm(self, buf) -> None:
        """Start this activation's collective on the packed distributed buffer
        (reference ActivationImpl::StartComm src/mlsl_impl.cpp:354-369). The
        output owns FPROP, the input owns BPROP."""
        self.op.session._stat_event(self, "start")
        if self.need_comm and self.comm_req is not None:
            self.comm_req.start(buf)
        self.op.session._stat_event(self, "start_done")

    def wait_comm(self):
        """Wait on the PEER's request: WaitComm completes the peer's transfer
        (src/mlsl_impl.cpp:377-380). -> the received distributed buffer, or
        None where the edge moves nothing in this direction."""
        self.op.session._stat_event(self, "wait")
        out = None
        if self.need_comm and self.peer_act is not None and self.peer_act.comm_req is not None:
            if self.peer_act.comm_req.is_started:
                out = self.peer_act.comm_req.wait()
            else:
                out = self.peer_act.comm_req._result
        self.op.session._stat_event(self, "wait_done")
        return out

    # PascalCase parity aliases
    GetGlobalFmCount = get_global_fm_count
    GetGlobalFmOffset = get_global_fm_offset
    GetLocalFmCount = get_local_fm_count
    GetFmSize = get_fm_size
    GetDataType = get_data_type
    IsNeedComm = is_need_comm
    GetPackBlockCount = get_pack_block_count
    GetPackBlock = get_pack_block
    GetUnpackBlockCount = get_unpack_block_count
    GetUnpackBlock = get_unpack_block
    GetCommBufSize = get_comm_buf_size
    GetCommBuf = get_comm_buf
    StartComm = start_comm
    WaitComm = wait_comm
