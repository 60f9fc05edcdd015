"""Distribution: the data x model grid of virtual ranks and its collectives.

Counterpart of ``mlsl_tpu.core.distribution`` (reference include/mlsl.hpp:350-504,
DistributionImpl src/mlsl_impl.hpp:174-305), over the virtual-rank world of
comm/mesh.py. Each collective takes a distributed buffer -- one tensor of shape
(R, D, S, M, n) whose (r, d, s, m) row is that rank's local buffer -- and
returns a CommRequest already started (complete it with Environment.wait/test).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mlsl_tpu_torch.comm.mesh import (
    DATA_AXIS,
    GRID_AXES,
    MODEL_AXIS,
    SEQ_AXIS,
    ProcessGroup,
    Topology,
)
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.types import (
    CompressionType,
    DataType,
    GroupType,
    ReductionType,
    torch_dtype,
)


class Distribution:
    def __init__(self, env, data_parts: int, model_parts: int, seq_parts: int = 1):
        self.env = env
        self.device = env.device
        self.topology = Topology(data_parts, model_parts, env.world_size,
                                 seq_parts=seq_parts)
        self.data_parts = data_parts
        self.model_parts = model_parts
        self.seq_parts = seq_parts
        self.replica_count = self.topology.replica_count

        def axis_group(axis, parts):
            return ProcessGroup(self.topology, (axis,) if parts > 1 else ())

        self.data_group = axis_group(DATA_AXIS, data_parts)
        self.model_group = axis_group(MODEL_AXIS, model_parts)
        self.seq_group = axis_group(SEQ_AXIS, seq_parts)
        self.global_group = ProcessGroup(self.topology, GRID_AXES)
        # Parameter gradients sum over batch shards and sequence shards.
        self.grad_group = ProcessGroup(
            self.topology,
            tuple(a for a, n in ((DATA_AXIS, data_parts), (SEQ_AXIS, seq_parts)) if n > 1),
        )

    # -- introspection (reference include/mlsl.hpp:360-373) ---------------

    def _group(self, gt: GroupType) -> ProcessGroup:
        gt = GroupType(gt)
        if gt == GroupType.DATA:
            return self.data_group
        if gt == GroupType.MODEL:
            return self.model_group
        if gt == GroupType.SEQ:
            return self.seq_group
        return self.global_group

    def get_process_count(self, group_type: GroupType) -> int:
        return self._group(group_type).size

    def get_process_idx(self, group_type: GroupType, global_idx: int = 0) -> int:
        """Member index of world rank ``global_idx`` within the group (the
        single controller has no implicit 'my rank')."""
        return self._group(group_type).group_idx_of(global_idx)

    def get_process_count_data(self) -> int:
        return self.get_process_count(GroupType.DATA)

    def get_process_count_model(self) -> int:
        return self.get_process_count(GroupType.MODEL)

    def get_process_count_global(self) -> int:
        return self.topology.world_size

    def get_data_parts(self) -> int:
        return self.data_parts

    def get_model_parts(self) -> int:
        return self.model_parts

    def get_seq_parts(self) -> int:
        return self.seq_parts

    # -- buffer helpers ----------------------------------------------------

    @property
    def world_shape(self) -> Tuple[int, int, int, int]:
        return self.topology.grid_shape

    def make_buffer(self, per_rank_fn, count: int, data_type=DataType.FLOAT) -> torch.Tensor:
        """Distributed buffer from a function global_rank -> np.ndarray(count)."""
        n = self.topology.world_size
        host = np.stack([np.asarray(per_rank_fn(p)) for p in range(n)], axis=0)
        t = torch.from_numpy(np.ascontiguousarray(host)).to(torch_dtype(data_type))
        return t.reshape(*self.world_shape, count).to(self.device)

    def local_part(self, buf: torch.Tensor, global_idx: int) -> np.ndarray:
        """Rank-local row of a distributed buffer, on the host (bfloat16,
        which numpy lacks, comes back as float32)."""
        r, d, s, m = self.topology.coords(global_idx)
        row = buf[r, d, s, m].detach()
        if row.dtype == torch.bfloat16:
            row = row.to(torch.float32)
        return row.cpu().numpy()

    # -- collectives (reference include/mlsl.hpp:375-503) -----------------

    def _start(self, desc: CommDesc, buf) -> CommRequest:
        req = CommRequest(desc, self.env.dispatcher)
        req.setup()
        req.start(buf)
        self.env.request_storage.register(req)
        return req

    def bcast(self, buffer, count, data_type, root_idx, group_type) -> CommRequest:
        return self._start(
            CommDesc("bcast", self._group(group_type), int(count), DataType(data_type),
                     root=int(root_idx)),
            buffer,
        )

    def reduce(self, send_buffer, count, data_type, red_type, root_idx,
               group_type) -> CommRequest:
        return self._start(
            CommDesc("reduce", self._group(group_type), int(count), DataType(data_type),
                     op=ReductionType(red_type), root=int(root_idx)),
            send_buffer,
        )

    def all_reduce(self, send_buffer, count, data_type, red_type, group_type,
                   compression=None) -> CommRequest:
        """compression=CompressionType.QUANTIZATION routes the SUM through the
        int8 error-feedback ring (reference: quantized allreduce swaps in
        MPI_QUANT_OP, src/comm_ep.cpp:946-950)."""
        return self._start(
            CommDesc(
                "allreduce", self._group(group_type), int(count), DataType(data_type),
                op=ReductionType(red_type),
                compression=(CompressionType(compression) if compression is not None
                             else CompressionType.NONE),
            ),
            send_buffer,
        )

    def gather(self, send_buffer, send_count, data_type, root_idx,
               group_type) -> CommRequest:
        """The concatenation lands on every member (superset of root-only)."""
        return self._start(
            CommDesc("gather", self._group(group_type), int(send_count),
                     DataType(data_type), root=int(root_idx)),
            send_buffer,
        )

    def all_gather(self, send_buffer, send_count, data_type, group_type) -> CommRequest:
        return self._start(
            CommDesc("allgather", self._group(group_type), int(send_count),
                     DataType(data_type)),
            send_buffer,
        )

    def all_to_all(self, send_buffer, send_count, data_type, group_type) -> CommRequest:
        """Member j of each group receives chunk j (``send_count`` elements) of
        every member, in member order; the buffer holds group-size chunks."""
        return self._start(
            CommDesc("alltoall", self._group(group_type), int(send_count),
                     DataType(data_type)),
            send_buffer,
        )

    def reduce_scatter(self, send_buffer, recv_count, data_type, red_type,
                       group_type) -> CommRequest:
        g = self._group(group_type)
        return self._start(
            CommDesc("reduce_scatter", g, int(recv_count) * g.size, DataType(data_type),
                     op=ReductionType(red_type), recv_count=int(recv_count)),
            send_buffer,
        )

    def barrier(self, group_type) -> None:
        req = CommRequest(
            CommDesc("barrier", self._group(group_type), 1, DataType.FLOAT),
            self.env.dispatcher,
        )
        req.setup()
        req.start(torch.ones((*self.world_shape, 1), device=self.device))
        req.wait()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # reference-style PascalCase aliases (API parity with include/mlsl.hpp)
    GetProcessCount = get_process_count
    GetProcessIdx = get_process_idx
    Bcast = bcast
    Reduce = reduce
    AllReduce = all_reduce
    Gather = gather
    AllGather = all_gather
    AlltoAll = all_to_all
    ReduceScatter = reduce_scatter
    Barrier = barrier
