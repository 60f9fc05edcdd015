"""Distribution: the data x model grid of virtual ranks and its collectives.

Counterpart of ``mlsl_tpu.core.distribution`` (reference include/mlsl.hpp:350-504,
DistributionImpl src/mlsl_impl.hpp:174-305), over the virtual-rank world of
comm/mesh.py. Each collective takes a distributed buffer -- one tensor of shape
(R, D, S, M, n) whose (r, d, s, m) row is that rank's local buffer -- and
returns a CommRequest already started (complete it with Environment.wait/test).

A distribution is a grid (data x model, with a sequence axis) or, built with
colors, two partitions of the world (``create_distribution_with_colors``):
the grid is then flat, (W, 1, 1, 1), and the data and model groups are color
groups, which may be ragged (distribution.py:49-80 of the JAX package).
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

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
    dtype_size,
    torch_dtype,
)
from mlsl_tpu_torch.log import mlsl_assert


class Distribution:
    def __init__(self, env, data_parts: Optional[int], model_parts: Optional[int],
                 seq_parts: int = 1, data_colors: Optional[Tuple[int, ...]] = None,
                 model_colors: Optional[Tuple[int, ...]] = None):
        self.env = env
        self.device = env.device
        self._colors_mode = data_colors is not None
        self.is_ragged = False
        if self._colors_mode:
            # color-based construction (reference src/mlsl_impl.hpp:268-280):
            # group sizes come from the color assignment; unequal partitions
            # are allowed, as with MPI_Comm_split, and carry collectives only
            n = env.world_size
            mlsl_assert(len(data_colors) == n and len(model_colors) == n,
                        "color arrays must have one entry per rank (%d)", n)
            data_sizes, model_sizes = Counter(data_colors), Counter(model_colors)
            self.data_parts = max(data_sizes.values())
            self.model_parts = max(model_sizes.values())
            self.is_ragged = (len(set(data_sizes.values())) > 1
                              or len(set(model_sizes.values())) > 1)
            self.seq_parts = 1
            # the grid is flat (W, 1, 1, 1): a storage layout, not replicas
            self.topology = Topology(1, 1, n)
            self.data_group = ProcessGroup(self.topology, (), colors=tuple(data_colors))
            self.model_group = ProcessGroup(self.topology, (), colors=tuple(model_colors))
            self.seq_group = ProcessGroup(self.topology, ())
            self.global_group = ProcessGroup(self.topology, GRID_AXES)
            self.grad_group = self.data_group
            self.replica_count = 1
            return
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
        g = self._group(group_type)
        return 1 if g.is_self else g.size

    def get_process_idx(self, group_type: GroupType, global_idx: int = 0) -> int:
        """Member index of world rank ``global_idx`` within the group (the
        single controller has no implicit 'my rank')."""
        g = self._group(group_type)
        return 0 if g.is_self else g.group_idx_of(global_idx)

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
        """The concatenation lands on every member (superset of root-only).
        Above ``MLSL_GATHER_DEVICE_LIMIT_MB`` of output a rank it is refused
        in favour of ``gather_to_host``, as in the JAX package."""
        g = self._group(group_type)
        cfg = getattr(self.env, "config", None)
        limit = getattr(cfg, "gather_device_limit_mb", 0) if cfg else 0
        out_bytes = (1 if g.is_self else g.size) * int(send_count) * dtype_size(
            DataType(data_type))
        mlsl_assert(
            limit <= 0 or out_bytes <= limit * 1024 * 1024,
            "gather output (%d MiB per rank; rank-uniform buffers replicate the "
            "concatenation on every member) exceeds MLSL_GATHER_DEVICE_LIMIT_MB=%d -- use "
            "gather_to_host for root-delivered results with no device footprint",
            out_bytes >> 20, limit,
        )
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
            CommDesc("reduce_scatter", g, int(recv_count) * (1 if g.is_self else g.size),
                     DataType(data_type),
                     op=ReductionType(red_type), recv_count=int(recv_count)),
            send_buffer,
        )

    def scatter(self, send_buffer, recv_count, data_type, root_idx,
                group_type) -> CommRequest:
        """Member i receives the root's segment i (``recv_count`` elements);
        the buffer holds group-size segments (on a ragged color group, the
        largest group's)."""
        g = self._group(group_type)
        return self._start(
            CommDesc("scatter", g, int(recv_count) * (1 if g.is_self else g.size),
                     DataType(data_type), root=int(root_idx), recv_count=int(recv_count)),
            send_buffer,
        )

    def all_gatherv(self, send_buffer, send_count, recv_counts, data_type,
                    group_type) -> CommRequest:
        """Member i contributes its first ``recv_counts[i]`` elements; every
        member receives them concatenated in member order."""
        return self._start(
            CommDesc("allgatherv", self._group(group_type), int(send_count),
                     DataType(data_type), recv_counts=tuple(int(c) for c in recv_counts)),
            send_buffer,
        )

    def all_to_allv(self, send_buffer, send_counts, send_offsets, recv_counts,
                    recv_offsets, data_type, group_type) -> CommRequest:
        """MPI AlltoAllv: ``send_counts`` (G,) the same on every rank, (G, G)
        the instance matrix, or (W, G) each world rank's own row; offsets
        default to the packed layout; ``recv_counts`` is checked against the
        transposed send counts (comm/request.normalize_alltoallv)."""
        s = np.asarray(send_counts, dtype=int)
        count = int(s.sum(axis=-1).max()) if s.ndim else int(s)

        def tup(a):
            if a is None:
                return None
            a = np.asarray(a, dtype=int)
            if a.ndim == 1:
                return tuple(int(v) for v in a)
            return tuple(tuple(int(v) for v in row) for row in a)

        return self._start(
            CommDesc("alltoallv", self._group(group_type), count, DataType(data_type),
                     send_counts=tup(send_counts), send_offsets=tup(send_offsets),
                     recv_counts=tup(recv_counts), recv_offsets=tup(recv_offsets)),
            send_buffer,
        )

    def send_recv_list(self, buffer, count, data_type, pairs, group_type) -> CommRequest:
        """Point-to-point exchange list: each (src, dst) member pair moves
        ``count`` elements; members that receive nothing get zeros (the
        reference's SendRecvList CommOp, src/comm.hpp:212-248)."""
        g = self._group(group_type)
        gsize = 1 if g.is_self else g.size
        srcs = [int(a) for a, _ in pairs]
        dsts = [int(b) for _, b in pairs]
        for a, b in zip(srcs, dsts):
            mlsl_assert(0 <= a < gsize and 0 <= b < gsize,
                        "SendRecvList pair (%d, %d) out of range for group size %d",
                        a, b, gsize)
        mlsl_assert(len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts),
                    "SendRecvList sources and destinations must be unique")
        return self._start(
            CommDesc("sendrecv", g, int(count), DataType(data_type),
                     pairs=tuple(zip(srcs, dsts))),
            buffer,
        )

    def gather_to_host(self, send_buffer, send_count, data_type, root_idx,
                       group_type) -> dict:
        """Rooted gather delivered to the host: ``{root world rank:
        np.ndarray(G * send_count)}``, one entry per group instance. The
        concatenations are assembled on the host from ONE device-to-host copy
        of the buffer; no collective runs. Ragged color groups need no
        padding here."""
        g = self._group(group_type)
        world = self.topology.world_size
        n = int(send_count)
        rows_dev = send_buffer.detach().reshape(world, -1)[:, :n]
        if rows_dev.dtype == torch.bfloat16:
            rows_dev = rows_dev.to(torch.float32)
        host = rows_dev.cpu().numpy()
        if g.is_self:
            return {p: host[p].copy() for p in range(world)}
        out = {}
        for row in g.member_table():
            mlsl_assert(int(root_idx) < len(row),
                        "root member index %d out of range for group of size %d",
                        int(root_idx), len(row))
            out[int(row[int(root_idx)])] = np.concatenate([host[q] for q in row])
        return out

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
    AlltoAllv = all_to_allv
    AllGatherv = all_gatherv
    Scatter = scatter
    ReduceScatter = reduce_scatter
    SendRecvList = send_recv_list
    GatherToHost = gather_to_host
    Barrier = barrier
