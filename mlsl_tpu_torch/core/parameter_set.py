"""ParameterSet: gradient synchronization with optional distributed update.

Counterpart of ``mlsl_tpu.core.parameter_set`` (reference ParameterSetImpl,
src/mlsl_impl.cpp:388-444 and include/mlsl.hpp:276-341):

- kernels are partitioned over the model group: localKernelCount =
  globalKernelCount / modelParts at offset localKernelCount * modelIdx;
- plain path: gradients AllReduce'd over the gradient group (data x seq),
  through the int8 error-feedback ring when compression is on (reference
  swaps the MPI op for MPI_QUANT_OP, src/comm_ep.cpp:946-950);
- distributed update (ZeRO-1): ownedKernelCount = ceil(local / dataParts),
  the local count padded up to owned * dataParts; gradients ReduceScatter'd
  so each data rank owns a shard, the optimizer updates only that shard, and
  the increments AllGather back (``start_increment_comm`` /
  ``wait_increment_comm``, reference :401-435);
- gradient bucketing (core/bucketing.py, assigned at Session.commit): the
  set's gradient collective and, under the distributed update, its increment
  all_gather may be coalesced with its neighbours' (``bucket``,
  ``inc_bucket``). The ``*_round`` flags say whether the CURRENT round is the
  bucket's or the set's own request (a fallback, which for a quantized set
  runs its own ring with its own residual).
"""

from __future__ import annotations

from typing import Optional

from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.types import CompressionType, DataType, ReductionType


class ParameterSet:
    def __init__(self, op, reg, index: int):
        self.op = op
        self.param_index = index
        self.dist = op.distribution
        self.distributed_update = bool(reg.distributed_update)
        self.compression = CompressionType(reg.compression)
        self.data_type = DataType(reg.data_type)
        self.kernel_size = reg.size
        self.global_kernel_count = reg.count

        model_size = self.dist.get_process_count_model()
        grad_group = self.dist.grad_group
        data_size = 1 if grad_group.is_self else grad_group.size
        mlsl_assert(
            self.global_kernel_count % model_size == 0,
            "kernel count %d not divisible by model parts %d",
            self.global_kernel_count,
            model_size,
        )
        self.local_kernel_count = self.global_kernel_count // model_size
        self._local_kernel_offset_per_model_idx = self.local_kernel_count
        self.need_comm = data_size > 1
        if self.distributed_update:
            self.owned_kernel_count = -(-self.local_kernel_count // data_size)   # ceil
            # the local count is padded up so that each data rank owns an
            # equal shard (reference :403-405)
            self.local_kernel_count = self.owned_kernel_count * data_size
        else:
            self.owned_kernel_count = self.local_kernel_count
        self.grad_req: Optional[CommRequest] = None
        self.inc_req: Optional[CommRequest] = None
        self.bucket = None
        self._bucket_round = False
        self.inc_bucket = None
        self._inc_bucket_round = False
        if self.need_comm:
            dispatcher = op.session.env.dispatcher
            n_owned = self.owned_kernel_count * self.kernel_size
            if self.distributed_update:
                self.grad_req = CommRequest(
                    CommDesc("reduce_scatter", grad_group, n_owned * data_size,
                             self.data_type, op=ReductionType.SUM, recv_count=n_owned,
                             compression=self.compression),
                    dispatcher, name=f"{op.name}/grad{index}",
                )
                self.inc_req = CommRequest(
                    CommDesc("allgather", grad_group, n_owned, self.data_type),
                    dispatcher, name=f"{op.name}/inc{index}",
                )
                self.inc_req.setup()
            else:
                self.grad_req = CommRequest(
                    CommDesc("allreduce", grad_group, n_owned, self.data_type,
                             op=ReductionType.SUM, compression=self.compression),
                    dispatcher, name=f"{op.name}/grad{index}",
                )
            self.grad_req.setup()

    @property
    def codec_name(self) -> str:
        """The gradient request's resolved registry codec ('int8', 'vq',
        ...; 'custom' for a user codec; '' without communication or for
        TOPK): bucketing partitions on it."""
        return self.grad_req.codec_name if self.grad_req is not None else ""

    # -- introspection (reference include/mlsl.hpp:284-341) ----------------

    def get_global_kernel_count(self) -> int:
        return self.global_kernel_count

    def get_global_kernel_offset(self, model_idx: int = 0) -> int:
        return self._local_kernel_offset_per_model_idx * model_idx

    def get_local_kernel_count(self) -> int:
        return self.local_kernel_count

    def get_owned_kernel_count(self) -> int:
        return self.owned_kernel_count

    def get_owned_kernel_offset(self, data_idx: int = 0) -> int:
        if self.distributed_update:
            return self.owned_kernel_count * data_idx
        return 0

    def get_kernel_size(self) -> int:
        return self.kernel_size

    def get_data_type(self) -> DataType:
        return self.data_type

    def is_distributed_update(self) -> bool:
        return self.distributed_update

    # -- gradient sync (reference src/mlsl_impl.cpp:446-539) ---------------

    def start_gradient_comm(self, grad_buf) -> None:
        """Start the gradient collective. grad_buf: distributed buffer of shape
        (R, D, S, M, localKernelCount*kernelSize)."""
        self.op.session._stat_event(self, "start", is_param=True)
        if self.need_comm:
            if self.bucket is not None and self.bucket.start(self, grad_buf):
                self._bucket_round = True
            else:
                self._bucket_round = False
                self.grad_req.start(grad_buf)
        self.op.session._stat_event(self, "start_done", is_param=True)

    def wait_gradient_comm(self):
        """-> the reduced gradient buffer, or None when no comm is needed."""
        self.op.session._stat_event(self, "wait", is_param=True)
        out = None
        if self.need_comm and self._bucket_round:
            handled, out = self.bucket.wait(self)
            if not handled:
                # the bucket's fallback just started our individual request
                self._bucket_round = False
                out = self.grad_req.wait()
        # a request completed by test() is no longer started but keeps its
        # result; wait() still delivers it (MPI_Wait on a completed request)
        elif self.need_comm and (self.grad_req.is_started
                                 or self.grad_req._result is not None):
            out = self.grad_req.wait()
        self.op.session._stat_event(self, "wait_done", is_param=True)
        return out

    def test_gradient_comm(self):
        """-> (is_completed, result_or_None)."""
        self.op.session._stat_event(self, "test", is_param=True)
        if not self.need_comm:
            done, out = True, None
        elif self._bucket_round:
            handled, done, out = self.bucket.test(self)
            if not handled:
                self._bucket_round = False
                done, out = self.grad_req.test()
        else:
            done, out = self.grad_req.test()
        self.op.session._stat_event(self, "test_done", is_param=True)
        return done, out

    def start_increment_comm(self, inc_buf) -> None:
        """AllGather the locally updated owned shard (distributed update only).
        inc_buf: distributed buffer (R, D, S, M, ownedKernelCount*kernelSize)."""
        self.op.session._stat_event(self, "start", is_param=True, is_increment=True)
        if self.need_comm and self.distributed_update:
            if self.inc_bucket is not None and self.inc_bucket.start(self, inc_buf):
                self._inc_bucket_round = True
            else:
                self._inc_bucket_round = False
                self.inc_req.start(inc_buf)
        self.op.session._stat_event(self, "start_done", is_param=True, is_increment=True)

    def wait_increment_comm(self):
        """-> the gathered increment buffer (R, D, S, M, localKernelCount*
        kernelSize), or None when no comm is needed."""
        self.op.session._stat_event(self, "wait", is_param=True, is_increment=True)
        out = None
        if self.need_comm and self.distributed_update and self._inc_bucket_round:
            handled, out = self.inc_bucket.wait(self)
            if not handled:
                self._inc_bucket_round = False
                out = self.inc_req.wait()
        elif self.need_comm and self.distributed_update and self.inc_req.is_started:
            out = self.inc_req.wait()
        self.op.session._stat_event(self, "wait_done", is_param=True, is_increment=True)
        return out

    # PascalCase parity aliases
    GetGlobalKernelCount = get_global_kernel_count
    GetGlobalKernelOffset = get_global_kernel_offset
    GetLocalKernelCount = get_local_kernel_count
    GetOwnedKernelCount = get_owned_kernel_count
    GetOwnedKernelOffset = get_owned_kernel_offset
    GetKernelSize = get_kernel_size
    GetDataType = get_data_type
    IsDistributedUpdate = is_distributed_update
    StartGradientComm = start_gradient_comm
    WaitGradientComm = wait_gradient_comm
    TestGradientComm = test_gradient_comm
    StartIncrementComm = start_increment_comm
    WaitIncrementComm = wait_increment_comm
