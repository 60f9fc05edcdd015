"""The multi-process transport: virtual ranks spread over processes.

Counterpart of the JAX package's ``jax.distributed`` world
(``mlsl_tpu/core/environment.py:60-79, 165-210``). With
``Environment.init(coordinator_address=..., num_processes=P, process_id=i)``
each process holds the box of its own virtual ranks (comm/mesh.py), and a
collective over a group whose instances span processes takes one hop
through ``torch.distributed``: NCCL for CUDA tensors, gloo for CPU tensors,
or gloo for CUDA tensors when asked (``backend="gloo"``), which stages them
through host memory explicitly. Without a coordinator this module makes no
``torch.distributed`` call, and it is the only module of the package that
calls its collectives.

The spanning forms (``build_spanning``), over the local view (C_l, G_l, n)
of a group -- the C_l instances this process holds, G_l of their members
each -- and the subgroup of processes that hold the same instances
(``ProcessGroup.process_partition``), in member order (``Span``):

- allreduce, reduce: a local reduction of the G_l members, ``all_reduce``
  over the subgroup, the result to every local member;
- reduce_scatter: a local reduction, ``reduce_scatter_tensor`` over the
  subgroup, each local member its slice: the local members are an aligned
  run of the group's members, so a process's chunk is exactly their slices;
- allgather: ``all_gather_into_tensor`` of the local members' rows;
- alltoall: ``all_to_all_single``, each process's members' blocks for
  another process's members sent to it, its own kept (``all_to_all``);
- bcast: one ``broadcast`` of the root's rows from the process that holds
  the root;
- sendrecv: a pair whose two ends sit in one process is a local copy; the
  rows one process sends another go as one ``isend`` / ``irecv``
  (``exchange``);
- gather, scatter and allgatherv: the assembled form, the group's rows
  gathered over the subgroup, the single-process body run on the assembled
  (C_l, G, n) view, the local members' rows kept (standing difference "the
  assembled form"). A color group's and alltoallv's assembled form gathers
  the world's rows.

The compressed wires (comm/quant_ring.py, comm/sparse.py, comm/codec.py)
run their one-process bodies over the local view with the ring shift
(``ring_shift``) in place of ``torch.roll`` on the member dim: a local roll
plus one boundary exchange, the last local member's rows to the next
process of the subgroup's ring. Their rows cross in compressed form.

The trainers (HybridTrainer, the MoE layer, the sequence-parallel
attention, the pipeline schedules) differentiate through their hops: the
ring's ``shift`` (+1 or -1), ``axis_sum`` (and ``axis_max`` without a
gradient), ``axis_all_to_all`` and ``axis_all_gather`` are autograd
Functions over a Span along one rank dim, each backward the transposed hop.
The sums gather the G members' rows and add them as one process does, so
they are the one-process run's bits; ``world_rows`` gathers a small tensor
(a step's loss rows) over the world.

The serving engine (serve/engine.py) sends its leader's records to every
process with ``serve_record``: a fixed int64 header, then the payload, two
broadcasts over the world (hop kind ``serve_record``). ``at_shutdown``
registers what ``shutdown`` runs while the group is still up: a leader that
exits without closing its engine stops the followers there.

Float sums that cross processes add in another order than one process's
member loop (a local sum, then the backend's), within 1e-6 relative; integer
payloads are exact, and every process receives the same bits.

Traps, each guarded by a test (tests/test_torch_transport.py):

1. ``new_group`` is collective over the world: every process builds the
   subgroups of a partition together, in the same order, member or not
   (``new_subgroups_by_enumeration``), cached by partition.
2. Every process must issue its hops in the same order. The Dispatcher
   never defers a request whose group spans processes (comm/request.py),
   so hops go out in program order, which is the same on every process
   (standing difference "the hop order").
3. torch 2.13 deprecates ``all_gather_into_tensor`` and
   ``reduce_scatter_tensor`` for ``*_single`` names that 2.11 lacks: the
   old names are used, their deprecation warning silenced here.
4. A process must destroy its group before it exits (``bootstrap``
   registers ``shutdown`` at exit).
5. A compressed ring issues 2(G - 1) ring shifts a round and a chunked
   request one round a chunk: every process issues them in the same order
   and count, because the bodies loop over the global G and the chunks in
   order, and the Dispatcher never defers a spanning request.
6. Under autograd, every process must build the same graph of hops: no
   branch on the process index may change their number or order, and one
   Function carries a whole tuple (K and V together) in one message, so the
   backward engine cannot order two ready hops differently on two
   processes; a remat replay replays its hops on every process alike.
"""

from __future__ import annotations

import atexit
import dataclasses
import socket
import time
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from mlsl_tpu_torch.log import MLSLError, log_warning, mlsl_assert
from mlsl_tpu_torch.types import ReductionType


@dataclasses.dataclass
class ProcessWorld:
    """This process's place in the world: ``count`` processes, this one
    ``index``, the backend, every process's host name, and the number of
    virtual ranks (``world_size``) they share."""

    count: int = 1
    index: int = 0
    backend: str = ""
    hosts: Tuple[str, ...] = ("",)
    world_size: int = 0
    up: bool = False


_WORLD = ProcessWorld()
#: partition -> {process: its subgroup's handle}
_SUBGROUPS: Dict[tuple, dict] = {}

#: per hop kind: calls, bytes this process handed the backend, host seconds,
#: of them the staging copies' and the wire's, and the bytes by dtype
HOP_STATS: Dict[str, list] = {}


def world() -> ProcessWorld:
    return _WORLD


def owner_of(rank: int, world_size: int, count: int) -> int:
    """The process that holds virtual rank ``rank``."""
    return int(rank) // max(1, int(world_size) // max(1, int(count)))


def reset_stats() -> None:
    HOP_STATS.clear()


def hop_totals() -> dict:
    """{kind: {"calls", "bytes", "s", "stage_s", "wire_s", "dtypes"}} since
    the last reset: ``s`` is the hop's host seconds, ``stage_s`` the part
    around the backend's call (packing a tuple into one message, and for
    gloo a CUDA tensor's copies to and from the host), ``wire_s`` the
    backend's call (on NCCL its enqueue), ``dtypes`` the bytes by the dtype
    that crossed."""
    return {k: {"calls": v[0], "bytes": v[1], "s": v[2], "stage_s": v[3], "wire_s": v[4],
                "dtypes": dict(v[5])} for k, v in HOP_STATS.items()}


# -- bootstrap -------------------------------------------------------------------


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def bootstrap(coordinator_address: str, num_processes: int, process_id: int,
              backend: str, retries: int, backoff_s: float, device=None) -> ProcessWorld:
    """Bring up ``torch.distributed`` once per process, with the JAX
    package's retry loop (environment.py:165-210): up to ``retries`` more
    attempts, ``backoff_s * 2**(attempt-1)`` seconds before each, the half
    made process group destroyed between them. A later call with the same
    world returns it; another world raises MLSLError."""
    import torch.distributed as dist

    num_processes, process_id = int(num_processes), int(process_id)
    if _WORLD.up:
        mlsl_assert(_WORLD.count == num_processes and _WORLD.index == process_id
                    and _WORLD.backend == backend,
                    "the process world is up as process %d of %d over %s; init asked "
                    "for %d of %d over %s", _WORLD.index, _WORLD.count, _WORLD.backend,
                    process_id, num_processes, backend)
        return _WORLD
    mlsl_assert(num_processes >= 1 and 0 <= process_id < num_processes,
                "process_id %d out of range for %d processes", process_id, num_processes)
    mlsl_assert(backend in ("gloo", "nccl"), "backend must be 'gloo' or 'nccl' (got %r)",
                backend)
    if backend == "nccl" and device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    for attempt in range(retries + 1):
        if attempt:
            time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                                    world_size=num_processes, rank=process_id)
            break
        except (RuntimeError, OSError) as e:
            if attempt >= retries:
                raise
            log_warning("torch.distributed.init_process_group failed (attempt %d/%d, "
                        "retrying in %.2gs): %s: %s", attempt + 1, retries + 1,
                        backoff_s * (2 ** attempt), type(e).__name__, e)
            try:
                dist.destroy_process_group()
            except Exception:  # mlsl-lint: disable=A205 -- half-made group: nothing to unwind
                pass
    hosts = [None] * num_processes
    dist.all_gather_object(hosts, socket.gethostname())
    _WORLD.count, _WORLD.index, _WORLD.backend = num_processes, process_id, backend
    _WORLD.hosts, _WORLD.up = tuple(str(h) for h in hosts), True
    # trap 4: a process that exits with its gloo group still up lets the
    # interpreter's teardown destroy the group's threads unjoined, and C++
    # aborts it ("terminate called without an active exception") after its
    # work is done; jax.distributed's client shuts down at exit the same way
    atexit.unregister(shutdown)
    atexit.register(shutdown)
    return _WORLD


def shutdown() -> None:
    """Destroy the process group: a test's teardown, and at the process's
    exit (trap 4), after the ``at_shutdown`` hooks. ``Environment.finalize``
    keeps it up, as the JAX package keeps ``jax.distributed``."""
    hooks = list(_AT_SHUTDOWN)
    _AT_SHUTDOWN.clear()
    if _WORLD.up:
        import torch.distributed as dist

        for fn in hooks:
            try:
                fn()
            except Exception as e:  # the group goes all the same
                log_warning("transport: a shutdown hook failed: %s: %s", type(e).__name__, e)
        _SUBGROUPS.clear()
        if dist.is_initialized():
            dist.destroy_process_group()
    _WORLD.__init__()


def set_world_size(n: int) -> None:
    _WORLD.world_size = int(n)


# -- subgroups ----------------------------------------------------------------------


def subgroup(partition: Tuple[Tuple[int, ...], ...]):
    """This process's handle in ``partition`` (None: the whole world). Every
    process builds every subgroup of a partition, in the same order, at its
    first use (trap 1)."""
    if len(partition) == 1 and len(partition[0]) == _WORLD.count:
        return None
    handles = _SUBGROUPS.get(partition)
    if handles is None:
        import torch.distributed as dist

        _, groups = dist.new_subgroups_by_enumeration([list(p) for p in partition])
        handles = {j: g for part, g in zip(partition, groups) for j in part}
        _SUBGROUPS[partition] = handles
    return handles[_WORLD.index]


# -- the hops -----------------------------------------------------------------------


def _op(op):
    import torch.distributed as dist

    op = ReductionType(op if op is not None else ReductionType.SUM)
    return {ReductionType.SUM: dist.ReduceOp.SUM, ReductionType.MIN: dist.ReduceOp.MIN,
            ReductionType.MAX: dist.ReduceOp.MAX}[op]


def _staged(t: torch.Tensor) -> torch.Tensor:
    """The tensor the backend takes: a CUDA tensor crosses a gloo group
    through host memory."""
    t = t.contiguous()
    if t.is_cuda and _WORLD.backend == "gloo":
        return t.cpu()
    return t


class _Clock:
    """A hop's host seconds in three parts: staging in, the wire, staging
    back (``wire()`` and ``back()`` mark the boundaries)."""

    def __init__(self):
        self.t0 = self.t1 = self.t2 = time.perf_counter()

    def wire(self) -> None:
        self.t1 = self.t2 = time.perf_counter()

    def back(self) -> None:
        self.t2 = time.perf_counter()

    def record(self, kind: str, tensors: Sequence[torch.Tensor]) -> None:
        t3 = time.perf_counter()
        rec = HOP_STATS.setdefault(kind, [0, 0, 0.0, 0.0, 0.0, {}])
        rec[0] += 1
        rec[2] += t3 - self.t0
        rec[3] += (self.t1 - self.t0) + (t3 - self.t2)
        rec[4] += self.t2 - self.t1
        for t in tensors:
            nb = t.numel() * t.element_size()
            rec[1] += nb
            name = str(t.dtype).replace("torch.", "")
            rec[5][name] = rec[5].get(name, 0) + nb


def _peer(group, index: int) -> int:
    """The global rank of the subgroup's ``index``-th process."""
    import torch.distributed as dist

    return dist.get_global_rank(group, int(index)) if group is not None else int(index)


def all_reduce(t: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """-> the reduction of ``t`` over the subgroup, on ``t``'s device."""
    import torch.distributed as dist

    clk = _Clock()
    x = _staged(t).clone()
    clk.wire()
    dist.all_reduce(x, op=_op(op), group=group)
    clk.back()
    out = x.to(t.device)
    clk.record("all_reduce", (x,))
    return out


def reduce_scatter(t: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """``t`` (P_s, *chunk) -> this process's chunk of the reduction."""
    import torch.distributed as dist

    clk = _Clock()
    x = _staged(t)
    out = x.new_empty(x.shape[1:])
    clk.wire()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dist.reduce_scatter_tensor(out.view(-1), x.view(-1), op=_op(op), group=group)
    clk.back()
    res = out.to(t.device)
    clk.record("reduce_scatter", (x,))
    return res


def all_gather(t: torch.Tensor, group=None, kind: str = "all_gather") -> torch.Tensor:
    """-> (P_s, *t.shape): every process's ``t``, in process order."""
    import torch.distributed as dist

    clk = _Clock()
    x = _staged(t)
    n = dist.get_world_size(group)
    out = x.new_empty((n, *x.shape))
    clk.wire()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dist.all_gather_into_tensor(out.view(-1), x.view(-1), group=group)
    clk.back()
    res = out.to(t.device)
    clk.record(kind, (x,))
    return res


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """-> process ``src``'s ``t`` (its index in the subgroup)."""
    import torch.distributed as dist

    clk = _Clock()
    x = _staged(t).clone()
    clk.wire()
    dist.broadcast(x, src=_peer(group, src), group=group)
    clk.back()
    out = x.to(t.device)
    clk.record("broadcast", (x,) if dist.get_rank(group) == int(src) else ())
    return out


def all_to_all(t: torch.Tensor, index: int, group=None, kind: str = "all_to_all") -> torch.Tensor:
    """``t`` (P_s, *block): row q for the subgroup's process q -> (P_s,
    *block), row q from process q. This process's own row stays here: the
    backend gets only the rows that cross (``all_to_all_single`` with a
    zero split for itself)."""
    import torch.distributed as dist

    ps, index = t.shape[0], int(index)
    if ps == 1:
        return t.clone()
    clk = _Clock()
    others = [q for q in range(ps) if q != index]
    x = _staged(t[others].reshape(-1))
    m = t[0].numel()
    splits = [0 if q == index else m for q in range(ps)]
    got = x.new_empty((ps - 1) * m)
    clk.wire()
    dist.all_to_all_single(got, x, output_split_sizes=splits, input_split_sizes=splits,
                           group=group)
    clk.back()
    out = t.new_empty(t.shape)
    out[others] = got.to(t.device).view(ps - 1, *t.shape[1:])
    out[index] = t[index]
    clk.record(kind, (x,))
    return out


def _pack(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, one flat uint8 tensor (one message for a tuple)."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in ts])


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    """``_pack``'s inverse, shaped and typed as ``like``."""
    out, at = [], 0
    for t in like:
        nb = t.numel() * t.element_size()
        # a copy: a slice off the dtype's alignment cannot be re-viewed
        out.append(buf[at:at + nb].clone().view(t.dtype).reshape(t.shape))
        at += nb
    return out


def exchange(sends: Dict[int, Sequence[torch.Tensor]],
             recvs: Dict[int, Sequence[torch.Tensor]], group=None,
             kind: str = "send_recv") -> Dict[int, list]:
    """Point to point over the subgroup: ``sends[q]``'s tensors go to its
    process q as one message, and from each process q one message arrives,
    shaped as ``recvs[q]``'s tensors (templates, not written). Every send
    and receive is posted at once (``batch_isend_irecv``), so no process
    blocks on a send before its receives are posted. -> {q: tensors}."""
    import torch.distributed as dist

    clk = _Clock()
    out_bufs = {q: _staged(_pack(ts)) for q, ts in sends.items()}
    dev = next(iter(recvs.values()))[0].device if recvs else None
    in_bufs = {}
    for q, ts in recvs.items():
        nb = sum(t.numel() * t.element_size() for t in ts)
        host = ts[0].is_cuda and _WORLD.backend == "gloo"
        in_bufs[q] = torch.empty(nb, dtype=torch.uint8, device="cpu" if host else ts[0].device)
    ops = [dist.P2POp(dist.isend, b, _peer(group, q), group) for q, b in out_bufs.items()]
    ops += [dist.P2POp(dist.irecv, b, _peer(group, q), group) for q, b in in_bufs.items()]
    clk.wire()
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    clk.back()
    got = {q: _unpack(b.to(dev), recvs[q]) for q, b in in_bufs.items()}
    clk.record(kind, [t for ts in sends.values() for t in ts])
    return got


def ring_shift(ts: Sequence[torch.Tensor], group, index: int, size: int, *, dim: int = 1,
               step: int = 1, kind: str = "ring_shift") -> tuple:
    """``torch.roll(t, step, dims=dim)`` of each tensor over a group whose
    members [off, off + G_l) of each instance sit here, along ``dim`` (the
    (C_l, G_l, ...) view's dim 1 by default), and the rest in the ``size``
    processes of the subgroup, in member order: member i's rows move to
    member i + step (step +1 or -1). A local roll, then the edge member's
    rows go to the neighbouring process of the ring and the other
    neighbour's arrive in the opposite edge's place (one message for the
    tuple; with one process in the subgroup, nothing crosses)."""
    mlsl_assert(step in (1, -1), "a ring shift moves one member (step +1 or -1), not %d", step)
    rolled = [torch.roll(t, shifts=step, dims=dim) for t in ts]
    if size == 1:
        return tuple(rolled)
    send_at, recv_at = (-1, 0) if step == 1 else (0, -1)
    edge = [t.select(dim, send_at) for t in ts]
    dst, src = (int(index) + step) % size, (int(index) - step) % size
    got = exchange({dst: edge}, {src: edge}, group, kind=kind)[src]
    for r, g in zip(rolled, got):
        r.select(dim, recv_at).copy_(g)
    return tuple(rolled)


def barrier(group=None) -> None:
    import torch.distributed as dist

    clk = _Clock()
    clk.wire()
    dist.barrier(group=group)
    clk.back()
    clk.record("barrier", ())


# -- the spanning forms ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Span:
    """This process's piece of an axis group: the group's axes over its box
    (``box``), whose view (C_l, G_l, n) holds the members [off, off + G_l)
    of each of the C_l instances (G in all), and the ``size`` processes of
    its subgroup (``partition``'s, this one at ``index``) that hold the
    rest, in member order. ``local_span`` is the one-process form: the box
    is the group, nothing crosses. The subgroup is built at the first hop,
    as every process reaches it in program order (trap 1), so a build
    makes no ``torch.distributed`` call."""

    box: object
    g: int
    gl: int
    off: int
    partition: Optional[tuple] = None
    index: int = 0
    size: int = 1

    @property
    def crosses(self) -> bool:
        return self.size > 1

    @property
    def handle(self):
        return subgroup(self.partition) if self.crosses else None

    def shift(self, *ts: torch.Tensor) -> tuple:
        """Member i's rows to member i + 1 (``torch.roll`` in one process)."""
        if not self.crosses:
            return tuple(torch.roll(t, shifts=1, dims=1) for t in ts)
        return ring_shift(ts, self.handle, self.index, self.size)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """(C_l, G_l, ...) -> (C_l, G, ...): every member's rows, in member
        order (itself in one process)."""
        return _gather_dim(self, y, 1, "all_gather") if self.crosses else y


def spans(group) -> bool:
    """``group`` spans processes in a world of more than one."""
    return group is not None and group.topology.num_procs > 1 and group.spans


def span_or_none(group) -> Optional[Span]:
    """The Span of a single-axis group that spans processes, else None (no
    group, or one whose box holds its every member: today's code runs)."""
    if not spans(group):
        return None
    mlsl_assert(len(group.live_axes()) == 1, "a hop along a rank dim needs a group of one "
                "axis, got %s", group.axes)
    return span_of(group)


# -- the differentiable hops ----------------------------------------------------------
#
# The trainers (models/transformer.py, models/moe.py, parallel/sequence.py,
# parallel/pipeline.py) differentiate through their hops. Each hop below is
# one torch.autograd.Function over a Span whose backward is the transposed
# hop, along the dim ``dim`` of the tensors that holds the group's G_l local
# members. One Function carries a whole tuple in one message (K and V
# together), so the backward engine cannot interleave two ready hops in
# another order on another process: every process builds the same graph of
# hops, in the same order, and no branch on the process index may change
# their number (trap 6). The sums gather the G members' rows and add them
# as the one process does, so every process holds the one-process run's
# bits.


#: the moves carry 16-bit floats as their bytes: a move needs only the bits,
#: and not every backend takes every 16-bit type in every collective
_MOVED_AS_BYTES = (torch.bfloat16, torch.float16)


def _bytes(t: torch.Tensor, lead: int) -> torch.Tensor:
    """A 16-bit float tensor -> its bytes, (*t.shape[:lead], nbytes); any
    other tensor as it is."""
    if t.dtype not in _MOVED_AS_BYTES:
        return t
    return t.contiguous().reshape(*t.shape[:lead], -1).view(torch.uint8)


def _unbytes(t: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """``_bytes``' inverse for a tensor shaped ``shape`` of ``like``'s dtype."""
    if like.dtype not in _MOVED_AS_BYTES:
        return t
    return t.view(like.dtype).reshape(shape)


def _gather_dim(span: Span, x: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
    """x with its G_l local members at ``dim`` -> every member's rows at
    ``dim`` (G), in member order."""
    rows = all_gather(_bytes(x.contiguous(), 0), span.handle, kind=kind)
    rows = _unbytes(rows, x, (span.size, *x.shape))                 # (P_s, *x.shape)
    rows = rows.movedim(0, dim)                                     # P_s just before G_l
    return rows.reshape(*x.shape[:dim], span.g, *x.shape[dim + 1:])


def _sum_members(full: torch.Tensor, dim: int, ordered: bool) -> torch.Tensor:
    """The members at ``dim`` added: one by one in member order
    (``ordered``, as ``algos.inline_allreduce`` sums on the CPU) or as one
    reduction (as ``transformer._model_sum``). keepdim."""
    if not ordered:
        return full.sum(dim=dim, keepdim=True)
    r = full.narrow(dim, 0, 1)
    for j in range(1, full.shape[dim]):
        r = r + full.narrow(dim, j, 1)
    return r


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, span, dim, step, *ts):
        ctx.span, ctx.dim, ctx.step = span, dim, step
        return ring_shift(ts, span.handle, span.index, span.size, dim=dim, step=step,
                          kind="shift")

    @staticmethod
    def backward(ctx, *gs):
        sp = ctx.span
        back = ring_shift(gs, sp.handle, sp.index, sp.size, dim=ctx.dim, step=-ctx.step,
                          kind="shift")
        return (None, None, None, *back)


def shift(span: Span, *ts: torch.Tensor, step: int = 1, dim: int = 1) -> tuple:
    """Member i's rows move to member i + step (±1) along ``dim``: the
    ring's ``lax.ppermute``, ``torch.roll`` in one process. Differentiable:
    the backward shifts the cotangents the opposite way."""
    if not span.crosses:
        return tuple(torch.roll(t, shifts=step, dims=dim) for t in ts)
    return _Shift.apply(span, dim, step, *ts)


class _AxisSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, span, dim, ordered, x):
        ctx.span, ctx.dim = span, dim
        full = _gather_dim(span, x, dim, "axis_sum")
        return _sum_members(full, dim, ordered).expand_as(x)

    @staticmethod
    def backward(ctx, g):
        # the one process's backward of a keepdim sum broadcast back: the
        # cotangents' sum over the members, as one reduction
        full = _gather_dim(ctx.span, g, ctx.dim, "axis_sum")
        return None, None, None, full.sum(dim=ctx.dim, keepdim=True).expand(g.shape)


def axis_sum(span: Span, x: torch.Tensor, dim: int, ordered: bool = False) -> torch.Tensor:
    """``lax.psum`` over the span's members at ``dim``, on every member
    (``x.sum(dim, keepdim=True).expand_as(x)`` in one process; ``ordered``
    adds the members one by one). Differentiable: the backward is the same
    sum of the cotangents."""
    if not span.crosses:
        return _sum_members(x, dim, ordered).expand_as(x)
    return _AxisSum.apply(span, dim, ordered, x)


def axis_max(span: Span, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The MAX over the span's members at ``dim``, keepdim, without a
    gradient (the sharded vocabulary's stability max)."""
    with torch.no_grad():
        full = _gather_dim(span, x.detach(), dim, "axis_sum") if span.crosses else x.detach()
        return full.amax(dim=dim, keepdim=True)


def _exchange_chunks(span: Span, x: torch.Tensor, dim: int, cdim: int) -> torch.Tensor:
    """out[member m at ``dim``, i at ``cdim``] = member i's chunk m: each
    process's blocks for another's members in one ``all_to_all``."""
    gl = span.gl
    send = torch.stack([x.narrow(cdim, q * gl, gl) for q in range(span.size)])
    got = all_to_all(_bytes(send, 1), span.index, span.handle, kind="axis_all_to_all")
    got = _unbytes(got, x, send.shape)
    return torch.cat([got[q].transpose(dim, cdim) for q in range(span.size)], dim=cdim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, span, dim, cdim, x):
        ctx.span, ctx.dim, ctx.cdim = span, dim, cdim
        return _exchange_chunks(span, x, dim, cdim)

    @staticmethod
    def backward(ctx, g):
        # the exchange is its own inverse
        return None, None, None, _exchange_chunks(ctx.span, g, ctx.dim, ctx.cdim)


def axis_all_to_all(span: Span, x: torch.Tensor, dim: int, cdim: int) -> torch.Tensor:
    """``lax.all_to_all`` (split = concat = ``cdim``, untiled) over the
    members at ``dim``: x holds one chunk a member along ``cdim`` (G), and
    member j receives chunk j of every member, in member order, at the same
    place (``x.transpose(dim, cdim)`` in one process). Differentiable: the
    backward is the inverse exchange."""
    mlsl_assert(dim < cdim and x.shape[cdim] == span.g and x.shape[dim] == span.gl,
                "axis_all_to_all: dim %d must hold the %d local members and dim %d the %d "
                "chunks, got %s", dim, span.gl, cdim, span.g, tuple(x.shape))
    if not span.crosses:
        return x.transpose(dim, cdim)
    return _AllToAll.apply(span, dim, cdim, x)


def _concat_members(full: torch.Tensor, dim: int, tdim: int, gl: int) -> torch.Tensor:
    """(..., G at dim, ..., T at tdim, ...) -> (..., G_l at dim, ..., G*T at
    tdim, ...): the members' rows concatenated along T, on every local member."""
    y = full.movedim(dim, tdim - 1).flatten(tdim - 1, tdim).unsqueeze(dim)
    return y.expand(*y.shape[:dim], gl, *y.shape[dim + 1:])


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, span, dim, tdim, x):
        ctx.span, ctx.dim, ctx.tdim, ctx.t = span, dim, tdim, x.shape[tdim]
        full = _gather_dim(span, x, dim, "axis_all_gather")
        return _concat_members(full, dim, tdim, span.gl)

    @staticmethod
    def backward(ctx, g):
        # JAX's transpose of lax.all_gather: the members' cotangents summed
        # (one reduction, as the one process's broadcast backward), this
        # member's slice kept
        sp, dim, tdim = ctx.span, ctx.dim, ctx.tdim
        s = _gather_dim(sp, g, dim, "axis_all_gather").sum(dim=dim, keepdim=True).squeeze(dim)
        s = s.unflatten(tdim - 1, (sp.g, ctx.t)).narrow(tdim - 1, sp.off, sp.gl)
        return None, None, None, s.movedim(tdim - 1, dim)


def axis_all_gather(span: Span, x: torch.Tensor, dim: int, tdim: int) -> torch.Tensor:
    """The tiled ``lax.all_gather`` over the members at ``dim``: every
    member receives every member's x, concatenated along ``tdim`` in member
    order. Differentiable: the backward sums the members' cotangents and
    keeps this member's slice."""
    mlsl_assert(dim < tdim and x.shape[dim] == span.gl,
                "axis_all_gather: dim %d must hold the %d local members, got %s", dim,
                span.gl, tuple(x.shape))
    if not span.crosses:
        return _concat_members(x, dim, tdim, span.gl)
    return _AllGather.apply(span, dim, tdim, x)


def world_rows(x: torch.Tensor, topo) -> torch.Tensor:
    """This process's box (R_l, D_l, S_l, M_l, ...) -> the world's grid (R,
    D, S, M, ...), every process's rows gathered (a small tensor: a step's
    loss rows). Itself in one process."""
    if topo.num_procs == 1:
        return x
    rest = x.shape[len(topo.local_shape):]
    rows = all_gather(x.contiguous().reshape(topo.local_size, -1), None, kind="world_rows")
    return rows.reshape(*topo.grid_shape, *rest)


def span_of(group) -> Span:
    """The Span of an axis group: ``local_span`` unless it spans processes,
    else its subgroup (built at first use, on every process: trap 1)."""
    from mlsl_tpu_torch.comm.mesh import GRID_AXES, ProcessGroup

    if not spans(group):
        return local_span(group)
    mlsl_assert(_WORLD.up, "a group spans processes but no process world is up")
    mlsl_assert(group.colors is None, "a color group spanning processes has no Span")
    mlsl_assert(list(group.axes) == sorted(group.axes, key=GRID_AXES.index),
                "a spanning group's axes must be in grid order (major -> minor), got %s",
                group.axes)
    topo = group.topology
    partition = group.process_partition()
    part = next(p for p in partition if topo.proc_index in p)
    # the group's axes over this process's box: the local view's layout
    box = ProcessGroup(topo.local_topology(), group.axes)
    g, gl, ps = group.size, box.size, len(part)
    mlsl_assert(gl * ps == g, "the local members (%d) times the processes (%d) are not "
                "the group (%d)", gl, ps, g)
    index = part.index(topo.proc_index)
    return Span(box=box, g=g, gl=gl, off=index * gl, partition=partition, index=index,
                size=ps)


def local_span(group) -> Span:
    """A process-local group's Span (itself with one process)."""
    box = group.localize() or group
    g = 1 if box.is_self else box.size
    return Span(box=box, g=g, gl=g, off=0)


def build_spanning(kind: str, group, world_body: Callable, *, direct: bool = True,
                   **kw) -> Callable:
    """-> fn: this process's box (R_l, D_l, S_l, M_l, n) -> its rows of the
    collective's result, for a ``group`` that spans processes.
    ``world_body`` is the single-process function over the whole grid, which
    the world form runs on the assembled world. ``direct=False`` takes the
    assembled form for alltoall, bcast and sendrecv too (the direct forms'
    reference)."""
    from mlsl_tpu_torch.comm import collectives

    mlsl_assert(_WORLD.up, "a group spans processes but no process world is up")
    topo = group.topology
    if group.colors is not None or kind == "alltoallv":
        return _world_form(topo, world_body)
    sp = span_of(group)
    box, g, gl, ps, off = sp.box, sp.g, sp.gl, sp.size, sp.off
    op = kw.get("op")

    def view(x):
        return collectives.group_view(x, box)

    def unview(y):
        return collectives.group_unview(y, box)

    if kind in ("allreduce", "reduce"):
        def fn(x):
            y = view(x)
            s = all_reduce(collectives._reduce(y, op or ReductionType.SUM), sp.handle, op)
            return unview(s.expand_as(y))
    elif kind == "reduce_scatter":
        rc = int(kw["recv_count"])

        def fn(x):
            y = view(x)
            c, _, n = y.shape
            mlsl_assert(n == g * rc, "reduce_scatter count %d != group %d * recv_count %d",
                        n, g, rc)
            s = collectives._reduce(y, op or ReductionType.SUM).reshape(c, ps, gl * rc)
            mine = reduce_scatter(s.transpose(0, 1).contiguous(), sp.handle, op)
            return unview(mine.reshape(c, gl, rc))
    elif kind == "allgather":
        def fn(x):
            y = view(x)
            c, _, n = y.shape
            rows = all_gather(y.reshape(c, gl * n), sp.handle)
            out = rows.transpose(0, 1).reshape(c, 1, g * n)
            return unview(out.expand(c, gl, g * n))
    elif kind == "alltoall" and direct:
        sc = int(kw["send_count"])

        def fn(x):
            y = view(x)
            c, _, n = y.shape
            mlsl_assert(n == g * sc, "alltoall count %d != group %d * send_count %d", n, g, sc)
            # [process q, instance, local sender, q's local receiver, block]
            send = y.reshape(c, gl, ps, gl, sc).permute(2, 0, 1, 3, 4).contiguous()
            got = all_to_all(send, sp.index, sp.handle)
            # member j receives chunk j of every member, in member order
            return unview(got.permute(1, 3, 0, 2, 4).reshape(c, gl, n))
    elif kind == "bcast" and direct:
        root = int(kw["root"])
        mlsl_assert(0 <= root < g, "root member index %d out of range for group size %d",
                    root, g)
        src = root // gl

        def fn(x):
            y = view(x)
            rows = y[:, root - off] if src == sp.index else y[:, 0]
            got = broadcast(rows.contiguous(), src, sp.handle)
            return unview(got.unsqueeze(1).expand_as(y))
    elif kind == "sendrecv" and direct:
        pairs = [(int(a), int(b)) for a, b in kw["pairs"]]
        mlsl_assert(all(0 <= v < g for pr in pairs for v in pr),
                    "SendRecvList pairs %s out of range for group size %d", pairs, g)
        mlsl_assert(len({b for _, b in pairs}) == len(pairs),
                    "SendRecvList destinations must be unique")
        mine = range(off, off + gl)
        # rows this process sends each other process, and receives, in pair order
        out_pairs: Dict[int, list] = {}
        in_pairs: Dict[int, list] = {}
        for a, b in pairs:
            pa, pb = a // gl, b // gl
            if pa == sp.index and pb != sp.index:
                out_pairs.setdefault(pb, []).append(a - off)
            if pb == sp.index and pa != sp.index:
                in_pairs.setdefault(pa, []).append(b - off)
        local = [(a - off, b - off) for a, b in pairs if a in mine and b in mine]

        def fn(x):
            y = view(x)
            out = torch.zeros_like(y)
            got = exchange({q: [y[:, idx]] for q, idx in out_pairs.items()},
                           {q: [y[:, idx]] for q, idx in in_pairs.items()}, sp.handle)
            for q, idx in in_pairs.items():
                out[:, idx] = got[q][0]
            for a, b in local:
                out[:, b] = y[:, a]
            return unview(out)
    else:
        body = collectives._BODIES[kind]

        def fn(x):
            y = view(x)
            return unview(body(sp.gather(y), **kw)[:, off:off + gl])
    return fn


def _world_form(topo, world_body: Callable) -> Callable:
    """The assembled world: every process's rows gathered over the world,
    the single-process body run on the whole grid, this process's rows
    kept."""
    lo, size = topo.local_lo, topo.local_size

    def fn(x):
        n = x.shape[-1]
        rows = all_gather(x.reshape(size, n), None).reshape(*topo.grid_shape, n)
        out = world_body(rows)
        return out.reshape(topo.world_size, out.shape[-1])[lo:lo + size].reshape(
            *topo.local_shape, out.shape[-1])

    return fn


# -- the serving engine's records ----------------------------------------------------

#: int64 values in a record's fixed header; the last is the payload's length
RECORD_HEADER = 8


def serve_record(rec: Optional[torch.Tensor], src: int, device=None) -> torch.Tensor:
    """One record of the serving engine (serve/engine.py) from process
    ``src`` to every process of the world, in two broadcasts: its fixed
    header of RECORD_HEADER int64 values, whose last is the payload's
    length, then the payload (none when it is empty). ``rec``: the whole
    record, 1-D int64, on ``src``; None elsewhere. On NCCL the record
    crosses on ``device``. -> the record on every process, on the CPU
    (hop kind ``serve_record``, its bytes counted on ``src``)."""
    import torch.distributed as dist

    dev = device if _WORLD.backend == "nccl" and device is not None else torch.device("cpu")
    mine = _WORLD.index == int(src)
    clk = _Clock()
    if mine:
        rec = rec.reshape(-1).to(dtype=torch.int64)
        head = rec[:RECORD_HEADER].to(dev, copy=True)
    else:
        head = torch.empty(RECORD_HEADER, dtype=torch.int64, device=dev)
    clk.wire()
    dist.broadcast(head, src=int(src))
    n = int(head[-1])
    body = (rec[RECORD_HEADER:].to(dev, copy=True) if mine
            else torch.empty(n, dtype=torch.int64, device=dev))
    if n:
        dist.broadcast(body, src=int(src))
    clk.back()
    out = torch.cat([head, body]).cpu()
    clk.record("serve_record", (out,) if mine else ())
    return out


#: callables run by ``shutdown`` before the group goes (the serving
#: engine's leader tells its followers to stop)
_AT_SHUTDOWN: list = []


def at_shutdown(fn: Callable, register: bool = True) -> None:
    """Run ``fn`` in ``shutdown`` (at the process's exit too) while the
    group is still up; ``register=False`` takes it back."""
    if fn in _AT_SHUTDOWN:
        _AT_SHUTDOWN.remove(fn)
    if register:
        _AT_SHUTDOWN.append(fn)
