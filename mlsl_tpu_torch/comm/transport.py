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
(``ProcessGroup.process_partition``), in member order:

- allreduce, reduce: a local reduction of the G_l members, ``all_reduce``
  over the subgroup, the result to every local member;
- reduce_scatter: a local reduction, ``reduce_scatter_tensor`` over the
  subgroup, each local member its slice: the local members are an aligned
  run of the group's members, so a process's chunk is exactly their slices;
- allgather: ``all_gather_into_tensor`` of the local members' rows;
- every other kind (bcast, gather, scatter, alltoall, allgatherv, sendrecv):
  the assembled form, the group's rows gathered over the subgroup, the
  single-process body run on the assembled (C_l, G, n) view, the local
  members' rows kept. It moves G x the bytes of a direct exchange (standing
  difference "the assembled form"; a direct ``all_to_all_single`` is A.8b).
  A color group's and alltoallv's assembled form gathers the world's rows.

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
"""

from __future__ import annotations

import dataclasses
import socket
import time
import warnings
from typing import Callable, Dict, Tuple

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

#: per hop kind: calls, bytes this process handed over, host seconds
HOP_STATS: Dict[str, list] = {}


def world() -> ProcessWorld:
    return _WORLD


def owner_of(rank: int, world_size: int, count: int) -> int:
    """The process that holds virtual rank ``rank``."""
    return int(rank) // max(1, int(world_size) // max(1, int(count)))


def reset_stats() -> None:
    HOP_STATS.clear()


def hop_totals() -> dict:
    """{kind: {"calls", "bytes", "s"}} since the last reset."""
    return {k: {"calls": v[0], "bytes": v[1], "s": v[2]} for k, v in HOP_STATS.items()}


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
    return _WORLD


def shutdown() -> None:
    """Destroy the process group (a test's teardown; ``Environment.finalize``
    keeps it up, as the JAX package keeps ``jax.distributed``)."""
    if _WORLD.up:
        import torch.distributed as dist

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


def _record(kind: str, nbytes: int, t0: float) -> None:
    rec = HOP_STATS.setdefault(kind, [0, 0, 0.0])
    rec[0] += 1
    rec[1] += int(nbytes)
    rec[2] += time.perf_counter() - t0


def all_reduce(t: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """-> the reduction of ``t`` over the subgroup, on ``t``'s device."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    x = _staged(t).clone()
    dist.all_reduce(x, op=_op(op), group=group)
    _record("all_reduce", x.numel() * x.element_size(), t0)
    return x.to(t.device)


def reduce_scatter(t: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """``t`` (P_s, *chunk) -> this process's chunk of the reduction."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    x = _staged(t)
    out = x.new_empty(x.shape[1:])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dist.reduce_scatter_tensor(out.view(-1), x.view(-1), op=_op(op), group=group)
    _record("reduce_scatter", x.numel() * x.element_size(), t0)
    return out.to(t.device)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """-> (P_s, *t.shape): every process's ``t``, in process order."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    x = _staged(t)
    n = dist.get_world_size(group)
    out = x.new_empty((n, *x.shape))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dist.all_gather_into_tensor(out.view(-1), x.view(-1), group=group)
    _record("all_gather", x.numel() * x.element_size(), t0)
    return out.to(t.device)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """-> process ``src``'s ``t`` (its index in the subgroup)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    x = _staged(t).clone()
    dist.broadcast(x, src=dist.get_global_rank(group, int(src)) if group is not None
                   else int(src), group=group)
    _record("broadcast", x.numel() * x.element_size(), t0)
    return x.to(t.device)


def barrier(group=None) -> None:
    import torch.distributed as dist

    t0 = time.perf_counter()
    dist.barrier(group=group)
    _record("barrier", 0, t0)


# -- the spanning forms ---------------------------------------------------------------


def build_spanning(kind: str, group, world_body: Callable, **kw) -> Callable:
    """-> fn: this process's box (R_l, D_l, S_l, M_l, n) -> its rows of the
    collective's result, for a ``group`` that spans processes.
    ``world_body`` is the single-process function over the whole grid, which
    the world form runs on the assembled world."""
    from mlsl_tpu_torch.comm import collectives
    from mlsl_tpu_torch.comm.mesh import GRID_AXES, ProcessGroup

    mlsl_assert(_WORLD.up, "a group spans processes but no process world is up")
    topo = group.topology
    if group.colors is not None or kind == "alltoallv":
        return _world_form(topo, world_body)
    mlsl_assert(list(group.axes) == sorted(group.axes, key=GRID_AXES.index),
                "a spanning group's axes must be in grid order (major -> minor), got %s",
                group.axes)
    partition = group.process_partition()
    part = next(p for p in partition if topo.proc_index in p)
    handle = subgroup(partition)
    # the group's axes over this process's box: the local view's layout
    box = ProcessGroup(topo.local_topology(), group.axes)
    g, gl, ps = group.size, box.size, len(part)
    mlsl_assert(gl * ps == g, "the local members (%d) times the processes (%d) are not "
                "the group (%d)", gl, ps, g)
    off = part.index(topo.proc_index) * gl
    op = kw.get("op")

    def view(x):
        return collectives.group_view(x, box)

    def unview(y):
        return collectives.group_unview(y, box)

    if kind in ("allreduce", "reduce"):
        def fn(x):
            y = view(x)
            s = all_reduce(collectives._reduce(y, op or ReductionType.SUM), handle, op)
            return unview(s.expand_as(y))
    elif kind == "reduce_scatter":
        rc = int(kw["recv_count"])

        def fn(x):
            y = view(x)
            c, _, n = y.shape
            mlsl_assert(n == g * rc, "reduce_scatter count %d != group %d * recv_count %d",
                        n, g, rc)
            s = collectives._reduce(y, op or ReductionType.SUM).reshape(c, ps, gl * rc)
            mine = reduce_scatter(s.transpose(0, 1).contiguous(), handle, op)
            return unview(mine.reshape(c, gl, rc))
    elif kind == "allgather":
        def fn(x):
            y = view(x)
            c, _, n = y.shape
            rows = all_gather(y.reshape(c, gl * n), handle)
            out = rows.transpose(0, 1).reshape(c, 1, g * n)
            return unview(out.expand(c, gl, g * n))
    else:
        body = collectives._BODIES[kind]

        def fn(x):
            y = view(x)
            c, _, n = y.shape
            full = all_gather(y, handle).transpose(0, 1).reshape(c, g, n)
            return unview(body(full, **kw)[:, off:off + gl])
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


def refuse(what: str) -> None:
    """The paths left for A.8b raise on a world of more than one process."""
    if _WORLD.count > 1:
        raise MLSLError(f"{what} runs in a one-process world only: across processes it is "
                        f"ROADMAP A.8b")
