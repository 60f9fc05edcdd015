"""The fused ring allreduce / reduce-scatter / all-gather: CUDA kernels on
the card, plain PyTorch on the CPU.

Counterpart of ``mlsl_tpu.ops.ring_kernels``. On the TPU one Pallas kernel
(``_ring_call``, ring_kernels.py:698) owns a whole ring in one of three
modes: ``allreduce`` (G-1 remote-DMA hops of a reduce-scatter, then G-1 hops
of an all-gather), ``reduce_scatter`` (the first half alone) and
``all_gather`` (the gather hops alone, from ``base = 0`` at :649: each member
brings only its own shard, the ZeRO-1 increment exchange), optionally with
the int8 codec on every hop of the first two. Here the G members of a group
are virtual ranks on one card (comm/mesh.py), so the hop sequence becomes a
loop over the members inside one thread (dense) or one warp (int8), in the
TPU kernel's order:

- for chunk j of an instance the travelling partial starts at ring member
  j+1 with its chunk j, and members j+2, ..., j+G = j each add theirs
  (``acc = got + loc``); after G-1 hops member j holds the sum;
- with the bidirectional split the chunk's rows from ``ra`` on walk the
  other way (start at j-1, walk down), another summation order;
- the all-gather only copies, so every member's output is written directly
  with the owner's value; the int8 variant requantizes the partial on every
  hop (``acc = dequant(quant(acc)) + loc``) and every member, the owner
  included, receives ``q * s`` of one final quantization.

Kernels (``csrc/ring_kernels.cu``, built by ``ops/cuda_build.py``):

- ``dense_ring`` replaces the dense ``_ring_call`` (B3; body
  ``_ring_kernel_factory``, ring_kernels.py:473) for float32, bfloat16 and
  int32. Bound by memory traffic: every input element is read once and every
  output element written once, so what limits it is the bytes in flight. A
  thread owns 16-byte vectors of a chunk (grid-stride, a scalar head and
  tail where a chunk starts off a 16-byte boundary), loads every member's
  vector before its first add (the hop loop unrolled for G = 2, 4, 8;
  batches of eight members otherwise), accumulates in the buffer's type in
  hop order and writes the sum to its member, or to every member.
- ``dense_ring`` with a plan of kind ``all_gather`` replaces the gather-only
  ``_ring_call`` (B3-AG; the same body, ``mode="all_gather"``), for the same
  dtypes. A pure copy, bound by memory traffic: one thread per (instance,
  owner, element) reads the owner's element once, with coalesced loads, and
  stores it into every member's row at the owner's group position, so the
  chunks land in group-position order also over the snake cycle. The result
  is bit-exact by construction, -0.0 included.
- ``quant_ring`` replaces the quantized ``_ring_call`` (B4; bodies
  ``quant_ring_body``, :885, and ``_quantize_rows``, :463). Bound by memory
  traffic as well (the codec is a few operations per element per hop). One
  warp per block row keeps the row's partial in registers across all hops,
  reduces each hop's max|x| with warp shuffles and rounds as B1 does
  (``__fdiv_rn``, ``rintf``, ``__fmul_rn`` then ``__fadd_rn``), so the kernel
  is bit-exact against the plain version.

Both kernels read the world buffer (W, n) through a table of world ranks in
ring order, so no group view is copied, and write the logical layout
directly. A wrapper launches its kernel for a CUDA tensor and adds one to
``LAUNCHES``; for a CPU tensor it runs the plain version; any other device
raises. The TPU's comm slots and capacity handshake have no counterpart:
nothing is in flight between members on one card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import MLSLKernelError, mlsl_assert
from mlsl_tpu_torch.ops import quant_kernels as qk
from mlsl_tpu_torch.types import ReductionType

#: dense ring chunk alignment (elements): 32 rows of 128, as on the TPU
DENSE_UNIT = 32 * 128

#: widest group the ring serves (the TPU unrolls 2*(G-1) hop bodies)
MAX_GROUP = 64

#: int8 chunk alignment in block rows: the TPU's ROW_TILE, and PACK_ROWS for
#: per-rank slices of at least 8 * block * PACK_ROWS elements
ROW_TILE = 32
PACK_ROWS = 1024

#: widest int8 block the CUDA ring keeps in registers (32 values a lane)
MAX_QUANT_BLOCK = 1024

# launches per kernel wrapper; only the CUDA launch site increments
LAUNCHES = {"dense_ring": 0, "dense_ring_gather": 0, "quant_ring": 0}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- eligibility ---------------------------------------------------------------


def ring_axis(group: ProcessGroup) -> Optional[str]:
    """The single live grid axis a ring rides, or None."""
    if group.colors is not None or not group.axes:
        return None
    live = group.live_axes()
    return live[0] if len(live) == 1 else None


def ring_axes2(group: ProcessGroup) -> Optional[Tuple[str, str]]:
    """The (major, minor) live axis pair of a 2-live-axis group, or None."""
    if group.colors is not None or not group.axes:
        return None
    live = group.live_axes()
    return (live[0], live[1]) if len(live) == 2 else None


def eligible_dense(kind: str, group: ProcessGroup, op=None) -> bool:
    """SUM allreduce / reduce_scatter on a single-live-axis group of 2..64
    members. Unlike the TPU's gate there is no backend condition: a CUDA
    tensor launches the kernel and a CPU tensor runs the plain version."""
    if kind not in ("allreduce", "reduce_scatter"):
        return False
    if op not in (None, ReductionType.SUM):
        return False
    return ring_axis(group) is not None and 1 < group.size <= MAX_GROUP


def eligible_dense2d(kind: str, group: ProcessGroup, op=None) -> bool:
    """The same ring over the snake cycle of a two-live-axis group."""
    if kind not in ("allreduce", "reduce_scatter"):
        return False
    if op not in (None, ReductionType.SUM):
        return False
    return ring_axes2(group) is not None and 1 < group.size <= MAX_GROUP


def eligible_quant(group: ProcessGroup, block: int) -> bool:
    """The int8 variant: dense eligibility plus the codec's block % 128 rule."""
    if block % 128 != 0:
        return False
    return ring_axis(group) is not None and 1 < group.size <= MAX_GROUP


# -- geometry ------------------------------------------------------------------


def dense_geometry(kind: str, group: ProcessGroup, count: int) -> Tuple[int, int, int]:
    """-> (g, rc, chunk): the per-rank logical slice rc and the DENSE_UNIT
    aligned ring chunk (slice j sits at the start of padded chunk j). For
    ``all_gather`` the count is the per-member shard, so rc = count."""
    g = 1 if group.is_self else group.size
    if kind == "reduce_scatter":
        mlsl_assert(count % g == 0, "reduce_scatter count %d %% group %d != 0", count, g)
        rc = count // g
    elif kind == "all_gather":
        rc = count
    else:
        rc = -(-count // g)
    chunk = -(-rc // DENSE_UNIT) * DENSE_UNIT
    return g, rc, chunk


def quant_unit(rc: int, block: int) -> int:
    """The int8 ring's chunk unit for a per-rank slice of ``rc`` elements:
    block * ROW_TILE elements, or block * PACK_ROWS once rc >= 8 * block *
    PACK_ROWS (the TPU's pallas units, which set the error-feedback length
    of this wire)."""
    return block * (PACK_ROWS if rc >= 8 * block * PACK_ROWS else ROW_TILE)


def quant_geometry(kind: str, group: ProcessGroup, count: int,
                   block: int) -> Tuple[int, int, int, int]:
    """-> (g, rc, chunk, err_len) for the int8 ring: chunks align to
    ``quant_unit``."""
    g = 1 if group.is_self else group.size
    if kind == "reduce_scatter":
        mlsl_assert(count % g == 0, "reduce_scatter count %d %% group %d != 0", count, g)
        rc = count // g
    else:
        rc = -(-count // g)
    unit = quant_unit(rc, block)
    chunk = -(-rc // unit) * unit
    return g, rc, chunk, g * chunk


# -- ring order ----------------------------------------------------------------


def _snake_order(row, a: int, b: int):
    """One instance's member row (major-axis-major, length a*b) in the
    boustrophedon order of the (a, b) torus: even major rows walk the minor
    axis up, odd rows down."""
    return [row[i * b + (j if i % 2 == 0 else b - 1 - j)]
            for i in range(a) for j in range(b)]


def _torus(group: ProcessGroup) -> Tuple[int, int]:
    axes2 = ring_axes2(group)
    mlsl_assert(axes2 is not None, "pallas_ring2d needs a 2-live-axis group (got axes=%s)",
                group.axes)
    topo = group.topology
    return topo.axis_size(axes2[0]), topo.axis_size(axes2[1])


def _snake_perm(group: ProcessGroup) -> np.ndarray:
    """Ring slot -> group position for the snake cycle: ring chunk i is
    logical chunk perm[i], so reduce_scatter lands each member its own
    group-position chunk and allreduce undoes the permutation on the way out."""
    a, b = _torus(group)
    return np.asarray(_snake_order(list(range(a * b)), a, b), dtype=np.int32)


def _ring_rows(group: ProcessGroup, snake: bool = False) -> np.ndarray:
    """(C, G) world ranks, one row per group instance, in ring order."""
    rows = group.member_table()
    if snake:
        a, b = _torus(group)
        rows = [_snake_order(list(row), a, b) for row in rows]
    return np.asarray(rows, dtype=np.int32)


def _ring_tables(group: ProcessGroup, snake: bool = False):
    """Per-world-rank ring addressing ``(pos, right, left)``, as the TPU
    kernel's scalar-prefetch operands: each member's ring position and its
    neighbours' world ranks."""
    w = group.topology.world_size
    pos = np.zeros((w,), dtype=np.int32)
    right = np.zeros((w,), dtype=np.int32)
    left = np.zeros((w,), dtype=np.int32)
    for row in _ring_rows(group, snake):
        g = len(row)
        for i, p in enumerate(row):
            pos[p] = i
            right[p] = row[(i + 1) % g]
            left[p] = row[(i - 1) % g]
    return pos, right, left


@dataclasses.dataclass
class RingPlan:
    """Everything a ring launch needs besides the buffer.

    ``ring`` (C, G): world ranks in ring order; ``chunk_of`` (G,): the
    logical chunk ring chunk i carries; ``split``: the element offset inside
    a chunk from which the rows walk the opposite direction (``chunk`` when
    the ring is unidirectional); ``cols``: 128 (dense) or the int8 block."""

    kind: str
    count: int
    rc: int
    chunk: int
    cols: int
    split: int
    ring: np.ndarray
    chunk_of: np.ndarray
    _tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def group_size(self) -> int:
        return self.ring.shape[1]

    def tables(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self._tables.get(device)
        if t is None:
            t = (torch.from_numpy(self.ring).to(device),
                 torch.from_numpy(self.chunk_of).to(device))
            self._tables[device] = t
        return t


def _bidir_split(rows: int, cols: int, row_tile: int, bidir: bool) -> int:
    """The bidirectional split of a chunk of ``rows`` rows, in elements: the
    rows halve on a ``row_tile`` boundary, and only when rows >= 2 * row_tile
    (ring_kernels.py:723-730)."""
    if bidir and rows >= 2 * row_tile:
        return (rows // 2 // row_tile) * row_tile * cols
    return rows * cols


def dense_plan(kind: str, group: ProcessGroup, count: int, *, bidir: bool,
               snake: bool = False, recv_count: Optional[int] = None) -> RingPlan:
    """``bidir`` is ``Config.pallas_ring_bidir``, passed down by the caller;
    the all-gather has no summation order, so it ignores it."""
    if kind == "all_gather":
        axes = ring_axes2(group) if snake else ring_axis(group)
        ok = axes is not None and 1 < group.size <= MAX_GROUP
    else:
        ok = eligible_dense2d(kind, group) if snake else eligible_dense(kind, group)
    mlsl_assert(ok, "%s cannot lower %s on group axes %s",
                "pallas_ring2d" if snake else "pallas_ring", kind, group.axes)
    g, rc, chunk = dense_geometry(kind, group, count)
    if kind == "reduce_scatter" and recv_count is not None:
        mlsl_assert(recv_count == rc, "pallas_ring reduce_scatter recv_count %s != count//G %d",
                    recv_count, rc)
    chunk_of = _snake_perm(group) if snake else np.arange(g, dtype=np.int32)
    return RingPlan(kind, count, rc, chunk, 128, _bidir_split(chunk // 128, 128, 8, bidir),
                    _ring_rows(group, snake), chunk_of)


def quant_plan(kind: str, group: ProcessGroup, count: int, block: int, *,
               bidir: bool) -> RingPlan:
    mlsl_assert(eligible_quant(group, block),
                "the int8 pallas ring needs a single-live-axis group of 2..%d members "
                "and block %% 128 == 0 (got axes %s, block %d)", MAX_GROUP, group.axes, block)
    g, rc, chunk, _ = quant_geometry(kind, group, count, block)
    return RingPlan(kind, count, rc, chunk, block,
                    _bidir_split(chunk // block, block, ROW_TILE, bidir),
                    _ring_rows(group), np.arange(g, dtype=np.int32))


# -- plain versions: the semantic oracle ---------------------------------------


def _walks(plan: RingPlan, device):
    """(ring, chunk_of, i, step) with step(s, sign) -> (member, chunk) index
    tensors of hop s of the ring that starts one member past each chunk's
    owner in direction ``sign``."""
    ring, chunk_of = plan.tables(device)
    g = plan.group_size
    i = torch.arange(g, device=device)
    return ring, chunk_of, lambda s, sign: ((i + sign * s) % g, i)


def _deliver(plan: RingPlan, acc: torch.Tensor, ring: torch.Tensor,
             chunk_of: torch.Tensor, w: int) -> torch.Tensor:
    """acc (C, G ring chunks, >= rc) -> the world result: reduce_scatter
    (W, rc), ring chunk i to ring member i; allreduce (W, count), every
    chunk in logical order to every member."""
    c, g = ring.shape
    out_shape = (w, plan.rc if plan.kind == "reduce_scatter" else plan.count)
    out = torch.empty(out_shape, dtype=acc.dtype, device=acc.device)
    if plan.kind == "reduce_scatter":
        out[ring.reshape(-1)] = acc[..., :plan.rc].reshape(c * g, plan.rc)
        return out
    logical = torch.empty_like(acc[..., :plan.rc])
    logical[:, chunk_of.long()] = acc[..., :plan.rc]
    row = logical.reshape(c, 1, g * plan.rc)[..., :plan.count]
    out[ring.reshape(-1)] = row.expand(c, g, plan.count).reshape(c * g, plan.count)
    return out


def _gather_ref(x: torch.Tensor, plan: RingPlan) -> torch.Tensor:
    """x (W, rc) -> (W, G*rc): the owner at ring slot i places its shard at
    group position chunk_of[i] of every member of its instance."""
    ring, chunk_of = plan.tables(x.device)
    c, g = ring.shape
    rc = plan.rc
    logical = torch.empty((c, g, rc), dtype=x.dtype, device=x.device)
    logical[:, chunk_of.long()] = x[ring.long()]
    out = torch.empty((x.shape[0], g * rc), dtype=x.dtype, device=x.device)
    out[ring.reshape(-1).long()] = logical.reshape(c, 1, g * rc).expand(
        c, g, g * rc).reshape(c * g, g * rc)
    return out


def dense_ring_ref(x: torch.Tensor, plan: RingPlan) -> torch.Tensor:
    """x (W, count) f32/bf16/i32 -> the ring's result in x's dtype, with the
    kernel's exact summation order: the accumulator has the buffer's dtype
    (bf16 rounds after every hop, i32 wraps). For ``all_gather`` x (W, rc)
    holds each member's shard and the result (W, G*rc) every shard in group
    position order."""
    if plan.kind == "all_gather":
        return _gather_ref(x, plan)
    ring, chunk_of, hop = _walks(plan, x.device)
    c, g = ring.shape
    rc = plan.rc
    xv = torch.nn.functional.pad(x[ring.long()], (0, g * rc - x.shape[1]))
    xv = xv.reshape(c, g, g, rc)[:, :, chunk_of.long()]   # [inst, ring member, ring chunk]

    def walk(sign, lo):
        acc = xv[:, *hop(1, sign), lo:]
        for s in range(2, g + 1):
            acc = acc + xv[:, *hop(s, sign), lo:]
        return acc

    acc = walk(1, 0)
    if plan.split < rc:
        acc[..., plan.split:] = walk(-1, plan.split)
    return _deliver(plan, acc, ring, chunk_of, x.shape[0])


def _qdq(a: torch.Tensor, block: int) -> torch.Tensor:
    """One hop's codec on block rows: dequantize(quantize(a)), B1's arithmetic."""
    q, s = qk.quantize_blocks_ref(a.reshape(-1, block))
    return qk.dequantize_blocks_ref(q, s).reshape(a.shape)


def quant_ring_ref(xhat: torch.Tensor, plan: RingPlan) -> torch.Tensor:
    """xhat (W, G*chunk) f32 in the padded ring layout (the entry codec's
    output) -> allreduce (W, count) or reduce_scatter (W, rc) f32."""
    ring, chunk_of, hop = _walks(plan, xhat.device)
    c, g = ring.shape
    block = plan.cols
    rows = plan.chunk // block
    xv = xhat[ring.long()].reshape(c, g, g, rows, block)
    ra = plan.split // block

    def walk(sign, r0, r1):
        sub = xv[..., r0:r1, :]
        acc = sub[:, *hop(1, sign)]
        for s in range(2, g + 1):
            acc = _qdq(acc, block) + sub[:, *hop(s, sign)]
        return acc

    acc = walk(1, 0, ra)
    if ra < rows:
        acc = torch.cat([acc, walk(-1, ra, rows)], dim=2)
    if plan.kind == "allreduce":
        acc = _qdq(acc, block)
    return _deliver(plan, acc.reshape(c, g, plan.chunk), ring, chunk_of, xhat.shape[0])


# -- kernel wrappers -----------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from mlsl_tpu_torch.ops import cuda_build

        lib = cuda_build.load("ring_kernels")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mlsl_dense_ring.argtypes = [p, p, p, p, i, i, ll, ll, ll, ll, i, i, p]
        lib.mlsl_dense_ring_gather.argtypes = [p, p, p, p, i, i, ll, ll, i, p]
        lib.mlsl_quant_ring.argtypes = [p, p, p, i, i, ll, i, i, i, ll, ll, i, p]
        for fn in (lib.mlsl_dense_ring, lib.mlsl_dense_ring_gather, lib.mlsl_quant_ring):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise MLSLKernelError(f"{what} kernel launch failed: cudaError {rc}")


def _check_rows(x: torch.Tensor, width: int, what: str) -> None:
    mlsl_assert(x.dim() == 2 and x.shape[1] == width,
                "%s must be (W, %d), got %s", what, width, tuple(x.shape))
    mlsl_assert(x.stride(1) == 1, "%s rows must be contiguous", what)


def dense_ring(x: torch.Tensor, plan: RingPlan) -> torch.Tensor:
    """x (W, count) f32/bf16/i32 -> allreduce (W, count), reduce_scatter
    (W, rc) or all_gather (W, G*rc), in x's dtype. Rows may be strided (a
    chunk of a wider buffer)."""
    _check_rows(x, plan.count, "dense ring input")
    mlsl_assert(x.dtype in _DTYPE_CODE, "dense ring takes float32, bfloat16 or int32, got %s",
                x.dtype)
    if x.device.type == "cpu":
        return dense_ring_ref(x, plan)
    if x.device.type != "cuda":
        raise MLSLKernelError(f"dense_ring: unsupported device {x.device}")
    ring, chunk_of = plan.tables(x.device)
    c, g = ring.shape
    mlsl_assert(c * g == x.shape[0], "ring table covers %d ranks, buffer has %d", c * g,
                x.shape[0])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.kind == "all_gather":
        out = torch.empty((x.shape[0], g * plan.rc), dtype=x.dtype, device=x.device)
        rc = _kernels().mlsl_dense_ring_gather(
            x.data_ptr(), out.data_ptr(), ring.data_ptr(), chunk_of.data_ptr(), c, g,
            x.stride(0), plan.rc, _DTYPE_CODE[x.dtype], stream,
        )
        _check_launch(rc, "dense ring all-gather")
        LAUNCHES["dense_ring_gather"] += 1
        return out
    rs = plan.kind == "reduce_scatter"
    out = torch.empty((x.shape[0], plan.rc if rs else plan.count), dtype=x.dtype,
                      device=x.device)
    rc = _kernels().mlsl_dense_ring(
        x.data_ptr(), out.data_ptr(), ring.data_ptr(), chunk_of.data_ptr(), c, g,
        x.stride(0), plan.rc, plan.count, plan.split, int(rs), _DTYPE_CODE[x.dtype], stream,
    )
    _check_launch(rc, "dense ring")
    LAUNCHES["dense_ring"] += 1
    return out


def quant_ring(xhat: torch.Tensor, plan: RingPlan) -> torch.Tensor:
    """xhat (W, G*chunk) f32, the entry codec's output in the padded ring
    layout -> allreduce (W, count) or reduce_scatter (W, rc) f32."""
    g = plan.group_size
    _check_rows(xhat, g * plan.chunk, "int8 ring input")
    mlsl_assert(xhat.dtype == torch.float32, "int8 ring input must be float32, got %s",
                xhat.dtype)
    if xhat.device.type == "cpu":
        return quant_ring_ref(xhat, plan)
    if xhat.device.type != "cuda":
        raise MLSLKernelError(f"quant_ring: unsupported device {xhat.device}")
    block = plan.cols
    mlsl_assert(block % 128 == 0 and block <= MAX_QUANT_BLOCK,
                "the CUDA int8 ring takes blocks that are multiples of 128 up to %d (got %d)",
                MAX_QUANT_BLOCK, block)
    ring, _ = plan.tables(xhat.device)
    c = ring.shape[0]
    mlsl_assert(c * g == xhat.shape[0], "ring table covers %d ranks, buffer has %d", c * g,
                xhat.shape[0])
    rs = plan.kind == "reduce_scatter"
    out = torch.empty((xhat.shape[0], plan.rc if rs else plan.count), dtype=torch.float32,
                      device=xhat.device)
    stream = torch.cuda.current_stream(xhat.device).cuda_stream
    rc = _kernels().mlsl_quant_ring(
        xhat.data_ptr(), out.data_ptr(), ring.data_ptr(), c, g, xhat.stride(0),
        plan.chunk // block, block, plan.split // block, plan.rc, plan.count, int(rs), stream,
    )
    _check_launch(rc, "int8 ring")
    LAUNCHES["quant_ring"] += 1
    return out


# -- the staged form -------------------------------------------------------------


def steps(kind: str, group: ProcessGroup, count: int, *, recv_count: Optional[int] = None,
          bidir: bool = False, snake: bool = False, plain: bool = False):
    """The staged form (``mlsl_tpu.ops.ring_kernels.steps``, :991-1024):
    ``(prep, phases, finish)`` with ONE phase, the whole ring in one launch.
    The carry is the distributed buffer (R, D, S, M, n): ``prep`` takes the
    (R, D, S, M, count) input, the phase runs ``dense_ring`` over its world
    view (``plain``: the plain version), ``finish`` returns the result
    buffer. ``kind='all_gather'`` is the ZeRO-1 increment exchange: ``count``
    is the per-member shard and the result (R, D, S, M, G*count) holds every
    shard in group-position order. ``snake`` rides the snake cycle of a
    two-live-axis group (pallas_ring2d)."""
    from mlsl_tpu_torch.comm.collectives import world_view

    topo = group.topology
    plan = dense_plan(kind, group, count, bidir=bidir, snake=snake, recv_count=recv_count)
    run = dense_ring_ref if plain else dense_ring

    def phase(buf):
        out = run(world_view(buf, topo), plan)
        return out.reshape(*topo.grid_shape, out.shape[-1])

    return (lambda buf: buf), [phase], (lambda buf: buf)
