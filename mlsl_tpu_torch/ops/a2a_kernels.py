"""The fused all-to-all: a CUDA kernel on the card, plain PyTorch on the CPU.

Counterpart of ``mlsl_tpu.ops.a2a_kernels``. On the TPU one Pallas kernel
(``_a2a_call``, a2a_kernels.py:250; body ``_a2a_kernel_factory``, :141) owns
the G-1 steps of a shifted-permutation all-to-all: step t sends the chunk for
member (pos+t)%G straight to that chip, with the int8 codec fused at the VMEM
boundary (quantize on send, dequantize on receive) and the self chunk making
the same codec round trip locally. The schedule exists only to move chunks
between chips. Here the G members are virtual ranks on one card, so the
kernel computes the function directly:

    out[c, j, chunk i] = T(in[c, i, chunk j])   for every instance c and
                                                 members i, j of the group

with T the identity (dense) or one int8 round trip of every block of
``block`` elements (quantized), B1's arithmetic: scale = amax / 127 by true
division (1 for an all-zero block), q = x / scale rounded half to even and
clamped to +-127, taken through an integer (so -0.0 comes back +0.0), then
q * scale, with no FMA contraction.

Kernel (``csrc/a2a_kernels.cu``, built by ``ops/cuda_build.py``): B6 in two
variants, ``a2a_dense`` and ``a2a_quant``. Bound by memory traffic: each
element is read once and written once (the codec is a few operations per
element). Rows are read and written by world rank through a (C, G) table of
each instance's members, so a multi-axis group costs no permute copy. The
dense variant copies 16 bytes a thread; the int8 variant gives one warp a
(instance, source member, chunk, block row), with up to 32 values a lane in
registers (blocks of 128 to 1,024 elements). A wrapper launches its kernel
for a CUDA tensor and adds one to ``LAUNCHES``; for a CPU tensor it runs the
plain version; any other device raises.

The entry error feedback of the quantized form runs before the kernel, with
``comm/quant_ring``'s own helpers (B1 for the quantize), as in the JAX
package, so the residual keeps the int8 ring's arithmetic. The chunk
geometry is JAX's: a quantized chunk pads to ``block * ROW_TILE`` elements,
which sets the error-feedback length; the dense variant reads the unpadded
chunks (padding changes nothing in a permutation).

The codec toggle is ``Config.pallas_a2a_quant`` (``MLSL_PALLAS_A2A_QUANT``,
or a tuned profile's knob), which the callers read: JAX's ``quant_enabled``
(:77) has no counterpart. Not ported: ``static_accounting`` (:126), which
checks the TPU kernel's comm-slot handshake; the CUDA kernel has no slots.
``inline_ok`` and ``steps`` have no counterpart either: the kernel route
applies in-graph wherever it is selected (``comm.algos.inline_alltoall``),
with ``exchange``'s gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import MLSLKernelError, mlsl_assert
from mlsl_tpu_torch.ops import quant_kernels as qk
from mlsl_tpu_torch.ops import ring_kernels as rk

#: widest group the exchange serves (the TPU unrolls G-1 steps)
MAX_GROUP = rk.MAX_GROUP

#: widest int8 block the CUDA kernel keeps in registers (32 values a lane)
MAX_QUANT_BLOCK = 1024

# launches per kernel variant; only the CUDA launch site increments
LAUNCHES = {"a2a_dense": 0, "a2a_quant": 0}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def eligible(kind: str, group: ProcessGroup, count: Optional[int] = None, op=None) -> bool:
    """The exchange of an axis-aligned uniform group of 2..64 members, with
    no reduction op and a count that splits G ways. Unlike the TPU's gate
    there is no backend condition: a CUDA tensor launches the kernel and a
    CPU tensor runs the plain version."""
    if kind != "alltoall" or op is not None:
        return False
    if group.colors is not None or not group.axes or not group.is_uniform:
        return False
    if not 1 < group.size <= MAX_GROUP:
        return False
    return count is None or count % group.size == 0


def geometry(g: int, count: int, block: int, quantized: bool) -> Tuple[int, int, int]:
    """-> (rc, chunk, rows): the per-destination slice rc = count / G and its
    padded chunk (slice at the chunk's start), as on the TPU: a quantized
    chunk aligns to ``block * ROW_TILE`` elements (``rows`` block rows), a
    dense one to ``DENSE_UNIT`` (rows of 128)."""
    mlsl_assert(count % g == 0, "alltoall count %d %% group %d != 0", count, g)
    rc = count // g
    if quantized:
        unit = block * rk.ROW_TILE
        chunk = -(-rc // unit) * unit
        return rc, chunk, chunk // block
    chunk = -(-rc // rk.DENSE_UNIT) * rk.DENSE_UNIT
    return rc, chunk, chunk // 128


def wire_bytes(g: int, count: int, block: int, quantized: bool) -> int:
    """Bytes one member would put on a fabric for one exchange (the G-1
    remote chunks; int8 payload and a float32 scale a block row, or float32)."""
    _, chunk, rows = geometry(g, count, block, quantized)
    return (g - 1) * (chunk + 4 * rows if quantized else chunk * 4)


def describe_plan(g: int, count: int, block: int, quantized: bool) -> str:
    """The JAX package's ``pallas.hop`` plan string, without its slot count."""
    _, chunk, rows = geometry(g, count, block, quantized)
    wire = chunk + 4 * rows if quantized else chunk * 4
    codec = f"int8/b{block}" if quantized else "float32"
    return f"hops={g - 1} slot_bytes={wire} codec={codec}"


@dataclasses.dataclass
class A2APlan:
    """Everything a launch needs besides the buffer: ``rows`` (C, G) world
    ranks of each instance's members; the input holds G chunks of
    ``in_chunk`` elements a row (``chunk`` when quantized, the padded layout
    of the entry codec's output; ``rc`` when dense), the output G chunks of
    ``rc``."""

    count: int
    rc: int
    chunk: int
    block: int
    quantized: bool
    rows: np.ndarray
    _tables: Dict[torch.device, torch.Tensor] = dataclasses.field(default_factory=dict,
                                                                  repr=False)

    @property
    def group_size(self) -> int:
        return self.rows.shape[1]

    @property
    def in_chunk(self) -> int:
        return self.chunk if self.quantized else self.rc

    def table(self, device: torch.device) -> torch.Tensor:
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = torch.from_numpy(self.rows).to(device)
        return t


def plan(group: ProcessGroup, count: int, block: int, quantized: bool) -> A2APlan:
    mlsl_assert(eligible("alltoall", group, count),
                "pallas_a2a needs an axis-aligned group of 2..%d members and a count that "
                "splits over it (got axes %s, count %d)", MAX_GROUP, group.axes, count)
    if quantized:
        mlsl_assert(block % 128 == 0,
                    "pallas_a2a int8 codec needs block %% 128 == 0 (got %d)", block)
    rc, chunk, _ = geometry(group.size, count, block, quantized)
    return A2APlan(count, rc, chunk, block, quantized,
                   np.asarray(group.member_table(), dtype=np.int32))


# -- plain version: the semantic oracle -----------------------------------------


def alltoall_ref(x: torch.Tensor, p: A2APlan) -> torch.Tensor:
    """x (W, G * in_chunk) float32 -> (W, G * rc): the (C, G, G, chunk)
    transpose, with one codec round trip per block row when quantized
    (``ring_kernels._qdq``, B1's plain arithmetic)."""
    rows = p.table(x.device).long()
    c, g = rows.shape
    xv = x[rows.reshape(-1)].reshape(c, g, g, p.in_chunk)     # [inst, source, chunk]
    if p.quantized:
        xv = rk._qdq(xv, p.block)
    out = torch.empty((x.shape[0], g * p.rc), dtype=torch.float32, device=x.device)
    out[rows.reshape(-1)] = xv[..., :p.rc].transpose(1, 2).reshape(c * g, g * p.rc)
    return out


# -- kernel wrapper ----------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from mlsl_tpu_torch.ops import cuda_build

        lib = cuda_build.load("a2a_kernels")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mlsl_a2a_dense.argtypes = [p, p, p, i, i, ll, ll, ll, ll, ll, p]
        lib.mlsl_a2a_quant.argtypes = [p, p, p, i, i, ll, ll, i, i, ll, ll, p]
        for fn in (lib.mlsl_a2a_dense, lib.mlsl_a2a_quant):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def alltoall(x: torch.Tensor, p: A2APlan) -> torch.Tensor:
    """x (W, G * in_chunk) float32, rows may be strided -> (W, G * rc)
    float32: one launch of B6 (``a2a_quant`` when the plan is quantized,
    else ``a2a_dense``) for a CUDA tensor, the plain version for a CPU one."""
    g = p.group_size
    mlsl_assert(x.dim() == 2 and x.shape[1] == g * p.in_chunk and x.stride(1) == 1,
                "alltoall input must be (W, %d) with contiguous rows, got %s",
                g * p.in_chunk, tuple(x.shape))
    mlsl_assert(x.dtype == torch.float32, "alltoall input must be float32, got %s", x.dtype)
    if x.device.type == "cpu":
        return alltoall_ref(x, p)
    if x.device.type != "cuda":
        raise MLSLKernelError(f"alltoall: unsupported device {x.device}")
    rows = p.table(x.device)
    c = rows.shape[0]
    mlsl_assert(c * g == x.shape[0], "member table covers %d ranks, buffer has %d", c * g,
                x.shape[0])
    out = torch.empty((x.shape[0], g * p.rc), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p.quantized:
        mlsl_assert(p.block % 128 == 0 and p.block <= MAX_QUANT_BLOCK,
                    "the CUDA int8 all-to-all takes blocks that are multiples of 128 up to "
                    "%d (got %d)", MAX_QUANT_BLOCK, p.block)
        rc = _kernels().mlsl_a2a_quant(
            x.data_ptr(), out.data_ptr(), rows.data_ptr(), c, g, x.stride(0), out.stride(0),
            p.chunk // p.block, p.block, p.rc, p.rc, stream)
        name = "a2a_quant"
    else:
        rc = _kernels().mlsl_a2a_dense(
            x.data_ptr(), out.data_ptr(), rows.data_ptr(), c, g, x.stride(0), out.stride(0),
            p.rc, p.rc, p.rc, stream)
        name = "a2a_dense"
    if rc != 0:
        raise MLSLKernelError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


# -- the exchange bodies -------------------------------------------------------------


def alltoall_body_ef(group: ProcessGroup, count: int, *, block: int = 256,
                     quantized: bool = True, plain: bool = False) -> Tuple[Callable, int]:
    """-> (body ``(x, err) -> (out, new_err)``, err_len) over world rows:
    x (W, count) of any float type, err (W, err_len) float32 or None (a zero
    residual), out (W, count) float32. Chunk j of a member's output is the
    chunk member j sent it. Quantized: the entry error feedback (B1 for the
    quantize, as quant_ring's helpers do it) gives xhat and the new residual,
    then one B6 launch makes every chunk's second codec round trip on the
    way; dense: new_err is None. ``plain`` runs the kernels' plain versions
    on any device (the card's parity checks)."""
    from mlsl_tpu_torch.comm import quant_ring

    g = group.size
    mlsl_assert(g > 1, "pallas_a2a needs a group with >1 member")
    p = plan(group, count, block, quantized)
    err_len = g * p.chunk if quantized else 0
    quantize = qk.quantize_blocks_ref if plain else qk.quantize_blocks
    run = alltoall_ref if plain else alltoall

    def body(x: torch.Tensor, err: Optional[torch.Tensor]):
        mlsl_assert(x.shape[-1] == count, "buffer count %d != exchange count %d",
                    x.shape[-1], count)
        x = x.to(torch.float32)
        if not quantized:
            return run(x, p), None
        w = x.shape[0]
        xq = quant_ring._to_chunks(x[:, None], g, p.rc, p.chunk).reshape(w, err_len)
        if err is not None:
            xq = xq + err
        q0, s0 = quant_ring._quant(xq, block, quantize)
        xhat = quant_ring._dequant(q0, s0, xq.shape)
        return run(xhat, p), xq - xhat

    return body, err_len


@functools.lru_cache(maxsize=64)
def _exchange_bodies(group: ProcessGroup, count: int, block: int,
                     quantized: bool) -> Tuple[Callable, Callable]:
    fwd, _ = alltoall_body_ef(group, count, block=block, quantized=quantized)
    back, _ = alltoall_body_ef(group, count, quantized=False)
    return fwd, back


class _Exchange(torch.autograd.Function):
    """The kernel route inside a training graph. An all-to-all with split =
    concat = 0 and leading dim G is its own transpose, so the backward
    exchanges the cotangent with the dense B6; for the int8 forward the codec
    passes straight through (the JAX package defines no gradient for its
    kernel)."""

    @staticmethod
    def forward(ctx, x, fwd, back):
        ctx.back = back
        out, _ = fwd(x, None)
        return out

    @staticmethod
    def backward(ctx, grad):
        out, _ = ctx.back(grad.contiguous(), None)
        return out, None, None


def exchange(x: torch.Tensor, group: ProcessGroup, *, block: int,
             quantized: bool) -> torch.Tensor:
    """The stateless exchange of world rows x (W, count) float32 -> (W,
    count), differentiable: the inline route of the MoE exchanges."""
    fwd, back = _exchange_bodies(group, int(x.shape[-1]), int(block), bool(quantized))
    return _Exchange.apply(x, fwd, back)
