"""The latency-class allreduce: recursive halving/doubling as one CUDA kernel on
the card, plain PyTorch on the CPU.

Counterpart of ``mlsl_tpu.ops.rhd_kernels``. On the TPU ``_rhd_call``
(rhd_kernels.py:256, body ``_rhd_kernel_factory`` :146) runs a pre-fold for a
group that is not a power of two, log2(c) halving rounds, log2(c) doubling
rounds and a post-fold as remote-DMA exchanges. With c = 2**k <= G and
r = G - c, every member ends with the value its element's owner computed,
and that value is a fixed binary tree over the members' inputs:

1. pre-fold, when r > 0: v[j] += v[c + j] for j < r, and v[j] += 0.0 for
   r <= j < c (the masked add; it turns -0.0 into +0.0);
2. halving round t at distance d = c >> (t + 1): v[i] = v[i] + v[i ^ d];
3. doubling and post-fold only copy.

Addition is commutative, so after round t all members of a pair hold the
same value and the tree reads v[j] += v[j + d] for j < d. The output is
float32 whatever the input type (the TPU body casts).

Kernel (``csrc/rhd_kernels.cu``): ``rhd_allreduce`` replaces ``_rhd_call``
(B5). One thread per element loads the G members' values (coalesced across
the warp), runs the pre-fold and the tree in registers and writes the result
to all G members. It is bound by memory traffic at large counts (G reads and
G writes per element) and by launch latency at the small-message sizes it is
selected for. The wrapper casts a non-float32 input to float32 first; it
launches for a CUDA tensor and adds one to ``LAUNCHES``, runs the plain
version for a CPU tensor, and raises for any other device.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import MLSLKernelError, mlsl_assert
from mlsl_tpu_torch.ops.ring_kernels import MAX_GROUP
from mlsl_tpu_torch.types import ReductionType

#: window alignment (elements) of the TPU kernel: 8 rows of 128
UNIT = 8 * 128

# launches per kernel wrapper; only the CUDA launch site increments
LAUNCHES = {"rhd_allreduce": 0}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _split(g: int) -> Tuple[int, int, int]:
    """-> (c, k, r): the largest power-of-two core c = 2**k <= g and the
    folded remainder r = g - c."""
    c = 1 << (int(g).bit_length() - 1)
    return c, c.bit_length() - 1, int(g) - c


def rounds(g: int) -> int:
    """Exchange rounds of the TPU schedule: pre-fold + k halvings + k
    doublings + post-fold."""
    c, k, r = _split(g)
    return 2 * k + (2 if r else 0)


def geometry(g: int, count: int) -> Tuple[int, int]:
    """-> (m, m_rows): ``count`` padded to a multiple of c * UNIT, as the TPU
    kernel's working size."""
    c, _k, _r = _split(g)
    m = -(-int(count) // (c * UNIT)) * (c * UNIT)
    return m, m // 128


def eligible(kind: str, group: ProcessGroup, op=None) -> bool:
    """SUM allreduce on a uniform axis-aligned group of 2..64 members; any
    axes (partners are addressed by world rank)."""
    if kind != "allreduce":
        return False
    if op not in (None, ReductionType.SUM):
        return False
    if group.colors is not None or not group.axes or not group.is_uniform:
        return False
    return 1 < group.size <= MAX_GROUP


def env_max_bytes(config=None) -> int:
    """The payload band (bytes) of the heuristic rung: an explicit
    ``pallas_rhd_max_bytes`` wins, else 4 x ``msg_priority_threshold``."""
    v = int(getattr(config, "pallas_rhd_max_bytes", 0) or 0)
    if v > 0:
        return v
    return 4 * int(getattr(config, "msg_priority_threshold", 10000))


class RhdPlan:
    """The member table of a group, (C, G) world ranks in group-position
    order, cached per device as an int32 tensor."""

    def __init__(self, group: ProcessGroup):
        mlsl_assert(eligible("allreduce", group),
                    "pallas_rhd needs an axis-aligned group of 2..%d members (got axes %s)",
                    MAX_GROUP, group.axes)
        self.rows = np.asarray(group.member_table(), dtype=np.int32)
        self._tables: Dict[torch.device, torch.Tensor] = {}

    def table(self, device: torch.device) -> torch.Tensor:
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = torch.from_numpy(self.rows).to(device)
        return t


def rhd_allreduce_ref(x: torch.Tensor, plan: RhdPlan) -> torch.Tensor:
    """x (W, count) -> (W, count) float32: the owner's tree on every member."""
    rows = plan.table(x.device).long()
    cinst, g = rows.shape
    c, k, r = _split(g)
    v = x[rows].to(torch.float32)                  # (C, G, count)
    w = v[:, :c]
    if r:
        w = w + torch.nn.functional.pad(v[:, c:], (0, 0, 0, c - r))
    for t in range(k):
        h = c >> (t + 1)
        w = w[:, :h] + w[:, h:2 * h]
    out = torch.empty((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    out[rows.reshape(-1)] = w.expand(cinst, g, x.shape[1]).reshape(cinst * g, x.shape[1])
    return out


_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from mlsl_tpu_torch.ops import cuda_build

        lib = cuda_build.load("rhd_kernels")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mlsl_rhd_allreduce.argtypes = [p, p, p, i, i, ll, ll, p]
        lib.mlsl_rhd_allreduce.restype = ctypes.c_int
        _lib = lib
    return _lib


def rhd_allreduce(x: torch.Tensor, plan: RhdPlan) -> torch.Tensor:
    """x (W, count), any real dtype, rows possibly strided -> (W, count) f32."""
    mlsl_assert(x.dim() == 2 and x.stride(1) == 1,
                "rhd input must be (W, count) with contiguous rows, got %s", tuple(x.shape))
    if x.device.type == "cpu":
        return rhd_allreduce_ref(x, plan)
    if x.device.type != "cuda":
        raise MLSLKernelError(f"rhd_allreduce: unsupported device {x.device}")
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    rows = plan.table(x.device)
    cinst, g = rows.shape
    mlsl_assert(cinst * g == x.shape[0], "member table covers %d ranks, buffer has %d",
                cinst * g, x.shape[0])
    out = torch.empty((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernels().mlsl_rhd_allreduce(x.data_ptr(), out.data_ptr(), rows.data_ptr(), cinst,
                                       g, x.stride(0), x.shape[1], stream)
    if rc != 0:
        raise MLSLKernelError(f"rhd allreduce kernel launch failed: cudaError {rc}")
    LAUNCHES["rhd_allreduce"] += 1
    return out
