"""Blockwise int8 quantization: CUDA kernels on the card, plain PyTorch on the CPU.

Counterpart of ``mlsl_tpu.ops.quant_kernels``. Elements are grouped into
fixed-size blocks (the rows of an (n_blocks, block) matrix); each block is
scaled by max|x|/127 and rounded to int8; dequantization multiplies back. The
error-feedback residual is kept by the caller (comm/quant_ring.py).

Kernels (``csrc/quant_kernels.cu``, built by ``ops/cuda_build.py``):

- ``quantize_blocks`` replaces the TPU kernel ``_quantize_pallas``
  (mlsl_tpu/ops/quant_kernels.py:99). It is bound by HBM bytes: it reads 4 B
  an element and writes 1 B an element plus 4 B a row.
- ``dequantize_blocks`` replaces ``_dequantize_pallas`` (:140). Also bound by
  HBM bytes, the other way round: 1 B an element plus 4 B a row in, 4 B an
  element out.

Both share one geometry (``geometry``): a thread owns 16 consecutive
elements of a row, and a row spreads over the power of two of neighbouring
lanes at or above block / 16, at most a warp (block 64: 4 lanes, 8 rows a
warp; block 256: 16 lanes), for every block the kernels take (any multiple
of 32). Quantize loads its 16 float32 values as four float4, keeps the row in
registers, reduces its maximum over the group's lanes with warp shuffles and
writes the 16 int8 values as one 16-byte store, so it reads the row once
(rows above 2,048 elements are read twice); it divides without a branch (a
reciprocal and one FMA correction, the same bits as the IEEE quotient for
the scales where it is used). Dequantize deals the row's 4-byte words out
across the group's lanes, so that its loads and its float4 stores are
contiguous over the group and every store fills whole sectors. A CTA has up
to 256 threads, fewer (down to one warp) where a launch has too few rows to
give every SM a CTA. A scalar path, one warp a row and one element a lane,
remains only for storage that is not 16-byte aligned, such as a view at an
element offset, where 16-byte accesses would fault.

Each wrapper checks device, dtype, shape and contiguity. For a CUDA tensor it
launches its kernel on the current stream and adds one to its count in
``LAUNCHES``; for a CPU tensor it runs the plain version (and counts
nothing); any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from mlsl_tpu_torch.log import MLSLError, mlsl_assert

# launches per kernel wrapper; only the CUDA launch site increments
LAUNCHES = {"quantize_blocks": 0, "dequantize_blocks": 0}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain versions: the semantic oracle ---------------------------------------


def quantize_blocks_ref(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_blocks, block) f32 -> (int8 q, f32 scales (n_blocks,))."""
    amax = x2d.abs().amax(dim=1)
    # tensor / tensor everywhere: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    scale = torch.where(amax == 0, torch.ones_like(amax),
                        amax / torch.full_like(amax, 127.0))
    # true division and round-half-even, exactly as jnp.round(x / scale)
    q = torch.clamp(torch.round(x2d / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blocks_ref(q2d: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q2d.to(torch.float32) * scales[:, None]


# -- kernel wrappers -----------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from mlsl_tpu_torch.ops import cuda_build

        lib = cuda_build.load("quant_kernels")
        argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.mlsl_quantize_rows, lib.mlsl_dequantize_rows):
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise MLSLError(f"{what} kernel launch failed: cudaError {rc}")


CTA_THREADS = 256   # threads a CTA at most, on both paths
SEGMENT = 16        # elements of a row a thread owns on the vector path


def geometry(block: int, n_rows: int, *ptrs: int, sms: int = 132) -> Tuple[str, int, int]:
    """-> (path, lanes a row, rows a CTA) of a launch over ``n_rows`` rows of
    ``block`` elements (a multiple of 32) whose storage starts at the data
    pointers ``ptrs``, on a card of ``sms`` SMs. "vector" when every pointer
    is 16-byte aligned (a row's start then is too): a row spreads over the
    power of two of lanes at or above block / 16, at most a warp. "scalar"
    otherwise: a warp a row. A CTA runs up to CTA_THREADS threads, down to
    one warp where fewer would leave SMs without a CTA: a launch of few rows
    (a decode step's 64) is bound by its threads' latency, not by bytes."""
    return _geometry(block, n_rows, not any(p % 16 for p in ptrs), sms)


@functools.lru_cache(maxsize=4096)
def _geometry(block: int, n_rows: int, aligned: bool, sms: int) -> Tuple[str, int, int]:
    if aligned:
        path, lanes = "vector", min(32, 1 << (block // SEGMENT - 1).bit_length())
    else:
        path, lanes = "scalar", 32
    warp_rows = 32 // lanes
    spread = -(-n_rows // sms)                     # rows a CTA with one CTA a SM
    rows = min(CTA_THREADS // lanes, max(1, -(-spread // warp_rows)) * warp_rows)
    return path, lanes, rows


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(fn, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, n: int, block: int,
            rows_in: torch.Tensor, rows_out: torch.Tensor) -> int:
    """One launch of ``fn`` over (a, b, c) with the geometry of its row arrays."""
    path, lanes, rows = _geometry(block, n, (rows_in.data_ptr() | rows_out.data_ptr()) % 16 == 0,
                                  _sms(a.device.index))
    return fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), n, block, int(path == "vector"),
              lanes, rows, torch.cuda.current_stream(a.device).cuda_stream)


def _check_2d(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    mlsl_assert(t.dim() == 2, "%s must be 2-D (n_blocks, block), got %s", what,
                tuple(t.shape))
    mlsl_assert(t.dtype == dtype, "%s must be %s, got %s", what, dtype, t.dtype)
    mlsl_assert(t.is_contiguous(), "%s must be contiguous", what)


def quantize_blocks(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_blocks, block) f32 -> (int8 q (n_blocks, block), f32 scales (n_blocks,))."""
    _check_2d(x2d, torch.float32, "quantize input")
    if x2d.device.type == "cpu":
        return quantize_blocks_ref(x2d)
    if x2d.device.type != "cuda":
        raise MLSLError(f"quantize_blocks: unsupported device {x2d.device}")
    n, block = x2d.shape
    mlsl_assert(block % 32 == 0, "CUDA quantize needs block %% 32 == 0 (got %d)", block)
    q = torch.empty((n, block), dtype=torch.int8, device=x2d.device)
    s = torch.empty((n,), dtype=torch.float32, device=x2d.device)
    rc = _launch(_kernels().mlsl_quantize_rows, x2d, q, s, n, block, x2d, q)
    _check_launch(rc, "quantize")
    LAUNCHES["quantize_blocks"] += 1
    return q, s


def dequantize_blocks(q2d: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 (n_blocks, block) x f32 (n_blocks,) -> f32 (n_blocks, block)."""
    _check_2d(q2d, torch.int8, "dequantize input")
    mlsl_assert(scales.dtype == torch.float32 and scales.dim() == 1
                and scales.shape[0] == q2d.shape[0] and scales.is_contiguous(),
                "scales must be contiguous f32 (n_blocks=%d,), got %s %s",
                q2d.shape[0], scales.dtype, tuple(scales.shape))
    mlsl_assert(scales.device == q2d.device, "q and scales on different devices")
    if q2d.device.type == "cpu":
        return dequantize_blocks_ref(q2d, scales)
    if q2d.device.type != "cuda":
        raise MLSLError(f"dequantize_blocks: unsupported device {q2d.device}")
    n, block = q2d.shape
    mlsl_assert(block % 32 == 0, "CUDA dequantize needs block %% 32 == 0 (got %d)", block)
    x = torch.empty((n, block), dtype=torch.float32, device=q2d.device)
    rc = _launch(_kernels().mlsl_dequantize_rows, q2d, scales, x, n, block, q2d, x)
    _check_launch(rc, "dequantize")
    LAUNCHES["dequantize_blocks"] += 1
    return x


def block_align(n: int, block: int) -> int:
    """Smallest multiple of ``block`` >= n."""
    return -(-n // block) * block


# -- public 1-D API ------------------------------------------------------------


def quantize(x: torch.Tensor, block: int = 256):
    """1-D f32 -> (q int8 (padded n,), scales f32, orig_len).

    Pads with zeros to a whole number of blocks (the JAX package pads further,
    to its TPU row tile; callers treat the q length as opaque and slice with
    orig_len, as they do there)."""
    mlsl_assert(x.dim() == 1, "quantize takes a 1-D tensor, got %s", tuple(x.shape))
    n = x.shape[0]
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, block_align(n, block) - n))
    q, s = quantize_blocks(xp.reshape(-1, block))
    return q.reshape(-1), s, n


def dequantize(q: torch.Tensor, scales: torch.Tensor, block: int = 256,
               orig_len: Optional[int] = None) -> torch.Tensor:
    x = dequantize_blocks(q.reshape(-1, block), scales).reshape(-1)
    if orig_len is None or orig_len == x.shape[0]:
        return x
    return x[:orig_len]
