"""User codecs on the compressed ring, and the registry codecs' transport.

Counterpart of ``mlsl_tpu.comm.codec`` (codec.py:51-370). The reference's
quantization is pluggable: the user names a shared library and three symbols
(compress / decompress / reduce_sum), and the allreduce compresses before
the wire, reduces in the compressed domain and decompresses after (reference
quant/quant.c:96-133, eplib/cqueue.c:1977-1994). Two plug-in forms, both
registered through ``Environment.set_quantization_params``:

1. **Python callables** (``QuantParams.compress_fn / decompress_fn /
   reduce_sum_fn``): functions on torch tensors, ``compress(x (n,) float32)
   -> payload``, ``decompress(payload, n) -> (n,)``, ``reduce(a, b) ->
   payload``. They run where their inputs are (the card for a CUDA buffer),
   once per virtual rank's chunk. A payload is any object the functions
   agree on; the transport only moves it.
2. **A shared library** of the reference's ABI (``QuantParams.lib_path`` and
   the symbol names; quant/quant.c:57-65), loaded with ``ctypes``. A library
   codec is host C code: on a CUDA buffer every compress, decompress and
   reduce copies its rows to pageable host memory and back, as the JAX
   package's ``pure_callback`` does. That round trip is the reference's own
   contract (its codec runs in the endpoint servers' CPUs), not a fallback;
   ``TIMINGS`` holds the seconds of the copies and of the codec calls. The
   rows of one call go through the library in parallel threads (``ctypes``
   releases the GIL); each row is one call of the library, as in the JAX
   package, so the results are the same bits.

The registry codecs (``mlsl_tpu_torch.codecs``) ride the same ring through
``Codec.as_custom()``, batched: one call encodes every virtual rank's chunk.

Error feedback is the transport's, as in the JAX package (codec.py:30-34):
``err' = (x + err) - decompress(compress(x + err))`` a chunk, carried by the
request; the library's own ``diff`` argument gets a zeroed buffer each call.

Ring order is the JAX ring's (codec.py:243-285): member i's travelling
partial starts at chunk (i - 1) mod G; a hop sends ``compress(partial)``
from member i to i + 1 (a row permutation of the payloads, ``torch.roll``'s
order) and the receiver adds its own chunk (decompress-add, or ``reduce``
on the compressed payloads when the codec has one); then the owned chunks
circulate compressed. Degenerate (one member) and multi-axis groups take the
entry compression and a plain sum. Nothing here launches a kernel of its
own; the registry's int8 codec launches B1 and B2.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from mlsl_tpu_torch.comm.collectives import _reduce, group_key, group_unview, group_view
from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.comm.quant_ring import _to_chunks
from mlsl_tpu_torch.log import MLSLError, mlsl_assert
from mlsl_tpu_torch.types import ReductionType


@dataclasses.dataclass(frozen=True, eq=False)
class CustomCodec:
    """A pluggable codec: ``compress``, ``decompress`` and the optional
    compressed-domain ``reduce`` (the reference's reduce_sum op; without it
    a hop decompresses and adds). ``rows``: the functions take a (rows, n)
    batch and code each row on its own (the registry codecs, the library
    codec); otherwise the transport calls them once a row. ``wire_len(n)``:
    the compressed bytes of an n-element chunk, where known.

    ``_programs`` caches the built collectives on the codec instance, so a
    replaced registration drops its programs with it."""

    compress: Callable
    decompress: Callable
    reduce: Optional[Callable] = None
    name: str = "custom"
    rows: bool = False
    wire_len: Optional[Callable] = None
    _programs: dict = dataclasses.field(default_factory=dict, repr=False)


# -- library (dlopen) codecs ---------------------------------------------------

# dl_comp-style constants (reference quant/quant.c:43-55, passed at :199)
_DL_COMP_FLOAT32 = 2
_DL_COMP_DFP = 1
_COMP_RATIO = 4
_GUARD = 64

#: seconds a library codec spent: copies from the card (d2h_s) and back
#: (h2d_s), and in its C functions (codec_s); ``calls`` counts its entries
TIMINGS = {"d2h_s": 0.0, "h2d_s": 0.0, "codec_s": 0.0, "calls": 0}


def reset_timings() -> None:
    for k in TIMINGS:
        TIMINGS[k] = 0 if k == "calls" else 0.0


def load_library_codec(params) -> CustomCodec:
    """dlopen ``params.lib_path``, resolve the three symbols it names
    (reference quant_load, quant/quant.c:96-133), probe one block's
    geometry, and wrap the functions as a row-batched codec on torch
    tensors. Raises MLSLError on any failure to open, resolve or honour the
    declared geometry."""
    mlsl_assert(params.lib_path, "QuantParams.lib_path is empty")
    names = (params.quant_buffer_func_name, params.dequant_buffer_func_name,
             params.reduce_sum_func_name)
    mlsl_assert(all(names),
                "QuantParams with lib_path must name quant/dequant/reduce_sum functions")
    try:
        lib = ctypes.CDLL(params.lib_path)
    except OSError as e:
        raise MLSLError(f"quantization library can't be opened: {e}") from e
    try:
        quant_c = getattr(lib, names[0])
        dequant_c = getattr(lib, names[1])
        reduce_c = getattr(lib, names[2])
    except AttributeError as e:
        raise MLSLError(f"quantization symbol can't be loaded: {e}") from e
    # the reference ABI (quant/quant.c:57-65)
    quant_c.restype = ctypes.c_int
    quant_c.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_size_t, ctypes.c_int]
    dequant_c.restype = ctypes.c_int
    dequant_c.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    reduce_c.restype = ctypes.c_int
    reduce_c.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]

    elem = int(params.elem_in_block)
    bsz = int(params.block_size)
    mlsl_assert(elem > 0 and bsz > 0, "block geometry must be positive")

    def nblocks(n: int) -> int:
        return -(-n // elem)

    # The codec is opaque: a one-block probe at load time measures what it
    # writes against the declared block_size, and a guard tail on every
    # staging buffer catches a count-dependent spill (codec.py:121-182 of
    # the JAX package). The probe's slack comes from the input size, never
    # from the declared output.
    slack = elem * 8 + bsz + 4096
    buf = np.linspace(-1.0, 1.0, elem, dtype=np.float32)
    out = np.full(slack, 0xA5, np.uint8)
    diff = np.zeros(elem, np.float32)      # held: ctypes gets a bare address
    rc = quant_c(buf.ctypes.data, out.ctypes.data, buf.size, diff.ctypes.data,
                 _DL_COMP_FLOAT32, _COMP_RATIO, _DL_COMP_DFP)
    if rc != 0:
        raise MLSLError(f"quantization library probe failed: error code {rc}")
    touched = np.nonzero(out != 0xA5)[0]
    written = int(touched[-1]) + 1 if touched.size else 0
    if written > bsz:
        raise MLSLError(
            f"quantization library geometry mismatch: declared block_size={bsz} bytes per "
            f"{elem}-element block, but {names[0]} wrote ~{written} bytes for one block -- "
            f"fix QuantParams.block_size/elem_in_block to match the codec")
    dout = np.full(elem * 4 + slack, 0xA5, np.uint8)
    rc = dequant_c(out.ctypes.data, dout.ctypes.data, elem)
    if rc != 0:
        raise MLSLError(f"dequantization library probe failed: error code {rc}")
    dtouched = np.nonzero(dout != 0xA5)[0]
    dwritten = int(dtouched[-1]) + 1 if dtouched.size else 0
    if dwritten > elem * 4:
        raise MLSLError(
            f"quantization library geometry mismatch: {names[1]} wrote ~{dwritten} bytes "
            f"decompressing one {elem}-element block (expected at most {elem * 4})")

    def check_guard(arr: np.ndarray, payload_bytes: int, what: str) -> None:
        tail = arr.view(np.uint8)[payload_bytes:]
        if tail.size and not (tail == 0xA5).all():
            raise MLSLError(
                f"{what} wrote past the declared block geometry (block_size={bsz}, "
                f"elem_in_block={elem}): the codec must write exactly block_size bytes per "
                f"block of elem_in_block elements")

    def host_compress(x: np.ndarray) -> np.ndarray:
        n = x.size
        nb = nblocks(n)
        src = np.zeros(nb * elem, np.float32)
        src[:n] = x
        # feedback is the transport's: the codec's own diff is zero each call
        diff = np.zeros(nb * elem, np.float32)
        dst = np.full(nb * bsz + _GUARD, 0xA5, np.uint8)
        dst[:nb * bsz] = 0
        rc = quant_c(src.ctypes.data, dst.ctypes.data, src.size, diff.ctypes.data,
                     _DL_COMP_FLOAT32, _COMP_RATIO, _DL_COMP_DFP)
        if rc != 0:
            raise MLSLError(f"quantization failed: error code {rc}")
        check_guard(dst, nb * bsz, f"compress ({names[0]})")
        return dst[:nb * bsz]

    def host_decompress(p: np.ndarray, n: int) -> np.ndarray:
        nb = nblocks(n)
        dst = np.zeros(nb * elem + _GUARD // 4, np.float32)
        dst.view(np.uint8)[nb * elem * 4:] = 0xA5
        src = np.ascontiguousarray(p)
        rc = dequant_c(src.ctypes.data, dst.ctypes.data, nb * elem)
        if rc != 0:
            raise MLSLError(f"dequantization failed: error code {rc}")
        check_guard(dst, nb * elem * 4, f"decompress ({names[1]})")
        return dst[:n]

    def host_reduce(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        inout = np.array(b, copy=True)
        src = np.ascontiguousarray(a)
        rc = reduce_c(src.ctypes.data, inout.ctypes.data, inout.size // bsz)
        if rc != 0:
            raise MLSLError(f"compressed reduce failed: error code {rc}")
        return inout

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                                 thread_name_prefix="mlsl-codec")

    def batched(fn, out_dtype, *args):
        """Run ``fn`` on every row of the (rows, ...) tensors ``args`` on the
        host: one copy from the device, the rows in parallel, one copy back."""
        dev = args[0].device
        one = args[0].dim() == 1
        t0 = time.perf_counter()
        host = [a.detach().reshape(1, -1) if one else a.detach() for a in args]
        host = [h.to("cpu").contiguous().numpy() for h in host]
        t1 = time.perf_counter()
        rows = list(pool.map(lambda r: fn(*(h[r] for h in host)), range(host[0].shape[0])))
        out = torch.from_numpy(np.stack(rows)).view(out_dtype)
        out = out[0] if one else out
        t2 = t3 = time.perf_counter()
        if dev.type != "cpu":
            out = out.to(dev)
            t3 = time.perf_counter()
        TIMINGS["d2h_s"] += t1 - t0
        TIMINGS["codec_s"] += t2 - t1
        TIMINGS["h2d_s"] += t3 - t2
        TIMINGS["calls"] += 1
        return out

    def compress(x: torch.Tensor) -> torch.Tensor:
        return batched(host_compress, torch.uint8, x.to(torch.float32))

    def decompress(p: torch.Tensor, n: int) -> torch.Tensor:
        return batched(lambda q: host_decompress(q, n), torch.float32, p)

    def reduce(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return batched(host_reduce, torch.uint8, a, b)

    return CustomCodec(compress=compress, decompress=decompress, reduce=reduce,
                       name=f"lib:{params.lib_path}", rows=True,
                       wire_len=lambda n: nblocks(n) * bsz)


def wire_bytes(codec: CustomCodec, n: int) -> int:
    """The compressed bytes of an n-element chunk: the codec's ``wire_len``,
    else the shape of ``compress`` on a meta tensor (no data), else 0 (the
    statistics then read 0 rather than a guess), as ``_custom_wire_bytes``
    (request.py:1266 of the JAX package) does with ``jax.eval_shape``."""
    if codec.wire_len is not None:
        return int(codec.wire_len(n))
    try:
        out = codec.compress(torch.empty((n,), dtype=torch.float32, device="meta"))
        return int(out.numel() * out.element_size())
    except Exception:   # a codec that reads its data cannot run on a meta tensor
        return 0


# -- the codec collective --------------------------------------------------------


class _Wire:
    """The codec over a batch of R rows (the virtual ranks' chunks): one call
    for a row-batched codec, one call a row otherwise; ``take`` moves the
    payloads between rows (the ring's hop)."""

    def __init__(self, codec: CustomCodec):
        self.codec = codec

    def enc(self, x: torch.Tensor):
        if self.codec.rows:
            return self.codec.compress(x)
        return [self.codec.compress(r) for r in x.unbind(0)]

    def dec(self, p, n: int) -> torch.Tensor:
        if self.codec.rows:
            return self.codec.decompress(p, n)
        return torch.stack([self.codec.decompress(q, n).reshape(n).to(torch.float32)
                            for q in p])

    def red(self, a, b):
        if self.codec.rows:
            return self.codec.reduce(a, b)
        return [self.codec.reduce(x, y) for x, y in zip(a, b)]

    def take(self, p, src: torch.Tensor, src_list):
        if self.codec.rows:
            return p[src]
        return [p[i] for i in src_list]


def _entry(wire: _Wire, xq: torch.Tensor):
    """Entry compression with the transport's error feedback: xq (..., chunk)
    -> (xhat, xq - xhat)."""
    shape = xq.shape
    xhat = wire.dec(wire.enc(xq.reshape(-1, shape[-1])), shape[-1]).reshape(shape)
    return xhat, xq - xhat


def _ring_body(x, err, *, G, rc, chunk, count, mode, wire):
    """x: (C, G, count), err: (C, G, G*chunk) -> (result (C, G, n'), new_err)."""
    c = x.shape[0]
    xq = _to_chunks(x.to(torch.float32), G, rc, chunk) + err.reshape(c, G, G, chunk)
    chunks, new_err = _entry(wire, xq)                 # [instance, member, chunk idx]
    new_err = new_err.reshape(c, G, G * chunk)
    me = torch.arange(G, device=x.device)
    # after a hop member i holds what member i - 1 sent (row c*G + i <- c*G + i-1)
    src_list = [i * G + (j - 1) % G for i in range(c) for j in range(G)]
    src = torch.tensor(src_list, device=x.device)

    def rows(t):
        return t.reshape(-1, chunk)

    # ring reduce-scatter over the compressed wire
    partial = chunks[:, me, (me - 1) % G]
    for t in range(G - 1):
        local = chunks[:, me, (me - 2 - t) % G]
        p = wire.take(wire.enc(rows(partial)), src, src_list)
        if wire.codec.reduce is not None:
            # compressed-domain accumulation (the reference's reduce_sum op)
            p = wire.red(p, wire.enc(rows(local)))
            partial = wire.dec(p, chunk).reshape(c, G, chunk)
        else:
            partial = wire.dec(p, chunk).reshape(c, G, chunk) + local
    if mode == "reduce_scatter":
        return partial[..., :rc], new_err

    # ring all-gather over the compressed wire
    own = wire.enc(rows(partial))
    out = torch.zeros((c, G, G, chunk), dtype=torch.float32, device=x.device)
    out[:, me, me] = wire.dec(own, chunk).reshape(c, G, chunk)
    p = own
    for k in range(G - 1):
        p = wire.take(p, src, src_list)
        out[:, me, (me - 1 - k) % G] = wire.dec(p, chunk).reshape(c, G, chunk)
    return out[..., :rc].reshape(c, G, G * rc)[..., :count], new_err


def _sum_body(x, err, *, G, rc, chunk, count, mode, wire):
    """Degenerate and multi-axis groups: entry compression, then a plain sum
    of the members (uncompressed wire, the same feedback numerics)."""
    c = x.shape[0]
    xq = _to_chunks(x.to(torch.float32), G, rc, chunk) + err.reshape(c, G, G, chunk)
    chunks, new_err = _entry(wire, xq)
    new_err = new_err.reshape(c, G, G * chunk)
    red = (_reduce(chunks.reshape(c, G, G * chunk), ReductionType.SUM).reshape(c, 1, G, chunk)
           .expand(c, G, G, chunk) if G > 1 else chunks)
    if mode == "reduce_scatter":
        me = torch.arange(G, device=x.device)
        return red[:, me, me, :rc], new_err
    return red[..., :rc].reshape(c, G, G * rc)[..., :count], new_err


def build_custom_collective(kind: str, group: ProcessGroup, count: int,
                            codec: CustomCodec) -> Tuple[Callable, int]:
    """-> (fn (buf, err) -> (result, new_err), error-feedback length): the
    contract of ``quant_ring.build_quantized_collective`` with the codec on
    the wire. Single-axis groups of two or more members take the compressed
    ring; others the entry compression and a plain sum. The chunks are not
    aligned to any block (rc = ceil(count / G))."""
    mlsl_assert(kind in ("allreduce", "reduce_scatter"),
                "custom codec supports allreduce/reduce_scatter (got %s)", kind)
    mlsl_assert(group.colors is None, "custom codec requires axis-aligned groups")
    g = 1 if group.is_self else group.size
    if kind == "reduce_scatter":
        mlsl_assert(count % g == 0, "reduce_scatter count %d %% group %d != 0", count, g)
        rc = count // g
    else:
        rc = -(-count // g)
    chunk = rc
    err_len = g * chunk
    key = (kind, group_key(group), count)
    fn = codec._programs.get(key)
    if fn is not None:
        return fn, err_len
    body = _ring_body if (g > 1 and len(group.axes) == 1) else _sum_body
    wire = _Wire(codec)

    def fn(buf: torch.Tensor, err: torch.Tensor):
        mlsl_assert(buf.shape[-1] == count, "buffer count %d != request count %d",
                    buf.shape[-1], count)
        out, new_err = body(group_view(buf, group), group_view(err, group), G=g, rc=rc,
                            chunk=chunk, count=count, mode=kind, wire=wire)
        return group_unview(out, group), group_unview(new_err, group)

    codec._programs[key] = fn
    return fn, err_len
