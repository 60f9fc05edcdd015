"""Int8-compressed ring collectives with error feedback, over virtual ranks.

Counterpart of ``mlsl_tpu.comm.quant_ring`` (reference quantized allreduce,
eplib/cqueue.c:1977-1994 with the int8 block transform of quant/quant.c:153-211).

A ring reduce-scatter + ring all-gather where every hop moves int8 payload +
per-block float32 scales. Each hop dequantizes, accumulates and requantizes.
The caller carries the entry error-feedback residual between rounds
(CommRequest holds it per request).

Ring index math, unchanged from the JAX ring: rank p's travelling partial
starts at chunk (p-1) mod G; after G-1 hops it has accumulated all ranks'
contributions for chunk p (MPI reduce-scatter placement). The all-gather phase
then circulates each rank's owned chunk.

Virtual ranks: the group's members are one dim of a (C, G, ...) tensor (see
collectives.group_view), so ``lax.ppermute`` with perm (i -> i+1) becomes
``torch.roll(..., shifts=1)`` along the member dim, and each hop's quantize is
ONE kernel launch covering all C*G ranks (their rows are independent). The
hop's dequantize stays a plain multiply fused into the accumulate, as in the
JAX ring (quant_ring.py:48-56).

Across processes (comm/transport.py) a process holds the members
[off, off + G_l) of each of its C_l instances: the bodies index chunks by the
group's member numbers, each hop quantizes the C_l * G_l local rows in one
launch, and the ring shift moves the int8 rows and their float32 scales to
the next member, across a process boundary where it falls. The arithmetic
is the one-process ring's, so the results and residuals are its bits. The
sum body gathers the G dequantized float rows and sums them as one process
does (the same bits again). B4 and the two-tier wire read every member on
one device: a spanning group takes the composed ring (the selection keeps
them off it; a direct build raises, the two-tier wire naming A.8b.7).

The ``ring="pallas"`` wire runs the same entry error feedback (kernel B1) and
then the whole ring as one launch of the fused int8 ring kernel B4
(ops/ring_kernels.py), which the selection table picks for a forced or tuned
``pallas_ring``. The ``ring="hier"`` wire is the two-tier lowering of
comm/algos/hier.py, for a forced or tuned ``hier``.

``build_quantized_collective`` puts every wire behind the ``codec.roundtrip``
chaos site and its ``quant.roundtrip`` span (``chaos_roundtrip``,
quant_ring.py:336-360 of the JAX package); the sparse wire (comm/sparse.py)
shares it. ``inline_body`` -- the compiled overlap engine's unit, one part
of its step -- passes neither, as in the JAX package, whose engine is one
compiled program.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from mlsl_tpu_torch.comm.collectives import group_unview, group_view
from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import MLSLError, mlsl_assert
from mlsl_tpu_torch.ops import quant_kernels as qk
from mlsl_tpu_torch.types import CompressionType, ReductionType


def ring_geometry(kind: str, group: ProcessGroup, count: int,
                  block: int) -> Tuple[int, int, int, int]:
    """-> (g, rc, chunk, err_len): the quantized-ring layout for
    (kind, group, count, block). Chunks align to one quant block, as on the
    JAX package's non-Pallas path (quant_ring._chunk_unit)."""
    g = 1 if group.is_self else group.size
    if kind == "reduce_scatter":
        mlsl_assert(count % g == 0, "reduce_scatter count %d %% group %d != 0", count, g)
        rc = count // g
    else:
        rc = -(-count // g)
    chunk = qk.block_align(rc, block)
    return g, rc, chunk, g * chunk


def _chunk_unit(rc: int, use_pallas: bool, block: int) -> int:
    """Ring-chunk alignment unit (elements), as at quant_ring.py:59-72 of the
    JAX package: one quant block on the composed ring, the fused int8 ring's
    (B4) ``ring_kernels.quant_unit`` on it."""
    from mlsl_tpu_torch.ops import ring_kernels as rk

    return rk.quant_unit(rc, block) if use_pallas else block


def use_pallas_for(kind: str, group: ProcessGroup, payload_bytes: int, config) -> bool:
    """Whether a quantized ``kind`` request of ``payload_bytes`` on ``group``
    takes the fused int8 ring (B4). The JAX package asks whether the mesh is
    a TPU; here the kernel route is the selection table's 'pallas_ring'."""
    from mlsl_tpu_torch.comm import algos

    return algos.select(kind, group, payload_bytes, CompressionType.QUANTIZATION, config,
                        op=ReductionType.SUM) == "pallas_ring"


def ring_aligned_rc(rc: int, block: int, use_pallas: bool) -> int:
    """Per-rank ring slice length >= ``rc`` aligned to the chunk unit
    (quant_ring.py:83-98 of the JAX package). A coalesced quantized payload
    (core/bucketing.py) sizes its bucket with it, so that the ring adds no
    padding inside a chunk. Aligning can push ``rc`` across the coarse
    unit's threshold; the units nest, so one more pass reaches the fixpoint."""
    for _ in range(2):
        unit = _chunk_unit(rc, use_pallas, block)
        rc = -(-rc // unit) * unit
    return rc


def logical_residual(err, g, chunk, rc, count):
    """Ring-layout residual (..., g*chunk) -> the logical buffer layout (..., count)."""
    lead = err.shape[:-1]
    e = err.reshape(*lead, g, chunk)[..., :rc]
    return e.reshape(*lead, g * rc)[..., :count]


def _to_chunks(x, G, rc, chunk):
    """(C, M, n_orig) -> (C, M, G, chunk): slice j of the logical partition
    (length rc) sits at the START of padded chunk j."""
    c, m, n = x.shape
    xp = torch.nn.functional.pad(x, (0, G * rc - n)).reshape(c, m, G, rc)
    return torch.nn.functional.pad(xp, (0, chunk - rc))


def _quant(x, block, quantize):
    """(..., L) -> (q, s) over rows of ``block``; one launch for everything."""
    return quantize(x.reshape(-1, block).contiguous())


def _dequant(q, s, shape):
    return qk.dequantize_blocks_ref(q, s).reshape(shape)


def _entry(x, err, G, rc, chunk, block, quantize):
    """Entry quantization + error feedback (reference quant_quantize semantics).
    x: (C, M, n_orig), err: (C, M, G*chunk) -> (xhat, new_err), both (C, M, G*chunk)."""
    c, m, _ = x.shape
    xq = _to_chunks(x.to(torch.float32), G, rc, chunk).reshape(c, m, G * chunk) + err
    q0, s0 = _quant(xq, block, quantize)
    xhat = _dequant(q0, s0, xq.shape)
    return xhat, xq - xhat


def _ring_body(x, err, *, G, rc, chunk, block, n_orig, mode, quantize, span):
    """x: (C, G_l, n_orig), err: (C, G_l, G*chunk) -> (result (C, G_l, n'),
    new_err): the members [off, off + G_l) of a G-member ring (``span``,
    comm/transport.py; all of them in one process). Member numbers are the
    group's, so each process indexes its own members' chunks, and every
    hop is one quantize launch over the local rows and a ring shift."""
    c, gl = x.shape[:2]
    xhat, new_err = _entry(x, err, G, rc, chunk, block, quantize)
    chunks = xhat.reshape(c, gl, G, chunk)         # [instance, member, chunk idx]
    li = torch.arange(gl, device=x.device)
    me = li + span.off

    if G == 1:
        result = xhat[..., :n_orig] if mode == "allreduce" else xhat[..., :rc]
        return result, new_err

    # --- phase 1: ring reduce-scatter (quantized wire) ---
    partial = chunks[:, li, (me - 1) % G]          # (C, G_l, chunk)
    for t in range(G - 1):
        q, s = _quant(partial, block, quantize)
        # member i -> i+1: int8 rows and their float32 scales
        q, s = span.shift(q.reshape(c, gl, chunk), s.reshape(c, gl, -1))
        received = _dequant(q.reshape(-1, block), s.reshape(-1), partial.shape)
        partial = received + chunks[:, li, (me - 2 - t) % G]
    # partial = fully reduced chunk `me`; its first rc elements are MPI slice `me`

    if mode == "reduce_scatter":
        return partial[..., :rc], new_err

    # --- phase 2: ring all-gather (quantized wire) ---
    q, s = _quant(partial, block, quantize)
    q, s = q.reshape(c, gl, chunk), s.reshape(c, gl, -1)
    out = torch.zeros((c, gl, G, chunk), dtype=torch.float32, device=x.device)
    out[:, li, me] = _dequant(q.reshape(-1, block), s.reshape(-1), partial.shape)
    for k in range(G - 1):
        q, s = span.shift(q, s)
        val = _dequant(q.reshape(-1, block), s.reshape(-1), partial.shape)
        out[:, li, (me - 1 - k) % G] = val
    return out[..., :rc].reshape(c, gl, G * rc)[..., :n_orig], new_err


def _sum_body(x, err, *, G, rc, chunk, block, n_orig, mode, quantize, span):
    """Degenerate (G == 1 of a self group) and multi-axis groups: entry
    quantization + sum (same numerics contract, uncompressed wire),
    as at quant_ring.py:229-245. x: (C, G_l, n_orig). Across processes the
    G dequantized float rows are gathered and summed as one process sums
    them, so the result is the same bits (the entry quantization and its
    residual stay with the process that holds the rank)."""
    c, gl = x.shape[:2]
    xhat, new_err = _entry(x, err, G, rc, chunk, block, quantize)
    if G > 1:
        red = span.gather(xhat).sum(dim=1, keepdim=True).expand(c, gl, G * chunk)
    else:
        red = xhat
    red_chunks = red.reshape(c, gl, G, chunk)
    if mode == "reduce_scatter":
        li = torch.arange(gl, device=x.device)
        return red_chunks[:, li, li + span.off, :rc], new_err
    return red_chunks[..., :rc].reshape(c, gl, G * rc)[..., :n_orig], new_err


def inline_body(kind: str, group: ProcessGroup, count: int, block: int, *, config=None,
                plain: bool = False) -> Tuple[Callable, int]:
    """-> (body ``(buf, err) -> (result, new_err)``, error-feedback length):
    the quantized round as a unit of the compiled overlap engine
    (comm/overlap.py; quant_ring.py:204-246 of the JAX package). The same
    choice of body as the host request's: where the selection table picks
    ``pallas_ring`` for this payload (``use_pallas_for``), the fused int8
    ring B4 with ``ring_kernels.quant_geometry``'s layout; otherwise the
    composed ring with B1 on every hop on a single-axis group, the entry
    quantization + sum on self and multi-axis groups. The residual has the
    geometry and length of the host request for the same payload. ``plain``
    runs the kernels' plain versions on any device."""
    fused = config is not None and use_pallas_for(kind, group, count * 4, config)
    return _build_quantized(
        kind, group, count, block, ring="pallas" if fused else "lax",
        bidir=bool(getattr(config, "pallas_ring_bidir", False)), plain=plain)


def chaos_roundtrip(fn: Callable, algo: str = "quant_ring") -> Callable:
    """``fn`` (buf, err) -> (result, new_err) behind the ``codec.roundtrip``
    chaos site, and, with the tracer armed, recorded as a ``quant.roundtrip``
    span of host time (the launches' enqueue; the device completion lands in
    the owning request's wait span). ``algo`` names the wire family. While a
    CUDA graph captures, both are idle. ``_mlsl_inner`` is ``fn``, for the
    callers that must not pass the site (a precompile warm, the sweep)."""
    from mlsl_tpu_torch import chaos
    from mlsl_tpu_torch.obs import tracer as obs

    def roundtrip(buf, err):
        if chaos._plans:
            chaos.inject("codec.roundtrip")
        tr = obs._tracer
        if tr is None or chaos._idle():
            return fn(buf, err)
        t0 = tr.now()
        out = fn(buf, err)
        tr.complete("quant.roundtrip", "quant", t0, elems=int(buf.shape[-1]), algo=algo)
        return out

    roundtrip._mlsl_inner = fn
    return roundtrip


def build_quantized_collective(
    kind: str, group: ProcessGroup, count: int, block: int, *,
    ring: str = "lax", bidir: bool = False, plain: bool = False,
    dcn_codec: Optional[str] = None, topk_ratio: float = 0.01,
) -> Tuple[Callable, int]:
    """``_build_quantized``'s wire behind ``chaos_roundtrip`` (a plain
    version, a check, passes no site)."""
    fn, err_len = _build_quantized(kind, group, count, block, ring=ring, bidir=bidir,
                                   plain=plain, dcn_codec=dcn_codec, topk_ratio=topk_ratio)
    if plain:
        return fn, err_len
    algo = {"lax": "quant_ring", "pallas": "pallas_ring", "hier": "hier"}[ring]
    return chaos_roundtrip(fn, algo), err_len


def _build_quantized(
    kind: str, group: ProcessGroup, count: int, block: int, *,
    ring: str = "lax", bidir: bool = False, plain: bool = False,
    dcn_codec: Optional[str] = None, topk_ratio: float = 0.01,
) -> Tuple[Callable, int]:
    """-> (fn (buf, err) -> (result, new_err), error-feedback length).

    ``kind``: 'allreduce' or 'reduce_scatter' (SUM only). ``buf`` is a
    distributed buffer (R, D, S, M, count); ``err`` is (R, D, S, M, err_len).

    ``ring="lax"``: single-axis groups use the composed ring above (one
    quantize launch per hop), self and multi-axis groups the
    entry-quantization + sum body. ``ring="pallas"``: the fused int8 ring,
    kernel B4 (quant_ring.py:302-319 of the JAX package), on a
    single-live-axis group of 2..64 members; the same entry error feedback,
    but the chunks align to ``ring_kernels.quant_geometry``'s units, so
    ``err_len`` differs from the composed ring's. ``bidir`` runs the second
    half of each chunk's block rows the other way round. ``plain`` runs the
    kernels' plain versions on any device (the card's parity checks).
    ``ring="hier"``: the two-tier wire (comm/algos/hier.py, quant_ring.py:
    250-290 of the JAX package), allreduce on a tiered group; ``dcn_codec``
    (None: MLSL_HIER_DCN_CODEC, else int8) applies on the inter-tier hop
    only and ``topk_ratio`` is the top-k codec's. Its residual covers each
    member's own 1/L shard (``hier.flush_residual`` places it); it launches
    no kernel, so ``plain`` changes nothing."""
    mlsl_assert(kind in ("allreduce", "reduce_scatter"),
                "quantized collectives support allreduce/reduce_scatter (got %s)", kind)
    mlsl_assert(ring in ("lax", "pallas", "hier"), "quantized ring wire %r is not ported",
                ring)
    from mlsl_tpu_torch.comm import transport

    if transport.spans(group):
        # B4 and the two-tier wire read every member on one device
        if ring == "hier":
            raise MLSLError("the compressed two-tier wire over a group that spans processes "
                            "is ROADMAP A.8b.7")
        mlsl_assert(ring == "lax", "the fused int8 ring (B4) serves process-local groups "
                    "only; a spanning group takes the composed ring")
    if ring == "hier":
        from mlsl_tpu_torch.comm.algos import hier

        mlsl_assert(hier.tier_structure(group) is not None,
                    "hier quantized wire needs a tiered group (MLSL_MESH_TIERS)")
        body, err_len = hier.quant_body(kind, group, count, block,
                                        codec=hier.dcn_codec(dcn_codec), topk_ratio=topk_ratio)

        def hier_fn(buf: torch.Tensor, err: torch.Tensor):
            mlsl_assert(buf.shape[-1] == count, "buffer count %d != request count %d",
                        buf.shape[-1], count)
            return body(buf, err)

        return hier_fn, err_len
    quantize = qk.quantize_blocks_ref if plain else qk.quantize_blocks
    if ring == "pallas":
        from mlsl_tpu_torch.comm.collectives import world_view
        from mlsl_tpu_torch.ops import ring_kernels as rk

        g, rc, chunk, err_len = rk.quant_geometry(kind, group, count, block)
        plan = rk.quant_plan(kind, group, count, block, bidir=bidir)
        topo = group.topology

        run = rk.quant_ring_ref if plain else rk.quant_ring

        def pallas_fn(buf: torch.Tensor, err: torch.Tensor):
            mlsl_assert(buf.shape[-1] == count, "buffer count %d != request count %d",
                        buf.shape[-1], count)
            # the same entry error feedback on world rows, then one B4 launch
            xhat, new_err = _entry(world_view(buf, topo)[:, None],
                                   world_view(err, topo)[:, None], g, rc, chunk, block,
                                   quantize)
            out = run(xhat.reshape(topo.world_size, err_len), plan)
            grid = topo.grid_shape
            return out.reshape(*grid, out.shape[-1]), new_err.reshape(*grid, err_len)

        return pallas_fn, err_len
    g, rc, chunk, err_len = ring_geometry(kind, group, count, block)
    body = _ring_body if (g > 1 and len(group.axes) == 1) else _sum_body
    # the members this process holds and the ring shift between processes
    span = transport.span_of(group)
    box = span.box

    def fn(buf: torch.Tensor, err: torch.Tensor):
        mlsl_assert(buf.shape[-1] == count, "buffer count %d != request count %d",
                    buf.shape[-1], count)
        out, new_err = body(
            group_view(buf, box), group_view(err, box),
            G=g, rc=rc, chunk=chunk, block=block, n_orig=count, mode=kind,
            quantize=quantize, span=span,
        )
        return group_unview(out, box), group_unview(new_err, box)

    return fn, err_len
