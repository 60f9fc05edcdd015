"""Two-tier hierarchical collectives: the DCN-aware compressed allreduce.

Counterpart of ``mlsl_tpu.comm.algos.hier`` (hier.py:1-514). A group whose
G = T x L members split into T tiers of L contiguous members reduces in
three phases:

  1. intra-tier reduce-scatter (float32)  -> each member holds n/L;
  2. inter-tier allreduce of that shard   -> only n/L crosses the slow tier,
     and the tier's codec applies here (int8 shared scale, top-k, float32,
     or a registry codec's ``hier_aggregate``);
  3. intra-tier all-gather (float32)      -> every member holds n again.

The tiers come from ``mesh.world_tier_ids``: on the card the synthetic
``MLSL_MESH_TIERS=TxL`` split of the virtual ranks (world rank // L). The
JAX package's other source, TPU multislice's ``slice_index``, has no
counterpart until a multi-process transport exists (ROADMAP A.8).

Virtual ranks: a group's members are one dim of a (C, G, n) tensor
(collectives.group_view), and member m sits in tier m // L, so the (C, T, L,
n) view holds every tier as one dim. The phases are tensor work over it, as
the port's ``lax`` algorithm is:

- a reduce-scatter (JAX ``psum_scatter`` over ``axis_index_groups``) is
  ``collectives._reduce`` over the source members: member by member in
  member order on the CPU, torch's one-pass sum on the card, as ``lax``;
- the inter-tier sum (``_inter_sum``: an all-gather and a local sum) adds
  the T tiers one at a time in tier order on both devices, so that every
  member's float result is the same bits;
- an all-gather is a broadcast of the tier's concatenated shards.

The compressed hop's int8 form takes the max of each block's absmax across
the tier peers, quantizes once against that shared scale (round half to
even), sums the int8 payloads in int32 and dequantizes once: an exact
integer sum, with the entry error-feedback residual over the member's own
1/L shard (``quant_geometry``), which ``flush_residual`` puts back at its
logical offset. Kernel B1 cannot serve it: B1 derives each row's scale from
the row alone. ``hier`` launches no kernel of its own.

``steps`` and ``quant_steps`` are the staged forms shared by the standalone
programs and the compiled overlap engine (comm/overlap.py).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mlsl_tpu_torch.comm.collectives import _ordered_sum, _reduce, group_unview, group_view
from mlsl_tpu_torch.comm.mesh import NUM_GRID_AXES, ProcessGroup, world_tier_ids
from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.types import ReductionType

#: DCN-tier codecs (the intra-tier phases are always float32): int8, f32 and
#: topk have their own exact hops, the others take the registry's
#: ``Codec.hier_aggregate``
DCN_CODECS = ("int8", "f32", "topk", "vq", "prune")
DEFAULT_DCN_CODEC = "int8"


def dcn_codec(value: Optional[str] = None) -> str:
    """The DCN-tier codec: explicit value > MLSL_HIER_DCN_CODEC > int8."""
    v = (value if value is not None
         else os.environ.get("MLSL_HIER_DCN_CODEC", "")).strip().lower()
    if not v:
        return DEFAULT_DCN_CODEC
    mlsl_assert(v in DCN_CODECS, "MLSL_HIER_DCN_CODEC must be one of %s (got %r)",
                "/".join(DCN_CODECS), v)
    return v


# -- tier structure ------------------------------------------------------------------


def _live_axis(group: ProcessGroup) -> Optional[str]:
    if group.colors is not None or group.is_self:
        return None
    live = group.live_axes()
    return live[0] if len(live) == 1 else None


def tier_structure(group: ProcessGroup) -> Optional[Tuple[int, int]]:
    """(T, L) when every instance of the group splits into T contiguous runs
    of L members (group-rank order) under the world's tiers, else None (the
    flat lowerings apply). T == 1 and L == 1 are valid: the inter- or the
    intra-tier phase vanishes."""
    if _live_axis(group) is None or group.size <= 1:
        return None
    tids = world_tier_ids(group.topology.world_size)
    if tids is None:
        return None
    g = group.size
    shape = None
    for row in group.member_table():
        runs: List[Tuple[int, int]] = []     # (tier id, run length)
        for w in row:
            t = tids[w]
            if runs and runs[-1][0] == t:
                runs[-1] = (t, runs[-1][1] + 1)
            else:
                runs.append((t, 1))
        if len({t for t, _ in runs}) != len(runs):
            return None          # a tier in two runs: an interleaved layout
        if len({n for _, n in runs}) != 1:
            return None
        cur = (len(runs), runs[0][1])
        if shape is None:
            shape = cur
        elif shape != cur:
            return None          # instances see different splits
    if shape is None or shape[0] * shape[1] != g:
        return None
    return shape


def _tiers(group: ProcessGroup) -> Tuple[int, int]:
    tiers = tier_structure(group)
    mlsl_assert(_live_axis(group) is not None and tiers is not None,
                "hier needs a single-live-axis group with a uniform tier split "
                "(MLSL_MESH_TIERS); got axes=%s", group.axes)
    return tiers


# -- the tier view and its collective phases -------------------------------------------


def _tier_op(group: ProcessGroup, t: int, l: int, fn: Callable) -> Callable:
    """A phase over distributed buffers: (R, D, S, M, k) -> the (C, T, L, k)
    tier view -> ``fn`` -> back to (R, D, S, M, k')."""
    def phase(buf: torch.Tensor) -> torch.Tensor:
        y = group_view(buf, group)
        c = y.shape[0]
        out = fn(y.reshape(c, t, l, y.shape[-1]))
        return group_unview(out.reshape(c, t * l, out.shape[-1]), group)

    return phase


def _scatter_intra(y: torch.Tensor, op=ReductionType.SUM) -> torch.Tensor:
    """(C, T, L, L*s) -> (C, T, L, s): member (t, l) receives shard l of the
    sum over its tier's L members (tiled ``psum_scatter`` over the intra
    groups)."""
    c, t, l, k = y.shape
    red = _reduce(y.reshape(c * t, l, k), op)          # (C*T, 1, L*s)
    return red.reshape(c, t, l, k // l)


def _scatter_inter(y: torch.Tensor, op=ReductionType.SUM) -> torch.Tensor:
    """(C, T, L, T*s) -> (C, T, L, s): member (t, l) receives shard t of the
    sum over its T tier peers (tiled ``psum_scatter`` over the inter
    groups)."""
    c, t, l, k = y.shape
    z = y.transpose(1, 2).reshape(c * l, t, k)          # peers of one local rank
    red = _reduce(z, op).reshape(c, l, t, k // t)
    return red.transpose(1, 2)


def _inter_sum(y: torch.Tensor) -> torch.Tensor:
    """(C, T, L, s) -> (C, T, L, s): the sum over the T tier peers, the tiers
    added one at a time in tier order (the gather and local sum of the JAX
    package), the same bits on every member."""
    c, t, l, s = y.shape
    if t <= 1:
        return y
    red = _ordered_sum(y.reshape(c, t, l * s))          # (C, 1, L*s)
    return red.reshape(c, 1, l, s).expand(c, t, l, s)


def _gather_intra(y: torch.Tensor) -> torch.Tensor:
    """(C, T, L, s) -> (C, T, L, L*s): every member receives its tier's
    shards in member order (tiled ``all_gather`` over the intra groups)."""
    c, t, l, s = y.shape
    return y.reshape(c, t, 1, l * s).expand(c, t, l, l * s)


# -- eligibility -------------------------------------------------------------------------


def eligible(kind: str, group: ProcessGroup, op=None) -> bool:
    """Dense eligibility: SUM over a single-live-axis group with a uniform
    tier split (the scatter phases are sums, as ring2d's)."""
    if op not in (None, ReductionType.SUM):
        return False
    return tier_structure(group) is not None


def eligible_quant(group: ProcessGroup, block: int) -> bool:
    """Compressed eligibility (a QUANTIZATION request through the table):
    a tiered group; the geometry pads, so any block serves. The caller
    restricts it to allreduce."""
    del block
    return tier_structure(group) is not None


# -- the dense lowering (float32 on both tiers) ----------------------------------------


def steps(kind: str, group: ProcessGroup, n: int, *, op=None,
          recv_count=None) -> Tuple[Callable, List[Callable], Callable]:
    """The staged two-tier schedule over distributed buffers: ``(prep,
    phases, finish)``, one collective a phase (intra reduce-scatter, inter
    allreduce, intra all-gather; a degenerate tier drops its phases).
    reduce_scatter relabels the chunks l-major first, so that scattering by
    l and then by t lands group chunk t*L + l on member (t, l)."""
    t, l = _tiers(group)
    g = t * l
    rop = ReductionType(op) if op is not None else ReductionType.SUM

    if kind == "reduce_scatter":
        mlsl_assert(recv_count is not None and n == g * recv_count,
                    "hier reduce_scatter needs count == G*recv_count (count %d, G %d, "
                    "recv_count %s)", n, g, recv_count)
        rc = recv_count

        def prep_rs(buf):
            grid = buf.shape[:NUM_GRID_AXES]
            return buf.reshape(*grid, t, l, rc).transpose(-3, -2).reshape(*grid, n)

        phases = (([_tier_op(group, t, l, lambda y: _scatter_intra(y, rop))] if l > 1 else [])
                  + ([_tier_op(group, t, l, lambda y: _scatter_inter(y, rop))] if t > 1
                     else []))
        return prep_rs, phases, lambda buf: buf[..., :rc]

    sc = -(-n // l)
    m = sc * l

    def prep(buf):
        return F.pad(buf, (0, m - n)) if m != n else buf

    phases = (([_tier_op(group, t, l, lambda y: _scatter_intra(y, rop))] if l > 1 else [])
              + ([_tier_op(group, t, l, _inter_sum)] if t > 1 else [])
              + ([_tier_op(group, t, l, _gather_intra)] if l > 1 else []))
    return prep, phases, lambda buf: buf[..., :n]


def build(kind: str, group: ProcessGroup, *, op=None, recv_count=None, **_) -> Callable:
    """-> fn: distributed buffer (R, D, S, M, n) -> result buffer: the staged
    schedule run to its end."""
    def fn(buf: torch.Tensor) -> torch.Tensor:
        prep, phases, finish = steps(kind, group, buf.shape[-1], op=op, recv_count=recv_count)
        carry = prep(buf)
        for phase in phases:
            carry = phase(carry)
        return finish(carry)

    return fn


# -- the compressed DCN tier (the QUANTIZATION wire) ----------------------------------


def quant_geometry(kind: str, group: ProcessGroup, count: int,
                   block: int) -> Tuple[int, int, int, Tuple[int, int]]:
    """-> (g, slen, err_len, (T, L)). ``slen``, a member's DCN shard, is
    ceil(count / L) aligned up to the quant block, so no block straddles a
    shard boundary and the shared-scale blocks tile the shard exactly. The
    residual covers the member's own shard (err_len == slen), unlike the
    flat ring's, which spans the whole buffer in ring-chunk layout."""
    mlsl_assert(kind == "allreduce", "hier compressed wire serves allreduce only (got %s)",
                kind)
    tiers = tier_structure(group)
    mlsl_assert(tiers is not None, "hier quant geometry needs a tiered group")
    t, l = tiers
    slen = -(-(-(-count // l)) // block) * block
    return t * l, slen, slen, (t, l)


def intra_positions(group: ProcessGroup) -> np.ndarray:
    """(R, D, S, M) int array: each world position's intra-tier rank l, the
    table with which a flush puts a member's residual at its logical slice."""
    tiers = tier_structure(group)
    mlsl_assert(tiers is not None, "intra_positions needs a tiered group")
    _, l = tiers
    topo = group.topology
    out = np.zeros(topo.grid_shape, dtype=np.int32)
    for p in range(topo.world_size):
        out[topo.coords(p)] = group.group_idx_of(p) % l
    return out


def flush_residual(err: torch.Tensor, l_idx: torch.Tensor, L: int, slen: int,
                   count: int) -> torch.Tensor:
    """The shard-layout residual -> the logical buffer layout. ``err``: (*lead,
    slen), each member's residual of its own slice; ``l_idx``: (*lead) the
    members' intra-tier ranks (``intra_positions``). Each residual lands at
    offset l*slen, so the float32 allreduce of the flushed payloads delivers
    slice l's undelivered error once, summed over the slice's tier peers;
    what lies past ``count`` (padding) is dropped, as the healthy round
    truncates its result. The one-hot product is the JAX package's."""
    lead = err.shape[:-1]
    onehot = F.one_hot(l_idx.to(torch.long), L).to(err.dtype)       # (*lead, L)
    placed = onehot[..., :, None] * err[..., None, :]               # (*lead, L, slen)
    return placed.reshape(*lead, L * slen)[..., :count]


def _block_quant_shared(xq: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 DCN hop over the tier view (C, T, L, slen): each block's
    absmax, its max over the tier peers, one shared scale (m / 127), one
    quantization (round half to even), the int8 payloads summed in int32 and
    dequantized once. -> (reduced shard, new residual)."""
    c, t, l, slen = xq.shape
    blocks = xq.reshape(c, t, l, slen // block, block)
    m = blocks.abs().amax(dim=-1).amax(dim=1, keepdim=True)     # (C, 1, L, nb)
    scale = torch.where(m == 0, torch.ones((), dtype=torch.float32, device=xq.device),
                        m / 127.0).to(torch.float32)[..., None]
    q8 = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    xhat = (q8.to(torch.float32) * scale).reshape(c, t, l, slen)
    q = q8.to(torch.int32).sum(dim=1, keepdim=True)
    red = (q.to(torch.float32) * scale).reshape(c, 1, l, slen)
    return red.expand(c, t, l, slen), xq - xhat


def _topk_shared(xq: torch.Tensor, ratio: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k DCN hop over the tier view: the threshold is each shard's
    k-th largest magnitude and every element at or above it is kept (ties
    keep more than k); the rest feeds the residual; the kept shards sum
    across the tiers."""
    k = max(1, int(xq.shape[-1] * ratio))
    a = xq.abs()
    thr = torch.topk(a, k, dim=-1).values[..., k - 1:k]
    keep = torch.where(a >= thr, xq, torch.zeros((), dtype=xq.dtype, device=xq.device))
    return _inter_sum(keep), xq - keep


def quant_steps(group: ProcessGroup, count: int, block: int, *, codec: Optional[str] = None,
                topk_ratio: float = 0.01
                ) -> Tuple[Callable, List[Callable], Callable, int]:
    """The staged compressed allreduce for the overlap engine: ``(prep(buf,
    err) -> carry, phases, finish(carry) -> (out, new_err), err_len)`` over
    distributed buffers. The intra reduce-scatter, the compressed DCN hop as
    its own phase, the intra all-gather. With one tier nothing crosses the
    DCN and the hop is float32."""
    g, slen, err_len, (t, l) = quant_geometry("allreduce", group, count, block)
    codec = dcn_codec(codec)
    if t == 1:
        codec = "f32"
    reg = None
    if codec not in ("int8", "topk", "f32"):
        # a registry codec: its instance resolved once; knobs from the
        # process environment (MLSL_VQ_*, MLSL_PRUNE_RATIO), as in JAX
        from mlsl_tpu_torch import codecs as codecs_mod
        from mlsl_tpu_torch.config import Config

        reg = codecs_mod.configure(codec, Config.from_env())

    def prep(buf, err):
        xp = buf.to(torch.float32)
        pad = l * slen - count
        return (F.pad(xp, (0, pad)) if pad else xp), err

    rs = _tier_op(group, t, l, _scatter_intra)
    ag = _tier_op(group, t, l, _gather_intra)

    def rs_intra(carry):
        cur, err = carry
        return rs(cur), err

    def dcn_hop(carry):
        cur, err = carry
        xc, ec = group_view(cur, group), group_view(err, group)
        c = xc.shape[0]
        xq = (xc + ec).reshape(c, t, l, slen)
        if codec == "int8":
            red, new_err = _block_quant_shared(xq, block)
        elif codec == "topk":
            red, new_err = _topk_shared(xq, topk_ratio)
        elif reg is not None:
            red, new_err = reg.hier_aggregate(xq, t=t)
        else:        # f32: an exact hop; the residual is delivered and reset
            red, new_err = _inter_sum(xq), torch.zeros_like(xq)
        return (group_unview(red.reshape(c, g, slen), group),
                group_unview(new_err.reshape(c, g, slen), group))

    def ag_intra(carry):
        cur, err = carry
        return ag(cur), err

    phases = ([rs_intra] if l > 1 else []) + [dcn_hop] + ([ag_intra] if l > 1 else [])
    return prep, phases, lambda carry: (carry[0][..., :count], carry[1]), err_len


def quant_body(kind: str, group: ProcessGroup, count: int, block: int, *,
               codec: Optional[str] = None, topk_ratio: float = 0.01
               ) -> Tuple[Callable, int]:
    """The compressed round as one ``(buf, err) -> (result, new_err)``
    function (quant_ring's contract), and the residual length."""
    mlsl_assert(kind == "allreduce", "hier compressed wire serves allreduce only (got %s)",
                kind)
    prep, phases, finish, err_len = quant_steps(group, count, block, codec=codec,
                                                topk_ratio=topk_ratio)

    def body(buf, err):
        carry = prep(buf, err)
        for phase in phases:
            carry = phase(carry)
        return finish(carry)

    return body, err_len


# -- the cost model (the JAX package's DCN bandwidth-delay simulator) ------------------


def dcn_wire_bytes(count: int, tiers: Tuple[int, int], codec: str, block: int) -> int:
    """Bytes one member's DCN link carries for a hier allreduce of ``count``
    float32 elements: the 1/L shard at the codec's wire width, ring-modelled
    across the T tier peers (2(T-1)/T), plus the shared scales for int8."""
    t, l = tiers
    if t <= 1:
        return 0
    slen = -(-(-(-count // l)) // block) * block
    if codec == "int8":
        per = slen + 4 * (slen // block)
    elif codec == "topk":
        per = slen * 4
    elif codec not in ("f32", "none"):
        from mlsl_tpu_torch import codecs as codecs_mod

        per = codecs_mod.configure(codec).wire_len(slen)
    else:
        per = slen * 4
    return int(2 * (t - 1) / t * per)


def dcn_phases(tiers: Tuple[int, int], codec: str) -> int:
    """DCN round trips of one hier allreduce: the shared-scale max (int8
    only) and the 2(T-1) hops of a ring-modelled allreduce across tiers."""
    t, _ = tiers
    if t <= 1:
        return 0
    return 2 * (t - 1) + (1 if codec == "int8" else 0)
