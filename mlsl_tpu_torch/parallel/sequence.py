"""Sequence-parallel attention over virtual ranks: the ring, zigzag and
all-to-all (Ulysses) schedules.

Counterpart of ``mlsl_tpu.parallel.sequence``. The JAX functions are SPMD
bodies run inside ``shard_map``, one device per rank. Here every rank's
shard lives in one tensor: q, k, v have shape (*ranks, B, H, Sl, D), the
leading dims are the virtual-rank grid (or any part of it), and ``axis`` is
the index of the leading dim that is the sequence group. So

- ``lax.ppermute`` around the ring is ``torch.roll`` along ``axis``;
- ``lax.axis_index`` is the coordinate along ``axis``, a broadcast tensor;
- ``lax.all_to_all`` is a transpose of ``axis`` with a split of the head
  or sequence dim;

and each kernel launch covers every rank at once, with per-row position
offsets where ranks differ (kernels B7-B9, ``ops/attention_kernels.py``).

Across processes (comm/transport.py) each function takes ``group``, the
sequence axis's ProcessGroup. A group that spans processes leaves this
process the S_l seq ranks [off, off + S_l) of the G: the coordinate is
``off + arange(S_l)``, the rotation is the transport's differentiable
``shift`` (a local roll and one boundary message for K and V together),
and Ulysses' two re-shards are its ``axis_all_to_all``. B9 folds what
arrived as it folds a local block. With ``None`` or a process-local group
the code below is today's, bit for bit.

``use_flash``: None routes through the kernels wherever ``supports()``
admits the shapes and head_dim is at most ``MAX_HEAD_DIM`` (128), what the
CUDA kernels take (the plain versions on a CPU tensor); any other shape takes
the einsum path, which is what the JAX package runs wherever its
``_use_flash`` is false. True requires the kernels; False takes the einsum
path. Nothing falls back from a kernel to the einsum path.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.ops.attention_kernels import (
    MAX_HEAD_DIM,
    empty_state,
    flash_attention,
    flash_block_update,
    supports,
)

_NEG = -1e30


def _span(group, axis_size: int):
    """The seq group's Span when it spans processes (else None)."""
    from mlsl_tpu_torch.comm import transport

    span = transport.span_or_none(group)
    mlsl_assert(span is None or span.g == axis_size, "the seq group has %d members, not %d",
                0 if span is None else span.g, axis_size)
    return span


def _coord(x: torch.Tensor, axis: int, axis_size: int, span=None) -> torch.Tensor:
    """The rank's coordinate along ``axis``: an int64 tensor over the leading
    rank dims of x (size ``axis_size`` at ``axis``, 1 elsewhere; this
    process's S_l ranks from ``span.off`` when the group spans processes)."""
    nr = x.dim() - 4
    local, off = (axis_size, 0) if span is None else (span.gl, span.off)
    mlsl_assert(0 <= axis < nr and x.shape[axis] == local,
                "axis %d of %s is not a sequence group of %d ranks", axis,
                tuple(x.shape), local)
    shape = [1] * nr
    shape[axis] = local
    return torch.arange(off, off + local, device=x.device).view(shape)


def _rotate(k, v, axis: int, span):
    """K and V passed one seq rank on (``lax.ppermute``): ``torch.roll`` in
    one process, else one differentiable hop carrying both."""
    if span is None:
        return torch.roll(k, 1, dims=axis), torch.roll(v, 1, dims=axis)
    from mlsl_tpu_torch.comm import transport

    return transport.shift(span, k, v, dim=axis)


def _per_row(x: torch.Tensor, lead) -> torch.Tensor:
    """A per-rank value (broadcast over the rank dims) -> one per (rank, b, h)
    row, in the order of ``reshape(-1, S, D)``."""
    return x.view(*x.shape, 1, 1).expand(*lead).reshape(-1)


def _attn_block_update(q, k_blk, v_blk, acc, m, l, q_pos, k_pos, causal, scale):
    """One online-softmax accumulation step, every rank at once.

    q: (..., B, H, Sq, D); k_blk/v_blk: (..., B, H, Sk, D); acc: (..., Sq, D);
    m, l: (..., Sq); q_pos (..., Sq), k_pos (..., Sk): global positions over
    the rank dims."""
    s = torch.einsum("...qd,...kd->...qk", q, k_blk) * scale
    if causal:
        valid = k_pos[..., None, :] <= q_pos[..., :, None]            # (ranks, Sq, Sk)
        s = torch.where(valid[..., None, None, :, :], s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # exp of masked entries: s = _NEG << m_new -> exp underflows to 0 exactly
    p = torch.exp(s - m_new[..., None])
    p = torch.where(s <= _NEG / 2, 0.0, p)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("...qk,...kd->...qd", p, v_blk)
    return acc_new, m_new, l_new


def _inv_sqrt(d: int, dtype, device) -> torch.Tensor:
    """``1.0 / jnp.sqrt(d).astype(dtype)``: the scale as the JAX einsum paths
    round it."""
    # filled on the device: no host copy, so that a CUDA graph can record it
    return 1.0 / torch.sqrt(torch.full((), float(d), device=device)).to(dtype)


def ring_attention(q, k, v, axis: int, axis_size: int, causal: bool = False,
                   use_flash: Optional[bool] = None, group=None) -> torch.Tensor:
    """Exact attention over the full (sharded) sequence via a k/v ring."""
    if axis_size == 1:
        return _dense_attention(q, k, v, causal, 0)
    span = _span(group, axis_size)
    sl, d = q.shape[-2:]
    if use_flash is None:
        use_flash = _use_flash(sl, sl, d)
    if use_flash:
        mlsl_assert(
            supports(sl, sl, d),
            "flash ring requires local seq %% 128 == 0 and head_dim %% 8 == 0 "
            "(got seq=%d, head_dim=%d); use use_flash=False",
            sl, d,
        )
        return _ring_flash(q, k, v, axis, axis_size, causal, span)
    scale = _inv_sqrt(d, q.dtype, q.device)
    me = _coord(q, axis, axis_size, span)
    ar = torch.arange(sl, device=q.device)
    q_pos = me[..., None] * sl + ar
    init = (
        torch.zeros(q.shape, dtype=torch.float32, device=q.device),
        torch.full(q.shape[:-1], _NEG, dtype=torch.float32, device=q.device),
        torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device),
    )
    qf = q.float()

    def step_fn(carry, k_cur, v_cur, src):
        k_pos = src[..., None] * sl + ar
        return _attn_block_update(qf, k_cur.float(), v_cur.float(), *carry, q_pos, k_pos,
                                  causal, scale)

    acc, m, l = _ring_schedule(k, v, axis, axis_size, init, step_fn, span)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype)


def _ring_schedule(k, v, axis: int, axis_size: int, init_carry, step_fn, span=None):
    """The shared k/v rotation loop: at hop t every rank folds the block
    originally owned by rank (me - t) into its carry, then passes it right.
    Every process runs the G - 1 hops of the global ring (trap 6 of
    comm/transport.py)."""
    me = _coord(k, axis, axis_size, span)
    carry, k_cur, v_cur = init_carry, k, v
    for t in range(axis_size):
        src = (me - t) % axis_size          # original owner of the current block
        carry = step_fn(carry, k_cur, v_cur, src)
        if t + 1 < axis_size:               # the last hop's rotation is never read
            k_cur, v_cur = _rotate(k_cur, v_cur, axis, span)
    return carry


def _ring_flash(q, k, v, axis: int, axis_size: int, causal: bool, span=None) -> torch.Tensor:
    """Ring attention with kernel B9 as the inner step: each hop folds the
    visiting k/v block into the carried (acc, m, l) of every rank in one
    launch, with per-row offsets me*sl and src*sl."""
    lead = q.shape[:-2]
    sl, d = q.shape[-2:]
    bh = math.prod(lead)
    qf = q.reshape(bh, sl, d)
    me = _coord(q, axis, axis_size, span)
    q_off = _per_row(me * sl, lead) if causal else 0

    def step_fn(carry, k_cur, v_cur, src):
        k_off = _per_row(src * sl, lead) if causal else 0
        return flash_block_update(qf, k_cur.reshape(bh, sl, d), v_cur.reshape(bh, sl, d),
                                  *carry, q_off, k_off, causal)

    acc, m, l = _ring_schedule(k, v, axis, axis_size, empty_state(bh, sl, d, q.device),
                               step_fn, span)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(q.shape).to(q.dtype)


def zigzag_perm(seq_len: int, axis_size: int) -> np.ndarray:
    """Permutation putting a sequence into ZIGZAG layout: rank r's contiguous
    shard holds global chunks r and 2G-1-r (chunk = seq_len / (2G)).

    Returns ``perm`` with ``x_zigzag = x[..., perm, :]``; invert with
    ``x[..., inv, :] = x_zigzag`` where ``inv = zigzag_perm_inverse(...)``.
    """
    g = axis_size
    mlsl_assert(
        seq_len % (2 * g) == 0,
        "zigzag needs seq_len %% (2 * axis_size) == 0 (got %d, %d)",
        seq_len, g,
    )
    c = seq_len // (2 * g)
    chunks = np.arange(seq_len).reshape(2 * g, c)
    order = [x for r in range(g) for x in (r, 2 * g - 1 - r)]
    return chunks[order].reshape(-1)


def zigzag_perm_inverse(seq_len: int, axis_size: int) -> np.ndarray:
    perm = zigzag_perm(seq_len, axis_size)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len)
    return inv


def zigzag_ring_attention(q, k, v, axis: int, axis_size: int,
                          use_flash: Optional[bool] = None, group=None) -> torch.Tensor:
    """Load-balanced CAUSAL ring attention over zigzag-sharded sequences.

    Rank r holds global chunks r and 2G-1-r (see zigzag_perm). The self hop
    makes three chunk updates (two diagonal, causal; one full); every later
    hop exactly two unmasked ones:

      - visiting kv from an earlier rank (src < me): both my chunks see the
        visitor's first chunk -> (q0, k0), (q1, k0);
      - visiting kv from a later rank (src > me): my second chunk sees both
        visitor chunks -> (q1, k0), (q1, k1).

    Which chunk a rank takes differs across ranks, so each update selects
    every rank's chunk first and then runs once for all ranks (one B9 launch
    on the flash path). Inputs are zigzag-sharded (*ranks, B, H, 2c, D): the
    chunk pair of seq rank ``me`` is (me, 2G-1-me) in the global numbering,
    whichever process holds it.
    """
    if axis_size == 1:
        return _dense_attention(q, k, v, True, 0)
    span = _span(group, axis_size)
    lead = q.shape[:-2]
    sl, d = q.shape[-2:]
    mlsl_assert(sl % 2 == 0, "zigzag shard length must be even (got %d)", sl)
    c, g, bh = sl // 2, axis_size, math.prod(lead)
    me = _coord(q, axis, axis_size, span)
    if use_flash is None:
        use_flash = _use_flash(c, c, d)

    # Both modes share the schedule below on per-chunk (bh, c, ...) carries;
    # they differ only in the chunk update.
    if use_flash:
        mlsl_assert(
            supports(c, c, d),
            "flash zigzag requires chunk length (local seq / 2) %% 128 == 0 "
            "and head_dim %% 8 == 0 (got chunk=%d, head_dim=%d); use "
            "use_flash=False",
            c, d,
        )

        def _update(causal):
            # causal=False: chunk fully visible (no mask, offsets irrelevant);
            # causal=True: equal offsets = within-chunk lower triangle
            def u(qc, kc, vc, ac, mc, lc):
                return flash_block_update(qc, kc, vc, ac, mc, lc, 0, 0, causal)
            return u

        cast = lambda x: x
    else:
        scale = _inv_sqrt(d, torch.float32, q.device)
        tri = torch.arange(c, device=q.device)
        tri = tri[None, :] <= tri[:, None]

        def _update(causal):
            """(c x c) online-softmax update; causal=True applies the
            within-chunk lower triangle (self-hop diagonals only)."""
            def u(qc, kc, vc, ac, mc, lc):
                s = torch.einsum("bqd,bkd->bqk", qc, kc) * scale
                if causal:
                    s = torch.where(tri[None], s, _NEG)
                m_new = torch.maximum(mc, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                if causal:
                    p = torch.where(s <= _NEG / 2, 0.0, p)
                corr = torch.exp(mc - m_new)
                l_new = lc * corr + p.sum(dim=-1)
                a_new = ac * corr[..., None] + torch.einsum("bqk,bkd->bqd", p, vc)
                return a_new, m_new, l_new
            return u

        cast = lambda x: x.float()

    full_update, diag_update = _update(False), _update(True)

    def chunk(x, i):
        """Chunk i of every row of a (*lead, 2, c, D) tensor -> (bh, c, D)."""
        return x[..., i, :, :].reshape(bh, c, d)

    qz = cast(q).reshape(*lead, 2, c, d)
    kz = cast(k).reshape(*lead, 2, c, d)
    vz = cast(v).reshape(*lead, 2, c, d)
    q0, q1 = chunk(qz, 0), chunk(qz, 1)

    # self hop: q0*k0 (diag), q1*k0 (full: chunk 2G-1-me is after chunk me),
    # q1*k1 (diag)
    a0, m0, l0 = diag_update(q0, chunk(kz, 0), chunk(vz, 0), *empty_state(bh, c, d, q.device))
    a1, m1, l1 = full_update(q1, chunk(kz, 0), chunk(vz, 0), *empty_state(bh, c, d, q.device))
    a1, m1, l1 = diag_update(q1, chunk(kz, 1), chunk(vz, 1), a1, m1, l1)

    k_cur, v_cur = _rotate(kz, vz, axis, span)
    for t in range(1, g):
        src = (me - t) % g                      # original owner of the visiting kv
        early = _per_row(src < me, lead)         # visitor's chunks precede mine
        e3, e2 = early.view(bh, 1, 1), early.view(bh, 1)
        k0, k1, v0, v1 = chunk(k_cur, 0), chunk(k_cur, 1), chunk(v_cur, 0), chunk(v_cur, 1)
        # my chunk (early ? 0 : 1) sees the visitor's chunk 0
        ac, mc, lc = full_update(torch.where(e3, q0, q1), k0, v0, torch.where(e3, a0, a1),
                                 torch.where(e2, m0, m1), torch.where(e2, l0, l1))
        a0, m0, l0 = torch.where(e3, ac, a0), torch.where(e2, mc, m0), torch.where(e2, lc, l0)
        a1, m1, l1 = torch.where(e3, a1, ac), torch.where(e2, m1, mc), torch.where(e2, l1, lc)
        # my chunk 1 sees the visitor's chunk (early ? 0 : 1)
        a1, m1, l1 = full_update(q1, torch.where(e3, k0, k1), torch.where(e3, v0, v1),
                                 a1, m1, l1)
        if t + 1 < g:
            k_cur, v_cur = _rotate(k_cur, v_cur, axis, span)

    out = torch.stack([a0 / torch.clamp_min(l0[..., None], 1e-30),
                       a1 / torch.clamp_min(l1[..., None], 1e-30)], dim=1)
    return out.reshape(q.shape).to(q.dtype)


def ulysses_attention(q, k, v, axis: int, axis_size: int,
                      causal: bool = False, group=None) -> torch.Tensor:
    """Exact attention by re-sharding seq->heads with all-to-all, attending, and
    re-sharding back."""
    nr = q.dim() - 4
    h = q.shape[nr + 1]
    if axis_size == 1:
        return _dense_attention(q, k, v, causal, 0)
    mlsl_assert(h % axis_size == 0,
                "heads_local %d must be divisible by seq axis size %d", h, axis_size)
    span = _span(group, axis_size)
    _coord(q, axis, axis_size, span)
    g = axis_size
    ranks = q.shape[:nr]

    def exchange(y):  # the seq rank dim <-> the head-group dim (nr + 1)
        if span is None:
            return y.transpose(axis, nr + 1)
        from mlsl_tpu_torch.comm import transport

        return transport.axis_all_to_all(span, y, axis, nr + 1)

    def to_heads(x):  # (ranks, B, H, Sl, D) -> (ranks, B, H/G, S, D)
        b, _, sl, d = x.shape[nr:]
        y = exchange(x.reshape(*ranks, b, g, h // g, sl, d))
        return y.movedim(nr + 1, nr + 2).reshape(*ranks, b, h // g, g * sl, d)

    def to_seq(x):    # (ranks, B, H/G, S, D) -> (ranks, B, H, Sl, D)
        b, hg, s, d = x.shape[nr:]
        y = x.reshape(*ranks, b, hg, g, s // g, d).movedim(nr + 2, nr + 1)
        return exchange(y).reshape(*ranks, b, g * hg, s // g, d)

    out = _dense_attention(to_heads(q), to_heads(k), to_heads(v), causal, 0)
    return to_seq(out)


def _dense_attention(q, k, v, causal: bool, pos_offset: int) -> torch.Tensor:
    """Attention over each row's whole sequence: (..., S, D) -> (..., S, D)."""
    s, d = q.shape[-2:]
    if _use_flash(s, s, d):
        out = flash_attention(q.reshape(-1, s, d), k.reshape(-1, s, d), v.reshape(-1, s, d),
                              pos_offset, pos_offset, causal)
        return out.reshape(q.shape)
    scale = _inv_sqrt(d, torch.float32, q.device)
    s_mat = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(s, device=q.device) + pos_offset
        s_mat = torch.where(pos[None, :] <= pos[:, None], s_mat, _NEG)
    p = torch.softmax(s_mat, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p, v.float()).to(q.dtype)


def _use_flash(sq: int, sk: int, d: int) -> bool:
    """Route through the kernels wherever their tiling admits the shapes
    (``supports()``, the TPU predicate) and the CUDA kernels take the
    head_dim."""
    return supports(sq, sk, d) and d <= MAX_HEAD_DIM
