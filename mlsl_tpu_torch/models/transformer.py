"""Decoder-only transformer with dp x sp x tp hybrid parallelism, MLSL in the loop.

Counterpart of the training path of ``mlsl_tpu.models.transformer``: batch
over the data axis (DP), sequence over the seq axis (SP: ring, zigzag or
Ulysses attention, ``parallel/sequence.py``), heads and MLP width over the
model axis (TP); parameter gradients sync over data x seq through the
ParameterSet requests, per layer, as in the ResNet trainer.

Every virtual rank runs in one process, so every activation carries the
leading (R, D, S, M) grid dims and each op runs once over all ranks:

- ``lax.psum(o, 'model')`` is a sum over the M dim, broadcast back;
- ``lax.ppermute`` around the sequence ring is ``torch.roll`` along S;
- ``lax.axis_index('seq')`` is the S coordinate.

Parameters are real per-rank copies, (R, D, S, M, *local) leaf tensors, so
autograd gives each rank its own gradient; the sum over data x seq happens
in the ParameterSet requests, never inside autograd. The gradient semantics
are JAX's SPMD ones: JAX differentiates each device's scalar, which gives
d(sum over ranks of their losses)/d(local leaf) with the CE scaled by 1/tp;
the port sums every rank's scaled loss and runs one backward, then sums the
replicated leaves' gradients over M (``transformer.py:757-760``).

With ``n_experts > 0`` every block's FFN is the expert-parallel MoE layer
(models/moe.py, ep = tp): the experts shard over the model axis, the gate is
replicated, and the dispatch and combine exchanges go through the collective
engine with the model group and the config (``MLSL_ALGO=alltoall=pallas_a2a``
puts the float32 combine exchange on kernel B6). Each rank's loss adds
``moe_aux_weight`` times its slice's aux loss, scaled as in the JAX package.

With ``sharded_vocab`` the LM head shards over the model axis and the CE
comes from each rank's slice of the logits (a max, a sum of exps and the
label's logit, each summed over M): the full-vocabulary logits never exist.

The update is the built-in SGD or an elementwise transform of
``mlsl_tpu_torch.optim`` (``adam``, ``sgd``) over each rank's flat local
(TP-sharded) layer vector, as the JAX trainer runs optax. With
``distributed_update`` (ZeRO-1) the gradients are reduce-scattered over data
x seq, each rank keeps optimizer state for its owned shard only and turns it
into an increment, and the increments are all-gathered back
(transformer.py:939-980, 1030-1058). ``step_accum`` sums several
micro-batches' gradients before one sync.

Compute is bfloat16 by default; parameters, the residual adds, the TP sums,
layer norms and the loss are float32. ``remat`` replays each block in the
backward (``"full"``) or everything in it but its matrix products
(``"dots"``). The gradient requests start after ``torch.autograd.grad``
returns, not from hooks, so a replayed block cannot start one twice.

Where no parameter set communicates (the fused path: one data x seq rank, no
ZeRO-1), ``step`` on the card replays the whole step -- forward, backward,
the TP sums and the update -- as one CUDA graph, the counterpart of the
reference's one donated jit (transformer.py:813-895); ``compiled_step``
gives its FLOPs, memory and recorded launches. On the CPU the same step runs
eagerly.

Decode mode (``prefill_local``, ``decode_local``; transformer.py:319-509 of
the JAX package) serves a dense model for ``mlsl_tpu_torch.serve``: a
prefill over one padded sequence, and the batched decode step over the paged
KV pools, the model's TP reductions through the collective engine's
selection table (``_decode_reduce``). Attention runs in float32 over float32
(or int8 + scale, ``kv_block_quant`` on kernel B1, read back on B2) KV at
rest.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from mlsl_tpu_torch import optim
from mlsl_tpu_torch.core import graph_capture
from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.models.convert import transformer_params_from_jax, tree_leaves
from mlsl_tpu_torch.models.train import owned_opt_increment
from mlsl_tpu_torch.models.moe import init_moe_params, moe_ffn
from mlsl_tpu_torch.ops.mxu import mxu_einsum
from mlsl_tpu_torch.parallel.sequence import (
    ring_attention,
    ulysses_attention,
    zigzag_perm,
    zigzag_ring_attention,
)
from mlsl_tpu_torch.types import CompressionType, DataType, OpType

GRID = 4            # leading (R, D, S, M) dims of every per-rank tensor
SEQ_DIM, MODEL_DIM = 2, 3


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 8
    head_dim: int = 8
    n_blocks: int = 2
    seq_len: int = 64
    mlp_ratio: int = 4
    attention: str = "ring"  # 'ring' | 'zigzag' | 'ulysses'. 'zigzag' is the
    # load-balanced causal ring (parallel/sequence.py): the trainer feeds
    # tokens/labels in zigzag sequence order and the position embedding rows
    # follow, so training is mathematically identical to 'ring'.
    dtype: str = "bfloat16"  # compute dtype; 'float32' for exactness tests
    remat: bool = False      # keep only each block's input; replay the block in
    # the backward (torch.utils.checkpoint)
    remat_policy: str = "full"  # 'full' | 'dots' (with remat=True): 'dots' also
    # keeps the matrix products' outputs
    n_experts: int = 0       # >0: MoE FFN with expert parallelism over 'model'
    moe_top_k: int = 1       # 1 = switch routing; 2 = GShard-style top-2
    moe_aux_weight: float = 0.01
    capacity_factor: float = 2.0
    sharded_vocab: bool = False  # shard the LM head over 'model': the CE from
    # per-shard logits, the full-vocabulary logits never formed


# gpt-medium-2k, the JAX package's realistic transformer row
# (benchmarks/transformer_bench.py:106-108): the configuration the card runs
GPT_MEDIUM_2K = TransformerConfig(vocab=32768, d_model=1024, n_heads=16, head_dim=64,
                                  n_blocks=12, seq_len=2048)

# gpt-medium-2k-moe8: the same widths with a Switch-style MoE FFN of 8 experts
# in every block, at the JAX package's MoE defaults (top-1, capacity factor
# 2.0, aux weight 0.01): the expert-parallel configuration the card runs
GPT_MEDIUM_2K_MOE8 = dataclasses.replace(GPT_MEDIUM_2K, n_experts=8)


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def init_params(generator: torch.Generator, cfg: TransformerConfig) -> Dict:
    """Random weights from ``generator`` in the JAX package's global layout
    (float32 CPU tensors): normal * 0.02 for the matrices, ones and zeros
    for the norms and biases. The JAX package draws from jax.random, so the
    same seed gives other numbers: tests convert JAX's own tree instead."""
    dm, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    f = cfg.mlp_ratio * dm
    std = 0.02

    def normal(*shape):
        return torch.randn(shape, generator=generator) * std

    params = {
        "embed": {"tok": normal(cfg.vocab, dm), "pos": normal(cfg.seq_len, dm)},
        "final": {"ln_scale": torch.ones(dm), "ln_bias": torch.zeros(dm),
                  "head": normal(dm, cfg.vocab)},
    }
    for i in range(cfg.n_blocks):
        params[f"blk{i}.ln"] = {
            "ln1_scale": torch.ones(dm), "ln1_bias": torch.zeros(dm),
            "ln2_scale": torch.ones(dm), "ln2_bias": torch.zeros(dm),
        }
        params[f"blk{i}.attn"] = {"wqkv": normal(dm, 3, h, dh), "wo": normal(h, dh, dm)}
        if cfg.n_experts > 0:
            params[f"blk{i}.mlp"] = init_moe_params(generator, dm, f, cfg.n_experts, std)
        else:
            params[f"blk{i}.mlp"] = {"w1": normal(dm, f), "b1": torch.zeros(f),
                                     "w2": normal(f, dm), "b2": torch.zeros(dm)}
    return params


def param_specs(cfg: TransformerConfig) -> Dict:
    """For every leaf, the dim of its global shape that is sharded over the
    model axis, or None for a leaf replicated over it (the JAX package's
    PartitionSpec tree, ``transformer.py:123``): with experts, the gate is
    replicated and the experts shard on dim 0."""
    specs = {
        "embed": {"tok": None, "pos": None},
        "final": {"ln_scale": None, "ln_bias": None, "head": 1 if cfg.sharded_vocab else None},
    }
    for i in range(cfg.n_blocks):
        specs[f"blk{i}.ln"] = {k: None for k in
                               ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")}
        specs[f"blk{i}.attn"] = {"wqkv": 2, "wo": 0}
        if cfg.n_experts > 0:
            specs[f"blk{i}.mlp"] = {"wg": None, "w1": 0, "w2": 0}
        else:
            specs[f"blk{i}.mlp"] = {"w1": 1, "b1": 0, "w2": 0, "b2": None}
    return specs


def layer_names(cfg: TransformerConfig) -> List[str]:
    names = ["embed"]
    for i in range(cfg.n_blocks):
        names += [f"blk{i}.ln", f"blk{i}.attn", f"blk{i}.mlp"]
    names.append("final")
    return names


def get_layer(params, name):
    return params[name]


def _bcast(p: torch.Tensor, n: int) -> torch.Tensor:
    """A per-rank (*grid, *shape) leaf with ``n`` singleton dims inserted after
    the grid dims, to broadcast against (*grid, <n dims>, *shape) activations."""
    return p.view(*p.shape[:GRID], *([1] * n), *p.shape[GRID:])


def _ln(x, scale, bias, eps=1e-5):
    """Layer norm over the last dim with per-rank scale and bias (x's rank is
    GRID + n + 1, the leaves' GRID + 1)."""
    n = x.dim() - GRID - 1
    y = F.layer_norm(x, x.shape[-1:], eps=eps)
    return y * _bcast(scale, n) + _bcast(bias, n)


def _model_sum(x: torch.Tensor, tp: int) -> torch.Tensor:
    """``lax.psum(x, 'model')``: the sum over the M dim on every model rank."""
    return x.sum(dim=MODEL_DIM, keepdim=True).expand_as(x) if tp > 1 else x


def _positions(sp: int, sl: int, zigzag: bool, device) -> torch.Tensor:
    """(S, sl) int64: the position-embedding rows of each sequence rank."""
    if zigzag and sp > 1:
        # zigzag layout: tokens/labels arrive zigzag-ordered (shard_tokens), so
        # the position rows follow the same permutation of the run-time global
        # length sp*sl
        return torch.as_tensor(zigzag_perm(sp * sl, sp), device=device).view(sp, sl)
    return torch.arange(sp * sl, device=device).view(sp, sl)


# the products whose outputs remat_policy="dots" keeps (jax.checkpoint_policies.
# checkpoint_dots): every matrix product, as ops/mxu.py's bf16 tensor-core
# product (aten.bmm.dtype) and the float32 einsums lower to them; the rest,
# kernel launches included, is replayed
_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
             torch.ops.aten.baddbmm)


def _products_policy(ctx, op, *args, **kwargs):
    if op.overloadpacket in _PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_products():
    return create_selective_checkpoint_contexts(_products_policy)


def forward_local(params, tokens, cfg: TransformerConfig, sp: int, tp: int, comm=None):
    """The forward of every rank at once.

    tokens: (R, D, S, M, Bl, Sl) int. params: per-rank local shards, each leaf
    (R, D, S, M, *local). ``comm``: (model group, Config) for the MoE
    exchanges' selection, or None for the plain exchange. Returns (final
    hidden states (R, D, S, M, Bl, Sl, d_model) float32 post final-LN, the
    same on every model rank, and the MoE aux-loss total of each rank's
    slices, (R, D, S, M), or 0.0 without experts). The LM head is applied by
    the loss.
    """
    grid, (bl, sl) = tokens.shape[:GRID], tokens.shape[GRID:]
    emb = params["embed"]
    cdt = _dtype(cfg.dtype)
    dm = cfg.d_model
    idx = _positions(sp, sl, cfg.attention == "zigzag", tokens.device)
    idx = idx.view(1, 1, sp, 1, sl, 1).expand(*grid, sl, dm)
    pos = torch.gather(emb["pos"], GRID, idx)                         # (*grid, Sl, dm)
    tok_idx = tokens.reshape(*grid, bl * sl, 1).long().expand(*grid, bl * sl, dm)
    tok = torch.gather(emb["tok"], GRID, tok_idx).view(*grid, bl, sl, dm)
    h = (tok + pos.unsqueeze(GRID)).to(cdt)

    if cfg.attention == "zigzag":
        def attn_fn(q, k, v, ax, n, causal=True):
            mlsl_assert(causal, "zigzag attention is causal-only "
                                "(use attention='ring' for non-causal)")
            if n > 1:
                return zigzag_ring_attention(q, k, v, ax, n)
            return ring_attention(q, k, v, ax, n, causal=True)
    else:
        attn_fn = ring_attention if cfg.attention == "ring" else ulysses_attention

    def block(h, lnp, ap, mp):
        a = _ln(h.float(), lnp["ln1_scale"], lnp["ln1_bias"]).to(cdt)
        qkv = torch.einsum("...bsd,...dchx->...bcshx", a, ap["wqkv"].to(cdt))
        q, k, v = (qkv[..., c, :, :, :].movedim(-2, -3) for c in range(3))  # (*grid, Bl, Hl, Sl, Dh)
        attn = attn_fn(q, k, v, SEQ_DIM, sp, causal=True)
        # bf16 operands, f32 product: the residual add and the TP sum stay f32
        o = mxu_einsum("...bhsx,...hxd->...bsd", attn.to(cdt), ap["wo"].to(cdt))
        h = (h.float() + _model_sum(o, tp)).to(cdt)

        a = _ln(h.float(), lnp["ln2_scale"], lnp["ln2_bias"]).to(cdt)
        if cfg.n_experts > 0:
            o, aux = moe_ffn(a.reshape(*grid, bl * sl, dm).float(), mp, MODEL_DIM, tp,
                             cfg.capacity_factor, cfg.moe_top_k, compute_dtype=cdt,
                             group=comm[0] if comm else None,
                             config=comm[1] if comm else None)
            return (h.float() + o.reshape(*grid, bl, sl, dm)).to(cdt), aux
        f = F.gelu(torch.einsum("...bsd,...df->...bsf", a, mp["w1"].to(cdt))
                   + _bcast(mp["b1"], 2).to(cdt), approximate="tanh")
        o = mxu_einsum("...bsf,...fd->...bsd", f, mp["w2"].to(cdt))
        return (h.float() + _model_sum(o, tp) + _bcast(mp["b2"], 2)).to(cdt), None

    # cfg.remat (transformer.py:256-275 of the JAX package): keep only each
    # block's input residual stream and replay the block in the backward
    mlsl_assert(cfg.remat_policy in ("full", "dots"),
                "unknown remat_policy %r", cfg.remat_policy)
    if cfg.remat:
        context = _save_products if cfg.remat_policy == "dots" else noop_context_fn
        # the block draws no random numbers: no RNG state to keep, which a
        # CUDA graph could not read back while it records
        blk = functools.partial(checkpoint, block, use_reentrant=False, context_fn=context,
                                preserve_rng_state=False)
    else:
        blk = block
    aux_total = 0.0
    for i in range(cfg.n_blocks):
        h, aux = blk(h, *(params[f"blk{i}.{part}"] for part in ("ln", "attn", "mlp")))
        if aux is not None:
            aux_total = aux_total + aux

    fin = params["final"]
    return _ln(h.float(), fin["ln_scale"], fin["ln_bias"]), aux_total


def _sharded_vocab_ce(h, head_local, labels, tp: int) -> torch.Tensor:
    """CE over a vocabulary sharded over the model axis (transformer.py:
    282-301): per-shard logits (..., Bl, Sl, V/tp), float32; the stability
    max is the max over M of the shards' maxima, without gradient (it cancels
    in d lse / d logits); the sum of exps and the label's logit, picked on
    the shard that holds it, are summed over M. -> (R, D, S, M) CE sums, the
    same on every model rank. Every rank's loss enters the objective scaled
    by 1/tp and ``_model_sum``'s backward adds the M cotangents, so each
    shard's logits get exactly softmax - onehot."""
    logits = torch.einsum("...bsd,...dv->...bsv", h, head_local)
    vl = logits.shape[-1]
    with torch.no_grad():
        mx = logits.amax(dim=-1).amax(dim=MODEL_DIM, keepdim=True)       # (R, D, S, 1, Bl, Sl)
    se = _model_sum(torch.exp(logits - mx[..., None]).sum(dim=-1), tp)
    lse = torch.log(se) + mx
    off = torch.arange(tp, device=labels.device).view(1, 1, 1, tp, 1, 1) * vl
    local = labels.long() - off
    in_range = (local >= 0) & (local < vl)
    picked = torch.gather(logits, -1, local.clamp(0, vl - 1).unsqueeze(-1)).squeeze(-1)
    label_logit = _model_sum(torch.where(in_range, picked, 0.0), tp)
    return (lse - label_logit).sum(dim=(-2, -1))


def local_loss(params, tokens, labels, cfg: TransformerConfig, sp: int, tp: int, comm=None):
    """Sum (not mean) of CE over each rank's local token shard -> ((R, D, S,
    M) float32, aux). The reduction across data/seq shards belongs to the
    gradient requests. The LM head is replicated over the model axis (dense
    log-softmax) or, with ``cfg.sharded_vocab`` and tp > 1, sharded over it
    (``_sharded_vocab_ce``)."""
    h, aux = forward_local(params, tokens, cfg, sp, tp, comm=comm)
    return head_ce(h, params["final"]["head"], labels, cfg, tp), aux


def head_ce(h, head, labels, cfg: TransformerConfig, tp: int) -> torch.Tensor:
    """The LM head and its CE on the final hidden states h (R, D, S, M, Bl,
    Sl, d_model) float32 -> (R, D, S, M) CE sums: the dense log-softmax over
    the replicated head, or ``_sharded_vocab_ce`` over the rank's shard."""
    head = head.float()
    if cfg.sharded_vocab and tp > 1:
        return _sharded_vocab_ce(h, head, labels, tp)
    logits = torch.einsum("...bsd,...dv->...bsv", h, head)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return ce.sum(dim=(-2, -1))


# -- decode mode (mlsl_tpu_torch.serve): prefill and paged one-token steps -----
#
# The serving engine (serve/engine.py) runs these over its 1 x tp slice (dp =
# sp = 1): a prefill a sequence, and the batched decode step over the paged
# KV pools, which shard over the model axis on the heads dim (as wqkv). The
# TP output reductions go through the collective engine's selection table
# (``algos.inline_allreduce``) when a (model group, config) pair is passed,
# so that the decode step's small reductions can take kernel B5 under
# MLSL_PALLAS_RHD=1 and every reduction B3 under MLSL_ALGO=allreduce=pallas_ring.
#
# Numerics, as the JAX package's: the QKV, MLP and output products in the
# compute dtype, attention in float32 over float32 KV at rest in both paths,
# and the engine pins the decode step's gathered context (max_pages x page)
# to the prefill's padded length, so that both reduce over the same extents
# and masked positions add exact zeros.


def _decode_reduce(x: torch.Tensor, tp: int, comm) -> torch.Tensor:
    """The TP output reduction of the decode path: routed by the selection
    table when a (model group, config) pair is given, else the plain model
    sum."""
    if tp <= 1:
        return x
    if comm is not None:
        from mlsl_tpu_torch.comm import algos

        return algos.inline_allreduce(x, MODEL_DIM, group=comm[0], config=comm[1])
    return _model_sum(x, tp)


def _causal_attn_f32(q, k, v, scale: float) -> torch.Tensor:
    """Plain causal attention on one sequence (sp = 1): (..., Hl, S, Dh)
    float32 -> (..., Hl, S, Dh) float32. The prefill twin of the decode
    step's masked softmax."""
    s = torch.einsum("...hsx,...htx->...hst", q * scale, k)
    n = q.shape[-2]
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, -torch.inf)
    return torch.einsum("...hst,...htx->...hsx", torch.softmax(s, dim=-1), v)


def kv_block_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing (head_dim) dim, one row a (token,
    head): kernel B1 (``ops.quant_kernels.quantize_blocks``, the blockwise
    contract with block = head_dim) on a CUDA tensor, its plain version on a
    CPU one. -> (q int8 of x's shape, float32 scales without the trailing
    dim); ``kv_block_dequant`` is the inverse, ``q * scales[..., None]``."""
    from mlsl_tpu_torch.ops import quant_kernels as qk

    q, s = qk.quantize_blocks(x.reshape(-1, x.shape[-1]).contiguous())
    return q.view(x.shape), s.view(x.shape[:-1])


def kv_block_dequant(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``q * scales[..., None]`` in float32: kernel B2
    (``ops.quant_kernels.dequantize_blocks``) on a CUDA tensor, its plain
    version on a CPU one."""
    from mlsl_tpu_torch.ops import quant_kernels as qk

    x = qk.dequantize_blocks(q.reshape(-1, q.shape[-1]).contiguous(),
                             scales.reshape(-1).contiguous())
    return x.view(q.shape)


def _decode_mlp(h, lnp, mp, cdt, tp, comm):
    """The block's second half, on (..., rows, d_model) activations."""
    a = _ln(h.float(), lnp["ln2_scale"], lnp["ln2_bias"]).to(cdt)
    f = F.gelu(torch.einsum("...sd,...df->...sf", a, mp["w1"].to(cdt))
               + _bcast(mp["b1"], 1).to(cdt), approximate="tanh")
    o = _decode_reduce(mxu_einsum("...sf,...fd->...sd", f, mp["w2"].to(cdt)), tp, comm)
    return (h.float() + o + _bcast(mp["b2"], 1)).to(cdt)


@torch.no_grad()
def prefill_local(params, tokens, length, cfg: TransformerConfig, tp: int, comm=None,
                  dtype=None):
    """Decode-mode prefill over one sequence, every rank at once.

    tokens: (S,) int on the parameters' device, padded past ``length`` with
    any value: the padded positions' K/V are computed but land on the KV
    cache's reserved garbage page or on positions the decode step writes
    before it reads them. ``params``: per-rank leaves (R, D, S, M, *local).
    -> (next-token logits (R, D, S, M, V) float32 read at position
    length - 1, the same on every model rank; k, v: (R, D, S, M, n_blocks,
    S, Hl, Dh) float32, each model rank's head shard).
    """
    mlsl_assert(cfg.n_experts == 0, "decode mode serves dense-MLP models")
    mlsl_assert(not cfg.sharded_vocab, "decode mode serves a replicated LM head")
    cdt = _dtype(dtype or cfg.dtype)
    emb = params["embed"]
    n = tokens.shape[0]
    tok = emb["tok"].index_select(GRID, tokens.long())                  # (*grid, S, dm)
    h = (tok + emb["pos"][..., :n, :]).to(cdt)
    scale = 1.0 / float(np.sqrt(cfg.head_dim))
    ks, vs = [], []
    for i in range(cfg.n_blocks):
        lnp, ap, mp = (params[f"blk{i}.{part}"] for part in ("ln", "attn", "mlp"))
        a = _ln(h.float(), lnp["ln1_scale"], lnp["ln1_bias"]).to(cdt)
        qkv = torch.einsum("...sd,...dchx->...cshx", a, ap["wqkv"].to(cdt))
        # (*grid, S, Hl, Dh) float32: the page layout and the at-rest dtype
        q, k, v = (qkv[..., c, :, :, :].float() for c in range(3))
        ks.append(k)
        vs.append(v)
        attn = _causal_attn_f32(q.movedim(-2, -3), k.movedim(-2, -3), v.movedim(-2, -3),
                                scale)                                    # (*grid, Hl, S, Dh)
        o = mxu_einsum("...hsx,...hxd->...sd", attn.to(cdt), ap["wo"].to(cdt))
        h = (h.float() + _decode_reduce(o, tp, comm)).to(cdt)
        h = _decode_mlp(h, lnp, mp, cdt, tp, comm)

    fin = params["final"]
    h = _ln(h.float(), fin["ln_scale"], fin["ln_bias"])
    last = torch.as_tensor(length, device=h.device).reshape(1).long() - 1
    h = h.index_select(GRID, last).squeeze(GRID)                          # (*grid, dm)
    logits = torch.einsum("...d,...dv->...v", h, fin["head"].float())
    return logits, torch.stack(ks, dim=GRID), torch.stack(vs, dim=GRID)


@torch.no_grad()
def decode_local(params, tokens, positions, pt, kpool, vpool, cfg: TransformerConfig,
                 tp: int, comm=None, dtype=None, kscale=None, vscale=None):
    """One continuous-batching decode step, every rank at once.

    tokens: (B,) int the token each slot feeds; positions: (B,) int the
    index that token takes (its K/V is written there and it attends over
    the indices <= it); pt: (B, M) int page tables (0 = the reserved garbage
    page: inactive slots carry all-zero tables and positions, and their
    writes land there); kpool, vpool: (R, D, S, M, n_blocks, Np, page, Hl,
    Dh) KV pools, float32, or int8 with kscale, vscale (R, D, S, M,
    n_blocks, Np, page, Hl) float32 (``kv_block_quant``). The pools are
    written in place. -> (logits (R, D, S, M, B, V) float32, kpool, vpool[,
    kscale, vscale]), as the JAX function returns its donated pools.

    Nothing here reads a value back to the host, so that on the card the
    whole step records as one CUDA graph.
    """
    mlsl_assert(cfg.n_experts == 0, "decode mode serves dense-MLP models")
    mlsl_assert(not cfg.sharded_vocab, "decode mode serves a replicated LM head")
    cdt = _dtype(dtype or cfg.dtype)
    quant = kscale is not None
    page = kpool.shape[GRID + 2]
    b, n_pages = pt.shape
    t_ctx = n_pages * page
    emb = params["embed"]
    tokens, positions, pt = tokens.long(), positions.long(), pt.long()
    h = (emb["tok"].index_select(GRID, tokens)
         + emb["pos"].index_select(GRID, positions)).to(cdt)               # (*grid, B, dm)
    scale = 1.0 / float(np.sqrt(cfg.head_dim))
    pages_b = pt.gather(1, (positions // page)[:, None])[:, 0]            # (B,)
    offs_b = positions % page
    flat_pt = pt.reshape(-1)
    mask = torch.arange(t_ctx, device=pt.device)[None, :] <= positions[:, None]   # (B, T)

    def gathered(pool, i):
        """Block i's pages of every slot: (*grid, B, T, ...)."""
        g = pool[:, :, :, :, i].index_select(GRID, flat_pt)
        return g.view(*g.shape[:GRID], b, t_ctx, *g.shape[GRID + 2:])

    for i in range(cfg.n_blocks):
        lnp, ap, mp = (params[f"blk{i}.{part}"] for part in ("ln", "attn", "mlp"))
        a = _ln(h.float(), lnp["ln1_scale"], lnp["ln1_bias"]).to(cdt)
        qkv = torch.einsum("...bd,...dchx->...bchx", a, ap["wqkv"].to(cdt))
        q, knew, vnew = (qkv[..., c, :, :].float() for c in range(3))     # (*grid, B, Hl, Dh)
        if quant:
            for pool, spool, x in ((kpool, kscale, knew), (vpool, vscale, vnew)):
                xq, xs = kv_block_quant(x)
                pool[:, :, :, :, i][:, :, :, :, pages_b, offs_b] = xq
                spool[:, :, :, :, i][:, :, :, :, pages_b, offs_b] = xs
            kseq = kv_block_dequant(gathered(kpool, i), gathered(kscale, i))
            vseq = kv_block_dequant(gathered(vpool, i), gathered(vscale, i))
        else:
            kpool[:, :, :, :, i][:, :, :, :, pages_b, offs_b] = knew
            vpool[:, :, :, :, i][:, :, :, :, pages_b, offs_b] = vnew
            kseq, vseq = gathered(kpool, i), gathered(vpool, i)           # (*grid, B, T, Hl, Dh)
        s = torch.einsum("...bhx,...bthx->...bht", q * scale, kseq)
        s = torch.where(mask[:, None, :], s, -torch.inf)
        attn = torch.einsum("...bht,...bthx->...bhx", torch.softmax(s, dim=-1), vseq)
        o = mxu_einsum("...bhx,...hxd->...bd", attn.to(cdt), ap["wo"].to(cdt))
        h = (h.float() + _decode_reduce(o, tp, comm)).to(cdt)
        h = _decode_mlp(h, lnp, mp, cdt, tp, comm)

    fin = params["final"]
    h = _ln(h.float(), fin["ln_scale"], fin["ln_bias"])
    logits = torch.einsum("...bd,...dv->...bv", h, fin["head"].float())
    if quant:
        return logits, kpool, vpool, kscale, vscale
    return logits, kpool, vpool


@dataclasses.dataclass
class CompiledStep:
    """The fused step as ``compiled_step`` gives it, the counterpart of the
    jax ``Compiled`` object the reference returns (transformer.py:679-690):
    ``cost_analysis()`` -> {"flops": ...}, ``memory_analysis()`` -> the peak
    device bytes as of the capture's end (``torch.cuda.max_memory_allocated``,
    which the capture does not reset: a caller that wants the step's own
    peak resets it before the first step) and the graph's pool,
    ``as_text()`` the kernel launches the graph recorded, by class.

    The FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s count of one
    eager step plus each B7/B8 launch's from its shape (``attention_kernels.
    count_flops``): the counter cannot see a ctypes launch. On the CPU the
    plain versions run instead and the counter sees them; there is no graph
    and no device memory to report."""

    flops: float = 0.0
    op_flops: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: Optional[int] = None
    graph_pool_bytes: Optional[int] = None
    capture_s: Optional[float] = None

    def cost_analysis(self) -> Dict[str, float]:
        return {"flops": self.flops}

    def memory_analysis(self) -> Dict[str, Optional[int]]:
        return {"peak_bytes": self.peak_bytes, "graph_pool_bytes": self.graph_pool_bytes}

    def as_text(self) -> str:
        lines = [f"fused step: {self.flops:.6g} flops"
                 + ("" if self.capture_s is None else
                    f", one CUDA graph captured in {self.capture_s:.3f} s")]
        lines.append("launches recorded: " + (", ".join(
            f"{k} {v}" for k, v in sorted(self.launches.items())) or "none"))
        for k, v in sorted({**self.op_flops, **self.kernel_flops}.items()):
            lines.append(f"  {k}: {v} flops")
        return "\n".join(lines)


def _bmm_flops(a_shape, b_shape, *rest, out_shape=None, **kwargs) -> int:
    """2 b m n k for a (b, m, k) x (b, k, n) product. The counter's own
    formula takes a third positional argument for its output shape, so it
    fails on ``aten.bmm.dtype``'s ``out_dtype`` (ops/mxu.py's tensor-core
    product)."""
    b, m, k = a_shape
    return 2 * b * m * b_shape[-1] * k


def _count_step(step, *args):
    """Run ``step(*args)`` under the FLOP counters. -> (FLOPs by op, FLOPs by
    kernel launch)."""
    from torch.utils.flop_counter import FlopCounterMode

    from mlsl_tpu_torch.ops import attention_kernels as ak

    counter = FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: _bmm_flops})
    with ak.count_flops() as kernels, counter:
        step(*args)
    ops = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return ops, dict(kernels)


class HybridTrainer:
    """dp x sp x tp training with per-layer MLSL gradient sync over data x seq.

    ``params``: the starting weights as a global tree in the JAX package's
    layout (numpy arrays or tensors, e.g. ``mlsl_tpu``'s ``init_params``
    converted to numpy); without it they come from ``init_params`` with a
    generator seeded by ``seed``. The parameters live in ``self.params`` as
    per-rank (R, D, S, M, *local) tensors and are updated in place.

    ``optimizer``: a transform of ``mlsl_tpu_torch.optim``; None means
    ``optim.sgd(lr)``. Its state per layer is ``self.opt_state[layer]``, over
    (R, D, S, M, local count) -- every rank's flat local vector -- or under
    ``distributed_update`` over (R, D, S, M, owned count)."""

    def __init__(self, env, cfg: TransformerConfig, dp: int, sp: int, tp: int,
                 batch: Optional[int] = None, lr: float = 0.1, seed: int = 0,
                 distributed_update: bool = False, compression=None, optimizer=None,
                 params=None):
        mlsl_assert(not isinstance(optimizer, optim.ShardedAdafactor),
                    "ShardedAdafactor's cross-shard factored stats are implemented for "
                    "DataParallelTrainer's distributed update; HybridTrainer takes the "
                    "elementwise transforms of mlsl_tpu_torch.optim (adam, sgd)")
        mlsl_assert(optimizer is None or isinstance(optimizer, optim.Transform),
                    "optimizer must be an elementwise transform of mlsl_tpu_torch.optim "
                    "(adam, sgd)")
        self.env = env
        self.cfg = cfg
        self.dp, self.sp, self.tp = dp, sp, tp
        self.batch = batch if batch is not None else dp
        mlsl_assert(self.batch % dp == 0, "batch %d %% dp %d", self.batch, dp)
        self.lr = lr
        self.optimizer = optimizer if optimizer is not None else optim.sgd(lr)
        self.distributed_update = bool(distributed_update)
        self.dist = env.create_distribution(dp, tp, seq_parts=sp)
        mlsl_assert(
            self.dist.replica_count == 1,
            "world size must equal dp*sp*tp (got %d replicas)", self.dist.replica_count,
        )
        mlsl_assert(cfg.n_heads % tp == 0, "heads %d %% tp %d", cfg.n_heads, tp)
        mlsl_assert(cfg.seq_len % sp == 0, "seq %d %% sp %d", cfg.seq_len, sp)
        if cfg.sharded_vocab:
            mlsl_assert(cfg.vocab % tp == 0, "vocab %d %% tp %d (sharded head)", cfg.vocab, tp)
        if cfg.n_experts > 0:
            local_tokens = (self.batch // dp) * (cfg.seq_len // sp)
            mlsl_assert(cfg.n_experts % tp == 0, "n_experts %d must be divisible by tp %d "
                        "(experts shard over the model axis)", cfg.n_experts, tp)
            mlsl_assert(local_tokens % tp == 0, "local token count %d (batch/dp * seq/sp) must "
                        "be divisible by tp %d for expert-parallel routing", local_tokens, tp)
        self.grid = self.dist.topology.grid_shape
        self.session = env.create_session()
        self.session.set_global_minibatch_size(self.batch)

        self.specs = param_specs(cfg)
        if params is None:
            params = init_params(torch.Generator().manual_seed(seed), cfg)
        self.params = transformer_params_from_jax(params, cfg, self.grid, device=env.device)
        for leaf in tree_leaves(self.params):
            leaf.requires_grad_(True)
        self.layers = layer_names(cfg)
        self._leaves = {n: tree_leaves(self.params[n]) for n in self.layers}
        self._leaf_specs = {n: tree_leaves(self.specs[n]) for n in self.layers}

        # local (per-rank) flat size of each layer = Operation kernel count
        self.local_counts = {
            n: sum(int(np.prod(p.shape[GRID:])) for p in self._leaves[n]) for n in self.layers
        }
        comp = CompressionType(compression) if compression is not None else CompressionType.NONE
        self.ops = {}
        for name in self.layers:
            reg = self.session.create_operation_reg_info(OpType.CC)
            reg.set_name(name)
            reg.add_input(tp, 1)   # placeholder activations (graph comm is unused
            reg.add_output(tp, 1)  # here; grads flow through the parameter sets)
            # MLSL kernel counts are global: the ParameterSet partitions them over the
            # model group, recovering the per-rank length local_counts[name]
            reg.add_parameter_set(self.local_counts[name] * tp, 1, DataType.FLOAT,
                                  distributed_update=self.distributed_update,
                                  compression_type=comp)
            self.ops[name] = self.session.get_operation(
                self.session.add_operation(reg, self.dist)
            )
        self.session.commit()
        self.padded_counts = {
            n: self.ops[n].get_parameter_set(0).get_local_kernel_count() for n in self.layers
        }
        # When no ParameterSet needs gradient comm (grad group of one: dp=sp=1;
        # TP-only grids qualify -- the TP sums of replicated leaves happen in
        # the step), fuse loss + grad + update and skip the per-layer buffers;
        # the distributed update keeps the graph path (owned = local there).
        self.fused = not self.distributed_update and not any(
            self.ops[n].get_parameter_set(0).need_comm for n in self.layers)
        # optimizer state per layer: every rank's flat local vector, or under
        # ZeRO-1 its owned shard only (transformer.py:641-655)
        self.opt_state = {}
        for n in self.layers:
            ps = self.ops[n].get_parameter_set(0)
            width = ps.owned_kernel_count if self.distributed_update else self.local_counts[n]
            self.opt_state[n] = self.optimizer.init((*self.grid, width), device=env.device)
        # synced grads are sums of d(CE sum)/dw over all data x seq shards; the
        # optimizer steps on the mean loss's, divided by the total token count
        self._norm = self.batch * cfg.seq_len
        # each rank's aux loss, pre-scaled by its slice's token count, so that
        # after the division by _norm the objective is mean CE + weight x mean
        # aux whatever the token count (transformer.py:695-722)
        tokens_per_slice = (self.batch // dp) * (cfg.seq_len // sp) / tp
        self._aux_w = cfg.moe_aux_weight * tokens_per_slice
        # the model group and config route the MoE exchanges through the
        # selection table
        self._comm = (self.dist.model_group, env.config) if tp > 1 else None
        # the fused step's CUDA graphs, one per batch shape (card only)
        self._graphs: Dict[tuple, Tuple[graph_capture.Captured, CompiledStep]] = {}

    # -- data placement ----------------------------------------------------

    def shard_tokens(self, tokens: np.ndarray, labels: np.ndarray):
        """Global (B, S) tokens and labels -> (R, D, S, M, Bl, Sl) int64 on the
        Environment's device: batch over data, sequence over seq, the same on
        every model rank; in zigzag order when attention is 'zigzag'."""
        if self.cfg.attention == "zigzag" and self.sp > 1:
            # CE is position-wise, so a consistent (tokens, labels) permutation
            # leaves the loss and the parameter trajectory unchanged
            perm = zigzag_perm(tokens.shape[1], self.sp)
            tokens, labels = np.asarray(tokens)[:, perm], np.asarray(labels)[:, perm]
        r, d, s, m = self.grid
        b, n = tokens.shape
        mlsl_assert(b % d == 0 and n % s == 0, "tokens (%d, %d) do not split over a "
                    "(%d data, %d seq) grid", b, n, d, s)

        def place(a):
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(self.env.device)
            t = t.reshape(r, d, b // d, s, n // s).permute(0, 1, 3, 2, 4)
            return t.unsqueeze(3).expand(r, d, s, m, b // d, n // s)

        return place(tokens), place(labels)

    # -- the training step -------------------------------------------------

    def _all_leaves(self) -> List[torch.Tensor]:
        return [p for n in self.layers for p in self._leaves[n]]

    def _backward(self, tokens, labels):
        """-> (CE sums (R, D, S, M), per-leaf gradients) of the sum over all
        ranks of their CE / tp + aux weight x aux, the TP sum over M applied
        to replicated leaves."""
        with torch.enable_grad():
            ce, aux = local_loss(self.params, tokens, labels, self.cfg, self.sp, self.tp,
                                 comm=self._comm)
            grads = torch.autograd.grad((ce / self.tp + self._aux_w * aux).sum(),
                                        self._all_leaves())
        specs = [s for n in self.layers for s in self._leaf_specs[n]]
        grads = [_model_sum(g.float(), self.tp) if spec is None else g.float()
                 for g, spec in zip(grads, specs)]
        return ce.detach(), grads

    def _grad_fn(self, tokens, labels):
        """-> (loss (R, D, S, M, 1), {layer: (R, D, S, M, padded count) float32
        gradient rows in JAX leaf order}), before any sync: the buffers the
        ParameterSet requests take."""
        ce, grads = self._backward(tokens, labels)
        flat, i = {}, 0
        for name in self.layers:
            n = len(self._leaves[name])
            g = torch.cat([p.reshape(*self.grid, -1) for p in grads[i:i + n]], dim=-1)
            # each layer's leaf gradients go once packed: the rows and the leaf
            # gradients never coexist in full (gpt-medium-2k-moe8 at 12 blocks
            # holds 15 GiB of each)
            grads[i:i + n] = [None] * n
            i += n
            pad = self.padded_counts[name] - g.shape[-1]
            flat[name] = F.pad(g, (0, pad)) if pad else g
        return ce[..., None], flat

    @torch.no_grad()
    def _add_flat(self, name: str, flat: torch.Tensor) -> None:
        """p += flat over one layer's leaves; flat: (R, D, S, M, >= count)."""
        off = 0
        for p in self._leaves[name]:
            n = int(np.prod(p.shape[GRID:]))
            p.add_(flat[..., off:off + n].reshape(p.shape))
            off += n

    @torch.no_grad()
    def _opt_update(self, name: str, flat_grad: torch.Tensor) -> None:
        """One layer's optimizer step on every rank's flat local vector
        (``_flat_opt_layer_update``, transformer.py:724-737); flat_grad is the
        mean gradient (R, D, S, M, local count). The state keeps its tensors:
        a new one (Adam's count) is copied into the old, so that a CUDA graph
        of the step reads and writes the same storage each replay."""
        state = self.opt_state[name]
        upd, new = self.optimizer.update(flat_grad, state)
        self.opt_state[name] = optim.keep_in_place(state, new)
        self._add_flat(name, upd)

    def _fused_update(self, grads) -> None:
        """The no-comm fused path's update (transformer.py:863-895): the
        per-leaf gradients of ``_backward``, layer by layer."""
        it = iter(grads)
        for name in self.layers:
            g = torch.cat([next(it).reshape(*self.grid, -1) for _ in self._leaves[name]], dim=-1)
            self._opt_update(name, g / self._norm)

    def step(self, tokens, labels) -> torch.Tensor:
        """One training step on sharded (tokens, labels) -> the mean CE. On
        the fused path the card replays the step's CUDA graph (captured at
        the first step of each batch shape), as the reference always runs its
        fused jit."""
        if self.fused:
            if tokens.device.type == "cuda":
                return self._replay(tokens, labels)
            return self._eager_step(tokens, labels)
        loss, grads = self._grad_fn(tokens, labels)
        return self._sync_and_update(grads, loss)

    def _eager_step(self, tokens, labels) -> torch.Tensor:
        """The fused no-comm step (transformer.py:813-895), run eagerly: the
        graph's body, and its twin on the card. -> the mean CE (0-d)."""
        ce, grads = self._backward(tokens, labels)
        self._fused_update(grads)
        return ce[:, :, :, 0].sum() / self._norm

    # -- the fused step as one CUDA graph ------------------------------------

    def compiled_step(self, tokens, labels) -> Optional[CompiledStep]:
        """The fused step's profile (transformer.py:679-690), or None off the
        fused path, where the step is many programs. On the card it describes
        the step's captured graph (captured here if ``step`` has not yet).
        Its FLOPs come from one eager step under the FLOP counters, run at the
        first call for a batch shape; the parameters and the optimizer state
        are restored afterwards."""
        if not self.fused:
            return None
        compiled = (self._graph_for(tokens, labels)[1] if tokens.device.type == "cuda"
                    else CompiledStep())
        if not compiled.op_flops and not compiled.kernel_flops:
            with graph_capture.restored(self._state_tensors()):
                compiled.op_flops, compiled.kernel_flops = _count_step(
                    self._eager_step, tokens, labels)
            compiled.flops = float(sum(compiled.op_flops.values())
                                   + sum(compiled.kernel_flops.values()))
        return compiled

    def _state_tensors(self) -> List[torch.Tensor]:
        """What a step writes: the parameters and the optimizer state."""
        state = [t for n in self.layers for t in self.opt_state[n] if torch.is_tensor(t)]
        return self._all_leaves() + state

    def _replay(self, tokens, labels) -> torch.Tensor:
        captured, _ = self._graph_for(tokens, labels)
        return captured.replay((tokens, labels)).clone()

    def _graph_for(self, tokens, labels) -> Tuple[graph_capture.Captured, CompiledStep]:
        """The batch shape's graph and its profile, captured at the first
        call (core/graph_capture.py: one eager warm-up on a side stream, the
        parameters and optimizer state put back, the recording; a capture
        that fails raises MLSLError and nothing runs eagerly in its place).
        The wrappers count a launch when the graph records it, not at
        replay; the warm-up's launches are real and count too."""
        key = (tuple(tokens.shape), tuple(labels.shape), tokens.dtype, labels.dtype)
        hit = self._graphs.get(key)
        if hit is None:
            captured = graph_capture.capture(self._eager_step, (tokens, labels),
                                             self._state_tensors(),
                                             "HybridTrainer's fused step")
            pool = tuple(captured.graph.pool())
            pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                             if tuple(seg["segment_pool_id"]) == pool)
            compiled = CompiledStep(launches=captured.launches,
                                    peak_bytes=torch.cuda.max_memory_allocated(tokens.device),
                                    graph_pool_bytes=pool_bytes, capture_s=captured.seconds)
            hit = self._graphs[key] = (captured, compiled)
        return hit

    def step_accum(self, batches) -> torch.Tensor:
        """Gradient accumulation (transformer.py:996-1016): k local
        forward/backward passes over (tokens, labels) pairs, one gradient
        sync and update; the objective is the mean over all k micro-batches.
        -> the mean CE."""
        mlsl_assert(len(batches) >= 1, "step_accum needs at least one batch")
        total = loss_sum = None
        for tokens, labels in batches:
            loss, grads = self._grad_fn(tokens, labels)
            total = grads if total is None else {n: total[n] + grads[n] for n in self.layers}
            loss_sum = loss if loss_sum is None else loss_sum + loss
        k = len(batches)
        return self._sync_and_update({n: g / k for n, g in total.items()}, loss_sum) / k

    def _sync_and_update(self, grads, loss) -> torch.Tensor:
        # newest gradient first: the backward produces the last layer's first
        for name in reversed(self.layers):
            self.ops[name].get_parameter_set(0).start_gradient_comm(grads[name])
        if self.distributed_update:
            self._zero1_update(grads)
        else:
            for name in self.layers:
                out = self.ops[name].get_parameter_set(0).wait_gradient_comm()
                reduced = out if out is not None else grads[name]
                self._opt_update(name, reduced[..., :self.local_counts[name]] / self._norm)
        # the loss buffer holds per-(data, seq)-shard CE sums, the same on every
        # model rank -> take slot 0; mean = total / (batch * seq_len)
        return loss[:, :, :, 0].sum() / self._norm

    @torch.no_grad()
    def _zero1_update(self, grads) -> None:
        """ZeRO-1 (transformer.py:1030-1058): each rank turns its owned
        gradient shard into an increment, the increments are all-gathered
        over data x seq, and every rank adds the gathered increment to its
        local shard. A grad group of one (owned is None) applies the full
        local increment."""
        incs = {}
        for name in self.layers:
            ps = self.ops[name].get_parameter_set(0)
            owned = ps.wait_gradient_comm()
            src = grads[name] if owned is None else owned
            inc, self.opt_state[name] = owned_opt_increment(
                src, self.opt_state[name], self.optimizer, self._norm)
            if owned is None:
                incs[name] = inc
            else:
                ps.start_increment_comm(inc)
        for name in self.layers:
            inc = self.ops[name].get_parameter_set(0).wait_increment_comm()
            if inc is not None:
                incs[name] = inc
        for name in self.layers:
            self._add_flat(name, incs[name][..., :self.local_counts[name]])
