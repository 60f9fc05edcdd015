"""Mixture-of-experts FFN with expert parallelism over the model axis.

Counterpart of ``mlsl_tpu.models.moe``. Tokens move to the rank holding
their expert and back: two all-to-alls over the model group, the
reference's case-4/5 AlltoAll redistribution (src/mlsl_impl.cpp:203-226)
applied per token. Switch-style top-1 routing (GShard dispatch algebra) or
GShard top-2: each rank routes its token slice, builds a capacity-bounded
dispatch tensor, exchanges token buffers with the expert owners, applies its
experts and exchanges the outputs back for gate-weighted combination.
Tokens over capacity are dropped (the residual connection carries them).
Routing gradients flow through the gate probability.

The JAX function is an SPMD body run once per device; here every rank's
tensors carry the leading rank dims, and ``axis`` is the index of the expert
axis among them (the trainer passes the model dim of (R, D, S, M)):

- rank m's token slice ``x[m*Tl:(m+1)*Tl]`` (``lax.axis_index``) is the
  diagonal over (rank dim, slice index);
- the exchanges go through ``comm.algos.inline_alltoall`` with the model
  group and the config, where the selection table may route the float32
  combine exchange through kernel B6 (``pallas_a2a``); without a group they
  are the plain transpose of the expert axis with the chunk dim;
- the all-gather reassembles the output over the expert axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.ops.mxu import mxu_einsum


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int,
                    std: float = 0.02) -> Dict:
    """Random expert weights from ``generator`` (float32 CPU tensors): the
    gate ``wg`` (d_model, E), replicated, and ``w1`` (E, d_model, d_ff),
    ``w2`` (E, d_ff, d_model), sharded on dim 0 over the expert axis."""
    def normal(*shape):
        return torch.randn(shape, generator=generator) * std

    return {"wg": normal(d_model, n_experts), "w1": normal(n_experts, d_model, d_ff),
            "w2": normal(n_experts, d_ff, d_model)}


def _route(x: torch.Tensor, wg: torch.Tensor, n_experts: int, capacity: int, top_k: int = 1):
    """x (..., T, D), wg (..., D, E) -> (dispatch (..., T, E, C), combine
    (..., T, E, C), aux (...)), float32.

    top_k=1 is switch routing (the raw probability gates the output);
    top_k=2 renormalises the two gates over the pair. Capacity positions are
    assigned choice-major (every first choice queues before any second one),
    so over-capacity drops hit second choices first."""
    probs = torch.softmax(x.float() @ wg.float(), dim=-1)            # (..., T, E)
    topv, topi = torch.topk(probs, top_k, dim=-1)
    gates = topv if top_k == 1 else topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    slots = torch.arange(capacity, device=x.device)
    dispatch = combine = 0.0
    taken = 0.0                       # running per-expert queue length, across choices
    for c in range(top_k):
        onehot = F.one_hot(topi[..., c], n_experts).float()          # (..., T, E)
        if c == 0:
            first = onehot
        pos = (torch.cumsum(onehot, dim=-2) - 1.0) * onehot + taken * onehot
        keep = (pos < capacity).float() * onehot
        # one_hot(pos, capacity): all zeros for a position past capacity
        d_c = keep[..., None] * (pos.long()[..., None] == slots).float()
        dispatch = dispatch + d_c
        combine = combine + d_c * gates[..., c, None, None]
        taken = taken + onehot.sum(dim=-2, keepdim=True)
    # load-balancing auxiliary loss on the first choice (switch/GShard)
    aux = n_experts * (first.mean(dim=-2) * probs.mean(dim=-2)).sum(dim=-1)
    return dispatch, combine, aux


def _expert_ffn(buf: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                compute_dtype=torch.float32) -> torch.Tensor:
    """buf (..., El, C, D) against this rank's experts w1 (El, D, F) and w2
    (El, F, D), each with the leading rank dims of buf's (any dims between
    them and El broadcast). The products take ``compute_dtype`` operands and
    give float32 (``ops.mxu.mxu_einsum``: bf16 tensor cores on the card)."""
    lead = w1.dim() - 3
    extra = buf.dim() - 3 - lead
    view = lambda w: w.view(*w.shape[:lead], *([1] * extra), *w.shape[lead:])  # noqa: E731
    h = F.gelu(mxu_einsum("...ecd,...edf->...ecf", buf.to(compute_dtype),
                          view(w1).to(compute_dtype)), approximate="tanh")
    return mxu_einsum("...ecf,...efd->...ecd", h.to(compute_dtype), view(w2).to(compute_dtype))


def _diagonal(x: torch.Tensor, axis: int, ep: int) -> torch.Tensor:
    """x (*ranks, T, D) -> (*ranks, T/ep, D): rank m along ``axis`` keeps
    token slice m."""
    nr = x.dim() - 2
    t, d = x.shape[nr:]
    x5 = x.reshape(*x.shape[:nr], ep, t // ep, d)
    return torch.diagonal(x5, dim1=axis, dim2=nr).movedim(-1, axis)


def _exchange(x: torch.Tensor, axis: int, group, config) -> torch.Tensor:
    """The all-to-all of (*ranks, ep, ...) over the expert axis: rank j
    receives chunk j of every rank, in rank order."""
    if group is not None:
        from mlsl_tpu_torch.comm import algos

        return algos.inline_alltoall(x, group, config=config)
    return x.transpose(axis, x.dim() - 4)


def _gather(x: torch.Tensor, axis: int, ep: int, group) -> torch.Tensor:
    """(*ranks, Tl, D) -> (*ranks, ep*Tl, D): every rank along ``axis``
    receives the slices of all, in rank order."""
    if group is not None:
        from mlsl_tpu_torch.comm import algos

        return algos.inline_allgather(x, group)
    nr = x.dim() - 2
    tl, d = x.shape[nr:]
    y = x.movedim(axis, nr - 1).reshape(*x.shape[:axis], *x.shape[axis + 1:nr], 1, ep * tl, d)
    return y.movedim(nr - 1, axis).expand(*x.shape[:nr], ep * tl, d)


def moe_ffn(x: torch.Tensor, params: Dict, axis: int, ep: int,
            capacity_factor: float = 1.25, top_k: int = 1, compute_dtype=torch.float32,
            group=None, config=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel MoE feed-forward of every rank at once.

    x: (*ranks, T, D) tokens, the same on every rank along ``axis`` (the
    transformer's post-sum residual stream). params: this rank's leaves with
    the leading rank dims, ``wg`` (*ranks, D, E) replicated, ``w1`` /``w2``
    (*ranks, El, ...) its shard of El = E/ep experts. ``group`` / ``config``:
    the expert-axis ProcessGroup of the (R, D, S, M) grid and the Config,
    when the caller has them (HybridTrainer passes its model group); with
    both the exchanges go through the selection table. -> (out (*ranks, T,
    D) float32, the same on every rank along ``axis``; aux (*ranks), the
    aux loss of the rank's slice)."""
    nr = x.dim() - 2
    t, d = x.shape[nr:]
    el = params["w1"].shape[nr]
    n_experts = el * ep
    if ep == 1:
        return _moe_slice(x, params, n_experts, capacity_factor, top_k, compute_dtype)
    mlsl_assert(t % ep == 0, "moe_ffn: token count %d not divisible by ep=%d (trailing "
                             "tokens would be silently dropped)", t, ep)
    mlsl_assert(x.shape[axis] == ep, "moe_ffn: rank dim %d has %d ranks, not ep=%d", axis,
                x.shape[axis], ep)
    tl = t // ep
    xs = _diagonal(x, axis, ep)                                       # (*ranks, Tl, D)
    capacity = max(1, int(tl * capacity_factor * top_k / n_experts))
    dispatch, combine, aux = _route(xs, params["wg"], n_experts, capacity, top_k)
    buf = torch.einsum("...tec,...td->...ecd", dispatch, xs.float())
    # the compute dtype on the wire: the experts downcast anyway (the return
    # exchange stays float32, combine consumes it in float32)
    buf = buf.reshape(*buf.shape[:nr], ep, el, capacity, d).to(compute_dtype)
    recv = _exchange(buf, axis, group, config)
    y = _expert_ffn(recv, params["w1"], params["w2"], compute_dtype)  # (*ranks, ep, El, C, D)
    back = _exchange(y, axis, group, config)
    y_full = back.reshape(*back.shape[:nr], n_experts, capacity, d)
    out_slice = torch.einsum("...tec,...ecd->...td", combine, y_full)  # (*ranks, Tl, D)
    return _gather(out_slice, axis, ep, group), aux


def _moe_slice(xs: torch.Tensor, params: Dict, n_experts: int, capacity_factor: float,
               top_k: int = 1, compute_dtype=torch.float32):
    capacity = max(1, int(xs.shape[-2] * capacity_factor * top_k / n_experts))
    dispatch, combine, aux = _route(xs, params["wg"], n_experts, capacity, top_k)
    buf = torch.einsum("...tec,...td->...ecd", dispatch, xs.float())
    y = _expert_ffn(buf, params["w1"], params["w2"], compute_dtype)
    return torch.einsum("...tec,...ecd->...td", combine, y), aux


def moe_ffn_dense(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  ep: int = 1, capacity_factor: float = 1.25, top_k: int = 1):
    """The single-device oracle of the sharded semantics: x (T, D), w1 (E, D,
    F); tokens route in ep independent slices (capacity competes per slice).
    -> (out (T, D), the mean of the slices' aux losses)."""
    e = w1.shape[0]
    params = {"wg": wg, "w1": w1, "w2": w2}
    tl = x.shape[0] // ep
    outs, auxes = zip(*(_moe_slice(x[s * tl:(s + 1) * tl], params, e, capacity_factor, top_k)
                        for s in range(ep)))
    return torch.cat(outs, dim=0), torch.stack(auxes).mean()
