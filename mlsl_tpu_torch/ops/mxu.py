"""Matrix products with bf16 operands and a float32 result.

Counterpart of ``mlsl_tpu.models.moe.mxu_einsum`` (moe.py:79-88): on the TPU
``jnp.einsum(..., preferred_element_type=jnp.float32)`` runs bf16 operands on
the matrix unit and returns its float32 sum. The port keeps that contract:

- both operands bf16 on the card: one batched product on the bf16 tensor
  cores with float32 accumulation and a float32 result
  (``torch.bmm(a, b, out_dtype=torch.float32)``, the ``aten::bmm.dtype``
  overload). A PyTorch bf16 product returns bf16, rounding the float32 sum
  once more, so ``out_dtype`` is what keeps the contract. A CUDA bf16
  operand is never upcast.
- both operands bf16 on the CPU (the plain version): the operands are
  upcast and multiplied in float32. A bf16 x bf16 product is exact in
  float32, so the card and the plain version differ only in the order in
  which the float32 products are summed.
- one operand bf16 and the other not: on the card this raises
  ``MLSLError`` (no silent float32 product of a bf16 operand); on the CPU
  or with ``plain`` the float32 einsum of the upcast operands.
- any other operand types (the float32 exactness configurations): the
  exact float32 einsum, as before.

The backward follows JAX's vjp of the einsum on bf16 operands
(``jax.make_jaxpr(jax.grad(...))``): each cotangent product is
``dot_general(ct, operand, preferred_element_type=f32)`` on the float32
cotangent rounded once to bf16, then the result is cast to the operand's
dtype. Here the cotangent is rounded to bf16 once, both products run as the
forward does (tensor cores on the card, float32 on the CPU), and each
gradient is cast to its operand's dtype.

Each einsum spec ``...A,...W->...O`` is lowered onto one
``(batch, m, k) x (batch, k, n) -> (batch, m, n)`` product with permutes
and reshapes outside the autograd Function, so autograd carries the
gradients back through them. A leading (``...``) dim that both operands
carry is a batch dim; one that only ``a`` carries (size 1 in ``w``, as the
expert weights' broadcast dims) joins m, and one that only ``w`` carries
joins n, so the product itself sums a broadcast weight's gradient over it,
in float32, before the one cast. A spec that cannot be lowered so raises
``MLSLError``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from mlsl_tpu_torch.log import MLSLError, MLSLKernelError

# calls of the tensor-core route (both operands bf16 on the card), forward
# and backward products each; a count of library calls, not of a kernel
# written here
CALLS = {"mxu_bf16_fwd": 0, "mxu_bf16_bwd": 0}


def reset_counts() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _bmm_f32(a: torch.Tensor, b: torch.Tensor, plain: bool) -> torch.Tensor:
    """(B, m, k) x (B, k, n) bf16 -> (B, m, n) float32: the tensor cores on
    the card, the upcast float32 product on the CPU or when ``plain``."""
    if a.device.type == "cuda" and not plain:
        return torch.bmm(a, b, out_dtype=torch.float32)
    if a.device.type not in ("cpu", "cuda"):
        raise MLSLKernelError(f"mxu_einsum: unsupported device {a.device}")
    return torch.bmm(a.float(), b.float())


class _Bf16Bmm(torch.autograd.Function):
    """(B, m, k) x (B, k, n) bf16 -> (B, m, n) float32, with JAX's vjp."""

    @staticmethod
    def forward(ctx, a, b, plain):
        ctx.save_for_backward(a, b)
        ctx.plain = plain
        if a.is_cuda and not plain:
            CALLS["mxu_bf16_fwd"] += 1
        return _bmm_f32(a, b, plain)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)          # the cotangent, rounded once
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _bmm_f32(g16, b.transpose(1, 2), ctx.plain).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _bmm_f32(a.transpose(1, 2), g16, ctx.plain).to(b.dtype)
        if a.is_cuda and not ctx.plain:
            CALLS["mxu_bf16_bwd"] += int(ga is not None) + int(gb is not None)
        return ga, gb, None


def _parse(spec: str) -> Tuple[str, str, str]:
    """'...A,...W->...O' -> (A, W, O), each a string of distinct letters."""
    try:
        lhs, out = spec.replace(" ", "").split("->")
        ta, tw = lhs.split(",")
    except ValueError:
        raise MLSLError(f"mxu_einsum cannot lower {spec!r}: not '...A,...W->...O'") from None
    terms = (ta, tw, out)
    if not all(t.startswith("...") for t in terms):
        raise MLSLError(f"mxu_einsum cannot lower {spec!r}: every term must start with '...'")
    a, w, o = (t[3:] for t in terms)
    for t in (a, w, o):
        if not t.isalpha() or len(set(t)) != len(t):
            raise MLSLError(f"mxu_einsum cannot lower {spec!r}: repeated or non-letter "
                            f"subscripts")
    if set(o) - set(a) - set(w) or (set(a) ^ set(w)) - set(o):
        raise MLSLError(f"mxu_einsum cannot lower {spec!r}: a subscript of one operand "
                        f"alone must be in the output, and every output subscript in an "
                        f"operand")
    return a, w, o


def _lowered(spec: str, terms: Tuple[str, str, str], a: torch.Tensor, w: torch.Tensor,
             plain: bool) -> torch.Tensor:
    sa, sw, so = terms
    na, nw = a.dim() - len(sa), w.dim() - len(sw)
    if na < 0 or nw < 0:
        raise MLSLError(f"mxu_einsum {spec!r}: operands of {a.dim()} and {w.dim()} dims")
    lead = max(na, nw)
    a = a.reshape(*([1] * (lead - na)), *a.shape)
    w = w.reshape(*([1] * (lead - nw)), *w.shape)
    # name the leading dims too: 0..lead-1 as integers, the spec's as letters
    dims_a: List = list(range(lead)) + list(sa)
    dims_w: List = list(range(lead)) + list(sw)
    size: Dict = {}
    batch, m_dims, n_dims = [], [], []
    for i in range(lead):
        sa_i, sw_i = a.shape[i], w.shape[i]
        if sa_i == sw_i:
            batch.append(i)
        elif sw_i == 1:
            m_dims.append(i)
        elif sa_i == 1:
            n_dims.append(i)
        else:
            raise MLSLError(f"mxu_einsum {spec!r}: leading dims {tuple(a.shape[:lead])} and "
                            f"{tuple(w.shape[:lead])} do not broadcast")
        size[i] = max(sa_i, sw_i)
    for c in sa:
        size[c] = a.shape[dims_a.index(c)]
    for c in sw:
        if c in size and size[c] != w.shape[dims_w.index(c)]:
            raise MLSLError(f"mxu_einsum {spec!r}: subscript {c!r} has sizes {size[c]} and "
                            f"{w.shape[dims_w.index(c)]}")
        size[c] = w.shape[dims_w.index(c)]
    batch += [c for c in so if c in sa and c in sw]
    m_dims += [c for c in so if c in sa and c not in sw]
    n_dims += [c for c in so if c in sw and c not in sa]
    k_dims = [c for c in sa if c in sw and c not in so]

    def prod(ds):
        n = 1
        for d in ds:
            n *= size[d]
        return n

    # a leading dim of size 1 in one operand that only the other carries is
    # dropped from the first
    a3 = _take(a, dims_a, batch + m_dims + k_dims, n_dims).reshape(
        prod(batch), prod(m_dims), prod(k_dims))
    w3 = _take(w, dims_w, batch + k_dims + n_dims, m_dims).reshape(
        prod(batch), prod(k_dims), prod(n_dims))
    order = batch + m_dims + n_dims
    y = _Bf16Bmm.apply(a3, w3, plain).reshape([size[d] for d in order])
    return y.permute([order.index(d) for d in list(range(lead)) + list(so)])


def _take(t: torch.Tensor, dims: List, order: List, absent: List) -> torch.Tensor:
    """``t`` (named by ``dims``) permuted into ``order``, its size-1 dims
    named in ``absent`` dropped."""
    keep = [i for i, d in enumerate(dims) if d not in absent]
    t = t.reshape([t.shape[i] for i in keep])
    named = [dims[i] for i in keep]
    return t.permute([named.index(d) for d in order])


def mxu_einsum(spec: str, a: torch.Tensor, b: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Einsum with a float32 result from (possibly) bf16 operands.

    Both operands bf16: the product of the module docstring (bf16 tensor
    cores on the card, the upcast float32 product on the CPU), with JAX's
    vjp. One bf16 operand beside one of another type raises ``MLSLError``
    on the card, where it would silently take a float32 SIMT product.
    Otherwise the float32 einsum of the upcast operands. bf16 x bf16
    products are exact in float32, so the routes differ only in the order
    of the float32 sum. ``plain`` takes the CPU's route (upcast float32
    products, the same vjp) on any device: the card's plain version."""
    terms = _parse(spec)
    bf16 = (a.dtype == torch.bfloat16, b.dtype == torch.bfloat16)
    if all(bf16):
        return _lowered(spec, terms, a, b, plain)
    if any(bf16) and (a.is_cuda or b.is_cuda) and not plain:
        raise MLSLError(f"mxu_einsum {spec!r}: operands {a.dtype} and {b.dtype} on the card; "
                        f"cast both to bfloat16 for the tensor cores")
    return torch.einsum(spec, a.float(), b.float())
