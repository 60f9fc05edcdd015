"""Recursive halving/doubling allreduce and reduce-scatter, composed.

Counterpart of ``mlsl_tpu.comm.algos.rhd`` (reference eplib/allreduce_pr.c).
On the TPU every pairwise exchange is a ``lax.ppermute``; here the members
are a dim of one tensor, so the schedule reduces to the value it computes.
With c = 2**k <= G, r = G - c and ``comb`` the op (SUM, MIN or MAX):

- pre-fold: member j < r combines its buffer with member c + j's
  (``comb(mine, got)``); members r..c-1 keep theirs unchanged;
- halving round t at distance d = c >> (t + 1): each core member combines
  the half it keeps with its partner's; since ``comb`` is commutative the
  pair holds one value, so the tree reads w[j] = comb(w[j], w[j + d]) for
  j < d;
- doubling and the post-fold copy the owner's chunk to every member.

So the f32 results equal the JAX program's bit for bit. The input is padded
with zeros to a multiple of c and the padding stripped again, as there.
reduce_scatter hands member p the slice [p * recv_count, (p + 1) *
recv_count) of the result, the fast exit's placement for 2**k groups and the
dynamic slice's otherwise. Plain PyTorch, not a kernel: the JAX version is
composed of ``lax.ppermute`` programs.

``steps`` is the staged form that the ZeRO-1 update interleaves between
layers: the JAX schedule's phases one by one (pre-fold, k halvings, k
doublings or the reduce_scatter fast exit, post-fold), each as tensor work
over the member dim, with the same result as ``build``.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from mlsl_tpu_torch.comm.collectives import group_unview, group_view
from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.ops.rhd_kernels import _split
from mlsl_tpu_torch.types import ReductionType


def _combine(op: ReductionType):
    if op == ReductionType.MIN:
        return torch.minimum
    if op == ReductionType.MAX:
        return torch.maximum
    return torch.add


def reduce_members(y: torch.Tensor, op=None) -> torch.Tensor:
    """(C, G, n) -> (C, 1, m): the halving tree over the members, m = n
    padded to a multiple of c."""
    comb = _combine(ReductionType(op) if op is not None else ReductionType.SUM)
    g, n = y.shape[1], y.shape[2]
    c, k, r = _split(g)
    m = -(-n // c) * c
    y = torch.nn.functional.pad(y, (0, m - n))
    w = y[:, :c]
    if r:
        w = torch.cat([comb(w[:, :r], y[:, c:]), w[:, r:]], dim=1)
    for t in range(k):
        h = c >> (t + 1)
        w = comb(w[:, :h], w[:, h:2 * h])
    return w


def build(kind: str, group: ProcessGroup, *, op=None, recv_count=None, **_) -> Callable:
    """-> fn: distributed buffer (R, D, S, M, n) -> result buffer."""
    g = group.size
    mlsl_assert(g > 1, "rhd needs a group with >1 member (got %d)", g)
    if kind == "reduce_scatter":
        mlsl_assert(recv_count is not None, "rhd reduce_scatter needs recv_count")

    def fn(buf: torch.Tensor) -> torch.Tensor:
        y = group_view(buf, group)
        c_inst, _, n = y.shape
        w = reduce_members(y, op)
        if kind == "reduce_scatter":
            mlsl_assert(n >= g * recv_count, "reduce_scatter count %d < group %d * "
                        "recv_count %d", n, g, recv_count)
            out = w[:, 0, :g * recv_count].reshape(c_inst, g, recv_count)
        else:
            out = w[..., :n].expand(c_inst, g, n)
        return group_unview(out, group)

    return fn


def steps(kind: str, group: ProcessGroup, n: int, *, op=None,
          recv_count=None) -> Tuple[Callable, List[Callable], Callable]:
    """The staged schedule (``mlsl_tpu.comm.algos.rhd.steps``):
    ``(prep, phases, finish)``. ``prep`` takes the distributed buffer
    (R, D, S, M, n) and the carry is its group view (C, G, L), one row of L
    elements per member; each phase is one exchange round of the JAX
    schedule; ``finish`` returns the result buffer. Member i of the core
    holds after halving round t the chunk its top t+1 position bits select;
    the members past the core hold nothing that is read until the post-fold
    overwrites them."""
    comb = _combine(ReductionType(op) if op is not None else ReductionType.SUM)
    g = group.size
    mlsl_assert(g > 1, "rhd needs a group with >1 member (got %d)", g)
    c, k, r = _split(g)
    m = -(-n // c) * c

    def prep(buf):
        y = group_view(buf, group)
        return torch.nn.functional.pad(y, (0, m - n)) if m != n else y

    phases: List[Callable] = []
    if r:
        def pre_fold(y):
            return torch.cat([comb(y[:, :r], y[:, c:]), y[:, r:]], dim=1)

        phases.append(pre_fold)

    def bits(t, device):
        pos = torch.arange(c, device=device)
        return pos, (pos >> (k - 1 - t)) & 1

    def halving(t):
        def phase(y):
            pos, bit = bits(t, y.device)
            h = y.shape[-1] // 2
            core = y[:, :c].reshape(y.shape[0], c, 2, h)
            mine = core[:, pos, bit]                      # the half member i keeps
            got = core[:, pos ^ (c >> (t + 1)), bit]      # its partner's copy of it
            return torch.cat([comb(mine, got), y[:, c:, :h]], dim=1)

        return phase

    phases.extend(halving(t) for t in range(k))
    if kind == "reduce_scatter" and g == c and recv_count is not None and n == g * recv_count:
        # member i's halving chunk is its slice: no doubling phase
        return prep, phases, lambda y: group_unview(y[..., :recv_count], group)

    def doubling(t):
        def phase(y):
            pos, bit = bits(t, y.device)
            core = y[:, :c]
            got = core[:, pos ^ (c >> (t + 1))]
            lo_first = (bit == 0)[None, :, None]
            new = torch.where(lo_first, torch.cat([core, got], -1), torch.cat([got, core], -1))
            rest = y[:, c:]
            return torch.cat([new, torch.cat([rest, rest], -1)], dim=1)

        return phase

    phases.extend(doubling(t) for t in reversed(range(k)))
    if r:
        def post_fold(y):
            return torch.cat([y[:, :c], y[:, :r]], dim=1)

        phases.append(post_fold)

    if kind == "reduce_scatter":
        mlsl_assert(recv_count is not None, "rhd reduce_scatter needs recv_count")
        mlsl_assert(n >= g * recv_count, "reduce_scatter count %d < group %d * recv_count %d",
                    n, g, recv_count)

        def finish_rs(y):
            idx = torch.arange(g, device=y.device)
            own = y[..., :g * recv_count].reshape(y.shape[0], g, g, recv_count)[:, idx, idx]
            return group_unview(own, group)

        return prep, phases, finish_rs
    return prep, phases, lambda y: group_unview(y[..., :n], group)
