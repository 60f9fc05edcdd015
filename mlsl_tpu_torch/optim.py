"""Elementwise optimizers over flat parameter vectors.

Counterpart of the optax transforms that ``mlsl_tpu.models.train`` takes as
``optimizer=``: each is ``init(shape) -> state`` and ``update(g, state) ->
(updates, state)``, and the caller adds the updates to the parameters
(``optax.apply_updates``). ``shape`` is an element count, or a tensor shape
such as a distributed buffer's (R, D, S, M, owned): the transforms are
elementwise, so under ZeRO-1 one state covers every virtual rank's owned
shard, and all ranks step together (one count for all).

- ``adam`` has the numerics of ``optax.adam`` 0.2.6: ``mu = (1 - b1) * g +
  b1 * mu``, ``nu = (1 - b2) * g**2 + b2 * nu``, bias correction by
  ``1 - b**count`` computed in float32, ``eps`` outside the square root,
  then the update ``-lr * mu_hat / (sqrt(nu_hat + eps_root) + eps)``.
- ``sgd`` is ``-lr * g``, or with ``momentum`` the trace ``t = g +
  momentum * t`` and ``-lr * t`` (``optax.sgd``, no Nesterov).

``update`` writes the moments (``mu``, ``nu``) and the momentum trace into
the tensors of the state it is given and returns them, as the reference's
donated update does: a caller must not read a state after passing it to
``update``. Each product is rounded on its own before its add, so the bits
are those of the out-of-place formula (no fused multiply-add).

``ShardedAdafactor`` (``mlsl_tpu/optim.py:103-489``) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

Shape = Union[int, Tuple[int, ...], torch.Size]


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count (int32, 0-d) and the two
    moments."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


class TraceState(NamedTuple):
    """optax's ``TraceState``; ``trace`` is None without momentum."""

    trace: Optional[torch.Tensor]


class Transform(NamedTuple):
    init: object
    update: object


def _zeros(shape: Shape, device) -> torch.Tensor:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Transform:
    """``optax.adam(lr, b1, b2, eps, eps_root)`` over float32 tensors."""

    def init(shape: Shape, device=None) -> AdamState:
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         _zeros(shape, device), _zeros(shape, device))

    def update(g: torch.Tensor, state: AdamState) -> Tuple[torch.Tensor, AdamState]:
        # mu and nu are updated in place (the reference donates its state);
        # every product rounds on its own before the add, as out of place
        mu, nu = state.mu, state.nu
        t = g * (1 - b1)
        mu.mul_(b1).add_(t)
        torch.mul(g, g, out=t).mul_(1 - b2)
        nu.mul_(b2).add_(t)
        limit = torch.iinfo(torch.int32).max
        count = torch.where(state.count < limit, state.count + 1, state.count)
        c = count.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=g.device)
        torch.div(nu, one - torch.pow(torch.full_like(one, b2), c), out=t)   # nu_hat
        t.add_(eps_root).sqrt_().add_(eps)
        updates = mu / (one - torch.pow(torch.full_like(one, b1), c))       # mu_hat
        updates.div_(t).mul_(-lr)
        return updates, AdamState(count, mu, nu)

    return Transform(init, update)


def sgd(lr: float, momentum: Optional[float] = None) -> Transform:
    """``optax.sgd(lr, momentum)`` over float32 tensors."""

    def init(shape: Shape, device=None) -> TraceState:
        return TraceState(None if momentum is None else _zeros(shape, device))

    def update(g: torch.Tensor, state: TraceState) -> Tuple[torch.Tensor, TraceState]:
        if momentum is None:
            return -lr * g, state
        trace = state.trace.mul_(momentum).add_(g)      # in place: g + momentum * t
        return -lr * trace, TraceState(trace)

    return Transform(init, update)


def state_nbytes(state) -> int:
    """Bytes of the tensors an optimizer state holds."""
    return sum(t.numel() * t.element_size() for t in state if torch.is_tensor(t))
