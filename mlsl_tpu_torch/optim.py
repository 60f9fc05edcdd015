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

``chain`` of elementwise transforms is elementwise too. Transforms that need
the parameters' shapes or values take trees:
``TreeTransform`` is ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)`` over lists of tensors (a layer's leaves in JAX
leaf order), optax's own signature, which the JAX trainer's plain path hands
the whole parameter tree. ``adamw`` (Adam with a masked weight decay),
``clip_by_global_norm`` (which reads every layer: ``whole_tree``), a
``chain`` holding either, and ``adafactor`` are tree transforms;
``adafactor`` is ``optax.adafactor``'s chain
(``scale_by_factored_rms`` -> ``clip_by_block_rms`` -> learning rate ->
``scale_by_param_block_rms`` -> momentum EMA -> weight decay -> sign).

``ShardedAdafactor`` (``mlsl_tpu/optim.py:103-489``) is the Adafactor
config every ``DataParallelTrainer`` path takes: the plain path runs
``as_transform()``; the distributed update (ZeRO-1) runs the cross-shard form
below with the same numerics. Each rank's owned shard of a layer's padded
flat gradient carries per-element row, column and leaf indices
(``build_adafactor_layout``, ``_shard_ids``); each step the owned shards'
squared gradients are segment-summed (``scatter_add_``) into partial row and
column statistics and summed over the gradient group, which completes them.
The EMA'd ``v_row``/``v_col`` stay replicated (tiny); the elementwise state
(the unfactored leaves' ``v``, the momentum) stays owned-shard only. The
per-leaf block quantities (the RMS clip, the parameter scale) are assembled
the same way.

``gather_owned_full`` and ``place_owned_vector`` (``mlsl_tpu/optim.py:
55-102``) move a ZeRO-1 owned-shard state between world sizes: the drain
all-gather of every rank's shard into the padded flat vector, and its
re-partition over another topology's ownership chunks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mlsl_tpu_torch.log import mlsl_assert

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
        updates, state = _adam_direction(g, state, b1, b2, eps, eps_root)
        return updates.mul_(-lr), state

    return Transform(init, update)


def _adam_direction(g, state: AdamState, b1, b2, eps, eps_root):
    """optax's ``scale_by_adam``: mu_hat / (sqrt(nu_hat + eps_root) + eps)
    and the new state. mu and nu are updated in place (the reference donates
    its state); every product rounds on its own before the add, as out of
    place."""
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
    return updates.div_(t), AdamState(count, mu, nu)


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


def keep_in_place(old, new):
    """A transform's new state written into the old state's tensors, where it
    gave new ones (Adam's count): -> the old state, whose storage a captured
    CUDA graph keeps reading and writing. Tensors it updated in place are
    left alone."""
    for o, n in zip(old, new):
        if torch.is_tensor(o) and o is not n:
            o.copy_(n)
    return old


# -- transforms over trees of parameters ------------------------------------------------


class TreeTransform(NamedTuple):
    """``init(params) -> state``, ``update(grads, state, params) -> (updates,
    state)`` over lists of float32 tensors: optax's signature. ``whole_tree``:
    the transform reads every layer's leaves at once (a global norm), so
    ``DataParallelTrainer`` calls it once a step over all layers, not once a
    layer."""

    init: object
    update: object
    whole_tree: bool = False


def _leaf_mask(mask, params) -> List[bool]:
    """optax's ``mask``: None (every leaf), a sequence of bools a leaf, or a
    callable of the leaves returning one."""
    if mask is None:
        return [True] * len(params)
    m = list(mask(params) if callable(mask) else mask)
    mlsl_assert(len(m) == len(params), "mask has %d entries for %d leaves", len(m),
                len(params))
    return [bool(v) for v in m]


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4, mask=None) -> TreeTransform:
    """``optax.adamw(lr, b1, b2, eps, eps_root, weight_decay=..., mask=...)``:
    Adam's direction, plus ``weight_decay * p`` on the leaves the mask
    keeps, times ``-lr`` (``chain(scale_by_adam, add_decayed_weights,
    scale_by_learning_rate)``). ``mask`` is a sequence of bools, one a leaf,
    or a callable of the leaves (a layer's, in ``DataParallelTrainer``)
    returning one. State: ``AdamState`` with lists of per-leaf moments.

    The decay reads the parameters, so this is a tree transform: the
    trainers' ZeRO-1 path, which hands an optimizer each rank's flat owned
    gradient shard and no parameters (a shard also crosses leaf boundaries,
    so no per-leaf mask applies to it), raises MLSLError for it, as the JAX
    package's ZeRO-1 path cannot run ``optax.adamw`` either (it passes no
    parameters, mlsl_tpu/models/train.py:240-275). ``adam`` is its
    elementwise, shardable form."""

    def init(params: Sequence[torch.Tensor], device=None) -> AdamState:
        dev = device if device is not None else (params[0].device if params else None)
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in params],
                         [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in params])

    def update(grads, state: AdamState, params=None):
        mlsl_assert(params is not None, "adamw's weight decay needs the parameters")
        keep = _leaf_mask(mask, params)
        out, count = [], _safe_increment(state.count)
        for g, mu, nu, p, k in zip(grads, state.mu, state.nu, params, keep):
            d, _ = _adam_direction(g.float(), AdamState(state.count, mu, nu), b1, b2, eps,
                                   eps_root)
            if k:
                d.add_(p.float() * weight_decay)
            out.append(d.mul_(-lr))
        return out, AdamState(count, state.mu, state.nu)

    return TreeTransform(init, update)


def clip_by_global_norm(max_norm: float) -> TreeTransform:
    """``optax.clip_by_global_norm(max_norm)``: every leaf scaled by
    ``max_norm / ||grads||`` when the global L2 norm exceeds ``max_norm``.
    It reads every leaf of the tree (``whole_tree``), so it is no
    elementwise transform: under ZeRO-1 use the trainers'
    ``clip_global_norm=``, which sums the owned shards' squares over the
    gradient group."""

    def init(params, device=None):
        return ()

    def update(grads, state, params=None):
        sq = sum((g.float() * g.float()).sum() for g in grads)
        norm = torch.sqrt(sq)
        trigger = norm < max_norm
        return [torch.where(trigger, g, (g / norm) * max_norm) for g in grads], state

    return TreeTransform(init, update, whole_tree=True)


def _lift(t: Transform) -> TreeTransform:
    """An elementwise transform over a tree: one state a leaf."""

    def init(params, device=None):
        return [t.init(tuple(p.shape), device=device if device is not None else p.device)
                for p in params]

    def update(grads, state, params=None):
        out = [t.update(g, s) for g, s in zip(grads, state)]
        return [u for u, _ in out], [s for _, s in out]

    return TreeTransform(init, update)


def chain(*transforms):
    """``optax.chain``: the transforms in turn, each on the previous one's
    updates. Of elementwise transforms only (``adam``, ``sgd``, ``chain``s of
    them) it is elementwise itself, a ``Transform`` over one tensor that
    every path takes, ZeRO-1 and ``HybridTrainer`` included; with a tree
    transform among them (``clip_by_global_norm``, ``adamw``, ``adafactor``)
    it is a ``TreeTransform``, the elementwise members lifted to one state a
    leaf, and ``whole_tree`` when any member is."""
    mlsl_assert(len(transforms) > 0, "chain needs at least one transform")
    for t in transforms:
        mlsl_assert(isinstance(t, (Transform, TreeTransform)),
                    "chain takes transforms of mlsl_tpu_torch.optim, got %r", type(t))
    if all(isinstance(t, Transform) for t in transforms):
        def init(shape: Shape, device=None):
            return tuple(t.init(shape, device=device) for t in transforms)

        def update(g, state):
            new = []
            for t, s in zip(transforms, state):
                g, s = t.update(g, s)
                new.append(s)
            return g, tuple(new)

        return Transform(init, update)
    trees = [t if isinstance(t, TreeTransform) else _lift(t) for t in transforms]

    def tree_init(params, device=None):
        return tuple(t.init(params, device=device) for t in trees)

    def tree_update(grads, state, params=None):
        new = []
        for t, s in zip(trees, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)

    return TreeTransform(tree_init, tree_update, whole_tree=any(t.whole_tree for t in trees))


class FactoredState(NamedTuple):
    """optax's ``FactoredState`` per leaf (the count shared), and the trace of
    the momentum EMA (``EmaState.ema``) or None."""

    count: torch.Tensor
    v_row: List[torch.Tensor]
    v_col: List[torch.Tensor]
    v: List[torch.Tensor]
    m: Optional[List[torch.Tensor]]


def _factored_dims(shape, min_dim_size_to_factor: int):
    """The two largest axes to factor over, or None (optax's rule exactly:
    optax/_src/factorized.py ``_factored_dims``)."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """optax ``numerics.safe_increment``: clamp before the +1 can wrap."""
    limit = torch.iinfo(torch.int32).max
    return torch.where(count < limit, count + 1, count)


def _decay(count: torch.Tensor, decay_offset: int, decay_rate: float) -> torch.Tensor:
    """Adafactor's second-moment decay 1 - (step + 1) ** -decay_rate, float32."""
    t = (count - decay_offset + 1).to(torch.float32)
    return 1.0 - torch.pow(t, -decay_rate)


def adafactor(learning_rate: float, min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
              decay_offset: int = 0, multiply_by_parameter_scale: bool = True,
              clipping_threshold: Optional[float] = 1.0, momentum: Optional[float] = None,
              weight_decay_rate: Optional[float] = None, eps: float = 1e-30) -> TreeTransform:
    """``optax.adafactor(...)`` with ``factored=True``, replicated: every
    leaf's factored row and column statistics, or its elementwise moment."""

    def init(params: Sequence[torch.Tensor], device=None) -> FactoredState:
        dev = device if device is not None else (params[0].device if params else None)
        one = lambda: torch.zeros(1, dtype=torch.float32, device=dev)   # noqa: E731
        v_row, v_col, v = [], [], []
        for p in params:
            fd = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            if fd is None:
                v_row.append(one())
                v_col.append(one())
                v.append(torch.zeros(p.shape, dtype=torch.float32, device=dev))
            else:
                d1, d0 = fd
                shape = list(p.shape)
                v_row.append(torch.zeros(shape[:d0] + shape[d0 + 1:], device=dev))
                v_col.append(torch.zeros(shape[:d1] + shape[d1 + 1:], device=dev))
                v.append(one())
        m = None if momentum is None else [torch.zeros(p.shape, device=dev) for p in params]
        return FactoredState(torch.zeros((), dtype=torch.int32, device=dev), v_row, v_col, v, m)

    def update(grads, state: FactoredState, params):
        beta = _decay(state.count, decay_offset, decay_rate)
        out, v_row, v_col, v, m = [], [], [], [], []
        for i, (g, p) in enumerate(zip(grads, params)):
            g = g.float()
            gsq = g * g + eps
            fd = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            if fd is not None:
                d1, d0 = fd
                vr = beta * state.v_row[i] + (1.0 - beta) * gsq.mean(dim=d0)
                vc = beta * state.v_col[i] + (1.0 - beta) * gsq.mean(dim=d1)
                rd1 = d1 - 1 if d1 > d0 else d1
                row_factor = (vr / vr.mean(dim=rd1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
                v_row.append(vr)
                v_col.append(vc)
                v.append(state.v[i])
            else:
                vv = beta * state.v[i] + (1.0 - beta) * gsq
                u = g * vv ** -0.5
                v_row.append(state.v_row[i])
                v_col.append(state.v_col[i])
                v.append(vv)
            if clipping_threshold is not None:
                u = u / torch.clamp(torch.sqrt((u * u).mean()) / clipping_threshold, min=1.0)
            u = u * learning_rate
            if multiply_by_parameter_scale:
                u = u * torch.clamp(torch.sqrt((p.float() ** 2).mean()), min=1e-3)
            if momentum is not None:
                u = (1.0 - momentum) * u + momentum * state.m[i]
                m.append(u)
            if weight_decay_rate is not None:
                u = u + weight_decay_rate * p.float()
            out.append(-u)
        return out, FactoredState(_safe_increment(state.count), v_row, v_col, v,
                                  m if momentum is not None else None)

    return TreeTransform(init, update)


@dataclasses.dataclass(frozen=True)
class ShardedAdafactor:
    """The Adafactor config every ``DataParallelTrainer`` path takes
    (``mlsl_tpu.optim.ShardedAdafactor``): the plain path runs
    ``as_transform()``, the distributed update the cross-shard form with the
    same numerics."""

    learning_rate: float
    min_dim_size_to_factor: int = 128
    decay_rate: float = 0.8
    decay_offset: int = 0
    multiply_by_parameter_scale: bool = True
    clipping_threshold: Optional[float] = 1.0
    momentum: Optional[float] = None
    weight_decay_rate: Optional[float] = None
    eps: float = 1e-30

    def as_transform(self) -> TreeTransform:
        return adafactor(**dataclasses.asdict(self))


def build_adafactor_layout(leaf_shapes, padded_count: int, data_size: int,
                           min_dim_size_to_factor: int) -> dict:
    """The host-side index layout of one layer's padded flat gradient
    (``mlsl_tpu/optim.py`` ``build_adafactor_layout``, the same arrays):
    per-element row, column and leaf indices over the full padded layout, the
    factored and padding masks, and the small per-state vectors. The LAST slot
    of each state and divisor vector is a dummy (factor 1, divisor 1) that
    padding and the elements a state does not cover address."""
    count = int(sum(int(np.prod(s)) for s in leaf_shapes))
    mlsl_assert(padded_count % data_size == 0,
                "padded count %d not divisible by data size %d", padded_count, data_size)
    row_ids, col_ids, leaf_ids, fact_mask = [], [], [], []
    row_divs, col_divs, rowmean_ids, leaf_sizes = [], [], [], []
    n_row = n_col = 0
    for li, shape in enumerate(leaf_shapes):
        shape = tuple(int(d) for d in shape)
        sz = int(np.prod(shape)) if shape else 1
        leaf_sizes.append(sz)
        fd = _factored_dims(shape, min_dim_size_to_factor)
        if fd is None:
            row_ids.append(np.full(sz, -1, np.int64))
            col_ids.append(np.full(sz, -1, np.int64))
            fact_mask.append(np.zeros(sz, np.float32))
        else:
            d1, d0 = fd
            nd = len(shape)
            grids = np.indices(shape)
            r_shape = tuple(np.delete(shape, d0))
            c_shape = tuple(np.delete(shape, d1))
            r_coords = [grids[a] for a in range(nd) if a != d0]
            c_coords = [grids[a] for a in range(nd) if a != d1]
            row_ids.append(np.ravel_multi_index(r_coords, r_shape).reshape(-1) + n_row)
            col_ids.append(np.ravel_multi_index(c_coords, c_shape).reshape(-1) + n_col)
            fact_mask.append(np.ones(sz, np.float32))
            # each v_row entry's mean group (optax: the mean over axis
            # reduced_d1 of the d0-reduced tensor), and the reduction sizes
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            rm_shape = tuple(np.delete(r_shape, reduced_d1))
            base = max(rowmean_ids[-1]) + 1 if rowmean_ids else 0
            if rm_shape:
                rg = np.indices(r_shape)
                rm_coords = [rg[a] for a in range(len(r_shape)) if a != reduced_d1]
                rowmean_ids.append(np.ravel_multi_index(rm_coords, rm_shape).reshape(-1) + base)
            else:
                rowmean_ids.append(np.zeros(int(np.prod(r_shape)), np.int64) + base)
            row_divs.append(np.full(int(np.prod(r_shape)), shape[d0], np.float32))
            col_divs.append(np.full(int(np.prod(c_shape)), shape[d1], np.float32))
            n_row += int(np.prod(r_shape))
            n_col += int(np.prod(c_shape))
        leaf_ids.append(np.full(sz, li, np.int64))

    n_leaf = len(leaf_shapes)
    pad = padded_count - count
    row_full = np.concatenate(row_ids + [np.full(pad, -1, np.int64)])
    col_full = np.concatenate(col_ids + [np.full(pad, -1, np.int64)])
    leaf_full = np.concatenate(leaf_ids + [np.full(pad, n_leaf, np.int64)])
    fact_full = np.concatenate(fact_mask + [np.zeros(pad, np.float32)])
    # a fully factored layer needs no elementwise moment: v stays a (1,)
    # dummy, keeping Adafactor's sublinear state memory
    has_elementwise = bool((fact_full[:count] == 0).any()) if count else False
    row_full = np.where(row_full < 0, n_row, row_full)
    col_full = np.where(col_full < 0, n_col, col_full)
    rowmean = np.concatenate(rowmean_ids) if rowmean_ids else np.zeros(0, np.int64)
    n_rowmean = int(rowmean.max()) + 1 if rowmean.size else 0
    return {
        "count": count,
        "has_elementwise": has_elementwise,
        "n_row": n_row,
        "n_col": n_col,
        "n_leaf": n_leaf,
        "n_rowmean": n_rowmean,
        "row_ids": row_full.astype(np.int32),
        "col_ids": col_full.astype(np.int32),
        "leaf_ids": leaf_full.astype(np.int32),
        "fact_mask": fact_full,
        "pad_mask": np.concatenate([np.ones(count, np.float32), np.zeros(pad, np.float32)]),
        "row_div": (np.concatenate(row_divs + [np.ones(1, np.float32)]) if row_divs
                    else np.ones(1, np.float32)),
        "col_div": (np.concatenate(col_divs + [np.ones(1, np.float32)]) if col_divs
                    else np.ones(1, np.float32)),
        "rowmean_ids": rowmean.astype(np.int32),
        "rowmean_div": (np.bincount(rowmean, minlength=n_rowmean).astype(np.float32)
                        if n_rowmean else np.ones(0, np.float32)),
        "leaf_sizes": np.asarray(leaf_sizes + [1], np.float32),
    }


def _shard_ids(topo, layout: dict, data_size: int, device=None) -> Dict[str, torch.Tensor]:
    """Each rank's owned slice of the per-element index vectors, as
    (R, D, S, M, k) tensors (grad-group rank r owns contiguous chunk r). The
    ownership chunks follow the DATA axis only, so replica, seq and model must
    be 1: under seq > 1 the chunk would follow the data x seq group, under
    model > 1 the leaf index vectors differ per model shard."""
    r, d, s, m = topo.grid_shape
    mlsl_assert(r == 1 and s == 1 and m == 1 and d == data_size,
                "ShardedAdafactor's factored-stats layout supports a pure data-parallel "
                "grid (replica=seq=model=1); got grid (%d,%d,%d,%d) with data_size=%d",
                r, d, s, m, data_size)
    k = layout["row_ids"].shape[0] // data_size

    def buf(vec, dtype):
        t = torch.from_numpy(np.ascontiguousarray(vec.reshape(1, data_size, 1, 1, k)))
        return t.to(device=device, dtype=dtype)

    return {"row_ids": buf(layout["row_ids"], torch.int64),
            "col_ids": buf(layout["col_ids"], torch.int64),
            "leaf_ids": buf(layout["leaf_ids"], torch.int64),
            "fact_mask": buf(layout["fact_mask"], torch.float32),
            "pad_mask": buf(layout["pad_mask"], torch.float32)}


def init_adafactor_state(topo, layout: dict, cfg: ShardedAdafactor, data_size: int,
                         device=None) -> Dict[str, torch.Tensor]:
    """The ZeRO-1 state of one layer, (R, D, S, M, n) tensors as the JAX
    trainer's distributed buffers: the count, the replicated factored
    vectors (with their dummy slot), the owned-shard elementwise moment (a (1,)
    dummy for a fully factored layer) and, with momentum, the owned trace."""
    grid = topo.grid_shape
    k = layout["row_ids"].shape[0] // data_size

    def zeros(n, dtype=torch.float32):
        return torch.zeros((*grid, n), dtype=dtype, device=device)

    state = {"count": zeros(1, torch.int32), "v_row": zeros(layout["n_row"] + 1),
             "v_col": zeros(layout["n_col"] + 1),
             "v": zeros(k if layout["has_elementwise"] else 1)}
    if cfg.momentum is not None:
        state["m"] = zeros(k)
    return state


def _group_sum(x: torch.Tensor) -> torch.Tensor:
    """``lax.psum`` over the gradient group (data x seq): the sum over the D and
    S dims on every member."""
    return x.sum(dim=(1, 2), keepdim=True).expand_as(x)


def build_adafactor_inc_fn(topo, cfg: ShardedAdafactor, layout: dict, data_size: int,
                           device=None):
    """-> fn(owned gradient (R, D, S, M, k), state, the layer's replicated
    parameter leaves, scale=1.0) -> (owned increment (R, D, S, M, k), new
    state), every rank's shard at once. The increment is ``optax.adafactor``'s
    update, sign included: the caller adds it (p + inc), as on the SGD and
    Adam distributed paths."""
    ids = _shard_ids(topo, layout, data_size, device)
    n_row, n_col = layout["n_row"], layout["n_col"]
    n_leaf, n_rowmean = layout["n_leaf"], layout["n_rowmean"]
    has_elem = layout["has_elementwise"]
    padded = layout["row_ids"].shape[0]
    k = padded // data_size

    def vec(name):
        return torch.from_numpy(layout[name]).to(device)

    row_div, col_div = vec("row_div"), vec("col_div")
    rowmean_ids = vec("rowmean_ids").long()
    rowmean_div, leaf_sizes = vec("rowmean_div"), vec("leaf_sizes")
    row_ids, col_ids, leaf_ids = ids["row_ids"], ids["col_ids"], ids["leaf_ids"]
    fact_mask, pad_mask = ids["fact_mask"], ids["pad_mask"]

    def segment_sum(x, seg, n):
        """(R, D, S, M, k) values summed into n segments per rank."""
        out = torch.zeros((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
        return out.scatter_add_(-1, seg.expand_as(x), x)

    def take(table, seg):
        """table (R, D, S, M, n) gathered at seg (1, D, 1, 1, k) per rank."""
        return torch.gather(table, -1, seg.expand(*table.shape[:-1], seg.shape[-1]))

    def fn(g, state, leaves, scale=1.0):
        g = scale * g / data_size
        beta = _decay(state["count"], cfg.decay_offset, cfg.decay_rate)     # (*grid, 1)
        gsq = g * g + cfg.eps
        # the factored second moments: owned partial sums, then the group sum
        row_sums = _group_sum(segment_sum(gsq * fact_mask, row_ids, n_row + 1))
        col_sums = _group_sum(segment_sum(gsq * fact_mask, col_ids, n_col + 1))
        v_row = beta * state["v_row"] + (1.0 - beta) * row_sums / row_div
        v_col = beta * state["v_col"] + (1.0 - beta) * col_sums / col_div
        grid = g.shape[:-1]
        one = torch.ones((*grid, 1), dtype=torch.float32, device=g.device)
        if n_rowmean:
            rm = segment_sum(v_row[..., :n_row], rowmean_ids.expand(*grid, n_row),
                             n_rowmean) / rowmean_div
            row_factor = (v_row[..., :n_row] / torch.gather(
                rm, -1, rowmean_ids.expand(*grid, n_row))) ** -0.5
            row_factor = torch.cat([row_factor, one], dim=-1)
        else:
            row_factor = one
        col_factor = torch.cat([v_col[..., :n_col] ** -0.5, one], dim=-1)
        u = g * take(row_factor, row_ids) * take(col_factor, col_ids)
        # the unfactored leaves' elementwise moment (owned shard only)
        if has_elem:
            v_new = beta * state["v"] + (1.0 - beta) * gsq
            u = torch.where(fact_mask > 0, u, g * v_new ** -0.5) * pad_mask
        else:
            v_new = state["v"]
            u = u * pad_mask
        if cfg.clipping_threshold is not None:
            leaf_sq = _group_sum(segment_sum(u * u, leaf_ids, n_leaf + 1))
            denom = torch.clamp(torch.sqrt(leaf_sq / leaf_sizes) / cfg.clipping_threshold,
                                min=1.0)
            u = u / take(denom, leaf_ids)
        u = u * cfg.learning_rate
        if cfg.multiply_by_parameter_scale:
            p_rms = torch.stack([torch.clamp(torch.sqrt((p.float() ** 2).mean()), min=1e-3)
                                 for p in leaves] + [one.new_ones(())])
            u = u * p_rms[leaf_ids]
        new = {"count": _safe_increment(state["count"]), "v_row": v_row, "v_col": v_col,
               "v": v_new}
        if cfg.momentum is not None:
            u = cfg.momentum * state["m"] + (1.0 - cfg.momentum) * u
            new["m"] = u
        if cfg.weight_decay_rate is not None:
            flat = torch.cat([p.detach().reshape(-1).float() for p in leaves])
            flat = torch.nn.functional.pad(flat, (0, padded - flat.numel()))
            u = u + cfg.weight_decay_rate * flat.view(1, data_size, 1, 1, k)
        return -u, new

    return fn


# -- the owned-state reshard (elastic shrink and grow) -------------------------------------


def gather_owned_full(topo, buf: torch.Tensor, grad_axes=("data", "seq")) -> np.ndarray:
    """All-gather a ZeRO-1 owned-shard buffer (R, D, S, M, k) over the
    ``grad_axes`` group into the padded flat (G * k,) host vector: the drain
    collective of an elastic reshard. Grad-group rank r owns contiguous chunk
    r, so the member-ordered concatenation is the padded flat layout. The
    gather runs through ``algos.inline_allgather`` with the Environment's
    config (None before ``init``: the plain gather): B3-AG on the card where
    its table routes the group's reduce_scatter to the fused ring."""
    from mlsl_tpu_torch.comm import algos
    from mlsl_tpu_torch.comm.mesh import ProcessGroup
    from mlsl_tpu_torch.core.environment import get_env

    group = ProcessGroup(topo, tuple(a for a in grad_axes if topo.axis_size(a) > 1))
    out = algos.inline_allgather(buf.detach(), group, config=get_env().config)
    return out[0, 0, 0, 0].cpu().numpy().copy()


def place_owned_vector(new_topo, vec: np.ndarray, count: int, padded_new: int, d_new: int,
                       device=None) -> torch.Tensor:
    """Re-partition a full flat state vector onto another topology's ZeRO-1
    ownership chunks: truncate the old padding to ``count``, pad to the new
    world's ``padded_new`` and split ``d_new`` equal chunks over the data axis
    -> a (1, d_new, 1, 1, padded_new / d_new) tensor on ``device``: the write
    half of an elastic reshard."""
    from mlsl_tpu_torch.core.environment import default_device

    mlsl_assert(padded_new % d_new == 0 and padded_new >= count,
                "reshard target geometry invalid: padded %d vs d=%d, count=%d",
                padded_new, d_new, count)
    grid = new_topo.grid_shape
    mlsl_assert(grid == (1, d_new, 1, 1),
                "elastic ZeRO-1 reshard supports a pure data-parallel grid "
                "(replica=seq=model=1); got %s", grid)
    flat = np.asarray(vec).reshape(-1)[:count]
    flat = np.pad(flat, (0, padded_new - count))
    chunks = np.ascontiguousarray(flat.reshape(1, d_new, 1, 1, padded_new // d_new))
    return torch.from_numpy(chunks).to(default_device() if device is None else device)
