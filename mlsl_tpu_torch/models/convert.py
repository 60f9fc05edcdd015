"""Parameter trees shared with the JAX package.

The port's models keep every parameter in the JAX package's layout (conv
weights HWIO, dense weights (in, out)) and expose them as a tree of nested
dicts and lists that mirrors the JAX pytree (``Module.jax_tree()``). The flat
order of a tree is ``jax.tree.leaves`` order -- dict keys sorted, list items
in order -- so a layer's flattened gradient orders its elements exactly as the
JAX package does, and an int8 quantization block (256 consecutive elements)
groups the same elements in both.

Optimizer state crosses the same way: optax's ``ScaleByAdamState`` (``mu``,
``nu``, ``count``, as numpy arrays) becomes the port's ``optim.AdamState``,
both for the ZeRO-1 owned-shard buffers and for a replicated state, whose
moments are parameter trees flattened layer by layer; and the transformer
trainer's per-layer states, whose moments are distributed buffers over
each rank's flat local (or owned) vector. ``optax.adafactor``'s state
becomes the port's: per layer an ``optim.FactoredState`` on the plain path,
the ZeRO-1 dict of (R, D, S, M, n) buffers under the distributed update.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch


def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t) for t in tree]
    return fn(tree)


def flatten_layer(tree) -> torch.Tensor:
    """A layer subtree -> its flat float32 vector (JAX ``_flatten_layer``)."""
    return torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in tree_leaves(tree)])


def params_from_jax(tree, device=None):
    """The JAX package's parameter pytree, given as numpy arrays (or anything
    ``np.asarray`` accepts), -> the same tree of float32 torch tensors on
    ``device`` (default: the Environment's device, else the card)."""
    from mlsl_tpu_torch.core.environment import default_device

    device = default_device() if device is None else device
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device), tree
    )


def params_to_jax(tree_or_module):
    """Inverse of ``params_from_jax``: a tree of tensors (or a module with
    ``jax_tree()``) -> the JAX-layout tree of numpy arrays."""
    tree = (tree_or_module.jax_tree() if hasattr(tree_or_module, "jax_tree")
            else tree_or_module)
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def transformer_params_from_jax(tree, cfg, grid, device=None):
    """The JAX package's transformer parameters (the global tree of numpy
    arrays that ``mlsl_tpu.models.transformer.init_params`` gives) -> the
    port's per-rank layout: each leaf a float32 tensor of shape
    (R, D, S, M, *local) on ``device`` (default: the Environment's device),
    where model rank m holds the m-th of ``tp`` equal slices of a leaf that
    ``param_specs`` shards over the model axis and a copy of every other.
    Every rank has its own copy, so autograd gives each its own gradient."""
    from mlsl_tpu_torch.core.environment import default_device
    from mlsl_tpu_torch.models.transformer import param_specs

    device = default_device() if device is None else device
    r, d, s, m = grid
    specs = param_specs(cfg)

    def place(a, dim):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        if dim is not None and t.shape[dim] % m:
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} leaf does not split {m} ways")
        parts = [t] * m if dim is None else list(t.chunk(m, dim=dim))
        x = torch.stack(parts).to(device)                       # (M, *local)
        return x.unsqueeze(0).unsqueeze(0).unsqueeze(0).expand(r, d, s, *x.shape).contiguous()

    return {name: {k: place(tree[name][k], specs[name][k]) for k in sorted(specs[name])}
            for name in specs}


def transformer_params_to_jax(per_rank, cfg):
    """Inverse of ``transformer_params_from_jax``: rank (0, 0, 0, m)'s copies
    -> the global tree of numpy arrays, model slices concatenated back."""
    from mlsl_tpu_torch.models.transformer import param_specs

    specs = param_specs(cfg)
    out = {}
    for name, leaves in per_rank.items():
        out[name] = {}
        for k, t in leaves.items():
            ranks = t.detach()[0, 0, 0]                         # (M, *local)
            dim = specs[name][k]
            full = ranks[0] if dim is None else torch.cat(list(ranks), dim=dim)
            out[name][k] = full.cpu().numpy().copy()
    return out


def load_params(module, tree) -> None:
    """Copy a tree of tensors or arrays into ``module.jax_tree()``'s parameters,
    checking that the two trees have the same structure and shapes."""
    dst = module.jax_tree()

    def walk(d, s, path):
        if isinstance(d, dict):
            if sorted(d) != sorted(s):
                raise ValueError(f"{path}: keys {sorted(s)} != {sorted(d)}")
            for k in d:
                walk(d[k], s[k], f"{path}/{k}")
        elif isinstance(d, (list, tuple)):
            if len(d) != len(s):
                raise ValueError(f"{path}: {len(s)} items != {len(d)}")
            for i, (dd, ss) in enumerate(zip(d, s)):
                walk(dd, ss, f"{path}/{i}")
        else:
            src = torch.as_tensor(np.asarray(s) if not torch.is_tensor(s) else s)
            if tuple(src.shape) != tuple(d.shape):
                raise ValueError(f"{path}: shape {tuple(src.shape)} != {tuple(d.shape)}")
            with torch.no_grad():
                d.copy_(src.to(d.dtype))

    walk(dst, tree, "")


def adam_state_from_optax(mu, nu, count, device=None, *, layers=None, get_layer=None):
    """optax's ``ScaleByAdamState`` fields (numpy arrays, or anything
    ``np.asarray`` accepts) -> the port's ``optim.AdamState``.

    - ZeRO-1 owned-shard buffers (the JAX trainer's per-layer
      ``_du_opt_state``): ``mu`` and ``nu`` (R, D, S, M, owned), ``count``
      (R, D, S, M, 1) -> one AdamState over (R, D, S, M, owned).
    - A replicated state: ``mu`` and ``nu`` parameter trees, ``count`` a
      scalar, with ``layers`` and ``get_layer(tree, name)`` -> {layer:
      AdamState over the layer's flat vector, in leaf order}.

    All ranks step together, so the count must be one value."""
    from mlsl_tpu_torch.core.environment import default_device
    from mlsl_tpu_torch.optim import AdamState

    device = default_device() if device is None else device
    counts = np.unique(np.asarray(count))
    if counts.size != 1:
        raise ValueError(f"Adam step counts differ across ranks: {counts.tolist()}")
    step = torch.tensor(int(counts[0]), dtype=torch.int32, device=device)

    def vec(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    if layers is None:
        return AdamState(step, vec(mu), vec(nu))

    def flat(tree, name):
        return vec(np.concatenate([np.asarray(a, np.float32).reshape(-1)
                                   for a in tree_leaves(get_layer(tree, name))]))

    return {name: AdamState(step.clone(), flat(mu, name), flat(nu, name)) for name in layers}


def adam_state_to_optax(state):
    """Inverse of ``adam_state_from_optax`` for one AdamState -> (mu, nu,
    count) numpy arrays, count a scalar."""
    return (state.mu.detach().cpu().numpy().copy(), state.nu.detach().cpu().numpy().copy(),
            np.int32(state.count.item()))


def _adam_fields(state):
    """optax's Adam state -- the ``ScaleByAdamState`` itself, or the chain's
    tuple that holds it (``optax.adam`` is scale_by_adam + the learning-rate
    scale) -> its (mu, nu, count)."""
    parts = (state,) if hasattr(state, "mu") else tuple(state)
    for part in parts:
        if hasattr(part, "mu") and hasattr(part, "nu"):
            return part.mu, part.nu, part.count
    raise ValueError(f"no ScaleByAdamState in {type(state).__name__}")


def transformer_adam_state_from_optax(states, device=None):
    """The JAX HybridTrainer's per-layer optax Adam states (``_opt_state``, or
    ``_du_opt_state`` under ZeRO-1: ``mu`` and ``nu`` distributed buffers
    (R, D, S, M, local or owned count), ``count`` (R, D, S, M, 1)) -> {layer:
    the port's ``optim.AdamState`` over the same (R, D, S, M, n)}, the
    trainer's ``opt_state``."""
    out = {}
    for name, state in states.items():
        mu, nu, count = _adam_fields(state)
        out[name] = adam_state_from_optax(np.asarray(mu), np.asarray(nu), np.asarray(count),
                                          device)
    return out


def transformer_adam_state_to_optax(opt_state):
    """Inverse of ``transformer_adam_state_from_optax``: {layer: AdamState} ->
    {layer: (mu, nu, count)} numpy arrays in the JAX trainer's layout, the
    count broadcast to (R, D, S, M, 1)."""
    out = {}
    for name, state in opt_state.items():
        mu, nu, count = adam_state_to_optax(state)
        out[name] = (mu, nu, np.full((*mu.shape[:-1], 1), count, dtype=np.int32))
    return out


def _optax_parts(state):
    """The leaf states of an optax chain's (nested) state tuple."""
    if hasattr(state, "_fields") or not isinstance(state, (tuple, list)):
        return [state]
    return [leaf for part in state for leaf in _optax_parts(part)]


def adafactor_state_from_optax(state, device=None, *, layers=None, get_layer=None):
    """``optax.adafactor``'s state -> the port's.

    - ZeRO-1: one layer's state of the JAX ``DataParallelTrainer``
      (``_du_opt_state[name]``, a dict of distributed buffers ``count``,
      ``v_row``, ``v_col``, ``v`` and ``m`` with momentum) -> the same dict of
      tensors, the trainer's ``opt_state[name]``.
    - The plain path: the chain's state over the whole parameter tree, with
      ``layers`` and ``get_layer(tree, name)`` -> {layer: ``optim.
      FactoredState`` over the layer's leaves in leaf order}; the momentum
      trace comes from the chain's ``EmaState``."""
    from mlsl_tpu_torch.core.environment import default_device
    from mlsl_tpu_torch.optim import FactoredState

    device = default_device() if device is None else device

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    if isinstance(state, dict):
        return {k: t(v, np.int32 if k == "count" else np.float32) for k, v in state.items()}
    parts = _optax_parts(state)
    fs = next(p for p in parts if hasattr(p, "v_row"))
    ema = next((p for p in parts if hasattr(p, "ema")), None)

    def leaves(tree, name):
        return [t(a) for a in tree_leaves(get_layer(tree, name))]

    return {name: FactoredState(t(int(np.asarray(fs.count)), np.int32), leaves(fs.v_row, name),
                                leaves(fs.v_col, name), leaves(fs.v, name),
                                None if ema is None else leaves(ema.ema, name))
            for name in layers}


def adafactor_state_to_optax(state):
    """Inverse of ``adafactor_state_from_optax`` for one layer: the ZeRO-1
    dict -> a dict of numpy arrays; a ``FactoredState`` -> {"count", "v_row",
    "v_col", "v", "m"} with lists of numpy arrays (``m`` None without
    momentum)."""
    def a(x):
        return x.detach().cpu().numpy().copy()

    if isinstance(state, dict):
        return {k: a(v) for k, v in state.items()}
    return {"count": np.int32(state.count.item()), "v_row": [a(x) for x in state.v_row],
            "v_col": [a(x) for x in state.v_col], "v": [a(x) for x in state.v],
            "m": None if state.m is None else [a(x) for x in state.m]}
