"""Parameter trees shared with the JAX package.

The port's models keep every parameter in the JAX package's layout (conv
weights HWIO, dense weights (in, out)) and expose them as a tree of nested
dicts and lists that mirrors the JAX pytree (``Module.jax_tree()``). The flat
order of a tree is ``jax.tree.leaves`` order -- dict keys sorted, list items
in order -- so a layer's flattened gradient orders its elements exactly as the
JAX package does, and an int8 quantization block (256 consecutive elements)
groups the same elements in both.
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
