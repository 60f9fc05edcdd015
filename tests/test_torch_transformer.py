"""The port's HybridTrainer (mlsl_tpu_torch.models.transformer) against the
JAX package's on tests/test_transformer.py's tiny float32 config, from the
same weights (the JAX tree, converted to the port's per-rank layout).

At each (dp, sp, tp) grid and attention schedule: the per-layer gradient
rows (R, D, S, M, count) that the ParameterSet requests receive, before any
sync, and then the losses and parameters after 2 SGD steps. At sp = 1 the
three schedules are one JAX program (all reach the dense attention), so the
JAX trainer runs once there and the port's three schedules are held to it.

Tolerances (float32): gradient rows 1e-5 absolute and 1e-4 relative (the
same terms summed in another order: the TP sum over 4 model ranks, the einsum
contractions); losses and parameters after 2 steps at lr 0.5, 1e-5 absolute
and 1e-4 relative.
"""

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.models import transformer as jtfm
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import transformer as ttfm
from mlsl_tpu_torch.models.convert import (
    transformer_params_from_jax,
    transformer_params_to_jax,
    tree_leaves,
)

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-4)
CFG = dict(vocab=32, d_model=16, n_heads=4, head_dim=4, n_blocks=2, seq_len=16,
           dtype="float32")


def _data(b, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG["vocab"], size=(b, CFG["seq_len"])).astype(np.int32)
    labels = rng.integers(0, CFG["vocab"], size=(b, CFG["seq_len"])).astype(np.int32)
    return toks, labels


def _port_env(world):
    return Environment.get_env().init(device="cpu", world_size=world)


# (dp, sp, tp): ring and zigzag at every grid, ulysses where the local head
# count (4 / tp) divides by sp
GRIDS = [(1, 1, 1), (2, 2, 2), (8, 1, 1), (1, 2, 4)]
CASES = [(g, a) for g in GRIDS for a in ("ring", "zigzag", "ulysses")
         if a != "ulysses" or (4 // g[2]) % g[1] == 0]


def _jax_run(env, dp, sp, tp, attention, toks, labels):
    cfg = jtfm.TransformerConfig(**CFG, attention=attention)
    jt = jtfm.HybridTrainer(env, cfg, dp, sp, tp, batch=toks.shape[0], lr=0.5,
                            devices=env.devices[: dp * sp * tp])
    init = jax.tree.map(np.asarray, jax.device_get(jt.params))
    st, sl = jt.shard_tokens(toks, labels)
    loss, flat = jt._grad_fn(jt.params, st, sl)
    rows = {n: np.asarray(v) for n, v in flat.items()}
    losses = [float(jt.step(st, sl)) for _ in range(2)]
    return init, np.asarray(loss), rows, losses, jax.device_get(jt.params)


_JAX_RUNS = {}


def _jax_cached(env, grid, attention, toks, labels):
    """JAX's run at this grid, once per test file (one program at sp = 1)."""
    key = (grid, "ring" if grid[1] == 1 else attention)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_run(env, *grid, key[1], toks, labels)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("grid,attention", CASES,
                         ids=lambda c: "dp%d-sp%d-tp%d" % c if isinstance(c, tuple) else c)
def test_hybrid_trainer_matches_jax(env, grid, attention):
    dp, sp, tp = grid
    toks, labels = _data(2 * dp)
    init, jloss, jrows, jlosses, jparams = _jax_cached(env, grid, attention, toks, labels)
    tenv = _port_env(dp * sp * tp)
    try:
        cfg = ttfm.TransformerConfig(**CFG, attention=attention)
        tt = ttfm.HybridTrainer(tenv, cfg, dp, sp, tp, batch=toks.shape[0], lr=0.5,
                                params=init)
        assert tt.fused == (dp * sp == 1)
        st, sl = tt.shard_tokens(toks, labels)
        loss, rows = tt._grad_fn(st, sl)
        np.testing.assert_allclose(loss.numpy(), jloss, **TOL)
        assert sorted(rows) == sorted(jrows)
        for name, row in rows.items():
            assert row.shape == jrows[name].shape, name
            np.testing.assert_allclose(row.numpy(), jrows[name], **TOL, err_msg=name)
        losses = [float(tt.step(st, sl)) for _ in range(2)]
        np.testing.assert_allclose(losses, jlosses, **TOL)
        got = transformer_params_to_jax(tt.params, cfg)
        for name in jtfm.layer_names(cfg):
            for a, w in zip(tree_leaves(got[name]), jax.tree.leaves(jparams[name])):
                np.testing.assert_allclose(a, np.asarray(w), **TOL, err_msg=name)
    finally:
        tenv.finalize()


def test_weight_conversion_round_trip():
    """JAX tree -> per-rank layout -> JAX tree is the identity; model rank m
    holds the m-th slice of every TP-sharded leaf and a copy of the rest, and
    the port's own init_params has the JAX tree's structure and shapes."""
    cfg = ttfm.TransformerConfig(**CFG)
    jparams = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(3),
                                                        jtfm.TransformerConfig(**CFG)))
    per_rank = transformer_params_from_jax(jparams, cfg, (1, 2, 1, 4), device="cpu")
    back = transformer_params_to_jax(per_rank, cfg)
    for name, leaves in jparams.items():
        for key, want in leaves.items():
            np.testing.assert_array_equal(back[name][key], want)
            t = per_rank[name][key]
            dim = ttfm.param_specs(cfg)[name][key]
            for d in range(2):
                for m in range(4):
                    part = want if dim is None else np.split(want, 4, axis=dim)[m]
                    np.testing.assert_array_equal(t[0, d, 0, m].numpy(), part)
    own = ttfm.init_params(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, jparams)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, {n: dict(v) for n, v in own.items()}))
    for name in jparams:
        for key in jparams[name]:
            assert tuple(own[name][key].shape) == jparams[name][key].shape


@pytest.mark.parametrize("option", ["n_experts", "remat", "sharded_vocab",
                                    "distributed_update", "optimizer"])
def test_unported_options_raise(option):
    """The options still to port raise MLSLError; ``n_experts`` (ported with
    the MoE slice), ``distributed_update`` and ``optimizer`` (ported with
    ZeRO-1 and Adam), ``remat`` and ``sharded_vocab`` (its head sharded over
    tp = 2) construct a trainer that steps."""
    from mlsl_tpu_torch import optim

    cfg_kw, kw = dict(CFG), {}
    if option == "n_experts":
        cfg_kw["n_experts"] = 4
    elif option in ("remat", "sharded_vocab"):
        cfg_kw[option] = True
    elif option == "distributed_update":
        kw["distributed_update"] = True
    else:
        kw["optimizer"] = optim.adam(1e-2)
    tenv = _port_env(2)
    try:
        if option in ("n_experts", "distributed_update", "optimizer", "remat",
                      "sharded_vocab"):
            grid = (1, 1, 2) if option in ("n_experts", "sharded_vocab") else (2, 1, 1)
            tt = ttfm.HybridTrainer(tenv, ttfm.TransformerConfig(**cfg_kw), *grid, batch=2,
                                    **kw)
            losses = [float(tt.step(*tt.shard_tokens(*_data(2)))) for _ in range(2)]
            assert np.isfinite(losses).all() and losses[1] < losses[0]
            return
        with pytest.raises(MLSLError, match="not ported yet"):
            ttfm.HybridTrainer(tenv, ttfm.TransformerConfig(**cfg_kw), 2, 1, 1, batch=2, **kw)
    finally:
        tenv.finalize()
