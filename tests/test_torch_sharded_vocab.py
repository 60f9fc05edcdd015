"""The port's sharded-vocabulary CE (``TransformerConfig(sharded_vocab=True)``:
the LM head sharded over the model axis, the CE from per-shard logits)
against the JAX package's trainer with the same flag, from the same weights
(the JAX tree converted to the port's per-rank layout).

At (dp, sp, tp) = (2, 2, 2) (ring and zigzag attention, the per-layer graph
path) and (1, 1, 2) (the fused path): the loss and every layer's gradient
rows before sync -- the head's rows are each model rank's vocabulary shard,
so these hold the cotangents that JAX gets from ``psum``'s transpose and the
port from ``_model_sum``'s -- then the losses and parameters after two SGD
steps. The port's sharded run also trains like its replicated head.

Tolerances (float32): 1e-5 absolute and 1e-4 relative, as the other
transformer tests (the same terms summed in another order: the vocabulary
sum in two shards, the TP sums).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.models import transformer as jtfm
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import transformer as ttfm
from mlsl_tpu_torch.models.convert import transformer_params_to_jax, tree_leaves

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-4)
CFG = dict(vocab=32, d_model=16, n_heads=4, head_dim=4, n_blocks=2, seq_len=16,
           dtype="float32")
CASES = [((2, 2, 2), "ring"), ((2, 2, 2), "zigzag"), ((1, 1, 2), "ring")]


def _data(b, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG["vocab"], size=(b, CFG["seq_len"])).astype(np.int32)
    labels = rng.integers(0, CFG["vocab"], size=(b, CFG["seq_len"])).astype(np.int32)
    return toks, labels


def _port_run(init, grid, attention, toks, labels, sharded=True):
    """-> (trainer's fused flag, loss, gradient rows, losses of 2 steps,
    parameters after them as the global tree)."""
    dp, sp, tp = grid
    tenv = Environment.get_env().init(device="cpu", world_size=dp * sp * tp)
    try:
        cfg = ttfm.TransformerConfig(**CFG, attention=attention, sharded_vocab=sharded)
        tt = ttfm.HybridTrainer(tenv, cfg, dp, sp, tp, batch=toks.shape[0], lr=0.5,
                                params=init)
        st, sl = tt.shard_tokens(toks, labels)
        loss, rows = tt._grad_fn(st, sl)
        losses = [float(tt.step(st, sl)) for _ in range(2)]
        return tt.fused, loss, rows, losses, transformer_params_to_jax(tt.params, cfg)
    finally:
        tenv.finalize()


@pytest.mark.parametrize("grid,attention", CASES,
                         ids=["dp2-sp2-tp2-ring", "dp2-sp2-tp2-zigzag", "dp1-sp1-tp2"])
def test_sharded_vocab_matches_jax(env, grid, attention):
    dp, sp, tp = grid
    toks, labels = _data(2 * dp)
    cfg = jtfm.TransformerConfig(**CFG, attention=attention, sharded_vocab=True)
    jt = jtfm.HybridTrainer(env, cfg, dp, sp, tp, batch=toks.shape[0], lr=0.5,
                            devices=env.devices[: dp * sp * tp])
    init = jax.tree.map(np.asarray, jax.device_get(jt.params))
    st, sl = jt.shard_tokens(toks, labels)
    jloss, jflat = jt._grad_fn(jt.params, st, sl)
    jlosses = [float(jt.step(st, sl)) for _ in range(2)]
    jparams = jax.device_get(jt.params)

    fused, loss, rows, losses, got = _port_run(init, grid, attention, toks, labels)
    assert fused == (dp * sp == 1)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    assert sorted(rows) == sorted(jflat)
    # the head's rows: each model rank's shard of the vocabulary, (d_model x
    # vocab / tp) first in the final layer's row
    assert rows["final"].shape[-1] == np.asarray(jflat["final"]).shape[-1]
    assert rows["final"].shape[-1] >= CFG["d_model"] * CFG["vocab"] // tp
    for name, row in rows.items():
        np.testing.assert_allclose(row.numpy(), np.asarray(jflat[name]), **TOL, err_msg=name)
    np.testing.assert_allclose(losses, jlosses, **TOL)
    for name in jtfm.layer_names(cfg):
        for a, w in zip(tree_leaves(got[name]), jax.tree.leaves(jparams[name])):
            np.testing.assert_allclose(a, np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize("grid", [(2, 2, 2), (1, 1, 2)], ids=["dp2-sp2-tp2", "dp1-sp1-tp2"])
def test_sharded_vocab_trains_like_the_replicated_head(grid):
    """The same weights and batch through the port's sharded and replicated
    heads: the same losses and parameters after two steps."""
    from mlsl_tpu.models.transformer import TransformerConfig, init_params

    init = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(5),
                                                TransformerConfig(**CFG)))
    toks, labels = _data(2 * grid[0], seed=3)
    _, loss_s, _, losses_s, params_s = _port_run(init, grid, "ring", toks, labels)
    _, loss_r, _, losses_r, params_r = _port_run(init, grid, "ring", toks, labels,
                                                 sharded=False)
    np.testing.assert_allclose(loss_s.numpy(), loss_r.numpy(), **TOL)
    np.testing.assert_allclose(losses_s, losses_r, **TOL)
    for name, leaves in params_r.items():
        for key, want in leaves.items():
            np.testing.assert_allclose(params_s[name][key], want, **TOL,
                                       err_msg=f"{name}/{key}")


def test_sharded_vocab_local_loss_matches_the_dense_ce():
    """``local_loss`` with the head sharded 4 ways against the dense
    log-softmax CE on the same per-rank weights (one data rank), and the
    head gradient of every shard against the dense head gradient's slice."""
    cfg_s = ttfm.TransformerConfig(**CFG, sharded_vocab=True)
    cfg_d = ttfm.TransformerConfig(**CFG)
    tp, grid = 4, (1, 1, 1, 4)
    gen = torch.Generator().manual_seed(7)
    tree = ttfm.init_params(gen, cfg_d)
    from mlsl_tpu_torch.models.convert import transformer_params_from_jax

    ps = transformer_params_from_jax(tree, cfg_s, grid, device="cpu")
    pd = transformer_params_from_jax(tree, cfg_d, grid, device="cpu")
    for p in tree_leaves(ps) + tree_leaves(pd):
        p.requires_grad_(True)
    toks, labels = _data(2, seed=11)
    t = torch.from_numpy(toks).long().view(1, 1, 1, 1, 2, -1).expand(*grid, 2, -1)
    lab = torch.from_numpy(labels).long().view(1, 1, 1, 1, 2, -1).expand(*grid, 2, -1)
    ce_s, _ = ttfm.local_loss(ps, t, lab, cfg_s, 1, tp)
    ce_d, _ = ttfm.local_loss(pd, t, lab, cfg_d, 1, tp)
    np.testing.assert_allclose(ce_s.detach().numpy(), ce_d.detach().numpy(), **TOL)
    (gs,) = torch.autograd.grad((ce_s / tp).sum(), [ps["final"]["head"]])
    (gd,) = torch.autograd.grad((ce_d / tp).sum(), [pd["final"]["head"]])
    full = gd[0, 0, 0].sum(dim=0)                      # the replicated head's TP sum
    vl = CFG["vocab"] // tp
    for m in range(tp):
        np.testing.assert_allclose(gs[0, 0, 0, m].numpy(), full[:, m * vl:(m + 1) * vl].numpy(),
                                   **TOL, err_msg=f"shard {m}")


def test_sharded_vocab_needs_vocab_divisible_by_tp():
    tenv = Environment.get_env().init(device="cpu", world_size=4)
    try:
        cfg = ttfm.TransformerConfig(**{**CFG, "vocab": 30}, sharded_vocab=True)
        with pytest.raises(MLSLError, match="sharded head"):
            ttfm.HybridTrainer(tenv, cfg, 1, 1, 4, batch=2)
        # tp = 1 keeps the dense head: the flag changes nothing there
        ttfm.HybridTrainer(tenv, dataclasses.replace(cfg, vocab=32), 4, 1, 1, batch=4)
    finally:
        tenv.finalize()
