"""The port's ``remat`` / ``remat_policy`` on HybridTrainer against the JAX
package's trainer with the same flags, and against the port's own run
without remat.

A small float32 config (2 blocks, d_model 64, 4 heads of 16, seq 64) at dp x
sp x tp = 2 x 2 x 2 with ring and with zigzag attention, and with a MoE FFN
of 4 experts (ep = tp = 2, zigzag). For each layout and each policy
(``"full"``: replay the whole block in the backward; ``"dots"``: keep the
matrix products' outputs and replay the rest), from the JAX tree's weights:

- the loss and every layer's gradient rows before sync against JAX's
  ``_grad_fn`` under ``jax.checkpoint`` with the same policy, at the
  tolerance the non-remat tests use (1e-5 absolute, 1e-4 relative: the same
  terms summed in another order);
- the same rows, and the losses and parameters after two SGD steps, equal
  to the port's run without remat bit for bit: on the CPU a replayed block
  computes exactly what the forward computed.
"""

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.models import transformer as jtfm
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import transformer as ttfm

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-4)
CFG = dict(vocab=64, d_model=64, n_heads=4, head_dim=16, n_blocks=2, seq_len=64,
           dtype="float32")
GRID = (2, 2, 2)
# (attention, experts)
LAYOUTS = [("ring", 0), ("zigzag", 0), ("zigzag", 4)]


def _data(b, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG["vocab"], size=(b, CFG["seq_len"])).astype(np.int32)
    labels = rng.integers(0, CFG["vocab"], size=(b, CFG["seq_len"])).astype(np.int32)
    return toks, labels


def _cfg(mod, attention, experts, **kw):
    return mod.TransformerConfig(**CFG, attention=attention, n_experts=experts, **kw)


def _port_run(init, attention, experts, toks, labels, **remat):
    """-> (loss, gradient rows, losses of 2 steps, parameters after them)."""
    dp, sp, tp = GRID
    tenv = Environment.get_env().init(device="cpu", world_size=dp * sp * tp)
    try:
        tt = ttfm.HybridTrainer(tenv, _cfg(ttfm, attention, experts, **remat), dp, sp, tp,
                                batch=toks.shape[0], lr=0.5, params=init)
        st, sl = tt.shard_tokens(toks, labels)
        loss, rows = tt._grad_fn(st, sl)
        losses = [float(tt.step(st, sl)) for _ in range(2)]
        params = {n: [p.detach().clone() for p in tt._leaves[n]] for n in tt.layers}
        return loss, rows, losses, params
    finally:
        tenv.finalize()


_PLAIN = {}


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("attention,experts", LAYOUTS,
                         ids=["ring", "zigzag", "zigzag-moe4"])
def test_remat_matches_jax_and_the_plain_run(env, attention, experts, policy):
    dp, sp, tp = GRID
    toks, labels = _data(2 * dp)
    jt = jtfm.HybridTrainer(env, _cfg(jtfm, attention, experts, remat=True,
                                      remat_policy=policy),
                            dp, sp, tp, batch=toks.shape[0], lr=0.5,
                            devices=env.devices[: dp * sp * tp])
    init = jax.tree.map(np.asarray, jax.device_get(jt.params))
    jst, jsl = jt.shard_tokens(toks, labels)
    jloss, jflat = jt._grad_fn(jt.params, jst, jsl)

    loss, rows, losses, params = _port_run(init, attention, experts, toks, labels,
                                           remat=True, remat_policy=policy)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    assert sorted(rows) == sorted(jflat)
    for name, row in rows.items():
        np.testing.assert_allclose(row.numpy(), np.asarray(jflat[name]), **TOL,
                                   err_msg=name)

    key = (attention, experts)
    if key not in _PLAIN:
        _PLAIN[key] = _port_run(init, attention, experts, toks, labels)
    ploss, prows, plosses, pparams = _PLAIN[key]
    assert torch.equal(loss, ploss)
    for name, row in rows.items():
        assert torch.equal(row, prows[name]), name
    assert losses == plosses
    for name, leaves in params.items():
        for a, b in zip(leaves, pparams[name]):
            assert torch.equal(a, b), name


def test_remat_policy_is_checked():
    """An unknown policy raises MLSLError at the first forward, as JAX's
    trainer asserts it."""
    tenv = Environment.get_env().init(device="cpu", world_size=2)
    try:
        tt = ttfm.HybridTrainer(tenv, _cfg(ttfm, "ring", 0, remat=True, remat_policy="all"),
                                2, 1, 1, batch=2)
        with pytest.raises(MLSLError, match="unknown remat_policy"):
            tt.step(*tt.shard_tokens(*_data(2)))
    finally:
        tenv.finalize()
