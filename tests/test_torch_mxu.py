"""The port's ``ops.mxu.mxu_einsum`` on bf16 operands against the JAX
package's ``mlsl_tpu.models.moe.mxu_einsum`` under ``jax.grad`` on the CPU,
and against a float64 product of the same bf16 operands.

The four specs the transformer and the experts use, on operands made with
numpy from a seed and rounded to bf16 (exact in both frameworks), with the
trainer's (R, D, S, M) grid dims and the experts' broadcast ep dim. On the
CPU the port multiplies the upcast operands in float32 (its plain version);
JAX's CPU backend computes the bf16 einsum and casts, so its forward is the
float32 result rounded once to bf16.

Tolerances, with their reasons:

- forward against float64: relative L2 1e-6 (bf16 x bf16 products are exact
  in float32; only the float32 sum rounds);
- forward against JAX: elementwise within one bf16 ulp (``2**-7`` of the
  value), since JAX's result is the same sum rounded to bf16;
- gradients against the float64 vjp of the cotangent rounded to bf16 (JAX's
  vjp rounds it so, and so does the port): relative L2 ``2**-8``, the
  largest relative error of the one rounding of each gradient to bf16 (half
  an ulp, 2**-8 of a value at the bottom of its binade), and at least 99 % of
  the elements equal to that vjp rounded to bf16, bit for bit (the float32
  sum is far closer than half a bf16 ulp, so only near-ties may round the
  other way; an unrounded cotangent leaves about 60 % equal);
- gradients against JAX's: within one bf16 ulp elementwise (the two round
  differently ordered float32 sums to bf16).

Then one bf16 training step of tests/test_transformer.py's tiny config on one
rank, from the same weights: the loss within 1e-3 of JAX's and every leaf's
update (its change over the SGD step) within 5e-2 relative L2 of JAX's. The
two frameworks round bf16 activations in other places and JAX's CPU path also
rounds the products' outputs to bf16, so the updates differ by a few bf16
roundings (about 1e-2, the loss by about 4e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsl_tpu.models import moe as jmoe
from mlsl_tpu.models import transformer as jtfm
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import transformer as ttfm
from mlsl_tpu_torch.models.convert import transformer_params_to_jax, tree_leaves
from mlsl_tpu_torch.ops import mxu

torch.set_num_threads(2)

GRID = (1, 2, 1, 2)
# (spec, a shape, w shape)
CASES = [
    ("...bhsx,...hxd->...bsd", (*GRID, 2, 2, 8, 16), (*GRID, 2, 16, 24)),
    ("...bsf,...fd->...bsd", (*GRID, 2, 8, 64), (*GRID, 64, 24)),
    ("...ecd,...edf->...ecf", (*GRID, 2, 2, 6, 24), (*GRID, 1, 2, 24, 32)),
    ("...ecf,...efd->...ecd", (*GRID, 2, 2, 6, 32), (*GRID, 1, 2, 32, 24)),
]


def _bf16(rng, shape, scale=1.0):
    """numpy float32 values that bf16 represents exactly."""
    x = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _inputs(spec, sa, sw):
    rng = np.random.default_rng(sum(map(ord, spec)))
    return _bf16(rng, sa), _bf16(rng, sw, 0.1)


def _port(spec, a, w, ct):
    x = torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
    y = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    out = mxu.mxu_einsum(spec, x, y)
    out.backward(torch.from_numpy(ct))
    return out.detach(), x.grad, y.grad


def _jax(spec, a, w, ct):
    ja, jw = jnp.asarray(a, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    out = jmoe.mxu_einsum(spec, ja, jw)
    ga, gw = jax.grad(lambda p, q: jnp.sum(jmoe.mxu_einsum(spec, p, q) * ct),
                      argnums=(0, 1))(ja, jw)
    return (np.asarray(out, np.float32), np.asarray(ga.astype(jnp.float32)),
            np.asarray(gw.astype(jnp.float32)))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _within_one_ulp(got, want):
    """|got - want| <= one bf16 ulp of |want| (2**-7 of it, at most)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-30))


@pytest.mark.parametrize("spec,sa,sw", CASES, ids=[c[0] for c in CASES])
def test_mxu_einsum_matches_jax_and_float64(spec, sa, sw):
    a, w = _inputs(spec, sa, sw)
    out_shape = np.einsum(spec, a, w).shape
    ct = np.random.default_rng(1).normal(size=out_shape).astype(np.float32)
    out, ga, gw = _port(spec, a, w, ct)
    assert out.dtype == torch.float32 and ga.dtype == gw.dtype == torch.bfloat16
    assert tuple(out.shape) == out_shape and ga.shape == a.shape and gw.shape == w.shape

    # float64 of the same bf16 operands, and its vjp on the bf16-rounded cotangent
    a64 = torch.from_numpy(a).double().requires_grad_()
    w64 = torch.from_numpy(w).double().requires_grad_()
    ref = torch.einsum(spec, a64, w64)
    ref.backward(torch.from_numpy(ct).to(torch.bfloat16).double())
    assert _rel_l2(out, ref.detach()) <= 1e-6
    assert _rel_l2(ga.float(), a64.grad) <= 2.0 ** -8
    assert _rel_l2(gw.float(), w64.grad) <= 2.0 ** -8
    for got, want in ((ga, a64.grad), (gw, w64.grad)):
        assert (got == want.to(torch.bfloat16)).float().mean().item() >= 0.99

    jout, jga, jgw = _jax(spec, a, w, ct)
    assert _within_one_ulp(out.numpy(), jout)
    assert _within_one_ulp(ga.float().numpy(), jga)
    assert _within_one_ulp(gw.float().numpy(), jgw)


def test_mxu_einsum_float32_operands_keep_the_exact_einsum():
    """Float32 (or, on the CPU, mixed) operands take the float32 einsum, as
    before."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(2, 3, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32))
    spec = "...bsf,...fd->...bsd"
    assert torch.equal(mxu.mxu_einsum(spec, a, w), torch.einsum(spec, a, w))
    assert torch.equal(mxu.mxu_einsum(spec, a.to(torch.bfloat16), w),
                       torch.einsum(spec, a.to(torch.bfloat16).float(), w))


@pytest.mark.parametrize("spec", ["bsf,fd->bsd", "...bb,...bd->...bd", "...bs,...fd->...bsd",
                                  "...bsf,...fd->...bd", "...bsf...fd->...bsd"])
def test_mxu_einsum_raises_on_a_spec_it_cannot_lower(spec):
    a = torch.zeros((2, 2, 2), dtype=torch.bfloat16)
    with pytest.raises(MLSLError, match="cannot lower"):
        mxu.mxu_einsum(spec, a, torch.zeros((2, 2), dtype=torch.bfloat16))


CFG = dict(vocab=32, d_model=16, n_heads=4, head_dim=4, n_blocks=2, seq_len=16,
           dtype="bfloat16")


def test_bf16_transformer_step_matches_jax(env):
    """One bf16 SGD step of the tiny config on one rank (the fused step, whose
    attention output projection and MLP run mxu_einsum), from the same
    weights, against JAX's."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, CFG["vocab"], size=(2, CFG["seq_len"])).astype(np.int32)
    labels = rng.integers(0, CFG["vocab"], size=(2, CFG["seq_len"])).astype(np.int32)
    jcfg = jtfm.TransformerConfig(**CFG)
    jt = jtfm.HybridTrainer(env, jcfg, 1, 1, 1, batch=2, lr=0.5, devices=env.devices[:1])
    init = jax.tree.map(np.array, jax.device_get(jt.params))     # copies: JAX donates
    st, sl = jt.shard_tokens(toks, labels)
    jloss = float(jt.step(st, sl))
    jparams = jax.device_get(jt.params)

    tenv = Environment.get_env().init(device="cpu", world_size=1)
    try:
        cfg = ttfm.TransformerConfig(**CFG)
        tt = ttfm.HybridTrainer(tenv, cfg, 1, 1, 1, batch=2, lr=0.5, params=init)
        loss = float(tt.step(*tt.shard_tokens(toks, labels)))
        assert np.isfinite(loss)
        assert abs(loss - jloss) <= 1e-3, (loss, jloss)
        got = transformer_params_to_jax(tt.params, cfg)
        for name in jtfm.layer_names(jcfg):
            for p, q, p0 in zip(tree_leaves(got[name]), jax.tree.leaves(jparams[name]),
                                jax.tree.leaves(init[name])):
                p0 = np.asarray(p0, np.float32)
                assert _rel_l2(p - p0, np.asarray(q, np.float32) - p0) <= 5e-2, name
    finally:
        tenv.finalize()
