"""The port's sequence-parallel attention (mlsl_tpu_torch.parallel.sequence)
against the JAX package's, which runs in ``shard_map`` on the 8-device CPU
mesh: ring, zigzag and Ulysses attention, forward and gradients, with
``use_flash`` True (the JAX kernels under the Pallas interpreter, the port's
plain B7-B9) and False (the einsum schedules).

Both sides take the same global (B, H, S, D) arrays (zigzag-ordered for the
zigzag schedule); the port holds rank r's shard in row r of a (G, B, H, Sl,
D) tensor whose leading dim is the sequence group. Gradients are of
sum(out * g) for a fixed random cotangent g.

Tolerances (float32): 2e-5 absolute and relative for outputs, 1e-4 for
gradients -- the two sides sum the same terms in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mlsl_tpu.models.train import smap
from mlsl_tpu.parallel import sequence as jseq
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.ops import attention_kernels as tak
from mlsl_tpu_torch.parallel import sequence as tseq

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
GTOL = dict(atol=1e-4, rtol=1e-4)

# (kind, sp, causal, use_flash, B, H, S, D): the flash cases' local shard
# (ring) or chunk (zigzag) is 128 long, as supports() needs
CASES = [
    ("ring", 8, False, False, 2, 4, 32, 8),
    ("ring", 8, True, False, 2, 4, 32, 8),
    ("ring", 4, True, None, 2, 4, 32, 8),
    ("ring", 2, True, True, 1, 2, 256, 16),
    ("ring", 2, False, True, 1, 2, 256, 16),
    ("zigzag", 4, True, False, 2, 4, 32, 8),
    ("zigzag", 2, True, False, 1, 2, 64, 16),
    ("zigzag", 2, True, True, 1, 2, 512, 16),
    ("ulysses", 4, True, None, 2, 4, 32, 8),
    ("ulysses", 2, False, None, 2, 4, 32, 8),
    ("ulysses", 2, True, None, 1, 2, 256, 8),
    # head_dim 256: supports() admits the 128-long shards, the CUDA kernels do
    # not take the head_dim, so both sides run the einsum schedule
    ("ring", 2, True, None, 1, 1, 256, 256),
]


def _id(c):
    kind, sp, causal, flash = c[:4]
    tail = f"-d{c[7]}" if c[7] > 128 else ""
    return f"{kind}-sp{sp}-{'causal' if causal else 'full'}-flash{flash}{tail}"


def _jax_fn(kind, sp, causal, use_flash):
    if kind == "ring":
        return lambda q, k, v: jseq.ring_attention(q, k, v, "seq", sp, causal=causal,
                                                   use_flash=use_flash)
    if kind == "zigzag":
        return lambda q, k, v: jseq.zigzag_ring_attention(q, k, v, "seq", sp,
                                                          use_flash=use_flash)
    return lambda q, k, v: jseq.ulysses_attention(q, k, v, "seq", sp, causal=causal)


def _torch_fn(kind, sp, causal, use_flash):
    if kind == "ring":
        return lambda q, k, v: tseq.ring_attention(q, k, v, 0, sp, causal=causal,
                                                   use_flash=use_flash)
    if kind == "zigzag":
        return lambda q, k, v: tseq.zigzag_ring_attention(q, k, v, 0, sp, use_flash=use_flash)
    return lambda q, k, v: tseq.ulysses_attention(q, k, v, 0, sp, causal=causal)


def _shard(x, sp):
    """(B, H, S, D) -> (G, B, H, S/G, D): rank r holds the r-th sequence slice."""
    b, h, s, d = x.shape
    return x.reshape(b, h, sp, s // sp, d).permute(2, 0, 1, 3, 4).contiguous()


def _unshard(x):
    g, b, h, sl, d = x.shape
    return x.permute(1, 2, 0, 3, 4).reshape(b, h, g * sl, d)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_sequence_attention_matches_jax(env, case):
    kind, sp, causal, use_flash, b, h, s, d = case
    rng = np.random.default_rng(sum(map(ord, _id(case))))
    q, k, v, g = (rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(4))

    dist = env.create_distribution(1, 1, seq_parts=sp, devices=env.devices[:sp])
    spec = P(None, None, "seq", None)
    fn = jax.jit(smap(_jax_fn(kind, sp, causal, use_flash), dist.topology.mesh,
                      in_specs=(spec, spec, spec), out_specs=spec, check=False))
    want, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))

    ts = [_shard(torch.from_numpy(x), sp).requires_grad_(True) for x in (q, k, v)]
    out = _torch_fn(kind, sp, causal, use_flash)(*ts)
    np.testing.assert_allclose(_unshard(out.detach()).numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad(out, ts, _shard(torch.from_numpy(g), sp))
    for got, w in zip(grads, want_grads):
        np.testing.assert_allclose(_unshard(got).numpy(), np.asarray(w), **GTOL)
    assert all(v == 0 for v in tak.LAUNCHES.values())


@pytest.mark.parametrize("seq_len,sp", [(16, 1), (16, 2), (32, 4), (64, 8), (24, 3)])
def test_zigzag_perm_matches_jax(seq_len, sp):
    np.testing.assert_array_equal(tseq.zigzag_perm(seq_len, sp), jseq.zigzag_perm(seq_len, sp))
    np.testing.assert_array_equal(tseq.zigzag_perm_inverse(seq_len, sp),
                                  jseq.zigzag_perm_inverse(seq_len, sp))
    with pytest.raises(MLSLError, match="zigzag needs"):
        tseq.zigzag_perm(seq_len + 1, sp)


def test_grid_dims_and_flash_routing():
    """The schedules take any leading rank dims (the trainer's (R, D, S, M)),
    and route through the kernels exactly where supports() admits the shapes:
    with use_flash=None a ring of 128-long shards runs B9 (its plain version
    here) and agrees with use_flash=False; use_flash=True on shards that the
    kernels do not take raises instead of falling back."""
    rng = np.random.default_rng(7)
    x = [torch.from_numpy(rng.normal(size=(1, 2, 2, 2, 1, 2, 128, 8)).astype(np.float32))
         for _ in range(3)]
    calls = []
    orig = tak.block_update

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    tak.block_update = counting
    try:
        auto = tseq.ring_attention(*x, 2, 2, causal=True)
    finally:
        tak.block_update = orig
    assert calls == [(16, 128, 8)] * 2       # one call per hop over all 8 ranks
    plain = tseq.ring_attention(*x, 2, 2, causal=True, use_flash=False)
    np.testing.assert_allclose(auto.numpy(), plain.numpy(), **TOL)
    small = [t[..., :64, :] for t in x]
    with pytest.raises(MLSLError, match="use_flash=False"):
        tseq.ring_attention(*small, 2, 2, causal=True, use_flash=True)
    with pytest.raises(MLSLError, match="divisible"):
        tseq.ulysses_attention(*(t[:, :, :, :, :, :1] for t in small), 2, 2)


def test_flash_route_needs_a_head_dim_the_kernels_take():
    """supports() keeps the TPU predicate (any multiple of 8); the route also
    needs head_dim <= 128, where the CUDA kernels stop."""
    assert tak.supports(128, 128, 256) and tak.supports(128, 128, 128)
    assert not tseq._use_flash(128, 128, 256)
    assert tseq._use_flash(128, 128, 128)
    assert not tseq._use_flash(64, 64, 64)
