"""The port's flash attention (mlsl_tpu_torch.ops.attention_kernels: B7, B8,
B9) against the JAX package's kernels under the Pallas interpreter, as
tests/test_flash.py runs them.

On the CPU the port's wrappers run their plain versions, so these tests hold
the plain B7 (output and lse), B8 (the gradients of ``flash_attention``,
against ``jax.vjp``) and B9 (the carried state, chained over two hops, and its
gradients) to the JAX kernels: causal and not, shifted offsets, offsets that
mask whole rows (output and gradients exactly 0 there), head_dim 8 to 128.

Tolerances: float32 inputs; the TPU kernels fold 128- to 2048-wide tiles and
the plain version the whole row at once, so sums differ in order: 2e-5
absolute and relative for outputs and the state (m, l are compared on the
TPU's lane 0), 1e-4 for gradients.

Each CUDA kernel against its plain version on the card:
mlsl_tpu_torch/cuda_tests/ (jax-free, so that it runs on the card's machine).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsl_tpu.ops import attention_kernels as jak
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.ops import attention_kernels as tak

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
GTOL = dict(atol=1e-4, rtol=1e-4)

# (name, bh, sq, sk, d, causal, q_off, k_off)
FWD_CASES = [
    ("plain", 4, 256, 256, 64, False, 0, 0),
    ("causal", 4, 256, 256, 64, True, 0, 0),
    ("later_queries", 2, 128, 128, 64, True, 256, 0),
    ("partial_offsets", 2, 128, 256, 32, True, 100, 37),
    ("all_rows_masked", 2, 128, 128, 64, True, 0, 256),
    ("some_rows_masked", 2, 256, 128, 16, True, 0, 64),
    ("d8", 3, 128, 128, 8, True, 0, 0),
    ("d128_noncausal", 2, 128, 256, 128, False, 0, 0),
]


def _arrays(name, bh, sq, sk, d):
    rng = np.random.default_rng(sum(map(ord, name)))
    mk = lambda s: rng.normal(size=(bh, s, d)).astype(np.float32)
    return mk(sq), mk(sk), mk(sk), mk(sq)


def _offs(q_off, k_off):
    return jnp.asarray([q_off], jnp.int32), jnp.asarray([k_off], jnp.int32)


def _masked_rows(sq, sk, q_off, k_off):
    """Rows whose every key lies in their future."""
    return q_off + np.arange(sq) < k_off


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: c[0])
def test_plain_flash_fwd_matches_jax(case):
    name, bh, sq, sk, d, causal, q_off, k_off = case
    q, k, v, _ = _arrays(name, bh, sq, sk, d)
    jo, jl = jak._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            *_offs(q_off, k_off), causal=causal, interpret=True)
    to, tl = tak.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)), q_off, k_off, causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, :, 0], **TOL)
    rows = _masked_rows(sq, sk, q_off, k_off) if causal else np.zeros(sq, bool)
    assert (to.numpy()[:, rows] == 0).all()
    assert tak.LAUNCHES["flash_fwd"] == 0      # the CPU runs the plain version


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: c[0])
def test_plain_flash_gradients_match_jax_vjp(case):
    name, bh, sq, sk, d, causal, q_off, k_off = case
    q, k, v, g = _arrays(name, bh, sq, sk, d)
    qo, ko = _offs(q_off, k_off)
    _, vjp = jax.vjp(lambda a, b, c: jak.flash_attention(a, b, c, qo, ko, causal, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tak.flash_attention(*ts, q_off, k_off, causal)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for gt, gw in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gw), **GTOL)
    if causal:
        rows = _masked_rows(sq, sk, q_off, k_off)
        assert (got[0].numpy()[:, rows] == 0).all()


# (name, bh, sq, sk, d, causal, q_off, k_off for hop 1, k_off for hop 2)
BU_CASES = [
    ("ring_causal", 4, 128, 128, 32, True, 128, 0, 128),
    ("noncausal", 4, 128, 256, 64, False, 0, 0, 0),
    ("future_then_past", 2, 128, 128, 16, True, 0, 128, 0),
    ("diag_d128", 2, 128, 128, 128, True, 0, 0, 0),
]


def _state_arrays(rng, bh, sq, d, fresh):
    if fresh:
        return (np.zeros((bh, sq, d), np.float32), np.full((bh, sq), jak.NEG, np.float32),
                np.zeros((bh, sq), np.float32))
    m = rng.normal(size=(bh, sq)).astype(np.float32)
    return (rng.normal(size=(bh, sq, d)).astype(np.float32), m,
            rng.uniform(0.5, 2.0, size=(bh, sq)).astype(np.float32))


def _lanes(x):
    return jnp.broadcast_to(jnp.asarray(x)[..., None], (*x.shape, 128))


@pytest.mark.parametrize("case", BU_CASES, ids=lambda c: c[0])
def test_plain_block_update_matches_jax_over_two_hops(case):
    name, bh, sq, sk, d, causal, q_off, k1, k2 = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q, ka, va, kb, vb = (rng.normal(size=(bh, s, d)).astype(np.float32)
                         for s in (sq, sk, sk, sk, sk))
    acc, m, l = _state_arrays(rng, bh, sq, d, fresh=True)
    jstate = (jnp.asarray(acc), _lanes(m), _lanes(l))
    tstate = tuple(torch.from_numpy(a) for a in (acc, m, l))
    for kk, vv, k_off in ((ka, va, k1), (kb, vb, k2)):
        jstate = jak.flash_block_update(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv),
                                        *jstate, *_offs(q_off, k_off), causal, True)
        tstate = tak.block_update(torch.from_numpy(q), torch.from_numpy(kk),
                                  torch.from_numpy(vv), *tstate, q_off, k_off, causal)
        np.testing.assert_allclose(tstate[0].numpy(), np.asarray(jstate[0]), **TOL)
        for t, j in zip(tstate[1:], jstate[1:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j)[:, :, 0], **TOL)
    assert tak.LAUNCHES["block_update"] == 0


@pytest.mark.parametrize("case", BU_CASES, ids=lambda c: c[0])
def test_plain_block_update_gradients_match_jax_vjp(case):
    """The port's B9 backward (autograd through the plain version) against
    JAX's ``_bu_bwd`` (jax.vjp of ``_block_update_ref``), from a carried
    state that is not the empty one. The TPU's m and l are lane-broadcast:
    its cotangents and its input gradients live on lane 0."""
    name, bh, sq, sk, d, causal, q_off, k_off, _ = case
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32) for s in (sq, sk, sk))
    acc, m, l = _state_arrays(rng, bh, sq, d, fresh=False)
    ga, gm, gl = (rng.normal(size=x.shape).astype(np.float32) for x in (acc, m, l))
    qo, ko = _offs(q_off, k_off)

    def jfn(q_, k_, v_, a_, m_, l_):
        return jak.flash_block_update(q_, k_, v_, a_, m_, l_, qo, ko, causal, True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v, acc)), _lanes(m), _lanes(l))
    zero_lanes = lambda x: jnp.zeros((*x.shape, 128), jnp.float32).at[..., 0].set(x)
    want = vjp((jnp.asarray(ga), zero_lanes(gm), zero_lanes(gl)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, acc, m, l)]
    outs = tak.flash_block_update(*ts, q_off, k_off, causal)
    got = torch.autograd.grad(outs, ts, tuple(torch.from_numpy(x) for x in (ga, gm, gl)))
    for i, (gt, gw) in enumerate(zip(got, want)):
        gw = np.asarray(gw)
        if i >= 4:
            gw = gw[:, :, 0]
        np.testing.assert_allclose(gt.numpy(), gw, **GTOL)


def test_supports_predicate_and_shape_checks():
    for sq, sk, d in ((256, 256, 64), (100, 256, 64), (256, 256, 7), (128, 384, 8),
                      (128, 128, 4), (2048, 2048, 64)):
        assert tak.supports(sq, sk, d) == jak.supports(sq, sk, d)
    q = torch.zeros(2, 100, 64)
    with pytest.raises(MLSLError, match="supports"):
        tak.flash_fwd(q, q, q, 0, 0, True)
    q = torch.zeros(2, 128, 64)
    with pytest.raises(MLSLError, match="offsets"):
        tak.flash_fwd(q, q, q, torch.zeros(3, dtype=torch.int32), 0, True)
    with pytest.raises(MLSLError, match="unsupported device"):
        tak.flash_fwd(q.to("meta"), q.to("meta"), q.to("meta"), 0, 0, True)


def test_per_row_offsets_equal_separate_calls():
    """One call with an offset per (b, h) row -- what a launch spanning ring
    ranks gets -- equals one call per row with its own scalar offsets."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, 128, 16)).astype(np.float32))
               for _ in range(3))
    qo, ko = torch.tensor([0, 128, 256], dtype=torch.int32), torch.tensor([128, 0, 200])
    out, lse = tak.flash_fwd(q, k, v, qo, ko, True)
    for b in range(3):
        o1, l1 = tak.flash_fwd(q[b:b + 1], k[b:b + 1], v[b:b + 1], int(qo[b]), int(ko[b]), True)
        assert torch.equal(out[b:b + 1], o1) and torch.equal(lse[b:b + 1], l1)
    assert (out[0] == 0).all() and (out[2] != 0).any()


# -- the wgmma form's rounding (P and dS to bf16), held against JAX ------------
#
# The sm90 form of B7/B8 (bf16 inputs, head_dim 64 or 128) rounds P and dS to
# bf16 where they enter a product; the plain versions do the same with
# p_dtype=torch.bfloat16, and the card holds each kernel to them at 2e-3. Here
# those rounded plain versions meet JAX's kernels (float32 inside, bf16 in and
# out) on bf16 inputs from a numpy seed: relative L2 error within 1e-2 for the
# output and the three gradients, the lse within 2e-5 absolute. Per-row offsets
# are one port call against one JAX call per row with its scalar offsets.

# (name, d, causal, q_off per row, k_off per row); bh 4, sq = sk = 256
BF16_CASES = [
    ("d64_noncausal", 64, False, [0, 0, 0, 0], [0, 0, 0, 0]),
    ("d64_causal_row_offsets", 64, True, [0, 128, 0, 64], [0, 0, 100, 512]),
    ("d128_noncausal", 128, False, [0, 0, 0, 0], [0, 0, 0, 0]),
    ("d128_causal_row_offsets", 128, True, [0, 256, 37, 0], [0, 0, 0, 128]),
]
BF16_REL = 1e-2


def _bf16_inputs(name, d, bh=4, s=256):
    rng = np.random.default_rng(sum(map(ord, name)) + 7)
    return [jnp.asarray(rng.normal(size=(bh, s, d)).astype(np.float32), jnp.bfloat16)
            for _ in range(4)]


def _to_torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(torch.bfloat16)


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _jax_rows(fn, q_off, k_off, *arrays):
    """fn(*row_arrays, qo, ko) per (b, h) row with its scalar offsets, stacked
    over the rows of each output."""
    outs = [fn(*(a[b:b + 1] for a in arrays), *_offs(q_off[b], k_off[b]))
            for b in range(len(q_off))]
    return [jnp.concatenate(parts) for parts in zip(*outs)]


@pytest.mark.parametrize("case", BF16_CASES, ids=lambda c: c[0])
def test_rounded_plain_flash_fwd_matches_jax_bf16(case):
    name, d, causal, q_off, k_off = case
    q, k, v, _ = _bf16_inputs(name, d)
    jo, jl = _jax_rows(lambda a, b, c, qo, ko: jak._flash_fwd(a, b, c, qo, ko, causal=causal,
                                                              interpret=True),
                       q_off, k_off, q, k, v)
    qo, ko = (torch.tensor(x, dtype=torch.int32) for x in (q_off, k_off))
    to, tl = tak.flash_fwd_ref(_to_torch(q), _to_torch(k), _to_torch(v), qo, ko, causal,
                               p_dtype=torch.bfloat16)
    assert to.dtype == torch.bfloat16
    assert _rel(to, _to_torch(jo)) < BF16_REL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, :, 0], atol=2e-5, rtol=2e-5)
    if causal:
        rows = torch.from_numpy(np.stack([_masked_rows(256, 256, a, b)
                                          for a, b in zip(q_off, k_off)]))
        assert rows.any() and (to[rows] == 0).all()


@pytest.mark.parametrize("case", BF16_CASES, ids=lambda c: c[0])
def test_rounded_plain_flash_gradients_match_jax_vjp_bf16(case):
    name, d, causal, q_off, k_off = case
    q, k, v, g = _bf16_inputs(name, d)

    def vjp_rows(a, b, c, gg, qo, ko):
        _, vjp = jax.vjp(lambda x, y, z: jak.flash_attention(x, y, z, qo, ko, causal, True),
                         a, b, c)
        return vjp(gg)

    want = _jax_rows(vjp_rows, q_off, k_off, q, k, v, g)
    tq, tk, tv, tg = (_to_torch(x) for x in (q, k, v, g))
    qo, ko = (torch.tensor(x, dtype=torch.int32) for x in (q_off, k_off))
    o, lse = tak.flash_fwd_ref(tq, tk, tv, qo, ko, causal, p_dtype=torch.bfloat16)
    dd = (tg.float() * o.float()).sum(dim=-1)
    dq = tak.flash_bwd_dq_ref(tq, tk, tv, tg, lse, dd, qo, ko, causal, p_dtype=torch.bfloat16)
    dk, dv = tak.flash_bwd_dkv_ref(tq, tk, tv, tg, lse, dd, qo, ko, causal,
                                   p_dtype=torch.bfloat16)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        assert _rel(got, _to_torch(w)) < BF16_REL
    if causal:
        rows = torch.from_numpy(np.stack([_masked_rows(256, 256, a, b)
                                          for a, b in zip(q_off, k_off)]))
        assert (dq[rows] == 0).all()


def _plain_before_rounding(q, k, v, g, qo, ko, causal):
    """The plain B7 and B8 as they were before ``p_dtype`` existed: one dense
    fold, P and dS in float32 throughout."""
    s = tak._scores_ref(q, k, qo, ko, causal)
    m = torch.maximum(torch.full(s.shape[:2], tak.NEG), s.amax(dim=-1))
    p = torch.where(s <= tak.NEG / 2, 0.0, torch.exp(s - m[..., None]))
    corr = torch.exp(torch.full_like(m, tak.NEG) - m)
    l = torch.zeros_like(m) * corr + p.sum(dim=-1)
    acc = torch.zeros(q.shape) * corr[..., None] + torch.einsum("bqk,bkd->bqd", p, v.float())
    denom = torch.clamp_min(l, 1e-30)
    o, lse = (acc / denom[..., None]).to(q.dtype), m + torch.log(denom)
    dd = (g.float() * o.float()).sum(dim=-1)
    pb = torch.where(s <= tak.NEG / 2, 0.0, torch.exp(s - lse[..., None]))
    ds = pb * (torch.einsum("bqd,bkd->bqk", g.float(), v.float()) - dd[..., None])
    sc = tak.scale_of(q.shape[-1])
    dq = (sc * torch.einsum("bqk,bkd->bqd", ds, k.float())).to(q.dtype)
    dk = (sc * torch.einsum("bqk,bqd->bkd", ds, q.float())).to(k.dtype)
    dv = torch.einsum("bqk,bqd->bkd", pb, g.float()).to(v.dtype)
    return o, lse, dd, dq, dk, dv


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: c[0])
def test_plain_versions_with_float32_p_are_unchanged(case):
    """p_dtype=torch.float32 (the default) is the plain B7/B8 of before, bit
    for bit, and so is B9's fold."""
    name, bh, sq, sk, d, causal, q_off, k_off = case
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(name, bh, sq, sk, d))
    qo, ko = tak.offsets(q_off, bh, "cpu"), tak.offsets(k_off, bh, "cpu")
    o0, lse0, dd, dq0, dk0, dv0 = _plain_before_rounding(q, k, v, g, qo, ko, causal)
    o, lse = tak.flash_fwd_ref(q, k, v, qo, ko, causal, p_dtype=torch.float32)
    dq = tak.flash_bwd_dq_ref(q, k, v, g, lse, dd, qo, ko, causal, p_dtype=torch.float32)
    dk, dv = tak.flash_bwd_dkv_ref(q, k, v, g, lse, dd, qo, ko, causal, p_dtype=torch.float32)
    for got, want in ((o, o0), (lse, lse0), (dq, dq0), (dk, dk0), (dv, dv0)):
        assert torch.equal(got, want)
    state = tak.empty_state(bh, sq, d, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tak.block_update_ref(q, k, v, *state, qo, ko, causal, p_dtype=torch.float32),
        tak.block_update_ref(q, k, v, *state, qo, ko, causal)))


# (dtype, head_dim, the form or None where the wrappers raise)
FORM_CASES = [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 72, "simt"), (torch.float32, 72, "simt"), (torch.bfloat16, 8, "simt"),
    (torch.bfloat16, 136, None), (torch.float32, 136, None), (torch.float16, 64, None),
]


@pytest.mark.parametrize("case", FORM_CASES, ids=lambda c: f"{c[0]}-d{c[1]}")
def test_kernel_form_from_dtype_and_head_dim(case):
    dtype, d, form = case
    for dev in ("meta", "cpu"):
        t = torch.empty((2, 128, d), dtype=dtype, device=dev)
        if form is None:
            with pytest.raises(MLSLError):
                tak.kernel_form(t.dtype, t.shape[-1])
        else:
            assert tak.kernel_form(t.dtype, t.shape[-1]) == form
    if form is None and d <= tak.MAX_HEAD_DIM:
        return
    # a meta tensor reaches the CUDA branch of the wrapper, which refuses its device
    q = torch.empty((2, 128, d), dtype=dtype, device="meta")
    with pytest.raises(MLSLError, match="unsupported device"):
        tak.flash_fwd(q, q, q, 0, 0, True)
