"""B9's backward in closed form and the plain versions of B9's wgmma form
(mlsl_tpu_torch.ops.attention_kernels) against the JAX package's
``flash_block_update`` under the Pallas interpreter, whose vjp (``_bu_bwd``)
is ``jax.vjp`` of ``_block_update_ref``.

- ``block_update_bwd_ref`` (what ``_BlockUpdate`` runs on the CPU) against
  JAX's vjp at random cotangents (ga, gm, gl), gm included: from a fresh and
  a carried state, causal with per-row offsets that hide whole rows, rows
  where m wins and rows where a score wins, an exact tie between m and the
  block maximum, two equal maximal scores in one row (small-integer inputs at
  head_dim 16, whose scale 1/4 keeps every score exact on both sides). Float32
  inputs; 1e-4 absolute and relative, the existing GTOL: the two sides sum
  the same terms in another order.
- The closed form against torch's autograd through ``block_update_ref``,
  ties included: 1e-5.
- The rounded closed form (``p_dtype``, ``g_dtype`` bf16, what the wgmma
  backward computes) and the 64-key-tiled rounded forward
  (``block_update_tiled_ref``, the wgmma forward's oracle) against JAX on
  bf16 inputs: relative L2 error under 1e-2, as the rounded B7/B8 are held;
  m and l within 2e-5.
- The winner that B9's forward returns on request against the first argmax
  of the scores computed in numpy; ``pick_form`` for ``block_update``; no
  launch counted on the CPU.

The kernels themselves meet these plain versions on the card:
mlsl_tpu_torch/cuda_tests/test_attention_kernels.py and chip_smoke.py.
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

GTOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 1e-2
SQ = SK = 128
BH = 4

# (name, d, causal, q_off per row, k_off per row, state, data): state "fresh"
# (acc 0, m NEG, l 0), "carried" (random), "m_wins" (half the rows carry an m
# above every score), "tie" (m equal to the row's block maximum, or one above
# or one below it, row by row); data "normal" or "int" (small integers)
CASES = [
    ("fresh_noncausal", 32, False, [0] * 4, [0] * 4, "fresh", "normal"),
    ("fresh_causal_diagonal", 64, True, [0] * 4, [0] * 4, "fresh", "normal"),
    ("carried_noncausal_d128", 128, False, [0] * 4, [0] * 4, "carried", "normal"),
    ("carried_row_offsets_hide_rows", 32, True, [0, 0, 128, 64], [0, 64, 200, 192],
     "carried", "normal"),
    ("m_wins_half_the_rows", 16, True, [128] * 4, [0, 64, 128, 0], "m_wins", "normal"),
    ("ties_m_and_equal_maxima", 16, True, [0, 64, 0, 128], [0, 0, 32, 0], "tie", "int"),
    ("ties_equal_maxima_noncausal", 16, False, [0] * 4, [0] * 4, "tie", "int"),
]


def _inputs(name, d, data):
    rng = np.random.default_rng(sum(map(ord, name)))
    if data == "int":
        q, k, v = (rng.integers(-2, 3, size=(BH, n, d)).astype(np.float32) for n in (SQ, SK, SK))
        k[:, 7] = k[:, 3]            # two equal keys: equal scores in every row
    else:
        q, k, v = (rng.normal(size=(BH, n, d)).astype(np.float32) for n in (SQ, SK, SK))
    return rng, q, k, v


def _scores(q, k, q_off, k_off, causal):
    """(BH, Sq, Sk) float64 scaled scores, NEG where hidden."""
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k.astype(np.float64)) / np.sqrt(q.shape[-1])
    if causal:
        q_pos = np.asarray(q_off)[:, None] + np.arange(q.shape[1])
        k_pos = np.asarray(k_off)[:, None] + np.arange(k.shape[1])
        s = np.where(k_pos[:, None, :] <= q_pos[:, :, None], s, jak.NEG)
    return s


def _state(rng, kind, s, d):
    """(acc, m, l) float32 of the case's kind for scores ``s``."""
    bh, sq = s.shape[:2]
    if kind == "fresh":
        return (np.zeros((bh, sq, d), np.float32), np.full((bh, sq), jak.NEG, np.float32),
                np.zeros((bh, sq), np.float32))
    acc = rng.normal(size=(bh, sq, d)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, size=(bh, sq)).astype(np.float32)
    s_max = s.max(axis=-1)
    if kind == "carried":
        m = rng.normal(size=(bh, sq))
    elif kind == "m_wins":          # even rows: m above every score; odd rows: far below
        m = np.where(np.arange(sq) % 2 == 0, np.maximum(s_max, 0) + 3.0,
                     rng.normal(size=(bh, sq)) - 6.0)
    else:                           # tie: m = the block maximum, one above, one below
        shift = np.array([0.0, 1.0, -1.0])[np.arange(sq) % 3]
        m = np.where(s_max > jak.NEG / 2, s_max + shift, 0.0)
    return acc, m.astype(np.float32), l


def _case_arrays(case):
    """-> (q, k, v, state, cotangents of (acc', m', l'), float64 scores)."""
    name, d, causal, q_off, k_off, kind, data = case
    rng, q, k, v = _inputs(name, d, data)
    s = _scores(q, k, q_off, k_off, causal)
    state = _state(rng, kind, s, d)
    cot = tuple(rng.normal(size=x.shape).astype(np.float32) for x in state)
    return q, k, v, state, cot, s


def _lanes(x):
    return jnp.broadcast_to(jnp.asarray(x)[..., None], (*x.shape, 128))


def _jax_vjp(q, k, v, state, cot, q_off, k_off, causal):
    """JAX's gradients (dq, dk, dv, dacc, dm, dl) at cotangents ``cot``, one
    call a row (JAX's offsets are one scalar a call); m and l's lane 0."""
    zero_lanes = lambda x: jnp.zeros((*x.shape, 128), jnp.float32).at[..., 0].set(x)  # noqa
    rows = []
    for b in range(q.shape[0]):
        qo, ko = jnp.asarray([q_off[b]], jnp.int32), jnp.asarray([k_off[b]], jnp.int32)

        def fn(q_, k_, v_, a_, m_, l_):
            return jak.flash_block_update(q_, k_, v_, a_, m_, l_, qo, ko, causal, True)

        one = lambda x: jnp.asarray(x[b:b + 1])  # noqa: E731
        acc, m, l = state
        _, vjp = jax.vjp(fn, one(q), one(k), one(v), one(acc), _lanes(m[b:b + 1]),
                         _lanes(l[b:b + 1]))
        ga, gm, gl = cot
        g = vjp((one(ga), zero_lanes(jnp.asarray(gm[b:b + 1])),
                 zero_lanes(jnp.asarray(gl[b:b + 1]))))
        rows.append([np.asarray(x, np.float32) for x in g[:4]]
                    + [np.asarray(g[4])[..., 0], np.asarray(g[5])[..., 0]])
    return [np.concatenate(parts) for parts in zip(*rows)]


def _offs(off):
    return torch.tensor(off, dtype=torch.int32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_closed_form_backward_matches_jax_vjp(case):
    """``_BlockUpdate``'s backward on the CPU, the closed form, against JAX."""
    name, d, causal, q_off, k_off, kind, _ = case
    q, k, v, state, cot, s = _case_arrays(case)
    if kind == "m_wins":
        assert (state[1][:, ::2] > s.max(axis=-1)[:, ::2]).all()
        assert (state[1][:, 1::2] < s.max(axis=-1)[:, 1::2]).all()
    if kind == "tie":
        live = s.max(axis=-1) > jak.NEG / 2
        assert (state[1][live] == s.max(axis=-1)[live]).any()
        top = np.sort(s, axis=-1)
        assert (top[..., -1] == top[..., -2])[live].any()      # equal maximal scores
    if name == "carried_row_offsets_hide_rows":
        hidden = (np.asarray(q_off)[:, None] + np.arange(SQ)) < np.asarray(k_off)[:, None]
        assert hidden.any() and not hidden.all()
    want = _jax_vjp(q, k, v, state, cot, q_off, k_off, causal)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, *state)]
    outs = tak.flash_block_update(*ts, _offs(q_off), _offs(k_off), causal)
    got = torch.autograd.grad(outs, ts, tuple(torch.from_numpy(x) for x in cot))
    for i, (gt, gw) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gt.numpy(), gw, **GTOL, err_msg=f"input {i}")
    assert all(n == 0 for n in tak.LAUNCHES.values())


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_closed_form_equals_autograd_through_plain_version(case):
    """The closed form is torch's own vjp of ``block_update_ref``, ties and
    all (maximum's 0.5/0.5, amax's even split)."""
    _, _, causal, q_off, k_off, _, _ = case
    q, k, v, state, cot, _ = _case_arrays(case)
    qo, ko = _offs(q_off), _offs(k_off)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, *state)]
    outs = tak.block_update_ref(*ins, qo, ko, causal)
    want = torch.autograd.grad(outs, ins, tuple(torch.from_numpy(x) for x in cot))
    acc_n, m_n, l_n = (t.detach() for t in outs)
    got = tak.block_update_bwd_ref(*(t.detach() for t in ins), m_n, l_n, acc_n,
                                   *(torch.from_numpy(x) for x in cot), qo, ko, causal)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=f"input {i}")


# (name, d, causal, q_off per row, k_off per row): bf16 inputs, carried state
BF16_CASES = [
    ("bf16_d64_causal_row_offsets", 64, True, [0, 128, 0, 256], [0, 0, 100, 0]),
    ("bf16_d128_noncausal", 128, False, [0] * 4, [0] * 4),
]


def _bf16_case(case, sk=256):
    name, d, causal, q_off, k_off = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v = (rng.normal(size=(BH, n, d)).astype(np.float32) for n in (SQ, sk, sk))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(torch.bfloat16)
                  for x in (jq, jk, jv))
    state = (rng.normal(size=(BH, SQ, d)).astype(np.float32),
             rng.normal(size=(BH, SQ)).astype(np.float32),
             rng.uniform(0.5, 2.0, size=(BH, SQ)).astype(np.float32))
    cot = tuple(rng.normal(size=x.shape).astype(np.float32) for x in state)
    return (jq, jk, jv), (tq, tk, tv), state, cot


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("case", BF16_CASES, ids=lambda c: c[0])
def test_tiled_rounded_forward_matches_jax_bf16(case):
    """The wgmma forward's oracle: ``block_update_ref(p_dtype=bf16)`` folded
    over 64-key tiles, against JAX's kernel on the same bf16 inputs."""
    _, d, causal, q_off, k_off = case
    jx, tx, state, _ = _bf16_case(case)
    want = []
    for b in range(BH):
        qo, ko = jnp.asarray([q_off[b]], jnp.int32), jnp.asarray([k_off[b]], jnp.int32)
        acc, m, l = state
        out = jak.flash_block_update(*(x[b:b + 1] for x in jx), jnp.asarray(acc[b:b + 1]),
                                     _lanes(m[b:b + 1]), _lanes(l[b:b + 1]), qo, ko, causal,
                                     True)
        want.append([np.asarray(out[0]), np.asarray(out[1])[..., 0], np.asarray(out[2])[..., 0]])
    want = [np.concatenate(p) for p in zip(*want)]
    got = tak.block_update_tiled_ref(*tx, *(torch.from_numpy(x) for x in state), _offs(q_off),
                                     _offs(k_off), causal, p_dtype=torch.bfloat16)
    assert _rel(got[0].numpy(), want[0]) < BF16_REL
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=2e-5, rtol=2e-5)
    one_shot = tak.block_update_ref(*tx, *(torch.from_numpy(x) for x in state), _offs(q_off),
                                    _offs(k_off), causal)
    assert torch.equal(got[1], one_shot[1])      # the maximum is the same fold's


@pytest.mark.parametrize("case", BF16_CASES, ids=lambda c: c[0])
def test_rounded_closed_form_matches_jax_vjp_bf16(case):
    """``block_update_bwd_ref`` with P, dS (``p_dtype``) and ga (``g_dtype``)
    rounded to bf16 where the wgmma passes round them, from the tiled
    rounded forward's state, against JAX's vjp on the same bf16 inputs."""
    _, d, causal, q_off, k_off = case
    jx, tx, state, cot = _bf16_case(case)
    want = _jax_vjp(*(np.asarray(jnp.asarray(x, jnp.float32)) for x in jx), state, cot,
                    q_off, k_off, causal)
    want[:3] = _jax_vjp_bf16(jx, state, cot, q_off, k_off, causal)
    qo, ko = _offs(q_off), _offs(k_off)
    st = tuple(torch.from_numpy(x) for x in state)
    acc_n, m_n, l_n = tak.block_update_tiled_ref(*tx, *st, qo, ko, causal, p_dtype=torch.bfloat16)
    got = tak.block_update_bwd_ref(*tx, *st, m_n, l_n, acc_n,
                                   *(torch.from_numpy(x) for x in cot), qo, ko, causal,
                                   p_dtype=torch.bfloat16, g_dtype=torch.bfloat16)
    for i, (gt, gw) in enumerate(zip(got, want)):
        if i < 3:
            assert gt.dtype == torch.bfloat16
        assert _rel(gt.float().numpy(), gw) < BF16_REL, i


def _jax_vjp_bf16(jx, state, cot, q_off, k_off, causal):
    """JAX's (dq, dk, dv) on the bf16 inputs themselves, one call a row."""
    out = []
    for b in range(BH):
        qo, ko = jnp.asarray([q_off[b]], jnp.int32), jnp.asarray([k_off[b]], jnp.int32)
        acc, m, l = state

        def fn(q_, k_, v_):
            return jak.flash_block_update(q_, k_, v_, jnp.asarray(acc[b:b + 1]),
                                          _lanes(m[b:b + 1]), _lanes(l[b:b + 1]), qo, ko,
                                          causal, True)

        _, vjp = jax.vjp(fn, *(x[b:b + 1] for x in jx))
        zero_lanes = lambda x: jnp.zeros((*x.shape, 128), jnp.float32).at[..., 0].set(x)  # noqa
        ga, gm, gl = cot
        g = vjp((jnp.asarray(ga[b:b + 1]), zero_lanes(jnp.asarray(gm[b:b + 1])),
                 zero_lanes(jnp.asarray(gl[b:b + 1]))))
        out.append([np.asarray(jnp.asarray(x, jnp.float32)) for x in g])
    return [np.concatenate(p) for p in zip(*out)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_winner_is_the_first_argmax_where_it_beats_m(case):
    _, _, causal, q_off, k_off, _, _ = case
    q, k, v, state, _, s = _case_arrays(case)
    ts = [torch.from_numpy(x) for x in (q, k, v, *state)]
    *outs, win = tak.block_update(*ts, _offs(q_off), _offs(k_off), causal, want_winner=True)
    want = np.where(s.max(axis=-1) > state[1], s.argmax(axis=-1), -1)
    np.testing.assert_array_equal(win.numpy(), want)
    assert win.dtype == torch.int32
    assert all(torch.equal(a, b) for a, b in zip(
        outs, tak.block_update(*ts, _offs(q_off), _offs(k_off), causal)))
    # where no key beats m, m' is m bit for bit
    kept = want < 0
    np.testing.assert_array_equal(outs[1].numpy()[kept], state[1][kept])
    assert all(n == 0 for n in tak.LAUNCHES.values())


# (dtype, head_dim, form asked for, the form launched or None where it raises)
PICK_CASES = [
    (torch.bfloat16, 64, None, "sm90"), (torch.bfloat16, 128, None, "sm90"),
    (torch.bfloat16, 64, "simt", "simt"), (torch.bfloat16, 64, "sm90", "sm90"),
    (torch.float32, 64, None, "simt"), (torch.float32, 64, "sm90", None),
    (torch.bfloat16, 32, None, "simt"), (torch.bfloat16, 32, "sm90", None),
    (torch.bfloat16, 136, None, None),
]


@pytest.mark.parametrize("case", PICK_CASES, ids=lambda c: f"{c[0]}-d{c[1]}-{c[2]}")
def test_block_update_form_routing(case):
    """``block_update`` routes as B7/B8 do; on a device that is neither the
    CPU nor a card every B9 wrapper raises instead of falling back."""
    dtype, d, form, want = case
    q = torch.empty((2, 128, d), dtype=dtype, device="meta")
    if want is None:
        with pytest.raises(MLSLError):
            tak.pick_form("block_update", q, form)
    else:
        assert tak.pick_form("block_update", q, form) == want
    if d > tak.MAX_HEAD_DIM:
        return
    acc, m = torch.empty((2, 128, d), device="meta"), torch.empty((2, 128), device="meta")
    with pytest.raises(MLSLError, match="unsupported device"):
        tak.block_update(q, q, q, acc, m, m, 0, 0, True, want_winner=True, form=form)
    with pytest.raises(MLSLError, match="unsupported device"):
        tak.block_update_bwd(q, q, q, acc, m, m, m, m, acc, None, acc, m, m, 0, 0, True)


def test_no_grad_forward_gives_no_winner_and_saves_nothing():
    """Without a gradient to take, B9's autograd Function runs the plain
    forward alone (on the card: the wgmma forward without the winner)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 128, 16)).astype(np.float32))
               for _ in range(3))
    state = tak.empty_state(2, 128, 16, "cpu")
    q.requires_grad_(True)
    with torch.no_grad():
        outs = tak.flash_block_update(q, k, v, *state, 0, 0, True)
    assert all(t.grad_fn is None for t in outs)
    want = tak.block_update_ref(q.detach(), k, v, *state, tak.offsets(0, 2, "cpu"),
                                tak.offsets(0, 2, "cpu"), True)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_winner_rule_equals_tie_split_where_no_row_ties(case):
    """The kernels' rule (the term through the max to the first maximal key,
    or to m where it is not beaten: ``win=``) gives torch's split wherever a
    row has no tie; a tie moves the term only within its row."""
    _, _, causal, q_off, k_off, kind, _ = case
    q, k, v, state, cot, s = _case_arrays(case)
    qo, ko = _offs(q_off), _offs(k_off)
    ts = [torch.from_numpy(x) for x in (q, k, v, *state)]
    acc_n, m_n, l_n = tak.block_update_ref(*ts, qo, ko, causal)
    win = tak.block_update_winner_ref(ts[0], ts[1], ts[4], qo, ko, causal)
    args = (*ts, m_n, l_n, acc_n, *(torch.from_numpy(x) for x in cot), qo, ko, causal)
    split, rule = tak.block_update_bwd_ref(*args), tak.block_update_bwd_ref(*args, win=win)
    s_max = s.max(axis=-1)
    live = s_max > jak.NEG / 2            # a row that sees no key: m wins either way
    tied = live & (((s == s_max[..., None]).sum(-1) > 1) | (s_max == state[1]))
    assert tied.any() == (kind == "tie")
    rows = torch.from_numpy(~tied)
    for i in (0, 4):                  # dq and dm: per query row
        np.testing.assert_allclose(rule[i][rows].numpy(), split[i][rows].numpy(), atol=1e-6,
                                   rtol=1e-6)
    for i in (1, 2, 3, 5):            # dk, dv: sums over rows; dacc, dl: no max term
        if kind != "tie" or i in (2, 3, 5):
            np.testing.assert_allclose(rule[i].numpy(), split[i].numpy(), atol=1e-6, rtol=1e-6)
    if kind == "tie":
        assert not np.allclose(rule[0].numpy(), split[0].numpy(), atol=1e-6, rtol=1e-6)
