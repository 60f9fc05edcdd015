"""B7, B8 and B9 (ops/attention_kernels.py) against their plain versions:
relative L2 error under 1e-5 in float32 (and for the lse and the carried
state), 1e-2 for bf16 outputs; fully masked rows exactly 0.

The wgmma form of B7 and B8 (bf16, head_dim 64 or 128) is held twice: within
2e-3 of the plain versions that round P and dS to bf16 where the kernels do
(``p_dtype=torch.bfloat16``; lse 1e-5), which a wrong fragment layout cannot
pass, and within 1e-2 of the float32 plain versions.

B9's wgmma form the same way: its forward within 2e-3 of
``block_update_tiled_ref(p_dtype=bf16)`` (m and l 1e-5), rows that see no key
keeping their state bit for bit, m' equal to m bit for bit wherever no key
beat it, the winner the plain scores' first argmax but at near-ties; its
backward within 2e-3 of ``block_update_bwd_ref`` with P, dS and ga rounded to
bf16 (dacc, dm, dl 1e-5) and within 1e-2 of the float32 closed form, both
given the kernel's winners.

The plain versions run on the card, in float32 (torch's CUDA matmuls take no
TF32 unless asked). On the CPU, torch's exp has been seen to return one
parallel chunk of 32,768 elements about 1e-4 off (relative) on its first call
in a process, in about 1 process of 30, and a plain version computed there
then misses the 1e-5 bound by itself."""

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.ops import attention_kernels as tak

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

BU_CASES = [
    ("ring_causal", 4, 128, 128, 32, True, 128, 0, 128),
    ("noncausal", 4, 128, 256, 64, False, 0, 0, 0),
    ("future_then_past", 2, 128, 128, 16, True, 0, 128, 0),
    ("diag_d128", 2, 128, 128, 128, True, 0, 0, 0),
]


def _arrays(name, bh, sq, sk, d):
    rng = np.random.default_rng(sum(map(ord, name)))
    mk = lambda s: rng.normal(size=(bh, s, d)).astype(np.float32)  # noqa: E731
    return mk(sq), mk(sk), mk(sk), mk(sq)


def _masked_rows(sq, sk, q_off, k_off):
    """Rows whose every key lies in their future."""
    return q_off + np.arange(sq) < k_off


def _state_arrays(rng, bh, sq, d):
    m = rng.normal(size=(bh, sq)).astype(np.float32)
    return (rng.normal(size=(bh, sq, d)).astype(np.float32), m,
            rng.uniform(0.5, 2.0, size=(bh, sq)).astype(np.float32))


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _assert_rel(got, want, tol, what, again=None):
    """The relative L2 error of ``got`` against ``want`` under ``tol``; a
    failure names the worst element, the (bh, row) pairs that differ by more
    than 1e-3, and, given ``again`` (a call that gives the kernel's output and
    the plain version's once more on the same inputs), whether each repeats
    its own result bit for bit."""
    rel = _rel(got, want)
    if rel < tol:
        return
    diff = (got.float() - want.float()).abs()
    at = int(diff.argmax())
    worst = tuple(int(i) for i in np.unravel_index(at, tuple(diff.shape)))
    rows = (diff.reshape(diff.shape[0], diff.shape[1], -1).amax(-1) > 1e-3).nonzero().tolist()
    note = ""
    if again is not None:
        got2, want2 = again()
        note = (f"; repeated bit for bit: kernel {torch.equal(got2, got)}, plain "
                f"{torch.equal(want2, want)}")
    raise AssertionError(
        f"{what}: relative error {rel:.3g} >= {tol:g}; worst |diff| {float(diff.max()):.3g} "
        f"at {worst} (got {float(got.flatten()[at]):.6g}, want "
        f"{float(want.flatten()[at]):.6g}); {len(rows)} (bh, row) pairs off by > 1e-3, "
        f"first {rows[:8]}{note}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: c[0])
def test_cuda_flash_kernels_match_plain(case, dtype):
    name, bh, sq, sk, d, causal, q_off, k_off = case
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(a).cuda().to(dt) for a in _arrays(name, bh, sq, sk, d))
    tol = 1e-5 if dtype == "float32" else 1e-2
    qo, ko = tak.offsets(q_off, bh, "cuda"), tak.offsets(k_off, bh, "cuda")
    o, lse = tak.flash_fwd(q, k, v, q_off, k_off, causal)
    ro, rl = tak.flash_fwd_ref(q, k, v, qo, ko, causal)
    _assert_rel(o, ro, tol, "flash_fwd out",
                lambda: (tak.flash_fwd(q, k, v, q_off, k_off, causal)[0],
                         tak.flash_fwd_ref(q, k, v, qo, ko, causal)[0]))
    _assert_rel(lse, rl, 1e-5, "flash_fwd lse")
    dd = (g.float() * o.float()).sum(-1)
    dq = tak.flash_bwd_dq(q, k, v, g, lse, dd, q_off, k_off, causal)
    dk, dv = tak.flash_bwd_dkv(q, k, v, g, lse, dd, q_off, k_off, causal)
    _assert_rel(dq, tak.flash_bwd_dq_ref(q, k, v, g, lse, dd, qo, ko, causal), tol,
                "flash_bwd_dq")
    for what, got, want in zip(("dk", "dv"), (dk, dv),
                               tak.flash_bwd_dkv_ref(q, k, v, g, lse, dd, qo, ko, causal)):
        _assert_rel(got, want, tol, f"flash_bwd_dkv {what}")
    if causal:
        rows = torch.from_numpy(_masked_rows(sq, sk, q_off, k_off))
        assert (o.cpu()[:, rows] == 0).all() and (dq.cpu()[:, rows] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", BU_CASES, ids=lambda c: c[0])
def test_cuda_block_update_matches_plain(case):
    name, bh, sq, sk, d, causal, q_off, k_off, _ = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, s, d)).astype(np.float32)).cuda()
               for s in (sq, sk, sk))
    state = [torch.from_numpy(x).cuda() for x in _state_arrays(rng, bh, sq, d)]
    got = tak.block_update(q, k, v, *state, q_off, k_off, causal)
    want = tak.block_update_ref(q, k, v, *state, tak.offsets(q_off, bh, "cuda"),
                                tak.offsets(k_off, bh, "cuda"), causal)
    for what, a, b in zip(("acc", "m", "l"), got, want):
        _assert_rel(a, b, 1e-5, f"block_update {what}")


# (name, bh, sq, sk, d, causal, q_off, k_off): offsets are one value or one per row
SM90_CASES = [
    ("causal_d64", 4, 256, 256, 64, True, 0, 0),
    ("causal_d128", 2, 256, 256, 128, True, 0, 0),
    ("noncausal_sq_ne_sk", 2, 256, 384, 64, False, 0, 0),
    ("noncausal_d128", 2, 128, 256, 128, False, 0, 0),
    ("causal_sq_ne_sk_later_queries", 2, 256, 512, 64, True, 256, 0),
    ("per_row_offsets_rows_masked", 4, 256, 256, 64, True, [0, 0, 128, 0], [0, 100, 0, 512]),
    ("offsets_skip_tiles_d128", 2, 384, 256, 128, True, [0, 64], [128, 320]),
]


def _offs(off, bh):
    return tak.offsets(torch.tensor(off, dtype=torch.int32) if isinstance(off, list) else off,
                       bh, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SM90_CASES, ids=lambda c: c[0])
def test_cuda_sm90_flash_kernels_match_both_plain_versions(case):
    name, bh, sq, sk, d, causal, q_off, k_off = case
    assert tak.kernel_form(torch.bfloat16, d) == "sm90"
    q, k, v, g = (torch.from_numpy(a).cuda().bfloat16() for a in _arrays(name, bh, sq, sk, d))
    qo, ko = _offs(q_off, bh), _offs(k_off, bh)
    before = dict(tak.LAUNCHES)
    o, lse = tak.flash_fwd(q, k, v, qo, ko, causal)
    dd = (g.float() * o.float()).sum(-1)
    dq = tak.flash_bwd_dq(q, k, v, g, lse, dd, qo, ko, causal)
    dk, dv = tak.flash_bwd_dkv(q, k, v, g, lse, dd, qo, ko, causal)
    torch.cuda.synchronize()
    for key in ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"):
        assert tak.LAUNCHES[key] == before[key] + 1
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    for p_dtype, tol in ((torch.bfloat16, 2e-3), (torch.float32, 1e-2)):
        ro, rl = tak.flash_fwd_ref(q, k, v, qo, ko, causal, p_dtype=p_dtype)
        rdq = tak.flash_bwd_dq_ref(q, k, v, g, lse, dd, qo, ko, causal, p_dtype=p_dtype)
        rdk, rdv = tak.flash_bwd_dkv_ref(q, k, v, g, lse, dd, qo, ko, causal, p_dtype=p_dtype)
        want = {"o": ro, "dq": rdq, "dk": rdk, "dv": rdv}
        for key in got:
            rel = _rel(got[key], want[key])
            assert rel < tol, (str(p_dtype), key, rel)
        live = rl > tak.NEG / 2
        assert _rel(lse[live], rl[live]) < 1e-5
        assert torch.equal(lse[~live], rl[~live])
    q_pos = qo[:, None] + torch.arange(sq, device="cuda")
    k_pos = ko[:, None] + torch.arange(sk, device="cuda")
    if causal:
        dead_q = q_pos < ko[:, None]                        # rows that see no key
        dead_k = k_pos > q_pos[:, -1:]                      # keys no query sees
        assert (o[dead_q] == 0).all() and (dq[dead_q] == 0).all()
        assert (dk[dead_k] == 0).all() and (dv[dead_k] == 0).all()
        assert bool((~dead_q).any()) == bool((dq != 0).any())


# (name, bh, sq, sk, d, causal, q_off, k_off, state): B9's wgmma form at the
# transformer paths' shapes with fewer rows (the zigzag chunk's diagonal on a
# fresh state and its full fold on a carried one; the ring's second hop, whose
# offsets hide every row of half the ranks), at head_dim 128, and folding a
# block into the state its own fold gave, where m ties each row's maximal score
BU_SM90_CASES = [
    ("zigzag_diagonal", 16, 512, 512, 64, True, 0, 0, "fresh"),
    ("zigzag_full_fold", 16, 512, 512, 64, False, 0, 0, "carried"),
    ("ring_hop_rows_masked", 8, 1024, 1024, 64, True, [0] * 4 + [1024] * 4,
     [1024] * 4 + [0] * 4, "carried"),
    ("d128_causal_offsets", 4, 256, 384, 128, True, [0, 64, 0, 256], [128, 0, 200, 0],
     "carried"),
    ("same_block_twice", 16, 512, 512, 64, False, 0, 0, "refold"),
]
BU_KEYS = ("block_update_sm90", "block_update_bwd_dq_sm90", "block_update_bwd_dkv_sm90")


def _near_tie(s, m, a, b):
    """Rows where winners ``a`` and ``b`` (key index, -1 for m) name candidates
    whose float32 scores lie within 1e-5 of each other (relative)."""
    pick = lambda w: torch.where(w >= 0, s.gather(-1, w.clamp_min(0).long()[..., None])[..., 0],
                                 m)  # noqa: E731
    x, y = pick(a), pick(b)
    return (x - y).abs() <= 1e-5 * torch.maximum(x.abs(), y.abs()).clamp_min(1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BU_SM90_CASES, ids=lambda c: c[0])
def test_cuda_sm90_block_update_and_backward_match_plain(case):
    name, bh, sq, sk, d, causal, q_off, k_off, kind = case
    assert tak.kernel_form(torch.bfloat16, d) == "sm90"
    rng = np.random.default_rng(sum(map(ord, name)))
    mk = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()  # noqa
    q, k, v = mk(bh, sq, d).bfloat16(), mk(bh, sk, d).bfloat16(), mk(bh, sk, d).bfloat16()
    qo, ko = _offs(q_off, bh), _offs(k_off, bh)
    if kind == "carried":
        state = (mk(bh, sq, d), mk(bh, sq),
                 torch.from_numpy(rng.uniform(0.5, 2.0, (bh, sq)).astype(np.float32)).cuda())
    else:
        state = tak.empty_state(bh, sq, d, "cuda")
        if kind == "refold":
            state = tak.block_update(q, k, v, *state, qo, ko, causal)
    before = dict(tak.LAUNCHES)
    acc_n, m_n, l_n, win = tak.block_update(q, k, v, *state, qo, ko, causal, want_winner=True)
    bare = tak.block_update(q, k, v, *state, qo, ko, causal)
    ga, gm, gl = mk(bh, sq, d), mk(bh, sq), mk(bh, sq)
    grads = tak.block_update_bwd(q, k, v, *state, m_n, l_n, acc_n, win, ga, gm, gl, qo, ko,
                                 causal)
    torch.cuda.synchronize()
    ran = {key: tak.LAUNCHES[key] - before[key] for key in tak.LAUNCHES}
    assert ran == {**{key: 0 for key in ran}, "block_update_sm90": 2,
                   "block_update_bwd_dq_sm90": 1, "block_update_bwd_dkv_sm90": 1}, ran
    # the variant without the winner computes the same state, bit for bit
    assert all(torch.equal(a, b) for a, b in zip((acc_n, m_n, l_n), bare))

    r_acc, r_m, r_l = tak.block_update_tiled_ref(q, k, v, *state, qo, ko, causal,
                                                 p_dtype=torch.bfloat16)
    live = r_m > tak.NEG / 2
    assert _rel(acc_n, r_acc) < 2e-3
    assert _rel(m_n[live], r_m[live]) < 1e-5 and torch.equal(m_n[~live], r_m[~live])
    assert _rel(l_n, r_l) < 1e-5
    q_pos = qo[:, None] + torch.arange(sq, device="cuda")
    dead = q_pos < ko[:, None] if causal else torch.zeros_like(live)
    assert bool(dead.any()) == (name == "ring_hop_rows_masked" or name.startswith("d128"))
    for got, was in zip((acc_n, m_n, l_n), state):
        assert torch.equal(got[dead], was[dead])
    kept = win < 0
    assert torch.equal(m_n[kept], state[1][kept])
    w_ref = tak.block_update_winner_ref(q, k, state[1], qo, ko, causal)
    s = tak._scores_ref(q, k, qo, ko, causal)
    off = win != w_ref
    # folded twice, m keeps every row (the kernel gives a tie to m); the
    # plain scores, from another product, may put a key a rounding above it
    assert bool(kept.all()) if kind == "refold" else int(off.sum()) <= max(1, win.numel() // 10000)
    assert bool(_near_tie(s, state[1], win, w_ref)[off].all())

    for p_dtype, tol in ((torch.bfloat16, 2e-3), (torch.float32, 1e-2)):
        want = tak.block_update_bwd_ref(q, k, v, *state, m_n, l_n, acc_n, ga, gm, gl, qo, ko,
                                        causal, p_dtype=p_dtype, g_dtype=p_dtype, win=win)
        for i, (got, w) in enumerate(zip(grads, want)):
            assert got.dtype == w.dtype
            rel = _rel(got, w)
            assert rel < (tol if i < 3 else 1e-5), (str(p_dtype), i, rel)
    dq, dk, dv = grads[:3]
    if causal:
        assert (dq[dead] == 0).all()
        k_pos = ko[:, None] + torch.arange(sk, device="cuda")
        unseen = k_pos > q_pos[:, -1:]
        assert (dk[unseen] == 0).all() and (dv[unseen] == 0).all()
