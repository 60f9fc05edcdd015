"""B7, B8 and B9 (ops/attention_kernels.py) against their plain versions:
relative L2 error under 1e-5 in float32 (and for the lse and the carried
state), 1e-2 for bf16 outputs; fully masked rows exactly 0.

The wgmma form of B7 and B8 (bf16, head_dim 64 or 128) is held twice: within
2e-3 of the plain versions that round P and dS to bf16 where the kernels do
(``p_dtype=torch.bfloat16``; lse 1e-5), which a wrong fragment layout cannot
pass, and within 1e-2 of the float32 plain versions."""

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: c[0])
def test_cuda_flash_kernels_match_plain(case, dtype):
    name, bh, sq, sk, d, causal, q_off, k_off = case
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(a).cuda().to(dt) for a in _arrays(name, bh, sq, sk, d))
    tol = 1e-5 if dtype == "float32" else 1e-2
    o, lse = tak.flash_fwd(q, k, v, q_off, k_off, causal)
    ro, rl = tak.flash_fwd(q.cpu(), k.cpu(), v.cpu(), q_off, k_off, causal)
    assert _rel(o.cpu(), ro) < tol and _rel(lse.cpu(), rl) < 1e-5
    dd = (g.float() * o.float()).sum(-1)
    dq = tak.flash_bwd_dq(q, k, v, g, lse, dd, q_off, k_off, causal)
    dk, dv = tak.flash_bwd_dkv(q, k, v, g, lse, dd, q_off, k_off, causal)
    cpu = [t.cpu() for t in (q, k, v, g, lse, dd)]
    assert _rel(dq.cpu(), tak.flash_bwd_dq(*cpu, q_off, k_off, causal)) < tol
    for got, want in zip((dk, dv), tak.flash_bwd_dkv(*cpu, q_off, k_off, causal)):
        assert _rel(got.cpu(), want) < tol
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
    want = tak.block_update(q.cpu(), k.cpu(), v.cpu(), *(s.cpu() for s in state), q_off,
                            k_off, causal)
    for a, b in zip(got, want):
        assert _rel(a.cpu(), b) < 1e-5


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
