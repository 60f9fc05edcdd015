"""B7, B8 and B9 (ops/attention_kernels.py) against their plain versions:
relative L2 error under 1e-5 in float32 (and for the lse and the carried
state), 1e-2 for bf16 outputs; fully masked rows exactly 0."""

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
