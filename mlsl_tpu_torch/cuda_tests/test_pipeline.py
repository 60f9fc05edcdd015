"""The pipeline schedules (parallel/pipeline.py) on the card against the same
schedule on the CPU: 1F1B and interleaved 1F1B (loss and stage gradients),
GPipe's forward and its autograd backward, within 1e-5 relative."""

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.parallel import pipeline as pp

S, MB, D = 4, 4, 64


def _stage(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def _loss(y, t):
    return ((y - t) ** 2).mean()


def _data(m, seed, lead=()):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(*lead, 1, 2, 1, S, D, D)) / np.sqrt(D)).astype(np.float32)
    b = (rng.normal(size=(*lead, 1, 2, 1, S, D)) * 0.1).astype(np.float32)
    x = rng.normal(size=(1, 2, 1, 1, m, MB, D)).astype(np.float32)
    t = rng.normal(size=(1, 2, 1, 1, m, MB, D)).astype(np.float32)
    return {"w": w, "b": b}, x, t


def _on(arrs, dev):
    p, x, t = arrs
    p = {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
    x = torch.from_numpy(x).to(dev).expand(1, 2, 1, S, *x.shape[4:])
    t = torch.from_numpy(t).to(dev).expand(1, 2, 1, S, *t.shape[4:])
    return p, x, t


def _close(a, b, tol=1e-5):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30)) <= tol


@pytest.mark.cuda
def test_cuda_one_f1b_matches_cpu():
    arrs = _data(8, 1)
    lc, gc = pp.one_f1b_step(_stage, _loss, *_on(arrs, "cpu"), 3, S)
    lg, gg = pp.one_f1b_step(_stage, _loss, *_on(arrs, "cuda"), 3, S)
    assert _close(lg, lc)
    assert all(_close(gg[k], gc[k]) for k in gc)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 7])
def test_cuda_interleaved_matches_cpu(m):
    arrs = _data(m, 2, lead=(2,))
    lc, gc = pp.interleaved_1f1b_step(_stage, _loss, *_on(arrs, "cpu"), 3, S, 2)
    lg, gg = pp.interleaved_1f1b_step(_stage, _loss, *_on(arrs, "cuda"), 3, S, 2)
    assert _close(lg, lc)
    assert all(_close(gg[k], gc[k]) for k in gc)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_cuda_gpipe_matches_cpu(remat):
    out = {}
    for dev in ("cpu", "cuda"):
        p, x, t = _on(_data(8, 3), dev)
        p = {k: v.requires_grad_() for k, v in p.items()}
        loss = pp.pipeline_loss(_stage, _loss, p, x, t, 3, S, remat=remat)
        g = torch.autograd.grad(loss.sum(), list(p.values()))
        out[dev] = (loss, g)
    assert _close(out["cuda"][0], out["cpu"][0])
    assert all(_close(a, b) for a, b in zip(out["cuda"][1], out["cpu"][1]))
