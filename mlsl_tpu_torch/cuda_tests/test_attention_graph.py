"""B7 and B8 in their wgmma form (``csrc/attention_sm90.cu``) recorded in a
CUDA graph and replayed, against the same launches made eagerly: bit for bit.
The fused transformer step replays them inside its graph (models/
transformer.py), so every launch must be capture-safe: its attributes set,
its TMA descriptors built and its offsets filled on the device while the
graph records.

Each case: the flash forward (with the lse) and both backward passes through
``flash_attention``'s autograd Function, captured after one eager warm-up on
a side stream, then replayed on new inputs copied into the graph's static
ones. The recorded launches count once, at capture."""

import pytest
import torch

from mlsl_tpu_torch.ops import attention_kernels as ak

# (bh, s, d, causal): run (a)'s shape cut to 2 heads of a batch row, and head_dim 128
CASES = [(16, 2048, 64, True), (4, 512, 128, True), (8, 1024, 64, False)]


def _step(q, k, v, g, causal):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = ak.flash_attention(q, k, v, 0, 0, causal)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    return out.detach(), dq, dk, dv


def _inputs(gen, bh, s, d):
    return [torch.randn((bh, s, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,causal", CASES, ids=lambda c: str(c))
def test_cuda_sm90_flash_graph_replay_bit_exact(bh, s, d, causal):
    assert ak.kernel_form(torch.bfloat16, d) == "sm90"
    gen = torch.Generator(device="cuda").manual_seed(bh * s + d)
    static = _inputs(gen, bh, s, d)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _step(*static, causal)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    keys = ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90")
    before = {k: ak.LAUNCHES[k] for k in keys}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = _step(*static, causal)
    assert {k: ak.LAUNCHES[k] - before[k] for k in keys} == dict.fromkeys(keys, 1)
    for rnd in range(2):
        fresh = _inputs(gen, bh, s, d)
        for t, f in zip(static, fresh):
            t.copy_(f)
        graph.replay()
        want = _step(*fresh, causal)
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "dq", "dk", "dv"), outs, want):
            assert torch.equal(a, b), f"{name} differs after replay {rnd}"
    assert {k: ak.LAUNCHES[k] - before[k] for k in keys} == dict.fromkeys(keys, 3)
