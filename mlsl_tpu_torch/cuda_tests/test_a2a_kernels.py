"""B6 (ops/a2a_kernels.py) against its plain version, bit for bit: the dense
and int8 exchange, and the error-feedback form over two rounds (outputs and
residuals)."""

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.comm import algos as talgos
from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
from mlsl_tpu_torch.ops import a2a_kernels as ta2a

BLOCK = 128
UNIT = BLOCK * 32           # the int8 chunk unit (block x ROW_TILE)
ROUNDS = 2

DENSE_CASES = [(8, 1, ("data",), 8 * 640), (4, 2, ("data",), 4 * 512), (4, 2, ("model",), 2 * 512),
               (4, 2, ("data", "model"), 8 * 300 + 8 * 3)]
QUANT_CASES = [(8, 1, ("data",), 8 * UNIT, 128), (4, 2, ("model",), 2 * 3 * BLOCK, 128),
               (4, 2, ("data",), 4 * UNIT, 256), (4, 2, ("data", "model"), 8 * 2 * BLOCK, 128),
               (8, 1, ("data",), 8 * 4096, 1024)]
EF_CASES = [("ef_g8", 8, 1, ("data",), 8 * UNIT, 128), ("ef_g2", 4, 2, ("model",), 2 * 3 * 256, 256),
            ("ef_g4x2", 4, 2, ("data", "model"), 8 * 1000, 128)]


def _group(d, m, axes):
    return ProcessGroup(Topology(d, m, 8), axes)


def _ef_inputs(name, grid, count):
    rng = np.random.default_rng(sum(map(ord, name)))
    base = rng.normal(size=(*grid, count)) * rng.uniform(0.1, 10, size=(*grid, 1))
    base[..., ::7] = -0.0
    base[..., : min(count, 3 * 256)] = 0.0                 # all-zero blocks: scale 1
    return [(base * (1.0 + 0.5 * r)).astype(np.float32) for r in range(ROUNDS)]


def _ef_rounds(name, d, m, axes, count, block, plain):
    tg = _group(d, m, axes)
    fn = talgos.build("alltoall", tg, "pallas_a2a", block=block, quantized=True, ef=True,
                      plain=plain)
    _, el = ta2a.alltoall_body_ef(tg, count, block=block)
    err = torch.zeros((*tg.topology.grid_shape, el), device="cuda")
    outs = []
    for x in _ef_inputs(name, tg.topology.grid_shape, count):
        res, err = fn(torch.from_numpy(x).cuda(), err)
        outs.append((res, err))
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,axes,count", DENSE_CASES, ids=lambda v: str(v))
def test_cuda_dense_a2a_bit_exact_vs_plain(d, m, axes, count):
    tg = _group(d, m, axes)
    p = ta2a.plan(tg, count, BLOCK, False)
    x = torch.randn((8, count), generator=torch.Generator().manual_seed(count)).cuda()
    got = ta2a.alltoall(x, p)
    torch.cuda.synchronize()
    assert torch.equal(got, ta2a.alltoall_ref(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,axes,count,block", QUANT_CASES, ids=lambda v: str(v))
def test_cuda_int8_a2a_bit_exact_vs_plain(d, m, axes, count, block):
    tg = _group(d, m, axes)
    p = ta2a.plan(tg, count, block, True)
    x = torch.randn((8, tg.size * p.chunk), generator=torch.Generator().manual_seed(count))
    x = (x * 30).cuda()
    x.view(8, -1, block)[:, ::5] = 0.0
    x[:, ::11] = -0.0
    got = ta2a.alltoall(x, p)
    torch.cuda.synchronize()
    want = ta2a.alltoall_ref(x, p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name,d,m,axes,count,block", EF_CASES, ids=[c[0] for c in EF_CASES])
def test_cuda_error_feedback_bit_exact_vs_plain(name, d, m, axes, count, block):
    kern = _ef_rounds(name, d, m, axes, count, block, plain=False)
    plain = _ef_rounds(name, d, m, axes, count, block, plain=True)
    torch.cuda.synchronize()
    for (kr, ke), (pr, pe) in zip(kern, plain):
        assert torch.equal(kr, pr) and torch.equal(ke, pe)
