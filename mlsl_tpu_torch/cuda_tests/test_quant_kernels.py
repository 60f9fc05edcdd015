"""B1 and B2 (ops/quant_kernels.py) against their plain versions, bit for bit."""

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.ops import quant_kernels as tqk


def _blocks(rows, block, seed, zero_rows=()):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, block)) * rng.uniform(0.01, 50, size=(rows, 1)))
    x = x.astype(np.float32)
    for r in zero_rows:
        x[r] = 0.0
    return x


CASES = [
    (64, 256, ()),
    (37, 256, (0, 5, 36)),        # ragged row count, all-zero rows
    (32, 128, (3,)),
    (16, 512, ()),
    (9, 32, (8,)),                # smallest block the CUDA kernel takes
    (5, 96, ()),                  # a multiple of 32 that is not one of 128
    (8 * 8008, 256, (7,)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,block,zeros", CASES)
def test_cuda_kernels_bit_exact_vs_plain(rows, block, zeros):
    x = torch.from_numpy(_blocks(rows, block, seed=rows, zero_rows=zeros)).cuda()
    before = dict(tqk.LAUNCHES)
    q, s = tqk.quantize_blocks(x)
    rq, rs = tqk.quantize_blocks_ref(x)
    d = tqk.dequantize_blocks(q, s)
    torch.cuda.synchronize()
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(d, tqk.dequantize_blocks_ref(rq, rs))
    assert tqk.LAUNCHES["quantize_blocks"] == before["quantize_blocks"] + 1
    assert tqk.LAUNCHES["dequantize_blocks"] == before["dequantize_blocks"] + 1
