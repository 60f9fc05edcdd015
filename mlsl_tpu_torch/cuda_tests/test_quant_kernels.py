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


def _ties(rows, block, seed):
    """Rows whose scale is a power of two (amax = 127 * 2^e), so x / scale is
    exact: every other value lies on a rounding tie k + 0.5 (half to even
    decides), the rest on -127 or 127, which the clip must leave there."""
    rng = np.random.default_rng(seed)
    e = rng.integers(-8, 8, size=(rows, 1)).astype(np.float32)
    k = rng.integers(-126, 126, size=(rows, block)).astype(np.float32) + 0.5
    k[:, 1::2] = np.where(rng.random((rows, block // 2)) < 0.5, -127.0, 127.0)
    k[:, 0] = 127.0
    return (k * np.exp2(e)).astype(np.float32)


def _signed_zeros_and_subnormals(rows, block, seed):
    """-0.0 beside normal values, and rows of subnormals only (their scale is
    subnormal too)."""
    x = _blocks(rows, block, seed)
    x[:, ::3] = -0.0
    x[1::2] = (np.random.default_rng(seed + 1).uniform(-1, 1, size=(rows // 2, block))
               * 1e-39).astype(np.float32)
    x[1, :] = -0.0
    return x


BLOCKS = (32, 64, 96, 128, 160, 256, 512, 1024, 2048)

CASES = [
    (64, 256, ()),
    (37, 256, (0, 5, 36)),        # ragged row count, all-zero rows
    (32, 128, (3,)),
    (16, 512, ()),
    (9, 32, (8,)),                # smallest block the CUDA kernel takes
    (5, 96, ()),                  # a multiple of 32 that is not one of 128
    (8 * 8008, 256, (7,)),
    # every block the geometry treats apart (groups of 2 to 32 lanes, 6 and 10
    # segments in groups of 8 and 16, 2 and 4 segments a lane), at 1, 7 and
    # 8k + 3 rows
    *[(rows, block, (0,) if rows > 1 else ()) for block in BLOCKS for rows in (1, 7, 8003)],
    (67, 4096, (2,)),             # over four segments a lane: the row read twice
    (393_216, 64, ()),            # the serving KV: a prefill's K over every block
    (64, 64, ()),                 # and a decode step's K rows of one block
]


def _check(x):
    """Both kernels on x against the plain versions, one launch each."""
    before = dict(tqk.LAUNCHES)
    q, s = tqk.quantize_blocks(x)
    rq, rs = tqk.quantize_blocks_ref(x)
    d = tqk.dequantize_blocks(q, s)
    torch.cuda.synchronize()
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(d, tqk.dequantize_blocks_ref(rq, rs))
    assert tqk.LAUNCHES["quantize_blocks"] == before["quantize_blocks"] + 1
    assert tqk.LAUNCHES["dequantize_blocks"] == before["dequantize_blocks"] + 1
    return q, s, rq, rs


@pytest.mark.cuda
@pytest.mark.parametrize("rows,block,zeros", CASES)
def test_cuda_kernels_bit_exact_vs_plain(rows, block, zeros):
    x = torch.from_numpy(_blocks(rows, block, seed=rows, zero_rows=zeros)).cuda()
    _check(x)


@pytest.mark.cuda
@pytest.mark.parametrize("block", (64, 96, 256, 1024))
def test_cuda_kernels_at_rounding_ties_and_the_clip(block):
    x = torch.from_numpy(_ties(37, block, seed=block)).cuda()
    q, s, _, _ = _check(x)
    assert torch.equal(s, torch.exp2(torch.log2(s)))        # the scales are powers of two
    assert int(q.abs().max()) == 127


@pytest.mark.cuda
@pytest.mark.parametrize("block", (64, 160, 512))
def test_cuda_kernels_on_signed_zeros_and_subnormals(block):
    x = torch.from_numpy(_signed_zeros_and_subnormals(8, block, seed=block)).cuda()
    _, s, _, _ = _check(x)
    assert float(s[1]) == 1.0                                # an all -0.0 row
    assert 0.0 < float(s[3]) < torch.finfo(torch.float32).tiny   # a subnormal scale


@pytest.mark.cuda
@pytest.mark.parametrize("rows,block", [(37, 256), (8003, 64), (7, 96), (67, 2048)])
def test_cuda_kernels_on_misaligned_views(rows, block):
    """Storage off a 16-byte boundary takes the scalar path, bit for bit."""
    flat = torch.from_numpy(_blocks(rows, block, seed=rows).reshape(-1)).cuda()
    x = torch.cat([flat.new_zeros(1), flat])[1:].view(rows, block)
    assert tqk.geometry(block, rows, x.data_ptr())[0] == "scalar"
    q, s, rq, rs = _check(x)
    qv = torch.cat([q.new_zeros(3).view(-1), q.reshape(-1)])[3:].view(rows, block)
    assert tqk.geometry(block, rows, qv.data_ptr())[0] == "scalar"
    before = dict(tqk.LAUNCHES)
    d = tqk.dequantize_blocks(qv, s)
    torch.cuda.synchronize()
    assert torch.equal(d, tqk.dequantize_blocks_ref(rq, rs))
    assert tqk.LAUNCHES["dequantize_blocks"] == before["dequantize_blocks"] + 1
