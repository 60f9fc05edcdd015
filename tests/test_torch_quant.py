"""The port's int8 block codec (mlsl_tpu_torch.ops.quant_kernels) against the
JAX package's, on the same numpy-seeded inputs.

On the CPU the port's wrappers run their plain PyTorch versions; those must
equal the JAX package's semantic oracle ``quantize_blocks_ref`` bit for bit
(q, scales and dequantized values). Against the jitted Pallas kernel (interpret
mode, as tests/test_quant.py runs it) the scales may differ by one ulp: XLA's
CPU compiler rewrites the division ``amax / 127.0`` into a multiply by the
reciprocal of 127, while the port divides exactly (IEEE), as its CUDA kernel
does. The CUDA kernels themselves are held against the plain versions by
mlsl_tpu_torch/cuda_tests/ and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mlsl_tpu.ops import quant_kernels as jqk
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.ops import quant_kernels as tqk

torch.set_num_threads(2)


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
]


@pytest.mark.parametrize("rows,block,zeros", CASES)
def test_plain_codec_bit_exact_vs_jax_ref(rows, block, zeros):
    x = _blocks(rows, block, seed=rows * block, zero_rows=zeros)
    jq, js = jqk.quantize_blocks_ref(jnp.asarray(x))
    tq, ts = tqk.quantize_blocks(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for r in zeros:
        assert ts[r].item() == 1.0 and not tq[r].any()
    jd = jqk.dequantize_blocks_ref(jq, js)
    td = tqk.dequantize_blocks(tq, ts)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("rows", [64, 1024])   # 1024 = the packed-scale kernel
def test_plain_codec_vs_pallas_interpret(rows):
    x = _blocks(rows, 256, seed=rows, zero_rows=(1,))
    pq, ps = jqk._quantize_pallas(jnp.asarray(x), interpret=True)
    pq, ps = np.asarray(pq), np.asarray(ps)
    tq, ts = tqk.quantize_blocks(torch.from_numpy(x))
    tq, ts = tq.numpy(), ts.numpy()
    # one ulp: XLA multiplies by 1/127 where the port divides by 127
    np.testing.assert_array_max_ulp(ts, ps, maxulp=1)
    same = ts == ps
    assert same.mean() > 0.9
    np.testing.assert_array_equal(tq[same], pq[same])
    # where the scale differs by an ulp, a value on a rounding boundary may
    # round the other way: never by more than one step
    assert np.abs(tq.astype(np.int32) - pq.astype(np.int32)).max() <= 1
    pd = np.asarray(jqk._dequantize_pallas(jnp.asarray(tq), jnp.asarray(ts), interpret=True))
    np.testing.assert_array_equal(
        tqk.dequantize_blocks(torch.from_numpy(tq), torch.from_numpy(ts)).numpy(), pd)


@pytest.mark.parametrize("n,block", [(1000, 256), (256, 256), (1, 128), (5000, 512)])
def test_1d_wrappers_ragged_padding(n, block):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * 4).astype(np.float32)
    jq, js, jn = jqk.quantize(jnp.asarray(x), block=block, use_pallas=False)
    tq, ts, tn = tqk.quantize(torch.from_numpy(x), block=block)
    assert tn == jn == n
    # the port pads to whole blocks; the JAX package pads further, to its TPU
    # row tile, with rows of zeros (scale 1.0). Both are opaque to callers.
    rows = tqk.block_align(n, block) // block
    assert tq.shape == (rows * block,) and ts.shape == (rows,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq)[: rows * block])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[:rows])
    assert not np.asarray(jq)[rows * block:].any()
    np.testing.assert_array_equal(np.asarray(js)[rows:], 1.0)
    jd = jqk.dequantize(jq, js, block=block, orig_len=n, use_pallas=False)
    td = tqk.dequantize(tq, ts, block=block, orig_len=n)
    assert td.shape == (n,)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # padding is zero: the pad region dequantizes to exact zeros
    full = tqk.dequantize(tq, ts, block=block)
    assert full.shape == (rows * block,) and not full[n:].any()


def test_block_align_matches_jax():
    for n in (0, 1, 255, 256, 257, 10_000):
        for b in (32, 128, 256):
            assert tqk.block_align(n, b) == jqk.block_align(n, b)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    tqk.reset_counts()
    x = torch.from_numpy(_blocks(8, 256, seed=3))
    q, s = tqk.quantize_blocks(x)
    tqk.dequantize_blocks(q, s)
    tqk.quantize(x.reshape(-1))
    assert tqk.LAUNCHES == {"quantize_blocks": 0, "dequantize_blocks": 0}


def test_wrappers_check_their_inputs():
    x = torch.zeros((4, 256))
    with pytest.raises(MLSLError):
        tqk.quantize_blocks(x.reshape(-1))                 # not 2-D
    with pytest.raises(MLSLError):
        tqk.quantize_blocks(x.double())                    # not f32
    with pytest.raises(MLSLError):
        tqk.quantize_blocks(torch.zeros((256, 4)).t())     # not contiguous
    q, s = tqk.quantize_blocks(x)
    with pytest.raises(MLSLError):
        tqk.dequantize_blocks(q.float(), s)                # q not int8
    with pytest.raises(MLSLError):
        tqk.dequantize_blocks(q, s[:3])                    # scales of another shape
    with pytest.raises(MLSLError):
        tqk.quantize_blocks(x.to("meta"))                  # neither CPU nor CUDA
