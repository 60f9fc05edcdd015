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

from fractions import Fraction

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
    (1, 64, ()),                  # the serving KV's block (head_dim 64)
    (7, 64, (3,)),
    (7, 160, ()),                 # 10 segments of 16 in a group of 16 lanes
    (3, 1024, ()),                # a row over a whole warp, 2 segments a lane
    (7, 2048, (6,)),
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


# (block, lanes a row) of the vector path: the power of two at or above
# block / 16, at most a warp
GEOMETRY = [(32, 2), (64, 4), (96, 8), (128, 8), (160, 16), (256, 16), (288, 32),
            (512, 32), (544, 32), (1024, 32), (2048, 32), (4096, 32)]


@pytest.mark.parametrize("block,lanes", GEOMETRY)
def test_geometry_of_the_vector_path(block, lanes):
    path, got, rows = tqk.geometry(block, 393_216, 0, 1 << 20)
    assert (path, got, rows) == ("vector", lanes, tqk.CTA_THREADS // lanes)
    # lane l of a group owns segments l, l + lanes, ...: each of the row's
    # block / 16 segments exactly once, every lane of a group at most 4 of
    # them where block <= 2,048 (the row kept in registers)
    nseg = block // tqk.SEGMENT
    owned = [j for lane in range(lanes) for j in range(lane, nseg, lanes)]
    assert sorted(owned) == list(range(nseg))
    assert (-(-nseg // lanes) <= 4) == (block <= 2048)
    assert rows * lanes == tqk.CTA_THREADS and 32 % lanes == 0


@pytest.mark.parametrize("n_rows,block,rows", [
    (64, 64, 8),            # a decode step's K: 8 CTAs of one warp
    (0, 64, 8), (1, 2048, 1), (7, 96, 4),
    (132 * 8, 64, 8), (132 * 8 + 1, 64, 16), (132 * 40, 64, 40), (132 * 64, 64, 64),
    (131_072, 64, 64), (64_064, 256, 16), (37_632, 256, 16)])
def test_geometry_shrinks_the_cta_for_few_rows(n_rows, block, rows):
    """Rows a CTA: enough for one CTA a SM (132), in whole warps, at most
    CTA_THREADS threads."""
    path, lanes, got = tqk.geometry(block, n_rows, 1 << 20, sms=132)
    assert path == "vector" and got == rows
    assert (lanes * got) % 32 == 0 and lanes * got <= tqk.CTA_THREADS
    assert -(-n_rows // got) >= min(132, -(-n_rows // (tqk.CTA_THREADS // lanes)))


@pytest.mark.parametrize("offsets", [(4, 0), (0, 3), (8, 8), (12, 16), (1, 0)])
def test_geometry_takes_the_scalar_path_only_off_16_bytes(offsets):
    base = 1 << 20
    for block in (32, 64, 96, 256, 2048):
        path, lanes, rows = tqk.geometry(block, 1 << 20, *(base + o for o in offsets))
        assert (path, lanes, rows) == ("scalar", 32, tqk.CTA_THREADS // 32)
        assert tqk.geometry(block, 1 << 20, base, base + 16 * 7)[0] == "vector"


def test_wrappers_pick_the_scalar_path_for_a_misaligned_view():
    """A view at an element offset: the CPU wrappers run the plain versions
    bit for bit against the JAX package's, and on the card the geometry sends
    the same pointers down the scalar path."""
    rows, block = 7, 64
    x = _blocks(rows, block, seed=11, zero_rows=(2,))
    flat = torch.zeros(rows * block + 1)
    flat[1:] = torch.from_numpy(x.reshape(-1))
    view = flat[1:].view(rows, block)
    assert tqk.geometry(block, rows, view.data_ptr())[0] == "scalar"
    tq, ts = tqk.quantize_blocks(view)
    jq, js = jqk.quantize_blocks_ref(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    qflat = torch.zeros(rows * block + 3, dtype=torch.int8)
    qflat[3:] = tq.reshape(-1)
    qview = qflat[3:].view(rows, block)
    assert tqk.geometry(block, rows, qview.data_ptr())[0] == "scalar"
    np.testing.assert_array_equal(tqk.dequantize_blocks(qview, ts).numpy(),
                                  np.asarray(jqk.dequantize_blocks_ref(jq, js)))


def _rn32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    c = np.float32(float(x))
    cands = (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf)))
    return min(cands, key=lambda f: (abs(Fraction(float(f)) - x),
                                     int(np.float32(f).view(np.uint32)) & 1))


def _fma32(a, b, c) -> np.float32:
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


@pytest.mark.parametrize("exp", [-96, -60, -20, 0, 20, 60, 95])
def test_branch_free_division_is_the_ieee_quotient(exp):
    """B1 divides by a row's scale in [2^-96, 2^96] as q0 = x * (1 / scale)
    and one FMA correction (csrc/quant_kernels.cu ``FmaDiv``): the same
    float32 as x / scale, here in exact arithmetic on rounding ties, their
    neighbours and random x, with the scale's significand random or all ones."""
    rng = np.random.default_rng(exp + 100)
    for i in range(24):
        m = np.float32(2 - 2.0 ** -23) if i == 0 else np.float32(rng.uniform(1, 2))
        b = np.float32(np.ldexp(m, exp))
        inv = np.float32(1) / b
        ties = (rng.integers(-127, 127, size=16) + 0.5).astype(np.float32) * b
        near = (ties.view(np.int32) + rng.integers(-3, 4, size=16).astype(np.int32)).view(
            np.float32)
        xs = np.concatenate([ties, near, rng.uniform(-127, 127, 16).astype(np.float32) * b])
        for x in xs:
            q0 = np.float32(x * inv)
            q = _fma32(_fma32(-q0, b, x), inv, q0)
            assert np.float32(q).view(np.uint32) == np.float32(x / b).view(np.uint32), (x, b)
