"""B3, B3-AG and B4 (ops/ring_kernels.py) against their plain versions, bit
for bit: the dense ring in its three modes and the int8 ring with its
error-feedback residual over two rounds."""

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.comm import quant_ring as tqr
from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
from mlsl_tpu_torch.ops import ring_kernels as trk

BLOCK = 128
ROUNDS = 2


def _group(d, m, axes):
    return ProcessGroup(Topology(d, m, 8), axes)


DENSE_CASES = [
    ("g8_f32_ar", 8, 1, ("data",), "pallas_ring", "allreduce", "float32", 2 * 4096 + 37, False),
    ("g8_f32_rs_bidir", 8, 1, ("data",), "pallas_ring", "reduce_scatter", "float32",
     8 * 2 * 4096, True),
    ("g8_f32_ar_bidir", 8, 1, ("data",), "pallas_ring", "allreduce", "float32",
     8 * 2 * 4096 - 3, True),
    ("g8_bf16_ar", 8, 1, ("data",), "pallas_ring", "allreduce", "bfloat16", 5000, False),
    ("g8_i32_rs", 8, 1, ("data",), "pallas_ring", "reduce_scatter", "int32", 8 * 700, False),
    ("g4_data_f32_ar", 4, 2, ("data",), "pallas_ring", "allreduce", "float32", 3001, False),
    ("g2_model_bf16_rs_bidir", 4, 2, ("model",), "pallas_ring", "reduce_scatter", "bfloat16",
     2 * 4 * 4096, True),
    ("g2_model_i32_ar", 4, 2, ("model",), "pallas_ring", "allreduce", "int32", 4099, False),
    ("snake4x2_f32_ar", 4, 2, ("data", "model"), "pallas_ring2d", "allreduce", "float32",
     3 * 4096 + 5, False),
    ("snake4x2_f32_rs", 4, 2, ("data", "model"), "pallas_ring2d", "reduce_scatter",
     "float32", 8 * 1000, False),
    ("snake2x4_bf16_ar_bidir", 2, 4, ("data", "model"), "pallas_ring2d", "allreduce",
     "bfloat16", 4 * 2 * 4096, True),
]


def _dense_input(name, grid, count, dtype):
    rng = np.random.default_rng(sum(map(ord, name)))
    if dtype == "int32":
        return torch.from_numpy(
            rng.integers(-2 ** 30, 2 ** 30, size=(*grid, count)).astype(np.int32))
    x = (rng.normal(size=(*grid, count)) * rng.uniform(0.1, 100, size=(*grid, 1)))
    t = torch.from_numpy(x.astype(np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _bits(t):
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype)
    return t.view(view) if view else t


@pytest.mark.cuda
@pytest.mark.parametrize("name,d,m,axes,algo,kind,dtype,count,bidir", DENSE_CASES,
                         ids=[c[0] for c in DENSE_CASES])
def test_cuda_dense_ring_bit_exact_vs_plain(name, d, m, axes, algo, kind, dtype, count,
                                            bidir):
    tg = _group(d, m, axes)
    x = _dense_input(name, tg.topology.grid_shape, count, dtype).cuda()
    plan = trk.dense_plan(kind, tg, count, snake=algo == "pallas_ring2d", bidir=bidir)
    w = x.reshape(8, count)
    got = trk.dense_ring(w, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, trk.dense_ring_ref(w, plan))


# B3 as redesigned for the card: group sizes with a compile-time body (2, 4,
# 8) and the generic one (3, 5, 16, 64); counts that leave a scalar head or
# tail (a chunk base off a 16-byte boundary) or that make the last chunk
# padding; strided rows and a base pointer off 16 bytes (the one-element
# body); the bidirectional split and the snake order; float32, bf16, int32.
# (name, (data, model, world), axes, algo, kind, dtype, count, bidir, row pad,
# column offset)
B3_CASES = [
    ("g2_f32_rs_bidir", (4, 2, 8), ("model",), "pallas_ring", "reduce_scatter", "float32",
     2 * 8 * 4096, True, 0, 0),
    ("g2_bf16_ar_tail", (4, 2, 8), ("model",), "pallas_ring", "allreduce", "bfloat16",
     2 * 4096 + 24, False, 0, 0),
    ("g3_f32_ar_padded", (3, 1, 3), ("data",), "pallas_ring", "allreduce", "float32",
     3 * 4096 + 7, False, 0, 0),
    ("g3_f32_ar_head_tail", (3, 1, 3), ("data",), "pallas_ring", "allreduce", "float32",
     2 * 3 * 4096 + 4, True, 0, 0),
    ("g4_f32_rs_strided_bidir", (2, 4, 8), ("model",), "pallas_ring", "reduce_scatter",
     "float32", 4 * 8 * 4096, True, 8, 0),
    ("g4_bf16_ar_head_tail", (4, 2, 8), ("data",), "pallas_ring", "allreduce", "bfloat16",
     4 * 4096 + 40, False, 0, 0),
    ("g4_i32_ar_offset", (2, 4, 8), ("model",), "pallas_ring", "allreduce", "int32",
     4 * 4096, False, 3, 1),
    ("g5_i32_ar", (5, 1, 5), ("data",), "pallas_ring", "allreduce", "int32", 5 * 1000 + 3,
     False, 0, 0),
    ("g5_f32_rs_bidir", (5, 1, 5), ("data",), "pallas_ring", "reduce_scatter", "float32",
     5 * 4096, True, 0, 0),
    ("g8_f32_ar_bidir_head_tail", (8, 1, 8), ("data",), "pallas_ring", "allreduce",
     "float32", 8 * 3 * 4096 + 4, True, 0, 0),
    ("g8_bf16_rs_bidir", (8, 1, 8), ("data",), "pallas_ring", "reduce_scatter", "bfloat16",
     8 * 2 * 4096, True, 0, 0),
    ("g8_i32_rs_strided", (8, 1, 8), ("data",), "pallas_ring", "reduce_scatter", "int32",
     8 * 1000, False, 4, 0),
    ("g8_f32_ar_unaligned", (8, 1, 8), ("data",), "pallas_ring", "allreduce", "float32",
     8 * 4096 + 5, False, 2, 1),
    ("g16_f32_ar", (16, 1, 16), ("data",), "pallas_ring", "allreduce", "float32",
     16 * 4096 + 20, False, 0, 0),
    ("g16_bf16_rs_bidir", (16, 1, 16), ("data",), "pallas_ring", "reduce_scatter",
     "bfloat16", 16 * 2 * 4096, True, 0, 0),
    ("g64_f32_ar", (64, 1, 64), ("data",), "pallas_ring", "allreduce", "float32",
     64 * 100 + 8, False, 0, 0),
    ("g64_i32_rs", (64, 1, 64), ("data",), "pallas_ring", "reduce_scatter", "int32",
     64 * 256, False, 0, 0),
    ("snake4x2_f32_ar_bidir", (4, 2, 8), ("data", "model"), "pallas_ring2d", "allreduce",
     "float32", 8 * 2 * 4096 + 16, True, 0, 0),
    ("snake2x4_i32_rs", (2, 4, 8), ("data", "model"), "pallas_ring2d", "reduce_scatter",
     "int32", 8 * 4096, False, 0, 0),
    ("snake4x2_bf16_rs_strided", (4, 2, 8), ("data", "model"), "pallas_ring2d",
     "reduce_scatter", "bfloat16", 8 * 4096, False, 16, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("special", ["plain", "signed_zero_nan"])
@pytest.mark.parametrize("name,dmw,axes,algo,kind,dtype,count,bidir,pad,col", B3_CASES,
                         ids=[c[0] for c in B3_CASES])
def test_cuda_b3_bit_exact_vs_plain(name, dmw, axes, algo, kind, dtype, count, bidir, pad,
                                    col, special):
    """B3 in both modes, one launch each, bit for bit against dense_ring_ref;
    with ``signed_zero_nan`` every 7th element is -0.0 and every 13th NaN
    (float types), or a column is INT32_MIN (int32, which wraps)."""
    d, m, world = dmw
    tg = ProcessGroup(Topology(d, m, world), axes)
    wide = _dense_input(name, tg.topology.grid_shape, col + count + pad, dtype).cuda()
    w = wide.reshape(world, col + count + pad)[:, col:col + count]
    if special == "signed_zero_nan":
        if dtype == "int32":
            w[:, ::11] = -2 ** 31
        else:
            w[:, ::7] = -0.0
            w[:, 5::13] = float("nan")
    plan = trk.dense_plan(kind, tg, count, snake=algo == "pallas_ring2d", bidir=bidir)
    before = trk.LAUNCHES["dense_ring"]
    got = trk.dense_ring(w, plan)
    torch.cuda.synchronize()
    assert trk.LAUNCHES["dense_ring"] == before + 1
    want = trk.dense_ring_ref(w, plan)
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


AG_CASES = [(d, m, axes, snake, shard, dtype)
            for d, m, axes, snake in [(8, 1, ("data",), False), (4, 2, ("data",), False),
                                      (4, 2, ("model",), False),
                                      (4, 2, ("data", "model"), True),
                                      (2, 4, ("data", "model"), True)]
            for shard in (130, 640, 4096 + 3)
            for dtype in ("float32", "bfloat16", "int32")]


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,axes,snake,shard,dtype", AG_CASES, ids=lambda v: str(v))
def test_cuda_dense_ring_all_gather_bit_exact_vs_plain(d, m, axes, snake, shard, dtype):
    """B3-AG: strided rows (a slice of a wider buffer) and -0.0 kept."""
    tg = _group(d, m, axes)
    x = _dense_input(f"ag{shard}{dtype}", tg.topology.grid_shape, shard + 5, dtype).cuda()
    w = x.reshape(8, shard + 5)[:, 2:2 + shard]
    if dtype != "int32":
        w[:, ::9] = -0.0
    plan = trk.dense_plan("all_gather", tg, shard, snake=snake, bidir=False)
    before = trk.LAUNCHES["dense_ring_gather"]
    got = trk.dense_ring(w, plan)
    torch.cuda.synchronize()
    assert trk.LAUNCHES["dense_ring_gather"] == before + 1
    want = trk.dense_ring_ref(w, plan)
    assert got.shape == (8, tg.size * shard)
    assert torch.equal(_bits(got), _bits(want))


QUANT_CASES = [
    ("q_g8_allreduce", 8, 1, ("data",), "allreduce", 1000, False),
    ("q_g8_reduce_scatter", 8, 1, ("data",), "reduce_scatter", 8 * 600, False),
    ("q_g4_data_allreduce", 4, 2, ("data",), "allreduce", 4 * 4096 + 9, False),
    ("q_g2_model_allreduce_bidir", 4, 2, ("model",), "allreduce", 2 * 3 * 4096 + 11, True),
    ("q_g2_model_reduce_scatter_bidir", 4, 2, ("model",), "reduce_scatter", 2 * 2 * 4096,
     True),
]


def _quant_inputs(name, grid_shape, count):
    rng = np.random.default_rng(sum(map(ord, name)))
    base = rng.normal(size=(*grid_shape, count)) * rng.uniform(0.1, 10, size=(*grid_shape, 1))
    return [(base * (1.0 + 0.5 * r) + r).astype(np.float32) for r in range(ROUNDS)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,d,m,axes,kind,count,bidir", QUANT_CASES,
                         ids=[c[0] for c in QUANT_CASES])
def test_cuda_quant_ring_bit_exact_vs_plain(name, d, m, axes, kind, count, bidir):
    tg = _group(d, m, axes)
    kfn, _ = tqr.build_quantized_collective(kind, tg, count, BLOCK, ring="pallas", bidir=bidir)
    pfn, el = tqr.build_quantized_collective(kind, tg, count, BLOCK, ring="pallas",
                                             bidir=bidir, plain=True)
    ke = pe = torch.zeros((*tg.topology.grid_shape, el), device="cuda")
    for x in _quant_inputs(name, tg.topology.grid_shape, count):
        x = torch.from_numpy(x).cuda()
        (kr, ke), (pr, pe) = kfn(x, ke), pfn(x, pe)
        torch.cuda.synchronize()
        assert torch.equal(kr, pr) and torch.equal(ke, pe)
