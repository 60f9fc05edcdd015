"""The port's fused ring (mlsl_tpu_torch.ops.ring_kernels, kernels B3 and B4)
against the JAX package's ``pallas_ring`` / ``pallas_ring2d`` programs, which
run here under the Pallas interpreter (MLSL_PALLAS_INTERPRET=1, as
tests/test_pallas_ring.py arms it).

Dense ring (B3): bit-exact for float32, bfloat16 and int32, on allreduce and
reduce_scatter, unidirectional and with the bidirectional split, on (8, 1)
and on the multi-instance subgroups of a (4, 2) grid, and over the snake
cycle of a two-axis group. The port's plain version adds in the kernel's
order, so the float results agree bit for bit, not only to rounding.

Int8 ring (B4) through ``build_quantized_collective(ring="pallas")`` over two
rounds, so that the residual is carried: bit-exact against the JAX program run
in a subprocess with XLA's division rewrite and FMA contraction switched off
(see tests/test_torch_quant_ring.py), and within one quantization step of the
JAX program as it runs by default. The error-feedback length is
``quant_geometry``'s.

B3-AG (the all-gather mode) against JAX's interpret-mode kernel, ring and
snake, bit-exact.

Each CUDA kernel against its plain version on the card:
mlsl_tpu_torch/cuda_tests/ (jax-free, so that it runs on the card's machine).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsl_tpu.comm import algos as jalgos
from mlsl_tpu.comm import quant_ring as jqr
from mlsl_tpu.comm.mesh import ProcessGroup as JGroup, Topology as JTopo
from mlsl_tpu.ops import ring_kernels as jrk
from mlsl_tpu.types import ReductionType as JRed
from mlsl_tpu_torch.comm import algos as talgos
from mlsl_tpu_torch.comm import quant_ring as tqr
from mlsl_tpu_torch.comm.mesh import ProcessGroup as TGroup, Topology as TTopo
from mlsl_tpu_torch.ops import ring_kernels as trk
from mlsl_tpu_torch.types import ReductionType

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BLOCK = 128
ROUNDS = 2


@pytest.fixture(autouse=True)
def _interpret_gate(monkeypatch):
    monkeypatch.setenv("MLSL_PALLAS_INTERPRET", "1")


def _groups(d, m, axes):
    return JGroup(JTopo(d, m), axes), TGroup(TTopo(d, m, 8), axes)


# -- geometry, ring order and eligibility --------------------------------------


GROUPS = [(8, 1, ("data",)), (4, 2, ("data",)), (4, 2, ("model",)),
          (4, 2, ("data", "model")), (2, 4, ("data", "model")), (1, 8, ()),
          (8, 1, ("replica", "data", "seq", "model"))]


@pytest.mark.parametrize("d,m,axes", GROUPS, ids=lambda v: str(v))
def test_geometry_tables_and_eligibility_match_jax(d, m, axes):
    jg, tg = _groups(d, m, axes)
    for kind in ("allreduce", "reduce_scatter"):
        for op in (None, ReductionType.SUM, ReductionType.MAX):
            jop = None if op is None else JRed(int(op))
            assert trk.eligible_dense(kind, tg, op) == jrk.eligible_dense(kind, jg, jop)
            assert trk.eligible_dense2d(kind, tg, op) == jrk.eligible_dense2d(kind, jg, jop)
    for block in (128, 256, 96):
        assert trk.eligible_quant(tg, block) == jrk.eligible_quant(jg, block)
    g = tg.size
    for n in (1, 1000, 8 * 4096, 2_049_000, 16 << 20):
        for kind in ("allreduce", "reduce_scatter"):
            count = -(-n // g) * g if kind == "reduce_scatter" else n
            assert trk.dense_geometry(kind, tg, count) == jrk.dense_geometry(kind, jg, count)
            if trk.eligible_quant(tg, 256):
                assert trk.quant_geometry(kind, tg, count, 256) == \
                    jrk.quant_geometry(kind, jg, count, 256)
        assert trk.dense_geometry("all_gather", tg, n) == jrk.dense_geometry("all_gather", jg, n)
    if trk.ring_axis(tg) is not None:
        for a, b in zip(trk._ring_tables(tg), jrk._ring_tables(jg)):
            np.testing.assert_array_equal(a, b)
    if trk.ring_axes2(tg) is not None:
        for a, b in zip(trk._ring_tables(tg, snake=True), jrk._ring_tables_2d(jg)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(trk._snake_perm(tg), jrk._snake_perm(jg))


def test_knobs_read_the_environment(monkeypatch):
    """MLSL_PALLAS_RING_BIDIR reaches the ring through Config alone, as in the
    JAX package: the request layer passes ``Config.pallas_ring_bidir`` down
    and the ops layer reads no environment (``bidir`` is a required argument
    of its plans). The TPU's slot count has no counterpart on the card."""
    from mlsl_tpu.config import Config as JConfig
    from mlsl_tpu_torch import DataType, GroupType, ReductionType as Red, get_env
    from mlsl_tpu_torch.config import Config as TConfig

    monkeypatch.setenv("MLSL_PALLAS_RING_BIDIR", "1")
    monkeypatch.setenv("MLSL_PALLAS_RING_SLOTS", "5")
    assert TConfig.from_env().pallas_ring_bidir and JConfig.from_env().pallas_ring_bidir
    assert not hasattr(TConfig.from_env(), "pallas_ring_slots")
    _, tg = _groups(8, 1, ("data",))
    n = 8 * 2 * 4096
    with pytest.raises(TypeError):
        trk.dense_plan("allreduce", tg, n)
    x = torch.from_numpy(_dense_inputs("bidir", (1, 8, 1, 1), n, "float32")[0])
    monkeypatch.setenv("MLSL_ALGO", "pallas_ring")
    env = get_env().init(device="cpu", world_size=8)
    try:
        dist = env.create_distribution(8, 1)
        req = dist.all_reduce(x, n, DataType.FLOAT, Red.SUM, GroupType.DATA)
        out = env.wait(req)
        assert req.algo == "pallas_ring"
        assert torch.equal(out, talgos.build("allreduce", tg, "pallas_ring", bidir=True)(x))
        assert not torch.equal(out, talgos.build("allreduce", tg, "pallas_ring")(x))
    finally:
        env.finalize()


# -- B3, the dense ring ---------------------------------------------------------


# (name, d, m, axes, algo, kind, dtype, count per rank, bidir)
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


def _dense_inputs(name, grid, count, dtype):
    rng = np.random.default_rng(sum(map(ord, name)))
    if dtype == "int32":
        x = rng.integers(-2 ** 30, 2 ** 30, size=(*grid, count)).astype(np.int32)
        return x, x, torch.from_numpy(x)
    x = (rng.normal(size=(*grid, count)) * rng.uniform(0.1, 100, size=(*grid, 1)))
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return x, t.float().numpy().astype(jnp.bfloat16), t
    return x, x, torch.from_numpy(x)


AG_CASES = [(8, 1, ("data",), False, 640), (8, 1, ("data",), False, 130),
            (4, 2, ("data", "model"), True, 640), (4, 2, ("data", "model"), True, 130)]


@pytest.mark.parametrize("d,m,axes,snake,shard", AG_CASES, ids=lambda v: str(v))
def test_dense_ring_all_gather_bit_exact_vs_jax(d, m, axes, snake, shard):
    """B3-AG's plain version against JAX's interpret-mode kernel in the
    gather-only mode, as tests/test_pallas_ring.py:271-287 runs it: every
    member ends with every shard in group-position order, over the 1-D ring
    and the snake cycle, chunk-aligned and padded shards, -0.0 kept."""
    jg, tg = _groups(d, m, axes)
    rng = np.random.default_rng(shard + d)
    vals = rng.normal(size=(*tg.topology.grid_shape, shard)).astype(np.float32)
    vals.reshape(8, shard)[:, ::9] = -0.0
    body = jrk.dense_ring_body("all_gather", jg, shard, np.float32, snake=snake)
    jfn = jrk.build_flat_program(body, jg, "all_gather")
    want = np.asarray(jfn(jg.topology.shard_buffer(vals))).reshape(8, 8 * shard)
    plan = trk.dense_plan("all_gather", tg, shard, snake=snake, bidir=False)
    got = trk.dense_ring(torch.from_numpy(vals).reshape(8, shard), plan).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got[3], vals.reshape(-1))
    pre, phases, fin = trk.steps("all_gather", tg, shard, snake=snake)
    assert len(phases) == 1
    staged = fin(phases[0](pre(torch.from_numpy(vals))))
    np.testing.assert_array_equal(staged.numpy().reshape(8, -1), got)


@pytest.mark.parametrize("name,d,m,axes,algo,kind,dtype,count,bidir", DENSE_CASES,
                         ids=[c[0] for c in DENSE_CASES])
def test_dense_ring_bit_exact_vs_jax(name, d, m, axes, algo, kind, dtype, count, bidir):
    jg, tg = _groups(d, m, axes)
    _, jx, tx = _dense_inputs(name, jg.topology.grid_shape, count, dtype)
    kw = {}
    if kind == "reduce_scatter":
        kw["recv_count"] = count // tg.size
    jfn = jalgos.build(kind, jg, jx.dtype, algo, op=JRed.SUM, bidir=bidir, **kw)
    want = np.asarray(jfn(jg.topology.shard_buffer(jx)))
    tfn = talgos.build(kind, tg, algo, op=ReductionType.SUM, bidir=bidir, **kw)
    got = tfn(tx)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy() if dtype == "bfloat16" else got.numpy(),
                                  want.astype(np.float32) if dtype == "bfloat16" else want)


def test_dense_ring_bidir_changes_the_order():
    """The second half of the rows walks the other way: on float data the
    two directions round differently somewhere, and the plain version shows
    it (the split is not a no-op)."""
    _, tg = _groups(8, 1, ("data",))
    x = torch.from_numpy(_dense_inputs("bidir", (1, 8, 1, 1), 8 * 2 * 4096, "float32")[0])
    one = talgos.build("allreduce", tg, "pallas_ring", bidir=False)(x)
    two = talgos.build("allreduce", tg, "pallas_ring", bidir=True)(x)
    split = trk.dense_plan("allreduce", tg, x.shape[-1], bidir=True).split
    assert split == 32 * 128   # 64 rows of 128 per chunk, halved on an 8-row tile
    rc = x.shape[-1] // 8
    lo = np.arange(x.shape[-1]) % rc < split
    assert torch.equal(one[..., lo], two[..., lo])
    assert not torch.equal(one[..., ~lo], two[..., ~lo])


# -- B4, the int8 ring ----------------------------------------------------------


# (name, d, m, axes, kind, count per rank, bidir)
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


_JAX_EXACT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from tests.test_torch_ring_kernels import QUANT_CASES, BLOCK, _quant_inputs
from mlsl_tpu.comm import quant_ring as jqr
from mlsl_tpu.comm.mesh import ProcessGroup, Topology
out = {}
for name, d, m, axes, kind, count, bidir in QUANT_CASES:
    topo = Topology(d, m)
    fn, el = jqr.build_quantized_collective(kind, ProcessGroup(topo, axes), count, BLOCK,
                                            ring="pallas", bidir=bidir)
    err = np.zeros((*topo.grid_shape, el), np.float32)
    for r, x in enumerate(_quant_inputs(name, topo.grid_shape, count)):
        res, err = fn(topo.shard_buffer(x), topo.shard_buffer(err))
        out[f"{name}/{r}/res"] = np.asarray(res)
        out[f"{name}/{r}/err"] = err = np.asarray(err)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_exact(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_exact") / "pallas_ring.npz"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["MLSL_PALLAS_INTERPRET"] = "1"
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_EXACT, str(ROOT), str(path)],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _port_rounds(name, d, m, axes, kind, count, bidir):
    topo = TTopo(d, m, 8)
    fn, el = tqr.build_quantized_collective(kind, TGroup(topo, axes), count, BLOCK,
                                            ring="pallas", bidir=bidir)
    err = torch.zeros((*topo.grid_shape, el))
    outs = []
    for x in _quant_inputs(name, topo.grid_shape, count):
        res, err = fn(torch.from_numpy(x), err)
        outs.append((res.numpy(), err.numpy()))
    return outs, el


@pytest.mark.parametrize("name,d,m,axes,kind,count,bidir", QUANT_CASES,
                         ids=[c[0] for c in QUANT_CASES])
def test_quant_ring_bit_exact_vs_jax(jax_exact, name, d, m, axes, kind, count, bidir):
    outs, el = _port_rounds(name, d, m, axes, kind, count, bidir)
    jg, tg = _groups(d, m, axes)
    assert el == trk.quant_geometry(kind, tg, count, BLOCK)[3] == \
        jrk.quant_geometry(kind, jg, count, BLOCK)[3]
    for r, (res, err) in enumerate(outs):
        np.testing.assert_array_equal(res, jax_exact[f"{name}/{r}/res"], err_msg=f"round {r}")
        np.testing.assert_array_equal(err, jax_exact[f"{name}/{r}/err"], err_msg=f"round {r}")


@pytest.mark.parametrize("name,d,m,axes,kind,count,bidir", QUANT_CASES[:3],
                         ids=[c[0] for c in QUANT_CASES[:3]])
def test_quant_ring_vs_default_jax_within_one_step(name, d, m, axes, kind, count, bidir):
    jg, _ = _groups(d, m, axes)
    topo = jg.topology
    fn, el = jqr.build_quantized_collective(kind, jg, count, BLOCK, ring="pallas",
                                            bidir=bidir)
    outs, tel = _port_rounds(name, d, m, axes, kind, count, bidir)
    assert el == tel
    err = np.zeros((*topo.grid_shape, el), np.float32)
    for r, x in enumerate(_quant_inputs(name, topo.grid_shape, count)):
        res, err = fn(topo.shard_buffer(x), topo.shard_buffer(err))
        res, err = np.asarray(res), np.asarray(err)
        step = np.abs(res).max() / 127.0
        np.testing.assert_allclose(outs[r][0], res, rtol=0, atol=step)
        np.testing.assert_allclose(outs[r][1], err, rtol=0, atol=step)


def test_err_len_differs_from_the_composed_ring():
    """The pallas wire aligns chunks to block * 32 (or block * 1024) elements,
    the composed ring to one block, so the residual lengths differ."""
    _, tg = _groups(8, 1, ("data",))
    _, pel = tqr.build_quantized_collective("allreduce", tg, 2_049_000, 256, ring="pallas")
    _, lel = tqr.build_quantized_collective("allreduce", tg, 2_049_000, 256)
    assert pel == 8 * 262_144 and lel == 8 * 256_256
