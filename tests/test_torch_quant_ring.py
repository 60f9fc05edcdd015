"""The port's int8 error-feedback ring (mlsl_tpu_torch.comm.quant_ring) against
the JAX package's ``build_quantized_collective``, over two rounds so that the
residual is carried.

Bit-exact. XLA's CPU compiler changes the arithmetic in two places, so the JAX
side is run once in a subprocess with those two rewrites switched off:

- the algebraic simplifier turns ``amax / 127.0`` into ``amax * (1/127)``,
  which moves about 4% of the scales by one ulp
  (``--xla_disable_hlo_passes=algsimp`` keeps the division);
- LLVM contracts ``x - q*s`` and ``q*s + partial`` into fused multiply-adds,
  which round once where the port rounds twice (``--xla_cpu_max_isa=AVX``, an
  instruction set without FMA, keeps the two roundings).

With both off, the JAX program computes exactly the port's arithmetic, and the
results and residuals must be equal bit for bit. Against the JAX program as it
runs by default (in this process) the test states the bound those two rewrites
allow: a last-bit difference may flip one rounding in a later quantize, which
moves a value by one quantization step, at most max|x|/127 of the block.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mlsl_tpu.comm import quant_ring as jqr
from mlsl_tpu.comm.mesh import ProcessGroup as JGroup, Topology as JTopo
from mlsl_tpu_torch.comm import quant_ring as tqr
from mlsl_tpu_torch.comm.mesh import ProcessGroup as TGroup, Topology as TTopo
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.types import CompressionType, DataType, ReductionType

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BLOCK = 256
ROUNDS = 2

# (name, data_parts, model_parts, group axes, kind, count per rank)
CASES = [
    ("g8_allreduce", 8, 1, ("data",), "allreduce", 1000),
    ("g8_allreduce_multiblock", 8, 1, ("data",), "allreduce", 8 * 3 * BLOCK + 5),
    ("g8_reduce_scatter", 8, 1, ("data",), "reduce_scatter", 8 * 300),
    ("g4x2_allreduce", 4, 2, ("data",), "allreduce", 777),
    ("g2_model_allreduce", 4, 2, ("model",), "allreduce", 513),
    ("g1_allreduce", 1, 8, (), "allreduce", 600),
    ("g1_reduce_scatter", 1, 8, (), "reduce_scatter", 300),
    ("multiaxis_allreduce", 4, 2, ("data", "model"), "allreduce", 999),
    ("multiaxis_reduce_scatter", 4, 2, ("data", "model"), "reduce_scatter", 8 * 100),
]


def _inputs(name, grid_shape, count):
    """Round r's input for a case, the same on both sides."""
    rng = np.random.default_rng(sum(map(ord, name)))
    base = rng.normal(size=(*grid_shape, count)) * rng.uniform(0.1, 10, size=(*grid_shape, 1))
    return [(base * (1.0 + 0.5 * r) + r).astype(np.float32) for r in range(ROUNDS)]


_JAX_EXACT = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from tests.test_torch_quant_ring import CASES, BLOCK, _inputs
from mlsl_tpu.comm import quant_ring as jqr
from mlsl_tpu.comm.mesh import ProcessGroup, Topology
out = {}
for name, d, m, axes, kind, count in CASES:
    topo = Topology(d, m)
    fn, el = jqr.build_quantized_collective(kind, ProcessGroup(topo, axes), count, BLOCK)
    err = np.zeros((*topo.grid_shape, el), np.float32)
    for r, x in enumerate(_inputs(name, topo.grid_shape, count)):
        res, err = fn(topo.shard_buffer(x), topo.shard_buffer(err))
        out[f"{name}/{r}/res"] = np.asarray(res)
        out[f"{name}/{r}/err"] = err = np.asarray(err)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_exact(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_exact") / "ring.npz"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_EXACT, str(ROOT), str(path)],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _port_rounds(d, m, axes, kind, count, name):
    topo = TTopo(d, m, 8)
    fn, el = tqr.build_quantized_collective(kind, TGroup(topo, axes), count, BLOCK)
    err = torch.zeros((*topo.grid_shape, el))
    outs = []
    for x in _inputs(name, topo.grid_shape, count):
        res, err = fn(torch.from_numpy(x), err)
        outs.append((res.numpy(), err.numpy()))
    return outs, el


@pytest.mark.parametrize("name,d,m,axes,kind,count", CASES, ids=[c[0] for c in CASES])
def test_ring_bit_exact_vs_jax(jax_exact, name, d, m, axes, kind, count):
    outs, el = _port_rounds(d, m, axes, kind, count, name)
    _, _, _, jel, _ = jqr.ring_geometry(kind, JGroup(JTopo(d, m), axes), count, BLOCK)
    assert el == jel
    for r, (res, err) in enumerate(outs):
        np.testing.assert_array_equal(res, jax_exact[f"{name}/{r}/res"], err_msg=f"round {r}")
        np.testing.assert_array_equal(err, jax_exact[f"{name}/{r}/err"], err_msg=f"round {r}")


@pytest.mark.parametrize("name,d,m,axes,kind,count", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_ring_vs_default_jax_within_one_step(name, d, m, axes, kind, count):
    topo = JTopo(d, m)
    fn, _ = jqr.build_quantized_collective(kind, JGroup(topo, axes), count, BLOCK)
    outs, el = _port_rounds(d, m, axes, kind, count, name)
    err = np.zeros((*topo.grid_shape, el), np.float32)
    for r, x in enumerate(_inputs(name, topo.grid_shape, count)):
        res, err = fn(topo.shard_buffer(x), topo.shard_buffer(err))
        res, err = np.asarray(res), np.asarray(err)
        step = np.abs(res).max() / 127.0
        np.testing.assert_allclose(outs[r][0], res, rtol=0, atol=step)
        np.testing.assert_allclose(outs[r][1], err, rtol=0, atol=step)


def test_ring_geometry_is_the_non_pallas_one():
    for count in (1, 255, 1000, 2_049_000):
        for axes, d in ((("data",), 8), ((), 1)):
            jg = JGroup(JTopo(d, 8 // d), axes)
            tg = TGroup(TTopo(d, 8 // d, 8), axes)
            for kind in ("allreduce",):
                assert tqr.ring_geometry(kind, tg, count, BLOCK) == \
                    jqr.ring_geometry(kind, jg, count, BLOCK)[:4]


def test_request_carries_the_residual():
    """A quantized CommRequest restarted on new data feeds the previous
    round's residual into the entry quantize, as the ring function does when
    the caller carries it."""
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        dist = env.create_distribution(8, 1)
        count = 1000
        req = CommRequest(CommDesc("allreduce", dist.data_group, count, DataType.FLOAT,
                                   op=ReductionType.SUM,
                                   compression=CompressionType.QUANTIZATION),
                          env.dispatcher)
        req.setup()
        want, _ = _port_rounds(8, 1, ("data",), "allreduce", count, "g8_allreduce")
        for r, x in enumerate(_inputs("g8_allreduce", dist.world_shape, count)):
            got = req.start(torch.from_numpy(x)).wait()
            np.testing.assert_array_equal(got.numpy(), want[r][0])
            np.testing.assert_array_equal(req._errs[0].numpy(), want[r][1])
    finally:
        env.finalize()


def test_quantized_sum_is_close_to_exact():
    """The reference test's statistical oracle (mlsl_test.cpp:407-428):
    relative L2 error of the int8 ring well under 2%."""
    outs, _ = _port_rounds(8, 1, ("data",), "allreduce", 1000, "g8_allreduce")
    x = _inputs("g8_allreduce", (1, 8, 1, 1), 1000)[0]
    exact = x.sum(axis=1, keepdims=True)
    rel = np.linalg.norm(outs[0][0] - exact) / np.linalg.norm(np.broadcast_to(exact, x.shape))
    assert rel < 0.02, rel
