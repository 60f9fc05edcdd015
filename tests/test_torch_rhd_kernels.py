"""The port's halving/doubling allreduce (mlsl_tpu_torch.ops.rhd_kernels,
kernel B5) against the JAX package's ``pallas_rhd`` program under the Pallas
interpreter (MLSL_PALLAS_INTERPRET=1).

Bit-exact for G in {2, 3, 4, 6, 8}: powers of two and the pre/post fold of
3 = 2 + 1 and 6 = 4 + 2, on single-axis groups, on the multi-instance data
group of a (4, 2) grid and on its two-axis global group. The payload holds
-0.0 entries: for a group that is not a power of two the TPU kernel's masked
pre-fold adds +0.0 on members that do not fold, which turns -0.0 into +0.0,
and the port must do the same. An int32
input comes out as float32, as on the TPU.

The CUDA kernel against its plain version on the card:
mlsl_tpu_torch/cuda_tests/ (jax-free, so that it runs on the card's machine).
"""

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.comm import algos as jalgos
from mlsl_tpu.comm.mesh import ProcessGroup as JGroup, Topology as JTopo
from mlsl_tpu.ops import rhd_kernels as jrhd
from mlsl_tpu.types import ReductionType as JRed
from mlsl_tpu_torch.comm import algos as talgos
from mlsl_tpu_torch.comm.mesh import ProcessGroup as TGroup, Topology as TTopo
from mlsl_tpu_torch.ops import rhd_kernels as trhd
from mlsl_tpu_torch.types import ReductionType

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _interpret_gate(monkeypatch):
    monkeypatch.setenv("MLSL_PALLAS_INTERPRET", "1")


# (name, data parts, model parts, world, group axes, count per rank, dtype)
CASES = [
    ("g2", 2, 1, 2, ("data",), 1000, "float32"),
    ("g3_fold", 3, 1, 3, ("data",), 2500, "float32"),
    ("g4", 4, 1, 4, ("data",), 777, "float32"),
    ("g6_fold", 6, 1, 6, ("data",), 3001, "float32"),
    ("g8", 8, 1, 8, ("data",), 10_000, "float32"),
    ("g8_int32", 8, 1, 8, ("data",), 1500, "int32"),
    ("g6_int32_fold", 6, 1, 6, ("data",), 999, "int32"),
    ("g4_of_4x2", 4, 2, 8, ("data",), 1234, "float32"),
    ("g8_global_4x2", 4, 2, 8, ("replica", "data", "seq", "model"), 2048, "float32"),
]


def _groups(d, m, w, axes):
    jt = JTopo(d, m, devices=jax.devices()[:w])
    return JGroup(jt, axes), TGroup(TTopo(d, m, w), axes)


def _inputs(name, grid, count, dtype):
    rng = np.random.default_rng(sum(map(ord, name)))
    if dtype == "int32":
        return rng.integers(-10 ** 6, 10 ** 6, size=(*grid, count)).astype(np.int32)
    x = rng.normal(size=(*grid, count)) * rng.uniform(0.01, 1000, size=(*grid, 1))
    x = x.astype(np.float32)
    # -0.0 on every member at every 7th element, and on some members only
    x[..., ::7] = -0.0
    x.reshape(-1, count)[::2, 3::11] = -0.0
    return x


@pytest.mark.parametrize("name,d,m,w,axes,count,dtype", CASES, ids=[c[0] for c in CASES])
def test_rhd_bit_exact_vs_jax(name, d, m, w, axes, count, dtype):
    jg, tg = _groups(d, m, w, axes)
    x = _inputs(name, jg.topology.grid_shape, count, dtype)
    jfn = jalgos.build("allreduce", jg, x.dtype, "pallas_rhd", op=JRed.SUM)
    want = np.asarray(jfn(jg.topology.shard_buffer(x)))
    got = talgos.build("allreduce", tg, "pallas_rhd", op=ReductionType.SUM)(
        torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    # bit patterns, so that -0.0 and +0.0 count as different
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if dtype == "float32":
        # -0.0 everywhere sums to -0.0, unless the masked pre-fold adds +0.0
        folds = trhd._split(tg.size)[2] > 0
        assert np.signbit(got[..., ::7]).all() != folds


@pytest.mark.parametrize("g", [2, 3, 4, 5, 6, 7, 8, 12, 64])
def test_split_rounds_geometry_match_jax(g):
    assert trhd._split(g) == jrhd._split(g)
    assert trhd.rounds(g) == jrhd.rounds(g)
    for count in (1, 1000, 10_000, 1 << 20):
        assert trhd.geometry(g, count) == jrhd.geometry(g, count)


def test_eligibility_and_band_match_jax():
    for d, m, w, axes in [(8, 1, 8, ("data",)), (4, 2, 8, ("data", "model")),
                          (1, 8, 8, ()), (4, 2, 8, ("model",))]:
        jg, tg = _groups(d, m, w, axes)
        for kind in ("allreduce", "reduce_scatter", "bcast"):
            for op in (None, ReductionType.SUM, ReductionType.MIN):
                jop = None if op is None else JRed(int(op))
                assert trhd.eligible(kind, tg, op) == jrhd.eligible(kind, jg, jop)

    class Cfg:
        msg_priority_threshold = 10000
        pallas_rhd_max_bytes = 0

    assert trhd.env_max_bytes(Cfg) == jrhd.env_max_bytes(Cfg) == 40_000
    Cfg.pallas_rhd_max_bytes = 4096
    assert trhd.env_max_bytes(Cfg) == jrhd.env_max_bytes(Cfg) == 4096
