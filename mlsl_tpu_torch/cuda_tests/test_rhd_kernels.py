"""B5 (ops/rhd_kernels.py) against its plain version, bit for bit."""

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
from mlsl_tpu_torch.ops import rhd_kernels as trhd

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


@pytest.mark.cuda
@pytest.mark.parametrize("name,d,m,w,axes,count,dtype", CASES, ids=[c[0] for c in CASES])
def test_cuda_rhd_bit_exact_vs_plain(name, d, m, w, axes, count, dtype):
    tg = ProcessGroup(Topology(d, m, w), axes)
    x = torch.from_numpy(_inputs(name, tg.topology.grid_shape, count, dtype)).cuda()
    plan = trhd.RhdPlan(tg)
    got = trhd.rhd_allreduce(x.reshape(w, count), plan)
    torch.cuda.synchronize()
    want = trhd.rhd_allreduce_ref(x.reshape(w, count), plan)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
