"""The integrity layer on the card (checker.py, sentinel.py), no JAX:

- the checker's level 2 on CUDA buffers: the verdicts queued at Start are
  resolved with one host read at the round's first wait, which names the
  buffer holding the NaN; a clean round passes;
- inside a CUDA-graph capture no finiteness verdict is queued or resolved
  (a host read cannot run there), while the host-only checks still run; the
  same Python outside the capture queues its verdict;
- the audit's block sums and digest on CUDA tensors equal the same
  computation on their CPU copies, bit for bit, for every dtype branch, and
  the per-rank min/max comparison finds one rank's flipped bit;
- the gate makes one host read a screened healthy step (counted by the
  synchronizing-operation warnings of ``torch.cuda.set_sync_debug_mode``).
"""

import warnings

import pytest
import torch

from mlsl_tpu_torch import checker, sentinel, supervisor
from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
from mlsl_tpu_torch.comm.request import CommDesc
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.types import DataType


@pytest.fixture(autouse=True)
def _integrity():
    supervisor.reset_all()
    yield
    supervisor.reset_all()


@pytest.fixture()
def env(monkeypatch):
    from mlsl_tpu_torch import get_env

    get_env().finalize()
    for k in ("MLSL_ALGO", "MLSL_GRAD_BUCKET_MB", "MLSL_MSG_PRIORITY"):
        monkeypatch.delenv(k, raising=False)
    e = get_env().init(world_size=8)
    yield e
    e.finalize()


def test_chkp_flush_names_the_nan_buffer_at_the_first_wait(env, monkeypatch):
    from mlsl_tpu_torch.types import GroupType, ReductionType

    monkeypatch.setenv("MLSL_CHKP", "2")
    dist = env.create_distribution(8, 1)
    counts = (4096, 4352, 4608)
    bufs = [torch.ones((1, 8, 1, 1, n), device="cuda") for n in counts]
    bufs[1][0, 5, 0, 0, 77] = float("nan")
    reqs = [dist.all_reduce(b, n, DataType.FLOAT, ReductionType.SUM, GroupType.DATA)
            for b, n in zip(bufs, counts)]
    assert len(checker._pending) == 3
    with pytest.raises(MLSLError, match=r"non-finite values: allreduce\[4352\]$"):
        env.wait(reqs[0])
    out = env.wait(reqs[2])
    assert out.is_cuda and bool((out == 8).all())
    assert stats.CHKP_COUNTERS == {"checks": 3, "violations": 1, "value_checks": 3,
                                   "value_syncs": 1}
    clean = dist.all_reduce(bufs[0], counts[0], DataType.FLOAT, ReductionType.SUM,
                            GroupType.DATA)
    assert bool((env.wait(clean) == 8).all())
    assert stats.CHKP_COUNTERS["value_syncs"] == 2


def test_no_verdict_queued_inside_a_capture():
    topo = Topology(8, 1, 8)
    desc = CommDesc("allreduce", ProcessGroup(topo, ("data",)), 256, DataType.FLOAT)
    buf = torch.full((1, 8, 1, 1, 256), float("nan"), device="cuda")
    checker.check_buffer(buf, desc, checker.CHKP_VALUES)         # the eager warm-up
    assert len(checker._pending) == 1
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        checker.check_buffer(buf, desc, checker.CHKP_VALUES)
        checker.flush_values()            # deferred: no host read in a capture
        out = buf * 2
    g.replay()
    torch.cuda.synchronize()
    assert len(checker._pending) == 1
    assert stats.CHKP_COUNTERS["checks"] == 2 and stats.CHKP_COUNTERS["value_checks"] == 1
    with pytest.raises(MLSLError, match="non-finite"):
        checker.flush_values()
    assert bool(torch.isnan(out).all())


DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int32,
          torch.int64, torch.uint8]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("block", [64, 4096])
def test_block_sums_on_cuda_equal_the_cpu(dtype, block):
    gen = torch.Generator().manual_seed(block)
    if dtype.is_floating_point:
        x = (torch.randn(8, 10007, generator=gen, dtype=torch.float64) * 5).to(dtype)
    else:
        lo, hi = {torch.int64: (-2 ** 62, 2 ** 62), torch.int32: (-2 ** 31, 2 ** 31 - 1),
                  torch.uint8: (0, 256)}[dtype]
        x = torch.randint(lo, hi, (8, 10007), generator=gen, dtype=torch.int64).to(dtype)
    got = sentinel.block_sums(x.cuda(), block)
    want = sentinel.block_sums(x, block)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def test_digest_on_cuda_equals_the_cpu_and_finds_a_flipped_rank():
    gen = torch.Generator().manual_seed(3)
    rep = {"w": torch.randn(300, 17, generator=gen), "b": torch.randn(5, generator=gen)}
    sh = [torch.randn(1, 8, 1, 1, 999, generator=gen)]
    s = sentinel.Sentinel((1, 8, 1, 1), every=1, block=128)
    on_cpu = s.audit_tree(rep, sh)
    on_cuda = s.audit_tree({k: v.cuda() for k, v in rep.items()}, [t.cuda() for t in sh])
    assert (on_cuda.equal, on_cuda.digest, on_cuda.blocks) == \
        (on_cpu.equal, on_cpu.digest, on_cpu.blocks)
    copies = rep["w"].cuda().expand(1, 8, 1, 1, 300, 17).clone()
    rep_ranked = {"w": sentinel.PerRank(copies), "b": rep["b"].cuda()}
    same = s.audit_tree(rep_ranked, [t.cuda() for t in sh])
    assert same.equal and same.digest == on_cpu.digest
    copies[0, 4, 0, 0].view(-1).view(torch.int32)[1000] ^= 1
    diverged = s.audit_tree(rep_ranked, [t.cuda() for t in sh])
    assert not diverged.equal and diverged.digest != on_cpu.digest


def test_gate_one_host_read_a_screened_step():
    # warmup above the steps: healthy random steps cannot trip the history
    # screens, and every step makes the one read all screens share
    s = sentinel.Sentinel((1, 8, 1, 1), gate="skip_step", warmup=10)
    gen = torch.Generator().manual_seed(5)
    steps = [(torch.rand(1, 8, 1, 1, 1, generator=gen) + 2.0,
              {"a": torch.randn(1, 8, 1, 1, 4096, generator=gen),
               "b": torch.randn(1, 8, 1, 1, 33, generator=gen)}) for _ in range(4)]
    steps = [(l.cuda(), {k: v.cuda() for k, v in g.items()}) for l, g in steps]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i, (loss, grads) in enumerate(steps):
                assert s.gate(loss, grads, None, i)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == len(steps)
    assert stats.SENTINEL_COUNTERS["screened"] == len(steps)
