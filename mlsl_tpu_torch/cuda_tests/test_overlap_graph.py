"""The compiled overlap engine's programs captured as CUDA graphs
(comm/overlap.py) against the same programs run eagerly on the kernels'
plain versions, bit for bit.

- ``build_multi_reduce`` on integer-valued payloads for every algorithm and
  group it serves, and its quantized units (B1 on the composed ring, B1 + B4
  on the fused int8 ring) over 3 rounds, results and residuals;
- the MLP trainer's engine step: the replayed graph against the engine's
  program run eagerly, and against the host Start/Wait path.
"""

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.comm import algos, overlap, quant_ring
from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.types import CompressionType, ReductionType

COUNTS = [37, 256, 1000, 70_000]
GROUPS = [("g8", 8, 1, 8, ("data",)), ("g4x2", 4, 2, 8, ("data", "model")),
          ("g6", 6, 1, 6, ("data",))]
CASES = [(*g, a) for g in GROUPS for a in ("lax", "rhd", "ring2d", "pallas_ring", "pallas_rhd")
         if algos.inline_eligible(a, "allreduce", ProcessGroup(Topology(*g[1:4]), g[4]),
                                  ReductionType.SUM)]


def _captured(fn, *args):
    """-> (graph, outputs) of ``fn(*args)`` captured after one eager warm-up."""
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    return graph, out


@pytest.mark.cuda
@pytest.mark.parametrize("name,d,m,w,axes,algo", CASES, ids=[f"{c[0]}-{c[5]}" for c in CASES])
def test_cuda_multi_reduce_graph_bit_exact(name, d, m, w, axes, algo):
    group = ProcessGroup(Topology(d, m, w), axes)
    grid = group.topology.grid_shape
    bufs = [torch.from_numpy(np.random.default_rng(i).integers(-40, 40, size=(*grid, c))
                             .astype(np.float32)).cuda() for i, c in enumerate(COUNTS)]
    for stages in (1, 3):
        fn, plan = overlap.build_multi_reduce(group, COUNTS, algo=algo, stages=stages)
        ref, _ = overlap.build_multi_reduce(group, COUNTS, algo=algo, stages=stages, plain=True)
        assert all(u.algo == algo for u in plan.units)
        graph, outs = _captured(fn, bufs)
        for b in bufs:
            b.mul_(-1)
        graph.replay()
        want = ref(bufs)
        torch.cuda.synchronize()
        for o, r in zip(outs, want):
            assert torch.equal(o, r), f"{name} {algo} stages={stages}"


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["composed_b1", "fused_b4"])
@pytest.mark.parametrize("name,d,m,w,axes", GROUPS[:2], ids=[g[0] for g in GROUPS[:2]])
def test_cuda_multi_reduce_quantized_graph_bit_exact(name, d, m, w, axes, fused):
    group = ProcessGroup(Topology(d, m, w), axes if fused else ("data",))
    cfg = Config()
    cfg.collective_algo = "pallas_ring" if fused else ""
    cfg.validate()
    grid = group.topology.grid_shape
    kw = dict(compression=CompressionType.QUANTIZATION, config=cfg, block=256)
    fn, plan = overlap.build_multi_reduce(group, COUNTS, **kw)
    ref, _ = overlap.build_multi_reduce(group, COUNTS, plain=True, **kw)
    want_algo = ("pallas_ring" if quant_ring.use_pallas_for("allreduce", group, 4, cfg)
                 else "quant_ring")
    assert (want_algo == "pallas_ring") == (fused and name == "g8")
    assert [u.algo for u in plan.units] == [want_algo] * len(COUNTS)
    gen = torch.Generator().manual_seed(7)
    bufs = [torch.randn((*grid, c), generator=gen).cuda() for c in COUNTS]
    res = overlap.zero_residuals(plan, group.topology, "cuda")
    ref_res = {k: v.clone() for k, v in res.items()}
    graph, (outs, new_res) = _captured(fn, bufs, res)
    for k in res:
        res[k].zero_()
    for r in range(3):
        for b in bufs:
            b.copy_(torch.randn(b.shape, generator=gen) * (r + 1))
        graph.replay()
        want, ref_res = ref(bufs, ref_res)
        torch.cuda.synchronize()
        for o, x in zip(outs, want):
            assert torch.equal(o, x), f"round {r}"
        for k in res:
            assert torch.equal(new_res[k], ref_res[k]), f"round {r} residual {k}"
            res[k].copy_(new_res[k])


def _mlp_trainer(env, engine, compression):
    from mlsl_tpu_torch.models import mlp
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    dist = env.create_distribution(8, 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(32)
    model = mlp.MLP(device=env.device, generator=torch.Generator().manual_seed(0))
    return DataParallelTrainer(env, dist, sess, model, mlp.loss_fn, mlp.LAYERS, mlp.get_layer,
                               lr=0.1, compression=compression, overlap_compiled=engine)


@pytest.mark.cuda
@pytest.mark.parametrize("compression", [CompressionType.NONE, CompressionType.QUANTIZATION],
                         ids=["plain", "int8"])
def test_cuda_engine_graph_matches_its_eager_step(compression):
    from mlsl_tpu_torch import get_env

    torch.backends.cuda.matmul.allow_tf32 = False
    env = get_env().init(world_size=8)
    try:
        graphed = _mlp_trainer(env, True, compression)
        eager = _mlp_trainer(env, True, compression)
        host = _mlp_trainer(env, False, compression)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(32, 8)).astype(np.float32)
        y = rng.integers(0, 4, size=(32,)).astype(np.int32)
        batch = graphed.shard_batch(x, y)
        other = graphed.shard_batch(x * 0.5, y)     # a replay reads the batch it is given
        before = [p.detach().clone() for p in graphed.model.parameters()]
        graphed.precompile(batch)
        engine = graphed._overlap
        assert engine.graphs["step"] is not None and graphed._step_no == 0
        assert all(torch.equal(a, b) for a, b in zip(graphed.model.parameters(), before))
        assert all(not bool(v.any()) for v in engine.residuals.values())
        if compression == CompressionType.QUANTIZATION:
            assert engine.capture_launches["step"]["quantize_blocks"] == 9 * 2
        for i in range(4):
            b = other if i % 2 else batch
            lg = graphed.step(b)
            eager._step_no += 1
            le = eager._overlap._fused(*b)          # the same program, not captured
            lh = host.step(b)
        torch.cuda.synchronize()
        assert len(engine.graphs) == 1
        assert torch.equal(lg, le)
        for a, b in zip(graphed.model.parameters(), eager.model.parameters()):
            assert torch.equal(a, b)
        for k, v in engine.residuals.items():
            assert torch.equal(v, eager._overlap.residuals[k])
        torch.testing.assert_close(lg, lh, rtol=1e-6, atol=0)
        for a, b in zip(graphed.model.parameters(), host.model.parameters()):
            assert float((a - b).abs().max()) <= 1e-6
    finally:
        env.finalize()
