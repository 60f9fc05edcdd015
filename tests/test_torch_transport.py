"""The multi-process transport in one process (comm/transport.py, comm/mesh.py).

Held against the JAX package where it has a counterpart: the bootstrap's
retry loop (``Environment._distributed_init_with_retry``), the knobs, and the
rank layout of ``dcn_aware_devices`` and ``Topology`` on fake devices that
carry ``process_index`` and ``id``. The rest states the port's own
contracts: the box layout and its refusal, the subgroup partitions, tiers by
host, the A.8b refusals, a one-process gloo world bit for bit the
transport-less one, the hop order under ``msg_priority`` across two
processes, the ring shift and the direct exchanges against their plain
versions across two processes, the compressed routes' process-local rule,
and the process index of the straggler shed and the trainer's replica id.
Tests that bring up ``torch.distributed`` destroy it in teardown: this file
shares an xdist worker with others.
"""

import dataclasses
import os
import random
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mlsl_tpu_torch import get_env
from mlsl_tpu_torch.comm import algos, mesh, transport
from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.log import MLSLError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    """A free port below Linux's default ephemeral range (32768-60999): no
    socket the kernel numbers itself (gloo's pair listeners, other tests'
    probes and clients) can take it between this probe and the
    coordinator's bind."""
    rng = random.SystemRandom()
    for _ in range(200):
        port = rng.randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port in 20000-32767")


@pytest.fixture(autouse=True)
def _clean_world():
    yield
    from mlsl_tpu_torch.core.environment import Environment

    if Environment._instance is not None:
        Environment._instance.finalize()
    transport.shutdown()
    mesh._LOCALIZED.clear()


@pytest.fixture
def fake_world(monkeypatch):
    """Pose as process ``index`` of ``count`` without a process group: what
    is built needs no hop until it is called."""
    def pose(count, index=0, hosts=None, world_size=8):
        w = transport.world()
        monkeypatch.setattr(w, "count", count)
        monkeypatch.setattr(w, "index", index)
        monkeypatch.setattr(w, "hosts", tuple(hosts or ("h",) * count))
        monkeypatch.setattr(w, "world_size", world_size)
        monkeypatch.setattr(w, "up", True)
        monkeypatch.setattr(w, "backend", "gloo")
        return w
    return pose


# -- the bootstrap's retries and the knobs ----------------------------------------


def test_bootstrap_retries_as_jax(monkeypatch):
    """Two failed rendezvous, then a world: the same attempts and sleeps as
    the JAX package's loop, and the half-made group destroyed between
    attempts."""
    import jax
    import torch.distributed as dist

    from mlsl_tpu.core.environment import Environment as JEnv

    monkeypatch.setenv("MLSL_DIST_INIT_RETRIES", "3")
    monkeypatch.setenv("MLSL_DIST_INIT_BACKOFF_S", "0.01")

    def flaky(real):
        calls = []

        def fn(*a, **kw):
            calls.append(1)
            if len(calls) <= 2:
                raise RuntimeError("rendezvous refused")
            return real(*a, **kw) if real else None
        return fn, calls

    sleeps = {"jax": [], "torch": []}
    j_init, j_calls = flaky(None)
    monkeypatch.setattr(jax.distributed, "initialize", j_init)
    monkeypatch.setattr(jax.distributed, "shutdown", lambda: None)
    monkeypatch.setattr("time.sleep", lambda s: sleeps["jax"].append(s))
    JEnv._distributed_init_with_retry("127.0.0.1:1", 1, 0)

    t_init, t_calls = flaky(dist.init_process_group)
    destroyed = []
    real_destroy = dist.destroy_process_group
    monkeypatch.setattr(dist, "init_process_group", t_init)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a: destroyed.append(1) if not dist.is_initialized()
                        else real_destroy(*a))
    monkeypatch.setattr(transport.time, "sleep", lambda s: sleeps["torch"].append(s))
    env = get_env().init(device="cpu", world_size=8,
                         coordinator_address=f"127.0.0.1:{_free_port()}", num_processes=1,
                         process_id=0)
    assert env.process_count() == 1 and env.process_index() == 0
    assert len(t_calls) == len(j_calls) == 3
    assert sleeps["torch"] == sleeps["jax"] == [0.01, 0.02]
    assert len(destroyed) == 2
    monkeypatch.setattr(dist, "destroy_process_group", real_destroy)


@pytest.mark.parametrize("exported", [False, True])
def test_dist_init_knobs_read_as_jax(monkeypatch, exported):
    from mlsl_tpu.config import Config as JConfig

    for k, v in (("MLSL_DIST_INIT_RETRIES", "5"), ("MLSL_DIST_INIT_BACKOFF_S", "0.25")):
        if exported:
            monkeypatch.setenv(k, v)
        else:
            monkeypatch.delenv(k, raising=False)
    j, t = JConfig.from_env(), Config.from_env()
    assert (t.dist_init_retries, t.dist_init_backoff_s) == (j.dist_init_retries,
                                                             j.dist_init_backoff_s)
    t.validate()


@pytest.mark.parametrize("var,value", [("MLSL_DIST_INIT_RETRIES", "-1"),
                                       ("MLSL_DIST_INIT_BACKOFF_S", "-0.5")])
def test_dist_init_knobs_validated_as_jax(monkeypatch, var, value):
    from mlsl_tpu.config import Config as JConfig
    from mlsl_tpu.log import MLSLError as JMLSLError

    monkeypatch.setenv(var, value)
    with pytest.raises(JMLSLError, match=var):
        JConfig.from_env().validate()
    with pytest.raises(MLSLError, match=var):
        Config.from_env().validate()


# -- the layout -------------------------------------------------------------------

GRIDS = [(8, 1, 1), (4, 2, 1), (2, 4, 1), (1, 8, 1), (2, 2, 2), (1, 4, 2), (4, 1, 2)]
MATRIX = [(p, g) for p in (1, 2, 4, 8) for g in GRIDS]


@dataclasses.dataclass(frozen=True)
class FakeDevice:
    id: int
    process_index: int


def _jax_topology(monkeypatch, d, m, s, devices):
    from mlsl_tpu.comm import mesh as jmesh

    class StubMesh:
        def __init__(self, devs, axes):
            self.devices = devs
    monkeypatch.setattr(jmesh, "Mesh", StubMesh)
    return jmesh.Topology(d, m, devices, seq_parts=s)


@pytest.mark.parametrize("nproc,grid", MATRIX, ids=[f"P{p}-{g}" for p, g in MATRIX])
def test_box_layout_and_partitions(monkeypatch, nproc, grid):
    """Every process's box is its contiguous ranks, each rank's owner is the
    JAX package's process of that device, and each partition puts together
    exactly the processes that hold the same instances."""
    from mlsl_tpu.comm.mesh import dcn_aware_devices as jdcn

    d, m, s = grid
    fakes = [FakeDevice(i, i // (8 // nproc)) for i in range(8)]
    jt = _jax_topology(monkeypatch, d, m, s, fakes)
    seen = set()
    for i in range(nproc):
        t = Topology(d, m, 8, seq_parts=s, procs=(nproc, i))
        ranks = list(t.local_ranks())
        assert ranks == list(range(i * 8 // nproc, (i + 1) * 8 // nproc))
        assert int(np.prod(t.local_shape)) == len(ranks)
        for p in range(8):
            assert t.coords(p) == jt.coords(p)
            assert t.owner(p) == jt.mesh.devices[jt.coords(p)].process_index
        for p in ranks:
            lc = t.local_coords(p)
            assert all(0 <= c < n for c, n in zip(lc, t.local_shape))
            assert tuple(o + c for o, c in zip(t.local_origin, lc)) == t.coords(p)
            seen.add(p)
        for axes in (("data",), ("model",), ("data", "seq"), ("seq",),
                     ("replica", "data", "seq", "model")):
            g = ProcessGroup(t, axes)
            held = [{tuple(row) for row in g.member_table()
                     if any(t.owner(q) == j for q in row)} for j in range(nproc)]
            for part in g.process_partition():
                assert all(held[j] == held[part[0]] for j in part)
                assert not any(held[j] & held[part[0]] for j in range(nproc) if j not in part)
            local = g.localize()
            assert (local is not None) == all(len({t.owner(q) for q in row}) == 1
                                              for row in g.member_table())
            if local is not None:
                assert local.size == g.size and local.topology.world_size == len(ranks)
    assert seen == set(range(8))
    if 8 // nproc % (m * s) == 0:
        assert mesh.dcn_aware_devices(m, s, ranks=fakes) == tuple(
            dv.id for dv in jdcn(m, s, devices=fakes))
    else:
        with pytest.raises(MLSLError, match="must divide"):
            mesh.dcn_aware_devices(m, s, ranks=fakes)


@pytest.mark.parametrize("grid,nproc", [((2, 3, 1), 3), ((2, 6, 1), 3), ((3, 2, 1), 4)])
def test_non_box_grid_refused(grid, nproc):
    d, m, s = grid
    with pytest.raises(MLSLError, match="box|split"):
        Topology(d, m, d * m * s, seq_parts=s, procs=(nproc, 0))


def test_one_process_changes_nothing():
    t = Topology(4, 2, 8)
    g = ProcessGroup(t, ("data",))
    assert t.local_shape == t.grid_shape and t.local_topology() is t
    assert g.localize() is g and not g.spans


def test_tiers_by_host(monkeypatch, fake_world):
    monkeypatch.delenv("MLSL_MESH_TIERS", raising=False)
    fake_world(2, hosts=("a", "b"))
    assert mesh.world_tier_ids(8) == (0, 0, 0, 0, 1, 1, 1, 1)
    assert mesh.world_tiers(8) == (2, 4)
    fake_world(4, hosts=("b", "b", "a", "a"))
    assert mesh.world_tier_ids(8) == (1, 1, 1, 1, 0, 0, 0, 0)
    fake_world(4, hosts=("a",) * 4)
    assert mesh.world_tier_ids(8) is None
    # MLSL_MESH_TIERS still comes first
    fake_world(2, hosts=("a", "b"))
    monkeypatch.setenv("MLSL_MESH_TIERS", "4x2")
    assert mesh.world_tier_ids(8) == (0, 0, 1, 1, 2, 2, 3, 3)
    from mlsl_tpu_torch import sysinfo

    monkeypatch.delenv("MLSL_MESH_TIERS")
    assert sysinfo.topology_fingerprint(8, torch.device("cpu"))["num_hosts"] == 2


# -- refusals --------------------------------------------------------------------


def test_refusals_on_more_than_one_process(fake_world):
    from mlsl_tpu_torch.models import mlp
    from mlsl_tpu_torch.models import transformer as tfm
    from mlsl_tpu_torch.models.train import DataParallelTrainer
    from mlsl_tpu_torch.types import CompressionType, DataType, GroupType, ReductionType

    fake_world(2)
    env = get_env().init(device="cpu", world_size=8)
    assert env.process_layout() == (2, 0)
    dist = env.create_distribution(8, 1)
    assert dist.data_group.spans and dist.world_shape == (1, 4, 1, 1)
    # the kernel routes serve process-local groups only
    for algo in algos.KERNEL_ROUTES:
        assert not algos.eligible(algo, "allreduce", dist.data_group)
    grid = env.create_distribution(4, 2)
    assert algos.eligible("pallas_ring", "reduce_scatter", grid.model_group)
    # a compressed wire over a spanning group builds (A.8b.1): the composed
    # ring and the sparse wire, no hop until it is started
    from mlsl_tpu_torch.comm.request import CommDesc, CommRequest

    for comp, algo in ((CompressionType.QUANTIZATION, "quant_ring"),
                       (CompressionType.TOPK, "topk")):
        req = CommRequest(CommDesc("allreduce", dist.data_group, 256, DataType.FLOAT,
                                   op=ReductionType.SUM, compression=comp), env.dispatcher)
        req.setup()
        assert req._spans and req.algo == algo
    # the compiled overlap engine over a spanning gradient group (trap 6),
    # int8 or not (A.8b.6): never another program in its place
    for comp in (CompressionType.NONE, CompressionType.QUANTIZATION):
        sess = env.create_session()
        sess.set_global_minibatch_size(16)
        with pytest.raises(MLSLError, match="A.8b"):
            DataParallelTrainer(env, dist, sess, mlp.MLP(device="cpu"), mlp.loss_fn,
                                mlp.LAYERS, mlp.get_layer, lr=0.1, overlap_compiled=True,
                                compression=comp)
    from mlsl_tpu_torch.comm import overlap

    with pytest.raises(MLSLError, match="build_multi_reduce.*A.8b"):
        overlap.build_multi_reduce(dist.data_group, [64])
    with pytest.raises(MLSLError, match="build_zero1_update.*A.8b"):
        overlap.build_zero1_update(dist.data_group, [64], lr=0.5, denom=8.0)
    # A.8b.4's first three pieces build over the spanning data group: the
    # trainer and the feed hold this process's box, the pipeline's local
    # stage dim is the group's members here
    tr = tfm.HybridTrainer(env, tfm.TransformerConfig(), 8, 1, 1)
    assert tr.dist.data_group.spans and tr.grid == (1, 4, 1, 1)
    assert tr.params["embed"]["tok"].shape[:4] == (1, 4, 1, 1)
    # A.8b.4's last piece: the serving engine builds over the box, the model
    # group of tp = 8 spanning the two processes; this process holds global
    # rank 0 and leads, a follower's submit raises
    import dataclasses as dc

    from mlsl_tpu_torch.serve.engine import InferenceEngine

    scfg = tfm.TransformerConfig()
    eng = InferenceEngine(env, scfg, tp=8,
                          config=dc.replace(env.config, serve_kv_cache_mb=1))
    assert eng.is_leader and eng.spanning and not eng.graphed
    assert eng.grid == (1, 1, 1, 4) and eng.global_grid == (1, 1, 1, 8)
    assert eng.params["embed"]["tok"].shape[:4] == (1, 1, 1, 4)
    assert eng.kpool.shape[:4] == (1, 1, 1, 4)
    eng.close()     # its STOP finds no group here: logged, not raised
    from mlsl_tpu_torch.data.feed import DeviceFeed

    feed = DeviceFeed(lambda i: None, dist.topology)
    assert feed.codec.topo.local_shape == (1, 4, 1, 1)
    from mlsl_tpu_torch.parallel import pipeline

    with pytest.raises(MLSLError, match="group="):
        pipeline.gpipe_forward(lambda p, x: x, [], torch.zeros(4, 2, 1, 4), 0, 4)
    ranks, n, span = pipeline._ranks(torch.zeros(1, 4, 1, 1, 2, 1, 4), 1, 8,
                                     group=dist.data_group)
    assert ranks == (1, 4, 1, 1) and n == 4 and (span.off, span.gl, span.g) == (0, 4, 8)
    # A.8b.5: a color list restricts the world over both processes, K / 2
    # ranks each; a K that does not split raises, naming the split
    env.configure("color=0,1,0,1,0,1,0,1")
    assert env.get_process_count() == 4 and transport.world().world_size == 4
    rd = env.create_distribution(2, 2)
    assert rd.topology.grid_shape == (1, 2, 1, 2) and rd.topology.local_shape == (1, 1, 1, 2)
    with pytest.raises(MLSLError, match="1 ranks of color 0.*2 processes"):
        env.configure("color=0,1,1,1")
    assert env.get_process_count() == 4
    env.finalize()
    fake_world(2, index=1)
    env = get_env().init(device="cpu", world_size=8)
    fol = InferenceEngine(env, scfg, tp=8, config=dc.replace(env.config, serve_kv_cache_mb=1))
    assert not fol.is_leader and fol.leader == 0
    with pytest.raises(MLSLError, match="leader, process 0"):
        fol.submit([1, 2, 3], 2)
    fol.close()


def test_plan_verifier_flags_a_kernel_route_on_a_spanning_group(fake_world):
    from mlsl_tpu_torch.analysis import plan
    from mlsl_tpu_torch.analysis.diagnostics import Report
    from mlsl_tpu_torch.comm.request import CommDesc
    from mlsl_tpu_torch.types import DataType

    fake_world(2)
    t = Topology(8, 1, 8, procs=(2, 0))

    class Req:
        name, uid, algo = "x", 1, "pallas_ring"
        desc = CommDesc("allreduce", ProcessGroup(t, ("data",)), 64, DataType.FLOAT)
        _chunk_slices = [slice(None)]
    rep = Report()
    plan._check_kernel_route(rep, Req(), Config(), "sess")
    assert "MLSL-A132" in rep.codes()
    rep = Report()
    Req.desc = CommDesc("allreduce", ProcessGroup(Topology(8, 1, 8), ("data",)), 64,
                        DataType.FLOAT)
    plan._check_kernel_route(rep, Req(), Config(), "sess")
    assert not rep.codes()


# -- a one-process world ------------------------------------------------------------


def _mlp_run(env):
    from mlsl_tpu_torch.models import mlp
    from mlsl_tpu_torch.models.train import DataParallelTrainer
    from mlsl_tpu_torch.types import DataType, GroupType, ReductionType

    dist = env.create_distribution(4, 2)
    rng = np.random.default_rng(0)
    bufs = {n: rng.normal(size=(8, 64)).astype(np.float32) for n in ("a", "b")}
    outs = [env.wait(dist.all_reduce(dist.make_buffer(lambda p: bufs["a"][p], 64), 64,
                                     DataType.FLOAT, ReductionType.SUM, GroupType.DATA)),
            env.wait(dist.reduce_scatter(dist.make_buffer(lambda p: bufs["b"][p], 64), 32,
                                         DataType.FLOAT, ReductionType.SUM,
                                         GroupType.MODEL))]
    d8 = env.create_distribution(8, 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(16)
    model = mlp.MLP(device="cpu")
    tr = DataParallelTrainer(env, d8, sess, model, mlp.loss_fn, mlp.LAYERS, mlp.get_layer,
                             lr=0.1, distributed_update=True)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(16,)).astype(np.int64)
    for _ in range(2):
        outs.append(tr.step(tr.shard_batch(x, y)))
    outs += [p.detach().clone() for p in model.parameters()]
    env.finalize()
    return outs


def test_one_process_gloo_world_is_bit_for_bit_transportless():
    base = _mlp_run(get_env().init(device="cpu", world_size=8))
    env = get_env().init(device="cpu", world_size=8,
                         coordinator_address=f"127.0.0.1:{_free_port()}",
                         num_processes=1, process_id=0)
    assert transport.world().up and transport.world().backend == "gloo"
    got = _mlp_run(env)
    for a, b in zip(base, got):
        assert torch.equal(a, b)
    # the world outlives finalize, as jax.distributed does
    assert transport.world().up
    # each hop on a one-member world is its plain version
    x = torch.arange(24, dtype=torch.float32).reshape(2, 12)
    assert torch.equal(transport.all_reduce(x), x)
    assert torch.equal(transport.reduce_scatter(x[None]), x)
    assert torch.equal(transport.all_gather(x), x[None])
    assert torch.equal(transport.broadcast(x, 0), x)
    assert transport.hop_totals()["all_reduce"]["bytes"] == x.numel() * 4


def test_no_distributed_call_without_a_coordinator(monkeypatch):
    import torch.distributed as dist

    def boom(*a, **kw):
        raise AssertionError("torch.distributed called without a coordinator")
    for name in ("init_process_group", "all_reduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "broadcast", "barrier", "new_subgroups_by_enumeration",
                 "all_to_all_single", "batch_isend_irecv", "isend", "irecv"):
        monkeypatch.setattr(dist, name, boom)
    _mlp_run(get_env().init(device="cpu", world_size=8))
    # the compressed wires too: their ring shift is torch.roll in one process
    from mlsl_tpu_torch.types import CompressionType, DataType, GroupType, ReductionType

    env = get_env().init(device="cpu", world_size=8)
    dist8 = env.create_distribution(8, 1)
    for comp in (CompressionType.QUANTIZATION, CompressionType.TOPK):
        buf = dist8.make_buffer(lambda p: np.full(512, p + 0.5, np.float32), 512)
        env.wait(dist8.all_reduce(buf, 512, DataType.FLOAT, ReductionType.SUM, GroupType.DATA,
                                  compression=comp))
    # the serving engine sends no record, and the restricted world relays nothing
    from mlsl_tpu_torch.models import transformer as tfm
    from mlsl_tpu_torch.serve.engine import InferenceEngine

    cfg = tfm.TransformerConfig(vocab=64, d_model=32, n_heads=4, head_dim=8, n_blocks=1,
                                seq_len=64, dtype="float32")
    eng = InferenceEngine(env, cfg, tp=2, config=dataclasses.replace(env.config,
                                                                      serve_kv_cache_mb=1))
    req = eng.submit([1, 2, 3], 3)
    eng.run()
    assert len(req.result(timeout=5)) == 3 and eng.is_leader and eng.nproc == 1
    eng.close()
    env.configure("color=0,1,0,1,0,1,0,1")
    assert env.get_process_count() == 4 and transport.world().world_size == 8
    assert not transport.world().up


# -- the hop order across two processes ---------------------------------------------

ORDER_WORKER = textwrap.dedent('''
    import os, sys, time
    import numpy as np
    pid, port = int(sys.argv[1]), sys.argv[2]
    os.environ.update(MLSL_MSG_PRIORITY="1", MLSL_MSG_PRIORITY_THRESHOLD="0",
                      MLSL_MSG_PRIORITY_FLUSH_MS="50", MLSL_MSG_PRIORITY_MODE="1")
    from mlsl_tpu_torch import get_env
    from mlsl_tpu_torch.types import DataType, GroupType, ReductionType
    env = get_env().init(device="cpu", world_size=8, coordinator_address="127.0.0.1:" + port,
                         num_processes=2, process_id=pid)
    dist = env.create_distribution(8, 1)
    reqs = []
    for k, n in enumerate((64, 4096, 16, 1024)):
        if pid == 1:
            time.sleep(0.2)      # the slowed process
        buf = dist.make_buffer(lambda p: np.full(n, float(p + k), np.float32), n)
        reqs.append((k, n, dist.all_reduce(buf, n, DataType.FLOAT, ReductionType.SUM,
                                           GroupType.DATA)))
        assert reqs[-1][2]._spans and not env.dispatcher._pending
    sums = []
    for k, n, r in reversed(reqs):
        out = env.wait(r)
        want = float(sum(p + k for p in range(8)))
        for p in dist.topology.local_ranks():
            assert (dist.local_part(out, p) == want).all()
        sums.append(float(out.sum()))
    env.finalize()
    print("ORDER OK", sums, flush=True)
''')


def test_spanning_hops_keep_program_order_under_msg_priority(tmp_path):
    script = tmp_path / "order.py"
    script.write_text(ORDER_WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(i), port], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            tails = "\n".join(f"-- process {i}:\n{q.communicate()[0][-2000:]}"
                              for i, q in enumerate(procs))
            pytest.fail("the two processes deadlocked\n" + tails)
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "ORDER OK" in out, out[-2000:]
    # the sums' line only: c10d may log to the shared stderr after it
    sums = [next(line for line in out.splitlines() if line.startswith("ORDER OK"))
            for out in outs]
    assert sums[0] == sums[1], outs


def test_transport_is_the_only_module_calling_torch_distributed():
    """Every port module linted as if it sat outside A201's allowlist: only
    comm/transport.py calls a torch.distributed collective."""
    from mlsl_tpu_torch.analysis import lint

    pkg = os.path.join(ROOT, "mlsl_tpu_torch")
    callers = set()
    for base, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                src = open(path).read().replace("mlsl-lint:", "mlsl-lint-off:")
                if "MLSL-A201" in lint.lint_source(src, "probe/module.py").codes():
                    callers.add(os.path.relpath(path, pkg))
    assert callers == {os.path.join("comm", "transport.py")}


# -- the ring shift and the direct exchanges ----------------------------------------


def _shift_inputs(c=2, g=8, n=5):
    """A tuple of (c, g, ...) tensors of the compressed wires' dtypes, with
    signed zeros and a NaN in the floats."""
    gen = torch.Generator().manual_seed(3)
    f = torch.randn(c, g, n, generator=gen)
    f[:, :, 0] = -0.0
    f[0, 1, 1] = float("nan")
    q = torch.randint(-127, 128, (c, g, n * 4), generator=gen).to(torch.int8)
    i = torch.randint(0, 1 << 40, (c, g, 3), generator=gen)
    return f, q, i


def _same_bits(a, b):
    if a.dtype in (torch.float32, torch.bfloat16):
        bits = torch.int32 if a.dtype == torch.float32 else torch.int16
        a, b = a.view(bits), b.view(bits)
    return torch.equal(a, b)


def test_ring_shift_on_a_one_process_world_is_roll():
    """In a one-process gloo world nothing crosses: the shift of a tuple is
    ``torch.roll`` along the member dim, bit for bit, and a process-local
    group's Span is the one-process form."""
    get_env().init(device="cpu", world_size=8, coordinator_address=f"127.0.0.1:{_free_port()}",
                   num_processes=1, process_id=0)
    ts = _shift_inputs()
    group = ProcessGroup(Topology(8, 1, 8), ("data",))
    span = transport.span_of(group)
    assert not span.crosses and (span.g, span.gl, span.off) == (8, 8, 0)
    for got in (transport.ring_shift(ts, None, 0, 1), span.shift(*ts)):
        assert all(_same_bits(a, torch.roll(t, 1, dims=1)) for a, t in zip(got, ts))
    assert torch.equal(span.gather(ts[1]), ts[1])


SHIFT_WORKER = textwrap.dedent('''
    import sys
    import torch
    pid, port = int(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, sys.argv[3])
    from test_torch_transport import _same_bits, _shift_inputs
    from mlsl_tpu_torch import get_env
    from mlsl_tpu_torch.comm import collectives, transport
    from mlsl_tpu_torch.types import ReductionType
    env = get_env().init(device="cpu", world_size=8, coordinator_address="127.0.0.1:" + port,
                         num_processes=2, process_id=pid)
    ts = _shift_inputs()
    mine = [t[:, pid * 4:(pid + 1) * 4] for t in ts]
    got = transport.ring_shift(mine, None, pid, 2)
    for a, t in zip(got, ts):
        assert _same_bits(a, torch.roll(t, 1, dims=1)[:, pid * 4:(pid + 1) * 4]), t.dtype
    # the direct exchanges against the assembled form on every group
    for shape in ((8, 1), (4, 2), (2, 4)):
        dist = env.create_distribution(*shape)
        for group in (dist.data_group, dist.model_group):
            g = group.size
            if not transport.spans(group):
                continue
            buf = dist.make_buffer(lambda p: ts[0].reshape(-1)[:6 * g] + p, 6 * g)
            for kind, kw in (("alltoall", {"send_count": 6}), ("bcast", {"root": g - 1}),
                             ("bcast", {"root": 0}),
                             ("sendrecv", {"pairs": ((g - 1, 0), (0, g // 2))}),
                             ("sendrecv", {"pairs": tuple((i, (i + 3) % g) for i in range(g))})):
                direct = collectives.build_raw(kind, group, **kw)(buf)
                asm = transport.build_spanning(kind, group, None, direct=False, **kw)(buf)
                assert _same_bits(direct, asm), (shape, group.axes, kind, kw)
    env.finalize()
    print("SHIFT OK", flush=True)
''')


def test_ring_shift_and_direct_exchanges_across_two_processes(tmp_path):
    """Two processes of 4 ranks: each shifts its members' rows of a global
    tuple, which is then the global ``torch.roll`` bit for bit; the direct
    alltoall, bcast and sendrecv are the assembled form bit for bit."""
    script = tmp_path / "shift.py"
    script.write_text(SHIFT_WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(i), port,
                               os.path.join(ROOT, "tests")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            tails = "\n".join(f"-- process {i}:\n{q.communicate()[0][-2000:]}"
                              for i, q in enumerate(procs))
            pytest.fail("the two processes deadlocked\n" + tails)
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "SHIFT OK" in out, out[-2000:]


# -- the differentiable hops (the trainers across processes) ----------------------


def _one_member_span(g: int):
    """A Span over a one-process world whose hops take the autograd
    Functions' path: every member here, the subgroup the whole world."""
    return transport.Span(box=None, g=g, gl=g, off=0, partition=((0,),), index=0, size=1)


def _hop_cases():
    """(name, the hop on a one-member span, its plain twin in one process,
    an input) of each differentiable hop."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 4, 3, 4, 5, generator=gen)
    return {
        "shift": (lambda sp, t: transport._Shift.apply(sp, 1, -1, t)[0],
                  lambda t: torch.roll(t, -1, dims=1), x),
        "axis_sum": (lambda sp, t: transport._AxisSum.apply(sp, 1, False, t),
                     lambda t: t.sum(dim=1, keepdim=True).expand_as(t), x),
        "axis_all_to_all": (lambda sp, t: transport._AllToAll.apply(sp, 1, 3, t),
                            lambda t: t.transpose(1, 3), x),
        "axis_all_gather": (lambda sp, t: transport._AllGather.apply(sp, 1, 2, t),
                            lambda t: transport._concat_members(t, 1, 2, 4), x),
    }


@pytest.mark.parametrize("hop", ["shift", "axis_sum", "axis_all_to_all", "axis_all_gather"])
def test_differentiable_hop_is_its_plain_twin_and_passes_gradcheck(hop):
    """Each hop's autograd Function on a one-process gloo world: forward and
    gradient bit for bit its plain twin's (``torch.roll``, the broadcast
    sum, the transpose, the concatenation), and ``gradcheck`` in float64;
    each hop counts under its own kind."""
    get_env().init(device="cpu", world_size=8, coordinator_address=f"127.0.0.1:{_free_port()}",
                   num_processes=1, process_id=0)
    fn, plain, x = _hop_cases()[hop]
    span = _one_member_span(4)
    transport.reset_stats()
    a = x.clone().requires_grad_()
    b = x.clone().requires_grad_()
    ya, yb = fn(span, a), plain(b)
    assert _same_bits(ya.contiguous(), yb.contiguous())
    g = torch.randn(ya.shape, generator=torch.Generator().manual_seed(6))
    (ga,) = torch.autograd.grad(ya, a, g)
    (gb,) = torch.autograd.grad(yb, b, g)
    assert _same_bits(ga.contiguous(), gb.contiguous())
    if hop in ("axis_sum", "axis_all_gather"):   # a one-member shift or exchange
        assert transport.hop_totals()[hop]["calls"] == 2   # hands the backend nothing
    assert torch.autograd.gradcheck(lambda t: fn(span, t), (x.double().requires_grad_(),))


HOPS_WORKER = textwrap.dedent('''
    import sys
    import torch
    pid, port = int(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, sys.argv[3])
    from test_torch_transport import _same_bits
    from mlsl_tpu_torch import get_env
    from mlsl_tpu_torch.comm import transport
    from mlsl_tpu_torch.comm.mesh import ProcessGroup
    get_env().init(device="cpu", world_size=8, coordinator_address="127.0.0.1:" + port,
                   num_processes=2, process_id=pid)
    topo = get_env().create_distribution(1, 8).topology
    span = transport.span_of(ProcessGroup(topo, ("model",)))
    assert span.crosses and (span.g, span.gl, span.off) == (8, 4, 4 * pid)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 8, 3, generator=gen)           # (C, G, chunk/T, ...)
    cot = torch.randn(2, 8, 8, 3, generator=gen)
    mine = slice(4 * pid, 4 * pid + 4)

    def plain_gather(t):
        return t.reshape(2, 1, 64, 3).expand(2, 8, 64, 3)

    cases = (
        ("shift+1", lambda t: transport.shift(span, t, step=1)[0],
         lambda t: torch.roll(t, 1, dims=1), cot),
        ("shift-1", lambda t: transport.shift(span, t, step=-1)[0],
         lambda t: torch.roll(t, -1, dims=1), cot),
        ("axis_sum", lambda t: transport.axis_sum(span, t, 1),
         lambda t: t.sum(dim=1, keepdim=True).expand_as(t), cot),
        ("axis_all_to_all", lambda t: transport.axis_all_to_all(span, t, 1, 2),
         lambda t: t.transpose(1, 2), cot),
        ("axis_all_gather", lambda t: transport.axis_all_gather(span, t, 1, 2),
         plain_gather, torch.randn(2, 8, 64, 3, generator=gen)),
    )
    # float32, and bfloat16 (moved as its bytes)
    for dt in (torch.float32, torch.bfloat16):
        for name, hop, plain, g in cases:
            a = x[:, mine].to(dt).requires_grad_()
            b = x.to(dt).requires_grad_()
            ya, yb = hop(a), plain(b)
            assert _same_bits(ya.contiguous(), yb[:, mine].contiguous()), (name, dt)
            (ga,) = torch.autograd.grad(ya, a, g[:, mine].to(dt))
            (gb,) = torch.autograd.grad(yb, b, g.to(dt))
            assert _same_bits(ga.contiguous(), gb[:, mine].contiguous()), (name, dt)
    # K and V in one message: one hop a shift, forward and backward
    transport.reset_stats()
    k, v = (x[:, mine].clone().requires_grad_() for _ in range(2))
    k2, v2 = transport.shift(span, k, v)
    torch.autograd.grad((k2 * v2).sum(), (k, v))
    assert transport.hop_totals()["shift"]["calls"] == 2
    print("HOPS OK", flush=True)
''')


def test_differentiable_hops_across_two_processes(tmp_path):
    """Two processes of 4 model ranks each: every differentiable hop's rows
    and gradient rows are the one-process plain twin's local part, bit for
    bit (the shift both ways, the sum, the all-to-all, the all-gather), and
    a tuple's shift is one message each way."""
    script = tmp_path / "hops.py"
    script.write_text(HOPS_WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(i), port,
                               os.path.join(ROOT, "tests")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            tails = "\n".join(f"-- process {i}:\n{q.communicate()[0][-2000:]}"
                              for i, q in enumerate(procs))
            pytest.fail("the two processes deadlocked\n" + tails)
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "HOPS OK" in out, out[-2000:]


def test_compiled_step_over_a_spanning_model_group_is_a8b6(fake_world):
    """Trap 2: the fused step over a model group that spans processes runs
    eagerly; its compiled form raises, naming A.8b.6, before any hop."""
    from mlsl_tpu_torch.models import transformer as tfm

    fake_world(2)
    env = get_env().init(device="cpu", world_size=8)
    cfg = tfm.TransformerConfig(vocab=32, d_model=16, n_heads=8, head_dim=2, n_blocks=1,
                                seq_len=16, dtype="float32")
    tr = tfm.HybridTrainer(env, cfg, 1, 1, 8)
    assert tr.fused and tr.dist.model_group.spans and tr.grid == (1, 1, 1, 4)
    st, sl = tr.shard_tokens(np.zeros((1, 16), np.int32), np.zeros((1, 16), np.int32))
    with pytest.raises(MLSLError, match="A.8b.6"):
        tr.compiled_step(st, sl)


@pytest.mark.parametrize("schedule", ["gpipe_forward", "pipeline_loss", "one_f1b_step",
                                      "interleaved_1f1b_step"])
def test_pipeline_without_group_raises_on_several_processes(fake_world, schedule):
    """In a world of several processes a schedule needs the stage axis's
    group: without it, MLSLError naming the argument, before any hop."""
    from mlsl_tpu_torch.parallel import pipeline

    fake_world(2)
    x = torch.zeros(4, 2, 1, 4)
    fn = getattr(pipeline, schedule)
    args = {"gpipe_forward": (lambda p, t: t, {}, x, 0, 4),
            "pipeline_loss": (lambda p, t: t, lambda y, t: y.sum(), {}, x, x, 0, 4),
            "one_f1b_step": (lambda p, t: t, lambda y, t: y.sum(), {}, x, x, 0, 4),
            "interleaved_1f1b_step": (lambda p, t: t, lambda y, t: y.sum(), {}, x, x, 0, 4,
                                      2)}[schedule]
    with pytest.raises(MLSLError, match="group="):
        fn(*args)


# -- the compressed routes on spanning groups --------------------------------------


def test_compressed_kernel_routes_are_process_local(fake_world, monkeypatch):
    """B4 and the two-tier wire read every member on one device: neither is
    eligible for a spanning group (``use_pallas_for`` false), both as before
    on a process-local one, and the bucket planner sizes to the composed
    ring."""
    from mlsl_tpu_torch.comm import quant_ring

    monkeypatch.setenv("MLSL_MESH_TIERS", "2x4")
    cfg = Config()
    cfg._forced_algos = algos.parse_forced("pallas_ring")
    fake_world(2)
    t2 = Topology(8, 1, 8, procs=(2, 0))
    spanning = ProcessGroup(t2, ("data",))
    local = ProcessGroup(Topology(2, 4, 8, procs=(2, 0)), ("model",))
    assert spanning.spans and not local.spans
    assert not algos._quant_pallas_eligible(spanning, cfg)
    assert algos._quant_pallas_eligible(local, cfg)
    assert not quant_ring.use_pallas_for("allreduce", spanning, 1 << 20, cfg)
    assert quant_ring.use_pallas_for("allreduce", local, 1 << 20, cfg)
    # one process: the same group shape keeps the fused ring, as before
    one = ProcessGroup(Topology(8, 1, 8), ("data",))
    assert quant_ring.use_pallas_for("allreduce", one, 1 << 20, cfg)
    assert not algos._quant_hier_eligible("allreduce", spanning, cfg)
    assert algos._quant_hier_eligible("allreduce", one, cfg)
    # the aligned slice the planner sizes a bucket with follows the choice
    rc = 3 * 256 + 1
    assert quant_ring.ring_aligned_rc(rc, 256, False) != quant_ring.ring_aligned_rc(
        rc, 256, True)


@pytest.mark.parametrize("forced", ["pallas_ring", "hier"])
def test_forced_route_on_a_spanning_compressed_bucket_keeps_the_composed_ring(
        fake_world, monkeypatch, forced):
    """A forced ``pallas_ring`` or ``hier`` on an int8 request or bucket
    whose group spans processes builds the composed ring (``req.algo`` says
    so), the bucket's total is the composed ring's alignment, and the
    commit-time verifier passes its bucket geometry (A110/A111)."""
    from mlsl_tpu_torch.analysis import plan
    from mlsl_tpu_torch.comm import quant_ring
    from mlsl_tpu_torch.types import CompressionType, OpType

    monkeypatch.setenv("MLSL_ALGO", forced)
    monkeypatch.setenv("MLSL_MESH_TIERS", "2x4")
    fake_world(2)
    env = get_env().init(device="cpu", world_size=8)
    env.config.grad_bucket_mb = 1
    dist = env.create_distribution(8, 1)
    s = env.create_session()
    s.set_global_minibatch_size(8)
    ops = []
    for i, count in enumerate((3000, 1000)):
        r = s.create_operation_reg_info(OpType.CC)
        r.set_name(f"q{i}")
        r.add_output(4, 4)
        r.add_parameter_set(count, 1, compression_type=CompressionType.QUANTIZATION)
        ops.append(s.get_operation(s.add_operation(r, dist)))
    s.commit()
    bucket = ops[0].parameter_sets[0].bucket
    assert bucket is not None and bucket.req.algo == "quant_ring"
    g = dist.grad_group.size
    rc = -(-sum(bucket.slots) // g)
    assert bucket.total == g * quant_ring.ring_aligned_rc(rc, 256, False)
    rep = plan.verify_session(s)
    assert not {"MLSL-A110", "MLSL-A111", "MLSL-A132"} & set(rep.codes()), rep.codes()


def test_compressed_two_tier_wire_across_processes_is_a8b7(fake_world, monkeypatch):
    from mlsl_tpu_torch.comm import quant_ring

    monkeypatch.setenv("MLSL_MESH_TIERS", "2x4")
    fake_world(2)
    group = ProcessGroup(Topology(8, 1, 8, procs=(2, 0)), ("data",))
    with pytest.raises(MLSLError, match="A.8b.7"):
        quant_ring.build_quantized_collective("allreduce", group, 1024, 256, ring="hier")
    with pytest.raises(MLSLError, match="process-local"):
        quant_ring.build_quantized_collective("allreduce", group, 1024, 256, ring="pallas")


# -- the process index (A.8b.3) -----------------------------------------------------


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_straggler_shed_maps_the_process_index_as_jax(fake_world, monkeypatch, nproc):
    """The shed names every active rank of the process ``replica`` on a
    world of more than one process, and the replica's position with one,
    as ``mlsl_tpu/elastic.py`` does by ``process_index`` on devices that
    carry it; both refuse a replica that names nothing."""
    from mlsl_tpu import elastic as jelastic
    from mlsl_tpu.log import MLSLError as JMLSLError
    from mlsl_tpu_torch import elastic

    fake_world(nproc)
    fakes = tuple(FakeDevice(i, i // (8 // nproc)) for i in range(8))
    taken = {}
    jc = object.__new__(jelastic.ElasticCoordinator)
    jc.world = fakes
    monkeypatch.setattr(jc, "shrink", lambda tr, mk, error=None, step=0:
                        taken.setdefault("jax", tuple(d.id for d in error.devices)),
                        raising=False)
    tc = elastic.ElasticCoordinator(capacity_budget=4)
    tc._adopt_world(8)
    monkeypatch.setattr(tc, "shrink", lambda tr, mk, error=None, step=0:
                        taken.setdefault("torch", tuple(error.devices)))
    monkeypatch.setattr(jelastic, "_active", None)
    for replica in range(-1, 9):
        taken.clear()
        for side, c, err in (("jax", jc, JMLSLError), ("torch", tc, MLSLError)):
            try:
                c.shed(None, None, replica)
            except err:
                taken[side] = None
        assert taken["jax"] == taken["torch"], (replica, taken)
    elastic.reset()


def test_trainer_replica_id_is_the_process_index(fake_world):
    """Process 1 of 2 reports its straggler samples as replica 1, as the JAX
    trainer's ``jax.process_index()``."""
    from mlsl_tpu_torch.models import mlp
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    fake_world(2, index=1)
    env = get_env().init(device="cpu", world_size=8)
    dist = env.create_distribution(8, 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(16)
    tr = DataParallelTrainer(env, dist, sess, mlp.MLP(device="cpu"), mlp.loss_fn, mlp.LAYERS,
                             mlp.get_layer, lr=0.1)
    assert tr._replica_id == 1
