"""The multi-process transport in one process (comm/transport.py, comm/mesh.py).

Held against the JAX package where it has a counterpart: the bootstrap's
retry loop (``Environment._distributed_init_with_retry``), the knobs, and the
rank layout of ``dcn_aware_devices`` and ``Topology`` on fake devices that
carry ``process_index`` and ``id``. The rest states the port's own
contracts: the box layout and its refusal, the subgroup partitions, tiers by
host, the A.8b refusals, a one-process gloo world bit for bit the
transport-less one, and the hop order under ``msg_priority`` across two
processes. Tests that bring up ``torch.distributed`` destroy it in teardown:
this file shares an xdist worker with others.
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
    # a compressed wire over a spanning group is A.8b
    buf = torch.zeros(1, 4, 1, 1, 256)
    with pytest.raises(MLSLError, match="A.8b"):
        dist.all_reduce(buf, 256, DataType.FLOAT, ReductionType.SUM, GroupType.DATA,
                        compression=CompressionType.QUANTIZATION)
    # the compiled overlap engine over a spanning gradient group (trap 6)
    sess = env.create_session()
    sess.set_global_minibatch_size(16)
    with pytest.raises(MLSLError, match="A.8b"):
        DataParallelTrainer(env, dist, sess, mlp.MLP(device="cpu"), mlp.loss_fn, mlp.LAYERS,
                            mlp.get_layer, lr=0.1, overlap_compiled=True)
    from mlsl_tpu_torch.comm import overlap

    with pytest.raises(MLSLError, match="build_multi_reduce.*A.8b"):
        overlap.build_multi_reduce(dist.data_group, [64])
    with pytest.raises(MLSLError, match="build_zero1_update.*A.8b"):
        overlap.build_zero1_update(dist.data_group, [64], lr=0.5, denom=8.0)
    with pytest.raises(MLSLError, match="HybridTrainer.*A.8b"):
        tfm.HybridTrainer(env, tfm.TransformerConfig(), 8, 1, 1)
    from mlsl_tpu_torch.serve.engine import InferenceEngine

    with pytest.raises(MLSLError, match="serving.*A.8b"):
        InferenceEngine(env, tfm.TransformerConfig())
    from mlsl_tpu_torch.data.feed import DeviceFeed

    with pytest.raises(MLSLError, match="feed.*A.8b"):
        DeviceFeed(lambda i: None, dist.topology)
    from mlsl_tpu_torch.parallel import pipeline

    with pytest.raises(MLSLError, match="pipeline.*A.8b"):
        pipeline.gpipe_forward(lambda p, x: x, [], torch.zeros(4, 2, 1, 4), 0, 4)


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
                 "reduce_scatter_tensor", "broadcast", "barrier", "new_subgroups_by_enumeration"):
        monkeypatch.setattr(dist, name, boom)
    _mlp_run(get_env().init(device="cpu", world_size=8))
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
