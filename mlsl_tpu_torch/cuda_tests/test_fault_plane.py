"""The fault plane on the card (chaos.py, supervisor.py, comm/request.py's
ladder, obs/serve.py), no JAX:

- a chaos site on code a CUDA graph records is idle while the graph is
  captured (no hit counted, no budget spent), and the site on the host
  before the replay fires at every replay: a bare collective captured by
  hand and through ``graph_capture.capture``, and the compiled overlap
  engine's step;
- a degraded dispatch on a CUDA buffer returns a CUDA tensor of the healthy
  path's shape and dtype, on the comm stream, in order with a later wait:
  the quant breaker's plain float32 SUM (B1 + B4 healthy) and the algo
  breaker's ``lax`` (B3 healthy), the latter bit for bit torch's sum on
  integer payloads;
- a kernel that fails to launch raises MLSLKernelError at every round and
  never counts against a breaker: no round is served by the plain version
  in B3's place;
- the watchdog's card branch: a round whose event is still pending on the
  comm stream trips in ``wait`` at the deadline, and the same round is
  waited for afterwards with the right sum;
- ``/healthz`` answers while the decode graph replays, from a handler thread
  that touches no CUDA tensor (every ``Tensor.cpu`` / ``item`` / ``tolist`` /
  ``numpy`` call is recorded with its thread).
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from mlsl_tpu_torch import chaos, supervisor
from mlsl_tpu_torch.comm import collectives
from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
from mlsl_tpu_torch.types import CompressionType, DataType, ReductionType


@pytest.fixture(autouse=True)
def _fault_plane():
    yield
    supervisor.reset_all()


@pytest.fixture()
def env(monkeypatch):
    from mlsl_tpu_torch import get_env

    made = []

    def make(**env_vars):
        get_env().finalize()
        for k in ("MLSL_ALGO", "MLSL_GRAD_BUCKET_MB", "MLSL_MSG_PRIORITY"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env_vars.items():
            monkeypatch.setenv(k, v)
        e = get_env().init(world_size=8)
        made.append(e)
        return e

    yield make
    get_env().finalize()


@pytest.mark.cuda
def test_cuda_site_idle_while_capturing_fires_at_each_replay():
    group = ProcessGroup(Topology(8, 1, 8), ("data",))
    fn = collectives.build_collective("allreduce", group, op=ReductionType.SUM)
    buf = torch.arange(8 * 1000, dtype=torch.float32, device="cuda").reshape(
        *group.topology.grid_shape, 1000)
    plan = chaos.plan("collective.dispatch", "error", times=None)
    # by hand: the warm-up under quiet(), the recording bare (the capture
    # rule alone keeps the site idle)
    with chaos.quiet():
        fn(buf)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(buf)
    assert plan.hits == 0

    def step():
        if chaos._plans:
            chaos.inject("collective.dispatch", kind="step")
        graph.replay()

    for i in range(3):
        with pytest.raises(chaos.ChaosError):
            step()
        assert plan.fires == i + 1
    chaos.clear()
    step()
    torch.cuda.synchronize()
    want = buf.reshape(8, 1000).sum(0)
    assert torch.equal(out.reshape(8, 1000)[0], want)
    # through graph_capture.capture: warm-up and recording pass no site
    from mlsl_tpu_torch.core import graph_capture

    plan = chaos.plan("collective.dispatch", "error", times=None)
    cap = graph_capture.capture(fn, [buf], [], "a bare allreduce")
    assert plan.hits == 0
    cap.replay([buf])
    torch.cuda.synchronize()
    assert torch.equal(cap.output.reshape(8, 1000)[0], want)


@pytest.mark.cuda
def test_cuda_engine_step_fires_at_its_host_site(env):
    """The compiled overlap engine (the MLP, int8 on the composed ring): a
    plan armed before the capture spends nothing in it; every step raises
    at its host site before the replay and leaves the state as it was."""
    from mlsl_tpu_torch.models import mlp
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    e = env(MLSL_OVERLAP_COMPILED="1")
    dist = e.create_distribution(8, 1)
    sess = e.create_session()
    sess.set_global_minibatch_size(32)
    tr = DataParallelTrainer(e, dist, sess, mlp.MLP(device="cuda"), mlp.loss_fn, mlp.LAYERS,
                             mlp.get_layer, lr=0.1, compression=CompressionType.QUANTIZATION)
    rng = np.random.default_rng(0)
    batch = tr.shard_batch(rng.normal(size=(32, 8)).astype(np.float32),
                           rng.integers(0, 4, size=(32,)).astype(np.int32))
    assert tr._overlap is not None
    plan = chaos.plan("collective.dispatch", "error", times=None)
    tr.precompile(batch)
    torch.cuda.synchronize()
    assert plan.hits == 0 and list(tr._overlap.graphs) == ["step"]
    state = [t.detach().clone() for t in tr._overlap._state()]
    for i in range(2):
        with pytest.raises(chaos.ChaosError):
            tr.step(batch)
        assert plan.fires == i + 1
    assert all(torch.equal(a, b) for a, b in zip(tr._overlap._state(), state))
    chaos.clear()
    loss = tr.step(batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss).all())


def _request(e, n, quant=False):
    from mlsl_tpu_torch.comm.request import CommDesc, CommRequest

    dist = e.create_distribution(8, 1)
    req = CommRequest(CommDesc("allreduce", dist.data_group, n, DataType.FLOAT,
                               op=ReductionType.SUM,
                               compression=(CompressionType.QUANTIZATION if quant
                                            else CompressionType.NONE)),
                      e.dispatcher, name="degrade")
    req.setup()
    return dist, req


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["algo_lax", "quant_plain"])
def test_cuda_degraded_dispatch_returns_the_healthy_shape(env, quant):
    e = env(MLSL_ALGO="pallas_ring")
    dist, req = _request(e, 4096 * 8, quant)
    assert req.algo == "pallas_ring"
    grid = dist.topology.grid_shape
    vals = np.random.default_rng(1).integers(-40, 40, size=(8, 4096 * 8)).astype(np.float32)
    buf = torch.from_numpy(vals).reshape(*grid, -1).cuda()
    healthy = req.start(buf).wait().clone()
    br = supervisor.breaker("quant" if quant else "algo")
    for _ in range(br.threshold):
        br.record_failure(RuntimeError("card test"))
    # a later in-place write on the caller's stream must not race the
    # degraded round, which the comm stream runs
    out = req.start(buf).wait()
    buf.mul_(0)
    torch.cuda.synchronize()
    assert out.is_cuda and out.shape == healthy.shape and out.dtype == healthy.dtype
    rows = out.reshape(8, -1)
    assert bool((rows == rows[:1]).all())
    exact = torch.from_numpy(vals.astype(np.float64).sum(0)).cuda()
    if quant:
        # the plain float32 SUM of payload + the residual the healthy round left
        assert float((rows[0].double() - exact).abs().max()) <= 2.0
    else:
        assert torch.equal(rows[0].double(), exact)
    from mlsl_tpu_torch.core import stats

    assert stats.DEGRADE_FALLBACKS == {("quant" if quant else "algo"): 1}


class _FailingLaunch:
    """Stands in for the ring library: every launch returns a CUDA error."""

    def mlsl_dense_ring(self, *args):
        return 719   # cudaErrorLaunchFailure


@pytest.mark.cuda
def test_cuda_kernel_launch_failure_raises_and_never_degrades(env, monkeypatch):
    from mlsl_tpu_torch.core import stats
    from mlsl_tpu_torch.log import MLSLKernelError
    from mlsl_tpu_torch.ops import ring_kernels as rk

    e = env(MLSL_ALGO="pallas_ring")
    dist, req = _request(e, 4096 * 8)
    assert req.algo == "pallas_ring"
    vals = np.random.default_rng(2).integers(-40, 40, size=(8, 4096 * 8)).astype(np.float32)
    buf = torch.from_numpy(vals).reshape(*dist.topology.grid_shape, -1).cuda()
    healthy = req.start(buf).wait().clone()
    launched = rk.LAUNCHES["dense_ring"]
    real = rk._kernels
    monkeypatch.setattr(rk, "_kernels", lambda: _FailingLaunch())
    br = supervisor.breaker("algo")
    for _ in range(2 * br.threshold + 1):
        with pytest.raises(MLSLKernelError, match="launch failed: cudaError 719"):
            req.start(buf).wait()
    assert br.state == supervisor.CLOSED and br.status()["failures_in_window"] == 0
    assert stats.DEGRADE_FALLBACKS == {} and rk.LAUNCHES["dense_ring"] == launched
    monkeypatch.setattr(rk, "_kernels", real)
    out = req.start(buf).wait()
    torch.cuda.synchronize()
    assert torch.equal(out, healthy) and rk.LAUNCHES["dense_ring"] == launched + 1


@pytest.mark.cuda
def test_cuda_watchdog_trips_in_wait_on_a_pending_event(env):
    from mlsl_tpu_torch.core import stats
    from mlsl_tpu_torch.log import MLSLTimeoutError

    e = env(MLSL_ALGO="pallas_ring", MLSL_WATCHDOG_TIMEOUT="0.2")
    dist, req = _request(e, 4096 * 8)
    vals = np.random.default_rng(3).integers(-40, 40, size=(8, 4096 * 8)).astype(np.float32)
    buf = torch.from_numpy(vals).reshape(*dist.topology.grid_shape, -1).cuda()
    req.start(buf).wait(timeout=0)   # builds B3 and its tables outside the deadline
    torch.cuda.synchronize()
    comm = e.dispatcher.stream_for(buf.device)
    with torch.cuda.stream(comm):
        torch.cuda._sleep(2_000_000_000)   # about 1 s at the H100's clocks
    t0 = time.monotonic()
    req.start(buf)
    with pytest.raises(MLSLTimeoutError, match="stuck in wait"):
        req.wait()
    assert time.monotonic() - t0 < 1.0 and not req._event.query()
    assert stats.WATCHDOG_EVENTS[-1]["phase"] == "wait"
    out = req.wait(timeout=0)
    torch.cuda.synchronize()
    exact = torch.from_numpy(vals.astype(np.float64).sum(0)).cuda()
    rows = out.reshape(8, -1)
    assert torch.equal(rows[0].double(), exact) and bool((rows == rows[:1]).all())


@pytest.mark.cuda
def test_cuda_healthz_answers_while_the_decode_graph_replays(monkeypatch):
    from mlsl_tpu_torch import get_env, obs
    from mlsl_tpu_torch.models import transformer as tfm
    from mlsl_tpu_torch.serve.engine import InferenceEngine

    cfg = tfm.TransformerConfig(vocab=256, d_model=128, n_heads=2, head_dim=64, n_blocks=4,
                                seq_len=256, dtype="bfloat16")
    get_env().finalize()
    monkeypatch.setenv("MLSL_SERVE_MAX_BATCH", "4")
    monkeypatch.setenv("MLSL_SERVE_KV_CACHE_MB", "64")
    e = get_env().init(world_size=1)
    eng = InferenceEngine(e, cfg, tp=1, seed=0)
    srv = obs.start_server(port=0, addr="127.0.0.1")
    assert srv is not None
    main = threading.main_thread()
    reads = []
    for name in ("cpu", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            if threading.current_thread() is not main:
                reads.append((_name, threading.current_thread().name, self.device.type))
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    answers, stop = [], threading.Event()

    def scrape():
        url = f"http://127.0.0.1:{srv.port}/healthz"
        while not stop.is_set():
            answers.append(json.loads(urllib.request.urlopen(url, timeout=10).read()))

    rng = np.random.default_rng(0)
    for _ in range(4):
        eng.submit(rng.integers(1, cfg.vocab, size=40).astype(np.int32), 48)
    eng.run(max_steps=2)                  # the prefills and the capture
    assert eng._decode_cache
    client = threading.Thread(target=scrape, name="scraper")
    client.start()
    eng.run()
    stop.set()
    client.join(timeout=30)
    eng.close()
    get_env().finalize()
    assert answers and all("serve" in a and "quant" in a for a in answers)
    assert not [r for r in reads if r[2] == "cuda"], reads
