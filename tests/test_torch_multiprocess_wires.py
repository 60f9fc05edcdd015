"""The compressed wires and the direct exchanges across processes.

``python -m mlsl_tpu_torch.tools.mp_worker`` runs its ``wires``,
``exchanges`` and ``train_int8`` phases in worlds of 2 processes x 4 virtual
ranks and 4 x 2 over gloo on the CPU, and once as one process of 8 ranks
without a coordinator (the twin). Every process's rows are held:

- against the twin, bit for bit (the bits of float32, so a sign flip of a
  zero shows): the int8 ring and its sum body, both top-k formats, the
  registry codecs and the user codec run the one-process arithmetic on each
  process's members, and only the compressed rows cross (comm/transport.py's
  ring shift); the MLP trained on the int8 ring ends with the twin's bits on
  every process;
- against the JAX package's run of the same wires on its 8 CPU devices
  (``build_quantized_collective``, ``build_sparse_collective`` and the codec
  ring, through its requests), run in a subprocess with XLA's two rewrites of
  the int8 arithmetic switched off (``--xla_disable_hlo_passes=algsimp
  --xla_cpu_max_isa=AVX``, tests/test_torch_quant_ring.py): bit for bit,
  except the VQ codec within 1e-6 (its decode's product); the exchanges bit
  for bit; the int8 trainer's parameters within 1e-3 of the JAX trainer's
  (tests/test_torch_train.py's bound for the int8 trainer);
- the direct alltoall, bcast and sendrecv are bit for bit their assembled
  form in each worker, and, summed over the processes, hand the backend no
  more bytes on any group and fewer for each kind;
- the codec guardrail, fed by a sentinel gate whose loss outliers sit on
  rank 0 alone, demotes on every process at the twin's step: the gate
  screens the whole world's rows on each process.

Each world runs under a 240 s limit that kills every worker and fails the
test. The 8 x 1 world (every member in its own process) is ``slow``.
"""

import json
import os
import random
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from mlsl_tpu_torch.tools import mp_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
PHASES = "wires,exchanges,train_int8,guard"
#: rows every process holds
REPLICATED = ("train8/params/", "csum/", "guard/")
#: tests/test_torch_train.py's bound for the int8 trainer against JAX's
INT8_TRAIN_ATOL = 1e-3
VQ_TOL = 1e-6


def _free_port() -> int:
    """A free port below Linux's default ephemeral range (32768-60999)."""
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


def _params_file(tmp):
    import jax

    from mlsl_tpu.models.mlp import init

    path = tmp / "params.npz"
    np.savez(path, **{f"{k}/{n}": np.asarray(v) for k, leaf in
                      init(jax.random.PRNGKey(0)).items() for n, v in leaf.items()})
    return path


def _start(tmp, nproc, params, phases=PHASES):
    """Start a world's workers (``nproc`` 0: the twin). -> (procs, out dir)."""
    out_dir = tmp / f"out{nproc}"
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    n = max(nproc, 1)
    port = ["--port", str(_free_port())] if nproc else []
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mlsl_tpu_torch.tools.mp_worker", "--pid", str(i),
         "--nproc", str(n), *port, "--device", "cpu", "--out", str(out_dir),
         "--params", str(params), "--phases", phases],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for i in range(n)]
    return procs, out_dir


def _join(procs, out_dir, what):
    """Every worker's output, each checked; the world's merged rows and
    reports. A worker past TIMEOUT kills all and fails."""
    outs = []
    for i, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"{what}: proc {i} of {len(procs)} timed out after {TIMEOUT} s")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"proc {i} E2E OK" in out, f"{what} proc {i}:\n{out[-3000:]}"
    rows = {}
    for i in range(len(procs)):
        with np.load(out_dir / f"proc{i}.npz") as z:
            for k in z.files:
                if k.startswith(REPLICATED):
                    rows.setdefault(k, []).append(z[k])
                else:
                    assert k not in rows, f"rank row {k} written by two processes"
                    rows[k] = z[k]
    reports = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("REPORT "))[7:])
               for out in outs]
    return rows, reports


_JAX_EXACT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from tests.test_torch_multiprocess_wires import jax_reference
np.savez(sys.argv[2], **jax_reference(sys.argv[3]))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The twin, the 2 x 4 and 4 x 2 worlds and the JAX package's run, all
    started together. -> {"twin" | 2 | 4: (rows, reports), "jax": rows}."""
    tmp = tmp_path_factory.mktemp("mp_wires")
    params = _params_file(tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=("--xla_force_host_platform_device_count=8 "
                          "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"))
    jax_out = tmp / "jax.npz"
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX_EXACT, ROOT, str(jax_out),
                                 str(params)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    started = {k: _start(tmp, k, params) for k in (0, 2, 4)}
    out = {("twin" if k == 0 else k): _join(*v, what=f"world {k}") for k, v in started.items()}
    try:
        log = jax_proc.communicate(timeout=TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        jax_proc.kill()
        jax_proc.communicate()
        pytest.fail(f"the JAX run timed out after {TIMEOUT} s")
    assert jax_proc.returncode == 0, log[-3000:]
    out["jax"] = dict(np.load(jax_out))
    return out


# -- the JAX package's run ------------------------------------------------------


def jax_kit():
    import jax.numpy as jnp

    from mlsl_tpu import types as JT
    from mlsl_tpu.comm import sparse as jsparse
    from mlsl_tpu.comm.mesh import ProcessGroup as JGroup
    from mlsl_tpu.comm.request import CommDesc as JDesc, CommRequest as JReq

    def custom(wire):
        kw = dict(compress_fn=lambda x: x.astype(jnp.float16),
                  decompress_fn=lambda p, n: p.astype(jnp.float32))
        if wire == "f16_reduce":
            kw["reduce_sum_fn"] = lambda a, b: a + b
        return kw

    return SimpleNamespace(types=JT, CommDesc=JDesc, CommRequest=JReq, ProcessGroup=JGroup,
                           sparse=jsparse, QuantParams=JT.QuantParams, custom=custom,
                           err=lambda req: req._err)


def jax_reference(params_path) -> dict:
    """{key/rank: row} of the JAX package's run of the worker's wires, its
    exchanges and its int8 trainer, on its 8 CPU devices."""
    import jax

    import mlsl_tpu as mlsl
    from mlsl_tpu import types as JT
    from mlsl_tpu.models import mlp as jmlp
    from mlsl_tpu.models.train import DataParallelTrainer as JTrainer

    env = mlsl.Environment.get_env().init()
    out = {}

    def save(key, dist, buf):
        for p in range(W.WORLD):
            out[f"{key}/{p}"] = np.asarray(dist.local_part(buf, p))

    try:
        W.run_wires(jax_kit(), env, save)
        for shape in ((8, 1), (4, 2), (2, 4)):
            dist = env.create_distribution(*shape)
            for g in sorted({s for s in shape if s > 1}):
                n = 6 * g
                for tag, _, _, start in W.exchange_requests(dist, g, n, JT):
                    buf = dist.make_buffer(lambda p: W.exchange_fill(p, n), n)
                    save(f"exch/{shape[0]}x{shape[1]}/{tag}", dist, env.wait(start(buf)))
        with np.load(params_path) as z:
            params = {}
            for k in z.files:
                layer, leaf = k.split("/")
                params.setdefault(layer, {})[leaf] = jax.numpy.asarray(z[k])
        rng = np.random.default_rng(0)
        x = rng.normal(size=(W.TRAIN_B, 8)).astype(np.float32)
        y = rng.integers(0, 4, size=(W.TRAIN_B,)).astype(np.int32)
        d8 = env.create_distribution(8, 1)
        sess = env.create_session()
        sess.set_global_minibatch_size(W.TRAIN_B)
        tr = JTrainer(env, d8, sess, params, jmlp.loss_fn, jmlp.LAYERS, jmlp.get_layer, lr=0.1,
                      compression=JT.CompressionType.QUANTIZATION)
        batch = tr.shard_batch(x, y)
        for _ in range(2):
            tr.step(batch)
        for k, leaf in tr.params.items():
            for n, v in leaf.items():
                out[f"train8/params/{k}/{n}"] = np.asarray(v)
    finally:
        env.finalize()
    return out


# -- the holds --------------------------------------------------------------------


def _bits(a):
    a = np.atleast_1d(np.asarray(a))
    return a.view(np.uint32) if a.dtype == np.float32 else a


WORLDS = pytest.mark.parametrize("nproc", [2, 4], ids=["2x4", "4x2"])


@WORLDS
def test_rows_match_the_one_process_twin_bit_for_bit(runs, nproc):
    rows, _ = runs[nproc]
    twin, _ = runs["twin"]
    assert set(rows) == set(twin)
    for k, want in twin.items():
        got = rows[k]
        if k.startswith(REPLICATED):
            assert len(got) == nproc, k
            for g in got:   # every process holds the twin's bits
                np.testing.assert_array_equal(_bits(g), _bits(want[0]), err_msg=k)
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)


def _wire_of(key):
    name = key.split("/")[1]
    return next(c[3] for c in W.WIRE_CASES if c[0] == name)


@WORLDS
@pytest.mark.parametrize("family", ["int8", "topk", "codec"])
def test_wires_match_jax(runs, nproc, family):
    """Every round's result and residual on every rank against the JAX
    package's 8-device run."""
    rows, _ = runs[nproc]
    ref = runs["jax"]
    wires = {"int8": ("int8",), "topk": ("topk", "topk_ring"),
             "codec": ("prune", "vq", "f16", "f16_reduce")}[family]
    keys = [k for k in ref if k.startswith("wires/") and _wire_of(k) in wires]
    assert len(keys) == W.WIRE_ROUNDS * 2 * 8 * sum(c[3] in wires for c in W.WIRE_CASES)
    for k in keys:
        if _wire_of(k) == "vq":
            np.testing.assert_allclose(rows[k], ref[k], rtol=VQ_TOL, atol=VQ_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(rows[k], ref[k], err_msg=k)


@WORLDS
def test_exchanges_match_jax_with_fewer_bytes(runs, nproc):
    """The direct exchanges: JAX's rows bit for bit (each worker held them
    to the assembled form already), and, summed over the processes, no
    more bytes than the assembled form on any group that spans them and
    fewer for each kind over the groups: a sendrecv whose every pair
    crosses between one-member boxes moves what the assembled form does."""
    rows, reports = runs[nproc]
    ref = runs["jax"]
    keys = [k for k in ref if k.startswith("exch/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(rows[k], ref[k], err_msg=k)
    spanning = reports[0]["exchange_bytes"]
    assert spanning and all(set(r["exchange_bytes"]) == set(spanning) for r in reports)
    totals = {}
    for key in spanning:
        direct = sum(r["exchange_bytes"][key]["direct"] for r in reports)
        assembled = sum(r["exchange_bytes"][key]["assembled"] for r in reports)
        assert direct <= assembled, (key, direct, assembled)
        kind = key.rsplit("/", 1)[1].split("_")[0]
        t = totals.setdefault(kind, [0, 0])
        t[0], t[1] = t[0] + direct, t[1] + assembled
    assert set(totals) == {"alltoall", "bcast", "sendrecv"}
    assert all(d < a for d, a in totals.values()), totals


@WORLDS
def test_int8_trainer_matches_jax(runs, nproc):
    rows, _ = runs[nproc]
    ref = runs["jax"]
    keys = [k for k in ref if k.startswith("train8/params/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(rows[k][0], ref[k], rtol=0, atol=INT8_TRAIN_ATOL, err_msg=k)


def _expected_shifts(nproc) -> int:
    """The ring shifts one process issues in phase ``wires``: 2(G - 1) a
    round of a ring allreduce, G - 1 of a reduce_scatter and of the top-k
    ring, over every single-axis group that spans processes; none on a
    process-local group, the sum bodies or the all-gather format."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    n = 0
    for _, (d, m), axes, wire, kind, _ in W.WIRE_CASES:
        group = ProcessGroup(Topology(d, m, W.WORLD, procs=(nproc, 0)), axes)
        if len(axes) != 1 or not group.spans or wire == "topk":
            continue
        g = group.size
        n += (g - 1) * (1 if kind == "reduce_scatter" or wire == "topk_ring" else 2)
    return n * W.WIRE_ROUNDS


@WORLDS
def test_every_process_issues_the_same_shifts(runs, nproc):
    """Trap 5 of comm/transport.py: each process issues the same ring
    shifts, as many as the rings' loops over the global G give."""
    _, reports = runs[nproc]
    calls = [r["wires"]["hops"]["ring_shift"]["calls"] for r in reports]
    assert calls == [_expected_shifts(nproc)] * nproc
    # the int8 rows and their float32 scales cross, never float32 rows alone
    dtypes = reports[0]["wires"]["hops"]["ring_shift"]["dtypes"]
    assert dtypes["int8"] > 0 and dtypes["float32"] < dtypes["int8"]


@WORLDS
def test_guardrail_demotes_on_every_process_at_once(runs, nproc):
    rows, _ = runs[nproc]
    twin, _ = runs["twin"]
    steps = [int(v) for v in rows["guard/demoted_at"]]
    assert steps == [int(twin["guard/demoted_at"][0])] * nproc and steps[0] >= 7, steps


@pytest.mark.slow
def test_eight_process_wires_match_the_twin(tmp_path):
    """One rank a process: every hop of every wire crosses processes."""
    params = _params_file(tmp_path)
    twin = _join(*_start(tmp_path, 0, params), what="twin")[0]
    rows = _join(*_start(tmp_path, 8, params), what="world 8")[0]
    for k, want in twin.items():
        got = rows[k][0] if k.startswith(REPLICATED) else rows[k]
        want = want[0] if k.startswith(REPLICATED) else want
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)
