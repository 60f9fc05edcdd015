"""The port's multi-process worlds against the JAX package's single-process run.

The JAX package's anchors are tests/test_multiprocess.py (2 processes x 4
devices) and tests/test_multiprocess_e2e.py (2 x 4, 4 x 2 and, slow, 8 x 1),
both over gloo. Here ``python -m mlsl_tpu_torch.tools.mp_worker`` is that
pair of worker scripts on the port: P processes share one world of 8 virtual
ranks on the CPU (``device="cpu"``, gloo), each checks the closed forms on its
own ranks and writes its rows to ``proc<i>.npz``. This file holds every
process's rows against the same phases run by the JAX package in this
process on its 8 CPU devices, and the trained MLP against the JAX trainer's
(the port's parameters are in the JAX layout, models/convert.py).

Tolerances: float sums that cross processes add in another order than JAX's
(a local sum, then gloo's), so they are held to rtol 1e-6, as the JAX
package's multi-process tests hold theirs; concatenations and moves are bit
for bit; the trained parameters within 1e-6; every process ends with
bit-identical parameters (the same ``csum``). Each world runs under a 240 s
timeout that kills every worker and fails the test.
"""

import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
RTOL = 1e-6
E2E = "hierarchy,gather,loop,matrix,kinds,train"
#: rows every process holds (gather_to_host delivers to every process)
REPLICATED = ("train/params/", "gather/")


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


def _jax_params():
    import jax

    from mlsl_tpu.models.mlp import init

    return {k: {n: np.asarray(v) for n, v in leaf.items()}
            for k, leaf in init(jax.random.PRNGKey(0)).items()}


def run_world(tmp_path, nproc: int, phases: str):
    """Start ``nproc`` workers; -> (their outputs, the merged rows)."""
    params = tmp_path / "params.npz"
    np.savez(params, **{f"{k}/{n}": v for k, leaf in _jax_params().items()
                        for n, v in leaf.items()})
    out_dir = tmp_path / "out"
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mlsl_tpu_torch.tools.mp_worker", "--pid", str(i),
         "--nproc", str(nproc), "--port", str(port), "--device", "cpu", "--out",
         str(out_dir), "--params", str(params), "--phases", phases],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for i in range(nproc)]
    outs = []
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"proc {i} of {nproc} timed out after {TIMEOUT} s")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} E2E OK" in out, out[-3000:]
    rows = {}
    for i in range(nproc):
        with np.load(out_dir / f"proc{i}.npz") as z:
            for k in z.files:
                if k.startswith(REPLICATED):
                    rows.setdefault(k, []).append(z[k])
                else:
                    assert k not in rows, f"rank row {k} written by two processes"
                    rows[k] = z[k]
    return outs, rows


# -- the JAX package's single-process run of the same phases ----------------------


def _jax_reference(phases):
    """{key/rank: row} of the JAX package's run on its 8 CPU devices."""
    import jax

    import mlsl_tpu as mlsl
    from mlsl_tpu.core.activation import pack_local
    from mlsl_tpu.models import mlp as jmlp
    from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
    from mlsl_tpu.types import DataType, GroupType, OpType, ReductionType

    from mlsl_tpu_torch.tools import mp_worker as W

    env = mlsl.Environment.get_env().init()
    out = {}

    def save(key, dist, buf):
        for p in range(W.WORLD):
            out[f"{key}/{p}"] = np.asarray(dist.local_part(buf, p))

    def net(dist, du=False):
        s = env.create_session()
        s.set_global_minibatch_size(W.MB)
        r1 = s.create_operation_reg_info(OpType.CC)
        r1.add_input(W.FM1, W.FM_SIZE)
        r1.add_output(W.FM2, W.FM_SIZE)
        r1.add_parameter_set(W.FM1 * W.FM2, 1, distributed_update=du)
        op1 = s.get_operation(s.add_operation(r1, dist))
        r2 = s.create_operation_reg_info(OpType.CC)
        r2.add_input(W.FM2, W.FM_SIZE)
        r2.add_output(W.FM1, W.FM_SIZE)
        r2.add_parameter_set(W.FM2 * W.FM1, 1, distributed_update=du)
        op2 = s.get_operation(s.add_operation(r2, dist))
        op1.set_next(op2, 0, 0)
        s.commit()
        return op1, op2

    try:
        if "basic" in phases:
            dist = env.create_distribution(8, 1)
            buf = dist.make_buffer(lambda p: np.full(16, float(p + 1), np.float32), 16)
            save("basic/allreduce", dist, env.wait(dist.all_reduce(
                buf, 16, DataType.FLOAT, ReductionType.SUM, GroupType.DATA)))
            grid = env.create_distribution(2, 4)
            gbuf = grid.make_buffer(lambda p: np.full(4, float(p), np.float32), 4)
            save("basic/allgather", grid, env.wait(grid.all_gather(
                gbuf, 4, DataType.FLOAT, GroupType.MODEL)))
            dbuf = grid.make_buffer(lambda p: np.full(4, float(p + 1), np.float32), 4)
            save("basic/dcn_allreduce", grid, env.wait(grid.all_reduce(
                dbuf, 4, DataType.FLOAT, ReductionType.SUM, GroupType.DATA)))
        dist = env.create_distribution(4, 2)
        if "gather" in phases:
            buf = dist.make_buffer(lambda p: W.rank_fill(p, 8), 8)
            for root, row in dist.gather_to_host(buf, 8, DataType.FLOAT, 1,
                                                 GroupType.MODEL).items():
                out[f"gather/{root}"] = np.asarray(row)
        if "loop" in phases:
            op1, op2 = net(dist)
            out_act, in_act = op1.get_output(0), op2.get_input(0)
            ps1 = op1.get_parameter_set(0)
            local_mb = op1.get_local_minibatch_size()
            n_wire = local_mb * out_act.local_fm_count * W.FM_SIZE
            for it in range(2):
                wires = {p: np.asarray(pack_local(
                    ((it + 1.0) * W.rank_fill(p, n_wire)).reshape(
                        local_mb, out_act.local_fm_count, W.FM_SIZE),
                    out_act.pack_blocks, local_mb, out_act.local_fm_count, W.FM_SIZE))
                    for p in range(8)}
                out_act.start_comm(dist.make_buffer(lambda p: wires[p], n_wire))
                save(f"loop{it}/fprop", dist, in_act.wait_comm())
                n_bwd = local_mb * in_act.local_fm_count * in_act.fm_size
                in_act.start_comm(dist.make_buffer(
                    lambda p: (it + 2.0) * W.rank_fill(p, n_bwd), n_bwd))
                save(f"loop{it}/bprop", dist, out_act.wait_comm())
                n_k = ps1.get_local_kernel_count() * ps1.get_kernel_size()
                ps1.start_gradient_comm(dist.make_buffer(
                    lambda p: (it + 3.0) * W.rank_fill(p, n_k), n_k))
                save(f"loop{it}/grad", dist, ps1.wait_gradient_comm())
        if "matrix" in phases:
            for mp in (1, 2, 8):
                for du in (False, True):
                    dmx = env.create_distribution(8 // mp, mp)
                    o1, o2 = net(dmx, du)
                    for mb in range(2):
                        for name, op in (("o2", o2), ("o1", o1)):
                            ps = op.get_parameter_set(0)
                            n = ps.get_local_kernel_count() * ps.get_kernel_size()
                            ps.start_gradient_comm(dmx.make_buffer(
                                lambda p: (1.0 + 0.1 * mb) * W.rank_fill(p, n), n))
                            res = ps.wait_gradient_comm()
                            if res is not None:
                                save(f"matrix/mp{mp}_du{int(du)}_mb{mb}_{name}", dmx, res)
        if "kinds" in phases:
            from mlsl_tpu import types as JT

            n = 16
            for shape in ((2, 4), (4, 2)):
                d = env.create_distribution(*shape)
                for g in sorted(set(shape)):
                    for tag, start in W.kind_requests(d, g, n, JT):
                        b = d.make_buffer(lambda p: W.rank_fill(p, n) - 3500.0, n)
                        save(f"kinds/{shape[0]}x{shape[1]}/{tag}", d, env.wait(start(b)))
            colors = env.create_distribution_with_colors([p % 2 for p in range(8)],
                                                         [p // 2 for p in range(8)])
            for tag, start in W.kind_requests(colors, 4, n, JT):
                b = colors.make_buffer(lambda p: W.rank_fill(p, n) - 3500.0, n)
                save(f"kinds/colors/{tag}", colors, env.wait(start(b)))
        if "train" in phases:
            rng = np.random.default_rng(0)
            x = rng.normal(size=(W.TRAIN_B, 8)).astype(np.float32)
            y = rng.integers(0, 4, size=(W.TRAIN_B,)).astype(np.int32)
            d8 = env.create_distribution(8, 1)
            sess = env.create_session()
            sess.set_global_minibatch_size(W.TRAIN_B)
            tr = JTrainer(env, d8, sess, jmlp.init(jax.random.PRNGKey(0)), jmlp.loss_fn,
                          jmlp.LAYERS, jmlp.get_layer, lr=0.1)
            tr.step(tr.shard_batch(x, y))
            for k, leaf in tr.params.items():
                for n, v in leaf.items():
                    out[f"train/params/{k}/{n}"] = np.asarray(v)
    finally:
        env.finalize()
    return out


def _hold(rows, ref, nproc):
    for k, want in ref.items():
        got = rows.get(k)
        assert got is not None, f"no process wrote {k}"
        if k.startswith(REPLICATED):
            assert len(got) == nproc, k
            for g in got[1:]:   # every process holds the same bits
                np.testing.assert_array_equal(g, got[0], err_msg=k)
            np.testing.assert_allclose(got[0], want, rtol=RTOL, atol=RTOL, err_msg=k)
        elif ("bprop" in k or k.startswith(("gather/", "kinds/")) or "allgather" in k):
            # moves, and sums of integer-valued floats: exact in any order
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                                       err_msg=k)
    extra = {k for k in rows if "/" in k and not k.startswith("train/loss")} - set(ref)
    assert not extra, sorted(extra)[:5]


def _csums(outs):
    return [o.split("csum=")[1].split()[0] for o in outs]


@pytest.mark.parametrize("nproc,phases", [(2, "basic,train"), (2, E2E), (4, E2E)],
                         ids=["2x4-basic", "2x4-e2e", "4x2-e2e"])
def test_multiprocess_world_matches_jax(tmp_path, nproc, phases):
    outs, rows = run_world(tmp_path, nproc, phases)
    for i, out in enumerate(outs):
        for line in ([f"proc {i} basic OK"] if "basic" in phases else
                     [f"proc {i} hierarchy OK", f"proc {i} gather_to_host OK",
                      f"proc {i} phase loop OK", f"proc {i} matrix mp=2 du=True OK"]):
            assert line in out, out[-2000:]
    # the replicated parameters: bit-identical on every process
    assert len(set(_csums(outs))) == 1, _csums(outs)
    _hold(rows, _jax_reference(phases.split(",")), nproc)


@pytest.mark.slow
def test_eight_process_world_matches_jax(tmp_path):
    """One rank a process: every collective crosses processes."""
    outs, rows = run_world(tmp_path, 8, E2E)
    assert len(set(_csums(outs))) == 1, _csums(outs)
    _hold(rows, _jax_reference(E2E.split(",")), 8)
