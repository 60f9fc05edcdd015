"""The trainers across processes: HybridTrainer, the pipeline schedules and
the device feed over a world whose virtual ranks are spread over processes.

``python -m mlsl_tpu_torch.tools.mp_worker`` runs its ``hybrid``, ``moe``,
``pipeline`` and ``feed`` phases in worlds of 2 processes x 4 virtual ranks
and 4 x 2 over gloo on the CPU, and once as one process of 8 ranks without a
coordinator (the twin). Between the two worlds every axis spans processes:
the data axis (ZeRO-1 too), the seq axis under ring, zigzag, Ulysses and
remat (a replayed block replays its hops on every process alike), the model
axis with its sums, the sharded vocabulary and the MoE exchanges, and the
pipelines' stage axis. Every process's rows are held:

- against the twin, bit for bit (the bits of float32): each rank's CE and
  gradient rows before the sync, the attention's output and gradients on
  its own, the pipelines' per-rank losses and stage gradients, the feed's
  decoded boxes and first losses (replicated and ZeRO-1); the first step's reduced gradients, the
  parameters after two steps and the feed's second losses within 1e-6
  relative L2 (the data group's sum adds its members in another order);
  the world losses every process returns, bit for bit the twin's;
- among themselves: every rank of one model shard holds the same parameter
  bits, whichever process it sits in;
- against the JAX package's 8-device run of the same cases from the same
  weights (its ``init_params``): the CE and gradient rows, the losses and
  the parameters after two steps within tests/test_torch_transformer.py's
  TOL; the pipelines within tests/test_torch_pipeline.py's RTOL_LOSS and
  TOL_GRAD; the feed's decoded rows bit for bit JAX's FeedCodec's, as
  tests/test_torch_feed.py holds them.

The hop counts are every process's alike (trap 6 of comm/transport.py), and
a fused step over a spanning model group ran eagerly. Each world runs under a
240 s limit that kills every worker and fails the test. The 8 x 1 world
(every rank its own process) is ``slow``.
"""

import json
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest

from mlsl_tpu_torch.tools import mp_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
PHASES = "hybrid,moe,pipeline,feed"
#: tests/test_torch_transformer.py's bound against the JAX trainer
TOL = dict(atol=1e-5, rtol=1e-4)
#: tests/test_torch_pipeline.py's bounds against the JAX schedules
RTOL_LOSS = 1e-5
TOL_GRAD = 3e-4
#: the reduced gradients and what follows them against the twin
RTOL_TWIN = 1e-6
CASES = W.HYBRID_TINY + W.MOE_TINY


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


def _bits(a):
    a = np.atleast_1d(np.asarray(a))
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _exact(key: str) -> bool:
    """Rows held bit for bit to the twin; the rest within RTOL_TWIN."""
    return (any(p in key for p in ("/ce/", "/in/", "/attn/", "/decoded/", "/labels/"))
            or key.startswith("pipeline/") or (key.startswith("feed/") and "/loss0/" in key))


def _cfg(fields):
    return {**W.TFM_TINY, **fields}


def _tparams_file(tmp):
    """Every case's starting weights, the JAX package's init_params (seed 0),
    as ``case/layer/leaf`` arrays."""
    import jax

    from mlsl_tpu.models import transformer as jtfm

    out = {}
    for tag, fields, *_ in CASES:
        tree = jtfm.init_params(jax.random.PRNGKey(0), jtfm.TransformerConfig(**_cfg(fields)))
        for layer, leaves in tree.items():
            for leaf, v in leaves.items():
                out[f"{tag}/{layer}/{leaf}"] = np.asarray(v)
    path = tmp / "tparams.npz"
    np.savez(path, **out)
    return path


def _start(tmp, nproc, tparams, phases=PHASES):
    """Start a world's workers (``nproc`` 0: the twin). -> (procs, out dir)."""
    out_dir = tmp / f"out{nproc}"
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # the tiny tensors gain nothing from intra-op threads: one a process,
    # so that the worlds' processes do not oversubscribe the cores
    env["OMP_NUM_THREADS"] = "1"
    n = max(nproc, 1)
    port = ["--port", str(_free_port())] if nproc else []
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mlsl_tpu_torch.tools.mp_worker", "--pid", str(i),
         "--nproc", str(n), *port, "--device", "cpu", "--out", str(out_dir),
         "--tparams", str(tparams), "--phases", phases],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for i in range(n)]
    return procs, out_dir


def _join(procs, out_dir, what):
    """Every worker's output, each checked; the world's merged rows (those
    every process writes, ``rep/``, as lists) and reports. A worker past
    TIMEOUT kills all and fails."""
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
                if k.startswith("rep/"):
                    rows.setdefault(k, []).append(z[k])
                else:
                    assert k not in rows, f"rank row {k} written by two processes"
                    rows[k] = z[k]
    reports = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("REPORT "))[7:])
               for out in outs]
    return rows, reports


_JAX = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from tests.test_torch_multiprocess_trainers import jax_reference
np.savez(sys.argv[2], **jax_reference(int(sys.argv[3])))
"""
#: the JAX package's run in parallel parts: the HybridTrainer cases in two,
#: the pipelines and the feed's codec in the third
JAX_PARTS = (CASES[:3], CASES[3:], ())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The twin, the 2 x 4 and 4 x 2 worlds and the JAX package's run, all
    started together. -> {"twin" | 2 | 4: (rows, reports), "jax": rows}."""
    tmp = tmp_path_factory.mktemp("mp_trainers")
    tparams = _tparams_file(tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_procs = [subprocess.Popen([sys.executable, "-c", _JAX, ROOT, str(tmp / f"jax{i}.npz"),
                                   str(i)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for i in range(len(JAX_PARTS))]
    started = {k: _start(tmp, k, tparams) for k in (0, 2, 4)}
    out = {("twin" if k == 0 else k): _join(*v, what=f"world {k}") for k, v in started.items()}
    out["jax"] = {}
    for i, proc in enumerate(jax_procs):
        try:
            log = proc.communicate(timeout=TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            for q in jax_procs:
                q.kill()
                q.communicate()
            pytest.fail(f"the JAX run's part {i} timed out after {TIMEOUT} s")
        assert proc.returncode == 0, log[-3000:]
        out["jax"].update(np.load(tmp / f"jax{i}.npz"))
    return out


# -- the JAX package's run ------------------------------------------------------


def _jax_pipelines(env, out):
    """GPipe, 1F1B and interleaved 1F1B of the worker's tiny pipeline on the
    JAX package's 8-device model axis."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from mlsl_tpu.models.train import smap
    from mlsl_tpu.parallel import pipeline as jpp

    S, V, d = W.PIPE_STAGES, W.PIPE_TINY["v_chunks"], W.PIPE_TINY["d"]
    data = W.pipe_data("tiny")
    mesh = env.create_distribution(1, S).topology.mesh
    x, t = jnp.asarray(data["x"]), jnp.asarray(data["t"])
    w = {k: v[:S] for k, v in data["weights"].items()}

    def stage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def head(y, tg):
        return jnp.mean((y - tg) ** 2)

    def mine(p):
        return {"w": p["w"].reshape(d, d), "b": p["b"].reshape(d)}

    spec = {"w": P("model", None, None), "b": P("model", None)}

    def gpipe_total(p):
        def body(p, xm, ym):
            return jpp.pipeline_loss(stage, head, mine(p), xm, ym, "model", S)[None]
        fn = smap(body, mesh, in_specs=(spec, P(), P()), out_specs=P("model"), check=False)
        losses = fn(p, x, t)
        return jnp.sum(losses) / S, losses

    (_, jl), jg = jax.value_and_grad(gpipe_total, has_aux=True)(w)
    out["pipeline/gpipe/loss"] = np.asarray(jl)
    for k, g in jg.items():
        out[f"pipeline/gpipe/grad/{k}"] = np.asarray(g)

    def f1b(p, xm, ym):
        loss, grads = jpp.one_f1b_step(stage, head, mine(p), xm, ym, "model", S)
        return loss[None], jax.tree.map(lambda g: g[None], grads)

    jl, jg = jax.jit(smap(f1b, mesh, in_specs=(spec, P(), P()), out_specs=(P("model"), spec),
                          check=False))(w, x, t)
    out["pipeline/1f1b/loss"] = np.asarray(jl)
    for k, g in jg.items():
        out[f"pipeline/1f1b/grad/{k}"] = np.asarray(g)

    def inter(p, xm, ym):
        my = {"w": p["w"].reshape(V, d, d), "b": p["b"].reshape(V, d)}
        loss, grads = jpp.interleaved_1f1b_step(stage, head, my, xm, ym, "model", S, V)
        return loss[None], jax.tree.map(lambda g: g[:, None], grads)

    cw = {k: v.reshape(V, S, *v.shape[1:]) for k, v in data["weights"].items()}
    cspec = {"w": P(None, "model", None, None), "b": P(None, "model", None)}
    jl, jg = jax.jit(smap(inter, mesh, in_specs=(cspec, P(), P()),
                          out_specs=(P("model"), cspec), check=False))(cw, x, t)
    out["pipeline/interleaved/loss"] = np.asarray(jl)
    for k, g in jg.items():
        out[f"pipeline/interleaved/grad/{k}"] = np.asarray(g)


def jax_reference(part: int) -> dict:
    """Part ``part`` of the JAX package's 8-device run (``JAX_PARTS``): each
    HybridTrainer case's (its init_params, seed 0: the weights the workers
    were given) CE and gradient rows before the sync, two steps' losses and
    the parameters after them; or its pipelines and its FeedCodec's decode
    of the feed's batches."""
    import jax

    import mlsl_tpu as mlsl
    from mlsl_tpu.data import FeedCodec as JCodec
    from mlsl_tpu.models import transformer as jtfm

    env = mlsl.Environment.get_env().init()
    out = {}
    try:
        for tag, fields, (dp, sp, tp), zero1, batch in JAX_PARTS[part]:
            cfg = jtfm.TransformerConfig(**_cfg(fields))
            jt = jtfm.HybridTrainer(env, cfg, dp, sp, tp, batch=batch, lr=W.TFM_LR["tiny"],
                                    distributed_update=zero1, donate_params=False)
            st, sl = jt.shard_tokens(*W.tfm_tokens(cfg.vocab, cfg.seq_len, batch))
            loss, flat = jt._grad_fn(jt.params, st, sl)
            out[f"{tag}/ce"] = np.asarray(loss)
            for name, v in flat.items():
                out[f"{tag}/in/{name}"] = np.asarray(v)
            out[f"{tag}/losses"] = np.asarray([float(jt.step(st, sl))
                                               for _ in range(W.TFM_STEPS)])
            for name, leaves in jax.device_get(jt.params).items():
                for leaf, v in leaves.items():
                    out[f"{tag}/params/{name}/{leaf}"] = np.asarray(v)
        if JAX_PARTS[part]:
            return out
        _jax_pipelines(env, out)
        topo = env.create_distribution(W.WORLD, 1).topology
        codec = JCodec(topo, "int8", quant_block=env.config.quant_block_elems)
        for b, batch in enumerate(W.feed_batches()):
            jx, _ = codec.decode(codec.stage(batch)[0])
            a = np.asarray(jx)
            out[f"feed/decoded/{b}"] = np.ascontiguousarray(a[:, :, 0, 0]).reshape(
                W.WORLD, -1)
    finally:
        env.finalize()
    return out


# -- the holds --------------------------------------------------------------------


WORLDS = pytest.mark.parametrize("nproc", [2, 4], ids=["2x4", "4x2"])


def _rank_rows(rows, prefix):
    """{rank: row} of a kept tensor."""
    return {int(k.rsplit("/", 1)[1]): v for k, v in rows.items()
            if k.rsplit("/", 1)[0] == prefix}


@WORLDS
def test_rows_match_the_one_process_twin(runs, nproc):
    """Bit for bit where the work is the twin's arithmetic on the twin's
    inputs; within RTOL_TWIN (relative L2 a row) where a sum over a spanning
    data group added its members in another order."""
    rows, _ = runs[nproc]
    twin, _ = runs["twin"]
    assert set(rows) == set(twin)
    n_exact = 0
    for k, want in twin.items():
        got = rows[k]
        if k.startswith("rep/"):
            assert len(got) == nproc, k
            for g in got:   # every process returns the twin's world losses
                np.testing.assert_array_equal(_bits(g), _bits(want[0]), err_msg=k)
        elif _exact(k):
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)
            n_exact += 1
        else:
            want64 = np.asarray(want, np.float64)
            rel = np.linalg.norm(np.asarray(got, np.float64) - want64) / max(
                np.linalg.norm(want64), 1e-30)
            assert rel <= RTOL_TWIN, (k, rel)
    held = {k.split("/")[1] for k in twin if k.startswith("hybrid/") and "/in/" in k}
    assert held == {c[0] for c in CASES} and n_exact > 0


def _axis_spans(nproc, grid):
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    dp, sp, tp = grid
    topo = Topology(dp, tp, W.WORLD, seq_parts=sp, procs=(nproc, 0))
    return {a: ProcessGroup(topo, (a,)).spans for a in ("data", "seq", "model")}


def test_every_axis_spans_processes_in_some_world(runs):
    """The cases' coverage: each axis spans in some case of some world, the
    seq axis under every schedule and remat, the model axis with the
    sharded vocabulary and the experts; each report agrees."""
    seen = set()
    for nproc in (2, 4):
        _, reports = runs[nproc]
        for tag, fields, grid, zero1, _ in CASES:
            spans = _axis_spans(nproc, grid)
            assert all(r[f"hybrid/{tag}"]["spans"] == spans for r in reports), tag
            for axis, on in spans.items():
                if on:
                    seen.add((axis, fields.get("attention", "ring") if axis == "seq" else
                              tag.split("_")[0]))
                    if axis == "data" and zero1:
                        seen.add(("data", "zero1"))
                    if axis == "seq" and fields.get("remat"):
                        seen.add(("seq", "remat"))
    assert {("seq", "ring"), ("seq", "zigzag"), ("seq", "ulysses"), ("seq", "remat"),
            ("data", "zero1"), ("model", "vocab"), ("model", "moe"),
            ("model", "ring")} <= seen, seen


@WORLDS
def test_every_process_issues_the_same_hops(runs, nproc):
    """Trap 6 of comm/transport.py: one graph of hops on every process, the
    same count of each kind in every case (remat's replay included); a
    spanning seq group's K/V cross as shifts, a spanning model group's sums
    and exchanges as their own kinds."""
    _, reports = runs[nproc]
    for tag, _, grid, _, _ in CASES:
        calls = [{k: h["calls"] for k, h in r[f"hybrid/{tag}"]["hops"].items()}
                 for r in reports]
        assert all(c == calls[0] for c in calls), (tag, calls)
        spans = _axis_spans(nproc, grid)
        assert ("shift" in calls[0]) == (spans["seq"] and grid[1] > 1
                                         and "ulysses" not in tag), (tag, calls[0])
        assert ("axis_sum" in calls[0]) == spans["model"], (tag, calls[0])
        if tag.startswith("moe") and spans["model"]:
            assert calls[0]["axis_all_to_all"] > 0 and calls[0]["axis_all_gather"] > 0
    for sched in ("gpipe", "1f1b", "interleaved"):
        calls = [r[f"pipeline/{sched}"]["hops"]["shift"]["calls"] for r in reports]
        assert len(set(calls)) == 1 and calls[0] > 0, (sched, calls)


@WORLDS
def test_replicated_parameters_agree_across_processes(runs, nproc):
    """Every rank of one model shard (the data and seq replicas) holds the
    same parameter bits after two steps, whichever process holds it."""
    rows, _ = runs[nproc]
    for tag, _, (dp, sp, tp), _, _ in CASES:
        for name in {k.split("/")[3] for k in rows if k.startswith(f"hybrid/{tag}/params/")}:
            by_rank = _rank_rows(rows, f"hybrid/{tag}/params/{name}")
            assert len(by_rank) == W.WORLD
            for p, row in by_rank.items():
                np.testing.assert_array_equal(_bits(row), _bits(by_rank[p % tp]),
                                              err_msg=f"{tag} {name} rank {p}")


def _global(by_rank, grid):
    """{rank: row} -> the (R, D, S, M, n) array of the case's grid."""
    dp, sp, tp = grid
    return np.stack([by_rank[p] for p in range(W.WORLD)]).reshape(1, dp, sp, tp, -1)


@WORLDS
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_hybrid_trainer_matches_jax(runs, nproc, case):
    """The rows, losses and parameters of the multi-process run against the
    JAX package's 8-device HybridTrainer within TOL."""
    import torch

    from mlsl_tpu_torch.models import transformer as ttfm
    from mlsl_tpu_torch.models.convert import transformer_params_from_jax, tree_leaves

    rows, _ = runs[nproc]
    ref = runs["jax"]
    tag, fields, grid, _, _ = next(c for c in CASES if c[0] == case)
    dp, sp, tp = grid
    ce = _global(_rank_rows(rows, f"hybrid/{tag}/ce"), grid)[..., 0]
    np.testing.assert_allclose(ce, ref[f"{tag}/ce"].reshape(ce.shape), **TOL)
    cfg = ttfm.TransformerConfig(**_cfg(fields))
    for name in ttfm.layer_names(cfg):
        got = _global(_rank_rows(rows, f"hybrid/{tag}/in/{name}"), grid)
        want = ref[f"{tag}/in/{name}"]
        np.testing.assert_allclose(got, want.reshape(got.shape), **TOL, err_msg=name)
    losses = rows[f"rep/hybrid/{tag}/losses"][0]
    np.testing.assert_allclose(losses, ref[f"{tag}/losses"], **TOL)
    jtree = {}
    for k, v in ref.items():
        if k.startswith(f"{tag}/params/"):
            _, _, layer, leaf = k.split("/")
            jtree.setdefault(layer, {})[leaf] = v
    per_rank = transformer_params_from_jax(jtree, cfg, (1, dp, sp, tp),
                                           device=torch.device("cpu"))
    for name in ttfm.layer_names(cfg):
        want = torch.cat([p.reshape(1, dp, sp, tp, -1) for p in tree_leaves(per_rank[name])],
                         -1).numpy()
        got = _global(_rank_rows(rows, f"hybrid/{tag}/params/{name}"), grid)
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


@WORLDS
@pytest.mark.parametrize("sched", ["gpipe", "1f1b", "interleaved"])
def test_pipelines_match_jax_and_the_oracle(runs, nproc, sched):
    """Each rank's loss (every stage holds the sum) and stage gradients
    against the JAX package's schedule on 8 devices and the dense oracle."""
    import torch

    rows, _ = runs[nproc]
    ref = runs["jax"]
    S, V = W.PIPE_STAGES, W.PIPE_TINY["v_chunks"]
    loss = np.concatenate([v for _, v in sorted(
        _rank_rows(rows, f"pipeline/{sched}/loss").items())])
    np.testing.assert_allclose(loss, ref[f"pipeline/{sched}/loss"], rtol=RTOL_LOSS)
    data = W.pipe_data("tiny")
    k_stages = S * (V if sched == "interleaved" else 1)
    weights = {k: torch.from_numpy(v[:k_stages]) for k, v in data["weights"].items()}
    dl, dg = W.pipe_dense(torch, weights, torch.from_numpy(data["x"]),
                          torch.from_numpy(data["t"]), k_stages)
    np.testing.assert_allclose(loss, dl, rtol=RTOL_LOSS)
    for k in ("w", "b"):
        got = np.stack([v for _, v in sorted(
            _rank_rows(rows, f"pipeline/{sched}/grad/{k}").items())])   # (S, [V,] ...)
        want = ref[f"pipeline/{sched}/grad/{k}"]
        if sched == "interleaved":
            want = np.moveaxis(want, 0, 1)                               # (S, V, ...)
            oracle = np.moveaxis(dg[k].numpy().reshape(V, S, -1), 0, 1)
        else:
            oracle = dg[k].numpy()
        np.testing.assert_allclose(got, want.reshape(got.shape), atol=TOL_GRAD, rtol=TOL_GRAD)
        np.testing.assert_allclose(got, oracle.reshape(got.shape), atol=TOL_GRAD,
                                   rtol=TOL_GRAD)


@WORLDS
def test_feed_decodes_jax_rows_and_counts_its_own_shards(runs, nproc):
    """Each process decodes only its box, bit for bit the JAX FeedCodec's
    rows of those ranks, replicated and ZeRO-1; its FEED counters count its
    own shards' bytes, the world's sum the twin's."""
    rows, reports = runs[nproc]
    _, twin_reports = runs["twin"]
    ref = runs["jax"]
    for du in ("du0", "du1"):
        for b in range(W.FEED_BATCHES):
            by_rank = _rank_rows(rows, f"feed/{du}/decoded/{b}")
            assert sorted(by_rank) == list(range(W.WORLD))
            for p, row in by_rank.items():
                np.testing.assert_array_equal(_bits(row), _bits(ref[f"feed/decoded/{b}"][p]))
        staged = [r["feed"][du]["counters"]["wire_bytes"] for r in reports]
        assert len(set(staged)) == 1 and sum(staged) == twin_reports[0]["feed"][du][
            "counters"]["wire_bytes"], staged


@WORLDS
def test_fused_step_over_a_spanning_model_group_runs_eagerly(runs, nproc):
    """dp = sp = 1 at tp = 8: the fused path, whose model sums cross
    processes, steps eagerly (no CUDA graph could hold a gloo hop)."""
    _, reports = runs[nproc]
    for tag in ("vocab_118", "moe_118"):
        assert all(r[f"hybrid/{tag}"]["fused"] for r in reports)
        assert all(r[f"hybrid/{tag}"]["spans"]["model"] for r in reports)


@pytest.mark.slow
def test_eight_process_trainers_match_the_twin(tmp_path):
    """One rank a process: every hop of every case crosses processes."""
    tparams = _tparams_file(tmp_path)
    twin = _join(*_start(tmp_path, 0, tparams), what="twin")[0]
    rows = _join(*_start(tmp_path, 8, tparams), what="world 8")[0]
    for k, want in twin.items():
        got = rows[k][0] if k.startswith("rep/") else rows[k]
        want = want[0] if k.startswith("rep/") else want
        if k.startswith("rep/") or _exact(k):
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)
        else:
            rel = np.linalg.norm(np.asarray(got, np.float64) - want) / max(
                np.linalg.norm(np.asarray(want, np.float64)), 1e-30)
            assert rel <= RTOL_TWIN, (k, rel)
