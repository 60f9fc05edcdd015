"""The serving engine and the color-restricted world across processes.

``python -m mlsl_tpu_torch.tools.mp_worker`` runs its ``serve`` and
``restrict`` phases in worlds of 2 processes x 4 virtual ranks and 4 x 2
over gloo on the CPU, and once as one process of 8 ranks without a
coordinator (the twin). The serving cases (``mp_worker.SERVE_TINY``) take
tests/test_torch_serve.py's tiny float32 config at tp = 8 (the model group
spans processes in both worlds), tp = 4 (inside a process on 2 x 4, spanning
on 4 x 2) and tp = 2 (inside a process in both), float32 and int8 KV, and
at tp = 8 an eviction with its resume, a forced shed with the leader slowed
(the processes' clocks part), two TRANSIENT faults and a FATAL one at
``serve.decode``. Held:

- against the twin, bit for bit: every request's tokens and every step's
  logits on the leader, every rank's KV pool rows of each box, and the
  programs each process ran, in order (prefills with their lengths, decode
  steps with their dtype and rung);
- against the JAX package's engine on its 8-device CPU mesh at the same tp,
  from the same weights (its ``init_params``): the float32 engines' tokens
  equal, as ``test_paged_engine_matches_oracle_and_jax`` holds them; the
  int8 engines within the JAX package's rule against its float32 tokens
  (first token exact, at most one differing), as
  ``test_int8_paged_engine_within_jax_rule``;
- among the processes: one sequence of programs on every process; the
  TRANSIENT retries sent no extra record (the clean run's programs); the
  FATAL fault ends every follower with MLSLError naming the leader, and so
  does a leader that exits without ``close()`` (the transport's exit
  hook); a follower's submit raises; the decode twin on every process's box.

The restricted world: ``configure("color=...")`` with two color lists, each
in an Environment of its own, every collective kind over a (2, 2) grid of
the 4 kept ranks, held bit for bit against the JAX package's restricted
8-device mesh and against the twin; a list that keeps 3 ranks raises in
both worlds, naming the split. Each world runs under a TIMEOUT that kills
every worker and fails the test.
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
TIMEOUT = 180
PHASES = "serve,restrict"
TPS = (8, 4, 2)
CASES = {c[0]: c for c in W.SERVE_TINY}


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


def _tparams_file(tmp):
    """The JAX package's init_params (seed 0) of the config at each tp, as
    ``serve_tp<tp>/layer/leaf`` arrays."""
    import jax

    from mlsl_tpu.models import transformer as jtfm

    out = {}
    for tp in TPS:
        cfg = jtfm.TransformerConfig(**W.serve_config("tiny", tp))
        for layer, leaves in jtfm.init_params(jax.random.PRNGKey(0), cfg).items():
            for leaf, v in leaves.items():
                out[f"serve_tp{tp}/{layer}/{leaf}"] = np.asarray(v)
    path = tmp / "tparams.npz"
    np.savez(path, **out)
    return path


def _start(tmp, nproc, tparams):
    """Start a world's workers (``nproc`` 0: the twin). -> (procs, out dir)."""
    out_dir = tmp / f"out{nproc}"
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    n = max(nproc, 1)
    port = ["--port", str(_free_port())] if nproc else []
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mlsl_tpu_torch.tools.mp_worker", "--pid", str(i),
         "--nproc", str(n), *port, "--device", "cpu", "--out", str(out_dir),
         "--tparams", str(tparams), "--phases", PHASES],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for i in range(n)]
    return procs, out_dir


def _kill(procs):
    for q in procs:
        q.kill()
        q.communicate()


def _join(procs, out_dir, what):
    """Every worker's output, each checked; the world's merged rows (``rep/``
    rows, which every process writes, as lists) and each process's report.
    A worker past TIMEOUT kills all and fails."""
    outs = []
    for i, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            _kill(procs)
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
                    assert k not in rows, f"row {k} written by two processes"
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
from tests.test_torch_multiprocess_serve import jax_reference
np.savez(sys.argv[2], **jax_reference(sys.argv[3]))
"""


def jax_reference(tparams_path: str) -> dict:
    """The JAX package's engine on its 8-device mesh at each tp of TPS, from
    the same weights: the float32 tokens of the serving prompts (and of the
    eviction's prompts at tp = 8); and each restricted world's collectives
    over a (2, 2) grid."""
    import jax  # noqa: F401

    import mlsl_tpu as mlsl
    from mlsl_tpu import serve as jserve
    from mlsl_tpu import types as JT
    from mlsl_tpu.models import transformer as jtfm

    out = {}
    with np.load(tparams_path) as z:
        tree = {k: z[k] for k in z.files}
    env = mlsl.Environment.get_env().init()
    try:
        for tp in TPS:
            params = {}
            for k, v in tree.items():
                c, layer, leaf = k.split("/")
                if c == f"serve_tp{tp}":
                    params.setdefault(layer, {})[leaf] = v
            cfg = jtfm.TransformerConfig(**W.serve_config("tiny", tp))
            runs = [("prompts", W.serve_prompts("tiny", cfg.vocab), W.SERVE_TINY_NEW)]
            if tp == 8:
                runs.append(("evict", W.serve_evict_prompts(), W.SERVE_EVICT_NEW))
            for name, prompts, new in runs:
                eng = jserve.InferenceEngine(env, cfg, tp=tp, params=params)
                reqs = [eng.submit(p, new) for p in prompts]
                eng.run()
                for r in reqs:
                    out[f"tp{tp}/{name}/{r.id}"] = np.asarray(r.result(timeout=30), np.int64)
                eng.close()
        jserve.reset()
    finally:
        env.finalize()
    n = 16
    for colors in W.RESTRICT_COLORS:
        tag = "".join(map(str, colors))
        env = mlsl.Environment.get_env().init()
        try:
            env.configure("color=" + ",".join(map(str, colors)))
            dist = env.create_distribution(2, 2)
            for ktag, start in W.kind_requests(dist, 2, n, JT):
                buf = dist.make_buffer(lambda p: W.rank_fill(p, n) - 3500.0, n)
                res = env.wait(start(buf))
                for p in range(4):
                    out[f"restrict/{tag}/{ktag}/{p}"] = np.asarray(dist.local_part(res, p))
        finally:
            env.finalize()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The twin, the 2 x 4 and 4 x 2 worlds and the JAX package's run, all
    started together. -> {"twin" | 2 | 4: (rows, reports), "jax": rows}."""
    tmp = tmp_path_factory.mktemp("mp_serve")
    tparams = _tparams_file(tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX, ROOT, str(tmp / "jax.npz"),
                                 str(tparams)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    started = {k: _start(tmp, k, tparams) for k in (0, 2, 4)}
    try:
        out = {("twin" if k == 0 else k): _join(*v, what=f"world {k}")
               for k, v in started.items()}
    except BaseException:
        for procs, _ in started.values():
            _kill(procs)
        _kill([jax_proc])
        raise
    try:
        log = jax_proc.communicate(timeout=TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        _kill([jax_proc])
        pytest.fail(f"the JAX run timed out after {TIMEOUT} s")
    assert jax_proc.returncode == 0, log[-3000:]
    out["jax"] = dict(np.load(tmp / "jax.npz"))
    return out


WORLDS = pytest.mark.parametrize("nproc", [2, 4], ids=["2x4", "4x2"])


def _serve(report, tag):
    return report[f"serve/{tag}"]


@WORLDS
def test_rows_match_the_one_process_twin(runs, nproc):
    """Bit for bit: the leader's tokens and every step's logits, every
    rank's pool rows, and every process's programs, in every case."""
    rows, _ = runs[nproc]
    twin, _ = runs["twin"]
    mine = {k for k in rows if "/twin_rows/" not in k}
    assert mine == {k for k in twin if "/twin_rows/" not in k}
    held = set()
    for k in mine:
        want, got = twin[k], rows[k]
        if k.startswith("rep/"):
            assert len(got) == nproc, k
            for g in got:
                np.testing.assert_array_equal(g, want[0], err_msg=k)
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)
        held.add(k.split("/")[2] if k.startswith("rep/") else k.split("/")[1])
    assert set(CASES) <= held
    for tag in CASES:
        for what in ("kpool", "vpool"):
            ranks = {int(k.rsplit("/", 1)[1]) for k in rows if k.startswith(f"serve/{tag}/{what}/")}
            assert ranks == set(range(8)), (tag, what, ranks)


def _tokens(rows, tag):
    return {int(k.rsplit("/", 1)[1]): list(v) for k, v in rows.items()
            if k.startswith(f"serve/{tag}/tokens/")}


@WORLDS
def test_tokens_match_the_jax_engine(runs, nproc):
    """The float32 engines' tokens equal the JAX package's 8-device engine's
    at the same tp (eviction and TRANSIENT retries included); the int8
    engines within the JAX package's rule against its float32 tokens."""
    rows, _ = runs[nproc]
    jx = runs["jax"]
    for tag, (_, tp, quant, mode, _) in CASES.items():
        if mode in ("shed", "fatal"):
            continue
        got = _tokens(rows, tag)
        name = "evict" if mode == "evict" else "prompts"
        want = {int(k.rsplit("/", 1)[1]): list(v) for k, v in jx.items()
                if k.startswith(f"tp{tp}/{name}/")}
        assert set(got) == set(want) and want, tag
        for i, toks in got.items():
            if quant:
                assert toks[0] == want[i][0], (tag, i, toks, want[i])
                assert sum(a == b for a, b in zip(toks, want[i])) >= len(want[i]) - 1, \
                    (tag, i, toks, want[i])
            else:
                assert toks == want[i], (tag, i, toks, want[i])


def _programs(rows, tag):
    return rows[f"rep/serve/{tag}/programs"]


@WORLDS
def test_every_process_runs_the_same_programs(runs, nproc):
    """One sequence of programs on every process under eviction, the forced
    shed with the leader slowed and the TRANSIENT retries: the resumes are
    extra prefills, the shed changes dtype and rung at one step on every
    process, and the retried steps sent one record each (the clean run's
    programs)."""
    rows, reports = runs[nproc]
    pre, dec = W.SERVE_PROGRAMS["prefill"], W.SERVE_PROGRAMS["decode"]
    for tag in CASES:
        progs = _programs(rows, tag)
        assert all(np.array_equal(p, progs[0]) for p in progs), tag
    evict = _programs(rows, "tp8_evict")[0]
    assert (evict[:, 0] == pre).sum() > len(W.serve_evict_prompts())
    shed = _programs(rows, "tp8_shed")[0]
    decodes = shed[shed[:, 0] == dec]
    assert decodes[:, 2].max() == 2, decodes
    assert set(decodes[:, 1]) == {0, 1}, decodes     # float32, then bf16 at the rung
    np.testing.assert_array_equal(_programs(rows, "tp8_transient")[0],
                                  _programs(rows, "tp8_f32")[0])
    lead = _serve(reports[0], "tp8_transient")
    assert lead["counters"]["retries"] == 2 and lead["leader"]
    for r in reports[1:]:
        fol = _serve(r, "tp8_transient")
        assert "retries" not in fol["counters"]
        assert fol["counters"]["decode_steps"] == lead["counters"]["decode_steps"]
        assert fol["counters"]["prefills"] == lead["counters"]["prefills"]
    # the slowed leader's clock: its host steps were the slower ones
    assert min(_serve(reports[0], "tp8_shed")["step_ms"]) >= 0


@WORLDS
def test_fatal_fault_ends_the_followers_and_submit_is_the_leaders(runs, nproc):
    """A FATAL decode fault raises on the leader and ends every follower
    with MLSLError naming the leader (none hangs: the world finished under
    its limit); a follower's submit raises, naming the leader."""
    _, reports = runs[nproc]
    assert "ValueError" in _serve(reports[0], "tp8_fatal")["fatal"]
    for i, r in enumerate(reports[1:], 1):
        msg = _serve(r, "tp8_fatal")["stopped_on_error"]
        assert "leader (process 0)" in msg and f"process {i}" in msg
        for tag in CASES:
            assert "leader, process 0" in _serve(r, tag)["submit_refused"]
            assert not _serve(r, tag)["leader"]


@WORLDS
def test_spanning_model_groups_sum_on_the_transport(runs, nproc):
    """A model group that spans processes sums on the transport, runs no
    graph and no kernel route; a process-local one sends only the records."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    _, reports = runs[nproc]
    for tag, (_, tp, *_rest) in CASES.items():
        spans = ProcessGroup(Topology(1, tp, 8, procs=(nproc, 0)), ("model",)).spans
        for r in reports:
            rec = _serve(r, tag)
            assert rec["spanning"] == spans and not rec["graphed"] and not rec["graphs"]
            assert not rec["launches"], (tag, rec["launches"])
            kinds = {k for p in rec["program_hops"].values() for k in p["hops"]}
            assert ("axis_sum" in kinds) == spans, (tag, kinds)
            if rec["leader"]:
                assert "serve_record" in kinds, (tag, kinds)
                sent = rec["program_hops"]["prefill"]["hops"]["serve_record"]
                assert sent["calls"] >= rec["program_hops"]["prefill"]["programs"]


@WORLDS
def test_decode_twin_on_every_process(runs, nproc):
    """decode_twin over a process-local model group: a TWIN record, the same
    twin on every box, each bit for bit, every replica's row the leader's."""
    rows, reports = runs[nproc]
    lead = rows["serve/tp2_f32_twin/twin_rows/proc0/0"]
    for i, r in enumerate(reports):
        tw = _serve(r, "tp2_f32_twin")["twins"]
        assert len(tw) == 1 and tw[0]["bit_for_bit"] and tw[0]["pools_equal"], (i, tw)
        # a follower keeps every slot's row: the live slots come first
        row = rows[f"serve/tp2_f32_twin/twin_rows/proc{i}/0"][:len(lead)]
        np.testing.assert_array_equal(_bits(row), _bits(lead))


@WORLDS
def test_restricted_world_matches_jax_and_one_process(runs, nproc):
    """The restricted world's collectives: bit for bit the JAX package's on
    its restricted mesh and the twin's; its 4 ranks laid K / P a process;
    an uneven split raises on every process, naming it."""
    rows, reports = runs[nproc]
    twin, _ = runs["twin"]
    jx = runs["jax"]
    keys = [k for k in jx if k.startswith("restrict/")]
    assert len(keys) == 2 * 4 * 26
    for k in keys:
        np.testing.assert_array_equal(rows[k], jx[k], err_msg=k)
        np.testing.assert_array_equal(rows[k], twin[k], err_msg=k)
    for i, r in enumerate(reports):
        rec = r["restrict"]
        assert f"3 ranks of color 0, which do not split over {nproc} processes" in rec["uneven"]
        for colors in W.RESTRICT_COLORS:
            tag = "".join(map(str, colors))
            k = 4 // nproc
            assert rec[tag]["local_ranks"] == list(range(i * k, (i + 1) * k))


EXIT_WORKER = r"""
import sys
import numpy as np
from mlsl_tpu_torch import get_env
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import transformer as tfm
from mlsl_tpu_torch.serve.engine import InferenceEngine
from mlsl_tpu_torch.tools import mp_worker as W
pid, port = int(sys.argv[1]), sys.argv[2]
env = get_env().init(device="cpu", world_size=8, coordinator_address="127.0.0.1:" + port,
                     num_processes=2, process_id=pid)
eng = InferenceEngine(env, tfm.TransformerConfig(**W.serve_config("tiny", 8)), tp=8)
if eng.is_leader:
    req = eng.submit(np.arange(1, 9), 3)
    eng.run()
    print("LEADER EXITS", req.result(timeout=5), flush=True)
else:
    try:
        eng.run()
    except MLSLError as e:
        print("FOLLOWER STOPPED:", e, flush=True)
"""


def test_a_leader_exiting_without_close_stops_its_followers(tmp_path):
    """Trap 2 at the interpreter's exit: the leader serves and exits without
    close(); the transport's shutdown hook sends STOP with the error flag,
    so the follower's run() raises MLSLError instead of waiting."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", EXIT_WORKER, str(i), port], env=env,
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            _kill(procs)
            pytest.fail("a follower waited for a leader that had exited")
    assert all(p.returncode == 0 for p in procs), outs
    assert "LEADER EXITS" in outs[0] and "without close()" in outs[0], outs[0][-2000:]
    assert "FOLLOWER STOPPED: the serving engine's leader (process 0)" in outs[1], outs[1][-2000:]
