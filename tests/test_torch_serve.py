"""The port's decode mode and serving engine (mlsl_tpu_torch.serve,
``models.transformer.prefill_local`` / ``decode_local``) against the JAX
package's, after tests/test_serve.py.

The same weights (JAX's ``init_params`` as numpy, placed with
``transformer_params_from_jax``) and the same numpy-seeded prompts go through
both. The config is the JAX tests': vocab 64, d_model 32, 4 heads of 8 (8 at
tp = 2), 2 blocks, seq_len 64, float32.

Tolerances, stated:

- ``prefill_local`` / ``decode_local`` against the JAX engine's programs:
  logits, K/V and pools within 1e-5 relative L2 error (the same float32
  terms summed in other orders: torch's CPU products, the TP sum); the pool
  entries no step writes equal bit for bit. At tp = 2 the port takes its
  ``lax``, ``rhd``, ``pallas_rhd`` (``MLSL_PALLAS_RHD=1``) and
  ``pallas_ring`` routes (the kernels' plain versions on the CPU); JAX takes
  ``lax`` off the TPU.
- ``kv_block_quant`` and the int8 decode step bit for bit JAX's under the XLA
  flags of the other int8 parity tests (``--xla_disable_hlo_passes=algsimp
  --xla_cpu_max_isa=AVX``, a subprocess), logits within 1e-5; and against
  ``quantize_blocks_ref`` / ``dequantize_blocks_ref`` with the amax/254
  round-trip bound.
- The paged engine's tokens equal the port's unpaged oracle and the JAX
  engine's, at tp = 1 and tp = 2. The port's paged and unpaged logits are NOT
  bit-identical on the CPU: torch's CPU products take another summation
  order for one row than for many (a (1, 8) x (8, 64) attention score row
  differs in the last bit from the same row of the (64, 8) x (8, 64)
  product), so the paged step's logits lie within 1e-6 of the oracle's
  (1.1e-7 seen) and the tokens are equal.
- The int8 paged engine: the JAX package's rule (first token exact, at most
  one differing token).
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu import serve as jserve
from mlsl_tpu.core.environment import Environment as JaxEnvironment
from mlsl_tpu.models import transformer as jtfm
from mlsl_tpu.serve.kv_cache import PagedKVCache as JaxPagedKVCache
from mlsl_tpu_torch import serve
from mlsl_tpu_torch.comm import algos as talgos
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import transformer as tfm
from mlsl_tpu_torch.ops import quant_kernels as qk
from mlsl_tpu_torch.serve import checks
from mlsl_tpu_torch.serve.engine import InferenceEngine, oracle_generate
from mlsl_tpu_torch.serve.kv_cache import PagedKVCache

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
XLA_EXACT = "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"
N_PROMPTS = 5
NEW = 6


def _kw(tp=1, **over):
    base = dict(vocab=64, d_model=32, n_heads=4 * tp, head_dim=8, n_blocks=2,
                seq_len=64, dtype="float32")
    base.update(over)
    return base


def _prompts(n=N_PROMPTS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=int(rng.integers(3, 20))).astype(np.int32)
            for _ in range(n)]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(autouse=True)
def _port_serve_state():
    stats.reset_serve_counters()
    serve.reset()
    yield
    stats.reset_serve_counters()
    serve.reset()
    if Environment._instance is not None:
        Environment._instance.finalize()


def _port_env(world=1):
    return Environment.get_env().init(device="cpu", world_size=world)


def _params(tp):
    cfg = jtfm.TransformerConfig(**_kw(tp))
    return jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0), cfg))


# -- the JAX side, once a module ------------------------------------------------


def _decode_inputs(cfg, tp, num_pages, seed):
    """Random pools (global layout), page tables of distinct live pages and
    positions: a decode step's inputs."""
    rng = np.random.default_rng(seed)
    b, page = 4, 16
    mpp = cfg.seq_len // page
    shape = (cfg.n_blocks, num_pages + 1, page, cfg.n_heads, cfg.head_dim)
    kpool = rng.normal(size=shape).astype(np.float32)
    vpool = rng.normal(size=shape).astype(np.float32)
    positions = np.array([5, 17, 40, 0], np.int32)
    pt = np.zeros((b, mpp), np.int32)
    ids = iter(rng.permutation(np.arange(1, num_pages + 1)))
    for i, p in enumerate(positions[:3]):
        for j in range(p // page + 1):
            pt[i, j] = next(ids)
    tokens = rng.integers(1, cfg.vocab, size=b).astype(np.int32)
    tokens[3] = 0                       # the inactive slot: page 0, position 0
    return tokens, positions, pt, kpool, vpool


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's tokens (tp = 1 and 2) and its prefill and decode
    programs' outputs on fixed inputs, as numpy."""
    out = {}
    env = JaxEnvironment.get_env().init()
    try:
        for tp in (1, 2):
            cfg = jtfm.TransformerConfig(**_kw(tp))
            eng = jserve.InferenceEngine(env, cfg, tp=tp, params=_params(tp))
            reqs = [eng.submit(p, NEW) for p in _prompts()]
            eng.run()
            out[tp, "tokens"] = [r.result(timeout=5) for r in reqs]
            toks = np.zeros((cfg.seq_len,), np.int32)
            toks[:11] = np.arange(3, 14)
            logits, k, v = eng._prefill(eng.params, toks, np.int32(11))
            out[tp, "prefill"] = (np.asarray(logits), np.asarray(k), np.asarray(v))
            tokens, positions, pt, kpool, vpool = _decode_inputs(cfg, tp, eng.cache.num_pages, 7)
            res = eng._decode_prog(cfg.dtype)(eng.params, tokens, positions, pt,
                                              jax.numpy.asarray(kpool), jax.numpy.asarray(vpool))
            out[tp, "decode"] = tuple(np.asarray(a) for a in res)
            out[tp, "num_pages"] = eng.cache.num_pages
            eng.close()
    finally:
        env.finalize()
        jserve.reset()
    return out


@pytest.fixture(scope="module")
def jax_int8_exact(tmp_path_factory):
    """JAX's kv_block_quant and its int8 decode step (tp = 1 and 2) under the
    int8 parity tests' XLA flags, in a subprocess."""
    path = tmp_path_factory.mktemp("serve_int8") / "int8.npz"
    code = (
        "import sys, dataclasses, numpy as np, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "sys.path.insert(0, sys.argv[1] + '/tests')\n"
        "import test_torch_serve as t\n"
        "from mlsl_tpu import serve\n"
        "from mlsl_tpu.core.environment import Environment\n"
        "from mlsl_tpu.models import transformer as jtfm\n"
        "out = {}\n"
        "x = t._quant_input()\n"
        "q, s = jtfm.kv_block_quant(x)\n"
        "out['q'], out['s'] = np.asarray(q), np.asarray(s)\n"
        "env = Environment.get_env().init()\n"
        "for tp in (1, 2):\n"
        "    cfg = jtfm.TransformerConfig(**t._kw(tp))\n"
        "    config = dataclasses.replace(env.config, serve_kv_quant=True)\n"
        "    eng = serve.InferenceEngine(env, cfg, tp=tp, params=t._params(tp), config=config)\n"
        "    args = t._int8_decode_inputs(cfg, eng.cache.num_pages)\n"
        "    res = eng._decode_prog(cfg.dtype)(eng.params, *args)\n"
        "    for name, a in zip(('logits', 'kpool', 'vpool', 'kscale', 'vscale'), res):\n"
        "        out[f'{name}{tp}'] = np.asarray(a)\n"
        "    eng.close()\n"
        "np.savez(sys.argv[2], **out)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count=8 {XLA_EXACT}")
    proc = subprocess.run([sys.executable, "-c", code, ROOT, str(path)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _quant_input():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 4, 8)).astype(np.float32)
    x[0, 0] = 0.0                        # the amax == 0 guard row
    x[1, 2] *= 1e-3
    return x


def _int8_decode_inputs(cfg, num_pages):
    """An int8 decode step's inputs: the float32 inputs' tables and
    positions, pools quantized from them with nonzero scales."""
    tokens, positions, pt, kpool, vpool = _decode_inputs(cfg, 1, num_pages, 11)
    rng = np.random.default_rng(12)
    kq = rng.integers(-127, 128, size=kpool.shape).astype(np.int8)
    vq = rng.integers(-127, 128, size=vpool.shape).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, size=kpool.shape[:-1]).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, size=vpool.shape[:-1]).astype(np.float32)
    return tokens, positions, pt, kq, vq, ks, vs


# -- the port side ----------------------------------------------------------------


ROUTES = {
    "lax": {},
    "rhd": {"collective_algo": "allreduce=rhd"},
    "pallas_rhd": {"pallas_rhd": True},
    "pallas_ring": {"collective_algo": "allreduce=pallas_ring"},
}
CASES = [(1, "lax")] + [(2, r) for r in ROUTES]


def _config(env, route, **over):
    c = dataclasses.replace(env.config, **ROUTES[route], **over)
    c.validate()
    return c


def _engine(tp, route="lax", world=None, max_batch=None, **over):
    """A port engine on the JAX weights; ``over`` sets Config fields."""
    env = Environment.get_env()
    if not env._initialized:
        env = _port_env(world or tp)
    cfg = tfm.TransformerConfig(**_kw(tp))
    return InferenceEngine(env, cfg, tp=tp, params=_params(tp), max_batch=max_batch,
                           config=_config(env, route, **over))


def _global(per_rank, dim):
    """(1, 1, 1, M, ...) per-rank head shards -> the global tensor, shards
    joined along ``dim`` of the local shape."""
    ranks = per_rank[0, 0, 0]
    return torch.cat(list(ranks), dim=dim).numpy()


def _took(algo):
    return any(k[0] == algo for k in talgos._INLINE_PLANS)


@pytest.mark.parametrize("tp,route", CASES, ids=[f"tp{t}-{r}" for t, r in CASES])
def test_prefill_local_matches_jax(jax_runs, tp, route):
    talgos._INLINE_PLANS.clear()
    eng = _engine(tp, route)
    toks = np.zeros((eng.ctx_len,), np.int64)
    toks[:11] = np.arange(3, 14)
    logits, k, v = eng._prefill(torch.from_numpy(toks), 11)
    jl, jk, jv = jax_runs[tp, "prefill"]
    for m in range(tp):                  # every model rank holds the same logits
        assert _rel(logits[0, 0, 0, m].numpy(), jl) < REL
    assert _rel(_global(k, 2), jk) < REL and _rel(_global(v, 2), jv) < REL
    assert k.shape == (1, 1, 1, tp, 2, 64, 4, 8)
    if route != "lax":
        assert _took(route)
    else:
        assert not talgos._INLINE_PLANS
    eng.close()


def _port_pools(a, tp):
    """A global (n_blocks, Np, page, H, Dh) numpy pool -> (1, 1, 1, tp, ...)
    head shards."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return torch.stack(list(t.chunk(tp, dim=3)))[None, None, None].contiguous()


@pytest.mark.parametrize("tp,route", CASES, ids=[f"tp{t}-{r}" for t, r in CASES])
def test_decode_local_matches_jax(jax_runs, tp, route):
    talgos._INLINE_PLANS.clear()
    eng = _engine(tp, route)
    assert eng.cache.num_pages == jax_runs[tp, "num_pages"]
    tokens, positions, pt, kpool, vpool = _decode_inputs(eng.cfg, tp, eng.cache.num_pages, 7)
    kp, vp = _port_pools(kpool, tp), _port_pools(vpool, tp)
    logits, kp2, vp2 = tfm.decode_local(
        eng.params, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(pt), kp, vp, eng.cfg, tp, comm=eng.comm)
    assert kp2 is kp and vp2 is vp      # written in place
    jl, jk, jv = jax_runs[tp, "decode"]
    for m in range(tp):
        assert _rel(logits[0, 0, 0, m].numpy(), jl) < REL
    gk, gv = _global(kp, 3), _global(vp, 3)
    assert _rel(gk, jk) < REL and _rel(gv, jv) < REL
    # entries no step wrote keep their bits; the written rows are new
    written = np.zeros(gk.shape[:3], bool)
    written[:, pt[np.arange(4), positions // 16], positions % 16] = True
    np.testing.assert_array_equal(gk[~written], kpool[~written])
    np.testing.assert_array_equal(gv[~written], vpool[~written])
    assert not np.array_equal(gk[written], kpool[written])
    if route != "lax":
        assert _took(route)
    eng.close()


def test_kv_block_quant_matches_refs_and_round_trip_bound():
    """The int8 KV codec is the blockwise contract with block = head_dim:
    quantize equals quantize_blocks_ref row for row, and the dequantize round
    trip is within amax/254 a row (half an int8 step)."""
    x = _quant_input()
    q, s = tfm.kv_block_quant(torch.from_numpy(x))
    q2, s2 = qk.quantize_blocks_ref(torch.from_numpy(x.reshape(-1, 8)))
    assert q.dtype == torch.int8 and q.shape == x.shape and s.shape == x.shape[:-1]
    np.testing.assert_array_equal(q.reshape(-1, 8).numpy(), q2.numpy())
    np.testing.assert_array_equal(s.reshape(-1).numpy(), s2.numpy())
    deq = qk.dequantize_blocks_ref(q2, s2).numpy().reshape(x.shape)
    np.testing.assert_array_equal(tfm.kv_block_dequant(q, s).numpy(), deq)
    amax = np.abs(x).max(axis=-1, keepdims=True)
    assert np.all(np.abs(deq - x) <= amax / 254 + 1e-7)
    assert float(s[0, 0]) == 1.0        # the amax == 0 guard


def test_kv_block_quant_bit_exact_vs_jax(jax_int8_exact):
    q, s = tfm.kv_block_quant(torch.from_numpy(_quant_input()))
    np.testing.assert_array_equal(q.numpy(), jax_int8_exact["q"])
    np.testing.assert_array_equal(s.numpy(), jax_int8_exact["s"])


@pytest.mark.parametrize("tp", [1, 2])
def test_int8_decode_local_matches_jax(jax_int8_exact, tp):
    """The int8 decode step against JAX's (run under the exact-division
    flags): logits within 1e-5; every pool entry the step does not write bit
    for bit; the written rows quantize K and V that the two packages compute
    in other summation orders (within 1e-7 relative), so their int8 values
    lie within one step of JAX's and their scales within 1e-5 relative
    (``kv_block_quant`` itself is held bit for bit above)."""
    eng = _engine(tp, serve_kv_quant=True)
    tokens, positions, pt, kq, vq, ks, vs = _int8_decode_inputs(eng.cfg, eng.cache.num_pages)
    pools = [_port_pools(a, tp) for a in (kq, vq, ks[..., None], vs[..., None])]
    kqp, vqp = pools[0], pools[1]
    ksp, vsp = pools[2][..., 0].contiguous(), pools[3][..., 0].contiguous()
    logits, *_ = tfm.decode_local(
        eng.params, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(pt), kqp, vqp, eng.cfg, tp, comm=eng.comm, kscale=ksp, vscale=vsp)
    for m in range(tp):
        assert _rel(logits[0, 0, 0, m].numpy(), jax_int8_exact[f"logits{tp}"]) < REL
    written = np.zeros(kq.shape[:3], bool)
    written[:, pt[np.arange(4), positions // 16], positions % 16] = True
    for name, pool, before in (("kpool", kqp, kq), ("vpool", vqp, vq)):
        got, want = _global(pool, 3), jax_int8_exact[f"{name}{tp}"]
        np.testing.assert_array_equal(got[~written], want[~written])
        np.testing.assert_array_equal(got[~written], before[~written])
        assert np.abs(got[written].astype(int) - want[written].astype(int)).max() <= 1
    for name, pool, before in (("kscale", ksp, ks), ("vscale", vsp, vs)):
        got, want = _global(pool[..., None], 3)[..., 0], jax_int8_exact[f"{name}{tp}"]
        np.testing.assert_array_equal(got[~written], want[~written])
        assert _rel(got[written], want[written]) < REL
    eng.close()


# -- the engine -----------------------------------------------------------------------


ENGINE_CASES = [(1, "lax"), (2, "lax"), (2, "pallas_rhd")]


@pytest.mark.parametrize("tp,route", ENGINE_CASES, ids=[f"tp{t}-{r}" for t, r in ENGINE_CASES])
def test_paged_engine_matches_oracle_and_jax(jax_runs, tp, route):
    """Continuous-batched paged decode: the port oracle's tokens and the JAX
    engine's; the paged logits within 1e-6 of the unpaged ones (not bit for
    bit on the CPU, see the module docstring)."""
    eng = _engine(tp, route)
    seen = {}
    pick = eng._pick

    def keep(logits, reqs):
        for i, r in enumerate(reqs):
            seen.setdefault(r.id, []).append(np.array(logits[i]))
        return pick(logits, reqs)

    eng._pick = keep
    prompts = _prompts()
    reqs = [eng.submit(p, NEW) for p in prompts]
    eng.run()
    got = [r.result(timeout=5) for r in reqs]
    assert got == jax_runs[tp, "tokens"]
    worst = 0.0
    for req, p, toks in zip(reqs, prompts, got):
        assert toks == oracle_generate(eng, p, NEW)
        seq = list(p)
        for j, tok in enumerate(toks):
            padded = np.zeros((eng.ctx_len,), np.int64)
            padded[:len(seq)] = seq
            want = eng._prefill(torch.from_numpy(padded), len(seq))[0][0, 0, 0, 0].numpy()
            worst = max(worst, float(np.abs(seen[req.id][j] - want).max()))
            seq.append(tok)
    assert worst < 1e-6
    assert all(r.state == "done" for r in reqs)
    eng.cache.check()
    assert len(eng.cache) == 0
    assert stats.SERVE_COUNTERS["completed"] == N_PROMPTS
    assert stats.SERVE_COUNTERS["tokens_out"] == N_PROMPTS * NEW
    if route == "pallas_rhd":
        assert _took("pallas_rhd")
    eng.close()


#: the CPU's bound for the card's rule (serve.checks.oracle_rule): the paged
#: logits within 1e-6 of the unpaged oracle's (see the module docstring)
CPU_DELTA = 1e-6
FAULTS = ["position+1", "drop_kv:0", "drop_kv:1"]


@pytest.mark.parametrize("fault", [None] + FAULTS, ids=["clean"] + FAULTS)
def test_oracle_rule_passes_the_engine_and_fails_planted_faults(fault):
    """The card's rule, at the CPU's bound: the engine passes it, and each
    planted fault (positions off by one; one block's K/V write lost) fails
    it on at least one request. The oracle on the engine's own stream is the
    oracle itself where the streams agree."""
    eng = _engine(1)
    probe = checks.Probe(eng)
    prompts = _prompts()
    with checks.planted(eng, fault) if fault else contextlib.nullcontext():
        reqs = [eng.submit(p, NEW) for p in prompts]
        eng.run()
    recs = [checks.oracle_rule(eng, r, probe.logits[r.id], CPU_DELTA) for r in reqs]
    if fault is None:
        assert all(rec["ok"] and rec["differing_steps"] == 0 for rec in recs), recs
        for r, p in zip(reqs, prompts):
            toks, logits = oracle_generate(eng, p, NEW, return_logits=True)
            assert toks == r.tokens and len(logits) == NEW
            assert toks == [int(np.argmax(row)) for row in logits]
    else:
        assert not all(rec["ok"] for rec in recs), recs
    eng.cache.check()
    assert len(eng.cache) == 0
    eng.close()


def test_probe_gaps_mark_the_joining_prefill():
    """The probe stamps every token; of two requests admitted in one step,
    only the first request's first gap holds the second one's prefill."""
    eng = _engine(1)
    probe = checks.Probe(eng, keep=set())
    reqs = [eng.submit(p, NEW) for p in _prompts(2)]
    eng.run()
    assert probe.logits == {} and len(probe.prefills) == 2
    assert [len(probe.stamps[r.id]) for r in reqs] == [NEW, NEW]
    assert len(probe.step_ms) == NEW - 1
    ms, stalled = probe.gaps([r.id for r in reqs])
    assert len(ms) == 2 * (NEW - 1) and min(ms) >= 0
    assert stalled == [True] + [False] * (2 * NEW - 3)
    eng.close()


def test_decode_twin_on_the_cpu():
    """On the CPU the decode step runs eagerly either way: the twin's two
    runs agree bit for bit and leave the pools equal."""
    eng = _engine(1)
    for p in _prompts(3):
        eng.submit(p, NEW)
    eng.run(max_steps=2)
    g, e, same, n_live = checks.decode_twin(eng)
    assert n_live == 3 and np.array_equal(g, e) and same
    eng.run()
    eng.close()


def test_finalize_drops_the_inline_plans():
    """inline_allreduce's staged forms do not outlive their Environment."""
    eng = _engine(2, "pallas_rhd")
    toks = np.zeros((eng.ctx_len,), np.int64)
    toks[:5] = np.arange(1, 6)
    eng._prefill(torch.from_numpy(toks), 5)
    assert _took("pallas_rhd")
    eng.close()
    Environment._instance.finalize()
    assert not talgos._INLINE_PLANS


def test_engine_on_a_wider_world_serves_replicas():
    """A world of 2 x tp serves as redundant replicas: the same tokens."""
    eng = _engine(1, world=2)
    assert eng.grid == (2, 1, 1, 1)
    p = _prompts(1)[0]
    req = eng.submit(p, 4)
    eng.run()
    assert req.result(timeout=5) == oracle_generate(eng, p, 4)
    eng.close()


def test_int8_paged_engine_within_jax_rule():
    """The int8-paged engine's first token is exact against the float32
    oracle and the greedy stream agrees in all but at most one token."""
    eng = _engine(1, serve_kv_quant=True)
    p = np.arange(1, 13, dtype=np.int32)
    req = eng.submit(p, 8)
    eng.run()
    got = req.result(timeout=5)
    f32 = _engine(1)
    want = oracle_generate(f32, p, 8)
    assert got[0] == want[0]
    assert sum(a == b for a, b in zip(got, want)) >= len(want) - 1, (got, want)
    assert eng.kpool.dtype == torch.int8 and eng.kscale.dtype == torch.float32
    eng.close()


def test_engine_needs_an_initialized_environment():
    """No quiet device choice: an Environment that was not initialized (on
    the card, or with device='cpu') refuses the engine."""
    env = Environment.get_env()
    with pytest.raises(MLSLError):
        InferenceEngine(env, tfm.TransformerConfig(**_kw()), tp=1)


@pytest.mark.parametrize("exc,cls", [(OSError, "transient"), (MLSLError, "persistent")])
def test_decode_fault_retries_or_sheds(exc, cls):
    """A TRANSIENT decode failure retries in place (the tokens unchanged);
    any other sheds the SLA ladder and skips the step; the engine drains."""
    eng = _engine(1, comm_retry_backoff_s=0.0)
    decode, fails = eng._decode, [2]

    def flaky(*a):
        if fails[0]:
            fails[0] -= 1
            raise exc("planted decode fault")
        return decode(*a)

    eng._decode = flaky
    p = np.arange(1, 9, dtype=np.int32)
    req = eng.submit(p, 4)
    eng.run()
    assert req.result(timeout=5) == oracle_generate(eng, p, 4)
    if cls == "transient":
        assert stats.SERVE_COUNTERS["retries"] == 2
        assert serve.status()["state"] == "healthy"
    else:
        assert eng.governor.sheds == 2 and stats.SERVE_COUNTERS["shed_batch"] == 1
    eng.close()


def test_decode_fault_cap_fails_the_batch_closed():
    eng = _engine(1)

    def broken(*a):
        raise MLSLError("planted decode fault")

    eng._decode = broken
    reqs = [eng.submit(p, 4) for p in _prompts(2)]
    eng.run()
    assert all(r.state == "failed" for r in reqs)
    with pytest.raises(MLSLError):
        reqs[0].result(timeout=5)
    assert stats.SERVE_COUNTERS["failed"] == 2
    eng.cache.check()
    assert len(eng.cache) == 0
    eng.close()


# -- the paged KV cache ----------------------------------------------------------------


def test_kv_cache_free_list_invariants_under_churn():
    cfg = tfm.TransformerConfig(**_kw())
    cache = PagedKVCache(cfg, page_elems=16, budget_mb=1, max_len=64)
    rng = np.random.default_rng(2)
    live = {}
    for seq_id in range(200):
        op = rng.integers(0, 3)
        if op == 0 or not live:
            n = int(rng.integers(1, 65))
            if cache.admit(seq_id, n):
                live[seq_id] = n
        elif op == 1:
            sid = int(rng.choice(list(live)))
            n = min(live[sid] + int(rng.integers(1, 20)), cache.ctx_len)
            if cache.extend(sid, n):
                live[sid] = n
        else:
            sid = int(rng.choice(list(live)))
            cache.release(sid, evict=bool(rng.integers(0, 2)))
            del live[sid]
        cache.check()
    for sid in list(live):
        cache.release(sid)
        cache.check()
    assert cache.free_pages == cache.num_pages
    assert cache.budget.bytes == 0


def test_kv_cache_rejects_and_budget_floor():
    cfg = tfm.TransformerConfig(**_kw())
    with pytest.raises(MLSLError):          # below one full-context sequence
        PagedKVCache(cfg, page_elems=16, budget_mb=0.01, max_len=64)
    with pytest.raises(MLSLError):          # the page must divide the context
        PagedKVCache(cfg, page_elems=24, budget_mb=4, max_len=64)
    # page_bytes = 2 blocks * 2 (K+V) * 16 * 4 heads * 8 * 4 B = 8 KiB; 0.04 MB
    # buys 5 pages: one full-context sequence (4) plus one
    cache = PagedKVCache(cfg, page_elems=16, budget_mb=0.04, max_len=64)
    assert cache.num_pages == 5 and cache.page_bytes == 8192
    assert cache.admit(0, 64)
    before = stats.SERVE_COUNTERS["kv_rejects"]
    assert not cache.admit(1, 64)
    assert stats.SERVE_COUNTERS["kv_rejects"] == before + 1
    assert cache.table_padded(0) == [1, 2, 3, 4]
    cache.check()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("budget_mb,page", [(1, 16), (0.5, 8), (3, 32)])
def test_kv_cache_page_bytes_as_jax(quant, budget_mb, page):
    """The page-bytes rule (float32 and int8 with its scale) and the pages a
    budget buys, as the JAX package's cache computes them."""
    kw = _kw(n_blocks=3)
    mine = PagedKVCache(tfm.TransformerConfig(**kw), page_elems=page, budget_mb=budget_mb,
                        quant=quant)
    theirs = JaxPagedKVCache(jtfm.TransformerConfig(**kw), page_elems=page,
                             budget_mb=budget_mb, quant=quant)
    assert (mine.page_bytes, mine.num_pages, mine.max_pages_per_seq) == (
        theirs.page_bytes, theirs.num_pages, theirs.max_pages_per_seq)


def test_engine_eviction_preempts_youngest_and_resumes():
    """Pool exhaustion mid-decode evicts the YOUNGEST sequence (its pages
    freed and counted), queues it again with its generated prefix, and the
    resumed output is still the oracle's."""
    eng = _engine(1, max_batch=2)
    # 5 pages of 8 KiB (one full sequence + 1): two 2-page sequences collide
    # on their third page and the younger yields
    eng.cache = PagedKVCache(eng.cfg, page_elems=16, budget_mb=0.04, max_len=64)
    assert eng.cache.num_pages == 5
    p1, p2 = np.arange(1, 31, dtype=np.int32), np.arange(2, 32, dtype=np.int32)
    r1, r2 = eng.submit(p1, 8), eng.submit(p2, 8)
    eng.run()
    assert stats.SERVE_COUNTERS["kv_evictions"] >= 1
    assert r1.result(timeout=5) == oracle_generate(eng, p1, 8)
    assert r2.result(timeout=5) == oracle_generate(eng, p2, 8)
    eng.cache.check()
    eng.close()


# -- the SLA ladder ---------------------------------------------------------------------


def test_sla_ladder_escalates_and_recovers():
    g = serve.SLAGovernor(max_batch=8, queue_depth=10, breach_ticks=2, recover_ticks=3)
    assert g.batch_limit == 8 and g.admission_open
    g.observe(queue_len=9)               # > 0.75 * 10
    for _ in range(6):
        g.tick()
    assert g.rung == 3
    assert g.batch_limit == 4 and g.precision_shed
    assert not g.admission_open
    assert g.sheds == 3
    g.observe(queue_len=0)
    for _ in range(9):
        g.tick()
    assert g.rung == 0 and g.admission_open and g.recoveries == 3
    assert g.status()["state"] == "healthy"
    assert stats.SERVE_COUNTERS["shed_batch"] >= 1
    assert stats.SERVE_COUNTERS["shed_admission"] >= 1
    assert stats.SERVE_COUNTERS["recoveries"] >= 3


def test_sla_ladder_matches_jax_governor():
    """The same random observations drive the port's governor and the JAX
    package's through the same rungs, tick for tick."""
    rng = np.random.default_rng(5)
    kw = dict(max_batch=8, queue_depth=16, tpot_p99_ms=20.0, breach_ticks=2,
              recover_ticks=4, window=16)
    mine, theirs = serve.SLAGovernor(**kw), jserve.SLAGovernor(**kw)
    for _ in range(300):
        obs = dict(queue_len=int(rng.integers(0, 17)), tpot_ms=float(rng.uniform(5, 30)),
                   straggler=bool(rng.random() < 0.05))
        mine.observe(**obs)
        theirs.observe(**obs)
        assert mine.tick() == theirs.tick()
        assert mine.status() == theirs.status()
    jserve.reset()


def test_submit_rejections_are_429_style():
    eng = _engine(1)
    eng.governor.queue_depth = 2
    eng.submit(np.arange(1, 5), 2)
    eng.submit(np.arange(1, 5), 2)
    with pytest.raises(serve.ServeOverloadError) as ei:   # the queue is full
        eng.submit(np.arange(1, 5), 2)
    assert ei.value.retry_after_s > 0
    for _ in range(3):
        eng.governor.force_shed("test")                   # -> shed_admission
    assert not eng.governor.admission_open
    with pytest.raises(serve.ServeOverloadError):
        eng.submit(np.arange(1, 3), 1)
    assert stats.SERVE_COUNTERS["rejected"] == 2
    # a prompt that cannot fit the context is a caller's bug, not a 429
    with pytest.raises(MLSLError) as ei:
        eng.submit(np.arange(1, 60), 10)
    assert not isinstance(ei.value, serve.ServeOverloadError)
    eng.close()
    assert serve.status() == {"state": "off"}


def test_straggler_candidate_counts_as_pressure():
    g = serve.SLAGovernor(max_batch=4, queue_depth=8, breach_ticks=2, recover_ticks=50)
    g.observe(straggler=True)
    g.tick()
    g.tick()
    assert g.rung == 1 and "straggler" in g.last_reason


# -- knobs, the tuner, the statistics, the backoff -------------------------------------------


@pytest.mark.parametrize("field,bad", [
    ("serve_max_batch", 0),
    ("serve_kv_page_elems", 0),
    ("serve_kv_cache_mb", 0),
    ("serve_queue_depth", -1),
    ("comm_retries", -1),
    ("comm_retry_backoff_s", -0.5),
])
def test_serve_knob_validation(field, bad):
    with pytest.raises(MLSLError):
        Config(**{field: bad}).validate()
    Config().validate()


def test_serve_knobs_from_env_as_jax(monkeypatch):
    from mlsl_tpu.config import Config as JaxConfig

    for name, value in (("MLSL_SERVE_MAX_BATCH", "3"), ("MLSL_SERVE_KV_PAGE_ELEMS", "8"),
                        ("MLSL_SERVE_KV_CACHE_MB", "12"), ("MLSL_SERVE_QUEUE_DEPTH", "5"),
                        ("MLSL_SERVE_KV_QUANT", "1"), ("MLSL_COMM_RETRIES", "4"),
                        ("MLSL_COMM_RETRY_BACKOFF_S", "0.25")):
        monkeypatch.setenv(name, value)
    mine, theirs = Config.from_env(), JaxConfig.from_env()
    for f in ("serve_max_batch", "serve_kv_page_elems", "serve_kv_cache_mb",
              "serve_queue_depth", "serve_kv_quant", "comm_retries", "comm_retry_backoff_s"):
        assert getattr(mine, f) == getattr(theirs, f), f
        assert getattr(Config(), f) == getattr(JaxConfig(), f), f
    assert {"serve_max_batch", "serve_kv_page_elems", "serve_kv_cache_mb",
            "serve_queue_depth"} <= mine._explicit


def test_serve_knobs_in_tuner_ranges():
    from mlsl_tpu.tuner.profile import KNOB_RANGES as JAX_RANGES
    from mlsl_tpu_torch.tuner import TUNABLE_KNOBS
    from mlsl_tpu_torch.tuner.profile import KNOB_RANGES

    for k in ("serve_max_batch", "serve_kv_page_elems", "serve_kv_cache_mb",
              "serve_queue_depth"):
        assert k in KNOB_RANGES and k in TUNABLE_KNOBS
        assert KNOB_RANGES[k] == JAX_RANGES[k]


def test_serve_stats_line(tmp_path, monkeypatch):
    monkeypatch.setenv("MLSL_STATS_DIR", str(tmp_path))
    eng = _engine(1)
    eng.submit(np.arange(1, 6), 2)
    eng.run()
    eng.governor.force_shed("stats-line probe")
    text = eng.env.create_session().get_stats().print_()
    line = next(line for line in text.splitlines() if line.startswith("SERVE"))
    assert "admitted 1" in line and "completed 1" in line and "tokens 2" in line
    assert "sheds 1b/0p/0a" in line
    shed_log = (tmp_path / "mlsl_stats.log").read_text()
    assert "BATCH" in shed_log and "stats-line probe" in shed_log
    eng.close()


def test_jittered_backoff_bounds_as_jax():
    import random

    from mlsl_tpu import supervisor as jsup
    from mlsl_tpu_torch import supervisor

    for attempt in range(5):
        for seed in range(20):
            got = supervisor.jittered_backoff(0.05, attempt, random.Random(seed))
            assert got == jsup.jittered_backoff(0.05, attempt, random.Random(seed))
            assert 0.5 * 0.05 * 2 ** attempt <= got < 1.5 * 0.05 * 2 ** attempt


def test_serve_package_is_import_light():
    code = ("import sys, mlsl_tpu_torch.serve as s; "
            "assert 'mlsl_tpu_torch.serve.engine' not in sys.modules; "
            "assert s.InferenceEngine.__name__ == 'InferenceEngine'; "
            "assert s.PagedKVCache.__name__ == 'PagedKVCache'; "
            "assert callable(s.oracle_generate) and s.Request.__name__ == 'Request'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
