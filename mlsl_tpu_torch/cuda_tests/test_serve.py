"""The serving engine on the card (mlsl_tpu_torch.serve), no JAX: the decode
step's CUDA graph against its eager twin bit for bit (float32 and int8 KV
pools), the int8 KV codec on B1 and B2 against its plain version bit for
bit, the engine's tokens against the unpaged oracle under the card's rule
(``serve.checks.oracle_rule``: every step's logits within DELTA_BOUND of the
oracle's on the engine's own stream), and planted faults that the rule must
fail.

Config: vocab 256, d_model 128, 2 heads of 64, 4 blocks, seq_len 256, bf16
compute, pages of 16 tokens, 4 slots.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.models import transformer as tfm
from mlsl_tpu_torch.serve import checks

CFG = tfm.TransformerConfig(vocab=256, d_model=128, n_heads=2, head_dim=64, n_blocks=4,
                            seq_len=256, dtype="bfloat16")
#: |logit - oracle logit| at every step, the oracle run on the engine's own
#: stream (bf16 compute at this config; largest seen on an H100: 0.0036,
#: PERF.md)
DELTA_BOUND = 0.02
NEW = 12


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab, size=int(rng.integers(8, 120))).astype(np.int32)
            for _ in range(n)]


@pytest.fixture()
def engine(monkeypatch):
    from mlsl_tpu_torch import get_env
    from mlsl_tpu_torch.serve.engine import InferenceEngine

    made = []

    def make(tp=1, quant=False, algo="", rhd=False, cfg=CFG):
        get_env().finalize()
        monkeypatch.setenv("MLSL_ALGO", algo)
        monkeypatch.setenv("MLSL_PALLAS_RHD", "1" if rhd else "0")
        monkeypatch.setenv("MLSL_SERVE_KV_QUANT", "1" if quant else "0")
        monkeypatch.setenv("MLSL_SERVE_MAX_BATCH", "4")
        monkeypatch.setenv("MLSL_SERVE_KV_CACHE_MB", "64")
        env = get_env().init(world_size=tp)
        eng = InferenceEngine(env, cfg, tp=tp, seed=0)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()
    get_env().finalize()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["float32_kv", "int8_kv"])
@pytest.mark.parametrize("tp,rhd", [(1, False), (2, True)], ids=["tp1", "tp2_b5"])
def test_cuda_decode_graph_matches_eager(engine, quant, tp, rhd):
    from mlsl_tpu_torch.core.graph_capture import launch_counts

    eng = engine(tp=tp, quant=quant, rhd=rhd)
    for p in _prompts(3):
        eng.submit(p, NEW)
    before = launch_counts()
    eng.run(max_steps=3)               # prefills, the capture, two replays
    assert len(eng._decode_cache) == 1
    rec = eng._decode_cache[CFG.dtype].launches
    n = CFG.n_blocks
    want = {}
    if quant:
        want.update(quantize_blocks=2 * n, dequantize_blocks=2 * n)
    if rhd:
        want["rhd_allreduce"] = 2 * n
    assert {k: v for k, v in rec.items() if v} == want, rec
    ran = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
    prefill_b1 = 2 * 3 if quant else 0          # the write quantizes K and V once each
    assert ran.get("quantize_blocks", 0) == 2 * want.get("quantize_blocks", 0) + prefill_b1
    assert ran.get("rhd_allreduce", 0) == 2 * want.get("rhd_allreduce", 0)
    g, e, same_pools, n_live = checks.decode_twin(eng)
    torch.cuda.synchronize()
    assert n_live > 0
    assert np.array_equal(g, e), float(np.abs(g - e).max())
    assert same_pools
    eng.run()


@pytest.mark.cuda
def test_cuda_kv_codec_on_b1_b2_bit_exact(engine):
    from mlsl_tpu_torch.ops import quant_kernels as qk

    eng = engine(quant=True)
    toks = torch.zeros((CFG.seq_len,), dtype=torch.long, device=eng.device)
    toks[:100] = torch.arange(1, 101)
    _, k, v = eng._prefill(toks, 100)
    for x in (k, v):
        before = dict(qk.LAUNCHES)
        q, s = tfm.kv_block_quant(x)
        deq = tfm.kv_block_dequant(q, s)
        torch.cuda.synchronize()
        assert qk.LAUNCHES["quantize_blocks"] == before["quantize_blocks"] + 1
        assert qk.LAUNCHES["dequantize_blocks"] == before["dequantize_blocks"] + 1
        rq, rs = qk.quantize_blocks_ref(x.reshape(-1, CFG.head_dim))
        assert torch.equal(q.reshape(-1, CFG.head_dim), rq)
        assert torch.equal(s.reshape(-1), rs)
        assert torch.equal(deq.reshape(-1, CFG.head_dim), qk.dequantize_blocks_ref(rq, rs))


def _served(eng, prompts):
    """Serve ``prompts`` to the end with a probe -> (requests, probe)."""
    probe = checks.Probe(eng)
    reqs = [eng.submit(p, NEW) for p in prompts]
    eng.run()
    assert all(r.state == "done" and len(r.tokens) == NEW for r in reqs)
    return reqs, probe


@pytest.mark.cuda
@pytest.mark.parametrize("tp,rhd", [(1, False), (2, True)], ids=["tp1", "tp2_b5"])
def test_cuda_engine_tokens_against_oracle(engine, tp, rhd):
    eng = engine(tp=tp, rhd=rhd)
    reqs, probe = _served(eng, _prompts(6, seed=1))
    for r in reqs:
        rec = checks.oracle_rule(eng, r, probe.logits[r.id], DELTA_BOUND)
        print(rec)
        assert rec["ok"], rec
    eng.cache.check()
    assert len(eng.cache) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["position+1", "drop_kv:0", f"drop_kv:{CFG.n_blocks - 1}"])
def test_cuda_oracle_rule_fails_a_planted_fault(engine, fault):
    """A wrong engine fails the rule: positions off by one (the write, the
    mask and the position embedding), or one block's K/V write lost."""
    eng = engine()
    with checks.planted(eng, fault):
        reqs, probe = _served(eng, _prompts(6, seed=1))
    recs = [checks.oracle_rule(eng, r, probe.logits[r.id], DELTA_BOUND) for r in reqs]
    print(fault, [round(rec["max_abs_delta"], 4) for rec in recs])
    assert not all(rec["ok"] for rec in recs), recs


@pytest.mark.cuda
def test_cuda_precision_shed_captures_a_second_graph(engine):
    eng = engine(cfg=dataclasses.replace(CFG, dtype="float32"))
    reqs = [eng.submit(p, NEW) for p in _prompts(4, seed=2)]
    eng.run(max_steps=3)
    eng.governor.force_shed("test")
    eng.governor.force_shed("test")
    assert eng.governor.precision_shed
    eng.run()
    assert sorted(eng._decode_cache) == ["bfloat16", "float32"]
    assert all(r.state == "done" for r in reqs)
