"""The transformer's fused step as one CUDA graph on tp-only grids
(models/transformer.py): a grid with no data or sequence split takes the
fused path, so its step -- the TP sums over the model group, the MoE layer's
exchanges over it, the sharded-vocabulary CE -- is captured and replayed.
Each case trains three steps through ``step`` (the graph; the second step on
another batch, so a replay must read the batch it is given) and three through
``_eager_step`` on a twin from the same seed: the losses and every parameter
bit for bit.

Cases, at bf16 with head_dim 64 (B7 and B8 in their wgmma form):
- tp 2, dense FFN;
- tp 2, 4 experts (ep = tp = 2), the exchanges on the plain route;
- tp 2, 4 experts, ``MLSL_ALGO=alltoall=pallas_a2a``: the combine exchange
  through kernel B6 inside the graph;
- tp 2, the LM head sharded over the model axis.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.models import transformer as tfm

CFG = tfm.TransformerConfig(vocab=1024, d_model=256, n_heads=4, head_dim=64, n_blocks=2,
                            seq_len=256, dtype="bfloat16")
BATCH = 4
CASES = {"tp2": ({}, ""), "tp2_moe": ({"n_experts": 4}, ""),
         "tp2_moe_b6": ({"n_experts": 4}, "alltoall=pallas_a2a"),
         "tp2_sharded_vocab": ({"sharded_vocab": True}, "")}


def _batches(trainer, cfg):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, size=(BATCH, cfg.seq_len)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab, size=(BATCH, cfg.seq_len)).astype(np.int32)
        out.append(trainer.shard_tokens(toks, labels))
    return out


def _run(env, cfg, graph: bool):
    trainer = tfm.HybridTrainer(env, cfg, 1, 1, 2, batch=BATCH, lr=0.1, seed=3)
    assert trainer.fused
    batches = _batches(trainer, cfg)
    losses = []
    for i in range(3):
        b = batches[i % 2]
        losses.append(float(trainer.step(*b) if graph else trainer._eager_step(*b)))
    torch.cuda.synchronize()
    return trainer, losses, [p.detach().clone() for p in trainer._all_leaves()]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_fused_step_graph_on_tp_grid_matches_eager(case, monkeypatch):
    from mlsl_tpu_torch import get_env
    from mlsl_tpu_torch.core.graph_capture import launch_counts

    extra, algo = CASES[case]
    cfg = dataclasses.replace(CFG, **extra)
    get_env().finalize()
    monkeypatch.setenv("MLSL_ALGO", algo)
    env = get_env().init(world_size=2)
    try:
        before = launch_counts()
        graphed, g_losses, g_params = _run(env, cfg, graph=True)
        assert len(graphed._graphs) == 1
        (_, compiled), = graphed._graphs.values()
        rec = compiled.launches
        assert rec.get("flash_fwd_sm90") == cfg.n_blocks and rec.get("flash_bwd_dkv_sm90") \
            == cfg.n_blocks, rec
        if algo:
            assert rec.get("a2a_dense", 0) + rec.get("a2a_quant", 0) > 0, rec
        ran = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
        # the warm-up and the recording; the replays count nothing
        assert all(v == 2 * rec.get(k, 0) for k, v in ran.items()), (ran, rec)
        _, e_losses, e_params = _run(env, cfg, graph=False)
        assert g_losses == e_losses, (g_losses, e_losses)
        assert all(map(torch.equal, g_params, e_params))
    finally:
        get_env().finalize()
