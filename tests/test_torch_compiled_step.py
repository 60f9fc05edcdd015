"""``HybridTrainer.compiled_step`` of the port, the profiling surface of the
fused step (the JAX package's ``compiled_step``, transformer.py:679-690).

- Off the fused path (a grid whose gradients communicate, or ZeRO-1) it
  returns None, as JAX's does.
- On the fused path it counts one step's FLOPs (``torch.utils.flop_counter``
  on the CPU, where the kernels' plain versions run), leaves the parameters
  and the optimizer state as they were, and reports no graph (the CPU has
  none).
- ``remat`` replays each block's forward in the backward: the step's FLOPs
  grow by about one forward, the same window of 1.15 to 1.45 that
  ``tests/test_transformer.py::test_remat_replays_forward`` holds the JAX
  program's cost-model FLOPs to, at its config (8 blocks, d_model 128, 4
  heads of 32, seq 512, batch 4).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mlsl_tpu_torch import optim
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.models import transformer as ttfm

torch.set_num_threads(2)

CFG = ttfm.TransformerConfig(vocab=32, d_model=16, n_heads=4, head_dim=4, n_blocks=2,
                             seq_len=16, dtype="float32")


def _data(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, cfg.seq_len)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(b, cfg.seq_len)).astype(np.int32)
    return toks, labels


@pytest.fixture
def tenv8():
    env = Environment.get_env().init(device="cpu", world_size=8)
    yield env
    env.finalize()


@pytest.mark.parametrize("grid,kw", [((2, 2, 2), {}), ((8, 1, 1), {}),
                                     ((2, 1, 4), {"distributed_update": True})],
                         ids=["dp2-sp2-tp2", "dp8", "zero1"])
def test_compiled_step_is_none_off_the_fused_path(tenv8, grid, kw):
    dp, sp, tp = grid
    tt = ttfm.HybridTrainer(tenv8, CFG, dp, sp, tp, batch=2 * dp, **kw)
    assert not tt.fused
    st, sl = tt.shard_tokens(*_data(CFG, 2 * dp))
    assert tt.compiled_step(st, sl) is None


@pytest.mark.parametrize("grid", [(1, 1, 1), (1, 1, 4)], ids=["1rank", "tp4"])
def test_compiled_step_counts_without_training(grid):
    """The count leaves every parameter and the Adam state bit for bit as it
    was; the next step equals a step of a trainer that never counted."""
    world = grid[0] * grid[1] * grid[2]
    tenv = Environment.get_env().init(device="cpu", world_size=world)
    try:
        def build():
            return ttfm.HybridTrainer(tenv, CFG, *grid, batch=2, seed=3,
                                      optimizer=optim.adam(1e-2))
        tt, twin = build(), build()
        assert tt.fused
        st, sl = tt.shard_tokens(*_data(CFG, 2))
        tt.step(st, sl)
        twin.step(st, sl)
        before = [t.detach().clone() for t in tt._state_tensors()]
        compiled = tt.compiled_step(st, sl)
        assert compiled is not None
        flops = compiled.cost_analysis()["flops"]
        assert flops > 0 and flops == sum(compiled.op_flops.values())
        assert compiled.launches == {} and compiled.kernel_flops == {}
        assert compiled.memory_analysis() == {"peak_bytes": None, "graph_pool_bytes": None}
        assert "flops" in compiled.as_text() and "launches recorded: none" in compiled.as_text()
        for t, b in zip(tt._state_tensors(), before):
            assert torch.equal(t, b)
        assert torch.equal(tt.step(st, sl), twin.step(st, sl))
        for a, b in zip(tt._state_tensors(), twin._state_tensors()):
            assert torch.equal(a, b)
    finally:
        tenv.finalize()


def test_remat_replays_forward():
    """The remat step's FLOPs over the plain step's lie in (1.15, 1.45): the
    backward replays every block's forward, and the LM head is not replayed
    (tests/test_transformer.py:296-322)."""
    cfg = dataclasses.replace(CFG, n_blocks=8, seq_len=512, d_model=128, n_heads=4,
                              head_dim=32)
    b = 4
    toks, labels = _data(cfg, b)
    tenv = Environment.get_env().init(device="cpu", world_size=1)
    try:
        flops = {}
        for key, c in (("plain", cfg), ("remat", dataclasses.replace(cfg, remat=True)),
                       ("dots", dataclasses.replace(cfg, remat=True, remat_policy="dots"))):
            tt = ttfm.HybridTrainer(tenv, c, 1, 1, 1, batch=b, lr=0.5)
            compiled = tt.compiled_step(*tt.shard_tokens(toks, labels))
            assert compiled is not None
            flops[key] = compiled.cost_analysis()["flops"]
    finally:
        tenv.finalize()
    assert flops["plain"] > 0
    ratio = flops["remat"] / flops["plain"]
    assert 1.15 < ratio < 1.45, flops
    # the counter counts matrix products only, and "dots" keeps every
    # product's output: its replay recomputes none of them
    assert flops["dots"] == flops["plain"], flops


def test_flop_count_takes_the_tensor_core_product():
    """``mxu_einsum``'s product on the card is ``aten.bmm.dtype`` (bf16
    operands, ``out_dtype`` float32), whose extra argument the counter's own
    formula refuses; the step's counter counts it as 2 b m n k. Meta tensors
    stand in for the card's."""
    a = torch.empty((3, 16, 8), dtype=torch.bfloat16, device="meta")
    b = torch.empty((3, 8, 5), dtype=torch.bfloat16, device="meta")

    def step():
        torch.bmm(a, b, out_dtype=torch.float32)
        torch.bmm(a.float(), b.float())

    ops, kernels = ttfm._count_step(step)
    assert sum(ops.values()) == 2 * (2 * 3 * 16 * 5 * 8) and kernels == {}
