"""The port's HybridTrainer with an optimizer, ZeRO-1, gradient accumulation
and gradient buckets, against the JAX package's HybridTrainer
(``donate_params=False``) on tests/test_transformer.py's tiny float32 config,
from the same weights (the JAX tree, converted), 2 steps.

- ``distributed_update=True`` at the grids of tests/test_transformer.py:66-108,
  (2, 2, 2), (4, 1, 2), (8, 1, 1) and (1, 1, 2) (a grad group of one: the full
  local increment), with the built-in SGD and with ``optim.adam`` against
  ``optax.adam``;
- the plain path with Adam: the graph path at (2, 2, 2) and the fused step at
  (1, 1, 2);
- int8 gradients with ZeRO-1 and Adam at (4, 1, 2);
- ``step_accum`` over 2 micro-batches, ZeRO-1 and plain;
- gradient buckets at a size that forms several, ZeRO-1 and plain: the
  bucket membership equals JAX's, and the parameters equal the port's own
  unbucketed run bit for bit (on ``lax`` each element's sum over the members
  is the same whatever its offset in the bucket);
- the Adam state carried from the JAX trainer into the port
  (``convert.transformer_adam_state_from_optax``) and one more step on each.

Tolerances (float32): losses, parameters and Adam moments within 1e-5
absolute and 1e-4 relative, as tests/test_torch_transformer.py holds SGD:
the same operations with the terms of the TP sums and the einsums summed in
another order. Adam's first step moves every element by about lr whatever
its gradient's size, so lr is 1e-3 here: a gradient whose sign the summation
order flips would move its element 2e-3 apart and fail. The int8 case is
held to the same tolerance: its entry quantization sees the same blocks of
the same gradients on both sides.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from mlsl_tpu.models import transformer as jtfm
from mlsl_tpu.types import CompressionType as JComp
from mlsl_tpu_torch import optim
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.models import transformer as ttfm
from mlsl_tpu_torch.models.convert import (
    transformer_adam_state_from_optax,
    transformer_adam_state_to_optax,
    transformer_params_from_jax,
    transformer_params_to_jax,
    tree_leaves,
)
from mlsl_tpu_torch.types import CompressionType

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-4)
CFG = dict(vocab=32, d_model=16, n_heads=4, head_dim=4, n_blocks=2, seq_len=16,
           dtype="float32", attention="zigzag")
LR = 1e-3
# several buckets at the tiny widths: the knob is in MiB and both packages
# size a bucket as grad_bucket_mb * 1024 * 1024 bytes
SMALL_BUCKET_MB = 4096 / (1024 * 1024)


def _data(b, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG["vocab"], size=(b, CFG["seq_len"])).astype(np.int32)
    labels = rng.integers(0, CFG["vocab"], size=(b, CFG["seq_len"])).astype(np.int32)
    return toks, labels


def _pair(env, grid, *, du, opt, comp=CompressionType.NONE, bucket_mb=0):
    """-> (JAX trainer, port trainer, port Environment) on the same weights."""
    dp, sp, tp = grid
    b = 2 * dp
    jopt = optax.adam(LR) if opt == "adam" else None
    env.config.grad_bucket_mb = bucket_mb
    try:
        jt = jtfm.HybridTrainer(env, jtfm.TransformerConfig(**CFG), dp, sp, tp, batch=b,
                                lr=0.5, distributed_update=du, compression=JComp(int(comp)),
                                devices=env.devices[:dp * sp * tp], optimizer=jopt,
                                donate_params=False)
    finally:
        env.config.grad_bucket_mb = 0
    init = jax.tree.map(np.asarray, jax.device_get(jt.params))
    return (jt, *_port(grid, init, du=du, opt=opt, comp=comp, bucket_mb=bucket_mb))


def _port(grid, init, *, du, opt, comp=CompressionType.NONE, bucket_mb=0):
    """-> (port trainer, its Environment) from the JAX tree ``init``."""
    dp, sp, tp = grid
    tenv = Environment.get_env().init(device="cpu", world_size=dp * sp * tp)
    tenv.config.grad_bucket_mb = bucket_mb
    tt = ttfm.HybridTrainer(tenv, ttfm.TransformerConfig(**CFG), dp, sp, tp, batch=2 * dp,
                            lr=0.5, distributed_update=du, compression=comp,
                            optimizer=optim.adam(LR) if opt == "adam" else None, params=init)
    return tt, tenv


def _jax_state(jt, du):
    return jt._du_opt_state if du else jt._opt_state


def _check(jt, tt, du, opt, tol=TOL):
    want = jax.device_get(jt.params)
    got = transformer_params_to_jax(tt.params, tt.cfg)
    for name in jtfm.layer_names(jt.cfg):
        for a, w in zip(tree_leaves(got[name]), jax.tree.leaves(want[name])):
            np.testing.assert_allclose(a, np.asarray(w), **tol, err_msg=name)
    if opt == "adam":
        port = transformer_adam_state_to_optax(tt.opt_state)
        for name, st in _jax_state(jt, du).items():
            mu, nu, count = port[name]
            np.testing.assert_allclose(mu, np.asarray(st[0].mu), **tol, err_msg=name)
            np.testing.assert_allclose(nu, np.asarray(st[0].nu), **tol, err_msg=name)
            np.testing.assert_array_equal(count, np.asarray(st[0].count))


def _run(jt, tt, steps=2, accum=False):
    dp = tt.dp
    micro = [_data(2 * dp, seed=s) for s in ((0, 1) if accum else (0,))]
    jb = [jt.shard_tokens(*m) for m in micro]
    tb = [tt.shard_tokens(*m) for m in micro]
    out = []
    for _ in range(steps):
        if accum:
            jl, tl = jt.step_accum(jb), tt.step_accum(tb)
        else:
            jl, tl = jt.step(*jb[0]), tt.step(*tb[0])
        out.append((float(tl), float(jl)))
    return out


ZERO1 = [(g, o) for g in [(2, 2, 2), (4, 1, 2), (8, 1, 1), (1, 1, 2)] for o in ("sgd", "adam")]


@pytest.mark.parametrize("grid,opt", ZERO1,
                         ids=lambda c: "dp%d-sp%d-tp%d" % c if isinstance(c, tuple) else c)
def test_zero1_matches_jax(env, grid, opt):
    jt, tt, tenv = _pair(env, grid, du=True, opt=opt)
    try:
        assert not tt.fused
        if grid[0] * grid[1] > 1:
            ps = tt.ops["blk0.attn"].get_parameter_set(0)
            assert ps.grad_req.desc.kind == "reduce_scatter"
            assert ps.inc_req.desc.kind == "allgather"
        if opt == "adam":
            for name in tt.layers:
                ps = tt.ops[name].get_parameter_set(0)
                assert tuple(tt.opt_state[name].mu.shape) == (*tt.grid, ps.owned_kernel_count)
        for tl, jl in _run(jt, tt):
            np.testing.assert_allclose(tl, jl, **TOL)
        _check(jt, tt, True, opt)
    finally:
        tenv.finalize()


@pytest.mark.parametrize("grid", [(2, 2, 2), (1, 1, 2)], ids=["graph", "fused"])
def test_plain_adam_matches_jax(env, grid):
    jt, tt, tenv = _pair(env, grid, du=False, opt="adam")
    try:
        assert tt.fused == (grid[0] * grid[1] == 1)
        for name in tt.layers:
            assert tuple(tt.opt_state[name].mu.shape) == (*tt.grid, tt.local_counts[name])
        for tl, jl in _run(jt, tt):
            np.testing.assert_allclose(tl, jl, **TOL)
        _check(jt, tt, False, "adam")
    finally:
        tenv.finalize()


def test_zero1_int8_matches_jax(env):
    jt, tt, tenv = _pair(env, (4, 1, 2), du=True, opt="adam",
                         comp=CompressionType.QUANTIZATION)
    try:
        assert tt.ops["final"].get_parameter_set(0).grad_req.algo == "quant_ring"
        for tl, jl in _run(jt, tt):
            np.testing.assert_allclose(tl, jl, **TOL)
        _check(jt, tt, True, "adam")
    finally:
        tenv.finalize()


@pytest.mark.parametrize("du", [True, False], ids=["zero1", "plain"])
def test_step_accum_matches_jax(env, du):
    jt, tt, tenv = _pair(env, (2, 2, 2), du=du, opt="adam")
    try:
        for tl, jl in _run(jt, tt, accum=True):
            np.testing.assert_allclose(tl, jl, **TOL)
        _check(jt, tt, du, "adam")
    finally:
        tenv.finalize()


@pytest.mark.parametrize("du", [True, False], ids=["zero1", "plain"])
def test_bucketed_matches_jax_and_unbucketed(env, du):
    from mlsl_tpu.core import stats as jstats
    from mlsl_tpu_torch.core import stats

    jt, tt, tenv = _pair(env, (2, 2, 2), du=du, opt="adam", bucket_mb=SMALL_BUCKET_MB)
    try:
        tps = [tt.ops[n].get_parameter_set(0) for n in tt.layers]
        jps = [jt.ops[n].get_parameter_set(0) for n in tt.layers]

        def members(pss, attr):
            seen = {}
            for i, ps in enumerate(pss):
                b = getattr(ps, attr)
                if b is not None:
                    seen.setdefault(id(b), []).append(i)
            return sorted(seen.values())

        for attr in ("bucket", "inc_bucket"):
            assert members(tps, attr) == members(jps, attr), attr
        groups = members(tps, "bucket")
        assert len(groups) >= 2, groups
        if du:
            assert len(members(tps, "inc_bucket")) >= 1
        stats.reset_bucket_counters()
        jstats.reset_bucket_counters()
        for tl, jl in _run(jt, tt):
            np.testing.assert_allclose(tl, jl, **TOL)
        _check(jt, tt, du, "adam")
        # every round coalesced: one dispatch a bucket, phase and step
        n = len(groups) + (len(members(tps, "inc_bucket")) if du else 0)
        assert stats.BUCKET_COUNTERS["rounds_dispatched"] == 2 * n
        assert stats.BUCKET_COUNTERS["rounds_fallback"] == 0
        for key in ("rounds_dispatched", "rounds_fallback", "member_abandons",
                    "bytes_coalesced"):
            assert stats.BUCKET_COUNTERS[key] == jstats.BUCKET_COUNTERS[key], key
        assert all(ps._bucket_round for ps in tps if ps.bucket is not None)
        bucketed = transformer_params_to_jax(tt.params, tt.cfg)
    finally:
        tenv.finalize()
    # the JAX trainer's own starting weights (seed 0)
    init = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                     jtfm.TransformerConfig(**CFG)))
    tt, tenv = _port((2, 2, 2), init, du=du, opt="adam")
    try:
        batch = tt.shard_tokens(*_data(4))
        for _ in range(2):
            tt.step(*batch)
        plain = transformer_params_to_jax(tt.params, tt.cfg)
    finally:
        tenv.finalize()
    for name in bucketed:
        for a, w in zip(tree_leaves(bucketed[name]), tree_leaves(plain[name])):
            np.testing.assert_array_equal(a, w, err_msg=name)


def test_adam_state_from_jax_then_one_step(env):
    """JAX's ZeRO-1 trainer after 1 step, carried into a fresh port trainer
    (weights and per-layer Adam state), then one more step on each."""
    jt, tt, tenv = _pair(env, (2, 2, 2), du=True, opt="adam")
    try:
        toks, labels = _data(4)
        jb = jt.shard_tokens(toks, labels)
        jt.step(*jb)
        grid = tt.grid
        tt.params = transformer_params_from_jax(
            jax.tree.map(np.asarray, jax.device_get(jt.params)), tt.cfg, grid, device="cpu")
        for leaf in tree_leaves(tt.params):
            leaf.requires_grad_(True)
        tt._leaves = {n: tree_leaves(tt.params[n]) for n in tt.layers}
        tt.opt_state = transformer_adam_state_from_optax(jt._du_opt_state, device="cpu")
        assert int(tt.opt_state["embed"].count) == 1
        jt.step(*jb)
        tt.step(*tt.shard_tokens(toks, labels))
        _check(jt, tt, True, "adam")
    finally:
        tenv.finalize()
