"""The port's mixture-of-experts layer (mlsl_tpu_torch.models.moe) and the
MoE transformer trainer against the JAX package's, on numpy-seeded inputs.

- ``_route`` (top-1, top-2, and capacity drops at capacity_factor 0.1):
  dispatch and combine equal, aux within 1e-6.
- ``moe_ffn`` at ep = 2 and 4 against JAX ``moe_ffn`` inside ``smap`` on
  the CPU mesh and against ``moe_ffn_dense``, float32: outputs and aux
  within 1e-5; gradients of wg, w1, w2 and x (of sum(out * g) + the aux
  losses) against jax.grad of the dense oracle within 1e-5 abs / 1e-4 rel.
  The port runs both with a bare rank dim (the plain exchange) and on the
  (R, D, S, M) grid with the model group (the engine's exchange).
- The kernel route on the CPU (``MLSL_ALGO=alltoall=pallas_a2a``, B6's plain
  version): dense, output and gradients equal to the lax route bit for bit
  (an all-to-all and its transpose are permutations); int8 within rtol/atol
  0.05 of the JAX output (tests/test_pallas_a2a.py:534-535).
- ``HybridTrainer`` with 4 experts, float32, at (dp, sp, tp) = (2, 1, 2),
  (1, 2, 2) zigzag and (1, 1, 2), the fused step: the gradient rows before
  sync against JAX's ``_grad_fn`` at tests/test_torch_transformer.py's
  tolerances (1e-5 abs, 1e-4 rel) and 3-step losses within 1e-5; a bfloat16
  run stays finite.
- The expert weights cross between the packages exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mlsl_tpu.models import moe as jmoe
from mlsl_tpu.models import transformer as jtfm
from mlsl_tpu.models.train import smap
from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.models import moe as tmoe
from mlsl_tpu_torch.models import transformer as ttfm
from mlsl_tpu_torch.models.convert import (
    transformer_params_from_jax,
    transformer_params_to_jax,
    tree_leaves,
)
from mlsl_tpu_torch.ops import a2a_kernels as ta2a

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-4)
D, FF, T = 16, 32, 64


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _moe_inputs(seed, e, d=D, f=FF, t=T):
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(jax.random.PRNGKey(seed), d, f, e))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, d)).astype(np.float32)
    g = rng.normal(size=(t, d)).astype(np.float32)
    return params, x, g


# -- routing ------------------------------------------------------------------------


@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 2.0), (1, 0.1), (2, 0.1)])
def test_route_matches_jax(top_k, cf):
    e = 4
    params, x, _ = _moe_inputs(top_k, e)
    capacity = max(1, int(T * cf * top_k / e))
    jd, jc, ja = jmoe._route(jnp.asarray(x), jnp.asarray(params["wg"]), e, capacity, top_k)
    td, tc, ta = tmoe._route(_t(x), _t(params["wg"]), e, capacity, top_k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=1e-6)
    if cf < 1:
        # over capacity: some tokens are dropped (their dispatch rows are 0)
        assert (td.sum(dim=(-2, -1)) < top_k).any()
    # leading rank dims route each rank's slice on its own
    tdb, _, tab = tmoe._route(_t(x).expand(3, T, D), _t(params["wg"]).expand(3, D, e),
                              e, capacity, top_k)
    assert torch.equal(tdb[1], td) and torch.equal(tab, ta.expand(3))


# -- moe_ffn against JAX ------------------------------------------------------------


def _jax_moe(env, params, x, ep, cf, top_k):
    dist = env.create_distribution(1, ep, devices=env.devices[:ep])
    spec_p = {"wg": P(), "w1": P("model", None, None), "w2": P("model", None, None)}

    def body(p, x):
        out, aux = jmoe.moe_ffn(x, p, "model", ep, cf, top_k)
        return out, aux[None]

    fn = jax.jit(smap(body, dist.topology.mesh, in_specs=(spec_p, P()),
                      out_specs=(P(), P("model")), check=False))
    out, aux = fn(params, jnp.asarray(x))
    return np.asarray(out), np.asarray(aux)


def _jax_dense_grads(params, x, g, ep, cf, top_k):
    def loss(wg, w1, w2, x):
        out, aux = jmoe.moe_ffn_dense(x, wg, w1, w2, ep, cf, top_k)
        return jnp.sum(out * g) + ep * aux

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (params["wg"], params["w1"], params["w2"], x)))
    return [np.asarray(v) for v in grads]


def _port_moe(params, x, g, ep, cf, top_k, grid, config=None):
    """The port's moe_ffn on ``ep`` ranks: ``grid`` False puts them on a bare
    rank dim (the plain exchange), True on the (1, 1, 1, ep) grid with the
    model group (the engine's exchange, with ``config``'s selection). ->
    (out of every rank, aux per rank, [d wg, d w1, d w2, d x] summed as the
    dense oracle's)."""
    e = params["w1"].shape[0]
    lead = (1, 1, 1, ep) if grid else (ep,)
    axis = len(lead) - 1
    group = ProcessGroup(Topology(1, ep, ep), ("model",)) if grid else None

    def ranks(a, shard):
        t = _t(a)
        t = t.reshape(ep, e // ep, *t.shape[1:]) if shard else t.expand(ep, *t.shape)
        return t.reshape(*lead, *t.shape[1:]).clone().requires_grad_(True)

    p = {"wg": ranks(params["wg"], False), "w1": ranks(params["w1"], True),
         "w2": ranks(params["w2"], True)}
    xt = ranks(x, False)
    out, aux = tmoe.moe_ffn(xt, p, axis, ep, cf, top_k, group=group, config=config)
    loss = (out.reshape(ep, T, D)[0] * _t(g)).sum() + aux.sum()
    gw = torch.autograd.grad(loss, [p["wg"], p["w1"], p["w2"], xt])
    grads = [gw[0].reshape(ep, D, e).sum(0), gw[1].reshape(e, D, FF),
             gw[2].reshape(e, FF, D), gw[3].reshape(ep, T, D).sum(0)]
    return out.detach().reshape(ep, T, D), aux.detach().reshape(ep), grads


@pytest.mark.parametrize("ep,top_k", [(2, 1), (4, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("grid", [False, True], ids=["rankdim", "grid"])
def test_moe_ffn_matches_jax(env, ep, top_k, grid):
    e, cf = 8, 2.0
    params, x, g = _moe_inputs(10 * ep + top_k, e)
    jout, jaux = _jax_moe(env, params, x, ep, cf, top_k)
    dout, daux = jmoe.moe_ffn_dense(*(jnp.asarray(a) for a in (x, params["wg"], params["w1"],
                                                               params["w2"])), ep, cf, top_k)
    out, aux, grads = _port_moe(params, x, g, ep, cf, top_k, grid)
    for r in range(ep):
        np.testing.assert_allclose(out[r].numpy(), jout, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(dout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(aux.numpy(), jaux, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux.mean()), float(daux), atol=1e-5, rtol=1e-5)
    tdo, tda = tmoe.moe_ffn_dense(_t(x), _t(params["wg"]), _t(params["w1"]), _t(params["w2"]),
                                  ep, cf, top_k)
    np.testing.assert_allclose(tdo.numpy(), np.asarray(dout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(tda), float(daux), atol=1e-5, rtol=1e-5)
    for name, got, want in zip(("wg", "w1", "w2", "x"), grads,
                               _jax_dense_grads(params, x, g, ep, cf, top_k)):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=name)


def _config(spec, quant):
    c = Config()
    c.collective_algo = spec
    c.pallas_a2a_quant = quant
    c.quant_block_elems = 128
    c.validate()
    return c


def test_kernel_route_dense_equals_lax(monkeypatch):
    """The forced kernel route on the CPU runs B6's plain version: dense, it
    is the lax exchange bit for bit, forward and backward (both exchanges
    are float32 here, so both take it)."""
    params, x, g = _moe_inputs(5, 8)
    calls = []
    orig = ta2a.alltoall_ref

    def counting(xw, p):
        calls.append((p.quantized, tuple(xw.shape)))
        return orig(xw, p)

    monkeypatch.setattr(ta2a, "alltoall_ref", counting)
    ta2a._exchange_bodies.cache_clear()
    base = _port_moe(params, x, g, 2, 2.0, 1, True, config=_config("alltoall=lax", True))
    assert calls == []
    got = _port_moe(params, x, g, 2, 2.0, 1, True, config=_config("alltoall=pallas_a2a", False))
    # two exchanges forward, their two transposes backward
    assert [q for q, _ in calls] == [False] * 4
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    for a, b in zip(got[2], base[2]):
        assert torch.equal(a, b)
    ta2a._exchange_bodies.cache_clear()


def test_kernel_route_int8_close_to_jax(env):
    """The int8 route: every chunk of both exchanges makes one codec round
    trip (the entry codec of a zero residual, then B6's), within 0.05 of the
    JAX output, with the gradient of the dense exchange."""
    params, x, g = _moe_inputs(7, 4)
    jout, _ = _jax_moe(env, params, x, 4, 2.0, 1)
    out, _, grads = _port_moe(params, x, g, 4, 2.0, 1, True,
                              config=_config("alltoall=pallas_a2a", True))
    np.testing.assert_allclose(out[0].numpy(), jout, rtol=0.05, atol=0.05)
    assert not torch.equal(out, _port_moe(params, x, g, 4, 2.0, 1, True)[0])
    assert all(bool(torch.isfinite(v).all()) for v in grads)


# -- the MoE transformer trainer ----------------------------------------------------

CFG = dict(vocab=32, d_model=16, n_heads=4, head_dim=4, n_blocks=2, seq_len=16,
           dtype="float32", n_experts=4)


def _data(b, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG["vocab"], size=(b, CFG["seq_len"])).astype(np.int32)
    labels = rng.integers(0, CFG["vocab"], size=(b, CFG["seq_len"])).astype(np.int32)
    return toks, labels


@pytest.mark.parametrize("grid,attention", [((2, 1, 2), "ring"), ((1, 2, 2), "zigzag"),
                                            ((1, 1, 2), "ring")],
                         ids=["dp2-sp1-tp2", "dp1-sp2-tp2-zigzag", "dp1-sp1-tp2-fused"])
def test_moe_trainer_matches_jax(env, grid, attention):
    """The graph path, and the fused path of a grad group of one: the aux
    term enters both backwards."""
    dp, sp, tp = grid
    toks, labels = _data(2 * dp)
    cfg = jtfm.TransformerConfig(**CFG, attention=attention)
    jt = jtfm.HybridTrainer(env, cfg, dp, sp, tp, batch=toks.shape[0], lr=0.5,
                            devices=env.devices[: dp * sp * tp])
    init = jax.tree.map(np.asarray, jax.device_get(jt.params))
    st, sl = jt.shard_tokens(toks, labels)
    jloss, jflat = jt._grad_fn(jt.params, st, sl)
    jlosses = [float(jt.step(st, sl)) for _ in range(3)]

    tenv = Environment.get_env().init(device="cpu", world_size=dp * sp * tp)
    try:
        tcfg = ttfm.TransformerConfig(**CFG, attention=attention)
        tt = ttfm.HybridTrainer(tenv, tcfg, dp, sp, tp, batch=toks.shape[0], lr=0.5,
                                params=init)
        assert tt.fused == (dp * sp == 1)
        tst, tsl = tt.shard_tokens(toks, labels)
        loss, rows = tt._grad_fn(tst, tsl)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
        assert sorted(rows) == sorted(jflat)
        for name, row in rows.items():
            np.testing.assert_allclose(row.numpy(), np.asarray(jflat[name]), **TOL,
                                       err_msg=name)
        losses = [float(tt.step(tst, tsl)) for _ in range(3)]
        np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    finally:
        tenv.finalize()


def test_moe_trainer_checks_and_bf16_runs():
    """JAX's checks (experts and local tokens divide by tp), and a bfloat16
    run that stays finite (tests/test_transformer.py:177-192)."""
    from mlsl_tpu_torch.log import MLSLError

    tenv = Environment.get_env().init(device="cpu", world_size=4)
    try:
        with pytest.raises(MLSLError, match="n_experts"):
            ttfm.HybridTrainer(tenv, ttfm.TransformerConfig(**{**CFG, "n_experts": 3}),
                               2, 1, 2, batch=2)
        with pytest.raises(MLSLError, match="local token count"):
            ttfm.HybridTrainer(tenv, ttfm.TransformerConfig(**{**CFG, "seq_len": 15}),
                               1, 1, 4, batch=1)
        cfg = ttfm.TransformerConfig(**{**CFG, "dtype": "bfloat16"})
        tt = ttfm.HybridTrainer(tenv, cfg, 2, 1, 2, batch=4, lr=0.1)
        batch = tt.shard_tokens(*_data(4))
        losses = [float(tt.step(*batch)) for _ in range(3)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    finally:
        tenv.finalize()


def test_moe_weights_cross_exactly():
    """JAX init_params with experts -> the port's per-rank layout -> back is
    the identity; rank m holds experts [m*El, (m+1)*El) and a copy of the
    gate; the port's own init_params has the JAX tree's structure."""
    cfg = ttfm.TransformerConfig(**CFG)
    jparams = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(4),
                                                        jtfm.TransformerConfig(**CFG)))
    per_rank = transformer_params_from_jax(jparams, cfg, (1, 1, 2, 2), device="cpu")
    back = transformer_params_to_jax(per_rank, cfg)
    for name, leaves in jparams.items():
        for key, want in leaves.items():
            np.testing.assert_array_equal(back[name][key], want)
    mp = per_rank["blk0.mlp"]
    assert sorted(mp) == ["w1", "w2", "wg"]
    np.testing.assert_array_equal(mp["w1"][0, 0, 1, 1].numpy(), jparams["blk0.mlp"]["w1"][2:])
    np.testing.assert_array_equal(mp["wg"][0, 0, 0, 1].numpy(), jparams["blk0.mlp"]["wg"])
    own = ttfm.init_params(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, jparams)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, {n: dict(v) for n, v in own.items()}))
    for name in jparams:
        for key in jparams[name]:
            assert tuple(own[name][key].shape) == jparams[name][key].shape
    assert [tuple(t.shape) for t in tree_leaves(own["blk1.mlp"])] == \
        [(4, 16, 64), (4, 64, 16), (16, 4)]
    assert dataclasses.asdict(cfg)["n_experts"] == 4
