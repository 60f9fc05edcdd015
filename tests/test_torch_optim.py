"""The port's elementwise optimizers (mlsl_tpu_torch.optim) against optax.

``adam`` and ``sgd`` (with and without momentum) over 5 updates on seeded
vectors and on a (R, D, S, M, n)-shaped batch of them, as the ZeRO-1 state
holds them: updates and state within rtol 1e-6 / atol 1e-7 of optax's, the
same float32 operations in the same order except ``b**count``, which the two
libraries compute with their own ``pow``. The optax state conversion
(``models.convert``) round-trips.

``adamw`` (with and without a mask), ``clip_by_global_norm`` and ``chain``:
as transforms over a list of leaves against optax at the same bound, and on
the MLP trainer against the single-device optax loop of
tests/test_optimizers.py within its 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlsl_tpu_torch import optim
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models.convert import adam_state_from_optax, adam_state_to_optax

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-7)
STEPS = 5


def _grads(shape, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
            for _ in range(STEPS)]


CASES = [
    ("adam", lambda: optax.adam(1e-3), lambda: optim.adam(1e-3)),
    ("adam-knobs", lambda: optax.adam(5e-3, b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-9),
     lambda: optim.adam(5e-3, b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-9)),
    ("sgd", lambda: optax.sgd(0.1), lambda: optim.sgd(0.1)),
    ("sgd-momentum", lambda: optax.sgd(0.1, momentum=0.9), lambda: optim.sgd(0.1, 0.9)),
]


@pytest.mark.parametrize("shape", [(1000,), (1, 8, 1, 1, 37)], ids=["flat", "per-rank"])
@pytest.mark.parametrize("name,jmake,tmake", CASES, ids=[c[0] for c in CASES])
def test_updates_match_optax(name, jmake, tmake, shape):
    jopt, topt = jmake(), tmake()
    jstate = jopt.init(jnp.zeros(shape, jnp.float32))
    tstate = topt.init(shape if len(shape) > 1 else shape[0], device="cpu")
    for g in _grads(shape, seed=len(shape)):
        ju, jstate = jopt.update(jnp.asarray(g), jstate)
        tu, tstate = topt.update(torch.from_numpy(g), tstate)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    if name.startswith("adam"):
        js = jstate[0]
        np.testing.assert_allclose(tstate.mu.numpy(), np.asarray(js.mu), **TOL)
        np.testing.assert_allclose(tstate.nu.numpy(), np.asarray(js.nu), **TOL)
        assert int(tstate.count) == int(js.count) == STEPS
    elif name == "sgd-momentum":
        np.testing.assert_allclose(tstate.trace.numpy(), np.asarray(jstate[0].trace), **TOL)


def test_adam_state_conversion_round_trips():
    """Owned-shard buffers and a replicated tree of moments: optax's
    ScaleByAdamState -> AdamState -> numpy gives back the same arrays, and
    a converted state steps on exactly as optax's does."""
    shape = (1, 8, 1, 1, 37)
    jopt, topt = optax.adam(1e-3), optim.adam(1e-3)
    jstate = jopt.init(jnp.zeros(shape, jnp.float32))
    gs = _grads(shape, seed=7)
    for g in gs[:3]:
        _, jstate = jopt.update(jnp.asarray(g), jstate)
    js = jstate[0]
    count = np.broadcast_to(np.asarray(js.count), shape[:-1] + (1,))   # per-rank buffer
    st = adam_state_from_optax(np.asarray(js.mu), np.asarray(js.nu), count, "cpu")
    mu, nu, c = adam_state_to_optax(st)
    np.testing.assert_array_equal(mu, np.asarray(js.mu))
    np.testing.assert_array_equal(nu, np.asarray(js.nu))
    assert c == 3
    ju, _ = jopt.update(jnp.asarray(gs[3]), jstate)
    tu, _ = topt.update(torch.from_numpy(gs[3]), st)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)

    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "w": np.ones(4, np.float32)}, "z": np.full(5, 2.0, np.float32)}
    per_layer = adam_state_from_optax(tree, {k: v for k, v in tree.items()}, np.int32(4),
                                      "cpu", layers=["a", "z"], get_layer=lambda t, n: t[n])
    m, _, c = adam_state_to_optax(per_layer["a"])
    np.testing.assert_array_equal(m, np.concatenate([np.arange(6), np.ones(4)]))
    assert c == 4 and per_layer["z"].mu.tolist() == [2.0] * 5
    with pytest.raises(ValueError):
        adam_state_from_optax(mu, nu, np.array([1, 2]), "cpu")


def _adam_out_of_place(g, mu, nu, count, lr, b1, b2, eps, eps_root):
    """The out-of-place formula the port had before its update went in place:
    the oracle of the in-place update's bits."""
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    limit = torch.iinfo(torch.int32).max
    count = torch.where(count < limit, count + 1, count)
    c = count.to(torch.float32)
    one = torch.ones((), dtype=torch.float32)
    mu_hat = mu / (one - torch.pow(torch.full_like(one, b1), c))
    nu_hat = nu / (one - torch.pow(torch.full_like(one, b2), c))
    return -lr * (mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)), mu, nu, count


ADAM_KNOBS = [dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0),
              dict(lr=5e-3, b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-9)]


@pytest.mark.parametrize("shape", [(1000,), (1, 8, 1, 1, 37)], ids=["flat", "per-rank"])
@pytest.mark.parametrize("knobs", ADAM_KNOBS, ids=["default", "knobs"])
def test_adam_in_place_keeps_the_bits_and_the_storage(knobs, shape):
    """``adam().update`` writes mu and nu into the state it was given (the
    reference donates its state) and gives the out-of-place formula's bits
    over 5 steps, updates and state."""
    opt = optim.adam(**knobs)
    state = opt.init(shape if len(shape) > 1 else shape[0], device="cpu")
    mu0, nu0 = state.mu.data_ptr(), state.nu.data_ptr()
    ref = (state.mu.clone(), state.nu.clone(), state.count.clone())
    for g in _grads(shape, seed=11):
        g = torch.from_numpy(g)
        upd, state = opt.update(g, state)
        want, *ref = _adam_out_of_place(g, *ref, **knobs)
        assert torch.equal(upd, want)
        assert torch.equal(state.mu, ref[0]) and torch.equal(state.nu, ref[1])
        assert int(state.count) == int(ref[2])
        assert (state.mu.data_ptr(), state.nu.data_ptr()) == (mu0, nu0)


def test_sgd_momentum_in_place_keeps_the_bits_and_the_storage():
    """The momentum trace is updated in place: t = g + momentum * t, bit for
    bit, in the storage ``init`` made; without momentum the state is empty."""
    opt = optim.sgd(0.1, momentum=0.9)
    state = opt.init(1000, device="cpu")
    ptr, trace = state.trace.data_ptr(), state.trace.clone()
    for g in _grads((1000,), seed=12):
        g = torch.from_numpy(g)
        upd, state = opt.update(g, state)
        trace = g + 0.9 * trace
        assert torch.equal(state.trace, trace) and torch.equal(upd, -0.1 * trace)
        assert state.trace.data_ptr() == ptr
    plain = optim.sgd(0.1)
    assert plain.init(10).trace is None


# -- adamw, clip_by_global_norm and chain (tests/test_optimizers.py:87-140, 240-) --


def _tree(seed, shapes=((6, 4), (4,), (3, 5))):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * 10.0 ** rng.integers(-2, 1)).astype(np.float32)
            for s in shapes]


TREE_CASES = [
    ("adamw", lambda: optax.adamw(1e-2, weight_decay=0.1),
     lambda: optim.adamw(1e-2, weight_decay=0.1)),
    ("adamw-mask", lambda: optax.adamw(5e-3, b1=0.8, eps=1e-6, weight_decay=0.3,
                                       mask=lambda p: [x.ndim > 1 for x in p]),
     lambda: optim.adamw(5e-3, b1=0.8, eps=1e-6, weight_decay=0.3,
                         mask=lambda p: [x.dim() > 1 for x in p])),
    ("clip-adam", lambda: optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2)),
     lambda: optim.chain(optim.clip_by_global_norm(0.5), optim.adam(1e-2))),
    ("clip-adamw", lambda: optax.chain(optax.clip_by_global_norm(0.5),
                                       optax.adamw(1e-2, weight_decay=0.1)),
     lambda: optim.chain(optim.clip_by_global_norm(0.5), optim.adamw(1e-2, weight_decay=0.1))),
    ("clip-sgd-momentum", lambda: optax.chain(optax.clip_by_global_norm(1e3),
                                              optax.sgd(0.1, momentum=0.9)),
     lambda: optim.chain(optim.clip_by_global_norm(1e3), optim.sgd(0.1, momentum=0.9))),
]


@pytest.mark.parametrize("name,jmake,tmake", TREE_CASES, ids=[c[0] for c in TREE_CASES])
def test_tree_transforms_match_optax(name, jmake, tmake):
    """The tree transforms over a list of leaves against optax over the same
    list, 5 updates with the parameters moving: updates within rtol 1e-6 /
    atol 1e-7 (the clip's norm sums the leaves in another order; XLA may
    contract the decay's product into the add)."""
    jopt, topt = jmake(), tmake()
    params = _tree(1)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jopt.init(jp), topt.init(tp, device="cpu")
    assert topt.whole_tree == name.startswith("clip")
    for step in range(STEPS):
        grads = _tree(10 + step)
        ju, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jp)
        tu, tstate = topt.update([torch.from_numpy(g) for g in grads], tstate, tp)
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        jp = optax.apply_updates(jp, ju)
        tp = [p + u for p, u in zip(tp, tu)]


def test_chain_of_elementwise_transforms_is_elementwise():
    """A chain of elementwise transforms is a ``Transform``, bit for bit the
    composition, and takes the (R, D, S, M, n) shape of a ZeRO-1 state."""
    shape = (1, 8, 1, 1, 37)
    ch = optim.chain(optim.sgd(1.0, momentum=0.5), optim.adam(1e-3))
    assert isinstance(ch, optim.Transform)
    a, b = optim.sgd(1.0, momentum=0.5), optim.adam(1e-3)
    sc, sa, sb = ch.init(shape, device="cpu"), a.init(shape, device="cpu"), b.init(
        shape, device="cpu")
    for g in _grads(shape, seed=3):
        g = torch.from_numpy(g)
        u, sc = ch.update(g, sc)
        w, sa = a.update(g, sa)
        w, sb = b.update(w, sb)
        assert torch.equal(u, w)


def _mlp_oracle(opt, xs, ys):
    import jax

    from mlsl_tpu.models.mlp import init as mlp_init, loss_fn

    params = mlp_init(jax.random.PRNGKey(0))
    state = opt.init(params)

    @jax.jit
    def step(params, state, x, y):
        grads = jax.grad(loss_fn)(params, (x, y))
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for x, y in zip(xs, ys):
        params, state = step(params, state, jnp.asarray(x), jnp.asarray(y))
    return params


def _mlp_trainer(tenv, opt, du=False, frozen=False):
    import jax

    from mlsl_tpu.models.mlp import init as mlp_init
    from mlsl_tpu_torch.models import mlp as tmlp
    from mlsl_tpu_torch.models.convert import params_from_jax
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    model = tmlp.MLP(device="cpu", params=params_from_jax(host, "cpu"))
    if frozen:
        model.frozen = torch.nn.Parameter(torch.full((4,), 7.0))
    dist = tenv.create_distribution(8, 1)
    sess = tenv.create_session()
    sess.set_global_minibatch_size(16)
    return DataParallelTrainer(tenv, dist, sess, model, tmlp.loss_fn, tmlp.LAYERS,
                               tmlp.get_layer, distributed_update=du, optimizer=opt)


@pytest.fixture()
def tenv():
    from mlsl_tpu_torch.core.environment import Environment

    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _ndim_mask(p):
    import jax

    return jax.tree.map(lambda x: x.ndim > 1, p)


TRAINER_CASES = [
    ("adamw", lambda: optax.adamw(1e-2, weight_decay=0.1),
     lambda: optim.adamw(1e-2, weight_decay=0.1)),
    ("adamw-mask", lambda: optax.adamw(1e-2, weight_decay=0.1,
                                       mask=_ndim_mask),
     lambda: optim.adamw(1e-2, weight_decay=0.1, mask=lambda p: [x.dim() > 1 for x in p])),
    ("clip-adam", lambda: optax.chain(optax.clip_by_global_norm(0.1), optax.adam(1e-2)),
     lambda: optim.chain(optim.clip_by_global_norm(0.1), optim.adam(1e-2))),
]


@pytest.mark.parametrize("name,jmake,tmake", TRAINER_CASES, ids=[c[0] for c in TRAINER_CASES])
def test_trainer_tree_transforms_match_single_device_optax(tenv, name, jmake, tmake):
    """tests/test_optimizers.py's adamw and clip-chain cases on the port's MLP
    trainer (plain path, 8 ranks, 4 steps) against the single-device optax
    loop, within its 1e-5; a leaf outside the registered layers stays
    untouched; the global clip runs once over every layer (``tree_state``)."""
    from mlsl_tpu_torch.models.convert import params_to_jax

    rng = np.random.default_rng(42)
    xs = [rng.normal(size=(16, 8)).astype(np.float32) for _ in range(4)]
    ys = [rng.integers(0, 4, size=(16,)).astype(np.int32) for _ in range(4)]
    tr = _mlp_trainer(tenv, tmake(), frozen=True)
    assert (tr.tree_state is not None) == name.startswith("clip")
    for x, y in zip(xs, ys):
        tr.step(tr.shard_batch(x, y))
    want = _mlp_oracle(jmake(), xs, ys)
    import jax

    got = jax.tree.leaves(params_to_jax(tr.model))
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5, rtol=1e-5)
    assert torch.equal(tr.model.frozen, torch.full((4,), 7.0))


def test_zero1_takes_elementwise_chains_and_refuses_tree_transforms(tenv):
    """Under ZeRO-1 a chain of elementwise transforms runs on the owned
    shards, bit for bit its members; adamw and the global clip raise."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(16,)).astype(np.int32)
    a = _mlp_trainer(tenv, optim.chain(optim.adam(1e-2)), du=True)
    b = _mlp_trainer(tenv, optim.adam(1e-2), du=True)
    for _ in range(3):
        a.step(a.shard_batch(x, y))
        b.step(b.shard_batch(x, y))
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
    for opt in (optim.adamw(1e-2), optim.chain(optim.clip_by_global_norm(1.0), optim.adam(1e-2))):
        with pytest.raises(MLSLError, match="distributed_update"):
            _mlp_trainer(tenv, opt, du=True)
