"""The port's elementwise optimizers (mlsl_tpu_torch.optim) against optax.

``adam`` and ``sgd`` (with and without momentum) over 5 updates on seeded
vectors and on a (R, D, S, M, n)-shaped batch of them, as the ZeRO-1 state
holds them: updates and state within rtol 1e-6 / atol 1e-7 of optax's, the
same float32 operations in the same order except ``b**count``, which the two
libraries compute with their own ``pow``. The optax state conversion
(``models.convert``) round-trips.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlsl_tpu_torch import optim
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
