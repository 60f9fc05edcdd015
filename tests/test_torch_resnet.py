"""The port's ResNet-50 (mlsl_tpu_torch.models.resnet) against the JAX package's
``apply_resnet50``/``loss_fn``, at 32x32, batch 2, 10 classes, with the JAX
parameters loaded through ``params_from_jax``.

Both compute activations in bfloat16 with float32 parameters, so the two
differ by bf16 rounding at other places (conv accumulation order, where each
framework rounds back to bf16). Each layer is held against JAX's on the same
input activation, at one bf16 rounding step; the whole network's logits and
loss at the sensitivity JAX shows to itself (see the test); each layer's flat
gradient at a relative L2 error of 2e-2. The layer names, per-layer parameter
counts and the flat per-layer element order must equal JAX's exactly: the
int8 codec's blocks group 256 consecutive elements of that order.
"""

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np
import pytest
import torch

from mlsl_tpu.models import resnet as jres
from mlsl_tpu.models.train import _flatten_layer
from mlsl_tpu_torch.models import resnet as tres
from mlsl_tpu_torch.models.convert import (
    flatten_layer,
    params_from_jax,
    params_to_jax,
    tree_leaves,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    jp = jres.init_resnet50(jax.random.PRNGKey(0), num_classes=10)
    host = jax.tree.map(np.asarray, jp)
    model = tres.ResNet50(num_classes=10, device="cpu", params=params_from_jax(host, device="cpu"))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = np.array([3, 7], np.int32)
    return jp, host, model, x, y


def test_layer_names_and_counts_match(pair):
    jp, _, model, _, _ = pair
    assert tres.layer_names(model) == jres.layer_names(jp)
    assert len(tres.layer_names(model)) == 18
    assert tres.layer_param_counts(model) == jres.layer_param_counts(jp)
    full = tres.ResNet50(num_classes=1000, device="meta")
    assert tres.layer_param_counts(full)["fc"] == 2048 * 1000 + 1000
    assert sum(tres.layer_param_counts(full).values()) == 25_557_032


def test_flat_layer_layout_is_jax_order(pair):
    jp, host, model, _, _ = pair
    back = params_to_jax(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for name in tres.layer_names(model):
        want = np.asarray(_flatten_layer(jres.layer_subtree(jp, name)))
        got = flatten_layer(tres.layer_subtree(model, name)).detach().numpy()
        np.testing.assert_array_equal(got, want)
    # leaf order within a bottleneck: dict keys sorted, bias before scale
    leaves = tree_leaves(tres.layer_subtree(model, "stage0.0"))
    assert leaves[0] is model.stages[0][0].bn1.bias
    assert leaves[1] is model.stages[0][0].bn1.scale


def _jax_blocks(jp, x):
    """The JAX forward cut at the layer boundaries: -> [(name, input, output)],
    activations bf16 NHWC, the fc's input f32."""
    h = jnp.asarray(x).astype(jnp.bfloat16)
    out = []
    c = jres._conv(h, jp["stem"]["conv"], 2)
    y = lax.reduce_window(jax.nn.relu(jres._bn(c, jp["stem"]["bn"])), -jnp.inf, lax.max,
                          (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    out.append(("stem", h, y))
    h = y
    for si, blocks in enumerate(jres.STAGES):
        for bi in range(blocks):
            y = jres._bottleneck(h, jp[f"stage{si}"][bi], 2 if (bi == 0 and si > 0) else 1)
            out.append((f"stage{si}.{bi}", h, y))
            h = y
    h = jnp.mean(h.astype(jnp.float32), axis=(1, 2))
    out.append(("fc", h, h @ jp["fc"]["w"] + jp["fc"]["b"]))
    return out


def _port_block(model, name, x):
    if name == "stem":
        return model.stem(x)
    if name == "fc":
        return model.fc(x)
    si, bi = (int(v) for v in name[len("stage"):].split("."))
    return model.stages[si][bi](x, 2 if (bi == 0 and si > 0) else 1)


def _to_torch(a):
    t = torch.from_numpy(np.asarray(a.astype(jnp.float32)))
    return t.to(torch.bfloat16).permute(0, 3, 1, 2) if t.dim() == 4 else t


def _to_np(t):
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def test_every_layer_matches_jax_on_the_same_input(pair):
    """Each of the 18 layers, fed JAX's own input activation, gives JAX's
    output within one bfloat16 rounding step of the output's magnitude
    (2**-7 relative): the two frameworks round to bf16 at other points."""
    jp, _, model, x, _ = pair
    for name, hin, hout in _jax_blocks(jp, x):
        with torch.no_grad():
            got = _to_np(_port_block(model, name, _to_torch(hin)))
        want = np.asarray(hout.astype(jnp.float32))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=np.abs(want).max() * 2.0 ** -7,
                                   err_msg=name)


def test_logits_and_loss_within_jax_own_sensitivity(pair):
    """End to end, at random init and batch norm over 2 samples, bf16
    rounding is amplified layer by layer: JAX's own logits move by O(1)
    under a 1e-3 relative perturbation of the input. The stated bound is
    that the port is no farther from JAX than JAX is from itself under the
    largest of three such perturbations. The loss then lies within twice that
    distance of JAX's (the gradient of the cross entropy by the logits has an
    L1 norm of at most 2), and it is JAX's cross entropy of the port's logits
    to 1e-6."""
    jp, _, model, x, y = pair
    want = np.asarray(jres.apply_resnet50(jp, jnp.asarray(x)))
    jl = float(jres.loss_fn(jp, (jnp.asarray(x), jnp.asarray(y))))
    d_logits = 0.0
    for seed in (1, 2, 3):
        noise = np.random.default_rng(seed).normal(size=x.shape).astype(np.float32)
        xs = jnp.asarray(x * (1 + 1e-3 * noise))
        d_logits = max(d_logits, np.abs(np.asarray(jres.apply_resnet50(jp, xs)) - want).max())
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        tl = float(tres.cross_entropy(got, torch.from_numpy(y)))
        assert tl == float(tres.loss_fn(model, (torch.from_numpy(x), torch.from_numpy(y))))
    got = got.numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= d_logits
    assert abs(tl - jl) <= 2 * np.abs(got - want).max()
    logp = jax.nn.log_softmax(jnp.asarray(got))
    ce = -float(jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1)))
    assert abs(tl - ce) < 1e-6


@pytest.mark.parametrize("name", ["stem", "stage0.0", "stage1.0", "stage2.3", "fc"])
def test_layer_gradient_layout_matches_jax(pair, name):
    """A layer's flat gradient, in the order the trainer hands it to the
    codec, against JAX's ``_flatten_layer`` of its gradient on the same
    input: relative L2 error under 2e-2 (bf16 backward). A leaf out of order
    would give an error of order 1."""
    jp, _, model, x, _ = pair
    (hin, hout), = [(i, o) for n, i, o in _jax_blocks(jp, x) if n == name]
    r = np.random.default_rng(7).normal(size=np.shape(hout)).astype(np.float32)
    sub = jres.layer_subtree(jp, name)

    def jloss(p):
        if name == "fc":
            o = hin @ p["w"] + p["b"]
        elif name == "stem":
            c = jres._conv(hin, p["conv"], 2)
            o = lax.reduce_window(jax.nn.relu(jres._bn(c, p["bn"])), -jnp.inf, lax.max,
                                  (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
        else:
            si, bi = (int(v) for v in name[len("stage"):].split("."))
            o = jres._bottleneck(hin, p, 2 if (bi == 0 and si > 0) else 1)
        return jnp.sum(o.astype(jnp.float32) * r)

    want = np.asarray(_flatten_layer(jax.grad(jloss)(sub)))
    leaves = tree_leaves(tres.layer_subtree(model, name))
    out = _port_block(model, name, _to_torch(hin))
    rt = torch.from_numpy(r)
    if out.dim() == 4:
        rt = rt.permute(0, 3, 1, 2)
    gs = torch.autograd.grad((out.float() * rt).sum(), leaves)
    got = torch.cat([g.reshape(-1) for g in gs]).numpy()
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


def test_same_padding_is_asymmetric():
    assert tres._same_pad(224, 7, 2) == (2, 3)
    assert tres._same_pad(56, 3, 2) == (0, 1)
    assert tres._same_pad(112, 3, 2) == (0, 1)
    assert tres._same_pad(56, 3, 1) == (1, 1)
    assert tres._same_pad(56, 1, 1) == (0, 0)
