"""The port's all-to-all (the ``alltoall`` collective and request, and the
``pallas_a2a`` lowering on kernel B6, mlsl_tpu_torch.ops.a2a_kernels)
against the JAX package's, whose kernel runs here under the Pallas
interpreter (MLSL_PALLAS_INTERPRET=1, as tests/test_pallas_a2a.py arms it).

- The ``lax`` exchange (collective, engine build and a Distribution request)
  is bit-exact on (8, 1) and (4, 2) worlds, single- and multi-axis groups;
  the in-graph ``algos.inline_alltoall`` / ``inline_allgather`` equal
  ``lax.all_to_all`` / ``lax.all_gather`` in the MoE layout.
- B6's plain version: the dense variant bit-exact on random floats (an
  all-to-all is a permutation); the int8 variant bit-exact on the
  exact-scale payload (a +-127 sentinel at every block start keeps every
  scale 1.0); the stateful error-feedback form over 2 rounds, output and
  residual, bit-exact against the JAX program run in a subprocess with XLA's
  division rewrite and FMA contraction off (tests/test_torch_quant_ring.py
  says why).
- Selection: forced and tuned ``pallas_a2a``, a global ``MLSL_ALGO=rhd``
  that leaves the exchange on ``lax``, the codec toggle and its profile
  knob, eligibility on ragged counts and groups without axes.

B6 against its plain version on the card: mlsl_tpu_torch/cuda_tests/
(jax-free, so that it runs on the card's machine).
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from mlsl_tpu.comm import algos as jalgos
from mlsl_tpu.comm.mesh import ProcessGroup as JGroup, Topology as JTopo
from mlsl_tpu.config import Config as JConfig
from mlsl_tpu.ops import a2a_kernels as ja2a
from mlsl_tpu.tuner.profile import TunedProfile as JProfile
from mlsl_tpu.types import CompressionType as JComp
from mlsl_tpu_torch import sysinfo
from mlsl_tpu_torch.comm import algos as talgos
from mlsl_tpu_torch.comm import collectives as tcoll
from mlsl_tpu_torch.comm.mesh import ProcessGroup as TGroup, Topology as TTopo
from mlsl_tpu_torch.config import Config as TConfig
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.ops import a2a_kernels as ta2a
from mlsl_tpu_torch.tuner import TunedProfile as TProfile
from mlsl_tpu_torch.types import CompressionType, DataType, GroupType

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BLOCK = 128
UNIT = BLOCK * 32           # the int8 chunk unit (block x ROW_TILE)


@pytest.fixture(autouse=True)
def _interpret_gate(monkeypatch):
    monkeypatch.setenv("MLSL_PALLAS_INTERPRET", "1")


def _groups(d, m, axes):
    return JGroup(JTopo(d, m), axes), TGroup(TTopo(d, m, 8), axes)


def _jax_run(fn, jg, x):
    return np.asarray(fn(jg.topology.shard_buffer(x)))


def _exact_scale(rng, grid, count, block=BLOCK):
    """Integers with a +-127 sentinel at every block start: every blockwise
    amax is 127 and every scale exactly 1.0, so the int8 round trip is the
    identity (tests/test_pallas_a2a.py:58-65)."""
    v = rng.integers(-10, 10, size=(*grid, count)).astype(np.float32)
    v[..., ::block] = 127.0
    v[..., block::4 * block] = -127.0
    return v


# -- the lax exchange: collective, engine build, request --------------------------

LAX_CASES = [(8, 1, ("data",), 8 * 37), (4, 2, ("data",), 4 * 50), (4, 2, ("model",), 2 * 33),
             (4, 2, ("data", "model"), 8 * 21), (2, 4, ("model", "data"), 8 * 5),
             (8, 1, ("replica", "data", "seq", "model"), 8 * 3), (8, 1, (), 17)]


@pytest.mark.parametrize("d,m,axes,count", LAX_CASES, ids=lambda v: str(v))
def test_lax_alltoall_bit_exact_vs_jax(d, m, axes, count):
    jg, tg = _groups(d, m, axes)
    g = tg.size
    rng = np.random.default_rng(count)
    for dtype in ("float32", "int32"):
        x = (rng.normal(size=(*tg.topology.grid_shape, count)) * 100).astype(dtype)
        want = _jax_run(jalgos.build("alltoall", jg, np.dtype(dtype), "lax",
                                     send_count=count // g), jg, x)
        got = talgos.build("alltoall", tg, "lax", send_count=count // g)(torch.from_numpy(x))
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tcoll.build_collective("alltoall", tg, send_count=count // g)(
                torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("d,m,gt", [(8, 1, GroupType.DATA), (4, 2, GroupType.MODEL),
                                    (4, 2, GroupType.GLOBAL)])
def test_distribution_all_to_all_request(d, m, gt):
    """Distribution.all_to_all through a CommRequest: the count is the
    per-member send count, the buffer holds G of them."""
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        dist = env.create_distribution(d, m)
        g = dist._group(gt).size
        sc = 40
        buf = dist.make_buffer(lambda p: p * 1000.0 + np.arange(g * sc), g * sc)
        req = dist.all_to_all(buf, sc, DataType.FLOAT, gt)
        out = env.wait(req)
        assert req.algo == "lax"
        axes = dist._group(gt).axes
        jg = JGroup(JTopo(d, m), axes)
        want = _jax_run(jalgos.build("alltoall", jg, np.float32, "lax", send_count=sc), jg,
                        buf.numpy())
        np.testing.assert_array_equal(out.numpy(), want)
        # member j of rank p's group holds chunk j of every member, in order
        row = dist._group(gt).member_table()[0]
        for j, p in enumerate(row):
            got = dist.local_part(out, p).reshape(g, sc)
            for i, q in enumerate(row):
                np.testing.assert_array_equal(got[i], q * 1000.0 + np.arange(j * sc, (j + 1) * sc))
    finally:
        env.finalize()


def test_alltoallv_is_not_ported():
    """alltoallv is ported now, and built only from its count matrices
    (``request.normalize_alltoallv``): a bare build still raises MLSLError.
    tests/test_torch_colors.py holds it against the JAX package."""
    _, tg = _groups(8, 1, ("data",))
    with pytest.raises(MLSLError, match="count matrices"):
        tcoll.build_collective("alltoallv", tg)


# (split_axis, concat_axis, tiled) over local dims (G, G, 5) untiled, (2G, 3G, 5) tiled
# (d, m, group axes, trailing local dims) of the MoE layout: a leading local
# dim of G chunks, split = concat = 0, untiled
INLINE_CASES = [(4, 2, ("data",), (5,)), (4, 2, ("model",), (3, 2)), (8, 1, ("data",), (6,)),
                (4, 2, ("data", "model"), (5,)), (2, 4, ("model",), (4,)),
                (2, 4, ("data",), (2, 3)), (4, 2, ("model",), ())]
# (d, m, group axes, local dims) of the tiled gather along the first local dim
GATHER_CASES = [(4, 2, ("model",), (3, 4)), (4, 2, ("data",), (3, 4)), (8, 1, ("data",), (2,)),
                (2, 4, ("model",), (5, 2, 3))]


def _jax_inline(jg, x, fn):
    """fn(local block) inside smap over the JAX topology's mesh: x (*grid,
    *local) -> the per-rank results stacked the same way."""
    import jax
    from jax.sharding import PartitionSpec as P

    from mlsl_tpu.comm.collectives import smap
    from mlsl_tpu.comm.mesh import GRID_AXES

    lead = (1,) * len(GRID_AXES)

    def body(b):
        y = fn(b.reshape(b.shape[len(lead):]))
        return y.reshape(*lead, *y.shape)

    spec = P(*GRID_AXES)
    return np.asarray(jax.jit(smap(body, jg.topology.mesh, in_specs=(spec,), out_specs=spec))(
        jg.topology.shard_buffer(x)))


@pytest.mark.parametrize("d,m,axes,rest", INLINE_CASES, ids=lambda v: str(v))
def test_inline_alltoall_matches_lax(d, m, axes, rest):
    """algos.inline_alltoall without a config is lax.all_to_all over the
    group's axes in the MoE layout."""
    jg, tg = _groups(d, m, axes)
    x = np.random.default_rng(d * 10 + len(rest)).normal(
        size=(*tg.topology.grid_shape, tg.size, *rest)).astype(np.float32)
    want = _jax_inline(jg, x, lambda b: jalgos.inline_alltoall(b, axes))
    got = talgos.inline_alltoall(torch.from_numpy(x), tg)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,m,axes,local", GATHER_CASES, ids=lambda v: str(v))
def test_inline_allgather_matches_lax(d, m, axes, local):
    jg, tg = _groups(d, m, axes)
    x = np.random.default_rng(len(local)).normal(
        size=(*tg.topology.grid_shape, *local)).astype(np.float32)
    want = _jax_inline(jg, x, lambda b: jalgos.inline_allgather(b, axes, gather_axis=0,
                                                                 tiled=True))
    got = talgos.inline_allgather(torch.from_numpy(x), tg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_inline_allgather_fused_ring_route_refuses_what_b3_ag_cannot_take():
    """Where the config's table sends the group's reduce_scatter to the fused
    ring, the gather is B3-AG (its plain version on the CPU), bit for bit the
    plain gather; a tensor that needs a gradient, or of a type the kernel does
    not take, raises MLSLError on that route instead of taking the plain
    gather."""
    _, tg = _groups(8, 1, ("data",))
    config = TConfig()
    config._forced_algos = {"reduce_scatter": "pallas_ring"}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(*tg.topology.grid_shape, 6)).astype(np.float32))
    np.testing.assert_array_equal(talgos.inline_allgather(x, tg, config=config).numpy(),
                                  talgos.inline_allgather(x, tg).numpy())
    with pytest.raises(MLSLError, match="no gradient"):
        talgos.inline_allgather(x.clone().requires_grad_(), tg, config=config)
    with pytest.raises(MLSLError, match="float64"):
        talgos.inline_allgather(x.double(), tg, config=config)


# -- B6's plain version against the JAX kernel ---------------------------------------

# (d, m, axes, count per rank): padding where rc is not a chunk unit
DENSE_CASES = [(8, 1, ("data",), 8 * 640), (4, 2, ("data",), 4 * 512), (4, 2, ("model",), 2 * 512),
               (4, 2, ("data", "model"), 8 * 300 + 8 * 3)]
QUANT_CASES = [(8, 1, ("data",), 8 * UNIT, 128), (4, 2, ("model",), 2 * 3 * BLOCK, 128),
               (4, 2, ("data",), 4 * UNIT, 256), (4, 2, ("data", "model"), 8 * 2 * BLOCK, 128)]


@pytest.mark.parametrize("d,m,axes,count", DENSE_CASES, ids=lambda v: str(v))
def test_dense_pallas_a2a_bit_exact_vs_jax(d, m, axes, count):
    jg, tg = _groups(d, m, axes)
    rng = np.random.default_rng(count + 1)
    x = rng.normal(size=(*tg.topology.grid_shape, count)).astype(np.float32)
    want = _jax_run(jalgos.build("alltoall", jg, np.float32, "pallas_a2a", block=BLOCK,
                                 quantized=False), jg, x)
    got = talgos.build("alltoall", tg, "pallas_a2a", block=BLOCK, quantized=False)(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    lax = talgos.build("alltoall", tg, "lax", send_count=count // tg.size)(torch.from_numpy(x))
    assert torch.equal(got, lax)


@pytest.mark.parametrize("d,m,axes,count,block", QUANT_CASES, ids=lambda v: str(v))
def test_int8_pallas_a2a_exact_scale_bit_exact_vs_jax(d, m, axes, count, block):
    jg, tg = _groups(d, m, axes)
    x = _exact_scale(np.random.default_rng(count), tg.topology.grid_shape, count, block)
    want = _jax_run(jalgos.build("alltoall", jg, np.float32, "pallas_a2a", block=block,
                                 quantized=True), jg, x)
    got = talgos.build("alltoall", tg, "pallas_a2a", block=block, quantized=True)(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _jax_run(jalgos.build(
        "alltoall", jg, np.float32, "lax", send_count=count // tg.size), jg, x))


EF_CASES = [("ef_g8", 8, 1, ("data",), 8 * UNIT, 128), ("ef_g2", 4, 2, ("model",), 2 * 3 * 256, 256),
            ("ef_g4x2", 4, 2, ("data", "model"), 8 * 1000, 128)]
ROUNDS = 2


def _ef_inputs(name, grid, count):
    rng = np.random.default_rng(sum(map(ord, name)))
    base = rng.normal(size=(*grid, count)) * rng.uniform(0.1, 10, size=(*grid, 1))
    base[..., ::7] = -0.0
    base[..., : min(count, 3 * 256)] = 0.0                 # all-zero blocks: scale 1
    return [(base * (1.0 + 0.5 * r)).astype(np.float32) for r in range(ROUNDS)]


_JAX_EXACT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from tests.test_torch_a2a import EF_CASES, _ef_inputs
from mlsl_tpu.comm import algos
from mlsl_tpu.comm.mesh import ProcessGroup, Topology
from mlsl_tpu.ops import a2a_kernels
out = {}
for name, d, m, axes, count, block in EF_CASES:
    topo = Topology(d, m)
    g = ProcessGroup(topo, axes)
    fn = algos.build("alltoall", g, np.float32, "pallas_a2a", block=block, quantized=True,
                     ef=True)
    _, chunk, _ = a2a_kernels.geometry(g.size, count, block, True)
    err = np.zeros((*topo.grid_shape, g.size * chunk), np.float32)
    for r, x in enumerate(_ef_inputs(name, topo.grid_shape, count)):
        res, err = fn(topo.shard_buffer(x), topo.shard_buffer(err))
        out[f"{name}/{r}/res"] = np.asarray(res)
        out[f"{name}/{r}/err"] = err = np.asarray(err)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_exact(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_exact") / "a2a.npz"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["MLSL_PALLAS_INTERPRET"] = "1"
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_EXACT, str(ROOT), str(path)],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _port_ef_rounds(name, d, m, axes, count, block, plain=False, device="cpu"):
    _, tg = _groups(d, m, axes)
    fn = talgos.build("alltoall", tg, "pallas_a2a", block=block, quantized=True, ef=True,
                      plain=plain)
    _, el = ta2a.alltoall_body_ef(tg, count, block=block)
    err = torch.zeros((*tg.topology.grid_shape, el), device=device)
    outs = []
    for x in _ef_inputs(name, tg.topology.grid_shape, count):
        res, err = fn(torch.from_numpy(x).to(device), err)
        outs.append((res, err))
    return outs, el


@pytest.mark.parametrize("name,d,m,axes,count,block", EF_CASES, ids=[c[0] for c in EF_CASES])
def test_int8_error_feedback_two_rounds_bit_exact_vs_jax(jax_exact, name, d, m, axes, count,
                                                         block):
    outs, el = _port_ef_rounds(name, d, m, axes, count, block)
    g = _groups(d, m, axes)[1].size
    assert el == g * ja2a.geometry(g, count, block, True)[1]
    for r, (res, err) in enumerate(outs):
        np.testing.assert_array_equal(res.numpy(), jax_exact[f"{name}/{r}/res"],
                                      err_msg=f"round {r}")
        np.testing.assert_array_equal(err.numpy(), jax_exact[f"{name}/{r}/err"],
                                      err_msg=f"round {r}")
        assert not np.signbit(res.numpy()[res.numpy() == 0]).any()


# -- geometry, eligibility and selection ---------------------------------------------

GROUPS = [(8, 1, ("data",)), (4, 2, ("data",)), (4, 2, ("model",)), (4, 2, ("data", "model")),
          (8, 1, ("replica", "data", "seq", "model")), (1, 8, ()), (8, 1, ("model",))]


@pytest.mark.parametrize("d,m,axes", GROUPS, ids=lambda v: str(v))
def test_eligibility_and_geometry_match_jax(d, m, axes):
    jg, tg = _groups(d, m, axes)
    g = tg.size
    for count in (None, 8 * 100, 8 * 100 + 3, g * 4096, g * 5000):
        assert ta2a.eligible("alltoall", tg, count) == ja2a.eligible("alltoall", jg, count)
    for kind in ("alltoall", "allreduce", "reduce_scatter"):
        assert talgos.candidates(kind, tg) == jalgos.candidates(kind, jg), kind
        for algo in talgos.ALGORITHMS:
            assert talgos.eligible(algo, kind, tg) == jalgos.eligible(algo, kind, jg), algo
    if g > 1:
        for count in (g * 100, g * UNIT, g * (3 * UNIT + 5), g * 2_097_152):
            for block, quantized in ((128, True), (256, True), (1024, True), (256, False)):
                args = (g, count, block, quantized)
                assert ta2a.geometry(*args) == ja2a.geometry(*args)
                assert ta2a.wire_bytes(*args) == ja2a.wire_bytes(*args)
                assert ta2a.describe_plan(*args) == \
                    ja2a.describe_plan(*args, 2).rsplit(" slots=", 1)[0]
        with pytest.raises(MLSLError):
            ta2a.geometry(g, g * 10 + 1, 128, True)


def test_eligibility_rejects_ops_color_groups_and_ragged_counts():
    _, tg = _groups(8, 1, ("data",))
    assert not ta2a.eligible("alltoall", tg, op=0)
    assert not ta2a.eligible("alltoall", tg, count=8 * 100 + 3)
    assert ta2a.eligible("alltoall", tg, count=8 * 100)
    # the port has no color groups; a group that carries colors is refused as
    # JAX refuses one
    colored = types.SimpleNamespace(colors=(0, 0, 1, 1), axes=(), is_uniform=True, size=2)
    assert not ta2a.eligible("alltoall", colored)
    jcol = JGroup(JTopo(8, 1), (), colors=(0, 0, 0, 0, 1, 1, 1, 1))
    assert not ja2a.eligible("alltoall", jcol)
    with pytest.raises(MLSLError, match="pallas_a2a"):
        talgos.build("alltoall", tg, "pallas_a2a")(torch.zeros(1, 8, 1, 1, 8 * 100 + 3))


FORCED = ("", "lax", "rhd", "pallas_ring", "pallas_a2a", "alltoall=pallas_a2a", "alltoall=lax",
          "allreduce=pallas_rhd,alltoall=pallas_a2a")
CELLS = [
    {"kind": "alltoall", "shape": [8], "compression": "none", "max_bytes": None,
     "algo": "pallas_a2a"},
    {"kind": "alltoall", "shape": [4], "compression": "none", "max_bytes": 8192, "algo": "lax"},
    {"kind": "alltoall", "shape": [4], "compression": "none", "max_bytes": None,
     "algo": "pallas_a2a"},
    {"kind": "allreduce", "shape": [8], "compression": "none", "max_bytes": None,
     "algo": "pallas_a2a"},
]


@pytest.mark.parametrize("forced", FORCED)
@pytest.mark.parametrize("tuned", [False, True], ids=["untuned", "tuned"])
def test_select_matches_jax(forced, tuned):
    jc, tc = JConfig(), TConfig()
    jc._forced_algos = jalgos.parse_forced(forced)
    tc._forced_algos = talgos.parse_forced(forced)
    assert tc._forced_algos == jc._forced_algos
    if tuned:
        jc.tuned_profile = JProfile(fingerprint={}, cells=CELLS)
        tc.tuned_profile = TProfile(fingerprint={}, cells=CELLS)
    for d, m, axes in GROUPS:
        jg, tg = _groups(d, m, axes)
        for kind in ("alltoall", "allreduce"):
            for payload in (4096, 8192, 8196, 1 << 20):
                want = jalgos.select(kind, jg, payload, JComp.NONE, jc)
                got = talgos.select(kind, tg, payload, CompressionType.NONE, tc)
                assert got == want, (forced, tuned, axes, kind, payload)
                if kind == "alltoall":
                    assert got in ("lax", "pallas_a2a")


def test_quant_toggle_and_profile_knob(tmp_path, monkeypatch):
    cfg = TConfig()
    assert cfg.pallas_a2a_quant and cfg.pallas_a2a_quant == JConfig().pallas_a2a_quant
    for v, want in (("0", False), ("off", False), ("1", True), ("", True)):
        monkeypatch.setenv("MLSL_PALLAS_A2A_QUANT", v)
        assert TConfig.from_env().pallas_a2a_quant == ja2a.quant_enabled(None) == want
        assert JConfig.from_env().pallas_a2a_quant == want
    monkeypatch.delenv("MLSL_PALLAS_A2A_QUANT")
    # a profile carries the codec as a 0/1 knob and an alltoall cell
    fp = sysinfo.topology_fingerprint(8, torch.device("cpu"))
    path = tmp_path / "p.json"
    path.write_text(json.dumps({"version": 1, "fingerprint": fp, "created": "",
                                "cells": CELLS[:1], "knobs": {"pallas_a2a_quant": 0}}))
    monkeypatch.setenv("MLSL_TUNE_PROFILE", str(path))
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert not env.config.pallas_a2a_quant
        dist = env.create_distribution(8, 1)
        x = dist.make_buffer(lambda p: np.random.default_rng(p).normal(size=8 * 64), 8 * 64)
        req = dist.all_to_all(x, 64, DataType.FLOAT, GroupType.DATA)
        out = env.wait(req)
        assert req.algo == "pallas_a2a"
        # the dense variant: a permutation, equal to the lax exchange
        assert torch.equal(out, tcoll.build_collective("alltoall", dist.data_group,
                                                       send_count=64)(x))
    finally:
        env.finalize()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1, "fingerprint": fp, "cells": [],
                               "knobs": {"pallas_a2a_quant": True}}))
    monkeypatch.setenv("MLSL_TUNE_PROFILE", str(bad))
    with pytest.raises(MLSLError, match="invalid knob"):
        Environment.get_env().init(device="cpu", world_size=8)
    # an exported toggle beats the profile
    monkeypatch.setenv("MLSL_TUNE_PROFILE", str(path))
    monkeypatch.setenv("MLSL_PALLAS_A2A_QUANT", "1")
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert env.config.pallas_a2a_quant
    finally:
        env.finalize()


@pytest.mark.parametrize("spec,quant,want", [("alltoall=pallas_a2a", "1", "pallas_a2a"),
                                             ("alltoall=pallas_a2a", "0", "pallas_a2a"),
                                             ("rhd", "1", "lax")])
def test_forced_request_runs_the_kernel_route(monkeypatch, spec, quant, want):
    """MLSL_ALGO reaches a Distribution.all_to_all request; the int8 route
    on the exact-scale payload and the dense route on random floats equal
    the lax exchange bit for bit, and a global reduction algorithm never
    claims the exchange."""
    monkeypatch.setenv("MLSL_ALGO", spec)
    monkeypatch.setenv("MLSL_PALLAS_A2A_QUANT", quant)
    monkeypatch.setenv("MLSL_QUANT_BLOCK_ELEMS", str(BLOCK))
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        dist = env.create_distribution(4, 2)
        for gt in (GroupType.DATA, GroupType.MODEL, GroupType.GLOBAL):
            group = dist._group(gt)
            sc = UNIT
            rng = np.random.default_rng(int(gt))
            x = torch.from_numpy(_exact_scale(rng, dist.world_shape, group.size * sc)
                                 if quant == "1" else
                                 rng.normal(size=(*dist.world_shape, group.size * sc))
                                 .astype(np.float32))
            req = dist.all_to_all(x, sc, DataType.FLOAT, gt)
            out = env.wait(req)
            assert req.algo == want
            assert torch.equal(out, tcoll.build_collective("alltoall", group, send_count=sc)(x))
    finally:
        env.finalize()
