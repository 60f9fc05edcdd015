"""The port's two-tier ``hier`` lowering (mlsl_tpu_torch.comm.algos.hier and its
places in the selection table, quant_ring, the codecs, CommRequest and the
overlap engine) against the JAX package's, on the 8-rank world split by
``MLSL_MESH_TIERS`` (the cases of tests/test_hier.py that need no pipeline,
verify, elastic or breaker).

Tolerances:

- integer-valued payloads make every summation order exact: dense ``hier``
  and the int8 hop are bit for bit against JAX's ``hier`` and the port's
  ``lax``, and the sentinel payload's int8 sum is the true sum, equal to the
  flat ring's, with a zero residual;
- random float32 payloads through the compressed wire, every DCN codec, two
  rounds: bit for bit, outputs and residuals, against JAX run in a subprocess
  with ``--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX`` (the two XLA
  rewrites tests/test_torch_quant_ring.py explains); against JAX as it runs
  by default, within one quantization step (max|x|/127 of the result);
- dense float payloads: within rtol 1e-6 of JAX's ``hier``.

JAX cases with no counterpart here: the topologies over a subset of the
devices (the port's world is one topology's virtual ranks), the breaker's
degrade (ROADMAP A.7; the port's flush runs through ``demote_codec``, held
here to the same oracle), the plan verifier's A112/A114/A120/A121 and DCN
budget (ROADMAP A.7), and the pipeline composition (ROADMAP A.5).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.comm import algos as jalgos
from mlsl_tpu.comm import collectives as jcoll
from mlsl_tpu.comm import overlap as jov
from mlsl_tpu.comm import quant_ring as jqr
from mlsl_tpu.comm.algos import hier as jhier
from mlsl_tpu.comm.mesh import ProcessGroup as JGroup, Topology as JTopo
from mlsl_tpu.comm.mesh import parse_mesh_tiers as jparse, world_tiers as jworld_tiers
from mlsl_tpu.config import Config as JConfig
from mlsl_tpu.core.environment import Environment as JEnv
from mlsl_tpu.models.mlp import LAYERS, get_layer as jget_layer, init as mlp_init
from mlsl_tpu.models.mlp import loss_fn as jmlp_loss
from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
from mlsl_tpu.tuner.profile import TunedProfile as JProfile, load_profile as jload
from mlsl_tpu.types import CompressionType as JComp, ReductionType as JRed
from mlsl_tpu_torch import codecs, sysinfo
from mlsl_tpu_torch.comm import algos as talgos
from mlsl_tpu_torch.comm import overlap as tov
from mlsl_tpu_torch.comm import quant_ring as tqr
from mlsl_tpu_torch.comm.algos import hier as thier
from mlsl_tpu_torch.comm.mesh import ProcessGroup as TGroup, Topology as TTopo
from mlsl_tpu_torch.comm.mesh import parse_mesh_tiers, world_tier_ids, world_tiers
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import mlp as tmlp
from mlsl_tpu_torch.models.convert import params_from_jax, params_to_jax
from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer
from mlsl_tpu_torch.tuner import TunedProfile, load_profile
from mlsl_tpu_torch.types import CompressionType, DataType, ReductionType

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SPLITS = ["2x4", "4x2", "1x8", "8x1"]
SUM = ReductionType.SUM
Q = CompressionType.QUANTIZATION


@pytest.fixture()
def tiers24(monkeypatch):
    monkeypatch.setenv("MLSL_MESH_TIERS", "2x4")
    jcoll.clear_cache()
    yield
    jcoll.clear_cache()


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _split(monkeypatch, spec):
    monkeypatch.setenv("MLSL_MESH_TIERS", spec)
    jcoll.clear_cache()      # JAX caches dense programs without the split in the key


def _groups(d=8, m=1, axes=("data",)):
    return JGroup(JTopo(d, m), axes), TGroup(TTopo(d, m, 8), axes)


def _int_vals(rng, grid, n, dtype=np.float32):
    return rng.integers(-8, 8, size=(*grid, n)).astype(dtype)


def _jrun(fn, jg, x):
    return np.asarray(fn(jg.topology.shard_buffer(x)))


# -- tier structure ------------------------------------------------------------------


def test_parse_mesh_tiers_grammar():
    for spec in ("", "2x4", " 8X1 ", "1x8"):
        assert parse_mesh_tiers(spec) == jparse(spec)
    for bad in ("2x", "x4", "2x4x2", "axb", "0x8", "-1x8"):
        with pytest.raises(MLSLError):
            parse_mesh_tiers(bad)
        with pytest.raises(Exception):
            jparse(bad)


def test_config_validates_tier_knobs(monkeypatch):
    c, jc = Config(), JConfig()
    assert (c.mesh_tiers, c.hier_dcn_codec) == (jc.mesh_tiers, jc.hier_dcn_codec) == ("", "int8")
    c.mesh_tiers = "2x4"
    for codec in thier.DCN_CODECS:
        c.hier_dcn_codec = codec
        c.validate()
    c.hier_dcn_codec = "fp4"
    with pytest.raises(MLSLError, match="HIER_DCN_CODEC"):
        c.validate()
    c.hier_dcn_codec = "int8"
    c.mesh_tiers = "banana"
    with pytest.raises(MLSLError, match="MESH_TIERS"):
        c.validate()
    monkeypatch.setenv("MLSL_MESH_TIERS", "4x2")
    monkeypatch.setenv("MLSL_HIER_DCN_CODEC", "TopK")
    for cfg in (Config.from_env(), JConfig.from_env()):
        assert (cfg.mesh_tiers, cfg.hier_dcn_codec) == ("4x2", "topk")
        assert "hier_dcn_codec" in cfg._explicit
    assert thier.DCN_CODECS == jhier.DCN_CODECS
    assert thier.dcn_codec() == jhier.dcn_codec() == "topk"
    assert thier.dcn_codec("F32") == jhier.dcn_codec("F32") == "f32"


@pytest.mark.parametrize("spec", SPLITS)
def test_tier_structure_on_world_ring(monkeypatch, spec):
    _split(monkeypatch, spec)
    t, l = (int(p) for p in spec.split("x"))
    assert world_tiers(8) == jworld_tiers() == (t, l)
    assert world_tier_ids(8) == tuple(p // l for p in range(8))
    jg, tg = _groups()
    assert thier.tier_structure(tg) == jhier.tier_structure(jg) == (t, l)
    assert talgos.eligible("hier", "allreduce", tg, SUM)
    assert talgos.candidates("allreduce", tg, SUM)[-1] == "hier"
    for kind in ("allreduce", "reduce_scatter"):
        for op in (None, SUM, ReductionType.MAX):
            assert talgos.eligible("hier", kind, tg, op) == jalgos.eligible(
                "hier", kind, jg, None if op is None else JRed(int(op)))
    assert not talgos.eligible("hier", "alltoall", tg)


def test_tier_structure_none_without_tiers(monkeypatch):
    monkeypatch.delenv("MLSL_MESH_TIERS", raising=False)
    jg, tg = _groups()
    assert world_tiers(8) is None and jworld_tiers() is None
    assert thier.tier_structure(tg) is None and jhier.tier_structure(jg) is None
    assert not talgos.eligible("hier", "allreduce", tg, SUM)


def test_tier_structure_of_subgroup(tiers24):
    """A data group of the (4, 2) grid: members stride the world by 2, two a
    tier, a (2, 2) split; a model group sits inside one tier, (1, 2); the
    two-axis group has no single live axis."""
    for axes, want in ((("data",), (2, 2)), (("model",), (1, 2)), (("data", "model"), None)):
        jg, tg = _groups(4, 2, axes)
        assert thier.tier_structure(tg) == jhier.tier_structure(jg) == want, axes


def test_tier_structure_rejects_interleaved(monkeypatch):
    """Under 4x2 tiers the (4, 2) grid's data group meets a new tier at every
    member: (4, 1), each member its own tier; under 2x4 a model group sits
    inside one tier."""
    _split(monkeypatch, "4x2")
    jg, tg = _groups(4, 2, ("data",))
    assert thier.tier_structure(tg) == jhier.tier_structure(jg) == (4, 1)
    _split(monkeypatch, "2x4")
    jg, tg = _groups(4, 2, ("model",))
    assert thier.tier_structure(tg) == jhier.tier_structure(jg) == (1, 2)
    # a color group never has a tier structure
    cg = TGroup(TTopo(8, 1, 8), (), colors=(0, 0, 1, 1, 0, 0, 1, 1))
    assert thier.tier_structure(cg) is None


def test_tiers_must_cover_the_world(tiers24):
    """A world of 4 virtual ranks under 2x4 is a misconfiguration, as in the
    JAX package, where the split must cover the device world."""
    with pytest.raises(MLSLError, match="does not cover"):
        thier.tier_structure(TGroup(TTopo(4, 1, 4), ("data",)))


def test_fingerprint_carries_tiers(monkeypatch):
    from mlsl_tpu import sysinfo as jsysinfo

    for spec, want in (("2x4", [2, 4]), ("8x1", [8, 1]), ("", None)):
        _split(monkeypatch, spec)
        assert sysinfo.topology_fingerprint(8, torch.device("cpu"))["tiers"] == want
        assert jsysinfo.topology_fingerprint()["tiers"] == want


# -- dense parity ----------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPLITS)
@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter"])
def test_dense_parity_bitexact_across_splits(monkeypatch, spec, kind):
    """Integer payloads: the port's hier equals its lax and JAX's hier bit for
    bit; random floats: within rtol 1e-6 of JAX's hier."""
    _split(monkeypatch, spec)
    rng = np.random.default_rng(11)
    jg, tg = _groups()
    n = 1000
    kw = {"op": SUM}
    if kind == "reduce_scatter":
        n = -(-n // 8) * 8
        kw["recv_count"] = n // 8
    jkw = {**kw, "op": JRed.SUM}
    fh = talgos.build(kind, tg, "hier", **kw)
    jh = jalgos.build(kind, jg, np.float32, "hier", **jkw)
    x = _int_vals(rng, (1, 8, 1, 1), n)
    got = fh(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, talgos.build(kind, tg, "lax", **kw)(
        torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(got, _jrun(jh, jg, x))
    y = rng.normal(size=(1, 8, 1, 1, n)).astype(np.float32)
    np.testing.assert_allclose(fh(torch.from_numpy(y)).numpy(), _jrun(jh, jg, y), rtol=1e-6,
                               atol=1e-6 * np.abs(y).sum(axis=1).max())


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_dense_parity_dtypes(tiers24, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    jg, tg = _groups()
    x = _int_vals(rng, (1, 8, 1, 1), 256)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = x.astype(jnp.bfloat16 if dtype == "bfloat16" else dtype)
    got = talgos.build("allreduce", tg, "hier", op=SUM)(tx)
    assert got.dtype == tx.dtype
    assert torch.equal(got, talgos.build("allreduce", tg, "lax", op=SUM)(tx))
    want = _jrun(jalgos.build("allreduce", jg, jx.dtype, "hier", op=JRed.SUM), jg, jx)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_dense_parity_subgroup_grid(tiers24):
    """The (4, 2) grid's data groups (2 instances, a (2, 2) split each), and
    its model groups' degenerate (1, 2) split, per instance bit for bit."""
    rng = np.random.default_rng(13)
    for axes in (("data",), ("model",)):
        jg, tg = _groups(4, 2, axes)
        x = _int_vals(rng, (1, 4, 1, 2), 300)
        got = talgos.build("allreduce", tg, "hier", op=SUM)(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, talgos.build("allreduce", tg, "lax", op=SUM)(
            torch.from_numpy(x)).numpy())
        np.testing.assert_array_equal(
            got, _jrun(jalgos.build("allreduce", jg, np.float32, "hier", op=JRed.SUM), jg, x))
        prep, phases, finish = talgos.inline_plan("allreduce", tg, "hier", 300, op=SUM)
        carry = prep(torch.from_numpy(x))
        for ph in phases:
            carry = ph(carry)
        np.testing.assert_array_equal(finish(carry).numpy(), got)


# -- the compressed wire -----------------------------------------------------------------


def _sentinel_vals(rng, grid, n, block):
    """The same integers on every member with a +-127 sentinel at each block
    start: every scale is an exact integer, so both compressed wires deliver
    the exact integer sum (tests/test_hier.py:226-233)."""
    x = rng.integers(-8, 8, size=n).astype(np.float32)
    x[::block] = 127.0
    return np.broadcast_to(x, (*grid, n)).copy()


@pytest.mark.parametrize("spec", ["2x4", "4x2", "1x8"])
def test_quant_integer_sum_bitexact_vs_flat_ring(monkeypatch, spec):
    _split(monkeypatch, spec)
    rng = np.random.default_rng(14)
    jg, tg = _groups()
    n, block = 1024, 64
    x = _sentinel_vals(rng, (1, 8, 1, 1), n, block)
    want = x.sum(axis=(0, 1, 2, 3))
    fh, elh = tqr.build_quantized_collective("allreduce", tg, n, block, ring="hier")
    ff, elf = tqr.build_quantized_collective("allreduce", tg, n, block)
    out_h, err_h = fh(torch.from_numpy(x), torch.zeros(1, 8, 1, 1, elh))
    out_f, _ = ff(torch.from_numpy(x), torch.zeros(1, 8, 1, 1, elf))
    for p in range(8):
        np.testing.assert_array_equal(out_h[0, p, 0, 0].numpy(), want)
    assert torch.equal(out_h, out_f)
    assert float(err_h.abs().max()) == 0.0
    jf, jel = jqr.build_quantized_collective("allreduce", jg, n, block, ring="hier")
    assert jel == elh
    jo, je = jf(jg.topology.shard_buffer(x),
                jg.topology.shard_buffer(np.zeros((1, 8, 1, 1, jel), np.float32)))
    np.testing.assert_array_equal(out_h.numpy(), np.asarray(jo))


# (name, split, DCN codec, count, block): random float32, two rounds, top-k at 0.25
WIRE_CASES = [
    ("int8_2x4", "2x4", "int8", 1000, 64), ("int8_4x2", "4x2", "int8", 777, 256),
    ("int8_8x1", "8x1", "int8", 1000, 64), ("int8_1x8", "1x8", "int8", 600, 64),
    ("f32_2x4", "2x4", "f32", 700, 64), ("topk_2x4", "2x4", "topk", 700, 64),
    ("topk_4x2", "4x2", "topk", 513, 128), ("prune_2x4", "2x4", "prune", 700, 64),
    ("vq_2x4", "2x4", "vq", 700, 64), ("vq_4x2", "4x2", "vq", 640, 128),
]
ROUNDS = 2


def _wire_inputs(name, n):
    rng = np.random.default_rng(sum(map(ord, name)))
    return [(rng.normal(size=(1, 8, 1, 1, n)) * (1.0 + r) + 0.1 * r).astype(np.float32)
            for r in range(ROUNDS)]


_JAX_EXACT = r"""
import os, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from tests.test_torch_hier import WIRE_CASES, _wire_inputs
from mlsl_tpu.comm import collectives, quant_ring
from mlsl_tpu.comm.mesh import ProcessGroup, Topology
out = {}
for name, spec, codec, n, block in WIRE_CASES:
    os.environ["MLSL_MESH_TIERS"] = spec
    collectives.clear_cache()
    topo = Topology(8, 1)
    fn, el = quant_ring.build_quantized_collective(
        "allreduce", ProcessGroup(topo, ("data",)), n, block, ring="hier", dcn_codec=codec,
        topk_ratio=0.25)
    err = np.zeros((*topo.grid_shape, el), np.float32)
    for r, x in enumerate(_wire_inputs(name, n)):
        res, err = fn(topo.shard_buffer(x), topo.shard_buffer(err))
        out[f"{name}/{r}/res"] = np.asarray(res)
        out[f"{name}/{r}/err"] = err = np.asarray(err)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_exact(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_hier") / "wire.npz"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_EXACT, str(ROOT), str(path)],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _port_wire(name, spec, codec, n, block):
    tg = TGroup(TTopo(8, 1, 8), ("data",))
    fn, el = tqr.build_quantized_collective("allreduce", tg, n, block, ring="hier",
                                            dcn_codec=codec, topk_ratio=0.25)
    err = torch.zeros(1, 8, 1, 1, el)
    outs = []
    for x in _wire_inputs(name, n):
        res, err = fn(torch.from_numpy(x), err)
        outs.append((res.numpy(), err.numpy()))
    return outs, el


@pytest.mark.parametrize("name,spec,codec,n,block", WIRE_CASES, ids=[c[0] for c in WIRE_CASES])
def test_quant_wire_bit_exact_vs_jax(monkeypatch, jax_exact, name, spec, codec, n, block):
    """Every DCN codec (int8's shared-scale hop, f32, top-k's threshold form,
    and prune and vq through ``Codec.hier_aggregate``), two rounds, outputs
    and residuals bit for bit."""
    _split(monkeypatch, spec)
    outs, el = _port_wire(name, spec, codec, n, block)
    assert el == jhier.quant_geometry("allreduce", _groups()[0], n, block)[2]
    for r, (res, err) in enumerate(outs):
        np.testing.assert_array_equal(res, jax_exact[f"{name}/{r}/res"], err_msg=f"round {r}")
        np.testing.assert_array_equal(err, jax_exact[f"{name}/{r}/err"], err_msg=f"round {r}")


@pytest.mark.parametrize("name,spec,codec,n,block", WIRE_CASES[:4],
                         ids=[c[0] for c in WIRE_CASES[:4]])
def test_quant_wire_vs_default_jax_within_one_step(monkeypatch, name, spec, codec, n, block):
    _split(monkeypatch, spec)
    jg, _ = _groups()
    fn, jel = jqr.build_quantized_collective("allreduce", jg, n, block, ring="hier",
                                             dcn_codec=codec, topk_ratio=0.25)
    outs, _ = _port_wire(name, spec, codec, n, block)
    err = np.zeros((1, 8, 1, 1, jel), np.float32)
    for r, x in enumerate(_wire_inputs(name, n)):
        res, err = fn(jg.topology.shard_buffer(x), jg.topology.shard_buffer(err))
        res, err = np.asarray(res), np.asarray(err)
        step = np.abs(res).max() / 127.0
        np.testing.assert_allclose(outs[r][0], res, rtol=0, atol=step)
        np.testing.assert_allclose(outs[r][1], err, rtol=0, atol=step)


def test_quant_two_round_ef_lockstep(tiers24):
    """An independently built twin (``hier.quant_body``) gives the same
    outputs and residuals over two rounds, and round 2 differs from round 1
    (the residual is live)."""
    _, tg = _groups()
    n, block = 700, 64
    fn, el = tqr.build_quantized_collective("allreduce", tg, n, block, ring="hier")
    twin, el2 = thier.quant_body("allreduce", tg, n, block)
    assert el == el2
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(1, 8, 1, 1, n))
                         .astype(np.float32))
    a, ae = fn(x, torch.zeros(1, 8, 1, 1, el))
    b, be = twin(x, torch.zeros(1, 8, 1, 1, el))
    assert torch.equal(a, b) and torch.equal(ae, be)
    a2, a2e = fn(x, ae)
    b2, b2e = twin(x, be)
    assert torch.equal(a2, b2) and torch.equal(a2e, b2e)
    assert not torch.equal(a, a2)


def test_quant_f32_codec_matches_dense(tiers24):
    rng = np.random.default_rng(16)
    _, tg = _groups()
    n = 512
    x = torch.from_numpy(_int_vals(rng, (1, 8, 1, 1), n))
    fn, el = tqr.build_quantized_collective("allreduce", tg, n, 64, ring="hier",
                                            dcn_codec="f32")
    out, err = fn(x, torch.zeros(1, 8, 1, 1, el))
    assert torch.equal(out, talgos.build("allreduce", tg, "hier", op=SUM)(x))
    assert float(err.abs().max()) == 0.0


def test_quant_topk_codec_ef_accumulates(tiers24):
    """The kept coordinates sum exactly; the dropped mass rides the residual,
    and the average over 8 rounds approaches the true sum (the JAX test's
    bound)."""
    _, tg = _groups()
    n = 512
    vals = np.random.default_rng(17).normal(size=(1, 8, 1, 1, n)).astype(np.float32)
    want = vals.sum(axis=(0, 1, 2, 3))
    fn, el = tqr.build_quantized_collective("allreduce", tg, n, 64, ring="hier",
                                            dcn_codec="topk", topk_ratio=0.25)
    err = torch.zeros(1, 8, 1, 1, el)
    acc = np.zeros_like(want)
    for _ in range(8):
        out, err = fn(torch.from_numpy(vals), err)
        acc += out[0, 0, 0, 0].numpy()
    rel = np.linalg.norm(acc / 8 - want) / (np.linalg.norm(want) + 1e-9)
    assert rel < 0.35, rel


def test_topk_threshold_keeps_ties(tiers24):
    """Every element at or above the k-th magnitude is kept, so ties keep
    more than k (hier.py:367-375 of the JAX package)."""
    xq = torch.tensor([[[[3.0, -3.0, 1.0, 3.0, 0.5, 2.0, -0.25, 0.0]]]])
    red, err = thier._topk_shared(xq, 0.25)        # k = 2, threshold 3
    assert torch.equal(red, torch.tensor([[[[3.0, -3.0, 0.0, 3.0, 0.0, 0.0, 0.0, 0.0]]]]))
    assert torch.equal(red + err, xq)


def test_quant_geometry_block_alignment(tiers24):
    jg, tg = _groups()
    for n in (64, 100, 1000, 4096, 4097):
        for block in (64, 256):
            got = thier.quant_geometry("allreduce", tg, n, block)
            assert got == jhier.quant_geometry("allreduce", jg, n, block)
            _, slen, el, (t, l) = got
            assert slen % block == 0 and slen * l >= n and el == slen
    with pytest.raises(MLSLError, match="allreduce only"):
        thier.quant_geometry("reduce_scatter", tg, 1024, 64)
    np.testing.assert_array_equal(thier.intra_positions(tg), jhier.intra_positions(jg))


def test_dcn_cost_model_matches_jax():
    for codec in ("int8", "f32", "topk", "vq", "prune", "none"):
        for tiers in ((2, 4), (4, 2), (1, 8), (8, 1)):
            for n in (1000, 1 << 20):
                assert thier.dcn_wire_bytes(n, tiers, codec, 256) == \
                    jhier.dcn_wire_bytes(n, tiers, codec, 256)
            assert thier.dcn_phases(tiers, codec) == jhier.dcn_phases(tiers, codec)


@pytest.mark.parametrize("name", ["vq", "prune", "f32"])
def test_hier_aggregate_generic_form_vs_jax(tiers24, name):
    """The registry's generic DCN hop on its own, over a 2 x 4 tier view: vq
    and prune (no ``aggregate``: each wire decoded and summed in tier order)
    and f32 through the base class's ``aggregate`` fold, against JAX's
    ``Codec.hier_aggregate`` over the inter-tier groups, bit for bit on
    integer-valued shards (every product and sum exact)."""
    from mlsl_tpu import codecs as jcodecs

    rng = np.random.default_rng(18)
    t, l, s = 2, 4, 96
    if name == "vq":
        x = np.tile(np.asarray([[1.0, 0.5, 0.25, -0.5]], np.float32), (t * l, s // 4))
        x[::3] *= 0.5
    else:
        x = (rng.integers(-8, 8, size=(t * l, s)) / 8.0).astype(np.float32)
    knobs = {"ratio": 0.25} if name == "prune" else {}
    tc, jc = codecs.get(name, **knobs), jcodecs.get(name, **knobs)
    red, err = codecs.Codec.hier_aggregate(tc, torch.from_numpy(x).reshape(1, t, l, s), t=t)
    inter = [[ti * l + li for ti in range(t)] for li in range(l)]
    jg, _ = _groups()
    jfn = jcoll.build_stateful_collective(
        lambda v, e: jcodecs.Codec.hier_aggregate(jc, v, axis="data", inter=inter, t=t),
        jg.topology.mesh)
    jr, je = jfn(jg.topology.shard_buffer(x.reshape(1, 8, 1, 1, s)),
                 jg.topology.shard_buffer(np.zeros((1, 8, 1, 1, s), np.float32)))
    np.testing.assert_array_equal(red.reshape(1, 8, 1, 1, s).numpy(), np.asarray(jr))
    np.testing.assert_array_equal(err.reshape(1, 8, 1, 1, s).numpy(), np.asarray(je))


# -- selection and requests ----------------------------------------------------------------


def _req(env, group, n, comp=CompressionType.NONE, kind="allreduce", recv_count=None,
         name=""):
    r = CommRequest(CommDesc(kind, group, n, DataType.FLOAT, op=SUM, recv_count=recv_count,
                             compression=comp), env.dispatcher, name=name)
    r.setup()
    return r


def test_request_rides_forced_hier_dense_and_quant(tiers24, tenv):
    tenv.config.collective_algo = "hier"
    tenv.config.validate()
    dist = tenv.create_distribution(8, 1)
    n = 1000
    req = _req(tenv, dist.data_group, n)
    assert req.algo == "hier"
    buf = dist.make_buffer(lambda p: np.full(n, float(p + 1), np.float32), n)
    out = req.start(buf).wait()
    np.testing.assert_array_equal(np.asarray(dist.local_part(out, 0)), np.full(n, 36.0))
    rq = _req(tenv, dist.data_group, n, Q)
    assert rq.algo == "hier" and rq._err_layout == "hier"
    assert rq._hier_meta[0] == 4 and rq._err_lens == [thier.quant_geometry(
        "allreduce", dist.data_group, n, 256)[2]]
    out = rq.start(buf).wait()
    got = np.asarray(dist.local_part(out, 0))
    assert np.linalg.norm(got - 36.0) / np.linalg.norm(np.full(n, 36.0)) < 0.02
    # the request's round is the wire's, bit for bit, and its plain twin too
    fn, el = tqr.build_quantized_collective("allreduce", dist.data_group, n, 256, ring="hier")
    want, _ = fn(buf, torch.zeros(1, 8, 1, 1, el))
    assert torch.equal(out, want)
    twin, _ = rq.plain_result(buf)
    assert torch.equal(twin, want)


def test_forced_hier_without_tiers_falls_back(monkeypatch, tenv):
    monkeypatch.delenv("MLSL_MESH_TIERS", raising=False)
    tenv.config.collective_algo = "hier"
    tenv.config.validate()
    dist = tenv.create_distribution(8, 1)
    assert _req(tenv, dist.data_group, 256).algo == "lax"
    assert _req(tenv, dist.data_group, 256, Q).algo == "quant_ring"


def test_quant_reduce_scatter_keeps_flat_ring(tiers24, tenv):
    tenv.config.collective_algo = "hier"
    tenv.config.validate()
    dist = tenv.create_distribution(8, 1)
    rq = _req(tenv, dist.data_group, 1024, Q, kind="reduce_scatter", recv_count=128)
    assert rq.algo == "quant_ring"
    # the dense reduce_scatter takes hier
    assert _req(tenv, dist.data_group, 1024, kind="reduce_scatter",
                recv_count=128).algo == "hier"


def test_selection_matches_jax(tiers24, tenv, env):
    """select() over forced / tuned hier, compression and groups, against
    JAX's table (the JAX side with the Pallas interpreter armed, so that its
    kernel algorithms are eligible as the port's always are)."""
    os.environ["MLSL_PALLAS_INTERPRET"] = "1"
    try:
        for forced in ("hier", "allreduce=hier", "reduce_scatter=hier"):
            for cfg in (tenv.config, env.config):
                cfg.collective_algo = forced
                cfg.validate()
            for d, m, axes in ((8, 1, ("data",)), (4, 2, ("data",)), (4, 2, ("model",)),
                               (4, 2, ("data", "model"))):
                jg, tg = _groups(d, m, axes)
                for kind in ("allreduce", "reduce_scatter"):
                    for comp, jcomp in ((CompressionType.NONE, JComp.NONE),
                                        (Q, JComp.QUANTIZATION)):
                        got = talgos.select(kind, tg, 4096, comp, tenv.config, op=SUM)
                        want = jalgos.select(kind, jg, 4096, jcomp, env.config, op=JRed.SUM)
                        assert got == want, (forced, axes, kind, comp)
    finally:
        os.environ.pop("MLSL_PALLAS_INTERPRET", None)


def test_tuned_profile_cell_selects_hier(tiers24, tenv):
    tenv.config.tuned_profile = TunedProfile(fingerprint={}, cells=[
        {"kind": "allreduce", "shape": [8], "compression": "none", "max_bytes": None,
         "algo": "hier"},
        {"kind": "allreduce", "shape": [8], "compression": "quantization", "max_bytes": None,
         "algo": "hier"}])
    dist = tenv.create_distribution(8, 1)
    for comp in (CompressionType.NONE, Q):
        assert _req(tenv, dist.data_group, 2048, comp).algo == "hier", comp


def test_profile_knob_choices_validated(tmp_path, tiers24):
    """hier cells and the hier_dcn_codec knob load; a codec outside the
    choices is an MLSLError naming the knob, in both packages."""
    path = str(tmp_path / "prof.json")
    p = TunedProfile(fingerprint={"x": 1}, cells=[
        {"kind": "allreduce", "shape": [8], "compression": "quantization", "max_bytes": None,
         "algo": "hier"}], knobs={"hier_dcn_codec": "topk"})
    p.save(path)
    assert load_profile(path).knobs["hier_dcn_codec"] == "topk"
    assert jload(path).knobs["hier_dcn_codec"] == "topk"
    p.knobs["hier_dcn_codec"] = "fp8"
    p.save(path)
    with pytest.raises(MLSLError, match="hier_dcn_codec"):
        load_profile(path)
    with pytest.raises(Exception, match="hier_dcn_codec"):
        jload(path)


def test_profile_knob_applies_the_dcn_codec(tmp_path, monkeypatch):
    """A profile swept on the 2x4 world sets the DCN codec of a fresh
    Environment there; an exported MLSL_HIER_DCN_CODEC wins."""
    _split(monkeypatch, "2x4")
    fp = sysinfo.topology_fingerprint(8, torch.device("cpu"))
    path = str(tmp_path / "p.json")
    TunedProfile(fingerprint=fp, cells=[
        {"kind": "allreduce", "shape": [8], "compression": "quantization", "max_bytes": None,
         "algo": "hier"}], knobs={"hier_dcn_codec": "f32"}).save(path)
    monkeypatch.setenv("MLSL_TUNE_PROFILE", path)
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert env.config.hier_dcn_codec == "f32"
        dist = env.create_distribution(8, 1)
        x = torch.from_numpy(_int_vals(np.random.default_rng(19), (1, 8, 1, 1), 600))
        rq = _req(env, dist.data_group, 600, Q)
        assert rq.algo == "hier"
        out = rq.start(x).wait()
        assert torch.equal(out, talgos.build("allreduce", dist.data_group, "lax", op=SUM)(x))
    finally:
        env.finalize()
    monkeypatch.setenv("MLSL_HIER_DCN_CODEC", "topk")
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert env.config.hier_dcn_codec == "topk"
    finally:
        env.finalize()


def test_chunked_quant_hier_request(tiers24, tenv):
    """Large-message splitting: a hier program a chunk, each with its own
    shard-layout residual; each chunk's result is its wire's, bit for bit,
    and the whole within 2 % of the exact sum."""
    tenv.config.collective_algo = "hier"
    tenv.config.large_msg_size_mb = 1
    tenv.config.large_msg_chunks = 3
    tenv.config.validate()
    dist = tenv.create_distribution(8, 1)
    n = 1 << 19
    rq = _req(tenv, dist.data_group, n, Q)
    assert rq.algo == "hier" and len(rq._chunk_slices) == 3
    rng = np.random.default_rng(5)
    vals = {p: rng.normal(size=n).astype(np.float32) for p in range(8)}
    buf = dist.make_buffer(lambda p: vals[p], n)
    out = rq.start(buf).wait()
    want = sum(vals.values())
    got = np.asarray(dist.local_part(out, 0))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 0.02
    for sl, el, e in zip(rq._chunk_slices, rq._err_lens, rq._errs):
        m = sl.stop - sl.start
        fn, fel = tqr.build_quantized_collective("allreduce", dist.data_group, m, 256,
                                                 ring="hier")
        assert fel == el
        o, ne = fn(buf[..., sl].contiguous(), torch.zeros(1, 8, 1, 1, el))
        assert torch.equal(out[..., sl], o) and torch.equal(e, ne)


def test_demote_flushes_shard_residual_once(tiers24, tenv):
    """demote_codec on a hier-routed set: the old residual (each member's
    own 1/L shard) is added once, at the member's logical slice, to the next
    round's payload, which runs the int8 hier wire from a zero residual; the
    round after that carries no flush (the JAX breaker test's oracle)."""
    tenv.config.collective_algo = "hier"
    tenv.config.validate()
    dist = tenv.create_distribution(8, 1)
    n = 1000
    rng = np.random.default_rng(7)
    vals = {p: rng.normal(size=n).astype(np.float32) for p in range(8)}
    buf = dist.make_buffer(lambda p: vals[p], n)
    rq = _req(tenv, dist.data_group, n, Q, name="l0")
    rq.start(buf).wait()
    err = rq._errs[0].numpy().copy()
    rq.demote_codec("test")
    assert rq.algo == "hier" and rq._pending_flush is not None and rq._errs is None
    out = rq.start(buf).wait()
    assert rq._pending_flush is None
    L, slen = 4, rq._err_lens[0]
    flushed = buf.numpy().astype(np.float64).copy()
    for p in range(8):
        li = dist.data_group.group_idx_of(p) % L
        logical = np.zeros(L * slen)
        logical[li * slen:(li + 1) * slen] = err[dist.topology.coords(p)]
        flushed[dist.topology.coords(p)] += logical[:n]
    fn, el = tqr.build_quantized_collective("allreduce", dist.data_group, n, 256, ring="hier")
    want, want_err = fn(torch.from_numpy(flushed.astype(np.float32)),
                        torch.zeros(1, 8, 1, 1, el))
    assert torch.equal(out, want) and torch.equal(rq._errs[0], want_err)
    # the exactly-once total: what the two rounds delivered, plus what is
    # still owed, is the two payloads' sum
    out3 = rq.start(buf).wait()
    want3, _ = fn(buf, want_err)
    assert torch.equal(out3, want3)
    # the flush itself against JAX's flush_residual
    l_idx = thier.intra_positions(dist.data_group)
    got = thier.flush_residual(torch.from_numpy(err), torch.from_numpy(l_idx), L, slen, n)
    jgot = jhier.flush_residual(err, l_idx, L, slen, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


# -- the overlap engine -------------------------------------------------------------------


def test_overlap_dense_hier_staged_parity(tiers24):
    rng = np.random.default_rng(20)
    jg, tg = _groups()
    cfg, jcfg = Config(), JConfig()
    cfg.validate()
    jcfg.validate()
    counts = [300, 512, 128]
    xs = [_int_vals(rng, (1, 8, 1, 1), c) for c in counts]
    for stages in (1, 3):
        fn, plan = tov.build_multi_reduce(tg, counts, algo="hier", config=cfg, stages=stages)
        jfn, jplan = jov.build_multi_reduce(jg, counts, algo="hier", config=jcfg, stages=stages)
        assert all(u.algo == "hier" and u.nphases == 3 for u in plan.units)
        assert [u.per_tick for u in plan.units] == [u.per_tick for u in jplan.units]
        outs = fn([torch.from_numpy(x) for x in xs])
        jouts = jfn([jg.topology.shard_buffer(x) for x in xs])
        for o, jo, x in zip(outs, jouts, xs):
            np.testing.assert_array_equal(o[0, 0, 0, 0].numpy(), x.sum(axis=(0, 1, 2, 3)))
            np.testing.assert_array_equal(o.numpy(), np.asarray(jo))


def test_overlap_quant_hier_staged_bitexact_vs_host(tiers24):
    """Quantized units staged as hier phases are the host ring='hier' wire:
    outputs and residuals bit for bit over 2 rounds; and JAX's engine within
    one quantization step."""
    rng = np.random.default_rng(21)
    jg, tg = _groups()
    cfg, jcfg = Config(), JConfig()
    cfg.validate()
    jcfg.validate()
    block = 64
    counts = [300, 512]
    xs = [rng.normal(size=(1, 8, 1, 1, c)).astype(np.float32) for c in counts]
    fn, plan = tov.build_multi_reduce(tg, counts, compression=Q, algo="hier", config=cfg,
                                      block=block)
    assert all(u.algo == "hier" and u.nphases == 3 for u in plan.units)
    assert plan.err_lens == {u.key: thier.quant_geometry("allreduce", tg, u.total, block)[2]
                             for u in plan.units}
    bufs = [torch.from_numpy(x) for x in xs]
    outs, res = fn(bufs)
    outs2, res2 = fn(bufs, res)
    for i, c in enumerate(counts):
        fh, el = tqr.build_quantized_collective("allreduce", tg, c, block, ring="hier")
        o1, e1 = fh(bufs[i], torch.zeros(1, 8, 1, 1, el))
        o2, e2 = fh(bufs[i], e1)
        assert torch.equal(outs[i], o1) and torch.equal(outs2[i], o2)
        key = plan.units[len(counts) - 1 - i].key
        assert torch.equal(res2[key], e2)
    jfn, jplan = jov.build_multi_reduce(jg, counts, compression=JComp.QUANTIZATION,
                                        algo="hier", config=jcfg, block=block)
    jouts, _ = jfn([jg.topology.shard_buffer(x) for x in xs],
                   jov.zero_residuals(jplan, jg.topology))
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0,
                                   atol=np.abs(np.asarray(jo)).max() / 127.0)


def _mlp_pair(tenv, jenv, engine):
    params = mlp_init(jax.random.PRNGKey(3))
    host = jax.tree.map(np.asarray, params)
    jd, td = jenv.create_distribution(8, 1), tenv.create_distribution(8, 1)
    js, ts = jenv.create_session(), tenv.create_session()
    js.set_global_minibatch_size(32)
    ts.set_global_minibatch_size(32)
    jt = JTrainer(jenv, jd, js, params, jmlp_loss, LAYERS, jget_layer,
                  compression=JComp.QUANTIZATION, lr=0.1, overlap_compiled=engine,
                  force_graph_path=not engine, donate_params=False)
    model = tmlp.MLP(device="cpu", params=params_from_jax(host, device="cpu"))
    tt = TTrainer(tenv, td, ts, model, tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer,
                  compression=Q, lr=0.1, overlap_compiled=engine)
    return jt, tt


def _batch():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(32, 8)).astype(np.float32),
            rng.integers(0, 4, size=(32,)).astype(np.int32))


def test_trainer_engine_hier_units_match_host(tiers24, tenv):
    """The MLP trainer with int8 gradients forced onto hier: the compiled
    overlap engine's staged hier units and the host requests give the same
    losses, parameters and residuals, bit for bit, over 3 steps."""
    tenv.config.collective_algo = "hier"
    tenv.config.validate()
    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    trainers = []
    for engine in (True, False):
        dist = tenv.create_distribution(8, 1)
        s = tenv.create_session()
        s.set_global_minibatch_size(32)
        model = tmlp.MLP(device="cpu", params=params_from_jax(host, device="cpu"))
        trainers.append(TTrainer(tenv, dist, s, model, tmlp.loss_fn, tmlp.LAYERS,
                                 tmlp.get_layer, compression=Q, lr=0.1,
                                 overlap_compiled=engine))
    tc, th = trainers
    units = tc._overlap.plan.units
    assert [u.algo for u in units] == ["hier"] * len(LAYERS)
    for u in units:
        req = th._pset(u.names[0]).grad_req
        assert req.algo == "hier" and [u.err_len] == req._err_lens
    x, y = _batch()
    for _ in range(3):
        lc, lh = tc.step(tc.shard_batch(x, y)), th.step(th.shard_batch(x, y))
        assert torch.equal(lc, lh)
    got, want = params_to_jax(tc.model), params_to_jax(th.model)
    for name in LAYERS:
        for g, w in zip(jax.tree.leaves(got[name]), jax.tree.leaves(want[name])):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for u in units:
        assert torch.equal(tc._overlap.residuals[u.key],
                           th._pset(u.names[0]).grad_req._errs[0])


@pytest.mark.parametrize("engine", [False, True])
def test_mlp_trainer_on_hier_matches_jax(tiers24, engine):
    """The slice end to end: the MLP trainer with int8 gradients on the hier
    wire, 2 steps on the port and on the JAX package from the same weights
    and batch, losses within 1e-4 and parameters within 1e-3 (the
    one-quantization-step bound of tests/test_torch_algos.py's slice
    test)."""
    os.environ["MLSL_ALGO"] = "hier"
    try:
        jenv = JEnv.get_env().init()
        tenv = Environment.get_env().init(device="cpu", world_size=8)
    finally:
        os.environ.pop("MLSL_ALGO", None)
    try:
        jt, tt = _mlp_pair(tenv, jenv, engine)
        if engine:
            assert all(u.algo == "hier" for u in tt._overlap.plan.units)
            assert all(u.algo == "hier" for u in jt._overlap.plan.units)
        else:
            for name in LAYERS:
                assert jt.ops[name].get_parameter_set(0).grad_req.algo == "hier"
                assert tt.ops[name].get_parameter_set(0).grad_req.algo == "hier"
        x, y = _batch()
        for _ in range(2):
            jl = np.asarray(jt.step(jt.shard_batch(x, y))).reshape(-1)
            tl = tt.step(tt.shard_batch(x, y)).reshape(-1).numpy()
            np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
        want = jax.device_get(jt.params)
        got = params_to_jax(tt.model)
        for name in LAYERS:
            for g, w in zip(jax.tree.leaves(got[name]), jax.tree.leaves(want[name])):
                np.testing.assert_allclose(g, np.asarray(w), atol=1e-3, rtol=0)
    finally:
        tenv.finalize()
        jenv.finalize()


def test_profile_from_jax_with_hier_cells_loads(tmp_path, tiers24):
    """A JAX profile document with hier cells and the DCN knob is a port
    profile too (one file format)."""
    path = str(tmp_path / "j.json")
    JProfile(fingerprint={"tiers": [2, 4]}, cells=[
        {"kind": "allreduce", "shape": [8], "compression": "none", "max_bytes": None,
         "algo": "hier"}], knobs={"hier_dcn_codec": "int8"}).save(path)
    p = load_profile(path)
    assert p.select("allreduce", (8,), "none", 1 << 20) == "hier"
    assert json.load(open(path))["knobs"]["hier_dcn_codec"] == "int8"
