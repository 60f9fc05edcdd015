"""The port's codec registry, its calibration and its guardrail
(mlsl_tpu_torch.codecs, tuner/calibrate.py, CommRequest.demote_codec)
against the JAX package's, mirroring tests/test_codec_lab.py.

The same numpy-seeded inputs go through JAX (on the 8-device CPU mesh where a
collective runs) and through the port (``device="cpu"``, 8 virtual ranks).
Tolerances:

- wire images of ``f32``, ``prune``, ``topk`` and ``vq`` and their decodes:
  bit for bit JAX's (VQ on inputs with no two codewords within an ulp of a
  vector; prune/topk with ties, which both packages break to the lower
  index); ``int8`` bit for bit against JAX run in a subprocess with
  ``--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX`` (ROADMAP's
  standing difference: XLA's default CPU build multiplies by 1/127);
- the registry's compressed ring against JAX's: bit for bit, results and
  residuals (the same hop order), except VQ, whose decode's product XLA
  contracts into the next add (an FMA): within 1e-6; lossless settings bit
  for bit the exact integer sums, as the reference pins them;
- int8 by name: the seed ring's 2 % relative L2 bound;
- calibration: the same codec for every set as JAX's calibration on the same
  samples, the NSRs within rtol 1e-5 (JAX's int8 scale differs by an ulp
  in about 4 % of the blocks; VQ's distances may contract into FMAs);
- the guardrail: the flush round and the rounds after it bit for bit a fresh
  int8 request fed the flushed payload.

The two-tier DCN hop (``test_hier_dcn_hop_through_registry``) is held in
tests/test_torch_hier.py; the sentinel's feed into ``guard_note``
(``test_sentinel_gate_feeds_guardrail``) through the port's sentinel. Not
mirrored: ``test_supervisor_status_codecs_section`` (``codecs.status()`` is
tested instead) and the codec-lab bench smoke.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsl_tpu import codecs as jcodecs
from mlsl_tpu.codecs import vq as jvq
from mlsl_tpu.comm.request import CommDesc as JDesc, CommRequest as JReq
from mlsl_tpu.config import Config as JConfig
from mlsl_tpu.tuner import calibrate as jcal
from mlsl_tpu.types import (
    CompressionType as JComp, DataType as JDT, GroupType as JGT, ReductionType as JRed,
)
from mlsl_tpu_torch import codecs
from mlsl_tpu_torch import sysinfo
from mlsl_tpu_torch.codecs import vq as tvq
from mlsl_tpu_torch.comm import sparse as tsparse
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.tuner import calibrate as tcal
from mlsl_tpu_torch.types import (
    CompressionType, DataType, GroupType, OpType, QuantParams, ReductionType,
)

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
NAMES = ["int8", "f32", "topk", "vq", "prune"]


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


@pytest.fixture(autouse=True)
def _fresh():
    codecs.guard_reset()
    stats.reset_codec_counters()
    yield
    codecs.guard_reset()
    stats.reset_codec_counters()


def _req(e, dist, n, *, name="", kind="allreduce", recv_count=None, jax=False):
    if jax:
        r = JReq(JDesc(kind, dist._group(JGT.DATA), n, JDT.FLOAT, op=JRed.SUM,
                       recv_count=recv_count, compression=JComp.QUANTIZATION),
                 e.dispatcher, name=name)
    else:
        r = CommRequest(CommDesc(kind, dist._group(GroupType.DATA), n, DataType.FLOAT,
                                 op=ReductionType.SUM, recv_count=recv_count,
                                 compression=CompressionType.QUANTIZATION),
                        e.dispatcher, name=name)
    r.setup()
    return r


def _round(dist, req, vals, n):
    req.start(dist.make_buffer(lambda p: vals[p], n))
    return np.asarray(dist.local_part(req.wait(), 0))


def _int_vals(n, seed=0):
    rng = np.random.default_rng(seed)
    return {p: rng.integers(-8, 8, size=n).astype(np.float32) for p in range(8)}


def _normal_vals(n, seed=0):
    rng = np.random.default_rng(seed)
    return {p: rng.normal(size=n).astype(np.float32) for p in range(8)}


def _both(env, tenv, **cfg):
    for e in (env, tenv):
        for k, v in cfg.items():
            setattr(e.config, k, v)


DYADIC_CB = [
    [0.0, 0.0, 0.0, 0.0],
    [1.0, 0.5, 0.25, -0.5],
    [0.5, -1.0, 0.25, -0.25],
    [-0.5, 0.25, -1.0, 1.0],
]


def _dyadic_vq_vals(n):
    rows = np.asarray(DYADIC_CB, np.float32)[1:]
    x = np.tile(rows, (n // 4 // 3 + 1, 1)).reshape(-1)[:n].astype(np.float32)
    return {p: x for p in range(8)}, x


# -- the registry's contract ----------------------------------------------------


def test_registry_names_caching_and_configure_precedence():
    assert set(codecs.names()) == set(jcodecs.names()) >= set(NAMES)
    a = codecs.get("prune", ratio=0.25)
    assert codecs.get("prune", ratio=0.25) is a and codecs.get("prune", ratio=0.5) is not a
    with pytest.raises(MLSLError, match="unknown codec"):
        codecs.get("fp4")
    cfg = Config()
    cfg.prune_ratio = 0.5
    cell = {"codec": "prune", "params": {"ratio": 0.25}}
    assert codecs.configure("prune", cfg, cell).ratio == 0.25
    assert codecs.configure("prune", cfg).ratio == 0.5
    assert codecs.configure("prune").ratio == 0.05
    assert codecs.configure("int8", cfg, {"codec": "int8", "block": 512}).block == 512
    assert codecs.configure("vq", cfg, {"codec": "vq", "params": {"vq_dim": 8}}).dim == 8


def test_assigned_precedence_env_calibrated_config_default():
    for cfg, mod in ((Config(), codecs), (JConfig(), jcodecs)):
        assert mod.assigned(cfg, "g")[::2] == ("int8", "default")
        cfg.codec = "vq"
        assert mod.assigned(cfg, "g")[::2] == ("vq", "config")
        cell = {"codec": "prune", "params": {"ratio": 0.1}}
        cfg.codec_assignment = {"g": cell}
        name, got, src = mod.assigned(cfg, "g")
        assert (name, src) == ("prune", "calibrated") and got is cell
        assert mod.assigned(cfg, "other")[::2] == ("vq", "config")
        cfg._explicit = ("codec",)
        assert mod.assigned(cfg, "g")[::2] == ("vq", "env")


@pytest.fixture(scope="module")
def jax_int8_exact(tmp_path_factory):
    """JAX's Int8Codec wires and decodes at blocks 128/256/512 on n = 1000
    and 4096, run with the codec tests' XLA flags in a subprocess."""
    path = tmp_path_factory.mktemp("int8") / "wires.npz"
    code = (
        "import sys, numpy as np, jax, jax.numpy as jnp\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from mlsl_tpu import codecs\n"
        "out = {}\n"
        "for n in (1000, 4096):\n"
        "    x = np.random.default_rng(n).normal(size=n).astype(np.float32)\n"
        "    for b in (128, 256, 512):\n"
        "        c = codecs.get('int8', block=b)\n"
        "        w = c.encode(jnp.asarray(x))\n"
        "        out[f'w{n}_{b}'] = np.asarray(w)\n"
        "        out[f'd{n}_{b}'] = np.asarray(c.decode(w, n))\n"
        "np.savez(sys.argv[2], **out)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", code, ROOT, str(path)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("n", [1000, 4096])
@pytest.mark.parametrize("block", [128, 256, 512])
def test_int8_wire_bit_exact_vs_jax(jax_int8_exact, n, block):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    c = codecs.get("int8", block=block)
    w = c.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(w.numpy(), jax_int8_exact[f"w{n}_{block}"])
    np.testing.assert_array_equal(c.decode(w, n).numpy(), jax_int8_exact[f"d{n}_{block}"])
    assert c.geometry(n) == jcodecs.get("int8", block=block).geometry(n)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("data", ["normal", "integer-ties"])
def test_wire_len_geometry_and_wire_bits_vs_jax(name, data):
    """wire_len, geometry and the decode's shape as the reference asserts
    them (n = 1000, off every grid); the wire image and the decode bit for
    bit JAX's (int8: its own subprocess test above)."""
    n = 1000
    rng = np.random.default_rng(3)
    x = (rng.normal(size=n) if data == "normal" else rng.integers(-8, 8, size=n)).astype(
        np.float32)
    codec, jcodec = codecs.get(name), jcodecs.get(name)
    wire = codec.encode(torch.from_numpy(x))
    assert wire.dtype == torch.uint8 and wire.shape == (codec.wire_len(n),)
    assert codec.wire_len(n) == jcodec.wire_len(n)
    assert codec.geometry(n) == jcodec.geometry(n)
    xhat = codec.decode(wire, n)
    assert xhat.shape == (n,) and bool(torch.isfinite(xhat).all())
    if name == "int8":
        return
    jw = np.asarray(jcodec.encode(jnp.asarray(x)))
    np.testing.assert_array_equal(wire.numpy(), jw)
    np.testing.assert_array_equal(xhat.numpy(), np.asarray(jcodec.decode(jnp.asarray(jw), n)))
    # a batch of rows codes each row on its own
    rows = torch.from_numpy(np.stack([x, 2 * x, np.zeros_like(x)]))
    np.testing.assert_array_equal(codec.encode(rows)[0].numpy(), wire.numpy())
    assert codec.encode(rows).shape == (3, codec.wire_len(n))


def test_lossless_roundtrip_and_aggregate():
    n = 768
    x = torch.from_numpy(np.random.default_rng(4).integers(-8, 8, size=n).astype(np.float32))
    f32 = codecs.get("f32")
    assert torch.equal(f32.decode(f32.encode(x), n), x)
    assert torch.equal(f32.decode(f32.aggregate(f32.encode(x), f32.encode(2 * x)), n), 3 * x)
    keep_all = codecs.get("prune", ratio=1.0)
    assert keep_all.lossless and torch.equal(keep_all.decode(keep_all.encode(x), n), x)


def test_vq_learned_codebook_matches_jax_and_reduces_nsr():
    """learn_codebook is the JAX package's numpy, array for array, and a
    larger codebook sharpens the round trip on its own data."""
    n = 2048
    x = np.random.default_rng(1).normal(size=n).astype(np.float32)
    sig = float(np.sum(x ** 2))

    def nsr(k):
        cb = tvq.learn_codebook(x, k=k, dim=4)
        np.testing.assert_array_equal(cb, jvq.learn_codebook(x, k=k, dim=4))
        c = codecs.get("vq", dim=4, k=k, codebook=cb)
        xhat = c.decode(c.encode(torch.from_numpy(x)), n).numpy()
        return float(np.sum((xhat - x) ** 2)) / sig

    n16, n64, n256 = nsr(16), nsr(64), nsr(256)
    assert n256 < n64 < n16 < 1.0, (n16, n64, n256)
    np.testing.assert_array_equal(tvq.default_codebook(16, 4), jvq.default_codebook(16, 4))


def test_hier_names_still_raise():
    """The two-tier DCN hop is ported (tests/test_torch_hier.py): every
    registry codec serves it, and only a name outside the DCN codecs raises."""
    xq = torch.linspace(-1.0, 1.0, 2 * 4 * 256).reshape(1, 2, 4, 256)
    for name in NAMES:
        red, err = codecs.get(name).hier_aggregate(xq, t=2)
        assert red.shape == err.shape == xq.shape
    cfg = Config()
    cfg.hier_dcn_codec = "int8"
    cfg.validate()
    cfg.hier_dcn_codec = "fp4"
    with pytest.raises(MLSLError, match="HIER_DCN_CODEC"):
        cfg.validate()


# -- the registry's compressed ring against JAX's ----------------------------------


@pytest.mark.parametrize("name,algo", [("f32", "codec:f32"), ("prune", "codec:prune"),
                                       ("topk", "topk")])
def test_plain_ring_exact_sum_lossless(env, tenv, name, algo):
    """Lossless settings through the registry's routes: the exact integer
    sums, JAX's bits, and a zero residual."""
    n = 1024
    _both(env, tenv, codec=name, prune_ratio=1.0, topk_ratio=1.0)
    jd, td = env.create_distribution(8, 1), tenv.create_distribution(8, 1)
    jr, tr = _req(env, jd, n, jax=True), _req(tenv, td, n)
    assert tr.algo == jr.algo == algo and tr.codec_name == name
    assert tr.codec_source == "config"
    vals = _int_vals(n)
    got = _round(td, tr, vals, n)
    np.testing.assert_array_equal(got, sum(vals[p] for p in range(8)))
    np.testing.assert_array_equal(got, _round(jd, jr, vals, n))
    assert float(tr._errs[0].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["vq", "prune", "f32"])
def test_registry_ring_lockstep_with_jax(env, tenv, name):
    """Lossy settings (the default VQ codebook, prune at 0.25): two rounds in
    lockstep with JAX's registry ring, results and residuals bit for bit for
    prune and f32, whose decode only moves bytes. VQ's decode multiplies
    (codeword times scale), and XLA's default CPU build contracts that
    product into the add that follows it (an FMA, ROADMAP's standing
    difference), so VQ agrees within rtol/atol 1e-6."""
    n = 768
    _both(env, tenv, codec=name, prune_ratio=0.25)
    jd, td = env.create_distribution(8, 1), tenv.create_distribution(8, 1)
    jr, tr = _req(env, jd, n, jax=True), _req(tenv, td, n)
    assert tr.algo == jr.algo == f"codec:{name}"
    assert tr._codec_geoms == jr._codec_geoms and tr._wire_rec == jr._wire_rec
    tol = dict(rtol=1e-6, atol=1e-6) if name == "vq" else dict(rtol=0, atol=0)
    for r in range(2):
        vals = _normal_vals(n, seed=30 + r)
        np.testing.assert_allclose(_round(td, tr, vals, n), _round(jd, jr, vals, n), **tol)
        np.testing.assert_allclose(tr._errs[0].numpy(), np.asarray(jr._err), **tol)


def test_plain_ring_tolerance_int8(tenv):
    """int8 by name stays the seed ring (quant_ring) within 2 % of the exact
    sum, its residual live."""
    n = 2048
    tenv.config.codec = "int8"
    td = tenv.create_distribution(8, 1)
    req = _req(tenv, td, n)
    assert req.algo == "quant_ring" and req.codec_name == "int8"
    vals = _normal_vals(n, seed=1)
    out = _round(td, req, vals, n)
    exact = sum(vals[p] for p in range(8))
    assert np.linalg.norm(out - exact) / np.linalg.norm(exact) < 0.02
    assert float(req._errs[0].abs().max()) > 0.0


def test_vq_dyadic_construction_is_bit_exact(tenv):
    n = 512
    tenv.config.codec_assignment = {
        "vqx": {"codec": "vq", "params": {"vq_dim": 4, "vq_codebook": 4,
                                          "codebook": DYADIC_CB}}}
    td = tenv.create_distribution(8, 1)
    vals, x = _dyadic_vq_vals(n)
    req = _req(tenv, td, n, name="vqx")
    assert req.algo == "codec:vq" and req.codec_source == "calibrated"
    np.testing.assert_array_equal(_round(td, req, vals, n), 8.0 * x)
    assert float(req._errs[0].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["f32", "prune"])
def test_zero1_reduce_scatter_exact_shards(tenv, name):
    n_owned = 256
    n = n_owned * 8
    tenv.config.codec = name
    tenv.config.prune_ratio = 1.0
    td = tenv.create_distribution(8, 1)
    vals = _int_vals(n, seed=5)
    req = _req(tenv, td, n, kind="reduce_scatter", recv_count=n_owned)
    assert req.algo == f"codec:{name}"
    req.start(td.make_buffer(lambda p: vals[p], n))
    out = req.wait()
    exact = sum(vals[p] for p in range(8))
    for p in range(8):
        np.testing.assert_array_equal(td.local_part(out, p),
                                      exact[p * n_owned:(p + 1) * n_owned])


def test_chunked_allreduce_exact_through_registry(tenv):
    tenv.config.large_msg_size_mb = 1
    tenv.config.large_msg_chunks = 4
    tenv.config.codec = "prune"
    tenv.config.prune_ratio = 1.0
    n = 1024 * 1024
    td = tenv.create_distribution(8, 1)
    vals = _int_vals(n, seed=6)
    req = _req(tenv, td, n)
    assert req.algo == "codec:prune" and len(req._chunk_slices) == 4
    assert len(req._codec_geoms) == 4
    np.testing.assert_array_equal(_round(td, req, vals, n), sum(vals[p] for p in range(8)))


# -- bucketing: one codec a bucket ------------------------------------------------


def _codec_session(e, counts, bucket_mb=4, names=None):
    e.config.grad_bucket_mb = bucket_mb
    dist = e.create_distribution(8, 1)
    s = e.create_session()
    s.set_global_minibatch_size(8)
    ops = []
    for i, c in enumerate(counts):
        r = s.create_operation_reg_info(OpType.CC)
        if names:
            r.set_name(names[i])
        r.add_input(8, 4)
        r.add_output(8, 4)
        r.add_parameter_set(c, 1, compression_type=CompressionType.QUANTIZATION)
        ops.append(s.get_operation(s.add_operation(r, dist)))
    s.commit()
    e.config.grad_bucket_mb = 0
    return dist, s, [op.get_parameter_set(0) for op in ops]


def test_bucketed_codec_exact_sum(tenv):
    tenv.config.codec = "prune"
    tenv.config.prune_ratio = 1.0
    counts = [512, 768]
    dist, s, pss = _codec_session(tenv, counts)
    assert pss[0].bucket is not None and pss[0].bucket is pss[1].bucket
    breq = pss[0].bucket.req
    assert breq.algo == "codec:prune" and breq.codec_name == "prune"
    assert breq.codec_source == "desc" and pss[0].bucket.codec == "prune"
    assert pss[0].bucket.precompile() == 1
    vals = [_int_vals(c, seed=7 + i) for i, c in enumerate(counts)]
    for ps, c, v in zip(pss, counts, vals):
        ps.start_gradient_comm(dist.make_buffer(lambda p, v=v: v[p], c))
    for ps, c, v in zip(pss, counts, vals):
        np.testing.assert_array_equal(dist.local_part(ps.wait_gradient_comm(), 0),
                                      sum(v[p] for p in range(8)))


def test_mixed_codec_buckets_stay_split(tenv):
    tenv.config.codec_assignment = {
        "a/grad0": {"codec": "prune", "params": {"ratio": 1.0}},
        "b/grad0": {"codec": "f32", "params": {}},
        "c/grad0": {"codec": "f32", "params": {}},
    }
    dist, s, pss = _codec_session(tenv, [512, 512, 512], names=["a", "b", "c"])
    assert [ps.codec_name for ps in pss] == ["prune", "f32", "f32"]
    assert pss[0].bucket is None and pss[1].bucket is pss[2].bucket is not None
    assert pss[0].grad_req.algo == "codec:prune" and pss[1].bucket.req.algo == "codec:f32"


def test_topk_stays_individual(tenv):
    """TOPK sets never bucket: the sparse wire has no coalesced form."""
    tenv.config.grad_bucket_mb = 4
    dist = tenv.create_distribution(8, 1)
    s = tenv.create_session()
    s.set_global_minibatch_size(8)
    ops = []
    for _ in range(2):
        r = s.create_operation_reg_info(OpType.CC)
        r.add_parameter_set(64, 1, compression_type=CompressionType.TOPK)
        ops.append(s.get_operation(s.add_operation(r, dist)))
    s.commit()
    assert all(op.get_parameter_set(0).bucket is None for op in ops)
    assert ops[0].get_parameter_set(0).grad_req.algo == "topk"


# -- the registry routes against the front doors they stand for -------------------


def test_topk_registry_matches_sparse_oracle(tenv):
    n = 1024
    tenv.config.codec = "topk"
    tenv.config.topk_ratio = 0.1
    td = tenv.create_distribution(8, 1)
    req = _req(tenv, td, n)
    assert req.algo == "topk" and req.codec_name == "topk"
    fn, el = tsparse.build_sparse_collective("allreduce", td.data_group, n, 0.1)
    err = torch.zeros((*td.topology.grid_shape, el))
    for r in range(2):
        vals = _normal_vals(n, seed=20 + r)
        got = _round(td, req, vals, n)
        want, err = fn(td.make_buffer(lambda p: vals[p], n), err)
        np.testing.assert_array_equal(got, td.local_part(want, 0))
        assert torch.equal(req._errs[0], err)


def test_registry_ring_matches_custom_codec_oracle(tenv):
    n = 768
    vq = codecs.get("vq")
    tenv.config.codec = "vq"
    td = tenv.create_distribution(8, 1)
    reg = _req(tenv, td, n, name="reg")
    assert reg.algo == "codec:vq"
    tenv.set_quantization_params(QuantParams(compress_fn=vq.encode,
                                             decompress_fn=lambda p, m: vq.decode(p, m)))
    oracle = _req(tenv, td, n, name="oracle")
    assert oracle.algo == "custom_codec"
    for r in range(2):
        vals = _normal_vals(n, seed=30 + r)
        np.testing.assert_array_equal(_round(td, reg, vals, n), _round(td, oracle, vals, n))
        assert torch.equal(reg._errs[0], oracle._errs[0])


# -- calibration -----------------------------------------------------------------


def _calib_session(e, names=("small", "wide")):
    dist = e.create_distribution(8, 1)
    s = e.create_session()
    s.set_global_minibatch_size(8)
    pss = []
    for name, c in zip(names, (2048, 32768)):
        r = s.create_operation_reg_info(OpType.CC)
        r.set_name(name)
        r.add_output(8, 4)
        r.add_parameter_set(c, 1, compression_type=CompressionType.QUANTIZATION)
        pss.append(s.get_operation(s.add_operation(r, dist)).get_parameter_set(0))
    s.commit()
    return s, pss


def test_calibration_matches_jax_measurements():
    """The samples are JAX's arrays; every candidate's wire bytes are JAX's
    and its NSR within rtol 1e-5; the solver picks the same cell."""
    cfg, jcfg = Config(), JConfig()
    for name, n, ks in (("small/grad0", 2048, 1), ("wide/grad0", 32768, 1), ("c", 5000, 9)):
        x = tcal.gradient_sample(name, n, ks)
        np.testing.assert_array_equal(x, jcal.gradient_sample(name, n, ks))
        assert tcal.norm_spectrum(x) == jcal.norm_spectrum(x)
        cells = tcal.candidate_cells(cfg, name, n, x)
        jcells = jcal.candidate_cells(jcfg, name, n, x)
        assert [(c["codec"], c["block"], c["wire_bytes"]) for c in cells] == \
            [(c["codec"], c["block"], c["wire_bytes"]) for c in jcells]
        np.testing.assert_allclose([c["nsr"] for c in cells], [c["nsr"] for c in jcells],
                                   rtol=1e-5, atol=1e-9)
        for budget in (0.001, 0.02, 0.2):
            a, b = tcal.solve(cells, budget), jcal.solve(jcells, budget)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a["codec"], a["block"], a["params"].get("ratio")) == \
                    (b["codec"], b["block"], b["params"].get("ratio"))


def test_calibration_assigns_persists_and_fresh_env_honors(tmp_path, monkeypatch):
    """MLSL_TUNE_CODEC=1 calibrates at commit, re-routes the live requests
    and writes the table into the profile; a fresh Environment loading the
    profile routes a new session the same way without calibrating."""
    path = str(tmp_path / "tuned.json")
    monkeypatch.setenv("MLSL_TUNE_CODEC", "1")
    monkeypatch.setenv("MLSL_TUNE_PROFILE", path)
    e = Environment.get_env().init(device="cpu", world_size=8)
    _, pss = _calib_session(e)
    live = {ps.grad_req.name: ps.grad_req for ps in pss}
    assert all(r.codec_source == "calibrated" for r in live.values())
    recorded = {k: v["codec"] for k, v in e.config.codec_assignment.items()}
    assert set(recorded) == set(live)
    for name, req in live.items():
        assert req.codec_name == recorded[name]
    assert live["wide/grad0"]._wire_rec[1] < codecs.get("int8").wire_len(32768)
    with open(path) as f:
        doc = json.load(f)
    assert set(doc["codecs"]) == set(recorded)
    assert doc["fingerprint"] == sysinfo.topology_fingerprint(8, torch.device("cpu"))
    assert stats.CODEC_COUNTERS["assignments"] >= 2 and stats.CODEC_COUNTERS["calibrations"] == 1
    e.finalize()

    monkeypatch.delenv("MLSL_TUNE_CODEC")
    e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert not e.config.tune_codec
        assert {k: v["codec"] for k, v in e.config.codec_assignment.items()} == recorded
        _, pss = _calib_session(e)
        for ps in pss:
            assert ps.grad_req.codec_source == "calibrated"
            assert ps.grad_req.codec_name == recorded[ps.grad_req.name]
        assert stats.CODEC_COUNTERS["calibrations"] == 1
    finally:
        e.finalize()


def test_stale_or_bad_codec_profile(tmp_path, monkeypatch, caplog):
    """A codec table measured elsewhere is rejected with the whole profile; a
    table naming an unknown codec is an MLSLError at load."""
    from mlsl_tpu_torch.tuner.profile import PROFILE_VERSION, load_profile

    stale = str(tmp_path / "stale.json")
    with open(stale, "w") as f:
        json.dump({"version": PROFILE_VERSION,
                   "fingerprint": {"platform": "tpu", "device_kind": "TPU v9",
                                   "num_devices": 4096, "num_hosts": 512},
                   "cells": [], "codecs": {"wide/grad0": {"codec": "prune",
                                                          "params": {"ratio": 0.05}}}}, f)
    monkeypatch.setenv("MLSL_TUNE_PROFILE", stale)
    e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert e.config.tuned_profile is None and not e.config.codec_assignment
        assert "different topology" in caplog.text
        _, pss = _calib_session(e)
        assert all(ps.grad_req.codec_source == "default" for ps in pss)
    finally:
        e.finalize()
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"version": PROFILE_VERSION,
                   "fingerprint": sysinfo.topology_fingerprint(8, torch.device("cpu")),
                   "cells": [], "codecs": {"g": {"codec": "fp4"}}}, f)
    with pytest.raises(MLSLError, match="codec"):
        load_profile(bad)


def test_explicit_codec_blocks_calibrated_assignment(tenv):
    tenv.config.codec = "int8"
    tenv.config._explicit = {"codec"}
    tenv.config.codec_assignment = {"g": {"codec": "prune", "params": {"ratio": 0.05}}}
    req = _req(tenv, tenv.create_distribution(8, 1), 512, name="g")
    assert req.codec_name == "int8" and req.codec_source == "env"


def test_sentinel_gate_feeds_guardrail(monkeypatch):
    """tests/test_codec_lab.py:647 through the port's sentinel: a pinned loss
    EMA makes every screened step a z-score outlier, and after
    ``codec_guard_breaches`` screens in a row the calibrated request demotes
    to int8, with no training-loop plumbing."""
    import jax

    from mlsl_tpu.models.mlp import init as mlp_init
    from mlsl_tpu_torch import sentinel, supervisor
    from mlsl_tpu_torch.models import mlp as tmlp
    from mlsl_tpu_torch.models.convert import params_from_jax
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    for k, v in (("MLSL_SENTINEL_GATE", "warn"), ("MLSL_SENTINEL_WARMUP", "1"),
                 ("MLSL_SENTINEL_ZMAX", "3"), ("MLSL_CODEC_GUARD_BREACHES", "2")):
        monkeypatch.setenv(k, v)
    e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        dist = e.create_distribution(8, 1)
        sess = e.create_session()
        sess.set_global_minibatch_size(16)
        host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
        tr = DataParallelTrainer(e, dist, sess,
                                 tmlp.MLP(device="cpu", params=params_from_jax(host, "cpu")),
                                 tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1)
        req = _calibrated_prune_req(e, dist, 512, name="guarded")
        assert codecs.guard_active()

        def batch(step):
            rng = np.random.default_rng(step)
            return (rng.normal(size=(16, 8)).astype(np.float32),
                    rng.integers(0, 4, size=(16,)).astype(np.int32))

        tr.step(tr.shard_batch(*batch(0)))      # warmup: the EMA seeds
        for step, demoted in ((1, False), (2, True)):
            tr.sentinel._loss_mean = 1e6        # every later loss is an outlier
            tr.sentinel._loss_var = 1.0
            tr.step(tr.shard_batch(*batch(step)))
            assert req._codec_demoted is demoted
        assert req.codec_name == "int8"
        assert stats.SENTINEL_COUNTERS["gate_warn"] == 2
    finally:
        e.finalize()
        sentinel.reset()
        supervisor.reset_all()


# -- the guardrail ---------------------------------------------------------------


def _calibrated_prune_req(e, dist, n, ratio=0.25, name="g"):
    e.config.codec_assignment = {name: {"codec": "prune", "params": {"ratio": ratio}}}
    return _req(e, dist, n, name=name)


@pytest.mark.parametrize("chunked", [False, True], ids=["one-program", "chunked"])
def test_guard_demotes_after_window_with_exactly_once_flush(tenv, chunked):
    """``window`` breaches in a row demote every calibrated set to int8; the
    old residual goes out once with the next round, and from then on the
    request is bit for bit a fresh int8 request."""
    n = 1024 if not chunked else 1 << 19
    if chunked:
        tenv.config.large_msg_size_mb = 1
        tenv.config.large_msg_chunks = 2
    td = tenv.create_distribution(8, 1)
    req = _calibrated_prune_req(tenv, td, n)
    assert req.codec_source == "calibrated" and codecs.guard_active()
    vals1 = _normal_vals(n, seed=40)
    _round(td, req, vals1, n)
    assert not codecs.guard_note(True, window=3)
    assert not codecs.guard_note(True, window=3)
    codecs.guard_note(False, window=3)
    assert not req._codec_demoted
    assert not codecs.guard_note(True, window=3, step=7)
    assert not codecs.guard_note(True, window=3, step=8)
    assert codecs.guard_note(True, window=3, step=9)
    assert req._codec_demoted and req.codec_name == "int8"
    assert req.codec_source == "demoted" and req.algo == "quant_ring"
    assert not codecs.guard_active() and codecs.guard_status()["breach_streak"] == 0
    assert stats.CODEC_COUNTERS["demotions"] == 1
    assert stats.CODEC_COUNTERS["guard_breaches"] == 5
    assert any("codec:prune -> int8" in d for d in stats.CODEC_DEMOTIONS)

    prune = codecs.get("prune", ratio=0.25)
    slices = req._chunk_slices

    def residual(x):
        out = []
        for sl in slices:
            part = x[sl]
            m = part.shape[0]
            chunk = -(-m // 8)
            padded = np.pad(part, (0, 8 * chunk - m)).reshape(8, chunk)
            enc = prune.decode(prune.encode(torch.from_numpy(padded)), chunk).numpy()
            out.append((padded - enc).reshape(-1)[:m])
        return np.concatenate(out)

    oracle = _req(tenv, td, n, name="oracle_int8")
    assert oracle.codec_name == "int8" and oracle.algo == "quant_ring"
    vals2 = _normal_vals(n, seed=41)
    flushed = {p: vals2[p] + residual(vals1[p]) for p in range(8)}
    np.testing.assert_array_equal(_round(td, req, vals2, n), _round(td, oracle, flushed, n))
    assert req._pending_flush is None
    vals3 = _normal_vals(n, seed=42)
    np.testing.assert_array_equal(_round(td, req, vals3, n), _round(td, oracle, vals3, n))
    for a, b in zip(req._errs, oracle._errs):
        assert torch.equal(a, b)


def test_demotion_before_first_round_is_plain_int8(tenv):
    n = 512
    td = tenv.create_distribution(8, 1)
    req = _calibrated_prune_req(tenv, td, n)
    req.demote_codec("test")
    oracle = _req(tenv, td, n, name="oracle")
    vals = _normal_vals(n, seed=50)
    np.testing.assert_array_equal(_round(td, req, vals, n), _round(td, oracle, vals, n))


def test_codecs_status_and_stats_line(tenv, tmp_path):
    """``codecs.status()`` is JSON with the registry, the guarded sets, the
    counters and the wire bytes; the statistics table prints the CODEC line
    the JAX package prints."""
    td = tenv.create_distribution(8, 1)
    req = _calibrated_prune_req(tenv, td, 512)
    _round(td, req, _normal_vals(512, seed=60), 512)
    st = codecs.status()
    json.dumps(st)
    assert set(st["registered"]) >= set(NAMES) and "g" in st["guarded"]
    assert st["wire_bytes"]["prune"] == codecs.get("prune", ratio=0.25).wire_len(512)
    s = tenv.create_session()
    text = s.get_stats().print_(str(tmp_path / "t.log"))
    assert "CODEC            LAB      calibrations 0 assignments 0 breaches 0 demotions 0 " \
           f"wire_bytes prune={st['wire_bytes']['prune']}" in text
