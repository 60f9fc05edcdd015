"""The port's user codecs (mlsl_tpu_torch.comm.codec) against the JAX
package's (mlsl_tpu.comm.codec), mirroring tests/test_codec.py.

Both plug-in forms of ``set_quantization_params``: Python callables (here on
torch tensors, there on jax arrays, the same arithmetic) and a library of the
reference's ABI (``native/sample_codec.c``, a float16 truncation codec,
compiled with gcc). The same numpy-seeded buffers go through JAX on the
8-device CPU mesh and through the port on 8 CPU virtual ranks. Tolerances:

- the compressed ring against JAX's: bit for bit, results and residuals
  (the same hop order; float16 conversion rounds to nearest even in numpy,
  XLA and torch alike; the library is the same C code);
- against the exact sum: the reference's own bounds (rtol 1e-5 for the
  identity codec, a median relative error under 1 % for float16).
"""

import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsl_tpu.comm.request import CommDesc as JDesc, CommRequest as JReq
from mlsl_tpu.types import (
    CompressionType as JComp, DataType as JDT, GroupType as JGT, QuantParams as JQP,
    ReductionType as JRed,
)
from mlsl_tpu_torch import c_shim
from mlsl_tpu_torch.comm import codec as tcodec
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.types import (
    CompressionType, DataType, GroupType, OpType, QuantParams, ReductionType,
)

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _sample_codec(tmp_path) -> str:
    so = str(tmp_path / "libsample_codec.so")
    subprocess.run(["gcc", "-shared", "-fPIC", "-O2", "-o", so,
                    os.path.join(REPO, "native", "sample_codec.c")], check=True,
                   capture_output=True)
    return so


def _lib_params(qp, so, **kw):
    base = dict(lib_path=so, quant_buffer_func_name="sample_compress",
                dequant_buffer_func_name="sample_decompress",
                reduce_sum_func_name="sample_reduce_sum", elem_in_block=128, block_size=256)
    base.update(kw)
    return qp(**base)


# the same codecs on both sides: (JAX QuantParams kwargs, port QuantParams kwargs)
CODECS = {
    "identity": (dict(compress_fn=lambda x: x, decompress_fn=lambda p, n: p),
                 dict(compress_fn=lambda x: x, decompress_fn=lambda p, n: p)),
    "f16": (dict(compress_fn=lambda x: x.astype(jnp.float16),
                 decompress_fn=lambda p, n: p.astype(jnp.float32)),
            dict(compress_fn=lambda x: x.to(torch.float16),
                 decompress_fn=lambda p, n: p.to(torch.float32))),
    "f16-reduce": (dict(compress_fn=lambda x: x.astype(jnp.float16),
                        decompress_fn=lambda p, n: p.astype(jnp.float32),
                        reduce_sum_fn=lambda a, b: a + b),
                   dict(compress_fn=lambda x: x.to(torch.float16),
                        decompress_fn=lambda p, n: p.to(torch.float32),
                        reduce_sum_fn=lambda a, b: a + b)),
}


def _req(e, dist, kind, n, mod, recv_count=None):
    desc, req, dt, rd, comp = mod
    r = req(desc(kind, dist._group(GroupType.DATA if req is CommRequest else JGT.DATA), n,
                 dt.FLOAT, op=rd.SUM, recv_count=recv_count, compression=comp.QUANTIZATION),
            e.dispatcher)
    r.setup()
    return r


JMOD = (JDesc, JReq, JDT, JRed, JComp)
TMOD = (CommDesc, CommRequest, DataType, ReductionType, CompressionType)


def _round(dist, req, vals, n):
    req.start(dist.make_buffer(lambda p: vals[p], n))
    return np.asarray(dist.local_part(req.wait(), 0))


def _vals(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {p: (rng.normal(size=n) * scale).astype(np.float32) for p in range(8)}


def _twins(env, tenv, jparams, tparams, kind, n, recv_count=None):
    env.set_quantization_params(JQP(**jparams))
    tenv.set_quantization_params(QuantParams(**tparams))
    jd, td = env.create_distribution(8, 1), tenv.create_distribution(8, 1)
    jr = _req(env, jd, kind, n, JMOD, recv_count)
    tr = _req(tenv, td, kind, n, TMOD, recv_count)
    assert jr.algo == tr.algo == "custom_codec" and tr.codec_name == "custom"
    return jd, jr, td, tr


@pytest.mark.parametrize("name", list(CODECS))
@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter"])
def test_python_codec_ring_matches_jax(env, tenv, name, kind):
    """Callable codecs through the compressed ring, two rounds (the second
    carries the residual): every rank's result and every residual bit for
    bit JAX's; close to the exact sum."""
    n = 2048
    jd, jr, td, tr = _twins(env, tenv, *CODECS[name], kind, n,
                            recv_count=n // 8 if kind == "reduce_scatter" else None)
    for r in range(2):
        vals = _vals(n, r, scale=5.0)
        jr.start(jd.make_buffer(lambda p: vals[p], n))
        jout = jr.wait()
        tr.start(td.make_buffer(lambda p: vals[p], n))
        tout = tr.wait()
        for p in range(8):
            np.testing.assert_array_equal(td.local_part(tout, p), np.asarray(jd.local_part(jout, p)))
        np.testing.assert_array_equal(tr._errs[0].numpy(), np.asarray(jr._err))
    want = np.sum([vals[p] for p in range(8)], axis=0)
    got = td.local_part(tout, 0)
    want = want if kind == "allreduce" else want[:n // 8]
    if name == "identity":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert not tr._errs[0].any()
    else:
        assert np.median(np.abs(got - want) / (np.abs(want) + 1e-3)) < 0.01
        assert float(tr._errs[0].abs().sum()) > 0.0


def test_public_allreduce_compression_kwarg(tenv):
    """Distribution.all_reduce(compression=QUANTIZATION) rides the codec."""
    n = 512
    tenv.set_quantization_params(QuantParams(**CODECS["identity"][1]))
    td = tenv.create_distribution(8, 1)
    vals = _vals(n, 5)
    req = td.all_reduce(td.make_buffer(lambda p: vals[p], n), n, DataType.FLOAT,
                        ReductionType.SUM, GroupType.DATA,
                        compression=CompressionType.QUANTIZATION)
    out = tenv.wait(req)
    assert req.algo == "custom_codec"
    np.testing.assert_allclose(td.local_part(out, 0), np.sum(list(vals.values()), axis=0),
                               rtol=1e-5, atol=1e-5)


def test_codec_through_parameter_set_grad_path(tenv):
    """The codec rides a QUANTIZATION parameter set's gradient request."""
    tenv.set_quantization_params(QuantParams(**CODECS["f16"][1]))
    td = tenv.create_distribution(8, 1)
    s = tenv.create_session()
    s.set_global_minibatch_size(8)
    r = s.create_operation_reg_info(OpType.CC)
    r.add_input(8, 4)
    r.add_output(8, 4)
    r.add_parameter_set(512, 1, compression_type=CompressionType.QUANTIZATION)
    op = s.get_operation(s.add_operation(r, td))
    s.commit()
    ps = op.get_parameter_set(0)
    assert ps.grad_req.algo == "custom_codec" and ps.codec_name == "custom"
    ps.start_gradient_comm(td.make_buffer(lambda p: np.full(512, p + 1.0, np.float32), 512))
    np.testing.assert_allclose(td.local_part(ps.wait_gradient_comm(), 0), np.full(512, 36.0),
                               rtol=0.01)


def test_chunked_large_allreduce_with_custom_codec(env, tenv):
    """Above the large-message threshold a codec allreduce runs one program
    and one residual a chunk, bit for bit JAX's."""
    for e in (env, tenv):
        e.config.large_msg_size_mb = 1
        e.config.large_msg_chunks = 4
    n = 1 << 19
    jd, jr, td, tr = _twins(env, tenv, *CODECS["f16"], "allreduce", n)
    assert len(tr._quant_fns) == 4 and len(jr._quant_fns) == 4
    vals = _vals(n, 4)
    jr.start(jd.make_buffer(lambda p: vals[p], n))
    tr.start(td.make_buffer(lambda p: vals[p], n))
    got = td.local_part(tr.wait(), 0)
    np.testing.assert_array_equal(got, np.asarray(jd.local_part(jr.wait(), 0)))
    want = np.sum([vals[p] for p in range(8)], axis=0)
    assert np.median(np.abs(got - want) / (np.abs(want) + 1e-3)) < 0.01


def test_registration_lifecycle(tenv):
    """Unset restores the built-in codec; a failed load leaves the previous
    registration whole; the C entry's bogus path fails because it cannot be
    opened (native/test_c_api.c:367-372)."""
    tenv.set_quantization_params(QuantParams(**CODECS["identity"][1]))
    good, good_params = tenv.config.custom_codec, tenv.get_quantization_params()
    assert good is not None
    with pytest.raises(MLSLError, match="can't be opened"):
        tenv.set_quantization_params(QuantParams(
            lib_path="/nonexistent/libcodec.so", elem_in_block=17,
            quant_buffer_func_name="c", dequant_buffer_func_name="d", reduce_sum_func_name="r"))
    assert tenv.config.custom_codec is good
    assert tenv.get_quantization_params() is good_params
    assert tenv.config.quant_block_elems != 17
    with pytest.raises(MLSLError, match="can't be opened"):
        c_shim.env_set_quantization_params("/nonexistent/libcodec.so", "c", "d", "r", 256, 256)
    assert tenv.config.custom_codec is good
    tenv.set_quantization_params(QuantParams())
    assert tenv.config.custom_codec is None


def test_pre_init_registration_and_failed_deferred_load(tmp_path, monkeypatch):
    """A registration made before init applies at init; a library that no
    longer loads at init unwinds it, and a retry loads it again."""
    e = Environment.get_env()
    assert not e._initialized
    e.set_quantization_params(QuantParams(**CODECS["identity"][1]))
    e.init(device="cpu", world_size=8)
    assert e.config.custom_codec is not None
    e.finalize()

    so = _sample_codec(tmp_path)
    e = Environment.get_env()
    e.set_quantization_params(_lib_params(QuantParams, so))

    def boom(_params):
        raise MLSLError("injected load failure")

    real = tcodec.load_library_codec
    monkeypatch.setattr(tcodec, "load_library_codec", boom)
    with pytest.raises(MLSLError, match="injected"):
        e.init(device="cpu", world_size=8)
    assert not e._initialized and e.config is None
    monkeypatch.setattr(tcodec, "load_library_codec", real)
    e.init(device="cpu", world_size=8)
    try:
        assert e._initialized and e.config.custom_codec is not None
        assert e.config.quant_block_elems == 128
    finally:
        e.finalize()


@pytest.mark.parametrize("bad,match", [
    (dict(quant_buffer_func_name="no_such_symbol"), "can't be loaded"),
    (dict(elem_in_block=256, block_size=256), "geometry mismatch"),
])
def test_library_codec_load_failures(env, tenv, tmp_path, bad, match):
    """A missing symbol and an under-declared block geometry fail at
    registration in both packages, leaving the built-in codec."""
    from mlsl_tpu.log import MLSLError as JError

    so = _sample_codec(tmp_path)
    with pytest.raises(JError, match=match):
        env.set_quantization_params(_lib_params(JQP, so, **bad))
    with pytest.raises(MLSLError, match=match):
        tenv.set_quantization_params(_lib_params(QuantParams, so, **bad))
    assert tenv.config.custom_codec is None


@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter"])
def test_library_codec_matches_jax(env, tenv, tmp_path, kind):
    """The reference's dlopen contract end to end: the sample codec with its
    compressed-domain reduce, two rounds, bit for bit JAX's results and
    residuals, and close to the exact sum; the wire accounting is the
    library's declared geometry; the C entry registers the same library."""
    so = _sample_codec(tmp_path)
    n = 1024
    env.set_quantization_params(_lib_params(JQP, so))
    tenv.set_quantization_params(_lib_params(QuantParams, so))
    jd, td = env.create_distribution(8, 1), tenv.create_distribution(8, 1)
    rc = n // 8 if kind == "reduce_scatter" else None
    jr, tr = _req(env, jd, kind, n, JMOD, rc), _req(tenv, td, kind, n, TMOD, rc)
    assert tr.algo == "custom_codec" and tr._wire_rec == ("custom", 2 * n)
    tcodec.reset_timings()
    for r in range(2):
        vals = _vals(n, 3 + r, scale=3.0)
        jr.start(jd.make_buffer(lambda p: vals[p], n))
        tr.start(td.make_buffer(lambda p: vals[p], n))
        jout, tout = jr.wait(), tr.wait()
        for p in range(8):
            np.testing.assert_array_equal(td.local_part(tout, p), np.asarray(jd.local_part(jout, p)))
        np.testing.assert_array_equal(tr._errs[0].numpy(), np.asarray(jr._err))
    assert tcodec.TIMINGS["calls"] > 0 and tcodec.TIMINGS["h2d_s"] == 0.0  # the CPU: no copy
    want = np.sum([vals[p] for p in range(8)], axis=0)[:n if rc is None else rc]
    got = td.local_part(tout, 0)
    assert np.median(np.abs(got - want) / (np.abs(want) + 1e-3)) < 0.01
    assert c_shim.env_set_quantization_params(so, "sample_compress", "sample_decompress",
                                              "sample_reduce_sum", 256, 128) == 0
    assert tenv.config.custom_codec is not None and tenv.config.quant_block_elems == 128
