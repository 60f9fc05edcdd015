"""The port's collective algorithm engine (mlsl_tpu_torch.comm.algos) against
the JAX package's, and its composed lowerings against the JAX ones.

- ``parse_forced``, ``eligible``, ``candidates`` and ``select`` agree with the
  JAX engine over a grid of kind x group (on (8, 1) and (4, 2) grids) x
  payload x compression x op x forced / tuned / heuristic configuration. The
  JAX side runs with MLSL_PALLAS_INTERPRET=1 so that its kernel algorithms are
  eligible off the TPU, as the port's always are.
- Unknown algorithm names raise MLSLError, as in the JAX package; MLSL_TUNE=1
  sweeps at init.
- A tuned profile written to a file selects its cell through a CommRequest;
  a profile measured elsewhere is rejected with a warning.
- The composed ``rhd`` is bit-exact against ``mlsl_tpu.comm.algos.rhd`` on
  float32, int32, MIN and MAX; ``ring2d`` is bit-exact on integer-valued
  floats and within rtol 1e-6 (plus an absolute 1e-6 of the largest member
  sum) on random floats, where the two sum in different orders.
- One slice test end to end: the MLP data-parallel trainer with int8
  gradients and MLSL_ALGO=pallas_ring takes 2 steps on the port and on the
  JAX package from the same weights and batch, within the one-quantization-
  step bound of tests/test_torch_train.py.
"""

import itertools
import json
import logging

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.comm import algos as jalgos
from mlsl_tpu.comm.mesh import ProcessGroup as JGroup, Topology as JTopo
from mlsl_tpu.config import Config as JConfig
from mlsl_tpu.core.environment import Environment as JEnv
from mlsl_tpu.models.mlp import LAYERS, get_layer as jget_layer, init as mlp_init
from mlsl_tpu.models.mlp import loss_fn as jmlp_loss
from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
from mlsl_tpu.tuner.profile import TunedProfile as JProfile
from mlsl_tpu.types import CompressionType as JComp, ReductionType as JRed
from mlsl_tpu_torch import sysinfo
from mlsl_tpu_torch.comm import algos as talgos
from mlsl_tpu_torch.comm.mesh import ProcessGroup as TGroup, Topology as TTopo
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.config import Config as TConfig
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.models import mlp as tmlp
from mlsl_tpu_torch.models.convert import params_from_jax, params_to_jax
from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer
from mlsl_tpu_torch.tuner import TunedProfile as TProfile
from mlsl_tpu_torch.types import CompressionType, DataType, ReductionType

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _interpret_gate(monkeypatch):
    monkeypatch.setenv("MLSL_PALLAS_INTERPRET", "1")


# -- the selection table ----------------------------------------------------------

GRIDS = {(8, 1): [("data",), ("model",), ("replica", "data", "seq", "model")],
         (4, 2): [("data",), ("model",), ("data", "model"),
                  ("replica", "data", "seq", "model")]}
GROUPS = [(d, m, axes) for (d, m), groups in GRIDS.items() for axes in groups]
KINDS = ("allreduce", "reduce_scatter", "bcast")
PAYLOADS = (4096, 40_000, 40_004, 1 << 20)
FORCED = ("", "lax", "rhd", "ring2d", "pallas_ring", "pallas_ring2d", "pallas_rhd",
          "allreduce=pallas_rhd,reduce_scatter=rhd", "reduce_scatter=pallas_ring2d")

CELLS = [
    {"kind": "allreduce", "shape": [8], "compression": "none", "max_bytes": 40_000,
     "algo": "pallas_rhd"},
    {"kind": "allreduce", "shape": [8], "compression": "none", "max_bytes": None,
     "algo": "pallas_ring"},
    {"kind": "allreduce", "shape": [4, 2], "compression": "none", "max_bytes": None,
     "algo": "pallas_ring2d"},
    {"kind": "reduce_scatter", "shape": [4], "compression": "none", "max_bytes": 8192,
     "algo": "rhd"},
    {"kind": "allreduce", "shape": [8], "compression": "quantization", "max_bytes": None,
     "algo": "pallas_ring"},
    {"kind": "allreduce", "shape": [2], "compression": "none", "max_bytes": None,
     "algo": "lax"},
]


def _configs(forced, tuned, rhd_armed, block):
    jc, tc = JConfig(), TConfig()
    for c in (jc, tc):
        c.pallas_rhd = rhd_armed
        c.quant_block_elems = block
    jc._forced_algos = jalgos.parse_forced(forced)
    tc._forced_algos = talgos.parse_forced(forced)
    assert tc._forced_algos == jc._forced_algos
    if tuned:
        fp = {"platform": "cpu"}
        jc.tuned_profile = JProfile(fingerprint=fp, cells=CELLS)
        tc.tuned_profile = TProfile(fingerprint=fp, cells=CELLS)
    return jc, tc


@pytest.mark.parametrize("d,m,axes", GROUPS, ids=lambda v: str(v))
def test_eligible_and_candidates_match_jax(d, m, axes):
    jg, tg = JGroup(JTopo(d, m), axes), TGroup(TTopo(d, m, 8), axes)
    assert talgos.group_shape(tg) == jalgos.group_shape(jg)
    for kind in KINDS:
        for op in (None, ReductionType.SUM, ReductionType.MIN, ReductionType.MAX):
            jop = None if op is None else JRed(int(op))
            assert talgos.candidates(kind, tg, op) == jalgos.candidates(kind, jg, jop)
            for algo in talgos.ALGORITHMS:
                assert talgos.eligible(algo, kind, tg, op) == \
                    jalgos.eligible(algo, kind, jg, jop), (algo, kind, op)


@pytest.mark.parametrize("forced", FORCED)
@pytest.mark.parametrize("tuned", [False, True], ids=["untuned", "tuned"])
def test_select_matches_jax(forced, tuned):
    groups = [(JGroup(JTopo(d, m), axes), TGroup(TTopo(d, m, 8), axes))
              for d, m, axes in GROUPS]
    picked = set()
    for rhd_armed, block in ((False, 256), (True, 256), (True, 96)):
        jc, tc = _configs(forced, tuned, rhd_armed, block)
        for (jg, tg), kind, payload, comp, op in itertools.product(
                groups, KINDS, PAYLOADS, (CompressionType.NONE, CompressionType.QUANTIZATION),
                (ReductionType.SUM, ReductionType.MAX)):
            want = jalgos.select(kind, jg, payload, JComp(int(comp)), jc, op=JRed(int(op)))
            got = talgos.select(kind, tg, payload, comp, tc, op=op)
            assert got == want, (forced, tuned, rhd_armed, block, tg.axes, kind, payload,
                                 comp, op)
            picked.add(got)
    if not tuned and forced in ("", "lax"):
        # the heuristic rung fires only when nothing is forced; a forced
        # 'lax' pins the baseline
        assert picked == ({"lax", "pallas_rhd"} if forced == "" else {"lax"})


@pytest.mark.parametrize("spec", ["hier", "pallas_a2a", "allreduce=hier",
                                  "reduce_scatter=pallas_a2a", "alltoall=lax", "nope",
                                  "allreduce=nope", "bcast=rhd", "allreduce"])
def test_names_not_ported_raise(spec, monkeypatch):
    """Every spec parses as the JAX package's parse_forced does (``hier``
    too, since the two-tier lowering is ported): the same result where JAX
    accepts it, MLSLError (and no Environment) where JAX raises."""
    monkeypatch.setenv("MLSL_ALGO", spec)
    env = Environment.get_env()
    try:
        want = jalgos.parse_forced(spec)
    except Exception:
        with pytest.raises(MLSLError):
            talgos.parse_forced(spec)
        with pytest.raises(MLSLError):
            env.init(device="cpu", world_size=8)
        assert not Environment.is_initialized()
        return
    assert talgos.parse_forced(spec) == want
    env.init(device="cpu", world_size=8)
    try:
        assert env.config._forced_algos == want
    finally:
        env.finalize()


def test_config_fields_and_validation(monkeypatch, tmp_path):
    jc, tc = JConfig(), TConfig()
    for name in ("collective_algo", "tune", "tune_profile", "tuned_profile",
                 "pallas_ring_bidir", "pallas_rhd", "pallas_rhd_max_bytes"):
        assert getattr(tc, name) == getattr(jc, name), name
    for env_name, value, field, want in [
            ("MLSL_ALGO", "rhd", "collective_algo", "rhd"),
            ("MLSL_PALLAS_RING_BIDIR", "1", "pallas_ring_bidir", True),
            ("MLSL_PALLAS_RHD", "yes", "pallas_rhd", True),
            ("MLSL_PALLAS_RHD_MAX_BYTES", "4096", "pallas_rhd_max_bytes", 4096),
            ("MLSL_TUNE_PROFILE", "p.json", "tune_profile", "p.json")]:
        monkeypatch.setenv(env_name, value)
        assert getattr(TConfig.from_env(), field) == getattr(JConfig.from_env(), field) == want
    # the TPU's comm-slot count has no counterpart on the card
    monkeypatch.setenv("MLSL_PALLAS_RING_SLOTS", "1")
    assert not hasattr(TConfig.from_env(), "pallas_ring_slots")
    TConfig.from_env().validate()
    bad = TConfig()
    bad.pallas_rhd_max_bytes = -1
    with pytest.raises(MLSLError, match="RHD_MAX_BYTES"):
        bad.validate()
    # MLSL_TUNE=1 sweeps at init (tests/test_torch_tuner_sweep.py) and writes
    # the profile where MLSL_TUNE_PROFILE points
    monkeypatch.setenv("MLSL_TUNE_PROFILE", str(tmp_path / "swept.json"))
    monkeypatch.setenv("MLSL_TUNE", "1")
    monkeypatch.setenv("MLSL_TUNE_SIZES", "4")
    monkeypatch.setenv("MLSL_TUNE_ITERS", "1")
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert env.config.tune and env.config.tuned_profile is not None
        assert (tmp_path / "swept.json").exists()
    finally:
        env.finalize()


# -- requests select through the table -------------------------------------------


def _req(env, kind, group, count, compression=CompressionType.NONE,
         data_type=DataType.FLOAT):
    req = CommRequest(CommDesc(kind, group, count, data_type, op=ReductionType.SUM,
                               recv_count=count // group.size if kind == "reduce_scatter"
                               else None, compression=compression), env.dispatcher)
    req.setup()
    return req


def test_requests_carry_the_selected_algorithm(monkeypatch):
    monkeypatch.setenv("MLSL_PALLAS_RHD", "1")
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        dist = env.create_distribution(8, 1)
        g = dist.data_group
        assert _req(env, "allreduce", g, 1024).algo == "pallas_rhd"          # 4 KiB
        assert _req(env, "allreduce", g, 10_000).algo == "pallas_rhd"        # 40,000 B
        assert _req(env, "allreduce", g, 10_001).algo == "lax"               # 40,004 B
        assert _req(env, "reduce_scatter", g, 800).algo == "lax"
        assert _req(env, "allreduce", g, 1000, CompressionType.QUANTIZATION).algo == \
            "quant_ring"
        x = torch.arange(8 * 1024, dtype=torch.float32).reshape(1, 8, 1, 1, 1024)
        out = _req(env, "allreduce", g, 1024).start(x).wait()
        assert torch.equal(out, x.sum(dim=1, keepdim=True).expand_as(x))
    finally:
        env.finalize()


@pytest.mark.parametrize("algo", ["rhd", "pallas_ring", "pallas_rhd"])
def test_forced_algorithm_reaches_the_request(algo, monkeypatch):
    """MLSL_ALGO picks the lowering of a Distribution collective; a chunked
    request selects once, on the full payload, and runs it per chunk."""
    monkeypatch.setenv("MLSL_ALGO", algo)
    monkeypatch.setenv("MLSL_LARGE_MSG_SIZE_MB", "1")
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        dist = env.create_distribution(8, 1)
        n = (1 << 20) // 4 + 333         # just over 1 MiB: chunked
        x = dist.make_buffer(lambda p: p * 1000.0 + np.arange(n) % 97, n)
        req = dist.all_reduce(x, n, DataType.FLOAT, ReductionType.SUM, 0)
        out = env.wait(req)
        assert req.algo == algo and len(req._chunk_slices) == 4
        assert torch.equal(out, x.sum(dim=1, keepdim=True).expand_as(x))
        q = dist.all_reduce(x, n, DataType.FLOAT, ReductionType.SUM, 0,
                            compression=CompressionType.QUANTIZATION)
        env.wait(q)
        assert q.algo == ("pallas_ring" if algo == "pallas_ring" else "quant_ring")
    finally:
        env.finalize()


# -- tuned profiles ---------------------------------------------------------------


def _write_profile(path, fingerprint, cells=CELLS, knobs=None, codecs=None):
    doc = {"version": 1, "fingerprint": fingerprint, "created": "", "cells": cells,
           "knobs": knobs or {}}
    if codecs:
        doc["codecs"] = codecs
    path.write_text(json.dumps(doc))
    return str(path)


def test_tuned_profile_selects_its_cell(tmp_path, monkeypatch, caplog):
    fp = sysinfo.topology_fingerprint(8, torch.device("cpu"))
    path = _write_profile(tmp_path / "p.json", fp,
                          knobs={"pallas_rhd_max_bytes": 4096, "overlap_stages": 3,
                                 "pallas_ring_slots": 1},
                          codecs={"l1": {"codec": "int8"}})
    monkeypatch.setenv("MLSL_TUNE_PROFILE", path)
    with caplog.at_level(logging.WARNING, logger="mlsl_tpu_torch"):
        env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert env.config.tuned_profile is not None
        assert env.config.pallas_rhd_max_bytes == 4096
        assert env.config.overlap_stages == 3              # a knob the sweep writes
        assert env.config.codec_assignment == {"l1": {"codec": "int8"}}   # applied
        assert "pallas_ring_slots" in caplog.text          # named, not applied
        assert not hasattr(env.config, "pallas_ring_slots")
        g = env.create_distribution(8, 1).data_group
        assert _req(env, "allreduce", g, 1000).algo == "pallas_rhd"
        assert _req(env, "allreduce", g, 20_000).algo == "pallas_ring"
        assert _req(env, "allreduce", g, 1000, CompressionType.QUANTIZATION).algo == \
            "pallas_ring"
        g2 = env.create_distribution(4, 2)
        assert _req(env, "allreduce", g2.global_group, 1000).algo == "pallas_ring2d"
        assert _req(env, "reduce_scatter", g2.data_group, 1024).algo == "rhd"
        assert _req(env, "allreduce", g2.model_group, 1000).algo == "lax"
    finally:
        env.finalize()


def test_exported_knob_beats_the_profile(tmp_path, monkeypatch):
    fp = sysinfo.topology_fingerprint(8, torch.device("cpu"))
    monkeypatch.setenv("MLSL_TUNE_PROFILE", _write_profile(
        tmp_path / "p.json", fp, knobs={"pallas_rhd_max_bytes": 4096}))
    monkeypatch.setenv("MLSL_PALLAS_RHD_MAX_BYTES", "8192")
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert env.config.pallas_rhd_max_bytes == 8192
    finally:
        env.finalize()


@pytest.mark.parametrize("change", [{"platform": "tpu", "device_kind": "TPU v5 lite"},
                                    {"num_devices": 4}])
def test_mismatched_fingerprint_is_rejected_with_a_warning(tmp_path, monkeypatch, caplog,
                                                           change):
    fp = {**sysinfo.topology_fingerprint(8, torch.device("cpu")), **change}
    monkeypatch.setenv("MLSL_TUNE_PROFILE", _write_profile(tmp_path / "p.json", fp))
    with caplog.at_level(logging.WARNING, logger="mlsl_tpu_torch"):
        env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert env.config.tuned_profile is None
        assert "different topology" in caplog.text
        g = env.create_distribution(8, 1).data_group
        assert _req(env, "allreduce", g, 1000).algo == "lax"
    finally:
        env.finalize()


@pytest.mark.parametrize("doc,match", [
    (None, "missing file"), ("{not json", "corrupt"), ({"cells": []}, "not a tuner profile"),
    ({"version": 2, "fingerprint": {}, "cells": []}, "unsupported version"),
    ({"version": 1, "fingerprint": {}, "cells": [], "knobs": {"hier_dcn_codec": "fp8"}},
     "hier_dcn_codec"),
    ({"version": 1, "fingerprint": {}, "cells": [{"algo": "nope"}]}, "not a registered"),
    ({"version": 1, "fingerprint": {}, "cells": [], "knobs": {"pallas_rhd_max_bytes": -1}},
     "invalid knob"),
])
def test_bad_profiles_raise_at_init(tmp_path, monkeypatch, doc, match):
    path = tmp_path / "p.json"
    if doc is not None:
        path.write_text(doc if isinstance(doc, str) else json.dumps(doc))
    monkeypatch.setenv("MLSL_TUNE_PROFILE", str(path))
    with pytest.raises(MLSLError, match=match):
        Environment.get_env().init(device="cpu", world_size=8)
    assert not Environment.is_initialized()


# -- the composed lowerings ---------------------------------------------------------


COMPOSED = [
    ("rhd", (8, 1), ("data",), "allreduce", ReductionType.SUM, "float32", 1001),
    ("rhd", (8, 1), ("data",), "reduce_scatter", ReductionType.SUM, "float32", 8 * 300),
    ("rhd", (4, 2), ("data", "model"), "allreduce", ReductionType.MIN, "float32", 777),
    ("rhd", (4, 2), ("data",), "reduce_scatter", ReductionType.MAX, "float32", 4 * 250),
    ("rhd", (8, 1), ("data",), "allreduce", ReductionType.SUM, "int32", 999),
    ("rhd", (4, 2), ("model",), "reduce_scatter", ReductionType.SUM, "int32", 2 * 512),
    ("rhd", (6, 1), ("data",), "allreduce", ReductionType.SUM, "float32", 1500),
    ("rhd", (6, 1), ("data",), "reduce_scatter", ReductionType.MAX, "float32", 6 * 100),
    ("rhd", (3, 1), ("data",), "allreduce", ReductionType.MIN, "int32", 500),
    ("ring2d", (4, 2), ("data", "model"), "allreduce", ReductionType.SUM, "float32", 1001),
    ("ring2d", (4, 2), ("replica", "data", "seq", "model"), "reduce_scatter",
     ReductionType.SUM, "float32", 8 * 128),
    ("ring2d", (2, 4), ("data", "model"), "allreduce", ReductionType.SUM, "int32", 333),
]


@pytest.mark.parametrize("algo,grid,axes,kind,op,dtype,count", COMPOSED,
                         ids=[f"{c[0]}-{c[3]}-{c[4].name}-{c[5]}-{c[1]}-{len(c[2])}ax"
                              for c in COMPOSED])
def test_composed_lowerings_match_jax(algo, grid, axes, kind, op, dtype, count):
    w = grid[0] * grid[1]
    jg = JGroup(JTopo(*grid, devices=jax.devices()[:w]), axes)
    tg = TGroup(TTopo(*grid, w), axes)
    rng = np.random.default_rng(count)
    shape = (*jg.topology.grid_shape, count)
    kw = {"op": op}
    if kind == "reduce_scatter":
        kw["recv_count"] = count // tg.size
    inputs = [rng.integers(-10 ** 6, 10 ** 6, size=shape).astype(dtype)]
    if dtype == "float32":
        inputs.append((rng.normal(size=shape) * rng.uniform(0.1, 100, size=(*shape[:-1], 1))
                       ).astype(np.float32))
    jfn = jalgos.build(kind, jg, np.dtype(dtype), algo, **{**kw, "op": JRed(int(op))})
    tfn = talgos.build(kind, tg, algo, **kw)
    for i, x in enumerate(inputs):
        want = np.asarray(jfn(jg.topology.shard_buffer(x)))
        got = tfn(torch.from_numpy(x)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        if algo == "rhd" or i == 0:
            np.testing.assert_array_equal(got, want)
        else:
            scale = np.abs(x).sum(axis=(0, 1, 2, 3)).max()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


# -- the slice end to end -------------------------------------------------------------


def test_mlp_trainer_on_the_fused_int8_ring_matches_jax(monkeypatch):
    monkeypatch.setenv("MLSL_ALGO", "pallas_ring")
    jenv = JEnv.get_env().init()
    tenv = Environment.get_env().init(device="cpu", world_size=8)
    try:
        params = mlp_init(jax.random.PRNGKey(3))
        jd, td = jenv.create_distribution(8, 1), tenv.create_distribution(8, 1)
        js, ts = jenv.create_session(), tenv.create_session()
        js.set_global_minibatch_size(32)
        ts.set_global_minibatch_size(32)
        jt = JTrainer(jenv, jd, js, params, jmlp_loss, LAYERS, jget_layer,
                      compression=JComp.QUANTIZATION, lr=0.1)
        model = tmlp.MLP(device="cpu",
                         params=params_from_jax(jax.tree.map(np.asarray, params),
                                                device="cpu"))
        tt = TTrainer(tenv, td, ts, model, tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer,
                      compression=CompressionType.QUANTIZATION, lr=0.1)
        for name in LAYERS:
            assert jt.ops[name].get_parameter_set(0).grad_req.algo == "pallas_ring"
            assert tt.ops[name].get_parameter_set(0).grad_req.algo == "pallas_ring"
        rng = np.random.default_rng(0)
        x = rng.normal(size=(32, 8)).astype(np.float32)
        y = rng.integers(0, 4, size=(32,)).astype(np.int32)
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
