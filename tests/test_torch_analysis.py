"""The port's commit-time plan verifier, linter and analysis CLI
(mlsl_tpu_torch.analysis) against the JAX package's, anchored on
tests/test_analysis.py.

Both packages build the same sessions from the same sizes and environment
variables (the JAX side runs the reference's own fixture modules under
tests/fixtures/analysis/, the port side the same construction in its own
types), and their findings are compared as sets of ``(code, anchor)``:

- the healthy-graph matrix (test_analysis.py:242, :259) and the registry
  codec sessions (:417): no finding in either package, ``MLSL_VERIFY=1``
  commits green;
- every fixture the reference pins: misordered groups (verify_session, at
  commit under ``error`` and under ``warn``), the straddling bucket, codec
  geometry, the in-flight overcommit, the err_len mismatch, the missing
  degrade geometry (the reference's ``_degrade_geoms``; the port derives it
  from ``_err_lens``, so its tamper empties that) and overlap-plan
  tampering;
- ``verify_hop_trace`` on the reference's own kernel traces
  (``static_accounting`` of its TPU kernels, which the port's CUDA kernels
  do not emit), the codes table, status / ANALYSIS line / trace instants, and
  the CLI's exit codes.

Stated apart: A201's torch form (a raw ``torch.distributed`` collective; the
reference flags ``lax`` collectives, which the port cannot contain) and the
kernel routes' CUDA launch limits (A111/A132 at error severity, standing
difference "A130-A132 on the CUDA routes"). A verified session's step is
bit for bit its unverified twin's, on the host path and in the compiled
engine. The reference's live-timing overhead test is not ported: the card's
run (ac1) prints verify ms against commit ms instead.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.analysis import diagnostics as jdiag
from mlsl_tpu.analysis import lint as jlint
from mlsl_tpu.analysis import plan as jplan
from mlsl_tpu.core import stats as jstats
from mlsl_tpu.log import MLSLError as JMLSLError
from mlsl_tpu.types import CompressionType as JComp
from mlsl_tpu.types import OpType as JOp
from mlsl_tpu_torch import supervisor
from mlsl_tpu_torch.analysis import diagnostics, lint
from mlsl_tpu_torch.analysis import plan as plan_mod
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.core.environment import Environment as TEnvironment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.types import CompressionType as TComp
from mlsl_tpu_torch.types import OpType as TOp

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"

J = SimpleNamespace(name="jax", Op=JOp, Comp=JComp, plan=jplan, diag=jdiag, lint=jlint,
                    MLSLError=JMLSLError)
T = SimpleNamespace(name="torch", Op=TOp, Comp=TComp, plan=plan_mod, diag=diagnostics,
                    lint=lint, MLSLError=MLSLError)


def load_fixture(name):
    spec = importlib.util.spec_from_file_location(f"torch_analysis_fixture_{name}",
                                                  FIXTURES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _isolated():
    supervisor.reset_all()
    yield
    supervisor.reset_all()
    jdiag.reset()
    jstats.reset_analysis_counters()


@pytest.fixture()
def tenv():
    e = TEnvironment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _jax_env():
    from mlsl_tpu.core.environment import Environment

    return Environment.get_env().init()


def _torch_env():
    return TEnvironment.get_env().init(device="cpu", world_size=8)


def findings(rep):
    return {(d.code, d.anchor) for d in rep.diagnostics}


def codes_lines(rep):
    return sorted((d.code, d.anchor) for d in rep.diagnostics)


# -- the sessions: test_analysis.py's _build_net and the fixture builds ----------------


def _build_net(P, env, dist, n_ops=2, count=2048, compression="NONE", du=False, wire=True,
               batch=8):
    s = env.create_session()
    s.set_global_minibatch_size(batch)
    prev = None
    for i in range(n_ops):
        r = s.create_operation_reg_info(P.Op.CC)
        r.set_name(f"op{i}")
        if i:
            r.add_input(8, 4)
        r.add_output(8, 4)
        r.add_parameter_set(count, 1, distributed_update=du,
                            compression_type=getattr(P.Comp, compression))
        op = s.get_operation(s.add_operation(r, dist))
        if wire and prev is not None:
            prev.set_next(op, 0, 0)
        prev = op
    s.commit()
    return s


def _torch_misordered(env):
    """tests/fixtures/analysis/misordered_groups.py in the port's types."""
    env.config.msg_priority = True
    env.config.msg_priority_threshold = 4096
    n = env.get_process_count()
    colors = env.create_distribution_with_colors([p // max(n // 2, 1) for p in range(n)],
                                                 [0] * n)
    world = env.create_distribution(n, 1)
    s = env.create_session()
    s.set_global_minibatch_size(max(8, n))
    for name, count, dist in (("sub_small", 256, colors), ("world_big", 4096, world)):
        r = s.create_operation_reg_info(TOp.CC)
        r.set_name(name)
        r.add_output(4, 4)
        r.add_parameter_set(count, 1)
        s.add_operation(r, dist)
    s.commit()
    return s


def _torch_straddling(env):
    """tests/fixtures/analysis/straddling_bucket.py in the port's types."""
    env.config.grad_bucket_mb = 1
    n = env.get_process_count()
    dist = env.create_distribution(n, 1)
    s = env.create_session()
    s.set_global_minibatch_size(max(8, n))
    ops = []
    for i in range(2):
        r = s.create_operation_reg_info(TOp.CC)
        r.set_name(f"q{i}")
        r.add_output(4, 4)
        r.add_parameter_set(2048, 1, compression_type=TComp.QUANTIZATION)
        ops.append(s.get_operation(s.add_operation(r, dist)))
    s.commit()
    bucket = ops[0].parameter_sets[0].bucket
    assert bucket is not None, "fixture precondition: the sets must coalesce"
    bucket.offsets[1] -= 7
    bucket.slots[0] -= 7
    return s


def _torch_codec(env, codec, key, delta):
    """tests/fixtures/analysis/{tampered_vq_geometry,short_prune_mask}.py in
    the port's types: a healthy registry-codec route, then one pinned
    geometry field shifted."""
    env.config.codec = codec
    n = env.get_process_count()
    dist = env.create_distribution(n, 1)
    s = env.create_session()
    s.set_global_minibatch_size(max(8, n))
    r = s.create_operation_reg_info(TOp.CC)
    r.set_name({"vq": "vqop", "prune": "prop"}[codec])
    r.add_output(4, 4)
    r.add_parameter_set(2048, 1, compression_type=TComp.QUANTIZATION)
    op = s.get_operation(s.add_operation(r, dist))
    s.commit()
    req = op.parameter_sets[0].grad_req
    assert req.algo == f"codec:{codec}", "fixture precondition"
    req._codec_geoms[0][key] -= delta
    return s


# -- the healthy-graph matrix ----------------------------------------------------------

SWEEP = [
    ("plain", {}, {}),
    ("bucketed", {"MLSL_GRAD_BUCKET_MB": "1"}, {}),
    ("quant", {}, {"compression": "QUANTIZATION"}),
    ("quant_bucketed", {"MLSL_GRAD_BUCKET_MB": "1"}, {"compression": "QUANTIZATION"}),
    ("zero1", {}, {"du": True}),
    ("zero1_quant", {}, {"compression": "QUANTIZATION", "du": True}),
    ("topk", {}, {"compression": "TOPK"}),
    ("chunked", {"MLSL_LARGE_MSG_SIZE_MB": "1", "MLSL_LARGE_MSG_CHUNKS": "4"},
     {"count": 2 ** 21}),
    ("priority_same_group", {"MLSL_MSG_PRIORITY": "1", "MLSL_MSG_PRIORITY_THRESHOLD": "4096"},
     {"count": 4096}),
    # the JAX side needs the Pallas interpreter for its kernel route; the
    # port routes to B4 and runs its plain version on the CPU
    ("pallas_interpret", {"MLSL_PALLAS_INTERPRET": "1", "MLSL_ALGO": "pallas_ring"},
     {"compression": "QUANTIZATION"}),
    ("hier_dense", {"MLSL_MESH_TIERS": "2x4", "MLSL_ALGO": "hier"}, {}),
    ("hier_quant", {"MLSL_MESH_TIERS": "2x4", "MLSL_ALGO": "hier"},
     {"compression": "QUANTIZATION"}),
]


def _commit_both(monkeypatch, envvars, dists=((8, 1),), **netkw):
    """Commit the same net in both packages under MLSL_VERIFY=1 ->
    {pkg name: (verify_session findings, recorded plan verdict, algos)}."""
    monkeypatch.setenv("MLSL_VERIFY", "1")
    for k, v in envvars.items():
        monkeypatch.setenv(k, v)
    out = {}
    for P, make in ((J, _jax_env), (T, _torch_env)):
        env = make()
        try:
            s = _build_net(P, env, env.create_distribution(*dists[0]), **netkw)
            rep = P.plan.verify_session(s)
            algos = sorted({ps.grad_req.algo for op in s.operations
                            for ps in op.parameter_sets if ps.grad_req is not None})
        finally:
            env.finalize()
        out[P.name] = (findings(rep), P.diag.status()["plan"], algos)
    return out


@pytest.mark.parametrize("name,envvars,netkw", SWEEP, ids=[s[0] for s in SWEEP])
def test_verify_green_on_healthy_graphs(monkeypatch, name, envvars, netkw):
    got = _commit_both(monkeypatch, envvars, **netkw)
    for pkg, (found, st, _algos) in got.items():
        assert st["verdict"] == "pass" and st["errors"] == 0, (pkg, st)
        assert found == set(), (pkg, found)
    if name == "pallas_interpret":
        assert got["torch"][2] == ["pallas_ring"]
    if name.startswith("hier"):
        assert got["torch"][2] == got["jax"][2] == ["hier"]


def test_verify_green_model_parallel(monkeypatch):
    got = _commit_both(monkeypatch, {}, dists=((4, 2),))
    for pkg, (found, st, _) in got.items():
        assert st["verdict"] == "pass" and not found, (pkg, st, found)


def test_overlap_plan_verifies_green(env, tenv):
    from mlsl_tpu.comm.overlap import build_plan as jbuild
    from mlsl_tpu_torch.comm.overlap import build_plan as tbuild

    reps = []
    for P, e, build in ((J, env, jbuild), (T, tenv, tbuild)):
        group = e.create_distribution(8, 1).grad_group
        layers = [("a", 4096, P.Comp.NONE), ("b", 2048, P.Comp.QUANTIZATION),
                  ("c", 1024, P.Comp.NONE)]
        plan = build(group, layers, e.config)
        reps.append(P.plan.verify_overlap_plan(plan, block=e.config.quant_block_elems))
    assert not reps[0].diagnostics and not reps[1].diagnostics, [r.format() for r in reps]


@pytest.mark.parametrize("codec", ["vq", "prune", "f32"])
def test_verify_green_on_codec_session(env, tenv, codec):
    for P, e in ((J, env), (T, tenv)):
        e.config.codec = codec
        s = _build_net(P, e, e.create_distribution(8, 1), n_ops=1, compression="QUANTIZATION")
        rep = P.plan.verify_session(s)
        assert not rep.errors, (P.name, rep.format())
        if codec != "f32":
            req = s.get_operation(0).parameter_sets[0].grad_req
            assert req.algo == f"codec:{codec}" and req._codec_geoms


# -- the hop-trace rule on the reference's traces ---------------------------------------


def test_hop_trace_rule_matches_on_the_reference_traces():
    """The port keeps verify_hop_trace as a pure function: fed every trace
    the reference's kernels emit (ring in three modes, halving/doubling and
    the fused all-to-all over the grids test_analysis.py:299-337 sweeps) it
    reaches the reference's verdict, and the slot-capacity case (:513) flags
    A131 in both."""
    from mlsl_tpu.ops import a2a_kernels as ja2a
    from mlsl_tpu.ops import rhd_kernels as jrhd
    from mlsl_tpu.ops import ring_kernels as jrk

    traces = []
    for mode in ("allreduce", "reduce_scatter", "all_gather"):
        for g in (2, 3, 4, 8, 64):
            for slots in (2, 3, 8):
                for bidir in (False, True):
                    traces.append((jrk.static_accounting(mode, g, slots, bidir=bidir), slots))
    for g in (2, 3, 4, 5, 6, 8, 12, 64):
        for slots in (2, 3, 8):
            traces.append((jrhd.static_accounting(g, slots), slots))
            traces.append((ja2a.static_accounting(g, slots), slots))
    traces.append((jrk.static_accounting("allreduce", 8, 1), 1))
    for (ev, th, nd), slots in traces:
        kw = dict(slots=slots, ndirs=nd, total_hops=th)
        want = codes_lines(jplan.verify_hop_trace(ev, **kw))
        assert codes_lines(plan_mod.verify_hop_trace(ev, **kw)) == want
        if slots >= 2:
            assert want == []
        else:
            assert ("MLSL-A131", "graph:pallas_ring") in want


@pytest.mark.parametrize("name", ["unbalanced_ring", "unbalanced_rhd", "unbalanced_a2a",
                                  "unbalanced_allgather"])
def test_fixture_unbalanced_traces_pinned(name):
    fx = load_fixture(name)
    events, kw = fx.build_trace()
    want = jplan.verify_hop_trace(events, **kw)
    got = plan_mod.verify_hop_trace(events, **kw)
    assert fx.EXPECTED_CODE in got.codes(), got.format()
    assert codes_lines(got) == codes_lines(want)


# -- the session fixtures ---------------------------------------------------------------


def test_fixture_misordered_groups_pinned(env, tenv):
    fx = load_fixture("misordered_groups")
    want = jplan.verify_session(fx.build(env))
    got = plan_mod.verify_session(_torch_misordered(tenv))
    assert fx.EXPECTED_CODE in got.codes(), got.format()
    assert any(d.severity == "error" and d.code == fx.EXPECTED_CODE for d in got.diagnostics)
    assert findings(got) == findings(want)


def test_fixture_misordered_rejected_at_commit(env, tenv):
    fx = load_fixture("misordered_groups")
    for P, e, build in ((J, env, fx.build), (T, tenv, _torch_misordered)):
        e.config.verify = True
        e.config.verify_severity = "error"
        with pytest.raises(P.MLSLError, match=fx.EXPECTED_CODE):
            build(e)


def test_fixture_misordered_warn_severity_commits(env, tenv):
    fx = load_fixture("misordered_groups")
    for P, e, build in ((J, env, fx.build), (T, tenv, _torch_misordered)):
        e.config.verify = True
        e.config.verify_severity = "warn"
        s = build(e)
        assert s._committed
        st = P.diag.status()["plan"]
        assert st["verdict"] == "fail" and fx.EXPECTED_CODE in st["codes"], (P.name, st)
    assert jdiag.status()["plan"]["codes"] == diagnostics.status()["plan"]["codes"]


def test_fixture_straddling_bucket_pinned(env, tenv):
    fx = load_fixture("straddling_bucket")
    want = jplan.verify_session(fx.build(env)[0])
    got = plan_mod.verify_session(_torch_straddling(tenv))
    assert fx.EXPECTED_CODE in got.codes(), got.format()
    assert findings(got) == findings(want)


@pytest.mark.parametrize("name,codec,key,delta", [
    ("tampered_vq_geometry", "vq", "idx_elems", 1),
    ("short_prune_mask", "prune", "mask_len", 8),
])
def test_fixture_codec_geometry_pinned(env, tenv, name, codec, key, delta):
    fx = load_fixture(name)
    want = jplan.verify_session(fx.build(env))
    got = plan_mod.verify_session(_torch_codec(tenv, codec, key, delta))
    assert any(d.severity == "error" and d.code == fx.EXPECTED_CODE for d in got.diagnostics)
    assert findings(got) == findings(want)


def test_inflight_budget_flags_overcommit(env, tenv, monkeypatch):
    sessions = [(P, _build_net(P, e, e.create_distribution(8, 1), n_ops=3))
                for P, e in ((J, env), (T, tenv))]
    for budget, want in ((2, {("MLSL-A102", "graph:backward")}),
                         (5, {("MLSL-A103", "graph:backward")})):
        for P, s in sessions:
            monkeypatch.setitem(P.plan.INFLIGHT_BUDGET, "cpu", budget)
            rep = P.plan.verify_session(s)
            assert findings(rep) == want, (P.name, budget, rep.format())
            assert bool(rep.errors) == (budget == 2)


def test_err_len_mismatch_flagged(env, tenv):
    reps = []
    for P, e in ((J, env), (T, tenv)):
        s = _build_net(P, e, e.create_distribution(8, 1), compression="QUANTIZATION")
        req = s.get_operation(0).parameter_sets[0].grad_req
        if P is J:
            req._err_len += e.config.quant_block_elems
        else:
            req._err_lens[0] += e.config.quant_block_elems
        reps.append(P.plan.verify_session(s))
    assert "MLSL-A112" in reps[1].codes()
    assert findings(reps[1]) == findings(reps[0])


def test_missing_degrade_geometry_flagged(env, tenv):
    reps = []
    for P, e in ((J, env), (T, tenv)):
        s = _build_net(P, e, e.create_distribution(8, 1), compression="QUANTIZATION")
        req = s.get_operation(0).parameter_sets[0].grad_req
        if P is J:
            req._degrade_geoms = None
        else:
            req._err_lens = None   # what the port's degrade flush reads
        reps.append(P.plan.verify_session(s))
    assert reps[1].codes() == ["MLSL-A121"], reps[1].format()
    assert findings(reps[1]) == findings(reps[0])


def test_overlap_plan_tampering_flagged(env, tenv):
    from mlsl_tpu.comm.overlap import build_plan as jbuild
    from mlsl_tpu_torch.comm.overlap import build_plan as tbuild

    got = {}
    for P, e, build in ((J, env, jbuild), (T, tenv, tbuild)):
        group = e.create_distribution(8, 1).grad_group
        layers = [("a", 4096, P.Comp.NONE), ("b", 2048, P.Comp.QUANTIZATION)]
        plan = build(group, layers, e.config)
        quant = next(u for u in plan.units if u.key is not None)
        dense0 = next(u for u in plan.units if u.key is None)
        dense0.key = quant.key
        aliased = P.plan.verify_overlap_plan(plan)
        plan = build(group, layers, e.config)
        dense = next(u for u in plan.units if u.key is None and u.nphases)
        dense.per_tick = 0
        stuck = P.plan.verify_overlap_plan(plan)
        got[P.name] = (findings(aliased), findings(stuck))
    assert "MLSL-A120" in {c for c, _ in got["torch"][0]}
    assert {"MLSL-A120", "MLSL-A122"} <= {c for c, _ in got["torch"][1]}
    assert got["torch"] == got["jax"]


# -- the CUDA routes' launch limits (port only: standing difference) --------------------


def test_kernel_route_block_over_the_register_budget(monkeypatch):
    """MLSL_ALGO=pallas_ring with a 2048-element int8 block routes to B4,
    whose CUDA launch takes at most 1,024: refused at commit with A132 at
    error severity, and committed with the finding under warn."""
    monkeypatch.setenv("MLSL_ALGO", "pallas_ring")
    monkeypatch.setenv("MLSL_QUANT_BLOCK_ELEMS", "2048")
    monkeypatch.setenv("MLSL_VERIFY", "1")
    env = _torch_env()
    try:
        with pytest.raises(MLSLError, match="MLSL-A132"):
            _build_net(T, env, env.create_distribution(8, 1), n_ops=1,
                       compression="QUANTIZATION")
        env.config.verify_severity = "warn"
        s = _build_net(T, env, env.create_distribution(8, 1), n_ops=1,
                       compression="QUANTIZATION")
        req = s.get_operation(0).parameter_sets[0].grad_req
        assert req.algo == "pallas_ring" and req._eff_quant_block == 2048
        rep = plan_mod.verify_session(s)
        assert findings(rep) == {("MLSL-A132", "graph:op0/ps0/pallas")}
        assert all(d.severity == "error" for d in rep.diagnostics)
    finally:
        env.finalize()


@pytest.mark.parametrize("algo", ["pallas_ring", "pallas_ring2d", "pallas_rhd", "pallas_a2a"])
def test_kernel_route_group_over_max_group(algo):
    """A 128-rank group on a kernel route: each CUDA kernel serves at most
    64 members. The table never routes such a group there; a tampered
    request pins the rule (A132, error)."""
    env = TEnvironment.get_env().init(device="cpu", world_size=128)
    try:
        s = _build_net(T, env, env.create_distribution(128, 1), n_ops=1, count=256,
                       batch=128)
        req = s.get_operation(0).parameter_sets[0].grad_req
        assert req.algo == "lax" and not plan_mod.verify_session(s).diagnostics
        req.algo = algo
        rep = plan_mod.verify_session(s)
        sub = "pallas" if algo in ("pallas_ring", "pallas_ring2d") else algo
        assert findings(rep) == {("MLSL-A132", f"graph:op0/ps0/{sub}")}, rep.format()
        assert len(rep.diagnostics) == 1 and rep.errors
    finally:
        env.finalize()


def test_kernel_route_a2a_launch_grid(monkeypatch):
    """B6's dense kernel launches one CTA row per (instance, sender,
    receiver): 16 instances of 64 members are 65,536 triples, one over its
    grid's limit (A132, error); 8 instances fit."""
    monkeypatch.setenv("MLSL_PALLAS_A2A_QUANT", "0")
    for world, want in ((1024, {("MLSL-A132", "graph:op0/ps0/pallas_a2a")}), (512, set())):
        env = TEnvironment.get_env().init(device="cpu", world_size=world)
        try:
            s = _build_net(T, env, env.create_distribution(64, 1), n_ops=1, count=256,
                           batch=64)
            req = s.get_operation(0).parameter_sets[0].grad_req
            req.algo = "pallas_a2a"
            assert findings(plan_mod.verify_session(s)) == want
        finally:
            env.finalize()


def test_kernel_route_block_alignment(monkeypatch):
    """An int8 block off the 128-element rows of B4 (a tampered effective
    block) is the kernel's geometry: A111, error."""
    monkeypatch.setenv("MLSL_ALGO", "pallas_ring")
    tenv = _torch_env()
    try:
        s = _build_net(T, tenv, tenv.create_distribution(8, 1), n_ops=1,
                       compression="QUANTIZATION")
    finally:
        tenv.finalize()
    req = s.get_operation(0).parameter_sets[0].grad_req
    assert req.algo == "pallas_ring" and not plan_mod.verify_session(s).diagnostics
    req._eff_quant_block = 192
    rep = plan_mod.verify_session(s)
    assert ("MLSL-A111", "graph:op0/ps0/pallas") in findings(rep) and rep.errors


# -- verification changes nothing ---------------------------------------------------------


def _round(s, seed):
    """One round of every gradient request of ``s`` on seeded buffers ->
    the results, in graph order."""
    rng = np.random.default_rng(seed)
    outs = []
    for op in s.operations:
        for ps in op.parameter_sets:
            req = ps.grad_req
            grid = req.desc.group.topology.grid_shape
            buf = torch.from_numpy(
                rng.normal(size=(*grid, req.desc.send_len())).astype(np.float32))
            req.start(buf)
            outs.append(req.wait())
    return outs


@pytest.mark.parametrize("bucket_mb", [0, 1])
def test_verified_session_is_bit_for_bit_its_twin(monkeypatch, bucket_mb):
    """MLSL_VERIFY=1 changes no request, bucket or result: the same int8
    net, with and without the verifier, selects the same algorithms, the
    same residual lengths and bucket layout, and three rounds give the
    same bits."""
    got = []
    for verify in ("0", "1"):
        monkeypatch.setenv("MLSL_VERIFY", verify)
        monkeypatch.setenv("MLSL_GRAD_BUCKET_MB", str(bucket_mb))
        env = _torch_env()
        try:
            s = _build_net(T, env, env.create_distribution(8, 1), n_ops=3,
                           compression="QUANTIZATION")
            reqs = [ps.grad_req for op in s.operations for ps in op.parameter_sets]
            layout = [(r.algo, r._err_lens, r._chunk_slices) for r in reqs]
            b = s.get_operation(0).parameter_sets[0].bucket
            if b is not None:
                layout.append((b.offsets, b.slots, b.total, b.req.algo))
            outs = [_round(s, seed) for seed in range(3)]
        finally:
            env.finalize()
        got.append((layout, outs))
    (l0, o0), (l1, o1) = got
    assert l0 == l1
    assert (bucket_mb > 0) == (len(l0) == 4)
    for r0, r1 in zip(o0, o1):
        for a, b in zip(r0, r1):
            assert torch.equal(a, b)
    assert diagnostics.status()["plan"]["verdict"] == "pass"


def test_verified_engine_is_bit_for_bit_its_twin(monkeypatch):
    """The compiled engine under MLSL_VERIFY=1: its plan verifies green at
    build, and three int8 steps give the unverified twin's parameters and
    residuals bit for bit."""
    from mlsl_tpu.models.mlp import init as mlp_init
    from mlsl_tpu_torch.models import mlp as tmlp
    from mlsl_tpu_torch.models.convert import params_from_jax
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(32,)).astype(np.int32)
    got = []
    for verify in ("0", "1"):
        monkeypatch.setenv("MLSL_VERIFY", verify)
        env = _torch_env()
        try:
            dist = env.create_distribution(8, 1)
            s = env.create_session()
            s.set_global_minibatch_size(32)
            model = tmlp.MLP(device="cpu", params=params_from_jax(host, device="cpu"))
            tr = DataParallelTrainer(env, dist, s, model, tmlp.loss_fn, tmlp.LAYERS,
                                     tmlp.get_layer, lr=0.1, overlap_compiled=True,
                                     compression=TComp.QUANTIZATION)
            assert tr._overlap is not None and tr._overlap.plan.quant_units
            losses = [tr.step(tr.shard_batch(x, y)) for _ in range(3)]
            got.append((losses, [p.detach().clone() for p in model.parameters()],
                        {k: v.clone() for k, v in tr._overlap.residuals.items()}))
        finally:
            env.finalize()
        if verify == "1":
            st = diagnostics.status()["plan"]
            assert st["verdict"] == "pass" and stats.ANALYSIS_COUNTERS["runs"] >= 2
    (l0, p0, r0), (l1, p1, r1) = got
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert r0.keys() == r1.keys() and all(torch.equal(r0[k], r1[k]) for k in r0)


def test_engine_hook_enforces_the_overlap_plan(tenv, monkeypatch):
    """The engine hook is the shared gate: a plan whose unit cannot retire
    inside its stage window is refused where the engine is built."""
    from mlsl_tpu.models.mlp import init as mlp_init
    from mlsl_tpu_torch.comm import overlap as tov
    from mlsl_tpu_torch.models import mlp as tmlp
    from mlsl_tpu_torch.models.convert import params_from_jax
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    real = tov.build_plan

    def stalled(*a, **kw):
        plan = real(*a, **kw)
        next(u for u in plan.units if u.nphases).per_tick = 0
        return plan

    monkeypatch.setattr(tov, "build_plan", stalled)
    tenv.config.verify = True
    host = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0)))
    dist = tenv.create_distribution(8, 1)
    s = tenv.create_session()
    s.set_global_minibatch_size(32)
    with pytest.raises(MLSLError, match="MLSL-A122"):
        DataParallelTrainer(tenv, dist, s, tmlp.MLP(device="cpu",
                                                    params=params_from_jax(host, device="cpu")),
                            tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer, lr=0.1,
                            overlap_compiled=True)
    assert "MLSL-A122" in diagnostics.status()["plan"]["codes"]


# -- integration: config, status, stats line, trace instants, CLI -------------------------


def test_config_severity_validated(monkeypatch):
    monkeypatch.setenv("MLSL_VERIFY_SEVERITY", "fatal")
    with pytest.raises(MLSLError, match="MLSL_VERIFY_SEVERITY"):
        _torch_env()
    assert not TEnvironment.is_initialized()


def test_verify_is_off_by_default(tenv):
    from mlsl_tpu.config import Config as JConfig

    assert tenv.config.verify is False and tenv.config.verify_severity == "error"
    assert (JConfig().verify, JConfig().verify_severity) == (False, "error")
    _build_net(T, tenv, tenv.create_distribution(8, 1))
    assert diagnostics.status()["plan"]["verdict"] == "never_ran"
    assert "verify=False" in repr(tenv.config)


def test_supervisor_status_carries_analysis(tenv, monkeypatch):
    assert supervisor.status()["analysis"]["plan"]["verdict"] == "never_ran"
    monkeypatch.setattr(tenv.config, "verify", True)
    _build_net(T, tenv, tenv.create_distribution(8, 1))
    st = supervisor.status()["analysis"]
    assert st["plan"]["verdict"] == "pass"
    assert st["plan"]["errors"] == 0 and "duration_s" in st["plan"]
    assert st["protocol"]["verdict"] == "pass"


def test_analysis_stats_line_written(tenv, monkeypatch, tmp_path):
    monkeypatch.setenv("MLSL_STATS_DIR", str(tmp_path))
    monkeypatch.setattr(tenv.config, "verify", True)
    _build_net(T, tenv, tenv.create_distribution(8, 1))
    assert stats.ANALYSIS_COUNTERS["runs"] >= 1
    with open(stats.stats_path()) as f:
        content = f.read()
    assert "ANALYSIS" in content and "PASS" in content


def test_trace_instants_emitted(tenv, monkeypatch):
    from mlsl_tpu_torch.obs import export
    from mlsl_tpu_torch.obs import tracer as obs

    obs.disable()
    tr = obs.enable(capacity=8192)
    try:
        monkeypatch.setattr(tenv.config, "verify", True)
        tenv.config.verify_severity = "warn"
        _torch_misordered(tenv)
        names = [e[1] for e in tr.snapshot()]
        assert "analysis.verdict" in names and "analysis.finding" in names
        text = export.summarize(export.render(tr.snapshot()))
        assert "analysis findings:" in text and "MLSL-A101" in text
    finally:
        obs.disable()


def test_cli_exit_codes(tmp_path, capsys):
    from mlsl_tpu.analysis.__main__ import main as jmain
    from mlsl_tpu_torch.analysis.__main__ import main

    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "bad.py").write_text("import torch.distributed as dist\n"
                                "def f(t):\n    dist.all_reduce(t)\n")
    assert main(["--lint", "--root", str(bad)]) == 1
    assert "MLSL-A201" in capsys.readouterr().out
    ok = tmp_path / "clean"
    ok.mkdir()
    (ok / "fine.py").write_text("x = 1\n")
    assert main(["--lint", "--root", str(ok)]) == main(["--lint", "--root", str(ok)]) == 0
    assert jmain(["--lint", "--root", str(ok)]) == 0
    assert main(["--codes"]) == 0
    table = capsys.readouterr().out
    assert all(code in table for code in diagnostics.CODES)


def test_cli_gate_over_the_shipped_tree():
    """The pre-commit gate as a user runs it, from a fresh interpreter:
    lint + locks (default), --concurrency and --graph --device cpu exit 0,
    and none of them imports jax."""
    code = ("import sys, runpy\n"
            "sys.argv = ['mlsl_tpu_torch.analysis'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('mlsl_tpu_torch.analysis', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert 'jax' not in sys.modules\n"
            "    raise\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("MLSL_")}
    for args in ([], ["--concurrency"], ["--graph", "--device", "cpu"]):
        r = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, (args, r.stdout, r.stderr)
        assert "0 error(s), 0 warning(s)" in r.stderr, (args, r.stderr)


def test_cli_graph_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default --graph runs on it")
    from mlsl_tpu_torch.analysis.__main__ import main

    with pytest.raises(MLSLError, match="CUDA is not available"):
        main(["--graph"])


def test_codes_table_matches_reference():
    """The same append-only table in both packages, so findings compare as
    (code, anchor) sets."""
    assert diagnostics.CODES == jdiag.CODES
    for code, (sev, title) in diagnostics.CODES.items():
        assert code.startswith("MLSL-A") and sev in ("error", "warn") and title


# -- the linter: rule units on the same sources ---------------------------------------------

SAME_RULE_SOURCES = {
    "thread_dispatch": (
        "import threading, jax\n"
        "class Loader:\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=self._worker)\n"
        "    def _worker(self):\n"
        "        self._pump()\n"
        "    def _pump(self):\n"
        "        jax.block_until_ready(self.buf)\n", "data/badloader.py"),
    "thread_staging_ok": (
        "import threading, jax\n"
        "class Loader:\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=self._worker)\n"
        "    def _worker(self):\n"
        "        self._pump()\n"
        "    def _pump(self):\n"
        "        jax.device_put(self.buf)\n", "data/okloader.py"),
    "stats_counter": ("from mlsl_tpu.core import stats\n"
                      "def sneaky():\n"
                      "    stats.BUCKET_COUNTERS['rounds_dispatched'] += 1\n", "comm/sneaky.py"),
    "stats_helper": ("FOO_COUNTERS = {'x': 0}\n"
                     "def record_foo():\n"
                     "    FOO_COUNTERS['x'] += 1\n", "core/stats.py"),
    "stats_rogue": ("FOO_COUNTERS = {'x': 0}\n"
                    "def print_table():\n"
                    "    FOO_COUNTERS['x'] = 5\n", "core/stats.py"),
    "chaos_wrapper": ("def wrap(fn):\n"
                      "    def inner(*a):\n"
                      "        return fn(*a)\n"
                      "    inner.__wrapped__ = fn\n"
                      "    return inner\n", "comm/wrapper.py"),
    "chaos_wrapper_ok": ("def wrap(fn):\n"
                         "    def inner(*a):\n"
                         "        return fn(*a)\n"
                         "    inner.__wrapped__ = fn\n"
                         "    inner._mlsl_inner = fn\n"
                         "    return inner\n", "comm/wrapper.py"),
    "bare_except": ("try:\n    x = 1\nexcept:\n    pass\n", "m.py"),
    "swallow_except": ("try:\n    x = 1\nexcept Exception:\n    pass\n", "m.py"),
    "narrow_except": ("try:\n    x = 1\nexcept ValueError:\n    pass\n", "m.py"),
    "wall_clock": ("import time\n"
                   "def retry_loop():\n"
                   "    deadline = time.time() + 5\n"
                   "    while time.time() < deadline:\n"
                   "        time.sleep(0.1)\n", "m.py"),
    "monotonic": ("import time\n"
                  "def retry_loop():\n"
                  "    deadline = time.monotonic() + 5\n"
                  "    while time.monotonic() < deadline:\n"
                  "        time.sleep(0.1)\n", "m.py"),
    "timestamp": ("import time\ndef record():\n    at = time.time()\n", "m.py"),
    "metrics_registry": ("class Counter:\n"
                         "    def inc(self, v):\n"
                         "        self._mval += v\n"
                         "    def record_sample(self, ts):\n"
                         "        self._msamples.append(ts)\n"
                         "    def _get(self, key, s):\n"
                         "        self._mseries[key] = s\n", "obs/metrics.py"),
    "metrics_outside": ("class Counter:\n"
                        "    def inc(self, v):\n"
                        "        self._mval += v\n", "models/train.py"),
    "metrics_pragma": ("def hack(c):\n"
                       "    c._mval += 1  # mlsl-lint: disable=A207 -- test oracle\n", "x.py"),
    "unparseable": ("def f(:\n", "broken.py"),
}


@pytest.mark.parametrize("name", list(SAME_RULE_SOURCES))
def test_lint_rules_match_reference(name):
    """A202-A207 (and A200) carry over: the same source gives the same
    codes, severities and lines in both linters."""
    src, rel = SAME_RULE_SOURCES[name]
    want = jlint.lint_source(src, rel)
    got = lint.lint_source(src, rel)
    assert [(d.code, d.severity, d.anchor) for d in got.diagnostics] == \
        [(d.code, d.severity, d.anchor) for d in want.diagnostics]


@pytest.mark.parametrize("name", ["metrics_direct_mutation", "control_thread_dispatch"])
def test_lint_fixture_files_match_reference(name):
    path = FIXTURES / f"{name}.py"
    want = jlint.lint_file(str(path), root=str(ROOT))
    got = lint.lint_file(str(path), root=str(ROOT))
    assert got.codes() == want.codes() and got.codes() in (["MLSL-A207"], ["MLSL-A202"])
    assert codes_lines(got) == codes_lines(want)


A201_TORCH = [
    ("import torch.distributed as dist\ndef f(t):\n    dist.all_reduce(t)\n", [3]),
    ("import torch\ndef f(t):\n    torch.distributed.broadcast(t, 0)\n", [3]),
    ("from torch import distributed as td\ndef f(o, i):\n"
     "    td.reduce_scatter_tensor(o, i)\n    td.all_gather_into_tensor(o, i)\n", [3, 4]),
    ("from torch.distributed import all_to_all_single, send as snd\ndef f(o, i):\n"
     "    all_to_all_single(o, i)\n    snd(i, 1)\n", [3, 4]),
    ("import torch.distributed as dist\ndef f(t):\n    dist.recv(t, 0)\n"
     "    dist.init_process_group('gloo')\n    dist.barrier()\n", [3]),
    # a Distribution's own collective methods are the engine's entry
    ("def f(dist, buf):\n    return dist.all_reduce(buf, 8, 0, 0)\n", []),
    # the reference's form is not the port's
    ("from jax import lax\ndef f(x, axes):\n    return lax.psum(x, axes)\n", []),
]


@pytest.mark.parametrize("src,lines", A201_TORCH, ids=[f"case{i}" for i in range(len(A201_TORCH))])
def test_lint_a201_torch_form(src, lines):
    """A201's torch form, stated apart from the reference's lax form: a raw
    torch.distributed collective outside comm/algos/ and the engine's
    allowlist is flagged at its line."""
    rep = lint.lint_source(src, "models/custom.py")
    assert [(d.code, d.anchor) for d in rep.diagnostics] == \
        [("MLSL-A201", f"models/custom.py:{n}") for n in lines]
    for engine_file in ("comm/algos/newalgo.py", "comm/collectives.py",
                        "mlsl_tpu_torch/comm/overlap.py"):
        assert not lint.lint_source(src, engine_file).diagnostics
    # the port's own cross-process transport is the one addition (ROADMAP A.8)
    assert lint.A201_ALLOWED_FILES == jlint.A201_ALLOWED_FILES | {"comm/transport.py"}
    assert lint.A201_ALLOWED_PREFIXES == jlint.A201_ALLOWED_PREFIXES


def test_lint_pragma_line_and_file():
    line = ("import torch.distributed as dist\n"
            "def f(t):\n"
            "    dist.all_reduce(t)  # mlsl-lint: disable=A201 -- deliberate\n")
    standalone = ("import torch.distributed as dist\n"
                  "def f(t):\n"
                  "    # mlsl-lint: disable=A201 -- deliberate call\n"
                  "    dist.all_reduce(t)\n")
    filewide = ("# mlsl-lint: disable-file=A201 -- transport module\n"
                "import torch.distributed as dist\n"
                "a = lambda t: dist.all_reduce(t)\n"
                "b = lambda t: dist.broadcast(t, 0)\n")
    for src in (line, standalone, filewide):
        assert not lint.lint_source(src, "m.py").diagnostics
        assert lint._parse_pragmas(src) == jlint._parse_pragmas(src)


def test_lint_torch_dispatch_markers():
    """The torch forms of A202's markers: a CUDA graph's replay and host
    blocking on the card, reached from a Thread target; staging stays
    legal."""
    src = ("import threading, torch\n"
           "class Feed:\n"
           "    def start(self):\n"
           "        self._t = threading.Thread(target=self._worker)\n"
           "    def _worker(self):\n"
           "        self._pump()\n"
           "    def _pump(self):\n"
           "        self.buf.to('cuda', non_blocking=True)\n"
           "        torch.cuda.synchronize()\n"
           "        self.graph.replay()\n")
    rep = lint.lint_source(src, "data/badfeed.py")
    assert [(d.code, d.anchor) for d in rep.diagnostics] == [
        ("MLSL-A202", "data/badfeed.py:9"), ("MLSL-A202", "data/badfeed.py:10")]


def test_clean_tree_lint_self_application():
    """The port's shipped source: zero findings, every deliberate site
    carrying its pragma next to the code it excuses."""
    rep = lint.lint_tree()
    assert not rep.diagnostics, "\n" + rep.format()


def test_shipped_control_plane_is_a202_clean():
    pkg = ROOT / "mlsl_tpu_torch"
    for mod in ("plane.py", "channel.py"):
        rep = lint.lint_file(str(pkg / "control" / mod))
        assert not rep.diagnostics, rep.format()
