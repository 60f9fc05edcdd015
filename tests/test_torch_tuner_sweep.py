"""The port's autotuner sweep (mlsl_tpu_torch.tuner.sweep, ``MLSL_TUNE=1``)
against the JAX package's (the sweep cases of tests/test_tuner.py).

- The sweep on the CPU at tiny sizes: cells for every engine kind on the 1D
  ring and the (4, 2) grid, every candidate timed (the kernel algorithms'
  plain versions here), the derived knobs, the quant block and lowering
  cells, ``MLSL_TUNE_QUANT``, and on a ``MLSL_MESH_TIERS`` world the ``hier``
  candidates and the tiers in the fingerprint.
- The derivation against JAX: both sweeps run with ``_time_fn`` patched to a
  scripted time per (kind, algorithm, payload, shape) (and per call for the
  closures: the chunk probe's split and the staging depths), so the cells,
  their bands, their timings and every derived knob must be equal. The JAX
  sweep skips the Pallas candidates under its interpreter; the test arms the
  interpreter for eligibility and lifts that skip, so both sweeps time the
  same candidates.
- ``MLSL_TUNE=1`` at ``Environment.init`` writes a profile that a fresh
  Environment honours (a request's ``algo`` is the profile's cell), a
  non-default cell is honoured, tuned knobs apply except exported ones, and a
  profile swept on a tiered world is rejected on a flat one.

Not ported: the JAX sweep's chaos bypass (``test_sweep_bypasses_armed_chaos_
budgets``; chaos is ROADMAP A.7).
"""

import json
import logging
import os
import zlib

import numpy as np
import pytest
import torch

from mlsl_tpu import tuner as jtuner
from mlsl_tpu.comm import algos as jalgos
from mlsl_tpu.comm import collectives as jcoll
from mlsl_tpu.comm import quant_ring as jqr
from mlsl_tpu.ops import ring_kernels as jrk
from mlsl_tpu.tuner import sweep as jsweep
from mlsl_tpu_torch import sysinfo, tuner
from mlsl_tpu_torch.comm import algos
from mlsl_tpu_torch.comm import quant_ring as tqr
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.tuner import sweep
from mlsl_tpu_torch.types import CompressionType, DataType, GroupType, ReductionType

torch.set_num_threads(2)

TINY_SIZES = (4 * 1024, 32 * 1024)
Q = CompressionType.QUANTIZATION


@pytest.fixture(autouse=True)
def _fast_sweep(monkeypatch):
    """An env-triggered sweep stays tiny: the tests pin the machinery."""
    monkeypatch.setenv("MLSL_TUNE_SIZES", "4,32")
    monkeypatch.setenv("MLSL_TUNE_ITERS", "1")
    monkeypatch.delenv("MLSL_MESH_TIERS", raising=False)


def _profile(tmp_path, cells=None, knobs=None, fingerprint=None, name="prof.json"):
    doc = {"version": 1,
           "fingerprint": fingerprint or sysinfo.topology_fingerprint(8, torch.device("cpu")),
           "created": "test", "cells": cells if cells is not None else [],
           "knobs": knobs or {}}
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _req(env, dist, n, comp=CompressionType.NONE, kind="allreduce"):
    req = CommRequest(CommDesc(kind, dist._group(GroupType.DATA), n, DataType.FLOAT,
                               op=ReductionType.SUM, compression=comp), env.dispatcher)
    req.setup()
    return req


# -- the sweep -----------------------------------------------------------------------------


def test_run_sweep_produces_cells_and_knobs():
    prof = tuner.run_sweep(8, "cpu", sizes=TINY_SIZES, iters=1)
    assert prof.fingerprint == sysinfo.topology_fingerprint(8, torch.device("cpu"))
    assert {c["kind"] for c in prof.cells} == {"allreduce", "reduce_scatter", "alltoall"}
    assert {tuple(c["shape"]) for c in prof.cells} == {(8,), (4, 2)}
    for c in prof.cells:
        assert c["algo"] in algos.ALGORITHMS
        assert "lax" in c["us"]                     # the baseline is always measured
        assert c["algo"] == min(c["us"], key=c["us"].get)
    assert prof.knobs.get("msg_priority_threshold", 0) > 0
    assert prof.knobs.get("grad_bucket_mb", 0) >= 1
    assert prof.knobs["overlap_stages"] in sweep.OVERLAP_STAGE_CANDIDATES
    m = prof.knobs["_measured"]
    assert m["large_single_us"] > 0 and m["large_chunked_us"] > 0
    # one open top band a kind and shape
    for kind in ("allreduce", "reduce_scatter", "alltoall"):
        for shape in ([8], [4, 2]):
            caps = [c["max_bytes"] for c in prof.cells
                    if c["kind"] == kind and c["shape"] == shape]
            assert caps[-1] is None and all(cap is not None for cap in caps[:-1])


def test_sweep_times_every_candidate():
    """Nothing is skipped: every eligible algorithm, the kernel ones
    included (their plain versions on a CPU tensor), has a time."""
    prof = tuner.run_sweep(8, "cpu", sizes=(4 * 1024,), iters=1)
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    groups = {(8,): ProcessGroup(Topology(8, 1, 8), ("data",)),
              (4, 2): ProcessGroup(Topology(4, 2, 8), ("data", "model"))}
    for c in prof.cells:
        op = None if c["kind"] == "alltoall" else ReductionType.SUM
        assert set(c["us"]) == set(algos.candidates(c["kind"], groups[tuple(c["shape"])], op))
    assert "pallas_a2a" in next(c for c in prof.cells if c["kind"] == "alltoall")["us"]


def test_sweep_quant_knob():
    prof = tuner.run_sweep(8, "cpu", sizes=(8 * 1024,), iters=1, quant=True)
    assert prof.knobs.get("quant_block_elems") in sweep.QUANT_BLOCKS
    assert set(prof.knobs["_quant_measured"]) == {str(b) for b in sweep.QUANT_BLOCKS}
    quant = [c for c in prof.cells if c["compression"] == "quantization"]
    assert quant and all(set(c["us"]) == {"lax", "pallas_ring"} for c in quant)


def test_tiered_sweep_times_hier(monkeypatch):
    """On a 2x4 world hier joins the 1D ring's dense candidates and the
    quantized lowering cells, and the fingerprint carries the tiers."""
    monkeypatch.setenv("MLSL_MESH_TIERS", "2x4")
    prof = tuner.run_sweep(8, "cpu", sizes=(8 * 1024,), iters=1, quant=True)
    assert prof.fingerprint["tiers"] == [2, 4]
    for c in prof.cells:
        if c["shape"] == [8] and c["kind"] != "alltoall":
            assert "hier" in c["us"], c
        if c["shape"] == [4, 2] or c["kind"] == "alltoall":
            assert "hier" not in c["us"], c
    quant = [c for c in prof.cells if c["compression"] == "quantization"]
    assert quant and all(set(c["us"]) == {"lax", "pallas_ring", "hier"} for c in quant)


def test_tune_quant_env_produces_knob(tmp_path, monkeypatch):
    path = str(tmp_path / "q.json")
    monkeypatch.setenv("MLSL_TUNE", "1")
    monkeypatch.setenv("MLSL_TUNE_QUANT", "1")
    monkeypatch.setenv("MLSL_TUNE_PROFILE", path)
    e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert e.config.tuned_profile.knobs.get("quant_block_elems") in sweep.QUANT_BLOCKS
        assert e.config.quant_block_elems == e.config.tuned_profile.knobs["quant_block_elems"]
    finally:
        e.finalize()
    monkeypatch.delenv("MLSL_TUNE_QUANT")
    monkeypatch.setenv("MLSL_TUNE_PROFILE", str(tmp_path / "noq.json"))
    e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert "quant_block_elems" not in e.config.tuned_profile.knobs
    finally:
        e.finalize()


def test_profile_save_load_roundtrip(tmp_path):
    prof = tuner.run_sweep(8, "cpu", sizes=TINY_SIZES, iters=1)
    path = str(tmp_path / "p.json")
    prof.save(path)
    back = tuner.load_profile(path)
    assert back.fingerprint == prof.fingerprint and back.knobs == prof.knobs
    for kind in ("allreduce", "reduce_scatter"):
        for shape in ((8,), (4, 2)):
            for payload in (1024, 40 * 1024, 10 << 20):
                assert back.select(kind, shape, "none", payload) == \
                    prof.select(kind, shape, "none", payload)
    # the JAX package reads the port's profile (one file format)
    assert jtuner.load_profile(path).cells == back.cells


# -- the derivation against JAX ------------------------------------------------------------


class _Tagged:
    """A built program labelled with what it is, for the scripted clock."""

    def __init__(self, fn, tag):
        self.fn, self.tag = fn, tag

    def __call__(self, *a, **k):
        return self.fn(*a, **k)


def _scripted(calls):
    """A ``_time_fn`` stand-in: the time of a labelled program is a function
    of (label, payload elements, grid); an unlabelled closure's, of its
    place among the closures timed (the chunk probe's split, then the
    staging depths)."""
    def fake(fn, args, iters):
        if isinstance(fn, _Tagged):
            key = repr((fn.tag, int(args[0].shape[-1]), tuple(int(d) for d in args[0].shape[:4])))
        else:
            calls.append(None)
            key = repr(("closure", len(calls)))
        return ((zlib.crc32(key.encode()) % 997) + 3) * 1e-6

    return fake


def _tag_builds(monkeypatch, mod_algos, mod_qr, jax_side):
    build, qbuild = mod_algos.build, mod_qr.build_quantized_collective

    def tagged_build(kind, group, *a, **kw):
        algo = a[1] if jax_side else a[0]
        return _Tagged(build(kind, group, *a, **kw), (kind, algo))

    def tagged_qbuild(kind, group, count, block, *a, ring="lax", **kw):
        fn, el = qbuild(kind, group, count, block, *a, ring=ring, **kw)
        return _Tagged(fn, ("quant", ring, block)), el

    monkeypatch.setattr(mod_algos, "build", tagged_build)
    monkeypatch.setattr(mod_qr, "build_quantized_collective", tagged_qbuild)


@pytest.mark.parametrize("tiers", ["", "2x4"])
def test_sweep_derivation_matches_jax(monkeypatch, tiers):
    """The same scripted times through both sweeps give the same cells,
    bands and knobs (the measurements under ``_measured`` included)."""
    if tiers:
        monkeypatch.setenv("MLSL_MESH_TIERS", tiers)
    monkeypatch.setenv("MLSL_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jrk, "interpret_mode", lambda: False)
    jcoll.clear_cache()
    sizes = (4 * 1024, 32 * 1024, 256 * 1024)
    monkeypatch.setenv("MLSL_TUNE_SIZES", "4,32,256")
    with monkeypatch.context() as mp:
        _tag_builds(mp, algos, tqr, jax_side=False)
        mp.setattr(sweep, "_time_fn", _scripted([]))
        got = tuner.run_sweep(8, "cpu", sizes=sizes, iters=2, quant=True)
    with monkeypatch.context() as mp:
        _tag_builds(mp, jalgos, jqr, jax_side=True)
        mp.setattr(jsweep, "_time_fn", _scripted([]))
        want = jtuner.run_sweep(sizes=sizes, iters=2, quant=True)
    jcoll.clear_cache()
    assert got.cells == want.cells
    assert got.knobs == want.knobs
    assert got.fingerprint["tiers"] == want.fingerprint["tiers"]
    assert {c["algo"] for c in got.cells} - {"lax"}, "the script made lax win everywhere"
    if tiers:
        assert any("hier" in c["us"] for c in got.cells if c["compression"] == "quantization")


# -- the Environment -------------------------------------------------------------------------


def test_tune_writes_profile_and_fresh_env_honors_it(tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    monkeypatch.setenv("MLSL_TUNE", "1")
    monkeypatch.setenv("MLSL_TUNE_PROFILE", path)
    e = Environment.get_env().init(device="cpu", world_size=8)
    prof = e.config.tuned_profile
    assert prof is not None and os.path.exists(path)
    recorded = {(c["kind"], tuple(c["shape"]), c.get("max_bytes")): c["algo"]
                for c in prof.cells}
    e.finalize()

    monkeypatch.delenv("MLSL_TUNE")
    e = Environment.get_env().init(device="cpu", world_size=8)
    loaded = e.config.tuned_profile
    try:
        assert loaded is not None
        assert {(c["kind"], tuple(c["shape"]), c.get("max_bytes")): c["algo"]
                for c in loaded.cells} == recorded
        dist = e.create_distribution(8, 1)
        n = 2048                                # 8 KiB: inside the smallest band
        want = loaded.select("allreduce", (8,), "none", n * 4) or "lax"
        req = _req(e, dist, n)
        assert req.algo == want
        buf = dist.make_buffer(lambda p: np.full(n, float(p + 1), np.float32), n)
        np.testing.assert_array_equal(np.asarray(dist.local_part(req.start(buf).wait(), 0)),
                                      np.full(n, 36.0, np.float32))
    finally:
        e.finalize()


def test_selection_honored_for_nondefault_cell(tmp_path, monkeypatch):
    cells = [{"kind": "allreduce", "shape": [8], "compression": "none", "max_bytes": None,
              "algo": "rhd"}]
    monkeypatch.setenv("MLSL_TUNE_PROFILE", _profile(tmp_path, cells=cells))
    e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert _req(e, e.create_distribution(8, 1), 1024).algo == "rhd"
    finally:
        e.finalize()


def test_tuned_knobs_applied_but_explicit_env_wins(tmp_path, monkeypatch, caplog):
    path = _profile(tmp_path, knobs={"msg_priority_threshold": 123456, "grad_bucket_mb": 7,
                                     "overlap_stages": 4, "_measured": {"x": 1}})
    monkeypatch.setenv("MLSL_TUNE_PROFILE", path)
    monkeypatch.setenv("MLSL_GRAD_BUCKET_MB", "2")      # exported: wins
    with caplog.at_level(logging.WARNING, logger="mlsl_tpu_torch"):
        e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert e.config.msg_priority_threshold == 123456
        assert e.config.overlap_stages == 4
        assert e.config.grad_bucket_mb == 2
        assert "_measured" not in caplog.text       # the sweep's metadata is no knob
    finally:
        e.finalize()


def test_tiered_profile_drives_quantized_requests_and_flat_world_rejects_it(tmp_path,
                                                                              monkeypatch,
                                                                              caplog):
    """MLSL_TUNE=1 MLSL_TUNE_QUANT=1 on the 2x4 world: a fresh Environment on
    the written profile routes each quantized request to the cell's lowering
    (``lax`` -> the composed ring); on a flat world the same file is rejected
    with a warning."""
    monkeypatch.setenv("MLSL_MESH_TIERS", "2x4")
    path = str(tmp_path / "tiered.json")
    monkeypatch.setenv("MLSL_TUNE", "1")
    monkeypatch.setenv("MLSL_TUNE_QUANT", "1")
    monkeypatch.setenv("MLSL_TUNE_PROFILE", path)
    e = Environment.get_env().init(device="cpu", world_size=8)
    e.finalize()
    monkeypatch.delenv("MLSL_TUNE")
    prof = tuner.load_profile(path)
    cells = [c for c in prof.cells if c["compression"] == "quantization"]
    assert cells and prof.fingerprint["tiers"] == [2, 4]
    # pin one cell to each lowering, so that every route is driven
    for c, algo in zip(cells, ("hier", "lax", "pallas_ring")):
        c["algo"] = algo
    prof.save(path)
    e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert e.config.tuned_profile is not None
        dist = e.create_distribution(8, 1)
        for c in cells:
            n = c["payload_bytes"] // 4
            req = _req(e, dist, n, Q)
            want = {"lax": "quant_ring"}.get(c["algo"], c["algo"])
            assert req.algo == want, (c, req.algo)
    finally:
        e.finalize()
    monkeypatch.delenv("MLSL_MESH_TIERS")
    with caplog.at_level(logging.WARNING, logger="mlsl_tpu_torch"):
        e = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert e.config.tuned_profile is None
        assert "different topology" in caplog.text
    finally:
        e.finalize()
