"""The unchanged C and C++ consumer programs against the port's C library.

``mlsl_tpu_torch/capi/build.py`` compiles ``capi/c_api.cpp`` (the port's
embedded-Python entry over ``mlsl_tpu_torch.c_shim``) against the unchanged
``include/mlsl_tpu.h`` and links ``native/test_c_api.c``,
``native/test_cpp_api.cpp``, ``native/compat_test.cpp`` and
``examples/compat_example.cpp`` (the last two with ``native/mlsl_compat.cpp``,
the drop-in ``mlsl.hpp`` surface) to it. Each program runs here with
``MLSL_TPU_PLATFORM=cpu`` and is held to what ``tests/test_c_api.py`` and
``tests/test_compat.py`` assert of it against the JAX package's library,
case for case: the reference matrix, test-driven completion, the
v-collectives, both watchdog tests and the example. Without
``MLSL_TPU_PLATFORM=cpu`` the entry runs on the card or fails: on a machine
without CUDA, ``test_c_api`` exits non-zero with the ``MLSLError`` text.
"""

import os
import shutil
import subprocess

import pytest
import torch

from mlsl_tpu_torch.capi import build

WORLD = 8


@pytest.fixture(scope="module")
def programs():
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no C/C++ toolchain")
    return build.build()


def _run(paths, name, *args, timeout=300, cwd=None, **env):
    run = subprocess.run([paths[name], *map(str, args)], capture_output=True, text=True,
                         timeout=timeout, cwd=cwd,
                         env=build.program_env(MLSL_TPU_PLATFORM="cpu", **env))
    return run


def _ok(run):
    assert run.returncode == 0, f"stdout:\n{run.stdout}\nstderr:\n{run.stderr}"
    return run.stdout


def test_c_api_end_to_end(programs, tmp_path):
    out = _ok(_run(programs, "test_c_api", cwd=tmp_path, MLSL_STATS="1"))
    for line in ("C API TEST PASSED", f"world = {WORLD}", "allreduce OK (36)",
                 "allgatherv/alltoallv OK", "alltoallv_full per-rank OK",
                 "activation fwd ReduceScatter OK", "activation bwd AllGather OK",
                 "distributed-update increment AllGather OK", "statistics queries OK"):
        assert line in out, line


def test_cpp_api_end_to_end(programs, tmp_path):
    assert "CPP API TEST PASSED" in _ok(_run(programs, "test_cpp_api", cwd=tmp_path))


def test_compat_example(programs, tmp_path):
    assert f"compat example OK (world={WORLD})" in _ok(
        _run(programs, "compat_example", cwd=tmp_path))


def _compat(paths, group_count, dist_update, user_buf, use_test, cwd):
    out = _ok(_run(paths, "compat_test", group_count, dist_update, user_buf, use_test,
                   timeout=600, cwd=cwd))
    assert "compat_test: PASSED" in out
    return out


@pytest.mark.parametrize("group_count", [1, 2, 4])
@pytest.mark.parametrize("dist_update", [0, 1])
def test_compat_matrix(programs, tmp_path, group_count, dist_update):
    out = _compat(programs, group_count, dist_update, 1, 0, tmp_path)
    assert f"dist={WORLD // group_count}x{group_count}" in out


def test_compat_test_driven_completion(programs, tmp_path):
    """The reference's USE_TEST mode: Update polls TestGradientComm until
    completion instead of blocking in WaitGradientComm."""
    _compat(programs, 2, 1, 0, 1, tmp_path)


def test_compat_v_collectives(programs, tmp_path):
    """AllGatherv through the drop-in surface and a double Wait on the
    completed request; the colored distribution."""
    out = _compat(programs, 2, 0, 0, 0, tmp_path)
    assert "compat_test: AllGatherv OK" in out
    assert "compat_test: colored distribution OK" in out


def test_compat_watchdog_on_divergent_ranks(programs, tmp_path):
    """A rank issuing a collective the others never join dies with a
    per-rank diagnostic instead of hanging."""
    run = _run(programs, "compat_test", "mismatch", timeout=60, cwd=tmp_path,
               MLSL_COMPAT_WATCHDOG_S="3")
    assert run.returncode != 0
    assert "rendezvous watchdog" in run.stderr
    assert "0:1/0" in run.stderr  # rank 0 started, nobody else arrived


def test_compat_watchdog_rearms_for_slow_collective(programs, tmp_path):
    """A slow but healthy collective (every rank joined, one thread inside
    the 32M-element allreduce past a 1 s deadline) is not taken for
    divergence: the watchdog re-arms and the result stays exact."""
    run = _run(programs, "compat_test", "slowwait", timeout=300, cwd=tmp_path,
               MLSL_COMPAT_WATCHDOG_S="1")
    assert run.returncode == 0, run.stderr[-2000:]
    assert "compat_test slowwait: PASSED" in run.stdout
    assert "rendezvous watchdog" not in run.stderr


def test_c_api_without_cpu_platform_needs_cuda(programs, tmp_path):
    """No fallback: without MLSL_TPU_PLATFORM=cpu the entry initialises on
    the card; on a machine without CUDA it returns MLSL_TPU_FAILURE with the
    MLSLError text, and test_c_api stops at its first check."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default init succeeds here")
    env = build.program_env()
    env.pop("MLSL_TPU_PLATFORM", None)
    run = subprocess.run([programs["test_c_api"]], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path, env=env)
    assert run.returncode != 0
    assert "CUDA is not available" in run.stdout + run.stderr
    assert "FAILED: env init" in run.stderr
    assert "C API TEST PASSED" not in run.stdout


def test_build_is_keyed_and_reused(programs):
    """The library and the programs sit in one directory named by a hash
    of their sources and flags, next to nothing else of the checkout; a
    second build reuses it."""
    out = build.build_dir()
    assert out.parent == build.ROOT / "build" / "mlsl_tpu_torch"
    assert build.build() == programs
    for path in programs.values():
        assert os.path.dirname(path) == str(out) and os.path.isfile(path)
