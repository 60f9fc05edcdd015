"""Build the port's C library and the unchanged C/C++ consumer programs.

``libmlsl_tpu_torch.so`` is ``capi/c_api.cpp`` compiled against the
unchanged ``include/mlsl_tpu.h``: it exports the ``mlsl_*`` symbols of the
JAX package's ``native/libmlsl_tpu.so`` and runs them on the port through
``mlsl_tpu_torch.c_shim``. The four consumer programs are built from their
unchanged sources and linked to it by path, with an rpath, as
``native/Makefile:20-30`` links them to the JAX package's library:

- ``test_c_api`` (``native/test_c_api.c``) and ``test_cpp_api``
  (``native/test_cpp_api.cpp``, ``include/mlsl_tpu.hpp``);
- ``compat_test`` (``native/compat_test.cpp``) and ``compat_example``
  (``examples/compat_example.cpp``), each with ``native/mlsl_compat.cpp``,
  the drop-in ``include/mlsl.hpp`` surface, and ``-pthread``.

Everything goes into one directory under ``build/mlsl_tpu_torch/`` (the
checkout's git-ignored build directory, beside the CUDA kernels) whose name
carries a hash of the sources and flags, so an unchanged tree reuses it.
The Python flags come from ``sysconfig`` (``INCLUDEPY``, ``LIBDIR``,
``LDVERSION``), not ``python3-config``. Nothing builds at import.

``build_sample_codec()`` compiles the reference-ABI sample codec
(``native/sample_codec.c``) for ``QuantParams.lib_path`` the same way.

Usage::

    from mlsl_tpu_torch.capi import build
    paths = build.build()                       # {"lib": ..., "test_c_api": ...}
    subprocess.run([paths["test_c_api"]], env=build.program_env())
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

from mlsl_tpu_torch.log import MLSLError

ROOT = Path(__file__).resolve().parents[2]
CAPI = Path(__file__).resolve().parent
LIB = "libmlsl_tpu_torch.so"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
CFLAGS = ("-O2", "-Wall")

# program -> (compiler, sources relative to the root, needs the mlsl.hpp runtime)
PROGRAMS = {
    "test_c_api": ("cc", ("native/test_c_api.c",), False),
    "test_cpp_api": ("cxx", ("native/test_cpp_api.cpp",), False),
    "compat_test": ("cxx", ("native/compat_test.cpp", "native/mlsl_compat.cpp"), True),
    "compat_example": ("cxx", ("examples/compat_example.cpp", "native/mlsl_compat.cpp"), True),
}
HEADERS = ("include/mlsl_tpu.h", "include/mlsl_tpu.hpp", "include/mlsl.hpp")


def python_flags() -> tuple:
    """-> (compile flags, link flags) that embed this interpreter."""
    inc = sysconfig.get_config_var("INCLUDEPY")
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var("VERSION")
    if not inc or not libdir or not ver:
        raise MLSLError("sysconfig lacks INCLUDEPY, LIBDIR or LDVERSION: cannot embed Python")
    extra = []
    for var in ("LIBS", "SYSLIBS"):
        extra += (sysconfig.get_config_var(var) or "").split()
    return ([f"-I{inc}"],
            [f"-L{libdir}", f"-lpython{ver}", f"-Wl,-rpath,{libdir}", *extra])


def _compilers() -> Dict[str, str]:
    found = {"cc": shutil.which(os.environ.get("CC", "gcc")),
             "cxx": shutil.which(os.environ.get("CXX", "g++"))}
    missing = [k for k, v in found.items() if v is None]
    if missing:
        raise MLSLError(f"no C/C++ compiler ({', '.join(missing)}): set CC / CXX")
    return found


def _commands(out: Path, compilers: Dict[str, str]) -> Dict[str, List[str]]:
    py_c, py_ld = python_flags()
    inc = f"-I{ROOT / 'include'}"
    cmds = {"lib": [compilers["cxx"], *CXXFLAGS, inc, *py_c, "-shared", "-o", str(out / LIB),
                    str(CAPI / "c_api.cpp"), *py_ld]}
    link = [f"-L{out}", "-lmlsl_tpu_torch", "-Wl,-rpath,$ORIGIN", *py_ld]
    for name, (cc, sources, runtime) in PROGRAMS.items():
        flags = CFLAGS if cc == "cc" else CXXFLAGS
        cmds[name] = [compilers[cc], *flags, inc, "-o", str(out / name),
                      *(str(ROOT / s) for s in sources), *link,
                      *(["-pthread"] if runtime else [])]
    return cmds


def build_dir() -> Path:
    """The directory of this tree's library and programs."""
    h = hashlib.sha256()
    for rel in ("mlsl_tpu_torch/capi/c_api.cpp", *HEADERS,
                *sorted({s for _, srcs, _ in PROGRAMS.values() for s in srcs})):
        h.update(rel.encode())
        h.update((ROOT / rel).read_bytes())
    h.update(" ".join(CXXFLAGS + CFLAGS).encode())
    h.update(repr(python_flags()).encode())
    return ROOT / "build" / "mlsl_tpu_torch" / f"capi-{h.hexdigest()[:16]}"


def paths(out: Optional[Path] = None) -> Dict[str, str]:
    out = out or build_dir()
    return {"lib": str(out / LIB), **{name: str(out / name) for name in PROGRAMS}}


def _run(procs: Dict[str, subprocess.Popen]) -> List[str]:
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
    return failed


def build() -> Dict[str, str]:
    """Build the library, then the four programs together, into a fresh
    directory that replaces nothing: a tree already built is reused. ->
    ``paths()``. Raises MLSLError with the compiler's output when a build
    fails."""
    out = build_dir()
    if out.is_dir():
        return paths(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="capi-tmp-", dir=out.parent))
    try:
        cmds = _commands(tmp, _compilers())

        def start(name):
            return subprocess.Popen(cmds[name], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)

        failed = _run({"lib": start("lib")})
        if not failed:
            failed = _run({name: start(name) for name in PROGRAMS})
        if failed:
            raise MLSLError("C API build failed: " + "\n".join(failed))
        try:
            os.rename(tmp, out)
        except OSError:
            if not out.is_dir():     # not a concurrent builder's finished tree
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return paths(out)


SAMPLE_CODEC = "native/sample_codec.c"
SAMPLE_CODEC_FLAGS = ("-shared", "-fPIC", "-O2")


def build_sample_codec() -> str:
    """Compile the reference-ABI sample codec (``native/sample_codec.c``, a
    float16 truncation codec: 128 elements -> 256 bytes a block) with
    ``gcc`` into ``build/mlsl_tpu_torch/sample_codec-<hash>/`` (keyed by the
    source and flags; an unchanged tree reuses it). -> the library's path,
    for ``QuantParams.lib_path``. Raises MLSLError when the build fails."""
    src = ROOT / SAMPLE_CODEC
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(SAMPLE_CODEC_FLAGS).encode())
    out = ROOT / "build" / "mlsl_tpu_torch" / f"sample_codec-{h.hexdigest()[:16]}"
    lib = out / "libsample_codec.so"
    if lib.is_file():
        return str(lib)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="sample-codec-tmp-", dir=out.parent))
    try:
        proc = subprocess.run([_compilers()["cc"], *SAMPLE_CODEC_FLAGS, "-o",
                               str(tmp / lib.name), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise MLSLError(f"sample codec build failed:\n{proc.stdout}")
        try:
            os.rename(tmp, out)
        except OSError:
            if not lib.is_file():    # not a finished tree from a concurrent build
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return str(lib)


def program_env(**extra: str) -> Dict[str, str]:
    """The environment a consumer program runs in: this one, with a
    PYTHONPATH that holds the repository root and this interpreter's
    ``sys.path`` (so that the embedded interpreter finds the package and
    torch, also from a virtual environment), and ``extra`` on top."""
    env = dict(os.environ)
    path = [str(ROOT)] + [p for p in sys.path if p]
    if env.get("PYTHONPATH"):
        path.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(path)
    env.update(extra)
    return env
