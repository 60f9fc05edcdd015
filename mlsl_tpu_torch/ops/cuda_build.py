"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

Every kernel source under ``mlsl_tpu_torch/csrc/`` exposes a plain C
interface; it is compiled at first use into a shared library in the build
directory and loaded with ``ctypes``. A library's file name carries a hash
of its source, of every header it includes from ``csrc/`` and of the flags,
so an edited source or header builds anew, an unchanged one is reused, and
a stale library is never loaded. ``build_all`` starts one nvcc per source,
all at once.

The build directory is the port's compile cache, the counterpart of the JAX
package's persistent XLA cache (``MLSL_COMPILE_CACHE_DIR``,
``mlsl_tpu/core/environment.py:213-240``): ``Config.compile_cache_dir`` of
the initialized Environment (handed over by ``configure``), else the
environment variable; empty means ``build/mlsl_tpu_torch/`` at the root of
the checkout (git-ignored). A cold process fills the directory, a warm one
loads from it without running nvcc. The toggle is symmetric across
init/finalize cycles: an Environment without the knob builds in the default
directory again. A library already loaded in a process stays loaded (a
process cannot unload it), so a change of directory applies to the sources
not loaded yet.

Nothing here runs at import: this module is imported on machines without
nvcc or a card, where only the kernels' plain versions are used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from mlsl_tpu_torch.log import MLSLKernelError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {
    "quant_kernels": "quant_kernels.cu",
    "ring_kernels": "ring_kernels.cu",
    "rhd_kernels": "rhd_kernels.cu",
    "attention_kernels": "attention_kernels.cu",
    "a2a_kernels": "a2a_kernels.cu",
    "attention_sm90": "attention_sm90.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # name -> nvcc output (ptxas register/spill report)


#: ``build/mlsl_tpu_torch`` beside the package, at the root of the checkout
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mlsl_tpu_torch"

# the initialized Environment's Config (Environment.init hands it over,
# finalize takes it back): its compile_cache_dir is read at each use
_config = None


def configure(config=None) -> None:
    global _config
    _config = config


def build_dir() -> Path:
    """Where the libraries are built and loaded from: the compile cache
    directory when one is set (the live Config's ``compile_cache_dir``, else
    ``MLSL_COMPILE_CACHE_DIR``), else :data:`DEFAULT_BUILD_DIR`."""
    d = (_config.compile_cache_dir if _config is not None
         else os.environ.get("MLSL_COMPILE_CACHE_DIR", ""))
    return Path(d).expanduser().resolve() if d else DEFAULT_BUILD_DIR


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise MLSLKernelError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def _with_headers(path: Path, seen: list) -> list:
    """``path`` and, depth first, every file it includes from ``csrc/`` with
    ``#include "..."``, each once."""
    if path in seen:
        return seen
    seen.append(path)
    for inc in re.findall(r'^\s*#\s*include\s*"([^"]+)"', path.read_text(), re.M):
        if (CSRC / inc).is_file():
            _with_headers(CSRC / inc, seen)
    return seen


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in _with_headers(CSRC / SOURCES[name], []):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library, one nvcc per source, all started
    together. -> {name: seconds its build took (0.0 when already built)}.
    Raises MLSLKernelError with the compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    running = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out)
    took = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            os.unlink(tmp)
            continue
        os.replace(tmp, out)
    if failed:
        raise MLSLKernelError("CUDA kernel build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``name``, built first when missing."""
    lib = _loaded.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all([name])
        try:
            lib = ctypes.CDLL(str(lib_path(name)))
        except OSError as e:
            raise MLSLKernelError(f"CUDA kernel library {name} cannot be loaded: {e}") from e
        _loaded[name] = lib
    return lib
