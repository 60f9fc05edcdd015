"""The port's core tier (mlsl_tpu_torch.log, config, sysinfo, ops/cuda_build)
against the JAX package's, after tests/test_aux.py's TestAutoConfig and
TestCompileCache and tests/test_pallas_a2a.py's use of the log level.

- The log level: at every ``LogLevel``, each message kind the JAX package
  prints the port's logger emits, and each it suppresses the port's does not;
  ``Environment.init`` applies ``MLSL_LOG_LEVEL``.
- The core-tier, parity and sentinel knobs: ``Config.from_env`` reads the
  same values from the same environment as the JAX package's, and
  ``validate`` refuses the same sentinel settings.
- AutoConfig: the CPU's class and row are the JAX package's (``host-sim``);
  the card has its own class, whose HBM-keyed entries equal the JAX
  package's formulas on the same memory; explicit exports win; the gate is
  off by default and then the Config is untouched.
- The compile cache: the build directory's resolution, the symmetric toggle
  over init/finalize cycles, and a cold process that fills a cache directory
  against a warm one that loads from it without running nvcc (nvcc stubbed:
  nothing is built here).

Every test starts and ends with the log level at ERROR, no build directory
handed over and the fault plane reset.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from mlsl_tpu import log as jlog
from mlsl_tpu import sysinfo as jsysinfo
from mlsl_tpu.config import Config as JConfig
from mlsl_tpu_torch import log as tlog
from mlsl_tpu_torch import supervisor, sysinfo
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parents[1]
GIB = 2 ** 30


@pytest.fixture(autouse=True)
def _isolated():
    supervisor.reset_all()
    tlog.set_log_level(tlog.LogLevel.ERROR)
    cuda_build.configure(None)
    yield
    if Environment._instance is not None:
        Environment._instance.finalize()
    cuda_build.configure(None)
    tlog.set_log_level(tlog.LogLevel.ERROR)
    jlog.set_log_level(jlog.LogLevel.ERROR)
    supervisor.reset_all()


def _tinit():
    return Environment.get_env().init(device="cpu", world_size=8)


# -- the log level ------------------------------------------------------------------


class _Records:
    def __init__(self):
        import logging

        self.records = []
        self.handler = logging.Handler()
        self.handler.emit = self.records.append

    def __enter__(self):
        tlog._logger.addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        tlog._logger.removeHandler(self.handler)


KINDS = ("log_error", "log_warning", "log_info", "log_debug", "log_trace")


@pytest.mark.parametrize("level", list(jlog.LogLevel))
def test_log_level_gates_each_kind_as_jax(level, capfd):
    jlog.set_log_level(level)
    tlog.set_log_level(int(level))
    assert tlog.get_log_level() == jlog.get_log_level() == level
    for kind in KINDS:
        capfd.readouterr()
        getattr(jlog, kind)("probe %s", kind)
        jax_printed = f"probe {kind}" in capfd.readouterr().err
        with _Records() as recs:
            getattr(tlog, kind)("probe %s", kind)
        assert bool(recs) == jax_printed, (level, kind)
        if recs:
            # the caller's function, as the JAX package prints it
            assert recs[0].funcName == "test_log_level_gates_each_kind_as_jax"
            assert recs[0].getMessage() == f"probe {kind}"


def test_trace_maps_below_debug():
    import logging

    assert tlog.TRACE_LEVEL < logging.DEBUG
    assert logging.getLevelName(tlog.TRACE_LEVEL) == "TRACE"
    tlog.set_log_level(tlog.LogLevel.DEBUG)
    assert tlog._logger.isEnabledFor(logging.DEBUG)
    assert not tlog._logger.isEnabledFor(tlog.TRACE_LEVEL)
    tlog.set_log_level(3)
    assert tlog._logger.isEnabledFor(tlog.TRACE_LEVEL)
    with pytest.raises(ValueError):
        tlog.set_log_level(4)
    with pytest.raises(ValueError):
        jlog.set_log_level(4)


@pytest.mark.parametrize("root", ["unconfigured", "basicConfig"])
def test_warning_printed_once(root):
    """A warning reaches stderr once: through the logger's own handler while
    the root logger has none, through the root logger alone once a program
    configures it (a fresh process: pytest's own handlers sit on root)."""
    code = ("import logging, sys\n"
            + ("logging.basicConfig(stream=sys.stderr)\n" if root == "basicConfig" else "")
            + "from mlsl_tpu_torch import log\n"
            "log.log_warning('probe %s', 'once')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "MLSL_LOG_LEVEL": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stderr.count("probe once") == 1, out.stderr


def test_init_applies_log_level(monkeypatch):
    monkeypatch.setenv("MLSL_LOG_LEVEL", "2")
    e = _tinit()
    assert e.config.log_level == 2
    assert tlog.get_log_level() == tlog.LogLevel.DEBUG
    with _Records() as recs:
        tlog.log_debug("visible at DEBUG")
    assert len(recs) == 1
    e.finalize()
    monkeypatch.delenv("MLSL_LOG_LEVEL")
    _tinit()
    assert tlog.get_log_level() == tlog.LogLevel.ERROR


# -- the Config's new knobs ---------------------------------------------------------


NEW_KNOBS = {
    "MLSL_LOG_LEVEL": "3", "MLSL_AUTO_CONFIG_TYPE": "1", "MLSL_COMPILE_CACHE_DIR": "/x/cc",
    "MLSL_DUP_GROUP": "1", "MLSL_NUM_SERVERS": "7", "MLSL_MAX_SHORT_MSG_SIZE": "4096",
    "MLSL_SERVER_AFFINITY": "1,3", "MLSL_HEAP_SIZE_GB": "12", "MLSL_ALLTOALL_SPLIT": "3",
    "MLSL_THP_THRESHOLD_MB": "9", "MLSL_SENTINEL_GATE": "skip_step", "MLSL_SENTINEL_EVERY": "5",
    "MLSL_SENTINEL_SPIKE": "4.5", "MLSL_SENTINEL_ZMAX": "2.5", "MLSL_SENTINEL_WARMUP": "2",
    "MLSL_SENTINEL_BLOCK": "512",
}
FIELDS = ("log_level", "auto_config_type", "compile_cache_dir", "dup_group", "num_servers",
          "max_short_msg_size", "server_affinity", "heap_size_gb", "alltoall_split",
          "thp_threshold_mb", "sentinel_gate", "sentinel_every", "sentinel_spike",
          "sentinel_zmax", "sentinel_warmup", "sentinel_block")


@pytest.mark.parametrize("exported", [False, True])
def test_new_knobs_read_as_jax(monkeypatch, exported):
    for k, v in NEW_KNOBS.items():
        if exported:
            monkeypatch.setenv(k, v)
        else:
            monkeypatch.delenv(k, raising=False)
    j, t = JConfig.from_env(), Config.from_env()
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    # the knobs a tuned profile and AutoConfig must leave alone
    for f in ("num_servers", "sentinel_every"):
        assert (f in t._explicit) == (f in j._explicit) == exported, f
    t.validate()


@pytest.mark.parametrize("var,value", [("MLSL_SENTINEL_GATE", "explode"),
                                       ("MLSL_SENTINEL_SPIKE", "0.5"),
                                       ("MLSL_SENTINEL_EVERY", "-1"),
                                       ("MLSL_SENTINEL_ZMAX", "0"),
                                       ("MLSL_SENTINEL_WARMUP", "-2"),
                                       ("MLSL_SENTINEL_BLOCK", "0")])
def test_sentinel_knobs_validated_as_jax(monkeypatch, var, value):
    from mlsl_tpu.log import MLSLError as JMLSLError

    monkeypatch.setenv(var, value)
    with pytest.raises(JMLSLError, match=var):
        JConfig.from_env().validate()
    with pytest.raises(MLSLError, match=var):
        _tinit()
    assert not Environment.is_initialized()


# -- AutoConfig -----------------------------------------------------------------------


def _jsi(platform, kind, mem):
    return jsysinfo.SysInfo(platform=platform, device_kind=kind, num_devices=8, num_hosts=1,
                            memory_per_device=mem)


def _jtuned(monkeypatch, si, env_vars=()):
    for k, v in env_vars:
        monkeypatch.setenv(k, v)
    c = JConfig.from_env()
    c.auto_config_type = 1
    monkeypatch.setattr(jsysinfo, "probe", lambda: si)
    jsysinfo.auto_config(c)
    return c


def _ttuned(monkeypatch, si, env_vars=()):
    for k, v in env_vars:
        monkeypatch.setenv(k, v)
    c = Config.from_env()
    c.auto_config_type = 1
    sysinfo.auto_config(c, si)
    return c


H100 = sysinfo.SysInfo("gpu", "NVIDIA H100 80GB HBM3", 1, (9, 0), 80 * GIB)
TUNED = ("msg_priority_threshold", "msg_priority_flush_ms", "large_msg_size_mb",
         "large_msg_chunks", "grad_bucket_mb", "gather_device_limit_mb")


def test_classes_differ(monkeypatch):
    """The CPU is 'host-sim' in both packages, with the same row; the card is
    a class of its own by name, where the JAX package sends every platform
    but the TPU to 'host-sim', and shares that row: the card's Config is the
    JAX package's on the same probe."""
    cpu_t = sysinfo.SysInfo("cpu", "cpu", 0, (), 0)
    assert sysinfo.device_class(cpu_t) == jsysinfo.device_class(_jsi("cpu", "cpu", 0)) \
        == "host-sim"
    assert sysinfo.device_class(H100) == "gpu-hopper"
    assert jsysinfo.device_class(_jsi("gpu", H100.device_kind, H100.memory_per_device)) \
        == "host-sim"
    assert sysinfo.device_class(sysinfo.SysInfo("gpu", "A100", 1, (8, 0), 40 * GIB)) \
        == "host-sim"
    tc, jc = _ttuned(monkeypatch, cpu_t), _jtuned(monkeypatch, _jsi("cpu", "cpu", 0))
    assert {f: getattr(tc, f) for f in TUNED} == {f: getattr(jc, f) for f in TUNED}
    th = _ttuned(monkeypatch, H100)
    jh = _jtuned(monkeypatch, _jsi("gpu", H100.device_kind, H100.memory_per_device))
    assert {f: getattr(th, f) for f in TUNED} == {f: getattr(jh, f) for f in TUNED}
    assert th.large_msg_chunks == 1 and th.grad_bucket_mb == 0
    assert th.msg_priority_threshold == Config().msg_priority_threshold
    assert th.gather_device_limit_mb == 80 * 1024 // 4


@pytest.mark.parametrize("mem_gib", [1, 16, 80, 95])
def test_hbm_keyed_entries_follow_jax_formulas(monkeypatch, mem_gib):
    """The card's large-message cap and gather cap on its probed memory are
    the JAX package's formulas (its tpu-performance row shares the 128 MiB
    large-message start)."""
    th = _ttuned(monkeypatch, sysinfo.SysInfo("gpu", "H100", 1, (9, 0), mem_gib * GIB))
    jp = _jtuned(monkeypatch, _jsi("tpu", "TPU v5p", mem_gib * GIB))
    assert th.large_msg_size_mb == jp.large_msg_size_mb
    assert th.gather_device_limit_mb == jp.gather_device_limit_mb


def test_explicit_env_wins(monkeypatch):
    env_vars = [("MLSL_LARGE_MSG_CHUNKS", "3"), ("MLSL_GATHER_DEVICE_LIMIT_MB", "777")]
    th = _ttuned(monkeypatch, H100, env_vars)
    jv = _jtuned(monkeypatch, _jsi("tpu", "TPU v5 lite", 16 * GIB), env_vars)
    assert th.large_msg_chunks == jv.large_msg_chunks == 3
    assert th.gather_device_limit_mb == jv.gather_device_limit_mb == 777
    assert th.msg_priority_flush_ms == 2.0          # the others still tuned
    assert th.large_msg_size_mb == 128


def test_gate_off_by_default(monkeypatch):
    c = Config.from_env()
    assert c.auto_config_type == 0
    before = dict(vars(c))
    sysinfo.auto_config(c, H100)
    assert dict(vars(c)) == before
    # through init on the CPU: the same Config as before this knob existed
    e = _tinit()
    assert {f: getattr(e.config, f) for f in TUNED} == {f: getattr(Config(), f) for f in TUNED}


def test_init_applies_the_cpu_row_and_explicit_wins(monkeypatch):
    monkeypatch.setenv("MLSL_AUTO_CONFIG_TYPE", "1")
    monkeypatch.setenv("MLSL_GRAD_BUCKET_MB", "2")
    e = _tinit()
    assert e.config.large_msg_chunks == 1            # host-sim's row (default 4)
    assert e.config.grad_bucket_mb == 2              # exported
    assert e.config.gather_device_limit_mb == Config().gather_device_limit_mb   # no memory


# -- the compile cache (the kernels' build directory) -----------------------------


def test_build_dir_resolution(monkeypatch, tmp_path):
    monkeypatch.delenv("MLSL_COMPILE_CACHE_DIR", raising=False)
    assert cuda_build.build_dir() == cuda_build.DEFAULT_BUILD_DIR
    assert cuda_build.DEFAULT_BUILD_DIR == ROOT / "build" / "mlsl_tpu_torch"
    monkeypatch.setenv("MLSL_COMPILE_CACHE_DIR", "")
    assert cuda_build.build_dir() == cuda_build.DEFAULT_BUILD_DIR    # empty = off
    monkeypatch.setenv("MLSL_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert cuda_build.build_dir() == tmp_path / "env"
    c = Config()
    c.compile_cache_dir = str(tmp_path / "cfg")
    cuda_build.configure(c)                         # the live Config wins
    assert cuda_build.build_dir() == tmp_path / "cfg"
    assert cuda_build.lib_path("quant_kernels").parent == tmp_path / "cfg"
    c.compile_cache_dir = ""
    assert cuda_build.build_dir() == cuda_build.DEFAULT_BUILD_DIR
    # a library already loaded stays loaded, whatever the directory
    marker = object()
    monkeypatch.setitem(cuda_build._loaded, "quant_kernels", marker)
    c.compile_cache_dir = str(tmp_path / "other")
    assert cuda_build.load("quant_kernels") is marker


def test_cache_toggle_is_symmetric(monkeypatch, tmp_path):
    """'Empty = off' holds across init/finalize cycles, as
    tests/test_aux.py::TestCompileCache states for the XLA cache."""
    cache = tmp_path / "c"
    monkeypatch.setenv("MLSL_COMPILE_CACHE_DIR", str(cache))
    e = _tinit()
    assert e.config.compile_cache_dir == str(cache)
    assert cuda_build.build_dir() == cache
    e.finalize()
    monkeypatch.delenv("MLSL_COMPILE_CACHE_DIR")
    e = _tinit()
    assert cuda_build.build_dir() == cuda_build.DEFAULT_BUILD_DIR
    e.finalize()
    assert cuda_build._config is None


_FAKE_NVCC = """#!{python}
import sys
with open({log!r}, "a") as f:
    f.write("called\\n")
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "wb").write(b"not a library")
"""

_PROG = """
import sys
sys.path.insert(0, {repo!r})
from mlsl_tpu_torch.ops import cuda_build
took = cuda_build.build_all(["quant_kernels", "rhd_kernels"])
print("BUILD", sorted(took), cuda_build.lib_path("quant_kernels"))
"""


def test_cache_dir_filled_cold_and_loaded_warm(tmp_path):
    """A cold process fills the cache directory (one nvcc a source); a warm
    one finds every library there and starts no nvcc."""
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    calls = tmp_path / "nvcc_calls.log"
    nvcc = cuda / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(calls)))
    nvcc.chmod(0o755)
    cache = tmp_path / "kernel_cache"
    env = dict(os.environ, MLSL_COMPILE_CACHE_DIR=str(cache), CUDA_HOME=str(tmp_path / "cuda"))
    prog = _PROG.format(repo=str(ROOT))
    runs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        runs.append(r.stdout)
        assert str(cache) in r.stdout
    assert calls.read_text().count("called") == 2          # the cold run's two sources
    assert sorted(p.name.split("-")[0] for p in cache.iterdir()) == \
        ["libquant_kernels", "librhd_kernels"]
