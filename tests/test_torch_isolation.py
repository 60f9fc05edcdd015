"""The port stands alone: it imports neither ``jax`` nor ``mlsl_tpu``, and it
never falls back to the CPU on its own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.log import MLSLError

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "mlsl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
C_SOURCES = sorted((ROOT / "mlsl_tpu_torch" / "capi").glob("*.cpp"))


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    assert path.exists()
    bad = _imported_roots(path) & {"jax", "jaxlib", "mlsl_tpu", "flax", "optax"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.mark.parametrize("path", C_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_c_entry_imports_only_the_port(path):
    """The port's C entry embeds Python and imports modules by name: only
    ``mlsl_tpu_torch.*``, and the shim among them."""
    import re

    text = path.read_text()
    names = re.findall(r'PyImport_Import(?:Module)?\s*\(\s*"([^"]+)"', text)
    names += re.findall(r'PyImport_ImportModuleLevel\s*\(\s*"([^"]+)"', text)
    assert names, f"{path.relative_to(ROOT)} imports no module"
    bad = [n for n in names if n.split(".")[0] != "mlsl_tpu_torch"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    assert "mlsl_tpu_torch.c_shim" in names


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mlsl_tpu_torch, mlsl_tpu_torch.models.train, "
            "mlsl_tpu_torch.models.resnet, mlsl_tpu_torch.ops.cuda_build, "
            "mlsl_tpu_torch.models.transformer, mlsl_tpu_torch.models.moe, "
            "mlsl_tpu_torch.parallel, mlsl_tpu_torch.ops.attention_kernels, "
            "mlsl_tpu_torch.ops.a2a_kernels, mlsl_tpu_torch.comm.algos.pallas_a2a, "
            "mlsl_tpu_torch.tools.profile_step, mlsl_tpu_torch.comm.overlap, "
            "mlsl_tpu_torch.optim, mlsl_tpu_torch.core.bucketing, "
            "mlsl_tpu_torch.core.activation, mlsl_tpu_torch.core.stats, "
            "mlsl_tpu_torch.core.session, mlsl_tpu_torch.core.distribution, "
            "mlsl_tpu_torch.comm.collectives, mlsl_tpu_torch.comm.request, "
            "mlsl_tpu_torch.comm.mesh, mlsl_tpu_torch.types, mlsl_tpu_torch.c_shim, "
            "mlsl_tpu_torch.capi.build, mlsl_tpu_torch.codecs, mlsl_tpu_torch.codecs.prune, "
            "mlsl_tpu_torch.codecs.vq, mlsl_tpu_torch.comm.sparse, mlsl_tpu_torch.comm.codec, "
            "mlsl_tpu_torch.tuner.calibrate, mlsl_tpu_torch.data.wire, "
            "mlsl_tpu_torch.data.feed, mlsl_tpu_torch.data.loader, "
            "mlsl_tpu_torch.data.cache, mlsl_tpu_torch.data.sources, "
            "mlsl_tpu_torch.parallel.pipeline, mlsl_tpu_torch.supervisor, "
            "mlsl_tpu_torch.serve, mlsl_tpu_torch.serve.engine, "
            "mlsl_tpu_torch.serve.kv_cache, mlsl_tpu_torch.serve.sla, "
            "mlsl_tpu_torch.serve.checks; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'mlsl_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_init_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default init succeeds here")
    env = Environment.get_env()
    with pytest.raises(MLSLError, match="CUDA is not available"):
        env.init()
    with pytest.raises(MLSLError):
        env.init(device="cuda:0")
    assert not Environment.is_initialized()
    env.init(device="cpu", world_size=8)
    try:
        assert env.device == torch.device("cpu") and env.get_process_count() == 8
    finally:
        env.finalize()


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py prints no result and exits non-zero where CUDA is
    missing, and likewise alone in a directory without the package."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_sysinfo_names_the_platform_it_found():
    from mlsl_tpu_torch import sysinfo

    info = sysinfo.probe()
    if torch.cuda.is_available():
        assert info.platform == "gpu" and info.num_devices == torch.cuda.device_count()
        assert info.device_kind == torch.cuda.get_device_name(0)
    else:
        assert not sysinfo.on_gpu()
        assert info == sysinfo.SysInfo("cpu", "cpu", 0, (), 0)


def test_models_default_to_the_environment_device():
    """ResNet50, MLP and params_from_jax put their tensors on the initialised
    Environment's device, else on the card: never on the CPU unasked."""
    import numpy as np

    from mlsl_tpu_torch.core.environment import default_device
    from mlsl_tpu_torch.models import mlp, resnet
    from mlsl_tpu_torch.models.convert import params_from_jax

    if not Environment.is_initialized():
        assert default_device() == torch.device("cuda")
    env = Environment.get_env().init(device="cpu", world_size=8)
    try:
        assert default_device() == torch.device("cpu")
        assert all(p.device.type == "cpu" for p in mlp.MLP().parameters())
        assert params_from_jax({"w": np.ones(3)})["w"].device.type == "cpu"
        model = resnet.ResNet50(num_classes=10, device="meta")
        assert all(p.device.type == "meta" for p in model.parameters())
    finally:
        env.finalize()
    assert default_device() == torch.device("cuda")


def test_topology_fingerprint_is_keyed_on_the_world():
    from mlsl_tpu_torch import sysinfo

    fp = sysinfo.topology_fingerprint(8, torch.device("cpu"))
    assert fp == {"platform": "cpu", "device_kind": "cpu", "num_devices": 8,
                  "num_hosts": 1, "tiers": None}
    assert sysinfo.topology_fingerprint(4, torch.device("cpu"))["num_devices"] == 4
