"""Platform probing and auto-configuration: what card the package runs on.

Counterpart of ``mlsl_tpu.sysinfo`` (reference src/sysinfo.hpp:27-48 and
AutoConfig, src/mlsl.cpp:649-682). Where the JAX package asks ``on_tpu()``,
this one asks ``torch.cuda``: the card's name, compute capability, memory and
count; ``device_class`` and ``auto_config`` turn the probe into knob defaults
under ``MLSL_AUTO_CONFIG_TYPE``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SysInfo:
    platform: str              # 'gpu' | 'cpu'
    device_kind: str           # torch.cuda.get_device_name, or 'cpu'
    num_devices: int           # torch.cuda.device_count(), 0 without CUDA
    capability: tuple          # (major, minor), () without CUDA
    memory_per_device: int     # bytes, 0 without CUDA


def platform_override():
    """The device an entry point that takes no arguments (the C shim) runs
    on, from ``MLSL_TPU_PLATFORM`` (``mlsl_tpu.sysinfo.apply_platform_override``):
    ``cpu`` -> ``"cpu"``; unset, ``gpu`` or ``cuda`` -> None, the card
    (``Environment.init``'s default, which raises without CUDA). Any other
    value raises ``MLSLError``."""
    import os

    from mlsl_tpu_torch.log import MLSLError

    platform = os.environ.get("MLSL_TPU_PLATFORM", "").strip().lower()
    if platform == "cpu":
        return "cpu"
    if platform in ("", "gpu", "cuda"):
        return None
    raise MLSLError(f"MLSL_TPU_PLATFORM={platform!r}: the port runs on 'cpu' or the card "
                    f"('gpu', 'cuda' or unset)")


def on_gpu() -> bool:
    """True when PyTorch sees a CUDA device."""
    return torch.cuda.is_available()


def probe(device: int = 0) -> SysInfo:
    if not on_gpu():
        return SysInfo("cpu", "cpu", 0, (), 0)
    props = torch.cuda.get_device_properties(device)
    return SysInfo(
        "gpu",
        torch.cuda.get_device_name(device),
        torch.cuda.device_count(),
        (props.major, props.minor),
        int(props.total_memory),
    )


def topology_fingerprint(world_size: int, device: torch.device) -> dict:
    """The identity a tuner profile is keyed by (``mlsl_tpu.sysinfo``'s
    keys): platform, the card's name, the number of virtual ranks and hosts,
    and the two-tier shape ``[T, L]`` of an ``MLSL_MESH_TIERS`` world (None
    for a flat one: a profile swept with ``hier`` cells must not steer a
    flat world, nor the reverse). A profile measured on a TPU, on another
    card or at another world size is stale here. ``device``: the
    Environment's device."""
    from mlsl_tpu_torch.comm import transport
    from mlsl_tpu_torch.comm.mesh import world_tiers

    device = torch.device(device)
    if device.type == "cuda":
        si = probe(torch.cuda.current_device() if device.index is None else device.index)
    else:
        si = SysInfo("cpu", "cpu", 0, (), 0)
    tiers = world_tiers(int(world_size))
    return {
        "platform": si.platform,
        "device_kind": si.device_kind,
        "num_devices": int(world_size),
        "num_hosts": len(set(transport.world().hosts)),
        "tiers": list(tiers) if tiers is not None else None,
    }


def device_class(si: SysInfo) -> str:
    """Coarse tuning class of the probed device (``mlsl_tpu.sysinfo.
    device_class``, the reference's Xeon-vs-Phi x NIC matrix,
    src/sysinfo.hpp:27-48). The JAX package sends every platform but the TPU
    to 'host-sim'; the card has a class of its own:

    - 'gpu-hopper': a card of compute capability 9.0 (the H100 the kernels
      are built for, ``sm_90a``), every virtual rank on the one card;
    - 'host-sim': the CPU, and any other card, keeps the settings under
      which the tests run.
    """
    if si.platform == "gpu" and tuple(si.capability[:1]) == (9,):
        return "gpu-hopper"
    return "host-sim"


# The row auto_config applies to both classes; the HBM-keyed entries are then
# derived from the probed memory. The TPU classes of the JAX package have no
# device here and are left out. No measurement has yet given the card a value
# of its own, so 'gpu-hopper' shares the 'host-sim' row (the JAX package's) and
# keeps its name for status and reporting; what the card's runs say of it:
_SHARED_ROW = dict(
    # no run timed the newest-first deferral on the card
    msg_priority_threshold=10000,
    msg_priority_flush_ms=2.0,
    large_msg_size_mb=128,
    # ROADMAP C.7 (run (v)'s chunk probe, PERF.md §6): four quarter-slice
    # lax allreduces of 8 x 64 MiB were 6.7 % faster than one dispatch (short
    # of the sweep's 10 % rule), and a chunked pallas_ring request at 256 MiB
    # a rank took 16.98-23.62 ms against 1.49 ms for one B3 launch; on a sim
    # mesh chunking only costs
    large_msg_chunks=1,
    # no run showed bucketed config 5 faster on the card; sim tests stay
    # launch-for-launch
    grad_bucket_mb=0,
)
_CLASS_DEFAULTS = {"gpu-hopper": _SHARED_ROW, "host-sim": _SHARED_ROW}


def auto_config(config, si: SysInfo = None) -> None:
    """Apply the probed device class's row of ``_CLASS_DEFAULTS`` to
    ``config``, then the knobs keyed on the device's memory, by the JAX
    package's formulas (``mlsl_tpu.sysinfo.auto_config``; reference
    AutoConfig, src/mlsl.cpp:649-682). Knobs the user exported
    (``Config._explicit``) are never overridden. Gated on
    ``MLSL_AUTO_CONFIG_TYPE != 0``. ``si``: the probe (default
    :func:`probe` of the current card)."""
    if config.auto_config_type == 0:
        return
    si = probe() if si is None else si
    tuned = dict(_CLASS_DEFAULTS[device_class(si)])
    if si.memory_per_device:
        # one deferred chunk stays under ~1.5 % of the device's memory
        cap_mb = max(8, si.memory_per_device // (64 * 1024 * 1024))
        tuned["large_msg_size_mb"] = min(tuned["large_msg_size_mb"], cap_mb)
        # the device-gather cap: a quarter of the device's memory
        tuned["gather_device_limit_mb"] = max(256, si.memory_per_device // (4 * 1024 * 1024))
    explicit = getattr(config, "_explicit", set())
    for k, v in tuned.items():
        if k not in explicit:
            setattr(config, k, v)
