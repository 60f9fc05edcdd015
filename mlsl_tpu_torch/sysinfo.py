"""Platform probing: what card the package runs on.

Counterpart of ``mlsl_tpu.sysinfo`` (reference src/sysinfo.hpp:27-48). Where
the JAX package asks ``on_tpu()``, this one asks ``torch.cuda``: the card's
name, compute capability, memory and count.
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
        "num_hosts": 1,
        "tiers": list(tiers) if tiers is not None else None,
    }
