"""Pod-scale control plane: membership, heartbeat, election, drain.

Counterpart of ``mlsl_tpu.control``, by adapted copy. Membership and
heartbeats run over localhost TCP (``channel``), never over the device
world; a committed loss of a member feeds the elastic coordinator's shrink
through ``FaultTolerantLoop``.

Module registry (the chaos._plans / elastic._active pattern): the active
:class:`~mlsl_tpu_torch.control.plane.ControlPlane` is process-wide state that
survives Environment rebuilds BY DESIGN — pod membership outlives any one
mesh generation, exactly like breaker history and the elastic world. Tests
reset it with ``supervisor.reset_all()``.

Arming: `Environment.init()` calls :func:`ensure_started` after the obs
plane comes up; it is a no-op unless the config names a control world
(``MLSL_CONTROL_ADDRS`` or ``MLSL_CONTROL_PORT`` + ``MLSL_CONTROL_WORLD``
with ``MLSL_CONTROL_RANK``). Single-process runs — every existing test and
bench — therefore never start a socket.
"""

from __future__ import annotations

from typing import Optional

from mlsl_tpu_torch.control.plane import ControlPlane  # noqa: F401 (public)
from mlsl_tpu_torch.log import log_warning

_active: Optional[ControlPlane] = None


def get_active() -> Optional[ControlPlane]:
    """The process's control plane, or None when not armed."""
    return _active


def set_active(plane: Optional[ControlPlane]) -> Optional[ControlPlane]:
    """Install a plane built by the caller (tests, the pod sim). Stops any
    previous one: a process is exactly one pod member."""
    global _active
    if _active is not None and _active is not plane:
        _active.stop()
    _active = plane
    return plane


def reset() -> None:
    """Stop and forget the active plane (test isolation)."""
    set_active(None)


def armed(config=None) -> bool:
    """Whether this process participates in a pod control plane."""
    return _active is not None


def status() -> dict:
    """JSON-serializable summary for supervisor.status() / healthz."""
    if _active is None:
        return {"state": "off"}
    return _active.status()


def replica_id(default: int) -> int:
    """The replica identity for straggler reports and per-host attribution:
    the pod rank when the control plane is armed (pod-wide peer medians need
    pod-unique ids), else the caller's default (the one process: 0)."""
    return _active.rank if _active is not None else int(default)


def _addr_table(config):
    """rank -> (host, port) from config. ``control_addrs`` is the explicit
    form ("h0:p0,h1:p1,..."); ``control_port`` + ``control_world`` is the
    localhost shorthand the CPU pod sim uses (consecutive ports from the
    base)."""
    if config.control_addrs:
        addrs = []
        for ent in config.control_addrs.split(","):
            host, _, port = ent.strip().rpartition(":")
            addrs.append((host or "127.0.0.1", int(port)))
        return addrs
    if config.control_port and config.control_world:
        return [("127.0.0.1", config.control_port + r)
                for r in range(config.control_world)]
    return []


def ensure_started(config) -> Optional[ControlPlane]:
    """Arm the control plane from config if it names a pod; idempotent.
    The device map here is label-only (``rank<r>``): a committed loss from
    this path records the pod transition without synthesizing a local
    device error — Environment.init() cannot know which virtual ranks a
    REMOTE rank owned. Embedders/tests that do know pass a real device_map
    to :class:`ControlPlane` directly and install it via
    :func:`set_active`."""
    global _active
    if _active is not None:
        return _active
    addrs = _addr_table(config)
    if not addrs:
        return None
    rank = config.control_rank
    if rank < 0 or rank >= len(addrs):
        log_warning(
            "control plane not armed: MLSL_CONTROL_RANK=%d outside the "
            "%d-member address table", rank, len(addrs),
        )
        return None
    plane = ControlPlane(
        rank=rank,
        addrs=addrs,
        device_map={r: (f"rank{r}",) for r in range(len(addrs))},
        interval_s=config.heartbeat_interval_s,
        misses=config.heartbeat_misses,
        grace_s=config.heartbeat_grace_s,
        notice_file=config.preemption_file or None,
    )
    plane.start()
    _active = plane
    return plane
