"""The error hierarchy and the assertion helper.

Counterpart of the part of ``mlsl_tpu.log`` that this package uses (reference
MLSL_ASSERT macro, src/log.hpp:72-83): an assert that raises ``MLSLError``
instead of calling ``_exit(1)``, and error/warning/debug messages through the
standard ``logging`` module (logger ``mlsl_tpu_torch``).
"""

from __future__ import annotations

import logging

_logger = logging.getLogger("mlsl_tpu_torch")


def log_error(msg: str, *args) -> None:
    """An error message, with the traceback of the exception being handled."""
    _logger.error(msg, *args, exc_info=True)


def log_warning(msg: str, *args) -> None:
    _logger.warning(msg, *args)


def log_info(msg: str, *args) -> None:
    _logger.info(msg, *args)


def log_debug(msg: str, *args) -> None:
    _logger.debug(msg, *args)


class MLSLError(RuntimeError):
    """Raised on MLSL_ASSERT failure (reference aborts via _exit; we raise)."""


class MLSLTimeoutError(MLSLError):
    """An async request exceeded its time bound."""


class MLSLCorruptionError(MLSLError):
    """Data-integrity failure: a codec round trip that does not verify, a
    checksum mismatch."""


class MLSLDeviceLossError(MLSLError):
    """A device left the world. ``devices`` names the lost devices when known."""

    def __init__(self, msg: str, devices=()):
        super().__init__(msg)
        self.devices = tuple(devices)


class MLSLIntegrityError(MLSLCorruptionError):
    """Training-state integrity failure (diverged replicas, a failed audit)."""


def mlsl_assert(cond: bool, msg: str, *args) -> None:
    """Assert helper mirroring MLSL_ASSERT (src/log.hpp:72-83): raises
    ``MLSLError`` so the Environment stays usable for a caller that catches it."""
    if cond:
        return
    raise MLSLError(msg % args if args else msg)
