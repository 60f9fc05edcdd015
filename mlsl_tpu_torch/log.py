"""Level-gated logging, the error hierarchy and the assertion helper.

Counterpart of ``mlsl_tpu.log`` (reference MLSL_LOG / MLSL_ASSERT macros,
src/log.hpp:35-83): an assert that raises ``MLSLError`` instead of calling
``_exit(1)``, and messages gated on ``MLSL_LOG_LEVEL`` (``LogLevel``: ERROR 0,
INFO 1, DEBUG 2, TRACE 3; ``set_log_level`` / ``get_log_level``;
``Environment.init`` applies ``Config.log_level``).

The messages go through the standard ``logging`` module, logger
``mlsl_tpu_torch``, whose level follows the MLSL level: ERROR lets errors and
warnings through (the JAX package prints its warnings at ERROR), INFO adds
``logging.INFO``, DEBUG ``logging.DEBUG``, and TRACE adds ``log_trace``'s
messages, which ``logging`` sees at ``TRACE_LEVEL`` (5, below DEBUG). The
logger propagates to the root logger. While the root logger has no handler,
the logger's own handler writes each message to stderr with the time, the
level, and the caller's function and line, as the JAX package prints them;
once a program configures the root logger (``logging.basicConfig``), the
message is printed there alone, so it is printed once either way.
"""

from __future__ import annotations

import enum
import logging
import os


class LogLevel(enum.IntEnum):
    ERROR = 0
    INFO = 1
    DEBUG = 2
    TRACE = 3


#: the ``logging`` level of ``log_trace``'s messages
TRACE_LEVEL = 5
logging.addLevelName(TRACE_LEVEL, "TRACE")

# the lowest ``logging`` level each MLSL level lets through
_THRESHOLD = {LogLevel.ERROR: logging.WARNING, LogLevel.INFO: logging.INFO,
              LogLevel.DEBUG: logging.DEBUG, LogLevel.TRACE: TRACE_LEVEL}

_logger = logging.getLogger("mlsl_tpu_torch")
_handler = logging.StreamHandler()
_handler.setFormatter(logging.Formatter(
    "[%(asctime)s] mlsl_tpu_torch %(levelname)s %(funcName)s:%(lineno)d %(message)s",
    "%H:%M:%S"))
# print here only while no root handler would print the message as well
_handler.addFilter(lambda record: not logging.getLogger().handlers)
_logger.addHandler(_handler)
_level = LogLevel.ERROR


def set_log_level(level) -> None:
    global _level
    _level = LogLevel(int(level))
    _logger.setLevel(_THRESHOLD[_level])


def get_log_level() -> LogLevel:
    return _level


set_log_level(int(os.environ.get("MLSL_LOG_LEVEL") or 0))


def log_error(msg: str, *args) -> None:
    """An error message, with the traceback of the exception being handled."""
    _logger.error(msg, *args, exc_info=True, stacklevel=2)


def log_warning(msg: str, *args) -> None:
    """Printed at every level, as an error is, without the traceback."""
    _logger.warning(msg, *args, stacklevel=2)


def log_info(msg: str, *args) -> None:
    _logger.info(msg, *args, stacklevel=2)


def log_debug(msg: str, *args) -> None:
    _logger.debug(msg, *args, stacklevel=2)


def log_trace(msg: str, *args) -> None:
    _logger.log(TRACE_LEVEL, msg, *args, stacklevel=2)


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


class MLSLKernelError(MLSLError):
    """A hand-written CUDA kernel could not be built, loaded or launched, or its
    wrapper was handed a device it has no kernel for. The recovery ladder never
    retries or degrades past it (FATAL): a wrapper on the card launches its
    kernel or raises, and never gives way to the plain version."""


class MLSLIntegrityError(MLSLCorruptionError):
    """Training-state integrity failure, raised by the integrity sentinel
    (``mlsl_tpu_torch.sentinel``): the step quality gate escalated to
    rollback, or a consistency audit found per-rank copies diverged. The
    taxonomy classes it CORRUPTION, as its parent."""


def mlsl_assert(cond: bool, msg: str, *args) -> None:
    """Assert helper mirroring MLSL_ASSERT (src/log.hpp:72-83): raises
    ``MLSLError`` so the Environment stays usable for a caller that catches it."""
    if cond:
        return
    raise MLSLError(msg % args if args else msg)
