"""The failure taxonomy: exception type -> recovery class.

Counterpart of the table at the head of ``mlsl_tpu.supervisor``
(``ErrorClass``, ``_TAXONOMY``, ``classify``). The device feed's retry gate
(data/common.py) reads it: only a TRANSIENT failure is retried in place. The
breakers, the recovery ladder and ``status()`` are not ported yet.
"""

from __future__ import annotations

import enum

from mlsl_tpu_torch.log import (
    MLSLCorruptionError,
    MLSLDeviceLossError,
    MLSLError,
    MLSLTimeoutError,
)


class ErrorClass(enum.Enum):
    """Recovery policy classes."""

    #: flaky IO / timing: retry in place with backoff
    TRANSIENT = "transient"
    #: data integrity (bitrot, codec round-trip mismatch)
    CORRUPTION = "corruption"
    #: dispatch, compile or device failure
    PERSISTENT = "persistent"
    #: capacity left the world: never retried in place
    DEVICE_LOSS = "device_loss"
    #: caller bugs and resource exhaustion: surface immediately
    FATAL = "fatal"


# Ordered (exception type, class) table: the first isinstance match wins, so
# subclasses precede their bases (MLSLTimeoutError < MLSLError < RuntimeError;
# TimeoutError < OSError). A timeout of the watchdog already waited its whole
# budget, so it is PERSISTENT, not TRANSIENT.
_TAXONOMY = (
    (MLSLCorruptionError, ErrorClass.CORRUPTION),
    (MLSLDeviceLossError, ErrorClass.DEVICE_LOSS),
    (MLSLTimeoutError, ErrorClass.PERSISTENT),
    (MLSLError, ErrorClass.PERSISTENT),
    (TimeoutError, ErrorClass.TRANSIENT),
    (ConnectionError, ErrorClass.TRANSIENT),
    (OSError, ErrorClass.TRANSIENT),
    (MemoryError, ErrorClass.FATAL),
    (ArithmeticError, ErrorClass.CORRUPTION),
    (RuntimeError, ErrorClass.PERSISTENT),
)


def classify(exc: BaseException) -> ErrorClass:
    """Map an exception to its recovery class; anything outside the table
    (ValueError, TypeError, KeyboardInterrupt, ...) is FATAL."""
    for typ, cls in _TAXONOMY:
        if isinstance(exc, typ):
            return cls
    return ErrorClass.FATAL
