"""The failure taxonomy: exception type -> recovery class.

Counterpart of the table at the head of ``mlsl_tpu.supervisor``
(``ErrorClass``, ``_TAXONOMY``, ``classify``) and of its retry delay
(``jittered_backoff``). The device feed's retry gate (data/common.py) and the
serving engine's decode retry (serve/engine.py) read them: only a TRANSIENT
failure is retried in place. The breakers, the recovery ladder and
``status()`` are not ported yet.
"""

from __future__ import annotations

import enum
import random
from typing import Optional

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


# -- retry policy (rung 2) ----------------------------------------------------

# process-wide jitter source
_rng = random.Random()


def jittered_backoff(base_s: float, attempt: int,
                     rng: Optional[random.Random] = None) -> float:
    """Delay before retry ``attempt`` (0-based): ``base * 2**attempt`` scaled
    by a uniform jitter in [0.5, 1.5), so that workers retrying the same
    transient fault do not collide again in lockstep:
    0.5 * base * 2^a <= delay < 1.5 * base * 2^a."""
    r = rng if rng is not None else _rng
    return base_s * (2.0 ** attempt) * (0.5 + r.random())
