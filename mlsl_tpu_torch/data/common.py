"""Shared helpers of the device feed: the wire-spec grammar, environment
defaults and the retry gate.

Counterpart of ``mlsl_tpu.data.common``. One retry gate serves both the
AsyncLoader (worker reads) and the DeviceFeed (source reads). The module
imports neither torch nor numpy: ``Config.validate`` parses the wire grammar
through it without loading the kernel stack.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

from mlsl_tpu_torch.log import log_warning

#: canonical wire kinds; spec strings may use the aliases below
WIRE_KINDS = ("none", "bf16", "uint8", "int8")

_KIND_ALIASES = {
    "": "none", "none": "none", "f32": "none", "float32": "none", "off": "none",
    "bf16": "bf16", "bfloat16": "bf16",
    "uint8": "uint8", "u8": "uint8",
    "int8": "int8", "i8": "int8",
}


def parse_wire_spec(spec: Optional[str]) -> Tuple[str, Dict[str, str]]:
    """``MLSL_FEED_WIRE_DTYPE`` grammar -> (default kind, per-leaf overrides).

    ``"uint8"`` applies uint8 to every eligible leaf; ``"uint8,y=none"`` or
    ``"x=uint8"`` override single leaves. Leaf names are flattened tree paths
    (``"0"``, ``"1"``, dict keys joined with ``.``); ``x``/``y`` alias the
    first/second leaf of an (x, y) batch tuple, resolved at lookup against
    positional keys only, so a dict key literally named ``"x"`` matches its
    own name. Unknown kinds raise ValueError (``Config.validate`` turns that
    into an MLSLError at init)."""
    default = "none"
    overrides: Dict[str, str] = {}
    for entry in filter(None, (e.strip() for e in (spec or "").split(","))):
        name, sep, kind = entry.partition("=")
        if not sep:
            name, kind = None, entry
        k = _KIND_ALIASES.get(kind.strip().lower())
        if k is None:
            raise ValueError(
                f"unknown feed wire dtype {kind!r} in {spec!r}; "
                f"known: {sorted(set(_KIND_ALIASES))}"
            )
        if name is None:
            default = k
        else:
            overrides[name.strip()] = k
    return default, overrides


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def env_default(name: str, fallback):
    """Environment override typed like ``fallback`` (a str passes through)."""
    v = os.environ.get(name)
    if v in (None, ""):
        return fallback
    return type(fallback)(v) if not isinstance(fallback, str) else v


def retry_or_raise(e: BaseException, attempt: int, retries: int,
                   backoff_s: float,
                   stopping: Optional[Callable[[], bool]] = None) -> int:
    """The retry gate: sleep with exponential backoff and return
    ``attempt + 1`` for a TRANSIENT failure (``supervisor.classify``);
    re-raise ``e`` for anything else, once the retries are spent, or when the
    owner is shutting down."""
    from mlsl_tpu_torch import supervisor
    from mlsl_tpu_torch.core import stats

    if (
        supervisor.classify(e) is not supervisor.ErrorClass.TRANSIENT
        or attempt >= retries
        or (stopping is not None and stopping())
    ):
        raise e
    attempt += 1
    delay = backoff_s * (2 ** (attempt - 1))
    stats.record_feed_retry()
    log_warning(
        "feed: transient source error (%r); retry %d/%d in %.3fs",
        e, attempt, retries, delay,
    )
    time.sleep(delay)
    return attempt
