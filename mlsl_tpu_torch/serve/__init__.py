"""Serving engine: continuous batching, paged KV cache, SLA-protected decode.

Counterpart of ``mlsl_tpu.serve``, on the training stack of the port:

- **engine.py** -- :class:`InferenceEngine`: an admission queue, continuous
  batching (sequences join and retire between decode steps), the prefill,
  the paged write and the decode step over the model's tensor-parallel
  ranks; the decode's TP reductions route through the collective engine's
  selection table (``MLSL_PALLAS_RHD=1`` puts them on kernel B5). On the card
  the decode step is one CUDA graph, captured once a compute dtype.
- **kv_cache.py** -- :class:`PagedKVCache`: the feed cache's
  ``AdmissionBudget`` generalized to fixed-size pages with a free-list,
  per-sequence page tables and eviction; int8 pages (kernels B1 and B2)
  with ``MLSL_SERVE_KV_QUANT=1``.
- **sla.py** -- :class:`SLAGovernor`: the degradation ladder for load
  (shed batch, then precision, then admission, 429-style
  :class:`ServeOverloadError`).
- **checks.py** -- the engine against its references on the card: the
  unpaged oracle's rule, the decode graph's eager twin, a probe of what each
  token was picked from and when, and planted faults the rule must fail.

This module stays import-light: the engine and the cache are resolved on
first touch.
"""

from __future__ import annotations

from mlsl_tpu_torch.serve.sla import (  # noqa: F401  (re-exports)
    RUNGS,
    ServeOverloadError,
    SLAGovernor,
    get_active,
    reset,
    status,
)

__all__ = [
    "RUNGS",
    "ServeOverloadError",
    "SLAGovernor",
    "get_active",
    "reset",
    "status",
    "InferenceEngine",
    "Request",
    "PagedKVCache",
    "oracle_generate",
]

_LAZY = {
    "InferenceEngine": "mlsl_tpu_torch.serve.engine",
    "Request": "mlsl_tpu_torch.serve.engine",
    "oracle_generate": "mlsl_tpu_torch.serve.engine",
    "PagedKVCache": "mlsl_tpu_torch.serve.kv_cache",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
