"""The device-resident dataset cache: epoch replays skip the host->device copy.

Counterpart of ``mlsl_tpu.data.cache``. Wire-format batches (compact: a uint8
image batch takes a quarter of its decoded float32 form) stay on the card on
first touch, under an ``MLSL_FEED_CACHE_MB`` budget; a replayed epoch decodes
straight from device memory, with no wire bytes.

Admission-capped, no eviction: an epoch replay touches every entry once, so
evicting A to admit B turns A's future hits into misses one for one. A batch
that does not fit is not cached (counted as a reject) and keeps streaming.

A batch's bytes are the sum of ``nbytes`` over the tensors it holds on the
card: one (R, D, *payload) copy a leaf, since every virtual rank lives on one
device (the JAX package counts the global logical bytes, which is the same
number wherever the seq and model groups are 1).

:class:`AdmissionBudget` is the accounting core (the serving KV cache of the
JAX package rides it too).
"""

from __future__ import annotations

from typing import Dict, Optional

from mlsl_tpu_torch.obs import tracer as obs_trace


class AdmissionBudget:
    """Admit-or-reject accounting against a fixed byte budget, with release
    for allocators that free."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self.bytes = 0
        self.rejects = 0

    def admit(self, nbytes: int) -> bool:
        """Reserve ``nbytes`` if the budget allows; False = rejected (and
        counted)."""
        if self.bytes + nbytes > self.budget_bytes:
            self.rejects += 1
            return False
        self.bytes += nbytes
        return True

    def release(self, nbytes: int) -> None:
        """Return ``nbytes`` to the budget."""
        self.bytes = max(0, self.bytes - nbytes)


class FeedCache(AdmissionBudget):
    """Wire-batch cache keyed by position in the epoch."""

    def __init__(self, budget_mb: float):
        super().__init__(int(budget_mb * (1 << 20)))
        self._slots: Dict[int, object] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._slots)

    def get(self, key: int):
        """The cached wire batch or None; counts hits and misses into
        ``FEED_COUNTERS``."""
        from mlsl_tpu_torch.core import stats

        item = self._slots.get(key)
        if item is None:
            self.misses += 1
            stats.record_feed_cache("miss")
            return None
        self.hits += 1
        stats.record_feed_cache("hit")
        tr = obs_trace._tracer
        if tr is not None:
            tr.instant("feed.cache_hit", "feed", batch=key)
        return item

    def put(self, key: int, wire_batch) -> bool:
        """Keep a staged wire batch if the budget allows; False = rejected
        (the caller then donates it to the decode)."""
        from mlsl_tpu_torch.core import stats

        if key in self._slots:
            return True
        if not self.admit(wire_batch.nbytes):
            stats.record_feed_cache("reject")
            return False
        self._slots[key] = wire_batch
        return True

    def complete(self, n: Optional[int]) -> bool:
        """True when every one of the dataset's ``n`` batches is cached."""
        return n is not None and len(self._slots) == n

    def clear(self) -> None:
        self._slots.clear()
        self.bytes = 0
