"""Asynchronous prefetch onto the card: the device feed's engine.

Counterpart of ``mlsl_tpu.data.loader`` (the reference's endpoint-server file
offload, eplib/eplib.h:51-58, as a background thread). Batches are read,
encoded and copied to the card ahead of use, so the training loop does not
wait on its input.

Depth-N buffering: the queue holds up to ``depth`` batches whose copies are
already issued; the worker blocks (backpressure) once that many are in
flight, so device memory is bounded at depth x batch bytes. Time the CONSUMER
blocks on an empty queue is input stall (``stall_ms``), time the WORKER blocks
on a full queue is healthy backpressure (``producer_wait_ms``); both land in
``FEED_COUNTERS``.

Over a :class:`DeviceFeed` the work splits across the queue: the worker does
the host read, the encode and the host->device copy (on the codec's copy
stream), the consumer the decode on its own stream, in order with the
training loop's launches.

Failure contract: a worker that dies surfaces its ORIGINAL exception on the
consumer's next ``__next__`` (never a hang on an empty queue). TRANSIENT
source errors (``supervisor.classify``) retry in place with exponential
backoff under ``MLSL_FEED_RETRIES`` first. The JAX package's ``data.prefetch``
chaos site is not ported yet.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

from mlsl_tpu_torch.data.common import env_int as _env_int, retry_or_raise
from mlsl_tpu_torch.log import log_warning, mlsl_assert


class AsyncLoader:
    """Wraps a host batch source with prefetch to the device.

    source: an iterator or callable yielding host batches, or a
    :class:`DeviceFeed`; place: fn(host_batch) -> device batch (e.g.
    ``trainer.shard_batch``), None = identity (the source already places);
    depth: batches in flight (default ``MLSL_FEED_DEPTH``, 2 = double
    buffering); retries: TRANSIENT source-read retries a batch (default
    ``MLSL_FEED_RETRIES``).
    """

    def __init__(self, source, place: Optional[Callable] = None,
                 depth: Optional[int] = None,
                 retries: Optional[int] = None,
                 retry_backoff_s: float = 0.05):
        self._finalize = getattr(source, "_consumer_decode", None)
        feed = self._finalize is not None and hasattr(source, "_prefetch_iter")
        self._depth = max(1, depth if depth is not None
                          else _env_int("MLSL_FEED_DEPTH", 2))
        if feed:
            mlsl_assert(
                place is None,
                "AsyncLoader: place must be None for a DeviceFeed source -- "
                "the feed already places and decodes its batches (got %r)",
                place,
            )
            # a staging set for every batch in flight and the one being staged
            source.codec.slots = max(source.codec.slots, self._depth + 1)
            source = source._prefetch_iter()
        self._source = iter(source) if not callable(source) else None
        self._source_fn = source if callable(source) else None
        self._place = place
        # a DeviceFeed retries its own reads: retrying here again would call
        # next() on a generator that just raised, which gives StopIteration
        # and truncates the stream instead of surfacing the failure
        self._retries = (0 if feed else
                         retries if retries is not None
                         else _env_int("MLSL_FEED_RETRIES", 2))
        self._retry_backoff_s = retry_backoff_s
        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._done = False
        self._exc: Optional[BaseException] = None
        self._batches = 0
        self._stall_s = 0.0          # consumer blocked on an empty queue
        self._producer_wait_s = 0.0  # worker blocked on a full queue (healthy)
        self._consumed = 0
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name=f"mlsl-prefetch-{id(self):x}"
        )
        self._thread.start()

    def _next_host_batch(self):
        if self._source_fn is not None:
            return self._source_fn()
        return next(self._source)

    def _read_with_retries(self):
        """One batch read with the retry loop. Only a CALLABLE source is
        called again; an iterator whose frame raised is dead, so its failure
        propagates at once with the original exception."""
        attempt = 0
        while True:
            try:
                return self._next_host_batch()
            except StopIteration:
                raise
            except BaseException as e:
                if self._source_fn is None:
                    raise
                attempt = retry_or_raise(e, attempt, self._retries,
                                         self._retry_backoff_s, self._stop.is_set)

    def _worker(self):
        try:
            while not self._stop.is_set():
                try:
                    host = self._read_with_retries()
                except StopIteration:
                    self._q.put(_SENTINEL)
                    return
                self._batches += 1
                if self._place is None:
                    dev = host
                else:
                    dev = (self._place(*host) if isinstance(host, tuple)
                           else self._place(host))
                t0 = time.perf_counter()
                self._q.put(dev)
                waited = time.perf_counter() - t0
                self._producer_wait_s += waited
                if waited > 1e-4:  # backpressure, not queue overhead
                    from mlsl_tpu_torch.core import stats

                    stats.record_feed_wait(waited * 1e3)
        except BaseException as e:  # surface worker failures to the consumer
            self._exc = e
            self._q.put(_SENTINEL)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            # stay exhausted instead of blocking on an empty queue forever
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            # input stall: the training loop waits on its feed
            t0 = time.perf_counter()
            item = self._q.get()
            stall = time.perf_counter() - t0
            self._stall_s += stall
            from mlsl_tpu_torch.core import stats

            stats.record_feed_stall(stall * 1e3)
        if item is _SENTINEL:
            self._done = True
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        self._consumed += 1
        if self._finalize is not None:
            # the decode, on the consumer's thread and stream
            item = self._finalize(item)
        return item

    def stats(self) -> dict:
        """Backpressure accounting: batches produced and consumed, in flight,
        and the consumer-stall and producer-wait totals (ms)."""
        return {
            "depth": self._depth,
            "produced": self._batches,
            "consumed": self._consumed,
            "in_flight": self._q.qsize(),
            "stall_ms": self._stall_s * 1e3,
            "producer_wait_ms": self._producer_wait_s * 1e3,
        }

    def close(self) -> None:
        self._stop.set()
        # drain so that the worker is not blocked on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            # wedged in the source or the copy: say so rather than leak quietly
            log_warning(
                "prefetch thread %s still alive after 5s join "
                "(was serving batch %d); abandoning it",
                self._thread.name,
                self._batches,
            )


_SENTINEL = object()
