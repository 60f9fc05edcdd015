"""DeviceFeed: the wire-compressed, device-cached, epoch-aware device feed.

Counterpart of ``mlsl_tpu.data.feed``. It composes

1. :class:`FeedCodec` -- host batches cross the host->device copy in the
   configured wire dtype and the decode on the device restores the training
   dtype;
2. :class:`FeedCache` -- wire batches stay on the card under
   ``MLSL_FEED_CACHE_MB``; epoch replays decode straight from device memory;
3. epochs -- a per-epoch shuffle from a fixed seed, the same with the cache on
   or off, so the cache changes where the bytes come from, never the data.

Iteration yields decoded batches in the layout ``DataParallelTrainer.
shard_batch`` gives, so ``trainer.step`` takes them unchanged. In a world of
several processes each process feeds its box: every process reads the same
source in the same (shuffled) order, and stages, caches and counts only its
own shards (data/wire.py); the FEED counters and the cache are this
process's. Wrap in
:class:`AsyncLoader` (or use ``DataParallelTrainer.feed``) for prefetch.

Source forms:

- a **sequence** of host batches (list/tuple): random access; the shuffle
  works with or without the cache;
- a **callable** returning a fresh iterator an epoch: sequential replay; once
  the cache holds the whole epoch the source is not read again;
- a **one-shot iterator**: epoch 0 streams it; later epochs replay from the
  cache and raise MLSLError if it does not hold the whole dataset.

``shuffle_seed`` needs a sequence source: a stream cannot replay out of order.

The ``data.prefetch`` chaos site fires at every host read, before the source
is touched (feed.py:122-215 of the JAX package): ``error`` / ``delay`` /
``hang`` act there, and a TRANSIENT error retries as a failed read does. A
fired ``bitrot`` plan rots that read: the batch is staged with
``stage(corrupt=True)`` (its wire payload's first bytes flipped, through the
codec and, when it is cached, the cache), and on a streaming epoch the cache
hit is skipped so that the rot is what is served; a clean copy the cache
already holds stays pinned. Under ``MLSL_CHKP=2`` every float leaf of a
decoded batch must be finite (``checker.check_feed_batch``, one host read a
batch on the consumer's thread).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import torch

from mlsl_tpu_torch import chaos, checker
from mlsl_tpu_torch.data.cache import FeedCache
from mlsl_tpu_torch.data.common import env_default as _env_default, retry_or_raise
from mlsl_tpu_torch.data.wire import FeedCodec
from mlsl_tpu_torch.log import MLSLError, mlsl_assert


class DeviceFeed:
    """One dataset's wire-compressed device feed (see the module docstring).

    epochs: passes over the source (None = forever); shuffle_seed: per-epoch
    batch-order shuffle (None = in order; sequence sources only);
    wire / cache_mb / retries default from ``MLSL_FEED_WIRE_DTYPE`` /
    ``MLSL_FEED_CACHE_MB`` (0 = no cache) / ``MLSL_FEED_RETRIES``;
    normalize / train_dtype / augment / quant_block / device pass through to
    :class:`FeedCodec`.
    """

    #: an AsyncLoader over this feed leaves the site to the feed's own reads
    _chaos_site = "data.prefetch"

    def __init__(self, source, topology, *,
                 wire: Optional[str] = None,
                 cache_mb: Optional[float] = None,
                 epochs: Optional[int] = 1,
                 shuffle_seed: Optional[int] = None,
                 normalize: Optional[Tuple] = None,
                 train_dtype: torch.dtype = torch.float32,
                 augment: Optional[Callable] = None,
                 quant_block: Optional[int] = None,
                 retries: Optional[int] = None,
                 device=None):
        if wire is None:
            wire = os.environ.get("MLSL_FEED_WIRE_DTYPE", "")
        if cache_mb is None:
            cache_mb = float(_env_default("MLSL_FEED_CACHE_MB", 0.0))
        self.codec = FeedCodec(
            topology, wire, normalize=normalize, train_dtype=train_dtype,
            augment=augment, quant_block=int(quant_block or 256), device=device,
        )
        self.cache = FeedCache(cache_mb) if cache_mb > 0 else None
        self.epochs = epochs
        self.shuffle_seed = shuffle_seed
        self.retries = (retries if retries is not None
                        else int(_env_default("MLSL_FEED_RETRIES", 2)))
        self._seq: Optional[Sequence] = (
            source if isinstance(source, (list, tuple)) else None
        )
        self._factory = source if callable(source) else None
        self._iter = (iter(source)
                      if self._seq is None and self._factory is None else None)
        self._n: Optional[int] = len(self._seq) if self._seq is not None else None
        mlsl_assert(
            shuffle_seed is None or self._seq is not None,
            "DeviceFeed: shuffle_seed requires a sequence source (random "
            "access) -- a streaming source cannot replay out of order",
        )
        self._gen = self._drive(self._serve)

    # -- epochs ------------------------------------------------------------------

    def _order(self, epoch: int):
        """Batch visit order for one epoch, the same with the cache on or off."""
        if self.shuffle_seed is None:
            return range(self._n)
        import numpy as np

        rng = np.random.default_rng((self.shuffle_seed, epoch))
        return rng.permutation(self._n)

    def _read_host(self, index: Optional[int], it):
        """One host batch (a sequence index, or an iterator step) with the
        chaos site and the TRANSIENT-retry loop. -> (host batch, whether a
        ``bitrot`` plan fired). A fault at the site fires before the source
        is touched, so it retries for either source. Only a sequence read is
        attempted again after the source failed: an iterator whose frame
        raised is dead (next() would give StopIteration, which ``_drive``
        would read as a truncated epoch), so its failure propagates at once
        with the original exception."""
        attempt = 0
        while True:
            fired = None
            if chaos._plans:
                try:
                    fired = chaos.inject("data.prefetch",
                                         kinds=("error", "delay", "hang", "bitrot"),
                                         batch=index)
                except BaseException as e:
                    attempt = retry_or_raise(e, attempt, self.retries, 0.05)
                    continue
            try:
                host = self._seq[index] if it is None else next(it)
                return host, (fired is not None and fired.kind == "bitrot")
            except StopIteration:
                raise
            except BaseException as e:
                if it is not None:
                    raise
                attempt = retry_or_raise(e, attempt, self.retries, 0.05)

    def _serve(self, key: int, it):
        """One decoded batch: a cache hit decodes from device memory; a miss
        reads the source, stages it and keeps the wire batch if the budget
        allows (a batch that was not kept is donated to the decode)."""
        wire_batch, donate = self._serve_wire(key, it)
        return self._checked_decode(wire_batch, donate)

    def _checked_decode(self, wire_batch, donate):
        """The decode and the checker's boundary: under ``MLSL_CHKP=2`` every
        float leaf of the decoded batch is checked finite (one host read), so
        that a wire or cache fault surfaces here and not as a poisoned
        gradient."""
        batch = self.codec.decode(wire_batch, donate=donate)
        lvl = checker.level()
        if lvl >= checker.CHKP_VALUES:
            checker.check_feed_batch(batch, lvl)
        return batch

    @property
    def cache_complete(self) -> bool:
        return (self.cache is not None and self._n is not None
                and self.cache.complete(self._n))

    def _stream_iter(self, epoch: int):
        if self._factory is not None:
            return iter(self._factory())
        if epoch == 0:
            return self._iter
        raise MLSLError(
            "DeviceFeed: source is a one-shot iterator and the feed cache "
            "does not hold the full dataset (%d of %s batches cached) -- "
            "epoch %d cannot replay. Pass a sequence / factory source or "
            "raise MLSL_FEED_CACHE_MB." % (
                0 if self.cache is None else len(self.cache), self._n, epoch,
            )
        )

    def _serve_wire(self, key: int, it):
        """The wire half of :meth:`_serve`: -> (wire_batch, donate). Runs on
        the thread that drives the stream (the AsyncLoader's worker); the
        decode runs on the consumer's thread. A streaming epoch (``it`` not
        None) always advances the iterator first, so that a partly cached epoch
        stays aligned with its source, and the cache then only saves the copy;
        random access skips the host read on a hit."""
        if it is not None:
            host, rot = self._read_host(None, it)
            # a fired bitrot is what is served: skip the cache hit (the
            # clean copy stays pinned -- a transient rot, not a poisoned pin)
            if self.cache is not None and not rot:
                cached = self.cache.get(key)
                if cached is not None:
                    return cached, False
        else:
            if self.cache is not None:
                cached = self.cache.get(key)
                if cached is not None:
                    return cached, False
            host, rot = self._read_host(key, None)
        wire_batch, _, _ = self.codec.stage(host, corrupt=rot)
        kept = self.cache is not None and self.cache.put(key, wire_batch)
        return wire_batch, not kept

    def _consumer_decode(self, item):
        """The decode the AsyncLoader runs on the consumer thread:
        (wire_batch, donate) -> decoded batch."""
        wire_batch, donate = item
        return self._checked_decode(wire_batch, donate)

    def _prefetch_iter(self):
        """The wire-batch stream for AsyncLoader: the worker runs the host
        encode and the copy ahead of use, the consumer the decode."""
        return self._drive(self._serve_wire)

    def _drive(self, emit):
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            if self._seq is not None:
                for i in self._order(epoch):
                    yield emit(int(i), None)
            elif self.cache_complete:
                # the whole epoch is on the card: the source is not read again
                for i in range(self._n):
                    yield emit(i, None)
            else:
                it = self._stream_iter(epoch)
                i = 0
                while True:
                    try:
                        item = emit(i, it)
                    except StopIteration:
                        break
                    yield item
                    i += 1
                if self._n is None:
                    self._n = i
                else:
                    mlsl_assert(self._n == i,
                                "source epoch length changed (%d, then %d)", self._n, i)
            epoch += 1

    def __iter__(self):
        return self._gen

    def __next__(self):
        return next(self._gen)
