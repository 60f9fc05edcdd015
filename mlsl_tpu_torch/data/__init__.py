"""The device feed: wire-compressed host->device copies, the decode on the
card, prefetch and a device-resident dataset cache.

Counterpart of ``mlsl_tpu.data``:

- :mod:`.wire`    -- wire codecs (uint8 / bf16 / int8, the block codec of the
  quantized collectives), per-shard staging into pinned host memory, and the
  decode on the device (``FeedCodec``; int8 through kernel B2);
- :mod:`.cache`   -- the device-resident cache (``MLSL_FEED_CACHE_MB``): epoch
  replays skip the host->device copy;
- :mod:`.feed`    -- ``DeviceFeed``: codec + cache + epochs and shuffle;
- :mod:`.loader`  -- ``AsyncLoader``: depth-N prefetch with backpressure
  accounting and the TRANSIENT retry (``MLSL_FEED_DEPTH`` /
  ``MLSL_FEED_RETRIES``);
- :mod:`.sources` -- host batch sources (``file_source``,
  ``synthetic_source``).
"""

# Lazy exports (PEP 562): importing the package, or data.common (which
# Config.validate uses for the wire grammar), must not load torch's kernel
# stack behind wire.py. Submodules load on first attribute access.
_EXPORTS = {
    "AsyncLoader": "mlsl_tpu_torch.data.loader",
    "DeviceFeed": "mlsl_tpu_torch.data.feed",
    "FeedCache": "mlsl_tpu_torch.data.cache",
    "FeedCodec": "mlsl_tpu_torch.data.wire",
    "WIRE_KINDS": "mlsl_tpu_torch.data.common",
    "parse_wire_spec": "mlsl_tpu_torch.data.common",
    "file_source": "mlsl_tpu_torch.data.sources",
    "synthetic_source": "mlsl_tpu_torch.data.sources",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
