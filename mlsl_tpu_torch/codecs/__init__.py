"""The codec registry: pluggable gradient compression behind one contract.

Counterpart of ``mlsl_tpu.codecs`` (codecs/__init__.py:65-429). A codec is

- ``encode(x) -> wire``: float32 ``(n,)`` -> a self-contained uint8 wire
  image (indices, masks, scales, codebooks: everything decode needs);
- ``decode(wire, n) -> x_hat``: its inverse, float32 ``(n,)``;
- ``wire_len(n)`` / ``wire_bytes(n)``: the image's length, the byte
  accounting behind the per-codec wire statistics and the calibration's cost;
- ``geometry(n)``: the static layout dict;
- ``aggregate(a, b)`` (optional): a sum of two wire images into one, with no
  decode on the hop;
- ``hier_aggregate(xq, t=T)``: the two-tier lowering's DCN hop
  (comm/algos/hier.py). The generic form encodes every member's shard,
  exchanges the wires across the tier peers and folds them through
  ``aggregate``, or decodes and sums them in tier order, which makes every
  registry codec a DCN codec; ``int8``, ``f32`` and ``topk`` take the
  lowering's own exact hops.

Here ``encode``, ``decode`` and ``aggregate`` also take a 2-D batch of rows
(``(R, n)`` -> ``(R, wire_len(n))``), each row coded on its own: the virtual
ranks' chunks go through one call (``as_custom`` tells the transport so). Row
``r`` of a batch is bit for bit ``encode(x[r])``.

Wire images are the JAX package's bytes: float32 fields are their
little-endian byte image (``lax.bitcast_convert_type``; ``Tensor.view(
torch.uint8)`` of a contiguous float32 tensor), int8 payloads their two's
complement bytes. On a CUDA tensor ``Int8Codec`` runs the port's kernels B1
(``quantize_blocks``) and B2 (``dequantize_blocks``), which are bit for bit
``quantize_blocks_ref`` / ``dequantize_blocks_ref``, what the JAX codec calls;
a block the kernels cannot take (not a multiple of 32) raises there. The
other codecs are plain tensor work on either device.

Error feedback belongs to the transport (comm/codec.py), not to a codec: a
codec is a pure encode/decode pair.

The registry also keeps the guardrail of calibrated assignments
(tuner/calibrate.py): a request running a calibrated codec other than int8
registers here; ``guard_note`` takes one screened step's verdict and, after
``window`` breaches in a row, demotes every registered request to int8
(``CommRequest.demote_codec``, with its exactly-once residual flush). The
sentinel's gate (sentinel.py) feeds ``guard_note`` from the loss z-score
screen, as the JAX package's does; a caller may feed it too.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mlsl_tpu_torch.log import mlsl_assert

__all__ = [
    "Codec", "register", "get", "names", "configure", "assigned",
    "guard_register", "guard_unregister", "guard_note", "guard_reset",
    "guard_status", "status",
]


def _bytes_of_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 (..., n) -> uint8 (..., 4n), each element's little-endian bytes."""
    return x.to(torch.float32).contiguous().view(torch.uint8)


def _f32_of_bytes(w: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 4n) -> float32 (..., n)."""
    w = w.contiguous()
    if w.storage_offset() % 4 or any(st % 4 for st in w.stride()[:-1]):
        # a slice of a wire: realign before the view
        w = w.clone(memory_format=torch.contiguous_format)
    return w.view(torch.float32)


def _stable_topk(a: torch.Tensor, k: int) -> torch.Tensor:
    """(R, n) -> (R, k) indices of each row's k largest values, largest
    first, equal values in index order: ``lax.top_k``'s order, ties
    included, on the CPU and on the card alike (a stable descending sort;
    ``torch.topk`` orders ties differently on each device)."""
    return torch.sort(a, dim=-1, descending=True, stable=True).indices[..., :k]


def _as_rows(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    mlsl_assert(x.dim() in (1, 2), "a codec takes (n,) or (rows, n), got %s", tuple(x.shape))
    return (x.unsqueeze(0), True) if x.dim() == 1 else (x, False)


class Codec:
    """The contract. Subclasses set ``name`` and implement ``_encode`` /
    ``_decode`` over (rows, n) batches and ``wire_len``. Instances are
    immutable once made (they are cached and shared by requests)."""

    name: str = "?"
    wire_dtype: str = "uint8"
    #: decode(encode(x)) == x bit for bit for every finite float32 input
    lossless: bool = False
    #: optional compressed-domain pairwise sum; None: the transport decodes
    #: and adds on each hop, and the residual absorbs the difference
    aggregate = None

    def __init__(self) -> None:
        self._custom = None

    def knob_key(self) -> Tuple:
        """Hashable identity of this configured instance (the cache key)."""
        return (self.name,)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        rows, one = _as_rows(x)
        w = self._encode(rows.to(torch.float32))
        return w[0] if one else w

    def decode(self, wire: torch.Tensor, n: int) -> torch.Tensor:
        rows, one = _as_rows(wire)
        x = self._decode(rows, int(n))
        return x[0] if one else x

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _decode(self, wire: torch.Tensor, n: int) -> torch.Tensor:
        raise NotImplementedError

    def wire_len(self, n: int) -> int:
        """Wire elements (uint8 bytes) for an n-element float32 chunk."""
        raise NotImplementedError

    def wire_bytes(self, n: int) -> int:
        return self.wire_len(n)

    def geometry(self, n: int) -> dict:
        return {"codec": self.name, "chunk": int(n), "wire_len": int(self.wire_len(n))}

    def hier_aggregate(self, xq: torch.Tensor, *, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One inter-tier hop of the two-tier lowering (codecs/__init__.py:
        109-135 of the JAX package) over the tier view ``xq`` (C, T, L, s):
        member (t, l)'s shard at [:, t, l]. Each shard is encoded, the wires
        of the T tier peers are exchanged, and each member folds them in
        tier order through ``aggregate`` and decodes once, or decodes each
        and adds. -> (the reduced shard of every member, the entry
        residual ``xq - decode(encode(xq))``), both (C, T, L, s)."""
        c, tt, l, n = xq.shape
        mlsl_assert(tt == t, "hier_aggregate: the tier view has %d tiers, not %d", tt, t)
        w = self.encode(xq.reshape(-1, n)).reshape(c, t, l, -1)
        xhat = self.decode(w.reshape(c * t * l, -1), n).reshape(c, t, l, n)
        new_err = xq - xhat
        if t == 1:
            return xhat, new_err
        if self.aggregate is not None:
            acc = w[:, 0]
            for i in range(1, t):
                acc = self.aggregate(acc.reshape(c * l, -1),
                                     w[:, i].reshape(c * l, -1)).reshape(c, l, -1)
            red = self.decode(acc.reshape(c * l, -1), n).reshape(c, l, n)
        else:
            red = self.decode(w[:, 0].reshape(c * l, -1), n).reshape(c, l, n)
            for i in range(1, t):
                red = red + self.decode(w[:, i].reshape(c * l, -1), n).reshape(c, l, n)
        return red[:, None].expand(c, t, l, n), new_err

    def as_custom(self):
        """This codec as a ``comm.codec.CustomCodec`` on the compressed ring,
        batched over rows; cached per instance, so that the transport's
        program cache on it persists."""
        if self._custom is None:
            from mlsl_tpu_torch.comm.codec import CustomCodec

            self._custom = CustomCodec(compress=self.encode, decompress=self.decode,
                                       reduce=self.aggregate, name=f"registry:{self.name}",
                                       rows=True, wire_len=self.wire_len)
        return self._custom


# -- the registry --------------------------------------------------------------

_REGISTRY: Dict[str, type] = {}
_INSTANCES: Dict[Tuple, Codec] = {}
_ILOCK = threading.Lock()


def register(cls):
    """Class decorator: add a Codec subclass to the registry under its name."""
    mlsl_assert(isinstance(cls.name, str) and cls.name not in ("", "?"),
                "codec class %s must set a name", cls)
    _REGISTRY[cls.name] = cls
    return cls


def _ensure_builtin() -> None:
    from mlsl_tpu_torch.codecs import prune, vq  # noqa: F401  (register on import)


def names() -> Tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


def get(name: str, **knobs) -> Codec:
    """The cached instance for (name, knobs); default knobs where omitted."""
    _ensure_builtin()
    mlsl_assert(name in _REGISTRY, "unknown codec %r (registry: %s)", name,
                ", ".join(sorted(_REGISTRY)))
    probe = _REGISTRY[name](**knobs)
    key = probe.knob_key()
    with _ILOCK:
        inst = _INSTANCES.get(key)
        if inst is None:
            inst = _INSTANCES[key] = probe
    return inst


def configure(name: str, config=None, cell: Optional[dict] = None) -> Codec:
    """The instance with knobs from a calibration cell first, then the
    Config (the MLSL_* knobs), then the codec's defaults."""
    cell = cell or {}
    params = cell.get("params", {}) or {}

    def pick(key, cfg_attr, default):
        if key in params:
            return params[key]
        if config is not None and cfg_attr:
            return getattr(config, cfg_attr, default)
        return default

    if name == "int8":
        block = cell.get("block") or pick("block", "quant_block_elems", 256)
        return get("int8", block=int(block))
    if name == "vq":
        import numpy as np

        cb = params.get("codebook")
        return get("vq", dim=int(pick("vq_dim", "vq_dim", 4)),
                   k=int(pick("vq_codebook", "vq_codebook", 16)),
                   codebook=np.asarray(cb, dtype=np.float32) if cb is not None else None)
    if name == "prune":
        return get("prune", ratio=float(pick("ratio", "prune_ratio", 0.05)))
    if name == "topk":
        return get("topk", ratio=float(pick("ratio", "topk_ratio", 0.01)))
    return get(name)


# -- the built-in members: int8 and the dense f32 image -----------------------


@register
class Int8Codec(Codec):
    """Blockwise int8: a max-abs scale a block, round half to even
    (ops/quant_kernels.py). Wire = the int8 payload's bytes ++ the float32
    scales' bytes. On the card, one B1 launch encodes a whole batch of rows
    and one B2 launch decodes it."""

    name = "int8"

    def __init__(self, block: int = 256) -> None:
        super().__init__()
        mlsl_assert(block >= 1, "int8 codec block must be >= 1 (got %r)", block)
        self.block = int(block)

    def knob_key(self):
        return ("int8", self.block)

    def _nb(self, n: int) -> int:
        return -(-n // self.block)

    def wire_len(self, n: int) -> int:
        return self._nb(n) * self.block + 4 * self._nb(n)

    def geometry(self, n: int) -> dict:
        g = super().geometry(n)
        g.update(block=self.block, n_blocks=self._nb(n))
        return g

    def _encode(self, x):
        from mlsl_tpu_torch.ops import quant_kernels as qk

        r, n = x.shape
        nb = self._nb(n)
        x2 = F.pad(x, (0, nb * self.block - n)).reshape(r * nb, self.block).contiguous()
        q, s = qk.quantize_blocks(x2)
        return torch.cat([q.view(torch.uint8).reshape(r, nb * self.block),
                          _bytes_of_f32(s.reshape(r, nb))], dim=1)

    def _decode(self, wire, n):
        from mlsl_tpu_torch.ops import quant_kernels as qk

        r = wire.shape[0]
        nb = self._nb(n)
        body = nb * self.block
        q = wire[:, :body].contiguous().view(torch.int8).reshape(r * nb, self.block)
        s = _f32_of_bytes(wire[:, body:body + 4 * nb]).reshape(r * nb)
        return qk.dequantize_blocks(q, s).reshape(r, body)[:, :n]

    def hier_aggregate(self, xq, *, t):
        """The shared-scale int8 hop (comm/algos/hier.py)."""
        from mlsl_tpu_torch.comm.algos import hier

        return hier._block_quant_shared(xq, self.block)


@register
class F32Codec(Codec):
    """The dense wire in registry terms: the float32 byte image, lossless,
    with an exact compressed-domain add as its ``aggregate``."""

    name = "f32"
    lossless = True

    def wire_len(self, n: int) -> int:
        return 4 * n

    def _encode(self, x):
        return _bytes_of_f32(x)

    def _decode(self, wire, n):
        return _f32_of_bytes(wire[:, :4 * n])

    def aggregate(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _bytes_of_f32(_f32_of_bytes(a) + _f32_of_bytes(b))

    def hier_aggregate(self, xq, *, t):
        """The dense hop: the tier-order sum, the residual drained to zero."""
        from mlsl_tpu_torch.comm.algos import hier

        return hier._inter_sum(xq), torch.zeros_like(xq)


# -- assignment ----------------------------------------------------------------


def assigned(config, req_name: str) -> Tuple[str, Optional[dict], str]:
    """The codec of a QUANTIZATION request -> (name, cell or None, source):
    an exported ``MLSL_CODEC`` ("env") > the calibrated per-set assignment
    (``config.codec_assignment``, "calibrated") > ``config.codec`` set in
    code ("config") > int8 ("default")."""
    if config is None:
        return "int8", None, "default"
    forced = getattr(config, "codec", "") or ""
    explicit = getattr(config, "_explicit", ()) or ()
    if forced and "codec" in explicit:
        return forced, None, "env"
    asn = getattr(config, "codec_assignment", None) or {}
    cell = asn.get(req_name)
    if isinstance(cell, dict) and cell.get("codec"):
        return str(cell["codec"]), cell, "calibrated"
    if forced:
        return forced, None, "config"
    return "int8", None, "default"


# -- the guardrail: a loss screen's breaches demote calibrated sets to int8 -----

_GLOCK = threading.Lock()
_GUARDED: Dict[int, "weakref.ReferenceType"] = {}
_BREACH_STREAK = 0


def guard_register(req) -> None:
    """Put a live request running a calibrated codec other than int8 under
    the guardrail (a weak reference: a dropped request leaves by itself)."""
    with _GLOCK:
        _GUARDED[id(req)] = weakref.ref(req)


def guard_unregister(req) -> None:
    with _GLOCK:
        _GUARDED.pop(id(req), None)


def guard_active() -> bool:
    with _GLOCK:
        return any(w() is not None for w in _GUARDED.values())


def guard_note(loss_outlier: bool, *, window: int = 3, step: int = -1) -> bool:
    """One screened step's verdict. A healthy step resets the streak;
    ``window`` breaches in a row while a calibrated codec is guarded demote
    every guarded request to int8. -> True when a demotion fired."""
    global _BREACH_STREAK
    with _GLOCK:
        live = [r for r in (w() for w in _GUARDED.values()) if r is not None]
        if not live:
            _GUARDED.clear()
            _BREACH_STREAK = 0
            return False
        if not loss_outlier:
            _BREACH_STREAK = 0
            return False
        _BREACH_STREAK += 1
        from mlsl_tpu_torch.core import stats as stats_mod

        stats_mod.record_codec("guard_breaches")
        if _BREACH_STREAK < max(1, int(window)):
            return False
        _GUARDED.clear()
        _BREACH_STREAK = 0
    reason = f"sentinel loss z-score breach x{window} (step {step})"
    for req in live:
        req.demote_codec(reason)
    return True


def guard_reset() -> None:
    """Forget the guarded requests and the breach streak."""
    global _BREACH_STREAK
    with _GLOCK:
        _GUARDED.clear()
        _BREACH_STREAK = 0


def guard_status() -> dict:
    with _GLOCK:
        live = [r for r in (w() for w in _GUARDED.values()) if r is not None]
        return {"guarded": sorted(getattr(r, "name", "?") for r in live),
                "breach_streak": _BREACH_STREAK}


def status() -> dict:
    """A JSON-serializable summary: the registered names, the guarded
    requests, the counters, the wire bytes and the demotions."""
    from mlsl_tpu_torch.core import stats as stats_mod

    out = {"registered": list(names())}
    out.update(guard_status())
    out["counters"] = dict(stats_mod.CODEC_COUNTERS)
    out["wire_bytes"] = dict(stats_mod.CODEC_WIRE_BYTES)
    out["demotions"] = list(stats_mod.CODEC_DEMOTIONS)
    return out
