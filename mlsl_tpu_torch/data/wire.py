"""Wire codecs, per-shard staging into pinned host memory, and the decode on
the device.

Counterpart of ``mlsl_tpu.data.wire``. Batches cross the host->device copy in
a compact *wire dtype*; the decode on the device restores the training dtype.

Wire kinds per leaf (``MLSL_FEED_WIRE_DTYPE``, parsed by
:func:`parse_wire_spec`):

- ``none``/``f32`` -- shipped unchanged;
- ``bf16``  -- cast on the host (``torch.Tensor.to(torch.bfloat16)``, round to
  nearest even, as ``ml_dtypes`` in the JAX package), cast back on the device;
- ``uint8`` -- images. A uint8 leaf ships raw; a float leaf ships affine-
  quantized with a per-shard (offset, scale) pair. The decode is a cast,
  ``(q + off) * scale`` as two separate ops and the optional ``(x - mean) *
  inv_std`` with the host-computed reciprocal, bit for bit the same float32
  math on the host;
- ``int8``  -- the block codec of the quantized collectives (max|x|/127 a
  block, float32 scales). The decode is kernel B2
  (``quant_kernels.dequantize_blocks``), launched once a leaf over the rows
  of every shard.

Staging: every (replica, data) shard of the host batch is encoded on its own
(a quantization block never straddles two shards) and written into one
pinned host tensor a leaf, (R, D, *payload), which is copied to the card with
``non_blocking=True`` on the codec's copy stream (a high-priority pool
stream, never one a CUDA graph captures on), holding
``graph_capture.CAPTURE_LOCK`` so that no copy is issued while the training
loop captures a graph. The pinned tensors are kept
in ``slots`` rotating sets; a set is written again only once its copy's event
has completed. The decode waits on that event on the consumer's stream and
marks every wire tensor as used there (``record_stream``), so a wire buffer
freed after the decode is not reused while the decode still reads it. On the
CPU each batch gets fresh tensors. The decoded leaves are (R, D, S, M, localB,
...) views expanded from (R, D, 1, 1, ...), as ``DataParallelTrainer.
shard_batch`` gives them.

Non-float leaves (labels) always ride unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mlsl_tpu_torch.core import graph_capture
from mlsl_tpu_torch.data.common import WIRE_KINDS, parse_wire_spec  # noqa: F401
from mlsl_tpu_torch.log import MLSLError, mlsl_assert
from mlsl_tpu_torch.ops import quant_kernels

#: the int8 payload of a shard is padded to ``block * ROW_TILE`` elements, the
#: JAX package's tile unit (its ``quant_kernels.ROW_TILE``): a constant of the
#: wire format, so both packages ship and count the same bytes
ROW_TILE = 32

#: |off| bound for the affine uint8 codec: above it, float32 ulp(off) exceeds
#: 0.25 quantization units and ``q + off`` eats the 8 payload bits
_UINT8_OFF_LIMIT = float(2 ** 22)


# -- batch trees -------------------------------------------------------------------


def _flatten(tree, path=()):
    """-> ([(leaf name, leaf)], structure). Tuples and lists by index, dicts by
    sorted key (as jax.tree_util), names joined with '.'."""
    if isinstance(tree, (tuple, list)):
        leaves, subs = [], []
        for i, t in enumerate(tree):
            lv, st = _flatten(t, path + (str(i),))
            leaves += lv
            subs.append(st)
        return leaves, (type(tree), None, tuple(subs))
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        leaves, subs = [], []
        for k in keys:
            lv, st = _flatten(tree[k], path + (str(k),))
            leaves += lv
            subs.append(st)
        return leaves, (dict, keys, tuple(subs))
    return [(".".join(path), tree)], None


def _unflatten(structure, leaves):
    it = iter(leaves)

    def build(st):
        if st is None:
            return next(it)
        typ, keys, subs = st
        kids = [build(s) for s in subs]
        return dict(zip(keys, kids)) if typ is dict else typ(kids)

    return build(structure)


def _effective_kind(kind: str, arr: np.ndarray) -> str:
    """Clamp a requested kind to what the leaf can carry: non-float leaves ride
    unchanged; uint8 also takes native uint8 leaves (raw image bytes)."""
    if kind == "none":
        return "none"
    if kind == "uint8":
        if arr.dtype == np.uint8 or np.issubdtype(arr.dtype, np.floating):
            return "uint8"
        return "none"
    if np.issubdtype(arr.dtype, np.floating):
        return kind
    return "none"


# -- host encoders (numpy; run on the loader's worker thread) ----------------------


def _encode_uint8(sl: np.ndarray, key: str = "?"):
    """Affine uint8 with the decode contract ``(q + off) * scale``: an add
    feeding a multiply has no fused form, so every backend rounds each op once.
    The DC offset rides in quantization units (off = lo / scale); a leaf whose
    offset dwarfs its spread is refused rather than decoded to a constant."""
    if sl.dtype == np.uint8:
        return np.ascontiguousarray(sl), None
    f = sl.astype(np.float32)
    lo = np.float32(f.min()) if f.size else np.float32(0.0)
    hi = np.float32(f.max()) if f.size else np.float32(0.0)
    scale = np.float32((hi - lo) / np.float32(255.0))
    if scale == 0.0:
        scale = np.float32(1.0)
    off = np.float32(lo / scale)
    if abs(float(off)) > _UINT8_OFF_LIMIT:
        raise MLSLError(
            f"feed leaf {key!r}: uint8 affine wire cannot carry this data -- "
            f"DC offset / spread ratio too large (lo={float(lo):g}, "
            f"scale={float(scale):g}, off=lo/scale={float(off):g} exceeds "
            f"{_UINT8_OFF_LIMIT:g}); float32 would drop quantization bits "
            f"and decode toward a constant. Use a per-leaf override "
            f"(MLSL_FEED_WIRE_DTYPE='...,{key}=bf16' or '...,{key}=none') "
            f"for this leaf."
        )
    q = np.clip(np.rint(f / scale - off), 0, 255).astype(np.uint8)
    return q, np.array([off, scale], np.float32)


def _encode_int8(sl: np.ndarray, block: int):
    """Blockwise int8, the numpy mirror of ``quantize_blocks_ref`` (max|x|/127,
    round half to even), zero-padded to ``block * ROW_TILE`` elements."""
    f = sl.reshape(-1).astype(np.float32)
    n = f.size
    unit = block * ROW_TILE
    npad = -(-max(n, 1) // unit) * unit
    buf = np.zeros(npad, np.float32)
    buf[:n] = f
    x2d = buf.reshape(-1, block)
    amax = np.abs(x2d).max(axis=1)
    scale = np.where(amax == 0.0, 1.0, amax / 127.0).astype(np.float32)
    q = np.clip(np.rint(x2d / scale[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1), scale


def _encode_bf16(sl: np.ndarray) -> np.ndarray:
    """bf16 bits (as int16) of a float leaf, rounded by torch on the host."""
    t = torch.from_numpy(np.ascontiguousarray(sl)).to(torch.bfloat16)
    return t.view(torch.int16).numpy()


def _encode_slice(kind: str, sl: np.ndarray, block: int, key: str = "?"):
    """-> (payload array, meta array or None) for one shard."""
    if kind == "none":
        return np.ascontiguousarray(sl), None
    if kind == "bf16":
        return _encode_bf16(sl), None
    if kind == "uint8":
        return _encode_uint8(sl, key)
    return _encode_int8(sl, block)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """Static per-leaf layout, fixed by the first staged batch."""

    key: str
    kind: str
    local_shape: Tuple[int, ...]  # decoded per-shard shape (localB, *payload)
    n: int                        # elements per shard
    has_meta: bool                # an (off, scale) pair or block scales ride along


class WireBatch:
    """A staged batch on the device: ``leaves`` holds one dict a leaf, ``q``
    (R, D, *payload) and, for uint8-affine and int8, ``s`` (R, D, meta);
    ``event`` is the end of its host->device copy on the copy stream (None on
    the CPU), ``start`` the copy's start (for ``copy_ms``)."""

    __slots__ = ("leaves", "event", "start")

    def __init__(self, leaves, event=None, start=None):
        self.leaves = leaves
        self.event = event
        self.start = start

    @property
    def nbytes(self) -> int:
        """Bytes the batch holds on the device."""
        return sum(t.nbytes for w in self.leaves for t in w.values())

    def copy_ms(self) -> Optional[float]:
        """The host->device copy's time on the card (waits for it); None on
        the CPU."""
        if self.event is None:
            return None
        self.event.synchronize()
        return self.start.elapsed_time(self.event)


class _Slot:
    """One set of pinned staging tensors and the event of its last copy."""

    __slots__ = ("bufs", "event")

    def __init__(self):
        self.bufs: Dict[Tuple[int, str], torch.Tensor] = {}
        self.event = None


def _resolve_device(device) -> torch.device:
    if device is None:
        from mlsl_tpu_torch.core.environment import default_device

        device = default_device()
    device = torch.device(device)
    if device.type == "cuda":
        mlsl_assert(torch.cuda.is_available(), "the feed was asked for %s, but CUDA is "
                    "not available (pass device='cpu')", device)
    else:
        mlsl_assert(device.type == "cpu", "the feed runs on cuda or cpu, not %s", device)
    return device


class FeedCodec:
    """Wire encode, staging and decode for one batch structure (shapes fixed
    across batches). ``normalize=(mean, std)`` is applied to uint8-decoded
    leaves; ``augment`` to the decoded batch. ``device``: None = the
    initialized Environment's, else the card. ``slots``: pinned staging sets on the card
    (the AsyncLoader raises it to its depth + 1)."""

    def __init__(self, topology, wire: Optional[str] = None, *,
                 normalize: Optional[Tuple] = None,
                 train_dtype: torch.dtype = torch.float32,
                 augment: Optional[Callable] = None,
                 quant_block: int = 256,
                 device=None,
                 slots: int = 2):
        self.topo = topology
        self.device = _resolve_device(device)
        self.default, self.overrides = parse_wire_spec(wire)
        self.block = int(quant_block)
        # B2 takes rows of any positive multiple of 32 elements (one warp a
        # row); refuse any other block here rather than at the first decode
        if self.block <= 0 or self.block % 32:
            raise MLSLError(f"feed int8 wire: quant_block {self.block} is not a positive "
                            f"multiple of 32, which kernel B2 needs")
        self.normalize = None
        self._norm_dev = None
        if normalize is not None:
            # mean and the HOST-computed reciprocal of std; the device applies
            # (x - mean) * inv_std with both as float32 tensors, never a
            # division (bit-exact against the same host math)
            mean = np.asarray(normalize[0], np.float32)
            inv = np.asarray(np.float32(1.0) / np.asarray(normalize[1], np.float32),
                             np.float32)
            self.normalize = (mean, inv)
            self._norm_dev = (torch.from_numpy(mean.copy()).to(self.device),
                              torch.from_numpy(inv.copy()).to(self.device))
        self.train_dtype = train_dtype
        self.augment = augment
        self.slots = max(1, int(slots))
        self._layout: Optional[List[_Leaf]] = None
        self._treedef = None
        self._batches = 0
        self._pool: List[_Slot] = []
        self._next = 0
        self._copy_stream = None

    # -- encode + staging ------------------------------------------------------

    def leaf_kind(self, key: str, arr: np.ndarray) -> str:
        kind = self.overrides.get(key)
        if kind is None and key in ("0", "1"):
            # x/y alias the (x, y) tuple's positional leaves; an exact key
            # match (a dict leaf literally named 'x') wins
            kind = self.overrides.get("x" if key == "0" else "y")
        if kind is None:
            kind = self.default
        return _effective_kind(kind, arr)

    def stage(self, host_batch, corrupt: bool = False):
        """Host batch -> (WireBatch, wire_bytes, full_bytes). Each (replica,
        data) shard is encoded on its own; ``full_bytes`` is what the float32
        path would have shipped, both counted per device as in the JAX package
        (the copy itself is made once for the S x M ranks of a shard).
        ``corrupt`` flips the first 64 payload bytes (a bad host read must flow
        through decode and the cache, not crash them)."""
        leaves, treedef = _flatten(host_batch)
        if self._layout is None:
            self._treedef = treedef
            self._layout = self._build_layout(leaves)
        else:
            mlsl_assert(treedef == self._treedef,
                        "feed batch structure changed mid-stream (got %s, staged %s)",
                        treedef, self._treedef)
        r_, d_, s_, m_ = self.topo.grid_shape
        cuda = self.device.type == "cuda"
        staged = []
        wire_bytes = full_bytes = 0
        for li, (leaf, (_, arr)) in enumerate(zip(self._layout, leaves)):
            arr = np.asarray(arr)
            b = arr.shape[0]
            local_b = b // (r_ * d_)
            mlsl_assert(local_b * r_ * d_ == b,
                        "batch size %d must divide over %d data ranks", b, r_ * d_)
            mlsl_assert((local_b, *arr.shape[1:]) == leaf.local_shape,
                        "feed leaf %s shape changed mid-stream (got %s, staged %s)",
                        leaf.key, (local_b, *arr.shape[1:]), leaf.local_shape)
            f32_nbytes = (arr[:local_b].size * 4 if np.issubdtype(arr.dtype, np.floating)
                          else arr[:local_b].nbytes)
            q_parts, s_parts = [], []
            for i in range(r_ * d_):
                q, meta = _encode_slice(leaf.kind, arr[i * local_b:(i + 1) * local_b],
                                        self.block, leaf.key)
                if corrupt:
                    q = q.copy()
                    flat = q.view(np.uint8).reshape(-1)
                    flat[:min(64, flat.size)] ^= 0xFF
                    corrupt = False  # one rotted block a batch
                q_parts.append(q)
                s_parts.append(meta)
            per_dev = s_ * m_
            wire_bytes += sum(q.nbytes for q in q_parts) * per_dev
            full_bytes += f32_nbytes * r_ * d_ * per_dev
            parts = {"q": q_parts}
            if leaf.has_meta:
                parts["s"] = s_parts
                wire_bytes += sum(s.nbytes for s in s_parts) * per_dev
            staged.append((li, parts))
        if cuda:
            # no CUDA call of the feed while a graph is captured
            with graph_capture.CAPTURE_LOCK:
                wire = self._copy_to_card(staged, self._take_slot())
        else:
            wire = WireBatch(tuple({k: self._host_tensor(v) for k, v in parts.items()}
                                   for _, parts in staged))
        self._batches += 1
        from mlsl_tpu_torch.core import stats

        stats.record_feed_stage(wire_bytes, full_bytes)
        return wire, wire_bytes, full_bytes

    def _host_tensor(self, parts) -> torch.Tensor:
        """Per-shard arrays -> one (R, D, *payload) tensor (fresh memory)."""
        r_, d_ = self.topo.grid_shape[:2]
        a = np.stack(parts).reshape(r_, d_, *parts[0].shape)
        t = torch.from_numpy(a)
        return t.view(torch.bfloat16) if a.dtype == np.int16 else t

    def _take_slot(self) -> _Slot:
        """The next pinned staging set, once its last copy has completed."""
        while len(self._pool) < self.slots:
            self._pool.append(_Slot())
        slot = self._pool[self._next % len(self._pool)]
        self._next += 1
        if slot.event is not None:
            slot.event.synchronize()
        return slot

    def _copy_to_card(self, staged, slot: _Slot) -> WireBatch:
        """Write the shards into the slot's pinned tensors and copy them to the
        card on the copy stream; -> the WireBatch with its copy events."""
        r_, d_ = self.topo.grid_shape[:2]
        if self._copy_stream is None:
            # from the high-priority pool: PyTorch hands out pool streams round
            # robin, so a default-priority one can be the very stream a CUDA
            # graph captures on (torch.cuda.graph's default capture stream),
            # and work queued on a stream while it is captured goes into the
            # graph
            self._copy_stream = torch.cuda.Stream(self.device, priority=-1)
        stream = self._copy_stream
        host = []
        for li, parts in staged:
            bufs = {}
            for k, arrs in parts.items():
                shape = (r_, d_, *arrs[0].shape)
                dtype = torch.from_numpy(arrs[0][:0]).dtype
                buf = slot.bufs.get((li, k))
                if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
                    buf = torch.empty(shape, dtype=dtype, pin_memory=True)
                    slot.bufs[(li, k)] = buf
                view = buf.numpy().reshape(r_ * d_, *arrs[0].shape)
                for i, a in enumerate(arrs):
                    view[i] = a
                bufs[k] = buf
            host.append(bufs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            start.record(stream)
            for (li, _), bufs in zip(staged, host):
                w = {}
                for k, buf in bufs.items():
                    t = buf.to(self.device, non_blocking=True)
                    w[k] = t.view(torch.bfloat16) if t.dtype == torch.int16 else t
                out.append(w)
            end.record(stream)
        slot.event = end
        return WireBatch(tuple(out), end, start)

    def _build_layout(self, leaves) -> List[_Leaf]:
        r_, d_ = self.topo.grid_shape[:2]
        layout = []
        for key, arr in leaves:
            arr = np.asarray(arr)
            kind = self.leaf_kind(key, arr)
            local_shape = (arr.shape[0] // (r_ * d_), *arr.shape[1:])
            has_meta = kind == "int8" or (kind == "uint8" and arr.dtype != np.uint8)
            layout.append(_Leaf(key, kind, local_shape, int(np.prod(local_shape)), has_meta))
        return layout

    # -- decode on the device ----------------------------------------------------

    def decode(self, wire_batch: WireBatch, donate: bool = False):
        """WireBatch -> the decoded batch, every leaf (R, D, S, M, localB, ...).
        ``donate``: the decode drops the WireBatch's references to its tensors
        (a freshly staged batch: the allocator reclaims them once the decode's
        work is done); a cached batch decodes with ``donate=False`` and
        survives any number of decodes."""
        mlsl_assert(self._layout is not None, "decode before any staged batch")
        wires = wire_batch.leaves
        mlsl_assert(wires is not None, "decode of a donated wire batch")
        if donate:
            wire_batch.leaves = None
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            if wire_batch.event is not None:
                cur.wait_event(wire_batch.event)
            for w in wires:
                for t in w.values():
                    t.record_stream(cur)
        r_, d_, s_, m_ = self.topo.grid_shape
        out = []
        for leaf, w in zip(self._layout, wires):
            ls = leaf.local_shape
            q = w["q"]
            if leaf.kind == "none":
                x = q
            elif leaf.kind == "bf16":
                x = q.to(self.train_dtype)
            elif leaf.kind == "uint8":
                x = q.to(torch.float32)
                if leaf.has_meta:
                    # (q + off) * scale as two ops, never q * scale + lo
                    s = w["s"]
                    bshape = (r_, d_) + (1,) * len(ls)
                    x = (x + s[..., 0].reshape(bshape)) * s[..., 1].reshape(bshape)
                if self._norm_dev is not None:
                    mean, inv = self._norm_dev
                    x = (x - mean) * inv
                x = x.to(self.train_dtype)
            else:
                # kernel B2, once over the rows of every shard: each shard is
                # padded to whole block * ROW_TILE units, so no row straddles
                # two shards
                x = quant_kernels.dequantize_blocks(q.reshape(-1, self.block),
                                                    w["s"].reshape(-1))
                x = x.reshape(r_, d_, -1)[..., :leaf.n].reshape(r_, d_, *ls)
                x = x.to(self.train_dtype)
            out.append(x.reshape(r_, d_, 1, 1, *ls).expand(r_, d_, s_, m_, *ls))
        del wires
        batch = _unflatten(self._treedef, out)
        if self.augment is not None:
            batch = self.augment(batch)
        return batch
