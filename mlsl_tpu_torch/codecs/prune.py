"""Magnitude pruning: a bit-packed keep mask and the kept values.

Counterpart of ``mlsl_tpu.codecs.prune`` (prune.py:32-105). The wire is a
keep mask over the whole chunk, eight elements a byte (element ``8j + b`` in
bit ``b`` of byte ``j``, the JAX package's weights 1, 2, ..., 128), followed
by the kept values' float32 bytes in ascending index order. The kept
elements are the ``kept(n)`` largest magnitudes; among equal magnitudes the
lower index wins, as in ``lax.top_k`` (``codecs._stable_topk``), so the mask
is the same bits in both packages and on both devices. ``ratio=1.0`` keeps
every element and round-trips bit for bit. ``topk`` is the same wire at the
top-k sparsifier's default ratio, with the two-tier hop pinned to the
lowering's threshold form (``hier._topk_shared``).
"""

from __future__ import annotations

import torch

from mlsl_tpu_torch.codecs import Codec, _bytes_of_f32, _f32_of_bytes, _stable_topk, register
from mlsl_tpu_torch.log import mlsl_assert


@register
class PruneCodec(Codec):
    """Bit-packed magnitude mask ++ kept float32 values."""

    name = "prune"

    def __init__(self, ratio: float = 0.05) -> None:
        super().__init__()
        mlsl_assert(0.0 < ratio <= 1.0, "prune ratio must be in (0, 1] (got %r)", ratio)
        self.ratio = float(ratio)

    def knob_key(self):
        return (self.name, self.ratio)

    def kept(self, n: int) -> int:
        return min(n, max(1, int(round(n * self.ratio))))

    def _mask_bytes(self, n: int) -> int:
        return -(-n // 8)

    def wire_len(self, n: int) -> int:
        return self._mask_bytes(n) + 4 * self.kept(n)

    def geometry(self, n: int) -> dict:
        g = super().geometry(n)
        g.update(mask_len=int(n), k=self.kept(n))
        return g

    @property
    def lossless(self) -> bool:  # type: ignore[override]
        return self.ratio >= 1.0

    def _encode(self, x):
        r, n = x.shape
        k, nb8 = self.kept(n), self._mask_bytes(n)
        idx = _stable_topk(x.abs(), k).sort(dim=1).values   # decode reads ascending
        mask = torch.zeros((r, nb8 * 8), dtype=torch.int32, device=x.device)
        mask.scatter_(1, idx, 1)
        shifts = torch.arange(8, dtype=torch.int32, device=x.device)
        bits = (mask.reshape(r, nb8, 8) << shifts).sum(dim=2).to(torch.uint8)
        return torch.cat([bits, _bytes_of_f32(x.gather(1, idx))], dim=1)

    def _decode(self, wire, n):
        k, nb8 = self.kept(n), self._mask_bytes(n)
        bits = wire[:, :nb8].to(torch.int32)
        shifts = torch.arange(8, dtype=torch.int32, device=wire.device)
        mask = ((bits[:, :, None] >> shifts) & 1).reshape(wire.shape[0], -1)[:, :n]
        vals = _f32_of_bytes(wire[:, nb8:nb8 + 4 * k])
        rank = (torch.cumsum(mask, dim=1) - 1).clamp(0, k - 1)
        return torch.where(mask > 0, vals.gather(1, rank), torch.zeros((), device=wire.device))


@register
class TopKCodec(PruneCodec):
    """The top-k sparsifier as a registry member: prune's wire at the
    sparsifier's default ratio. A request that resolves to it rides the
    sparse wire of comm/sparse.py, as in the JAX package."""

    name = "topk"

    def __init__(self, ratio: float = 0.01) -> None:
        super().__init__(ratio=ratio)

    def hier_aggregate(self, xq, *, t):
        """The two-tier lowering's top-k hop (comm/algos/hier.py)."""
        from mlsl_tpu_torch.comm.algos import hier

        return hier._topk_shared(xq, self.ratio)
