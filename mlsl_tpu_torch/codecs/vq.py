"""Vector quantization (GradiVeQ-style, arXiv:1811.03617).

Counterpart of ``mlsl_tpu.codecs.vq`` (vq.py:47-134). A chunk is scaled by
its max-abs, cut into ``dim``-element vectors, and each vector is sent as the
index of its nearest row of a ``k``-row codebook; the wire is one index byte
a vector, then the codebook's and the scale's float32 bytes, so decode needs
nothing else.

Nearest row: the squared distance summed over the vector's elements in
element order, one rounding a term (an explicit loop, so that the CPU and
the card give the same bits); among equally near rows the lowest index wins
(``torch.argmin``, as ``jnp.argmin``). XLA may contract the JAX package's
sum into fused multiply-adds, so where two rows lie within an ulp of each
other the two packages can pick different rows; the tests use inputs without
such ties.

``learn_codebook`` (numpy, as in the JAX package) fits a codebook to a
sample by deterministic Lloyd iterations at calibration time.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mlsl_tpu_torch.codecs import Codec, _bytes_of_f32, _f32_of_bytes, register
from mlsl_tpu_torch.log import mlsl_assert


def default_codebook(k: int, dim: int) -> np.ndarray:
    """A fixed-seed Gaussian cloud scaled to unit max-abs, row 0 the zero
    vector (zero blocks round-trip exactly): the JAX package's array."""
    rng = np.random.default_rng(0)
    cb = rng.standard_normal((k, dim)).astype(np.float32)
    cb /= max(1e-12, np.max(np.abs(cb)))
    cb[0] = 0.0
    return cb


@register
class VQCodec(Codec):
    """Index bytes ++ the codebook ++ the scale."""

    name = "vq"

    def __init__(self, dim: int = 4, k: int = 16, codebook: Optional[np.ndarray] = None) -> None:
        super().__init__()
        mlsl_assert(1 <= dim <= 64, "vq dim must be in [1, 64] (got %r)", dim)
        mlsl_assert(2 <= k <= 256, "vq codebook size must be in [2, 256] (one index byte "
                    "per vector; got %r)", k)
        self.dim = int(dim)
        self.k = int(k)
        cb = (default_codebook(self.k, self.dim) if codebook is None
              else np.asarray(codebook, dtype=np.float32))
        mlsl_assert(cb.shape == (self.k, self.dim), "vq codebook shape %r != (k=%d, dim=%d)",
                    cb.shape, self.k, self.dim)
        self.codebook = cb
        self._cb_digest = hash(cb.tobytes())
        self._cb_dev: dict = {}

    def knob_key(self):
        return ("vq", self.dim, self.k, self._cb_digest)

    def _nvec(self, n: int) -> int:
        return -(-n // self.dim)

    def wire_len(self, n: int) -> int:
        return self._nvec(n) + 4 * self.k * self.dim + 4

    def geometry(self, n: int) -> dict:
        g = super().geometry(n)
        g.update(dim=self.dim, k=self.k, idx_elems=self._nvec(n),
                 codebook_elems=self.k * self.dim)
        return g

    def _cb(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._cb_dev:
            self._cb_dev[key] = torch.from_numpy(self.codebook).to(device)
        return self._cb_dev[key]

    def _encode(self, x):
        r, n = x.shape
        nv = self._nvec(n)
        xf = F.pad(x, (0, nv * self.dim - n))
        amax = xf.abs().amax(dim=1)
        scale = torch.where(amax == 0, torch.ones_like(amax), amax)
        vecs = (xf / scale[:, None]).reshape(r, nv, self.dim)
        cb = self._cb(x.device)
        d2 = None
        for j in range(self.dim):
            d = vecs[:, :, j, None] - cb[:, j]
            d = d * d
            d2 = d if d2 is None else d2 + d
        idx = torch.argmin(d2, dim=2).to(torch.uint8)
        return torch.cat([idx, _bytes_of_f32(cb.reshape(1, -1)).expand(r, -1),
                          _bytes_of_f32(scale[:, None])], dim=1)

    def _decode(self, wire, n):
        r = wire.shape[0]
        nv, cb_elems = self._nvec(n), self.k * self.dim
        idx = wire[:, :nv].to(torch.int64)
        cb = _f32_of_bytes(wire[:, nv:nv + 4 * cb_elems]).reshape(r, self.k, self.dim)
        scale = _f32_of_bytes(wire[:, nv + 4 * cb_elems:nv + 4 * cb_elems + 4])   # (r, 1)
        rows = torch.gather(cb, 1, idx[:, :, None].expand(r, nv, self.dim))
        return (rows * scale[:, :, None]).reshape(r, -1)[:, :n]


def learn_codebook(sample: np.ndarray, k: int, dim: int, iters: int = 8) -> np.ndarray:
    """Deterministic Lloyd iterations over the max-abs-normalized vectors of
    ``sample``, from ``default_codebook``; row 0 stays the zero row
    (``mlsl_tpu.codecs.vq.learn_codebook``, the same numpy)."""
    flat = np.asarray(sample, dtype=np.float32).reshape(-1)
    nv = -(-flat.size // dim)
    flat = np.pad(flat, (0, nv * dim - flat.size))
    amax = float(np.max(np.abs(flat))) if flat.size else 0.0
    vecs = (flat / (amax if amax > 0 else 1.0)).reshape(nv, dim)
    cb = default_codebook(k, dim).copy()
    for _ in range(max(1, int(iters))):
        d2 = ((vecs[:, None, :] - cb[None, :, :]) ** 2).sum(axis=-1)
        idx = np.argmin(d2, axis=1)
        for j in range(k):
            hit = vecs[idx == j]
            if hit.size:
                cb[j] = hit.mean(axis=0)
    cb[0] = 0.0
    return cb.astype(np.float32)
