"""Host batch sources: the producers the device feed pulls from.

Counterpart of ``mlsl_tpu.data.sources`` (numpy only). A source yields host
batches; the loader's worker thread does the read and the host->device copy
while the trainer computes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def file_source(paths, epochs: Optional[int] = 1):
    """Stream (x, y) batches from ``.npz`` files (keys 'x' and 'y').
    ``epochs=None`` cycles forever."""
    paths = list(paths)  # a one-shot iterable must survive several epochs
    e = 0
    while epochs is None or e < epochs:
        for p in paths:
            with np.load(p) as z:
                yield z["x"], z["y"]
        e += 1


def synthetic_source(batch: int, shape, num_classes: int, seed: int = 0,
                     steps: Optional[int] = None, dtype=np.float32):
    """Deterministic synthetic (x, y) batches: normal images of ``shape`` and
    int32 labels below ``num_classes``, from ``seed``."""
    rng = np.random.default_rng(seed)
    produced = 0
    while steps is None or produced < steps:
        x = rng.normal(size=(batch, *shape)).astype(dtype)
        y = rng.integers(0, num_classes, size=(batch,)).astype(np.int32)
        produced += 1
        yield x, y
