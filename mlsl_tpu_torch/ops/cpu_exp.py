"""A workaround for a fault of torch's vectorized CPU ``exp`` (ROADMAP C.3).

Now and then ``exp`` (and once ``tanh``) returned one parallel chunk of
32,768 elements about 1e-4 off, relative, on its first call in a process,
after a float32 einsum had started the intra-op threads; the cause is not
known. One throwaway ``exp`` and ``tanh`` that give every thread a chunk,
before the first real one, kept it off the results. ``warm`` runs them once
per thread count it has not seen: ``Environment.init`` on the CPU calls it,
so every trainer's CPU path is covered, and so do the attention plain
versions, which run without an Environment in their tests.
"""

from __future__ import annotations

import torch

_GRAIN = 32768          # at::internal::GRAIN_SIZE, the elements of one chunk
_WARM = set()


def warm(device) -> None:
    """On a CPU device, the throwaway calls for the current thread count,
    once; nothing on a card."""
    if torch.device(device).type != "cpu":
        return
    n = torch.get_num_threads()
    if n not in _WARM:
        x = torch.zeros(2 * n * _GRAIN)
        torch.exp(x)
        torch.tanh(x)
        _WARM.add(n)
