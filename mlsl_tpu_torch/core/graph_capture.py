"""One training program captured as a CUDA graph: the capture that the
compiled overlap step (comm/overlap.py) and the transformer's fused step
(models/transformer.py) share.

``capture(fn, args, state, what)`` runs ``fn`` once eagerly on copies of
``args`` on a side stream (the warm-up that loads kernels and settles the
allocator), puts ``state`` back as it was, records ``fn`` on those copies as
one ``torch.cuda.CUDAGraph`` and puts ``state`` back again, so a capture
leaves the caller's tensors as it found them. The copies are the graph's
static inputs: ``Captured.replay`` copies a new batch into them and replays.
A capture that fails raises MLSLError; nothing runs eagerly in its place.

The kernel wrappers count a launch when the graph records it, not when it is
replayed: ``Captured.launches`` holds the launches one recording made. The
warm-up's launches are real and count too.

The warm-up and the recording run inside ``chaos.quiet()``: no chaos site
fires and no plan's budget is spent while a program is captured (Python that
a graph records runs once, at the capture). A site that must fire every step
sits on the host before ``replay``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, Iterator, List, Sequence

import torch

from mlsl_tpu_torch.log import MLSLError

WARMUP_RUNS = 1

#: Held for the whole of a capture (warm-up and recording). A thread that
#: issues CUDA work beside the training loop (the feed's loader, data/wire.py)
#: takes it around that work, so none of it is issued while a graph is
#: captured.
CAPTURE_LOCK = threading.Lock()


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by key."""
    from mlsl_tpu_torch.ops import (a2a_kernels, attention_kernels, quant_kernels,
                                    rhd_kernels, ring_kernels)

    return {k: v for m in (quant_kernels, ring_kernels, rhd_kernels, a2a_kernels,
                           attention_kernels) for k, v in m.LAUNCHES.items()}


def put_back(state: Sequence[torch.Tensor], saved: Sequence[torch.Tensor]) -> None:
    """Copy ``saved`` into ``state``, tensor by tensor, in place."""
    with torch.no_grad():
        for t, s in zip(state, saved):
            t.copy_(s)


@contextlib.contextmanager
def restored(state: Sequence[torch.Tensor]) -> Iterator[List[torch.Tensor]]:
    """Whatever runs inside, ``state`` holds its entry values afterwards.
    -> the saved copies."""
    saved = [t.detach().clone() for t in state]
    try:
        yield saved
    finally:
        put_back(state, saved)


@dataclasses.dataclass
class Captured:
    """One captured program: its graph, static inputs and output, the
    launches its recording counted and the recording's seconds."""

    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]
    output: object
    launches: Dict[str, int]
    seconds: float

    def fits(self, args: Sequence[torch.Tensor]) -> bool:
        return all(s.shape == a.shape and s.dtype == a.dtype
                   for s, a in zip(self.inputs, args))

    def replay(self, args: Sequence[torch.Tensor]) -> object:
        """Copy ``args`` into the static inputs and replay. -> the static
        output (the next replay overwrites it)."""
        for s, a in zip(self.inputs, args):
            s.copy_(a)
        self.graph.replay()
        return self.output


def capture(fn: Callable, args: Sequence[torch.Tensor], state: Sequence[torch.Tensor],
            what: str) -> Captured:
    """``fn(*args)`` as one CUDA graph; ``state``: every tensor ``fn`` writes
    in place, put back after the warm-up and after the recording; ``what``
    names the program in the error a failed capture raises."""
    from mlsl_tpu_torch import chaos

    dev = args[0].device
    inputs = [a.detach().clone() for a in args]
    with CAPTURE_LOCK, chaos.quiet(), restored(state) as saved:
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                fn(*inputs)
        cur.wait_stream(side)
        put_back(state, saved)
        # the warm-up drains before the recording starts; CAPTURE_LOCK is
        # held on purpose across the whole capture, the wait included: its
        # one other taker, the feed's loader, must issue no CUDA work
        # until the graph is recorded
        # mlsl-lint: disable=A211 -- deliberate hold across the capture's drain
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            # thread_local: a CUDA call of another thread does not
            # invalidate this capture (the feed's loader also holds off,
            # CAPTURE_LOCK)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn(*inputs)
        except Exception as e:
            raise MLSLError(f"capturing {what} as a CUDA graph failed: {e!r}") from e
        seconds = time.perf_counter() - t0
    launches = {k: v - before.get(k, 0) for k, v in launch_counts().items()
                if v != before.get(k, 0)}
    return Captured(graph, inputs, out, launches, seconds)
