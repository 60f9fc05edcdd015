"""The device feed on the card (data/): the int8 wire's batched B2 decode
against its plain version, and the pinned staging sets reused under depth 3
with a slow consumer, each batch held to the CPU feed's decode bit for bit."""

import time

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.comm.mesh import Topology
from mlsl_tpu_torch.data import AsyncLoader, DeviceFeed, FeedCodec
from mlsl_tpu_torch.ops import quant_kernels as qk


def _batches(k, b, shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        x = rng.normal(size=(b, *shape)) * rng.uniform(0.1, 20.0)
        y = rng.integers(0, 1000, size=(b,)).astype(np.int32)
        out.append((x.astype(dtype), y))
    return out


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 256, 1024])
@pytest.mark.parametrize("grid", [(8, 1), (2, 4)])
def test_cuda_int8_wire_decode_bit_exact_vs_plain(block, grid):
    """One B2 launch a decode over every shard's rows, equal to the plain
    version (the same codec on the CPU) and to dequantize_blocks_ref of the
    numpy encode."""
    from mlsl_tpu_torch.data.wire import _encode_int8

    topo = Topology(grid[0], grid[1], 8)
    (x, y), = _batches(1, 16, (24, 24, 3), seed=block)
    gpu, cpu = (FeedCodec(topo, "int8", quant_block=block, device=d) for d in ("cuda", "cpu"))
    wire, wb, fb = gpu.stage((x, y))
    before = qk.LAUNCHES["dequantize_blocks"]
    dx, dy = gpu.decode(wire)
    torch.cuda.synchronize()
    assert qk.LAUNCHES["dequantize_blocks"] == before + 1
    cw, cwb, cfb = cpu.stage((x, y))
    cx, cy = cpu.decode(cw)
    assert (wb, fb) == (cwb, cfb)
    assert _same(dx.cpu(), cx) and _same(dy.cpu(), cy)
    d = grid[0]
    local = 16 // d
    for i in range(d):
        q, s = _encode_int8(x[i * local:(i + 1) * local], block)
        ref = qk.dequantize_blocks_ref(torch.from_numpy(q).reshape(-1, block),
                                       torch.from_numpy(s)).reshape(-1)[:local * 24 * 24 * 3]
        assert _same(dx[0, i, 0, 0].cpu().reshape(-1), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["uint8", "int8", "bf16", ""])
def test_cuda_staging_reuse_slow_consumer(wire):
    """Depth 3, a consumer slower than the worker, batches of distinct values
    large enough that copies take time: every decoded batch equals the CPU
    feed's, so no staging set or freed wire buffer was reused while still in
    use."""
    topo = Topology(8, 1, 8)
    batches = _batches(10, 32, (64, 64, 3), seed=7)
    want = [tuple(t.clone() for t in b) for b in DeviceFeed(batches, topo, wire=wire,
                                                             device="cpu")]
    feed = DeviceFeed(batches, topo, wire=wire, device="cuda")
    loader = AsyncLoader(feed, depth=3)
    got = []
    for b in loader:
        time.sleep(0.02)
        # overwrite-prone work on the consumer stream between decodes
        junk = torch.empty(32 << 20, dtype=torch.uint8, device="cuda").fill_(0xA5)
        got.append(tuple(t.cpu() for t in b))
        del junk
    st = loader.stats()
    loader.close()
    assert feed.codec.slots == 4 and st["consumed"] == 10
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(_same(a, b) for a, b in zip(g, w))


@pytest.mark.cuda
def test_cuda_cached_batches_survive_replays():
    topo = Topology(8, 1, 8)
    batches = _batches(3, 16, (32, 32, 3), seed=9)
    feed = DeviceFeed(batches, topo, wire="int8", cache_mb=64, epochs=3, device="cuda")
    loader = AsyncLoader(feed, depth=2)
    outs = [tuple(t.cpu() for t in b) for b in loader]
    loader.close()
    assert len(outs) == 9
    for e in (1, 2):
        for i in range(3):
            assert all(_same(a, b) for a, b in zip(outs[e * 3 + i], outs[i]))


@pytest.mark.cuda
def test_cuda_loader_holds_off_during_a_capture():
    """A graph captured through core/graph_capture while the loader's worker
    stages batches: no copy is issued between the capture's warm-up and the
    end of its recording (CAPTURE_LOCK), every batch decodes equal to the CPU
    feed's, and the graph replays."""
    from mlsl_tpu_torch.core import graph_capture

    x = torch.ones(256, 256, device="cuda")
    (x @ x).sum().item()
    topo = Topology(8, 1, 8)
    batches = _batches(8, 16, (32, 32, 3), seed=11)
    want = [tuple(t.clone() for t in b) for b in DeviceFeed(batches, topo, wire="int8",
                                                             device="cpu")]

    def slow():
        for i, b in enumerate(batches):
            if i:
                time.sleep(0.05)
            yield b

    feed = DeviceFeed(slow, topo, wire="int8", device="cuda")
    copies = []
    copy_to_card = feed.codec._copy_to_card

    def copy(staged, slot):
        copies.append(time.perf_counter())
        return copy_to_card(staged, slot)

    feed.codec._copy_to_card = copy
    loader = AsyncLoader(feed, depth=2)
    got = [tuple(t.cpu() for t in next(loader))]
    window = []

    def program(a):
        window.append(time.perf_counter())
        y, end = a, time.perf_counter() + 0.3
        while time.perf_counter() < end:
            y = y @ x * 1e-3
        window.append(time.perf_counter())
        return y

    captured = graph_capture.capture(program, [x.clone()], [], "a long program")
    got += [tuple(t.cpu() for t in b) for b in loader]
    loader.close()
    captured.replay([x])
    torch.cuda.synchronize()
    assert not [t for t in copies if window[0] < t < window[-1]]
    assert len(got) == 8
    for a, b in zip(got, want):
        assert all(_same(u, v) for u, v in zip(a, b))
