"""The codec registry, the sparse wire and the codec ring on the card against
the same code on the CPU, bit for bit.

``int8`` runs B1 and B2 on the card and their plain versions on the CPU
(one launch of each a batch of rows); ``f32``, ``prune``, ``topk`` and
``vq`` are plain tensor work whose every operation rounds once, the same on
both devices; the top-k selection is a stable sort (ties to the lower index)
and VQ's nearest codeword an explicit sum in element order with
``argmin``'s first-index rule, so ties resolve alike too. The sparse wire's
scatter-adds take one value an element per pass, so the card's atomics add
in no other order than the CPU's.
"""

import numpy as np
import pytest
import torch

from mlsl_tpu_torch import codecs
from mlsl_tpu_torch.comm import codec as tcodec
from mlsl_tpu_torch.comm import sparse as tsparse
from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.ops import quant_kernels as tqk

CARD = torch.device("cuda", 0) if torch.cuda.is_available() else None


def _rows(r, n, seed, ints=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 8, size=(r, n)) if ints else rng.normal(size=(r, n)) * 3.0
    x = x.astype(np.float32)
    x[0, : n // 3] = 0.0           # a run of exact zeros: ties in the selection
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("name,knobs", [("int8", {}), ("int8", {"block": 128}),
                                        ("int8", {"block": 512}), ("f32", {}),
                                        ("prune", {"ratio": 0.25}), ("topk", {}),
                                        ("vq", {}), ("vq", {"dim": 8, "k": 64})])
@pytest.mark.parametrize("n,ints", [(1000, False), (4096, True), (2049000 // 64, False)])
def test_cuda_codec_bit_exact_vs_cpu(name, knobs, n, ints):
    codec = codecs.get(name, **knobs)
    x = _rows(8, n, seed=n, ints=ints)
    before = dict(tqk.LAUNCHES)
    w = codec.encode(x.to(CARD))
    d = codec.decode(w, n)
    torch.cuda.synchronize()
    rw = codec.encode(x)
    assert w.dtype == torch.uint8 and torch.equal(w.cpu(), rw)
    assert torch.equal(d.cpu(), codec.decode(rw, n))
    launched = {k: tqk.LAUNCHES[k] - before[k] for k in before}
    want = 1 if name == "int8" else 0
    assert launched == {"quantize_blocks": want, "dequantize_blocks": want}


@pytest.mark.cuda
def test_cuda_int8_codec_raises_for_a_block_b1_cannot_take():
    with pytest.raises(MLSLError, match="block % 32"):
        codecs.get("int8", block=100).encode(torch.ones(1000, device=CARD))


@pytest.mark.cuda
@pytest.mark.parametrize("use_ring", [False, True], ids=["all-gather", "ring"])
@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter"])
def test_cuda_sparse_wire_bit_exact_vs_cpu(use_ring, kind):
    topo = Topology(8, 1, 8)
    group = ProcessGroup(topo, ("data",))
    n = 8 * 25_000
    fn, el = tsparse.build_sparse_collective(kind, group, n, 0.01, use_ring=use_ring)
    x = _rows(8, n, seed=7).reshape(*topo.grid_shape, n)
    e = _rows(8, n, seed=8).reshape(*topo.grid_shape, n) * 1e-3
    out, err = fn(x.to(CARD), e.to(CARD))
    rout, rerr = fn(x, e)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), rout) and torch.equal(err.cpu(), rerr)


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", [False, True], ids=["decompress-add", "reduce"])
def test_cuda_callable_codec_ring_bit_exact_vs_cpu(reduce):
    """A float16 callable codec on the compressed ring: the card's rounds,
    results and residuals, equal the CPU's over two rounds."""
    topo = Topology(8, 1, 8)
    group = ProcessGroup(topo, ("data",))
    codec = tcodec.CustomCodec(compress=lambda v: v.to(torch.float16),
                               decompress=lambda p, m: p.to(torch.float32),
                               reduce=(lambda a, b: a + b) if reduce else None)
    n = 10_000
    fn, el = tcodec.build_custom_collective("allreduce", group, n, codec)
    err = torch.zeros((*topo.grid_shape, el), device=CARD)
    rerr = torch.zeros((*topo.grid_shape, el))
    for r in range(2):
        x = _rows(8, n, seed=20 + r).reshape(*topo.grid_shape, n)
        out, err = fn(x.to(CARD), err)
        rout, rerr = fn(x, rerr)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), rout) and torch.equal(err.cpu(), rerr)
