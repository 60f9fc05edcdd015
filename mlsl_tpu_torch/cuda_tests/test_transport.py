"""The cross-process hops on CUDA tensors (comm/transport.py), no JAX.

A world of one process over NCCL, and over gloo (which stages a CUDA tensor
through host memory): each hop returns a CUDA tensor bit for bit its plain
version (a one-member reduction, gather or broadcast is the tensor itself),
and the spanning forms -- the two-level allreduce and reduce_scatter, the
allgather and the assembled form of the other kinds -- equal the
single-process collective on a (4, 2) grid's groups bit for bit, the direct
alltoall, bcast and sendrecv their assembled form too. The ring shift of a
tuple of CUDA tensors is ``torch.roll`` (nothing crosses in one process), and
one composed int8 ring round on a Span launches B1 once a hop, bit for bit
the round on ``quantize_blocks_ref``. The four differentiable hops of the
trainers (the shift both ways, the sum, the all-to-all, the all-gather), as
their autograd Functions on a one-member span of the world, give CUDA
tensors whose rows and gradients are their plain versions' bit for bit. The
process group is destroyed after each test.
"""

import socket

import pytest
import torch

from mlsl_tpu_torch.comm import collectives, transport
from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
from mlsl_tpu_torch.types import ReductionType


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(params=["nccl", "gloo"])
def backend(request):
    dev = torch.device("cuda", 0)
    transport.bootstrap(f"127.0.0.1:{_port()}", 1, 0, request.param, 0, 0.0, dev)
    yield request.param
    transport.shutdown()


def test_cuda_hops_match_plain(backend):
    transport.reset_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.int32):
        x = (torch.randn(3, 4099, device="cuda", generator=gen) * 100).to(dtype)
        for name, got, want in (
                ("all_reduce", transport.all_reduce(x), x),
                ("all_reduce max", transport.all_reduce(x, op=ReductionType.MAX), x),
                ("reduce_scatter", transport.reduce_scatter(x[None]), x),
                ("all_gather", transport.all_gather(x), x[None]),
                ("broadcast", transport.broadcast(x, 0), x)):
            assert got.is_cuda and got.dtype == dtype, name
            assert torch.equal(got, want), f"{backend} {name} {dtype}"
    stats = transport.hop_totals()
    assert stats["all_reduce"]["calls"] == 4


KINDS = [("allreduce", {"op": ReductionType.SUM}), ("reduce", {"op": ReductionType.MIN}),
         ("reduce_scatter", {"op": ReductionType.SUM, "recv_count": None}),
         ("allgather", {}), ("bcast", {"root": 1}), ("gather", {"root": 0}),
         ("alltoall", {"send_count": None}), ("scatter", {"root": 0, "recv_count": None}),
         ("sendrecv", {"pairs": ((0, 1), (1, 0))})]


def test_cuda_spanning_forms_match_the_collective(backend):
    topo = Topology(4, 2, 8)
    gen = torch.Generator(device="cuda").manual_seed(1)
    buf = torch.randn(*topo.grid_shape, 1024, device="cuda", generator=gen)
    for axes in (("data",), ("model",)):
        group = ProcessGroup(topo, axes)
        for kind, kw in KINDS:
            kw = {k: (1024 // group.size if v is None else v) for k, v in kw.items()}
            plain = collectives.build_raw(kind, group, **kw)(buf)
            span = transport.build_spanning(
                kind, group, collectives._build_raw(kind, group, dict(kw)), **kw)(buf)
            assert span.is_cuda and torch.equal(span, plain), f"{backend} {kind} {axes}"


def test_cuda_ring_shift_is_roll(backend):
    gen = torch.Generator(device="cuda").manual_seed(2)
    f = torch.randn(2, 8, 33, device="cuda", generator=gen)
    f[:, :, 0] = -0.0
    q = torch.randint(-127, 128, (2, 8, 256), device="cuda", generator=gen).to(torch.int8)
    span = transport.span_of(ProcessGroup(Topology(8, 1, 8), ("data",)))
    for got in (transport.ring_shift((f, q), None, 0, 1), span.shift(f, q)):
        assert got[0].is_cuda and torch.equal(got[0].view(torch.int32),
                                              torch.roll(f, 1, dims=1).view(torch.int32))
        assert torch.equal(got[1], torch.roll(q, 1, dims=1))


def test_cuda_direct_exchanges_match_the_assembled_form(backend):
    topo = Topology(4, 2, 8)
    gen = torch.Generator(device="cuda").manual_seed(3)
    buf = torch.randn(*topo.grid_shape, 1024, device="cuda", generator=gen)
    for axes in (("data",), ("model",)):
        group = ProcessGroup(topo, axes)
        g = group.size
        for kind, kw in (("alltoall", {"send_count": 1024 // g}), ("bcast", {"root": g - 1}),
                         ("sendrecv", {"pairs": ((g - 1, 0), (0, g // 2))})):
            plain = collectives.build_raw(kind, group, **kw)(buf)
            direct = transport.build_spanning(kind, group, None, **kw)(buf)
            asm = transport.build_spanning(kind, group, None, direct=False, **kw)(buf)
            assert direct.is_cuda and torch.equal(direct, asm) and torch.equal(direct, plain), \
                f"{backend} {kind} {axes}"


def test_cuda_composed_int8_round_on_b1(backend):
    """One int8 allreduce round of the composed ring over a Span: B1 on the
    entry, every hop and the all-gather's quantize (G + 1 launches), the
    result and the residual bit for bit the round on its plain version."""
    from mlsl_tpu_torch.comm import quant_ring
    from mlsl_tpu_torch.ops import quant_kernels as qk

    topo = Topology(8, 1, 8)
    group = ProcessGroup(topo, ("data",))
    n = 8 * 3 * 256 + 5
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(*topo.grid_shape, n, device="cuda", generator=gen) * 3.0
    fn, el = quant_ring.build_quantized_collective("allreduce", group, n, 256)
    ref, _ = quant_ring.build_quantized_collective("allreduce", group, n, 256, plain=True)
    err = torch.randn(*topo.grid_shape, el, device="cuda", generator=gen) * 0.01
    qk.reset_counts()
    got, got_err = fn(x, err)
    torch.cuda.synchronize()
    assert qk.LAUNCHES["quantize_blocks"] == group.size + 1
    want, want_err = ref(x, err)
    assert torch.equal(got, want) and torch.equal(got_err, want_err)


def _hops():
    one = transport.Span(box=None, g=4, gl=4, off=0, partition=((0,),), index=0, size=1)
    return (
        ("shift+1", lambda t: transport._Shift.apply(one, 1, 1, t)[0],
         lambda t: torch.roll(t, 1, dims=1)),
        ("shift-1", lambda t: transport._Shift.apply(one, 1, -1, t)[0],
         lambda t: torch.roll(t, -1, dims=1)),
        ("axis_sum", lambda t: transport._AxisSum.apply(one, 1, False, t),
         lambda t: t.sum(dim=1, keepdim=True).expand_as(t)),
        ("axis_all_to_all", lambda t: transport._AllToAll.apply(one, 1, 3, t),
         lambda t: t.transpose(1, 3)),
        ("axis_all_gather", lambda t: transport._AllGather.apply(one, 1, 2, t),
         lambda t: transport._concat_members(t, 1, 2, 4)))


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def test_cuda_differentiable_hops_match_plain(backend):
    gen = torch.Generator(device="cuda").manual_seed(5)
    hops = _hops()
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 4, 33, 4, 65, device="cuda", generator=gen).to(dtype)
        x[:, :, 0] = -0.0
        for name, hop, plain in hops:
            a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
            ya, yb = hop(a), plain(b)
            assert ya.is_cuda and torch.equal(_bits(ya), _bits(yb)), f"{backend} {name} {dtype}"
            g = torch.randn(ya.shape, device="cuda", generator=gen).to(dtype)
            (ga,) = torch.autograd.grad(ya, a, g)
            (gb,) = torch.autograd.grad(yb, b, g)
            assert ga.is_cuda and torch.equal(_bits(ga), _bits(gb)), \
                f"{backend} {name} {dtype} backward"
