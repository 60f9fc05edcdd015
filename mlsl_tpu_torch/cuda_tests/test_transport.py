"""The cross-process hops on CUDA tensors (comm/transport.py), no JAX.

A world of one process over NCCL, and over gloo (which stages a CUDA tensor
through host memory): each hop returns a CUDA tensor bit for bit its plain
version (a one-member reduction, gather or broadcast is the tensor itself),
and the spanning forms -- the two-level allreduce and reduce_scatter, the
allgather and the assembled form of the other kinds -- equal the
single-process collective on a (4, 2) grid's groups bit for bit. The
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
