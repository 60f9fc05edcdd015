"""The Hopper tile layer (csrc/sm90_tiles.cuh) on one 64 x 64 x 64 product:
TMA loads into 128-byte-swizzled tiles, wgmma descriptors for K-major and
MN-major B, the SS and RS forms, and the accumulator -> bf16 A fragment hand-off
that the flash kernels chain their products with (mlsl_sm90_tile_test in
csrc/attention_sm90.cu).

Small integers make every product exact, so the kernel must equal
torch.matmul in float32 bit for bit; normal values hold it within 1e-5
relative L2 (the sums run in another order), 1e-3 where the intermediate is
rounded to bf16 (a value that lands on a rounding boundary moves one bf16 step).
"""

import ctypes

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.ops import cuda_build

# mode -> (a, b1, b2) -> the product the kernel computes
MODES = {
    0: lambda a, b1, b2: a @ b1.T,                                    # SS, B K-major
    1: lambda a, b1, b2: a @ b1,                                      # SS, B MN-major
    2: lambda a, b1, b2: (a @ b1.T).bfloat16().float() @ b2,          # then RS, B MN-major
    3: lambda a, b1, b2: (a @ b1.T).bfloat16().float() @ b2.T,        # then RS, B K-major
}


def _tile_test(a, b1, b2, mode):
    lib = cuda_build.load("attention_sm90")
    fn = lib.mlsl_sm90_tile_test
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    c = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    rc = fn(a.data_ptr(), b1.data_ptr(), b2.data_ptr(), c.data_ptr(), mode,
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"mlsl_sm90_tile_test: cudaError {rc}"
    torch.cuda.synchronize()
    return c


def _inputs(seed, integers):
    rng = np.random.default_rng(seed)
    if integers:
        mk = lambda: rng.integers(-1, 2, size=(64, 64)).astype(np.float32)  # noqa: E731
    else:
        mk = lambda: rng.normal(size=(64, 64)).astype(np.float32)  # noqa: E731
    return [torch.from_numpy(mk()).cuda().bfloat16() for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_tile_product_exact_on_integers(mode):
    a, b1, b2 = _inputs(10 + mode, integers=True)
    got = _tile_test(a, b1, b2, mode)
    want = MODES[mode](a.float(), b1.float(), b2.float())
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_tile_product_matches_matmul(mode):
    a, b1, b2 = _inputs(20 + mode, integers=False)
    got = _tile_test(a, b1, b2, mode)
    want = MODES[mode](a.float(), b1.float(), b2.float())
    rel = float((got - want).norm() / want.norm())
    assert rel < (1e-5 if mode < 2 else 1e-3), rel
