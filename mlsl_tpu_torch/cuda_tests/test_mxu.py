"""The tensor-core product of ``ops.mxu.mxu_einsum`` (bf16 operands, float32
accumulation and result) and its backward against the plain version on the
card (``plain=True``: the upcast operands multiplied in full float32, the
same vjp), for the four specs the transformer and the experts use.

Bounds, relative L2 (derived before the switch): the forward 1e-5, since a
bf16 x bf16 product is exact in float32 and only the order of the float32
sum differs (about 1e-7 expected); each gradient 1e-3: both routes round the
cotangent to bf16 once and cast each gradient to bf16, so they differ only
where the differently ordered float32 sums round to neighbouring bf16
values, one ulp (about 5.5e-3 relative, RMS) on a fraction p of the
elements, sqrt(p) * 5.5e-3 in all: 1e-3 admits p up to 3 %.
"""

import numpy as np
import pytest
import torch

from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.ops import mxu

FWD_TOL = 1e-5
GRAD_TOL = 1e-3

# (spec, a shape, w shape): the attention output projection and the MLP's
# second product over a (1, 2, 1, 2) grid, the expert products with the
# experts' broadcast ep dim
CASES = [
    ("...bhsx,...hxd->...bsd", (1, 2, 1, 2, 2, 8, 128, 64), (1, 2, 1, 2, 8, 64, 1024)),
    ("...bsf,...fd->...bsd", (1, 2, 1, 2, 2, 128, 2048), (1, 2, 1, 2, 2048, 1024)),
    ("...ecd,...edf->...ecf", (1, 2, 1, 2, 2, 4, 96, 1024), (1, 2, 1, 2, 1, 4, 1024, 512)),
    ("...ecf,...efd->...ecd", (1, 2, 1, 2, 2, 4, 96, 512), (1, 2, 1, 2, 1, 4, 512, 1024)),
]


def rel_l2(got, want):
    return float(torch.linalg.vector_norm((got.double() - want.double())) /
                 torch.linalg.vector_norm(want.double()))


def _inputs(spec, sa, sw, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=sa).astype(np.float32)).to("cuda", torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=sw) * 0.02).astype(np.float32)).to("cuda",
                                                                               torch.bfloat16)
    return a, w


@pytest.mark.cuda
@pytest.mark.parametrize("spec,sa,sw", CASES, ids=[c[0] for c in CASES])
def test_cuda_mxu_product_and_backward_match_plain(spec, sa, sw):
    a, w = _inputs(spec, sa, sw, seed=len(spec))
    outs = {}
    for plain in (False, True):
        x, y = a.clone().requires_grad_(), w.clone().requires_grad_()
        before = dict(mxu.CALLS)
        out = mxu.mxu_einsum(spec, x, y, plain=plain)
        g = torch.from_numpy(np.random.default_rng(7).normal(size=tuple(out.shape))
                             .astype(np.float32)).cuda()
        out.backward(g)
        torch.cuda.synchronize()
        fwd, bwd = (mxu.CALLS[k] - before[k] for k in ("mxu_bf16_fwd", "mxu_bf16_bwd"))
        assert (fwd, bwd) == ((0, 0) if plain else (1, 2))
        assert out.dtype == torch.float32 and x.grad.dtype == y.grad.dtype == torch.bfloat16
        outs[plain] = (out.detach(), x.grad, y.grad)
    (o, ga, gw), (po, pga, pgw) = outs[False], outs[True]
    assert torch.isfinite(o).all()
    assert rel_l2(o, po) <= FWD_TOL
    assert rel_l2(ga, pga) <= GRAD_TOL
    assert rel_l2(gw, pgw) <= GRAD_TOL


@pytest.mark.cuda
def test_cuda_mxu_mixed_operands_raise():
    """A bf16 operand beside a float32 one is never silently upcast on the
    card; ``plain`` keeps the float32 einsum of the upcast operands."""
    spec, sa, sw = CASES[1]
    a, w = _inputs(spec, sa, sw, seed=1)
    for x, y in ((a, w.float()), (a.float(), w)):
        with pytest.raises(MLSLError):
            mxu.mxu_einsum(spec, x, y)
        assert torch.equal(mxu.mxu_einsum(spec, x, y, plain=True),
                           torch.einsum(spec, x.float(), y.float()))
