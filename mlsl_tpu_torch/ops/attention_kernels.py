"""Flash attention: kernels B7 (forward), B8 (backward, two passes) and B9 (the
ring hop's carried-state update) as CUDA kernels on the card, plain PyTorch on
the CPU.

Counterpart of ``mlsl_tpu.ops.attention_kernels``. The online softmax keeps
the (Sq, Sk) score matrix out of device memory: the forward folds k/v tiles
into a running (acc, m, l) state per query row; the backward recomputes the
probabilities from the saved per-row log-sum-exp, dq looping over key tiles
and dk/dv over query tiles, so each block owns its output rows.

Kernels (``csrc/attention_kernels.cu``, built by ``ops/cuda_build.py``):

- ``flash_fwd`` replaces ``_flash_fwd`` (attention_kernels.py:154), B7;
- ``flash_bwd_dq`` and ``flash_bwd_dkv`` replace the two passes of
  ``_flash_bwd`` (:297; :311 dq, :335 dk/dv), B8;
- ``block_update`` replaces ``_block_update_fwd`` (:442), B9.

They are bound by operations (4*D per visible (q, k) pair in B7 and B9, 6*D
in the dq pass, 8*D in the dk/dv pass) at the transformer's shapes; see the
source's note for what the first CUDA form does about it.

Differences from the TPU kernels, none of them in the results:

- offsets are int32 per (batch x head) row, not one scalar per program: one
  launch covers every virtual rank, and ring ranks sit at different global
  positions;
- m, l and the lse are (BH, Sq) float32; the TPU's (BH, Sq, 128) lane
  broadcast is dropped;
- B9 writes new tensors instead of aliasing acc/m/l in place: its autograd
  backward needs the inputs;
- the kernels take head_dim up to 128 and raise above it; ``supports()``
  is the TPU's predicate unchanged.

Each wrapper checks shapes, types and ``supports()``. For a CUDA tensor it
launches its kernel on the current stream, raises ``MLSLError`` if the launch
fails, and adds one to its count in ``LAUNCHES``; for a CPU tensor it runs the
plain version (and counts nothing); any other device raises. Nothing falls
back from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from mlsl_tpu_torch.log import MLSLError, mlsl_assert

NEG = -1e30
MAX_HEAD_DIM = 128          # the CUDA kernels' limit (shared-memory tiles)

# launches per kernel wrapper; only the CUDA launch site increments
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "block_update": 0}

Offset = Union[int, torch.Tensor]


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _pick_tiles(sq: int, sk: int):
    """The TPU kernels' tiles: the largest that divide the shapes."""
    tq = next((t for t in (512, 256, 128) if sq % t == 0), None)
    tk = next((t for t in (2048, 1024, 512, 256, 128) if sk % t == 0), None)
    return tq, tk


def supports(sq: int, sk: int, d: int) -> bool:
    """Whether the kernels' tiling admits these shapes (the TPU predicate:
    sequence lengths multiples of 128, head_dim a multiple of 8)."""
    tq, tk = _pick_tiles(sq, sk)
    return tq is not None and tk is not None and d % 8 == 0 and d >= 8


def scale_of(d: int) -> float:
    return 1.0 / (d ** 0.5)


def offsets(off: Offset, bh: int, device) -> torch.Tensor:
    """An int, a (1,) tensor or a (BH,) tensor -> (BH,) int32 on ``device``."""
    t = torch.as_tensor(off, dtype=torch.int32).to(device).reshape(-1)
    mlsl_assert(t.numel() in (1, bh), "offsets must hold 1 or %d values, got %d",
                bh, t.numel())
    return t.expand(bh).contiguous()


def _check(q, k, v, what: str) -> Tuple[int, int, int, int]:
    mlsl_assert(q.dim() == 3 and k.dim() == 3 and v.dim() == 3,
                "%s: q, k, v must be (BH, S, D), got %s %s %s", what,
                tuple(q.shape), tuple(k.shape), tuple(v.shape))
    bh, sq, d = q.shape
    sk = k.shape[1]
    mlsl_assert(k.shape == (bh, sk, d) and v.shape == (bh, sk, d),
                "%s: k and v must be (%d, Sk, %d), got %s %s", what, bh, d,
                tuple(k.shape), tuple(v.shape))
    mlsl_assert(k.dtype == q.dtype and v.dtype == q.dtype,
                "%s: q, k, v differ in type", what)
    mlsl_assert(supports(sq, sk, d),
                "%s: shapes (Sq=%d, Sk=%d, D=%d) are outside supports()", what, sq, sk, d)
    return bh, sq, sk, d


def _cuda_ready(what: str, *tensors) -> int:
    """-> the kernels' dtype code; raises for what the kernels do not take."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise MLSLError(f"{what}: unsupported device {dev}")
    mlsl_assert(all(t.device == dev for t in tensors), "%s: tensors on several devices", what)
    d = tensors[0].shape[-1]
    mlsl_assert(d <= MAX_HEAD_DIM, "%s: the CUDA kernel takes head_dim <= %d, got %d",
                what, MAX_HEAD_DIM, d)
    code = {torch.float32: 0, torch.bfloat16: 1}.get(tensors[0].dtype)
    mlsl_assert(code is not None, "%s: the CUDA kernel takes float32 or bfloat16, got %s",
                what, tensors[0].dtype)
    return code


# -- plain versions -------------------------------------------------------


def _scores_ref(q, k, q_off, k_off, causal: bool) -> torch.Tensor:
    """(BH, Sq, Sk) float32 scaled scores, NEG where the causal mask hides."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale_of(q.shape[-1])
    if causal:
        q_pos = q_off[:, None] + torch.arange(q.shape[1], device=q.device)
        k_pos = k_off[:, None] + torch.arange(k.shape[1], device=k.device)
        s = torch.where(k_pos[:, None, :] <= q_pos[:, :, None], s, NEG)
    return s


def block_update_ref(q, k, v, acc, m, l, q_off, k_off, causal: bool):
    """The online-softmax fold of one k/v block into (acc, m, l), dense: the
    plain version of B9 (and, from the empty state, of B7)."""
    s = _scores_ref(q, k, q_off, k_off, causal)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(s <= NEG / 2, 0.0, p)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bqk,bkd->bqd", p, v.float())
    return acc_new, m_new, l_new


def empty_state(bh: int, sq: int, d: int, device):
    """The carried state before the first block: (acc 0, m NEG, l 0)."""
    return (torch.zeros((bh, sq, d), dtype=torch.float32, device=device),
            torch.full((bh, sq), NEG, dtype=torch.float32, device=device),
            torch.zeros((bh, sq), dtype=torch.float32, device=device))


def flash_fwd_ref(q, k, v, q_off, k_off, causal: bool):
    """Plain B7: -> (out in q's type, lse (BH, Sq) float32)."""
    acc, m, l = block_update_ref(q, k, v, *empty_state(*q.shape, q.device),
                                 q_off, k_off, causal)
    denom = torch.clamp_min(l, 1e-30)
    return (acc / denom[..., None]).to(q.dtype), m + torch.log(denom)


def _bwd_ref(q, k, v, do, lse, dd, q_off, k_off, causal: bool):
    """P recomputed from the lse, and dS = P * (dO V^T - dd)."""
    s = _scores_ref(q, k, q_off, k_off, causal)
    p = torch.where(s <= NEG / 2, 0.0, torch.exp(s - lse[..., None]))
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, p * (dp - dd[..., None])


def flash_bwd_dq_ref(q, k, v, do, lse, dd, q_off, k_off, causal: bool):
    """Plain B8, dq pass."""
    _, ds = _bwd_ref(q, k, v, do, lse, dd, q_off, k_off, causal)
    return (scale_of(q.shape[-1]) * torch.einsum("bqk,bkd->bqd", ds, k.float())).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, dd, q_off, k_off, causal: bool):
    """Plain B8, dk/dv pass."""
    p, ds = _bwd_ref(q, k, v, do, lse, dd, q_off, k_off, causal)
    dk = scale_of(q.shape[-1]) * torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA kernels -----------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from mlsl_tpu_torch.ops import cuda_build

        lib = cuda_build.load("attention_kernels")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i, i, i, i, f, i, i, p]           # bh, sq, sk, d, scale, causal, dtype, stream
        lib.mlsl_flash_fwd.argtypes = [p] * 7 + tail
        lib.mlsl_flash_bwd_dq.argtypes = [p] * 9 + tail
        lib.mlsl_flash_bwd_dkv.argtypes = [p] * 10 + tail
        lib.mlsl_flash_block_update.argtypes = [p] * 11 + tail
        for fn in (lib.mlsl_flash_fwd, lib.mlsl_flash_bwd_dq, lib.mlsl_flash_bwd_dkv,
                   lib.mlsl_flash_block_update):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(name: str, fn, ptrs, bh, sq, sk, d, causal, code, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*ptrs, bh, sq, sk, d, scale_of(d), int(bool(causal)), code, stream)
    if rc != 0:
        raise MLSLError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, q_off: Offset, k_off: Offset, causal: bool = False,
              want_lse: bool = True):
    """B7. q (BH, Sq, D), k/v (BH, Sk, D) -> (out (BH, Sq, D) in q's type,
    lse (BH, Sq) float32 or None)."""
    bh, sq, sk, d = _check(q, k, v, "flash_fwd")
    qo, ko = offsets(q_off, bh, q.device), offsets(k_off, bh, q.device)
    if q.device.type == "cpu":
        out, lse = flash_fwd_ref(q, k, v, qo, ko, causal)
        return out, (lse if want_lse else None)
    code = _cuda_ready("flash_fwd", q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device) if want_lse else None
    _launch("flash_fwd", _kernels().mlsl_flash_fwd,
            [_ptr(t) for t in (q, k, v, qo, ko, out, lse)], bh, sq, sk, d, causal, code,
            q.device)
    return out, lse


def _bwd_inputs(q, k, v, do, lse, dd, what):
    bh, sq, sk, d = _check(q, k, v, what)
    mlsl_assert(do.shape == q.shape and do.dtype == q.dtype,
                "%s: dO must match q's shape and type", what)
    mlsl_assert(lse.shape == (bh, sq) and dd.shape == (bh, sq),
                "%s: lse and dd must be (%d, %d)", what, bh, sq)
    return bh, sq, sk, d


def flash_bwd_dq(q, k, v, do, lse, dd, q_off: Offset, k_off: Offset,
                 causal: bool = False) -> torch.Tensor:
    """B8, dq pass: -> dq (BH, Sq, D) in q's type."""
    bh, sq, sk, d = _bwd_inputs(q, k, v, do, lse, dd, "flash_bwd_dq")
    qo, ko = offsets(q_off, bh, q.device), offsets(k_off, bh, q.device)
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, dd, qo, ko, causal)
    code = _cuda_ready("flash_bwd_dq", q, k, v, do, lse, dd)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse, dd = lse.float().contiguous(), dd.float().contiguous()
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", _kernels().mlsl_flash_bwd_dq,
            [_ptr(t) for t in (q, k, v, do, lse, dd, qo, ko, dq)], bh, sq, sk, d, causal,
            code, q.device)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dd, q_off: Offset, k_off: Offset,
                  causal: bool = False):
    """B8, dk/dv pass: -> (dk, dv) (BH, Sk, D) in k's and v's type."""
    bh, sq, sk, d = _bwd_inputs(q, k, v, do, lse, dd, "flash_bwd_dkv")
    qo, ko = offsets(q_off, bh, q.device), offsets(k_off, bh, q.device)
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, dd, qo, ko, causal)
    code = _cuda_ready("flash_bwd_dkv", q, k, v, do, lse, dd)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse, dd = lse.float().contiguous(), dd.float().contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", _kernels().mlsl_flash_bwd_dkv,
            [_ptr(t) for t in (q, k, v, do, lse, dd, qo, ko, dk, dv)], bh, sq, sk, d,
            causal, code, q.device)
    return dk, dv


def block_update(q, k, v, acc, m, l, q_off: Offset, k_off: Offset, causal: bool = False):
    """B9: fold one k/v block into the carried (acc (BH, Sq, D), m, l (BH, Sq)),
    all float32 -> new (acc, m, l); the inputs are left as they were."""
    bh, sq, sk, d = _check(q, k, v, "block_update")
    mlsl_assert(acc.shape == (bh, sq, d) and m.shape == (bh, sq) and l.shape == (bh, sq),
                "block_update: state must be acc (%d, %d, %d), m and l (%d, %d)",
                bh, sq, d, bh, sq)
    mlsl_assert(acc.dtype == m.dtype == l.dtype == torch.float32,
                "block_update: the carried state is float32")
    qo, ko = offsets(q_off, bh, q.device), offsets(k_off, bh, q.device)
    if q.device.type == "cpu":
        return block_update_ref(q, k, v, acc, m, l, qo, ko, causal)
    code = _cuda_ready("block_update", q, k, v, acc, m, l)
    q, k, v, acc, m, l = (t.contiguous() for t in (q, k, v, acc, m, l))
    outs = (torch.empty_like(acc), torch.empty_like(m), torch.empty_like(l))
    _launch("block_update", _kernels().mlsl_flash_block_update,
            [_ptr(t) for t in (q, k, v, acc, m, l, qo, ko, *outs)], bh, sq, sk, d, causal,
            code, q.device)
    return outs


# -- autograd -------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """B7 forward (with the lse only when a gradient is wanted), B8 backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, k_off, causal):
        want = any(ctx.needs_input_grad[:3])
        out, lse = flash_fwd(q, k, v, q_off, k_off, causal, want_lse=want)
        if want:
            ctx.save_for_backward(q, k, v, out, lse, q_off, k_off)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, q_off, k_off = ctx.saved_tensors
        # D_i = rowsum(dO * O), outside the kernels as on the TPU (:305-309)
        dd = (g.float() * out.float()).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, g, lse, dd, q_off, k_off, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, dd, q_off, k_off, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, q_offset: Offset = 0, k_offset: Offset = 0,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention. q (BH, Sq, D); k, v (BH, Sk, D); offsets: the global
    position bases of the rows (one value, or one per BH row) for causal
    masking across sequence shards."""
    bh = q.shape[0]
    return _FlashAttention.apply(q, k, v, offsets(q_offset, bh, q.device),
                                 offsets(k_offset, bh, q.device), causal)


class _BlockUpdate(torch.autograd.Function):
    """B9 forward into new tensors; the backward is autograd through the plain
    version, as ``_bu_bwd`` is ``jax.vjp`` of ``_block_update_ref``: the TPU
    has no backward kernel for B9."""

    @staticmethod
    def forward(ctx, q, k, v, acc, m, l, q_off, k_off, causal):
        ctx.save_for_backward(q, k, v, acc, m, l, q_off, k_off)
        ctx.causal = causal
        return block_update(q, k, v, acc, m, l, q_off, k_off, causal)

    @staticmethod
    def backward(ctx, ga, gm, gl):
        *ins, q_off, k_off = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ins]
            outs = block_update_ref(*ins, q_off, k_off, ctx.causal)
        grads = torch.autograd.grad(outs, ins, (ga, gm, gl), allow_unused=True)
        return (*grads, None, None, None)


def flash_block_update(q, k, v, acc, m, l, q_offset: Offset = 0, k_offset: Offset = 0,
                       causal: bool = False):
    """Ring-attention inner step: fold one k/v block into (acc, m, l)."""
    bh = q.shape[0]
    return _BlockUpdate.apply(q, k, v, acc, m, l, offsets(q_offset, bh, q.device),
                              offsets(k_offset, bh, q.device), causal)
