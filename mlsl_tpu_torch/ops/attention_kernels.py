"""Flash attention: kernels B7 (forward), B8 (backward, two passes) and B9 (the
ring hop's carried-state update) as CUDA kernels on the card, plain PyTorch on
the CPU.

Counterpart of ``mlsl_tpu.ops.attention_kernels``. The online softmax keeps
the (Sq, Sk) score matrix out of device memory: the forward folds k/v tiles
into a running (acc, m, l) state per query row; the backward recomputes the
probabilities from the saved per-row log-sum-exp, dq looping over key tiles
and dk/dv over query tiles, so each block owns its output rows.

Kernels (built by ``ops/cuda_build.py``):

- ``flash_fwd`` replaces ``_flash_fwd`` (attention_kernels.py:154), B7;
- ``flash_bwd_dq`` and ``flash_bwd_dkv`` replace the two passes of
  ``_flash_bwd`` (:297; :311 dq, :335 dk/dv), B8;
- ``block_update`` replaces ``_block_update_fwd`` (:442), B9;
- ``block_update_bwd`` computes B9's vjp, which the TPU leaves to XLA
  (``_bu_bwd`` :530 is ``jax.vjp`` of ``_block_update_ref``): B8's two passes
  with B9's inputs.

Each has two forms, picked by ``kernel_form`` from the dtype and the head dim
alone:

- ``"sm90"`` (``csrc/attention_sm90.cu``) for bf16 with head_dim 64 or 128:
  bf16 wgmma tiles fed by TMA. P and dS enter their products rounded to bf16,
  and B9's backward takes its cotangent ``ga`` rounded to bf16 once; the plain
  versions round at the same places with ``p_dtype``/``g_dtype``
  ``torch.bfloat16``. Launches count under ``flash_fwd_sm90``,
  ``flash_bwd_dq_sm90``, ``flash_bwd_dkv_sm90``, ``block_update_sm90``,
  ``block_update_bwd_dq_sm90`` and ``block_update_bwd_dkv_sm90``.
- ``"simt"`` (``csrc/attention_kernels.cu``) for float32, and for bf16 at the
  other head dims: float32 arithmetic on the CUDA cores, the exact form the
  reference computes. B9 in this form has no backward kernel: its backward is
  the closed form ``block_update_bwd_ref`` on the card (no main path takes
  this form).

B9's vjp in closed form. With P, m' = max(m, max_j s_j), l', acc' of the
forward, c = exp(m - m'), the cotangents (ga, gm, gl), Delta = gl l' + ga .
acc' (a row dot, like B8's D) and g = gm - Delta:
dS = P (ga V^T + gl) + g at the row's maximal score where it beat m, so that
dq, dk and dv are B8's with lse := m', dd := -gl and dO := ga, plus that one
term; dacc = c ga, dl = c gl, dm = c (gl l + ga . acc) + g where m won. The
kernels give the term through the max to the first maximal key (``win``, an
int32 per row that B9's forward returns on request: -1 where m won); the
plain version splits a tie as torch and JAX do (``maximum`` 0.5/0.5, ``amax``
evenly among equal maxima).

They are bound by operations (4*D per visible (q, k) pair in B7, 6*D in the
dq pass, 8*D in the dk/dv pass) at the transformer's shapes, B9's forward by
the bytes of its float32 state; see each source's note for what its design
does about it.

Differences from the TPU kernels, none of them in the results:

- offsets are int32 per (batch x head) row, not one scalar per program: one
  launch covers every virtual rank, and ring ranks sit at different global
  positions;
- m, l and the lse are (BH, Sq) float32; the TPU's (BH, Sq, 128) lane
  broadcast is dropped;
- B9 writes new tensors instead of aliasing acc/m/l in place: its backward
  needs the inputs;
- the kernels take head_dim up to 128 and raise above it; ``supports()``
  is the TPU's predicate unchanged.

Each wrapper checks shapes, types and ``supports()``. For a CUDA tensor it
launches its kernel on the current stream, raises ``MLSLError`` if the launch
fails, and adds one to its count in ``LAUNCHES``; for a CPU tensor it runs the
plain version (and counts nothing); any other device raises. Nothing falls
back from the kernel to the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple, Union

import torch

from mlsl_tpu_torch.log import MLSLError, mlsl_assert
from mlsl_tpu_torch.ops import cpu_exp

NEG = -1e30
MAX_HEAD_DIM = 128          # the CUDA kernels' limit (shared-memory tiles)
SM90_HEAD_DIMS = (64, 128)  # the wgmma form's head dims (one or two 128-byte tiles)
SM90_KEY_TILE = 64          # keys of each tile the wgmma form's B7 folds

# launches per kernel and form; only the CUDA launch site increments
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "block_update": 0,
            "flash_fwd_sm90": 0, "flash_bwd_dq_sm90": 0, "flash_bwd_dkv_sm90": 0,
            "block_update_sm90": 0, "block_update_bwd_dq_sm90": 0,
            "block_update_bwd_dkv_sm90": 0}

Offset = Union[int, torch.Tensor]


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# FLOPs a (q, k) pair costs in B7 (S and P V) and in B8's two passes (S, dP,
# dQ; S, dP, dV, dK), per head-dim element
_PAIR_FLOPS = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}
_FLOP_SINKS = []


@contextlib.contextmanager
def count_flops():
    """Sum the FLOPs of the B7 and B8 launches made inside, by LAUNCHES key:
    ``torch.utils.flop_counter`` cannot see a ctypes launch. A causal launch
    counts the pairs its rows see at equal query and key offsets, as the
    fused transformer step gives them (offsets are device tensors, not read
    back); others count every pair."""
    sink: Dict[str, int] = {}
    _FLOP_SINKS.append(sink)
    try:
        yield sink
    finally:
        _FLOP_SINKS.remove(sink)


def _launch_flops(name: str, bh: int, sq: int, sk: int, d: int, causal: bool) -> int:
    per = _PAIR_FLOPS.get(name.removesuffix("_sm90"), 0)
    if not causal:
        pairs = sq * sk
    else:   # row i sees keys 0..i
        n = min(sq, sk)
        pairs = n * (n + 1) // 2 + (sq - n) * sk
    return per * d * bh * pairs


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
    """An int, a (1,) tensor or a (BH,) tensor -> (BH,) int32 on ``device``
    (an int is filled in on the device: no copy from the host, no wait)."""
    if isinstance(off, int):
        return torch.full((bh,), off, dtype=torch.int32, device=device)
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


def kernel_form(dtype: torch.dtype, d: int) -> str:
    """The CUDA form of B7, B8 and B9 for inputs of this type and head dim:
    ``"sm90"`` (bf16 wgmma tiles) for bf16 with head_dim 64 or 128, ``"simt"``
    (float32 on the CUDA cores) for float32 and the other bf16 head dims.
    Raises for what neither form takes."""
    mlsl_assert(d <= MAX_HEAD_DIM, "the CUDA kernels take head_dim <= %d, got %d",
                MAX_HEAD_DIM, d)
    mlsl_assert(dtype in (torch.float32, torch.bfloat16),
                "the CUDA kernels take float32 or bfloat16, got %s", dtype)
    return "sm90" if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS else "simt"


def _cuda_ready(what: str, *tensors, form: Optional[str] = None) -> Tuple[int, str]:
    """-> (the kernels' dtype code, the form to launch: ``kernel_form``'s, or
    ``form`` where the caller names one, "simt" being open to every input the
    kernels take); raises for what the kernels do not take."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise MLSLError(f"{what}: unsupported device {dev}")
    mlsl_assert(all(t.device == dev for t in tensors), "%s: tensors on several devices", what)
    return (1 if tensors[0].dtype == torch.bfloat16 else 0), pick_form(what, tensors[0], form)


def pick_form(what: str, q: torch.Tensor, form: Optional[str] = None) -> str:
    """The form a wrapper launches for inputs like ``q``: ``kernel_form``'s,
    or ``form`` where the caller names one ("simt" takes every input the
    kernels take, "sm90" only what ``kernel_form`` gives it); raises else."""
    best = kernel_form(q.dtype, q.shape[-1])
    mlsl_assert(form in (None, "simt", best), "%s: form %r does not take %s with head_dim %d",
                what, form, q.dtype, q.shape[-1])
    return form or best


# -- plain versions -------------------------------------------------------


def _scores_ref(q, k, q_off, k_off, causal: bool) -> torch.Tensor:
    """(BH, Sq, Sk) float32 scaled scores, NEG where the causal mask hides."""
    cpu_exp.warm(q.device)     # ROADMAP C.3
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale_of(q.shape[-1])
    if causal:
        q_pos = q_off[:, None] + torch.arange(q.shape[1], device=q.device)
        k_pos = k_off[:, None] + torch.arange(k.shape[1], device=k.device)
        s = torch.where(k_pos[:, None, :] <= q_pos[:, :, None], s, NEG)
    return s


def _rounded(x: torch.Tensor, p_dtype: torch.dtype) -> torch.Tensor:
    """x as it enters a product: unchanged for float32, else rounded to
    ``p_dtype`` (nearest even) and held in float32."""
    return x if p_dtype == torch.float32 else x.to(p_dtype).float()


def block_update_ref(q, k, v, acc, m, l, q_off, k_off, causal: bool,
                     p_dtype: torch.dtype = torch.float32):
    """The online-softmax fold of one k/v block into (acc, m, l), dense: the
    plain version of B9 (and, from the empty state, of B7). ``p_dtype``: the
    type P is rounded to before P V (bf16 for the wgmma form); l sums P in
    float32 either way."""
    s = _scores_ref(q, k, q_off, k_off, causal)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(s <= NEG / 2, 0.0, p)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bqk,bkd->bqd", _rounded(p, p_dtype),
                                                   v.float())
    return acc_new, m_new, l_new


def empty_state(bh: int, sq: int, d: int, device):
    """The carried state before the first block: (acc 0, m NEG, l 0)."""
    return (torch.zeros((bh, sq, d), dtype=torch.float32, device=device),
            torch.full((bh, sq), NEG, dtype=torch.float32, device=device),
            torch.zeros((bh, sq), dtype=torch.float32, device=device))


def block_update_tiled_ref(q, k, v, acc, m, l, q_off, k_off, causal: bool,
                           p_dtype: torch.dtype = torch.float32):
    """``block_update_ref`` as the wgmma form folds it: with a rounded
    ``p_dtype`` the keys fold in tiles of SM90_KEY_TILE, so that P is rounded
    against the same running maximum as in the kernel (a one-shot rounded
    fold rounds against the block's final maximum); float32 folds at once."""
    tile = k.shape[1] if p_dtype == torch.float32 else SM90_KEY_TILE
    state = (acc, m, l)
    for k0 in range(0, k.shape[1], tile):
        state = block_update_ref(q, k[:, k0:k0 + tile], v[:, k0:k0 + tile], *state, q_off,
                                 k_off + k0, causal, p_dtype)
    return state


def block_update_winner_ref(q, k, m, q_off, k_off, causal: bool) -> torch.Tensor:
    """(BH, Sq) int32: the key index of the row's maximal score where it beats
    the carried m (the first of equal maxima), -1 where m wins."""
    s = _scores_ref(q, k, q_off, k_off, causal)
    return torch.where(s.amax(dim=-1) > m, s.argmax(dim=-1), -1).to(torch.int32)


def flash_fwd_ref(q, k, v, q_off, k_off, causal: bool, p_dtype: torch.dtype = torch.float32):
    """Plain B7: -> (out in q's type, lse (BH, Sq) float32), folded as
    ``block_update_tiled_ref`` folds."""
    acc, m, l = block_update_tiled_ref(q, k, v, *empty_state(*q.shape, q.device), q_off, k_off,
                                       causal, p_dtype)
    denom = torch.clamp_min(l, 1e-30)
    return (acc / denom[..., None]).to(q.dtype), m + torch.log(denom)


def _bwd_ref(q, k, v, do, lse, dd, q_off, k_off, causal: bool):
    """P recomputed from the lse, and dS = P * (dO V^T - dd)."""
    s = _scores_ref(q, k, q_off, k_off, causal)
    p = torch.where(s <= NEG / 2, 0.0, torch.exp(s - lse[..., None]))
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, p * (dp - dd[..., None])


def flash_bwd_dq_ref(q, k, v, do, lse, dd, q_off, k_off, causal: bool,
                     p_dtype: torch.dtype = torch.float32):
    """Plain B8, dq pass. ``p_dtype``: the type dS is rounded to before dS K."""
    _, ds = _bwd_ref(q, k, v, do, lse, dd, q_off, k_off, causal)
    dq = torch.einsum("bqk,bkd->bqd", _rounded(ds, p_dtype), k.float())
    return (scale_of(q.shape[-1]) * dq).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, dd, q_off, k_off, causal: bool,
                      p_dtype: torch.dtype = torch.float32):
    """Plain B8, dk/dv pass. ``p_dtype``: the type P and dS are rounded to
    before P^T dO and dS^T Q (dS from P in float32)."""
    p, ds = _bwd_ref(q, k, v, do, lse, dd, q_off, k_off, causal)
    dk = scale_of(q.shape[-1]) * torch.einsum("bqk,bqd->bkd", _rounded(ds, p_dtype), q.float())
    dv = torch.einsum("bqk,bqd->bkd", _rounded(p, p_dtype), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _bu_row_terms(acc, m, l, m_new, l_new, acc_new, ga, gm, gl):
    """B9's backward per row, with c = exp(m - m'): -> (g = gm - Delta with
    Delta = gl l' + ga . acc', dacc = c ga, the part of dm that does not go
    through the max, dl = c gl), all float32."""
    cpu_exp.warm(m.device)
    ga, gm, gl = ga.float(), gm.float(), gl.float()
    corr = torch.exp(m - m_new)
    g = gm - (gl * l_new + (ga * acc_new).sum(dim=-1))
    return g, corr[..., None] * ga, corr * (gl * l + (ga * acc).sum(dim=-1)), corr * gl


def block_update_bwd_ref(q, k, v, acc, m, l, m_new, l_new, acc_new, ga, gm, gl, q_off, k_off,
                         causal: bool, p_dtype: torch.dtype = torch.float32,
                         g_dtype: torch.dtype = torch.float32,
                         win: Optional[torch.Tensor] = None):
    """Plain B9 backward: the vjp of ``block_update_ref`` at cotangents (ga,
    gm, gl) in closed form, dense in float32 -> (dq, dk, dv in their inputs'
    types, dacc, dm, dl float32). The term through the max goes to m or to the
    row's maximal scores with torch's and JAX's tie rules: ``maximum`` splits
    a tie 0.5/0.5, ``amax`` evenly among equal maxima; given ``win`` (the
    forward's winners), to each row's winning key or to m where it is -1, the
    kernels' rule. ``p_dtype``: the type P and dS are rounded to before their
    products (as B8's); ``g_dtype``: the type ga is rounded to where it enters
    dP = ga V^T and dV = P^T ga."""
    s = _scores_ref(q, k, q_off, k_off, causal)
    hidden = s <= NEG / 2
    p = torch.where(hidden, 0.0, torch.exp(s - m_new[..., None]))
    g, dacc, dm, dl = _bu_row_terms(acc, m, l, m_new, l_new, acc_new, ga, gm, gl)
    if win is None:
        s_max = s.amax(dim=-1)
        w_m = torch.where(m > s_max, 1.0, torch.where(m == s_max, 0.5, 0.0))
        at_max = (s == s_max[..., None]) & ~hidden
        w_s = (1.0 - w_m) / at_max.sum(dim=-1).clamp_min(1)
    else:
        w_m = (win < 0).float()
        at_max = torch.arange(k.shape[1], device=q.device) == win[..., None]
        w_s = torch.ones_like(w_m)
    ga_r = _rounded(ga.float(), g_dtype)
    dp = torch.einsum("bqd,bkd->bqk", ga_r, v.float())
    ds = p * (dp + gl.float()[..., None]) + torch.where(at_max, (g * w_s)[..., None], 0.0)
    sc = scale_of(q.shape[-1])
    ds_r = _rounded(ds, p_dtype)
    dq = sc * torch.einsum("bqk,bkd->bqd", ds_r, k.float())
    dk = sc * torch.einsum("bqk,bqd->bkd", ds_r, q.float())
    dv = torch.einsum("bqk,bqd->bkd", _rounded(p, p_dtype), ga_r)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dacc, dm + g * w_m, dl


# -- the CUDA kernels -----------------------------------------------------

_libs = {}
# C entry -> its pointer arguments; every entry then takes bh, sq, sk, d, scale,
# causal, dtype and the stream
_ENTRIES = {
    "attention_kernels": {"mlsl_flash_fwd": 7, "mlsl_flash_bwd_dq": 9,
                          "mlsl_flash_bwd_dkv": 10, "mlsl_flash_block_update": 11},
    "attention_sm90": {"mlsl_flash_fwd_sm90": 7, "mlsl_flash_bwd_dq_sm90": 9,
                       "mlsl_flash_bwd_dkv_sm90": 10, "mlsl_block_update_sm90": 12,
                       "mlsl_block_update_bwd_dq_sm90": 11,
                       "mlsl_block_update_bwd_dkv_sm90": 12},
}


def _kernels(source: str = "attention_kernels") -> ctypes.CDLL:
    """The bound library of ``csrc/<source>.cu``, built at first use."""
    lib = _libs.get(source)
    if lib is None:
        from mlsl_tpu_torch.ops import cuda_build

        lib = cuda_build.load(source)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i, i, i, i, f, i, i, p]           # bh, sq, sk, d, scale, causal, dtype, stream
        for entry, n_ptrs in _ENTRIES[source].items():
            fn = getattr(lib, entry)
            fn.argtypes = [p] * n_ptrs + tail
            fn.restype = ctypes.c_int
        _libs[source] = lib
    return lib


def _entry(kernel: str, form: str):
    """-> (the LAUNCHES key, the C function) of ``kernel`` in ``form``."""
    if form == "sm90":
        return f"{kernel}_sm90", getattr(_kernels("attention_sm90"), f"mlsl_{kernel}_sm90")
    return kernel, getattr(_kernels(), f"mlsl_{kernel}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t at a 16-byte aligned address (TMA and bulk copies need it)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, fn, ptrs, bh, sq, sk, d, causal, code, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*ptrs, bh, sq, sk, d, scale_of(d), int(bool(causal)), code, stream)
    if rc != 0:
        raise MLSLError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    for sink in _FLOP_SINKS:
        sink[name] = sink.get(name, 0) + _launch_flops(name, bh, sq, sk, d, causal)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, q_off: Offset, k_off: Offset, causal: bool = False,
              want_lse: bool = True, form: Optional[str] = None):
    """B7. q (BH, Sq, D), k/v (BH, Sk, D) -> (out (BH, Sq, D) in q's type,
    lse (BH, Sq) float32 or None). ``form`` ("simt" or "sm90") overrides
    ``kernel_form`` on the card, to measure one form against the other."""
    bh, sq, sk, d = _check(q, k, v, "flash_fwd")
    qo, ko = offsets(q_off, bh, q.device), offsets(k_off, bh, q.device)
    if q.device.type == "cpu":
        out, lse = flash_fwd_ref(q, k, v, qo, ko, causal)
        return out, (lse if want_lse else None)
    code, form = _cuda_ready("flash_fwd", q, k, v, form=form)
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device) if want_lse else None
    _launch(*_entry("flash_fwd", form), [_ptr(t) for t in (q, k, v, qo, ko, out, lse)],
            bh, sq, sk, d, causal, code, q.device)
    return out, lse


def _bwd_inputs(q, k, v, do, lse, dd, what):
    bh, sq, sk, d = _check(q, k, v, what)
    mlsl_assert(do.shape == q.shape and do.dtype == q.dtype,
                "%s: dO must match q's shape and type", what)
    mlsl_assert(lse.shape == (bh, sq) and dd.shape == (bh, sq),
                "%s: lse and dd must be (%d, %d)", what, bh, sq)
    return bh, sq, sk, d


def _bwd_contiguous(q, k, v, do, lse, dd):
    return (*(_aligned(t.contiguous()) for t in (q, k, v, do)),
            _aligned(lse.float().contiguous()), _aligned(dd.float().contiguous()))


def flash_bwd_dq(q, k, v, do, lse, dd, q_off: Offset, k_off: Offset,
                 causal: bool = False, form: Optional[str] = None) -> torch.Tensor:
    """B8, dq pass: -> dq (BH, Sq, D) in q's type; ``form`` as in ``flash_fwd``."""
    bh, sq, sk, d = _bwd_inputs(q, k, v, do, lse, dd, "flash_bwd_dq")
    qo, ko = offsets(q_off, bh, q.device), offsets(k_off, bh, q.device)
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, dd, qo, ko, causal)
    code, form = _cuda_ready("flash_bwd_dq", q, k, v, do, lse, dd, form=form)
    q, k, v, do, lse, dd = _bwd_contiguous(q, k, v, do, lse, dd)
    dq = torch.empty_like(q)
    _launch(*_entry("flash_bwd_dq", form), [_ptr(t) for t in (q, k, v, do, lse, dd, qo, ko, dq)],
            bh, sq, sk, d, causal, code, q.device)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dd, q_off: Offset, k_off: Offset,
                  causal: bool = False, form: Optional[str] = None):
    """B8, dk/dv pass: -> (dk, dv) (BH, Sk, D) in k's and v's type; ``form`` as
    in ``flash_fwd``."""
    bh, sq, sk, d = _bwd_inputs(q, k, v, do, lse, dd, "flash_bwd_dkv")
    qo, ko = offsets(q_off, bh, q.device), offsets(k_off, bh, q.device)
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, dd, qo, ko, causal)
    code, form = _cuda_ready("flash_bwd_dkv", q, k, v, do, lse, dd, form=form)
    q, k, v, do, lse, dd = _bwd_contiguous(q, k, v, do, lse, dd)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(*_entry("flash_bwd_dkv", form),
            [_ptr(t) for t in (q, k, v, do, lse, dd, qo, ko, dk, dv)], bh, sq, sk, d,
            causal, code, q.device)
    return dk, dv


def _state_checks(acc, m, l, what: str, bh: int, sq: int, d: int) -> None:
    mlsl_assert(acc.shape == (bh, sq, d) and m.shape == (bh, sq) and l.shape == (bh, sq),
                "%s: state must be acc (%d, %d, %d), m and l (%d, %d)", what,
                bh, sq, d, bh, sq)
    mlsl_assert(acc.dtype == m.dtype == l.dtype == torch.float32,
                "%s: the carried state is float32", what)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return _aligned(t.float().contiguous())


def block_update(q, k, v, acc, m, l, q_off: Offset, k_off: Offset, causal: bool = False,
                 want_winner: bool = False, form: Optional[str] = None):
    """B9: fold one k/v block into the carried (acc (BH, Sq, D), m, l (BH, Sq)),
    all float32 -> new (acc, m, l), the state left unnormalised and the inputs
    as they were; with ``want_winner`` also win (BH, Sq) int32, the key index
    of the row's maximal score where it beat m (-1 where m won), which the
    wgmma backward needs. ``form`` as in ``flash_fwd``; the CUDA-core form
    gives no winner."""
    bh, sq, sk, d = _check(q, k, v, "block_update")
    _state_checks(acc, m, l, "block_update", bh, sq, d)
    qo, ko = offsets(q_off, bh, q.device), offsets(k_off, bh, q.device)
    if q.device.type == "cpu":
        outs = block_update_ref(q, k, v, acc, m, l, qo, ko, causal)
        if want_winner:
            outs = (*outs, block_update_winner_ref(q, k, m, qo, ko, causal))
        return outs
    code, form = _cuda_ready("block_update", q, k, v, acc, m, l, form=form)
    outs = (torch.empty_like(acc, memory_format=torch.contiguous_format),
            torch.empty_like(m, memory_format=torch.contiguous_format),
            torch.empty_like(l, memory_format=torch.contiguous_format))
    if form == "simt":
        mlsl_assert(not want_winner, "block_update: the CUDA-core form gives no winner")
        q, k, v, acc, m, l = (t.contiguous() for t in (q, k, v, acc, m, l))
        _launch("block_update", _kernels().mlsl_flash_block_update,
                [_ptr(t) for t in (q, k, v, acc, m, l, qo, ko, *outs)], bh, sq, sk, d, causal,
                code, q.device)
        return outs
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    acc, m, l = _f32(acc), _f32(m), _f32(l)
    win = torch.empty((bh, sq), dtype=torch.int32, device=q.device) if want_winner else None
    _launch(*_entry("block_update", form),
            [_ptr(t) for t in (q, k, v, qo, ko, acc, m, l, *outs, win)], bh, sq, sk, d, causal,
            code, q.device)
    return (*outs, win) if want_winner else outs


def block_update_bwd(q, k, v, acc, m, l, m_new, l_new, acc_new, win, ga, gm, gl,
                     q_off: Offset, k_off: Offset, causal: bool = False):
    """B9's backward at cotangents (ga, gm, gl) of (acc', m', l') -> (dq, dk,
    dv in their inputs' types, dacc, dm, dl float32). ``win``: the wgmma
    forward's winner (None from the CUDA-core form; unused on the CPU, where
    the plain version splits ties as torch does). In the wgmma form: B8's two
    passes with lse := m', dd := -gl, dO := ga rounded once to q's type, plus
    g = gm - Delta at each row's winner inside the passes; Delta, dacc, dm
    and dl are PyTorch ops around them, as B8's D is. The CUDA-core form
    (float32, other head dims; no main path) has no backward kernel, as the
    TPU has none: its backward is the closed form on the card too."""
    bh, sq, sk, d = _check(q, k, v, "block_update_bwd")
    _state_checks(acc, m, l, "block_update_bwd", bh, sq, d)
    qo, ko = offsets(q_off, bh, q.device), offsets(k_off, bh, q.device)
    on_cpu = q.device.type == "cpu"
    if on_cpu or _cuda_ready("block_update_bwd", q, k, v, acc, m, l, ga)[1] == "simt":
        return block_update_bwd_ref(q, k, v, acc, m, l, m_new, l_new, acc_new, ga, gm, gl,
                                    qo, ko, causal)
    mlsl_assert(win is not None and win.shape == (bh, sq) and win.dtype == torch.int32,
                "block_update_bwd: needs the forward's int32 winner (%d, %d)", bh, sq)
    with torch.profiler.record_function("block_update_bwd"):
        g, dacc, dm, dl = _bu_row_terms(acc, m, l, m_new, l_new, acc_new, ga, gm, gl)
        do = _aligned(ga.to(q.dtype).contiguous())
        q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
        lse, dd, g32, win = _f32(m_new), _f32(-gl), _f32(g), _aligned(win.contiguous())
        (dq,) = bu_bwd_pass("dq", q, k, v, do, lse, dd, win, g32, qo, ko, causal)
        dk, dv = bu_bwd_pass("dkv", q, k, v, do, lse, dd, win, g32, qo, ko, causal)
        dm = dm + torch.where(win < 0, g, 0.0)
    return dq, dk, dv, dacc, dm, dl


def bu_bwd_pass(which: str, q, k, v, do, m_new, neg_gl, win, g, q_off, k_off, causal: bool):
    """One pass of B9's wgmma backward ("dq" -> (dq,), "dkv" -> (dk, dv)) on
    inputs ``block_update_bwd`` has prepared: bf16 q, k, v and dO = ga, and
    16-byte aligned float32 m', -gl, g and int32 winners (BH, Sq)."""
    bh, sq, d = q.shape
    outs = ((torch.empty_like(q),) if which == "dq" else
            (torch.empty_like(k), torch.empty_like(v)))
    _launch(*_entry(f"block_update_bwd_{which}", "sm90"),
            [_ptr(t) for t in (q, k, v, do, m_new, neg_gl, win, g, q_off, k_off, *outs)],
            bh, sq, k.shape[1], d, causal, 1, q.device)
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
    """B9 forward into new tensors (with the winner when a gradient is wanted
    and the wgmma form runs); B9's backward, ``block_update_bwd``, where the
    TPU has ``jax.vjp`` of ``_block_update_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, acc, m, l, q_off, k_off, causal, want_grad):
        ctx.causal = causal
        if not want_grad:
            return block_update(q, k, v, acc, m, l, q_off, k_off, causal)
        win = None
        if q.device.type == "cuda" and kernel_form(q.dtype, q.shape[-1]) == "sm90":
            acc_n, m_n, l_n, win = block_update(q, k, v, acc, m, l, q_off, k_off, causal,
                                                want_winner=True)
        else:
            acc_n, m_n, l_n = block_update(q, k, v, acc, m, l, q_off, k_off, causal)
        ctx.save_for_backward(q, k, v, acc, m, l, m_n, l_n, acc_n, win, q_off, k_off)
        return acc_n, m_n, l_n

    @staticmethod
    def backward(ctx, ga, gm, gl):
        q, k, v, acc, m, l, m_n, l_n, acc_n, win, q_off, k_off = ctx.saved_tensors
        grads = block_update_bwd(q, k, v, acc, m, l, m_n, l_n, acc_n, win, ga, gm, gl,
                                 q_off, k_off, ctx.causal)
        return (*grads, None, None, None, None)


def flash_block_update(q, k, v, acc, m, l, q_offset: Offset = 0, k_offset: Offset = 0,
                       causal: bool = False):
    """Ring-attention inner step: fold one k/v block into (acc, m, l)."""
    bh = q.shape[0]
    want_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, acc, m, l))
    return _BlockUpdate.apply(q, k, v, acc, m, l, offsets(q_offset, bh, q.device),
                              offsets(k_offset, bh, q.device), causal, want_grad)
