"""Collective algorithm engine: several lowerings per collective.

Counterpart of the host path of ``mlsl_tpu.comm.algos`` (algos/__init__.py:
84-373 and 527-564). The registry lists what the port has:

- ``lax``           the single-shot reduction over the member dim
                    (comm/collectives.py), the baseline and the default;
- ``rhd``           recursive halving/doubling with the pre/post fold, in
                    plain PyTorch over the member dim (algos/rhd.py);
- ``ring2d``        the ring-of-rings for groups over two or more live axes
                    (algos/ring2d.py);
- ``pallas_ring``   the fused ring, CUDA kernel B3 (algos/pallas_ring.py),
                    and for QUANTIZATION requests its int8 variant B4
                    (quant_ring's ``ring="pallas"`` wire);
- ``pallas_ring2d`` B3 over the snake cycle of a two-live-axis group;
- ``pallas_rhd``    the halving/doubling allreduce as CUDA kernel B5
                    (algos/pallas_rhd.py).

The JAX registry's ``hier`` and ``pallas_a2a`` are not ported: naming them in
MLSL_ALGO or a profile raises MLSLError. The kernel algorithms are eligible
wherever the group qualifies: a CUDA buffer launches the kernel, a CPU buffer
runs its plain version.

Selection (``select``) is keyed by (kind, payload bytes, group shape,
compression), with the JAX package's precedence:

    explicit config (MLSL_ALGO)  >  tuned profile (tuner/)  >  heuristic

and the heuristic is the baseline, except that with ``pallas_rhd`` armed a
dense SUM allreduce inside the small-message band selects ``pallas_rhd``. The
JAX package's circuit-breaker gate (``_breaker_gate``) is the identity while
its breaker is closed, and the port has no supervisor to open it, so
``select`` returns its choice directly.
"""

from __future__ import annotations

from typing import Callable, Tuple

from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import log_debug, mlsl_assert
from mlsl_tpu_torch.types import CompressionType, ReductionType

#: the baseline algorithm: the single-shot reduction (comm/collectives.py)
DEFAULT = "lax"

#: the elementwise-reduction collectives the engine chooses for
ENGINE_KINDS = ("allreduce", "reduce_scatter")

#: registry names of the JAX package that the port does not have yet, and
#: the engine kind it does not have yet
NOT_PORTED = ("hier", "pallas_a2a")
NOT_PORTED_KINDS = ("alltoall",)


def group_shape(group: ProcessGroup) -> Tuple[int, ...]:
    """The selection-table shape key: per-axis member counts, major ->
    minor, size-1 axes dropped; ``(1,)`` for a group with none."""
    topo = group.topology
    shape = tuple(topo.axis_size(a) for a in group.live_axes())
    return shape or (1,)


def _eligible_rhd(kind: str, group: ProcessGroup, op) -> bool:
    # uniform groups only; any op (the pairwise combine handles MIN/MAX)
    if group.is_self or not group.is_uniform or group.size <= 1:
        return False
    if kind == "reduce_scatter" and op not in (None, ReductionType.SUM,
                                               ReductionType.MIN, ReductionType.MAX):
        return False
    return True


def _eligible_ring2d(kind: str, group: ProcessGroup, op) -> bool:
    # SUM only, over >= 2 live axes; the 2-phase scatter placement is 2-D
    if group.colors is not None or op not in (None, ReductionType.SUM):
        return False
    live = len(group.live_axes())
    if live < 2:
        return False
    return not (kind == "reduce_scatter" and live != 2)


def _eligible_pallas_ring(kind: str, group: ProcessGroup, op) -> bool:
    from mlsl_tpu_torch.ops import ring_kernels

    return ring_kernels.eligible_dense(kind, group, op)


def _eligible_pallas_rhd(kind: str, group: ProcessGroup, op) -> bool:
    from mlsl_tpu_torch.ops import rhd_kernels

    return rhd_kernels.eligible(kind, group, op)


def _eligible_pallas_ring2d(kind: str, group: ProcessGroup, op) -> bool:
    from mlsl_tpu_torch.ops import ring_kernels

    return ring_kernels.eligible_dense2d(kind, group, op)


#: name -> eligibility predicate, in the JAX registry's order
_ELIGIBLE = {
    "lax": lambda kind, group, op: True,
    "rhd": _eligible_rhd,
    "ring2d": _eligible_ring2d,
    "pallas_ring": _eligible_pallas_ring,
    "pallas_rhd": _eligible_pallas_rhd,
    "pallas_ring2d": _eligible_pallas_ring2d,
}

ALGORITHMS = tuple(_ELIGIBLE)


def eligible(algo: str, kind: str, group: ProcessGroup, op=None) -> bool:
    """Can ``algo`` lower (kind, group, op)? Unknown names never are."""
    if kind not in ENGINE_KINDS:
        return algo == DEFAULT
    pred = _ELIGIBLE.get(algo)
    return bool(pred and pred(kind, group, op))


def candidates(kind: str, group: ProcessGroup, op=None) -> Tuple[str, ...]:
    """Every algorithm eligible for (kind, group, op), baseline first."""
    return tuple(a for a in ALGORITHMS if eligible(a, kind, group, op))


def check_name(name: str, what: str) -> None:
    """Raise MLSLError for an algorithm name the port cannot run."""
    mlsl_assert(name not in NOT_PORTED,
                "%s %r is not ported yet (ported: %s)", what, name, ", ".join(ALGORITHMS))
    mlsl_assert(name in ALGORITHMS,
                "%s %r is not a registered collective algorithm (registry: %s)",
                what, name, ", ".join(ALGORITHMS))


def parse_forced(spec: str) -> dict:
    """Parse MLSL_ALGO: one algorithm name (forced for every engine kind) or
    a comma list of kind=name entries. Raises MLSLError on unknown or
    unported names and kinds, at init rather than deep in dispatch."""
    spec = (spec or "").strip()
    out: dict = {}
    if not spec:
        return out
    if "=" not in spec:
        check_name(spec, "MLSL_ALGO")
        out["*"] = spec
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        mlsl_assert("=" in part, "MLSL_ALGO entry %r is not kind=algo", part)
        kind, _, name = part.partition("=")
        kind, name = kind.strip(), name.strip()
        mlsl_assert(kind not in NOT_PORTED_KINDS,
                    "MLSL_ALGO kind %r is not ported yet", kind)
        mlsl_assert(kind in ENGINE_KINDS,
                    "MLSL_ALGO kind %r is not an engine collective (expected one of %s)",
                    kind, ", ".join(ENGINE_KINDS))
        check_name(name, f"MLSL_ALGO for kind {kind!r}:")
        out[kind] = name
    return out


def select(kind: str, group: ProcessGroup, payload_bytes: int,
           compression: CompressionType, config, op=None) -> str:
    """The selection table: explicit config > tuned profile > heuristic. A
    forced or tuned choice that is not eligible for (kind, group, op) falls
    back to the baseline with a debug message."""
    if kind not in ENGINE_KINDS or config is None:
        return DEFAULT
    if compression != CompressionType.NONE:
        # compressed collectives keep their own wire (the composed int8
        # ring), except that a forced or tuned 'pallas_ring' routes a
        # QUANTIZATION request through the fused int8 ring when the group
        # qualifies
        if compression == CompressionType.QUANTIZATION:
            name = _requested(kind, group, payload_bytes, compression, config)
            if name == "pallas_ring" and _quant_pallas_eligible(group, config):
                return name
            if name == "pallas_ring":
                log_debug("%s not eligible for quantized %s on group %s; keeping the "
                          "composed quant ring", name, kind, group_shape(group))
        return DEFAULT
    name = _requested(kind, group, payload_bytes, compression, config)
    if name and name != DEFAULT:
        if eligible(name, kind, group, op):
            return name
        log_debug("selected algorithm %s not eligible for %s on group %s; falling back "
                  "to %s", name, kind, group_shape(group), DEFAULT)
        return DEFAULT
    if name == DEFAULT:
        # an explicit or tuned 'lax' pins the baseline over the heuristic rung
        return DEFAULT
    # heuristic rung: the latency-class kernel for dense SUM allreduces inside
    # the small-message band, only when the operator armed it
    if (kind == "allreduce" and getattr(config, "pallas_rhd", False)
            and eligible("pallas_rhd", kind, group, op)):
        from mlsl_tpu_torch.ops import rhd_kernels

        if payload_bytes <= rhd_kernels.env_max_bytes(config):
            return "pallas_rhd"
    return DEFAULT


def _requested(kind, group, payload_bytes, compression, config):
    """The raw forced or tuned choice for this cell, eligibility unchecked."""
    forced = getattr(config, "_forced_algos", None)
    if forced:
        name = forced.get(kind) or forced.get("*")
        if name:
            return name
    profile = getattr(config, "tuned_profile", None)
    if profile is not None:
        return profile.select(kind, group_shape(group), compression, payload_bytes)
    return None


def _quant_pallas_eligible(group: ProcessGroup, config) -> bool:
    from mlsl_tpu_torch.ops import ring_kernels

    return ring_kernels.eligible_quant(group, int(getattr(config, "quant_block_elems", 256)))


def build(kind: str, group: ProcessGroup, algo: str, **kw) -> Callable:
    """-> fn: distributed buffer (R, D, S, M, n) -> result buffer, the
    calling convention of collectives.build_collective. ``algo='lax'`` is
    build_collective. The kernel algorithms take ``plain=True`` to run their
    plain versions on any device (the card's parity checks); the rings take
    ``bidir`` (``Config.pallas_ring_bidir``, off unless passed). Each lowering ignores the keywords it has no use for."""
    from mlsl_tpu_torch.comm import collectives

    if algo == DEFAULT:
        return collectives.build_collective(
            kind, group, **{k: v for k, v in kw.items() if k in ("op", "root", "recv_count")})
    mlsl_assert(eligible(algo, kind, group, kw.get("op")),
                "algorithm %s cannot lower %s on group shape %s", algo, kind,
                group_shape(group))
    if algo == "rhd":
        from mlsl_tpu_torch.comm.algos import rhd as impl
    elif algo == "ring2d":
        from mlsl_tpu_torch.comm.algos import ring2d as impl
    elif algo == "pallas_ring":
        from mlsl_tpu_torch.comm.algos import pallas_ring as impl
    elif algo == "pallas_ring2d":
        from mlsl_tpu_torch.comm.algos import pallas_ring2d as impl
    else:
        from mlsl_tpu_torch.comm.algos import pallas_rhd as impl
    return impl.build(kind, group, **kw)
