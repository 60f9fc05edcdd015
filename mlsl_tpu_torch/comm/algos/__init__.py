"""Collective algorithm engine: several lowerings per collective.

Counterpart of ``mlsl_tpu.comm.algos`` (algos/__init__.py:84-373, 527-564
and the in-graph helpers of 615-665). The registry lists what the port has:

- ``lax``           the single-shot reduction or exchange over the member dim
                    (comm/collectives.py), the baseline and the default;
- ``rhd``           recursive halving/doubling with the pre/post fold, in
                    plain PyTorch over the member dim (algos/rhd.py);
- ``ring2d``        the ring-of-rings for groups over two or more live axes
                    (algos/ring2d.py);
- ``pallas_ring``   the fused ring, CUDA kernel B3 (algos/pallas_ring.py),
                    and for QUANTIZATION requests its int8 variant B4
                    (quant_ring's ``ring="pallas"`` wire);
- ``pallas_rhd``    the halving/doubling allreduce as CUDA kernel B5
                    (algos/pallas_rhd.py);
- ``pallas_ring2d`` B3 over the snake cycle of a two-live-axis group;
- ``pallas_a2a``    the fused all-to-all, CUDA kernel B6, with or without the
                    int8 codec (algos/pallas_a2a.py): the ``alltoall`` kind's
                    one alternative to ``lax``, serving the MoE dispatch and
                    combine exchanges and ``Distribution.all_to_all``;
- ``hier``          the two-tier lowering for an ``MLSL_MESH_TIERS`` world
                    (algos/hier.py): intra-tier reduce-scatter, inter-tier
                    allreduce of the 1/L shard, intra-tier all-gather, with
                    the DCN codec on the inter-tier hop of a QUANTIZATION
                    request (quant_ring's ``ring="hier"`` wire).

The kernel algorithms are eligible wherever the
group qualifies: a CUDA buffer launches the kernel, a CPU buffer runs its
plain version. The same holds in-graph: JAX emits ``pallas_a2a`` inside a
training graph only on a TPU (``a2a_kernels.inline_ok``), the port wherever
it is selected.

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

import math
from typing import Callable, Tuple

import torch

from mlsl_tpu_torch.comm.mesh import NUM_GRID_AXES, ProcessGroup
from mlsl_tpu_torch.log import log_debug, mlsl_assert
from mlsl_tpu_torch.types import CompressionType, ReductionType

#: the baseline algorithm: the single-shot reduction (comm/collectives.py)
DEFAULT = "lax"

#: the elementwise-reduction collectives the engine chooses for, and the MoE
#: dispatch/combine exchange
ENGINE_KINDS = ("allreduce", "reduce_scatter", "alltoall")


def group_shape(group: ProcessGroup) -> Tuple[int, ...]:
    """The selection-table shape key: per-axis member counts, major ->
    minor, size-1 axes dropped; ``(1,)`` for a group with none; ``(-G,)``
    for a color group (the sign keeps it apart from an axis group of the
    same size, as in the JAX package)."""
    if group.colors is not None:
        return (-int(group.size),)
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


def _eligible_pallas_a2a(kind: str, group: ProcessGroup, op) -> bool:
    from mlsl_tpu_torch.ops import a2a_kernels

    return a2a_kernels.eligible(kind, group, op=op)


def _eligible_hier(kind: str, group: ProcessGroup, op) -> bool:
    # a single live axis with a uniform tier split, SUM only
    from mlsl_tpu_torch.comm.algos import hier

    return hier.eligible(kind, group, op)


#: name -> eligibility predicate, in the JAX registry's order
_ELIGIBLE = {
    "lax": lambda kind, group, op: True,
    "rhd": _eligible_rhd,
    "ring2d": _eligible_ring2d,
    "pallas_ring": _eligible_pallas_ring,
    "pallas_rhd": _eligible_pallas_rhd,
    "pallas_ring2d": _eligible_pallas_ring2d,
    "pallas_a2a": _eligible_pallas_a2a,
    "hier": _eligible_hier,
}

ALGORITHMS = tuple(_ELIGIBLE)


def eligible(algo: str, kind: str, group: ProcessGroup, op=None) -> bool:
    """Can ``algo`` lower (kind, group, op)? Unknown names never are."""
    if kind not in ENGINE_KINDS:
        return algo == DEFAULT
    if kind == "alltoall" and algo not in (DEFAULT, "pallas_a2a"):
        # the reduction algorithms' predicates do not check the kind: this
        # guard keeps a global MLSL_ALGO=rhd off the MoE exchange
        return False
    pred = _ELIGIBLE.get(algo)
    return bool(pred and pred(kind, group, op))


def candidates(kind: str, group: ProcessGroup, op=None) -> Tuple[str, ...]:
    """Every algorithm eligible for (kind, group, op), baseline first."""
    return tuple(a for a in ALGORITHMS if eligible(a, kind, group, op))


def check_name(name: str, what: str) -> None:
    """Raise MLSLError for a name the registry does not have."""
    mlsl_assert(name in ALGORITHMS,
                "%s %r is not a registered collective algorithm (registry: %s)",
                what, name, ", ".join(ALGORITHMS))


def parse_forced(spec: str) -> dict:
    """Parse MLSL_ALGO: one algorithm name (forced for every engine kind) or
    a comma list of kind=name entries. Raises MLSLError on unknown names and
    kinds, at init rather than deep in dispatch."""
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
        # QUANTIZATION request through the fused int8 ring, and a forced or
        # tuned 'hier' through the two-tier wire (its codec on the DCN hop
        # only), when the group qualifies
        if (compression == CompressionType.QUANTIZATION
                and getattr(config, "custom_codec", None) is None):
            name = _requested(kind, group, payload_bytes, compression, config)
            if name == "pallas_ring" and _quant_pallas_eligible(group, config):
                return name
            if name == "hier" and _quant_hier_eligible(kind, group, config):
                return name
            if name in ("pallas_ring", "hier"):
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


def _quant_hier_eligible(kind: str, group: ProcessGroup, config) -> bool:
    """The compressed two-tier wire serves allreduce on a tiered group."""
    from mlsl_tpu_torch.comm.algos import hier

    if kind != "allreduce":
        return False
    return hier.eligible_quant(group, int(getattr(config, "quant_block_elems", 256)))


def build(kind: str, group: ProcessGroup, algo: str, **kw) -> Callable:
    """-> fn: distributed buffer (R, D, S, M, n) -> result buffer, the
    calling convention of collectives.build_collective. ``algo='lax'`` is
    build_collective. The kernel algorithms take ``plain=True`` to run their
    plain versions on any device (the card's parity checks); the rings take
    ``bidir`` (``Config.pallas_ring_bidir``, off unless passed); ``pallas_a2a``
    takes ``block``, ``quantized`` and ``ef``. Each lowering ignores the
    keywords it has no use for."""
    from mlsl_tpu_torch.comm import collectives

    if algo == DEFAULT:
        return collectives.build_collective(
            kind, group, **{k: v for k, v in kw.items() if k in collectives.BUILD_KW})
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
    elif algo == "pallas_a2a":
        from mlsl_tpu_torch.comm.algos import pallas_a2a as impl
    elif algo == "hier":
        from mlsl_tpu_torch.comm.algos import hier as impl
    else:
        from mlsl_tpu_torch.comm.algos import pallas_rhd as impl
    return impl.build(kind, group, **kw)


# -- the staged forms (the ZeRO-1 update, comm/overlap.py) ------------------------


def inline_eligible(algo: str, kind: str, group: ProcessGroup, op=None) -> bool:
    """Can ``algo`` serve (kind, group, op) as staged phases
    (``mlsl_tpu.comm.algos.inline_eligible``)? A color group of more than
    one member cannot: its phases would need its own axes. The kernel
    algorithms are eligible wherever ``eligible`` admits them: JAX emits them
    in a graph only on a TPU (``inline_ok``), the port runs their kernels on
    the card and their plain versions on the CPU."""
    if group.colors is not None and group.size > 1:
        return False
    return eligible(algo, kind, group, op)


def inline_plan(kind: str, group: ProcessGroup, algo: str, count: int, *, op=None,
                recv_count=None, config=None, plain: bool = False):
    """The staged form of ``algo`` (``mlsl_tpu.comm.algos.inline_plan``):
    ``(prep, phases, finish)`` over distributed buffers, ``prep(buf) ->
    carry``, each ``phases[i](carry) -> carry`` one collective phase (the
    unit the ZeRO-1 update interleaves between layers), ``finish(carry) ->
    result buffer``. ``lax`` is one phase, the baseline collective; ``rhd``,
    ``ring2d`` and ``hier`` have the phases of their JAX schedules; the kernel
    algorithms one phase, one launch (``plain``: their plain versions).
    ``count`` is the per-member element count. allreduce and reduce_scatter
    only."""
    from mlsl_tpu_torch.comm import collectives

    mlsl_assert(kind in ("allreduce", "reduce_scatter"),
                "the staged form serves allreduce and reduce_scatter, not %s", kind)
    mlsl_assert(inline_eligible(algo, kind, group, op),
                "algorithm %s cannot lower %s in stages on group shape %s", algo, kind,
                group_shape(group))
    rop = ReductionType(op) if op is not None else ReductionType.SUM
    ident = lambda buf: buf   # noqa: E731
    if group.is_self or group.size <= 1:
        # a degenerate group: every reduction is the identity
        if kind == "reduce_scatter" and recv_count is not None:
            return ident, [], lambda buf: buf[..., :recv_count]
        return ident, [], ident
    if algo == DEFAULT:
        kw = {"recv_count": recv_count} if kind == "reduce_scatter" else {}
        return ident, [collectives.build_collective(kind, group, op=rop, **kw)], ident
    if algo == "rhd":
        from mlsl_tpu_torch.comm.algos import rhd

        return rhd.steps(kind, group, count, op=rop, recv_count=recv_count)
    if algo == "ring2d":
        from mlsl_tpu_torch.comm.algos import ring2d

        return ring2d.steps(kind, group, count, op=rop, recv_count=recv_count)
    if algo == "hier":
        from mlsl_tpu_torch.comm.algos import hier

        return hier.steps(kind, group, count, op=rop, recv_count=recv_count)
    if algo == "pallas_rhd":
        from mlsl_tpu_torch.comm.algos import pallas_rhd

        return pallas_rhd.steps(kind, group, count, op=rop, plain=plain)
    from mlsl_tpu_torch.comm.algos import pallas_ring, pallas_ring2d

    impl = pallas_ring if algo == "pallas_ring" else pallas_ring2d
    return impl.steps(kind, group, count, op=rop, recv_count=recv_count,
                      bidir=bool(getattr(config, "pallas_ring_bidir", False)), plain=plain)


# -- engine-owned collectives inside a training graph ---------------------------
#
# The pipeline schedules (parallel/pipeline.py) sum their microbatch losses
# over the stage dim; the MoE layer (models/moe.py) exchanges and gathers
# per-rank tensors with the leading (R, D, S, M) grid dims. With a group and a
# config the exchange goes through the selection table; the helpers are plain
# tensor work on the plain route, so autograd runs through them.


#: inline_allreduce's staged forms, by (algorithm, group key, count, op,
#: bidir); Environment.finalize empties it
_INLINE_PLANS: dict = {}


def inline_allreduce(x: torch.Tensor, dim: int, *, group: ProcessGroup = None,
                     config=None, op=None) -> torch.Tensor:
    """The allreduce inside model and parallelism code (algos/__init__.py:580-612).

    With a ``group`` of more than one member, ``x`` is a grid buffer (R, D, S,
    M, ...) and the selection table picks the lowering (``config``): a
    non-default choice that ``inline_eligible`` admits runs through
    ``inline_plan`` (prep, phases, finish), anything else the baseline
    collective over the group. Otherwise ``x`` holds per-rank values with
    leading rank dims and the SUM / MIN / MAX runs along the rank dim ``dim``
    (the JAX package's axis name), every rank receiving the result. On the CPU
    a SUM adds the members one by one, in member order, as the baseline
    collective does; on the card it is one reduction. Autograd runs through
    the plain routes.

    A staged form is built once per (algorithm, group, count, op) and kept
    until the Environment is finalized, with the member tables its kernels
    read on the card: a second call copies nothing to the card, so a CUDA
    graph can record it (the serving engine's decode step)."""
    from mlsl_tpu_torch.comm import collectives

    rop = ReductionType(op) if op is not None else ReductionType.SUM
    if group is not None and not group.is_self and group.size > 1:
        grid = x.shape[:NUM_GRID_AXES]
        count = math.prod(x.shape[NUM_GRID_AXES:])
        buf = x.reshape(*grid, count)
        algo = select("allreduce", group, count * 4, CompressionType.NONE, config, op=rop)
        if algo != DEFAULT and inline_eligible(algo, "allreduce", group, rop):
            key = (algo, collectives.group_key(group, x.device), count, rop,
                   bool(getattr(config, "pallas_ring_bidir", False)))
            plan = _INLINE_PLANS.get(key)
            if plan is None:
                plan = _INLINE_PLANS[key] = inline_plan("allreduce", group, algo, count,
                                                        op=rop, config=config)
            prep, phases, finish = plan
            carry = prep(buf)
            for phase in phases:
                carry = phase(carry)
            return finish(carry).reshape(x.shape)
        return collectives.build_collective("allreduce", group, op=rop)(buf).reshape(x.shape)
    if rop == ReductionType.SUM:
        if x.is_cuda:
            r = x.sum(dim=dim, keepdim=True)
        else:
            r = x.narrow(dim, 0, 1)
            for j in range(1, x.shape[dim]):
                r = r + x.narrow(dim, j, 1)
    elif rop == ReductionType.MIN:
        r = x.amin(dim=dim, keepdim=True)
    else:
        r = x.amax(dim=dim, keepdim=True)
    return r.expand_as(x)


def _group_exchange(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """The plain all-to-all of per-rank tensors (R, D, S, M, G, *rest) whose
    first local dim holds one chunk per member: member j receives chunk j of
    every member, in member order, at the same place."""
    from mlsl_tpu_torch.comm import collectives

    grid = x.shape[:NUM_GRID_AXES]
    n = math.prod(x.shape[NUM_GRID_AXES + 1:])
    fn = collectives.build_collective("alltoall", group, send_count=n)
    return fn(x.reshape(*grid, -1)).reshape(x.shape)


def inline_alltoall(x: torch.Tensor, group: ProcessGroup, *, config=None) -> torch.Tensor:
    """The MoE dispatch and combine exchange of per-rank tensors (R, D, S,
    M, G, *rest) over ``group``: ``lax.all_to_all`` with split = concat = 0,
    untiled, the only layout the MoE FFN uses. Member j receives chunk j of
    every member, in member order.

    With a config the selection table picks the lowering. The kernel route
    (``pallas_a2a``, kernel B6) takes a float32 payload, as in the JAX
    package; any other type, or the ``lax`` choice, takes the plain
    exchange. The kernel route's gradient is the dense exchange of the
    cotangent (ops/a2a_kernels.py)."""
    g = group.size
    if group.is_self or g <= 1:
        return x
    local = x.shape[NUM_GRID_AXES:]
    mlsl_assert(local[0] == g, "alltoall needs a leading local dim of size %d, got %s", g,
                tuple(local))
    if config is not None and x.dtype == torch.float32:
        count = math.prod(local)
        algo = select("alltoall", group, count * 4, CompressionType.NONE, config)
        if algo == "pallas_a2a":
            from mlsl_tpu_torch.ops import a2a_kernels

            w = group.topology.world_size
            out = a2a_kernels.exchange(x.reshape(w, count), group,
                                       block=config.quant_block_elems,
                                       quantized=config.pallas_a2a_quant)
            return out.reshape(x.shape)
    return _group_exchange(x, group)


def inline_allgather(x: torch.Tensor, group: ProcessGroup, *, config=None) -> torch.Tensor:
    """The tiled all-gather of per-rank tensors (R, D, S, M, T, *rest) over
    ``group`` (the MoE output reassembly, the ZeRO-1 state drain): every
    member receives every member's tensor, concatenated along T in member
    order. Autograd sums the cotangent over the members, as JAX transposes
    ``lax.all_gather``.

    With a config whose table routes the group's reduce_scatter to the fused
    ring (``pallas_ring``, ``pallas_ring2d``), the gather is one B3-AG launch
    over the same ring or snake cycle, as the staged ZeRO-1 update pairs the
    two (comm/overlap.py). The kernel has no autograd and takes float32, bf16
    or int32: a tensor that needs a gradient, or of another type, raises
    MLSLError on that route. Otherwise the plain gather."""
    from mlsl_tpu_torch.comm import collectives

    grid, local = x.shape[:NUM_GRID_AXES], x.shape[NUM_GRID_AXES:]
    n = math.prod(local)
    if config is not None and not group.is_self and group.size > 1:
        algo = select("reduce_scatter", group, n * group.size * x.element_size(),
                      CompressionType.NONE, config)
        if algo in ("pallas_ring", "pallas_ring2d"):
            from mlsl_tpu_torch.ops import ring_kernels

            mlsl_assert(not (torch.is_grad_enabled() and x.requires_grad),
                        "inline_allgather: the %s route (B3-AG) has no gradient; gather "
                        "a tensor that needs one without a config", algo)
            mlsl_assert(x.dtype in (torch.float32, torch.bfloat16, torch.int32),
                        "inline_allgather: the %s route (B3-AG) takes float32, bfloat16 "
                        "or int32, not %s", algo, x.dtype)
            plan = ring_kernels.dense_plan("all_gather", group, n, bidir=False,
                                           snake=algo == "pallas_ring2d")
            w = group.topology.world_size
            y = ring_kernels.dense_ring(x.reshape(w, n), plan)
            return y.reshape(*grid, group.size * local[0], *local[1:])
    y = collectives.build_collective("allgather", group)(x.reshape(*grid, -1))
    return y.reshape(*grid, group.size * local[0], *local[1:])
