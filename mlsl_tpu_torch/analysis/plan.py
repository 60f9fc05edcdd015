"""Commit-time collective-plan verifier.

Counterpart of ``mlsl_tpu.analysis.plan``, by adapted copy. ``Session.commit``
is the one point where the whole communication plan is visible *before*
anything executes: every CommRequest is built, buckets are formed, the
selection table has resolved each request's algorithm. This pass walks that
committed state and statically checks the invariants the runtime relies on:

- **A101** issue-order consistency across overlapping process groups: under
  ``MLSL_MSG_PRIORITY`` a deferred large request's dispatch is released by a
  wall-clock flush window, so its wire order against an immediately
  dispatched request is rank-dependent on a multi-controller mesh — when the
  two groups' instance partitions differ and intersect, that inversion is
  the classic cross-replica deadlock.
- **A102/A103** worst-case concurrent in-flight collective programs vs the
  backend budget. On a two-tier world (``MLSL_MESH_TIERS``) the count is
  also taken per tier: programs whose groups span tiers are budgeted
  separately at half the backend figure.
- **A110-A114** quantization geometry: bucket member slots on quant-block
  boundaries, coalesced totals on the ring-chunk unit, error-feedback
  lengths equal to the wire's geometry, ZeRO-1 shard boundaries on block
  boundaries, and hier-routed compressed requests whose inter-tier quant
  blocks would straddle the intra-tier shard boundary.
- **A115/A116** registry-codec wire geometry (``codecs/*.geometry``): VQ
  index-table/codebook alignment and prune mask coverage.
- **A121** the degrade machinery's static preconditions: every compressed
  request's residual layout and per-chunk residual lengths cover every
  chunk program it dispatches (the port keeps no separate degrade-geometry
  list: a degraded flush reads ``_chunk_slices`` and ``_err_lens``).
- **A120/A122** compiled-overlap donation hazards (``verify_overlap_plan``):
  aliased residual carry slots, units that cannot retire inside their stage
  window.
- **A130-A132** the kernel routes. ``verify_hop_trace`` checks a ring
  kernel's semaphore accounting as in the reference; the port's CUDA
  kernels have no comm slots or capacity semaphores (one thread or one warp
  walks the hops on one card), so nothing emits such a trace here. A
  request routed to ``pallas_ring``, ``pallas_ring2d``, ``pallas_rhd`` or
  ``pallas_a2a`` is instead held to the limits its CUDA kernel would refuse
  at launch with MLSLKernelError: a group of at most ``MAX_GROUP`` (64)
  members and B6's launch grid (A132, the kernel's budget), an int8 block
  that is a multiple of 128 (A111, its geometry) and at most
  ``MAX_QUANT_BLOCK`` (1,024) elements (A132), both for B4 and B6 (standing
  difference "A130-A132 on the CUDA routes"), and, across processes, a
  process-local group (A132: the kernel reads every member on one device).
- **A140/A141** elastic reshard coverage (``verify_reshard``), run
  unconditionally by the elastic coordinator, not gated by MLSL_VERIFY.

Armed by ``MLSL_VERIFY=1`` at commit (``run_commit_verify``), where the
compiled engine is built (comm/overlap.py), and by ``python -m
mlsl_tpu_torch.analysis --graph``. Findings land in the shared diagnostic
format (analysis/diagnostics.py), the ``ANALYSIS`` stats line, and trace
instants; ``MLSL_VERIFY_SEVERITY`` picks raise-vs-warn.
"""

from __future__ import annotations

import time
from typing import FrozenSet, List, Optional, Set

import numpy as np

from mlsl_tpu_torch.analysis.diagnostics import ERROR, Report, record
from mlsl_tpu_torch.log import MLSLError, log_warning
from mlsl_tpu_torch.types import CompressionType, dtype_size

#: worst-case concurrent in-flight collective programs the backend tolerates.
#: The CPU figure is the reference's XLA:CPU rendezvous figure (measured in
#: its bucket bench), kept so that CPU verdicts match the JAX package's
#: (standing difference "The cuda in-flight budget"); the card streams
#: launches on one comm stream and takes the reference's default.
INFLIGHT_BUDGET = {"cpu": 32}
INFLIGHT_BUDGET_DEFAULT = 512


# ---------------------------------------------------------------------------
# Group overlap model
# ---------------------------------------------------------------------------


def _instances(group) -> Set[FrozenSet[int]]:
    """The group's instance partition: the set of member-world-rank sets."""
    from mlsl_tpu_torch.comm.collectives import member_world_table

    tbl = member_world_table(group)
    return {frozenset(int(v) for v in row) for row in tbl}


def _partitions_conflict(i1, i2) -> bool:
    if i1 == i2:
        return False
    return any(a != b and a & b for a in i1 for b in i2)


def groups_conflict(g1, g2, _cache: Optional[dict] = None) -> bool:
    """True when the two groups' instance partitions differ AND intersect:
    a rank-dependent dispatch-order inversion between collectives on such
    groups is the cross-replica deadlock (two instances progress
    independently while sharing members). Identical partitions are safe —
    every member sees both collectives in its own (single) order.

    ``_cache`` (id(group) -> partition) amortizes the member-table walk
    across one verify run: the A101 scan compares O(L^2) request pairs on
    a graph whose few distinct groups repeat across every layer."""
    if getattr(g1, "is_self", False) or getattr(g2, "is_self", False):
        return False
    if _cache is None:
        _cache = {}
    i1 = _cache.get(id(g1))
    if i1 is None:
        i1 = _cache[id(g1)] = _instances(g1)
    i2 = _cache.get(id(g2))
    if i2 is None:
        i2 = _cache[id(g2)] = _instances(g2)
    return _partitions_conflict(i1, i2)


# ---------------------------------------------------------------------------
# The committed-graph walk
# ---------------------------------------------------------------------------


def _chunk_counts(req) -> List[int]:
    """Element count of each independently dispatched chunk program."""
    d = req.desc
    out = []
    for sl in req._chunk_slices:
        if sl == slice(None):
            out.append(d.count)
        else:
            out.append(int(sl.stop) - int(sl.start))
    return out or [d.count]


def _programs(req) -> int:
    return max(1, len(req._chunk_slices))


def _backward_entities(session) -> List[tuple]:
    """The backward dispatch window, in issue order (newest gradient first):
    one entry per dispatched entity — ``('bucket', bucket, anchor)`` once per
    coalesced bucket, ``('req', request, anchor)`` for individual sets."""
    out: List[tuple] = []
    seen_buckets: Set[int] = set()
    for op in reversed(session.operations):
        for ps in reversed(op.parameter_sets):
            if not ps.need_comm or ps.grad_req is None:
                continue
            anchor = f"graph:{op.name}/ps{ps.param_index}"
            b = ps.bucket
            if b is not None:
                if id(b) not in seen_buckets:
                    seen_buckets.add(id(b))
                    out.append(("bucket", b, f"graph:{b.req.name}"))
            else:
                out.append(("req", ps.grad_req, anchor))
    return out


def _inc_entities(session) -> List[tuple]:
    out: List[tuple] = []
    seen: Set[int] = set()
    for op in session.operations:
        for ps in op.parameter_sets:
            if not ps.need_comm or not ps.distributed_update:
                continue
            anchor = f"graph:{op.name}/ps{ps.param_index}/inc"
            b = ps.inc_bucket
            if b is not None:
                if id(b) not in seen:
                    seen.add(id(b))
                    out.append(("bucket", b, f"graph:{b.req.name}"))
            elif ps.inc_req is not None:
                out.append(("req", ps.inc_req, anchor))
    return out


def _entity_programs(kind: str, ent) -> int:
    """Worst-case concurrent programs one entity can put in flight: a bucket
    either dispatches its coalesced request OR (early-Wait fallback) every
    member's individual request — the worst case is the larger."""
    if kind == "req":
        return _programs(ent)
    coalesced = _programs(ent.req)
    fallback = sum(
        _programs(getattr(ps, ent.req_attr)) for ps in ent.members
        if getattr(ps, ent.req_attr) is not None
    )
    return max(coalesced, fallback)


def _entity_reqs(kind: str, ent) -> List[tuple]:
    """(request, anchor) pairs an entity can dispatch (bucket: the coalesced
    request AND the members' fallbacks — both are reachable paths)."""
    if kind == "req":
        return [(ent, None)]
    out = [(ent.req, None)]
    for ps in ent.members:
        r = getattr(ps, ent.req_attr)
        if r is not None:
            out.append((r, None))
    return out


def _platform(session) -> str:
    """The device type the session's environment runs on: 'cuda' on the
    card, 'cpu' where the caller asked for the CPU."""
    dev = getattr(session.env, "device", None)
    return dev.type if dev is not None else "cpu"


def verify_session(session, config=None) -> Report:
    """Statically verify one committed session's collective plan."""
    rep = Report("plan")
    cfg = config if config is not None else session.env.config
    back = _backward_entities(session)
    inc = _inc_entities(session)

    _check_inflight(rep, session, back, inc)
    _check_issue_order(rep, cfg, back)
    for kind, ent, anchor in back + inc:
        if kind == "bucket":
            _check_bucket_geometry(rep, ent, cfg, anchor)
        for req, _ in _entity_reqs(kind, ent):
            _check_request(rep, req, cfg,
                           anchor if kind == "req" else f"{anchor}/member")
    # activation edges dispatch sequentially (start -> wait per edge); their
    # requests still carry geometry/EF invariants worth pinning
    for op in session.operations:
        for act in list(op.inputs) + list(op.outputs):
            r = getattr(act, "comm_req", None)
            if r is not None and r.is_setup:
                _check_request(rep, r, cfg, f"graph:{op.name}/act")
    return rep


def _spans_tiers(group, tier_ids, cache=None) -> bool:
    """True when one of the group's instances has members in >= 2 tiers: its
    collectives put traffic on the DCN. ``cache`` memoizes per distinct
    group within one verify run (the A101 convention — the member table is
    O(W*G) to build and per-layer requests share a handful of groups)."""
    if getattr(group, "is_self", False):
        return False
    key = id(group)
    if cache is not None and key in cache:
        return cache[key]
    from mlsl_tpu_torch.comm.collectives import member_world_table

    try:
        tbl = member_world_table(group)
    except Exception:
        return True  # unknowable layout: worst-case it as DCN-crossing
    spans = any(
        len({tier_ids[int(w)] for w in row}) > 1
        for row in np.atleast_2d(tbl)
    )
    if cache is not None:
        cache[key] = spans
    return spans


def _dcn_budget(budget: int) -> int:
    """The per-tier budget for DCN-crossing programs: the slow tier's
    rendezvous/transfer machinery tolerates far fewer concurrent
    collectives than the ICI — half the backend figure, floored so tiny
    budgets stay usable."""
    return max(budget // 2, 4)


def _check_inflight(rep: Report, session, back, inc) -> None:
    from mlsl_tpu_torch.comm.mesh import world_tier_ids

    platform = _platform(session)
    budget = INFLIGHT_BUDGET.get(platform, INFLIGHT_BUDGET_DEFAULT)
    tier_ids = None
    for op in session.operations:
        if op.distribution is not None:
            tier_ids = world_tier_ids(op.distribution.topology.world_size)
            break
    for window, entities in (("backward", back), ("increment", inc)):
        n = sum(_entity_programs(k, e) for k, e, _ in entities)
        if n > budget:
            rep.add("MLSL-A102",
                    f"{window} window can put {n} collective programs in "
                    f"flight concurrently; the {platform} backend budget is "
                    f"{budget} (the rendezvous wedge class — raise "
                    "MLSL_GRAD_BUCKET_MB or window the dispatches)",
                    f"graph:{window}")
        elif n > budget // 2:
            rep.add("MLSL-A103",
                    f"{window} window reaches {n}/{budget} of the {platform} "
                    "in-flight collective budget", f"graph:{window}")
        if tier_ids is None:
            continue
        # two-tier shape: programs whose groups span tiers contend for the
        # DCN separately — the slow tier wedges at far lower concurrency
        dcn = _dcn_budget(budget)
        span_cache: dict = {}  # one member-table walk per distinct group
        n_dcn = sum(
            _entity_programs(k, e) for k, e, _ in entities
            if any(_spans_tiers(r.desc.group, tier_ids, span_cache)
                   for r, _ in _entity_reqs(k, e))
        )
        if n_dcn > dcn:
            rep.add("MLSL-A102",
                    f"{window} window can put {n_dcn} DCN-crossing "
                    f"collective programs in flight concurrently; the "
                    f"two-tier budget is {dcn} (half the {platform} figure "
                    "— route through the 'hier' lowering or raise "
                    "MLSL_GRAD_BUCKET_MB)", f"graph:{window}/dcn")
        elif n_dcn > dcn // 2:
            rep.add("MLSL-A103",
                    f"{window} window reaches {n_dcn}/{dcn} of the "
                    "DCN-crossing in-flight budget on this two-tier world",
                    f"graph:{window}/dcn")


def _check_issue_order(rep: Report, cfg, back) -> None:
    """A101: deferral-window order inversion on conflicting groups."""
    if not getattr(cfg, "msg_priority", False):
        return
    threshold = getattr(cfg, "msg_priority_threshold", 0)
    open_deferred: List[tuple] = []
    cache: dict = {}  # one partition computation per distinct group
    for kind, ent, anchor in back:
        for req, _ in _entity_reqs(kind, ent):
            d = req.desc
            if d.kind == "barrier":
                open_deferred.clear()  # a barrier flushes the stack
                continue
            if req._payload > threshold:
                open_deferred.append((req, anchor))
                continue
            for dref, danchor in open_deferred:
                if groups_conflict(dref.desc.group, d.group, cache):
                    rep.add(
                        "MLSL-A101",
                        f"immediate dispatch of '{req.name or req.uid}' can "
                        f"land before OR after the deferred flush of "
                        f"'{dref.name or dref.uid}' (flush window "
                        f"{cfg.msg_priority_flush_ms}ms) while their groups' "
                        "instance partitions overlap but differ — wire "
                        "order becomes rank-dependent, the cross-replica "
                        "deadlock", anchor)


def _expected_err_len(req, cfg) -> Optional[List[int]]:
    """Per-chunk expected error-feedback length for a compressed request, or
    None when the wire family owns its own layout (top-k, user dlopen
    codec — registry codecs DO declare theirs: g x chunk entry residual)."""
    d = req.desc
    if d.compression != CompressionType.QUANTIZATION:
        return None
    if req.algo.startswith("codec:"):
        # registry codec on the compressed-ring transport (comm/codec.py):
        # entry EF, one residual row per hop — err_len = g * chunk
        g = 1 if d.group.is_self else d.group.size
        rs = d.kind == "reduce_scatter"
        return [g * (n // g if rs else -(-n // g)) for n in _chunk_counts(req)]
    if req.algo not in ("quant_ring", "pallas_ring", "hier"):
        return None
    # effective block: a desc-level override or a calibrated int8 cell may
    # widen it per-request (comm/request.py setup) — the session block is
    # only the fallback
    block = _eff_block(req, cfg)
    out = []
    for n in _chunk_counts(req):
        if req.algo == "pallas_ring":
            from mlsl_tpu_torch.ops import ring_kernels as rk

            out.append(rk.quant_geometry(d.kind, d.group, n, block)[3])
        elif req.algo == "hier":
            from mlsl_tpu_torch.comm.algos import hier

            out.append(hier.quant_geometry(d.kind, d.group, n, block)[2])
        else:
            from mlsl_tpu_torch.comm.quant_ring import ring_geometry

            out.append(ring_geometry(d.kind, d.group, n, block)[3])
    return out


def _eff_block(req, cfg) -> int:
    return int(getattr(req, "_eff_quant_block", 0)
               or getattr(cfg, "quant_block_elems", 256))


def _check_request(rep: Report, req, cfg, anchor: str) -> None:
    """Per-request invariants: EF geometry (A112), the snapshot/rewind
    machinery's static preconditions (A121), codec geometry (A114-A116),
    plus the kernel routes' launch limits."""
    d = req.desc
    compressed = req._quant_fns is not None
    if compressed:
        # -- A121: every retry/degrade path rewinds from a snapshot and
        # flushes residuals whose geometry covers every chunk program
        # (request._flush_fn / _take_residuals preconditions)
        lens = req._err_lens
        chunks = _chunk_counts(req)
        if req._err_layout not in ("ring", "flat", "hier"):
            rep.add("MLSL-A121",
                    f"compressed request '{req.name or req.uid}' has no "
                    "_err_layout: the degrade flush cannot invert its "
                    "residual", anchor)
        if req._err_layout == "hier" and getattr(
                req, "_hier_meta", None) is None:
            rep.add("MLSL-A121",
                    f"hier-routed request '{req.name or req.uid}' carries "
                    "no intra-tier position table: the degrade flush "
                    "cannot re-place its per-shard residual", anchor)
        if lens is None or len(lens) != len(chunks):
            rep.add("MLSL-A121",
                    f"degrade geometry of '{req.name or req.uid}' covers "
                    f"{0 if lens is None else len(lens)} chunk(s) but the "
                    f"request dispatches {len(chunks)}: a degraded retry "
                    "would flush the wrong residual slices", anchor)
        # -- A112: EF length vs the wire's geometry (a missing residual
        # table is A121's finding above)
        expected = _expected_err_len(req, cfg)
        if expected is not None and lens is not None:
            actual = list(lens)
            if len(actual) == len(expected):
                for a, e in zip(actual, expected):
                    if int(a) != int(e):
                        rep.add("MLSL-A112",
                                f"err_len {a} != quant-ring geometry {e} on "
                                f"'{req.name or req.uid}' (block="
                                f"{_eff_block(req, cfg)})", anchor)
            else:
                rep.add("MLSL-A112",
                        f"'{req.name or req.uid}' carries {len(actual)} "
                        f"residual length(s) for {len(expected)} chunk "
                        "program(s)", anchor)
    if compressed and req.algo == "hier":
        # -- A114 (the A113 class on the two-tier shape): the compressed
        # DCN tier quantizes each member's 1/L shard against the shared
        # per-block scale — a residual/shard length off the block grid means
        # a quant block straddles the intra-slice shard boundary, breaking
        # scale locality AND the flush_residual slice placement
        block = getattr(cfg, "quant_block_elems", 256)
        actual = list(req._err_lens or ())
        from mlsl_tpu_torch.comm.algos import hier

        tiers = hier.tier_structure(d.group)
        for slen, n in zip(actual, _chunk_counts(req)):
            if int(slen) % int(block):
                rep.add("MLSL-A114",
                        f"hier compressed-tier shard length {slen} is not "
                        f"on the {block}-elem quant block grid on "
                        f"'{req.name or req.uid}': a DCN-tier block "
                        "straddles the intra-slice shard boundary", anchor)
            elif tiers is not None and int(slen) * tiers[1] < int(n):
                rep.add("MLSL-A114",
                        f"hier shard length {slen} x L={tiers[1]} does not "
                        f"cover chunk count {n} on "
                        f"'{req.name or req.uid}': the tail of the payload "
                        "would never cross the DCN", anchor)
    geoms = getattr(req, "_codec_geoms", None)
    if compressed and geoms is not None:
        # -- A115/A116 (the A110-A114 siblings for registry codecs): each
        # chunk's pinned wire geometry must be self-consistent — a tampered
        # VQ index table or codebook no longer covers the chunk (A115), a
        # prune mask shorter than the chunk silently drops tail gradients
        # and desynchronizes the rank-decode (A116)
        for gm in geoms:
            name = str(gm.get("codec", ""))
            chunk = int(gm.get("chunk", 0))
            if name == "vq":
                dim = int(gm.get("dim", 0) or 0)
                k = int(gm.get("k", 0) or 0)
                idx = int(gm.get("idx_elems", -1))
                cbe = int(gm.get("codebook_elems", -1))
                want_idx = -(-chunk // dim) if dim > 0 else -1
                if dim <= 0 or idx != want_idx:
                    rep.add("MLSL-A115",
                            f"VQ index table of '{req.name or req.uid}' "
                            f"carries {idx} indices for a {chunk}-elem chunk "
                            f"at dim={dim} (expected {want_idx}): decode "
                            "would mis-tile the vectors", anchor)
                elif cbe != k * dim:
                    rep.add("MLSL-A115",
                            f"VQ codebook of '{req.name or req.uid}' "
                            f"carries {cbe} elems for k={k} x dim={dim}: "
                            "the wire codebook and the index range "
                            "disagree", anchor)
                elif int(gm.get("wire_len", -1)) != idx + 4 * cbe + 4:
                    rep.add("MLSL-A115",
                            f"VQ wire length {gm.get('wire_len')} of "
                            f"'{req.name or req.uid}' != indices {idx} + "
                            f"codebook {4 * cbe} + scale 4 bytes", anchor)
            elif name in ("prune", "topk"):
                k = int(gm.get("k", 0) or 0)
                mask_len = int(gm.get("mask_len", -1))
                if mask_len != chunk:
                    rep.add("MLSL-A116",
                            f"prune mask of '{req.name or req.uid}' covers "
                            f"{mask_len} elems of a {chunk}-elem chunk: the "
                            "tail would silently drop from every round",
                            anchor)
                elif not 0 < k <= chunk:
                    rep.add("MLSL-A116",
                            f"prune keep-count {k} of "
                            f"'{req.name or req.uid}' is outside the "
                            f"{chunk}-elem chunk", anchor)
                elif int(gm.get("wire_len", -1)) != -(-mask_len // 8) + 4 * k:
                    rep.add("MLSL-A116",
                            f"prune wire length {gm.get('wire_len')} of "
                            f"'{req.name or req.uid}' != packed mask "
                            f"{-(-mask_len // 8)} + {4 * k} value bytes: "
                            "the rank-decode gather desynchronizes", anchor)
    if req.algo in KERNEL_ROUTES:
        _check_kernel_route(rep, req, cfg, anchor)


# ---------------------------------------------------------------------------
# Bucket geometry (A110/A111/A113 + the request-level A112 above)
# ---------------------------------------------------------------------------


def _check_bucket_geometry(rep: Report, bucket, cfg, anchor: str) -> None:
    if bucket.compression != CompressionType.QUANTIZATION:
        return
    from mlsl_tpu_torch.comm import quant_ring

    block = getattr(cfg, "quant_block_elems", 256)
    d = bucket.req.desc
    group = d.group
    g = 1 if group.is_self else group.size
    for i, (ps, off, slot) in enumerate(
            zip(bucket.members, bucket.offsets, bucket.slots)):
        if off % block or slot % block:
            req = getattr(ps, bucket.req_attr, None)
            rep.add("MLSL-A110",
                    f"member '{getattr(req, 'name', None) or i}' slot "
                    f"[{off}, {off + slot}) is not on the {block}-elem quant "
                    "block grid: a block would straddle members and break "
                    "per-member scale locality", f"{anchor}/member{i}")
    # the chunk unit the bucket sized its total for: the fused int8 ring's
    # when the selection table routes its payload there (core/bucketing.py)
    rs = bucket.kind == "reduce_scatter"
    fused = bucket.codec in ("", "int8") and quant_ring.use_pallas_for(
        bucket.kind, group,
        sum(bucket.slots) * dtype_size(d.data_type) * (g if rs else 1), cfg)
    if rs:
        recv = d.count // g
        if recv % block:
            rep.add("MLSL-A113",
                    f"ZeRO-1 shard length {recv} is not block-aligned "
                    f"(block={block}): a quant block straddles the shard "
                    "boundary", anchor)
        if quant_ring.ring_aligned_rc(recv, block, fused) != recv:
            rep.add("MLSL-A111",
                    f"per-rank shard {recv} is not ring-chunk aligned "
                    "(quant_ring.ring_aligned_rc): hops would pad "
                    "internally", anchor)
    else:
        rc = -(-d.count // g)
        if quant_ring.ring_aligned_rc(rc, block, fused) != rc or d.count != g * rc:
            rep.add("MLSL-A111",
                    f"coalesced total {d.count} (per-rank slice {rc}) is "
                    "not ring-chunk aligned (quant_ring.ring_aligned_rc)",
                    anchor)


# ---------------------------------------------------------------------------
# Compiled-overlap plan (A120/A122, + A112 via the shared geometry)
# ---------------------------------------------------------------------------


def verify_overlap_plan(plan, block: Optional[int] = None) -> Report:
    """Statically verify a comm/overlap.OverlapPlan + its staged schedule:
    donated-carry aliasing (A120), stage-window retirement (A122), and the
    residual geometry the donated EF carry must match (A112)."""
    rep = Report("plan")
    seen_keys: Set[str] = set()
    for u in plan.units:
        anchor = f"graph:overlap/{'+'.join(u.names)}"
        if u.key is not None:
            if u.key in seen_keys:
                rep.add("MLSL-A120",
                        f"residual carry key '{u.key}' aliased by two "
                        "units: both would donate and read the same EF "
                        "slot", anchor)
            seen_keys.add(u.key)
            if plan.err_lens.get(u.key) != u.err_len:
                rep.add("MLSL-A120",
                        f"plan residual table says {plan.err_lens.get(u.key)}"
                        f" elems for '{u.key}' but the unit carries "
                        f"{u.err_len}: the donated carry would be read at "
                        "the wrong geometry", anchor)
            if block is not None:
                if u.algo == "hier":
                    from mlsl_tpu_torch.comm.algos import hier

                    exp = hier.quant_geometry("allreduce", plan.group,
                                              u.total, block)[2]
                elif u.algo == "pallas_ring":
                    from mlsl_tpu_torch.ops import ring_kernels as rk

                    exp = rk.quant_geometry("allreduce", plan.group, u.total,
                                            block)[3]
                else:
                    from mlsl_tpu_torch.comm.quant_ring import ring_geometry

                    exp = ring_geometry("allreduce", plan.group, u.total,
                                        block)[3]
                if exp != u.err_len:
                    rep.add("MLSL-A112",
                            f"unit err_len {u.err_len} != quant-ring "
                            f"geometry {exp} (block={block})", anchor)
        need = -(-u.nphases // plan.stages) if u.nphases else 0
        if u.nphases and u.per_tick < max(1, need):
            rep.add("MLSL-A122",
                    f"unit advances {u.per_tick} phase(s)/tick but needs "
                    f"{need} to retire inside its {plan.stages}-stage "
                    "window: its carry stays live past the stage boundary",
                    anchor)
    _simulate_schedule(rep, plan)
    return rep


def _simulate_schedule(rep: Report, plan) -> None:
    """Integer replay of overlap.emit_schedule's tick loop: every unit must
    retire (all phases emitted exactly once) within the bounded tick budget,
    or its donated carry outlives the emission window (A120)."""
    inflight: List[list] = []   # [unit, phase_idx]
    retired: Set[int] = set()
    total_ticks = 0
    budget = len(plan.units) + sum(u.nphases for u in plan.units) + \
        plan.stages + 4

    def tick():
        nonlocal total_ticks
        total_ticks += 1
        for ent in inflight:
            u = ent[0]
            for _ in range(max(0, u.per_tick)):
                if ent[1] < u.nphases:
                    ent[1] += 1
        for ent in [e for e in inflight if e[1] >= e[0].nphases]:
            inflight.remove(ent)
            retired.add(ent[0].index)

    for u in plan.units:
        inflight.append([u, 0])
        tick()
    while inflight and total_ticks < budget:
        tick()
    for ent in inflight:
        rep.add("MLSL-A120",
                f"unit {'+'.join(ent[0].names)} never retires "
                f"({ent[1]}/{ent[0].nphases} phases after {total_ticks} "
                "ticks): its donated carry is read after the emission "
                "window", f"graph:overlap/{'+'.join(ent[0].names)}")


# ---------------------------------------------------------------------------
# Ring-kernel accounting and the kernel routes (A130/A131/A132)
# ---------------------------------------------------------------------------


def verify_hop_trace(events: List[tuple], *, slots: int, ndirs: int,
                     total_hops: int, anchor: str = "graph:pallas_ring",
                     report: Optional[Report] = None) -> Report:
    """Check one kernel build's semaphore accounting. ``events`` is the
    ordered ``('wait', dir, hop)`` / ``('free', dir, use_hop)`` trace (the
    reference's ``ops/ring_kernels.static_accounting`` mirrors its TPU
    kernel's slot_wait/slot_free emission; the port's CUDA kernels hold no
    slots, so none of them emits one). Invariants: every wait's matching free (of hop
    ``h - slots``) precedes it in program order — the peer's symmetric SPMD
    program emits that signal strictly before this rank can block on it —
    and every semaphore drains to zero at kernel exit (signals == waits per
    direction)."""
    rep = report if report is not None else Report("plan")
    if slots < 2:
        rep.add("MLSL-A131",
                f"{slots} comm slot(s): the ring needs a double buffer — "
                "hop h's send would overwrite the slot hop h-1 is still "
                "accumulating from", anchor)
    freed: List[Set[int]] = [set() for _ in range(ndirs)]
    waits = [0] * ndirs
    frees = [0] * ndirs
    for ev in events:
        kind, d, hop = ev[0], int(ev[1]), int(ev[2])
        if kind == "free":
            frees[d] += 1
            freed[d].add(hop)
        elif kind == "wait":
            waits[d] += 1
            need = hop - slots
            if need < 0 or need not in freed[d]:
                rep.add("MLSL-A130",
                        f"hop {hop} (dir {d}) waits on slot {hop % slots} "
                        f"but hop {need}'s free signal is not emitted "
                        "before it: the capacity semaphore deadlocks",
                        anchor)
    for d in range(ndirs):
        if waits[d] != frees[d]:
            rep.add("MLSL-A130",
                    f"dir {d}: {frees[d]} free signal(s) vs {waits[d]} "
                    "wait(s) — the capacity semaphore does not drain to "
                    "zero at kernel exit", anchor)
    return rep


#: the algorithms whose request launches a CUDA kernel of its own (B3, B4,
#: B3 over the snake cycle, B5, B6): their limits are checked at commit
KERNEL_ROUTES = ("pallas_ring", "pallas_ring2d", "pallas_rhd", "pallas_a2a")

#: warps a CTA of B6's int8 kernel (csrc/a2a_kernels.cu kWarpsPerCta) and
#: its launch limits: gridDim.y of the dense form, gridDim.x of the int8 one
_A2A_WARPS_PER_CTA = 8
_A2A_MAX_TRIPLES = 65535
_A2A_MAX_CTAS = 0x7FFFFFFF


def _check_kernel_route(rep: Report, req, cfg, anchor: str) -> None:
    """The launch limits of the CUDA kernel a request is routed to, each a
    refusal the kernel would raise as MLSLKernelError at its first launch:
    the group size (all four; ``MAX_GROUP``), the int8 block (B4 on a
    quantized ring request, B6 under ``pallas_a2a_quant``: a multiple of
    128, at most ``MAX_QUANT_BLOCK``) and B6's launch grid. A budget is
    reported as A132 and the block's alignment as A111, at error severity:
    unlike the reference's VMEM estimate, each is a certain failure."""
    from mlsl_tpu_torch.ops import a2a_kernels as a2a
    from mlsl_tpu_torch.ops import ring_kernels as rk

    d = req.desc
    g = 1 if d.group.is_self else int(d.group.size)
    if g <= 1:
        return
    sub = "pallas" if req.algo in ("pallas_ring", "pallas_ring2d") else req.algo
    at = f"{anchor}/{sub}"
    name = req.name or req.uid
    if d.group.topology.num_procs > 1 and d.group.spans:
        # the single-device kernels serve process-local groups only
        # (comm/algos.eligible); the selection never routes a spanning
        # group here, so a request that is must have been built by hand
        rep.add("MLSL-A132",
                f"'{name}' routes a group that spans processes to {req.algo}; its "
                "CUDA kernel reads every member on one device", at, severity=ERROR)
    if g > rk.MAX_GROUP:
        rep.add("MLSL-A132",
                f"'{name}' routes a group of {g} members to {req.algo}; its "
                f"CUDA kernel serves at most {rk.MAX_GROUP} and the launch is "
                "refused", at,
                severity=ERROR)
    quantized = False
    block = _eff_block(req, cfg)
    if req.algo == "pallas_ring":
        quantized = d.compression == CompressionType.QUANTIZATION
        max_block = rk.MAX_QUANT_BLOCK
    elif req.algo == "pallas_a2a":
        quantized = bool(getattr(cfg, "pallas_a2a_quant", True))
        block = int(getattr(cfg, "quant_block_elems", 256))
        max_block = a2a.MAX_QUANT_BLOCK
    if quantized:
        if block % 128:
            rep.add("MLSL-A111",
                    f"'{name}' takes int8 blocks of {block} elements on "
                    f"{req.algo}; the CUDA kernel's rows are multiples of "
                    "128 elements", at, severity=ERROR)
        if block > max_block:
            rep.add("MLSL-A132",
                    f"'{name}' takes int8 blocks of {block} elements on "
                    f"{req.algo}; the CUDA kernel keeps a block row in one "
                    f"warp's registers, at most {max_block} elements, and "
                    "refuses the launch", at, severity=ERROR)
    if req.algo == "pallas_a2a" and g <= rk.MAX_GROUP:
        instances = d.group.topology.world_size // g
        triples = instances * g * g
        for n in _chunk_counts(req):
            # an alltoall desc's count is the per-destination slice; the
            # kernel exchanges g of them
            if quantized:
                if block % 128 or block > max_block:
                    break
                _rc, _chunk, rows = a2a.geometry(g, g * int(n), block, True)
                ctas = -(-triples * rows // _A2A_WARPS_PER_CTA)
                if ctas > _A2A_MAX_CTAS:
                    rep.add("MLSL-A132",
                            f"'{name}' needs {ctas} CTAs of B6's int8 "
                            f"kernel; its launch grid takes at most "
                            f"{_A2A_MAX_CTAS}", at, severity=ERROR)
            elif triples > _A2A_MAX_TRIPLES:
                rep.add("MLSL-A132",
                        f"'{name}' exchanges {triples} (instance, sender, "
                        f"receiver) triples on B6's dense kernel; its launch "
                        f"grid takes at most {_A2A_MAX_TRIPLES}", at,
                        severity=ERROR)


# ---------------------------------------------------------------------------
# Elastic reshard coverage (A140/A141)
# ---------------------------------------------------------------------------


def verify_reshard(plan: dict, report: Optional[Report] = None) -> Report:
    """Prove an elastic reshard plan (mlsl_tpu_torch.elastic.build_reshard_plan)
    moves every ZeRO-1 shard element exactly once BEFORE it executes.

    Per layer: ``sources`` are (old-rank, lo, hi) intervals over the old
    padded flat layout that must tile ``[0, count)`` exactly — a gap loses
    optimizer state, an overlap double-applies it (A140) — and ``targets``
    are (new-rank, lo, hi) intervals that must tile ``[0, padded_new)`` in
    ownership-chunk geometry (k_new per rank; A141 when the target geometry
    disagrees with the survivor world's shard math). The coordinator runs
    this unconditionally (not gated by MLSL_VERIFY): a covering bug here
    silently corrupts the training state it exists to carry."""
    rep = report if report is not None else Report("plan")
    d_old = int(plan.get("d_old", 0))
    d_new = int(plan.get("d_new", 0))
    if d_old < 1 or d_new < 1:
        rep.add("MLSL-A141",
                f"reshard world sizes invalid: d_old={d_old}, d_new={d_new}",
                "graph:reshard")
        return rep
    for layer in plan.get("layers", ()):
        name = layer.get("name", "?")
        anchor = f"graph:reshard/{name}"
        count = int(layer["count"])
        padded_old = int(layer["padded_old"])
        padded_new = int(layer["padded_new"])
        k_old = int(layer["k_old"])
        k_new = int(layer["k_new"])
        if padded_old != k_old * d_old or padded_old < count:
            rep.add("MLSL-A141",
                    f"source geometry: padded_old {padded_old} != "
                    f"k_old {k_old} x d_old {d_old} (count {count})", anchor)
        if padded_new != k_new * d_new or padded_new < count:
            rep.add("MLSL-A141",
                    f"target geometry: padded_new {padded_new} != "
                    f"k_new {k_new} x d_new {d_new} (count {count}) — the "
                    "survivor world's ownership chunks cannot hold this "
                    "layer", anchor)
        # -- A140: sources tile [0, count) exactly once ---------------------
        src = sorted(
            (int(lo), int(hi), int(r)) for r, lo, hi in layer["sources"]
        )
        pos = 0
        for lo, hi, r in src:
            if lo < pos:
                rep.add("MLSL-A140",
                        f"source interval [{lo}, {hi}) of old rank {r} "
                        f"overlaps coverage up to {pos}: an element would "
                        "be applied twice", anchor)
            elif lo > pos:
                rep.add("MLSL-A140",
                        f"coverage gap [{pos}, {lo}) before old rank {r}'s "
                        "interval: those shard elements would be dropped",
                        anchor)
            if not (0 <= lo <= hi <= padded_old) or (
                    hi > lo and (k_old < 1  # no chunk can own an interval
                                 or lo // k_old != (hi - 1) // k_old
                                 or lo // k_old != r)):
                rep.add("MLSL-A140",
                        f"source interval [{lo}, {hi}) does not lie inside "
                        f"old rank {r}'s owned chunk "
                        f"[{r * k_old}, {(r + 1) * k_old})", anchor)
            pos = max(pos, hi)
        if pos != count:
            rep.add("MLSL-A140",
                    f"sources cover [0, {pos}) but the layer holds {count} "
                    "real elements", anchor)
        # -- targets tile [0, padded_new) in ownership-chunk geometry -------
        tgt = sorted(
            (int(lo), int(hi), int(r)) for r, lo, hi in layer["targets"]
        )
        pos = 0
        for i, (lo, hi, r) in enumerate(tgt):
            if lo != pos or r != i or hi - lo != k_new:
                rep.add("MLSL-A141",
                        f"target interval [{lo}, {hi}) of new rank {r} is "
                        f"not the ownership chunk "
                        f"[{i * k_new}, {(i + 1) * k_new})", anchor)
            pos = hi
        if pos != padded_new or len(tgt) != d_new:
            rep.add("MLSL-A141",
                    f"targets cover [0, {pos}) across {len(tgt)} rank(s); "
                    f"the survivor world needs [0, {padded_new}) across "
                    f"{d_new}", anchor)
    return rep


# ---------------------------------------------------------------------------
# The commit hook
# ---------------------------------------------------------------------------


def enforce(rep: Report, cfg, what: str, t0: Optional[float] = None) -> Report:
    """The one severity gate every MLSL_VERIFY entry point shares: record
    the verdict (stats line, trace instants, supervisor.status 'analysis'
    key), log each finding, then apply ``MLSL_VERIFY_SEVERITY`` — ``error``
    (default) raises MLSLError naming every error-severity code; ``warn``
    logs and continues."""
    record(rep, time.perf_counter() - t0 if t0 is not None else 0.0)
    for d in rep.diagnostics:
        log_warning("MLSL_VERIFY: %s", d.format())
    if rep.errors and getattr(cfg, "verify_severity", "error") == "error":
        raise MLSLError(
            f"MLSL_VERIFY rejected the {what}: "
            + "; ".join(d.format() for d in rep.errors)
            + " (set MLSL_VERIFY_SEVERITY=warn to log instead)"
        )
    return rep


def run_commit_verify(session) -> Report:
    """Session.commit's MLSL_VERIFY=1 entry point."""
    cfg = session.env.config
    t0 = time.perf_counter()
    return enforce(verify_session(session, cfg), cfg,
                   "collective plan at commit", t0)
