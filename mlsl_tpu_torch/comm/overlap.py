"""The compiled overlap engine and the staged ZeRO-1 update.

Counterpart of ``mlsl_tpu.comm.overlap``. The host per-layer path
(models/train.py ``_sync_and_update``) starts one request per layer and waits
for each; this module holds the schedule of the whole gradient sync instead:

- ``OverlapUnit``: one in-graph reduction unit, a single layer or a bucket of
  small consecutive uncompressed layers coalesced with the host buckets' own
  packing policy (core/bucketing.pack_by_size). A dense unit runs the staged
  form of its algorithm (``algos.inline_plan``: ``lax`` one phase, ``rhd`` and
  ``ring2d`` the phases of their schedules, the kernel algorithms one launch
  of B3 or B5); a quantized unit runs the host request's own body
  (``quant_ring.inline_body``: the composed ring with B1 on every hop, or B1
  and the fused int8 ring B4 where the selection table picks
  ``pallas_ring``), its error-feedback residual carried from step to step.
  Where the table routes a quantized unit to ``hier`` (a tiered group), the
  unit is staged: the intra-tier reduce-scatter, the compressed DCN hop as
  its own phase, the intra-tier all-gather (``hier.quant_steps``), the
  residual threaded through the carry.
- ``build_plan`` orders the units newest-gradient-first and gives each unit
  ``per_tick = ceil(nphases / stages)`` (``MLSL_OVERLAP_STAGES``);
  ``emit_schedule`` emits them: each unit start is followed by a tick that
  advances every unit in flight by its ``per_tick`` phases, and a unit that
  has run all its phases retires (``on_ready``: the per-layer update).
- ``OverlapEngine``: the trainer's compiled step -- every virtual rank's
  forward and backward, the staged schedule and the per-layer SGD -- and
  the split program ``step_accum`` uses. On a CUDA device each is captured
  as one ``torch.cuda.CUDAGraph`` and replayed every step, the counterpart of
  the JAX package's single-dispatch executable; on the CPU the same code
  runs eagerly.
- ``_Zero1Unit`` / ``build_zero1_update``: the staged ZeRO-1 update
  (reduce-scatter, owned-shard SGD, all-gather; :489-689), scheduled by the
  same tick/retire loop (``_run_staged``). With the fused ring selected both
  of its wire directions are single launches, B3 and B3-AG.

PyTorch runs eagerly, so the schedule is the order in which the phases are
launched: on the card they queue on one stream in that order, in a captured
graph as in an eager call. That order is the pin the JAX program needs
``lax.optimization_barrier`` (``_pin``) for; nothing here corresponds to it.
The step passes the ``collective.dispatch`` chaos site once, on the host
before the replay ("the whole comm segment is ONE dispatch", overlap.py:
834-862 of the JAX package), and with the tracer armed is one
``step.overlap`` span of host time. Nothing inside the captured graph passes
a site (a capture runs in ``chaos.quiet()``), and the units' collectives are
the bare staged phases. With ``MLSL_VERIFY=1``, ``engine_for_trainer``
verifies the plan before it builds the engine (analysis/plan.py
``verify_overlap_plan``), as overlap.py:907-924 of the JAX package does.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from mlsl_tpu_torch import chaos
from mlsl_tpu_torch.comm import algos, collectives, quant_ring
from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.core import graph_capture, stats
from mlsl_tpu_torch.log import MLSLError, log_debug, mlsl_assert
from mlsl_tpu_torch.obs import tracer as obs
from mlsl_tpu_torch.types import CompressionType, DataType, ReductionType

DEFAULT_STAGES = 2


# -- the plan: what is reduced, how, in what order -------------------------------


class OverlapUnit:
    """One reduction unit over distributed buffers (R, D, S, M, n): a single
    layer, or a bucket of consecutive uncompressed layers reduced as one
    concatenated payload (overlap.py:71-164)."""

    def __init__(self, names: Sequence[str], counts: Sequence[int],
                 compression: CompressionType, algo: str, group: ProcessGroup, *,
                 index: int, block: int, config=None, plain: bool = False):
        self.names = tuple(names)
        self.counts = tuple(int(c) for c in counts)
        self.total = sum(self.counts)
        self.compression = compression
        self.algo = algo
        self.index = index
        self.key: Optional[str] = None    # residual key (quantized units)
        self.err_len = 0
        self.per_tick = 1                 # phases advanced per tick (set by the plan)
        self._quant_staged = False
        if compression == CompressionType.QUANTIZATION and algo == "hier":
            # the table routed the compressed wire through the two tiers:
            # staged phases (overlap.py:92-111 of the JAX package)
            from mlsl_tpu_torch.comm.algos import hier

            self._qprep, self._phases, self._qfinish, self.err_len = hier.quant_steps(
                group, self.total, block, codec=getattr(config, "hier_dcn_codec", None),
                topk_ratio=float(getattr(config, "topk_ratio", 0.01)))
            self._quant_staged = True
            self.key = f"q{index}/{self.names[0]}"
            self.nphases = len(self._phases)
        elif compression == CompressionType.QUANTIZATION:
            self._body, self.err_len = quant_ring.inline_body(
                "allreduce", group, self.total, block, config=config, plain=plain)
            self.key = f"q{index}/{self.names[0]}"
            self.nphases = 1
            # attribution names the wire family, as the host request's .algo
            fused = config is not None and quant_ring.use_pallas_for(
                "allreduce", group, self.total * 4, config)
            self.algo = "pallas_ring" if fused else "quant_ring"
        else:
            self._prep, self._phases, self._finish = algos.inline_plan(
                "allreduce", group, algo, self.total, op=ReductionType.SUM, config=config,
                plain=plain)
            # 0 on a degenerate group: the unit retires at its first tick
            self.nphases = len(self._phases)

    def prep(self, flat: Dict[str, torch.Tensor], err: Optional[torch.Tensor]):
        x = (torch.cat([flat[n] for n in self.names], dim=-1) if len(self.names) > 1
             else flat[self.names[0]])
        if self._quant_staged:
            return self._qprep(x, err)
        if self.compression == CompressionType.QUANTIZATION:
            return x, err
        return self._prep(x)

    def advance(self, carry, i: int):
        if self.compression == CompressionType.QUANTIZATION and not self._quant_staged:
            return self._body(*carry)
        return self._phases[i](carry)

    def finish(self, carry) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
        """-> ({member name: its reduced buffer}, the new residual or None)."""
        if self._quant_staged:
            out, new_err = self._qfinish(carry)
        elif self.compression == CompressionType.QUANTIZATION:
            out, new_err = carry
        else:
            out, new_err = self._finish(carry), None
        parts, off = {}, 0
        for n, c in zip(self.names, self.counts):
            parts[n] = out[..., off:off + c] if len(self.names) > 1 else out
            off += c
        return parts, new_err


class OverlapPlan:
    """The units in newest-gradient-first start order, with the bookkeeping
    the counters read (overlap.py:167-211)."""

    def __init__(self, group: ProcessGroup, units: List[OverlapUnit], stages: int,
                 data_type: DataType = DataType.FLOAT):
        self.group = group
        self.units = units
        self.stages = max(int(stages), 1)
        self.data_type = data_type
        for u in units:
            u.per_tick = max(1, -(-u.nphases // self.stages))
        self.err_lens = {u.key: u.err_len for u in units if u.key}
        self.total_bytes = sum(u.total for u in units) * 4
        self.rounds = sum(u.nphases for u in units)
        breakdown: Dict[Tuple[str, str], int] = {}
        for u in units:
            k = ("allreduce", u.algo)
            breakdown[k] = breakdown.get(k, 0) + 1
        self.breakdown = breakdown

    @property
    def quant_units(self) -> int:
        return sum(1 for u in self.units if u.key)

    def algos_summary(self) -> str:
        return ",".join(f"{algo}:{n}" for (_, algo), n in sorted(self.breakdown.items()))

    def describe(self) -> List[str]:
        """One descriptor a unit, in CommRequest.describe()'s grammar."""
        from mlsl_tpu_torch.comm.request import in_graph_descriptor

        return [in_graph_descriptor("allreduce", "+".join(u.names), u.algo, u.total,
                                    self.data_type, self.group)
                for u in self.units]


def _unit_algo(group: ProcessGroup, payload: int, compression: CompressionType, config,
               forced: Optional[str]) -> str:
    """A dense unit's algorithm: ``forced``, else the selection table, and
    the baseline where the choice cannot serve the group in stages. A
    compressed unit carries its own wire family (OverlapUnit), except that a
    forced or tuned ``hier`` stages a quantized unit over the two tiers when
    the group qualifies (overlap.py:223-232 of the JAX package)."""
    if compression != CompressionType.NONE:
        if compression == CompressionType.QUANTIZATION and config is not None:
            name = forced or algos.select("allreduce", group, payload, compression, config,
                                          op=ReductionType.SUM)
            if name == "hier" and algos._quant_hier_eligible("allreduce", group, config):
                return "hier"
        return algos.DEFAULT
    name = forced or algos.select("allreduce", group, payload, compression, config,
                                  op=ReductionType.SUM)
    if name != algos.DEFAULT and not algos.inline_eligible(name, "allreduce", group,
                                                           ReductionType.SUM):
        log_debug("overlap: algorithm %s cannot serve group %s in stages; falling back "
                  "to %s", name, algos.group_shape(group), algos.DEFAULT)
        return algos.DEFAULT
    return name


def build_plan(group: ProcessGroup, layers: Sequence[Tuple[str, int, CompressionType]],
               config, *, stages: Optional[int] = None, bucket_mb: Optional[int] = None,
               block: Optional[int] = None, algo: Optional[str] = None,
               plain: bool = False) -> OverlapPlan:
    """The overlap schedule of ``layers`` (FORWARD order, as a trainer
    registers them: (name, flat element count, compression)), overlap.py:248-322.
    Units start newest-gradient-first, with small uncompressed neighbours
    coalesced under ``bucket_mb`` by the host buckets' packing policy.
    ``algo`` forces every dense unit's algorithm; None uses the selection
    table. ``plain`` runs the kernels' plain versions on any device."""
    from mlsl_tpu_torch.core.bucketing import pack_by_size

    mlsl_assert(len(layers) > 0, "overlap plan needs at least one layer")
    for _, _, comp in layers:
        mlsl_assert(comp in (CompressionType.NONE, CompressionType.QUANTIZATION),
                    "compiled overlap supports NONE/QUANTIZATION compression (got %s -- "
                    "TOPK rides the host path)", comp)
    stages = int(stages if stages is not None
                 else getattr(config, "overlap_stages", DEFAULT_STAGES))
    bucket_mb = int(bucket_mb if bucket_mb is not None
                    else getattr(config, "grad_bucket_mb", 0))
    block = int(block if block is not None else getattr(config, "quant_block_elems", 256))

    # bucket membership: the host packing policy over the uncompressed layers
    member_of: Dict[str, int] = {}
    dense = [(n, c) for n, c, comp in layers if comp == CompressionType.NONE]
    if bucket_mb > 0 and not group.is_self and group.size > 1:
        for gi, members in enumerate(pack_by_size(dense, bucket_mb * 1024 * 1024,
                                                  lambda e: e[1] * 4)):
            for n, _ in members:
                member_of[n] = gi
    counts = {n: c for n, c, _ in layers}
    comps = {n: comp for n, _, comp in layers}
    newest_first = [n for n, _, _ in reversed(list(layers))]

    def unit(names, comp):
        total = sum(counts[n] for n in names)
        return OverlapUnit(names, [counts[n] for n in names], comp,
                           _unit_algo(group, total * 4, comp, config, algo), group,
                           index=len(units), block=block, config=config, plain=plain)

    units: List[OverlapUnit] = []
    emitted: set = set()
    for name in newest_first:
        if name in emitted:
            continue
        if name in member_of:
            members = tuple(n for n in newest_first if member_of.get(n) == member_of[name])
            emitted.update(members)
            units.append(unit(members, CompressionType.NONE))
            continue
        emitted.add(name)
        units.append(unit((name,), comps[name]))
    return OverlapPlan(group, units, stages)


# -- the staged scheduler ---------------------------------------------------------


def _run_staged(starts: Iterable[Tuple[object, object]], retire: Callable) -> None:
    """The tick/retire loop both staged schedules share (overlap.py:374-404
    and :650-670). ``starts`` yields (unit, carry) in start order and is
    read lazily, one unit per start; each start is followed by a tick that
    advances every unit in flight by its ``per_tick`` phases, then retires
    (``retire(unit, carry)``) the units that have run all of theirs."""
    inflight: List[list] = []     # [unit, carry, next phase]

    def tick() -> None:
        for ent in inflight:
            u = ent[0]
            for _ in range(u.per_tick):
                if ent[2] < u.nphases:
                    ent[1] = u.advance(ent[1], ent[2])
                    ent[2] += 1
        for ent in [e for e in inflight if e[2] >= e[0].nphases]:
            inflight.remove(ent)
            retire(ent[0], ent[1])

    for u, carry in starts:
        inflight.append([u, carry, 0])
        tick()
    while inflight:
        tick()


def emit_schedule(plan: OverlapPlan, flat: Dict[str, torch.Tensor],
                  residuals: Dict[str, torch.Tensor],
                  on_ready: Optional[Callable[[str, torch.Tensor], None]] = None
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Emit the staged schedule (overlap.py:353-404). ``flat``: each
    layer's gradient buffer (R, D, S, M, count); ``residuals``: each
    quantized unit's residual (R, D, S, M, err_len). ``on_ready(name,
    reduced)`` runs as each unit retires. -> (reduced buffers, new
    residuals)."""
    reduced: Dict[str, torch.Tensor] = {}
    new_res: Dict[str, torch.Tensor] = {}

    def retire(unit: OverlapUnit, carry) -> None:
        parts, new_err = unit.finish(carry)
        if new_err is not None:
            new_res[unit.key] = new_err
        for n, r in parts.items():
            reduced[n] = r
            if on_ready is not None:
                on_ready(n, r)

    _run_staged(((u, u.prep(flat, residuals.get(u.key))) for u in plan.units), retire)
    return reduced, new_res


# -- the standalone multi-tensor reduce ---------------------------------------------


def build_multi_reduce(group: ProcessGroup, counts: Sequence[int], *,
                       compression: CompressionType = CompressionType.NONE,
                       algo: Optional[str] = None, config=None, stages: Optional[int] = None,
                       bucket_mb: int = 0, block: int = 256,
                       plain: bool = False) -> Tuple[Callable, OverlapPlan]:
    """The staged multi-tensor reduction on its own: -> (fn, plan)
    (overlap.py:412-470). ``fn(bufs[, residuals]) -> reduced list[, new
    residuals]`` over (R, D, S, M, count) buffers, newest-first: the last
    buffer starts first, as in a backward pass. A quantized plan starts from
    zero residuals when none are given. ``plain`` runs the kernels' plain
    versions (the card's parity check)."""
    refuse_spanning(group, "build_multi_reduce")
    layers = [(f"t{i}", int(c), compression) for i, c in enumerate(counts)]
    plan = build_plan(group, layers, config, stages=stages, bucket_mb=bucket_mb, block=block,
                      algo=algo, plain=plain)
    names = [n for n, _, _ in layers]
    res_keys = sorted(plan.err_lens)

    def fn(bufs, residuals: Optional[dict] = None):
        mlsl_assert(len(bufs) == len(names), "multi reduce takes %d buffers, got %d",
                    len(names), len(bufs))
        if residuals is None and res_keys:
            residuals = zero_residuals(plan, group.topology, bufs[0].device)
        reduced, new_res = emit_schedule(plan, dict(zip(names, bufs)), residuals or {})
        outs = [reduced[n] for n in names]
        return (outs, new_res) if res_keys else outs

    return fn, plan


def zero_residuals(plan: OverlapPlan, topo, device=None) -> Dict[str, torch.Tensor]:
    """Zero error-feedback residuals for the plan's quantized units: the
    state a host request's first round starts from."""
    return {k: torch.zeros((*topo.grid_shape, el), dtype=torch.float32, device=device)
            for k, el in plan.err_lens.items()}


# -- the staged ZeRO-1 update -------------------------------------------------------


class _Zero1Unit:
    """One layer's ZeRO-1 exchange as staged phases over distributed buffers
    (R, D, S, M, n). The carry of a wire phase is a buffer; ``pos`` (W,)
    holds each world rank's position in ``group``, which picks its owned
    shard."""

    def __init__(self, name: str, count: int, algo: str, group: ProcessGroup, *,
                 lr: float, denom: float, config=None, plain: bool = False):
        self.name = name
        self.count = int(count)
        self.algo = algo
        self.group = group
        g = max(group.size, 1)
        self.padded = -(-self.count // g) * g
        self.shard = self.padded // g
        self._lr, self._denom = float(lr), float(denom)
        self._degenerate = group.is_self or group.size <= 1
        self.per_tick = 1
        if self._degenerate:
            self.nphases = 1
            return
        self._rs_prep, self._rs_phases, self._rs_finish = algos.inline_plan(
            "reduce_scatter", group, algo, self.padded, op=ReductionType.SUM,
            recv_count=self.shard, config=config, plain=plain,
        )
        if algo in ("pallas_ring", "pallas_ring2d"):
            # the gather rides the same kernel family as the reduce phase:
            # one B3-AG launch over the same ring or snake cycle
            from mlsl_tpu_torch.ops import ring_kernels

            self._ag_prep, self._ag_phases, self._ag_finish = ring_kernels.steps(
                "all_gather", group, self.shard, snake=algo == "pallas_ring2d", plain=plain)
        else:
            ident = lambda buf: buf   # noqa: E731
            self._ag_prep, self._ag_finish = ident, ident
            self._ag_phases = [collectives.build_raw("allgather", group)]
        # reduce phases + the owned-shard update (its own stage: the boundary
        # between the two wire directions) + gather phases
        self.nphases = len(self._rs_phases) + 1 + len(self._ag_phases)

    def prep(self, p: torch.Tensor, g: torch.Tensor, pos: torch.Tensor) -> dict:
        pad = self.padded - self.count
        if pad:
            p = torch.nn.functional.pad(p, (0, pad))
            g = torch.nn.functional.pad(g, (0, pad))
        if self._degenerate:
            return {"p": p, "g": g}
        return {"p": p, "carry": self._rs_prep(g), "pos": pos}

    def advance(self, state: dict, i: int) -> dict:
        if self._degenerate:
            state["p"] = state["p"] - self._lr * (state["g"] / self._denom)
            return state
        n_rs = len(self._rs_phases)
        if i < n_rs:
            state["carry"] = self._rs_phases[i](state["carry"])
        elif i == n_rs:
            # owned-shard update: each member updates ONLY its 1/G slice of
            # the parameter; the others' slices arrive through the gather
            gshard = self._rs_finish(state["carry"]) / self._denom
            p = state["p"]
            grid = p.shape[:-1]
            rows = p.reshape(-1, self.padded)
            idx = state["pos"][:, None] * self.shard + torch.arange(self.shard,
                                                                     device=p.device)
            owned = torch.gather(rows, 1, idx).reshape(*grid, self.shard)
            state["carry"] = self._ag_prep(owned - self._lr * gshard)
        else:
            state["carry"] = self._ag_phases[i - n_rs - 1](state["carry"])
        return state

    def finish(self, state: dict) -> torch.Tensor:
        if self._degenerate:
            return state["p"][..., :self.count]
        return self._ag_finish(state["carry"])[..., :self.count]


def _zero1_algo(group: ProcessGroup, payload: int, config, forced: Optional[str]) -> str:
    """The unit's reduce-scatter algorithm: forced > selection table, and the
    baseline where the choice cannot serve the group in stages."""
    name = forced or algos.select("reduce_scatter", group, payload, CompressionType.NONE,
                                  config, op=ReductionType.SUM)
    if name and name != algos.DEFAULT and not algos.inline_eligible(
            name, "reduce_scatter", group, ReductionType.SUM):
        log_debug("zero1: algorithm %s cannot serve group %s in stages; falling back to %s",
                  name, algos.group_shape(group), algos.DEFAULT)
        return algos.DEFAULT
    return name or algos.DEFAULT


def build_zero1_update(group: ProcessGroup, counts: Sequence[int], *, lr: float,
                       denom: float = 1.0, algo: Optional[str] = None, config=None,
                       stages: Optional[int] = None,
                       plain: bool = False) -> Tuple[Callable, List[_Zero1Unit]]:
    """The staged ZeRO-1 update over ``group``: -> (fn, units).

    ``fn(param_bufs, grad_bufs) -> new param bufs``, one (R, D, S, M, count)
    buffer per layer. Each layer is one ``_Zero1Unit``: reduce-scatter the
    gradient, update the owned 1/G shard with SGD (``p -= lr * g / denom``),
    all-gather the updated parameter. Units start newest-first (the reversed
    list first, as a backward pass produces them) and each start advances
    every unit in flight by its ``per_tick`` phases. ``algo`` forces the
    reduce-scatter algorithm; ``stages`` defaults to
    ``config.overlap_stages``; ``plain`` runs the kernel algorithms' plain
    versions (the card's parity check)."""
    refuse_spanning(group, "build_zero1_update")
    mlsl_assert(len(counts) > 0, "zero1 plan needs at least one layer")
    stages = int(stages if stages is not None
                 else getattr(config, "overlap_stages", DEFAULT_STAGES))
    units = [
        _Zero1Unit(f"p{i}", int(c), _zero1_algo(group, int(c) * 4, config, algo), group,
                   lr=lr, denom=denom, config=config, plain=plain)
        for i, c in enumerate(counts)
    ]
    for u in units:
        u.per_tick = max(1, -(-u.nphases // max(stages, 1)))
    topo = group.topology
    positions = [0 if group.is_self else group.group_idx_of(w)
                 for w in range(topo.world_size)]
    pos_on = {}

    def fn(param_bufs, grad_bufs):
        mlsl_assert(len(param_bufs) == len(units) and len(grad_bufs) == len(units),
                    "zero1 update takes %d parameter and gradient buffers", len(units))
        dev = param_bufs[0].device
        pos = pos_on.get(dev)
        if pos is None:
            pos = pos_on[dev] = torch.tensor(positions, dtype=torch.long, device=dev)
        out = {}

        def retire(unit, state) -> None:
            out[unit.name] = unit.finish(state)

        _run_staged(((units[i], units[i].prep(param_bufs[i], grad_bufs[i], pos))
                     for i in reversed(range(len(units)))), retire)
        return [out[u.name] for u in units]

    return fn, units


# -- the trainer's engine -------------------------------------------------------------


class OverlapEngine:
    """The trainer's compiled overlap step (overlap.py:692-881): owns the
    plan, the step's programs and the error-feedback residuals.

    - fused, ``step(batch)``: every virtual rank's forward and backward
      (the trainer's ``_local_grads``, the host path's own core), the staged
      schedule, and each layer's SGD as its unit retires -- or, under
      ``clip_global_norm``, the host path's clipped update after every unit;
    - split, ``step(None, grads=...)``: the schedule and the update from
      gradients the caller accumulated (``step_accum``).

    On a CUDA device each program is captured as one CUDA graph at its first
    use (``precompile`` captures the fused one ahead) and replayed every step:
    the batch or the gradients are copied into the graph's static inputs,
    parameters and residuals are updated in place, and the loss is read from
    the graph's static output. The capture (core/graph_capture.py) runs
    one eager warm-up first; parameters, module buffers, residuals and the
    trainer's step count are restored afterwards, so a capture leaves the
    trainer as it was. A capture that fails raises MLSLError; the engine
    never runs eagerly on the card. On the CPU the same programs run eagerly and no graph exists.
    ``capture_launches`` holds each graph's kernel launches (the wrappers
    count a launch when it is recorded, not when it is replayed) and
    ``capture_s`` each capture's seconds."""

    def __init__(self, trainer, plan: OverlapPlan):
        self.plan = plan
        self._trainer = trainer
        self.residuals = zero_residuals(plan, trainer.dist.topology, trainer.device)
        self.graphs: Dict[str, graph_capture.Captured] = {}
        self.capture_s: Dict[str, float] = {}
        self.capture_launches: Dict[str, Dict[str, int]] = {}
        log_debug("compiled overlap plan: %d units (%s), stages=%d, %d phases",
                  len(plan.units), plan.algos_summary(), plan.stages, plan.rounds)

    # -- the programs ----------------------------------------------------------

    def _reduce_and_update(self, flat: Dict[str, torch.Tensor]) -> None:
        tr = self._trainer
        clip = tr.clip_global_norm is not None

        def apply(name: str, reduced: torch.Tensor) -> None:
            tr._sgd_layer(name, reduced[0, 0, 0, 0])

        # each layer updates as its unit retires, except under the clip, whose
        # scale needs every reduced gradient first
        reduced, new_res = emit_schedule(self.plan, flat, self.residuals,
                                         None if clip else apply)
        for k, v in new_res.items():
            self.residuals[k].copy_(v)
        if clip:
            tr._replicated_update({n: reduced[n][0, 0, 0, 0] for n in tr.layers},
                                  tr.data_size)

    def _fused(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss, flat = self._trainer._local_grads((x, y))
        self._reduce_and_update(flat)
        return loss

    def _sync(self, *grads: torch.Tensor) -> None:
        self._reduce_and_update(dict(zip(self._trainer.layers, grads)))

    # -- the step --------------------------------------------------------------

    def step(self, batch, *, grads: Optional[Dict[str, torch.Tensor]] = None):
        """One compiled-overlap step: the fused program on ``batch``, or with
        ``grads`` the split one. -> the fused step's loss (R, D, S, M, 1)."""
        tr = self._trainer
        trace = obs._tracer
        t0 = trace.now() if trace is not None else 0
        if chaos._plans:
            # the whole comm segment is ONE dispatch: an armed budget fires
            # at the step boundary it targets, before the replay
            chaos.inject("collective.dispatch", kind="overlap")
        split = grads is not None
        key, fn, args = (("sync", self._sync, [grads[n] for n in tr.layers]) if split
                         else ("step", self._fused, list(batch)))
        if tr.device.type == "cuda":
            g = self.graphs.get(key)
            if g is None or not g.fits(args):
                g = self._prepare(key, fn, args)
            out = g.replay(args)
            out = None if out is None else out.clone()
        else:
            out = fn(*args)
        plan = self.plan
        stats.record_overlap_step(len(plan.units), plan.rounds, plan.total_bytes, split=split,
                                  breakdown=plan.breakdown)
        if trace is not None:
            trace.complete("step.overlap", "step", t0, step=tr._step_no,
                           layers=len(tr.layers), units=len(plan.units), stages=plan.stages,
                           phases=plan.rounds, algos=plan.algos_summary(),
                           quant_units=plan.quant_units, bytes=plan.total_bytes, split=split)
        return out

    def precompile(self, batch) -> None:
        """Ahead of the first step: on a CUDA device capture the fused
        step's graph; on the CPU run the step once. The trainer stands as it
        was afterwards."""
        self._prepare("step", self._fused, list(batch))

    # -- capture ---------------------------------------------------------------

    def _state(self) -> List[torch.Tensor]:
        model = self._trainer.model
        return [*model.parameters(), *model.buffers(), *self.residuals.values()]

    def _prepare(self, key: str, fn: Callable,
                 args: List[torch.Tensor]) -> Optional[graph_capture.Captured]:
        """Capture ``fn`` on a CUDA device (the trainer's state restored
        after its warm-up and its recording); on the CPU run it once on
        copies of ``args`` and restore the state. -> the graph, or None on
        the CPU."""
        tr = self._trainer
        step_no = tr._step_no
        try:
            if tr.device.type != "cuda":
                with graph_capture.restored(self._state()):
                    fn(*[a.detach().clone() for a in args])
                return None
            g = graph_capture.capture(fn, args, self._state(),
                                      f"the compiled overlap {key} program")
            self.graphs[key] = g
            self.capture_s[key] = g.seconds
            self.capture_launches[key] = g.launches
            return g
        finally:
            tr._step_no = step_no


def refuse_spanning(group: ProcessGroup, what: str) -> None:
    """A compiled form over a group that spans processes is A.8b: a gloo
    hop cannot be captured in a CUDA graph."""
    if group.topology.num_procs > 1 and group.spans:
        raise MLSLError(f"{what} over a group that spans processes is ROADMAP A.8b")


def engine_for_trainer(trainer, config) -> Optional[OverlapEngine]:
    """The trainer's OverlapEngine, or None where its graph rides the host
    path (overlap.py:884-925): a custom codec keeps its host wire, TOPK its
    sparse requests, a color group its flat-mesh programs. A gradient group
    that spans processes raises (A.8b)."""
    group = trainer.dist.grad_group
    refuse_spanning(group, "the compiled overlap engine")
    if getattr(config, "custom_codec", None) is not None:
        log_debug("overlap: custom codec rides the host path")
        return None
    if group.colors is not None:
        log_debug("overlap: color-group gradients ride the host path")
        return None
    layers = [(name, trainer.padded_counts[name], trainer._pset(name).compression)
              for name in trainer.layers]
    if any(comp == CompressionType.TOPK for _, _, comp in layers):
        log_debug("overlap: TOPK compression rides the host path")
        return None
    plan = build_plan(group, layers, config)
    if getattr(config, "verify", False):
        # MLSL_VERIFY=1 covers the compiled engine's plan too: its residual
        # carry and stage geometry are fixed here, before the step is
        # captured (analysis/plan.py A112/A120/A122; the same severity gate
        # as Session.commit)
        from mlsl_tpu_torch.analysis import plan as plan_verifier

        t0 = time.perf_counter()
        plan_verifier.enforce(
            plan_verifier.verify_overlap_plan(
                plan, block=getattr(config, "quant_block_elems", None)
                if plan.quant_units else None),
            config, "compiled-overlap plan", t0)
    return OverlapEngine(trainer, plan)
