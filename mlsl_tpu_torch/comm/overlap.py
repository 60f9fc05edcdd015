"""The staged ZeRO-1 update: reduce-scatter, owned-shard update, all-gather.

Counterpart of the ZeRO-1 part of ``mlsl_tpu.comm.overlap`` (:489-689). Each
layer is one ``_Zero1Unit`` whose phases are the selected algorithm's
reduce-scatter phases (``algos.inline_plan``), the owned-shard SGD update
``owned - lr * (gshard / denom)``, then the all-gather phases that put the
updated parameter back together on every member. With the fused ring selected
(``pallas_ring`` / ``pallas_ring2d``) both wire directions are single kernel
launches: B3 in its reduce_scatter mode and B3-AG (``ops.ring_kernels``,
``kind='all_gather'``) over the same ring or snake cycle.

``build_zero1_update`` schedules the units newest-first, as a backward pass
produces their gradients: each unit start is followed by a tick that advances
every unit in flight by ``per_tick = ceil(nphases / stages)`` phases, so a
unit's phases spread over the next ``stages`` unit starts
(``MLSL_OVERLAP_STAGES``). PyTorch runs eagerly, so the schedule is the order
in which the phases are issued; on the card they queue on one stream in that
order, which is what the XLA optimisation barrier (``_pin``) enforces in the
JAX program. The compiled overlap engine around it (``OverlapUnit``,
``build_plan``, ``build_multi_reduce``, ``OverlapEngine``) is not ported.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from mlsl_tpu_torch.comm import algos, collectives
from mlsl_tpu_torch.comm.mesh import ProcessGroup
from mlsl_tpu_torch.log import log_debug, mlsl_assert
from mlsl_tpu_torch.types import CompressionType, ReductionType

DEFAULT_STAGES = 2


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
            self._ag_phases = [collectives.build_collective("allgather", group)]
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
        inflight: List[list] = []     # [unit, state, next phase]
        out = {}

        def tick() -> None:
            for ent in inflight:
                u = ent[0]
                for _ in range(u.per_tick):
                    if ent[2] < u.nphases:
                        ent[1] = u.advance(ent[1], ent[2])
                        ent[2] += 1
            for ent in [e for e in inflight if e[2] >= e[0].nphases]:
                inflight.remove(ent)
                out[ent[0].name] = ent[0].finish(ent[1])

        for i in reversed(range(len(units))):
            inflight.append([units[i], units[i].prep(param_bufs[i], grad_bufs[i], pos), 0])
            tick()
        while inflight:
            tick()
        return [out[u.name] for u in units]

    return fn, units
