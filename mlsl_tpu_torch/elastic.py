"""Elastic mesh over virtual ranks: survive a loss by rescaling, not restarting.

Counterpart of ``mlsl_tpu.elastic``. On a ``DEVICE_LOSS`` fault the
coordinator

1. **shrinks**: re-derives the world among the survivor ranks
   (``comm/mesh.survivor_devices``: a flat world sheds exactly the lost
   ranks, a tiered one the whole tier), re-initializes the Environment over
   them and carries the training state across LIVE: the parameters and the
   replicated optimizer state copied, ZeRO-1's owned state drained by the
   all-gather (``optim.gather_owned_full``: B3-AG on the card where the table
   routes the group to the fused ring) and re-partitioned onto the survivor
   world's ownership chunks (``optim.place_owned_vector``), under a plan the
   analysis pass verifies first, unconditionally
   (``analysis/plan.verify_reshard``, MLSL-A140/A141). No checkpoint restore.
2. **continues** at the very step the loss interrupted: that step never
   applied its update.
3. **grows** when capacity returns (``announce_return()`` or the
   ``MLSL_ELASTIC_GROW_AFTER`` timer): the full world is rebuilt, the state
   re-sharded back, and the returning ranks are admitted only after the
   sentinel's fingerprint audit passes; a failing audit re-syncs the
   rejoiner from a survivor's copy and re-audits
   (``MLSL_ELASTIC_ADMIT_RETRIES``); persistent divergence abandons the grow
   and the run stays shrunk.

A world here is a set of virtual ranks on the same card, so a survivor world
is a smaller set of them: the registry holds the survivors' rank ids in the
full world's numbering, ``Environment.init`` with no world size adopts their
count, and the tiers keep their ranks by identity (``mesh.world_tier_ids``).
The port keeps one copy of the replicated state, which every virtual rank
reads (``sentinel.py``), so the admission audit cannot fail on the trainer's
own parameters: the rejoining ranks' copy is a :class:`sentinel.PerRank`
copy of a survivor's, which a ``silent`` ``device.lost`` plan corrupts
(``sentinel.corrupt_replica``) and the audit compares with the survivors';
admitted, it folds back into the one copy (ROADMAP, standing differences).

Scope: ``DataParallelTrainer`` on a pure data-parallel grid (as
``optim.place_owned_vector`` asserts). Trainers without its attributes fail
the harvest and take the restart rung; a kernel that cannot be built or
launched during the drain raises ``MLSLKernelError`` out of the loop.

Knobs (validated in Config.validate): ``MLSL_ELASTIC``,
``MLSL_CAPACITY_BUDGET``, ``MLSL_ELASTIC_GROW_AFTER``,
``MLSL_ELASTIC_ADMIT_RETRIES``. ``timings`` on a coordinator: the last
reshard's drain, plan-verify and placement ms and its rebuild s.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mlsl_tpu_torch.analysis import witness
from mlsl_tpu_torch.log import (
    MLSLDeviceLossError,
    MLSLError,
    log_info,
    log_warning,
    mlsl_assert,
)

# -- the process-wide active world ------------------------------------------
#
# Like the chaos registry and the breakers, the active world survives
# Environment teardown and rebuild BY DESIGN: the loop's factories call
# ``Environment.init()`` with no world size, and init adopts the survivors.

_active: Optional[Tuple[int, ...]] = None

#: the full world's size once a coordinator has seen it (status() reports it
#: with the shrunk Environment up)
_full: Optional[int] = None

_registry_lock = witness.named_lock("elastic.registry")

#: last reshard/admission verdict, for supervisor.status()['elastic']
_last_reshard: Optional[dict] = None

#: (budget, shed_total) of the live coordinator, for status() after it is gone
_budget_info: list = [None, 0]


def active_devices() -> Optional[Tuple[int, ...]]:
    """The survivor ranks (full-world numbering) a rebuilt Environment must
    adopt, or None (the full world)."""
    return _active


def _set_active(ranks: Optional[Sequence[int]]) -> None:
    global _active
    with _registry_lock:
        _active = tuple(int(r) for r in ranks) if ranks is not None else None


def reset() -> None:
    """Clear the registry, the verdict record and the capacity-budget
    snapshot (``supervisor.reset_all``)."""
    global _last_reshard, _full
    _set_active(None)
    _full = None
    _last_reshard = None
    _budget_info[0] = None
    _budget_info[1] = 0


def armed(config=None) -> bool:
    """Is the elastic coordinator armed (MLSL_ELASTIC / Config.elastic)?"""
    if config is not None:
        return bool(getattr(config, "elastic", False))
    from mlsl_tpu_torch.config import _env_bool

    return _env_bool("MLSL_ELASTIC", False)


def _env_world() -> Optional[int]:
    from mlsl_tpu_torch.core.environment import Environment

    env = Environment._instance
    return env.world_size if env is not None and env._initialized else None


def status() -> dict:
    """The elastic mesh for ``supervisor.status()``: the full and active
    world sizes, the counters, the capacity budget and the last reshard;
    ``state`` is 'full' or 'shrunk'."""
    from mlsl_tpu_torch.core import stats as stats_mod

    world = _full if _full is not None else _env_world()
    out = {
        "state": "shrunk" if _active is not None else "full",
        "world_size": world,
        "active_size": len(_active) if _active is not None else world,
        **dict(stats_mod.ELASTIC_COUNTERS),
    }
    out["capacity_budget"] = _budget_info[0]
    out["budget_remaining"] = (max(0, _budget_info[0] - _budget_info[1])
                               if _budget_info[0] is not None else None)
    if _last_reshard is not None:
        out["last_reshard"] = dict(_last_reshard)
    return out


def _sync(trainer) -> None:
    """Wait for the trainer's card (no-op on the CPU)."""
    dev = getattr(trainer, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ElasticCoordinator:
    """Drives shrink -> continue -> grow -> continue for a FaultTolerantLoop
    (which routes DEVICE_LOSS faults here and polls :meth:`maybe_grow`
    between steps).

    Factory contract: ``make_trainer`` calls ``Environment.init()`` with no
    world size and sizes its Distribution from ``env.get_process_count()``:
    the whole point of a reshard is that the world size changed.
    """

    def __init__(self, capacity_budget: Optional[int] = None,
                 grow_after: Optional[int] = None,
                 admit_retries: Optional[int] = None):
        # an exported variable wins, then the live Config, then the default
        from mlsl_tpu_torch.config import Config, _env_int
        from mlsl_tpu_torch.core.environment import Environment

        cfg = Environment._instance.config if Environment.is_initialized() else None
        if cfg is None:
            cfg = Config
        try:
            if capacity_budget is None:
                capacity_budget = _env_int("MLSL_CAPACITY_BUDGET", cfg.capacity_budget)
            if grow_after is None:
                grow_after = _env_int("MLSL_ELASTIC_GROW_AFTER", cfg.elastic_grow_after)
            if admit_retries is None:
                admit_retries = _env_int("MLSL_ELASTIC_ADMIT_RETRIES",
                                         cfg.elastic_admit_retries)
        except ValueError as e:
            raise MLSLError(f"invalid MLSL_ELASTIC_*/MLSL_CAPACITY_BUDGET value: {e}") from e
        mlsl_assert(capacity_budget >= 0 and grow_after >= 0 and admit_retries >= 0,
                    "elastic knobs must be >= 0 (budget=%d, grow_after=%d, admit_retries=%d)",
                    capacity_budget, grow_after, admit_retries)
        # the full world: the live Environment's, or the first trainer's seen
        self._world: Optional[Tuple[int, ...]] = None
        self._budget_knob = capacity_budget
        self.capacity_budget: Optional[int] = capacity_budget or None
        self.grow_after = grow_after
        self.admit_retries = admit_retries
        self.shed_total = 0
        self._return_due: Optional[int] = None
        self._pending_return = False
        self.timings: dict = {}
        world = _full if _full is not None else (None if _active is not None else _env_world())
        if world is not None:
            self._adopt_world(world)
        _budget_info[0] = self.capacity_budget
        _budget_info[1] = 0

    def _adopt_world(self, size: int) -> None:
        """Fix the full world (its size; ranks 0..size-1) and the auto budget:
        0 = half the world, as a majority lost leaves too little to keep."""
        global _full
        if self._world is None:
            self._world = tuple(range(int(size)))
            _full = int(size)
            if not self._budget_knob:
                self.capacity_budget = max(1, len(self._world) // 2)
            _budget_info[0] = self.capacity_budget

    @property
    def world(self) -> Tuple[int, ...]:
        if self._world is None:
            size = _env_world()
            mlsl_assert(size is not None and _active is None,
                        "the elastic coordinator needs an initialized full-world "
                        "Environment to learn the world")
            self._adopt_world(size)
        return self._world

    # -- capacity-return signalling ---------------------------------------

    def announce_return(self) -> None:
        """Capacity is back; the next :meth:`maybe_grow` poll grows."""
        self._pending_return = True

    # -- shrink ------------------------------------------------------------

    def shrink(self, trainer, make_trainer, error=None, step: int = 0):
        """Answer one DEVICE_LOSS fault: drain state off the pre-loss world,
        rebuild over the survivors, carry the state live. -> the survivor
        trainer; MLSLError when the capacity budget refuses the loss or the
        drain or rebuild fails (the caller escalates to the restart rung)."""
        from mlsl_tpu_torch.comm import mesh as mesh_mod
        from mlsl_tpu_torch.core import stats as stats_mod
        from mlsl_tpu_torch.core.environment import Environment
        from mlsl_tpu_torch.obs import tracer as obs

        active = _active if _active is not None else self.world
        if self.capacity_budget is None:
            # the auto budget of a coordinator that never saw the full world
            self.capacity_budget = max(1, len(self._world or active) // 2)
            _budget_info[0] = self.capacity_budget
        lost = tuple(getattr(error, "devices", ()) or ())
        if not lost:
            # a loss observed but not attributed: shed the highest active
            # rank (its whole tier on a tiered world)
            lost = (active[-1],)
        survivors = mesh_mod.survivor_devices(lost, active)
        shed = len(active) - len(survivors)
        detail = (f"step={step} world {len(active)}->{len(survivors)} shed={shed} "
                  f"budget={self.shed_total + shed}/{self.capacity_budget}")
        stats_mod.record_elastic("device_losses", detail)
        if shed == 0:
            # a loss naming no active rank (a stale notice) would be a no-op
            # reshard the loop would retry forever
            stats_mod.record_elastic("restart_fallbacks", detail)
            raise MLSLError(f"device loss at step {step} names no active device — nothing "
                            "to shed; escalating to the restart rung instead of spinning "
                            "no-op reshards")
        if self.shed_total + shed > self.capacity_budget:
            stats_mod.record_elastic("restart_fallbacks", detail)
            raise MLSLError(f"capacity budget exhausted: shedding {shed} more device(s) "
                            f"would exceed {self.capacity_budget} (already shed "
                            f"{self.shed_total}) — escalating to the restart rung")
        tr = obs._tracer
        t0 = tr.now() if tr is not None else 0
        log_warning("elastic shrink at step %d: %d device(s) lost (%s), re-deriving the "
                    "mesh over %d survivors", step, shed,
                    type(error).__name__ if error else "announced", len(survivors))
        try:
            harvest = self._harvest(trainer)
        except Exception:
            # a failed drain IS an escalation to the restart rung: count it
            stats_mod.record_elastic("restart_fallbacks", detail)
            raise
        prev_active = _active
        _set_active(survivors)
        try:
            new_trainer = self._rebuild(make_trainer, harvest, len(survivors), step, "shrink")
        except Exception:
            # unwind: a restart-rung recovery rebuilds the pre-shrink world,
            # where the checkpoint shapes still match
            _set_active(prev_active)
            stats_mod.record_elastic("restart_fallbacks", detail)
            raise
        self.shed_total += shed
        _budget_info[1] = self.shed_total
        if self.grow_after > 0:
            self._return_due = step + self.grow_after
        global _last_reshard
        _last_reshard = {"kind": "shrink", "step": step, "verdict": "pass",
                         "d_old": harvest["d_old"], "d_new": new_trainer.data_size}
        stats_mod.record_elastic("shrinks", detail)
        if tr is not None:
            tr.complete("elastic.shrink", "elastic", t0, step=step,
                        world_before=len(active), world_after=len(survivors), shed=shed,
                        budget_remaining=self.capacity_budget - self.shed_total)
        log_info("elastic shrink complete: continuing at step %d on %d devices (capacity "
                 "budget %d/%d spent)", step, len(survivors), self.shed_total,
                 self.capacity_budget)
        return new_trainer

    # -- straggler shed (obs/straggler.py -> here) --------------------------

    def shed(self, trainer, make_trainer, replica: int, step: int = 0):
        """Hand a confirmed straggler replica to the shrink machinery as a
        synthetic DEVICE_LOSS. ``replica`` carries the straggler sentinel's
        numbering, the feeding process's index (models/train.py). On a world
        of more than one process it names every active rank that process
        holds (comm/transport.py's layout: the slow host is the straggler
        unit), as ``mlsl_tpu/elastic.py:348-356`` does by ``process_index``;
        with one process, every rank shares index 0, and the id is the
        replica's position in the active world. Raises MLSLError when the
        replica names no active rank or the shrink refuses; the caller keeps
        the full world."""
        from mlsl_tpu_torch.comm import transport
        from mlsl_tpu_torch.core import stats as stats_mod

        active = _active if _active is not None else self.world
        count = transport.world().count

        def proc(r):
            return transport.owner_of(r, len(self.world), count)

        procs = {proc(r) for r in active}
        if len(procs) > 1:
            devs = tuple(r for r in active if proc(r) == int(replica))
        elif 0 <= int(replica) < len(active):
            devs = (active[int(replica)],)
        else:
            devs = ()
        if not devs:
            stats_mod.record_straggler(
                "shed_fallbacks",
                f"replica={replica} names no active capacity (world={len(active)}, "
                f"processes={len(procs)})")
            raise MLSLError(f"straggler shed: replica {replica} does not name active "
                            f"capacity (active world {len(active)} devices across "
                            f"{len(procs)} process(es))")
        err = MLSLDeviceLossError(f"straggler shed: replica {replica} confirmed slow at step "
                                  f"{step}", devices=devs)
        try:
            new_trainer = self.shrink(trainer, make_trainer, error=err, step=step)
        except Exception:
            stats_mod.record_straggler("shed_fallbacks",
                                       f"replica={replica} step={step} shrink refused")
            raise
        stats_mod.record_straggler("sheds", f"replica={replica} step={step} "
                                            f"devices={','.join(str(d) for d in devs)}")
        return new_trainer

    # -- grow --------------------------------------------------------------

    def maybe_grow(self, trainer, make_trainer, step: int):
        """Between-steps poll: grow back to the full world when shrunk and
        capacity has returned. In a pod, re-admission is the leader's
        decision (``control``)."""
        if _active is None:
            return trainer
        from mlsl_tpu_torch import control as control_mod

        plane = control_mod.get_active()
        if plane is not None and not plane.may_decide():
            return trainer
        due = self._pending_return or (self._return_due is not None
                                       and step >= self._return_due)
        if not due:
            return trainer
        return self.grow(trainer, make_trainer, step)

    def grow(self, trainer, make_trainer, step: int):
        """Re-admit returned capacity: rebuild the full world, re-shard the
        state back, and admit the rejoining ranks only after their
        fingerprint audit passes."""
        from mlsl_tpu_torch import chaos
        from mlsl_tpu_torch.core import stats as stats_mod
        from mlsl_tpu_torch.obs import tracer as obs

        mlsl_assert(_active is not None, "grow() without a preceding shrink")
        active = _active
        returning = tuple(d for d in self.world if d not in set(active))
        # the site before any teardown: an 'error' plan is capacity lost
        # again during re-admission (the shrunk trainer stays live); a
        # 'silent' plan corrupts the rejoining copy, the audit's quarry
        silent_plan = None
        if chaos._plans:
            p = chaos.inject("device.lost", phase="admit", step=step)
            if p is not None and p.kind == "silent":
                silent_plan = p
        tr = obs._tracer
        t0 = tr.now() if tr is not None else 0
        log_info("elastic grow at step %d: re-admitting %d device(s) (world %d -> %d)",
                 step, len(returning), len(active), len(self.world))
        harvest = self._harvest(trainer)
        _set_active(None)
        try:
            new_trainer = self._rebuild(make_trainer, harvest, len(self.world), step, "grow")
            try:
                self._admit(new_trainer, harvest, step, returning, silent_plan)
            except MLSLError as admission_err:
                return self._abandon_grow(make_trainer, harvest, active, step, t0, tr,
                                          admission_err)
        except Exception:
            # structural failure: stay shrunk and disarm the return flags,
            # or every poll would retry the same grow
            _set_active(active)
            self._pending_return = False
            self._return_due = None
            raise
        self._return_due = None
        self._pending_return = False
        global _last_reshard
        _last_reshard = {"kind": "grow", "step": step, "verdict": "pass",
                         "d_old": harvest["d_old"], "d_new": new_trainer.data_size}
        stats_mod.record_elastic("grows", f"step={step} world {len(active)}->"
                                          f"{len(self.world)} readmitted={len(returning)}")
        if tr is not None:
            tr.complete("elastic.grow", "elastic", t0, step=step, world_before=len(active),
                        world_after=len(self.world), readmitted=len(returning))
        log_info("elastic grow complete: step %d continues on the full %d-device world",
                 step, len(self.world))
        return new_trainer

    def _abandon_grow(self, make_trainer, harvest, active, step: int, t0, tr, err):
        """Persistent admission divergence ABANDONS the grow: the full world
        is torn down, the survivor world rebuilt from the harvest, the
        return flags disarmed (only a fresh ``announce_return()``
        re-attempts)."""
        from mlsl_tpu_torch.core import stats as stats_mod

        global _last_reshard
        log_warning("elastic grow ABANDONED at step %d (%s) — staying on the %d-device "
                    "survivor world; announce_return() re-attempts", step, err, len(active))
        _set_active(active)
        shrunk = self._rebuild(make_trainer, harvest, len(active), step, "abandon")
        self._pending_return = False
        self._return_due = None
        _last_reshard = {"kind": "grow", "step": step, "verdict": "abandoned",
                         "d_old": harvest["d_old"], "d_new": shrunk.data_size}
        stats_mod.record_elastic("grow_abandons", f"step={step} world stays {len(active)}")
        if tr is not None:
            tr.complete("elastic.grow", "elastic", t0, step=step, world_before=len(active),
                        world_after=len(active), verdict="abandoned")
        return shrunk

    # -- admission audit ----------------------------------------------------

    def _admit(self, trainer, harvest, step: int, returning, silent_plan) -> None:
        """The sentinel's fingerprint audit as the admission check. Every
        rank's copy of the parameters -- the rejoining ranks' taken from a
        survivor, the plan's ``silent`` corruption applied to them -- enters
        as a :class:`sentinel.PerRank` leaf, so the audit compares each rank's
        copy with the others'. A mismatch re-syncs the rejoiners from the
        harvest and re-audits; persistent divergence raises. Admitted, the
        copy folds back into the trainer's one copy."""
        from mlsl_tpu_torch import sentinel as sentinel_mod
        from mlsl_tpu_torch.core import stats as stats_mod
        from mlsl_tpu_torch.obs import tracer as obs

        grid = tuple(trainer.dist.topology.grid_shape)
        w = math.prod(grid)
        sent = getattr(trainer, "sentinel", None)
        if sent is None:
            # audit machinery only; none of the gate/cadence knobs arm
            sent = sentinel_mod.Sentinel(grid, block=trainer.env.config.sentinel_block)
        copies = {n: [p.detach().reshape(1, -1).expand(w, -1).clone().reshape(*grid, *p.shape)
                      for p in trainer.layer_params[n]] for n in trainer.layers}
        if silent_plan is not None:
            sentinel_mod.corrupt_replica(copies, returning, silent_plan, grid)
        survivor = next(r for r in range(w) if r not in set(returning))
        tr = obs._tracer
        for attempt in range(self.admit_retries + 1):
            t0 = tr.now() if tr is not None else 0
            rep, sh = trainer._audit_state()
            rep["params"] = {n: [sentinel_mod.PerRank(c) for c in copies[n]] for n in copies}
            res = sent.audit_tree(rep, sh, step)
            if tr is not None:
                tr.complete("elastic.admit", "elastic", t0, step=step, attempt=attempt,
                            equal=res.equal, digest=res.digest[:16])
            if res.equal:
                stats_mod.record_elastic("admits", f"step={step} attempt={attempt} "
                                                   f"digest={res.digest[:16]}")
                with torch.no_grad():
                    for n in trainer.layers:
                        for p, c in zip(trainer.layer_params[n], copies[n]):
                            p.copy_(c.reshape(w, *p.shape)[survivor])
                return
            stats_mod.record_elastic("admit_rejects", f"step={step} attempt={attempt} "
                                                      f"digest={res.digest[:16]}")
            log_warning("elastic admission audit REJECTED the rejoining replica at step %d "
                        "(attempt %d): fingerprints diverge (digest %s)", step, attempt,
                        res.digest[:16])
            if attempt < self.admit_retries:
                stats_mod.record_elastic("resyncs", f"step={step}")
                self._resync(copies, harvest, returning, grid)
        raise MLSLError(f"elastic admission failed at step {step}: the rejoining replica's "
                        f"fingerprint still diverges after {self.admit_retries} resync "
                        "attempt(s)")

    @staticmethod
    @torch.no_grad()
    def _resync(copies, harvest, returning, grid) -> None:
        """Copy the survivors' state (the harvest) over the rejected rows."""
        w = math.prod(grid)
        for n, rows in copies.items():
            for c, h in zip(rows, harvest["params"][n]):
                flat = c.reshape(w, -1)
                for r in returning:
                    flat[r].copy_(h.reshape(-1))

    # -- state harvest / carry ---------------------------------------------

    def _harvest(self, trainer) -> dict:
        """Read the training state off the CURRENT (pre-reshard) world:
        copies of the parameters and the replicated optimizer state, and the
        full flat vector of every ZeRO-1 owned leaf by the drain all-gather
        on the pre-reshard world (the grace-window read)."""
        from mlsl_tpu_torch import optim
        from mlsl_tpu_torch.sentinel import tree_leaves

        for attr in ("layer_params", "layers", "layer_counts", "padded_counts", "data_size",
                     "dist", "opt_state"):
            if not hasattr(trainer, attr):
                raise MLSLError(f"elastic reshard supports DataParallelTrainer-shaped state; "
                                f"{type(trainer).__name__} lacks {attr!r} — falling back to "
                                "the restart rung")
        h0 = time.perf_counter()
        zero1 = trainer.distributed_update and trainer._needs_comm
        out = {
            "params": {n: [p.detach().clone() for p in trainer.layer_params[n]]
                       for n in trainer.layers},
            "opt_state": None,
            "du": None,
            "d_old": trainer.data_size,
            "layer_counts": dict(trainer.layer_counts),
            "padded_counts": dict(trainer.padded_counts),
        }
        if not zero1 and (trainer.opt_state or trainer.tree_state is not None):
            out["opt_state"] = [t.detach().clone() for t in
                                tree_leaves((trainer.opt_state, trainer.tree_state))]
        if zero1 and trainer.opt_state:
            # quiesce the dispatcher first: the loss interrupted a step
            try:
                trainer.env.dispatcher.shutdown()
            except Exception as e:
                log_warning("dispatcher quiesce before reshard drain failed: %s: %s",
                            type(e).__name__, e)
            topo = trainer.dist.topology
            grid = tuple(topo.grid_shape)
            gathered = {}
            for name in sorted(trainer.opt_state):
                gathered[name] = [
                    optim.gather_owned_full(topo, leaf)
                    if tuple(leaf.shape[:len(grid)]) == grid
                    else leaf.detach().clone()
                    for leaf in tree_leaves(trainer.opt_state[name])]
            out["du"] = gathered
        _sync(trainer)
        self.timings["drain_ms"] = (time.perf_counter() - h0) * 1e3
        return out

    def _rebuild(self, make_trainer, harvest, expected: int, step: int, kind: str):
        """Tear the Environment down, build the trainer over the active
        world and place the harvest on it."""
        from mlsl_tpu_torch.core.environment import Environment

        r0 = time.perf_counter()
        try:
            Environment.get_env().finalize()
        except Exception as e:
            log_warning("environment teardown during %s failed (continuing with rebuild): "
                        "%s: %s", kind, type(e).__name__, e)
        new_trainer = make_trainer()
        self._check_factory_world(new_trainer, expected)
        self._write_state(new_trainer, harvest, step=step, kind=kind)
        _sync(new_trainer)
        self.timings["rebuild_s"] = time.perf_counter() - r0
        return new_trainer

    @torch.no_grad()
    def _write_state(self, trainer, harvest, step: int, kind: str) -> None:
        """Place the harvest on the rebuilt trainer: the parameters and the
        replicated optimizer state copied in, ZeRO-1 state re-partitioned
        under a verified reshard plan."""
        from mlsl_tpu_torch.sentinel import tree_leaves

        for n in trainer.layers:
            mlsl_assert(n in harvest["params"], "reshard factory mismatch: layer %r has no "
                        "harvested parameters", n)
            for p, h in zip(trainer.layer_params[n], harvest["params"][n]):
                p.copy_(h)
        if harvest["opt_state"] is not None:
            dst = tree_leaves((trainer.opt_state, trainer.tree_state))
            mlsl_assert(len(dst) == len(harvest["opt_state"]),
                        "reshard factory mismatch: the %s trainer carries no replicated "
                        "optimizer state to receive the harvest", kind)
            for d, h in zip(dst, harvest["opt_state"]):
                d.copy_(h)
        if harvest["du"]:
            self._reshard_du(trainer, harvest, step, kind)

    def _reshard_du(self, trainer, harvest, step: int, kind: str) -> None:
        """Re-partition the gathered ZeRO-1 state onto the new world's
        ownership chunks, under an A140/A141-verified plan. A leaf whose
        per-rank payload spans the owned shard reshards; a leaf replicated by
        construction (a step count, adafactor's factored vectors) carries one
        copy; anything else is unreshardable and raises."""
        from mlsl_tpu_torch import optim
        from mlsl_tpu_torch.analysis import diagnostics
        from mlsl_tpu_torch.analysis import plan as plan_mod
        from mlsl_tpu_torch.core import stats as stats_mod
        from mlsl_tpu_torch.sentinel import tree_leaves

        d_old, d_new = harvest["d_old"], trainer.data_size
        plan = build_reshard_plan(harvest["layer_counts"], harvest["padded_counts"],
                                  trainer.padded_counts, d_old, d_new)
        t0 = time.perf_counter()
        rep = plan_mod.verify_reshard(plan)
        self.timings["plan_verify_ms"] = (time.perf_counter() - t0) * 1e3
        diagnostics.record(rep, time.perf_counter() - t0)
        if rep.errors:
            # unconditional: an uncovered plan silently corrupts optimizer state
            raise MLSLError(f"elastic {kind} reshard plan rejected: "
                            + "; ".join(d.format() for d in rep.errors))
        p0 = time.perf_counter()
        topo = trainer.dist.topology
        grid = tuple(topo.grid_shape)
        moved = 0
        for name in sorted(harvest["du"]):
            mlsl_assert(name in trainer.opt_state,
                        "reshard factory mismatch: layer %r has harvested ZeRO-1 state but "
                        "the rebuilt trainer does not register it", name)
            count = harvest["layer_counts"][name]
            padded_old = harvest["padded_counts"][name]
            padded_new = trainer.padded_counts[name]
            old_leaves = harvest["du"][name]
            new_leaves = tree_leaves(trainer.opt_state[name])
            mlsl_assert(len(old_leaves) == len(new_leaves),
                        "reshard factory mismatch: layer %r optimizer state trees differ "
                        "between worlds (%d vs %d leaves)", name, len(old_leaves),
                        len(new_leaves))
            roles = _du_leaf_roles(trainer, trainer.opt_state[name])
            if roles is not None and len(roles) != len(old_leaves):
                roles = None
            for i, (old, new_leaf) in enumerate(zip(old_leaves, new_leaves)):
                if isinstance(old, torch.Tensor):
                    # a rank-less leaf (Adam's one step count): carry it
                    new_leaf.copy_(old)
                    moved += 1
                    continue
                full = np.asarray(old).reshape(-1)
                k_old = full.shape[0] // d_old
                k_new = math.prod(new_leaf.shape[len(grid):])
                owned_fit = k_old * d_old == padded_old and k_new * d_new == padded_new
                repl_fit = k_old == k_new
                if owned_fit and repl_fit and roles is not None:
                    # shapes alone cannot tell a replicated scalar from a k == 1
                    # owned shard; the state's structure can
                    owned_fit, repl_fit = roles[i], not roles[i]
                if owned_fit:
                    placed = optim.place_owned_vector(topo, full, count, padded_new, d_new,
                                                      device=new_leaf.device)
                    new_leaf.copy_(placed.reshape(new_leaf.shape))
                elif repl_fit:
                    # every old rank held the same value: rank 0's to every rank
                    rep0 = torch.from_numpy(np.ascontiguousarray(full[:k_old]))
                    new_leaf.copy_(rep0.to(new_leaf.device).expand(new_leaf.shape))
                else:
                    raise MLSLError(
                        f"unreshardable optimizer leaf in layer {name!r}: per-rank payload "
                        f"{k_old} is neither the owned shard ({padded_old // d_old}) nor "
                        f"world-invariant ({k_new} expected) — falling back to the "
                        "restart rung")
                moved += 1
        _sync(trainer)
        self.timings["placement_ms"] = (time.perf_counter() - p0) * 1e3
        stats_mod.record_elastic("reshard_buffers", n=moved)

    # -- shared checks ------------------------------------------------------

    @staticmethod
    def _check_factory_world(trainer, expected: int) -> None:
        size = int(trainer.dist.topology.world_size)
        mlsl_assert(size == expected,
                    "make_trainer built a %d-device Distribution but the active world is "
                    "%d: elastic factories must size from env.get_process_count(), not a "
                    "constant", size, expected)


def _du_leaf_roles(trainer, state) -> Optional[list]:
    """Per leaf of one layer's ZeRO-1 state (``sentinel.tree_leaves``
    order): True when its size scales with the owned shard (elementwise
    moments: reshard), False when it is world-invariant (step counts,
    adafactor's factored vectors: carry one copy). By STRUCTURE, never by
    shape: a layer with fewer elements than the world has ranks makes a
    (1,)-payload count indistinguishable from a k == 1 owned shard. The
    adafactor dict schema (``optim.init_adafactor_state``) by key; an
    elementwise transform by initializing it at two sizes. None when
    neither applies (shape arithmetic then resolves every unambiguous
    layer)."""
    from mlsl_tpu_torch.sentinel import tree_leaves

    if isinstance(state, dict) and {"count", "v_row", "v_col"} <= set(state):
        return [k in ("v", "m") for k in sorted(state)]
    init = getattr(getattr(trainer, "optimizer", None), "init", None)
    if init is None:
        return None
    try:
        a = tree_leaves(init(2, device="cpu"))
        b = tree_leaves(init(3, device="cpu"))
    except Exception:
        return None
    if len(a) != len(b):
        return None
    return [x.numel() != y.numel() for x, y in zip(a, b)]


def build_reshard_plan(layer_counts: dict, padded_old: dict, padded_new: dict, d_old: int,
                       d_new: int) -> dict:
    """The statically verifiable description of one ZeRO-1 reshard: per
    layer, the old ownership-chunk intervals that tile the real elements
    ``[0, count)`` (sources) and the new ownership chunks (targets).
    ``analysis/plan.verify_reshard`` proves coverage before execution."""
    layers = []
    for name in sorted(layer_counts):
        count = int(layer_counts[name])
        po, pn = int(padded_old[name]), int(padded_new[name])
        k_old, k_new = po // max(d_old, 1), pn // max(d_new, 1)
        sources = []
        for r in range(d_old):
            lo, hi = r * k_old, min((r + 1) * k_old, count)
            if hi > lo:
                sources.append((r, lo, hi))
        targets = [(r, r * k_new, (r + 1) * k_new) for r in range(d_new)]
        layers.append({"name": name, "count": count, "padded_old": po, "k_old": k_old,
                       "padded_new": pn, "k_new": k_new, "sources": sources,
                       "targets": targets})
    return {"d_old": int(d_old), "d_new": int(d_new), "layers": layers}
