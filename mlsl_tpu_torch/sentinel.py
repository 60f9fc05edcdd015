"""Training integrity sentinel: silent-corruption detection and response.

Counterpart of ``mlsl_tpu.sentinel``, rewritten on tensors. The loud faults
have their rungs (the watchdog, the recovery ladder, the checker); a silent
one -- a bit flip in a parameter or an optimizer slot, a NaN gradient from a
bad batch -- passes them and poisons the model. Two layers guard the
training state:

1. **The step quality gate** (:meth:`Sentinel.gate`), between the gradient
   computation and any gradient comm: the non-finite screen, the global
   gradient-norm spike against its EMA and the loss z-score against its EMA,
   from ONE host read a step of two (W,) vectors -- each virtual rank's
   float32 squared gradient norm and its local loss. A corrupt parameter
   poisons the loss and gradients it produces, so the parameters are not
   scanned each step. ``MLSL_SENTINEL_GATE`` picks the response: ``warn``
   logs and goes on, ``skip_step`` drops the step before any comm starts
   (error-feedback residuals and the data order stay as if it never ran),
   ``rollback`` raises :class:`MLSLIntegrityError`. The loss z-score feeds
   the codec guardrail (``codecs.guard_note``).
2. **The consistency audit** (:meth:`Sentinel.audit_now`), every
   ``MLSL_SENTINEL_EVERY`` steps: a blockwise int32 fingerprint of the
   parameters and the optimizer state. Float bits are bitcast to int32 and
   summed in int32 with wraparound, so the fingerprint is exact integer math
   that no reduction order changes, and one flipped bit changes its block's
   sum; it is bit for bit the JAX package's for float32, bf16/f16, float64
   and integer leaves. Per-rank copies of one state (:class:`PerRank`
   leaves, ``(*grid, ...)``) are compared by their block sums' min and max
   over the rank dims (the JAX package's pmin/pmax over devices); per-rank
   shards (ZeRO-1's owned optimizer state) join by an exact integer sum over
   the rank dims. ``digest`` is the sha256 of the fingerprint vector: what a
   checkpoint records (``checkpoint_fingerprint``, for ROADMAP A.7c).

On virtual ranks the replicated parameters and optimizer state of
``DataParallelTrainer`` are one copy on the card that every rank reads: a
JAX replica's private copy has no counterpart, so a ``silent`` plan at
``train.params`` / ``train.opt_state`` corrupts the copy every rank reads,
the min/max comparison over it cannot fail, and only the gate's screens and
the digest's change see that plan (ROADMAP, standing differences). The
comparison runs wherever a trainer holds per-rank copies.

``corrupt_silent`` applies a chaos ``silent`` plan (flip a bit of, perturb
or overwrite one element of one leaf, of one rank's rows for a per-rank
leaf), seeded by the chaos RNG. The port's tensors are mutable: it corrupts
in place and returns the tree.

Knobs: MLSL_SENTINEL_GATE, _EVERY, _SPIKE, _ZMAX, _WARMUP, _BLOCK (validated
in ``Config.validate``; ``sentinel_every`` is a tuner knob).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mlsl_tpu_torch import chaos
from mlsl_tpu_torch.core import stats as stats_mod
from mlsl_tpu_torch.log import MLSLIntegrityError, log_warning
from mlsl_tpu_torch.obs import tracer as obs

#: EMA decay of the spike and z-score screens: about the last 10 healthy steps
EMA_DECAY = 0.9

# the last completed audit, process-wide: the dashboards ask "when was the
# state last known consistent" after its trainer is gone
_last_audit: Optional[dict] = None


def armed(config) -> bool:
    """Does ``config`` arm any sentinel layer?"""
    return bool(config is not None
                and (getattr(config, "sentinel_gate", "")
                     or getattr(config, "sentinel_every", 0) > 0))


def status() -> dict:
    """The sentinel's part of ``supervisor.status()``: the counters, the last
    audit, and ``state``: 'idle' (never ran), 'armed' (screening or
    auditing, nothing found), 'tripped' (a gate rolled back or an audit
    found divergence)."""
    c = dict(stats_mod.SENTINEL_COUNTERS)
    if c["gate_rollback"] or c["audit_mismatch"]:
        state = "tripped"
    elif c["screened"] or c["audits"]:
        state = "armed"
    else:
        state = "idle"
    out = {"state": state, **c}
    if _last_audit is not None:
        out["last_audit"] = dict(_last_audit)
    return out


def reset() -> None:
    """The counters at 0 and no last audit (``supervisor.reset_all``)."""
    global _last_audit
    stats_mod.reset_sentinel_counters()
    _last_audit = None


@dataclasses.dataclass
class AuditResult:
    """One consistency audit: ``equal`` is the min/max verdict over the
    per-rank copies; ``digest`` the sha256 of the fingerprint vector."""

    equal: bool
    digest: str
    step: int
    blocks: int


@dataclasses.dataclass(frozen=True)
class PerRank:
    """A leaf of the audit's replicated tree that holds one copy a virtual
    rank, ``(*grid, ...)``: the copies must agree."""

    tensor: torch.Tensor


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, sequences (and
    NamedTuples) in order; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def _as_int32(rows: torch.Tensor) -> torch.Tensor:
    """(W, n) leaf rows -> (W, n) int32 of their bits, as the JAX package's
    ``_leaf_blocks`` takes them: float32 bitcast; bf16/f16 bitcast to int16
    and sign-extended; float64 and 64-bit integers the XOR of their halves
    (a cast would round low-mantissa flips away); other integers cast."""
    dt = rows.dtype
    if dt == torch.float32:
        return rows.contiguous().view(torch.int32)
    if dt in (torch.bfloat16, torch.float16):
        return rows.contiguous().view(torch.int16).to(torch.int32)
    if dt == torch.float64:
        v = rows.contiguous().view(torch.int64)
        return (v ^ (v >> 32)).to(torch.int32)
    if dt == torch.int64:
        return (rows ^ (rows >> 32)).to(torch.int32)
    return rows.to(torch.int32)


def block_sums(rows: torch.Tensor, block: int) -> torch.Tensor:
    """(W, n) rows of any dtype -> (W, ceil(n / block)) int32 block sums with
    int32 wraparound, the last block zero-padded."""
    v = _as_int32(rows)
    pad = (-v.shape[1]) % block
    if pad:
        v = torch.cat([v, v.new_zeros((v.shape[0], pad))], dim=1)
    return v.reshape(v.shape[0], -1, block).sum(dim=2, dtype=torch.int32)


class Sentinel:
    """One trainer's integrity sentinel (build with :meth:`from_config`).
    ``grid``: the trainer's topology grid ``(R, D, S, M)``; per-rank
    buffers carry it as their leading dims."""

    def __init__(self, grid: Sequence[int] = (1, 1, 1, 1), gate: str = "", every: int = 0,
                 spike: float = 10.0, zmax: float = 8.0, warmup: int = 5,
                 block: int = 4096, codec_guard_window: int = 3):
        self.grid = tuple(int(g) for g in grid)
        self.gate_response = gate
        self.every = int(every)
        self.spike = float(spike)
        self.zmax = float(zmax)
        self.warmup = int(warmup)
        self.block = int(block)
        # consecutive loss-outlier screens before a calibrated codec demotes
        # to int8 (MLSL_CODEC_GUARD_BREACHES; codecs.guard_note)
        self.codec_guard_window = int(codec_guard_window)
        # the EMA state of the history-armed screens (healthy steps only)
        self._n = 0
        self._ema_norm: Optional[float] = None
        self._loss_mean: Optional[float] = None
        self._loss_var = 0.0
        self._last: Optional[AuditResult] = None

    @classmethod
    def from_config(cls, config, grid) -> "Sentinel":
        return cls(grid, gate=config.sentinel_gate, every=config.sentinel_every,
                   spike=config.sentinel_spike, zmax=config.sentinel_zmax,
                   warmup=config.sentinel_warmup, block=config.sentinel_block,
                   codec_guard_window=getattr(config, "codec_guard_breaches", 3))

    @property
    def gate_armed(self) -> bool:
        return bool(self.gate_response)

    @property
    def audit_armed(self) -> bool:
        return self.every > 0

    # -- layer 1: the step quality gate --------------------------------------

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(math.prod(self.grid), -1)

    def screen(self, loss: torch.Tensor, grads) -> Tuple[np.ndarray, np.ndarray]:
        """-> (each rank's float32 squared gradient norm, each rank's local
        loss), both (W,), from one host read; across processes the world's
        rows, in rank order, gathered from every process. ``grads``: a tree
        of per-rank ``(*grid, ...)`` buffers; ``loss``: ``(*grid, ...)``,
        its first element a rank's loss."""
        sq = None
        for leaf in tree_leaves(grads):
            if leaf.is_floating_point():
                part = self._rows(leaf).float().square().sum(dim=1)
                sq = part if sq is None else sq + part
        lv = self._rows(loss)[:, 0].float()
        if sq is None:
            sq = torch.zeros_like(lv)
        host = torch.stack([sq, lv])
        from mlsl_tpu_torch.comm import transport

        w = transport.world()
        if w.count > 1 and w.up:
            # every process screens the whole world's rows, the JAX
            # package's global arrays: one verdict on every process, so the
            # codec guardrail demotes everywhere at the same round
            host = transport.all_gather(host).transpose(0, 1).reshape(2, -1)
        host = host.cpu().numpy()
        return host[0], host[1]

    def gate(self, loss, grads, params, step: int) -> bool:
        """Screen one step's (per-rank loss, per-rank gradients) before any
        gradient comm starts. -> True to go on with the update, False to skip
        it (``skip_step``); raises :class:`MLSLIntegrityError` under
        ``rollback``. Healthy steps feed the EMA state, fired ones never do.
        ``params`` is not scanned (a corrupt parameter shows in the loss and
        the gradients it produces)."""
        if not self.gate_response:
            return True
        tr = obs._tracer
        t0 = tr.now() if tr is not None else 0
        sq_a, lv_a = self.screen(loss, grads)
        sq = float(np.sum(sq_a, dtype=np.float64))
        lv = float(lv_a[0])
        norm = math.sqrt(sq) if math.isfinite(sq) and sq >= 0 else float("inf")
        stats_mod.record_sentinel("screened")

        reason = None
        if not math.isfinite(sq) or not np.isfinite(lv_a).all():
            # every rank's local loss rides along, so one rank's poisoned
            # forward pass fires even when rank 0's looks fine; the count is
            # a second pass the healthy path never pays
            nf = sum(int((~torch.isfinite(g)).sum()) for g in tree_leaves(grads)
                     if g.is_floating_point())
            reason = f"nonfinite: {nf} grad elements, sqnorm={sq!r}, loss={lv!r}"
        elif self._n >= self.warmup:
            if (self._ema_norm is not None and self._ema_norm > 0
                    and norm > self.spike * self._ema_norm):
                reason = (f"grad-norm spike: {norm:.4g} > {self.spike:g} x "
                          f"EMA {self._ema_norm:.4g}")
            elif self._loss_mean is not None:
                sd = math.sqrt(max(self._loss_var, 0.0))
                if sd > 0 and abs(lv - self._loss_mean) > self.zmax * sd:
                    reason = (f"loss outlier: {lv:.4g} vs EMA {self._loss_mean:.4g} +- "
                              f"{self.zmax:g} x {sd:.4g}")

        if tr is not None:
            tr.complete("sentinel.gate", "sentinel", t0, step=step,
                        grad_norm=round(norm, 6) if math.isfinite(norm) else None,
                        fired=reason)
        # the codec guardrail: the z-score screen is the convergence monitor
        # of calibrated codecs; healthy screens reset the streak, spike and
        # non-finite firings neither advance nor reset it
        loss_outlier = reason is not None and reason.startswith("loss outlier")
        if reason is None or loss_outlier:
            from mlsl_tpu_torch import codecs as codecs_mod

            if codecs_mod.guard_active():
                codecs_mod.guard_note(loss_outlier, window=self.codec_guard_window,
                                      step=step)
        if reason is None:
            self._observe(norm, lv)
            return True
        resp = self.gate_response
        stats_mod.record_sentinel(
            "gate_" + {"warn": "warn", "skip_step": "skip", "rollback": "rollback"}[resp])
        log_warning("sentinel gate fired at step %d (%s): %s", step, resp, reason)
        if tr is not None:
            tr.instant("integrity.gate", "sentinel", step=step, response=resp, reason=reason)
        if resp == "rollback":
            raise MLSLIntegrityError(
                f"step quality gate at step {step}: {reason} (response=rollback)")
        return resp != "skip_step"

    def _observe(self, norm: float, loss: float) -> None:
        self._n += 1
        if self._ema_norm is None:
            self._ema_norm = norm
        else:
            self._ema_norm = EMA_DECAY * self._ema_norm + (1 - EMA_DECAY) * norm
        if self._loss_mean is None:
            self._loss_mean = loss
        else:
            dev = loss - self._loss_mean
            self._loss_mean += (1 - EMA_DECAY) * dev
            self._loss_var = EMA_DECAY * self._loss_var + (1 - EMA_DECAY) * dev * dev

    # -- layer 2: the consistency audit ----------------------------------------

    def _leaf_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """One copy of a leaf -> its (ceil(numel / block),) int32 block sums
        (``mlsl_tpu.sentinel.Sentinel._leaf_blocks``)."""
        return block_sums(x.reshape(1, -1), self.block)[0]

    def fingerprint(self, rep, sh=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (equal, fingerprint) on the state's device. ``rep``: a tree of
        one-copy tensors and :class:`PerRank` copies, whose block sums'
        minimum over the ranks enters the fingerprint and whose min == max
        is ``equal``; ``sh``: a tree of per-rank shards ``(*grid, ...)``,
        whose block sums enter summed over the ranks (int32 wraparound)."""
        w = math.prod(self.grid)
        parts: List[torch.Tensor] = []
        equal = None
        for leaf in tree_leaves(rep):
            if isinstance(leaf, PerRank):
                b = block_sums(leaf.tensor.reshape(w, -1), self.block)
                mn, mx = b.min(dim=0).values, b.max(dim=0).values
                same = (mn == mx).all()
                equal = same if equal is None else equal & same
                parts.append(mn)
            else:
                parts.append(self._leaf_blocks(leaf))
        shards = [block_sums(l.reshape(w, -1), self.block).sum(dim=0, dtype=torch.int32)
                  for l in tree_leaves(sh)]
        fp = torch.cat(parts + shards) if parts or shards else torch.zeros(0, dtype=torch.int32)
        if equal is None:
            equal = torch.ones((), dtype=torch.bool, device=fp.device)
        return equal, fp

    def audit_tree(self, rep, sh=None, step: int = 0) -> AuditResult:
        """Audit the given state (see :meth:`fingerprint`) with one host
        read; never raises on a mismatch."""
        global _last_audit
        tr = obs._tracer
        t0 = tr.now() if tr is not None else 0
        equal_dev, fp_dev = self.fingerprint(rep, sh)
        host = torch.cat([fp_dev, equal_dev.reshape(1).to(torch.int32)]).cpu().numpy()
        equal = bool(host[-1])
        fp = np.ascontiguousarray(host[:-1], dtype="<i4")
        digest = hashlib.sha256(fp.tobytes()).hexdigest()
        res = AuditResult(equal=equal, digest=digest, step=step, blocks=int(fp.size))
        stats_mod.record_sentinel("audits")
        if not equal:
            stats_mod.record_sentinel("audit_mismatch")
        self._last = res
        _last_audit = {"step": step, "equal": equal, "digest": digest}
        if tr is not None:
            tr.complete("sentinel.audit", "sentinel", t0, step=step, equal=equal,
                        blocks=res.blocks, digest=digest[:16])
            if not equal:
                tr.instant("integrity.violation", "sentinel", step=step, digest=digest[:16])
        if not equal:
            log_warning("sentinel audit at step %d: per-rank fingerprints DIVERGE (digest "
                        "%s) -- the parameters or optimizer state differ between ranks",
                        step, digest[:16])
        return res

    def audit_now(self, trainer, step: int) -> AuditResult:
        """Audit ``trainer``'s state now (no cadence check): its
        ``_audit_state()`` gives the (replicated, sharded) trees."""
        rep, sh = trainer._audit_state()
        return self.audit_tree(rep, sh, step)

    def maybe_audit(self, trainer, step: int) -> Optional[AuditResult]:
        """The audit every ``MLSL_SENTINEL_EVERY`` steps; raises
        :class:`MLSLIntegrityError` on divergence."""
        if self.every <= 0 or step % self.every:
            return None
        res = self.audit_now(trainer, step)
        if not res.equal:
            raise MLSLIntegrityError(
                f"consistency audit failed at step {step}: per-rank fingerprints of the "
                f"parameters or optimizer state diverge (digest {res.digest[:16]})")
        return res

    def checkpoint_fingerprint(self, trainer, step: int) -> str:
        """The digest a checkpoint of ``step`` records, from this step's audit
        (run now if it has not); raises on divergence, so that corrupt state
        is never saved as a verified resume point."""
        res = self._last
        if res is None or res.step != step:
            res = self.audit_now(trainer, step)
        if not res.equal:
            raise MLSLIntegrityError(
                f"refusing to checkpoint step {step}: the consistency audit found "
                f"per-rank divergence (digest {res.digest[:16]})")
        stats_mod.record_sentinel("verified_saves")
        return res.digest


# -- the proof harness: seeded silent corruption --------------------------------


# a float's bits as the signed integer of its width (the top bit is the sign)
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@torch.no_grad()
def _corrupt_element(leaf: torch.Tensor, idx: int, plan, rng) -> None:
    mi = tuple(int(i) for i in np.unravel_index(idx, tuple(leaf.shape)))
    mag = getattr(plan, "mag", None)
    if mag is None:
        # one flipped bit of the element's representation (the classic SDC)
        width = leaf.element_size()
        bits = leaf[mi].reshape(1).view(_BITS[width]).clone()
        bit = rng.randrange(width * 8)
        flip = torch.tensor([1 << bit if bit < width * 8 - 1 else -(1 << bit)],
                            dtype=bits.dtype, device=bits.device)
        leaf[mi] = (bits ^ flip).view(leaf.dtype)[0]
    elif not math.isfinite(mag):
        leaf[mi] = mag
    else:
        v = float(leaf[mi])
        leaf[mi] = v + mag * (abs(v) + 1.0)


def corrupt_silent(tree, plan, grid: Optional[Sequence[int]] = None):
    """Apply one chaos ``silent`` plan to a tree of tensors in place, without
    raising: one float leaf, one element -- of one rank's rows when the
    leaf's leading dims are ``grid`` (a per-rank buffer). Seeded by the chaos
    RNG (``MLSL_CHAOS_SEED`` / ``chaos.seed``). ``plan.mag``: None flips one
    random bit, nan/inf overwrite the element, a finite value adds
    ``mag * (|x| + 1)``. -> the tree."""
    leaves = tree_leaves(tree)
    float_idx = [i for i, l in enumerate(leaves)
                 if isinstance(l, torch.Tensor) and l.is_floating_point() and l.numel()]
    if not float_idx:
        return tree
    rng = chaos._rng
    leaf = leaves[float_idx[rng.randrange(len(float_idx))]]
    n, base = leaf.numel(), 0
    if grid is not None and tuple(leaf.shape[:len(grid)]) == tuple(grid):
        w = math.prod(grid)
        n //= w
        base = rng.randrange(w) * n
    _corrupt_element(leaf, base + rng.randrange(n), plan, rng)
    return tree


def corrupt_replica(tree, ranks: Sequence[int], plan, grid: Sequence[int]):
    """:func:`corrupt_silent` aimed at given ranks: one element of one float
    per-rank leaf, in the rows of one of ``ranks`` (the elastic admission's
    rejoining copy, A.7c). Leaves without the ``grid`` dims are skipped;
    -> the tree, unchanged when no leaf is corruptible there."""
    leaves = [l for l in tree_leaves(tree)
              if isinstance(l, torch.Tensor) and l.is_floating_point() and l.numel()
              and tuple(l.shape[:len(grid)]) == tuple(grid)]
    ranks = list(ranks)
    if not leaves or not ranks:
        return tree
    rng = chaos._rng
    leaf = leaves[rng.randrange(len(leaves))]
    n = leaf.numel() // math.prod(grid)
    rank = ranks[rng.randrange(len(ranks))]
    _corrupt_element(leaf, rank * n + rng.randrange(n), plan, rng)
    return tree
