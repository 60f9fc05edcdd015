"""Gradient bucketing: coalesce small per-layer gradient collectives.

Counterpart of ``mlsl_tpu.core.bucketing`` (bucketing.py:52-662). A deep
model's backward pass starts one small collective per parameter set, each
paying a host dispatch and a launch; buckets pack eligible ParameterSets --
same gradient group, same dtype, same compression, same codec -- into
``MLSL_GRAD_BUCKET_MB``-sized groups in REVERSE creation order (the
backward-pass start order), at Session.commit. The last member to Start
triggers ONE concatenated collective for the whole bucket; each member's
Wait/Test slices its own segment from the bucket result.

Kinds: the plain ``allreduce``; ZeRO-1's gradient ``reduce_scatter``, packed
so that one reduce_scatter delivers every member's owned shard; and ZeRO-1's
increment ``allgather``, always uncompressed. QUANTIZATION members pack into
one int8 ring whose single error-feedback residual carries each member's
slice: member slots align to the quant block (a block never straddles two
members) and the total to the ring's chunk unit (``quant_ring.
ring_aligned_rc``), and a quantized allreduce bucket stays under 7/8 of
``MLSL_LARGE_MSG_SIZE_MB`` so that it is never chunked. The members'
resolved registry codec is part of the bucket's key, so that sets of
different codecs never share a ring (each codec owns its wire and residual
layout), and it is pinned into the coalesced request's ``desc.codec``; a
user codec routes through the config instead. TOPK stays individual: the
sparse wire has no coalesced form.

Opportunistic by design: a Wait or Test before the bucket fills falls back
to the registered members' individual requests, and a member restarted
while the bucket is in flight abandons its slot and runs individually; the
bucket re-arms for the next round. A failed bucket collective raises at
EVERY member's Wait/Test, once each.

The recovery ladder (``_degrade_locked``, bucketing.py:235-310 and 367-380
of the JAX package): a classified failure of the coalesced request counts
against the process-wide ``bucket`` breaker. Below its threshold the error
escalates to every member, also when the dispatch failed at the Start that
triggered it (the JAX package raises that one to the starting caller alone
and lets the other members' waits run their own requests; here no member
quietly changes route below the threshold). Once the breaker is OPEN the
failed round degrades: every registered member's own request starts with its
registered buffer, the round is counted as a ``bucket`` fallback and filed as
a DEGRADE event, and fresh rounds run individually until the cooldown admits
a half-open probe round, whose success re-closes the breaker. With the
tracer armed, a dispatched round's pack and Start is a ``bucket.pack`` span.

With ``MLSL_CHKP`` set, a member's buffer is checked against its own
request's descriptor as it registers (``checker.check_buffer``), before it
joins the packed round, so a bad buffer is named as that member's; a
declined round runs the member's own request, whose Start checks it.

Not ported: the stats' round-event ring (nothing reads it).
"""

from __future__ import annotations

import threading
from typing import List

import torch
import torch.nn.functional as F

from mlsl_tpu_torch import checker, supervisor
from mlsl_tpu_torch.comm import quant_ring
from mlsl_tpu_torch.comm.collectives import group_key
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
from mlsl_tpu_torch.core import stats as stats_mod
from mlsl_tpu_torch.log import log_debug, mlsl_assert
from mlsl_tpu_torch.obs import tracer as obs
from mlsl_tpu_torch.ops.quant_kernels import block_align
from mlsl_tpu_torch.types import CompressionType, ReductionType, dtype_size, torch_dtype


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return x if n == x.shape[-1] else F.pad(x, (0, n - x.shape[-1]))


class GradBucket:
    """One coalesced collective shared by several ParameterSets.

    Round lifecycle (all transitions under _lock):
      collecting --(all members registered)--> dispatched
      collecting --(any Wait/Test early)-----> fallback: registered members'
                                               individual requests start, the
                                               round re-arms at once
      dispatched --(every member consumed)---> re-armed for the next round
    A member restarting while dispatched abandons its bucket slot for that
    round (counts as consumed) and runs individually."""

    def __init__(self, members: List, env, kind: str = "allreduce",
                 compression: CompressionType = CompressionType.NONE, codec: str = ""):
        # members in START order (reverse creation = backward pass order)
        self.members = members
        self.kind = kind
        self.compression = CompressionType(compression)
        # the registry codec the members resolved to, pinned into the
        # coalesced desc so that the bucket rides their wire (a user codec
        # routes through the config, not the pin)
        self.codec = codec if codec not in ("", "custom") else ""
        quant = self.compression == CompressionType.QUANTIZATION
        # which ParameterSet round flag / fallback request this bucket drives
        self.round_attr = "_inc_bucket_round" if kind == "allgather" else "_bucket_round"
        self.req_attr = "inc_req" if kind == "allgather" else "grad_req"
        self._idx = {id(ps): i for i, ps in enumerate(members)}
        # owned elements per member (== local for the plain allreduce path)
        self.counts = [ps.owned_kernel_count * ps.kernel_size for ps in members]
        ps0 = members[0]
        group = ps0.dist.grad_group
        g = 1 if group.is_self else group.size
        esize = dtype_size(ps0.data_type)
        mult = g if kind == "reduce_scatter" else 1
        if quant:
            mlsl_assert(kind in ("allreduce", "reduce_scatter"),
                        "quantized buckets coalesce allreduce/reduce_scatter only (got %s)",
                        kind)
            block = env.config.quant_block_elems
            # member slots align to the quant block (the padding quantizes to
            # exact zeros) and the total to the ring's chunk unit, for the
            # wire the coalesced request will take
            self.slots = [block_align(c, block) for c in self.counts]
            total_slots = sum(self.slots)
            fused = self.codec in ("", "int8") and quant_ring.use_pallas_for(
                kind, group, total_slots * esize * mult, env.config)
            if kind == "reduce_scatter":
                total = quant_ring.ring_aligned_rc(total_slots, block, fused)
            else:
                total = g * quant_ring.ring_aligned_rc(-(-total_slots // g), block, fused)
        else:
            self.slots = list(self.counts)
            total = sum(self.counts)
        self.offsets = [0]
        for s in self.slots[:-1]:
            self.offsets.append(self.offsets[-1] + s)
        self.total = total
        # stats: coalesced member payload bytes per dispatched round, and the
        # wire bytes a quantized round saves against the float32 wire (int8
        # payload + one float32 scale a block; the JAX package's estimate)
        self._coalesced_bytes = sum(self.counts) * esize * mult
        n_wire = total * mult
        self._wire_saved_bytes = (
            max(0, n_wire * esize - (n_wire + (n_wire // env.config.quant_block_elems) * 4))
            if quant else 0
        )
        if kind == "allreduce":
            desc = CommDesc("allreduce", group, total, ps0.data_type, op=ReductionType.SUM,
                            compression=self.compression, codec=self.codec)
        elif kind == "reduce_scatter":
            # member m's buffer is G chunks of counts[m]; chunk r of the
            # PACKED buffer holds every member's chunk r, so the scatter
            # hands rank r one contiguous (total,) block
            desc = CommDesc("reduce_scatter", group, total * g, ps0.data_type,
                            op=ReductionType.SUM, recv_count=total,
                            compression=self.compression, codec=self.codec)
        elif kind == "allgather":
            # the result is G blocks of (total,); member m's shard
            # concatenation is its offsets[m] slice of every block, in
            # group-rank order
            desc = CommDesc("allgather", group, total, ps0.data_type)
        else:  # pragma: no cover - kinds are closed
            raise ValueError(kind)
        self._g = g
        self.req = CommRequest(desc, env.dispatcher,
                               name=f"bucket-{kind}[{len(members)}x{total}]")
        self.req.setup()
        self._lock = threading.Lock()
        self._bufs: dict = {}        # member index -> buffer (this round)
        self._dispatched = False
        self._parts = None           # split bucket result (this round)
        self._consumed: set = set()
        self._last: dict = {}        # member index -> last delivered result
        self._round = 0              # bumped at every re-arm: detects a round
        #                              completing under an out-of-lock wait
        # a failed bucket collective must raise at EVERY member's wait/test,
        # as each individual request raises its own error, not only at the
        # first waiter (CommRequest consumes its error once)
        self._error = None
        self._error_left: set = set()
        self._degraded_round = -1    # _round value the last degrade fired on
        # the recovery ladder: classified failures of the coalesced request
        # count against the process-wide bucket breaker; once OPEN, rounds
        # run the members' individual requests until a probe round succeeds
        self._breaker = supervisor.breaker("bucket")

    def precompile(self) -> int:
        """Run the pack, the coalesced request and the split once on zero
        buffers (bucketing.py:494-530 of the JAX package), so that the first
        round builds nothing; the round state is left as it was. -> the
        number of programs run."""
        d = self.req.desc
        topo = d.group.topology
        mult = self._g if self.kind == "reduce_scatter" else 1
        bufs = [torch.zeros((*topo.grid_shape, c * mult), dtype=torch_dtype(d.data_type),
                            device=self.req.dispatcher.device) for c in self.counts]
        self._split(self._pack(bufs))
        return self.req.precompile()

    # -- pack / unpack -------------------------------------------------------

    def _pack(self, xs) -> torch.Tensor:
        """Member buffers (start order) -> the bucket's send buffer, each
        member's segment padded to its slot and the total to ``total``."""
        lead = xs[0].shape[:-1]
        if self.kind == "reduce_scatter":
            g = self._g
            parts = [_pad_last(x.reshape(*lead, g, c), s)
                     for x, c, s in zip(xs, self.counts, self.slots)]
            return _pad_last(torch.cat(parts, dim=-1), self.total).reshape(*lead, g * self.total)
        parts = [_pad_last(x, s) for x, s in zip(xs, self.slots)]
        return _pad_last(torch.cat(parts, dim=-1), self.total)

    def _split(self, out: torch.Tensor):
        """The bucket's result -> each member's result, in start order."""
        if self.kind == "allgather":
            blocks = out.reshape(*out.shape[:-1], self._g, self.total)
            return [blocks[..., o:o + c].reshape(*out.shape[:-1], self._g * c)
                    for o, c in zip(self.offsets, self.counts)]
        return [out[..., o:o + c] for o, c in zip(self.offsets, self.counts)]

    # -- round state machine (all under _lock) -------------------------------

    def start(self, ps, buf) -> bool:
        """Register a member's buffer. True = the bucket owns this round for
        ps; False = run this start on ps's individual request."""
        i = self._idx[id(ps)]
        with self._lock:
            if self._error is not None:
                # THIS member's restart supersedes its undelivered error (the
                # CommRequest.start contract); other members still collect it
                self._error_left.discard(i)
                if not self._error_left:
                    self._error = None
            if self._dispatched:
                # restart while the bucket is in flight: abandon the slot for
                # this round and run individually
                stats_mod.record_bucket_round("abandon", kind=self.kind)
                self._consume_locked(i)
                return False
            if not self._bufs and not self._breaker.allow():
                # the bucket breaker is OPEN: deny the fresh round at its
                # boundary -- every member runs its own request until the
                # cooldown admits a probe round. Members of a round already
                # registering keep registering, so that an admitted round
                # completes or fails as a unit.
                return False
            chkp = checker.level()
            if chkp:
                # the member's buffer against ITS OWN descriptor, on the
                # registering path only (a declined round's individual Start
                # checks it itself; checking here too would count it twice)
                checker.check_buffer(buf, getattr(ps, self.req_attr).desc, chkp)
            self._bufs[i] = buf  # a pre-dispatch restart supersedes
            if len(self._bufs) == len(self.members):
                ordered = [self._bufs[j] for j in range(len(self.members))]
                tr = obs._tracer
                t0 = tr.now() if tr is not None else 0
                try:
                    self.req.start(self._pack(ordered))
                except Exception as e:
                    # a direct dispatch fails at Start, not at the waits: run
                    # the ladder here. A degrade pops OUR buffer first (the
                    # caller starts our request on the False return, the
                    # fallback everyone else's); below the threshold every
                    # member raises the error, this caller first
                    del self._bufs[i]
                    if self._degrade_locked(e):
                        return False
                    self._record_error_locked(e)
                    self._raise_error_locked(i)
                if tr is not None:
                    tr.complete("bucket.pack", "bucket", t0, track=self.req._trace_name,
                                kind=self.kind, members=len(self.members),
                                bytes=self._coalesced_bytes, algo=self.req.algo)
                self._dispatched = True
                stats_mod.record_bucket_round("dispatched", members=len(self.members),
                                              coalesced=self._coalesced_bytes,
                                              wire_saved=self._wire_saved_bytes,
                                              kind=self.kind)
            return True

    def _fallback_locked(self) -> None:
        """A member was waited/tested before the bucket filled: start every
        registered member's individual request and re-arm. Those members'
        current round becomes individual (their round flag cleared)."""
        log_debug("%s bucket fallback: %d/%d members started",
                  self.kind, len(self._bufs), len(self.members))
        stats_mod.record_bucket_round("fallback", members=len(self._bufs), kind=self.kind)
        for j, buf in self._bufs.items():
            ps = self.members[j]
            getattr(ps, self.req_attr).start(buf)
            setattr(ps, self.round_attr, False)
        self._bufs.clear()
        self._consumed.clear()
        self._round += 1

    def _consume_locked(self, i: int) -> None:
        self._consumed.add(i)
        if self._dispatched and len(self._consumed) == len(self.members):
            self._bufs.clear()
            self._consumed.clear()
            self._dispatched = False
            self._parts = None
            self._round += 1

    def _part_locked(self, out, i: int):
        if self._parts is None:
            self._parts = self._split(out)  # one unpack per round
        res = self._parts[i]
        self._last[i] = res
        self._consume_locked(i)
        return res

    def _record_error_locked(self, e: BaseException) -> None:
        self._error = e
        self._error_left = set(range(len(self.members)))
        self._bufs.clear()
        self._consumed.clear()
        self._dispatched = False
        self._parts = None
        self._round += 1

    def _degrade_locked(self, e: BaseException) -> bool:
        """Rung 3 for a failed coalesced round (the caller holds ``_lock``):
        count the classified failure against the bucket breaker; once it is
        OPEN (this failure tripped it, or a probe round failed) the round
        degrades -- every registered member's own request starts with its
        registered buffer and the bucket re-arms. -> True when degraded;
        False leaves the error to escalate (below the threshold)."""
        if supervisor.classify(e) is supervisor.ErrorClass.FATAL:
            return False
        if not self._breaker.record_failure(e):
            return False
        stats_mod.record_degrade("bucket", "fallback",
                                 detail=f"{self.kind}[{len(self.members)}]: "
                                        f"{type(e).__name__}: {e}")
        self._degraded_round = self._round
        self._dispatched = False
        self._parts = None
        self._fallback_locked()
        return True

    def _raise_error_locked(self, i: int) -> None:
        err = self._error
        self._error_left.discard(i)
        if not self._error_left:  # every member has seen it: clear for reuse
            self._error = None
        raise err

    def wait(self, ps):
        """-> (handled, result). handled=False: the fallback just started
        ps's individual request; the caller must wait it."""
        i = self._idx[id(ps)]
        with self._lock:
            if self._error is not None and i in self._error_left:
                # deliver the failed round's error ONCE per member
                self._raise_error_locked(i)
            if not self._dispatched:
                if i not in self._bufs:
                    # nothing pending this round: MPI no-op, last result again
                    return True, self._last.get(i)
                self._fallback_locked()
                return False, None
            if i in self._consumed:
                # duplicate wait on an already-consumed member: MPI no-op --
                # must not touch req.wait again (the round may re-arm under a
                # second out-of-lock wait)
                return True, self._last.get(i)
            r0 = self._round
        # Blocking wait OUTSIDE the lock: a concurrent Test on another member
        # stays a non-blocking poll. The round cannot re-arm until THIS
        # member consumes, and CommRequest.wait is idempotent for a completed
        # round. On failure the first error wins and everyone re-raises it.
        try:
            out = self.req.wait()
        except Exception as e:
            with self._lock:
                if self._round == r0:
                    # the first waiter to see the failure decides the round:
                    # degrade (breaker OPEN -- the individual requests run
                    # now, ours included) or record it for every member
                    if self._degrade_locked(e):
                        return False, None
                    if self._error is None:
                        self._record_error_locked(e)
                    self._raise_error_locked(i)
                if self._degraded_round == r0:
                    # a concurrent waiter degraded this round under us; its
                    # fallback started our request
                    return False, None
                if self._error is not None and i in self._error_left:
                    self._raise_error_locked(i)
                # the round completed under us despite our local failure:
                # first error wins
                if self._error is None:
                    self._record_error_locked(e)
                self._raise_error_locked(i)
        self._breaker.record_success()   # a no-op unless HALF_OPEN (the probe)
        with self._lock:
            if self._round != r0:
                # the round completed (or failed) under us: a concurrent
                # duplicate wait consumed this member; its result is cached
                if self._error is not None and i in self._error_left:
                    self._raise_error_locked(i)
                return True, self._last.get(i)
            return True, self._part_locked(out, i)

    def test(self, ps):
        """-> (handled, done, result_or_None); handled=False as in wait()."""
        i = self._idx[id(ps)]
        with self._lock:
            if self._error is not None and i in self._error_left:
                self._raise_error_locked(i)
            if not self._dispatched:
                if i not in self._bufs:
                    return True, True, self._last.get(i)
                self._fallback_locked()
                return False, False, None
            if i in self._consumed:  # duplicate poll: MPI no-op
                return True, True, self._last.get(i)
            try:
                done, out = self.req.test()
            except Exception as e:
                if self._degrade_locked(e):
                    # the member's own request runs now: handled=False sends
                    # the caller to poll it
                    return False, False, None
                if self._error is None:
                    self._record_error_locked(e)
                self._raise_error_locked(i)
            if not done:
                return True, False, None
            self._breaker.record_success()   # a no-op unless HALF_OPEN
            return True, True, self._part_locked(out, i)


def pack_by_size(pss: List, limit: int, size_of) -> List[List]:
    """Greedy packing in reverse creation (= backward start) order; singleton
    groups are dropped (a 1-member bucket is pure overhead). ``size_of(ps)``
    is the member's WIRE contribution -- its full local gradient bytes, so a
    layer that is already bandwidth-sized is excluded however its buffer is
    chunked. Public: the compiled overlap engine reuses this policy."""
    cur: List = []
    cur_bytes = 0
    groups: List[List] = []
    for ps in reversed(pss):
        nbytes = size_of(ps)
        if nbytes >= limit:
            # bandwidth-sized already: bucketing adds only copy traffic
            if len(cur) > 1:
                groups.append(cur)
            cur, cur_bytes = [], 0
            continue
        if cur_bytes + nbytes > limit and cur:
            if len(cur) > 1:
                groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(ps)
        cur_bytes += nbytes
    if len(cur) > 1:
        groups.append(cur)
    return groups


#: compressions whose gradient collective coalesces (TOPK stays individual:
#: the sparse wire format has no coalesced form)
_BUCKETABLE = (CompressionType.NONE, CompressionType.QUANTIZATION)


def build_buckets(session, bucket_mb: int) -> int:
    """Pack eligible ParameterSets into GradBuckets (called at Commit): plain
    sets coalesce their gradient allreduce (uncompressed, or the int8 ring --
    never mixed with uncompressed neighbours); distributed-update (ZeRO-1)
    sets coalesce BOTH phases, the gradient reduce_scatter (uncompressed or
    int8) and the increment all_gather (always uncompressed, so it coalesces
    across compressions). Returns the number of buckets formed."""
    device = session.env.device
    plain: dict = {}
    du: dict = {}
    du_inc: dict = {}
    for op in session.operations:
        for ps in op.parameter_sets:
            if not ps.need_comm:
                continue
            # the codec keeps mixed-codec sets apart: one ring, one wire
            key = (group_key(ps.dist.grad_group, device), ps.data_type, ps.compression,
                   ps.codec_name)
            if (not ps.distributed_update and ps.compression in _BUCKETABLE
                    and ps.bucket is None):
                plain.setdefault(key, []).append(ps)
            elif ps.distributed_update:
                du.setdefault(key, []).append(ps)
                du_inc.setdefault(key[:2], []).append(ps)

    limit = bucket_mb * 1024 * 1024
    cfg = session.env.config
    n_buckets = 0

    def form(pss, kind, attr, compression=CompressionType.NONE, codec=""):
        nonlocal n_buckets
        if not pss:
            return
        limit_eff = limit
        if (compression == CompressionType.QUANTIZATION and kind == "allreduce"
                and cfg.large_msg_size_mb > 0 and cfg.large_msg_chunks > 1):
            # a quantized allreduce above MLSL_LARGE_MSG_SIZE_MB would be
            # chunked by CommRequest.setup at arbitrary offsets, voiding the
            # slot and ring alignment and splitting the one residual: stay
            # under the threshold (7/8: alignment can grow the payload by up
            # to 12.5 %)
            limit_eff = min(limit, cfg.large_msg_size_mb * 1024 * 1024 * 7 // 8)
        esize = dtype_size(pss[0].data_type)
        grp = pss[0].dist.grad_group
        g = 1 if grp.is_self else grp.size
        # a member's wire contribution: its full LOCAL gradient bytes (for
        # the ZeRO-1 reduce_scatter owned * g, the whole chunked buffer);
        # quantized members count at their f32 bytes
        mult = g if kind == "reduce_scatter" else 1

        def size_of(ps):
            return ps.owned_kernel_count * ps.kernel_size * esize * mult

        for members in pack_by_size(pss, limit_eff, size_of):
            bucket = GradBucket(members, session.env, kind=kind, compression=compression,
                                codec=codec)
            for ps in members:
                setattr(ps, attr, bucket)
            n_buckets += 1

    for (_, _, comp, cname), pss in plain.items():
        form(pss, "allreduce", "bucket", compression=comp, codec=cname)
    for (_, _, comp, cname), pss in du.items():
        if comp in _BUCKETABLE:
            form([ps for ps in pss if ps.bucket is None], "reduce_scatter", "bucket",
                 compression=comp, codec=cname)
    for pss in du_inc.values():
        form([ps for ps in pss if ps.inc_bucket is None], "allgather", "inc_bucket")
    if n_buckets:
        log_debug("grad bucketing: %d bucket(s) formed", n_buckets)
    return n_buckets
