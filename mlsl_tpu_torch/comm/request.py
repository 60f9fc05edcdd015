"""Asynchronous communication requests: the Start/Wait/Test engine.

Counterpart of the core of ``mlsl_tpu.comm.request`` (reference CommRequest +
eplib command queue, src/comm.hpp:368-409, eplib/cqueue.c). On a CUDA device:

- ``start`` makes a dedicated comm stream wait on the caller's current stream,
  enqueues the collective there, records an event and calls ``record_stream``
  on each tensor it hands across, so it returns before the device finishes;
- ``wait`` makes the caller's stream wait on that event and returns the result;
- ``test`` is ``event.query()``.

On the CPU every collective runs synchronously inside ``start``.

``setup`` picks the lowering through the algorithm engine's selection table
(comm/algos: MLSL_ALGO > tuned profile > heuristic) and names it in
``req.algo``, as at request.py:312-343 and :452-514 of the JAX package.

Also, as host-side scheduling policy:
- large-message chunking (reference splits >128 MiB allreduces,
  src/comm_ep.cpp:640-657): a big allreduce runs as several independent chunk
  programs (a quantized one with one error-feedback residual per chunk);
- newest-first priority (reference eplib/allreduce_pr.c LIFO queue, :76-79):
  with ``msg_priority`` on, requests larger than the threshold are deferred
  and launched together ``msg_priority_flush_ms`` after the last deferral by
  the dispatcher's progress thread, newest first (``msg_priority_mode`` 1) or
  oldest first (0), with no call from the app; a wait, a test, a barrier or
  an explicit flush launches them sooner.

A request deferred on a CUDA buffer may be launched from the progress thread,
whose current stream and device are not the caller's. So ``start`` records an
event on the caller's current stream, and the dispatch sets the buffer's
device and makes the comm stream wait on that event. A failure while the
progress thread dispatches stays on its request and is raised again by that
request's ``wait`` or ``test``.

A compressed request keeps its error-feedback residual from one round to the
next. The compressed wires (request.py:183-430 of the JAX package):

- ``CompressionType.TOPK``, or a QUANTIZATION request whose codec resolves
  to ``topk``: the sparse wire of comm/sparse.py (``algo`` "topk");
- a user codec (``config.custom_codec``, from ``set_quantization_params``):
  the compressed ring of comm/codec.py (``algo`` "custom_codec");
- a registry codec other than int8 (``MLSL_CODEC``, a calibrated per-set
  assignment, ``config.codec``, or ``desc.codec`` pinned by a bucket or a
  demotion; ``codecs.assigned`` orders them): the same ring through
  ``Codec.as_custom()`` (``algo`` "codec:<name>");
- int8: the int8 ring of comm/quant_ring.py, composed or fused (B4), or, for
  a forced or tuned ``hier`` allreduce on a tiered group, the two-tier wire
  (``algo`` "hier": ``config.hier_dcn_codec`` on the DCN hop, a residual
  over each member's own shard, ``_err_layout`` "hier").

``codec_name`` and ``codec_source`` name the resolved codec and where it came
from; every start adds the compressed image of the payload to the codec's
wire bytes (``stats.record_codec_wire``). ``demote_codec`` (the guardrail's
rung, codecs.guard_note) pins a request to int8: the old wire's residual is
taken, added once to the payload of the next round that succeeds, and from
then on the request runs the plain int8 build.

The fault plane (request.py:620-1250 of the JAX package):

- chaos sites: ``request.start`` at Start, ``request.wait`` at each wait
  attempt, ``request.test`` at each poll; the collectives pass
  ``collective.dispatch`` / ``device.lost`` (comm/collectives.py), the
  compressed wires ``codec.roundtrip`` (comm/quant_ring.py);
- the recovery ladder around every dispatch (``_dispatch_ladder``): a
  TRANSIENT failure retries in place with ``comm_retries`` /
  ``comm_retry_backoff_s`` (on the progress thread for a deferred request);
  CORRUPTION and PERSISTENT failures count against the request's breaker
  (``quant`` for a compressed wire, ``algo`` for a forced or tuned
  algorithm); once it is OPEN the dispatch is served by
  ``_dispatch_degraded`` -- the plain float32 SUM over the payload with the
  residual flushed into it once, or ``lax`` -- on the same stream and device
  as the healthy path, counted in ``stats.DEGRADE_FALLBACKS`` and filed as a
  DEGRADE event; after the cooldown one HALF_OPEN probe runs the healthy path
  again; DEVICE_LOSS and FATAL failures raise. A kernel that cannot be
  built, loaded or launched (``MLSLKernelError``) is FATAL: it never counts
  against a breaker, so no round is ever served by the plain version in a
  kernel's place. Every re-attempt rewinds the error-feedback residuals to
  their state at Start;
- a TRANSIENT failure at wait re-starts the stored buffer (rung 2 on the
  wait side). Only the ``request.wait`` site raises one after a dispatch
  that succeeded, so unless a plan is armed there the stored buffer and the
  residuals' Start snapshot are released as soon as the dispatch succeeds;
- the watchdog: with ``watchdog_timeout_s`` set, a request in flight longer
  than that (a dispatch wedged on the progress thread, or on the card an
  event not done) raises MLSLTimeoutError and writes the tracer's flight
  record (``stats.record_watchdog_event``);
- with the tracer armed, ``submit`` / ``dispatch.error`` / ``test.done``
  instants and ``dispatch`` / ``wait`` spans on the request's own track, all
  host time; with the metrics registry armed, the dispatch-to-wait latency
  and the achieved algbw at each completed round.

With ``MLSL_CHKP`` set, ``start`` checks the buffer against the request's
descriptor (checker.check_buffer: layout, length, dtype; at level 2 a queued
finiteness verdict), and the round's first completed ``wait`` or ``test``
resolves the queued verdicts with one host read; a failing round drains them
into the log, so that its own error stays the one raised and no later round
inherits them.

Not ported: the JAX package's native priority queue (standing difference "No
native dispatcher queue").
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from mlsl_tpu_torch import chaos, checker, supervisor
from mlsl_tpu_torch.comm import algos, collectives
from mlsl_tpu_torch.comm.mesh import NUM_GRID_AXES, ProcessGroup
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.log import (MLSLError, MLSLTimeoutError, log_debug, log_error, log_warning,
                                mlsl_assert)
from mlsl_tpu_torch.obs import metrics as obs_metrics
from mlsl_tpu_torch.obs import tracer as obs
from mlsl_tpu_torch.types import (
    CompressionType,
    DataType,
    ReductionType,
    dtype_size,
    torch_dtype,
)


class ComputeType(enum.IntEnum):
    """What a request carries (reference CommDesc src/comm.hpp:253-261)."""

    FPROP = 0
    BPROP = 1
    PARAM_GRAD = 2
    PARAM_INC = 3
    GENERIC = 4


@dataclasses.dataclass
class CommDesc:
    kind: str                      # 'allreduce' | 'bcast' | ... | 'barrier'
    group: ProcessGroup
    count: int                     # elements per rank (send side; alltoall: per member)
    data_type: DataType
    compute_type: ComputeType = ComputeType.GENERIC
    op: Optional[ReductionType] = None
    root: Optional[int] = None
    recv_count: Optional[int] = None
    recv_counts: Optional[tuple] = None   # allgatherv; alltoallv: counts or matrix
    send_counts: Optional[tuple] = None   # alltoallv
    send_offsets: Optional[tuple] = None
    recv_offsets: Optional[tuple] = None
    pairs: Optional[tuple] = None  # sendrecv: ((src, dst), ...) member indices
    compression: CompressionType = CompressionType.NONE
    # registry codec pin for QUANTIZATION wires: '' = resolved by request name
    # (codecs.assigned); set by bucketing (members share one codec)
    codec: str = ""
    # the int8 block of this request (0 = config.quant_block_elems)
    quant_block: int = 0

    def payload_bytes(self) -> int:
        return self.count * dtype_size(self.data_type)

    def send_len(self) -> int:
        """Elements a rank's send buffer holds: ``count``, except for
        alltoall, whose count is one member's chunk."""
        if self.kind == "alltoall" and not self.group.is_self:
            return self.count * self.group.size
        return self.count


class CommRequest:
    """One reusable communication request (the analog of a cached CommRequestImpl).

    Lifecycle: construct -> setup() -> start(buf) / wait() / test() any number
    of times. ``start`` never blocks; ``wait`` returns the result tensor."""

    _seq_lock = threading.Lock()
    _seq = 0

    def __init__(self, desc: CommDesc, dispatcher: "Dispatcher", name: str = ""):
        self.desc = desc
        self.dispatcher = dispatcher
        self.name = name
        self._fns: List[Callable] = []
        self._chunk_slices: List[slice] = [slice(None)]
        self._quant_fns: Optional[List[Callable]] = None
        self._err_lens: Optional[List[int]] = None
        self._errs: Optional[List[torch.Tensor]] = None   # error-feedback state
        self._results: List[torch.Tensor] = []
        self._result: Optional[torch.Tensor] = None
        self._event = None
        self._ready = None      # event on the caller's stream at start (CUDA)
        self._dispatched = False
        self._dispatch_error: Optional[BaseException] = None
        self._epoch = 0         # bumped by every start; a stale queue entry is dropped
        self._dlock = threading.Lock()
        self.is_started = False
        self.is_setup = False
        self.algo = algos.DEFAULT
        self._payload = desc.payload_bytes()
        self._plain_build: Optional[Callable] = None
        self._plain_fns: Optional[List[Callable]] = None
        # the codec: the resolved registry name and its source, the wire
        # accounting (codec label, compressed bytes of one payload), the
        # registry geometry a chunk, the demotion latch and the residual a
        # demotion leaves for the next round
        self.codec_name = ""
        self.codec_source = ""
        self._wire_rec: Optional[tuple] = None
        self._codec_geoms: Optional[List[dict]] = None
        self._codec_demoted = False
        self._pending_flush: Optional[tuple] = None
        # the residual's layout ('ring', 'flat' or 'hier') and, for 'hier',
        # (L, the members' intra-tier ranks (R, D, S, M)): what a flush reads
        self._err_layout = "ring"
        self._hier_meta: Optional[tuple] = None
        # the recovery ladder: the subsystem breaker (None for a request with
        # no degradable subsystem, the plain 'lax' path), the lax fallback of
        # a forced or tuned algorithm, the last Start's buffer (a wait-side
        # retry starts it again) and the residuals at Start (every
        # re-attempt rewinds to them)
        self._breaker: Optional[supervisor.CircuitBreaker] = None
        self._degrade_subsys: Optional[str] = None
        self._lax_kw: Optional[dict] = None
        self._lax_fns: Optional[List[Callable]] = None
        self._degrade_fns: Optional[tuple] = None
        self._last_buf: Optional[torch.Tensor] = None
        self._ef_snapshot: Optional[List[torch.Tensor]] = None
        self._started_at: Optional[float] = None   # the watchdog's stamp
        with CommRequest._seq_lock:
            CommRequest._seq += 1
            self.uid = CommRequest._seq
        self._trace_name = f"mlsl:{desc.kind}:{name or self.uid}"

    # -- setup ------------------------------------------------------------

    def setup(self) -> None:
        d = self.desc
        mlsl_assert(d.compression in (CompressionType.NONE, CompressionType.QUANTIZATION,
                                      CompressionType.TOPK),
                    "compression %s is not supported", CompressionType(d.compression).name)
        if d.compression == CompressionType.TOPK:
            mlsl_assert(d.kind in ("allreduce", "reduce_scatter")
                        and d.op in (None, ReductionType.SUM),
                        "TOPK compression supports allreduce/reduce_scatter SUM only "
                        "(got %s/%s)", d.kind, d.op)
            _check_recv_count(d)
            self._setup_sparse(self.dispatcher.config.topk_ratio)
            return
        if d.compression == CompressionType.QUANTIZATION and d.kind in (
            "allreduce", "reduce_scatter",
        ):
            mlsl_assert(d.op in (None, ReductionType.SUM),
                        "quantized collectives support SUM only (got %s)", d.op)
            _check_recv_count(d)
            self._setup_compressed()
            return
        if d.kind == "barrier":
            self._fns = [collectives.build_barrier(d.group)]
            self.is_setup = True
            return
        kw = {}
        if d.op is not None:
            kw["op"] = ReductionType(d.op)
        if d.root is not None:
            kw["root"] = int(d.root)
        if d.recv_count is not None:
            kw["recv_count"] = int(d.recv_count)
        if d.recv_counts is not None and d.kind != "alltoallv":
            # alltoallv's recv_counts may be a (G, G) matrix: normalize_alltoallv
            # reads it
            kw["recv_counts"] = tuple(int(c) for c in d.recv_counts)
        if d.kind == "alltoall":
            kw["send_count"] = int(d.count)
        if d.kind == "sendrecv":
            kw["pairs"] = tuple((int(a), int(b)) for a, b in d.pairs)
        if d.kind == "alltoallv":
            kw.update(normalize_alltoallv(d))
        # explicit config > tuned profile > the 'lax' baseline; a chunked
        # request selects once, on the full payload, and reuses one program
        cfg = self.dispatcher.config
        self.algo = algos.select(d.kind, d.group, self._payload, d.compression, cfg,
                                 op=kw.get("op"))
        if self.algo == "pallas_a2a":
            kw["block"] = cfg.quant_block_elems
            kw["quantized"] = cfg.pallas_a2a_quant
        chunks = self._plan_chunks()
        fn = algos.build(d.kind, d.group, self.algo, bidir=cfg.pallas_ring_bidir, **kw)
        self._plain_build = lambda: [algos.build(   # noqa: E731
            d.kind, d.group, self.algo, bidir=cfg.pallas_ring_bidir, plain=True, **kw)]
        self._chunk_slices = chunks or [slice(None)]
        self._fns = [fn] * len(self._chunk_slices)
        self._breaker = self._degrade_subsys = None
        self._lax_fns = None
        if self.algo != algos.DEFAULT:
            # a forced or tuned algorithm degrades to the 'lax' baseline per
            # dispatch; the baseline has no lower rung
            self._breaker = supervisor.breaker("algo")
            self._degrade_subsys = "algo"
            self._lax_kw = {k: v for k, v in kw.items() if k in collectives.BUILD_KW}
        self.is_setup = True

    def _setup_sparse(self, ratio: float) -> None:
        """The top-k sparse wire (comm/sparse.py): one program, a residual in
        the logical layout."""
        from mlsl_tpu_torch.comm import sparse

        d = self.desc
        fn, el = sparse.build_sparse_collective(d.kind, d.group, d.count, ratio)
        self._quant_fns, self._err_lens, self._errs = [fn], [el], None
        self._chunk_slices = [slice(None)]
        self._plain_build = lambda: [fn]     # noqa: E731 (no kernel: its own twin)
        self._plain_fns = None
        self._err_layout = "flat"
        self.algo = "topk"
        # the sparse wire rides the codec subsystem's breaker
        self._breaker = supervisor.breaker("quant")
        self._degrade_subsys = "quant"
        self._degrade_fns = None
        # the sparse image: k (value, index) pairs of the whole payload
        self._wire_rec = ("topk", 8 * max(1, int(d.count * ratio)))
        self.is_setup = True

    def _setup_compressed(self) -> None:
        """A QUANTIZATION allreduce / reduce_scatter: resolve the codec (a user
        codec, then ``desc.codec``, then ``codecs.assigned``; int8 once
        demoted) and build its programs, one a chunk of a large message
        (request.py:209-430 of the JAX package). Called again by a
        calibration's re-route and by ``demote_codec``."""
        from mlsl_tpu_torch import codecs as codecs_mod
        from mlsl_tpu_torch.comm import codec as codec_mod
        from mlsl_tpu_torch.comm import quant_ring

        d = self.desc
        cfg = self.dispatcher.config
        custom = getattr(cfg, "custom_codec", None)
        self._quant_fns = self._err_lens = self._errs = None
        self._plain_fns = None
        self._codec_geoms = None
        self._degrade_fns = None
        # codec faults count against the quant breaker; once it trips the
        # dispatch degrades to the plain float32 SUM, residual flushed
        self._breaker = supervisor.breaker("quant")
        self._degrade_subsys = "quant"
        reg_name, reg_cell, reg_src = "int8", None, "default"
        if custom is None:
            if self._codec_demoted:
                reg_name, reg_src = "int8", "demoted"
            elif d.codec:
                reg_name, reg_src = d.codec, "desc"
            else:
                reg_name, reg_cell, reg_src = codecs_mod.assigned(cfg, self.name)
        self.codec_name = "custom" if custom is not None else reg_name
        self.codec_source = "custom" if custom is not None else reg_src
        block = int(d.quant_block or (reg_cell or {}).get("block", 0) or cfg.quant_block_elems)
        if custom is None and reg_name == "topk":
            # the registry's route into the sparse wire, its ratio from the cell
            ratio = float((reg_cell or {}).get("params", {}).get("ratio", 0) or cfg.topk_ratio)
            self._setup_sparse(ratio)
            if reg_src == "calibrated":
                codecs_mod.guard_register(self)
            return
        chunks = self._plan_chunks()
        self._chunk_slices = chunks or [slice(None)]
        sizes = [sl.stop - sl.start for sl in chunks] if chunks else [d.count]
        reg_codec = None
        if custom is not None or reg_name != "int8":
            if custom is not None:
                wire, self.algo = custom, "custom_codec"
            else:
                reg_codec = codecs_mod.configure(reg_name, cfg, reg_cell)
                wire, self.algo = reg_codec.as_custom(), f"codec:{reg_name}"
            built = [codec_mod.build_custom_collective(d.kind, d.group, n, wire) for n in sizes]
            fns = [fn for fn, _ in built]
            self._plain_build = lambda: fns      # noqa: E731 (no kernel of its own)
        else:
            # a forced or tuned 'pallas_ring' routes the same compressed wire
            # through the fused int8 ring kernel (quant_ring ring='pallas'),
            # a forced or tuned 'hier' through the two-tier wire, whose codec
            # applies on the DCN hop only (ring='hier')
            sel = algos.select(d.kind, d.group, self._payload, d.compression, cfg, op=d.op)
            if sel == "hier":
                self.algo = "hier"
                qkw = dict(ring="hier", dcn_codec=cfg.hier_dcn_codec,
                           topk_ratio=cfg.topk_ratio)
            else:
                fused = sel == "pallas_ring"
                self.algo = "pallas_ring" if fused else "quant_ring"
                qkw = dict(ring="pallas" if fused else "lax", bidir=cfg.pallas_ring_bidir)
            built = [quant_ring.build_quantized_collective(d.kind, d.group, n, block, **qkw)
                     for n in sizes]
            self._plain_build = lambda: [quant_ring.build_quantized_collective(   # noqa: E731
                d.kind, d.group, n, block, plain=True, **qkw)[0] for n in sizes]
        self._quant_fns = [fn for fn, _ in built]
        self._err_lens = [el for _, el in built]
        if self.algo == "hier":
            # each member's residual covers its own 1/L shard; a flush puts
            # it back at the shard's logical offset through the members'
            # intra-tier ranks (request.py:379-389 of the JAX package)
            from mlsl_tpu_torch.comm.algos import hier

            self._err_layout = "hier"
            self._hier_meta = (hier.tier_structure(d.group)[1], hier.intra_positions(d.group))
        else:
            self._err_layout = "ring"
        # the wire accounting: the compressed image of one full payload
        g = 1 if d.group.is_self else d.group.size
        if reg_codec is not None:
            rs = d.kind == "reduce_scatter"
            self._codec_geoms = []
            for n, el in zip(sizes, self._err_lens):
                geom = reg_codec.geometry(n // g if rs else -(-n // g))
                geom.update(err_len=int(el), hops=g)
                self._codec_geoms.append(geom)
            self._wire_rec = (reg_name, sum(reg_codec.wire_len(n) for n in sizes))
        elif custom is not None:
            self._wire_rec = ("custom", sum(codec_mod.wire_bytes(custom, n) for n in sizes))
        else:
            int8 = codecs_mod.get("int8", block=block)
            self._wire_rec = ("int8", sum(int8.wire_len(n) for n in sizes))
        if reg_src == "calibrated" and reg_name != "int8":
            # under the guardrail: demoted to int8 on a sustained loss breach
            codecs_mod.guard_register(self)
        self.is_setup = True

    def _flush_fn(self) -> Callable:
        """(buf, residuals) -> buf as float32 plus each chunk's residual in the
        logical layout at its slice: how a demotion delivers the old wire's
        undelivered gradient (``_degrade_programs``' flush, request.py:839-877
        of the JAX package). The residual's layout is the wire's: logical
        already (``flat``, the sparse wire), the ring's chunks (``ring``), or
        each member's own shard (``hier``, placed by ``hier.flush_residual``
        at the member's intra-tier offset)."""
        from mlsl_tpu_torch.comm.quant_ring import logical_residual

        d = self.desc
        g = 1 if d.group.is_self else d.group.size
        rs = d.kind == "reduce_scatter"
        layout = self._err_layout
        slices = list(self._chunk_slices)
        sizes = [d.count if sl == slice(None) else sl.stop - sl.start for sl in slices]
        lens = list(self._err_lens)
        if layout == "hier":
            from mlsl_tpu_torch.comm.algos import hier

            hier_l, l_np = self._hier_meta
            l_idx = torch.from_numpy(l_np)

        def flush(buf, errs):
            x = buf.to(torch.float32).clone()
            for sl, n, el, e in zip(slices, sizes, lens, errs):
                if layout == "flat":
                    res = e
                elif layout == "hier":
                    res = hier.flush_residual(e, l_idx.to(e.device), hier_l, el, n)
                else:
                    res = logical_residual(e, g, el // g, n // g if rs else -(-n // g), n)
                x[..., sl] += res
            return x

        return flush

    def _take_residuals(self) -> List[torch.Tensor]:
        """Consume the residuals (zeros before a first round): the flush
        delivers them, and the next program starts from zero feedback."""
        topo = self.desc.group.topology
        errs = self._errs if self._errs is not None else [
            torch.zeros((*topo.grid_shape, el), dtype=torch.float32, device=self.dispatcher.device)
            for el in self._err_lens]
        self._errs = None
        return errs

    def demote_codec(self, reason: str = "") -> None:
        """The guardrail's demotion (``codecs.guard_note``): pin this
        request's wire to int8. The old wire's residual is taken now and
        added once to the payload of the next round that succeeds; from then
        on the programs are the plain int8 build, bit for bit
        (request.py:917-951 of the JAX package)."""
        from mlsl_tpu_torch import codecs as codecs_mod

        with self._dlock:
            if (self._codec_demoted or self.desc.compression != CompressionType.QUANTIZATION
                    or self._quant_fns is None):
                return
            label = self.algo
            self._pending_flush = (self._flush_fn(), self._take_residuals())
            self._codec_demoted = True
            self._ef_snapshot = None
            self.setup()
        codecs_mod.guard_unregister(self)
        stats.record_codec_demotion(self.name or str(self.uid), label, reason or "guardrail")
        log_warning("codec guardrail: %s demoted %s -> int8 (%s); its residual goes out with "
                    "the next round", self.name or self.uid, label, reason or "guardrail")

    def _plan_chunks(self):
        """Chunk only elementwise-decomposable hot collectives (allreduce)."""
        d = self.desc
        cfg = self.dispatcher.config
        if d.kind != "allreduce":
            return None
        threshold = cfg.large_msg_size_mb * 1024 * 1024
        if threshold <= 0 or d.payload_bytes() <= threshold or cfg.large_msg_chunks <= 1:
            return None
        k = min(cfg.large_msg_chunks, d.count)
        bounds = np.linspace(0, d.count, k + 1).astype(int)
        return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]

    # -- start/wait/test --------------------------------------------------

    def precompile(self) -> int:
        """Run each of the request's programs once on a zero buffer, so that
        the first timed round builds no kernel and allocates no table
        (``mlsl_tpu.comm.request.CommRequest.precompile``). The round state
        (results, error-feedback residuals, ``is_started``) is left as it
        was. -> the number of programs run."""
        mlsl_assert(self.is_setup, "request must be setup() before precompile()")
        d = self.desc
        topo = d.group.topology
        dev = self.dispatcher.device
        buf = torch.zeros((*topo.grid_shape, max(d.send_len(), 1)),
                          dtype=torch_dtype(d.data_type), device=dev)
        n, seen = 0, set()
        fns = self._quant_fns if self._quant_fns is not None else self._fns
        for i, (fn, sl) in enumerate(zip(fns, self._chunk_slices)):
            key = (id(fn), (sl.stop or 0) - (sl.start or 0))
            if key in seen:
                continue
            seen.add(key)
            x = buf[..., sl]
            # the warm passes no chaos site: it must not spend an armed budget
            fn = collectives.unwrap_chaos(fn)
            if self._quant_fns is not None:
                fn(x, torch.zeros((*topo.grid_shape, self._err_lens[i]), dtype=torch.float32,
                                  device=dev))
            else:
                fn(x)
            n += 1
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return n

    def plain_result(self, buf: torch.Tensor, errs=None):
        """This request's round on ``buf`` through the plain versions of its
        algorithm's kernels, on any device, chunk by chunk as the request
        runs it; a quantized request starts from the residuals ``errs``
        (zeros when None). -> (result, new residuals or None). The card's
        checks hold each kernel-driven round to it, bit for bit."""
        mlsl_assert(self._plain_build is not None,
                    "request %s has no plain version (a barrier)", self.name or self.uid)
        if self._plain_fns is None:
            # a check: the plain versions pass no chaos site
            self._plain_fns = [collectives.unwrap_chaos(f) for f in self._plain_build()]
        buf = self.desc.group.topology.adopt_buffer(buf)
        if self._quant_fns is None:
            fn = self._plain_fns[0]
            outs = [fn(buf[..., sl]) for sl in self._chunk_slices]
            return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)), None
        grid = buf.shape[:NUM_GRID_AXES]
        outs, new = [], []
        for i, (fn, sl) in enumerate(zip(self._plain_fns, self._chunk_slices)):
            e = (errs[i] if errs is not None else
                 torch.zeros((*grid, self._err_lens[i]), dtype=torch.float32,
                             device=buf.device))
            res, ne = fn(buf[..., sl], e)
            outs.append(res)
            new.append(ne)
        return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)), new

    def start(self, buf: torch.Tensor, *, _rewind_ef: bool = False) -> "CommRequest":
        """``_rewind_ef`` (a wait-side retry only): put the residuals back to
        the previous Start's inside the epoch bump, so that the replay
        quantizes from the state the suspect round saw."""
        mlsl_assert(self.is_setup, "request must be setup() before start()")
        if chaos._plans:
            chaos.inject("request.start", request=self.name or self.uid, kind=self.desc.kind)
        chkp = checker.level()
        if chkp:
            # the buffer as handed over, before a cross-distribution re-view
            checker.check_buffer(buf, self.desc, chkp)
        topo = self.desc.group.topology
        # a cross-distribution graph edge hands a buffer laid out for the
        # other distribution's grid (activation cases 3-5): re-view it
        buf = topo.adopt_buffer(buf)
        mlsl_assert(
            buf.dim() == NUM_GRID_AXES + 1
            and tuple(buf.shape[:NUM_GRID_AXES]) == topo.grid_shape,
            "buffer must have shape (R=%d, D=%d, S=%d, M=%d, n), got %s",
            *topo.grid_shape, tuple(buf.shape),
        )
        with self._dlock:
            self._epoch += 1
            if _rewind_ef:
                self._ef_restore()
            self._results = []
            self._result = None
            self._event = None
            self._dispatched = False
            self._dispatch_error = None
            self._ready = None
            if buf.device.type == "cuda":
                # the dispatch may run on the progress thread, whose current
                # stream is not the caller's: it waits on this event instead
                self._ready = torch.cuda.Event()
                self._ready.record(torch.cuda.current_stream(buf.device))
            self.is_started = True
            self._started_at = time.monotonic()
            self._last_buf = buf
            self._ef_snapshot = list(self._errs) if self._errs is not None else None
        tr = obs._tracer
        if tr is not None:
            tr.instant("submit", "req", track=self._trace_name, req=self.name or self.uid,
                       epoch=self._epoch, bytes=self._payload)
        if self._wire_rec is not None:
            stats.record_codec_wire(*self._wire_rec)
        self.dispatcher.submit(self, buf)
        return self

    def _dispatch(self, buf: torch.Tensor, epoch: Optional[int] = None) -> None:
        """Launch the collective (called by the Dispatcher): on the comm stream
        for a CUDA buffer, in place on the CPU. ``epoch`` is the request's
        epoch when the dispatch was queued: a later ``start`` superseded an
        entry whose epoch differs, and it is dropped. A queued dispatch that
        fails records the error for ``wait``/``test``; a direct one raises."""
        with self._dlock:
            if epoch is not None and epoch != self._epoch:
                return
            tr = obs._tracer
            t0 = tr.now() if tr is not None else 0
            try:
                self._launch(buf)
            except Exception as e:
                if tr is not None:
                    tr.instant("dispatch.error", "req", track=self._trace_name,
                               req=self.name or self.uid, error=repr(e))
                if epoch is None:
                    raise
                self._dispatch_error = e
            else:
                if tr is not None:
                    # host time of the enqueue: the device's completion lands
                    # in the wait span
                    tr.complete("dispatch", "req", t0, track=self._trace_name,
                                req=self.name or self.uid, epoch=self._epoch, algo=self.algo)
            self._dispatched = True

    def _launch(self, buf: torch.Tensor) -> None:
        """The ladder on the comm stream for a CUDA buffer (every attempt,
        the degraded one included, is ordered before the event a wait takes),
        in place on the CPU."""
        stream = self.dispatcher.stream_for(buf.device)
        if stream is None:
            self._dispatch_ladder(buf)
            return
        with torch.cuda.device(buf.device):
            stream.wait_event(self._ready)
            with torch.cuda.stream(stream):
                self._dispatch_ladder(buf)
                event = torch.cuda.Event()
                event.record(stream)
        # the caller's stream allocated buf: its memory must not be
        # recycled while the comm stream still reads it
        buf.record_stream(stream)
        self._event = event

    def _dispatch_ladder(self, buf: torch.Tensor) -> None:
        """Rungs 2 and 3 around one dispatch (the caller holds ``_dlock``;
        request.py:721-797 of the JAX package). TRANSIENT failures retry in
        place with jittered exponential backoff; CORRUPTION and PERSISTENT
        failures count against the request's breaker, and once it is OPEN --
        the tripping failure included -- the dispatch is served by the
        degraded path instead of raising. A healthy dispatch while the
        breaker is HALF_OPEN is the probe: its success re-closes it.
        DEVICE_LOSS and FATAL failures raise untouched. The backoff sleeps in
        place, on the progress thread for a deferred request."""
        br = self._breaker
        attempt = 0
        forced_degrade = False
        while True:
            degraded = forced_degrade or (br is not None and not br.allow())
            try:
                if degraded:
                    self._dispatch_degraded(buf)
                else:
                    self._dispatch_inner(buf)
            except Exception as e:
                # any re-attempt replays the round from the Start residuals
                self._ef_restore()
                cfg = self.dispatcher.config
                cls = supervisor.classify(e)
                if cls is supervisor.ErrorClass.TRANSIENT and attempt < cfg.comm_retries:
                    delay = supervisor.jittered_backoff(cfg.comm_retry_backoff_s, attempt)
                    stats.record_comm_retry("dispatch", self.name or str(self.uid), e,
                                            attempt + 1, delay)
                    log_debug("transient dispatch failure of %s (%s); retry %d in %.3fs",
                              self.name or self.uid, e, attempt + 1, delay)
                    attempt += 1
                    time.sleep(delay)
                    continue
                if cls is supervisor.ErrorClass.DEVICE_LOSS:
                    # capacity left the world: a fallback on the same ranks
                    # would mask the loss
                    raise
                if (not degraded and br is not None and cls is not supervisor.ErrorClass.FATAL
                        and br.record_failure(e)):
                    # OPEN now: serve THIS dispatch degraded, without asking
                    # allow() again (a zero cooldown must not ping-pong)
                    forced_degrade = True
                    continue
                raise
            else:
                if br is not None and not degraded:
                    br.record_success()   # a no-op unless HALF_OPEN (the probe)
                if "request.wait" not in chaos._plans:
                    # no wait-side retry can replay this round (that site is
                    # the only TRANSIENT failure a wait sees after a dispatch
                    # that succeeded): the retry buffer and the previous
                    # residuals go now, not at the end of the round
                    self._last_buf = None
                    self._ef_snapshot = None
                return

    def _dispatch_inner(self, buf: torch.Tensor) -> None:
        # per-algorithm launch attribution, as at request.py:953-956
        stats.record_algo_dispatch(self.desc.kind, self.algo)
        self._results = self._run(buf)

    def _dispatch_degraded(self, buf: torch.Tensor) -> None:
        """Rung 3's dispatch (request.py:799-830 of the JAX package): a
        compressed wire runs the plain float32 SUM with the residual flushed
        into the payload (delivered once, not dropped); a forced or tuned
        algorithm runs the ``lax`` baseline. The result has the healthy
        path's shape and dtype; only the statistics tell a degraded round
        from a healthy one."""
        d = self.desc
        stats.record_degrade(self._degrade_subsys or "?", "fallback")
        if self._quant_fns is not None:
            pf = self._pending_flush
            if pf is not None:
                # a breaker degrade racing a codec demotion: the demoted
                # codec's residual still rides this round
                buf = pf[0](buf, pf[1])
            flush, plain = self._degrade_programs()
            out = plain(flush(buf, self._take_residuals()))
            self._results = [out]
            self._pending_flush = None
            stats.record_algo_dispatch(d.kind, "degraded-plain")
            return
        if self._lax_fns is None:
            fn = algos.build(d.kind, d.group, algos.DEFAULT, **self._lax_kw)
            self._lax_fns = [fn] * len(self._chunk_slices)
        stats.record_algo_dispatch(d.kind, algos.DEFAULT)
        self._results = [fn(buf[..., sl]) for fn, sl in zip(self._lax_fns, self._chunk_slices)]

    def _degrade_programs(self) -> tuple:
        """(flush, plain SUM) of the degraded compressed path, built at the
        first degrade: the flush is ``_flush_fn``, the plain SUM the
        uncompressed request's program (``collectives.build_plain_fallback``)."""
        if self._degrade_fns is None:
            d = self.desc
            self._degrade_fns = (self._flush_fn(),
                                 collectives.build_plain_fallback(d.kind, d.group, d.count))
        return self._degrade_fns

    def _ef_restore(self) -> None:
        """Rewind the residuals to the Start snapshot before a re-attempt: a
        failed chunked dispatch may have advanced some of them, a degraded
        one consumed them; the replay must see what the first attempt saw."""
        snap = self._ef_snapshot
        self._errs = list(snap) if snap is not None else None

    def _run(self, buf: torch.Tensor) -> List[torch.Tensor]:
        if self._quant_fns is not None:
            pf = self._pending_flush
            if pf is not None:
                # a demotion's residual rides this round's payload; it is
                # cleared only once the round succeeds, so it lands once
                buf = pf[0](buf, pf[1])
            if self._errs is None:
                self._errs = [
                    torch.zeros((*buf.shape[:NUM_GRID_AXES], el), dtype=torch.float32,
                                device=buf.device)
                    for el in self._err_lens
                ]
            out = []
            for i, (fn, sl) in enumerate(zip(self._quant_fns, self._chunk_slices)):
                res, self._errs[i] = fn(buf[..., sl], self._errs[i])
                out.append(res)
            self._pending_flush = None
            return out
        return [fn(buf[..., sl]) for fn, sl in zip(self._fns, self._chunk_slices)]

    def _assemble(self) -> torch.Tensor:
        if self._result is None:
            if len(self._results) == 1:
                self._result = self._results[0]
            else:
                self._result = torch.cat(self._results, dim=-1)
        return self._result

    # -- watchdog ----------------------------------------------------------

    def _watchdog_deadline(self, timeout: Optional[float]) -> Optional[float]:
        """The absolute deadline of this wait, from the Start stamp: the
        watchdog bounds the whole time in flight, not the time in wait()."""
        t = timeout
        if t is None:
            t = getattr(self.dispatcher.config, "watchdog_timeout_s", 0.0)
        if not t or t <= 0:
            return None
        return (self._started_at or time.monotonic()) + t

    def describe(self) -> str:
        """One-line descriptor of the request (the watchdog's log); a breaker
        off CLOSED is part of it while it lasts."""
        d = self.desc
        s = (f"{d.kind} name={self.name or self.uid} algo={self.algo} "
             f"count={d.count} dtype={DataType(d.data_type).name} axes={d.group.axes} "
             f"payload={self._payload}B epoch={self._epoch}")
        br = self._breaker
        if br is not None and br.state != supervisor.CLOSED:
            s += f" breaker={br.name}:{br.state}"
        return s

    def _watchdog_trip(self, phase: str) -> None:
        """Log the stuck descriptor, keep the event record (with the tracer's
        flight record) and raise the recoverable timeout."""
        waited = time.monotonic() - (self._started_at or time.monotonic())
        desc = self.describe()
        tr = obs._tracer
        if tr is not None:
            # on the stuck request's own track, before the flight record is
            # cut, so that the record holds it
            tr.instant("watchdog.trip", "watchdog", track=self._trace_name,
                       req=self.name or self.uid, phase=phase,
                       waited_s=round(waited, 3), descriptor=desc)
        stats.record_watchdog_event(desc, phase, waited)
        raise MLSLTimeoutError(f"watchdog: request stuck in {phase} for {waited:.2f}s: {desc}")

    def _block_ready(self, deadline: Optional[float]) -> None:
        """With a deadline, poll the round's event until it is done or the
        deadline trips (an exponential backoff from 10 us to 1 ms); without
        one, return at once (wait orders the caller's stream after it)."""
        if deadline is None or self._event is None:
            return
        delay = 1e-5
        while not self._event.query():
            if time.monotonic() > deadline:
                self._watchdog_trip("wait")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    # -- wait/test ---------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> torch.Tensor:
        # A completed request can be wait()ed any number of times (MPI_Wait on
        # a completed request returns immediately).
        if not self.is_started and self._result is not None:
            return self._result
        mlsl_assert(self.is_started, "request was not started")
        tr = obs._tracer
        t0 = tr.now() if tr is not None else 0
        attempt = 0
        while True:
            try:
                out = self._wait_inner(timeout)
            except Exception as e:
                # rung 2 on the wait side: a TRANSIENT failure at wait starts
                # the stored buffer again (the round in flight is suspect)
                cfg = self.dispatcher.config
                if (supervisor.classify(e) is not supervisor.ErrorClass.TRANSIENT
                        or attempt >= cfg.comm_retries or self._last_buf is None):
                    # the round fails: its queued verdicts go to the log, so
                    # that a later healthy round cannot inherit them
                    self._drain_chkp_logged()
                    raise
                delay = supervisor.jittered_backoff(cfg.comm_retry_backoff_s, attempt)
                stats.record_comm_retry("wait", self.name or str(self.uid), e, attempt + 1,
                                        delay)
                log_debug("transient wait failure of %s (%s); restarting, retry %d in "
                          "%.3fs", self.name or self.uid, e, attempt + 1, delay)
                attempt += 1
                time.sleep(delay)
                self.start(self._last_buf, _rewind_ef=True)
                continue
            break
        self._finish_round()
        if checker._pending:
            # the round's boundary: one host read resolves every finiteness
            # verdict queued since the last completion (MLSL_CHKP=2)
            checker.flush_values()
        if tr is not None:
            # the wait stall: host time blocked for this request
            tr.complete("wait", "req", t0, track=self._trace_name,
                        req=self.name or self.uid, epoch=self._epoch, algo=self.algo)
        m = obs_metrics._registry
        if m is not None:
            self._record_done_metrics(m)
        return out

    def _wait_inner(self, timeout: Optional[float]) -> torch.Tensor:
        """One wait attempt: the chaos site, the dispatch drain, the error,
        the stream order, the result."""
        if chaos._plans:
            chaos.inject("request.wait", request=self.name or self.uid, kind=self.desc.kind)
        deadline = self._watchdog_deadline(timeout)
        self.dispatcher.wait_dispatched(self, deadline)
        self._raise_dispatch_error()
        mlsl_assert(self._dispatched, "request %s was never dispatched", self.name or self.uid)
        self._block_ready(deadline)
        self._order_results()
        return self._assemble()

    def _order_results(self) -> None:
        if self._event is not None:
            # the comm stream allocated the results; the caller's stream now
            # uses them too
            cur = torch.cuda.current_stream(self._results[0].device)
            cur.wait_event(self._event)
            for t in self._results:
                t.record_stream(cur)

    def _drain_chkp_logged(self) -> None:
        """Resolve the queued finiteness verdicts of a failing round without
        letting a violation replace the round's own error: it is logged (and
        counted), and the queue is clean for the next round."""
        if not checker._pending:
            return
        try:
            checker.flush_values()
        except MLSLError as ce:
            log_warning("CHKP verdicts from the failed round of %s: %s",
                        self.name or self.uid, ce)

    def _finish_round(self) -> None:
        """The round is over: the retry buffer and the residual snapshot are
        needed only in flight."""
        self.is_started = False
        self._last_buf = None
        self._ef_snapshot = None

    def test(self) -> tuple:
        """Non-blocking completion poll -> (is_completed, result_or_None)."""
        if not self.is_started:
            return True, self._result
        if chaos._plans:
            chaos.inject("request.test", request=self.name or self.uid, kind=self.desc.kind)
        self.dispatcher.wait_dispatched(self)
        if self._dispatch_error is not None:
            self._drain_chkp_logged()
        self._raise_dispatch_error()
        if self._event is not None and not self._event.query():
            return False, None
        self._order_results()
        out = self._assemble()
        self._finish_round()
        if checker._pending:
            checker.flush_values()
        tr = obs._tracer
        if tr is not None:
            tr.instant("test.done", "req", track=self._trace_name,
                       req=self.name or self.uid, epoch=self._epoch)
        m = obs_metrics._registry
        if m is not None:
            self._record_done_metrics(m)
        return True, out

    def _raise_dispatch_error(self) -> None:
        """Re-raise a failure of a queued dispatch, once, and end the round."""
        if self._dispatch_error is not None:
            err, self._dispatch_error = self._dispatch_error, None
            self.is_started = False
            raise err

    def _record_done_metrics(self, m) -> None:
        """At a completed round with the registry armed: the dispatch-to-wait
        latency and the achieved algbw (payload over time in flight, host
        clock), by algorithm and tier shape."""
        started = self._started_at
        if not started:
            return
        waited_s = time.monotonic() - started
        m.observe("mlsl_dispatch_wait_ms", waited_s * 1e3, kind=self.desc.kind)
        if waited_s > 0 and self._payload:
            m.observe("mlsl_algbw_gbps", self._payload / waited_s / 1e9,
                      buckets=obs_metrics.ALGBW_BUCKETS_GBPS, algo=self.algo,
                      tier="two-tier" if self.algo == "hier" else "flat")


def in_graph_descriptor(kind: str, name: str, algo: str, count: int,
                        data_type: DataType, group: ProcessGroup) -> str:
    """One-line descriptor of a collective round of the compiled overlap
    engine (comm/overlap.py), which constructs no CommRequest: the grammar of
    the JAX package's ``CommRequest.describe`` field for field, with
    ``in_graph=1`` in place of the epoch (request.py:1238-1251)."""
    payload = count * dtype_size(data_type)
    return (f"{kind} name={name} algo={algo} count={count} "
            f"dtype={DataType(data_type).name} axes={group.axes} "
            f"payload={payload}B in_graph=1")


def _check_recv_count(d: CommDesc) -> None:
    """Compressed reduce_scatter derives recv_count as count // group_size; a
    caller-supplied value that disagrees would silently change placement."""
    if d.kind != "reduce_scatter" or d.recv_count is None:
        return
    g = d.group.size
    mlsl_assert(
        d.recv_count == d.count // g,
        "compressed reduce_scatter recv_count %d != count//group %d",
        d.recv_count, d.count // g,
    )


def normalize_alltoallv(d: CommDesc) -> dict:
    """Expand the user's alltoallv count and offset arrays into full static
    matrices (``_normalize_alltoallv``, request.py:1296-1340 of the JAX
    package). MPI semantics: S[i][j] = elements member i sends to member j. A
    1-D array means the same on every rank (S[i][j] = counts[j]); a (G, G)
    array is the full matrix, the same for every group instance. Offsets
    default to the packed layout. The receive matrix is derived, R[i][j] =
    S[j][i], and explicit recv_counts must equal it. (W, G) arrays (W != G)
    select the per-rank form."""
    g = d.group.size
    w = d.group.topology.world_size
    a = np.asarray(d.send_counts, dtype=int)
    if a.ndim == 2 and a.shape == (w, g) and w != g:
        return _normalize_alltoallv_per_rank(d, a)

    def packed(mat):
        return np.hstack([np.zeros((g, 1), int), np.cumsum(mat, axis=1)[:, :-1]])

    def expand(arr):
        a = np.asarray(arr, dtype=int)
        if a.ndim == 1:
            return np.tile(a, (g, 1))
        mlsl_assert(a.shape == (g, g), "counts/offsets matrix must be (%d,%d)", g, g)
        return a

    s = expand(d.send_counts)
    soff = packed(s) if d.send_offsets is None else expand(d.send_offsets)
    r = s.T
    if d.recv_counts is not None:
        # MPI requires recvcounts[i][j] == sendcounts[j][i]
        mlsl_assert(np.array_equal(expand(d.recv_counts), r),
                    "alltoallv recv_counts do not match transposed send_counts")
    roff = packed(r) if d.recv_offsets is None else expand(d.recv_offsets)
    recv_len = int(np.max(roff + r)) if g > 0 else 1
    to_t = lambda m: tuple(tuple(int(v) for v in row) for row in m)   # noqa: E731
    return dict(S=to_t(s), Soff=to_t(soff), Roff=to_t(roff), recv_len=max(recv_len, 1))


def _normalize_alltoallv_per_rank(d: CommDesc, s: np.ndarray) -> dict:
    """Per-rank form: each world rank's own (G,) count and offset rows,
    stacked as (W, G) arrays (``_normalize_alltoallv_per_rank``,
    request.py:1342-1390). The receive geometry is derived through the member
    table, R[w][j] = S[member j of w's instance][position of w]; explicit
    recv_counts must equal it (MPI's pairwise invariant)."""
    g = d.group.size
    w = d.group.topology.world_size
    mlsl_assert(
        d.group.is_uniform,
        "per-rank alltoallv requires equal-size groups (ragged partitions are "
        "spelled with zero counts on an equal-size group)",
    )
    m = collectives.member_world_table(d.group)
    pos = np.array([list(m[p]).index(p) for p in range(w)], dtype=int)

    def packed(mat):
        return np.hstack([np.zeros((w, 1), int), np.cumsum(mat, axis=1)[:, :-1]])

    def expand(arr, name):
        a = np.asarray(arr, dtype=int)
        if a.ndim == 1:
            a = np.tile(a, (w, 1))
        mlsl_assert(a.shape == (w, g),
                    "per-rank alltoallv %s must be (world=%d, group=%d), got %s",
                    name, w, g, a.shape)
        return a

    soff = packed(s) if d.send_offsets is None else expand(d.send_offsets, "send_offsets")
    r = s[m, pos[:, None]]
    if d.recv_counts is not None:
        mlsl_assert(
            np.array_equal(expand(d.recv_counts, "recv_counts"), r),
            "alltoallv recv_counts violate the MPI pairwise invariant: "
            "recv_counts[w][j] must equal member j's send count toward w",
        )
    roff = packed(r) if d.recv_offsets is None else expand(d.recv_offsets, "recv_offsets")
    recv_len = int(np.max(roff + r)) if r.size else 1
    to_t = lambda m_: tuple(tuple(int(v) for v in row) for row in m_)   # noqa: E731
    return dict(Sw=to_t(s), Swoff=to_t(soff), Rwoff=to_t(roff), recv_len=max(recv_len, 1))


class Dispatcher:
    """Host-side dispatch policy: immediate launch, or newest-first deferral
    with autonomous progress (``mlsl_tpu.comm.request.Dispatcher``).

    The reference's endpoint servers pull commands from a queue and may serve
    the newest large allreduce first (eplib/cqueue.c:1999-2012 routing to
    allreduce_pr.c LIFO), driving the network without the app thread
    (eplib/allreduce_pr.c:69-278). Here the queue is a host-side list of
    not-yet-launched requests. A daemon progress thread, started at the first
    deferral, launches them ``msg_priority_flush_ms`` after the last deferral:
    requests deferred within that window go out together, LIFO
    (``msg_priority_mode`` 1) or FIFO (0). ``flush`` launches them at once.
    Small messages, barriers and the default configuration (msg_priority off)
    dispatch at once. Also owns the comm stream of each CUDA device."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = device        # the Environment's device (precompile's buffers)
        self._pending: List[tuple] = []   # (request, buf, epoch), oldest first
        self._streams: dict = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._in_flight: set = set()      # uids taken off the queue, dispatch running
        self._thread: Optional[threading.Thread] = None
        self._deadline = 0.0
        self._stopped = False

    def stream_for(self, device: torch.device):
        if device.type != "cuda":
            return None
        with self._lock:
            s = self._streams.get(device)
            if s is None:
                s = torch.cuda.Stream(device=device)
                self._streams[device] = s
        return s

    def submit(self, req: CommRequest, buf: torch.Tensor) -> None:
        cfg = self.config
        if req.desc.kind == "barrier":
            # a barrier orders everything before it
            self.flush()
        if (not cfg.msg_priority or req.desc.kind == "barrier"
                or req._payload <= cfg.msg_priority_threshold):
            req._dispatch(buf)
            return
        with self._lock:
            # a restart of an already-deferred request supersedes the stale entry
            self._pending = [e for e in self._pending if e[0] is not req]
            self._pending.append((req, buf, req._epoch))
            self._deadline = time.monotonic() + cfg.msg_priority_flush_ms / 1e3
            if self._thread is None and not self._stopped:
                self._thread = threading.Thread(target=self._progress_loop, daemon=True,
                                                name="mlsl-dispatch")
                self._thread.start()
            self._cv.notify_all()
        tr = obs._tracer
        if tr is not None:
            tr.instant("defer", "req", track=req._trace_name, req=req.name or req.uid,
                       bytes=req._payload, scheduler="python")

    def _progress_loop(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and not self._pending:
                    self._cv.wait()
                if self._stopped:
                    return
                delay = self._deadline - time.monotonic()
            if delay > 0:
                time.sleep(min(delay, 0.05))
                continue
            try:
                self.flush()
            except Exception as e:   # keep the daemon alive; the request holds its error
                log_error("background flush failed: %r", e)

    def flush(self) -> None:
        """Launch every deferred request now, in the configured order."""
        if not self._pending:
            return
        with self._lock:
            # a uid enters _in_flight before its entry leaves _pending, so a
            # waiter never finds its request in neither place
            self._in_flight.update(e[0].uid for e in self._pending)
            pending, self._pending = self._pending, []
        items = list(reversed(pending)) if self.config.msg_priority_mode else pending
        try:
            for req, buf, epoch in items:
                req._dispatch(buf, epoch)
        finally:
            with self._cv:
                for req, _, _ in items:
                    self._in_flight.discard(req.uid)
                self._cv.notify_all()

    def wait_dispatched(self, req: CommRequest, deadline: Optional[float] = None) -> None:
        """Make sure ``req`` has been launched: flush the queue, then wait out
        a dispatch of it that the progress thread is running. ``deadline``
        (monotonic) is the request watchdog's: a dispatch wedged on the
        progress thread past it trips MLSLTimeoutError instead of blocking
        forever."""
        self.flush()
        if req.uid not in self._in_flight:
            return
        with self._cv:
            while req.uid in self._in_flight:
                if deadline is None:
                    self._cv.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    req._watchdog_trip("dispatch")
                self._cv.wait(min(remaining, 0.05))

    def shutdown(self) -> None:
        """Launch anything still deferred and stop the progress thread."""
        self.flush()
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                log_warning("dispatch progress thread %s still alive after 5 s "
                            "(%d deferred requests pending); abandoning it",
                            self._thread.name, self.pending_count)
            self._thread = None

    @property
    def pending_count(self) -> int:
        return len(self._pending)


class RequestStorage:
    """Tracks live generic requests so Environment.wait/test can free them
    (reference RequestStorage src/mlsl_impl.hpp:60-94)."""

    def __init__(self):
        self._reqs: dict = {}

    def register(self, req: CommRequest) -> None:
        self._reqs[req.uid] = req

    def remove(self, req: CommRequest) -> None:
        self._reqs.pop(req.uid, None)

    def __len__(self) -> int:
        return len(self._reqs)
