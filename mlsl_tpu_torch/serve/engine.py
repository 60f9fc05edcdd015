"""Continuous-batching inference engine on the training stack.

Counterpart of ``mlsl_tpu.serve.engine``. One :class:`InferenceEngine` owns
a 1 x tp slice of the Environment's virtual ranks (dp = sp = 1: serving
replicates across engines, not inside one), the per-rank parameters (the
HybridTrainer's layout), the paged KV pools and three programs:

- **prefill** -- one sequence padded to the full context -> next-token
  logits and every block's K/V (``models.transformer.prefill_local``). Runs
  eagerly: one padded shape, one call a request (and one a resume).
- **write** -- the prefill's K/V into the pools through the sequence's page
  table, in place; the int8 variant quantizes on kernel B1
  (``kv_block_quant``). Eager too.
- **decode** -- one step over the whole slot array
  (``models.transformer.decode_local``): every sequence in flight advances
  one token a call, sequences join and retire between calls. On the card it
  is one CUDA graph a compute dtype (``core/graph_capture.capture``: one
  warm-up, the pools put back, the recording), the counterpart of the JAX
  engine's jitted program that donates the pools; the SLA governor's
  precision shed (bf16) is a second entry of that cache. A replay copies the
  tokens, positions and page tables into the graph's static inputs; the
  logits are read back after it. On the CPU the step runs eagerly.

Where the Environment's world is larger than tp, the ranks beyond the first
tp serve as redundant replicas of the same slice (every replica computes the
same step; the engine reads replica 0); ``chip_smoke.py`` initializes
``world_size=tp``. The JAX engine's ``devices=`` has no counterpart: the
virtual ranks live on the Environment's one device.

Across processes (``Environment.init(coordinator_address=...)``) each
process holds the box of the slice's ranks that it owns
(``Topology.local_shape``): the weights and the KV pools are placed over the
box, and a model group that spans processes sums on the transport
(``inline_allreduce`` -> ``transport.axis_sum``). One scheduler decides and
every process replays:

- the **leader** is the process that holds global rank 0. It alone runs
  ``submit``, the queue, the SLA governor, the straggler read, admission,
  eviction, the page tables, retirement and the chaos sites, and picks the
  tokens from global rank 0's logits, which it holds;
- before each device program the leader broadcasts a **record**
  (``transport.serve_record``): a header of int64 fields, then the payload.
  PREFILL carries the prefix and, for a write, the page table (the oracle's
  prefills carry none); DECODE the tokens, positions, page tables and the
  compute dtype the ladder chose; TWIN the same for ``checks.decode_twin``;
  STOP ends the followers, with an error flag;
- a **follower** replays the records in order: ``run()`` until STOP,
  ``step()`` one record. It never reads its clock, its queue or its logits
  to decide anything, holds no KV bookkeeping (the records carry the page
  tables), and its ``submit`` raises MLSLError naming the leader.

Traps, each guarded by a test (tests/test_torch_multiprocess_serve.py):

1. Decisions from host state: the processes' clocks and arrival times
   differ, so a decision that read them on every process would run a
   prefill on one process and a decode step on another, and the model
   group's sums would pair the wrong messages. Only the leader decides.
2. A leader that raises must not leave a follower blocked in a broadcast:
   ``step`` (so ``run``) sends STOP with the error flag as the exception
   leaves it, and the transport's shutdown hook sends it at the process's
   exit when ``close`` never did. The follower then raises MLSLError.
3. Retries: ``serve.decode`` fires on the leader before the record goes
   out, so a TRANSIENT retry sends one record and a skipped step none; a
   follower runs every step once.
4. Eviction and resume change only the leader's page tables, which the next
   records carry.
5. The decode step is a CUDA graph only where the model group lies inside
   the process (``graphed``); over a spanning model group its sums are
   transport hops, which a graph cannot hold (ROADMAP A.8b.6), and it runs
   eagerly on the card as on the CPU.
6. The dtype shed travels in the DECODE record: the followers capture or
   replay the bf16 entry at the same step as the leader.

Counters: the SERVE counters, the ``mlsl_serve_*`` metrics, the tracer's
spans and ``supervisor.status()["serve"]`` are the leader's; a follower
counts only the prefills and decode steps it replayed. Every process logs
the programs it ran (``programs``), the leader's and the followers' alike.

Scheduling runs on the caller's thread (``step()`` / ``run()``): ``submit()``
is the only entry for other threads and only touches the queue under a lock,
never the card.

Fault story (chaos sites ``serve.admit`` and ``serve.decode``): an
admission fault fails the one request closed; a decode fault goes through
``supervisor.classify`` -- TRANSIENT retries in place with jittered backoff
(``MLSL_COMM_RETRIES``), FATAL propagates, anything else force-sheds the SLA
ladder and skips the step; after ``_DECODE_FAIL_CAP`` failed steps in a row
the batch in flight fails closed and the engine keeps admitting. A chaos
``hang`` at ``serve.decode`` is no exception at all: the step takes its
time, breaches the TPOT window and the governor sheds. The decode site sits
on the host before the graph's replay, so it fires every step.

Telemetry (engine.py:300-590 of the JAX package): with the tracer armed,
``serve.prefill`` and ``serve.decode`` spans of host time (the decode span
ends once the logits are on the host) and the ``kv.evict`` instant; with the
metrics registry armed, the ``mlsl_serve_*`` families (requests, rejections,
TTFT, TPOT, queue depth, slots in flight, free KV pages, batch limit,
tokens/s); ``supervisor.status()["serve"]`` is the ladder's state. ``step()``
reads the straggler sentinel: a shed candidate counts as a straggler signal
for the ladder. The engine's lock is ``witness.named_lock("serve.engine")``.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from mlsl_tpu_torch import chaos, supervisor
from mlsl_tpu_torch.analysis import witness
from mlsl_tpu_torch.core import graph_capture, stats
from mlsl_tpu_torch.comm import transport
from mlsl_tpu_torch.log import MLSLError, log_info, log_warning, mlsl_assert
from mlsl_tpu_torch.models import transformer as tfm
from mlsl_tpu_torch.models.convert import transformer_params_from_jax
from mlsl_tpu_torch.obs import metrics, tracer as obs_trace
from mlsl_tpu_torch.obs import straggler as obs_straggler
from mlsl_tpu_torch.serve import kv_cache as kvc, sla

#: consecutive failed decode steps before the batch in flight is failed
#: closed (the engine itself survives and keeps admitting)
_DECODE_FAIL_CAP = 8

#: the kinds of a record (the first int64 of its header)
PREFILL, DECODE, TWIN, STOP = 1, 2, 3, 4
#: a DECODE or TWIN record's compute dtype, by index
_DTYPES = ("float32", "bfloat16", "float16")
#: the programs an engine keeps in ``programs``: the newest, so that a
#: long-running server's log stays bounded
PROGRAM_LOG = 1 << 16


def _record(kind: int, fields=(), *parts) -> torch.Tensor:
    """A record: the header (``kind``, ``fields``, zeros, the payload's
    length last) and the payload, ``parts`` flattened, as one int64 tensor."""
    body = [np.asarray(p, np.int64).reshape(-1) for p in parts]
    head = np.zeros(transport.RECORD_HEADER, np.int64)
    head[0] = kind
    head[1:1 + len(fields)] = fields
    head[-1] = sum(b.size for b in body)
    return torch.from_numpy(np.concatenate([head, *body]))


@dataclass
class Request:
    """One generation request. ``submit()`` returns it at once; ``result()``
    blocks until the scheduler retires it."""

    prompt: np.ndarray
    max_new_tokens: int
    id: int = -1
    route: str = "default"
    eos_token: Optional[int] = None
    state: str = "queued"          # queued | active | done | failed
    tokens: List[int] = field(default_factory=list)
    error: Optional[BaseException] = None
    t_submit: float = 0.0
    ttft_ms: Optional[float] = None
    _done: threading.Event = field(default_factory=threading.Event, repr=False)
    _resume: Optional[np.ndarray] = field(default=None, repr=False)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """The generated tokens (blocking). Raises the recorded error of a
        failed request."""
        mlsl_assert(self._done.wait(timeout), "request %d still in flight", self.id)
        if self.state == "failed" and self.error is not None:
            raise self.error
        return list(self.tokens)


@dataclass
class _Seq:
    """A sequence in flight, the scheduler's own state."""

    req: Request
    seq_id: int
    slot: int
    position: int       # next KV write index == current context length
    last_token: int
    admitted_at: int    # admission counter: eviction preempts the youngest
    finished: bool = False


class InferenceEngine:
    """Continuous batching, paged KV and the SLA ladder over one model slice.

    ``params``: the JAX package's global parameter tree (numpy arrays or
    tensors, e.g. ``mlsl_tpu``'s ``init_params`` converted to numpy), placed
    with ``convert.transformer_params_from_jax``; without it the weights come
    from ``models.transformer.init_params`` with a generator seeded by
    ``seed``. ``config`` defaults to the Environment's. The engine runs on the
    Environment's device: the card unless it was initialized with
    ``device="cpu"``. Across processes every process builds its engine with
    the same arguments; the leader (``is_leader``) serves, the followers
    replay (module docstring)."""

    def __init__(self, env, cfg, tp: int = 1, params=None, seed: int = 0, config=None,
                 max_batch: Optional[int] = None, queue_depth: Optional[int] = None,
                 tpot_p99_ms: float = 0.0):
        self.env = env
        self.cfg = cfg
        self.tp = int(tp)
        self.config = config if config is not None else env.config
        mlsl_assert(cfg.n_heads % self.tp == 0, "heads %d %% tp %d", cfg.n_heads, self.tp)
        self.dist = env.create_distribution(1, self.tp)
        topo = self.dist.topology
        # this process's box of the slice's ranks: the whole grid in one process
        self.grid = topo.local_shape
        self.global_grid = topo.grid_shape
        self.device = env.device
        self.comm = (self.dist.model_group, self.config) if self.tp > 1 else None
        self.nproc = topo.num_procs
        self.leader = topo.owner(0)
        self.is_leader = topo.proc_index == self.leader
        # the box index of the row the tokens are picked from: global rank 0's
        self._row0 = topo.local_coords(0) if self.is_leader else (0, 0, 0, 0)
        self.spanning = transport.spans(self.dist.model_group)
        # trap 5: a graph cannot hold the transport's hops (ROADMAP A.8b.6)
        self.graphed = self.device.type == "cuda" and not self.spanning
        if self.device.type == "cuda" and self.spanning:
            log_info("serving engine: the model group spans processes; the decode step "
                     "runs eagerly (its graph is ROADMAP A.8b.6)")

        if params is None:
            params = tfm.init_params(torch.Generator().manual_seed(seed), cfg)
        self.params = transformer_params_from_jax(
            params, cfg, self.global_grid, device=self.device,
            box=(topo.local_origin, topo.local_shape) if self.nproc > 1 else None)

        self.quant = bool(self.config.serve_kv_quant)
        self.cache = kvc.PagedKVCache(
            cfg,
            page_elems=self.config.serve_kv_page_elems,
            budget_mb=self.config.serve_kv_cache_mb,
            max_len=cfg.seq_len,
            quant=self.quant,
        )
        # the extents pin: the gathered decode context == the prefill's padded
        # length (kv_cache asserts seq_len % page_elems == 0)
        self.ctx_len = self.cache.ctx_len
        self.max_batch = int(max_batch if max_batch is not None
                             else self.config.serve_max_batch)
        self.governor = sla.SLAGovernor(
            max_batch=self.max_batch,
            queue_depth=int(queue_depth if queue_depth is not None
                            else self.config.serve_queue_depth),
            tpot_p99_ms=tpot_p99_ms,
        )
        if self.is_leader:
            sla._set_active(self.governor)

        # KV pools: page 0 is the reserved garbage page (kv_cache.py), so the
        # page dim is num_pages + 1; each model rank holds its heads' shard
        npg, page = self.cache.num_pages + 1, self.cache.page_elems
        hl = cfg.n_heads // self.tp
        shape = (*self.grid, cfg.n_blocks, npg, page, hl, cfg.head_dim)
        kv_dt = torch.int8 if self.quant else torch.float32
        self.kpool = torch.zeros(shape, dtype=kv_dt, device=self.device)
        self.vpool = torch.zeros(shape, dtype=kv_dt, device=self.device)
        if self.quant:
            self.kscale = torch.ones(shape[:-1], dtype=torch.float32, device=self.device)
            self.vscale = torch.ones(shape[:-1], dtype=torch.float32, device=self.device)
        # the decode step's captured graphs, one a compute dtype (card only)
        self._decode_cache: Dict[str, graph_capture.Captured] = {}

        self._lock = witness.named_lock("serve.engine")
        self._pending: Deque[Request] = collections.deque()
        self._active: Dict[int, _Seq] = {}
        self._next_req_id = 0
        self._next_seq_id = 0
        self._admit_counter = 0
        self._decode_fails = 0
        self._t_start: Optional[float] = None
        self._tokens_total = 0
        #: the programs this process ran, in order (the last PROGRAM_LOG):
        #: ("prefill", length, written), ("decode", dtype, the ladder's
        #: rung), ("twin", dtype, rung)
        self.programs: Deque[tuple] = collections.deque(maxlen=PROGRAM_LOG)
        #: a follower's decode_twin results, (graph logits, eager logits,
        #: pools equal), in the order the leader asked for them
        self.twins: List[tuple] = []
        self._stopped = False
        if self.nproc > 1 and self.is_leader:
            # trap 2: a leader that exits without close() stops its followers
            transport.at_shutdown(self._stop_on_exit)

    # -- the programs ------------------------------------------------------

    def _pools(self) -> List[torch.Tensor]:
        """What the write and the decode step change in place."""
        if self.quant:
            return [self.kpool, self.vpool, self.kscale, self.vscale]
        return [self.kpool, self.vpool]

    def _prefill(self, tokens: torch.Tensor, length: int):
        """-> (logits (R, D, S, M, V), k, v (R, D, S, M, n_blocks, S, Hl, Dh))."""
        return tfm.prefill_local(self.params, tokens, length, self.cfg, self.tp,
                                 comm=self.comm)

    @torch.no_grad()
    def _write(self, k: torch.Tensor, v: torch.Tensor, page_ids: torch.Tensor) -> None:
        """The prefill's K/V into the pools through a padded page table, in
        place; pages past the sequence's own are the garbage page 0."""
        m, page = page_ids.shape[0], self.cache.page_elems

        def paged(x):
            return x.reshape(*x.shape[:tfm.GRID + 1], m, page, *x.shape[tfm.GRID + 2:])

        if self.quant:
            for pool, spool, x in ((self.kpool, self.kscale, k), (self.vpool, self.vscale, v)):
                q, s = tfm.kv_block_quant(x)
                pool[:, :, :, :, :, page_ids] = paged(q)
                spool[:, :, :, :, :, page_ids] = paged(s)
        else:
            self.kpool[:, :, :, :, :, page_ids] = paged(k)
            self.vpool[:, :, :, :, :, page_ids] = paged(v)

    def _decode_fn(self, dtype: str):
        """The decode step of one compute dtype as a function of (tokens,
        positions, page tables) -> logits (R, D, S, M, B, V); it writes the
        pools in place."""
        def step(tokens, positions, pt):
            scales = ({"kscale": self.kscale, "vscale": self.vscale} if self.quant else {})
            out = tfm.decode_local(self.params, tokens, positions, pt, self.kpool,
                                   self.vpool, self.cfg, self.tp, comm=self.comm,
                                   dtype=dtype, **scales)
            return out[0]
        return step

    def _decode_graph(self, dtype: str, args) -> graph_capture.Captured:
        """The decode step's CUDA graph for ``dtype``, captured at its first
        use (the route of every reduction inside it is fixed then)."""
        captured = self._decode_cache.get(dtype)
        if captured is None:
            captured = graph_capture.capture(self._decode_fn(dtype), args, self._pools(),
                                             f"the decode step ({dtype})")
            self._decode_cache[dtype] = captured
        return captured

    def _args(self, *arrays) -> List[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(self.device)
                for a in arrays]

    def _run_prefill(self, prefix: np.ndarray, pages: Optional[np.ndarray]) -> torch.Tensor:
        """The prefill of ``prefix`` padded to the context, and with a page
        table the write of its K/V. -> the logits (R_l, D_l, S_l, M_l, V)."""
        n = int(prefix.size)
        tokens = np.zeros((self.ctx_len,), np.int64)
        tokens[:n] = prefix
        logits, k, v = self._prefill(self._args(tokens)[0], n)
        if pages is not None:
            self._write(k, v, self._args(pages)[0])
        self.programs.append(("prefill", n, pages is not None))
        return logits

    def _run_decode(self, dtype: str, tokens, positions, pt, rung: int = 0) -> torch.Tensor:
        """One decode step: the graph's replay where ``graphed``, else eager.
        ``rung``: the leader's SLA rung, logged only. -> the logits (R_l,
        D_l, S_l, M_l, B, V)."""
        args = self._args(tokens, positions, pt)
        if self.graphed:
            logits = self._decode_graph(dtype, args).replay(args)
        else:
            logits = self._decode_fn(dtype)(*args)
        self.programs.append(("decode", dtype, int(rung)))
        return logits

    def _run_twin(self, dtype: str, tokens, positions, pt, rung: int = 0):
        """``checks.decode_twin``'s body on this process's box: the step as
        the graph's replay, then run eagerly from the same pools. -> (graph
        logits, eager logits, (B, V) on the host, of the row the leader
        reads (the box's first on a follower); whether every pool page but
        the garbage page 0 came out equal). The pools are left as the eager
        step wrote them."""
        state = self._pools()
        with graph_capture.restored(state) as saved:
            g = self._run_decode(dtype, tokens, positions, pt, rung)[self._row0].cpu().numpy()
            g_pools = [t[:, :, :, :, :, 1:].clone() for t in state]
            graph_capture.put_back(state, saved)
            e = self._decode_fn(dtype)(*self._args(tokens, positions, pt))
            e = e[self._row0].cpu().numpy()
            same = all(torch.equal(a, t[:, :, :, :, :, 1:]) for a, t in zip(g_pools, state))
        self.programs[-1] = ("twin", dtype, int(rung))
        return g, e, same

    # -- the leader's side of a program: its record, then the program -------

    def _publish(self, kind: int, fields=(), *parts) -> None:
        """Broadcast a record to the followers (nothing in one process)."""
        if self.nproc == 1:
            return
        mlsl_assert(self.is_leader, "only the leader (process %d) publishes records",
                    self.leader)
        if self._stopped:
            raise MLSLError("the serving engine stopped its followers (close() or a fault): "
                            "build a new engine on every process")
        transport.serve_record(_record(kind, fields, *parts), self.leader, self.device)

    def _prefill_program(self, prefix, pages=None) -> np.ndarray:
        """A PREFILL on every process (the write too with ``pages``, a page
        table) -> global rank 0's next-token logits (V,) float32 on the
        host (the leader's)."""
        prefix = np.asarray(prefix, np.int64).reshape(-1)
        if pages is None:
            self._publish(PREFILL, (prefix.size, 0, 0), prefix)
        else:
            pages = np.asarray(pages, np.int64).reshape(-1)
            self._publish(PREFILL, (prefix.size, 1, pages.size), prefix, pages)
        return self._run_prefill(prefix, pages)[self._row0].cpu().numpy()

    def _decode(self, dtype: str, tokens, positions, pt) -> np.ndarray:
        """One decode step on (B,) tokens and positions and (B, M) page tables
        (numpy), on every process -> the logits of global rank 0 on the host,
        (B, V) float32 (the leader's)."""
        rung = self.governor.rung
        self._publish(DECODE, (len(tokens), pt.shape[1], _DTYPES.index(dtype), rung), tokens,
                      positions, pt)
        return self._run_decode(dtype, tokens, positions, pt, rung)[self._row0].cpu().numpy()

    def _twin(self, dtype: str, tokens, positions, pt):
        """``checks.decode_twin``'s step on every process (``_run_twin``); a
        follower keeps its result in ``twins``. -> the leader's."""
        mlsl_assert(not self.spanning, "decode_twin compares the decode graph with its eager "
                    "twin: over a spanning model group the step runs eagerly (A.8b.6)")
        rung = self.governor.rung
        self._publish(TWIN, (len(tokens), pt.shape[1], _DTYPES.index(dtype), rung), tokens,
                      positions, pt)
        return self._run_twin(dtype, tokens, positions, pt, rung)

    # -- a follower: replay the leader's records ---------------------------

    def _replay(self) -> bool:
        """Receive one record and run its program. -> False at STOP; a STOP
        with the error flag raises MLSLError."""
        mlsl_assert(not self._stopped, "the serving engine's followers were stopped")
        rec = transport.serve_record(None, self.leader, self.device).numpy()
        head, body = rec[:transport.RECORD_HEADER], rec[transport.RECORD_HEADER:]
        kind, f = int(head[0]), [int(v) for v in head[1:-1]]
        if kind == STOP:
            self._stopped = True
            if f[0]:
                raise MLSLError(f"the serving engine's leader (process {self.leader}) stopped "
                                f"on an error; this follower (process "
                                f"{transport.world().index}) ends with it")
            return False
        if kind == PREFILL:
            n, write, m = f[:3]
            self._run_prefill(body[:n], body[n:n + m] if write else None)
            if write:
                stats.record_serve("prefills")
            return True
        b, m, dt, rung = f[:4]
        arrays = (body[:b], body[b:2 * b], body[2 * b:].reshape(b, m))
        if kind == DECODE:
            self._run_decode(_DTYPES[dt], *arrays, rung)
            stats.record_serve("decode_steps")
        else:
            mlsl_assert(kind == TWIN, "unknown serving record kind %d", kind)
            self.twins.append(self._run_twin(_DTYPES[dt], *arrays, rung))
        return True

    def _stop_followers(self, error: bool) -> None:
        """STOP to the followers, once (the leader's; nothing in one process)."""
        if self.nproc == 1 or not self.is_leader or self._stopped:
            return
        self._stopped = True
        transport.at_shutdown(self._stop_on_exit, register=False)
        try:
            transport.serve_record(_record(STOP, (int(error),)), self.leader, self.device)
        except Exception as e:  # the world may be going down already
            log_warning("serving engine: STOP did not reach the followers: %s: %s",
                        type(e).__name__, e)

    def _stop_on_exit(self) -> None:
        if not self._stopped:
            log_warning("serving engine: the leader exits without close(): its followers "
                        "stop with an error")
        self._stop_followers(error=True)

    # -- admission (any thread) --------------------------------------------

    def submit(self, prompt, max_new_tokens: int, route: str = "default",
               eos_token: Optional[int] = None) -> Request:
        """Queue a request. Raises :class:`~mlsl_tpu_torch.serve.sla.
        ServeOverloadError` (429-style, with ``retry_after_s``) when the
        ladder closed admission or the queue is full, and MLSLError on a
        follower (only the leader takes requests)."""
        if not self.is_leader:
            raise MLSLError(f"submit runs on the serving engine's leader, process "
                            f"{self.leader}; process {transport.world().index} is a follower "
                            f"that replays the leader's records")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        mlsl_assert(prompt.size >= 1, "empty prompt")
        mlsl_assert(max_new_tokens >= 1, "max_new_tokens must be >= 1")
        mlsl_assert(
            prompt.size + max_new_tokens <= self.ctx_len,
            "prompt %d + max_new %d exceeds the context length %d",
            prompt.size, max_new_tokens, self.ctx_len,
        )
        with self._lock:
            reason = None
            if not self.governor.admission_open:
                reason = "shed_admission"
            elif len(self._pending) >= self.governor.queue_depth:
                reason = "queue_full"
            if reason is not None:
                stats.record_serve("rejected")
                m = metrics._registry
                if m is not None:
                    m.inc("mlsl_serve_rejected_total", 1.0, route=route, reason=reason)
                raise sla.ServeOverloadError(
                    f"admission rejected ({reason}); retry after "
                    f"{self.governor.retry_after_s}s",
                    retry_after_s=self.governor.retry_after_s,
                )
            req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                          id=self._next_req_id, route=route, eos_token=eos_token,
                          t_submit=time.monotonic())
            self._next_req_id += 1
            self._pending.append(req)
            stats.record_serve("admitted")
            return req

    # -- scheduler (the caller's thread only) ------------------------------

    def step(self) -> int:
        """One scheduler iteration: observe and tick the SLA ladder, admit up
        to the rung's batch limit, advance every sequence in flight one
        token, retire the finished. -> the sequences in flight after it.
        On a follower: replay one record -> 1, or 0 once STOP came."""
        if not self.is_leader:
            return int(self._replay())
        try:
            return self._step()
        except BaseException:
            self._stop_followers(error=True)    # trap 2
            raise

    def _step(self) -> int:
        if self._t_start is None:
            self._t_start = time.monotonic()
        sentinel = obs_straggler.get_active()
        straggler = sentinel is not None and sentinel.shed_candidate() is not None
        with self._lock:
            qlen = len(self._pending)
        self.governor.observe(queue_len=qlen, straggler=straggler)
        self.governor.tick()

        self._admit()
        if self._active:
            self._decode_step()
        self._retire()
        self._gauges()
        return len(self._active)

    def run(self, deadline_s: Optional[float] = None, until_idle: bool = True,
            max_steps: Optional[int] = None, idle_sleep_s: float = 0.001) -> None:
        """Drive ``step()`` until idle (the default), a deadline or a step
        budget, whichever comes first. A follower replays every record
        until the leader's ``close()`` (its arguments do not apply)."""
        if not self.is_leader:
            while self._replay():
                pass
            return
        t0 = time.monotonic()
        steps = 0
        while True:
            n = self.step()
            steps += 1
            with self._lock:
                idle = n == 0 and not self._pending
            if until_idle and idle:
                return
            if deadline_s is not None and time.monotonic() - t0 >= deadline_s:
                return
            if max_steps is not None and steps >= max_steps:
                return
            if n == 0:
                time.sleep(idle_sleep_s)

    # -- internals ---------------------------------------------------------

    def _pick(self, logits: np.ndarray, reqs: List[Request]) -> List[int]:
        """Greedy tokens from host logits, one row a request: the first index
        of the maximum, as ``np.argmax``."""
        return [int(np.argmax(logits[i])) for i in range(len(reqs))]

    def _admit(self) -> None:
        while len(self._active) < self.governor.batch_limit:
            with self._lock:
                if not self._pending:
                    return
                req = self._pending.popleft()
            seq_id = self._next_seq_id
            self._next_seq_id += 1
            admitted_kv = False
            try:
                chaos.inject("serve.admit", req_id=req.id)
                prefix = req._resume if req._resume is not None else req.prompt
                if not self.cache.admit(seq_id, prefix.size + 1):
                    # pool backpressure: leave it queued, stop admitting
                    with self._lock:
                        self._pending.appendleft(req)
                    return
                admitted_kv = True
                self._prefill_seq(req, seq_id, prefix)
            except Exception as e:  # fail this one request closed
                if admitted_kv:
                    self.cache.release(seq_id)
                self._active.pop(seq_id, None)
                req.state = "failed"
                req.error = e
                req._done.set()
                stats.record_serve("failed")
                m = metrics._registry
                if m is not None:
                    m.inc("mlsl_serve_requests_total", 1.0, route=req.route, outcome="failed")

    def _prefill_seq(self, req: Request, seq_id: int, prefix: np.ndarray) -> None:
        n = int(prefix.size)
        tr = obs_trace._tracer
        t0 = tr.now() if tr is not None else 0
        row = self._prefill_program(prefix, np.asarray(self.cache.table_padded(seq_id)))
        tok = self._pick(row[None], [req])[0]
        if tr is not None:
            tr.complete("serve.prefill", "serve", t0, seq=seq_id, tokens=n)
        stats.record_serve("prefills")
        stats.record_serve("tokens_out")
        self._tokens_total += 1
        if req._resume is None:
            req.ttft_ms = (time.monotonic() - req.t_submit) * 1e3
            m = metrics._registry
            if m is not None:
                m.observe("mlsl_serve_ttft_ms", req.ttft_ms, route=req.route)
        req._resume = None
        req.state = "active"
        req.tokens.append(tok)
        seq = _Seq(req=req, seq_id=seq_id, slot=-1, position=n, last_token=tok,
                   admitted_at=self._admit_counter)
        self._admit_counter += 1
        if (req.eos_token is not None and tok == req.eos_token) \
                or len(req.tokens) >= req.max_new_tokens \
                or seq.position >= self.ctx_len:
            seq.finished = True
        self._active[seq_id] = seq

    def _evict_youngest(self) -> None:
        """Preempt the youngest sequence in flight: free its pages, keep the
        prompt and everything generated as the resume prefix, and put it back
        at the FRONT of the queue (it has seniority over work never started)."""
        seq = max(self._active.values(), key=lambda s: s.admitted_at)
        self._active.pop(seq.seq_id)
        self.cache.release(seq.seq_id, evict=True)
        req = seq.req
        req._resume = np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])
        req.state = "queued"
        with self._lock:
            self._pending.appendleft(req)

    def _ensure_capacity(self) -> None:
        """Every live sequence needs pages covering its next KV write; a pool
        that cannot extend evicts the youngest until it can. The budget floor
        (num_pages >= max_pages_per_seq) keeps at least one sequence
        running."""
        for seq in sorted(self._active.values(), key=lambda s: s.admitted_at):
            while seq.seq_id in self._active \
                    and not self.cache.extend(seq.seq_id, seq.position + 1):
                self._evict_youngest()

    def _batch(self):
        """The sequences in flight, oldest first, each given its slot, and
        the decode step's inputs: (B,) tokens and positions and (B, M) page
        tables, numpy; inactive slots feed token 0 at position 0 of the
        garbage page."""
        live = sorted(self._active.values(), key=lambda s: s.admitted_at)
        b, mpp = self.max_batch, self.cache.max_pages_per_seq
        tokens = np.zeros((b,), np.int64)
        positions = np.zeros((b,), np.int64)
        pt = np.zeros((b, mpp), np.int64)
        for i, seq in enumerate(live):
            seq.slot = i
            tokens[i] = seq.last_token
            positions[i] = seq.position
            pt[i] = self.cache.table_padded(seq.seq_id)
        return live, (tokens, positions, pt)

    def _decode_step(self) -> None:
        self._ensure_capacity()
        if not self._active:
            return
        live, (tokens, positions, pt) = self._batch()
        dtype = "bfloat16" if self.governor.precision_shed else self.cfg.dtype
        attempt = 0
        tr = obs_trace._tracer
        while True:
            t_step = time.monotonic()
            t0 = tr.now() if tr is not None else 0
            try:
                # on the host before the replay; a chaos 'hang' is a slow
                # step, inside the timed window: it breaches the TPOT SLO
                # and the governor sheds (degraded, never down)
                chaos.inject("serve.decode", inflight=len(live))
                logits = self._decode(dtype, tokens, positions, pt)
                break
            except Exception as e:
                cls = supervisor.classify(e)
                if cls is supervisor.ErrorClass.TRANSIENT \
                        and attempt < self.config.comm_retries:
                    stats.record_serve("retries")
                    time.sleep(supervisor.jittered_backoff(
                        self.config.comm_retry_backoff_s, attempt))
                    attempt += 1
                    continue
                self._decode_fault(e)
                return
        step_ms = (time.monotonic() - t_step) * 1e3
        if tr is not None:
            tr.complete("serve.decode", "serve", t0, inflight=len(live))
        self._decode_fails = 0
        if attempt > 0:
            stats.record_serve("recoveries")
        self.governor.observe(tpot_ms=step_ms)
        m = metrics._registry
        if m is not None:
            m.observe("mlsl_serve_tpot_ms", step_ms)
        stats.record_serve("decode_steps")
        stats.record_serve("tokens_out", len(live))
        self._tokens_total += len(live)
        toks = self._pick(logits, [seq.req for seq in live])
        for seq, tok in zip(live, toks):
            seq.position += 1
            seq.last_token = tok
            seq.req.tokens.append(tok)
            if (seq.req.eos_token is not None and tok == seq.req.eos_token) \
                    or len(seq.req.tokens) >= seq.req.max_new_tokens \
                    or seq.position >= self.ctx_len:
                seq.finished = True

    def _decode_fault(self, e: BaseException) -> None:
        cls = supervisor.classify(e)
        if cls is supervisor.ErrorClass.FATAL:
            raise e
        self._decode_fails += 1
        self.governor.force_shed(f"decode fault: {cls.name}")
        if self._decode_fails < _DECODE_FAIL_CAP:
            return
        # the batch is wedged: fail it closed, keep the engine alive
        for seq in list(self._active.values()):
            self._active.pop(seq.seq_id)
            self.cache.release(seq.seq_id)
            seq.req.state = "failed"
            seq.req.error = e
            seq.req._done.set()
            stats.record_serve("failed")
        self._decode_fails = 0

    def _retire(self) -> None:
        m = metrics._registry
        for seq in [s for s in self._active.values() if s.finished]:
            self._active.pop(seq.seq_id)
            self.cache.release(seq.seq_id)
            seq.req.state = "done"
            seq.req._done.set()
            stats.record_serve("completed")
            if m is not None:
                m.inc("mlsl_serve_requests_total", 1.0, route=seq.req.route, outcome="done")

    def _gauges(self) -> None:
        m = metrics._registry
        if m is None:
            return
        with self._lock:
            qlen = len(self._pending)
        m.set("mlsl_serve_queue_depth", float(qlen))
        m.set("mlsl_serve_inflight", float(len(self._active)))
        m.set("mlsl_serve_kv_free_pages", float(self.cache.free_pages))
        m.set("mlsl_serve_batch_limit", float(self.governor.batch_limit))
        if self._t_start is not None:
            dt = time.monotonic() - self._t_start
            if dt > 0:
                m.set("mlsl_serve_tokens_per_s", self._tokens_total / dt)

    def close(self) -> None:
        """Detach the SLA governor from the module registry (tests and
        processes with several engines); across processes the leader's
        ``close`` sends STOP, which ends the followers' ``run()``."""
        self._stop_followers(error=False)
        if sla.get_active() is self.governor:
            sla._set_active(None)


def oracle_generate(engine: InferenceEngine, prompt, max_new_tokens: int,
                    eos_token: Optional[int] = None, *, follow=None,
                    return_logits: bool = False):
    """The UNPAGED oracle: greedy decode by running the engine's own prefill
    over the growing full sequence each step -- no KV cache, no pages.

    ``follow``: a token stream that extends the sequence in place of the
    oracle's own picks (each step's logits are then the oracle's on that
    stream's prefix). ``return_logits``: -> (tokens, each step's (V,)
    float32 logits) instead of the tokens alone. Across processes it runs on
    the leader, each prefill a PREFILL record that the followers replay."""
    mlsl_assert(engine.is_leader, "the oracle runs on the serving engine's leader "
                "(process %d)", engine.leader)
    seq = list(np.asarray(prompt, np.int32).reshape(-1))
    out: List[int] = []
    steps: List[np.ndarray] = []
    for j in range(max_new_tokens):
        row = engine._prefill_program(np.asarray(seq, np.int64))
        tok = int(np.argmax(row))
        out.append(tok)
        if return_logits:
            steps.append(row)
        seq.append(tok if follow is None else int(follow[j]))
        if eos_token is not None and seq[-1] == eos_token:
            break
        if len(seq) >= engine.ctx_len:
            break
    return (out, steps) if return_logits else out
