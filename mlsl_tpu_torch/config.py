"""Typed configuration with MLSL_* environment-variable overrides.

The subset of ``mlsl_tpu.config.Config`` that this package reads: statistics,
the commit-time precompile and the device gather's cap, the int8
codec's block, large-message chunking (reference src/comm_ep.cpp:95-97),
gradient bucketing (core/bucketing.py),
newest-first priority deferral and its progress thread (reference
eplib/env.c:135-165), the collective algorithm engine with its tuned profile
and kernel knobs (comm/algos, tuner/, ops/), the compiled overlap engine
with the staging depth it shares with the ZeRO-1 update (comm/overlap.py), and
the compressed wires beyond int8: the top-k ratio, a user codec, the codec
registry's knobs and its calibration (codecs/, tuner/calibrate.py), and the
two-tier split with the ``hier`` lowering's DCN codec (comm/algos/hier.py),
the device feed's wire, cache, depth and retries (data/), the serving
engine's batch, KV pages, KV budget, queue and int8 KV (serve/) with the
transient-fault retries its decode step reads, the fault plane's and the
telemetry's knobs, the integrity sentinel's (sentinel.py), the recovery
layer's (checkpoint retries, the restart and capacity budgets, the elastic
mesh, the control plane), and the core tier: the log level, the
device-class defaults (sysinfo.auto_config), the kernels' build directory
and the reference's parity knobs.
Field names, defaults and environment names are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os

from mlsl_tpu_torch.log import mlsl_assert

# env var -> Config field, for the explicit-override bookkeeping in from_env:
# a tuned profile never overrides a knob the user exported
_ENV_FIELDS = {
    "MLSL_LARGE_MSG_SIZE_MB": "large_msg_size_mb",
    "MLSL_LARGE_MSG_CHUNKS": "large_msg_chunks",
    "MLSL_GRAD_BUCKET_MB": "grad_bucket_mb",
    "MLSL_MSG_PRIORITY_THRESHOLD": "msg_priority_threshold",
    "MLSL_MSG_PRIORITY_FLUSH_MS": "msg_priority_flush_ms",
    "MLSL_QUANT_BLOCK_ELEMS": "quant_block_elems",
    "MLSL_PALLAS_RHD_MAX_BYTES": "pallas_rhd_max_bytes",
    "MLSL_PALLAS_A2A_QUANT": "pallas_a2a_quant",
    "MLSL_OVERLAP_STAGES": "overlap_stages",
    "MLSL_GATHER_DEVICE_LIMIT_MB": "gather_device_limit_mb",
    "MLSL_CODEC": "codec",
    "MLSL_CODEC_NSR_BUDGET": "codec_nsr_budget",
    "MLSL_CODEC_GUARD_BREACHES": "codec_guard_breaches",
    "MLSL_VQ_DIM": "vq_dim",
    "MLSL_VQ_CODEBOOK": "vq_codebook",
    "MLSL_PRUNE_RATIO": "prune_ratio",
    "MLSL_HIER_DCN_CODEC": "hier_dcn_codec",
    "MLSL_FEED_DEPTH": "feed_depth",
    "MLSL_FEED_CACHE_MB": "feed_cache_mb",
    "MLSL_FEED_WIRE_DTYPE": "feed_wire_dtype",
    "MLSL_SERVE_MAX_BATCH": "serve_max_batch",
    "MLSL_SERVE_KV_PAGE_ELEMS": "serve_kv_page_elems",
    "MLSL_SERVE_KV_CACHE_MB": "serve_kv_cache_mb",
    "MLSL_SERVE_QUEUE_DEPTH": "serve_queue_depth",
    "MLSL_NUM_SERVERS": "num_servers",
    "MLSL_SENTINEL_EVERY": "sentinel_every",
    "MLSL_HEARTBEAT_MISSES": "heartbeat_misses",
    "MLSL_VERIFY": "verify",
    "MLSL_VERIFY_SEVERITY": "verify_severity",
}

# the registry's codec names (mlsl_tpu_torch.codecs), mirrored so that
# validate() needs no import of the registry; codecs.get re-checks them
_CODEC_NAMES = ("f32", "int8", "prune", "topk", "vq")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v.strip().lower() not in ("0", "false", "no", "off")


@dataclasses.dataclass
class Config:
    # --- the core tier (reference src/env.cpp:26-40) ---
    # Log level of the package's logger (log.LogLevel: 0 ERROR, 1 INFO,
    # 2 DEBUG, 3 TRACE), applied by Environment.init.
    log_level: int = 0              # MLSL_LOG_LEVEL
    enable_stats: bool = False      # MLSL_STATS
    # Device-class defaults at init (sysinfo.auto_config): 0 = off; any other
    # value applies the probed class's row to every knob not exported.
    auto_config_type: int = 0       # MLSL_AUTO_CONFIG_TYPE
    # Where the CUDA kernels are built and loaded from (ops/cuda_build.py);
    # '' = build/mlsl_tpu_torch at the root of the checkout.
    compile_cache_dir: str = ""     # MLSL_COMPILE_CACHE_DIR
    # Accepted for parity with the reference and read by nothing, as in the
    # JAX package: the MPI endpoint, server and shared-memory knobs.
    dup_group: bool = False         # MLSL_DUP_GROUP
    num_servers: int = 4            # MLSL_NUM_SERVERS
    max_short_msg_size: int = 0     # MLSL_MAX_SHORT_MSG_SIZE
    server_affinity: str = ""       # MLSL_SERVER_AFFINITY
    heap_size_gb: int = 0           # MLSL_HEAP_SIZE_GB
    alltoall_split: int = 1         # MLSL_ALLTOALL_SPLIT
    thp_threshold_mb: int = 0       # MLSL_THP_THRESHOLD_MB
    # Session.commit runs every registered request once on zero buffers
    # (Session.precompile_collectives), so the first step builds nothing.
    precompile: bool = False        # MLSL_PRECOMPILE
    # Distribution.gather refuses an output above this many MiB a rank
    # (rank-uniform buffers hold the concatenation on every member); 0 = no cap.
    gather_device_limit_mb: int = 1024  # MLSL_GATHER_DEVICE_LIMIT_MB
    # Chunking for very large messages: an allreduce above this size is split
    # into independently dispatched chunks so Wait completes incrementally.
    large_msg_size_mb: int = 128    # MLSL_LARGE_MSG_SIZE_MB
    large_msg_chunks: int = 4       # MLSL_LARGE_MSG_CHUNKS
    # Gradient bucketing (core/bucketing.py): coalesce per-layer gradient
    # collectives below this bucket size into one concatenated collective
    # (fewer host dispatches, bandwidth-sized wire messages). 0 = off.
    grad_bucket_mb: int = 0         # MLSL_GRAD_BUCKET_MB
    # Newest-first priority: requests above the threshold are deferred and
    # launched together, by the progress thread or at the next sync point.
    msg_priority: bool = False           # MLSL_MSG_PRIORITY
    msg_priority_threshold: int = 10000  # MLSL_MSG_PRIORITY_THRESHOLD (bytes)
    msg_priority_mode: bool = True       # MLSL_MSG_PRIORITY_MODE: 1 = LIFO, 0 = FIFO
    # Coalescing window: the progress thread launches the deferred requests
    # this long after the last deferral, with no call from the app.
    msg_priority_flush_ms: float = 2.0   # MLSL_MSG_PRIORITY_FLUSH_MS
    # Elements per int8 quantization block (one float32 scale each).
    quant_block_elems: int = 256    # MLSL_QUANT_BLOCK_ELEMS
    # Fraction of a TOPK request's elements each rank sends (comm/sparse.py).
    topk_ratio: float = 0.01        # MLSL_TOPK_RATIO
    # A user codec (comm/codec.CustomCodec), registered through
    # Environment.set_quantization_params; None = the registry's codecs.
    custom_codec: object = None

    # --- the codec registry (codecs/) and its calibration (tuner/calibrate.py) ---
    # Registry codec of every QUANTIZATION gradient wire: '' = the int8 ring;
    # 'vq', 'prune', 'topk' or 'f32' route through the registry's transport.
    # An exported MLSL_CODEC beats a calibrated per-set assignment; a value
    # set in code is the default that calibration overrides per set.
    codec: str = ""                 # MLSL_CODEC
    # Calibrate at Session.commit: measure each set's noise-to-signal under
    # every candidate codec, assign the cheapest within codec_nsr_budget,
    # write the table into the tuned profile and re-route the live requests.
    tune_codec: bool = False        # MLSL_TUNE_CODEC
    # Request name -> calibration cell, from calibration or a loaded profile.
    codec_assignment: dict = dataclasses.field(default_factory=dict)
    codec_nsr_budget: float = 0.02  # MLSL_CODEC_NSR_BUDGET
    # Consecutive loss breaches (codecs.guard_note) before the guardrail
    # demotes every calibrated set to int8.
    codec_guard_breaches: int = 3   # MLSL_CODEC_GUARD_BREACHES
    vq_dim: int = 4                 # MLSL_VQ_DIM: elements a vector
    vq_codebook: int = 16           # MLSL_VQ_CODEBOOK: rows (one index byte a vector)
    prune_ratio: float = 0.05       # MLSL_PRUNE_RATIO: the pruning codec's keep ratio
    # The synthetic two-tier split 'TxL' (T tiers of L virtual ranks, world
    # rank // L): the world the 'hier' lowering sees as tiered
    # (comm/mesh.world_tier_ids, which reads the environment variable on each
    # build). The grammar is checked here; that T*L covers the world, where
    # the world is known.
    mesh_tiers: str = ""            # MLSL_MESH_TIERS
    # The 'hier' lowering's DCN-tier codec (comm/algos/hier.py): 'int8' (the
    # shared-scale integer sum), 'f32', 'topk', or the registry's 'vq' and
    # 'prune'. The intra-tier phases are always float32.
    hier_dcn_codec: str = "int8"    # MLSL_HIER_DCN_CODEC

    # --- collective algorithm engine (comm/algos) + tuned profile (tuner/) ---
    # Forced algorithm: '' = auto (tuned profile, else the 'lax' baseline).
    # One registry name for every engine kind, or a comma list of kind=name
    # entries ('allreduce=rhd,reduce_scatter=ring2d'); validate() parses it
    # into _forced_algos and rejects names the port does not have.
    collective_algo: str = ""       # MLSL_ALGO
    # Run the autotuner's sweep at init over the live world (tuner/sweep.py),
    # write the profile and use it.
    tune: bool = False              # MLSL_TUNE
    # Profile file read at init (tuner.init_profile). A profile measured on
    # another topology is rejected with a warning; a missing or corrupt file
    # is an MLSLError at init.
    tune_profile: str = ""          # MLSL_TUNE_PROFILE
    # Loaded tuner.TunedProfile or None, set by Environment.init.
    tuned_profile: object = None

    # --- the ring and halving/doubling kernels (ops/ring_kernels.py,
    # ops/rhd_kernels.py) ---
    # Split each ring chunk's rows in half and run the second half in the
    # opposite direction (another summation order for those elements).
    pallas_ring_bidir: bool = False  # MLSL_PALLAS_RING_BIDIR
    # Arm the heuristic rung: dense SUM allreduces up to the payload band
    # below select 'pallas_rhd' without MLSL_ALGO or a profile.
    pallas_rhd: bool = False         # MLSL_PALLAS_RHD
    # Upper edge (bytes) of that band; 0 = 4 x msg_priority_threshold.
    pallas_rhd_max_bytes: int = 0    # MLSL_PALLAS_RHD_MAX_BYTES
    # The int8 blockwise codec on the 'pallas_a2a' alltoall (ops/a2a_kernels.py):
    # every chunk makes one codec round trip with quant_block_elems blocks.
    # Off = the same kernel exchanges dense float32.
    pallas_a2a_quant: bool = True    # MLSL_PALLAS_A2A_QUANT

    # --- the compiled overlap engine and the staged ZeRO-1 update
    # (comm/overlap.py) ---
    # Arm the compiled step for every DataParallelTrainer that can take it:
    # local backward, every layer's gradient collective staged newest-first
    # and the per-layer update in one step, captured as one CUDA graph on the
    # card. The host Start/Wait path stays the default and the parity oracle.
    overlap_compiled: bool = False   # MLSL_OVERLAP_COMPILED
    # A unit's phases are spread over this many unit starts.
    overlap_stages: int = 2          # MLSL_OVERLAP_STAGES

    # --- the device feed (data/) ---
    # Wire dtype of the host->device batch copy: '' = full width, 'uint8'
    # (images), 'bf16', 'int8' (the block codec of the quantized
    # collectives); per-leaf overrides in the same string ('uint8,y=none'),
    # parsed by data.common.parse_wire_spec at validate().
    feed_wire_dtype: str = ""       # MLSL_FEED_WIRE_DTYPE
    # Budget (MiB) of the device-resident feed cache; 0 = off.
    feed_cache_mb: int = 0          # MLSL_FEED_CACHE_MB
    # Batches in flight ahead of the consumer (2 = double buffering);
    # a tuned profile may set it, an exported value wins.
    feed_depth: int = 2             # MLSL_FEED_DEPTH
    # TRANSIENT source-read retries per batch.
    feed_retries: int = 2           # MLSL_FEED_RETRIES

    # --- the serving engine (serve/) ---
    # Decode slots of the continuous batch; the SLA ladder sheds below it. A
    # tuned profile may set it, an exported value wins (as for the three
    # knobs below).
    serve_max_batch: int = 8        # MLSL_SERVE_MAX_BATCH
    # Tokens a KV page: the paged cache's allocation unit.
    serve_kv_page_elems: int = 16   # MLSL_SERVE_KV_PAGE_ELEMS
    # Device budget (MiB) of the paged KV cache: it caps the pages.
    serve_kv_cache_mb: int = 64     # MLSL_SERVE_KV_CACHE_MB
    # Requests waiting beyond the in-flight batch; over it submit() rejects
    # 429-style with a retry-after hint.
    serve_queue_depth: int = 32     # MLSL_SERVE_QUEUE_DEPTH
    # KV pages int8 with one float32 scale a (token, head) row (kernels B1
    # and B2) instead of float32.
    serve_kv_quant: bool = False    # MLSL_SERVE_KV_QUANT
    # TRANSIENT retries of a failed decode step in place, with jittered
    # exponential backoff from this base (supervisor.jittered_backoff).
    comm_retries: int = 2               # MLSL_COMM_RETRIES
    comm_retry_backoff_s: float = 0.05  # MLSL_COMM_RETRY_BACKOFF_S

    # --- the fault plane and telemetry (chaos.py, supervisor.py, obs/,
    # analysis/witness.py; config.py:281-474 of the JAX package).
    # Environment.init hands each knob to the module that acts on it
    # (supervisor.configure, supervisor.configure_fault_plane); before any
    # init those modules read the environment variables themselves. ---
    # Request watchdog: wait() on a request in flight longer than this raises
    # MLSLTimeoutError and writes the tracer's flight record (0 = off).
    watchdog_timeout_s: float = 0.0     # MLSL_WATCHDOG_TIMEOUT (seconds)
    # Rung 3: per-subsystem circuit breakers (quant, bucket, algo, tracer).
    # After `threshold` classified failures inside the sliding window the
    # breaker trips OPEN and the subsystem degrades; after the cooldown one
    # half-open probe decides.
    breaker_threshold: int = 3          # MLSL_BREAKER_THRESHOLD
    breaker_window_s: float = 30.0      # MLSL_BREAKER_WINDOW_S
    breaker_cooldown_s: float = 10.0    # MLSL_BREAKER_COOLDOWN_S
    # Runtime lock witness (analysis/witness.py): named locks created while
    # it is armed are instrumented; holds over the budget are reported.
    lock_witness: bool = False          # MLSL_LOCK_WITNESS
    lock_witness_budget_ms: float = 250.0   # MLSL_LOCK_WITNESS_BUDGET_MS
    # Fault-injection spec (chaos.py's grammar), armed at init unless it is
    # the spec the plans were last armed from.
    chaos_spec: str = ""            # MLSL_CHAOS
    # Telemetry plane: the metrics registry (armed by MLSL_METRICS or a
    # scrape port), its sampler cadence and ring size, and the scrape port
    # of /metrics, /healthz and /statusz (0 = off).
    metrics: bool = False           # MLSL_METRICS
    metrics_every: int = 20         # MLSL_METRICS_EVERY
    metrics_port: int = 0           # MLSL_METRICS_PORT
    metrics_retention: int = 512    # MLSL_METRICS_RETENTION
    # Straggler sentinel (obs/straggler.py): fire when one replica's window
    # median exceeds skew x its peers', sustained over `sustain` audits.
    straggler_skew: float = 0.0     # MLSL_STRAGGLER_SKEW (0 = off)
    straggler_every: int = 20       # MLSL_STRAGGLER_EVERY
    straggler_sustain: int = 2      # MLSL_STRAGGLER_SUSTAIN
    straggler_shed: bool = False    # MLSL_STRAGGLER_SHED
    # On a watchdog trip, a short torch.profiler trace next to the flight
    # record (core/stats._profile_on_trip).
    profile_on_trip: bool = False   # MLSL_PROFILE_ON_TRIP
    # The span tracer (obs/tracer.py): armed at init with this many slots,
    # its exports written to trace_dir ("" = MLSL_TRACE_DIR, else CWD).
    trace: bool = False             # MLSL_TRACE
    trace_dir: str = ""             # MLSL_TRACE_DIR
    trace_capacity: int = 65536     # MLSL_TRACE_CAPACITY

    # --- the integrity sentinel (sentinel.py; config.py:337-362 of the JAX
    # package), armed on each DataParallelTrainer ---
    # Step quality gate: '' = off; 'warn' logs and continues, 'skip_step'
    # drops the step before any comm starts (residuals and data order stay
    # as if it never ran), 'rollback' raises MLSLIntegrityError. An armed
    # gate turns the fused no-comm step off (it needs the gradients).
    sentinel_gate: str = ""         # MLSL_SENTINEL_GATE
    # Consistency audit interval in steps (0 = off): a blockwise int32
    # fingerprint of the parameters and optimizer state. A tuned profile may
    # set it; an exported value wins.
    sentinel_every: int = 0         # MLSL_SENTINEL_EVERY
    # Gradient-norm spike screen: fire above this factor times its EMA.
    sentinel_spike: float = 10.0    # MLSL_SENTINEL_SPIKE
    # Loss z-score screen: fire beyond this many EMA standard deviations.
    sentinel_zmax: float = 8.0      # MLSL_SENTINEL_ZMAX
    # Healthy steps before the spike and z-score screens arm (the
    # non-finite screen is always armed).
    sentinel_warmup: int = 5        # MLSL_SENTINEL_WARMUP
    # Fingerprint block in elements: one int32 sum a block.
    sentinel_block: int = 4096      # MLSL_SENTINEL_BLOCK

    # --- static analysis (analysis/; config.py:363-374 of the JAX package) ---
    # Commit-time collective-plan verifier: MLSL_VERIFY=1 walks the committed
    # graph at Session.commit (and the compiled engine's plan where it is
    # built) and checks issue order, in-flight budgets, quantization and codec
    # geometry, the degrade machinery and the kernel routes' launch limits
    # (analysis/plan.py), then explores the control-plane and elastic protocol
    # models (analysis/protocol.py).
    verify: bool = False                # MLSL_VERIFY
    # What an error-severity finding does: 'error' raises MLSLError naming
    # every code; 'warn' logs the findings and goes on. Both record the
    # verdict in supervisor.status()['analysis'] and the ANALYSIS stats line.
    verify_severity: str = "error"      # MLSL_VERIFY_SEVERITY

    # --- recovery (checkpoint.py, resilience.py, elastic.py, control/;
    # config.py:285-340, 430-460 of the JAX package) ---
    # Checkpoint save retries on OSError beyond the first, with exponential
    # backoff from the base; CheckpointManager reads the same variables.
    ckpt_save_retries: int = 3          # MLSL_CKPT_SAVE_RETRIES
    ckpt_retry_backoff_s: float = 0.05  # MLSL_CKPT_RETRY_BACKOFF_S
    # Checkpoint recoveries FaultTolerantLoop may make across a run.
    restart_budget: int = 20            # MLSL_RESTART_BUDGET
    # Answer a DEVICE_LOSS fault by shrinking to the survivor ranks and
    # resharding ZeRO-1 state live instead of restarting.
    elastic: bool = False               # MLSL_ELASTIC
    # Ranks the run may shed in all before a loss restarts (0 = half the world).
    capacity_budget: int = 0            # MLSL_CAPACITY_BUDGET
    # Steps after a shrink at which the lost ranks rejoin (0 = only on
    # ElasticCoordinator.announce_return()).
    elastic_grow_after: int = 0         # MLSL_ELASTIC_GROW_AFTER
    # Re-syncs of a rejoining copy that fails its admission audit.
    elastic_admit_retries: int = 1      # MLSL_ELASTIC_ADMIT_RETRIES
    # The control plane (control/): heartbeat cadence and miss budget on its
    # own localhost TCP sockets, the boot grace, the scheduler's notice file
    # and the pod's address table ("host:port,..." or a base port + world).
    heartbeat_interval_s: float = 2.0   # MLSL_HEARTBEAT_INTERVAL_S
    heartbeat_misses: int = 3           # MLSL_HEARTBEAT_MISSES
    heartbeat_grace_s: float = 30.0     # MLSL_HEARTBEAT_GRACE_S
    preemption_file: str = ""           # MLSL_PREEMPTION_FILE
    control_addrs: str = ""             # MLSL_CONTROL_ADDRS
    control_port: int = 0               # MLSL_CONTROL_PORT
    control_world: int = 0              # MLSL_CONTROL_WORLD
    control_rank: int = -1              # MLSL_CONTROL_RANK
    # the multi-process bootstrap's retry budget (comm/transport.bootstrap):
    # attempts beyond the first, backoff dist_init_backoff_s * 2**(k-1)
    dist_init_retries: int = 3          # MLSL_DIST_INIT_RETRIES
    dist_init_backoff_s: float = 0.5    # MLSL_DIST_INIT_BACKOFF_S

    def validate(self) -> None:
        """Reject unserviceable settings at init. Parses ``collective_algo``
        into ``_forced_algos`` (comm/algos.select reads it)."""
        from mlsl_tpu_torch.comm import algos

        self._forced_algos = algos.parse_forced(self.collective_algo)
        mlsl_assert(self.large_msg_size_mb >= 0,
                    "MLSL_LARGE_MSG_SIZE_MB must be >= 0 (got %d)",
                    self.large_msg_size_mb)
        mlsl_assert(self.large_msg_chunks >= 1,
                    "MLSL_LARGE_MSG_CHUNKS must be >= 1 (got %d)",
                    self.large_msg_chunks)
        mlsl_assert(self.grad_bucket_mb >= 0,
                    "MLSL_GRAD_BUCKET_MB must be >= 0 (got %d)", self.grad_bucket_mb)
        mlsl_assert(self.quant_block_elems > 0 and self.quant_block_elems % 32 == 0,
                    "MLSL_QUANT_BLOCK_ELEMS must be a positive multiple of 32 "
                    "(one warp per block row; got %d)", self.quant_block_elems)
        mlsl_assert(self.msg_priority_threshold >= 0,
                    "MLSL_MSG_PRIORITY_THRESHOLD must be >= 0 (got %d)",
                    self.msg_priority_threshold)
        mlsl_assert(self.msg_priority_flush_ms >= 0,
                    "MLSL_MSG_PRIORITY_FLUSH_MS must be >= 0 (got %s)",
                    self.msg_priority_flush_ms)
        mlsl_assert(self.gather_device_limit_mb >= 0,
                    "MLSL_GATHER_DEVICE_LIMIT_MB must be >= 0 (got %d)",
                    self.gather_device_limit_mb)
        mlsl_assert(self.overlap_stages >= 1,
                    "MLSL_OVERLAP_STAGES must be >= 1 (got %d)", self.overlap_stages)
        mlsl_assert(0.0 < self.topk_ratio <= 1.0,
                    "MLSL_TOPK_RATIO must be in (0, 1] (got %r)", self.topk_ratio)
        mlsl_assert(self.codec in ("",) + _CODEC_NAMES,
                    "MLSL_CODEC must be '' or one of %s (got %r)",
                    "/".join(_CODEC_NAMES), self.codec)
        mlsl_assert(isinstance(self.codec_assignment, dict),
                    "codec_assignment must be a dict of request name -> calibration cell "
                    "(got %r)", type(self.codec_assignment).__name__)
        mlsl_assert(self.codec_nsr_budget > 0.0,
                    "MLSL_CODEC_NSR_BUDGET must be > 0 (got %r)", self.codec_nsr_budget)
        mlsl_assert(self.codec_guard_breaches >= 1,
                    "MLSL_CODEC_GUARD_BREACHES must be >= 1 (got %d)",
                    self.codec_guard_breaches)
        mlsl_assert(1 <= self.vq_dim <= 64, "MLSL_VQ_DIM must be in [1, 64] (got %d)",
                    self.vq_dim)
        mlsl_assert(2 <= self.vq_codebook <= 256,
                    "MLSL_VQ_CODEBOOK must be in [2, 256] (one index byte per vector; "
                    "got %d)", self.vq_codebook)
        mlsl_assert(0.0 < self.prune_ratio <= 1.0,
                    "MLSL_PRUNE_RATIO must be in (0, 1] (got %r)", self.prune_ratio)
        # the MLSL_MESH_TIERS grammar (comm/mesh.parse_mesh_tiers)
        spec = (self.mesh_tiers or "").strip().lower()
        if spec:
            parts = spec.split("x")
            mlsl_assert(len(parts) == 2
                        and all(p.strip().isdigit() and int(p) >= 1 for p in parts),
                        "MLSL_MESH_TIERS must be 'TxL' with positive ints (got %r)",
                        self.mesh_tiers)
        mlsl_assert(self.hier_dcn_codec in _CODEC_NAMES,
                    "MLSL_HIER_DCN_CODEC must be one of %s (got %r)",
                    "/".join(_CODEC_NAMES), self.hier_dcn_codec)
        mlsl_assert(self.pallas_rhd_max_bytes >= 0,
                    "MLSL_PALLAS_RHD_MAX_BYTES must be >= 0 (0 = derive from "
                    "MLSL_MSG_PRIORITY_THRESHOLD; got %d)", self.pallas_rhd_max_bytes)
        try:
            # data.common imports nothing of the kernel stack
            from mlsl_tpu_torch.data.common import parse_wire_spec

            parse_wire_spec(self.feed_wire_dtype)
        except ValueError as e:
            from mlsl_tpu_torch.log import MLSLError

            raise MLSLError(f"MLSL_FEED_WIRE_DTYPE: {e}") from e
        mlsl_assert(self.feed_depth >= 1,
                    "MLSL_FEED_DEPTH must be >= 1 (got %d)", self.feed_depth)
        mlsl_assert(self.feed_cache_mb >= 0,
                    "MLSL_FEED_CACHE_MB must be >= 0 (got %d)", self.feed_cache_mb)
        mlsl_assert(self.feed_retries >= 0,
                    "MLSL_FEED_RETRIES must be >= 0 (got %d)", self.feed_retries)
        mlsl_assert(self.comm_retries >= 0,
                    "MLSL_COMM_RETRIES must be >= 0 (got %d)", self.comm_retries)
        mlsl_assert(self.comm_retry_backoff_s >= 0,
                    "MLSL_COMM_RETRY_BACKOFF_S must be >= 0 (got %r)",
                    self.comm_retry_backoff_s)
        mlsl_assert(self.serve_max_batch >= 1,
                    "MLSL_SERVE_MAX_BATCH must be >= 1 (got %d)", self.serve_max_batch)
        mlsl_assert(self.serve_kv_page_elems >= 1,
                    "MLSL_SERVE_KV_PAGE_ELEMS must be >= 1 (got %d)",
                    self.serve_kv_page_elems)
        mlsl_assert(self.serve_kv_cache_mb >= 1,
                    "MLSL_SERVE_KV_CACHE_MB must be >= 1 -- a zero-page cache cannot "
                    "admit any sequence (got %d)", self.serve_kv_cache_mb)
        mlsl_assert(self.serve_queue_depth >= 1,
                    "MLSL_SERVE_QUEUE_DEPTH must be >= 1 (got %d)", self.serve_queue_depth)
        mlsl_assert(self.watchdog_timeout_s >= 0,
                    "MLSL_WATCHDOG_TIMEOUT must be >= 0 (got %r)", self.watchdog_timeout_s)
        mlsl_assert(self.breaker_threshold >= 1,
                    "MLSL_BREAKER_THRESHOLD must be >= 1 (got %d)", self.breaker_threshold)
        mlsl_assert(self.breaker_window_s >= 0 and self.breaker_cooldown_s >= 0,
                    "MLSL_BREAKER_WINDOW_S / MLSL_BREAKER_COOLDOWN_S must be >= 0 "
                    "(got %r / %r)", self.breaker_window_s, self.breaker_cooldown_s)
        mlsl_assert(self.lock_witness_budget_ms > 0,
                    "MLSL_LOCK_WITNESS_BUDGET_MS must be > 0 (got %s)",
                    self.lock_witness_budget_ms)
        mlsl_assert(self.verify_severity in ("error", "warn"),
                    "MLSL_VERIFY_SEVERITY must be 'error' or 'warn' (got %r)",
                    self.verify_severity)
        mlsl_assert(self.metrics_every >= 1,
                    "MLSL_METRICS_EVERY must be >= 1 (got %d)", self.metrics_every)
        mlsl_assert(0 <= self.metrics_port <= 65535,
                    "MLSL_METRICS_PORT must be in [0, 65535] (0 = off; got %d)",
                    self.metrics_port)
        mlsl_assert(self.metrics_retention >= 2,
                    "MLSL_METRICS_RETENTION must be >= 2 (got %d)", self.metrics_retention)
        mlsl_assert(self.straggler_skew == 0 or self.straggler_skew > 1.0,
                    "MLSL_STRAGGLER_SKEW must be 0 (off) or > 1 -- a skew ratio at or "
                    "below 1 would flag healthy replicas (got %r)", self.straggler_skew)
        mlsl_assert(self.straggler_every >= 3,
                    "MLSL_STRAGGLER_EVERY must be >= 3 (a replica needs 3 window samples "
                    "to be judged; got %d)", self.straggler_every)
        mlsl_assert(self.straggler_sustain >= 1,
                    "MLSL_STRAGGLER_SUSTAIN must be >= 1 (got %d)", self.straggler_sustain)
        mlsl_assert(self.sentinel_gate in ("", "warn", "skip_step", "rollback"),
                    "MLSL_SENTINEL_GATE must be '', 'warn', 'skip_step' or 'rollback' "
                    "(got %r)", self.sentinel_gate)
        mlsl_assert(self.sentinel_every >= 0,
                    "MLSL_SENTINEL_EVERY must be >= 0 (got %d)", self.sentinel_every)
        mlsl_assert(self.sentinel_spike > 1.0,
                    "MLSL_SENTINEL_SPIKE must be > 1 (got %r)", self.sentinel_spike)
        mlsl_assert(self.sentinel_zmax > 0,
                    "MLSL_SENTINEL_ZMAX must be > 0 (got %r)", self.sentinel_zmax)
        mlsl_assert(self.sentinel_warmup >= 0,
                    "MLSL_SENTINEL_WARMUP must be >= 0 (got %d)", self.sentinel_warmup)
        mlsl_assert(self.sentinel_block > 0,
                    "MLSL_SENTINEL_BLOCK must be > 0 (got %d)", self.sentinel_block)
        mlsl_assert(self.ckpt_save_retries >= 0,
                    "MLSL_CKPT_SAVE_RETRIES must be >= 0 (got %d)", self.ckpt_save_retries)
        mlsl_assert(self.ckpt_retry_backoff_s >= 0,
                    "MLSL_CKPT_RETRY_BACKOFF_S must be >= 0 (got %r)",
                    self.ckpt_retry_backoff_s)
        mlsl_assert(self.restart_budget >= 0,
                    "MLSL_RESTART_BUDGET must be >= 0 (got %d)", self.restart_budget)
        mlsl_assert(self.capacity_budget >= 0,
                    "MLSL_CAPACITY_BUDGET must be >= 0 (0 = half the world; got %d)",
                    self.capacity_budget)
        mlsl_assert(self.elastic_grow_after >= 0,
                    "MLSL_ELASTIC_GROW_AFTER must be >= 0 (0 = manual announce; got %d)",
                    self.elastic_grow_after)
        mlsl_assert(self.elastic_admit_retries >= 0,
                    "MLSL_ELASTIC_ADMIT_RETRIES must be >= 0 (got %d)",
                    self.elastic_admit_retries)
        mlsl_assert(self.heartbeat_interval_s > 0,
                    "MLSL_HEARTBEAT_INTERVAL_S must be > 0 (got %r)", self.heartbeat_interval_s)
        mlsl_assert(self.heartbeat_misses >= 1,
                    "MLSL_HEARTBEAT_MISSES must be >= 1 (a zero miss budget would declare "
                    "every peer dead on the first tick; got %d)", self.heartbeat_misses)
        mlsl_assert(self.heartbeat_grace_s >= 0,
                    "MLSL_HEARTBEAT_GRACE_S must be >= 0 (got %r)", self.heartbeat_grace_s)
        mlsl_assert(0 <= self.control_port <= 65535,
                    "MLSL_CONTROL_PORT must be in [0, 65535] (0 = off; got %d)",
                    self.control_port)
        mlsl_assert(self.control_world >= 0,
                    "MLSL_CONTROL_WORLD must be >= 0 (got %d)", self.control_world)
        mlsl_assert(not (self.control_addrs and self.control_world),
                    "MLSL_CONTROL_ADDRS and MLSL_CONTROL_PORT/WORLD are mutually exclusive "
                    "bootstrap forms -- set one")
        if self.control_addrs or self.control_world:
            world = (len(self.control_addrs.split(",")) if self.control_addrs
                     else self.control_world)
            mlsl_assert(0 <= self.control_rank < world,
                        "MLSL_CONTROL_RANK must name this process's slot in the %d-member "
                        "control world (got %d)", world, self.control_rank)
        mlsl_assert(self.dist_init_retries >= 0,
                    "MLSL_DIST_INIT_RETRIES must be >= 0 (got %d)", self.dist_init_retries)
        mlsl_assert(self.dist_init_backoff_s >= 0,
                    "MLSL_DIST_INIT_BACKOFF_S must be >= 0 (got %r)", self.dist_init_backoff_s)

    @staticmethod
    def from_env() -> "Config":
        c = Config()
        # the knobs exported explicitly: neither a tuned profile nor
        # sysinfo.auto_config overrides them (reference src/mlsl.cpp:649-682)
        c._explicit = {field for env, field in _ENV_FIELDS.items() if os.environ.get(env)}
        c.log_level = _env_int("MLSL_LOG_LEVEL", c.log_level)
        c.enable_stats = _env_bool("MLSL_STATS", c.enable_stats)
        c.auto_config_type = _env_int("MLSL_AUTO_CONFIG_TYPE", c.auto_config_type)
        c.compile_cache_dir = os.environ.get("MLSL_COMPILE_CACHE_DIR", c.compile_cache_dir)
        c.dup_group = _env_bool("MLSL_DUP_GROUP", c.dup_group)
        c.num_servers = _env_int("MLSL_NUM_SERVERS", c.num_servers)
        c.max_short_msg_size = _env_int("MLSL_MAX_SHORT_MSG_SIZE", c.max_short_msg_size)
        c.server_affinity = os.environ.get("MLSL_SERVER_AFFINITY", c.server_affinity)
        c.heap_size_gb = _env_int("MLSL_HEAP_SIZE_GB", c.heap_size_gb)
        c.alltoall_split = _env_int("MLSL_ALLTOALL_SPLIT", c.alltoall_split)
        c.thp_threshold_mb = _env_int("MLSL_THP_THRESHOLD_MB", c.thp_threshold_mb)
        c.precompile = _env_bool("MLSL_PRECOMPILE", c.precompile)
        c.gather_device_limit_mb = _env_int("MLSL_GATHER_DEVICE_LIMIT_MB",
                                            c.gather_device_limit_mb)
        c.large_msg_size_mb = _env_int("MLSL_LARGE_MSG_SIZE_MB", c.large_msg_size_mb)
        c.large_msg_chunks = _env_int("MLSL_LARGE_MSG_CHUNKS", c.large_msg_chunks)
        c.grad_bucket_mb = _env_int("MLSL_GRAD_BUCKET_MB", c.grad_bucket_mb)
        c.msg_priority = _env_bool("MLSL_MSG_PRIORITY", c.msg_priority)
        c.msg_priority_threshold = _env_int(
            "MLSL_MSG_PRIORITY_THRESHOLD", c.msg_priority_threshold
        )
        c.msg_priority_mode = _env_bool("MLSL_MSG_PRIORITY_MODE", c.msg_priority_mode)
        c.msg_priority_flush_ms = _env_float("MLSL_MSG_PRIORITY_FLUSH_MS",
                                             c.msg_priority_flush_ms)
        c.quant_block_elems = _env_int("MLSL_QUANT_BLOCK_ELEMS", c.quant_block_elems)
        c.collective_algo = os.environ.get("MLSL_ALGO", c.collective_algo)
        c.tune = _env_bool("MLSL_TUNE", c.tune)
        c.tune_profile = os.environ.get("MLSL_TUNE_PROFILE", c.tune_profile)
        c.pallas_ring_bidir = _env_bool("MLSL_PALLAS_RING_BIDIR", c.pallas_ring_bidir)
        c.pallas_rhd = _env_bool("MLSL_PALLAS_RHD", c.pallas_rhd)
        c.pallas_rhd_max_bytes = _env_int("MLSL_PALLAS_RHD_MAX_BYTES",
                                          c.pallas_rhd_max_bytes)
        c.pallas_a2a_quant = _env_bool("MLSL_PALLAS_A2A_QUANT", c.pallas_a2a_quant)
        c.overlap_compiled = _env_bool("MLSL_OVERLAP_COMPILED", c.overlap_compiled)
        c.overlap_stages = _env_int("MLSL_OVERLAP_STAGES", c.overlap_stages)
        c.topk_ratio = _env_float("MLSL_TOPK_RATIO", c.topk_ratio)
        c.codec = os.environ.get("MLSL_CODEC", c.codec).strip().lower()
        c.tune_codec = _env_bool("MLSL_TUNE_CODEC", c.tune_codec)
        c.codec_nsr_budget = _env_float("MLSL_CODEC_NSR_BUDGET", c.codec_nsr_budget)
        c.codec_guard_breaches = _env_int("MLSL_CODEC_GUARD_BREACHES", c.codec_guard_breaches)
        c.vq_dim = _env_int("MLSL_VQ_DIM", c.vq_dim)
        c.vq_codebook = _env_int("MLSL_VQ_CODEBOOK", c.vq_codebook)
        c.prune_ratio = _env_float("MLSL_PRUNE_RATIO", c.prune_ratio)
        c.mesh_tiers = os.environ.get("MLSL_MESH_TIERS", c.mesh_tiers).strip()
        c.hier_dcn_codec = (os.environ.get("MLSL_HIER_DCN_CODEC", "").strip().lower()
                            or c.hier_dcn_codec)
        c.feed_wire_dtype = os.environ.get("MLSL_FEED_WIRE_DTYPE", c.feed_wire_dtype)
        c.feed_cache_mb = _env_int("MLSL_FEED_CACHE_MB", c.feed_cache_mb)
        c.feed_depth = _env_int("MLSL_FEED_DEPTH", c.feed_depth)
        c.feed_retries = _env_int("MLSL_FEED_RETRIES", c.feed_retries)
        c.serve_max_batch = _env_int("MLSL_SERVE_MAX_BATCH", c.serve_max_batch)
        c.serve_kv_page_elems = _env_int("MLSL_SERVE_KV_PAGE_ELEMS", c.serve_kv_page_elems)
        c.serve_kv_cache_mb = _env_int("MLSL_SERVE_KV_CACHE_MB", c.serve_kv_cache_mb)
        c.serve_queue_depth = _env_int("MLSL_SERVE_QUEUE_DEPTH", c.serve_queue_depth)
        c.serve_kv_quant = _env_bool("MLSL_SERVE_KV_QUANT", c.serve_kv_quant)
        c.comm_retries = _env_int("MLSL_COMM_RETRIES", c.comm_retries)
        c.comm_retry_backoff_s = _env_float("MLSL_COMM_RETRY_BACKOFF_S",
                                            c.comm_retry_backoff_s)
        c.watchdog_timeout_s = _env_float("MLSL_WATCHDOG_TIMEOUT", c.watchdog_timeout_s)
        c.breaker_threshold = _env_int("MLSL_BREAKER_THRESHOLD", c.breaker_threshold)
        c.breaker_window_s = _env_float("MLSL_BREAKER_WINDOW_S", c.breaker_window_s)
        c.breaker_cooldown_s = _env_float("MLSL_BREAKER_COOLDOWN_S", c.breaker_cooldown_s)
        c.lock_witness = _env_bool("MLSL_LOCK_WITNESS", c.lock_witness)
        c.lock_witness_budget_ms = _env_float("MLSL_LOCK_WITNESS_BUDGET_MS",
                                              c.lock_witness_budget_ms)
        c.chaos_spec = os.environ.get("MLSL_CHAOS", c.chaos_spec)
        c.metrics = _env_bool("MLSL_METRICS", c.metrics)
        c.metrics_every = _env_int("MLSL_METRICS_EVERY", c.metrics_every)
        c.metrics_port = _env_int("MLSL_METRICS_PORT", c.metrics_port)
        c.metrics_retention = _env_int("MLSL_METRICS_RETENTION", c.metrics_retention)
        c.straggler_skew = _env_float("MLSL_STRAGGLER_SKEW", c.straggler_skew)
        c.straggler_every = _env_int("MLSL_STRAGGLER_EVERY", c.straggler_every)
        c.straggler_sustain = _env_int("MLSL_STRAGGLER_SUSTAIN", c.straggler_sustain)
        c.straggler_shed = _env_bool("MLSL_STRAGGLER_SHED", c.straggler_shed)
        c.profile_on_trip = _env_bool("MLSL_PROFILE_ON_TRIP", c.profile_on_trip)
        c.trace = _env_bool("MLSL_TRACE", c.trace)
        c.trace_dir = os.environ.get("MLSL_TRACE_DIR", c.trace_dir)
        c.trace_capacity = _env_int("MLSL_TRACE_CAPACITY", c.trace_capacity)
        c.sentinel_gate = os.environ.get("MLSL_SENTINEL_GATE", c.sentinel_gate)
        c.sentinel_every = _env_int("MLSL_SENTINEL_EVERY", c.sentinel_every)
        c.sentinel_spike = _env_float("MLSL_SENTINEL_SPIKE", c.sentinel_spike)
        c.sentinel_zmax = _env_float("MLSL_SENTINEL_ZMAX", c.sentinel_zmax)
        c.sentinel_warmup = _env_int("MLSL_SENTINEL_WARMUP", c.sentinel_warmup)
        c.sentinel_block = _env_int("MLSL_SENTINEL_BLOCK", c.sentinel_block)
        c.verify = _env_bool("MLSL_VERIFY", c.verify)
        c.verify_severity = os.environ.get(
            "MLSL_VERIFY_SEVERITY", c.verify_severity).strip().lower() or c.verify_severity
        c.ckpt_save_retries = _env_int("MLSL_CKPT_SAVE_RETRIES", c.ckpt_save_retries)
        c.ckpt_retry_backoff_s = _env_float("MLSL_CKPT_RETRY_BACKOFF_S", c.ckpt_retry_backoff_s)
        c.restart_budget = _env_int("MLSL_RESTART_BUDGET", c.restart_budget)
        c.elastic = _env_bool("MLSL_ELASTIC", c.elastic)
        c.capacity_budget = _env_int("MLSL_CAPACITY_BUDGET", c.capacity_budget)
        c.elastic_grow_after = _env_int("MLSL_ELASTIC_GROW_AFTER", c.elastic_grow_after)
        c.elastic_admit_retries = _env_int("MLSL_ELASTIC_ADMIT_RETRIES",
                                           c.elastic_admit_retries)
        c.heartbeat_interval_s = _env_float("MLSL_HEARTBEAT_INTERVAL_S",
                                            c.heartbeat_interval_s)
        c.heartbeat_misses = _env_int("MLSL_HEARTBEAT_MISSES", c.heartbeat_misses)
        c.heartbeat_grace_s = _env_float("MLSL_HEARTBEAT_GRACE_S", c.heartbeat_grace_s)
        c.preemption_file = os.environ.get("MLSL_PREEMPTION_FILE", c.preemption_file)
        c.control_addrs = os.environ.get("MLSL_CONTROL_ADDRS", c.control_addrs)
        c.control_port = _env_int("MLSL_CONTROL_PORT", c.control_port)
        c.control_world = _env_int("MLSL_CONTROL_WORLD", c.control_world)
        c.control_rank = _env_int("MLSL_CONTROL_RANK", c.control_rank)
        c.dist_init_retries = _env_int("MLSL_DIST_INIT_RETRIES", c.dist_init_retries)
        c.dist_init_backoff_s = _env_float("MLSL_DIST_INIT_BACKOFF_S", c.dist_init_backoff_s)
        return c
