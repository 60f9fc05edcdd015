"""Typed configuration with MLSL_* environment-variable overrides.

The subset of ``mlsl_tpu.config.Config`` that this package reads: statistics,
the commit-time precompile and the device gather's cap, the int8
codec's block, large-message chunking (reference src/comm_ep.cpp:95-97),
gradient bucketing (core/bucketing.py),
newest-first priority deferral and its progress thread (reference
eplib/env.c:135-165), the collective algorithm engine with its tuned profile
and kernel knobs (comm/algos, tuner/, ops/), and the compiled overlap engine
with the staging depth it shares with the ZeRO-1 update (comm/overlap.py).
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
}


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
    enable_stats: bool = False      # MLSL_STATS
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

    # --- collective algorithm engine (comm/algos) + tuned profile (tuner/) ---
    # Forced algorithm: '' = auto (tuned profile, else the 'lax' baseline).
    # One registry name for every engine kind, or a comma list of kind=name
    # entries ('allreduce=rhd,reduce_scatter=ring2d'); validate() parses it
    # into _forced_algos and rejects names the port does not have.
    collective_algo: str = ""       # MLSL_ALGO
    # The autotuner's sweep; not ported (tuner.init_profile rejects it).
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
        mlsl_assert(self.pallas_rhd_max_bytes >= 0,
                    "MLSL_PALLAS_RHD_MAX_BYTES must be >= 0 (0 = derive from "
                    "MLSL_MSG_PRIORITY_THRESHOLD; got %d)", self.pallas_rhd_max_bytes)

    @staticmethod
    def from_env() -> "Config":
        c = Config()
        c._explicit = {field for env, field in _ENV_FIELDS.items() if os.environ.get(env)}
        c.enable_stats = _env_bool("MLSL_STATS", c.enable_stats)
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
        return c
