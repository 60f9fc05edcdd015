"""Typed configuration with MLSL_* environment-variable overrides.

The subset of ``mlsl_tpu.config.Config`` that this package reads: the int8
codec's block, large-message chunking (reference src/comm_ep.cpp:95-97) and
newest-first priority deferral (reference eplib/env.c:135-165). Field names,
defaults and environment names are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os

from mlsl_tpu_torch.log import mlsl_assert


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v.strip().lower() not in ("0", "false", "no", "off")


@dataclasses.dataclass
class Config:
    enable_stats: bool = False      # MLSL_STATS
    # Chunking for very large messages: an allreduce above this size is split
    # into independently dispatched chunks so Wait completes incrementally.
    large_msg_size_mb: int = 128    # MLSL_LARGE_MSG_SIZE_MB
    large_msg_chunks: int = 4       # MLSL_LARGE_MSG_CHUNKS
    # Newest-first priority: requests above the threshold are deferred on a
    # stack and dispatched LIFO at the next sync point.
    msg_priority: bool = False           # MLSL_MSG_PRIORITY
    msg_priority_threshold: int = 10000  # MLSL_MSG_PRIORITY_THRESHOLD (bytes)
    # Elements per int8 quantization block (one float32 scale each).
    quant_block_elems: int = 256    # MLSL_QUANT_BLOCK_ELEMS

    def validate(self) -> None:
        mlsl_assert(self.large_msg_size_mb >= 0,
                    "MLSL_LARGE_MSG_SIZE_MB must be >= 0 (got %d)",
                    self.large_msg_size_mb)
        mlsl_assert(self.large_msg_chunks >= 1,
                    "MLSL_LARGE_MSG_CHUNKS must be >= 1 (got %d)",
                    self.large_msg_chunks)
        mlsl_assert(self.quant_block_elems > 0 and self.quant_block_elems % 32 == 0,
                    "MLSL_QUANT_BLOCK_ELEMS must be a positive multiple of 32 "
                    "(one warp per block row; got %d)", self.quant_block_elems)
        mlsl_assert(self.msg_priority_threshold >= 0,
                    "MLSL_MSG_PRIORITY_THRESHOLD must be >= 0 (got %d)",
                    self.msg_priority_threshold)

    @staticmethod
    def from_env() -> "Config":
        c = Config()
        c.enable_stats = _env_bool("MLSL_STATS", c.enable_stats)
        c.large_msg_size_mb = _env_int("MLSL_LARGE_MSG_SIZE_MB", c.large_msg_size_mb)
        c.large_msg_chunks = _env_int("MLSL_LARGE_MSG_CHUNKS", c.large_msg_chunks)
        c.msg_priority = _env_bool("MLSL_MSG_PRIORITY", c.msg_priority)
        c.msg_priority_threshold = _env_int(
            "MLSL_MSG_PRIORITY_THRESHOLD", c.msg_priority_threshold
        )
        c.quant_block_elems = _env_int("MLSL_QUANT_BLOCK_ELEMS", c.quant_block_elems)
        return c
