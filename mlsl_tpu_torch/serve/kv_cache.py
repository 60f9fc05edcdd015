"""Paged KV cache: the feed cache's admission model, generalized to pages.

Counterpart of ``mlsl_tpu.serve.kv_cache``. The feed cache (data/cache.py)
admits or rejects and never evicts; serving needs more: sequences arrive and
retire continuously and hold very different context lengths. So the KV side
keeps the :class:`~mlsl_tpu_torch.data.cache.AdmissionBudget` contract
underneath and adds:

- **fixed-size pages** -- the engine's pools are (R, D, S, M, n_blocks,
  num_pages + 1, page, heads / tp, head_dim) tensors for K and for V; this
  class is the host-side allocator (free-list and page tables) and never
  touches device memory. A 16-token sequence holds one page, not
  seq_len / page of them.
- **page tables** -- ``table_padded()`` gives the engine a fixed-width gather
  index (padded with page 0), so the decode step has one shape whatever the
  pages a sequence holds, and on the card one captured graph.
- **page 0 is reserved garbage** -- never allocated, never counted against
  the budget. Padded prefill writes and inactive batch slots land there; the
  decode mask keeps it out of every attention read.
- **eviction** -- ``release(evict=True)`` is the preemption path: the engine
  evicts the youngest sequence when a decode step cannot extend, queues it
  again for a resume prefill, and the pages go back to the free-list and the
  budget.

The int8 variant (``quant=True``, ``models.transformer.kv_block_quant`` on
kernel B1) stores one byte an element plus one float32 scale a (token, head)
row: the page-bytes rule below decides how many pages a given
``MLSL_SERVE_KV_CACHE_MB`` buys. Bytes are global logical bytes (every model
rank's head shard), as the JAX package counts them.
"""

from __future__ import annotations

from typing import Dict, List

from mlsl_tpu_torch.data.cache import AdmissionBudget
from mlsl_tpu_torch.log import MLSLError, mlsl_assert
from mlsl_tpu_torch.obs import tracer as obs_trace


class PagedKVCache:
    """Host-side page allocator for the serving engine's KV pools.

    ``cfg`` is the model's TransformerConfig (page bytes depend on
    n_blocks, n_heads and head_dim); ``page_elems`` tokens a page
    (MLSL_SERVE_KV_PAGE_ELEMS); ``budget_mb`` the device budget
    (MLSL_SERVE_KV_CACHE_MB); ``max_len`` the context ceiling (default
    cfg.seq_len, where the engine keeps it: the decode step gathers
    max_pages x page = seq_len positions, the prefill's extent)."""

    def __init__(self, cfg, *, page_elems: int, budget_mb: float,
                 max_len: int = 0, quant: bool = False):
        self.page_elems = int(page_elems)
        self.quant = bool(quant)
        self.ctx_len = int(max_len) if max_len else int(cfg.seq_len)
        mlsl_assert(
            self.ctx_len % self.page_elems == 0,
            f"context length {self.ctx_len} must be a multiple of "
            f"MLSL_SERVE_KV_PAGE_ELEMS={self.page_elems} (the decode step "
            "gathers whole pages)",
        )
        self.max_pages_per_seq = self.ctx_len // self.page_elems
        # bytes of ONE page over every block, K and V: int8 stores 1 byte an
        # element plus a float32 scale a (token, head); float32 stores 4
        elem = 1 if self.quant else 4
        scale = 4 if self.quant else 0
        self.page_bytes = (
            cfg.n_blocks * 2 * self.page_elems * cfg.n_heads
            * (cfg.head_dim * elem + scale)
        )
        self.budget = AdmissionBudget(int(budget_mb * (1 << 20)))
        self.num_pages = self.budget.budget_bytes // self.page_bytes
        if self.num_pages < self.max_pages_per_seq:
            raise MLSLError(
                f"MLSL_SERVE_KV_CACHE_MB={budget_mb} buys {self.num_pages} "
                f"pages of {self.page_bytes} B but one full-context sequence "
                f"needs {self.max_pages_per_seq}; raise the budget or lower "
                "seq_len/MLSL_SERVE_KV_PAGE_ELEMS"
            )
        # page ids 1..num_pages, popped from the tail so that allocation goes
        # 1, 2, 3, ...; page 0 is the reserved garbage page and never here
        self._free: List[int] = list(range(self.num_pages, 0, -1))
        self._tables: Dict[int, List[int]] = {}

    # -- helpers -----------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_elems)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def __len__(self) -> int:
        return len(self._tables)

    # -- allocation --------------------------------------------------------

    def admit(self, seq_id: int, n_tokens: int) -> bool:
        """Allocate pages for a sequence entering the batch with ``n_tokens``
        of context. False = rejected (free-list or budget, both counted as a
        kv reject; the engine leaves the request queued)."""
        from mlsl_tpu_torch.core import stats

        mlsl_assert(seq_id not in self._tables, f"seq {seq_id} already admitted")
        need = self.pages_for(n_tokens)
        if need > len(self._free) or not self.budget.admit(need * self.page_bytes):
            stats.record_serve("kv_rejects")
            return False
        self._tables[seq_id] = [self._free.pop() for _ in range(need)]
        stats.record_serve("kv_pages_alloc", need)
        return True

    def extend(self, seq_id: int, n_tokens: int) -> bool:
        """Grow a sequence's table to cover ``n_tokens`` of context. The
        decode step calls it every step; it allocates only when the position
        crosses a page boundary. False = the pool is exhausted (the engine
        evicts)."""
        from mlsl_tpu_torch.core import stats

        table = self._tables[seq_id]
        need = self.pages_for(n_tokens) - len(table)
        if need <= 0:
            return True
        if need > len(self._free) or not self.budget.admit(need * self.page_bytes):
            stats.record_serve("kv_rejects")
            return False
        table.extend(self._free.pop() for _ in range(need))
        stats.record_serve("kv_pages_alloc", need)
        return True

    def release(self, seq_id: int, evict: bool = False) -> None:
        """Return a sequence's pages to the free-list and the budget.
        ``evict=True`` is the preemption path, counted apart and a
        ``kv.evict`` instant on the tracer's timeline."""
        from mlsl_tpu_torch.core import stats

        table = self._tables.pop(seq_id)
        self._free.extend(reversed(table))
        self.budget.release(len(table) * self.page_bytes)
        stats.record_serve("kv_pages_freed", len(table))
        if evict:
            stats.record_serve("kv_evictions")
            tr = obs_trace._tracer
            if tr is not None:
                tr.instant("kv.evict", "serve", seq=seq_id, pages=len(table))

    def table_padded(self, seq_id: int) -> List[int]:
        """The fixed-width page table of the decode gather: the live pages,
        padded to ``max_pages_per_seq`` with the garbage page 0."""
        table = self._tables[seq_id]
        return table + [0] * (self.max_pages_per_seq - len(table))

    # -- invariants (tests) ------------------------------------------------

    def check(self) -> None:
        """Assert the allocator's invariants; the churn tests call it after
        every operation."""
        held = [p for t in self._tables.values() for p in t]
        mlsl_assert(len(held) == len(set(held)), "page allocated to two sequences")
        mlsl_assert(0 not in held, "garbage page 0 was allocated")
        mlsl_assert(not (set(held) & set(self._free)), "page simultaneously held and free")
        mlsl_assert(len(held) + len(self._free) == self.num_pages,
                    "pages leaked or duplicated")
        mlsl_assert(all(1 <= p <= self.num_pages for p in held + self._free),
                    "page id out of range")
        mlsl_assert(self.budget.bytes == len(held) * self.page_bytes,
                    "budget accounting out of sync with the free-list")
