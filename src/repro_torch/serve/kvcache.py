"""Paged KV cache: fixed-size pages, per-slot page tables, alloc/free.

Port of ``repro.serve.kvcache.PagedKVCache`` for attention-only stacks.
Each layer's K and V live in one token-major pool ``(num_pages *
page_size, kv_heads, head_dim)`` on the device; each serving slot owns
only the pages it was allocated, and the per-slot page table maps its
logical positions to pool rows.  Page 0 is the reserved trash page:
never allocated, the write sink of idle slots (all-zero table rows).

Allocation is host bookkeeping (a free list); the device only sees the
table.  The model updates the pool in place, so a prefill call for one
slot simply receives the whole pool (the reference's ``slot_cache`` /
``merge_slot_cache`` exist to slice per-slot SSM state, which this
attention-only path has none of).  Prefix aliasing, copy-on-write and
page refcounts join with the prefix-cache slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import PagedView
from repro_torch.models.model import init_cache

__all__ = ["PagedView", "PagedKVCache"]


class PagedKVCache:
    """Device pool + host page bookkeeping for one serving batch."""

    def __init__(self, cfg, *, slots: int, max_len: int, page_size: int = 16,
                 num_pages: Optional[int] = None, dtype=torch.float32,
                 device="cuda"):
        if max_len % page_size:
            raise ValueError(
                f"max_len={max_len} must be a multiple of "
                f"page_size={page_size} (the gather width is the table "
                "span; keep it page-aligned)")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.page_size = page_size
        self.table_width = max_len // page_size
        self.num_pages = (slots * self.table_width + 1 if num_pages is None
                          else num_pages)
        if self.num_pages < 2:
            raise ValueError("need at least one real page beyond the "
                             "reserved trash page 0")
        self.device = resolve_device(device)
        self.cache = init_cache(cfg, dtype, pool=(self.num_pages, page_size),
                                device=self.device)
        self._table = np.zeros((slots, self.table_width), np.int32)
        self._free = list(range(self.num_pages - 1, 0, -1))  # stack, no 0
        self._owned = {s: [] for s in range(slots)}

    # ---- host bookkeeping -----------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return sum(len(v) for v in self._owned.values())

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, slot: int, n_tokens: int) -> None:
        """Ensure `slot` owns pages for a TOTAL of `n_tokens` tokens,
        topping up past its current allocation; updates its table row."""
        have = len(self._owned[slot]) * self.page_size
        need = self.pages_needed(max(0, n_tokens - have))
        if need > len(self._free):
            raise MemoryError(
                f"paged KV pool exhausted: slot {slot} needs {need} more "
                f"pages, {len(self._free)} free of {self.num_pages - 1}")
        if len(self._owned[slot]) + need > self.table_width:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens exceeds max_len="
                f"{self.max_len}")
        for _ in range(need):
            p = self._free.pop()
            self._table[slot, len(self._owned[slot])] = p
            self._owned[slot].append(p)

    def free(self, slot: int) -> None:
        """Return the slot's pages to the free list and point its table
        row at the trash page, so in-flight writes land harmlessly."""
        self._free.extend(reversed(self._owned[slot]))
        self._owned[slot] = []
        self._table[slot] = 0

    # ---- device views ----------------------------------------------------
    def table(self, rows=None) -> torch.Tensor:
        """Device page table (int32) -- all slots, or a subset of rows."""
        t = self._table if rows is None else self._table[list(rows)]
        return torch.from_numpy(np.ascontiguousarray(t)).to(self.device)

    def view(self, rows=None) -> PagedView:
        return PagedView(self.table(rows), self.page_size)

    # ---- accounting ------------------------------------------------------
    def pool_bytes(self) -> int:
        """Resident bytes of the paged pools."""
        return sum(t.numel() * t.element_size()
                   for layer in self.cache for t in layer.values())
