"""Paged KV cache: fixed-size pages, per-slot page tables, alloc/free,
and per-slot recurrent state.

Port of ``repro.serve.kvcache.PagedKVCache``.  An attention layer's K
and V live in one token-major pool ``(num_pages * page_size, kv_heads,
head_dim)`` on the device (an MLA layer's latent and rope key in
``(num_pages * page_size, kv_lora | rope)``: "pooled" leaves); each serving slot owns
only the pages it was allocated, and the per-slot page table maps its
logical positions to pool rows.  Page 0 is the reserved trash page:
never allocated, the write sink of idle slots (all-zero table rows).
A Mamba or RWKV layer's recurrent state is not paged: it keeps one row
per slot ("per-slot" leaves, O(1) in the context length), zeroed when a
request is admitted into the slot.

Allocation is host bookkeeping (a free list); the device only sees the
table.  The model updates pools and states in place.  Where the
reference slices a B=1 cache for a one-slot prefill call
(``slot_cache``) and writes the call's result back
(``merge_slot_cache``), ``slot_cache`` here returns row VIEWS
``t[slot:slot+1]`` of the per-slot leaves beside the whole pools: the
call's in-place update lands in the slot's rows, so nothing is merged.
Prefix aliasing, copy-on-write and page refcounts join with the
prefix-cache slice.
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
                                slots=slots, device=self.device)
        # which layers hold per-slot (recurrent) leaves, not pooled ones
        self._per_slot = [kind != "attn" for kind, _ in cfg.layer_pattern()]
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

    def reset_slot_state(self, slot: int) -> None:
        """Zero the slot's recurrent rows on admit: the previous
        occupant's state must not leak into a new request."""
        for layer, per_slot in zip(self.cache, self._per_slot):
            if per_slot:
                for t in layer.values():
                    t[slot].zero_()

    def slot_cache(self, slot: int) -> list:
        """The cache of a one-slot (B=1) model call: per-slot leaves as
        row views ``t[slot:slot+1]`` (updated in place by the call),
        pooled leaves shared whole."""
        return [{k: t[slot:slot + 1] for k, t in layer.items()}
                if per_slot else layer
                for layer, per_slot in zip(self.cache, self._per_slot)]

    # ---- accounting ------------------------------------------------------
    def _bytes(self, per_slot: bool) -> int:
        return sum(t.numel() * t.element_size()
                   for layer, p in zip(self.cache, self._per_slot)
                   if p == per_slot for t in layer.values())

    def pool_bytes(self) -> int:
        """Resident bytes of the pooled (paged) leaves."""
        return self._bytes(False)

    def state_bytes(self) -> int:
        """Resident bytes of the per-slot recurrent leaves, all slots."""
        return self._bytes(True)
