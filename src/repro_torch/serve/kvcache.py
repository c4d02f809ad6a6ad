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

Pages are REFCOUNTED, so that the prefix (radix) cache
(``serve.prefix``) can alias one physical page into many page tables:
``alloc`` hands out pages at refcount 1, ``alias`` maps already-written
pages into another slot's table (+1 each), ``retain`` / ``release`` are
the raw operations (the radix tree holds one reference on every page it
indexes), and ``free`` DECREMENTS: a page returns to the free list only
when its last reference drops.  ``cow_fork`` is the copy-on-write: a
slot that must write into a page it shares gets a fresh page whose rows
are copied on the device from the shared one, in every pooled leaf; the
shared page's bytes are never touched.  Page 0 is never allocated,
aliased or refcounted.

On a serve mesh (``mesh=``), each rank allocates only its block of
each pooled leaf, placed by ``sharding.rules.pool_spec``: k / v cut
over ``"model"`` on the kv heads where they divide, else on head_dim;
MLA's latent and rope widths over ``"model"``; the token axis whole,
so the pool is replicated over pod x data; per-slot leaves whole on
every rank.  A pooled layer's cache is then a ``sharding.ctx.Placed``
whose ``split`` names each leaf's cut dim.  Allocation stays host
bookkeeping run alike on every rank; ``cow_fork`` copies a page within
each rank's blocks.  ``pool_bytes()`` is the whole pool's size,
``pool_bytes_by_device()`` each rank's resident bytes (an all-gather
over the ranks, keyed by rank; on one device, that device's).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models.attention import PagedView
from repro_torch.models.model import init_cache
from repro_torch.sharding.ctx import place_cache

__all__ = ["PagedView", "PagedKVCache"]


class PagedKVCache:
    """Device pool + host page bookkeeping for one serving batch."""

    def __init__(self, cfg, *, slots: int, max_len: int, page_size: int = 16,
                 num_pages: Optional[int] = None, dtype=torch.float32,
                 device="cuda", mesh=None):
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
        self.mesh = mesh
        # which layers hold per-slot (recurrent) leaves, not pooled ones
        self._per_slot = [kind != "attn" for kind, _ in cfg.layer_pattern()]
        pool = (self.num_pages, page_size)
        shapes = init_cache(cfg, dtype, pool=pool, slots=slots,
                            device="meta")
        self._pool_bytes = sum(t.numel() * t.element_size()
                               for layer, p in zip(shapes, self._per_slot)
                               if not p for t in layer.values())
        self.cache = (init_cache(cfg, dtype, pool=pool, slots=slots,
                                 device=self.device) if mesh is None
                      else self._placed(shapes))
        self._table = np.zeros((slots, self.table_width), np.int32)
        self._free = list(range(self.num_pages - 1, 0, -1))  # stack, no 0
        self._owned = {s: [] for s in range(slots)}
        self._refs: dict = {}                # page -> refcount (live only)

    def _placed(self, shapes) -> list:
        """This rank's blocks of the pool (``rules.pool_spec``; a
        per-slot leaf's slot axis is 0), zeros."""
        from repro_torch.sharding.comm import MeshComm
        from repro_torch.sharding.rules import pool_spec
        comm = MeshComm(self.mesh)
        return place_cache(shapes, lambda i, name, shape: pool_spec(
            self.cfg, comm.sizes, f"layers/{i}/{name}", shape,
            0 if self._per_slot[i] else -1), comm, self.device)

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
            self._refs[p] = 1
            self._table[slot, len(self._owned[slot])] = p
            self._owned[slot].append(p)

    def free(self, slot: int) -> None:
        """Drop the slot's reference on every page it maps and point its
        table row at the trash page, so in-flight writes land
        harmlessly.  Shared (aliased) pages survive under their other
        references; pages the slot held alone return to the free list."""
        for p in reversed(self._owned[slot]):
            self.release(p)
        self._owned[slot] = []
        self._table[slot] = 0

    # ---- refcounts / prefix aliasing ------------------------------------
    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def retain(self, page: int) -> None:
        """Add a reference to a live page (the radix tree holds one per
        indexed page; ``alias`` takes one per mapped page)."""
        if page == 0:
            raise ValueError("page 0 is the trash sink; never retained")
        if self._refs.get(page, 0) <= 0:
            raise ValueError(f"retain of dead page {page} (double-free "
                             "guard: it is not live)")
        self._refs[page] += 1

    def release(self, page: int) -> None:
        """Drop a reference; the page returns to the free list when the
        last one goes.  Releasing a dead page raises (double free)."""
        if page == 0:
            raise ValueError("page 0 is the trash sink; never released")
        r = self._refs.get(page, 0)
        if r <= 0:
            raise ValueError(f"double free of page {page}")
        if r == 1:
            del self._refs[page]
            self._free.append(page)
        else:
            self._refs[page] = r - 1

    def alias(self, slot: int, pages) -> None:
        """Map already-written shared pages into `slot`'s table (the
        prefix-cache admission path), after the slot's current blocks,
        one reference taken per page.  No bytes move: the slot reads
        the pages through its table and must never write into them
        (``cow_fork`` first if it has to)."""
        if len(self._owned[slot]) + len(pages) > self.table_width:
            raise ValueError(
                f"slot {slot}: aliasing {len(pages)} pages past "
                f"table_width={self.table_width}")
        for p in pages:
            self.retain(p)               # rejects page 0 and dead pages
            self._table[slot, len(self._owned[slot])] = p
            self._owned[slot].append(p)

    @torch.no_grad()
    def cow_fork(self, slot: int, block: int) -> int:
        """Copy-on-write: give `slot` a PRIVATE copy of its `block`-th
        page.  Pops a fresh page, copies the shared page's rows into it
        on the device in every pooled leaf (one copy a leaf, along the
        token axis; per-slot recurrent leaves are not paged), re-points
        the table entry and drops the slot's reference on the shared
        page, whose bytes are never written.  Callers fork exactly when
        the page is shared.  Returns the new page."""
        old = self._owned[slot][block]
        if not self._free:
            raise MemoryError(f"paged KV pool exhausted: COW fork of "
                              f"slot {slot} block {block} needs a free "
                              "page")
        new = self._free.pop()
        self._refs[new] = 1
        ps = self.page_size
        for layer, per_slot in zip(self.cache, self._per_slot):
            if not per_slot:
                for t in layer.values():
                    t[new * ps:(new + 1) * ps].copy_(
                        t[old * ps:(old + 1) * ps])
        self._owned[slot][block] = new
        self._table[slot, block] = new
        self.release(old)
        return new

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
        """Bytes of the whole pool (the pooled, paged leaves), however
        it is placed."""
        return self._pool_bytes

    def pool_bytes_by_device(self) -> dict:
        """Resident pooled bytes of each device holding a block: on a
        mesh {rank: its blocks' bytes}, gathered from every rank (a
        collective); on one device {device: the whole pool}."""
        local = self._bytes(False)
        if self.mesh is None:
            return {str(self.device): local}
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, local)
        return dict(enumerate(got))

    def pool_bytes_per_device(self) -> int:
        """The most pooled bytes any one device holds: ``pool_bytes()``
        on one device, its share under ``pool_spec`` on a mesh."""
        return max(self.pool_bytes_by_device().values())

    def slab_bytes(self) -> int:
        """What the same slots would reserve as a static slab (slots x
        max_len rows of each pooled leaf), the reference's measure of
        what paging saves."""
        rows = self.num_pages * self.page_size
        return self._pool_bytes * self.slots * self.max_len // rows

    def state_bytes(self) -> int:
        """Resident bytes of the per-slot recurrent leaves, all slots."""
        return self._bytes(True)
