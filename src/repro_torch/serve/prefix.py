"""Prefix/radix cache: page-table aliasing over the paged KV pool.

Port of ``repro.serve.prefix``: host bookkeeping in numpy only.

Production traffic is templated — tenants share system prompts — yet a
cache-less scheduler re-prefills the same KV pages for every request.
This module keeps a **radix tree over prompt-token pages**: each edge
is one FULL page of prompt tokens (a ``page_size``-tuple of ids), each
node holds the physical pool page that a previous request's prefill
already wrote for exactly that token prefix.  Admission walks the tree
(``match``), aliases the matched pages into the new slot's page table
(``PagedKVCache.alias`` — refcount +1 per page, zero bytes moved), and
prefills only the unmatched suffix: TTFT for templated traffic becomes
the cost of the suffix, not the prompt.

Correctness hinges on three invariants, all enforced here or in
``kvcache``:

* **Content-addressed, position-dependent.** A page's KV bytes depend
  only on the token prefix up to and including that page (per-token
  projections + causal attention over earlier, identical pages), so a
  radix match — identical token pages from position 0 — is exactly the
  condition under which aliasing is bitwise-safe.  Matching starts at
  the root: there is no mid-prompt sharing.
* **Shared pages are read-only.** Writers fork first
  (``PagedKVCache.cow_fork``): the one serving path that must write
  into a matched page — a fully-matched, page-aligned prompt
  re-prefilling its final token to obtain logits — copies the page and
  writes the private copy.  The radix tree keeps indexing the shared
  original.
* **Page 0 never enters the tree.** The trash page is never allocated,
  so no slot's owned pages (the only thing ``insert`` indexes) can
  contain it; ``insert`` asserts anyway.

The tree holds ONE reference per indexed page (taken at ``insert``,
dropped at eviction), so pages outlive the request that wrote them and
future requests can alias them.  Under pool pressure ``evict`` trims
least-recently-matched leaves — interior nodes only become evictable
once their children go, preserving the invariant that every cached
chain is rooted (a match never dangles).

Only attention/MLA architectures can use the cache: a recurrent (SSM)
mixer's state at the suffix boundary is not captured by KV pages, so
``ContinuousScheduler`` refuses ``prefix_cache=True`` for hybrids.

"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache"]


class _Node:
    __slots__ = ("page", "children", "parent", "key", "tick")

    def __init__(self, page: Optional[int], parent, key):
        self.page = page          # physical pool page (None at the root)
        self.children = {}        # page-token tuple -> _Node
        self.parent = parent
        self.key = key
        self.tick = 0


class PrefixCache:
    """Radix tree over prompt pages, backed by a ``PagedKVCache``.

    The cache does not own device memory: it indexes pages the pool
    already holds and manages their lifetime purely through the pool's
    refcounts (one reference per indexed page).
    """

    def __init__(self, kv):
        self.kv = kv
        self.root = _Node(None, None, None)
        self._tick = 0
        self._nodes = 0
        # telemetry: admission-level hit accounting
        self.hits = 0             # lookups that matched >= 1 page
        self.misses = 0
        self.hit_tokens = 0       # prompt tokens covered by matches
        self.lookup_tokens = 0    # prompt tokens seen by lookups
        self.evictions = 0

    # ---- lookup / admission ---------------------------------------------
    def _keys(self, prompt) -> List[tuple]:
        ps = self.kv.page_size
        prompt = np.asarray(prompt).reshape(-1)
        return [tuple(int(t) for t in prompt[i:i + ps])
                for i in range(0, len(prompt) - ps + 1, ps)]

    def match(self, prompt) -> Tuple[int, List[int]]:
        """Longest cached page-chain equal to the prompt's leading full
        pages.  Returns ``(n_tokens_matched, pages)`` — the pages are
        LIVE (refcount >= 1, held by the tree); alias them into a slot
        before anything can evict them."""
        self._tick += 1
        node, pages = self.root, []
        for key in self._keys(prompt):
            child = node.children.get(key)
            if child is None:
                break
            child.tick = self._tick
            pages.append(child.page)
            node = child
        n_tok = len(pages) * self.kv.page_size
        self.lookup_tokens += len(np.asarray(prompt).reshape(-1))
        self.hit_tokens += n_tok
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return n_tok, pages

    def insert(self, prompt, slot_pages) -> int:
        """Index the prompt's full pages (``slot_pages`` = the slot's
        owned pages, in block order, after its prefill completed).
        Existing chains are kept — if two identical prompts prefilled
        before either inserted, the first chain wins and the second
        request's duplicate pages simply retire with its slot.  Returns
        the number of NEW nodes (references taken)."""
        self._tick += 1
        node, added = self.root, 0
        for i, key in enumerate(self._keys(prompt)):
            child = node.children.get(key)
            if child is None:
                page = int(slot_pages[i])
                if page == 0:
                    raise ValueError("page 0 (trash) can never enter the "
                                     "radix tree")
                self.kv.retain(page)
                child = _Node(page, node, key)
                node.children[key] = child
                self._nodes += 1
                added += 1
            child.tick = self._tick
            node = child
        return added

    # ---- eviction --------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict_one(self) -> bool:
        """Drop the least-recently-matched LEAF (deepest page of its
        chain): release the tree's reference so the page returns to the
        free list unless a live slot still aliases it.  Returns False
        when the tree is empty."""
        leaves = self._leaves()
        if not leaves:
            return False
        victim = min(leaves, key=lambda n: n.tick)
        del victim.parent.children[victim.key]
        self.kv.release(victim.page)
        self._nodes -= 1
        self.evictions += 1
        return True

    def evict(self, need_pages: int) -> int:
        """Evict until the pool has ``need_pages`` free (or the tree is
        dry).  Returns pages actually freed to the pool — evicting a
        page a live slot still aliases only drops the tree's reference,
        so callers re-check ``kv.free_pages``."""
        freed0 = self.kv.free_pages
        while self.kv.free_pages < need_pages and self.evict_one():
            pass
        return self.kv.free_pages - freed0

    # ---- introspection ---------------------------------------------------
    @property
    def nodes(self) -> int:
        return self._nodes

    def pages(self) -> List[int]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(n.children.values())
        return out

    def stats(self) -> dict:
        return {
            "nodes": self._nodes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "hit_rate": (self.hit_tokens / self.lookup_tokens
                         if self.lookup_tokens else 0.0),
        }
