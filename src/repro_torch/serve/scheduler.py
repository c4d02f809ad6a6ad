"""Continuous-batching scheduler over the paged KV cache.

Port of ``repro.serve.scheduler.ContinuousScheduler`` without the
prefix cache, speculative decode or a mesh (those join with their own
slices).  A request queue, slot admission the moment a slot retires,
chunked prefill, and a fused decode tick: ``decode_chunk`` sample ->
decode steps queued on the device with EOS masking on the device, then
ONE host sync (``.cpu()``) for the whole tick.  Nothing inside the
tick's loop reads a device value on the host.

Request lifecycle::

    QUEUED     submit() enqueued it (priority-ordered; FIFO within a
               priority); waiting for a slot + pages + tenant quota
    PREFILL    admitted: pages allocated, the slot's recurrent state
               zeroed, the prompt fed in `prefill_chunk`-token chunks
               (exact, never padded: a padded lane would corrupt the
               recurrent state, which integrates every token it sees;
               B=1 calls that write into the shared pool and the slot's
               state rows); the LAST chunk's call also samples the
               first token, whose read-back is prefill's one host sync
    DECODE     slot participates in the fused batched decode tick
               (idle and done slots step on pad tokens too; their
               recurrent state is garbage until the next admit resets it)
    RETIRED    EOS emitted (device-detected) or token budget reached
               (host-detected): pages freed, table row -> trash, the
               next queued request admits into the slot

Counters mirror the reference's ``stats()``: a "dispatch" is one
prefill chunk call or one fused decode tick, a "host sync" one blocking
device-to-host read.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.attention import PagedView
from repro_torch.models.model import apply_model, compute_dtype
from repro_torch.serve.kvcache import PagedKVCache
from repro_torch.serve.sampling import SamplingConfig, masked_sample, sample

__all__ = ["ServeRequest", "ContinuousScheduler"]


@dataclasses.dataclass
class ServeRequest:
    uid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    priority: int = 0                  # higher admits first
    tenant: Optional[str] = None       # per-tenant quota key
    out: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: Optional[float] = None    # time-to-first-token timestamp
    t_done: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_submit


class ContinuousScheduler:
    """Continuous batching over ``slots`` fixed batch lanes.

    cfg/model    -- model config + ``repro_torch.models.Model`` (its
                   device is the scheduler's device).
    slots        -- decode batch width (lanes).
    max_len      -- per-slot logical context bound (page-aligned).
    page_size    -- tokens per KV page.
    num_pages    -- pool size; default slots*max_len/page_size + trash.
    eos_id       -- on-device EOS detection; None = budget-only.
    pad_id       -- what retired slots emit (default: eos_id or 0).
    prefill_chunk/decode_chunk -- prompt tokens per prefill call;
                   decoded tokens per fused tick.
    tenant_quota -- max concurrently-active slots per tenant: an int
                   (every tenant) or ``{tenant: n}``; entries >= 1.
    """

    def __init__(self, cfg, model, *, slots, max_len,
                 eos_id: Optional[int] = None, pad_id: Optional[int] = None,
                 sampling: SamplingConfig = SamplingConfig(), seed: int = 0,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: int = 32, decode_chunk: int = 8,
                 tenant_quota=None):
        if tenant_quota is not None:
            vals = (tenant_quota.values()
                    if isinstance(tenant_quota, dict) else [tenant_quota])
            if any(int(v) < 1 for v in vals):
                raise ValueError("tenant_quota entries must be >= 1 (a "
                                 "0 quota deadlocks admission)")
        self.cfg = cfg
        self.model = model
        self.device = model.embed.device
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id if pad_id is not None else (
            eos_id if eos_id is not None else 0)
        self.sampling = sampling
        self.prefill_chunk = prefill_chunk
        self.decode_chunk = decode_chunk
        # the fused tick may overrun a request's budget by up to one
        # chunk (host truncation happens after the sync); those writes
        # must still land in the slot's own pages
        self._chunk_slack = decode_chunk
        self.kv = PagedKVCache(
            cfg, slots=slots, max_len=max_len, page_size=page_size,
            num_pages=num_pages, dtype=compute_dtype(cfg), device=self.device)
        self.tenant_quota = tenant_quota
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        dev = self.device
        self._tok = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._done_host = np.ones((slots,), bool)      # idle == done
        self._done = torch.ones((slots,), dtype=torch.bool, device=dev)
        self._pending: List[tuple] = []    # heap: (-priority, uid, req)
        self._active: Dict[int, ServeRequest] = {}
        self._results: Dict[int, ServeRequest] = {}
        self._uid = 0
        # ---- telemetry ----
        self._ttft: List[float] = []   # window: reset at each run()
        self._ttft_n_cum = 0
        self._ttft_sum_cum = 0.0
        self.host_syncs = 0
        self.dispatches = 0
        self.prefill_dispatches = 0
        self.prefill_host_syncs = 0
        self.decode_dispatches = 0
        self.decode_host_syncs = 0
        self.tokens_out = 0
        self.prompt_tokens = 0

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               tenant: Optional[str] = None) -> int:
        """Queue one request; returns its uid.  No device work happens
        until ``run()``/``tick()``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt (need >= 1 token to prefill)")
        if len(prompt) + max_new_tokens + self._chunk_slack > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new_tokens}) + "
                f"decode slack ({self._chunk_slack}) exceeds "
                f"max_len={self.max_len}")
        uid = self._uid
        self._uid += 1
        req = ServeRequest(uid, prompt, max_new_tokens, priority=priority,
                           tenant=tenant, t_submit=time.time())
        heapq.heappush(self._pending, (-priority, uid, req))
        return uid

    @torch.inference_mode()
    def tick(self) -> bool:
        """One scheduling quantum: an admission pass, then -- if any slot
        is active -- ONE fused decode tick.  Returns whether work
        remains."""
        admitted = self._admit()
        if self._active:
            self._decode_tick()
        elif self._pending and not admitted:
            req = min(self._pending)[2]
            raise MemoryError(
                f"request {req.uid} ({len(req.prompt)} prompt tokens) "
                f"cannot be admitted into an empty batch -- pool too "
                f"small ({self.kv.free_pages} free pages)")
        return bool(self._active or self._pending)

    def take_results(self) -> Dict[int, ServeRequest]:
        """Hand off the requests completed so far."""
        done, self._results = self._results, {}
        return done

    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {uid: generated tokens} for the
        requests completed by this drain (the TTFT window resets here)."""
        self._ttft = []
        while self.tick():
            pass
        return {uid: np.asarray(r.out, np.int32)
                for uid, r in self.take_results().items()}

    def generate(self, prompts: Sequence, max_new_tokens: int):
        """Submit all, run, return outputs in submit order."""
        uids = [self.submit(p, max_new_tokens) for p in prompts]
        results = self.run()
        return [results[u] for u in uids]

    def stats(self) -> dict:
        return {
            "host_syncs": self.host_syncs,
            "dispatches": self.dispatches,
            "prefill_dispatches": self.prefill_dispatches,
            "prefill_host_syncs": self.prefill_host_syncs,
            "decode_dispatches": self.decode_dispatches,
            "decode_host_syncs": self.decode_host_syncs,
            "tokens_out": self.tokens_out,
            "syncs_per_token": (self.host_syncs / self.tokens_out
                                if self.tokens_out else 0.0),
            "ttft_s": list(self._ttft),
            "ttft_count_cum": self._ttft_n_cum,
            "ttft_sum_cum_s": self._ttft_sum_cum,
            "prompt_tokens": self.prompt_tokens,
            "pool_pages_in_use": self.kv.pages_in_use,
            "pool_bytes": self.kv.pool_bytes(),
            "state_bytes": self.kv.state_bytes(),
        }

    # ------------------------------------------------------------------
    # scheduling internals
    # ------------------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [s for s in range(self.slots) if s not in self._active]

    def _quota_of(self, tenant) -> Optional[int]:
        q = self.tenant_quota
        if q is None:
            return None
        if isinstance(q, dict):
            v = q.get(tenant)
            return None if v is None else int(v)
        return int(q)

    def _at_quota(self, tenant) -> bool:
        q = self._quota_of(tenant)
        if q is None:
            return False
        return sum(1 for r in self._active.values()
                   if r.tenant == tenant) >= q

    def _next_admissible(self) -> Optional[ServeRequest]:
        """Pop the highest-priority pending request whose tenant is under
        quota; quota-blocked requests are skipped, not head-of-line
        blockers."""
        blocked = []
        req = None
        while self._pending:
            item = heapq.heappop(self._pending)
            if self._at_quota(item[2].tenant):
                blocked.append(item)
                continue
            req = item[2]
            break
        for item in blocked:
            heapq.heappush(self._pending, item)
        return req

    def _admit(self) -> int:
        """Admit queued requests into free slots in priority order; the
        free-slot set is recomputed each iteration (a request retiring
        at its first token frees its slot mid-pass).  Returns #admitted."""
        n = 0
        while self._pending:
            free = self._free_slots()
            if not free:
                break
            req = self._next_admissible()
            if req is None:
                break
            if not self._try_admit(free[0], req):
                heapq.heappush(self._pending,
                               (-req.priority, req.uid, req))
                break
            n += 1
        return n

    def _try_admit(self, slot: int, req: ServeRequest) -> bool:
        """Alloc + prefill one request into `slot`; False when the pool
        lacks pages (the slot is left clean)."""
        n_tokens = len(req.prompt) + req.max_new_tokens + self._chunk_slack
        if self.kv.pages_needed(n_tokens) > self.kv.free_pages:
            return False
        self.kv.alloc(slot, n_tokens)
        self.kv.reset_slot_state(slot)
        self.prompt_tokens += len(req.prompt)
        self._prefill(slot, req)
        return True

    def _prefill(self, slot: int, req: ServeRequest):
        C = self.prefill_chunk
        S = len(req.prompt)
        dev = self.device
        view = PagedView(self.kv.table([slot]), self.kv.page_size)
        cache = self.kv.slot_cache(slot)
        prompt = torch.from_numpy(req.prompt).to(dev)[None]
        starts = list(range(0, S, C))
        for s in starts[:-1]:
            apply_model(self.cfg, self.model, prompt[:, s:s + C],
                        cache=cache,
                        cache_pos=torch.full((1,), s, dtype=torch.int32,
                                             device=dev),
                        paged=view, logits=False)
            self.dispatches += 1
            self.prefill_dispatches += 1
        # last chunk: the first-token sample rides on the same call
        s = starts[-1]
        out = apply_model(self.cfg, self.model, prompt[:, s:s + C],
                          cache=cache,
                          cache_pos=torch.full((1,), s, dtype=torch.int32,
                                               device=dev),
                          paged=view, last_only=True)
        first_dev = sample(out["logits"][:, -1], self._gen, self.sampling)
        self.dispatches += 1
        self.prefill_dispatches += 1
        first = int(first_dev[0])              # prefill's ONE host sync
        self.host_syncs += 1
        self.prefill_host_syncs += 1
        req.t_first = time.time()
        req.out.append(first)
        self.tokens_out += 1
        if (self.eos_id is not None and first == self.eos_id) \
                or req.max_new_tokens <= 1:
            self._retire(slot, req, active=False)
            return
        self._active[slot] = req
        self._tok[slot, 0] = first
        self._pos[slot] = S
        self._done[slot] = False
        self._done_host[slot] = False

    def _retire(self, slot: int, req: ServeRequest, *, active=True):
        req.t_done = time.time()
        if req.ttft is not None:
            self._ttft.append(req.ttft)
            self._ttft_n_cum += 1
            self._ttft_sum_cum += req.ttft
        self.kv.free(slot)
        if active:
            del self._active[slot]
        self._done_host[slot] = True
        self._done[slot] = True
        self._results[req.uid] = req

    def _decode_tick(self):
        """``decode_chunk`` sample -> decode steps queued on the device.
        Done (and idle) slots emit `pad_id`, freeze their position and
        -- their table rows being zero -- write into the trash page."""
        view = self.kv.view()
        tok, pos, done = self._tok, self._pos, self._done
        toks = torch.empty((self.slots, self.decode_chunk),
                           dtype=torch.int32, device=self.device)
        for i in range(self.decode_chunk):
            out = apply_model(self.cfg, self.model, tok,
                              cache=self.kv.cache, cache_pos=pos,
                              paged=view)
            nxt = masked_sample(out["logits"][:, -1], self._gen, done,
                                self.pad_id, self.sampling)
            pos = pos + (~done).to(torch.int32)
            if self.eos_id is not None:
                done = done | (nxt == self.eos_id)
            tok = nxt[:, None]
            toks[:, i] = nxt
        self._tok, self._pos = tok, pos
        self.dispatches += 1
        self.decode_dispatches += 1
        toks_np = toks.cpu().numpy()                   # ONE sync per tick
        self.host_syncs += 1
        self.decode_host_syncs += 1
        for slot, req in list(self._active.items()):
            for t in toks_np[slot]:
                req.out.append(int(t))
                self.tokens_out += 1
                if (self.eos_id is not None and t == self.eos_id) \
                        or len(req.out) >= req.max_new_tokens:
                    self._retire(slot, req)
                    break
        # the device `done` may run ahead of the host's retirements;
        # re-sync it from (a copy of) the host mirror
        self._done = torch.tensor(self._done_host, device=self.device)
