"""Continuous-batching scheduler over the paged KV cache.

Port of ``repro.serve.scheduler.ContinuousScheduler``, on one device
or on a ``(data, model)`` serve mesh (``mesh=``).  A request queue,
slot admission the moment a slot retires, chunked prefill, and a fused
decode tick: ``decode_chunk`` sample -> decode steps queued on the
device with EOS masking on the device, then ONE host sync (``.cpu()``)
for the whole tick.  Nothing inside the tick's
loop reads a device value on the host.

Request lifecycle::

    QUEUED     submit() enqueued it (priority-ordered; FIFO within a
               priority); waiting for a slot + pages + tenant quota
    PREFILL    admitted: cached prefix pages ALIASED into the page
               table (``prefix_cache=True``: refcount +1 each, zero
               bytes moved), the remaining pages allocated, the slot's
               recurrent state zeroed, the UNMATCHED prompt suffix fed
               in `prefill_chunk`-token chunks (exact, never padded: a
               padded lane would corrupt the recurrent state, which
               integrates every token it sees; B=1 calls that write
               into the shared pool and the slot's state rows); the
               LAST chunk's call also samples the first token, whose
               read-back is prefill's one host sync
    DECODE     slot participates in the fused batched decode tick
               (idle and done slots step on pad tokens too; their
               recurrent state is garbage until the next admit resets it)
    RETIRED    EOS emitted (device-detected) or token budget reached
               (host-detected): the slot's page references dropped
               (shared pages survive under the radix tree's reference),
               table row -> trash, the next queued request admits into
               the slot

The ``tick()`` quantum (one admission pass + one fused decode tick) is
the streaming front door's pump (``serve.frontdoor.FrontDoor``).

Speculative decode (``spec_decode=k``, greedy only, needs
``cfg.mtp_depth > 0``): each of the tick's ``decode_chunk`` steps
becomes draft -> verify -> accept.  The MTP head drafts ``k - 1``
tokens from the last accepted hidden state (``models.mtp_draft``: no
pool, no attention kernel), ONE verify forward scores the k-token chunk
through the paged pool at per-slot positions ``pos .. pos + k - 1``,
the longest matching prefix of the greedy targets is accepted on the
device (``sampling.accept_speculative``), and rejected positions roll
back by rewinding the slot's position: their K/V stay in the slot's
allocated slack, masked by ``kv_position <= q_position``, and the next
chunk overwrites them before any query can see them.  Still one host
sync a tick, but each step emits 1..k tokens, every one of them the
verify argmax.

Counters mirror the reference's ``stats()``: a "dispatch" is one
prefill chunk call or one fused decode tick, a "host sync" one blocking
device-to-host read.

On a serve mesh every rank runs this same scheduler: the same host
bookkeeping (admission, page tables, prefix tree, EOS) on the same
requests.  The weights come placed by the serve-mode rules (drawn with
``bridge.mesh_placer(cfg, mesh, mode="serve")`` or loaded with
``params_from_jax(..., mesh=)``; ``bridge.check_serve_placed`` refuses
a whole model), the pool by ``rules.pool_spec`` (``PagedKVCache(mesh=)``),
and each tick runs under the scoped serve topology
(``sharding.ctx.serve_topology``).  Every slot is computed on every
rank: the per-slot recurrent leaves are whole on every rank, so the pod
x data replicas compute the same slots, and a decode step or prefill
chunk is a batch replicated over them (``ctx.batch_split(False)``);
``"model"`` splits the heads, the ffn, the experts (with ``"data"``)
and the vocabulary.  The logits come back whole, so each rank samples
the same tokens and reads them in its tick's one host sync.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.attention import PagedView
from repro_torch.models.model import (apply_model, check_paged_ported,
                                      compute_dtype, mtp_draft)
from repro_torch.serve.kvcache import PagedKVCache
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.sampling import (SamplingConfig, accept_speculative,
                                        masked_sample, sample)
from repro_torch.sharding import ctx as shctx

__all__ = ["ServeRequest", "ContinuousScheduler"]


@dataclasses.dataclass
class ServeRequest:
    uid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    priority: int = 0                  # higher admits first
    tenant: Optional[str] = None       # per-tenant quota key
    prefix_tokens: int = 0             # prompt tokens served from cache
    spec_steps: int = 0                # verify steps this request rode
    spec_accepted: int = 0             # draft tokens accepted for it
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
    prefix_cache -- radix-tree prefix reuse (``serve.prefix``): matched
                   prompt pages are aliased instead of re-prefilled.
                   Attention/MLA stacks only (a recurrent mixer's state
                   is not captured by KV pages).
    spec_decode  -- 0 = off; k >= 2 = speculative decode with k-token
                   verify chunks (the carried token + k - 1 MTP drafts a
                   step).  Greedy only, needs ``cfg.mtp_depth > 0`` and
                   an attention/MLA stack.
    mesh         -- a ``(data, model)`` (or ``(pod, data, model)``)
                   ``DeviceMesh`` to serve on (module docstring); None:
                   one device.
    """

    def __init__(self, cfg, model, *, slots, max_len,
                 eos_id: Optional[int] = None, pad_id: Optional[int] = None,
                 sampling: SamplingConfig = SamplingConfig(), seed: int = 0,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: int = 32, decode_chunk: int = 8,
                 tenant_quota=None, prefix_cache: bool = False,
                 spec_decode: int = 0, mesh=None):
        check_paged_ported(cfg)
        recurrent = any(mix != "attn" for mix, _ in cfg.layer_pattern())
        if prefix_cache and recurrent:
            raise ValueError(
                "prefix_cache=True needs an attention/MLA-only stack: a "
                "recurrent (SSM) mixer's state at the suffix boundary is "
                "not captured by KV pages, so aliased prefixes would "
                "serve with a zeroed recurrent state")
        spec_decode = int(spec_decode or 0)
        if spec_decode:
            if spec_decode < 2:
                raise ValueError(
                    "spec_decode counts the whole verify chunk (the "
                    "carried token + the drafts); k=1 is plain decode -- "
                    "pass spec_decode >= 2 or 0")
            if cfg.mtp_depth <= 0:
                raise ValueError(
                    "spec_decode needs an architecture with MTP heads "
                    "(cfg.mtp_depth > 0) to draft from; this config has "
                    "none")
            if sampling.temperature > 0:
                raise ValueError(
                    "speculative decode is greedy-only: lossless "
                    "acceptance emits the verify argmax, which only "
                    "equals the engine's output at temperature=0")
            if recurrent:
                raise ValueError(
                    "spec_decode needs an attention/MLA-only stack: a "
                    "rejected draft cannot be rolled back out of a "
                    "recurrent (SSM) state")
        if tenant_quota is not None:
            vals = (tenant_quota.values()
                    if isinstance(tenant_quota, dict) else [tenant_quota])
            if any(int(v) < 1 for v in vals):
                raise ValueError("tenant_quota entries must be >= 1 (a "
                                 "0 quota deadlocks admission)")
        self.cfg = cfg
        self.mesh = mesh
        self._topo = None
        if mesh is not None:
            from repro_torch.bridge import check_serve_placed
            check_serve_placed(model, mesh)
            self._topo = shctx.ServeTopology.from_mesh(mesh)
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
        self.spec_decode = spec_decode
        # the fused tick may overrun a request's budget by up to one
        # chunk (host truncation happens after the sync), and a rejected
        # draft writes up to spec_decode - 1 positions past the last
        # accepted one: all of it must land in the slot's own pages
        self._chunk_slack = (decode_chunk * spec_decode + spec_decode
                             if spec_decode else decode_chunk)
        self.kv = PagedKVCache(
            cfg, slots=slots, max_len=max_len, page_size=page_size,
            num_pages=num_pages, dtype=compute_dtype(cfg), device=self.device,
            mesh=mesh)
        self.prefix = PrefixCache(self.kv) if prefix_cache else None
        self.tenant_quota = tenant_quota
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        dev = self.device
        self._tok = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
        # trunk hidden at each slot's last accepted position: the MTP
        # draft head's input (speculative decode only)
        self._hid = torch.zeros((slots, cfg.d_model),
                                dtype=compute_dtype(cfg), device=dev)
        self._done_host = np.ones((slots,), bool)      # idle == done
        self._done = torch.ones((slots,), dtype=torch.bool, device=dev)
        self._pending: List[tuple] = []    # heap: (-priority, uid, req)
        self._active: Dict[int, ServeRequest] = {}
        self._results: Dict[int, ServeRequest] = {}
        self._byuid: Dict[int, ServeRequest] = {}      # submit -> handoff
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
        self.prefix_tokens_saved = 0   # prompt tokens served by aliasing
        self.prompt_tokens = 0
        # speculative decode: acceptance is accepted / offered drafts
        # over live verify steps, also per slot
        self.spec_verify_steps = 0
        self.spec_draft_tokens = 0     # offered: (k - 1) a live step
        self.spec_accepted_tokens = 0
        self._spec_slot_steps = np.zeros((slots,), np.int64)
        self._spec_slot_accepted = np.zeros((slots,), np.int64)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               tenant: Optional[str] = None) -> int:
        """Queue one request; returns its uid.  No device work happens
        until ``run()``/``tick()``."""
        prompt = np.array(prompt, np.int32).reshape(-1)      # own copy
        if len(prompt) == 0:
            raise ValueError("empty prompt (need >= 1 token to prefill)")
        if len(prompt) + max_new_tokens + self._chunk_slack > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new_tokens}) + "
                f"decode slack ({self._chunk_slack}"
                f"{', spec_decode' if self.spec_decode else ''}) exceeds "
                f"max_len={self.max_len}")
        uid = self._uid
        self._uid += 1
        req = ServeRequest(uid, prompt, max_new_tokens, priority=priority,
                           tenant=tenant, t_submit=time.time())
        heapq.heappush(self._pending, (-priority, uid, req))
        self._byuid[uid] = req
        return uid

    def request(self, uid: int) -> ServeRequest:
        """Live view of a submitted request (the streaming front door
        reads ``req.out`` as ticks sync); valid until the request's
        result is handed off."""
        return self._byuid[uid]

    @torch.inference_mode()
    def tick(self) -> bool:
        """One scheduling quantum: an admission pass, then -- if any slot
        is active -- ONE fused decode tick.  Returns whether work
        remains.  On a mesh, under the serve topology, every call's batch
        replicated over the replicas."""
        with shctx.serving(self._topo):
            return self._tick()

    def _tick(self) -> bool:
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
        """Hand off the requests completed so far (and drop them from
        the uid index)."""
        done, self._results = self._results, {}
        for uid in done:
            self._byuid.pop(uid, None)
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
        st = {
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
            "prefix_hit_tokens": self.prefix_tokens_saved,
            "prefix_hit_rate": (self.prefix_tokens_saved / self.prompt_tokens
                                if self.prompt_tokens else 0.0),
            "pool_pages_in_use": self.kv.pages_in_use,
            "pool_bytes": self.kv.pool_bytes(),
            "slab_bytes_equiv": self.kv.slab_bytes(),
            "state_bytes": self.kv.state_bytes(),
        }
        if self.prefix is not None:
            st["prefix_cache"] = self.prefix.stats()
        if self.spec_decode:
            steps = self.spec_verify_steps
            st["spec_decode"] = {
                "k": self.spec_decode,
                "verify_steps": steps,
                "draft_tokens": self.spec_draft_tokens,
                "accepted_tokens": self.spec_accepted_tokens,
                # accepted / offered drafts (budget- and EOS-truncated
                # steps count what the host consumed)
                "acceptance": (self.spec_accepted_tokens
                               / self.spec_draft_tokens
                               if self.spec_draft_tokens else 0.0),
                # emitted tokens per verify step = 1 + accepted
                "tokens_per_step": ((self.spec_accepted_tokens + steps)
                                    / steps if steps else 0.0),
                "slot_verify_steps": self._spec_slot_steps.tolist(),
                "slot_accepted_tokens": self._spec_slot_accepted.tolist(),
                "slot_accepted_len": [
                    1.0 + (a / n) if n else 0.0
                    for a, n in zip(self._spec_slot_accepted,
                                    self._spec_slot_steps)],
            }
        return st

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
        """Alias + copy-on-write fork + alloc + prefill one request into
        `slot`.  False (slot left clean) when the pool lacks pages even
        after prefix eviction."""
        S = len(req.prompt)
        matched, pages = (self.prefix.match(req.prompt)
                          if self.prefix is not None else (0, []))
        # always prefill >= 1 token: the last chunk's logits give the
        # first token
        start = min(matched, S - 1)
        # a fully matched page-aligned prompt re-writes its final token
        # into a page it shares: fork that page first
        fork = bool(pages) and matched >= S
        n_tokens = S + req.max_new_tokens + self._chunk_slack
        fresh = self.kv.pages_needed(n_tokens) - len(pages) + int(fork)
        # alias FIRST: the matched pages are then referenced by the
        # slot, so evicting their radix nodes cannot free them under us
        self.kv.alias(slot, pages)
        if fresh > self.kv.free_pages and self.prefix is not None:
            self.prefix.evict(fresh)
        if fresh > self.kv.free_pages:
            self.kv.free(slot)              # roll the aliases back
            return False
        if fork:
            self.kv.cow_fork(slot, len(pages) - 1)
        self.kv.alloc(slot, n_tokens)
        self.kv.reset_slot_state(slot)
        req.prefix_tokens = start
        self.prefix_tokens_saved += start
        self.prompt_tokens += S
        self._prefill(slot, req, start)
        return True

    def _prefill(self, slot: int, req: ServeRequest, start: int = 0):
        C = self.prefill_chunk
        S = len(req.prompt)
        dev = self.device
        view = PagedView(self.kv.table([slot]), self.kv.page_size)
        cache = self.kv.slot_cache(slot)
        prompt = torch.from_numpy(req.prompt).to(dev)[None]
        starts = list(range(start, S, C))      # non-empty: start <= S - 1
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
        if self.prefix is not None:
            # index the prompt's FULL pages (decode never writes them:
            # its first write position S lies in a later block)
            full = S // self.kv.page_size
            if full:
                self.prefix.insert(req.prompt, self.kv._owned[slot][:full])
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
        if self.spec_decode:
            # seed the draft head: the trunk hidden at the last prompt
            # position pairs with `first` as in the train-mode head
            self._hid[slot] = out["hidden"][0, -1]
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
        if self.spec_decode:
            self._spec_decode_tick()
            return
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

    def _spec_decode_tick(self):
        """The speculative twin of the fused tick, the same discipline
        (one dispatch, one host sync): each of the ``decode_chunk`` steps
        drafts, verifies and accepts on the device and emits 1..k
        tokens.  The emitted tokens (slots, decode_chunk, k), left-packed,
        and their counts ride in one int32 buffer, read back in ONE
        ``.cpu()``."""
        view = self.kv.view()
        k, K = self.spec_decode, self.decode_chunk
        tok, pos, hid, done = self._tok, self._pos, self._hid, self._done
        lanes = torch.arange(self.slots, device=self.device)
        buf = torch.empty((self.slots, K, k + 1), dtype=torch.int32,
                          device=self.device)
        pad = torch.full_like(tok[:, 0], self.pad_id)
        for i in range(K):
            drafts, _ = mtp_draft(self.cfg, self.model, hid[:, None, :], tok,
                                  k - 1)
            chunk = torch.cat([tok, drafts], dim=1)            # (B, k)
            out = apply_model(self.cfg, self.model, chunk,
                              cache=self.kv.cache, cache_pos=pos, paged=view)
            tgt = torch.argmax(out["logits"], dim=-1).to(torch.int32)
            emit, n_emit, n_acc, done_new = accept_speculative(
                tgt, chunk, done, self.pad_id, self.eos_id)
            pos = pos + torch.where(done, torch.zeros_like(n_acc), n_acc + 1)
            nxt = tgt[lanes, (n_emit - 1).clamp_min(0)]
            tok = torch.where(done_new, pad, nxt)[:, None]
            hid = torch.where(done_new[:, None], hid,
                              out["hidden"][lanes, n_acc])
            done = done_new
            buf[:, i, :k] = emit
            buf[:, i, k] = n_emit
        self._tok, self._pos, self._hid = tok, pos, hid
        self.dispatches += 1
        self.decode_dispatches += 1
        buf_np = buf.cpu().numpy()                     # ONE sync per tick
        self.host_syncs += 1
        self.decode_host_syncs += 1
        for slot, req in list(self._active.items()):
            finished = False
            for step in range(K):
                cnt = int(buf_np[slot, step, k])
                if cnt <= 0:            # the lane went done in a prior step
                    break
                req.spec_steps += 1
                req.spec_accepted += cnt - 1
                self.spec_verify_steps += 1
                self.spec_draft_tokens += k - 1
                self.spec_accepted_tokens += cnt - 1
                self._spec_slot_steps[slot] += 1
                self._spec_slot_accepted[slot] += cnt - 1
                for t in buf_np[slot, step, :cnt]:
                    req.out.append(int(t))
                    self.tokens_out += 1
                    if (self.eos_id is not None and t == self.eos_id) \
                            or len(req.out) >= req.max_new_tokens:
                        finished = True
                        break
                if finished:
                    break
            if finished:
                self._retire(slot, req)
        self._done = torch.tensor(self._done_host, device=self.device)
