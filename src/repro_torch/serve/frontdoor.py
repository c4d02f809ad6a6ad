"""Async front door: non-blocking submit, streaming token handles.

Port of ``repro.serve.frontdoor`` over the port's
``ContinuousScheduler``.

``ContinuousScheduler.generate`` is a batch interface — submit
everything, drain, get arrays back.  Production traffic wants the
opposite shape: requests arrive one at a time, the caller must not
block behind other tenants, and tokens should surface as they decode.
``FrontDoor`` is that surface over the scheduler's ``tick()`` quantum:

    fd = FrontDoor(scheduler)
    h = fd.submit(prompt, max_new_tokens=128, tenant="acme", priority=1)
    for tok in h:              # yields as each decode chunk syncs
        emit(tok)

``submit`` costs no device work (the prompt is queued; prefill happens
on the first pump).  A ``StreamHandle`` is an iterator over the
request's tokens: iterating PUMPS the scheduler (one ``tick`` — an
admission pass plus one fused decode tick) until new tokens sync, so
tokens arrive in ``decode_chunk``-sized bursts after a first-token
burst at prefill — the one-host-sync-per-chunk dispatch discipline is
unchanged, streaming just reads each sync's tokens as they land.
Pumping is cooperative and single-threaded: whichever handle (or
``pump()``/``drain()`` call) runs the tick advances EVERY in-flight
request, so interleaved consumers see each other's tokens appear
between their own.

Priorities and per-tenant quotas are the scheduler's
(``priority``/``tenant`` forward to ``ContinuousScheduler.submit``;
quotas come from its ``tenant_quota`` or the ``quotas=`` override
here).  Completed requests are harvested off the scheduler
(``take_results``) into the handles, so a long-lived front door never
lets the scheduler accumulate result arrays.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

__all__ = ["FrontDoor", "StreamHandle"]


class StreamHandle:
    """Iterator over one request's generated tokens.

    ``__next__`` pumps the scheduler until a new token is available (or
    the request finished); ``available()`` is the non-blocking read;
    ``result()`` drains to completion and returns the full output.
    """

    def __init__(self, fd: "FrontDoor", req):
        self._fd = fd
        self._req = req
        self._cursor = 0

    @property
    def uid(self) -> int:
        return self._req.uid

    @property
    def done(self) -> bool:
        return self._req.t_done is not None

    @property
    def ttft(self) -> Optional[float]:
        return self._req.ttft

    def available(self) -> List[int]:
        """Tokens that have synced since the last read — no pumping."""
        new = self._req.out[self._cursor:]
        self._cursor += len(new)
        return list(new)

    def __iter__(self) -> Iterator[int]:
        return self

    def __next__(self) -> int:
        while self._cursor >= len(self._req.out):
            if self.done:
                raise StopIteration
            self._fd.pump()
        tok = self._req.out[self._cursor]
        self._cursor += 1
        return int(tok)

    def result(self) -> np.ndarray:
        """Drain until this request completes; full output (the tokens
        already streamed included)."""
        while not self.done:
            self._fd.pump()
        return np.asarray(self._req.out, np.int32)


class FrontDoor:
    """Multi-tenant submission surface over a ``ContinuousScheduler``.

    quotas — optional per-tenant admission quota override (an int for
    every tenant, or ``{tenant: n}``), installed onto the scheduler.
    """

    def __init__(self, scheduler, *, quotas=None):
        self.sched = scheduler
        if quotas is not None:
            if isinstance(quotas, dict):
                if any(int(v) < 1 for v in quotas.values()):
                    raise ValueError("tenant quotas must be >= 1")
            elif int(quotas) < 1:
                raise ValueError("tenant quotas must be >= 1")
            scheduler.tenant_quota = quotas
        self._handles: Dict[int, StreamHandle] = {}

    # ---- submission ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, tenant=None,
               priority: int = 0) -> StreamHandle:
        """Queue a request and return its streaming handle — no device
        work until the first pump."""
        uid = self.sched.submit(prompt, max_new_tokens, priority=priority,
                                tenant=tenant)
        h = StreamHandle(self, self.sched.request(uid))
        self._handles[uid] = h
        return h

    # ---- pumping ---------------------------------------------------------
    def pump(self) -> bool:
        """One scheduler tick (admission pass + one fused decode tick);
        harvests any requests that completed.  Returns whether work
        remains."""
        more = self.sched.tick()
        for uid in self.sched.take_results():
            self._handles.pop(uid, None)   # handle keeps its req alive
        return more

    def drain(self) -> None:
        """Pump until every submitted request has completed."""
        while self.pump():
            pass

    @property
    def in_flight(self) -> int:
        return len(self._handles)

    def stats(self) -> dict:
        return self.sched.stats()
