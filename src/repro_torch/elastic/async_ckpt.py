"""Async checkpointer daemon: snapshot on the step path, publish off it
(port of ``repro.elastic.async_ckpt``).

A synchronous ``save_sharded_checkpoint`` holds the step loop for the
whole device->host copy *and* the file write + atomic publish.  Only the
first half has to block -- the masters and moments must be copied out
before the next optimizer step overwrites them in place -- so
:class:`AsyncCheckpointer` splits the save exactly along the
``snapshot_train_state`` / ``write_state_snapshot`` seam of the store:

  1. ``save(state)`` runs the blocking device->host copy (every leaf
     copied into fresh host memory under the reference's key; complete
     when ``save`` returns, on the CPU too, where a ``numpy()`` view
     would alias the master) and enqueues the frozen
     :class:`~repro_torch.checkpoint.store.StateSnapshot`;
  2. a single daemon thread drains the queue, writing + atomically
     publishing each snapshot (stale ``tmp-`` sweep and ``keep_last``
     retention ride the same publish), and drops its reference to a
     snapshot once written (a full-width snapshot is tens of GB of host
     memory);
  3. the queue is bounded (``max_in_flight``): when the writer falls
     behind, the *oldest* queued snapshot is dropped so the newest
     always publishes -- last-publish-wins.  A preempted run therefore
     resumes from the last *published* step, which may trail the last
     *requested* step; ``stats()["steps_behind"]`` is that gap.  A
     sharded state's save is written by every rank (each its own
     worker file), and ranks that dropped different snapshots would
     leave steps no rank can publish, so there ``save`` waits for room
     in the queue instead of dropping (the wait counts as blocking).

``wait()`` is the clean-shutdown barrier (drain the queue, re-raise any
writer error); ``close()`` stops the daemon.  Telemetry: per-save
blocking seconds (the device->host copy -- the only step-path cost),
per-write publish seconds, bytes, drop/publish counts.  On a mesh,
only the writing rank (rank 0) holds a checkpointer for a replicated
state, every rank for a sharded one (``api.Trainer``).
"""
from __future__ import annotations

import collections
import pathlib
import threading
import time
from typing import Callable, Optional

from repro_torch.checkpoint.store import (
    StateSnapshot, snapshot_train_state, write_state_snapshot,
)


class AsyncCheckpointer:
    """See module docstring.  ``writer`` is the publish function the
    daemon calls (``write_state_snapshot(ckpt_dir, snap, keep_last=)``
    signature) -- tests substitute a delayed writer to pin down the
    queue semantics."""

    def __init__(self, ckpt_dir, *, keep_last: Optional[int] = None,
                 max_in_flight: int = 1,
                 writer: Optional[Callable] = None):
        if max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {max_in_flight}")
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep_last = keep_last
        self.max_in_flight = int(max_in_flight)
        self._writer = writer if writer is not None else write_state_snapshot
        self._cond = threading.Condition()
        self._pending: "collections.deque[StateSnapshot]" = \
            collections.deque()
        self._writing = False
        self._closed = False
        self._error: Optional[BaseException] = None
        # telemetry (all guarded by _cond)
        self._saves = 0
        self._published = 0
        self._dropped = 0
        self._bytes_published = 0
        self._last_requested_step: Optional[int] = None
        self._last_published_step: Optional[int] = None
        self._last_blocking_s: Optional[float] = None
        self._last_write_s: Optional[float] = None
        self._total_blocking_s = 0.0
        self._total_write_s = 0.0
        self._thread = threading.Thread(
            target=self._run, name="async-ckpt", daemon=True)
        self._thread.start()

    # ---- step-path API ---------------------------------------------------
    def save(self, state, step: Optional[int] = None, *,
             extra: Optional[dict] = None) -> dict:
        """Snapshot ``state`` (blocking: the device->host copy only) and
        enqueue it for background publish.  Returns a small record of
        the blocking cost (``{"step", "blocking_s", "bytes"}``).  If
        the bounded queue is full, the oldest *queued* snapshot is
        dropped -- the one being written always completes (its publish
        is already the newest durable state)."""
        self._check_error()
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        at = int(state.step) if step is None else int(step)
        t0 = time.monotonic()
        snap = snapshot_train_state(state, at, extra=extra)
        with self._cond:
            while len(self._pending) >= self.max_in_flight:
                if snap.per_worker:        # sharded: wait, never drop
                    if self._error is not None:
                        break
                    self._cond.wait()
                    continue
                victim = self._pending.popleft()   # last-publish-wins
                self._dropped += 1
                del victim
            self._check_error()
            blocking_s = time.monotonic() - t0
            self._pending.append(snap)
            self._saves += 1
            self._last_requested_step = at
            self._last_blocking_s = blocking_s
            self._total_blocking_s += blocking_s
            self._cond.notify_all()
        return {"step": at, "blocking_s": blocking_s,
                "bytes": snap.nbytes}

    def wait(self, timeout: Optional[float] = None):
        """Barrier: block until every queued snapshot is published (or
        ``timeout`` seconds elapse -> TimeoutError).  Re-raises any
        background writer error.  Call before a planned shutdown so the
        final step is durable."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while (self._pending or self._writing) and self._error is None:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"async checkpoint publish still pending after "
                        f"{timeout}s (queued={len(self._pending)}, "
                        f"writing={self._writing})")
                self._cond.wait(remaining)
        self._check_error()

    def close(self, *, drain: bool = True):
        """Stop the daemon.  ``drain=True`` (default) publishes
        everything still queued first; ``drain=False`` abandons queued
        snapshots (the in-progress write still completes)."""
        if drain and self._error is None:
            try:
                self.wait()
            except RuntimeError:
                pass                       # surfaced via _check_error below
        with self._cond:
            if not drain:
                self._dropped += len(self._pending)
                self._pending.clear()
            self._closed = True
            self._cond.notify_all()
        self._thread.join()
        self._check_error()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)
        return False

    # ---- telemetry -------------------------------------------------------
    def stats(self) -> dict:
        """Save latency / bytes / steps-behind telemetry.
        ``steps_behind`` = last requested − last published step: how
        much training a crash right now would lose on top of the steps
        since the last ``save()``."""
        with self._cond:
            if self._last_requested_step is None:
                behind = None                 # nothing requested yet
            elif self._last_published_step is None:
                behind = self._last_requested_step   # nothing durable yet
            else:
                behind = (self._last_requested_step
                          - self._last_published_step)
            return {
                "saves": self._saves,
                "published": self._published,
                "dropped": self._dropped,
                "queued": len(self._pending) + int(self._writing),
                "bytes_published": self._bytes_published,
                "last_requested_step": self._last_requested_step,
                "last_published_step": self._last_published_step,
                "steps_behind": behind,
                "last_blocking_s": self._last_blocking_s,
                "last_write_s": self._last_write_s,
                "total_blocking_s": self._total_blocking_s,
                "total_write_s": self._total_write_s,
            }

    # ---- daemon ----------------------------------------------------------
    def _run(self):
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending:
                    return                  # closed + drained
                snap = self._pending.popleft()
                self._writing = True
                self._cond.notify_all()     # a waiting save has room now
            try:
                t0 = time.monotonic()
                self._writer(self.ckpt_dir, snap,
                             keep_last=self.keep_last)
                write_s = time.monotonic() - t0
                step, nbytes = snap.step, snap.nbytes
                del snap                    # free the host copy now
                with self._cond:
                    self._writing = False
                    self._published += 1
                    self._bytes_published += nbytes
                    self._last_published_step = step
                    self._last_write_s = write_s
                    self._total_write_s += write_s
                    self._cond.notify_all()
            except BaseException as e:       # surface on the step path
                snap = None
                with self._cond:
                    self._writing = False
                    self._error = e
                    self._cond.notify_all()
                return

    def _check_error(self):
        if self._error is not None:
            raise RuntimeError(
                "async checkpoint writer failed; the LAST PUBLISHED "
                "step is still consistent on disk") from self._error
