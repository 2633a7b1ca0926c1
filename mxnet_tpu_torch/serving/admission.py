"""Admission control for the serving engine.

Counterpart of ``mxnet_tpu/serving/admission.py`` (its core): a bounded
queue of pending requests in front of the dispatcher.

- **backpressure**: at most ``max_queue`` requests wait; beyond that
  ``admit`` raises :class:`QueueFullError` to the submitting client.
- **deadlines**: a request may carry an absolute expiry; every queue
  interaction (and the blocking ``take`` wait) sweeps, so an expired
  request fails with :class:`DeadlineExceededError` instead of taking a
  batch slot — or, when it declared ``on_expire`` (a multi-step decode
  request), completes with what that handler returns: its partial
  output.
- **coalescing pop**: ``take`` blocks until work is there, honours a
  batching window measured from the oldest request's enqueue, and returns
  the oldest request plus every queued request of the same shape group,
  oldest first, up to ``max_batch``; ``poll`` is its non-blocking form,
  which the decode scheduler calls between steps.

One condition variable guards the state; client threads produce, the
engine worker is the single consumer.  Futures fail outside the lock.
"""
from __future__ import annotations

import collections
import threading
import time

from ..base import MXNetError

__all__ = ["AdmissionController", "Request", "QueueFullError",
           "DeadlineExceededError", "EngineClosedError"]


class QueueFullError(MXNetError):
    """The bounded queue is full (backpressure)."""


class DeadlineExceededError(MXNetError):
    """The request's deadline passed while it was still queued."""


class EngineClosedError(MXNetError):
    """Submitting to, or draining of, a closed engine."""


def _fail_future(fut, exc):
    """Deliver ``exc`` unless the client already cancelled the future."""
    if not fut.cancelled():
        try:
            fut.set_exception(exc)
        except Exception:       # lost a cancel() race: outcome delivered
            pass


class Request(object):
    """One pending request: ``inputs`` maps data name to a per-example
    host array; ``group`` is the engine's coalescing key.

    ``on_expire(exc)``, when set, turns a deadline expiry from a failure
    into a completion: the sweep delivers its return value as the
    future's RESULT (a decode request's partial tokens with the
    ``expired`` flag); returning None falls back to the exception."""
    __slots__ = ("inputs", "group", "future", "t_enqueue", "deadline",
                 "on_expire")

    def __init__(self, inputs, group, future, deadline=None,
                 on_expire=None):
        self.inputs = inputs
        self.group = group
        self.future = future
        self.t_enqueue = time.monotonic()
        self.deadline = deadline            # absolute time.monotonic()
        self.on_expire = on_expire

    def expired(self, now):
        return self.deadline is not None and now >= self.deadline


class AdmissionController(object):
    def __init__(self, max_queue=256, sweep_interval=0.05):
        self.max_queue = int(max_queue)
        self._sweep_interval = sweep_interval
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._woken = False
        self.admitted = 0
        self.rejected = 0
        self.expired = 0

    def admit(self, req):
        """Enqueue, or raise QueueFullError when the queue is full."""
        with self._cond:
            if self._closed:
                raise EngineClosedError("serving engine is closed")
            failures = self._sweep_locked()
            full = len(self._queue) >= self.max_queue
            if full:
                self.rejected += 1
            else:
                self._queue.append(req)
                self.admitted += 1
                self._cond.notify()
        self._deliver(failures)
        if full:
            raise QueueFullError("serving queue full (%d pending): "
                                 "backpressure" % self.max_queue)

    def take(self, max_batch, window_s):
        """Block until a batch is ready and return the oldest request's
        group (at most ``max_batch``, oldest first); ``None`` once closed
        and drained; an empty list after :meth:`wake`."""
        while True:
            batch, decided = None, False
            with self._cond:
                failures = self._sweep_locked()
                if self._woken:
                    self._woken = False
                    decided, batch = True, []
                elif not self._queue:
                    if self._closed:
                        decided = True
                    else:
                        self._cond.wait(self._sweep_interval)
                else:
                    head = self._queue[0]
                    now = time.monotonic()
                    n_group = sum(1 for r in self._queue
                                  if r.group == head.group)
                    wait_until = head.t_enqueue + window_s
                    if n_group >= max_batch or now >= wait_until \
                            or self._closed:
                        decided = True
                        batch = self._pop_group_locked(head.group, max_batch)
                    else:
                        self._cond.wait(min(wait_until - now,
                                            self._sweep_interval))
            self._deliver(failures)
            if decided:
                return batch

    def wake(self):
        """Make the consumer's pending (or next) :meth:`take` return an
        empty list at once: how the decode engine hands its scheduler
        thread work that is not a request (warmup)."""
        with self._cond:
            self._woken = True
            self._cond.notify_all()

    def poll(self, max_batch):
        """Non-blocking :meth:`take`: sweep deadlines, then pop the head
        request's group at once — possibly an empty list.  A running
        decode batch admits between steps with this and never blocks on
        the queue."""
        if not self._queue:
            return []
        with self._cond:
            failures = self._sweep_locked()
            batch = []
            if self._queue:
                batch = self._pop_group_locked(self._queue[0].group,
                                               max_batch)
        self._deliver(failures)
        return batch

    def sweep(self):
        """Expire overdue queued requests now (every admit, take and poll
        also does)."""
        with self._cond:
            failures = self._sweep_locked()
        self._deliver(failures)

    def _pop_group_locked(self, group, max_batch):
        taken, keep = [], collections.deque()
        for r in self._queue:
            if r.group == group and len(taken) < max_batch:
                taken.append(r)
            else:
                keep.append(r)
        self._queue = keep
        return taken

    def _sweep_locked(self):
        """Drop expired requests; returns (request, exception) pairs to
        deliver after the lock is released."""
        now = time.monotonic()
        live, failures = collections.deque(), []
        for r in self._queue:
            if r.expired(now):
                self.expired += 1
                failures.append((r, DeadlineExceededError(
                    "deadline exceeded after %.1f ms in queue"
                    % ((now - r.t_enqueue) * 1e3))))
            else:
                live.append(r)
        self._queue = live
        return failures

    @staticmethod
    def _deliver(failures):
        """Fail futures outside the lock; a deadline expiry of a request
        with ``on_expire`` resolves it with the handler's result
        instead."""
        for req, exc in failures:
            result = None
            if req.on_expire is not None and \
                    isinstance(exc, DeadlineExceededError):
                try:
                    result = req.on_expire(exc)
                except Exception:   # handler bug: fall back to the error
                    result = None
            if result is None:
                _fail_future(req.future, exc)
            elif not req.future.cancelled():
                try:
                    req.future.set_result(result)
                except Exception:   # lost a cancel() race
                    pass

    def close(self, drain=True):
        """Stop admitting; with ``drain`` the worker keeps taking until the
        queue is empty, otherwise pending futures fail now."""
        failures = []
        with self._cond:
            self._closed = True
            if not drain:
                while self._queue:
                    failures.append((self._queue.popleft(),
                                     EngineClosedError(
                                         "engine closed before dispatch")))
            self._cond.notify_all()
        self._deliver(failures)

    @property
    def closed(self):
        return self._closed

    def __len__(self):
        with self._cond:
            return len(self._queue)

    def stats(self):
        with self._cond:
            return {"queue_depth": len(self._queue),
                    "max_queue": self.max_queue,
                    "admitted": self.admitted,
                    "rejected": self.rejected,
                    "expired": self.expired}
