"""Admission control for the serving engine.

Counterpart of ``mxnet_tpu/serving/admission.py`` (its core): a bounded
queue of pending requests in front of the dispatcher.

- **backpressure**: at most ``max_queue`` requests wait; beyond that
  ``admit`` either raises :class:`QueueFullError` to the submitting
  client (policy ``reject``) or evicts the oldest pending request, whose
  future fails with :class:`ServerOverloadError` (policy
  ``shed-oldest``: old work is the least likely to still meet its
  deadline);
- **pressure**: :meth:`AdmissionController.apply_pressure` tightens the
  effective queue limit below ``max_queue``, shedding the highest-cost
  requests (``Request.cost``, padded elements) first; these sheds are
  counted apart from the policy's (``pressure_shed``, and
  ``mxnet_serve_regulator_shed_total``).  Nothing in the port sets
  pressure yet: the overload regulator that does is not ported, so that
  counter registers and stays 0.
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
With the engine's telemetry bundle (``telemetry=``) every decision also
moves its counter (admitted, rejected, shed, regulator shed, expired)
and the queue-depth gauge; without one, no instrument is touched.
"""
from __future__ import annotations

import collections
import threading
import time

from ..base import MXNetError

__all__ = ["AdmissionController", "Request", "QueueFullError",
           "DeadlineExceededError", "ServerOverloadError",
           "EngineClosedError"]


class QueueFullError(MXNetError):
    """The bounded queue is full and the overload policy is ``reject``
    (backpressure)."""


class DeadlineExceededError(MXNetError):
    """The request's deadline passed while it was still queued."""


class ServerOverloadError(MXNetError):
    """Set on the future of a request shed under the ``shed-oldest``
    overload policy, or by queue pressure."""


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
    host array; ``group`` is the engine's coalescing key (the padded
    per-example shapes).  ``out_rows`` holds the per-example output
    shapes the graph infers at the UNPADDED input, which the engine
    slices dispatched rows back to (None without seq buckets).

    ``cost`` is the request's padded-element price (the serving engine
    computes it from the bucket-padded group shapes; decode uses prompt
    plus generation budget): under pressure the highest-cost queued
    request sheds first.  None ranks as zero.

    ``on_expire(exc)``, when set, turns a deadline expiry from a failure
    into a completion: the sweep delivers its return value as the
    future's RESULT (a decode request's partial tokens with the
    ``expired`` flag); returning None falls back to the exception.

    ``trace`` optionally carries a :class:`~mxnet_tpu_torch.telemetry.
    LazyTrace` across the thread hop to the worker; ``tenant`` the
    resolved per-tenant accounting label (telemetry/goodput.py), None
    when unattributed."""
    __slots__ = ("inputs", "group", "future", "t_enqueue", "deadline",
                 "out_rows", "trace", "on_expire", "cost", "tenant")

    def __init__(self, inputs, group, future, deadline=None,
                 out_rows=None, trace=None, on_expire=None, cost=None,
                 tenant=None):
        self.inputs = inputs
        self.group = group
        self.future = future
        self.t_enqueue = time.monotonic()
        self.deadline = deadline            # absolute time.monotonic()
        self.out_rows = out_rows
        self.trace = trace
        self.on_expire = on_expire
        self.cost = cost                    # padded elements
        self.tenant = tenant                # resolved accounting label

    def expired(self, now):
        return self.deadline is not None and now >= self.deadline


class AdmissionController(object):
    def __init__(self, max_queue=256, overload_policy="reject",
                 sweep_interval=0.05, telemetry=None):
        if overload_policy not in ("reject", "shed-oldest", "shed_oldest"):
            raise MXNetError("unknown overload policy %r "
                             "(use 'reject' or 'shed-oldest')"
                             % (overload_policy,))
        self.max_queue = int(max_queue)
        self.overload_policy = overload_policy.replace("_", "-")
        self._sweep_interval = sweep_interval
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._woken = False
        self.admitted = 0
        self.rejected = 0
        self.shed = 0
        # pressure sheds are counted apart from policy sheds (the JAX
        # package's burn-rate rule reads the policy count; feeding it
        # pressure sheds would close a loop that only tightens)
        self.pressure_shed = 0
        self.expired = 0
        self._pressure = None       # tightened queue limit, or None
        # the engine's telemetry bundle, or None (zero instrument calls)
        self._telemetry = telemetry

    def admit(self, req):
        """Enqueue, or apply the overload policy when the queue is full:
        ``reject`` raises QueueFullError here, ``shed-oldest`` fails the
        oldest queued request with ServerOverloadError and admits this
        one.  Under pressure, below ``max_queue``, the highest-cost
        pending request (this one included) is shed instead."""
        reject = None
        tm = self._telemetry
        with self._cond:
            if self._closed:
                raise EngineClosedError("serving engine is closed")
            failures = self._sweep_locked()
            pressure = self._pressure
            if pressure is not None and len(self._queue) >= pressure \
                    and len(self._queue) < self.max_queue:
                victim = max(list(self._queue) + [req], key=self._cost_key)
                self.pressure_shed += 1
                if tm is not None:
                    tm.regulator_shed.inc()
                exc = ServerOverloadError(
                    "request shed under queue pressure: queue at the "
                    "tightened limit (%d < max_queue %d) and this is the "
                    "highest-cost pending request"
                    % (pressure, self.max_queue))
                if victim is req:
                    reject = exc
                else:
                    self._queue.remove(victim)
                    failures.append((victim, exc))
            elif len(self._queue) >= self.max_queue:
                if self.overload_policy == "shed-oldest":
                    victim = self._queue.popleft()
                    self.shed += 1
                    if tm is not None:
                        tm.shed.inc()
                    failures.append((victim, ServerOverloadError(
                        "request shed after %.1f ms queued: queue full "
                        "(%d) under shed-oldest overload policy"
                        % ((time.monotonic() - victim.t_enqueue) * 1e3,
                           self.max_queue))))
                else:
                    self.rejected += 1
                    if tm is not None:
                        tm.rejected.inc()
                    reject = QueueFullError(
                        "serving queue full (%d pending): backpressure"
                        % self.max_queue)
            if reject is None:
                self._queue.append(req)
                self.admitted += 1
                if tm is not None:
                    tm.admitted.inc()
                self._cond.notify()
            if tm is not None:
                tm.queue_depth.set(len(self._queue))
        self._deliver(failures)
        if reject is not None:
            raise reject

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

    def expire_request(self, req, detail=""):
        """Deliver deadline expiry to a request already POPPED from this
        queue, with the queued sweep's contract (``on_expire``) and
        accounting, so ``stats()["expired"]`` is one number however a
        deadline was hit."""
        exc = DeadlineExceededError(
            "deadline exceeded after %.1f ms%s"
            % ((time.monotonic() - req.t_enqueue) * 1e3,
               " (%s)" % detail if detail else ""))
        with self._cond:
            self.expired += 1
            if self._telemetry is not None:
                self._telemetry.expired.inc()
        self._deliver([(req, exc)])

    # ------------------------------------------------------------ pressure
    @staticmethod
    def _cost_key(r):
        """Cost-aware shed ranking: highest padded-element cost first,
        oldest first among equals."""
        return (r.cost if r.cost is not None else 0, -r.t_enqueue)

    @property
    def pressure(self):
        return self._pressure

    def apply_pressure(self, limit):
        """Set (or withdraw, ``None``) a tightened queue limit, shedding
        cost-aware down to it at once.  Futures fail outside the lock."""
        failures = []
        tm = self._telemetry
        with self._cond:
            self._pressure = None if limit is None else max(1, int(limit))
            shed_to = self._pressure
            while shed_to is not None and len(self._queue) > shed_to:
                victim = max(self._queue, key=self._cost_key)
                self._queue.remove(victim)
                self.pressure_shed += 1
                if tm is not None:
                    tm.regulator_shed.inc()
                failures.append((victim, ServerOverloadError(
                    "request shed under queue pressure after %.1f ms "
                    "queued: queue tightened to %d (max_queue %d)"
                    % ((time.monotonic() - victim.t_enqueue) * 1e3,
                       shed_to, self.max_queue))))
            if failures and tm is not None:
                tm.queue_depth.set(len(self._queue))
        self._deliver(failures)

    def _pop_group_locked(self, group, max_batch):
        taken, keep = [], collections.deque()
        for r in self._queue:
            if r.group == group and len(taken) < max_batch:
                taken.append(r)
            else:
                keep.append(r)
        self._queue = keep
        if self._telemetry is not None:
            self._telemetry.queue_depth.set(len(keep))
        return taken

    def _sweep_locked(self):
        """Drop expired requests; returns (request, exception) pairs to
        deliver after the lock is released."""
        now = time.monotonic()
        live, failures = collections.deque(), []
        for r in self._queue:
            if r.expired(now):
                self.expired += 1
                if self._telemetry is not None:
                    self._telemetry.expired.inc()
                failures.append((r, DeadlineExceededError(
                    "deadline exceeded after %.1f ms in queue"
                    % ((now - r.t_enqueue) * 1e3))))
            else:
                live.append(r)
        self._queue = live
        if failures and self._telemetry is not None:
            self._telemetry.queue_depth.set(len(live))
        return failures

    @staticmethod
    def _deliver(failures):
        """Fail futures outside the lock; a deadline expiry of a request
        with ``on_expire`` resolves it with the handler's result
        instead.  A traced request's trace is finished either way
        (aborted under the failure's name, or as "expired")."""
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
                if req.trace is not None:
                    req.trace.abort(type(exc).__name__)
                continue
            if not req.future.cancelled():
                try:
                    req.future.set_result(result)
                except Exception:   # lost a cancel() race
                    pass
            if req.trace is not None:
                req.trace.abort("expired")

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
                if self._telemetry is not None:
                    self._telemetry.queue_depth.set(0)
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
                    "pressure": self._pressure,
                    "overload_policy": self.overload_policy,
                    "admitted": self.admitted,
                    "rejected": self.rejected,
                    "shed": self.shed,
                    "pressure_shed": self.pressure_shed,
                    "expired": self.expired}
