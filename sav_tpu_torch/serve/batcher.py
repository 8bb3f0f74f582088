"""Deadline-aware dynamic batcher: bounded queue -> bucketed batches.

The port's own copy of ``sav_tpu/serve/batcher.py`` (stdlib only). Requests enter a bounded FIFO: a full queue
rejects (:class:`QueueFullError`), and a request whose projected queue wait
already exceeds its deadline is shed at submit
(:class:`DeadlineInfeasibleError`). The drain groups requests into the
largest ladder bucket that fills before the earliest admitted deadline's
slack expires: a batch is dispatched no later than
``earliest_deadline - est_step(bucket)``, so an admitted request overruns by
at most one bucket's actual step time.

Each request may carry its span record
(:class:`~sav_tpu_torch.serve.telemetry.RequestTrace`): admission stamps
``admit`` and the drain stamps ``batch_formed``, host-clock appends only,
so neither path can wait on the device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Optional

from sav_tpu_torch.serve.bucketing import BucketLadder
from sav_tpu_torch.serve.telemetry import stamp


class QueueFullError(RuntimeError):
    """Admission rejected: the bounded request queue is at capacity."""


class DeadlineInfeasibleError(QueueFullError):
    """Admission rejected: the projected dispatch wait already exceeds the
    request's deadline (serving it would burn a step on a guaranteed miss)."""


class ServeClosedError(RuntimeError):
    """The engine was stopped with this request still pending."""


class ServeFuture:
    """Set-once result slot the submitter blocks on."""

    def __init__(self):
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def set_result(self, value: Any) -> None:
        self._value = value
        self._done.set()

    def set_exception(self, error: BaseException) -> None:
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError("serve request still pending")
        if self._error is not None:
            raise self._error
        return self._value


@dataclasses.dataclass
class ServeRequest:
    payload: Any  # preprocessed host input (uint8 [H, W, 3] row)
    deadline_s: float  # latency budget from submit time
    enqueue_t: float
    future: ServeFuture
    # The request's span record (telemetry's RequestTrace), None when
    # telemetry is off.
    trace: Any = None

    @property
    def deadline_t(self) -> float:
        return self.enqueue_t + self.deadline_s


@dataclasses.dataclass
class FormedBatch:
    """One drained batch: the real requests (<= bucket), the bucket they pad
    to, and drain-time facts for the latency ledger."""

    requests: list
    bucket: int
    queue_depth: int
    formed_t: float


class DynamicBatcher:
    """Bounded request queue + deadline-aware bucket drain.

    Args:
      ladder: the engine's bucket ladder.
      step_time_fn: bucket -> estimated device seconds for one batch.
      max_queue: admission bound.
      default_deadline_s: budget for requests submitted without one.
      clock: injectable monotonic clock (deterministic tests).
    """

    _POLL_S = 0.05  # close()-responsiveness bound for blocking waits

    def __init__(
        self,
        ladder: BucketLadder,
        *,
        step_time_fn: Callable[[int], float],
        max_queue: int = 256,
        default_deadline_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if default_deadline_s <= 0:
            raise ValueError(
                f"default_deadline_s must be > 0, got {default_deadline_s}"
            )
        self.ladder = ladder
        self._step_time_fn = step_time_fn
        self._default_deadline_s = default_deadline_s
        self._clock = clock
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._closed = threading.Event()
        self._lock = threading.Lock()
        self._submitted = 0
        self._rejected = 0
        self._shed_infeasible = 0
        # Batches drained but not yet completed: wait ahead of new arrivals.
        self._inflight = 0

    def submit(
        self, payload: Any, *, deadline_s: Optional[float] = None, trace: Any = None
    ) -> ServeFuture:
        """Admit one request; returns the future its result arrives on.
        Admission stamps ``admit`` on ``trace`` (its span record, if any)."""
        if self._closed.is_set():
            raise ServeClosedError("batcher is closed")
        future = ServeFuture()
        request = ServeRequest(
            payload=payload,
            deadline_s=(
                deadline_s if deadline_s is not None else self._default_deadline_s
            ),
            enqueue_t=self._clock(),
            future=future,
            trace=trace,
        )
        if request.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {request.deadline_s}")
        # Projected dispatch wait: in-flight batches plus the full batches
        # queued ahead, one top-bucket step each.
        max_batch = self.ladder.max_batch
        est = max(float(self._step_time_fn(max_batch)), 0.0)
        if est > 0.0:
            with self._lock:
                inflight = self._inflight
            batches_ahead = inflight + (self._queue.qsize() + max_batch) // max_batch
            if batches_ahead * est > request.deadline_s:
                with self._lock:
                    self._rejected += 1
                    self._shed_infeasible += 1
                raise DeadlineInfeasibleError(
                    f"projected dispatch wait {batches_ahead * est:.3f}s "
                    f"({batches_ahead} batches ahead at ~{est:.3f}s) "
                    f"exceeds the {request.deadline_s:.3f}s deadline; "
                    "shedding instead of serving a guaranteed miss"
                )
        # Stamp admit BEFORE the put: once queued, the drain thread may pop
        # the request and stamp batch_formed at once, and an admit stamped
        # after the put could postdate it (a negative "queue" interval). A
        # stamp on a request the put then rejects dies with its trace.
        stamp(trace, "admit", self._clock())
        try:
            self._queue.put_nowait(request)
        except queue.Full:
            with self._lock:
                self._rejected += 1
            raise QueueFullError(
                f"request queue at capacity ({self._queue.maxsize}); "
                "shed load or raise max_queue"
            ) from None
        if self._closed.is_set():
            # close() may have run its fail pass between the entry check and
            # the put; run it again so no future is stranded.
            self._fail_queued()
            raise ServeClosedError("batcher closed during submit")
        with self._lock:
            self._submitted += 1
        return future

    def _get(self, timeout: float):
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def next_batch(self) -> Optional[FormedBatch]:
        """Block until a batch is ready under the deadline policy; None once
        closed and drained. Called from exactly one drain thread."""
        first = None
        while first is None:
            if self._closed.is_set() and self._queue.empty():
                return None
            first = self._get(self._POLL_S)
        batch = [first]
        earliest_deadline = first.deadline_t
        max_batch = self.ladder.max_batch
        while True:
            while len(batch) < max_batch:
                try:
                    request = self._queue.get_nowait()
                except queue.Empty:
                    break
                batch.append(request)
                earliest_deadline = min(earliest_deadline, request.deadline_t)
            if len(batch) >= max_batch:
                break
            # Latest safe dispatch: earliest deadline minus the current
            # bucket's estimated step.
            bucket = self.ladder.bucket_for(len(batch))
            dispatch_by = earliest_deadline - max(float(self._step_time_fn(bucket)), 0.0)
            now = self._clock()
            if now >= dispatch_by or self._closed.is_set():
                break
            request = self._get(min(dispatch_by - now, self._POLL_S))
            if request is not None:
                batch.append(request)
                earliest_deadline = min(earliest_deadline, request.deadline_t)
        with self._lock:
            self._inflight += 1
        formed_t = self._clock()
        for request in batch:
            stamp(request.trace, "batch_formed", formed_t)
        return FormedBatch(
            requests=batch,
            bucket=self.ladder.bucket_for(len(batch)),
            queue_depth=self._queue.qsize(),
            formed_t=formed_t,
        )

    def mark_completed(self) -> None:
        """One drained batch finished (results distributed or failed)."""
        with self._lock:
            self._inflight = max(self._inflight - 1, 0)

    def pending(self) -> int:
        """Requests not yet resolved: queued, plus drained batches not yet
        completed (in batch units; nonzero means the device loop still owns
        work). The engine's ``drain()`` polls this to zero."""
        with self._lock:
            return self._queue.qsize() + self._inflight

    def close(self) -> None:
        """Stop admission and fail queued-but-unshipped requests. Idempotent."""
        self._closed.set()
        self._fail_queued()

    def _fail_queued(self) -> None:
        while True:
            try:
                request = self._queue.get_nowait()
            except queue.Empty:
                break
            request.future.set_exception(
                ServeClosedError("engine stopped before this request shipped")
            )

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def stats(self) -> dict:
        with self._lock:
            return {
                "submitted": self._submitted,
                "rejected": self._rejected,
                "shed_infeasible": self._shed_infeasible,
                "inflight": self._inflight,
                "queued": self._queue.qsize(),
            }
