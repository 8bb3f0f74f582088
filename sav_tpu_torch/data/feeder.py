"""Async double-buffered device feeder.

The port's own copy of ``sav_tpu/data/feeder.py`` (stdlib only; the port
imports nothing of ``sav_tpu``). One background thread pulls host batches,
places each through the caller's ``place_fn`` and pushes the *placed*
batches into a bounded queue, so placement of batch N+1 overlaps the
consumer's work on batch N:

    host fetch (batch N+2)  ──┐  background thread
    place      (batch N+1)  ──┤  (bounded queue, depth knob)
    device step (batch N)   ──┘  consumer thread

``depth=2`` is double buffering: at most ``depth`` placed batches wait
beyond the one the consumer holds; the queue's ``maxsize`` is the
backpressure. The serving engine's ``place_fn`` pads each batch into
pinned host memory and copies it to the card on a CUDA stream of the
worker's own (:mod:`sav_tpu_torch.serve.engine`).

Semantics (tests/test_torch_serve_path.py):

- **Drain**: the source iterator's ``StopIteration`` is delivered to the
  consumer exactly once, after every already-placed batch has been
  consumed; later ``next()`` calls keep raising ``StopIteration``.
- **Exception propagation**: an exception in the source iterator or in
  ``place_fn`` is re-raised in the consumer thread (after the batches
  placed before it), not swallowed on the worker.
- **Shutdown**: ``close()`` (also via context manager) stops the worker
  promptly even when it is blocked on a full queue, and a consumer blocked
  in ``next()`` on another thread sees the closed state; it never joins a
  thread blocked inside the source iterator forever (the worker is a
  daemon and checks the stop flag between stages).

:meth:`DeviceFeeder.stats` keeps the worker-side counters (fetch and
placement seconds, queue-depth high-water and average) and the consumer's
blocked time.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional


class DeviceFeeder:
    """Bounded async pipeline: host iterator → place_fn → placed-batch queue.

    Args:
      iterator: host batch source (dicts of numpy arrays, typically).
      place_fn: called on the worker thread with each host batch; returns
        the placed (device) batch the consumer receives.
      depth: max placed batches queued beyond the one the consumer holds
        (2 = double buffering). Also the backpressure bound.
      name: the worker thread's name (stack dumps list it).
    """

    _POLL_S = 0.1  # stop-flag responsiveness for blocking queue ops

    def __init__(
        self,
        iterator: Iterator[dict],
        place_fn: Callable[[dict], Any],
        *,
        depth: int = 2,
        name: str = "device-feeder",
    ):
        if depth < 1:
            raise ValueError(f"feeder depth must be >= 1, got {depth}")
        self.depth = depth
        self._iterator = iterator
        self._place_fn = place_fn
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._finished = False
        # Worker-side counters. Python attribute writes are atomic under
        # the GIL; the consumer only ever reads them for telemetry.
        self._fetch_s = 0.0
        self._put_s = 0.0
        self._batches = 0
        self._depth_max = 0
        self._depth_sum = 0
        self._wait_s = 0.0  # consumer-side blocked time
        self._thread = threading.Thread(
            target=self._worker, name=name, daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- worker

    def _enqueue(self, item) -> bool:
        """Bounded put that stays responsive to close(); True if queued."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = next(self._iterator)
                except StopIteration:
                    break
                self._fetch_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                placed = self._place_fn(batch)
                self._put_s += time.perf_counter() - t0
                self._batches += 1
                if not self._enqueue(placed):
                    return  # closed while blocked on a full queue
                d = self._queue.qsize()
                self._depth_sum += d
                self._depth_max = max(self._depth_max, d)
        except BaseException as e:  # re-raised on the consumer thread
            self._err = e
        finally:
            self._enqueue(self._done)

    # ----------------------------------------------------------- consumer

    def __iter__(self):
        return self

    def __next__(self):
        # Terminal states persist: the sentinel is consumed exactly once,
        # so later next() calls must not block on an empty queue.
        if self._finished:
            if self._err is not None:
                raise self._err
            raise StopIteration
        # Timed get re-checking the stop flag (mirror of _enqueue): after
        # close() the worker drops everything including the sentinel, so
        # an untimed get from a consumer on another thread would block
        # forever instead of seeing the closed state.
        t0 = time.perf_counter()
        while True:
            if self._stop.is_set():
                self._wait_s += time.perf_counter() - t0
                raise RuntimeError("DeviceFeeder is closed")
            try:
                item = self._queue.get(timeout=self._POLL_S)
                break
            except queue.Empty:
                continue
        self._wait_s += time.perf_counter() - t0
        if item is self._done:
            self._finished = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker and release the queue. Idempotent.

        Safe to call with the worker in any state (blocked on a full
        queue, mid-place, already drained). Does not wait on the source
        iterator: a worker blocked inside ``next(iterator)`` is a daemon
        thread and dies with the process; everything it might still
        enqueue after close() is dropped by the poisoned stop flag.
        """
        self._stop.set()
        # Unblock a worker stuck in queue.put by draining; bounded loop —
        # the worker checks the stop flag at least every _POLL_S.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5 * self._POLL_S)
        # The drain races the worker's in-flight put: the slot it freed can
        # be re-filled just after get_nowait saw Empty. The worker never
        # *starts* a put once the flag is set, so after the join one more
        # drain releases anything that slipped in — without it a placed
        # device batch could stay referenced by the dead queue.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---------------------------------------------------------- telemetry

    def stats(self) -> dict:
        """Worker and consumer counters.

        ``h2d_s``/``fetch_s`` are background-thread seconds (overlapped
        with the consumer's work, not its wall time); ``wait_s`` is the
        consumer's blocked time; ``depth_avg``/``depth_max`` show whether
        the buffer stayed full (a starved feeder sits at 0).
        """
        batches = self._batches
        return {
            "batches": float(batches),
            "fetch_s": round(self._fetch_s, 6),
            "h2d_s": round(self._put_s, 6),
            "wait_s": round(self._wait_s, 6),
            "depth": float(self.depth),
            "depth_max": float(self._depth_max),
            "depth_avg": round(self._depth_sum / batches, 4) if batches else 0.0,
        }
