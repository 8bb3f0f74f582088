"""Host-side span tracing: Chrome trace events around ``Trainer.fit``'s
phases (the port's own copy of ``sav_tpu/obs/spans.py``, stdlib only).

``torch.profiler`` answers what the device did; these spans answer where the
*host* spent its wall time: waiting for a batch, placing it, dispatching
the step (a graph replay on the card), the log boundary's device-to-host
copy, eval and checkpoint. The file is the Trace Event Format
(``{"traceEvents": [...]}``, ``ph: "X"`` complete events, microsecond
timestamps), which Perfetto (https://ui.perfetto.dev) and
``chrome://tracing`` load.

A disabled tracer (``SpanTracer(None)``) costs one ``if`` a span, so the
trainer wires spans unconditionally.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional


class SpanTracer:
    """Collects complete-events in memory; :meth:`write` dumps the file.

    ``path=None`` disables the tracer entirely (every method is a cheap
    no-op), so the trainer wires spans unconditionally and the flag only
    decides whether anything is recorded. Thread-safe: the watchdog and
    checkpoint threads may emit instants while the train loop records
    spans.
    """

    def __init__(self, path: Optional[str], *, process_name: str = "sav_tpu_torch"):
        self.path = path
        self.enabled = path is not None
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        if self.enabled:
            # Metadata event names the process row in the Perfetto UI.
            self._events.append({
                "name": "process_name", "ph": "M", "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": {"name": process_name},
            })

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Record a complete event around the ``with`` body."""
        if not self.enabled:
            yield
            return
        start = self._now_us()
        try:
            yield
        finally:
            event = {
                "name": name, "ph": "X", "ts": start,
                "dur": self._now_us() - start,
                "pid": os.getpid(), "tid": threading.get_ident(),
            }
            if args:
                event["args"] = args
            with self._lock:
                self._events.append(event)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker (eval boundaries, stall anomalies...)."""
        if not self.enabled:
            return
        event = {
            "name": name, "ph": "i", "ts": self._now_us(), "s": "t",
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        if args:
            event["args"] = args
        with self._lock:
            self._events.append(event)

    @property
    def num_events(self) -> int:
        with self._lock:
            return len(self._events)

    def write(self) -> Optional[str]:
        """Write the trace file (returns its path; None when disabled).

        Safe to call repeatedly — crash-prone loops can flush
        periodically and the final file wins.
        """
        if not self.enabled:
            return None
        with self._lock:
            events = list(self._events)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(
                {"traceEvents": events, "displayTimeUnit": "ms"},
                f,
            )
        return self.path
