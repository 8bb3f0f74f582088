"""Goodput ledger: where a run's wall time went (the port's own copy of
``sav_tpu/obs/goodput.py``, stdlib only).

The training thread's wall clock is split into buckets:

  compile     the first train step: on the card its two warm-ups and the
              CUDA-graph capture (``train/graphs.py``), on the CPU its eager
              run
  step        training compute: the steps' dispatch (graph replays) and the
              log boundary's device-to-host copy, which waits for them
  input_wait  the training thread waiting for its next batch (with the async
              feeder the queue wait only; serial, the whole host fetch)
  h2d         host-to-device placement on the training thread (serial feed
              only; the feeder's overlapped placement is the gauge
              ``feeder/h2d_s``, not a bucket: buckets sum to the wall)
  eval        evaluation passes
  checkpoint  checkpoint saves' hold on the training thread and the waits
              for their writes
  stall       the *excess* of anomalous log windows over the expected step
              time
  other       what is left (computed, never accounted)

Gauges (:meth:`GoodputLedger.set_gauge`) carry scalars that are not the
training thread's wall time: background-thread seconds, queue depths, byte
counts.

Stall detection is per log window (where the trainer waits for the device):
a window whose per-step time exceeds ``stall_factor`` x the rolling median
of healthy windows is flagged, its expected share booked as ``step`` and
the excess as ``stall``; flagged windows stay out of the median.

``clock`` is injectable for deterministic tests.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

BUCKETS = (
    "compile", "step", "input_wait", "h2d", "eval", "checkpoint", "stall",
    "other",
)


class GoodputLedger:
    def __init__(
        self,
        *,
        stall_factor: float = 5.0,
        window_history: int = 64,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self._clock = clock
        self._t0 = clock()
        self.stall_factor = stall_factor
        self.window_history = window_history
        self._buckets: dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._per_step_history: list[float] = []
        self._gauges: dict[str, float] = {}
        self.anomalies: list[dict] = []
        self.steps = 0

    # ------------------------------------------------------------- recording

    def account(self, bucket: str, seconds: float) -> None:
        """Add ``seconds`` of wall time to ``bucket``."""
        if bucket not in self._buckets:
            raise KeyError(f"unknown goodput bucket {bucket!r}; use {BUCKETS}")
        self._buckets[bucket] += max(float(seconds), 0.0)

    @contextlib.contextmanager
    def measure(self, bucket: str):
        """Account the wall time of the ``with`` body to ``bucket``."""
        start = self._clock()
        try:
            yield
        finally:
            self.account(bucket, self._clock() - start)

    def set_gauge(self, name: str, value: float) -> None:
        """Record a scalar gauge (background-thread seconds, queue depths,
        byte counts). Gauges are reported next to the buckets but are NOT
        wall-time buckets — they never enter the sum-to-wall accounting."""
        self._gauges[name] = float(value)

    def _median(self) -> Optional[float]:
        if not self._per_step_history:
            return None
        ordered = sorted(self._per_step_history)
        n = len(ordered)
        mid = ordered[n // 2]
        return mid if n % 2 else 0.5 * (ordered[n // 2 - 1] + mid)

    def note_window(self, num_steps: int, seconds: float,
                    step: Optional[int] = None) -> bool:
        """Record one logging window of ``num_steps`` steps.

        Splits the window into ``step`` (expected) + ``stall`` (excess)
        when anomalous; returns True iff the window was flagged.
        """
        if num_steps <= 0:
            return False
        self.steps += num_steps
        per_step = seconds / num_steps
        median = self._median()
        anomalous = median is not None and per_step > self.stall_factor * median
        if anomalous:
            expected = num_steps * median
            self.account("step", expected)
            self.account("stall", seconds - expected)
            self.anomalies.append({
                "step": step,
                "per_step_s": round(per_step, 6),
                "median_per_step_s": round(median, 6),
                "slowdown": round(per_step / max(median, 1e-12), 2),
            })
        else:
            self.account("step", seconds)
            self._per_step_history.append(per_step)
            if len(self._per_step_history) > self.window_history:
                self._per_step_history.pop(0)
        return anomalous

    # ------------------------------------------------------------- reporting

    @property
    def wall_s(self) -> float:
        return self._clock() - self._t0

    def bucket_seconds(self, bucket: str) -> float:
        """Accumulated seconds of one bucket (the supervisor reads the
        ``step`` bucket's seconds per step from the heartbeats)."""
        if bucket not in self._buckets:
            raise KeyError(f"unknown goodput bucket {bucket!r}; use {BUCKETS}")
        return self._buckets[bucket]

    def summary(self) -> dict:
        """End-of-run ledger: buckets (incl. the ``other`` residual) sum to
        ``wall_s`` up to clock-read noise."""
        total = self.wall_s
        buckets = dict(self._buckets)
        accounted = sum(v for k, v in buckets.items() if k != "other")
        buckets["other"] = max(total - accounted, 0.0)
        summary = {
            "wall_s": round(total, 4),
            "steps": self.steps,
            "buckets_s": {k: round(v, 4) for k, v in buckets.items()},
            "fractions": {
                k: round(v / total, 4) if total > 0 else 0.0
                for k, v in buckets.items()
            },
            # Goodput proper: the fraction of wall time spent on training
            # compute (compile excluded — it is overhead, not progress).
            "goodput_fraction": round(
                buckets["step"] / total, 4) if total > 0 else 0.0,
            "num_anomalies": len(self.anomalies),
        }
        if self.anomalies:
            summary["anomalies"] = list(self.anomalies)
        if self._gauges:
            summary["gauges"] = {
                k: round(v, 6) for k, v in self._gauges.items()
            }
        median = self._median()
        if median is not None:
            summary["median_step_s"] = round(median, 6)
        return summary

    def flat_metrics(self, prefix: str = "goodput/") -> dict[str, float]:
        """Flat float view of :meth:`summary` for metric writers (every
        value a scalar, for metric writers)."""
        s = self.summary()
        out = {prefix + "wall_s": s["wall_s"]}
        for k, v in s["buckets_s"].items():
            out[prefix + k + "_s"] = v
        out[prefix + "goodput_fraction"] = s["goodput_fraction"]
        out[prefix + "num_anomalies"] = float(s["num_anomalies"])
        for k, v in s.get("gauges", {}).items():
            out[prefix + k] = v
        return out
