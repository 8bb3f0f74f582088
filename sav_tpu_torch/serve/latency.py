"""Serving latency ledger: p50/p95/p99, throughput, queue, padding waste.

The port's own copy of ``sav_tpu/serve/latency.py`` (stdlib only). One
observation per finished batch, from host clocks the engine already holds.
An optional live window (:class:`~sav_tpu_torch.serve.telemetry.LiveWindow`)
is fed from the same observation path, so the final summary is
bit-identical with the window on or off, while :meth:`LatencyLedger.live`
shows the trailing window mid-run.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


def percentile(sorted_values: list, q: float) -> float:
    """Linear-interpolated percentile of an already-sorted list (numpy's
    default method)."""
    if not sorted_values:
        raise ValueError("percentile of an empty series")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    n = len(sorted_values)
    if n == 1:
        return float(sorted_values[0])
    pos = (q / 100.0) * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_values[lo] * (1.0 - frac) + sorted_values[hi] * frac)


class LatencyLedger:
    """Per-request latency and per-batch serving accounting."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter, *, window=None):
        self._clock = clock
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self._latencies: list = []
        self._overruns: list = []  # positive seconds past the deadline
        self._batches: dict = {}  # bucket -> [batches, real_rows]
        self._queue_sum = 0
        self._queue_max = 0
        self._step_s = 0.0
        self._rejected = 0
        # The live window (telemetry's LiveWindow, or None): fed after the
        # cumulative accumulators, from the same arguments.
        self._window = window

    def start(self) -> None:
        """Start of the serving window (the throughput denominator)."""
        with self._lock:
            self._t0 = self._clock()

    def observe_batch(
        self,
        *,
        bucket: int,
        latencies_s: list,
        overruns_s: list,
        queue_depth: int,
        step_s: float,
    ) -> None:
        with self._lock:
            if self._t0 is None:
                self._t0 = self._clock()
            self._t_last = self._clock()
            self._latencies.extend(float(v) for v in latencies_s)
            self._overruns.extend(float(v) for v in overruns_s if v > 0.0)
            stats = self._batches.setdefault(bucket, [0, 0])
            stats[0] += 1
            stats[1] += len(latencies_s)
            self._queue_sum += int(queue_depth)
            self._queue_max = max(self._queue_max, int(queue_depth))
            self._step_s += float(step_s)
        if self._window is not None:
            self._window.observe_window(
                latencies_s=latencies_s,
                overruns_s=overruns_s,
                bucket=bucket,
                queue_depth=queue_depth,
                step_s=step_s,
            )

    def observe_rejected(self, n: int = 1) -> None:
        """Requests refused at admission."""
        with self._lock:
            self._rejected += int(n)
        if self._window is not None:
            self._window.observe_shed(n)

    def live(self) -> Optional[dict]:
        """The windowed mid-run view (None with no window attached). Safe
        at any point: before the first completed batch the percentiles are
        None, never an exception."""
        if self._window is None:
            return None
        return self._window.snapshot()

    def summary(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            n = len(lat)
            batches = sum(b for b, _ in self._batches.values())
            padded_rows = sum(bucket * b for bucket, (b, _) in self._batches.items())
            real_rows = sum(r for _, r in self._batches.values())
            wall = (
                (self._t_last - self._t0)
                if (self._t0 is not None and self._t_last is not None)
                else 0.0
            )
            out = {
                "requests": n,
                "batches": batches,
                "rejected": self._rejected,
                "wall_s": round(wall, 4),
                "throughput_rps": round(n / wall, 2) if wall > 0 else 0.0,
                "step_s_total": round(self._step_s, 4),
                "padding_waste_frac": round(1.0 - real_rows / padded_rows, 4)
                if padded_rows else 0.0,
                "bucket_occupancy": {
                    str(bucket): {
                        "batches": b,
                        "fill": round(r / (bucket * b), 4) if b else 0.0,
                    }
                    for bucket, (b, r) in sorted(self._batches.items())
                },
                "queue_depth_avg": round(self._queue_sum / batches, 2) if batches else 0.0,
                "queue_depth_max": self._queue_max,
                "deadline_overruns": len(self._overruns),
                "deadline_overrun_max_ms": round(max(self._overruns) * 1e3, 3)
                if self._overruns else 0.0,
            }
            if n:
                out["latency_ms"] = {
                    "p50": round(percentile(lat, 50.0) * 1e3, 3),
                    "p95": round(percentile(lat, 95.0) * 1e3, 3),
                    "p99": round(percentile(lat, 99.0) * 1e3, 3),
                    "max": round(lat[-1] * 1e3, 3),
                }
            return out

    def flat_metrics(self, prefix: str = "serve/") -> dict:
        """Flat scalar view for the run manifest (``sav_tpu``'s keys, so
        its readers take the port's serve manifests)."""
        s = self.summary()
        out = {
            prefix + "requests": float(s["requests"]),
            prefix + "batches": float(s["batches"]),
            prefix + "rejected": float(s["rejected"]),
            prefix + "wall_s": s["wall_s"],
            prefix + "throughput_rps": s["throughput_rps"],
            prefix + "padding_waste_frac": s["padding_waste_frac"],
            prefix + "queue_depth_avg": s["queue_depth_avg"],
            prefix + "queue_depth_max": float(s["queue_depth_max"]),
            prefix + "deadline_overruns": float(s["deadline_overruns"]),
        }
        if "latency_ms" in s:
            for k, v in s["latency_ms"].items():
                out[prefix + k + "_latency_ms"] = v
        return out
