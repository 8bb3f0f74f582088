"""Serve telemetry — per-request spans, live windows, heartbeats, SLO burn.

The port's own copy of ``sav_tpu/serve/telemetry.py`` (stdlib only). Four
pillars:

1. **Per-request lifecycle tracing.** Every admitted request carries a
   :class:`RequestTrace` stamped at each stage of its life::

       submit -> admit -> batch_formed -> placed -> dispatched
              -> executed -> depadded -> completed

   Stamps are host-clock appends only (:func:`stamp`): the batcher drain
   and the engine's device loop add no device sync for tracing, and
   ``executed`` is stamped after the loop's one per-batch sync returns.
   Completed traces land in a bounded :class:`SpanRing`; requests whose
   latency clears a robust median+MAD gate are dumped as **slow-request
   exemplars** with full span detail under ``<log_dir>/serve_traces/``,
   and the ring exports as chrome-trace events
   (:func:`export_chrome_trace`) in ``sav_tpu``'s layout, so its trace
   readers parse the port's files.

2. **Live windowed metrics.** :class:`SlidingWindow` is a fixed-window
   sorted-reservoir percentile sketch (exact over the retained samples);
   :class:`LiveWindow` aggregates the serving headline over the trailing
   window — p50/p99, throughput, queue depth, occupancy, padding waste,
   shed/overrun counts — observable *while serving*. The
   :class:`~sav_tpu_torch.serve.latency.LatencyLedger` feeds it from its
   own observation path, so the ledger's final numbers are bit-identical
   with the window on or off.

3. **Serve heartbeats.** A time-cadenced (serving has no step boundary)
   ``kind=serve`` stream on the
   :class:`~sav_tpu_torch.obs.fleet.HeartbeatWriter` substrate
   (``fleet/proc_<i>.jsonl``): windowed p99, queue depth, inflight,
   occupancy, padding waste, shed/overrun counters, SLO burn state, the
   device-memory watermark, measured capacity and the firing alerts.
   :func:`aggregate_serve` folds the streams into the per-replica view —
   queue depth, p99, occupancy per replica — that a fleet router
   balances on.

4. **SLO accounting.** :class:`SLOTracker` scores every request against a
   declarative SLO (deadline-hit-rate target over short/long burn windows
   — the Google-SRE multiwindow burn-rate shape), producing
   ``slo_hit_frac`` / ``burn_rate`` in heartbeats and the serve manifest;
   :mod:`sav_tpu_torch.obs.alerts` turns the beats into firing/resolved
   episodes.

The anomaly-profiler seam (``autoprof``) and the quality seam
(``quality_fn``) are kept with ``sav_tpu``'s behaviour; the port's engine
passes its quality snapshot (digest drift gates and the probe ledger) and
no profiler yet (ROADMAP queue A10).

Deliberately **stdlib only** (no torch, no numpy): the offline readers
work on copied logs on any machine, and keeping torch unimportable here is
the structural proof that span stamping and window arithmetic cannot sync
a device value (a test checks the import surface in a fresh interpreter).
"""

from __future__ import annotations

import gzip
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from sav_tpu_torch.obs import alerts as alerts_mod
from sav_tpu_torch.obs import rollup as rollup_mod
from sav_tpu_torch.obs.fleet import (
    MAD_SCALE,
    _mad,
    _median,
    iter_manifests,
    read_heartbeats,
    silence_suspects,
)

SERVE_TELEMETRY_SCHEMA = 1

#: The span vocabulary, in lifecycle order.
STAGES = (
    "submit",       # engine.submit entry (request validated, host clock)
    "admit",        # batcher admission passed (queue + shed projection)
    "batch_formed", # the drain closed the batch this request rides in
    "placed",       # padded batch's copy to the device issued (feeder thread)
    "dispatched",   # device loop handed the batch to the executable
    "executed",     # device done (the loop's one per-batch sync returned)
    "depadded",     # this request's row sliced out of the padded batch
    "completed",    # future resolved; the submitter can read the result
)

#: Derived per-request intervals (seconds), keyed by the stage that
#: *ends* each one. "queue" spans admission to batch close — the
#: batcher wait; "device" spans dispatch to the post-execution sync.
INTERVALS = (
    ("admission", "submit", "admit"),
    ("queue", "admit", "batch_formed"),
    ("place", "batch_formed", "placed"),
    ("dispatch_wait", "placed", "dispatched"),
    ("device", "dispatched", "executed"),
    ("depad", "executed", "depadded"),
    ("deliver", "depadded", "completed"),
)

#: The fleet router's span vocabulary, in lifecycle order
#: (:mod:`sav_tpu_torch.serve.router`). The router stamps with
#: its OWN monotonic clock — replica stamps live in the replica's clock
#: domain and only meet these in the offline merge, which estimates
#: the per-replica offset from the (sent, submit)/(completed, reply)
#: handshake pairs. Terminal stamps for requests that never complete
#: ("shed", "failed") ride the same list but end no interval.
ROUTER_STAGES = (
    "submit",         # router.admit entry (request validated, job built)
    "admit",          # admission passed (capacity + shed projection)
    "route_selected", # a dispatch worker picked a replica
    "connect",        # transport connection to the replica established
    "sent",           # request bytes handed to the replica socket
    "reply",          # the replica's reply line arrived
    "completed",      # future resolved; the submitter can read the result
)

#: The router's per-request intervals (its own clock domain only).
#: ``replica_wait`` is the opaque cross-process span the offline merge
#: decomposes into replica_queue/device/depad + transport halves.
ROUTER_INTERVALS = (
    ("admission", "submit", "admit"),
    ("router_queue", "admit", "route_selected"),
    ("route", "route_selected", "connect"),
    ("transport_send", "connect", "sent"),
    ("replica_wait", "sent", "reply"),
    ("deliver", "reply", "completed"),
)


class RequestTrace:
    """One request's span record: an append-only ``(stage, t)`` list.

    ``t`` values come from one injectable monotonic clock (the
    batcher's); stamping is the cheapest possible host operation so the
    admission/drain/device paths stay sync-free.
    """

    __slots__ = ("rid", "deadline_s", "stamps")

    def __init__(self, rid: int, deadline_s: float, t_submit: float):
        self.rid = rid
        self.deadline_s = float(deadline_s)
        self.stamps = [("submit", float(t_submit))]


def stamp(trace: Optional[RequestTrace], stage: str, t: float) -> None:
    """Append one span stamp (no-op on untraced requests). Host-only by
    contract: a device sync here would serialize the batcher drain behind
    the device."""
    if trace is not None:
        trace.stamps.append((stage, t))


def intervals(stamps: list, defs: tuple = INTERVALS) -> dict:
    """Per-interval seconds from a stamp list (missing stages skipped).
    ``defs`` selects the vocabulary — the replica's :data:`INTERVALS`
    by default, :data:`ROUTER_INTERVALS` for router traces."""
    at = {}
    for name, t in stamps:
        at.setdefault(name, float(t))
    out = {}
    for name, start, end in defs:
        if start in at and end in at:
            out[name] = at[end] - at[start]
    return out


def dominant_stage(stages_s: dict) -> Optional[str]:
    """The interval that ate the most wall time — 'queue vs device' for
    a slow-request post-mortem."""
    if not stages_s:
        return None
    return max(stages_s, key=lambda k: stages_s[k])


class SpanRing:
    """Bounded ring of the last N completed request traces (plain
    dicts, export-ready). Thread-safety is the owner's job — the engine
    appends from its single device loop."""

    def __init__(self, depth: int = 256):
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {depth}")
        self._ring: deque = deque(maxlen=depth)
        self.appended = 0

    def append(self, record: dict) -> None:
        self._ring.append(record)
        self.appended += 1

    def records(self) -> list:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


def trace_record(
    trace: RequestTrace,
    *,
    latency_s: float,
    overrun_s: float,
    bucket: int,
    batch_n: int,
) -> dict:
    """Fold one completed trace into the ring/export record shape.

    Values stay UNROUNDED here — this runs on the device loop for every
    completed request, and cosmetic rounding is deferred to the write
    paths (exemplar dump, chrome export), which are rare/bounded.
    """
    stages_s = intervals(trace.stamps)
    return {
        "rid": trace.rid,
        "deadline_ms": trace.deadline_s * 1e3,
        "latency_ms": latency_s * 1e3,
        "overrun_ms": overrun_s * 1e3,
        "hit": overrun_s <= 0.0,
        "bucket": bucket,
        "batch_n": batch_n,
        "stamps": trace.stamps,
        "stages_ms": {k: v * 1e3 for k, v in stages_s.items()},
        "dominant_stage": dominant_stage(stages_s),
    }


# -------------------------------------------------------- chrome export


def export_chrome_trace(
    records: list,
    defs: tuple = INTERVALS,
    *,
    process_name: str = "Serve Requests",
    extra_args: tuple = (),
) -> dict:
    """The span ring as chrome-trace events (one row per request,
    one "X" event per interval) — the format ``sav_tpu``'s trace
    readers (``obs/traceview.py``'s ``load_trace`` and
    ``request_spans``) parse.
    ``defs`` picks the interval vocabulary; ``extra_args`` names record
    keys copied into each event's args verbatim (the router export
    carries ``rank``/``outcome`` so the offline merge can join the
    replica's trace)."""
    events = [
        {
            "ph": "M", "pid": 1, "name": "process_name",
            "args": {"name": process_name},
        }
    ]
    for rec in records:
        at = {}
        for stage, t in rec.get("stamps", []):
            at.setdefault(stage, float(t))
        rid = rec.get("rid", 0)
        for name, start, end in defs:
            if start not in at or end not in at:
                continue
            args = {
                "request": rid,
                "bucket": rec.get("bucket"),
                "deadline_ms": (
                    round(rec["deadline_ms"], 3)
                    if isinstance(rec.get("deadline_ms"), (int, float))
                    else None
                ),
                "overrun_ms": (
                    round(rec["overrun_ms"], 3)
                    if isinstance(rec.get("overrun_ms"), (int, float))
                    else None
                ),
            }
            for key in extra_args:
                if key in rec:
                    args[key] = rec[key]
            events.append({
                "ph": "X",
                "pid": 1,
                "tid": rid,
                "name": name,
                "ts": round(at[start] * 1e6, 1),
                "dur": round((at[end] - at[start]) * 1e6, 1),
                "args": args,
            })
    return {"traceEvents": events}


def write_request_trace(
    path: str,
    records: list,
    defs: tuple = INTERVALS,
    *,
    process_name: str = "Serve Requests",
    extra_args: tuple = (),
) -> Optional[str]:
    """Persist the ring as ``*.trace.json.gz`` (telemetry: returns None
    instead of raising on I/O failure)."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with gzip.open(tmp, "wt") as f:
            json.dump(
                export_chrome_trace(
                    records, defs,
                    process_name=process_name, extra_args=extra_args,
                ),
                f,
            )
        os.replace(tmp, path)
        return path
    except OSError:
        return None


# ------------------------------------------------------- sliding windows


class SlidingWindow:
    """Fixed-window sorted-reservoir percentile sketch (stdlib-only).

    Holds the last ``window_s`` seconds of ``(t, value)`` samples,
    bounded by ``max_samples`` (oldest evicted first — under cap the
    percentiles are EXACT over the window; over cap they are exact over
    the newest ``max_samples``, a bounded-staleness approximation). Not
    thread-safe; owners lock.
    """

    def __init__(
        self,
        window_s: float = 30.0,
        *,
        max_samples: int = 4096,
        clock: Callable[[], float] = time.monotonic,
    ):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.window_s = float(window_s)
        self._max = int(max_samples)
        self._clock = clock
        self._samples: deque = deque()

    def _evict(self, now: float) -> None:
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()
        while len(self._samples) > self._max:
            self._samples.popleft()

    def observe(self, value: float, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        self._samples.append((now, float(value)))
        self._evict(now)

    def values(self, now: Optional[float] = None) -> list:
        self._evict(self._clock() if now is None else now)
        return [v for _, v in self._samples]

    def count(self, now: Optional[float] = None) -> int:
        self._evict(self._clock() if now is None else now)
        return len(self._samples)

    def total(self, now: Optional[float] = None) -> float:
        self._evict(self._clock() if now is None else now)
        return sum(v for _, v in self._samples)

    def percentile(self, q: float, now: Optional[float] = None):
        """Windowed percentile, or None on an empty window — the
        graceful-degrade contract: a live query before the first
        completed batch must never raise."""
        values = sorted(self.values(now))
        if not values:
            return None
        from sav_tpu_torch.serve.latency import percentile as _pct

        return _pct(values, q)


class LiveWindow:
    """The live serving headline over a trailing window.

    Fed by :meth:`~sav_tpu_torch.serve.latency.LatencyLedger.observe_batch`
    (one call per shipped batch — same observation path as the final
    summary, which is what keeps the two views consistent) and by the
    shed path. ``snapshot()`` is safe at ANY point in the run: before
    the first completed batch every percentile is None and every rate
    zero, never an exception.
    """

    def __init__(
        self,
        window_s: float = 30.0,
        *,
        max_samples: int = 4096,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._latency = SlidingWindow(
            window_s, max_samples=max_samples, clock=clock
        )
        self._queue = SlidingWindow(
            window_s, max_samples=max_samples, clock=clock
        )
        # Per-batch (t, (real_rows, padded_rows)) for occupancy/waste.
        self._rows: deque = deque()
        self._overruns = SlidingWindow(
            window_s, max_samples=max_samples, clock=clock
        )
        self._shed = SlidingWindow(
            window_s, max_samples=max_samples, clock=clock
        )
        self._step_s = SlidingWindow(
            window_s, max_samples=max_samples, clock=clock
        )

    def observe_window(
        self,
        *,
        latencies_s: list,
        overruns_s: list,
        bucket: int,
        queue_depth: int,
        step_s: float,
        now: Optional[float] = None,
    ) -> None:
        """One shipped batch into the window (host floats only)."""
        now = self._clock() if now is None else now
        with self._lock:
            for v in latencies_s:
                self._latency.observe(float(v), now)
            for v in overruns_s:
                if v > 0.0:
                    self._overruns.observe(float(v), now)
            self._queue.observe(int(queue_depth), now)
            self._step_s.observe(float(step_s), now)
            self._rows.append((now, (len(latencies_s), int(bucket))))
            horizon = now - self.window_s
            while self._rows and self._rows[0][0] < horizon:
                self._rows.popleft()

    def observe_shed(self, n: int = 1, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            for _ in range(int(n)):
                self._shed.observe(1.0, now)

    def latency_values(self, now: Optional[float] = None) -> list:
        with self._lock:
            return self._latency.values(now)

    def queue_values(self, now: Optional[float] = None) -> list:
        with self._lock:
            return self._queue.values(now)

    def snapshot(self, now: Optional[float] = None) -> dict:
        now = self._clock() if now is None else now
        with self._lock:
            lat = sorted(self._latency.values(now))
            horizon = now - self.window_s
            while self._rows and self._rows[0][0] < horizon:
                self._rows.popleft()
            # Request counts and throughput come from the per-batch row
            # entries (one per batch, time-evicted only) — EXACT over
            # the window. The latency reservoir is additionally capped
            # at max_samples, so len(lat) saturates under high load
            # (4096/30s ≈ 137 rps at defaults) and must only feed the
            # percentiles, where bounded staleness is the documented
            # approximation.
            real = sum(r for _, (r, _) in self._rows)
            padded = sum(b for _, (_, b) in self._rows)
            queue_vals = self._queue.values(now)
            # Elapsed window: the full window once data is older than
            # it, else the observed span (a 2s-old window must not
            # report a 30s-diluted rate).
            span = self.window_s
            if lat or self._rows:
                oldest = min(
                    [t for t, _ in self._rows]
                    or [now - self.window_s]
                )
                span = min(self.window_s, max(now - oldest, 1e-9))
            out = {
                "window_s": self.window_s,
                "requests": real,
                "batches": len(self._rows),
                "throughput_rps": (
                    round(real / span, 2) if real else 0.0
                ),
                "queue_depth_last": (
                    int(queue_vals[-1]) if queue_vals else 0
                ),
                "queue_depth_avg": (
                    round(sum(queue_vals) / len(queue_vals), 2)
                    if queue_vals else 0.0
                ),
                "queue_depth_max": (
                    int(max(queue_vals)) if queue_vals else 0
                ),
                "occupancy": (
                    round(real / padded, 4) if padded else None
                ),
                "padding_waste_frac": (
                    round(1.0 - real / padded, 4) if padded else None
                ),
                "overruns": self._overruns.count(now),
                "shed": self._shed.count(now),
                "step_s_avg": (
                    round(
                        self._step_s.total(now) / self._step_s.count(now), 5
                    )
                    if self._step_s.count(now) else None
                ),
            }
            if lat:
                from sav_tpu_torch.serve.latency import percentile as _pct

                out["p50_ms"] = round(_pct(lat, 50.0) * 1e3, 3)
                out["p95_ms"] = round(_pct(lat, 95.0) * 1e3, 3)
                out["p99_ms"] = round(_pct(lat, 99.0) * 1e3, 3)
            else:
                out["p50_ms"] = out["p95_ms"] = out["p99_ms"] = None
            return out


# -------------------------------------------------------------- SLO


class _RateWindow:
    """Windowed (misses, total) counts — the SLO burn windows need only
    rates, so one ``(t, misses, n)`` entry per observed BATCH keeps the
    per-request hot-path cost at zero appends. Owner locks."""

    def __init__(self, window_s: float):
        self.window_s = float(window_s)
        self._entries: deque = deque()
        self._misses = 0
        self._n = 0

    def observe(self, misses: int, n: int, now: float) -> None:
        self._entries.append((now, misses, n))
        self._misses += misses
        self._n += n
        self._evict(now)

    def _evict(self, now: float) -> None:
        horizon = now - self.window_s
        while self._entries and self._entries[0][0] < horizon:
            _, misses, n = self._entries.popleft()
            self._misses -= misses
            self._n -= n

    def counts(self, now: float) -> tuple:
        self._evict(now)
        return self._misses, self._n


class SLOTracker:
    """Deadline-hit-rate SLO with Google-SRE multiwindow burn rates.

    ``target`` is the hit-rate objective (0.99 = at most 1% of requests
    may miss their deadline); the **error budget** is ``1 - target``.
    The burn rate of a window is ``miss_frac / budget`` — 1.0 means the
    budget burns exactly at the sustainable rate, N means the budget
    exhausts N times too fast. Alerting uses the standard two-window
    AND (a short window for responsiveness, a long one so a single
    blip cannot page): ``burning`` iff BOTH windows exceed
    ``burn_threshold``. Shed requests count as misses — a request the
    admission controller turned away did not hit its deadline.
    """

    def __init__(
        self,
        *,
        target: float = 0.99,
        fast_window_s: float = 60.0,
        slow_window_s: float = 600.0,
        burn_threshold: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not 0.0 < target < 1.0:
            raise ValueError(f"slo target must be in (0, 1), got {target}")
        if fast_window_s >= slow_window_s:
            raise ValueError(
                f"fast window ({fast_window_s}s) must be shorter than the "
                f"slow window ({slow_window_s}s)"
            )
        self.target = float(target)
        self.burn_threshold = float(burn_threshold)
        self._clock = clock
        self._lock = threading.Lock()
        self._fast = _RateWindow(fast_window_s)
        self._slow = _RateWindow(slow_window_s)
        self.requests = 0
        self.misses = 0

    def observe_outcomes(
        self, misses: int, n: int, now: Optional[float] = None
    ) -> None:
        """Fold one batch's outcomes in — ONE lock + append per batch,
        which is what keeps SLO accounting off the per-request cost."""
        if n <= 0:
            return
        now = self._clock() if now is None else now
        with self._lock:
            self.requests += n
            self.misses += misses
            self._fast.observe(misses, n, now)
            self._slow.observe(misses, n, now)

    def observe_request(
        self, hit: bool, now: Optional[float] = None
    ) -> None:
        self.observe_outcomes(int(not hit), 1, now)

    def _burn(self, window: _RateWindow, now: float) -> Optional[float]:
        misses, n = window.counts(now)
        if not n:
            return None
        return round((misses / n) / (1.0 - self.target), 4)

    def state(self, now: Optional[float] = None) -> dict:
        now = self._clock() if now is None else now
        with self._lock:
            fast = self._burn(self._fast, now)
            slow = self._burn(self._slow, now)
            return {
                "target": self.target,
                "requests": self.requests,
                "misses": self.misses,
                "hit_frac": (
                    round(1.0 - self.misses / self.requests, 6)
                    if self.requests else None
                ),
                "burn_fast": fast,
                "burn_slow": slow,
                # The headline burn number: the long window (short-blip
                # noise stays in burn_fast).
                "burn_rate": slow,
                "burning": bool(
                    fast is not None and slow is not None
                    and fast > self.burn_threshold
                    and slow > self.burn_threshold
                ),
                "burn_threshold": self.burn_threshold,
            }


# -------------------------------------------------------- the orchestrator


class ServeTelemetry:
    """The engine's request-scoped + fleet-scoped observability layer.

    Owns the span ring, the live window, the SLO tracker, the
    slow-request exemplar gate, the serve heartbeat thread, and the
    anomaly hooks into a bounded :class:`AutoProfiler`. Everything on
    the serving hot path (``begin_trace`` / ``stamp`` /
    ``observe_completed`` / ``observe_shed`` / ``serve_beat``) is
    host-only, and ``stats()``'s ``overhead_s`` gauge makes the cost
    assertable.
    """

    # Batches between robust-gate recomputations (latency + queue
    # anomaly gates): median+MAD over the window costs two sorts, which
    # must not be a per-batch tax. A slow-moving gate refreshed every
    # few batches detects the same spikes (a spike is 10-100x the
    # median; the gate drifts by percents between refreshes).
    GATE_REFRESH = 8

    def __init__(
        self,
        log_dir: Optional[str] = None,
        *,
        dtype: Optional[str] = None,
        trace_ring: int = 256,
        exemplar_max: int = 8,
        exemplar_sigma: float = 4.0,
        exemplar_min_history: int = 16,
        window_s: float = 30.0,
        heartbeat_secs: float = 5.0,
        slo_target: float = 0.99,
        slo_fast_window_s: float = 60.0,
        slo_slow_window_s: float = 600.0,
        slo_burn_threshold: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
        perf: Callable[[], float] = time.perf_counter,
        writer=None,
        autoprof=None,
        queue_stats_fn: Optional[Callable[[], dict]] = None,
        hbm_fn: Optional[Callable[[], Optional[dict]]] = None,
        quality_fn: Optional[Callable[[], Optional[dict]]] = None,
        max_batch: Optional[int] = None,
        alerts="auto",
    ):
        self.log_dir = log_dir
        # Weight-serving dtype stamp ("bfloat16" | "float32" | "int8"):
        # rides every heartbeat so a reader can tell a quantized replica
        # from a bf16 one without reading its manifest. None = unstamped.
        self.dtype = dtype
        self.clock = clock
        self._wall = wall_clock
        self._perf = perf
        self.ring = SpanRing(trace_ring)
        self.window = LiveWindow(window_s, clock=clock)
        self.slo = SLOTracker(
            target=slo_target,
            fast_window_s=slo_fast_window_s,
            slow_window_s=slo_slow_window_s,
            burn_threshold=slo_burn_threshold,
            clock=clock,
        )
        self.exemplar_max = int(exemplar_max)
        self.exemplar_sigma = float(exemplar_sigma)
        self.exemplar_min_history = int(exemplar_min_history)
        self.heartbeat_secs = float(heartbeat_secs)
        self.writer = writer
        self.autoprof = autoprof
        # Measured capacity: the ladder's top rung over the windowed
        # per-batch step — rows/s this replica can actually sustain,
        # published as ``capacity_rps`` in every beat. None publishes
        # nothing.
        self.max_batch = int(max_batch) if max_batch else None
        # Declarative alert rules: "auto" arms the built-in SLO burn
        # rule (the same edges as SLOTracker's ``burning``) plus any
        # operator rules from the SAV_ALERT_RULES environment variable (a
        # JSON file path or JSON text — replicas inherit the parent's
        # environment, so a fleet arms without flags). Pass an
        # AlertEngine to own the rule set outright, or None to disarm.
        # Evaluation runs at heartbeat cadence only.
        if alerts == "auto":
            alerts = None
            if writer is not None:
                rules = alerts_mod.default_rules(slo_burn_threshold)
                # Quality rules arm ALONGSIDE the default set, never
                # inside it — default_rules() stays exactly the SLO rule.
                # Beats without quality fields evaluate them False, so
                # replicas without a quality seam pay nothing.
                rules = rules + alerts_mod.quality_rules()
                source = os.environ.get("SAV_ALERT_RULES")
                if source:
                    rules = rules + alerts_mod.load_rules(source)
                alerts = alerts_mod.AlertEngine(
                    rules,
                    log_dir=log_dir,
                    proc=getattr(writer, "process_index", None),
                    clock=wall_clock,
                )
        self.alerts = alerts
        self._queue_stats_fn = queue_stats_fn
        self._hbm_fn = hbm_fn
        # Quality snapshot seam: digest drift gates + probe state folded
        # at beat cadence — rides every kind=serve beat under
        # ``quality`` (readers are forward-compatible).
        self._quality_fn = quality_fn
        self._lock = threading.Lock()
        self._rid = itertools.count(1)
        self._batches = 0
        self._completed = 0
        self._shed = 0
        # Cached robust gates (latency + queue), refreshed every
        # GATE_REFRESH batches: the median+MAD of a trailing window
        # moves slowly, and recomputing it (two sorts) on EVERY batch
        # is the kind of per-batch tax the <2%-overhead contract
        # exists to keep out of the device loop.
        self._lat_gate: Optional[float] = None
        self._queue_gate: Optional[float] = None
        self._gates_at = -10**9
        self._gate_window_n = 0
        self._exemplars: list = []
        self._heartbeats = 0
        self._overhead_s = 0.0
        self._t_start: Optional[float] = None
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._closed = False

    # ----------------------------------------------------------- tracing

    def begin_trace(self, deadline_s: float, *, rid=None) -> RequestTrace:
        """Open one request's span record (engine ``submit`` entry —
        host clock only). Request ids come from a lock-free
        counter (itertools.count — the submit path must not contend
        with the device loop's telemetry lock) unless the caller
        propagates one: a fleet request arrives with the ROUTER's
        globally unique ``r<pid>-<seq>`` id in the wire header, and
        adopting it is what joins this replica's spans to the router's
        in the offline merge (replica-local serving, with no id to
        adopt, mints its own)."""
        return RequestTrace(
            next(self._rid) if rid is None else rid,
            deadline_s, self.clock(),
        )

    def observe_completed(
        self,
        formed,
        *,
        latencies_s: list,
        overruns_s: list,
        step_s: float,
    ) -> None:
        """One completed batch from the device loop: ring, SLO, the
        slow-exemplar gate, and the anomaly triggers. Host bookkeeping
        only — the bounded exemplar dump is the single file
        write this path can take, capped at ``exemplar_max`` per run.
        """
        t0 = self._perf()
        now = self.clock()
        # Robust gates over the live window (the ledger fed it before
        # this call; median+MAD keeps a spike from raising its own
        # bar). Refreshed every GATE_REFRESH batches, not every batch —
        # the gate moves slowly and the two sorts it costs belong off
        # the per-batch path.
        window_n = 0
        if self._batches - self._gates_at >= self.GATE_REFRESH:
            lat_values = self.window.latency_values(now)
            window_n = len(lat_values)
            if window_n >= self.exemplar_min_history:
                med = _median(lat_values)
                mad = _mad(lat_values, med)
                self._lat_gate = med + self.exemplar_sigma * max(
                    MAD_SCALE * mad, 0.05 * abs(med), 1e-9
                )
            queue_vals = self.window.queue_values(now)
            if len(queue_vals) >= self.exemplar_min_history:
                qmed = _median(queue_vals)
                qmad = _mad(queue_vals, qmed)
                self._queue_gate = qmed + self.exemplar_sigma * max(
                    MAD_SCALE * qmad, 0.25 * abs(qmed), 1.0
                )
            self._gates_at = self._batches
            self._gate_window_n = window_n
        gate = self._lat_gate
        self.slo.observe_outcomes(
            sum(1 for v in overruns_s if v > 0.0), len(overruns_s), now
        )
        spiked = False
        records = []
        for request, latency_s, overrun_s in zip(
            formed.requests, latencies_s, overruns_s
        ):
            trace = getattr(request, "trace", None)
            if trace is None:
                continue
            rec = trace_record(
                trace,
                latency_s=latency_s,
                overrun_s=overrun_s,
                bucket=formed.bucket,
                batch_n=len(formed.requests),
            )
            slow = gate is not None and latency_s > gate
            rec["slow"] = slow
            spiked = spiked or slow
            records.append(rec)
            if slow:
                self._dump_exemplar(rec, gate, self._gate_window_n)
        with self._lock:
            for rec in records:
                self.ring.append(rec)
            self._batches += 1
            self._completed += len(latencies_s)
            batches = self._batches
        # Queue-depth anomaly: the current depth against the cached
        # robust gate (a backlog building faster than the drain can eat
        # it is the overload signature shedding is about to follow).
        queue_spiked = (
            self._queue_gate is not None
            and formed.queue_depth > self._queue_gate
        )
        if self.autoprof is not None:
            if spiked:
                self.autoprof.request("serve_p99_spike", batches)
            elif queue_spiked:
                self.autoprof.request("serve_queue_spike", batches)
            # Drive the capture window in batch units (serving's only
            # repeating boundary): starts an armed capture, stops a
            # finished one.
            self.autoprof.on_step(batches)
        with self._lock:
            self._overhead_s += self._perf() - t0

    def observe_shed(self, n: int = 1) -> None:
        """Admission rejects (queue full / deadline infeasible): SLO
        misses (a shed request did not hit its deadline). The window's
        shed count is fed by the ledger's ``observe_rejected`` forward
        — one window-observation path, no double counting."""
        self.slo.observe_outcomes(int(n), int(n), self.clock())
        with self._lock:
            self._shed += int(n)

    # ---------------------------------------------------------- exemplars

    def _dump_exemplar(self, rec: dict, gate_s: float, window_n: int):
        """Write one slow-request bundle (bounded: ``exemplar_max``)."""
        with self._lock:
            if (
                self.log_dir is None
                or len(self._exemplars) >= self.exemplar_max
            ):
                return
            seq = len(self._exemplars)
            # pid-stamped: seq and rid both restart per process, so
            # replicas/restarts sharing a log dir must not reclaim each
            # other's bundle names — earlier runs' exemplars stay on
            # disk.
            path = os.path.join(
                self.log_dir, "serve_traces",
                f"slow_{seq:04d}_req{rec['rid']}_p{os.getpid()}.json",
            )
            self._exemplars.append(path)
        bundle = dict(rec)
        # Cosmetic rounding happens HERE (bounded writes), not on the
        # per-request trace_record path.
        for key in ("deadline_ms", "latency_ms", "overrun_ms"):
            bundle[key] = round(bundle[key], 3)
        bundle["stamps"] = [(s, round(t, 6)) for s, t in bundle["stamps"]]
        bundle["stages_ms"] = {
            k: round(v, 3) for k, v in bundle["stages_ms"].items()
        }
        bundle["schema"] = SERVE_TELEMETRY_SCHEMA
        bundle["kind"] = "slow_exemplar"
        bundle["t_unix"] = round(self._wall(), 3)
        bundle["gate"] = {
            "sigma": self.exemplar_sigma,
            "threshold_ms": round(gate_s * 1e3, 3),
            "window_n": window_n,
        }
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(bundle, f, indent=2)
            os.replace(tmp, path)
        except OSError:
            with self._lock:
                self._exemplars.remove(path)

    # ---------------------------------------------------------- heartbeats

    def start(self) -> None:
        """Open the serving window and start the heartbeat thread."""
        self._t_start = self.clock()
        if self.writer is not None and self.heartbeat_secs > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name="serve-heartbeat",
                daemon=True,
            )
            self._hb_thread.start()

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_secs):
            self.serve_beat()

    def serve_beat(self) -> None:
        """Emit one ``kind=serve`` heartbeat line (host-only: every
        value is already host-side — window floats, batcher counters,
        the caching allocator's counters)."""
        if self.writer is None:
            return
        t0 = self._perf()
        now = self.clock()
        # One consistent counter snapshot: the heartbeat thread
        # reads what request threads write, and a beat catching requests
        # N with batches from N+1 is a torn line in the fleet record.
        with self._lock:
            completed = self._completed
            batches = self._batches
            shed = self._shed
            exemplars = len(self._exemplars)
        record: dict = {
            "up_s": (
                round(now - self._t_start, 3)
                if self._t_start is not None else None
            ),
            "requests": completed,
            "batches": batches,
            "shed": shed,
            "w": self.window.snapshot(now),
            "slo": self.slo.state(now),
            "exemplars": exemplars,
        }
        if self.dtype is not None:
            record["dtype"] = self.dtype
        # Measured capacity: top ladder rung / windowed per-batch step
        # (rows per second at full batches). Published only once the
        # window has a measured step — capacity is a measurement, not a
        # spec sheet (absent beats are skipped by the fold, not zeroed).
        step = record["w"].get("step_s_avg")
        if (
            self.max_batch
            and isinstance(step, (int, float))
            and step > 0
        ):
            record["capacity_rps"] = round(self.max_batch / step, 2)
        if self._queue_stats_fn is not None:
            try:
                qs = self._queue_stats_fn() or {}
                record["queued"] = qs.get("queued")
                record["inflight"] = qs.get("inflight")
                record["rejected"] = qs.get("rejected")
            except Exception:
                pass
        if self._hbm_fn is not None:
            try:
                hbm = self._hbm_fn()
                if hbm:
                    record.update(hbm)
            except Exception:
                pass
        if self._quality_fn is not None:
            # Quality fields: digest drift gates + probe fingerprint
            # state, folded at THIS beat cadence (never per request).
            # Inserted before
            # alerts.observe so the quality rules see them on the same
            # beat; the close() path reuses this, so the FINAL beat of
            # a stopping replica carries its last probe verdict — a
            # mismatch is on disk even if the replica dies right after.
            try:
                quality = self._quality_fn()
                if quality and (
                    quality.get("n") or quality.get("probe_runs")
                ):
                    record["quality"] = quality
            except Exception:
                pass
        if self.autoprof is not None:
            record["captures"] = len(self.autoprof.captures)
        if self.alerts is not None:
            # Rule evaluation rides the beat cadence (its one home, out
            # of the request paths);
            # active rule names stamp the line so a beat stream alone
            # shows what was firing when.
            try:
                self.alerts.observe(record, now=self._wall())
                active = self.alerts.active()
                if active:
                    record["alerts"] = active
            except Exception:
                pass  # a broken rule must not stop heartbeating
        appended = self.writer.serve_beat(record)
        with self._lock:
            # Count only beats actually appended — a dropped (lock
            # timeout) or post-close beat must not make the bench
            # line's heartbeat count exceed the lines on disk.
            if appended:
                self._heartbeats += 1
            self._overhead_s += self._perf() - t0

    # ------------------------------------------------------------ shutdown

    def close(self, outcome: str = "ok") -> dict:
        """Stop the heartbeat thread, emit one final beat, persist the
        span ring, and return the summary the engine stamps into the
        manifest. Idempotent."""
        if self._closed:
            return self.summary()
        self._closed = True
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        if self.writer is not None:
            self.serve_beat()
            self.writer.close(outcome)
        if self.alerts is not None:
            # An episode cannot outlive its emitter: the final beat
            # above was its last chance to resolve on data; whatever is
            # still firing resolves here (exactly one resolved event
            # per open episode — the once-per-episode contract).
            try:
                self.alerts.finalize(self._wall())
            except Exception:
                pass
        if self.autoprof is not None:
            try:
                self.autoprof.finalize(self._batches)
            except Exception:
                pass
        if self.log_dir is not None and len(self.ring):
            # Replica-namespaced like the heartbeat streams
            # (proc_<i>.jsonl): N replicas sharing a log dir must not
            # overwrite each other's ring. A RESTART of the same
            # replica does overwrite — the ring is "the last N
            # requests of replica i", newest state wins.
            proc = (
                getattr(self.writer, "process_index", 0)
                if self.writer is not None else 0
            )
            write_request_trace(
                os.path.join(
                    self.log_dir, "serve_traces",
                    f"requests_proc{proc}.trace.json.gz",
                ),
                self.ring.records(),
            )
        return self.summary()

    def summary(self) -> dict:
        with self._lock:
            out = {
                "schema": SERVE_TELEMETRY_SCHEMA,
                "requests": self._completed,
                "batches": self._batches,
                "shed": self._shed,
                "traced": self.ring.appended,
                "ring": len(self.ring),
                "exemplars": list(self._exemplars),
                "heartbeats": self._heartbeats,
                "overhead_s": round(self._overhead_s, 6),
            }
        out["slo"] = self.slo.state()
        out["window"] = self.window.snapshot()
        if self.autoprof is not None:
            out["autoprof"] = self.autoprof.stats()
        if self.alerts is not None:
            out["alerts"] = self.alerts.state()
        return out

    def stats(self) -> dict:
        """Flat gauge view (the <2% overhead guard reads overhead_s)."""
        with self._lock:
            return {
                "requests": float(self._completed),
                "batches": float(self._batches),
                "shed": float(self._shed),
                "exemplars": float(len(self._exemplars)),
                "heartbeats": float(self._heartbeats),
                "overhead_s": self._overhead_s,
            }


# -------------------------------------------------------- offline readers


def _serve_streams(
    log_dir: str, *, tail_bytes: Optional[int] = None
) -> tuple:
    """``(streams, finals)``: per-process ``kind=serve`` beats plus a
    per-process "closed" flag — the ONE filtering body behind
    :func:`read_serve_beats`, :func:`aggregate_serve` and the router's
    live view. ``finals[proc]`` is True only when the newest ``final``
    record is at least as new as the newest serve beat: the streams are
    append-only across restarts, so a final from a PREVIOUS process
    generation (a graceful stop before a pool restart) must not mark
    the freshly-beating replica as closed — that would down every
    replica of a reused log dir forever (same recency rule for the
    suspicion's "an orderly close is not a death" exemption)."""
    streams: dict = {}
    finals: dict = {}
    for proc, records in read_heartbeats(
        log_dir, tail_bytes=tail_bytes
    ).items():
        serve = [r for r in records if r.get("kind") == "serve"]
        if not serve:
            continue
        streams[proc] = serve
        last_final = max(
            (
                float(r.get("t", 0.0)) for r in records
                if r.get("kind") == "final"
            ),
            default=None,
        )
        finals[proc] = (
            last_final is not None
            and last_final >= float(serve[-1].get("t", 0.0))
        )
    return streams, finals


def read_serve_beats(log_dir: str) -> dict:
    """Per-process ``kind=serve`` heartbeat records from the fleet
    streams (``fleet/proc_*.jsonl`` — same files, same torn-tail
    discipline as training heartbeats)."""
    return _serve_streams(log_dir)[0]


def aggregate_serve(
    log_dir: str,
    *,
    max_timeline: int = 120,
    now: Optional[float] = None,
    suspect_factor: float = 3.0,
    tail_bytes: Optional[int] = None,
) -> dict:
    """Fold the serve heartbeat streams into the per-replica fleet view.

    This is a fleet router's input: per replica, the latest
    windowed p99 / queue depth / inflight / occupancy, plus SLO burn
    state — recomputable offline from artifacts alone (stdlib-only).

    Dead-replica suspicion rides the same summary (the flag
    ``aggregate_fleet`` carries for training streams, via the shared
    :func:`sav_tpu_torch.obs.fleet.silence_suspects` body): a
    replica silent for more than ``suspect_factor`` x the fleet median
    beat interval, with no final record, is listed in ``suspects`` and
    flagged ``suspect`` in its view — a SIGKILLed replica shows up as
    "replica 1 stopped heartbeating", not by vanishing from the view.
    A fleet router routes on EXACTLY this flag
    (:func:`router_views`). ``now`` defaults to the newest heartbeat
    across the fleet (offline semantics — wall clock would flag every
    replica of a finished run); the live router passes the wall clock
    (and a ``tail_bytes`` bound, so refreshing the view every half
    second never re-parses a long run's full history).
    """
    streams, finals = _serve_streams(log_dir, tail_bytes=tail_bytes)
    summary: dict = {
        "schema": SERVE_TELEMETRY_SCHEMA,
        "log_dir": log_dir,
        "replicas": {},
    }
    if not streams:
        return summary
    if now is None:
        now = max(
            float(b.get("t", 0.0)) for beats in streams.values()
            for b in beats
        )
    suspects = silence_suspects(
        {
            proc: [float(b.get("t", 0.0)) for b in beats]
            for proc, beats in streams.items()
        },
        finals,
        now=float(now),
        suspect_factor=suspect_factor,
    )
    suspect_procs = {s["proc"] for s in suspects}
    timeline = []
    for proc, beats in streams.items():
        last = beats[-1]
        w = last.get("w") or {}
        slo = last.get("slo") or {}
        p99s = [
            (b.get("w") or {}).get("p99_ms")
            for b in beats
            if isinstance((b.get("w") or {}).get("p99_ms"), (int, float))
        ]
        view = {
            "beats": len(beats),
            "first_unix": beats[0].get("t"),
            "last_unix": last.get("t"),
            "dtype": last.get("dtype"),
            "up_s": last.get("up_s"),
            "requests": last.get("requests"),
            "shed": last.get("shed"),
            "queued": last.get("queued"),
            "inflight": last.get("inflight"),
            "p99_ms": w.get("p99_ms"),
            "throughput_rps": w.get("throughput_rps"),
            "capacity_rps": last.get("capacity_rps"),
            "alerts": last.get("alerts") or [],
            "step_s_avg": w.get("step_s_avg"),
            "queue_depth": w.get("queue_depth_last"),
            "occupancy": w.get("occupancy"),
            "padding_waste_frac": w.get("padding_waste_frac"),
            "median_p99_ms": (
                round(_median(p99s), 3) if p99s else None
            ),
            "slo_hit_frac": slo.get("hit_frac"),
            "burn_rate": slo.get("burn_rate"),
            "burning": slo.get("burning"),
            "exemplars": last.get("exemplars"),
            "captures": last.get("captures"),
            "hbm_peak_bytes": last.get("hbm_peak_bytes"),
            # Quality fields: the last beat's digest gates + probe
            # verdict — absent on streams without them (readers skip,
            # never zero-fill).
            "quality": last.get("quality"),
            "pid": last.get("pid"),
            "final": bool(finals.get(proc)),
            "suspect": proc in suspect_procs,
        }
        summary["replicas"][str(proc)] = view
        for b in beats:
            bw = b.get("w") or {}
            timeline.append({
                "t": b.get("t"),
                "proc": proc,
                "p99_ms": bw.get("p99_ms"),
                "queue": bw.get("queue_depth_last"),
                "rps": bw.get("throughput_rps"),
            })
    timeline.sort(key=lambda e: (e.get("t") or 0.0, e.get("proc") or 0))
    if len(timeline) > max_timeline:
        stride = -(-len(timeline) // max_timeline)
        timeline = timeline[::stride] + timeline[-1:]
    summary["timeline"] = timeline
    replicas = summary["replicas"].values()
    rps = [
        v["throughput_rps"] for v in replicas
        if isinstance(v.get("throughput_rps"), (int, float))
    ]
    p99 = [
        v["p99_ms"] for v in replicas
        if isinstance(v.get("p99_ms"), (int, float))
    ]
    summary["suspects"] = suspects
    summary["fleet"] = {
        "replicas": len(summary["replicas"]),
        "throughput_rps": round(sum(rps), 2) if rps else None,
        "worst_p99_ms": max(p99) if p99 else None,
        "burning": sorted(
            int(p) for p, v in summary["replicas"].items() if v.get("burning")
        ),
        "suspects": sorted(s["proc"] for s in suspects),
        "alerts": sorted({
            name for v in replicas for name in (v.get("alerts") or [])
        }),
    }
    # Fleet probe verdict: the WORST replica's probe_ok_frac
    # — one corrupt replica must not hide behind healthy peers. Skipped
    # (not zero-filled) when no replica ran a probe.
    probe_ok = [
        (v.get("quality") or {}).get("probe_ok_frac") for v in replicas
    ]
    probe_ok = [p for p in probe_ok if isinstance(p, (int, float))]
    if probe_ok:
        summary["fleet"]["probe_ok_frac"] = round(min(probe_ok), 6)
    _fold_capacity(summary, log_dir)
    return summary


#: Projection horizon for the headroom fold: one fast SLO window ahead
#: — far enough that a building ramp shows, near enough that the
#: Theil–Sen slope over the finest rollup tier is still predictive.
HEADROOM_HORIZON_S = 60.0


def _fold_capacity(summary: dict, log_dir: str) -> None:
    """The capacity/headroom fold on ``summary["fleet"]``:

    - ``capacity_rps``: sum of the replicas' measured ``capacity_rps``
      stamps (absent stamps are SKIPPED, not zero-filled — capacity is
      a measurement; a fleet with no measured replica has no capacity
      number and therefore no headroom number).
    - ``projected_rps``: robust-slope projection of fleet throughput
      over the finest rollup tier (:func:`sav_tpu_torch.obs.rollup
      .project_load` — Theil–Sen, so one straggling bucket cannot bend
      the forecast), falling back to the beat timeline when nothing has
      been rolled yet.
    - ``headroom_frac``: ``(capacity - projected) / capacity``, clamped
      to [-1, 1] — an autoscaler's or weighted router's input.
    """
    fleet = summary["fleet"]
    replicas = summary["replicas"].values()
    capacity = [
        v["capacity_rps"] for v in replicas
        if isinstance(v.get("capacity_rps"), (int, float))
    ]
    if not capacity or sum(capacity) <= 0:
        return
    fleet["capacity_rps"] = round(sum(capacity), 2)
    points = []
    try:
        res, lines = rollup_mod.finest_rollup(log_dir)
        if res is not None:
            points = [
                (t, v)
                for t, v in rollup_mod.series(lines, "throughput_rps")
            ]
    except Exception:
        points = []
    if not points:
        # Nothing rolled yet: the beat timeline carries per-replica rps
        # at beat cadence; sum per timestamp bucket (1s) as a stand-in.
        per_t: dict = {}
        for entry in summary.get("timeline") or []:
            t, v = entry.get("t"), entry.get("rps")
            if isinstance(t, (int, float)) and isinstance(v, (int, float)):
                per_t[int(t)] = per_t.get(int(t), 0.0) + float(v)
        points = sorted(per_t.items())
    projection = rollup_mod.project_load(
        points, horizon_s=HEADROOM_HORIZON_S
    )
    if projection is None:
        return
    fleet["load_rps"] = projection["now_rps"]
    fleet["load_slope_rps_per_s"] = projection["slope_rps_per_s"]
    fleet["projected_rps"] = projection["projected_rps"]
    raw = (fleet["capacity_rps"] - projection["projected_rps"]) / (
        fleet["capacity_rps"]
    )
    fleet["headroom_frac"] = round(max(min(raw, 1.0), -1.0), 4)


#: Default per-stream read bound for the LIVE router view: enough for
#: hours of beats at the default cadence, constant-cost per refresh.
ROUTER_VIEW_TAIL_BYTES = 256 * 1024


def router_views(
    log_dir: str,
    *,
    now: Optional[float] = None,
    suspect_factor: float = 3.0,
    tail_bytes: Optional[int] = ROUTER_VIEW_TAIL_BYTES,
) -> dict:
    """The fleet router's live per-replica view (``Router.views_fn``):
    queue depth / inflight / measured per-batch step / windowed p99 /
    beat recency / dead suspicion, read from the same ``kind=serve``
    heartbeat streams ``aggregate_serve`` folds offline — the router
    balances on the numbers the offline tools render, by construction.
    ``now`` defaults to the wall clock (live semantics: a replica that
    stopped beating IS suspect, unlike the offline default). Reads are
    tail-bounded by default: a long-lived router refreshes up to every
    half second, and re-parsing the full history each time would grow
    routing cost with run age (``tail_bytes=None`` = full read)."""
    now = time.time() if now is None else float(now)
    summary = aggregate_serve(
        log_dir, now=now, suspect_factor=suspect_factor, max_timeline=1,
        tail_bytes=tail_bytes,
    )
    views = {}
    for proc, v in (summary.get("replicas") or {}).items():
        step = v.get("step_s_avg")
        views[int(proc)] = {
            "queued": v.get("queued"),
            "inflight": v.get("inflight"),
            "est_step_s": (
                float(step) if isinstance(step, (int, float)) else None
            ),
            "p99_ms": v.get("p99_ms"),
            "last_beat_unix": v.get("last_unix"),
            "beats": v.get("beats"),
            "final": v.get("final"),
            "suspect": v.get("suspect"),
            # Replica dtype stamp: the router's shadow
            # scorer keys its tolerance envelope on the (primary,
            # shadow) dtype pair it reads from here.
            "dtype": v.get("dtype"),
            "pid": v.get("pid"),
        }
    return views


def find_exemplars(log_dir: str) -> list:
    """The slow-request exemplar index under ``serve_traces/`` (newest
    last; torn/unreadable bundles skipped)."""
    root = os.path.join(log_dir, "serve_traces")
    out = []
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        if not (name.startswith("slow_") and name.endswith(".json")):
            continue
        path = os.path.join(root, name)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        doc["path"] = path
        out.append(doc)
    return out


def find_serve_manifests(log_dir: str) -> list:
    """Finalized-or-live ``kind=serve`` manifests in a log dir."""
    out = []
    for path, doc in iter_manifests(log_dir):
        if doc.get("kind") == "serve":
            doc["path"] = path
            out.append(doc)
    return out
