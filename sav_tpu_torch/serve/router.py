"""Wait-aware fleet router: admit, balance, drain, fail over.

Port of ``sav_tpu/serve/router.py``. One
:class:`~sav_tpu_torch.serve.engine.ServeEngine` is one process on one card;
horizontal capacity is N engine replicas behind a router that spreads load
by where it will actually finish soonest. This module is that router,
deliberately **stdlib-only** (no torch, no numpy — the structural proof,
like the batcher's, that routing cannot sync a device value; the router
typically runs in the pool's parent process, which must never be hangable
by a backend import, the supervisor's philosophy).

Routing policy — **projected dispatch wait**, not round robin: each
replica's live ``kind=serve`` heartbeat
(:mod:`sav_tpu_torch.serve.telemetry`) carries its queue depth, in-flight
batch count, and measured per-batch step time; the router projects what a
new request would wait at each replica with the SAME arithmetic the
batcher uses for its admission shed (:func:`projected_wait_s` — batches
ahead x estimated step), adds the requests it has itself routed there
since the last heartbeat (heartbeats are cadenced; the router's own
outstanding count fills the staleness gap), and picks the minimum. A fleet
whose *best* projected wait already blows the deadline sheds at admission
(:class:`~sav_tpu_torch.serve.batcher.DeadlineInfeasibleError`) — the
batcher's "never serve a guaranteed miss" contract, lifted fleet-wide.

Replica lifecycle the router tracks:

- **active** — routable.
- **draining** — the leave-one-out straggler attribution
  (:func:`sav_tpu_torch.obs.fleet._loo_scores`, here on windowed p99)
  flagged the replica: no NEW requests are routed to it, its in-flight
  work finishes normally, and it resumes the moment the attribution
  unflags it. The router never drains the last active replica —
  degraded capacity beats none. A shadow rank (which takes no routed
  traffic) is left out of both the attribution and that count; in
  ``sav_tpu``'s router it is in both, so a live replica slower than an
  idle shadow is drained and nothing is left to route to.
- **down** — a transport failure (connection refused/reset: the process
  died mid-request) or heartbeat-silence suspicion
  (:func:`sav_tpu_torch.obs.fleet.silence_suspects` — the same flag
  ``aggregate_serve`` renders) marks the replica dead. Requests in flight
  to it come back as transport errors and are REROUTED to a healthy
  replica while their deadline still stands — rerouted or honestly shed,
  never silently lost. Recovery is a fresh heartbeat newer than the down
  mark (the supervisor restarts the process; its first beat folds it
  back in).

Distributed tracing: the router mints a globally unique trace id per
admitted request (``r<pid>-<seq>``) and stamps its own lifecycle with the
same stdlib :func:`~sav_tpu_torch.serve.telemetry.stamp` machinery the
replicas use — ``submit -> admit -> route_selected -> connect -> sent ->
reply -> completed`` in the ROUTER's clock domain, one sub-span per
reroute/retry attempt, and honest terminal stamps for shed/failed. The id
rides the wire header (``meta["trace"]``); the replica's ``begin_trace``
adopts it, so the two clock domains join by id offline. Completed router
traces land in a bounded :class:`~sav_tpu_torch.serve.telemetry.SpanRing`
exported at close; live per-stage windows feed ``kind=router`` heartbeats
(``fleet/router.jsonl``).

The hot functions (``admit`` / ``route`` / ``note_result`` /
``_refresh_views`` / ``drain`` / ``resume``) and the trace surface
(``_dispatch`` / ``_route_with_waits`` / ``_observe_completion`` /
``router_beat``) read and write host values only: a device sync anywhere in
the routing or tracing path would serialize every request in the fleet
behind one pipeline drain.
"""

from __future__ import annotations

import itertools
import json
import os
import queue as _queue_mod
import threading
import time
from typing import Any, Callable, Optional

from sav_tpu_torch.obs.fleet import HeartbeatWriter, _loo_scores
from sav_tpu_torch.serve.batcher import (
    DeadlineInfeasibleError,
    QueueFullError,
    ServeClosedError,
    ServeFuture,
)
from sav_tpu_torch.serve.telemetry import (
    ROUTER_INTERVALS,
    RequestTrace,
    SlidingWindow,
    SpanRing,
    dominant_stage,
    intervals,
    stamp,
    write_request_trace,
)

ROUTER_SCHEMA = 1


def _round3(v: Optional[float]) -> Optional[float]:
    return round(v, 3) if isinstance(v, (int, float)) else None

#: Replica states.
ACTIVE = "active"
DRAINING = "draining"
DOWN = "down"


class ReplicaTransportError(RuntimeError):
    """The transport could not complete the exchange (connection
    refused/reset, torn reply): the replica process is gone or going.
    The router marks the replica down and REROUTES the request."""


class ReplicaShedError(QueueFullError):
    """The replica itself shed the request (its admission control
    rejected it). Retried elsewhere/later while the deadline stands."""


class RouterShedError(QueueFullError):
    """No replica could serve the request before its deadline — the
    router's honest shed (set on the future; never a silent drop)."""


def projected_wait_s(
    *,
    queued: int,
    inflight: int,
    fresh_outstanding: int,
    max_batch: int,
    est_step_s: float,
) -> float:
    """Projected dispatch wait at one replica, in the batcher's own
    arithmetic (sav_tpu/serve/batcher.py submit): the batches already
    drained-but-not-completed (``inflight``) plus the full batches the
    queue ahead would form — ``queued`` from the replica's last
    heartbeat plus ``fresh_outstanding``, the requests this router has
    sent since that heartbeat (cadenced beats are stale; the router's
    own ledger fills the gap) — each one estimated step. The ``+
    max_batch`` inside the ceiling counts the batch this request itself
    would ride, exactly like the batcher's ``(qsize + max_batch) //
    max_batch``."""
    max_batch = max(int(max_batch), 1)
    batches_ahead = max(int(inflight), 0) + (
        (max(int(queued), 0) + max(int(fresh_outstanding), 0) + max_batch)
        // max_batch
    )
    return batches_ahead * max(float(est_step_s), 0.0)


class _Replica:
    """Router-side live state for one replica (owner locks)."""

    __slots__ = (
        "rank", "state", "queued", "inflight", "est_step_s", "p99_ms",
        "last_beat_unix", "beats", "final", "pid", "sends", "routed",
        "completed", "failures", "down_since_unix", "down_reason",
        "drained_at_unix", "drain_auto", "dtype",
    )

    def __init__(self, rank: int):
        self.rank = rank
        self.state = ACTIVE
        self.queued = 0
        self.inflight = 0
        self.est_step_s: Optional[float] = None
        self.p99_ms: Optional[float] = None
        self.last_beat_unix: Optional[float] = None
        self.beats = 0
        self.final = False
        self.pid: Optional[int] = None
        # Weight-serving dtype stamp from the replica's heartbeats
        #: the shadow scorer keys its tolerance envelope on
        # the (primary, shadow) dtype pair.
        self.dtype: Optional[str] = None
        # In-flight sends: job id -> wall stamp (fresh_outstanding =
        # sends newer than the replica's last heartbeat).
        self.sends: dict = {}
        self.routed = 0
        self.completed = 0
        self.failures = 0
        self.down_since_unix: Optional[float] = None
        self.down_reason: Optional[str] = None
        self.drained_at_unix: Optional[float] = None
        self.drain_auto = False

    def fresh_outstanding(self) -> int:
        beat_t = self.last_beat_unix
        if beat_t is None:
            return len(self.sends)
        return sum(1 for t in self.sends.values() if t > beat_t)

    def view(self) -> dict:
        return {
            "rank": self.rank,
            "state": self.state,
            "queued": self.queued,
            "inflight": self.inflight,
            "outstanding": len(self.sends),
            "est_step_s": self.est_step_s,
            "p99_ms": self.p99_ms,
            "last_beat_unix": self.last_beat_unix,
            "beats": self.beats,
            "routed": self.routed,
            "completed": self.completed,
            "failures": self.failures,
            "down_reason": self.down_reason,
            "dtype": self.dtype,
        }


class _Job:
    __slots__ = (
        "jid", "payload", "meta", "deadline_t", "admit_t", "future",
        "trace", "attempts", "waits", "shadow",
    )

    def __init__(self, jid, payload, meta, deadline_t, admit_t, future):
        self.jid = jid
        self.payload = payload
        self.meta = meta
        self.deadline_t = deadline_t
        self.admit_t = admit_t
        self.future = future
        # Tracing: the per-request RequestTrace (router clock domain),
        # the per-attempt sub-span ledger, and the candidate projected
        # waits the first route decision saw (ms, keyed by rank).
        self.trace: Optional[RequestTrace] = None
        self.attempts: list = []
        self.waits: Optional[dict] = None
        # Shadow sampling mark: set at admit (deterministic
        # 1-in-N), mirrors the completed request to the shadow replica.
        self.shadow = False


_STOP = object()

# Dispatch workers poll their queue at this cadence so a torn-down
# router can never strand one (see Router._worker).
_WORKER_POLL_S = 1.0

#: Bound on queued shadow mirrors: a slow shadow replica
#: sheds its own sampled traffic (``shadow.shed``) instead of growing
#: an unbounded payload backlog in the router — shed-before-
#: primary-impact, the probe's contract on the router side.
SHADOW_QUEUE_DEPTH = 64

#: Wire timeout for one shadow mirror: generous (the shadow is off the
#: latency path), but bounded so a wedged shadow replica cannot pin the
#: shadow worker forever.
SHADOW_SEND_TIMEOUT_S = 10.0

#: Per-mirror request deadline (ms). The mirror is usually the ONLY
#: row in the otherwise-idle shadow replica's batcher, and inheriting a
#: live-traffic deadline would let the batcher hold it for seconds of
#: bucket-fill slack per sample — one mirror scored per drain instead
#: of dozens. A short deadline ships the batch-of-1 promptly; if the
#: shadow replica is genuinely busy the sample sheds (report-only),
#: never a live request.
SHADOW_MIRROR_DEADLINE_MS = 250.0


class Router:
    """Admission + load balancing over a serve replica fleet.

    Args:
      transport: the wire to the replicas —
        ``send(rank, payload, meta, timeout_s) -> dict`` (raising
        :class:`ReplicaTransportError` on a dead connection and
        :class:`ReplicaShedError` on a replica-side admission reject).
        :class:`sav_tpu_torch.serve.fleet.TcpTransport` is the production
        implementation; tests inject fakes.
      views_fn: ``() -> {rank: view}`` — the per-replica live view
        (:func:`sav_tpu_torch.serve.telemetry.router_views` reads it from the
        ``kind=serve`` heartbeat streams). Each view carries ``queued``
        / ``inflight`` / ``est_step_s`` / ``p99_ms`` /
        ``last_beat_unix`` / ``beats`` / ``final`` / ``suspect``.
      max_batch: the replicas' top bucket (the projection's batch unit).
      default_step_s: per-batch step estimate before the first heartbeat
        carries a measured one.
      default_deadline_s / max_inflight: admission knobs (the fleet
        twins of the batcher's ``default_deadline_s`` / ``max_queue``).
      refresh_secs: heartbeat-view refresh cadence (admission and the
        dispatch loop refresh at most this often).
      straggler_k / straggler_rel_floor / straggler_min_beats: the
        leave-one-out p99 drain gate (conservative by default — with a
        2-replica fleet the LOO baseline is a single value, so the
        relative floor alone separates "slower" from "straggling").
      ranks: the expected fleet roster — pre-seeds the routing table
        (active, no data) so replicas are routable from the first
        request, BEFORE their first heartbeat lands (a fresh fleet's
        beats are cadenced; waiting for them would funnel the whole
        warmup flood at whichever replica beat first). None = discover
        from heartbeats alone.
      workers: dispatch worker threads. ``0`` = synchronous mode —
        ``admit`` dispatches inline and blocks until the request
        completes or sheds (deterministic unit tests; single-threaded
        callers).
      clock / wall_clock / sleep: injectable for fake-clock tests.
      log_dir: when set, ``close()`` writes the router summary to
        ``<log_dir>/fleet/router.json`` for offline readers, exports
        the router span ring to
        ``<log_dir>/serve_traces/requests_router.trace.json.gz``, and
        (with ``heartbeat_secs > 0``) streams ``kind=router``
        heartbeats to ``<log_dir>/fleet/router.jsonl``.
      trace_depth: span-ring depth for completed/terminal request
        traces (old spans roll off, admission never
        blocks on telemetry).
      heartbeat_secs: ``kind=router`` heartbeat cadence; ``0`` (the
        default) disables the heartbeat thread.
      window_s: sliding-window span for the live latency / per-stage
        attribution the heartbeats and mid-run ``summary()`` carry.
      perf: the overhead meter (``time.perf_counter``) — tracing cost
        is self-accounted exactly like the engine telemetry and
        surfaced as ``router_overhead_ms`` per completed request.
      shadow_rank / shadow_frac: shadow agreement scoring: mirror a deterministic ``shadow_frac``
        sample of completed requests to replica ``shadow_rank``
        (excluded from normal routing) and score top-1 agreement +
        logit drift per (primary_dtype, shadow_dtype) pair.
        Report-only — scoring runs on a dedicated worker thread off
        the latency path and sheds before impacting live traffic.
    """

    _POLL_S = 0.02  # no-routable-replica retry cadence inside dispatch

    def __init__(
        self,
        transport,
        *,
        views_fn: Callable[[], dict],
        max_batch: int = 8,
        default_step_s: float = 0.05,
        default_deadline_s: float = 1.0,
        max_inflight: int = 256,
        refresh_secs: float = 0.5,
        suspect_factor: float = 3.0,
        straggler_k: float = 3.5,
        straggler_rel_floor: float = 1.0,
        straggler_min_beats: int = 3,
        ranks=None,
        workers: int = 8,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        log_dir: Optional[str] = None,
        trace_depth: int = 256,
        heartbeat_secs: float = 0.0,
        window_s: float = 30.0,
        perf: Callable[[], float] = time.perf_counter,
        shadow_rank: Optional[int] = None,
        shadow_frac: float = 0.05,
    ):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if default_deadline_s <= 0:
            raise ValueError(
                f"default_deadline_s must be > 0, got {default_deadline_s}"
            )
        if shadow_rank is not None and not 0.0 < float(shadow_frac) <= 1.0:
            raise ValueError(
                f"shadow_frac must be in (0, 1], got {shadow_frac}"
            )
        self._transport = transport
        self._views_fn = views_fn
        self.max_batch = int(max_batch)
        self.default_step_s = float(default_step_s)
        self.default_deadline_s = float(default_deadline_s)
        self.max_inflight = int(max_inflight)
        self.refresh_secs = float(refresh_secs)
        self.suspect_factor = float(suspect_factor)
        self.straggler_k = float(straggler_k)
        self.straggler_rel_floor = float(straggler_rel_floor)
        self.straggler_min_beats = int(straggler_min_beats)
        self.log_dir = log_dir
        self._clock = clock
        self._wall = wall_clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._replicas: dict[int, _Replica] = {}
        self._closed = threading.Event()
        self._jid = 0
        self._inflight_total = 0
        self._last_refresh: Optional[float] = None
        self._t_start = clock()
        self._first_admit_t: Optional[float] = None
        self._last_complete_t: Optional[float] = None
        self._latencies_s: list = []
        self._completed = 0
        self._rejected = 0
        self._shed_admit = 0
        self._shed_deadline = 0
        self._rerouted = 0
        self._transport_failures = 0
        self._errors = 0
        self._down_flaps = 0
        # Tracing state: globally unique ids (r<pid>-<seq>),
        # a bounded span ring of terminal traces, live latency /
        # per-stage sliding windows, and the self-accounted overhead
        # meter behind router_overhead_ms.
        self._pid = os.getpid()
        self._trace_seq = itertools.count()
        self._perf = perf
        self.window_s = float(window_s)
        self._ring = SpanRing(depth=int(trace_depth))
        self._lat_window = SlidingWindow(self.window_s, clock=clock)
        self._stage_windows: dict[str, SlidingWindow] = {}
        self._overhead_s = 0.0
        self.heartbeat_secs = float(heartbeat_secs)
        self._hb_writer = None
        self._hb_thread = None
        self._roller = None
        self._last_roll = None
        if log_dir:
            self._hb_writer = HeartbeatWriter(
                log_dir, process_index=0, stream="router",
                clock=wall_clock,
            )
            if self.heartbeat_secs > 0:
                # The router owns the fleet's rollup ladder: one
                # single-writer Roller per run, ticked from the
                # heartbeat thread — never from request paths
                #, never from replica processes (cursor is
                # single-writer).
                try:
                    from sav_tpu_torch.obs.rollup import Roller

                    self._roller = Roller(log_dir)
                except Exception:
                    self._roller = None
        # Shadow agreement scoring: the
        # designated shadow rank is EXCLUDED from normal routing; a
        # deterministic 1-in-round(1/frac) sample of completed requests
        # is mirrored to it from a dedicated worker thread (report-only
        # — scoring never rides admit/route/_dispatch), scored
        # per (primary_dtype, shadow_dtype) pair, and shed before it
        # could ever back-pressure live traffic (bounded queue).
        self.shadow_rank = int(shadow_rank) if shadow_rank is not None else None
        self.shadow_frac = float(shadow_frac)
        self._shadow_scorer = None
        self._shadow_queue: Any = None
        self._shadow_thread: Optional[threading.Thread] = None
        self._shadow_every = 0
        self._shadow_alerts = None
        if self.shadow_rank is not None:
            from sav_tpu_torch.obs.quality import AgreementScorer

            self._shadow_scorer = AgreementScorer()
            self._shadow_every = max(1, round(1.0 / self.shadow_frac))
            self._shadow_queue = _queue_mod.Queue(maxsize=SHADOW_QUEUE_DEPTH)
            if self._hb_writer is not None:
                # Quality rules ONLY: the router beat carries w.p99_ms,
                # and arming the SLO/env rules here would double-fire
                # episodes the replicas already own.
                from sav_tpu_torch.obs import alerts as alerts_mod

                self._shadow_alerts = alerts_mod.AlertEngine(
                    alerts_mod.quality_rules(),
                    log_dir=log_dir,
                    proc="router",
                    clock=wall_clock,
                )
        for rank in (ranks or ()):
            self._replicas[int(rank)] = _Replica(int(rank))
        self._refresh_views()  # seed the table before the first admit
        self._jobs: Any = _queue_mod.Queue()
        self._workers = []
        for i in range(int(workers)):
            t = threading.Thread(
                target=self._worker, name=f"router-dispatch-{i}", daemon=True
            )
            t.start()
            self._workers.append(t)
        if self._shadow_queue is not None:
            self._shadow_thread = threading.Thread(
                target=self._shadow_worker, name="router-shadow", daemon=True
            )
            self._shadow_thread.start()
        if self._hb_writer is not None and self.heartbeat_secs > 0:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, name="router-heartbeat", daemon=True
            )
            self._hb_thread.start()

    # ----------------------------------------------------------- admission

    def admit(
        self,
        payload: Any,
        *,
        deadline_s: Optional[float] = None,
        meta: Optional[dict] = None,
    ) -> ServeFuture:
        """Admit one request into the fleet; returns its future.

        Sheds at admission (:class:`DeadlineInfeasibleError`) when even
        the BEST replica's projected dispatch wait blows the deadline —
        the batcher's guaranteed-miss contract, fleet-wide — and
        rejects (:class:`QueueFullError`) past ``max_inflight``. Both
        reject shapes subclass :class:`QueueFullError`, like the
        batcher's. Host bookkeeping only."""
        if self._closed.is_set():
            raise ServeClosedError("router is closed")
        deadline_s = (
            float(deadline_s) if deadline_s is not None
            else self.default_deadline_s
        )
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        t_entry = self._clock()  # the trace's "submit" instant
        self._maybe_refresh()
        # Capacity check, shed projection, and the inflight increment in
        # ONE critical section: a check in a separate lock acquisition
        # would let N concurrent admitters all pass at capacity-1 and
        # overshoot the bound by the caller thread count.
        with self._lock:
            if self._inflight_total >= self.max_inflight:
                self._rejected += 1
                raise QueueFullError(
                    f"router at capacity ({self.max_inflight} in flight); "
                    "shed load or raise max_inflight"
                )
            waits = [
                self._projected_wait(r)
                for r in self._replicas.values()
                if r.state == ACTIVE and r.rank != self.shadow_rank
            ]
            if waits and min(waits) > deadline_s:
                self._shed_admit += 1
                raise DeadlineInfeasibleError(
                    f"best projected dispatch wait {min(waits):.3f}s across "
                    f"{len(waits)} active replica(s) exceeds the "
                    f"{deadline_s:.3f}s deadline; shedding instead of "
                    "serving a guaranteed miss"
                )
            self._jid += 1
            now = self._clock()
            if self._first_admit_t is None:
                self._first_admit_t = now
            job = _Job(
                self._jid, payload, dict(meta or {}),
                now + deadline_s, now, ServeFuture(),
            )
            # Mint the fleet-global trace id and stamp submit/admit in
            # the router's clock domain; the id rides the wire header
            # (meta["trace"]) so the replica's begin_trace adopts it.
            t0 = self._perf()
            rid = f"r{self._pid}-{next(self._trace_seq)}"
            job.trace = RequestTrace(rid, deadline_s, t_entry)
            stamp(job.trace, "admit", now)
            job.meta["trace"] = rid
            if self._shadow_every and self._jid % self._shadow_every == 0:
                # Deterministic 1-in-N sampling (a counter, not a RNG —
                # reproducible benches): the PRIMARY exchange asks for
                # logits so the scorer can judge drift, not just top-1.
                # Integer bookkeeping only — the scoring itself happens
                # on the shadow worker thread.
                job.shadow = True
                job.meta["want_logits"] = True
            self._overhead_s += self._perf() - t0
            self._inflight_total += 1
        if self._workers:
            self._jobs.put(job)
            if self._closed.is_set():
                # close() can finish draining the queue and stopping
                # the workers between this thread's entry check and the
                # put above; the job would then sit in a queue nothing
                # will ever drain, stranding result() forever. Re-run
                # the fail pass (the batcher's submit/close
                # TOCTOU fix, same shape) — any job still queued after
                # close must fail anyway.
                self._fail_queued_jobs()
        else:
            self._dispatch(job)  # synchronous mode: block until resolved
        return job.future

    def _projected_wait(self, replica: _Replica) -> float:
        est = replica.est_step_s
        if est is None:
            # No measured step yet (fresh replica / just restarted):
            # be OPTIMISTIC — assume the best measured step in the
            # fleet, so the unknown replica gets traffic and its
            # estimate gets measured. A pessimistic default would
            # repel traffic forever: no traffic, no measurement, no
            # recovery from the default (the fold-back deadlock).
            known = [
                r.est_step_s for r in self._replicas.values()
                if r.est_step_s is not None
            ]
            est = min(known) if known else self.default_step_s
        return projected_wait_s(
            queued=replica.queued,
            inflight=replica.inflight,
            fresh_outstanding=replica.fresh_outstanding(),
            max_batch=self.max_batch,
            est_step_s=est,
        )

    def route(self) -> Optional[int]:
        """The replica a new request should go to: minimum projected
        dispatch wait among ACTIVE replicas (ties break to the lowest
        rank — deterministic), or None when nothing is routable (all
        down/draining — the dispatch loop polls for recovery until the
        deadline). Host arithmetic only."""
        rank, _ = self._route_with_waits()
        return rank

    def _route_with_waits(self) -> tuple:
        """:meth:`route` plus the full candidate wait table the decision
        saw — ``(best_rank, {rank: projected_wait_s})`` — so the trace's
        ``route_selected`` span can carry WHY this replica won (the
        Tail-at-Scale attribution input). Same lock discipline and host
        arithmetic as route()."""
        with self._lock:
            best = None
            best_wait = None
            waits: dict = {}
            for rank in sorted(self._replicas):
                replica = self._replicas[rank]
                if replica.state != ACTIVE or rank == self.shadow_rank:
                    # The shadow replica only sees mirrored traffic —
                    # routing live load at it would make its agreement
                    # window judge a double-loaded replica.
                    continue
                wait = self._projected_wait(replica)
                waits[rank] = wait
                if best_wait is None or wait < best_wait:
                    best, best_wait = rank, wait
            return best, waits

    # ------------------------------------------------------------ dispatch

    def _worker(self) -> None:
        # Bounded get: close() posts one _STOP per worker, but a
        # close() that dies mid-teardown must not strand a worker blocked
        # forever — each timeout re-checks the closed flag and exits.
        while True:
            try:
                job = self._jobs.get(timeout=_WORKER_POLL_S)
            except _queue_mod.Empty:
                if self._closed.is_set():
                    return
                continue
            if job is _STOP:
                return
            self._dispatch(job)

    def _dispatch(self, job: _Job) -> None:
        """Route one admitted request until it completes, sheds, or the
        router closes: send to the best replica; a transport failure
        marks the replica down and REROUTES while the deadline stands
        (never silently lost); a replica-side shed retries as capacity
        frees; past the deadline the future fails with
        :class:`RouterShedError` — the honest shed. Stamps the trace
        lifecycle (route_selected/connect/sent/reply/completed plus one
        sub-span per attempt) along the way — host stamps only."""
        trace = job.trace
        try:
            while True:
                if self._closed.is_set():
                    job.future.set_exception(
                        ServeClosedError("router closed with this request "
                                         "in flight")
                    )
                    self._observe_completion(job, rank=None, outcome="failed")
                    return
                # Keep the view fresh on the dispatch path too: under a
                # flood, admissions stop long before dispatch does, and
                # a router working a whole drain on its admission-time
                # view would never see queues build or replicas die.
                self._maybe_refresh()
                remaining = job.deadline_t - self._clock()
                if remaining <= 0:
                    with self._lock:
                        self._shed_deadline += 1
                    job.future.set_exception(RouterShedError(
                        "no replica could serve this request before its "
                        "deadline (rerouted/retried until the budget ran "
                        "out) — shed, not silently dropped"
                    ))
                    self._observe_completion(job, rank=None, outcome="shed")
                    return
                rank, waits = self._route_with_waits()
                if rank is None:
                    self._sleep(min(self._POLL_S, remaining))
                    self._maybe_refresh()
                    continue
                t_selected = self._clock()
                # First stamp wins in intervals() — a reroute's second
                # route_selected leaves the original span intact; the
                # per-attempt ledger carries the retries.
                stamp(trace, "route_selected", t_selected)
                if job.waits is None:
                    job.waits = {
                        int(r): round(w * 1e3, 3) for r, w in waits.items()
                    }
                attempt = {"rank": int(rank), "t_start": t_selected}
                job.attempts.append(attempt)
                with self._lock:
                    replica = self._replicas.get(rank)
                    if replica is None:
                        continue
                    replica.routed += 1
                    replica.sends[job.jid] = self._wall()
                # Transport stamp seam: a stamp-aware transport (the
                # production TcpTransport) stamps connect/sent at the
                # real socket instants; a plain transport degrades to
                # stamping both at the pre-send instant so the chain
                # stays contiguous (transport_send collapses to ~0 and
                # the whole exchange lands in replica_wait).
                stamp_fn = None
                if trace is not None:
                    if getattr(self._transport, "supports_stamps", False):
                        clock = self._clock
                        stamp_fn = lambda name, _t=trace: (  # noqa: E731
                            stamp(_t, name, clock())
                        )
                    else:
                        t_pre = self._clock()
                        stamp(trace, "connect", t_pre)
                        stamp(trace, "sent", t_pre)
                try:
                    if stamp_fn is not None:
                        result = self._transport.send(
                            rank, job.payload, job.meta, remaining,
                            stamp_fn=stamp_fn,
                        )
                    else:
                        result = self._transport.send(
                            rank, job.payload, job.meta, remaining
                        )
                except ReplicaShedError:
                    attempt["t_end"] = self._clock()
                    attempt["outcome"] = "replica_shed"
                    self.note_result(rank, job.jid, ok=False)
                    # The replica's own admission control is loaded:
                    # back off briefly and retry (here or elsewhere)
                    # while the deadline stands.
                    self._sleep(min(self._POLL_S, remaining))
                    self._maybe_refresh()
                    continue
                except ReplicaTransportError as e:
                    attempt["t_end"] = self._clock()
                    attempt["outcome"] = "transport_error"
                    self.note_result(rank, job.jid, ok=False)
                    with self._lock:
                        self._transport_failures += 1
                        self._rerouted += 1
                    self._mark_down(rank, reason=f"transport: {e}")
                    continue
                except Exception as e:  # noqa: BLE001 — replica app error
                    attempt["t_end"] = self._clock()
                    attempt["outcome"] = "error"
                    self.note_result(rank, job.jid, ok=False)
                    with self._lock:
                        self._errors += 1
                    job.future.set_exception(e)
                    self._observe_completion(job, rank=rank, outcome="failed")
                    return
                self.note_result(rank, job.jid, ok=True)
                now = self._clock()
                stamp(trace, "reply", now)
                attempt["t_end"] = now
                attempt["outcome"] = "ok"
                with self._lock:
                    self._completed += 1
                    self._latencies_s.append(now - job.admit_t)
                    self._last_complete_t = now
                job.future.set_result(result)
                stamp(trace, "completed", self._clock())
                if job.shadow and rank != self.shadow_rank:
                    # Hand the completed pair to the shadow worker: one
                    # bounded put_nowait — never a send, never scoring —
                    # on the dispatch path. Full queue = the
                    # shadow sheds its own sample.
                    self._shadow_enqueue(job, rank, result)
                self._observe_completion(
                    job, rank=rank, outcome="completed",
                    latency_s=now - job.admit_t,
                )
                return
        finally:
            with self._lock:
                self._inflight_total = max(self._inflight_total - 1, 0)

    # ------------------------------------------------------------- shadow

    def _shadow_enqueue(self, job: _Job, rank: int, result: Any) -> None:
        """Bounded handoff to the shadow worker (dispatch path: one
        put_nowait, no scoring). A full queue sheds the sample
        (``shadow.shed``) instead of back-pressuring live traffic."""
        if self._shadow_queue is None:
            return
        try:
            self._shadow_queue.put_nowait((job.payload, dict(job.meta),
                                           rank, result))
        except _queue_mod.Full:
            self._shadow_scorer.record_shed()

    def _shadow_worker(self) -> None:
        """Drain mirrored requests and score them — the ONE thread that
        talks to the shadow replica. Same bounded-poll shutdown shape
        as the dispatch workers."""
        while True:
            try:
                item = self._shadow_queue.get(timeout=_WORKER_POLL_S)
            except _queue_mod.Empty:
                if self._closed.is_set():
                    return
                continue
            if item is _STOP:
                return
            try:
                self._score_one(*item)
            except Exception:  # noqa: BLE001 — report-only by contract
                self._shadow_scorer.record_shed()

    def _score_one(self, payload, meta: dict, primary_rank: int,
                   primary_result: Any) -> None:
        """Mirror one sampled request to the shadow replica and fold
        the agreement verdict (shadow worker thread only)."""
        meta = dict(meta)
        meta["want_logits"] = True
        # The mirror must NOT adopt the primary's trace id: the shadow
        # exchange is observability traffic, and joining it to the live
        # request's span chain would double-count the request in the
        # fleet trace merge.
        meta.pop("trace", None)
        # Nor the live deadline: the mirror rides an idle batcher, and
        # a long deadline becomes pure bucket-fill slack per sample.
        meta["deadline_ms"] = SHADOW_MIRROR_DEADLINE_MS
        try:
            shadow_result = self._transport.send(
                self.shadow_rank, payload, meta, SHADOW_SEND_TIMEOUT_S
            )
        except Exception:  # noqa: BLE001 — shed, never propagate
            self._shadow_scorer.record_shed()
            return
        with self._lock:
            primary = self._replicas.get(primary_rank)
            shadow = self._replicas.get(self.shadow_rank)
            primary_dtype = primary.dtype if primary is not None else None
            shadow_dtype = shadow.dtype if shadow is not None else None
        if primary_dtype is None or shadow_dtype is None:
            # Early mirrors can outrun the first dtype-carrying
            # heartbeat view, and an unknown pair would be judged
            # against the tight same-dtype envelope — a false breach
            # on an int8 arm's first samples. Refresh once (worker
            # thread, off the hot path) before falling back to "?".
            self._refresh_views()
            with self._lock:
                primary = self._replicas.get(primary_rank)
                shadow = self._replicas.get(self.shadow_rank)
                if primary is not None and primary.dtype:
                    primary_dtype = primary.dtype
                if shadow is not None and shadow.dtype:
                    shadow_dtype = shadow.dtype
        p_res = primary_result if isinstance(primary_result, dict) else {}
        s_res = shadow_result if isinstance(shadow_result, dict) else {}
        self._shadow_scorer.score_shadow(
            primary_dtype or "?",
            shadow_dtype or "?",
            p_res.get("pred", -1),
            s_res.get("pred", -1),
            primary_logits=p_res.get("logits"),
            shadow_logits=s_res.get("logits"),
        )

    def _shadow_snapshot(self) -> Optional[dict]:
        if self._shadow_scorer is None:
            return None
        out = self._shadow_scorer.snapshot()
        out["rank"] = self.shadow_rank
        out["frac"] = self.shadow_frac
        with self._lock:
            primary_dtypes = sorted({
                r.dtype for rank, r in self._replicas.items()
                if r.dtype and rank != self.shadow_rank
            })
            shadow = self._replicas.get(self.shadow_rank)
            if shadow is not None and shadow.dtype:
                out["dtype"] = shadow.dtype
        if primary_dtypes:
            out["primary_dtypes"] = primary_dtypes
        return out

    def _quality_tick(self) -> None:
        """Evaluate the quality rules against the live shadow snapshot
        — heartbeat-thread cadence only, never on a request path."""
        if self._shadow_alerts is None:
            return
        try:
            snapshot = self._shadow_scorer.snapshot()
            self._shadow_alerts.observe(
                {"shadow": snapshot}, now=self._wall()
            )
        except Exception:
            pass  # a broken rule must not stop heartbeating

    def note_result(self, rank: int, jid: int, *, ok: bool) -> None:
        """Completion bookkeeping for one send (host counters only):
        the projection stops counting it as outstanding."""
        with self._lock:
            replica = self._replicas.get(rank)
            if replica is None:
                return
            replica.sends.pop(jid, None)
            if ok:
                replica.completed += 1
            else:
                replica.failures += 1

    # ------------------------------------------------------------- tracing

    def _observe_completion(
        self,
        job: _Job,
        *,
        rank: Optional[int],
        outcome: str,
        latency_s: Optional[float] = None,
    ) -> None:
        """Fold one TERMINAL request (completed/shed/failed) into the
        span ring and the live windows. Self-accounted against the
        overhead meter (router_overhead_ms) and host-only by contract;
        it runs once per request on the
        dispatch path."""
        trace = job.trace
        if trace is None:
            return
        t0 = self._perf()
        now = self._clock()
        if outcome != "completed":
            # Honest terminal stamp: shed/failed traces end with their
            # real outcome, never a fake "completed".
            stamp(trace, outcome if outcome == "shed" else "failed", now)
        if latency_s is None:
            latency_s = now - job.admit_t
        overrun_s = latency_s - trace.deadline_s
        stages_s = intervals(trace.stamps, ROUTER_INTERVALS)
        record = {
            "rid": trace.rid,
            "deadline_ms": trace.deadline_s * 1e3,
            "latency_ms": latency_s * 1e3,
            "overrun_ms": overrun_s * 1e3,
            "hit": outcome == "completed" and overrun_s <= 0.0,
            "rank": rank,
            "outcome": outcome,
            "attempts": [
                {
                    "rank": a.get("rank"),
                    "outcome": a.get("outcome"),
                    "ms": (
                        round((a["t_end"] - a["t_start"]) * 1e3, 3)
                        if "t_end" in a else None
                    ),
                }
                for a in job.attempts
            ],
            "candidate_waits_ms": job.waits,
            "stamps": trace.stamps,
            "stages_ms": {k: v * 1e3 for k, v in stages_s.items()},
            "dominant_stage": dominant_stage(stages_s),
        }
        with self._lock:
            self._ring.append(record)
            if outcome == "completed":
                self._lat_window.observe(latency_s * 1e3, now=now)
                for name, dur_s in stages_s.items():
                    w = self._stage_windows.get(name)
                    if w is None:
                        w = self._stage_windows[name] = SlidingWindow(
                            self.window_s, clock=self._clock
                        )
                    w.observe(dur_s * 1e3, now=now)
            self._overhead_s += self._perf() - t0

    def _window_snapshot(self, now: Optional[float] = None) -> dict:
        """The live windowed view (owner must hold the lock): latency
        percentiles, throughput over the window, and per-stage latency
        SHARES — where the window's wall time went, the Tail-at-Scale
        attribution the heartbeats carry."""
        if now is None:
            now = self._clock()
        n = self._lat_window.count(now=now)
        total_ms = self._lat_window.total(now=now)
        stage_shares = {}
        if total_ms > 0:
            for name, w in sorted(self._stage_windows.items()):
                stage_ms = w.total(now=now)
                if stage_ms > 0:
                    stage_shares[name] = round(stage_ms / total_ms, 4)
        # Effective span: a run younger than the window must divide by
        # the time actually served, not the full window — otherwise a
        # 2-second flood reads as window_s worth of "throughput" and
        # mid-run disagrees with the close-time summary (the bug this
        # snapshot exists for).
        eff = self.window_s
        if self._first_admit_t is not None:
            eff = min(self.window_s, max(now - self._first_admit_t, 1e-9))
        return {
            "window_s": self.window_s,
            "requests": n,
            "p50_ms": _round3(self._lat_window.percentile(50.0, now=now)),
            "p95_ms": _round3(self._lat_window.percentile(95.0, now=now)),
            "p99_ms": _round3(self._lat_window.percentile(99.0, now=now)),
            "throughput_rps": round(n / eff, 2) if n else 0.0,
            "stage_shares": stage_shares,
        }

    def live(self) -> dict:
        """The mid-run router view — counters + the windowed snapshot —
        the SAME numbers ``summary()`` reports at close (mid-run and
        post-run readers must agree)."""
        with self._lock:
            now = self._clock()
            view_age = (
                now - self._last_refresh
                if self._last_refresh is not None else None
            )
            span = None
            if (
                self._first_admit_t is not None
                and self._last_complete_t is not None
            ):
                span = max(self._last_complete_t - self._first_admit_t, 1e-9)
            out = {
                "completed": self._completed,
                "throughput_rps": (
                    round(self._completed / span, 2) if span else None
                ),
                "rejected": self._rejected,
                "shed": self._shed_admit + self._shed_deadline,
                "rerouted": self._rerouted,
                "transport_failures": self._transport_failures,
                "errors": self._errors,
                "down_flaps": self._down_flaps,
                "inflight": self._inflight_total,
                "view_age_s": _round3(view_age),
                "router_overhead_ms": self._overhead_ms_locked(),
                "w": self._window_snapshot(now),
            }
        # Shadow agreement rides every kind=router beat —
        # folded OUTSIDE the router lock (the scorer has its own).
        shadow = self._shadow_snapshot()
        if shadow is not None:
            out["shadow"] = shadow
        return out

    def _overhead_ms_locked(self) -> float:
        return round(
            self._overhead_s / max(self._completed, 1) * 1e3, 4
        )

    def router_beat(self) -> bool:
        """Append one ``kind=router`` heartbeat to ``fleet/router.jsonl``
        (the heartbeat substrate; bounded-lock, drop-never-block). The
        router is a first-class fleet citizen: its stream sits next to the
        replicas'."""
        if self._hb_writer is None:
            return False
        return self._hb_writer.serve_beat(self.live(), kind="router")

    def _hb_loop(self) -> None:
        while not self._closed.wait(self.heartbeat_secs):
            self.router_beat()
            self._quality_tick()
            self._roll_tick()

    def _roll_tick(self, min_interval_s: float = 2.0) -> None:
        """Advance the fleet rollup ladder by the bytes appended since
        the last tick. Cadenced work, deliberately outside
        ``router_beat`` and every request path: O(new bytes) per tick, and a failed roll must never
        take the heartbeat with it. Ticks are rate-limited below the
        heartbeat cadence (the finest bucket is 10s — sub-second rolls
        only steal GIL slices from request threads); close() passes 0
        so the final fold always runs."""
        if self._roller is None:
            return
        now = self._clock()
        if (
            self._last_roll is not None
            and now - self._last_roll < min_interval_s
        ):
            return
        self._last_roll = now
        try:
            self._roller.roll_once()
        except Exception:
            pass

    # ----------------------------------------------------- replica states

    def _mark_down(self, rank: int, *, reason: str) -> None:
        with self._lock:
            replica = self._replicas.get(rank)
            if replica is None or replica.state == DOWN:
                return
            replica.state = DOWN
            replica.down_since_unix = self._wall()
            replica.down_reason = reason
            self._down_flaps += 1

    def drain(
        self, rank: int, *, reason: str = "manual", auto: bool = False
    ) -> bool:
        """Stop routing NEW requests to a replica; its in-flight work
        finishes normally (the futures resolve as results arrive). The
        straggler attribution calls this automatically (``auto`` — and
        only auto drains auto-RESUME when the attribution unflags; a
        manual drain stays until :meth:`resume`). Refuses to drain the
        last active replica. Host-only."""
        with self._lock:
            replica = self._replicas.get(rank)
            if replica is None or replica.state != ACTIVE:
                return False
            # The shadow rank takes no routed traffic, so it does not count:
            # draining the last live replica beside an idle shadow would
            # leave nothing routable (sav_tpu's router counts it).
            active = sum(
                1 for r in self._replicas.values()
                if r.state == ACTIVE and r.rank != self.shadow_rank
            )
            if active <= 1:
                return False  # degraded capacity beats none
            replica.state = DRAINING
            replica.drained_at_unix = self._wall()
            replica.down_reason = reason
            replica.drain_auto = bool(auto)
            return True

    def resume(self, rank: int) -> bool:
        """Fold a draining/down replica back into rotation (the
        recovery path calls this when a fresh heartbeat arrives)."""
        with self._lock:
            replica = self._replicas.get(rank)
            if replica is None or replica.state == ACTIVE:
                return False
            replica.state = ACTIVE
            replica.down_since_unix = None
            replica.down_reason = None
            replica.drained_at_unix = None
            replica.drain_auto = False
            return True

    # -------------------------------------------------------- view refresh

    def refresh(self) -> None:
        """Force a heartbeat-view refresh NOW (callers polling for a
        replica's recovery — e.g. the chaos arm's fold-back probe —
        should not wait out the cadence)."""
        self._refresh_views()

    def _maybe_refresh(self) -> None:
        # Check-and-claim under the lock: two dispatch workers
        # racing the lock-free check both used to decide "stale" and
        # refresh back-to-back — the claim makes one refresh per cadence.
        now = self._clock()
        with self._lock:
            if (
                self._last_refresh is not None
                and now - self._last_refresh < self.refresh_secs
            ):
                return
            self._last_refresh = now
        self._refresh_views()

    def _refresh_views(self) -> None:
        """Fold the live heartbeat views into the routing table: update
        each replica's queue/step estimates, mark heartbeat-silent
        replicas down (the silence_suspects flag), recover replicas
        whose beats resumed, and run the leave-one-out straggler gate
        on windowed p99 (drain flagged, resume unflagged). Host-only by
        contract: every value read here is a parsed JSON line."""
        with self._lock:
            self._last_refresh = self._clock()
        try:
            views = self._views_fn() or {}
        except Exception:  # noqa: BLE001 — a torn read must not stop routing
            return
        with self._lock:
            for rank, view in views.items():
                rank = int(rank)
                replica = self._replicas.get(rank)
                if replica is None:
                    replica = self._replicas[rank] = _Replica(rank)
                queued = view.get("queued")
                inflight = view.get("inflight")
                replica.queued = int(queued) if queued is not None else 0
                replica.inflight = (
                    int(inflight) if inflight is not None else 0
                )
                est = view.get("est_step_s")
                if isinstance(est, (int, float)) and est > 0:
                    replica.est_step_s = float(est)
                p99 = view.get("p99_ms")
                replica.p99_ms = (
                    float(p99) if isinstance(p99, (int, float)) else None
                )
                beat_t = view.get("last_beat_unix")
                if isinstance(beat_t, (int, float)):
                    replica.last_beat_unix = float(beat_t)
                replica.beats = int(view.get("beats") or 0)
                replica.final = bool(view.get("final"))
                dtype = view.get("dtype")
                if dtype:
                    replica.dtype = str(dtype)
                pid = view.get("pid")
                if pid is not None:
                    if replica.pid is not None and replica.pid != pid:
                        # A new process took this rank (supervisor
                        # restart): the old outstanding ledger is dead
                        # weight against the fresh replica's projection.
                        replica.sends.clear()
                    replica.pid = pid
                # Dead suspicion / recovery. An orderly final record is
                # a close, not a death — down, but not suspicion-tagged.
                if view.get("suspect") or replica.final:
                    if replica.state != DOWN:
                        replica.state = DOWN
                        replica.down_since_unix = self._wall()
                        replica.down_reason = (
                            "final record" if replica.final
                            else "heartbeat-silent"
                        )
                        self._down_flaps += 1
                elif (
                    replica.state == DOWN
                    and replica.last_beat_unix is not None
                    and (
                        replica.down_since_unix is None
                        or replica.last_beat_unix > replica.down_since_unix
                    )
                ):
                    # Fresh beat after the down mark: the supervisor
                    # restarted it (or the silence healed) — fold it
                    # back in.
                    replica.state = ACTIVE
                    replica.down_since_unix = None
                    replica.down_reason = None
            # Straggler gate: LOO median+MAD on windowed p99 across the
            # replicas that have one (the sentinel machinery's
            # fleet application — one robust-stats implementation).
            # The shadow's p99 is its mirrors' (alone, short deadline), not
            # live traffic's: it is neither a baseline nor a straggler.
            p99s = {
                rank: r.p99_ms
                for rank, r in self._replicas.items()
                if r.p99_ms is not None
                and r.beats >= self.straggler_min_beats
                and r.state in (ACTIVE, DRAINING)
                and rank != self.shadow_rank
            }
            flagged = set()
            if len(p99s) >= 2:
                scores = _loo_scores(
                    p99s, k=self.straggler_k,
                    rel_floor=self.straggler_rel_floor,
                )
                flagged = {
                    rank for rank, s in scores.items() if s["flagged"]
                }
        for rank in sorted(flagged):
            self.drain(rank, reason="straggler (LOO p99)", auto=True)
        with self._lock:
            unflag = [
                rank for rank, r in self._replicas.items()
                if r.state == DRAINING and r.drain_auto
                and rank not in flagged
            ]
        for rank in unflag:
            self.resume(rank)

    # ----------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Stop admission, fail requests still queued for dispatch
        (:class:`ServeClosedError`), and join the workers. Requests a
        worker already sent complete normally. Idempotent."""
        if self._closed.is_set():
            return
        self._closed.set()
        # Fail everything still queued (workers check closed before
        # sending; the sentinel wakes them for shutdown).
        self._fail_queued_jobs()
        for _ in self._workers:
            self._jobs.put(_STOP)
        for t in self._workers:
            t.join(timeout=5.0)
        if self._shadow_thread is not None:
            # After the dispatch workers: nothing can enqueue mirrors
            # any more, so one _STOP drains whatever was sampled and the
            # final beat below carries the complete agreement picture.
            self._shadow_queue.put(_STOP)
            self._shadow_thread.join(timeout=SHADOW_SEND_TIMEOUT_S + 5.0)
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        if self._hb_writer is not None:
            # One last beat with the final counters, then the stream's
            # orderly final record.
            self._hb_writer.serve_beat(self.live(), kind="router")
            self._hb_writer.close()
        if self._shadow_alerts is not None:
            # Judge the final snapshot, then resolve whatever is still
            # firing — exactly one resolved event per open episode (the
            # monotonic breach counter + this finalize is what makes a
            # planted fault exactly-once).
            self._quality_tick()
            try:
                self._shadow_alerts.finalize(self._wall())
            except Exception:
                pass
        # Fold the final beats into the rollup ladder so post-run
        # readers (console, headroom fold) see the whole run.
        self._roll_tick(min_interval_s=0.0)
        if self.log_dir:
            with self._lock:
                records = self._ring.records()
            if records:
                write_request_trace(
                    os.path.join(
                        self.log_dir, "serve_traces",
                        "requests_router.trace.json.gz",
                    ),
                    records,
                    ROUTER_INTERVALS,
                    process_name="Fleet Router",
                    extra_args=("rank", "outcome"),
                )
            self.write_summary()

    def _fail_queued_jobs(self) -> None:
        """Fail every queued job's future (close()'s pass; admit()
        re-runs it when its enqueue raced close). Worker shutdown
        sentinels drained in passing are re-enqueued — admit's re-run
        can execute after close() armed them, and swallowing one would
        leave a worker blocked forever on the queue."""
        stops = 0
        while True:
            try:
                job = self._jobs.get_nowait()
            except _queue_mod.Empty:
                break
            if job is _STOP:
                stops += 1
                continue
            job.future.set_exception(
                ServeClosedError("router closed before this request shipped")
            )
            with self._lock:
                self._inflight_total = max(self._inflight_total - 1, 0)
        for _ in range(stops):
            self._jobs.put(_STOP)

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    # ------------------------------------------------------------- reading

    def stats(self) -> dict:
        with self._lock:
            return {
                "completed": self._completed,
                "rejected": self._rejected,
                "shed_admit": self._shed_admit,
                "shed_deadline": self._shed_deadline,
                "rerouted": self._rerouted,
                "transport_failures": self._transport_failures,
                "errors": self._errors,
                "down_flaps": self._down_flaps,
                "router_overhead_ms": self._overhead_ms_locked(),
                "inflight": self._inflight_total,
                "replicas": {
                    str(rank): r.view()
                    for rank, r in sorted(self._replicas.items())
                },
            }

    def summary(self) -> dict:
        """The fleet-level serving headline: router-observed end-to-end
        latency percentiles (admit -> result), throughput over the
        serving span, and the shed/reroute accounting the chaos proof
        audits (completed + shed == admitted, nothing silently lost)."""
        from sav_tpu_torch.serve.latency import percentile

        with self._lock:
            lat = sorted(self._latencies_s)
            span = None
            if (
                self._first_admit_t is not None
                and self._last_complete_t is not None
            ):
                span = max(self._last_complete_t - self._first_admit_t, 1e-9)
            shed = self._shed_admit + self._shed_deadline
            out = {
                "schema": ROUTER_SCHEMA,
                "completed": self._completed,
                "rejected": self._rejected,
                "shed": shed,
                "shed_admit": self._shed_admit,
                "shed_deadline": self._shed_deadline,
                "rerouted": self._rerouted,
                "transport_failures": self._transport_failures,
                "errors": self._errors,
                "down_flaps": self._down_flaps,
                "router_overhead_ms": self._overhead_ms_locked(),
                "traces": {
                    "ring": len(self._ring),
                    "appended": self._ring.appended,
                },
                "window": self._window_snapshot(),
                "latency_ms": {
                    "p50": round(percentile(lat, 50.0) * 1e3, 3) if lat else None,
                    "p95": round(percentile(lat, 95.0) * 1e3, 3) if lat else None,
                    "p99": round(percentile(lat, 99.0) * 1e3, 3) if lat else None,
                },
                "throughput_rps": (
                    round(self._completed / span, 2) if span else None
                ),
                "replicas": {
                    str(rank): r.view()
                    for rank, r in sorted(self._replicas.items())
                },
            }
        shadow = self._shadow_snapshot()
        if shadow is not None:
            out["shadow"] = shadow
        return out

    def write_summary(self) -> Optional[str]:
        """Persist the router summary to ``<log_dir>/fleet/router.json``
        (atomic; telemetry never raises) — offline readers render it
        next to the per-replica heartbeat views."""
        if not self.log_dir:
            return None
        path = os.path.join(self.log_dir, "fleet", "router.json")
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.summary(), f, indent=2, default=str)
            os.replace(tmp, path)
            return path
        except OSError:
            return None


def read_router_summary(log_dir: str) -> Optional[dict]:
    """The persisted router summary (``fleet/router.json``), or None —
    the offline readers' side of :meth:`write_summary`."""
    try:
        with open(os.path.join(log_dir, "fleet", "router.json")) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return doc if isinstance(doc, dict) else None
