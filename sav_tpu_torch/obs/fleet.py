"""Fleet telemetry: per-process heartbeats, step skew and straggler
attribution (the port's own copy of the writer and the readers of
``sav_tpu/obs/fleet.py`` that the trainer and the supervisor use, stdlib
only).

Every process appends heartbeats to its own stream, and an aggregator
(process 0 at the end of ``fit``, or any machine offline) turns the streams
into step skew, a straggler ranking and missing-heartbeat suspicion. The
layout and the line format are ``sav_tpu``'s, so either side's readers read
the other's streams::

    <log_dir>/fleet/proc_<i>.jsonl   one JSON line per heartbeat
    <log_dir>/fleet/fleet.json       merged fleet manifest (process 0)

A heartbeat carries host values only: the goodput ledger's wall-clock
buckets, the log window's metrics that the trainer has already copied to
the host, the flight recorder's last incident. :meth:`HeartbeatWriter.beat`
reads no device tensor, so it adds no device sync; its cost is one flushed
append per log window (the ``fleet/write_s`` gauge).

The straggler ranking scores the host-stall share (Δ(input_wait + h2d +
stall) / Δwall) first and the per-step wall second, each against a
leave-one-out median + MAD baseline, so one bad process cannot poison its
own baseline.

Not ported (ROADMAP queue A10, and A5.8 for the router): the router's and
the serving engine's beats, the backend probe's timeline and the autoprof
capture readers.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Callable, Optional

FLEET_SCHEMA = 1

# Every line carries ``schema_version`` beside the frozen ``schema`` field
# (sav_tpu's values); the readers filter on ``kind`` only, so they take
# unknown versions and keys.
FLEET_SCHEMA_VERSION = 2

# Ledger buckets carried by each heartbeat (a subset of goodput.BUCKETS,
# inlined: the names are a contract with sav_tpu's readers).
HEARTBEAT_BUCKETS = (
    "compile", "step", "input_wait", "h2d", "eval", "checkpoint", "stall",
)

# Host-stall buckets: wall time the *host* spent not feeding the device.
# In a lockstep collective run this is what distinguishes the straggler
# (who stalls before the all-reduce) from its victims (whose time lands
# in 'step', blocked inside it).
HOST_STALL_BUCKETS = ("input_wait", "h2d", "stall")

# The normal distribution's MAD-to-sigma factor.
MAD_SCALE = 1.4826


def fleet_dir(log_dir: str) -> str:
    return os.path.join(log_dir, "fleet")


def resolve_identity(
    default_index: int = 0, default_count: int = 1
) -> tuple[int, int]:
    """(process index, process count) for fleet telemetry.

    Defaults to the caller's view (the port's trainer runs one process
    on one device: 0 of 1), overridable with ``SAV_FLEET_PROC`` /
    ``SAV_FLEET_PROCS`` for independent workers sharing a log dir.
    Malformed overrides fall back to the defaults: identity resolution
    never takes a run down.
    """
    try:
        index = int(os.environ.get("SAV_FLEET_PROC", default_index))
        count = int(os.environ.get("SAV_FLEET_PROCS", default_count))
    except ValueError:
        return default_index, default_count
    if index < 0 or count < 1:
        return default_index, default_count
    return index, max(count, index + 1)


def heartbeat_path(log_dir: str, process_index: int) -> str:
    return os.path.join(fleet_dir(log_dir), f"proc_{process_index}.jsonl")


class HeartbeatWriter:
    """Append-only per-process heartbeat stream.

    One writer per process, file ``fleet/proc_<i>.jsonl`` — processes
    never share a file, so multi-host runs need no cross-process locking
    (the same shared-log-dir discipline as the manifest/goodput writers,
    minus the process-0-only restriction: heartbeats are per-process *by
    design*). Each :meth:`beat` appends one JSON line and flushes, so a
    watchdog ``os._exit`` or SIGKILL loses at most the in-flight line
    (readers skip torn tails). The per-beat path is host-only; the
    ``write_s``/``beats`` gauges say what it costs.
    """

    # Bound on any lock wait (seconds): telemetry drops, never blocks.
    LOCK_TIMEOUT_S = 1.0

    def __init__(
        self,
        log_dir: str,
        *,
        process_index: int = 0,
        process_count: int = 1,
        clock: Callable[[], float] = time.time,
        perf: Callable[[], float] = time.perf_counter,
    ):
        self.log_dir = log_dir
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.path = heartbeat_path(log_dir, self.process_index)
        self._clock = clock
        self._perf = perf
        # Training thread (beat/close) vs watchdog-side events share the
        # file; acquisition is BOUNDED (LOCK_TIMEOUT_S) everywhere: the
        # watchdog's soft stage deliberately abandons a dump thread that
        # wedges on a hung log-dir filesystem, and an abandoned writer
        # stuck inside this lock must not deadlock the training thread's
        # next beat — a recovered stall would then be converted into a
        # hard watchdog abort by its own telemetry. A timed-out record
        # is dropped and counted (``dropped`` stat), never waited for.
        self._lock = threading.Lock()
        self._dropped = 0
        self._file = None
        # Eager open: directory creation + file open are one-time setup
        # paid at construction (before the train loop), so the per-beat
        # write_s gauge measures only the steady-state append+flush —
        # that is what the <1%-of-step-time contract bounds. _append
        # retries lazily if this failed (degraded FS ≠ dead telemetry).
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._file = open(self.path, "a")
        except OSError:
            pass
        self._beats = 0
        self._events = 0
        self._write_s = 0.0
        self._closed = False
        self.last_step: Optional[int] = None
        self._host = socket.gethostname()
        self._pid = os.getpid()

    # ------------------------------------------------------------- recording

    def _append(self, record: dict) -> None:
        """One line out; open lazily, flush eagerly, never raise
        (telemetry must not take the run down)."""
        try:
            if self._file is None:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                self._file = open(self.path, "a")
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        except OSError:
            pass

    def beat(
        self,
        step: int,
        *,
        ledger=None,
        metrics: Optional[dict] = None,
        incident: Optional[str] = None,
    ) -> None:
        """Append one heartbeat at the trainer's log boundary.

        ``ledger``: the fit's GoodputLedger — wall-clock aggregates, all
        host-side. ``metrics``: the log window's record, already copied to
        the host (floats); a small subset rides along.
        ``incident``: last flight-recorder bundle path, if any. No value
        touched here is a device tensor.
        """
        t0 = self._perf()
        record: dict = {
            "schema": FLEET_SCHEMA,
            "schema_version": FLEET_SCHEMA_VERSION,
            "kind": "hb",
            "proc": self.process_index,
            "procs": self.process_count,
            "step": int(step),
            "t": round(float(self._clock()), 3),
            "host": self._host,
            "pid": self._pid,
        }
        if ledger is not None:
            record["wall_s"] = round(ledger.wall_s, 4)
            record["steps"] = ledger.steps
            record["b"] = {
                name: round(ledger.bucket_seconds(name), 4)
                for name in HEARTBEAT_BUCKETS
            }
            record["anomalies"] = len(ledger.anomalies)
        if metrics:
            loss = metrics.get("loss")
            if isinstance(loss, (int, float)):
                record["loss"] = round(float(loss), 6)
            rate = metrics.get("images_per_sec")
            if isinstance(rate, (int, float)):
                record["images_per_sec"] = round(float(rate), 1)
            retraces = metrics.get("retraces")
            if isinstance(retraces, (int, float)):
                record["retraces"] = int(retraces)
            hbm = metrics.get("hbm_bytes_in_use")
            if isinstance(hbm, (int, float)):
                record["hbm_bytes_in_use"] = float(hbm)
            hbm_peak = metrics.get("hbm_peak_bytes")
            if isinstance(hbm_peak, (int, float)):
                record["hbm_peak_bytes"] = float(hbm_peak)
        if incident:
            record["incident"] = incident
        if not self._lock.acquire(timeout=self.LOCK_TIMEOUT_S):
            self._dropped += 1  # a wedged writer must not block training
            return
        try:
            if self._closed:
                return
            self._append(record)
            self._beats += 1
            self.last_step = int(step)
            self._write_s += self._perf() - t0
        finally:
            self._lock.release()

    def fleet_event(self, event: str, **fields) -> None:
        """Append an out-of-band event line (watchdog soft stage, probe
        outcomes). Callable from any thread; host-only like beat()."""
        t0 = self._perf()
        record = {
            "schema": FLEET_SCHEMA,
            "schema_version": FLEET_SCHEMA_VERSION,
            "kind": "event",
            "event": event,
            "proc": self.process_index,
            "step": self.last_step,
            "t": round(float(self._clock()), 3),
        }
        record.update(fields)
        if not self._lock.acquire(timeout=self.LOCK_TIMEOUT_S):
            self._dropped += 1
            return
        try:
            if self._closed:
                return
            self._append(record)
            self._events += 1
            self._write_s += self._perf() - t0
        finally:
            self._lock.release()

    def close(self, outcome: str = "ok") -> None:
        """Final record + file close. A process that never reaches this
        (killed, wedged) is exactly what the aggregator's
        missing-heartbeat suspicion exists to notice."""
        if not self._lock.acquire(timeout=self.LOCK_TIMEOUT_S):
            self._dropped += 1  # wedged writer: the daemon file handle
            return              # dies with the process; no final record
        try:
            if self._closed:
                return
            self._append({
                "schema": FLEET_SCHEMA,
                "schema_version": FLEET_SCHEMA_VERSION,
                "kind": "final",
                "proc": self.process_index,
                "step": self.last_step,
                "outcome": outcome,
                "t": round(float(self._clock()), 3),
            })
            self._closed = True
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
        finally:
            self._lock.release()

    def stats(self) -> dict[str, float]:
        """Gauge view for the goodput ledger (``fleet/*``)."""
        # Lock-free snapshot: each counter read is GIL-atomic, and a
        # slightly torn multi-counter view is fine for gauges.
        return {
            "beats": float(self._beats),
            "events": float(self._events),
            "write_s": self._write_s,
            "dropped": float(self._dropped),
        }


def read_heartbeats(log_dir: str) -> dict[int, list[dict]]:
    """Every ``fleet/proc_*.jsonl`` stream, by process index; torn tail
    lines (a killed writer's) are skipped."""
    root = fleet_dir(log_dir)
    out: dict[int, list[dict]] = {}
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        if not (name.startswith("proc_") and name.endswith(".jsonl")):
            continue
        try:
            proc = int(name[len("proc_"):-len(".jsonl")])
        except ValueError:
            continue
        records = []
        try:
            with open(os.path.join(root, name), "rb") as f:
                for raw in f:
                    line = raw.decode("utf-8", "replace").strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue  # torn tail of a killed process
        except OSError:
            continue
        out[proc] = records
    return out


def _median(values: list) -> Optional[float]:
    if not values:
        return None
    ordered = sorted(values)
    n = len(ordered)
    mid = ordered[n // 2]
    return mid if n % 2 else 0.5 * (ordered[n // 2 - 1] + mid)


def _mad(values: list, med: float) -> float:
    return _median([abs(v - med) for v in values]) or 0.0


def _intervals(beats: list[dict]) -> list[dict]:
    """Per consecutive-heartbeat deltas for one process: wall seconds,
    steps advanced, and the host-stall share of the interval."""
    out = []
    for prev, cur in zip(beats, beats[1:]):
        dt = float(cur.get("t", 0.0)) - float(prev.get("t", 0.0))
        dsteps = int(cur.get("step", 0)) - int(prev.get("step", 0))
        if dt <= 0 or dsteps <= 0:
            continue
        interval = {
            "dt": dt,
            "dsteps": dsteps,
            "per_step_s": dt / dsteps,
        }
        pb, cb = prev.get("b"), cur.get("b")
        if isinstance(pb, dict) and isinstance(cb, dict):
            stall = sum(
                float(cb.get(k, 0.0)) - float(pb.get(k, 0.0))
                for k in HOST_STALL_BUCKETS
            )
            interval["host_stall_frac"] = max(min(stall / dt, 1.0), 0.0)
        out.append(interval)
    return out


_UNSET = object()


def silence_suspects(
    beat_times: dict[int, list],
    finals: dict[int, bool],
    *,
    now: float,
    suspect_factor: float = 3.0,
    median_interval=_UNSET,
) -> list[dict]:
    """Missing-heartbeat dead-host suspicion (:func:`aggregate_fleet`'s):
    a process silent for more than ``suspect_factor`` x the fleet's
    median beat interval, without a final record, likely went dark.

    ``beat_times``: per-process heartbeat unix stamps (ascending).
    ``finals``: per-process "a final record exists" (an orderly close is
    not a death). ``median_interval`` overrides the fleet-median
    computed from ``beat_times`` — a caller that PASSES it owns the
    baseline outright, including passing None for "no valid baseline
    yet, flag nothing" (aggregate_fleet passes the median of its
    step-filtered intervals: beats that advanced no step, e.g. through
    a long first compile, carry no interval signal and must not
    manufacture suspicion). Returns ``[{proc, last_unix, silent_s,
    median_interval_s}]``, empty when no interval baseline exists yet.
    """
    med = median_interval
    if med is _UNSET:
        intervals = [
            b - a
            for times in beat_times.values()
            for a, b in zip(times, times[1:])
            if b > a
        ]
        med = _median(intervals)
    if not med:
        return []
    suspects = []
    for proc, times in sorted(beat_times.items()):
        if not times or finals.get(proc):
            continue
        silent = float(now) - float(times[-1])
        if silent > suspect_factor * med:
            suspects.append({
                "proc": proc,
                "last_unix": times[-1],
                "silent_s": round(silent, 3),
                "median_interval_s": round(med, 3),
            })
    return suspects


def _loo_scores(
    per_proc: dict[int, float], *, k: float, rel_floor: float
) -> dict[int, dict]:
    """Leave-one-out median+MAD score per process.

    For each process, the baseline is every OTHER process's value —
    a robust outlier test applied across the fleet, so
    the straggler's own slowness cannot inflate the threshold it is
    judged against. ``score`` is deviations-above-baseline in threshold
    units; ``flagged`` when score > 1 (i.e. beyond
    ``median + max(k·1.4826·MAD, rel_floor·|median|)``).
    """
    out: dict[int, dict] = {}
    for proc, value in per_proc.items():
        baseline = [v for p, v in per_proc.items() if p != proc]
        if not baseline:
            out[proc] = {"value": value, "score": 0.0, "flagged": False}
            continue
        med = _median(baseline)
        mad = _mad(baseline, med)
        threshold = max(
            k * MAD_SCALE * mad, rel_floor * abs(med), 1e-9
        )
        score = (value - med) / threshold
        out[proc] = {
            "value": value,
            "baseline_median": med,
            "baseline_mad": mad,
            "threshold": threshold,
            "score": round(score, 3),
            "flagged": score > 1.0,
        }
    return out


def aggregate_fleet(
    log_dir: str,
    *,
    straggler_k: float = 3.5,
    rel_floor: float = 0.25,
    suspect_factor: float = 3.0,
    now: Optional[float] = None,
    max_timeline: int = 200,
) -> dict:
    """Fold the per-process heartbeat streams into one fleet summary.

    Runs anywhere (stdlib-only): process 0 calls it at the end of fit(),
    and any machine can recompute it offline over copied logs (the
    streams are sav_tpu's, so its tools read them too). ``now`` defaults
    to the newest heartbeat across the fleet (offline semantics: the
    wall clock would flag every process of a finished run as silent).

    Summary keys: ``processes`` (per-process view), ``step_skew``,
    ``skew_timeline``, ``straggler`` (leave-one-out MAD ranking on
    host-stall share and per-step wall time), ``suspects``
    (missing-heartbeat dead-host suspicion), ``events``.
    """
    streams = read_heartbeats(log_dir)
    summary: dict = {
        "schema": FLEET_SCHEMA,
        "log_dir": log_dir,
        "processes": {},
        "events": [],
    }
    if not streams:
        return summary
    beats: dict[int, list[dict]] = {}
    for proc, records in streams.items():
        beats[proc] = [r for r in records if r.get("kind") == "hb"]
        for r in records:
            if r.get("kind") == "event":
                summary["events"].append(r)
    finals = {
        proc: next(
            (r for r in reversed(records) if r.get("kind") == "final"), None
        )
        for proc, records in streams.items()
    }
    latest = 0.0
    intervals: dict[int, list[dict]] = {}
    for proc, hb in beats.items():
        final = finals.get(proc)
        last = hb[-1] if hb else None
        intervals[proc] = _intervals(hb)
        per_step = [i["per_step_s"] for i in intervals[proc]]
        stalls = [
            i["host_stall_frac"] for i in intervals[proc]
            if "host_stall_frac" in i
        ]
        view = {
            "heartbeats": len(hb),
            "first_step": hb[0].get("step") if hb else None,
            "last_step": last.get("step") if last else None,
            "last_unix": last.get("t") if last else None,
            "host": last.get("host") if last else None,
            "median_step_s": (
                round(_median(per_step), 6) if per_step else None
            ),
            "median_host_stall_frac": (
                round(_median(stalls), 4) if stalls else None
            ),
            "anomalies": last.get("anomalies") if last else None,
            "incident": next(
                (r["incident"] for r in reversed(hb) if r.get("incident")),
                None,
            ),
            "final": bool(final),
            "outcome": final.get("outcome") if final else None,
        }
        summary["processes"][str(proc)] = view
        for r in hb + ([final] if final else []):
            latest = max(latest, float(r.get("t", 0.0)))
    now = latest if now is None else float(now)

    # Step skew: how far apart the processes' frontiers are.
    frontiers = {
        proc: hb[-1].get("step") for proc, hb in beats.items() if hb
    }
    if frontiers:
        lo_proc = min(frontiers, key=lambda p: frontiers[p])
        hi_proc = max(frontiers, key=lambda p: frontiers[p])
        summary["step_skew"] = {
            "min_step": frontiers[lo_proc],
            "max_step": frontiers[hi_proc],
            "skew": frontiers[hi_proc] - frontiers[lo_proc],
            "laggard": lo_proc,
        }

    # Skew timeline: the merged (t, proc, step) trail, downsampled.
    trail = sorted(
        (
            {"t": r.get("t"), "proc": proc, "step": r.get("step")}
            for proc, hb in beats.items() for r in hb
        ),
        key=lambda e: (e["t"], e["proc"]),
    )
    if len(trail) > max_timeline:
        stride = -(-len(trail) // max_timeline)
        trail = trail[::stride] + trail[-1:]
    summary["skew_timeline"] = trail

    # Straggler ranking: host-stall share first (attributes the process
    # that stalls BEFORE the collective in lockstep runs), per-step wall
    # second (covers non-lockstep / independent-process fleets).
    stall_medians = {
        proc: _median([
            i["host_stall_frac"] for i in iv if "host_stall_frac" in i
        ])
        for proc, iv in intervals.items()
    }
    stall_medians = {
        p: v for p, v in stall_medians.items() if v is not None
    }
    step_medians = {
        proc: _median([i["per_step_s"] for i in iv])
        for proc, iv in intervals.items()
    }
    step_medians = {p: v for p, v in step_medians.items() if v is not None}
    stall_scores = _loo_scores(
        stall_medians, k=straggler_k, rel_floor=rel_floor
    )
    step_scores = _loo_scores(
        step_medians, k=straggler_k, rel_floor=rel_floor
    )
    ranking = []
    procs = sorted(set(stall_scores) | set(step_scores))
    for proc in procs:
        entry = {"proc": proc}
        if proc in stall_scores:
            entry["host_stall"] = stall_scores[proc]
        if proc in step_scores:
            entry["step_time"] = step_scores[proc]
        entry["score"] = max(
            stall_scores.get(proc, {}).get("score", 0.0),
            step_scores.get(proc, {}).get("score", 0.0),
        )
        entry["flagged"] = bool(
            stall_scores.get(proc, {}).get("flagged")
            or step_scores.get(proc, {}).get("flagged")
        )
        ranking.append(entry)
    ranking.sort(key=lambda e: -e["score"])
    straggler = next((e["proc"] for e in ranking if e["flagged"]), None)
    summary["straggler"] = {
        "ranking": ranking,
        "straggler": straggler,
        "k": straggler_k,
        "rel_floor": rel_floor,
    }

    # Missing-heartbeat dead-host suspicion: a process silent for more
    # than suspect_factor x the fleet's median heartbeat interval (and
    # without a final record) likely went dark — "process 5 stopped
    # heartbeating at step 1240", not a symmetric timeout. The median
    # interval passed in is the step-filtered one (beats that advanced no
    # step carry no interval signal for training streams).
    all_intervals = [i["dt"] for iv in intervals.values() for i in iv]
    suspects = silence_suspects(
        {
            proc: [float(r.get("t", 0.0)) for r in hb]
            for proc, hb in beats.items()
        },
        {proc: bool(finals.get(proc)) for proc in beats},
        now=now,
        suspect_factor=suspect_factor,
        median_interval=_median(all_intervals),
    )
    for s in suspects:
        hb = beats.get(s["proc"]) or []
        s["last_step"] = hb[-1].get("step") if hb else None
    summary["suspects"] = suspects
    return summary


def write_fleet_manifest(log_dir: str, summary: dict) -> Optional[str]:
    """Write the merged fleet manifest (``fleet/fleet.json``), atomically
    (tmp + ``os.replace`` — the manifest writer's discipline). Process 0
    owns the file in-run; offline tools recompute rather than overwrite.
    Returns the path, or None on I/O failure (telemetry never takes the
    run down)."""
    path = os.path.join(fleet_dir(log_dir), "fleet.json")
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(summary, f, indent=2, default=str)
        os.replace(tmp, path)
        return path
    except OSError:
        return None
