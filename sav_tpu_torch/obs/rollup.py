"""Heartbeat rollups — incremental time-series aggregation (the port's own
copy of ``sav_tpu/obs/rollup.py``, stdlib only; its files are
``sav_tpu``'s, so either side's readers read the other's).

The metrics pipeline between the raw append-only heartbeat streams
(``fleet/proc_<i>.jsonl`` + ``fleet/router.jsonl``) and their readers: a
:class:`Roller` consumes each stream exactly once (byte-offset cursor,
O(new bytes) per refresh — the ``bytes_read`` gauge), buckets every numeric heartbeat metric onto a
fixed resolution ladder (:data:`RESOLUTIONS`, 10s -> 60s -> 600s), and
appends closed buckets as one JSON line each to
``fleet/rollup_<res>.jsonl``::

    {"v": 1, "res": 10, "bucket": 1722000300, "proc": 1,
     "metric": "p99_ms", "n": 12, "min": ..., "max": ...,
     "mean": ..., "p50": ..., "p99": ...}

``proc`` is the replica's process index for ``proc_<i>.jsonl`` streams
and the string ``"router"`` for the router stream (its metrics are also
``router_``-prefixed, so merged views cannot confuse a router queue
with a replica queue).

Crash discipline (the substrate's, extended):

- **Torn tails.** Only byte ranges ending in a newline are consumed; a
  SIGKILLed writer's partial last line stays un-consumed until the next
  roll sees its terminator (or a restarted writer glues a fresh line
  onto it — then the glued garbage line is skipped like every torn
  line, ``read_heartbeats``'s discipline).
- **Torn/missing/stale cursor.** The cursor (``fleet/rollup.cursor.json``)
  is written atomically (tmp + ``os.replace``) *after* the rollup
  appends. An unreadable/missing cursor, or a stream shorter than its
  recorded offset (truncation), triggers a full **rebuild**: streams
  re-read from byte 0 and every ``rollup_<res>.jsonl`` atomically
  rewritten — no double-count, no gap.
- **Crash between append and cursor write.** The next roll re-reads the
  un-cursored bytes and re-appends the same closed buckets; readers
  (:func:`read_rollup`) deduplicate by ``(bucket, proc, metric)``
  keeping the NEWEST line, so replayed appends are idempotent.

Retention is bounded per tier (:data:`RETENTION_BUCKETS` buckets): when
a tier's file outgrows its budget the Roller compacts it in place
(atomic rewrite keeping the newest buckets), so a week-long fleet never
grows an unbounded 10s tier.

Single-writer by contract: ONE roller per log dir at a time (in-run, or
a reader post-run or offline) — the cursor file is the handoff, not a
lock.

Stdlib only (no torch, no numpy): rollups are readable and writable on
any machine over copied logs, and rolling happens at heartbeat cadence or
offline, never per request.
"""

from __future__ import annotations

import json
import os
from typing import Optional

ROLLUP_SCHEMA = 1

#: The resolution ladder (seconds per bucket), finest first.
RESOLUTIONS = (10, 60, 600)

#: Per-tier retention budget, in buckets (not seconds): the 10s tier
#: keeps ~1h, the 60s tier ~6h, the 600s tier ~2.5 days at the default.
RETENTION_BUCKETS = 360

#: Compaction hysteresis: rewrite a tier only when its line count
#: exceeds the retained-line estimate by this factor (an append-heavy
#: roller must not rewrite the file on every roll).
_COMPACT_SLACK = 2.0

#: Numeric top-level keys worth rolling from each heartbeat kind. The
#: windowed snapshot (``w``) is rolled wholesale (every numeric value).
_SERVE_KEYS = ("capacity_rps", "queued", "inflight", "shed", "rejected")
_ROUTER_KEYS = (
    "completed", "throughput_rps", "inflight", "shed", "rerouted",
    "transport_failures", "view_age_s", "router_overhead_ms",
)
_HB_KEYS = ("images_per_sec", "loss", "step")

#: Read-side instrumentation: bumped once per :func:`read_rollup` call,
#: so a caller can tell a render from rollups from a raw-stream parse.
READS = {"read_rollup": 0}


def rollup_path(log_dir: str, res: int) -> str:
    return os.path.join(log_dir, "fleet", f"rollup_{int(res)}.jsonl")


def cursor_path(log_dir: str) -> str:
    return os.path.join(log_dir, "fleet", "rollup.cursor.json")


def metrics_from(record: dict) -> dict:
    """The rollable numeric metrics of one heartbeat record.

    ``kind=serve``: the windowed snapshot (``w.*`` flattened, e.g.
    ``p99_ms``/``throughput_rps``/``queue_depth_last`` ->
    ``queue_depth``) plus the capacity/queue counters.
    ``kind=router``: the same shape, ``router_``-prefixed.
    ``kind=hb`` (training): throughput/loss/step frontier.
    Unknown kinds roll nothing (forward-compat: a future stream kind
    must not crash an old roller).
    """
    kind = record.get("kind")
    out: dict = {}
    if kind == "serve" or kind == "router":
        prefix = "router_" if kind == "router" else ""
        w = record.get("w")
        if isinstance(w, dict):
            for key, value in w.items():
                if key == "window_s" or not isinstance(
                    value, (int, float)
                ) or isinstance(value, bool):
                    continue
                name = "queue_depth" if key == "queue_depth_last" else key
                out[prefix + name] = float(value)
        keys = _ROUTER_KEYS if kind == "router" else _SERVE_KEYS
        for key in keys:
            value = record.get(key)
            if isinstance(value, (int, float)) and not isinstance(
                value, bool
            ):
                # No double prefix: router_overhead_ms stays itself.
                name = (
                    key if prefix and key.startswith(prefix)
                    else prefix + key
                )
                out[name] = float(value)
        slo = record.get("slo")
        if kind == "serve" and isinstance(slo, dict):
            burn = slo.get("burn_rate")
            if isinstance(burn, (int, float)):
                out["burn_rate"] = float(burn)
        # Prediction-quality snapshots roll under distinct prefixes so
        # the alert fold reads them from rollups alone. Nested dicts (per-pair stats) stay in the
        # raw beats — rollups carry only the scalar headline.
        quality = record.get("quality")
        if kind == "serve" and isinstance(quality, dict):
            for key, value in quality.items():
                if isinstance(value, (int, float)) and not isinstance(
                    value, bool
                ):
                    out["quality_" + key] = float(value)
        shadow = record.get("shadow")
        if kind == "router" and isinstance(shadow, dict):
            for key, value in shadow.items():
                if isinstance(value, (int, float)) and not isinstance(
                    value, bool
                ):
                    out["router_shadow_" + key] = float(value)
    elif kind == "hb":
        for key in _HB_KEYS:
            value = record.get(key)
            if isinstance(value, (int, float)) and not isinstance(
                value, bool
            ):
                out[key] = float(value)
    return out


def _percentile(ordered: list, q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list (the latency
    ledger's convention, inlined so rollups import nothing from serve)."""
    if len(ordered) == 1:
        return ordered[0]
    rank = q / 100.0 * (len(ordered) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(ordered) - 1)
    frac = rank - lo
    return ordered[lo] * (1.0 - frac) + ordered[hi] * frac


def _fold(values: list) -> dict:
    ordered = sorted(values)
    n = len(ordered)
    return {
        "n": n,
        "min": round(ordered[0], 6),
        "max": round(ordered[-1], 6),
        "mean": round(sum(ordered) / n, 6),
        "p50": round(_percentile(ordered, 50.0), 6),
        "p99": round(_percentile(ordered, 99.0), 6),
    }


class Roller:
    """Incremental roller over one log dir's heartbeat streams.

    ``roll_once()`` consumes the streams' new complete lines and
    appends every *closed* bucket (a bucket closes when its own stream's
    newest timestamp has moved past the bucket's end — per-stream
    watermarks, so a lagging replica cannot have its open bucket closed
    by a faster sibling's clock). ``flush()`` force-closes the pending
    buckets at end of run. Single-writer by contract (module docstring).
    """

    def __init__(
        self,
        log_dir: str,
        *,
        resolutions: tuple = RESOLUTIONS,
        retention_buckets: int = RETENTION_BUCKETS,
    ):
        self.log_dir = log_dir
        self.resolutions = tuple(int(r) for r in resolutions)
        self.retention_buckets = int(retention_buckets)
        self.bytes_read = 0
        self.buckets_closed = 0
        self.rolls = 0

    # ------------------------------------------------------------- cursor

    def _load_cursor(self) -> Optional[dict]:
        """The cursor doc, or None when a full rebuild is required
        (missing / torn / wrong schema)."""
        try:
            with open(cursor_path(self.log_dir)) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return None
        if not isinstance(doc, dict) or doc.get("v") != ROLLUP_SCHEMA:
            return None
        for key in ("streams", "pending", "lines"):
            if not isinstance(doc.get(key), dict):
                return None
        return doc

    def _save_cursor(self, doc: dict) -> None:
        path = cursor_path(self.log_dir)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            pass

    # ------------------------------------------------------------- streams

    def _streams(self) -> list:
        """``(name, proc, path)`` for every rollable stream on disk."""
        root = os.path.join(self.log_dir, "fleet")
        out = []
        if not os.path.isdir(root):
            return out
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if name.startswith("proc_") and name.endswith(".jsonl"):
                try:
                    proc = int(name[len("proc_"):-len(".jsonl")])
                except ValueError:
                    continue
                out.append((name, proc, path))
            elif name == "router.jsonl":
                out.append((name, "router", path))
        return out

    def _read_new(self, path: str, offset: int) -> tuple:
        """``(records, new_offset, stale)``: the complete JSON lines
        past ``offset``. ``stale`` flags a truncated stream (size below
        the cursor's offset) — the caller rebuilds."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return [], offset, False
        if size < offset:
            return [], offset, True
        if size == offset:
            return [], offset, False
        records = []
        consumed = offset
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(size - offset)
        except OSError:
            return [], offset, False
        self.bytes_read += len(data)
        end = data.rfind(b"\n")
        if end < 0:
            return [], offset, False  # torn tail only: consume nothing
        for raw in data[: end + 1].split(b"\n"):
            line = raw.decode("utf-8", "replace").strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn/glued line (SIGKILLed writer restart)
            if isinstance(doc, dict):
                records.append(doc)
        consumed = offset + end + 1
        return records, consumed, False

    # ------------------------------------------------------------- rolling

    def roll_once(self) -> dict:
        """One incremental pass; returns :meth:`stats`. Never raises on
        stream I/O (telemetry must not take its owner down)."""
        cursor = self._load_cursor()
        rebuild = cursor is None
        if cursor is None:
            cursor = {
                "v": ROLLUP_SCHEMA, "streams": {}, "pending": {},
                "lines": {},
            }
        closed: dict = {}
        for name, proc, path in self._streams():
            state = cursor["streams"].get(name) or {"offset": 0}
            records, offset, stale = self._read_new(
                path, int(state.get("offset", 0))
            )
            if stale:
                # Truncated stream: one stream lying about its past
                # invalidates every tier it fed.
                return self._rebuild()
            watermark = float(state.get("watermark", 0.0))
            pending = cursor["pending"]
            for record in records:
                t = record.get("t")
                if not isinstance(t, (int, float)):
                    continue
                watermark = max(watermark, float(t))
                metrics = metrics_from(record)
                for res in self.resolutions:
                    bucket = int(t // res) * res
                    for metric, value in metrics.items():
                        key = f"{res}|{name}|{metric}|{bucket}"
                        entry = pending.get(key)
                        if entry is None:
                            entry = {
                                "res": res, "proc": proc,
                                "metric": metric, "bucket": bucket,
                                "vals": [],
                            }
                            pending[key] = entry
                        entry["vals"].append(value)
            # Close this stream's buckets its own clock has passed.
            for key in list(cursor["pending"]):
                entry = cursor["pending"][key]
                res_s, stream_name, _, _ = key.split("|", 3)
                if stream_name != name:
                    continue
                if watermark >= entry["bucket"] + entry["res"]:
                    closed.setdefault(entry["res"], []).append(
                        cursor["pending"].pop(key)
                    )
            cursor["streams"][name] = {
                "offset": offset, "watermark": watermark,
            }
        self._append_closed(cursor, closed)
        if rebuild:
            # A fresh cursor over possibly pre-existing rollup files:
            # rewrite the tiers so replayed history cannot double-count.
            return self._rebuild_from(cursor, closed)
        self._compact(cursor)
        self._save_cursor(cursor)
        self.rolls += 1
        return self.stats()

    def flush(self) -> dict:
        """Force-close every pending bucket (end of run: the streams
        are final, nothing more is coming). Appends + cursor like
        :meth:`roll_once`."""
        cursor = self._load_cursor()
        if cursor is None:
            self.roll_once()
            cursor = self._load_cursor()
            if cursor is None:
                return self.stats()
        closed: dict = {}
        for key in list(cursor["pending"]):
            entry = cursor["pending"].pop(key)
            closed.setdefault(entry["res"], []).append(entry)
        self._append_closed(cursor, closed)
        self._compact(cursor)
        self._save_cursor(cursor)
        return self.stats()

    def _append_closed(self, cursor: dict, closed: dict) -> None:
        for res, entries in sorted(closed.items()):
            path = rollup_path(self.log_dir, res)
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "a") as f:
                    for entry in sorted(
                        entries,
                        key=lambda e: (e["bucket"], str(e["proc"])),
                    ):
                        f.write(json.dumps(self._line(entry)) + "\n")
                    f.flush()
            except OSError:
                continue
            self.buckets_closed += len(entries)
            cursor["lines"][str(res)] = (
                int(cursor["lines"].get(str(res), 0)) + len(entries)
            )

    def _line(self, entry: dict) -> dict:
        line = {
            "v": ROLLUP_SCHEMA,
            "res": entry["res"],
            "bucket": entry["bucket"],
            "proc": entry["proc"],
            "metric": entry["metric"],
        }
        line.update(_fold(entry["vals"]))
        return line

    # ------------------------------------------------------ rebuild/compact

    def _rebuild(self) -> dict:
        """Full re-roll after a truncation: drop the cursor and take
        roll_once's rebuild branch (read from byte 0, rewrite tiers).
        No recursion risk: a fresh cursor's offsets are 0, so the stale
        check cannot re-trigger."""
        try:
            os.remove(cursor_path(self.log_dir))
        except OSError:
            pass
        return self.roll_once()

    def _rebuild_from(self, cursor: dict, closed: dict) -> dict:
        """Atomic tier rewrite from one full pass's closed buckets
        (``_append_closed`` already wrote them; rewrite = dedup +
        drop pre-crash lines that the replayed pass did not produce)."""
        for res in self.resolutions:
            path = rollup_path(self.log_dir, res)
            entries = closed.get(res, [])
            lines = [self._line(e) for e in sorted(
                entries, key=lambda e: (e["bucket"], str(e["proc"]))
            )]
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    for line in lines:
                        f.write(json.dumps(line) + "\n")
                os.replace(tmp, path)
            except OSError:
                continue
            cursor["lines"][str(res)] = len(lines)
        self._compact(cursor)
        self._save_cursor(cursor)
        self.rolls += 1
        return self.stats()

    def _compact(self, cursor: dict) -> None:
        """Bound each tier to the retention budget (newest buckets win).
        Rewrites only past the hysteresis factor — appends stay cheap."""
        for res in self.resolutions:
            path = rollup_path(self.log_dir, res)
            count = int(cursor["lines"].get(str(res), 0))
            # Budget in LINES: retention_buckets buckets x however many
            # (proc, metric) series exist; estimate from the live file
            # only when the raw line count crosses the slack threshold.
            if count <= self.retention_buckets * _COMPACT_SLACK:
                continue
            lines = read_rollup(self.log_dir, res)
            if not lines:
                cursor["lines"][str(res)] = 0
                continue
            newest = max(line["bucket"] for line in lines)
            horizon = newest - self.retention_buckets * res
            kept = [line for line in lines if line["bucket"] >= horizon]
            series = {
                (line["proc"], line["metric"]) for line in kept
            }
            budget = self.retention_buckets * max(len(series), 1)
            if len(kept) > budget:
                kept.sort(key=lambda e: e["bucket"])
                kept = kept[-budget:]
            try:
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    for line in kept:
                        f.write(json.dumps(line) + "\n")
                os.replace(tmp, path)
            except OSError:
                continue
            cursor["lines"][str(res)] = len(kept)

    def stats(self) -> dict:
        return {
            "bytes_read": self.bytes_read,
            "buckets_closed": self.buckets_closed,
            "rolls": self.rolls,
        }


def roll(log_dir: str, *, flush: bool = False) -> dict:
    """One-shot convenience: roll a log dir's new bytes (and optionally
    force-close the pending tail buckets). Returns the roller stats."""
    roller = Roller(log_dir)
    stats = roller.roll_once()
    if flush:
        stats = roller.flush()
    return stats


# ---------------------------------------------------------------- readers


def read_rollup(
    log_dir: str,
    res: int,
    *,
    metric: Optional[str] = None,
    proc=None,
) -> list:
    """One tier's deduplicated bucket lines, sorted by bucket.

    Replayed appends (a roller crash between append and cursor write)
    produce duplicate ``(bucket, proc, metric)`` lines; the NEWEST line
    wins. Torn tails and unknown-version lines are skipped (readers
    tolerate future rollers). ``metric``/``proc`` filter the result.
    """
    READS["read_rollup"] += 1
    path = rollup_path(log_dir, res)
    dedup: dict = {}
    try:
        with open(path, "rb") as f:
            for raw in f:
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail of a killed roller
                if not isinstance(doc, dict):
                    continue
                key = (doc.get("bucket"), str(doc.get("proc")),
                       doc.get("metric"))
                if None in key:
                    continue
                dedup[key] = doc
    except OSError:
        return []
    out = [
        doc for doc in dedup.values()
        if (metric is None or doc.get("metric") == metric)
        and (proc is None or str(doc.get("proc")) == str(proc))
    ]
    out.sort(key=lambda e: (e["bucket"], str(e["proc"]), e["metric"]))
    return out


def finest_rollup(log_dir: str) -> tuple:
    """``(res, lines)`` for the finest tier with data (the default
    view), or ``(None, [])`` when nothing has been rolled."""
    for res in RESOLUTIONS:
        lines = read_rollup(log_dir, res)
        if lines:
            return res, lines
    return None, []


def series(lines: list, metric: str, *, proc=None) -> list:
    """``[(bucket, value)]`` for one metric: per-bucket mean, summed
    across procs by default (fleet view), filtered to one proc when
    given. The fleet-capacity/projected-load folds read THIS."""
    per_bucket: dict = {}
    for line in lines:
        if line.get("metric") != metric:
            continue
        if proc is not None and str(line.get("proc")) != str(proc):
            continue
        mean = line.get("mean")
        if not isinstance(mean, (int, float)):
            continue
        per_bucket[line["bucket"]] = (
            per_bucket.get(line["bucket"], 0.0) + float(mean)
        )
    return sorted(per_bucket.items())


# ----------------------------------------------------------- projections


def robust_slope(points: list) -> Optional[float]:
    """Theil–Sen slope (median of pairwise slopes) over ``[(t, v)]`` —
    one straggling bucket cannot bend the projection the way a
    least-squares fit would. None below 2 distinct timestamps. Pairs
    are capped (stride sampling) so a long series stays cheap."""
    pts = sorted(
        (float(t), float(v)) for t, v in points
        if isinstance(t, (int, float)) and isinstance(v, (int, float))
    )
    if len(pts) > 60:
        stride = -(-len(pts) // 60)
        pts = pts[::stride] + pts[-1:]
    slopes = []
    for i in range(len(pts)):
        for j in range(i + 1, len(pts)):
            dt = pts[j][0] - pts[i][0]
            if dt > 0:
                slopes.append((pts[j][1] - pts[i][1]) / dt)
    if not slopes:
        return None
    slopes.sort()
    n = len(slopes)
    mid = slopes[n // 2]
    return mid if n % 2 else 0.5 * (slopes[n // 2 - 1] + mid)


def project_load(points: list, *, horizon_s: float = 60.0) -> Optional[dict]:
    """Projected fleet load ``horizon_s`` ahead of the newest bucket:
    newest value + robust slope x horizon, floored at 0 (a draining
    fleet projects to idle, not to negative traffic). None without at
    least one point; slope None (single bucket) projects flat."""
    pts = [
        (float(t), float(v)) for t, v in points
        if isinstance(t, (int, float)) and isinstance(v, (int, float))
    ]
    if not pts:
        return None
    pts.sort()
    last_t, last_v = pts[-1]
    slope = robust_slope(pts)
    projected = last_v + (slope or 0.0) * float(horizon_s)
    return {
        "now_rps": round(last_v, 3),
        "slope_rps_per_s": round(slope, 6) if slope is not None else None,
        "horizon_s": float(horizon_s),
        "projected_rps": round(max(projected, 0.0), 3),
    }
