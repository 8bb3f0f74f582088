"""Declarative alert rules over heartbeat records (the port's own copy of
``sav_tpu/obs/alerts.py``, stdlib only).

The SLO two-window burn pair of
:class:`~sav_tpu_torch.serve.telemetry.SLOTracker`, generalized into data: a
rule is a named set of metric comparisons
against the heartbeat record (dotted paths into the beat — ``w.p99_ms``,
``slo.burn_fast``, ``queued``), a for-duration, a resolve hold, and a
severity, JSON-loadable so an operator arms a new alert without a
deploy::

    {"rules": [{"name": "p99-high", "metric": "w.p99_ms", "op": ">",
                "value": 250, "for_s": 10, "resolve_s": 10,
                "severity": "warn"}]}

The windowing discipline is the beats' own: every metric a rule reads
is already a *windowed* value (the live window's trailing ``w.*``
snapshot, the SLO burn windows), so a rule adds only the for-duration
hold on top — the Google-SRE shape (condition sustained for N seconds)
without re-deriving windows the telemetry already maintains.

State machine per rule (flap-suppressed, once-per-episode)::

    inactive -> pending (condition true)        no event
    pending  -> firing  (held for for_s)        ONE "firing" event
    pending  -> inactive (condition dropped)    no event
    firing   -> cooling (condition false)       no event
    cooling  -> firing  (condition returns      no event (same episode
                         within resolve_s)       — flap suppressed)
    cooling  -> resolved (held for resolve_s)   ONE "resolved" event

A missing or non-numeric metric evaluates the condition **false** —
exactly :class:`SLOTracker`'s semantics (``burning`` is False while a
burn window is still empty), which is what makes the built-in SLO rule
(:func:`slo_burn_rule`) bit-identical to the tracker on a replayed
stream.

Events append to ``fleet/alerts.jsonl`` (one JSON line per transition,
torn-tail-tolerant readers, same substrate discipline as the heartbeat
streams); active rule names are stamped into the emitting replica's
heartbeats and the episode summary into the serve manifest's
``notes.alerts``. Evaluation runs at heartbeat cadence only, never on the
batcher's or the engine's request paths.

Stdlib only (no torch, no numpy): rules evaluate in the serving plane and
load on any machine over copied logs. The files and lines are
``sav_tpu``'s, so either side's readers read the other's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

ALERTS_SCHEMA = 1

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


def alerts_path(log_dir: str) -> str:
    return os.path.join(log_dir, "fleet", "alerts.jsonl")


def _lookup(record: dict, path: str):
    """Dotted-path read into a beat record (``w.p99_ms`` ->
    ``record["w"]["p99_ms"]``); None on any missing hop."""
    node = record
    for part in path.split("."):
        if not isinstance(node, dict):
            return None
        node = node.get(part)
    return node


class AlertRule:
    """One declarative rule: AND-composed conditions + hold durations.

    ``when`` is a list of ``(metric, op, value)`` conditions — ALL must
    hold (the SLO burn pair is the canonical two-condition rule). The
    JSON shorthand ``{"metric", "op", "value"}`` becomes a one-condition
    ``when``.
    """

    __slots__ = ("name", "severity", "for_s", "resolve_s", "when")

    def __init__(
        self,
        name: str,
        *,
        when: list,
        severity: str = "warn",
        for_s: float = 0.0,
        resolve_s: float = 0.0,
    ):
        if not name:
            raise ValueError("alert rule needs a name")
        if not when:
            raise ValueError(f"alert rule {name!r} has no conditions")
        conditions = []
        for metric, op, value in when:
            if op not in _OPS:
                raise ValueError(
                    f"alert rule {name!r}: unknown comparator {op!r} "
                    f"(have {sorted(_OPS)})"
                )
            conditions.append((str(metric), str(op), float(value)))
        self.name = str(name)
        self.severity = str(severity)
        self.for_s = float(for_s)
        self.resolve_s = float(resolve_s)
        self.when = tuple(conditions)

    @classmethod
    def from_dict(cls, doc: dict) -> "AlertRule":
        when = doc.get("when")
        if when is None and "metric" in doc:
            when = [{
                "metric": doc["metric"],
                "op": doc.get("op", ">"),
                "value": doc.get("value", 0.0),
            }]
        if not isinstance(when, list):
            raise ValueError(
                f"alert rule {doc.get('name')!r}: no conditions "
                "(want 'when' or metric/op/value shorthand)"
            )
        return cls(
            doc.get("name") or "",
            when=[
                (c.get("metric", ""), c.get("op", ">"),
                 c.get("value", 0.0))
                for c in when
            ],
            severity=doc.get("severity", "warn"),
            for_s=doc.get("for_s", 0.0),
            resolve_s=doc.get("resolve_s", 0.0),
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "severity": self.severity,
            "for_s": self.for_s,
            "resolve_s": self.resolve_s,
            "when": [
                {"metric": m, "op": op, "value": v}
                for m, op, v in self.when
            ],
        }

    def evaluate(self, record: dict) -> bool:
        """True iff every condition holds on this record. Missing /
        non-numeric metrics are FALSE (SLOTracker's empty-window
        semantics — the parity gate depends on this)."""
        for metric, op, value in self.when:
            observed = _lookup(record, metric)
            if not isinstance(observed, (int, float)) or isinstance(
                observed, bool
            ):
                return False
            if not _OPS[op](float(observed), value):
                return False
        return True


def slo_burn_rule(
    burn_threshold: float = 2.0, *, severity: str = "page"
) -> AlertRule:
    """The SLO fast/slow burn pair as ONE declarative rule — fires
    exactly when ``SLOTracker.state()["burning"]`` is True on the same
    beat (both windows non-empty and above threshold; for/resolve hold 0
    because the tracker's own windows already debounce)."""
    return AlertRule(
        "slo-burn",
        when=[
            ("slo.burn_fast", ">", float(burn_threshold)),
            ("slo.burn_slow", ">", float(burn_threshold)),
        ],
        severity=severity,
        for_s=0.0,
        resolve_s=0.0,
    )


def default_rules(slo_burn_threshold: float = 2.0) -> list:
    """The built-in rule set every armed replica carries: the SLO burn
    pair."""
    return [slo_burn_rule(slo_burn_threshold)]


def quality_rules() -> list:
    """The prediction-quality rule set — a SEPARATE set from
    :func:`default_rules` on purpose: the default set is exactly the SLO
    rule, and quality rules arm alongside it, not inside it. The serve
    engine's beats carry ``quality`` (its digest gates and probe ledger),
    the fleet router's beats ``shadow`` (the shadow's agreement).

    The two integrity rules gate on CUMULATIVE MONOTONIC counters
    (``quality.probe_mismatch``, ``shadow.breach``) with ``for_s=0``
    and a long ``resolve_s``: a planted fault fires exactly one
    episode that resolves only at finalize. The two drift
    rules (churn / entropy shift) gate on windowed statistics and
    debounce with for/resolve holds instead. Records without quality
    fields (training beats, pre-reference windows) evaluate False —
    missing metrics never fire."""
    return [
        AlertRule(
            "quality-churn",
            when=[("quality.churn", ">", 0.5)],
            severity="warn",
            for_s=10.0,
            resolve_s=30.0,
        ),
        AlertRule(
            "quality-entropy-shift",
            when=[("quality.entropy_shift", ">", 6.0)],
            severity="warn",
            for_s=10.0,
            resolve_s=30.0,
        ),
        AlertRule(
            "quality-probe-mismatch",
            when=[("quality.probe_mismatch", ">", 0.0)],
            severity="page",
            for_s=0.0,
            resolve_s=3600.0,
        ),
        AlertRule(
            "shadow-agreement",
            when=[("shadow.breach", ">", 0.0)],
            severity="page",
            for_s=0.0,
            resolve_s=3600.0,
        ),
    ]


def load_rules(source) -> list:
    """Rules from a JSON file path, a JSON string, or a parsed doc
    (``{"rules": [...]}`` or a bare list). Raises ValueError on
    malformed rules — arming a fleet with a typo'd rule set should fail
    loudly at startup, not silently never fire."""
    doc = source
    if isinstance(source, str):
        if os.path.exists(source):
            with open(source) as f:
                doc = json.load(f)
        else:
            doc = json.loads(source)
    if isinstance(doc, dict):
        doc = doc.get("rules")
    if not isinstance(doc, list):
        raise ValueError(
            "alert rules want {'rules': [...]} or a bare list"
        )
    return [AlertRule.from_dict(d) for d in doc]


class AlertEngine:
    """The firing/resolved state machine over a rule set.

    One engine per emitting process (each replica judges its OWN
    beats — per-replica alerts carry ``proc`` so a fleet view can
    attribute them). ``observe()`` is called once per heartbeat by the
    telemetry's cadenced beat path — never from a request path. Events append to ``fleet/alerts.jsonl``; a failed append
    drops the line (telemetry never takes serving down) but the state
    machine still advances.
    """

    def __init__(
        self,
        rules: list,
        *,
        log_dir: Optional[str] = None,
        proc: Optional[int] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.rules = list(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names: {names}")
        self.log_dir = log_dir
        self.proc = proc
        self._clock = clock
        self._state = {
            r.name: {"status": "inactive", "since": None, "episodes": 0}
            for r in self.rules
        }
        self.emitted = 0
        self.dropped = 0

    # -------------------------------------------------------- evaluation

    def observe(self, record: dict, now: Optional[float] = None) -> list:
        """Advance every rule on one beat record; returns (and appends)
        the transition events this beat produced."""
        now = self._clock() if now is None else float(now)
        events = []
        for rule in self.rules:
            state = self._state[rule.name]
            cond = rule.evaluate(record)
            status = state["status"]
            if status == "inactive":
                if cond:
                    state["status"] = "pending"
                    state["since"] = now
                    status = "pending"
            if status == "pending":
                if not cond:
                    state["status"] = "inactive"
                    state["since"] = None
                elif now - state["since"] >= rule.for_s:
                    state["status"] = "firing"
                    state["episodes"] += 1
                    events.append(self._event("firing", rule, record, now))
            elif status == "firing":
                if not cond:
                    state["status"] = "cooling"
                    state["since"] = now
                    status = "cooling"
            if status == "cooling":
                if cond:
                    # Flap suppression: the episode survives a dip
                    # shorter than resolve_s — no new event.
                    state["status"] = "firing"
                elif now - state["since"] >= rule.resolve_s:
                    state["status"] = "inactive"
                    state["since"] = None
                    events.append(
                        self._event("resolved", rule, record, now)
                    )
        if events:
            self._append(events)
        return events

    def finalize(self, now: Optional[float] = None) -> list:
        """End of stream: resolve every firing/cooling episode (an
        episode cannot outlive its emitter — the final beat is the
        recovery edge). Idempotent."""
        now = self._clock() if now is None else float(now)
        events = []
        for rule in self.rules:
            state = self._state[rule.name]
            if state["status"] in ("firing", "cooling"):
                state["status"] = "inactive"
                state["since"] = None
                events.append(self._event("resolved", rule, {}, now))
            elif state["status"] == "pending":
                state["status"] = "inactive"
                state["since"] = None
        if events:
            self._append(events)
        return events

    def _event(
        self, edge: str, rule: AlertRule, record: dict, now: float
    ) -> dict:
        observed = {}
        for metric, _, _ in rule.when:
            value = _lookup(record, metric)
            if isinstance(value, (int, float)) and not isinstance(
                value, bool
            ):
                observed[metric] = value
        event = {
            "v": ALERTS_SCHEMA,
            "kind": "alert",
            "event": edge,
            "rule": rule.name,
            "severity": rule.severity,
            "episode": self._state[rule.name]["episodes"],
            "t": round(now, 3),
        }
        if self.proc is not None:
            event["proc"] = self.proc
        if observed:
            event["observed"] = observed
        return event

    def _append(self, events: list) -> None:
        self.emitted += len(events)
        if self.log_dir is None:
            return
        path = alerts_path(self.log_dir)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # One write() per line: concurrent replicas append to the
            # shared file, and O_APPEND keeps whole small lines intact
            # (the torn-tolerant reader absorbs the pathological case).
            with open(path, "a") as f:
                for event in events:
                    f.write(json.dumps(event) + "\n")
                f.flush()
        except OSError:
            self.dropped += len(events)

    # ----------------------------------------------------------- queries

    def active(self) -> list:
        """Names of currently-firing rules (cooling counts: the episode
        is still open), sorted — the heartbeat stamp."""
        return sorted(
            name for name, s in self._state.items()
            if s["status"] in ("firing", "cooling")
        )

    def state(self) -> dict:
        """The manifest ``notes.alerts`` snapshot."""
        return {
            "schema": ALERTS_SCHEMA,
            "rules": len(self.rules),
            "active": self.active(),
            "episodes": {
                name: s["episodes"]
                for name, s in self._state.items()
                if s["episodes"]
            },
            "emitted": self.emitted,
            "dropped": self.dropped,
        }


# ---------------------------------------------------------------- readers


def read_alerts(log_dir: str) -> list:
    """Every alert event in ``fleet/alerts.jsonl``, oldest first
    (torn/foreign lines skipped — same discipline as the heartbeat
    readers)."""
    out = []
    try:
        with open(alerts_path(log_dir), "rb") as f:
            for raw in f:
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(doc, dict) and doc.get("kind") == "alert":
                    out.append(doc)
    except OSError:
        pass
    return out


def episodes(events: list) -> dict:
    """Fold an event list into per-rule episode accounting:
    ``{rule: {"fired": n, "resolved": n, "active": bool, "severity",
    "last_t"}}`` — the console's alert table and the bench line's
    episode assertions read this."""
    out: dict = {}
    for event in events:
        rule = event.get("rule")
        if not rule:
            continue
        entry = out.setdefault(rule, {
            "fired": 0, "resolved": 0, "active": False,
            "severity": event.get("severity"), "last_t": None,
        })
        edge = event.get("event")
        if edge == "firing":
            entry["fired"] += 1
            entry["active"] = True
        elif edge == "resolved":
            entry["resolved"] += 1
            entry["active"] = False
        entry["severity"] = event.get("severity", entry["severity"])
        entry["last_t"] = event.get("t", entry["last_t"])
    return out
