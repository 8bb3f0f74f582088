"""The port's declarative alert rules (``sav_tpu_torch.obs.alerts``) against
``sav_tpu.obs.alerts`` on the CPU: the same seeded beat sequences and rule
sets through both engines, compared exactly (the events file byte for byte,
the state, the episodes); the rule surface; and the built-in SLO burn rule
against the port's ``SLOTracker``. Every comparison is exact equality."""

import json

import numpy as np
import pytest

from sav_tpu.obs import alerts as jax_alerts
from sav_tpu_torch.obs import alerts
from sav_tpu_torch.serve.telemetry import SLOTracker

# An operator's rule file: the JSON shorthand, an AND of two conditions with
# holds, every comparator, and a rule on a metric no beat carries.
OPERATOR_RULES = {"rules": [
    {"name": "p99-high", "metric": "w.p99_ms", "op": ">", "value": 250, "for_s": 10,
     "resolve_s": 10, "severity": "warn"},
    {"name": "queue-and-slow", "when": [{"metric": "queued", "op": ">=", "value": 4},
                                        {"metric": "w.p50_ms", "op": ">", "value": 20}],
     "for_s": 2, "resolve_s": 20, "severity": "page"},
    {"name": "idle", "metric": "w.requests", "op": "==", "value": 0},
    {"name": "shed-any", "metric": "shed", "op": "!=", "value": 0, "resolve_s": 30},
    {"name": "occupancy-low", "metric": "w.occupancy", "op": "<", "value": 0.5, "for_s": 3},
    {"name": "burn-le", "metric": "slo.burn_fast", "op": "<=", "value": 0.5},
    {"name": "never", "metric": "not.a.metric", "op": ">", "value": 0},
]}


def _beats(seed: int, n: int = 160) -> list:
    """A seeded beat stream: p99 and queue ramps with bursts, SLO burns
    that cross the threshold and fall back, missing and non-numeric
    fields, booleans where numbers go, and quality fields on some beats."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = 1000.0 + 2.5 * i + float(rng.uniform(0.0, 0.4))
        burst = (i // 20) % 2 == 1
        w = {"requests": int(rng.integers(0, 3)) if i % 37 == 0 else int(rng.integers(1, 500)),
             "p50_ms": round(float(rng.uniform(5, 80 if burst else 30)), 3),
             "p99_ms": round(float(rng.uniform(100, 600 if burst else 260)), 3),
             "occupancy": round(float(rng.uniform(0.2, 1.0)), 4)}
        if i % 11 == 0:
            w["p99_ms"] = None
        if i % 13 == 0:
            w["occupancy"] = "n/a"
        fast = round(float(rng.uniform(0.0, 5.0 if burst else 1.5)), 4)
        slo = {"burn_fast": fast, "burn_slow": round(fast * float(rng.uniform(0.5, 1.5)), 4)}
        if i % 17 == 0:
            slo["burn_slow"] = None
        beat = {"t": round(t, 3), "w": w, "slo": slo,
                "queued": int(rng.integers(0, 16)), "shed": int(rng.integers(0, 2)) * (i // 40)}
        if i % 19 == 0:
            beat["queued"] = True  # a bool is not a number: evaluates False
        if i % 7 == 0:
            beat["quality"] = {"churn": round(float(rng.uniform(0, 1)), 3),
                               "entropy_shift": round(float(rng.uniform(0, 9)), 3),
                               "probe_mismatch": int(i > 100)}
        out.append(beat)
    return out


def _rule_sets():
    return {
        "default": lambda mod: mod.default_rules(2.0),
        "default+quality": lambda mod: mod.default_rules(1.5) + mod.quality_rules(),
        "operator": lambda mod: mod.load_rules(json.dumps(OPERATOR_RULES)),
        "all": lambda mod: (mod.default_rules(2.0) + mod.quality_rules()
                            + mod.load_rules(OPERATOR_RULES)),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rule_set", sorted(_rule_sets()))
def test_alert_engine_events_state_and_episodes_equal_sav_tpus(tmp_path, seed, rule_set):
    make = _rule_sets()[rule_set]
    engines = {}
    for name, mod in (("port", alerts), ("jax", jax_alerts)):
        engines[name] = mod.AlertEngine(make(mod), log_dir=str(tmp_path / name), proc=3,
                                        clock=lambda: 0.0)
    for beat in _beats(seed):
        got = engines["port"].observe(beat, now=beat["t"])
        want = engines["jax"].observe(beat, now=beat["t"])
        assert got == want
        assert engines["port"].active() == engines["jax"].active()
    assert engines["port"].finalize(1500.0) == engines["jax"].finalize(1500.0)
    assert engines["port"].finalize(1501.0) == []  # idempotent
    assert engines["port"].state() == engines["jax"].state()
    files = {name: (tmp_path / name / "fleet" / "alerts.jsonl") for name in engines}
    if engines["jax"].emitted:
        assert files["port"].read_bytes() == files["jax"].read_bytes()
    else:
        assert not files["port"].exists() and not files["jax"].exists()
    events = alerts.read_alerts(str(tmp_path / "port"))
    assert events == jax_alerts.read_alerts(str(tmp_path / "jax"))
    assert alerts.episodes(events) == jax_alerts.episodes(events)
    # Each reader reads the other's file.
    assert alerts.read_alerts(str(tmp_path / "jax")) == events


def test_the_seeded_streams_fire_and_resolve():
    """The parity above is not vacuous: the streams open episodes of the
    SLO rule, the holds' rules and a quality rule, and every one resolves."""
    engine = alerts.AlertEngine(alerts.default_rules(2.0) + alerts.quality_rules()
                                + alerts.load_rules(OPERATOR_RULES))
    for beat in _beats(0):
        engine.observe(beat, now=beat["t"])
    engine.finalize(1500.0)
    state = engine.state()
    for rule in ("slo-burn", "p99-high", "queue-and-slow", "quality-probe-mismatch",
                 "shed-any"):
        assert state["episodes"].get(rule, 0) >= 1, (rule, state)
    assert "never" not in state["episodes"]
    assert state["active"] == []


def test_rule_surface_equals_sav_tpus(tmp_path):
    for doc in OPERATOR_RULES["rules"]:
        rule, jax_rule = alerts.AlertRule.from_dict(doc), jax_alerts.AlertRule.from_dict(doc)
        assert rule.to_dict() == jax_rule.to_dict()
        assert alerts.AlertRule.from_dict(rule.to_dict()).to_dict() == rule.to_dict()
    for mod_rules, jax_rules in ((alerts.default_rules(3.0), jax_alerts.default_rules(3.0)),
                                 (alerts.quality_rules(), jax_alerts.quality_rules()),
                                 ([alerts.slo_burn_rule(1.0, severity="warn")],
                                  [jax_alerts.slo_burn_rule(1.0, severity="warn")])):
        assert [r.to_dict() for r in mod_rules] == [r.to_dict() for r in jax_rules]
    # load_rules from a file path, JSON text, a parsed doc and a bare list.
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(OPERATOR_RULES))
    for source in (str(path), json.dumps(OPERATOR_RULES), OPERATOR_RULES,
                   OPERATOR_RULES["rules"]):
        assert ([r.to_dict() for r in alerts.load_rules(source)]
                == [r.to_dict() for r in jax_alerts.load_rules(source)])
    # evaluate: missing hops, non-numeric values and booleans are False.
    rule = alerts.AlertRule("r", when=[("a.b", ">", 1.0)])
    jax_rule = jax_alerts.AlertRule("r", when=[("a.b", ">", 1.0)])
    for record in ({}, {"a": 3}, {"a": {"b": True}}, {"a": {"b": "9"}}, {"a": {"b": 1.0}},
                   {"a": {"b": 2}}, {"a": {"b": None}}):
        assert rule.evaluate(record) == jax_rule.evaluate(record)
    assert rule.evaluate({"a": {"b": 2}}) and not rule.evaluate({"a": {"b": True}})


@pytest.mark.parametrize("bad", [
    {"rules": [{"name": "x", "metric": "m", "op": "~", "value": 1}]},
    {"rules": [{"name": "", "metric": "m"}]},
    {"rules": [{"name": "x", "when": []}]},
    {"rules": [{"name": "x"}]},
    {"not_rules": []},
])
def test_malformed_rules_raise_on_both_sides(bad):
    with pytest.raises(ValueError):
        jax_alerts.load_rules(bad)
    with pytest.raises(ValueError):
        alerts.load_rules(bad)


def test_duplicate_rule_names_raise():
    with pytest.raises(ValueError, match="duplicate"):
        alerts.AlertEngine(alerts.default_rules() + alerts.default_rules())


def test_slo_burn_rule_fires_exactly_when_the_tracker_burns():
    """The built-in rule replayed beside the port's SLOTracker: the rule is
    active on a beat exactly when ``state()["burning"]`` is, so it opens an
    episode at each rising edge of ``burning`` and resolves at each falling
    edge."""
    rng = np.random.default_rng(7)
    t = [0.0]
    tracker = SLOTracker(target=0.99, fast_window_s=60.0, slow_window_s=600.0,
                         burn_threshold=2.0, clock=lambda: t[0])
    engine = alerts.AlertEngine(alerts.default_rules(2.0))
    edges, burning_before = [], False
    for i in range(400):
        t[0] = 5.0 * i
        phase = (i // 60) % 3
        miss_p = (0.0, 0.2, 0.01)[phase]
        for _ in range(int(rng.integers(1, 20))):
            tracker.observe_request(bool(rng.uniform() >= miss_p), now=t[0])
        if i % 29 == 0:
            tracker.observe_outcomes(3, 3, now=t[0])  # sheds count as misses
        state = tracker.state(now=t[0])
        events = engine.observe({"slo": state}, now=t[0])
        assert (engine.active() == ["slo-burn"]) == state["burning"]
        if state["burning"] != burning_before:
            edges.append("firing" if state["burning"] else "resolved")
        burning_before = state["burning"]
        assert [e["event"] for e in events] == edges[len(edges) - len(events):]
    assert edges.count("firing") >= 2, edges
    assert engine.state()["episodes"]["slo-burn"] == edges.count("firing")
