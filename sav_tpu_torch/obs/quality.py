"""Prediction-quality accounting: windowed digest distributions, golden
probe bookkeeping, and shadow-replica agreement scoring.

Port of ``sav_tpu/obs/quality.py``. Everything here is stdlib-only on
purpose: this module is imported by the serve telemetry thread and by the
Router, neither of which may drag an array library into a process that only
routes bytes (``tests/test_torch_router.py``'s import proof pins it). All
array math (the in-graph digests themselves, probe fingerprints) lives in
``sav_tpu_torch.serve.quality``; this module only *folds* the scalar
streams those produce.

Three folds:

- :class:`QualityTracker` — windowed distributions of the per-row
  output digests (top-1 index, top-1 margin, predictive entropy) with
  robust median+MAD drift gates against a frozen reference window:
  prediction churn (total-variation distance of the top-1 class
  histogram), entropy shift (robust z of the entropy median), and PSI
  (population stability index) of the class histogram.
- :class:`ProbeLedger` — golden-probe run accounting: ok/mismatch/shed
  counters, the expected and last-observed fingerprints, and
  ``probe_ok_frac`` (None until a probe ran — skip, never zero-fill).
- :class:`AgreementScorer` — shadow-replica agreement keyed by
  (primary_dtype, shadow_dtype) so an int8 replica shadowing a bf16
  primary is judged against the int8 tolerance envelope (the int8 arm's
  contract: same argmax, rel max-abs-diff <= 0.1) and never flagged by
  the same-dtype rule.

The breach and mismatch counters are CUMULATIVE MONOTONIC by design:
the default alert rules (``obs.alerts.quality_rules``) gate on them
with ``for_s=0`` so a planted fault fires exactly one episode that
resolves at finalize — the same exactly-once shape the straggler
battery pins for latency alerts.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Optional

from sav_tpu_torch.obs.fleet import MAD_SCALE, _mad, _median

# Frozen-reference size: the tracker needs enough rows for a stable
# class histogram before judging drift against it. Small on purpose so
# short benches still freeze a reference.
REFERENCE_MIN = 256

# Smoothing mass for PSI: empty histogram cells would otherwise make
# ln(p/q) blow up on any class the reference never saw.
_PSI_EPS = 1e-4

# Per-(primary_dtype, shadow_dtype) tolerance envelopes for shadow
# scoring: relative logit max-abs-diff ceilings, ``rel`` meaning
# relative to the primary's logit max-abs. Same-dtype replicas with
# identical weights produce bit-identical logits under a fixed
# program, so the same-dtype envelope is tight; any pair involving
# int8 against a float dtype inherits the int8 arm's envelope
# (|f - q|.max() <= 0.1 * |f|.max(), same argmax).
_SAME_DTYPE_REL = 1e-2
_INT8_MIXED_REL = 0.1


def pair_key(primary_dtype: str, shadow_dtype: str) -> str:
    return f"{primary_dtype or '?'}->{shadow_dtype or '?'}"


def envelope_rel(primary_dtype: str, shadow_dtype: str) -> float:
    """The logit rel-diff ceiling for a dtype pair."""
    a, b = (primary_dtype or ""), (shadow_dtype or "")
    if a != b and ("int8" in (a, b)):
        return _INT8_MIXED_REL
    return _SAME_DTYPE_REL


class QualityTracker:
    """Windowed output-digest distributions with drift gates vs a
    frozen reference window.

    ``observe_digests`` is hot-path-safe by construction: it only
    appends to bounded deques under a lock (the SlidingWindow idiom).
    All gate math — medians, MADs, histograms, PSI — runs in
    :meth:`snapshot`, which only the telemetry beat thread calls. Neither
    ``observe_digests`` nor ``score_shadow`` may sync a device: they take
    host values that already rode the batch's one result copy."""

    def __init__(self, window: int = 512, reference_min: int = REFERENCE_MIN):
        self._lock = threading.Lock()
        self._window = int(window)
        self._top1 = collections.deque(maxlen=self._window)
        self._margin = collections.deque(maxlen=self._window)
        self._entropy = collections.deque(maxlen=self._window)
        self._reference_min = int(reference_min)
        self._seen = 0
        self._num_classes = 0
        # Frozen once _seen crosses reference_min: (class hist fracs,
        # entropy median, entropy MAD). Drift is judged against this,
        # not against a sliding baseline that would absorb the drift.
        self._ref: Optional[tuple] = None

    def observe_digests(self, top1, margin, entropy, num_classes: int = 0) -> None:
        """Append one batch of per-row digests (parallel lists of
        int/float scalars — already host-side, already past the single
        result fetch)."""
        with self._lock:
            self._top1.extend(int(t) for t in top1)
            self._margin.extend(float(m) for m in margin)
            self._entropy.extend(float(e) for e in entropy)
            self._seen += len(top1)
            if num_classes:
                self._num_classes = max(self._num_classes, int(num_classes))
            if self._ref is None and self._seen >= self._reference_min:
                self._ref = (
                    self._hist_locked(),
                    _median(list(self._entropy)),
                    _mad(list(self._entropy), _median(list(self._entropy)) or 0.0),
                )

    def _hist_locked(self) -> dict:
        counts: dict = {}
        for t in self._top1:
            counts[t] = counts.get(t, 0) + 1
        n = max(1, len(self._top1))
        return {k: v / n for k, v in counts.items()}

    def snapshot(self) -> dict:
        """The quality fields one heartbeat carries. Gate math happens
        here, at beat cadence — never per request."""
        with self._lock:
            n = len(self._top1)
            if not n:
                return {"n": 0}
            hist = self._hist_locked()
            ent = list(self._entropy)
            mar = list(self._margin)
            ref = self._ref
        ent_med = _median(ent) or 0.0
        out = {
            "n": n,
            "seen": self._seen,
            "entropy_med": round(ent_med, 6),
            "margin_med": round(_median(mar) or 0.0, 6),
        }
        if ref is None:
            return out
        ref_hist, ref_med, ref_mad = ref
        classes = set(hist) | set(ref_hist)
        # Prediction churn: total-variation distance of top-1 class
        # histograms — 0 when the class mix matches the reference, 1
        # when disjoint.
        churn = 0.5 * sum(
            abs(hist.get(c, 0.0) - ref_hist.get(c, 0.0)) for c in classes
        )
        # PSI over the same bins, epsilon-smoothed.
        psi = 0.0
        for c in classes:
            p = hist.get(c, 0.0) + _PSI_EPS
            q = ref_hist.get(c, 0.0) + _PSI_EPS
            psi += (p - q) * math.log(p / q)
        # Entropy shift: robust z of the current entropy median against
        # the frozen reference (MAD-scaled, the obs.fleet convention).
        denom = max(MAD_SCALE * (ref_mad or 0.0), 1e-6)
        out.update(
            {
                "churn": round(churn, 6),
                "psi": round(psi, 6),
                "entropy_shift": round(abs(ent_med - (ref_med or 0.0)) / denom, 4),
                "ref_n": self._reference_min,
            }
        )
        return out


class ProbeLedger:
    """Golden-probe run accounting. The probe itself (batch synthesis,
    fingerprinting, reference persistence) lives device-side in
    ``serve.quality``; this ledger only counts outcomes so heartbeats
    and the final close() beat can carry them."""

    def __init__(self):
        self._lock = threading.Lock()
        self.runs = 0
        self.ok = 0
        self.mismatch = 0
        self.shed = 0
        self.probe_id: Optional[str] = None
        self.expected: Optional[str] = None
        self.last: Optional[str] = None

    def record(self, *, fingerprint: str, expected: str, probe_id: str) -> bool:
        matched = fingerprint == expected
        with self._lock:
            self.runs += 1
            self.probe_id = probe_id
            self.expected = expected
            self.last = fingerprint
            if matched:
                self.ok += 1
            else:
                self.mismatch += 1
        return matched

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "probe_runs": self.runs,
                "probe_ok": self.ok,
                # Cumulative monotonic: the probe-mismatch alert rule
                # gates on > 0 with for_s=0 — exactly one episode per
                # faulty executable, resolved only at finalize.
                "probe_mismatch": self.mismatch,
                "probe_shed": self.shed,
            }
            if self.runs:
                out["probe_ok_frac"] = round(self.ok / self.runs, 6)
            if self.probe_id:
                out["probe_id"] = self.probe_id
            if self.last:
                out["probe_fingerprint"] = self.last
            if self.expected and self.expected != self.last:
                out["probe_expected"] = self.expected
            return out


class AgreementScorer:
    """Shadow-replica agreement, keyed by (primary_dtype,
    shadow_dtype). ``score_shadow`` runs on the router's dedicated
    shadow worker thread — never in admit/route/_dispatch."""

    def __init__(self, window: int = 256):
        self._lock = threading.Lock()
        self._window = int(window)
        # pair key -> deque of (agree: bool, rel_diff: float|None)
        self._pairs: dict = {}
        self._scored = 0
        self._breach = 0
        self._shed = 0

    def score_shadow(
        self,
        primary_dtype: str,
        shadow_dtype: str,
        primary_top1: int,
        shadow_top1: int,
        primary_logits=None,
        shadow_logits=None,
    ) -> dict:
        """Score one mirrored request. Returns the per-sample verdict
        (mostly for tests); counters and windows update in place."""
        key = pair_key(primary_dtype, shadow_dtype)
        agree = int(primary_top1) == int(shadow_top1)
        rel = None
        if primary_logits and shadow_logits and len(primary_logits) == len(shadow_logits):
            scale = max(max(abs(float(x)) for x in primary_logits), 1e-6)
            diff = max(
                abs(float(a) - float(b))
                for a, b in zip(primary_logits, shadow_logits)
            )
            rel = diff / scale
        ceiling = envelope_rel(primary_dtype, shadow_dtype)
        # A sample breaches its pair envelope when the predictions
        # disagree outright, or the logits drifted past the pair's
        # ceiling. An int8 arm inside its envelope (same argmax,
        # rel <= 0.1) never breaches.
        breach = (not agree) or (rel is not None and rel > ceiling)
        with self._lock:
            dq = self._pairs.get(key)
            if dq is None:
                dq = self._pairs[key] = collections.deque(maxlen=self._window)
            dq.append((agree, rel))
            self._scored += 1
            if breach:
                self._breach += 1
        return {"pair": key, "agree": agree, "rel_diff": rel, "breach": breach}

    def record_shed(self) -> None:
        with self._lock:
            self._shed += 1

    def snapshot(self) -> dict:
        with self._lock:
            pairs = {}
            agreements = []
            for key, dq in self._pairs.items():
                if not dq:
                    continue
                agreement = sum(1 for a, _ in dq if a) / len(dq)
                rels = [r for _, r in dq if r is not None]
                pairs[key] = {
                    "n": len(dq),
                    "agreement": round(agreement, 6),
                    "envelope_rel": envelope_rel(*key.split("->", 1)),
                }
                if rels:
                    pairs[key]["rel_diff_max"] = round(max(rels), 6)
                agreements.append(agreement)
            out = {
                "scored": self._scored,
                # Cumulative monotonic, the ProbeLedger.mismatch shape:
                # the shadow-agreement rule gates on > 0.
                "breach": self._breach,
                "shed": self._shed,
            }
            if pairs:
                out["pairs"] = pairs
                # Fleet-level agreement is the WORST pair — a healthy
                # bf16 pair must not mask a drifting int8 pair.
                out["agreement"] = round(min(agreements), 6)
            return out
