"""Flight recorder: a bounded ring of step context and incident bundles
(the port's own copy of ``sav_tpu/obs/recorder.py``; its ``replay_step``
twin is not ported, ROADMAP queue A10).

:class:`FlightRecorder` keeps the last ``depth`` steps' **host-side**
context (each batch's content hash, shapes and dtypes, the logged step
metrics), for the newest ``keep_batches`` steps the raw host batches, and a
periodic pre-step snapshot of the train state on the host. Per step it adds
no device sync: the batch passes through the feeder's place callback (or
the serial fetch) as a host numpy batch, hashed there before it is placed,
and the metrics arrive at the trainer's log-boundary copy. Nor does the
periodic snapshot, every ``snapshot_every`` steps (:meth:`snapshot_state`):
its copies run in stream order into two reused sets of pinned buffers, and
only a dump waits for them.

On an **incident** (nonfinite logged metrics, a loss spike beyond a robust
z-score gate, a watchdog hang, or an uncaught exception in ``fit``)
:meth:`dump_incident` writes a bundle in ``sav_tpu``'s layout, so either
side's readers read it::

    <log_dir>/incidents/step_<N>/
      incident.json        ring, trigger, config, the generators' derivation
      batch_<S>.npz        raw host batches of the kept steps
      state/               nearest pre-step snapshot (the port's
                           Checkpointer layout)

Thread-safety: the feeder's thread calls the wrapped place callback, the
training thread :meth:`on_step`/:meth:`note_metrics`, and the watchdog's
thread may call :meth:`dump_incident`; one lock covers the shared state.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np

INCIDENT_SCHEMA = 1

# Incident triggers (incident.json "trigger"): what tripped the dump.
TRIGGERS = (
    "nonfinite",        # nonfinite value in the logged step metrics
    "loss_spike",       # loss beyond the robust z-score gate
    "eval_nonfinite",   # nonfinite evaluation metrics
    "hang",             # the hang watchdog fired
    "exception",        # fit() died on an uncaught exception
)

# Host-only keys merged into the logged metrics dict by the trainer; they
# are not produced by the step and are excluded from nonfinite detection
# (sav_tpu's set, plus the port's step_s and feeder_* keys).
HOST_METRIC_KEYS = frozenset({"step", "images_per_sec", "mfu", "retraces", "step_s"})
HOST_METRIC_PREFIXES = ("hbm_", "goodput/", "feeder_")


def device_metric_items(metrics: dict) -> list:
    """(key, value) pairs of the step-produced metrics — the subset that a
    deterministic replay must reproduce bit-exactly."""
    return [
        (k, v)
        for k, v in sorted(metrics.items())
        if k not in HOST_METRIC_KEYS
        and not any(k.startswith(p) for p in HOST_METRIC_PREFIXES)
        and isinstance(v, (int, float))
    ]


def batch_fingerprint(batch: dict) -> dict:
    """Content hash + shapes/dtypes of a host batch.

    blake2b over the raw bytes (shape/dtype folded in so a reshape cannot
    alias). Runs on whatever thread holds the host batch — the feeder's
    background thread in async mode, so steady-state hashing overlaps
    device compute.
    """
    h = hashlib.blake2b(digest_size=16)
    shapes: dict[str, list] = {}
    dtypes: dict[str, str] = {}
    for key in sorted(batch):
        leaf = batch[key]
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = str(getattr(leaf, "dtype", type(leaf).__name__))
        shapes[key] = list(shape)
        dtypes[key] = dtype
        h.update(key.encode())
        h.update(f"{shape}{dtype}".encode())
        data = getattr(leaf, "tobytes", None)
        h.update(data() if data is not None else repr(leaf).encode())
    return {"hash": h.hexdigest(), "shapes": shapes, "dtypes": dtypes}


# How the trainer's generators derive from the seed (Trainer._seed_generators);
# their states at a snapshot are in the bundle's state/ checkpoint.
RNG_DERIVATION = (
    "torch.Generator(device).manual_seed(seed) for 'stochastic_depth', "
    "manual_seed(stream_seed(seed, 'dropout')) for 'dropout', "
    "manual_seed(stream_seed(seed, 'mix')) for 'mix'"
)


class _HostState:
    """A snapshot's host state dict in the form ``Checkpointer.save``
    takes."""

    def __init__(self, tree: dict):
        self._tree = tree

    def state_dict(self) -> dict:
        return self._tree


class _RingEntry:
    """Host-side context of one training step."""

    __slots__ = ("step", "fingerprint", "batch", "metrics")

    def __init__(self, step, fingerprint, batch):
        self.step = step              # 1-indexed completed-step number
        self.fingerprint = fingerprint  # {hash, shapes, dtypes} or None
        self.batch = batch            # raw host batch (kept steps only)
        self.metrics = None           # logged metrics dict (log windows)

    def to_json(self) -> dict:
        return {
            "step": self.step,
            "batch": self.fingerprint,
            "has_batch": self.batch is not None,
            "metrics": self.metrics,
        }


class FlightRecorder:
    """Bounded ring of step context + incident bundles.

    Args:
      log_dir: incident bundles land in ``<log_dir>/incidents/``.
      depth: ring entries (steps of context) retained.
      keep_batches: raw host batches retained (≤ depth). Snapshot cadence
        must not exceed this or the bundle cannot replay up to the
        incident step.
      snapshot_every: pre-step train-state snapshot cadence in steps
        (default: ``keep_batches``). The recorder retains the two most
        recent snapshots so the ring window is always covered.
      spike_sigma: loss-spike gate — flag a logged loss more than
        ``spike_sigma`` scaled MADs above the rolling median of healthy
        windows (upward only; a collapsing loss is progress). ``0``
        disables the gate.
      spike_window / spike_min_history: rolling history length and the
        minimum healthy windows before the gate arms (early-training
        noise must not false-fire).
      config: JSON-able run config (``dataclasses.asdict(TrainConfig)``)
        embedded in the bundle, enough to rebuild the exact trainer.
      seed: the run seed; the bundle records how the trainer's
        generators derive from it rather than reading their states from
        the device, keeping recording sync-free.
      manifest: optional RunManifest; every dump cross-links under
        ``notes.incidents``.
      max_incidents: dump budget per recorder (a NaN that persists across
        every later window must not fill the disk).
      clock: injectable for deterministic overhead tests.
    """

    def __init__(
        self,
        log_dir: str,
        *,
        depth: int = 16,
        keep_batches: int = 4,
        snapshot_every: Optional[int] = None,
        spike_sigma: float = 6.0,
        spike_window: int = 32,
        spike_min_history: int = 8,
        config: Optional[dict] = None,
        seed: Optional[int] = None,
        manifest=None,
        max_incidents: int = 4,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if keep_batches < 1 or keep_batches > depth:
            raise ValueError(
                f"keep_batches must be in [1, depth={depth}], got {keep_batches}"
            )
        self.log_dir = log_dir
        self.depth = depth
        self.keep_batches = keep_batches
        self.snapshot_every = (
            snapshot_every if snapshot_every is not None else keep_batches
        )
        if self.snapshot_every > keep_batches:
            raise ValueError(
                f"snapshot_every={self.snapshot_every} must not exceed "
                f"keep_batches={keep_batches}: the steps between a snapshot "
                "and an incident need their batches to replay"
            )
        self.spike_sigma = spike_sigma
        self.spike_window = spike_window
        self.spike_min_history = spike_min_history
        self.config = config
        self.seed = seed
        self.manifest = manifest
        self.max_incidents = max_incidents
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque[_RingEntry] = deque(maxlen=depth)
        # Host batches observed (feeder thread) but not yet consumed by a
        # step (training thread); the feeder delivers in FIFO order, so a
        # plain queue matches batch to step. Bounded by the feeder's own
        # backpressure (depth + in-flight), not by us.
        self._pending: deque = deque()
        # (state_step, host state dict) — the two most recent snapshots.
        self._snapshots: deque = deque(maxlen=2)
        # state_step -> the CUDA event that ends a snapshot_state copy.
        self._ready: dict = {}
        self._snap_anchor: Optional[int] = None
        self._loss_history: deque = deque(maxlen=spike_window)
        self.incidents: list[dict] = []
        self.last_step: Optional[int] = None
        # Training-thread bookkeeping (on_step/note_metrics) vs hashing
        # (observe_batch — the feeder's thread in async mode, overlapped
        # with device compute like placement itself) vs the periodic
        # snapshot copy: three separate gauges, each against its own
        # clock.
        self._overhead_s = 0.0
        self._hash_s = 0.0
        self._snapshot_s = 0.0
        # snapshot_state's allocations of its two sets of host buffers.
        self._buffers_s = 0.0
        self._steps = 0
        # One bundle per nonfinite *episode*: once NaN is in the state,
        # every later window stays nonfinite — re-dumping each would just
        # burn the incident budget on copies of the same failure.
        self._nonfinite_active = False

    @classmethod
    def from_config(
        cls, config, log_dir: str, *, manifest=None, **overrides
    ) -> "FlightRecorder":
        """Build a recorder from a ``TrainConfig`` — the single source for
        the config→knob mapping.

        A shallow ring implies a shallow batch window: ``--record-depth 2``
        with the default ``record_batches=4`` means "keep 2 steps of
        context", so the batch/snapshot knobs clamp down to the depth
        instead of failing the run at fit start (the raw constructor
        stays strict — explicit contradictions should raise).
        """
        import dataclasses

        keep = min(config.record_batches, config.record_depth)
        snap = config.record_snapshot_every
        kwargs = dict(
            depth=config.record_depth,
            keep_batches=keep,
            snapshot_every=min(snap, keep) if snap is not None else None,
            spike_sigma=config.spike_sigma,
            config=dataclasses.asdict(config),
            seed=config.seed,
            manifest=manifest,
        )
        kwargs.update(overrides)
        return cls(log_dir, **kwargs)

    # --------------------------------------------------------- steady state

    def wrap_place(self, place_fn: Callable) -> Callable:
        """Wrap the feeder's place callback: fingerprint + retain the host
        batch on the feeder's thread (overlapped with device compute),
        then place as usual."""

        def place(batch):
            self.observe_batch(batch)
            return place_fn(batch)

        return place

    def observe_batch(self, batch: dict) -> None:
        """Record one host batch about to be placed/consumed (FIFO)."""
        t0 = self._clock()
        info = (batch_fingerprint(batch), batch)
        with self._lock:
            self._pending.append(info)
            self._hash_s += self._clock() - t0

    def on_step(self, step: int) -> None:
        """One training step dispatched; pairs with the oldest observed
        batch. Host-only bookkeeping — never touches device values."""
        t0 = self._clock()
        with self._lock:
            fingerprint, batch = (
                self._pending.popleft() if self._pending else (None, None)
            )
            entry = _RingEntry(step, fingerprint, batch)
            self._ring.append(entry)
            # Batch retention window: only the newest keep_batches entries
            # hold raw data.
            held = [e for e in self._ring if e.batch is not None]
            for stale in held[: max(0, len(held) - self.keep_batches)]:
                stale.batch = None
            self.last_step = step
            self._steps += 1
        self._overhead_s += self._clock() - t0

    def note_metrics(self, step: int, metrics: dict) -> Optional[str]:
        """Attach logged (already host-side) metrics to the ring entry and
        run incident detection. Returns a trigger name or None.

        Called at the trainer's log boundaries with the dict it already
        copied to the host — detection adds no transfers of its own.
        """
        t0 = self._clock()
        trigger = None
        with self._lock:
            for entry in reversed(self._ring):
                if entry.step == step:
                    entry.metrics = dict(metrics)
                    break
        device_items = device_metric_items(metrics)
        if any(not math.isfinite(v) for _, v in device_items):
            # One trigger per nonfinite episode: once NaN is in the state
            # every later window stays nonfinite, and re-dumping would
            # spend the incident budget on copies of the same failure.
            if not self._nonfinite_active:
                self._nonfinite_active = True
                trigger = "nonfinite"
        else:
            self._nonfinite_active = False
            loss = metrics.get("loss")
            if self.spike_sigma and isinstance(loss, (int, float)):
                spike = self._spike_gate(loss)
                if spike is not None:
                    trigger = "loss_spike"
        self._overhead_s += self._clock() - t0
        return trigger

    def _spike_gate(self, loss: float) -> Optional[dict]:
        """Robust z-score gate (median + spike_sigma scaled MADs, upward
        only). Healthy losses enter the rolling history; a flagged one
        does not, so one spike cannot poison the baseline."""
        history = list(self._loss_history)
        if len(history) >= self.spike_min_history:
            med = sorted(history)[len(history) // 2]
            mad = sorted(abs(v - med) for v in history)[len(history) // 2]
            # Same floor logic as the regression sentinel: a zero-MAD
            # (flat) history must not flag sub-percent jitter.
            threshold = self.spike_sigma * max(
                1.4826 * mad, 0.05 * abs(med), 1e-9
            )
            if loss > med + threshold:
                return {"loss": loss, "median": med, "mad": mad,
                        "threshold": threshold}
        self._loss_history.append(float(loss))
        return None

    # ------------------------------------------------------------ snapshots

    def wants_snapshot(self, step: int) -> bool:
        """True when the caller should hand over a pre-step state copy
        (every ``snapshot_every`` steps, anchored at the first ask)."""
        if self._snap_anchor is None:
            self._snap_anchor = step
        return (step - self._snap_anchor) % self.snapshot_every == 0

    def snapshot(self, state_step: int, host_state: Any) -> None:
        """Retain a pre-step train state already copied to the host (a
        ``TrainState.state_dict()`` of host tensors).

        The *caller* makes the copy (``sav_tpu``'s form; the trainer uses
        :meth:`snapshot_state`, which makes it without a wait).
        """
        t0 = self._clock()
        with self._lock:
            self._snapshots.append((int(state_step), host_state))
        self._snapshot_s += self._clock() - t0

    def snapshot_state(self, state_step: int, tree: dict, device) -> None:
        """The port's copy and :meth:`snapshot` in one: copy ``tree`` (a
        ``TrainState.state_dict()`` on ``device``) to the host and retain
        it. The copies go into the host buffers of the snapshot the new one
        evicts, in the current stream's order, with no wait: a dump waits
        for them (:meth:`dump_incident`). The first two snapshots allocate
        the run's two sets of pinned buffers, timed apart (``buffers_s``)."""
        from sav_tpu_torch.train.checkpoint import host_buffers, host_snapshot

        t0 = self._clock()
        with self._lock:
            evicted = (self._snapshots.popleft()
                       if len(self._snapshots) == self._snapshots.maxlen else None)
            if evicted is not None:
                self._ready.pop(evicted[0], None)
        if evicted is None:
            buffers = host_buffers(tree)
            t1 = self._clock()
            self._buffers_s += t1 - t0
            t0 = t1
        else:
            buffers = evicted[1]
        host = host_snapshot(tree, buffers, wait=False)
        ready = None
        if device.type == "cuda":
            import torch

            ready = torch.cuda.current_stream(device).record_event()
        with self._lock:
            self._snapshots.append((int(state_step), host))
            if ready is not None:
                self._ready[int(state_step)] = ready
        self._snapshot_s += self._clock() - t0

    # ------------------------------------------------------------ incidents

    def stats(self) -> dict[str, float]:
        """Gauge view for the goodput ledger (``recorder/*``)."""
        with self._lock:
            return {
                "steps": float(self._steps),
                "overhead_s": self._overhead_s,
                "hash_s": self._hash_s,
                "snapshot_s": self._snapshot_s,
                "buffers_s": self._buffers_s,
                "incidents": float(len(self.incidents)),
            }

    def dump_incident(
        self,
        trigger: str,
        step: Optional[int] = None,
        *,
        error: Optional[str] = None,
        extra: Optional[dict] = None,
    ) -> Optional[str]:
        """Write one incident bundle; returns its directory (None when the
        budget is spent, the step already dumped, or I/O failed — dumping
        is telemetry and must never take the run down with it)."""
        if trigger not in TRIGGERS:
            raise ValueError(f"unknown trigger {trigger!r}; use {TRIGGERS}")
        with self._lock:
            if len(self.incidents) >= self.max_incidents:
                return None
            step = step if step is not None else (self.last_step or 0)
            if any(i["step"] == step and i["trigger"] == trigger
                   for i in self.incidents):
                return None
            ring = list(self._ring)
            snapshots = list(self._snapshots)
            ready = list(self._ready.values())
        for event in ready:  # snapshot_state's copies, still in flight
            event.synchronize()
        bundle = os.path.join(self.log_dir, "incidents", f"step_{step:08d}")
        if os.path.isdir(bundle):
            bundle = f"{bundle}-{trigger}"
            if os.path.isdir(bundle):
                return None
        try:
            path = self._write_bundle(
                bundle, trigger, step, ring, snapshots, error, extra
            )
        except Exception as e:  # never let telemetry kill the run
            import sys

            print(f"flight recorder: incident dump failed: {e!r}",
                  file=sys.stderr)
            return None
        record = {"step": step, "trigger": trigger, "path": path}
        with self._lock:
            self.incidents.append(record)
            incidents = list(self.incidents)
        if self.manifest is not None:
            try:
                self.manifest.note("incidents", incidents)
            except Exception:
                pass
        return path

    def _write_bundle(
        self, bundle, trigger, step, ring, snapshots, error, extra
    ) -> str:
        os.makedirs(bundle, exist_ok=True)
        # Nearest usable snapshot: a snapshot at state-step S replays steps
        # S+1..incident, so EVERY one of those steps must still hold its
        # batch — contiguity, not just overlap (window-granularity
        # recordings hold sparse steps and must come out replayable:
        # false). Snapshot cadence <= keep_batches guarantees a candidate
        # exists in fit() once recording is warm.
        snap_step = None
        snap_state = None
        batch_held = {e.step for e in ring if e.batch is not None}
        batch_steps = sorted(batch_held)
        usable = [
            (s, st) for s, st in snapshots
            if s < step and set(range(s + 1, step + 1)) <= batch_held
        ]
        replayable = bool(usable)
        if usable:
            snap_step, snap_state = max(usable, key=lambda x: x[0])
        elif snapshots:
            # Not replayable up to the incident step, but still the nearest
            # recorded context (replayable: false in the manifest below).
            snap_step, snap_state = max(snapshots, key=lambda x: x[0])
            batch_steps = [s for s in batch_steps if s > snap_step]
        for entry in ring:
            if entry.batch is None:
                continue
            arrays = {}
            for key in sorted(entry.batch):
                leaf = np.asarray(entry.batch[key])
                if leaf.dtype.kind not in "biufc?":
                    # ml_dtypes (bfloat16, float8) round-trip as raw bytes;
                    # the ring entry's dtypes map restores the view
                    # (np.savez cannot serialize them natively).
                    leaf = leaf.view(np.uint8).reshape(leaf.shape + (-1,))
                arrays[key] = leaf
            np.savez(
                os.path.join(bundle, f"batch_{entry.step:08d}.npz"), **arrays
            )
        if snap_step is not None:
            from sav_tpu_torch.train.checkpoint import Checkpointer

            ckpt = Checkpointer(os.path.join(bundle, "state"), keep=1)
            try:
                ckpt.save(snap_step, _HostState(snap_state))
                # Unbounded on purpose: a truncated snapshot is a bundle
                # that cannot replay.
                ckpt.wait()
            finally:
                ckpt.close()
        doc = {
            "schema": INCIDENT_SCHEMA,
            "trigger": trigger,
            "step": step,
            "created_unix": round(time.time(), 3),
            "error": error,
            "ring": [e.to_json() for e in ring],
            "batch_steps": batch_steps,
            "snapshot_step": snap_step,
            "replayable": replayable,
            "rng": {
                "seed": self.seed,
                "derivation": RNG_DERIVATION,
            },
            "config": self.config,
            "extra": extra,
        }
        tmp = os.path.join(bundle, "incident.json.tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, default=str)
        os.replace(tmp, os.path.join(bundle, "incident.json"))
        return bundle


def load_bundle_batch(bundle: str, step: int, dtypes: dict) -> dict:
    """Load one recorded batch, restoring non-native dtypes (bfloat16 &
    friends were stored as raw uint8 bytes) via the ring's dtype map
    (which needs ``ml_dtypes`` for those dtypes)."""
    try:
        import ml_dtypes  # noqa: F401  (registers bfloat16 et al. with numpy)
    except ImportError:
        pass

    out = {}
    with np.load(os.path.join(bundle, f"batch_{step:08d}.npz")) as data:
        for key in data.files:
            arr = data[key]
            want = np.dtype(dtypes.get(key, arr.dtype))
            if arr.dtype != want:
                arr = arr.reshape(arr.shape[:-1] + (-1,)).view(want)
                arr = arr.reshape(arr.shape[:-1])
            out[key] = arr
    return out
