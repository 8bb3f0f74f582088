"""One :meth:`~sav_tpu_torch.train.trainer.Trainer.fit`'s run telemetry
(``sav_tpu``'s, :mod:`sav_tpu_torch.obs`), in one owner: :class:`RunTelemetry`
is built at the fit's start, told of each step and log boundary, and closed
on every way out.

Into the sink ``config.log_dir or config.checkpoint_dir``, nothing without
one: a goodput ledger always (``goodput.json`` in the sink); with
``trace_spans`` the host spans (``spans.trace.json``); with ``fleet`` a
heartbeat per log window from every process (``fleet/proc_<i>.jsonl``) and,
from process 0, ``fleet/fleet.json`` at the end; with ``record`` the flight
recorder (incident bundles under ``incidents/``); with ``watchdog_secs`` the
hang watchdog, armed after the first step (exit 4). Process 0 (by
``SAV_FLEET_PROC``, default 0) writes the files that are not per process.
None of it reads a device value: the recorder's periodic state copy goes in
stream order into two reused sets of pinned buffers, and only a dump waits
for it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import torch

from sav_tpu_torch.obs.fleet import (
    HeartbeatWriter,
    aggregate_fleet,
    resolve_identity,
    write_fleet_manifest,
)
from sav_tpu_torch.obs.goodput import GoodputLedger
from sav_tpu_torch.obs.recorder import FlightRecorder
from sav_tpu_torch.obs.spans import SpanTracer
from sav_tpu_torch.obs.watchdog import HangWatchdog


class RunTelemetry:
    """``RunTelemetry(trainer, start_step, manifest=None)``: the telemetry of
    one fit of ``trainer`` from ``start_step``. ``manifest`` (a
    :class:`~sav_tpu_torch.obs.manifest.RunManifest`) gets the ``backend``
    note now; the ``kernels`` note (:meth:`Trainer._kernel_note`, with
    ``first_step_unix`` and ``replays_at_step``, the step its ``replays``
    were read at) after the first step, at each log boundary and at the
    close; the ledger's metrics at each log boundary and at the close; the
    recorder's incidents; the watchdog finalizes it as ``hang``."""

    def __init__(self, trainer, start_step: int, manifest=None):
        cfg = trainer.config
        self.trainer, self.manifest = trainer, manifest
        self.obs_dir = cfg.log_dir or cfg.checkpoint_dir
        proc, procs = resolve_identity(0, 1)
        writer = proc == 0 and self.obs_dir is not None
        self.tracer = SpanTracer(os.path.join(self.obs_dir, "spans.trace.json")
                                 if cfg.trace_spans and writer else None)
        self.ledger = GoodputLedger()
        self.recorder = (FlightRecorder.from_config(cfg, self.obs_dir, manifest=manifest)
                         if cfg.record and writer else None)
        self.heartbeats = (HeartbeatWriter(self.obs_dir, process_index=proc, process_count=procs)
                           if cfg.fleet and self.obs_dir is not None else None)
        self.writer = writer
        self.start_step = self.last_step = self._last_logged = start_step
        # Dispatch and log-sync seconds of the steps not yet noted by the
        # ledger (the first step's are its compile bucket).
        self._window_s = 0.0
        # Seconds the log boundaries' manifest writes took.
        self._manifest_write_s = 0.0
        self.kernels: dict = {}
        self.goodput: Optional[dict] = None
        self.feeder_stats: Optional[dict] = None
        self.watchdog = None
        if cfg.watchdog_secs:
            def on_soft(silent_s):
                if self.heartbeats is not None:
                    self.heartbeats.fleet_event("watchdog_soft", silent_s=round(silent_s, 1),
                                                at_step=self.last_step)

            # The deadline must exceed the longest legitimate gap between
            # steps: an eval pass or a save beats once, at its end.
            self.watchdog = HangWatchdog(cfg.watchdog_secs, ledger=self.ledger,
                                         tag="train-watchdog", manifest=manifest,
                                         recorder=self.recorder,
                                         checkpointer=trainer.checkpointer,
                                         soft_deadline_s=cfg.watchdog_soft_secs, on_soft=on_soft)
        if manifest is not None:
            device = trainer.device
            manifest.note("backend", {
                "platform": "gpu" if device.type == "cuda" else "cpu",
                "device_kind": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu"),
                "n_devices": 1,
                "process_count": procs,
            })

    # ------------------------------------------------------------ the steps

    def place(self, place_fn):
        """The feeder's place callback: the recorder hashes and keeps each
        host batch on the feeder's thread first."""
        return self.recorder.wrap_place(place_fn) if self.recorder is not None else place_fn

    def observe(self, batch: dict) -> None:
        """A host batch fetched on the training thread (no async feed)."""
        if self.recorder is not None:
            self.recorder.observe_batch(batch)

    def before_step(self, step: int, state) -> None:
        """The recorder's periodic pre-step copy of ``state``, in stream
        order and without a wait."""
        if self.recorder is not None and self.recorder.wants_snapshot(step):
            self.recorder.snapshot_state(step, state.state_dict(), self.trainer.device)

    def after_step(self, step: int, dispatch_s: float) -> None:
        """Step ``step + 1`` dispatched in ``dispatch_s`` seconds. On the
        card the first step warms up and captures: the ledger's compile
        bucket, and the first ``kernels`` note."""
        if self.recorder is not None:
            self.recorder.on_step(step + 1)
        self.last_step = step + 1
        if step == self.start_step:
            self.ledger.account("compile", dispatch_s)
            self.kernels["first_step_unix"] = round(time.time(), 3)
            if self.manifest is not None:
                self.manifest.update(self._kernel_notes(), {})
        else:
            self._window_s += dispatch_s

    def window_synced(self, step: int, sync_s: float) -> None:
        """A log window's metrics reached the host after ``sync_s`` seconds
        of waiting (priced into the ``step`` bucket)."""
        self._window_s += sync_s
        if self.ledger.note_window(step - self._last_logged, self._window_s, step=step):
            self.tracer.instant("stall_anomaly", step=step)
        self._window_s, self._last_logged = 0.0, step

    def log_boundary(self, step: int, record: dict) -> None:
        """After the ledger's window, in order: the recorder's gates (and
        its dump), the manifest's progress (the ``kernels`` note and the
        ledger's metrics, so a killed or hung process leaves its counters
        as of its last boundary), the heartbeat. The save follows."""
        recorder = self.recorder
        if recorder is not None:
            trigger = recorder.note_metrics(step, record)
            if trigger and recorder.dump_incident(trigger, step) is not None:
                self.tracer.instant("incident", step=step, trigger=trigger)
        if self.manifest is not None:
            t0 = time.perf_counter()
            self.manifest.update(self._kernel_notes(), self._flat_metrics())
            self._manifest_write_s += time.perf_counter() - t0
            self.ledger.set_gauge("manifest/write_s", self._manifest_write_s)
        if self.heartbeats is not None:
            self.heartbeats.beat(step, ledger=self.ledger, metrics=record, incident=(
                recorder.incidents[-1]["path"] if recorder is not None and recorder.incidents
                else None))

    def beat(self, step: int) -> None:
        """The watchdog: armed after the first step (the start, imports and
        capture, is the backend probe's to bound), then beaten each step."""
        if self.watchdog is not None:
            if step == self.start_step:
                self.watchdog.start()
            else:
                self.watchdog.beat()

    def stop_watchdog(self) -> None:
        """Before the final save and wait, which may outlast the deadline."""
        if self.watchdog is not None:
            self.watchdog.stop()

    # ---------------------------------------------------------------- notes

    def _kernel_notes(self) -> dict:
        """``{"kernels": ...}`` as it stands at the last step, or nothing
        before the first."""
        if not self.kernels:
            return {}
        self.kernels.update(self.trainer._kernel_note(), replays_at_step=self.last_step)
        # A copy: the watchdog's thread may write the manifest meanwhile.
        return {"kernels": dict(self.kernels)}

    def _flat_metrics(self) -> dict:
        """The ledger's metrics with the recorder's and the heartbeats'
        gauges as they stand."""
        if self.recorder is not None:
            for k, v in self.recorder.stats().items():
                self.ledger.set_gauge(f"recorder/{k}", v)
        if self.heartbeats is not None:
            for k, v in self.heartbeats.stats().items():
                self.ledger.set_gauge(f"fleet/{k}", v)
        return self.ledger.flat_metrics()

    # ---------------------------------------------------------------- close

    def close(self, exc, feeder=None) -> None:
        """The fit's way out, normal or not (``exc`` is the exception in
        flight): the recorder's crash incident, the feeder's stats and its
        close, the watchdog disarmed, the writes in flight drained (bounded
        on an exception), the heartbeat stream closed and
        ``fleet/fleet.json`` merged (process 0), the manifest's notes and
        metrics, the spans and ``goodput.json``."""
        failed = exc is not None and not isinstance(exc, StopIteration)
        recorder, ledger, manifest = self.recorder, self.ledger, self.manifest
        if recorder is not None and failed:
            # Not again where the failure already dumped at this step.
            if not (recorder.incidents
                    and recorder.incidents[-1]["step"] == (recorder.last_step or 0)):
                recorder.dump_incident(
                    "nonfinite" if isinstance(exc, FloatingPointError) else "exception",
                    error=repr(exc))
        if feeder is not None:
            self.feeder_stats = feeder.stats()
            for k, v in self.feeder_stats.items():
                ledger.set_gauge(f"feeder/{k}", v)
            feeder.close()
        self.stop_watchdog()
        checkpointer = self.trainer.checkpointer
        if failed and checkpointer is not None:
            # Bounded: a crash escaping a wedged filesystem must not hang
            # on it; an unfinished write leaves its step missing, never
            # torn.
            with ledger.measure("checkpoint"):
                if not checkpointer.wait(timeout_s=120.0):
                    logging.warning("a checkpoint write is still in flight after 120 s; "
                                    "abandoning it (the previous committed step restores)")
        metrics = self._flat_metrics()
        if self.heartbeats is not None:
            self.heartbeats.close(outcome="error" if failed else "ok")
            if self.heartbeats.process_index == 0:
                self._merge_fleet()
        if manifest is not None:
            manifest.update(self._kernel_notes(), metrics)
        self.tracer.write()
        self.goodput = ledger.summary()
        if self.writer:
            try:
                os.makedirs(self.obs_dir, exist_ok=True)
                with open(os.path.join(self.obs_dir, "goodput.json"), "w") as f:
                    json.dump(self.goodput, f, indent=2)
            except OSError as e:  # telemetry, never fatal
                logging.warning("goodput.json not written: %r", e)

    def _merge_fleet(self) -> None:
        """Process 0's ``fleet/fleet.json`` and the manifest's ``fleet``
        note."""
        try:
            summary = aggregate_fleet(self.obs_dir)
        except (OSError, ValueError, TypeError) as e:  # telemetry, never fatal
            logging.warning("fleet aggregation failed: %r", e)
            return
        path = write_fleet_manifest(self.obs_dir, summary)
        if self.manifest is not None and path is not None:
            self.manifest.note("fleet", {
                "path": path,
                "processes": {p: {k: v.get(k) for k in ("heartbeats", "last_step", "outcome")}
                              for p, v in summary.get("processes", {}).items()},
                "step_skew": summary.get("step_skew"),
                "straggler": (summary.get("straggler") or {}).get("straggler"),
                "suspects": [s.get("proc") for s in summary.get("suspects", [])],
            })
