"""Steady-state hang watchdog (the port's own copy of
``sav_tpu/obs/watchdog.py``, stdlib only).

``utils.backend_probe`` guards the start: it probes the card from a
subprocess with a timeout. This module guards the steady state: a run whose
step never completes (a wedged card, a stuck input source, the host blocked
inside a device-to-host copy) would otherwise hold its slot forever.

:class:`HangWatchdog` is a daemon thread. The train loop calls :meth:`beat`
every iteration; when no beat arrives within ``deadline_s`` the watchdog
dumps every Python thread's stack and the goodput ledger's summary, dumps
the flight recorder's incident, drains the checkpointer's write in flight
(bounded), finalizes the run manifest as ``hang`` and exits the process
with :data:`WATCHDOG_EXIT_CODE` (4): distinct from the backend probe's
exit 3, so a supervisor tells "never started" from "hung mid-run".

``os._exit``, not ``sys.exit``: the main thread is presumed wedged in a
call that never returns, so unwinding it is not an option.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

# Exit-code contract: backend_probe aborts startup with 3; the watchdog
# aborts a hung steady-state run with 4. Wrapper scripts key on both.
WATCHDOG_EXIT_CODE = 4


def dump_all_stacks(stream=None) -> None:
    """Write every live Python thread's stack to ``stream`` (stderr)."""
    stream = stream if stream is not None else sys.stderr
    frames = sys._current_frames()
    threads = {t.ident: t for t in threading.enumerate()}
    for ident, frame in frames.items():
        thread = threads.get(ident)
        name = thread.name if thread is not None else f"thread-{ident}"
        print(f"--- stack of {name} (ident={ident}) ---", file=stream)
        for line in traceback.format_stack(frame):
            stream.write(line)
    stream.flush()


class HangWatchdog:
    """Fires when no :meth:`beat` arrives within ``deadline_s``.

    ``ledger``: optional :class:`~sav_tpu_torch.obs.goodput.GoodputLedger`
    whose summary is dumped alongside the stacks (where the time went
    before the hang). ``manifest``: optional
    :class:`~sav_tpu_torch.obs.manifest.RunManifest` finalized with
    ``outcome: "hang"`` *before* the process exits — the hang must be
    machine-visible in the run record, not only in a stderr dump
    (``os._exit`` skips every atexit/finally, so nothing downstream gets
    another chance). ``recorder``: optional
    :class:`~sav_tpu_torch.obs.recorder.FlightRecorder` — its incident bundle
    (trigger ``hang``: the ring's last steps, kept batches, nearest state
    snapshot) is dumped before the manifest is finalized, and the bundle
    path rides the manifest's finalize notes, for the same reason: after
    ``os._exit`` nothing gets another chance. The dump runs on a side
    thread bounded by ``dump_timeout_s`` (default 30 s): the log dir's
    filesystem may be the hang's own cause, and the guaranteed-exit
    contract outranks telemetry. ``checkpointer``: optional
    :class:`~sav_tpu_torch.train.checkpoint.Checkpointer` whose in-flight
    async save is drained (bounded the same way) before the exit —
    ``os._exit`` skips ``fit()``'s finally, and an abandoned save is
    wall time the next attempt re-pays.
    ``exit_fn``/``stream`` are
    injectable for tests — production uses ``os._exit`` so a wedged main
    thread cannot swallow the abort.

    **Two-stage escalation** (``soft_deadline_s``): an optional *soft*
    (warning) stage below the hard deadline. Crossing it dumps every
    thread's stack and invokes ``on_soft(silent_s)`` (the trainer writes
    a fleet event, :mod:`sav_tpu_torch.obs.fleet`), but the run
    *continues*: a slow eval or a transient stall recovers, and the
    evidence of where it was stuck is already on disk if it does not. The soft stage fires once per silent episode (re-armed by
    the next beat); the hard stage's exit-4 contract is unchanged.
    ``on_soft`` runs on a side thread bounded by ``dump_timeout_s`` and
    is exception-guarded — the log dir's filesystem may be the stall's
    own cause, and neither a failing nor a *blocking* callback may stop
    the hard stage from ever firing.
    """

    def __init__(
        self,
        deadline_s: float,
        *,
        ledger=None,
        manifest=None,
        recorder=None,
        checkpointer=None,
        tag: str = "watchdog",
        exit_code: int = WATCHDOG_EXIT_CODE,
        exit_fn: Optional[Callable[[int], None]] = None,
        stream=None,
        poll_s: Optional[float] = None,
        dump_timeout_s: float = 30.0,
        soft_deadline_s: Optional[float] = None,
        on_soft: Optional[Callable[[float], None]] = None,
    ):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        if soft_deadline_s is not None and not (
            0 < soft_deadline_s < deadline_s
        ):
            raise ValueError(
                f"soft_deadline_s must be in (0, deadline_s={deadline_s}), "
                f"got {soft_deadline_s}"
            )
        self.deadline_s = deadline_s
        self.soft_deadline_s = soft_deadline_s
        self.on_soft = on_soft
        self.ledger = ledger
        self.manifest = manifest
        self.recorder = recorder
        self.checkpointer = checkpointer
        self.tag = tag
        self.exit_code = exit_code
        # A wedged main thread cannot be unwound: the hard exit, after the
        # bounded dumps and drains of _fire.
        self._exit_fn = exit_fn if exit_fn is not None else os._exit
        self._stream = stream
        self._poll_s = poll_s if poll_s is not None else min(deadline_s / 4, 5.0)
        self._dump_timeout_s = dump_timeout_s
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self.fired = threading.Event()
        self.soft_fired = threading.Event()
        self.soft_count = 0
        self._soft_fired_episode = False
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        """Mark progress; call once per completed step/loop iteration."""
        self._last_beat = time.monotonic()

    def start(self) -> "HangWatchdog":
        if self._thread is not None:
            return self
        self.beat()  # the deadline counts from start, not construction
        self._thread = threading.Thread(
            target=self._run, name=f"{self.tag}-thread", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Disarm (normal shutdown, eval/checkpoint-free exit paths)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll_s)
            self._thread = None

    def __enter__(self) -> "HangWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            silent_s = time.monotonic() - self._last_beat
            if silent_s >= self.deadline_s:
                self._fire(silent_s)
                return
            if self.soft_deadline_s is not None:
                if silent_s >= self.soft_deadline_s:
                    if not self._soft_fired_episode:
                        self._soft_fired_episode = True
                        self._fire_soft(silent_s)
                else:
                    # A beat arrived since the soft fire: the episode is
                    # over, re-arm the warning stage for the next stall.
                    self._soft_fired_episode = False

    def _fire_soft(self, silent_s: float) -> None:
        """Warning stage: evidence to disk, run continues.

        The dump + ``on_soft`` run on a side thread bounded by
        ``dump_timeout_s`` — the same discipline as the hard stage's
        recorder dump, and for the same reason: the callback writes to
        the very log dir whose filesystem may BE the stall's cause (or
        waits on a lock a wedged training thread holds), and a blocked
        monitor thread would silently void the hard stage's
        guaranteed-exit contract. Exceptions are printed, never raised.
        """
        stream = self._stream if self._stream is not None else sys.stderr
        print(
            f"{self.tag}: SOFT — no step completed in {silent_s:.0f}s "
            f"(soft deadline {self.soft_deadline_s:.0f}s, hard "
            f"{self.deadline_s:.0f}s); dumping stacks, run continues",
            file=stream,
        )

        def _dump():
            try:
                dump_all_stacks(stream)
                if self.ledger is not None:
                    print(
                        f"{self.tag}: goodput ledger at soft stage: "
                        + json.dumps(self.ledger.summary()),
                        file=stream,
                    )
            except Exception as e:
                print(f"{self.tag}: soft dump failed: {e!r}", file=stream)
            if self.on_soft is not None:
                try:
                    self.on_soft(silent_s)
                except Exception as e:
                    print(f"{self.tag}: on_soft failed: {e!r}", file=stream)
            try:
                stream.flush()
            except Exception:
                pass

        dumper = threading.Thread(
            target=_dump, name=f"{self.tag}-soft-dump", daemon=True
        )
        dumper.start()
        # Never wait past the hard deadline: the monitor thread must be
        # back polling silent_s when it expires, or a wedged dump would
        # delay the exit-4 contract wrapper scripts key on.
        dumper.join(timeout=min(
            self._dump_timeout_s,
            max(self.deadline_s - silent_s, 0.1),
        ))
        if dumper.is_alive():
            print(
                f"{self.tag}: soft-stage dump still blocked after "
                f"{self._dump_timeout_s:.0f}s (wedged filesystem?); "
                "abandoning it — the hard deadline stays armed",
                file=stream,
            )
        self.soft_count += 1
        self.soft_fired.set()

    def _fire(self, silent_s: float) -> None:
        stream = self._stream if self._stream is not None else sys.stderr
        print(
            f"{self.tag}: HANG — no step completed in {silent_s:.0f}s "
            f"(deadline {self.deadline_s:.0f}s); dumping stacks and "
            f"aborting with exit {self.exit_code}",
            file=stream,
        )
        try:
            dump_all_stacks(stream)
            if self.ledger is not None:
                print(
                    f"{self.tag}: goodput ledger at hang: "
                    + json.dumps(self.ledger.summary()),
                    file=stream,
                )
        except Exception as e:  # diagnostics must not mask the abort
            print(f"{self.tag}: dump failed: {e!r}", file=stream)
        # Flight-recorder bundle BEFORE the manifest finalize, both BEFORE
        # exiting: os._exit skips every finally/atexit, so this is the only
        # chance for the hang's context (last steps, batches, snapshot) to
        # reach disk and for the manifest to point at it. The dump is
        # unbounded file I/O to the very log_dir whose filesystem may BE
        # the hang's cause — so it runs on a bounded side thread: if the
        # write wedges, the abort proceeds anyway (the watchdog's
        # guaranteed-exit contract outranks its telemetry).
        incident_path = None
        if self.recorder is not None:
            dumped: dict = {}

            def _dump():
                try:
                    dumped["path"] = self.recorder.dump_incident(
                        "hang",
                        error=(
                            f"{self.tag}: no step completed in "
                            f"{silent_s:.0f}s"
                        ),
                    )
                except Exception as e:
                    dumped["error"] = e
            dumper = threading.Thread(
                target=_dump, name=f"{self.tag}-dump", daemon=True
            )
            dumper.start()
            dumper.join(timeout=self._dump_timeout_s)
            incident_path = dumped.get("path")
            if dumper.is_alive():
                print(
                    f"{self.tag}: recorder dump still blocked after "
                    f"{self._dump_timeout_s:.0f}s (wedged filesystem?); "
                    "aborting without it",
                    file=stream,
                )
            elif "error" in dumped:
                print(
                    f"{self.tag}: recorder dump failed: "
                    f"{dumped['error']!r}",
                    file=stream,
                )
            elif incident_path:
                print(
                    f"{self.tag}: incident bundle: {incident_path}",
                    file=stream,
                )
        if self.checkpointer is not None:
            # Drain any in-flight async checkpoint save before os._exit
            # abandons it (fit()'s finally never runs on this path). The
            # checkpointer's own wait(timeout_s) bounds the drain on a
            # side thread — a hang whose cause IS the checkpoint
            # filesystem must not stall the exit-4 contract.
            try:
                if not self.checkpointer.wait(
                    timeout_s=self._dump_timeout_s
                ):
                    print(
                        f"{self.tag}: in-flight checkpoint save still "
                        f"unfinished after {self._dump_timeout_s:.0f}s; "
                        "aborting without it (the previous committed "
                        "step remains restorable)",
                        file=stream,
                    )
            except Exception as e:
                print(
                    f"{self.tag}: checkpoint drain failed: {e!r}",
                    file=stream,
                )
        try:
            if self.manifest is not None:
                metrics = None
                if self.ledger is not None:
                    metrics = self.ledger.flat_metrics()
                self.manifest.finalize(
                    "hang",
                    error=(
                        f"{self.tag}: no step completed in "
                        f"{silent_s:.0f}s (deadline {self.deadline_s:.0f}s)"
                    ),
                    exit_code=self.exit_code,
                    metrics=metrics,
                    notes=(
                        {"incident": incident_path} if incident_path else None
                    ),
                )
        except Exception as e:
            print(f"{self.tag}: manifest finalize failed: {e!r}", file=stream)
        stream.flush()
        self.fired.set()
        self._exit_fn(self.exit_code)
