"""Bounded probing of the card before a run starts (the port's CUDA twin of
``sav_tpu/utils/backend_probe.py``, stdlib only).

A card that is missing, taken or wedged can make the first CUDA call of a
process fail late or hang. The probe runs that first call in a
**subprocess** with a timeout: ``torch.cuda.is_available()``, one tiny
launch and a synchronize. The caller either gets the card's name, or
gives up within a deadline with exit 3 (``require_backend_or_exit``) and a
manifest finalized as ``backend_unreachable``. It never falls back to the
CPU: a run that asks for the card and finds none is unreachable, not a CPU
run. ``--device cpu`` does not probe.

The steady-state counterpart (a run that hangs after it started) is
:mod:`sav_tpu_torch.obs.watchdog`.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Optional

# The card's name is printed behind a sentinel prefix, so that nothing else
# a library prints on stdout can be read as a reachable card.
_PROBE_SENTINEL = "PROBE_DEVICE="
_PROBE_SRC = """
import torch
if not torch.cuda.is_available():
    raise SystemExit("no CUDA device")
x = torch.ones((128, 128), device="cuda", dtype=torch.bfloat16)
total = float((x @ x).sum())
torch.cuda.synchronize()
print("PROBE_DEVICE=" + torch.cuda.get_device_name(0))
"""


def start_probe() -> subprocess.Popen:
    """Start one probe subprocess; :func:`probe_backend` reads it. Started
    early, it runs while the caller imports torch (which starts no CUDA)."""
    return subprocess.Popen([sys.executable, "-c", _PROBE_SRC], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def probe_backend(timeout_s: float, started: Optional[subprocess.Popen] = None) -> Optional[str]:
    """The name of CUDA device 0, probed in a subprocess (``started``, or a
    new one); None when the probe fails, finds no card or times out (the
    subprocess is then killed)."""
    proc = started if started is not None else start_probe()
    try:
        stdout, _ = proc.communicate(timeout=max(timeout_s, 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return None
    if proc.returncode != 0:
        return None
    for line in stdout.splitlines():
        if line.startswith(_PROBE_SENTINEL):
            return line[len(_PROBE_SENTINEL):].strip() or None
    return None


def unreachable_message(tag: str, deadline_s: float) -> str:
    """The one abort line wrapper scripts look for."""
    return (
        f"{tag}: CUDA device unreachable within "
        f"--backend-wait={deadline_s:.0f}s; aborting"
    )


def wait_for_backend(deadline_s: float = 600.0, poll_s: float = 30.0,
                     probe_s: float = 90.0, tag: str = "backend-probe",
                     probe_log: Optional[list] = None,
                     started: Optional[subprocess.Popen] = None) -> Optional[str]:
    """Probe until the card answers or ``deadline_s`` passes: the card's
    name, or None once the deadline is spent. ``started`` is a first probe
    already running (:func:`start_probe`). Each probe's timeout is clamped
    to what is left of the deadline, and the wait gives up only once ~1 s
    of it remains. Logs to stderr under ``tag``.

    ``probe_log``: a list the wait appends one dict per probe to
    (``attempt``/``elapsed_s``/``platform``), the probe timeline the run
    manifest carries."""
    t0 = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        remaining = deadline_s - (time.monotonic() - t0)
        device = probe_backend(timeout_s=min(probe_s, max(remaining, 1.0)),
                               started=started if attempt == 1 else None)
        if probe_log is not None:
            probe_log.append({
                "attempt": attempt,
                "elapsed_s": round(time.monotonic() - t0, 1),
                "platform": "gpu" if device is not None else None,
                "device": device,
            })
        if device is not None:
            if attempt > 1:
                print(f"{tag}: CUDA device '{device}' reachable after "
                      f"{time.monotonic() - t0:.0f}s ({attempt} probes)", file=sys.stderr)
            return device
        remaining = deadline_s - (time.monotonic() - t0)
        if remaining <= 1.0:
            print(f"{tag}: CUDA device unreachable after {time.monotonic() - t0:.0f}s "
                  f"({attempt} probes); giving up", file=sys.stderr)
            return None
        sleep_s = min(poll_s, max(remaining - 1.0, 0.0))
        print(f"{tag}: backend probe {attempt} failed at {time.monotonic() - t0:.0f}s; "
              f"retrying in {sleep_s:.0f}s", file=sys.stderr)
        time.sleep(sleep_s)


def require_backend_or_exit(deadline_s: float, tag: str, exit_code: int = 3,
                            manifest=None, started: Optional[subprocess.Popen] = None) -> str:
    """:func:`wait_for_backend` (from the probe ``started``, if any), or
    finalize ``manifest`` as ``backend_unreachable`` with the probe
    timeline and exit with ``exit_code`` (3, the code a supervisor reads as
    "never started"). Returns the card's name; the manifest notes the probe
    either way (``backend_probe``)."""
    probe_log: list = []
    t0 = time.monotonic()
    device = wait_for_backend(deadline_s=deadline_s, tag=tag, probe_log=probe_log,
                              started=started)
    if device is not None and manifest is not None:
        manifest.note("backend_probe", {"device": device, "attempts": len(probe_log),
                                        "wait_s": round(time.monotonic() - t0, 3)})
    if device is None:
        message = unreachable_message(tag, deadline_s)
        if manifest is not None:
            manifest.finalize(
                "backend_unreachable",
                error=message,
                exit_code=exit_code,
                notes={"backend_probe": {
                    "deadline_s": deadline_s,
                    "attempts": len(probe_log),
                    "probes": probe_log,
                }},
            )
        print(message, file=sys.stderr)
        raise SystemExit(exit_code)
    return device
