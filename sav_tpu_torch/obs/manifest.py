"""Run manifests: one JSON record per run, finalized on every way out (the
port's own copy of the run half of ``sav_tpu/obs/manifest.py``, stdlib
only).

``python -m sav_tpu_torch.train`` writes a :class:`RunManifest` at start
(config, argv, environment fingerprint) and finalizes it with a
machine-readable **outcome** on every way out: success, exception, watchdog
fire, backend unreachable. The file's layout is ``sav_tpu``'s, so either
side's readers read the other's manifests.

Outcomes (:data:`OUTCOMES`):

  ok                   the run completed
  backend_unreachable  the startup probe gave up (backend_probe, exit 3)
  retrace              kept for ``sav_tpu``'s layout; the port has no
                       retrace sanitizer
  hang                 the hang watchdog fired (obs.watchdog, exit 4)
  oom                  device allocator exhaustion
                       (``torch.cuda.OutOfMemoryError``)
  nonfinite            the run died on NaN/Inf (``FloatingPointError`` from
                       ``debug_nans``)
  error                any other exception
  running              transient: the run is running, or died too hard to
                       say (SIGKILL)

Rules: stdlib only (the supervising process never imports torch); every
write is atomic (tmp + ``os.replace``), so an ``os._exit`` mid-write cannot
tear the file; ``finalize`` is first-wins and thread-safe, so the watchdog
thread and a crashing main thread cannot both report; a failed manifest
write never takes the run down.

The history half of ``sav_tpu``'s module (run records for the regression
sentinel) is not ported (ROADMAP queue A10).
"""

from __future__ import annotations

import json
import os
import platform as _platform
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Optional

OUTCOMES = (
    "ok", "backend_unreachable", "retrace", "hang", "oom", "nonfinite",
    "error",
)
MANIFEST_SCHEMA = 1


def classify_exception(exc: BaseException) -> str:
    """Map an exception to a manifest outcome, by type *names* and message
    (no torch import): ``RetraceSanitizerError`` → ``retrace``;
    ``FloatingPointError`` (``debug_nans``) and "non-finite" messages →
    ``nonfinite``; ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory"),
    "out of memory", ``RESOURCE_EXHAUSTED`` and ``MemoryError`` → ``oom``;
    everything else → ``error``."""
    name = type(exc).__name__
    if name == "RetraceSanitizerError":
        return "retrace"
    text = f"{name}: {exc}".lower()
    if (
        isinstance(exc, FloatingPointError)
        or "non-finite" in text
        or "nan generated by" in text
    ):
        return "nonfinite"
    if (
        name == "OutOfMemoryError"
        or "resource_exhausted" in text
        or "out of memory" in text
        or isinstance(exc, MemoryError)
    ):
        return "oom"
    return "error"


def _git_sha() -> Optional[str]:
    try:
        proc = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=2.0,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except Exception:
        return None
    sha = proc.stdout.strip()
    return sha if proc.returncode == 0 and sha else None


def environment_fingerprint() -> dict:
    """Host and toolchain fingerprint, safe to call without torch: it
    imports nothing, and names torch, its CUDA and the card only where the
    process has imported torch and started CUDA already (the supervising
    process never does). Callers that hold the card add its facts with
    :meth:`RunManifest.note`."""
    env = {
        "python": sys.version.split()[0],
        "platform": _platform.platform(),
        "hostname": socket.gethostname(),
        "argv0": sys.argv[0] if sys.argv else None,
        "git_sha": _git_sha(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
    }
    torch = sys.modules.get("torch")
    if torch is not None:  # versions only; never starts CUDA
        env["torch"] = getattr(torch, "__version__", None)
        env["cuda"] = getattr(getattr(torch, "version", None), "cuda", None)
        try:
            if torch.cuda.is_initialized():
                env["device"] = torch.cuda.get_device_name(0)
        except Exception:  # noqa: BLE001 — a fingerprint never raises
            pass
    return env


class RunManifest:
    """Lifecycle: ``begin()`` writes an in-progress record; ``note()`` /
    ``set_metrics()`` accrete facts; ``finalize(outcome)`` stamps the one
    terminal outcome (first caller wins — later finalizes are ignored, so
    an exception handler racing the watchdog cannot overwrite ``hang``).
    """

    def __init__(
        self,
        path: str,
        *,
        kind: str,
        argv: Optional[list] = None,
        config: Optional[dict] = None,
        clock=time.time,
    ):
        self.path = path
        self._clock = clock
        self._lock = threading.Lock()
        self._enabled = True
        self._data: dict[str, Any] = {
            "schema": MANIFEST_SCHEMA,
            "kind": kind,
            "outcome": "running",
            "argv": list(argv) if argv is not None else None,
            "config": config,
            "env": environment_fingerprint(),
            "created_unix": round(float(clock()), 3),
            "finalized_unix": None,
            "exit_code": None,
            "error": None,
            "notes": {},
            "metrics": {},
        }

    # ------------------------------------------------------------ lifecycle

    @property
    def outcome(self) -> str:
        return self._data["outcome"]

    @property
    def finalized(self) -> bool:
        return self._data["outcome"] != "running"

    def begin(self) -> Optional[str]:
        """Write the in-progress record; returns the path (None if the
        write failed — telemetry never takes a run down)."""
        return self._write()

    def disable(self) -> None:
        """Stop writing (non-zero processes of a multi-host run share the
        log dir; only process 0 may own the manifest file)."""
        with self._lock:
            self._enabled = False

    def set_config(self, config: Optional[dict]) -> None:
        with self._lock:
            self._data["config"] = config
        self._write()

    def note(self, key: str, value: Any) -> None:
        """Record one machine-readable fact (replication fallback, cost
        model source, probe timings...). Last write per key wins."""
        with self._lock:
            self._data["notes"][key] = value
        self._write()

    def set_metrics(self, metrics: dict) -> None:
        """Merge flat scalar metrics (e.g. ``GoodputLedger.flat_metrics``:
        ``goodput/mfu``, ``goodput/flops/<comp>_frac``, ...)."""
        with self._lock:
            for k, v in (metrics or {}).items():
                self._data["metrics"][k] = v
        self._write()

    def update(self, notes: dict, metrics: dict) -> None:
        """:meth:`note` for each of ``notes`` and :meth:`set_metrics`, in one
        write (the port's; a run's progress at each log boundary)."""
        with self._lock:
            self._data["notes"].update(notes)
            self._data["metrics"].update(metrics)
        self._write()

    def finalize(
        self,
        outcome: str,
        *,
        error: Optional[str] = None,
        exit_code: Optional[int] = None,
        metrics: Optional[dict] = None,
        notes: Optional[dict] = None,
    ) -> bool:
        """Stamp the terminal outcome; True iff this call won the race."""
        if outcome not in OUTCOMES:
            raise ValueError(
                f"unknown outcome {outcome!r}; use one of {OUTCOMES}"
            )
        with self._lock:
            if self._data["outcome"] != "running":
                return False
            self._data["outcome"] = outcome
            self._data["error"] = error
            self._data["exit_code"] = exit_code
            self._data["finalized_unix"] = round(float(self._clock()), 3)
            for k, v in (metrics or {}).items():
                self._data["metrics"][k] = v
            for k, v in (notes or {}).items():
                self._data["notes"][k] = v
        self._write()
        return True

    def move_to(self, path: str) -> None:
        """Re-home the manifest (config resolution can change the log
        dir after the early, pre-probe record was written)."""
        with self._lock:
            old = self.path
            self.path = path
        self._write()
        if old != path:
            try:
                os.remove(old)
            except OSError:
                pass

    # ----------------------------------------------------------------- I/O

    def _write(self) -> Optional[str]:
        with self._lock:
            if not self._enabled:
                return None
            payload = json.dumps(self._data, indent=2, default=str)
            path = self.path
        try:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, path)  # atomic: a crash mid-write cannot tear
            return path
        except OSError:
            return None

    @classmethod
    def load(cls, path: str) -> dict:
        with open(path) as f:
            return json.load(f)
