"""Metric writers: host-side sinks for the trainer's log records (the
port's own copy of ``sav_tpu/utils/writers.py``).

The trainer hands a plain ``dict[str, float]`` to a writer after the log
boundary's copy to the host. :class:`JsonlWriter` appends
``<log_dir>/metrics.jsonl`` in ``sav_tpu``'s format; writers compose via
:class:`MultiWriter`. ``sav_tpu``'s wandb and TensorBoard sinks are not
ported (ROADMAP queue A10).
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Protocol, Sequence


class MetricWriter(Protocol):
    def write(self, step: int, metrics: Mapping[str, float]) -> None: ...
    def close(self) -> None: ...


class JsonlWriter:
    """One JSON object per write, appended to ``<dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, filename)
        self._f = open(self._path, "a", buffering=1)

    @property
    def path(self) -> str:
        return self._path

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        rec = {"step": int(step)}
        for k, v in metrics.items():
            if k == "step":
                continue  # the positional step wins; don't float-cast it
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                # Non-scalar payloads (e.g. a goodput summary dict) pass
                # through as-is — jsonl is the one sink that can hold them.
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class LoggingWriter:
    """Writes through a callable (default ``print``) — the CLI sink."""

    def __init__(self, log_fn=print):
        self._log_fn = log_fn

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        parts = ", ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in metrics.items()
        )
        self._log_fn(f"step {step}: {parts}")

    def close(self) -> None:
        pass


class MultiWriter:
    """Fan-out to several writers."""

    def __init__(self, writers: Sequence[MetricWriter]):
        self._writers = list(writers)

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        for w in self._writers:
            w.write(step, metrics)

    def close(self) -> None:
        # Close every sink even if one raises (a wandb network error must
        # not leave the jsonl file unflushed); re-raise the first failure.
        errors: list[Exception] = []
        for w in self._writers:
            try:
                w.close()
            except Exception as e:
                errors.append(e)
        if errors:
            raise errors[0]
