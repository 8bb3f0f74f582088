"""Checkpointing with restore (the port's own counterpart of
``sav_tpu/train/checkpoint.py``), on ``torch.save`` alone.

Each step is a directory ``<directory>/<step>`` holding four files:

- ``params.pt``: ``{"step", "params", "batch_stats"}``, the model's
  parameters and buffers by name;
- ``opt_state.pt``: ``{"opt_state": {"count", "mu", "nu"[, "ema"]}}``;
- ``generators.pt``: ``{"generators": {name: state}}``, the byte tensors of
  the trainer's generators (``torch.Generator.get_state()``);
- ``config.json``: the run's ``TrainConfig``, when the caller gives it.

The files hold only tensors, ints, strings and dicts, so
``torch.load(weights_only=True)`` reads them. A step is written under a
temporary name (``.<step>.tmp-<hex>``) and committed by ``os.replace``, so
a crash leaves a missing step, never a torn one; a process killed during a
write leaves its temporary directory, which the next writable
:class:`Checkpointer` of the directory removes. :meth:`Checkpointer.restore_latest` falls back to
older steps when the newest fails to load all the same (a disk can still
lose data).

:meth:`Checkpointer.save` copies every tensor to the host on the calling
thread (the trainer updates parameters, moments and BatchNorm buffers in
place, so a later step must not reach the snapshot) and hands the file
writes to one background thread, which touches no device tensor.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import re
import shutil
import time
import uuid
from typing import Any, Optional

import torch

PARAMS_FILE = "params.pt"
OPT_STATE_FILE = "opt_state.pt"
GENERATORS_FILE = "generators.pt"
CONFIG_FILE = "config.json"
# A step's temporary directory, until os.replace commits it (_write).
_TORN = re.compile(r"\.\d+\.tmp-[0-9a-f]+")


def host_snapshot(tree: Any, out: Any = None, *, wait: bool = True) -> Any:
    """``tree`` (nested dicts of tensors and scalars) with every tensor
    copied to the host: a copy even where it already lies there. A device
    tensor goes to pinned memory without a wait each; one wait for the
    stream ends the snapshot. With ``wait=False`` the copies are left in
    flight on the current stream, ordered before any later work there: the
    caller waits for that stream (an event recorded on it) before reading
    them. ``out``, a snapshot of a tree of the same form made here before,
    takes the copies into its tensors where shape and dtype match, rather
    than into new ones."""
    copies = []

    def copy(node, into):
        if isinstance(node, dict):
            return {key: copy(value, into.get(key) if isinstance(into, dict) else None)
                    for key, value in node.items()}
        if not torch.is_tensor(node):
            return node
        node = node.detach()
        reuse = (torch.is_tensor(into) and into.shape == node.shape
                 and into.dtype == node.dtype)
        if node.device.type != "cuda":
            return into.copy_(node) if reuse else node.to("cpu", copy=True)
        host = into if reuse else torch.empty(node.shape, dtype=node.dtype, pin_memory=True)
        host.copy_(node, non_blocking=True)
        copies.append(node.device)
        return host

    snapshot = copy(tree, out)
    if wait:
        for device in set(copies):
            torch.cuda.current_stream(device).synchronize()
    return snapshot


def host_buffers(tree: Any) -> Any:
    """Empty host tensors in ``tree``'s form, pinned where a tensor lies on
    the card: the ``out`` of later :func:`host_snapshot` calls."""
    if isinstance(tree, dict):
        return {key: host_buffers(value) for key, value in tree.items()}
    if not torch.is_tensor(tree):
        return tree
    return torch.empty(tree.shape, dtype=tree.dtype, pin_memory=tree.device.type == "cuda")


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class Checkpointer:
    """``Checkpointer(directory, *, keep=3, read_only=False)``.

    ``keep`` is the number of committed steps retained.
    ``read_only`` opens an existing directory for restores only (warm
    starts): a missing directory raises ``FileNotFoundError`` and nothing is
    created; :meth:`save` raises.
    """

    def __init__(self, directory: str, *, keep: int = 3, read_only: bool = False):
        self._dir = os.path.abspath(directory)
        self._keep = keep
        self._read_only = read_only
        if read_only:
            if not os.path.isdir(self._dir):
                raise FileNotFoundError(f"checkpoint directory does not exist: {self._dir!r}")
            self._writer = None
        else:
            os.makedirs(self._dir, exist_ok=True)
            self._remove_torn()
            self._writer = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint-writer"
            )
        self._pending: list = []
        # One record per committed save, collected by wait():
        # {"step", "write_s", "bytes"}.
        self.written: list = []
        # Seconds the last save held the calling thread (the host snapshot).
        self.last_hold_s: Optional[float] = None

    @property
    def directory(self) -> str:
        return self._dir

    def _remove_torn(self) -> None:
        """Remove the temporary directories of writes that never committed
        (a process killed during a save leaves one; its ``except`` never
        ran). One writer owns a directory, and a new one has no write in
        flight yet, so every such directory is torn."""
        for name in os.listdir(self._dir):
            if _TORN.fullmatch(name) and os.path.isdir(os.path.join(self._dir, name)):
                logging.warning("removing %s, the torn write of a save that never committed",
                                os.path.join(self._dir, name))
                shutil.rmtree(os.path.join(self._dir, name), ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    # ----------------------------------------------------------------- save

    def save(self, step: int, state, *, config: Optional[str] = None) -> None:
        """Snapshot ``state`` (a :class:`~sav_tpu_torch.train.state.TrainState`)
        on the host now and write it as step ``step`` in the background;
        ``config`` is the run's config as JSON text. An earlier write's
        failure is raised here or by :meth:`wait`."""
        if self._writer is None:
            raise RuntimeError(f"checkpoint directory {self._dir!r} was opened read-only")
        self._collect([f for f in self._pending if f.done()])
        t0 = time.perf_counter()
        snap = host_snapshot(state.state_dict())
        files = {
            PARAMS_FILE: {"step": snap["step"], "params": snap["params"],
                          "batch_stats": snap["batch_stats"]},
            OPT_STATE_FILE: {"opt_state": snap["opt_state"]},
            GENERATORS_FILE: {"generators": snap["generators"]},
        }
        self._pending.append(self._writer.submit(self._write, int(step), files, config))
        self.last_hold_s = time.perf_counter() - t0

    def _write(self, step: int, files: dict, config: Optional[str]) -> dict:
        """Runs on the writer thread: the files into a temporary directory,
        each flushed to disk, then one rename commits the step."""
        t0 = time.perf_counter()
        tmp = os.path.join(self._dir, f".{step}.tmp-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        try:
            payloads = dict(files)
            if config is not None:
                payloads[CONFIG_FILE] = config
            nbytes = 0
            for name, payload in payloads.items():
                path = os.path.join(tmp, name)
                with open(path, "wb") as f:
                    if isinstance(payload, str):
                        f.write(payload.encode())
                    else:
                        torch.save(payload, f)
                    f.flush()
                    os.fsync(f.fileno())
                nbytes += os.path.getsize(path)
            final = self._step_dir(step)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self._keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return {"step": step, "write_s": time.perf_counter() - t0, "bytes": nbytes}

    def _collect(self, done) -> None:
        for future in done:
            self._pending.remove(future)
            self.written.append(future.result())

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Block until the writes in flight are committed; raise a write's
        error. ``timeout_s`` bounds the wait: ``False`` when it runs out
        with a write still in flight (which may commit later, or leave its
        step missing; never torn)."""
        done, not_done = concurrent.futures.wait(list(self._pending), timeout=timeout_s)
        self._collect([f for f in self._pending if f in done])  # in the order saved
        return not not_done

    def close(self) -> None:
        """Wait for the writes in flight, then stop the writer thread."""
        if self._writer is not None:
            try:
                self.wait()
            finally:
                self._writer.shutdown()
                self._writer = None

    # ------------------------------------------------------------- restore

    def all_steps(self) -> list:
        """Committed steps, ascending."""
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit() and os.path.isdir(os.path.join(self._dir, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read(self, step: int) -> dict:
        """Every file of ``step``, on the host:
        ``{"step", "params", "batch_stats", "opt_state", "generators", "config"}``."""
        root = self._step_dir(step)
        out = dict(_load(os.path.join(root, PARAMS_FILE)))
        out.update(_load(os.path.join(root, OPT_STATE_FILE)))
        out.update(_load(os.path.join(root, GENERATORS_FILE)))
        config = os.path.join(root, CONFIG_FILE)
        out["config"] = None
        if os.path.exists(config):
            with open(config) as f:
                out["config"] = json.load(f)
        return out

    def restore_latest(self, template):
        """Restore the newest loadable step into ``template`` (a
        ``TrainState``: its tensors and generators are overwritten in
        place, on their devices); returns the restored state, or None when
        there is no step. When the newest step fails to load, older steps
        are tried in turn, with a warning naming the fallback; the newest
        step's error is raised only when every step fails."""
        steps = self.all_steps()
        if not steps:
            return None
        first_error: Optional[Exception] = None
        for step in reversed(steps):
            try:
                restored = template.load_state_dict(self._read(step))
            except Exception as e:  # noqa: BLE001 — any unreadable step falls back
                if first_error is None:
                    first_error = e
                else:
                    logging.warning("checkpoint step %d also failed to restore: %r", step, e)
                continue
            if first_error is not None:
                logging.warning(
                    "newest checkpoint failed to restore (%r); resumed from the older "
                    "step %d instead", first_error, step,
                )
            return restored
        raise first_error

    def restore_params_only(self, template: dict, step: Optional[int] = None) -> Optional[dict]:
        """``{"params", "batch_stats", "step"}`` of ``step`` (default: the
        newest) without opening the optimizer state, the serving path.
        ``template`` is ``{"params": {name: tensor}, "batch_stats": {...}}``;
        each restored tensor takes its template's device and dtype, and a
        missing name or another shape raises. None when there is no step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        saved = _load(os.path.join(self._step_dir(step), PARAMS_FILE))
        out = {"step": int(saved["step"])}
        for kind in ("params", "batch_stats"):
            out[kind] = {}
            for name, like in template.get(kind, {}).items():
                value = saved[kind][name]
                if tuple(value.shape) != tuple(like.shape):
                    raise ValueError(f"{kind} {name}: saved shape {tuple(value.shape)} != "
                                     f"{tuple(like.shape)}")
                out[kind][name] = value.to(device=like.device, dtype=like.dtype)
        return out

    def restore_raw(self, step: Optional[int] = None) -> Optional[dict]:
        """A step (default: the newest) in its saved structure, on the host:
        ``{"step", "params", "batch_stats", "opt_state", "generators",
        "config"}``; None when there is no step. For warm starts, where the
        saved shapes may differ from the new model's."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return self._read(step)
