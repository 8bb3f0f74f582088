"""Device-side prediction-quality primitives: in-graph output digests, the
golden-probe batch and fingerprint, and the deterministic weight-perturbation
chaos seam.

Port of ``sav_tpu/serve/quality.py``. The scalar folds (windows, drift
gates, ledgers) live stdlib-side in :mod:`sav_tpu_torch.obs.quality`; this
module is the only quality code that touches torch and numpy, and none of it
runs on the request path:

- :func:`output_digests` is part of the serving program: the engine captures
  it into every bucket's CUDA graph beside the logits, and the digests ride
  the batch's one copy to the host as three more small outputs (B ints and
  2B floats), so quality telemetry adds no device sync to a batch.
- :class:`ProbeRunner` runs on its own low-cadence thread and submits through
  the NORMAL admission path, but only when the engine is fully idle — a
  probe sheds itself before it would ever queue behind (or evict) a live
  request.
- :func:`fingerprint_logits` is a blake2b over the exact float32 logit
  bytes: bit-stable under a fixed program and fixed weights, so a matching
  fingerprint across a restart proves weight integrity (and a per-dtype
  reference keeps int8 and bf16 replicas from judging each other's bits).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from sav_tpu_torch.interop import flax_from_params, params_from_flax

# Golden probe shape: small on purpose (one bucket-1..4 batch); the probe is
# a weight-integrity check, not a benchmark.
PROBE_ROWS = 4
# The probe's byte stream is keyed by this tag, sav_tpu's, so the port and
# sav_tpu regenerate the same images and the same probe_id.
_PROBE_TAG = b"sav_tpu golden probe v1"


def output_digests(logits: torch.Tensor, valid: torch.Tensor) -> dict:
    """Per-row digests computed next to the logits: top-1 class index, top-1
    margin (best minus runner-up) and predictive entropy (nats). Padded rows
    (``valid`` 0) come out 0.

    ``top1`` is the FIRST maximum (``torch.argmax``, as ``jnp.argmax``). The
    runner-up is a second max with exactly the argmax slot masked to the
    dtype's lowest value, not ``topk``: all logits equal gives margin 0,
    never -inf, and a single-class head gives 0. The margin is taken in the
    logits' dtype, as ``sav_tpu``'s; the entropy from ``log_softmax`` in f32
    (the engine's logits are f32, so this is ``sav_tpu``'s arithmetic).
    Device ops only, no host scalar read, so it captures into a CUDA graph.
    """
    top1 = torch.argmax(logits, dim=-1)
    num_classes = logits.shape[-1]
    best = torch.amax(logits, dim=-1)
    if num_classes < 2:  # a single-class head: no runner-up
        second = best
    else:
        classes = torch.arange(num_classes, device=logits.device)
        is_top1 = classes == top1[..., None]
        second = torch.amax(logits.masked_fill(is_top1, torch.finfo(logits.dtype).min), dim=-1)
    margin = (best - second) * valid
    logp = torch.log_softmax(logits.float(), dim=-1)
    entropy = -torch.sum(torch.exp(logp) * logp, dim=-1) * valid
    return {
        "top1": top1.to(torch.int32) * valid.to(torch.int32),
        "margin": margin.to(torch.float32),
        "entropy": entropy.to(torch.float32),
    }


def digested_infer_fn(infer_fn: Callable) -> Callable:
    """Wrap a ``build_infer_fn`` program so it returns ``{"logits", "top1",
    "margin", "entropy"}``: the digests are part of the same program (and of
    the same captured graph and result copy) rather than computed on the host
    per request."""

    def infer(images: torch.Tensor, valid: torch.Tensor) -> dict:
        logits = infer_fn(images, valid)
        with torch.inference_mode():
            out = {"logits": logits}
            out.update(output_digests(logits, valid))
        return out

    return infer


# --------------------------------------------------------------- probe


def make_probe_batch(image_size: int, rows: int = PROBE_ROWS) -> tuple:
    """``(images, probe_id)``: a content-addressed deterministic uint8 probe
    batch. The bytes are a blake2b stream keyed only by the request shape, so
    every replica of every fleet (and ``sav_tpu``'s) regenerates the
    identical batch — and ``probe_id`` (the digest OF those bytes) names it,
    so a reference fingerprint can never be compared against logits from a
    different probe."""
    need = rows * image_size * image_size * 3
    chunks = []
    counter = 0
    while sum(len(c) for c in chunks) < need:
        h = hashlib.blake2b(
            _PROBE_TAG + f":{image_size}:{rows}:{counter}".encode(),
            digest_size=64,
        )
        chunks.append(h.digest())
        counter += 1
    raw = b"".join(chunks)[:need]
    images = np.frombuffer(raw, np.uint8).reshape(rows, image_size, image_size, 3)
    probe_id = hashlib.blake2b(raw, digest_size=8).hexdigest()
    return images, probe_id


def fingerprint_logits(rows) -> str:
    """blake2b over the exact float32 logit bytes of the probe rows —
    bit-stable under a fixed program and weights."""
    h = hashlib.blake2b(digest_size=16)
    for row in rows:
        h.update(np.ascontiguousarray(np.asarray(row, np.float32)).tobytes())
    return h.hexdigest()


def _reference_path(log_dir: str) -> str:
    return os.path.join(log_dir, "fleet", "probe_reference.json")


def load_reference(log_dir: Optional[str]) -> dict:
    if not log_dir:
        return {}
    try:
        with open(_reference_path(log_dir)) as f:
            return json.load(f) or {}
    except (OSError, ValueError):
        return {}


def store_reference(log_dir: Optional[str], key: str, fingerprint: str) -> None:
    """First writer wins per ``probe_id:dtype`` key (replicas of identical
    weights write identical values, so the race is benign); tmp file and
    rename, so a torn write never corrupts the reference."""
    if not log_dir:
        return
    path = _reference_path(log_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = load_reference(log_dir)
    if key in doc:
        return
    doc[key] = fingerprint
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


class ProbeRunner:
    """Low-cadence golden-probe thread.

    Submits the probe batch through the engine's NORMAL admission path
    (``engine.submit``, so the probe exercises the batcher, the feeder, the
    captured program and the depad the live traffic does), but only when the
    engine is fully idle: any queued or in-flight live work sheds the probe
    instead (``probe_shed`` on the ledger) — probe traffic never evicts or
    delays a live request.

    Outcomes land on the stdlib :class:`~sav_tpu_torch.obs.quality.ProbeLedger`
    that the heartbeat's ``quality_fn`` snapshots; the expected fingerprint
    is persisted per ``probe_id:dtype`` (the engine's
    ``startup_report["dtype"]``) under ``log_dir``, so a restarted replica on
    the same weights must reproduce its predecessor's bits exactly.

    The probe's rows carry a 10 s deadline, so on an idle engine whose top
    bucket is above :data:`PROBE_ROWS` the batcher holds them until that
    deadline less a step before it ships them (as in ``sav_tpu``).
    """

    def __init__(self, engine, ledger, *, every_s: float, log_dir: Optional[str] = None):
        self._engine = engine
        self._ledger = ledger
        self._every_s = max(0.05, float(every_s))
        self._log_dir = log_dir
        self._images, self.probe_id = make_probe_batch(engine.config.image_size)
        self.key = f"{self.probe_id}:{engine.startup_report['dtype']}"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ProbeRunner":
        self._thread = threading.Thread(target=self._loop, name="serve-probe", daemon=True)
        self._thread.start()
        return self

    def close(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def _loop(self) -> None:
        while not self._stop.wait(self._every_s):
            try:
                self.observe_probe()
            except Exception:  # noqa: BLE001 — the probe is observability
                # A failed probe run must never take the serving loop down.
                self._ledger.record_shed()

    # -------------------------------------------------------------- one run

    def _idle(self) -> bool:
        batcher = getattr(self._engine, "_batcher", None)
        if batcher is None:
            return False
        stats = batcher.stats()
        return not stats.get("queued") and not stats.get("inflight")

    def observe_probe(self) -> Optional[bool]:
        """One probe run: None when shed (engine busy or closed), else
        whether the fingerprint matched the reference. May block on the
        probe's own results: it never runs on a request path."""
        if not self._idle():
            self._ledger.record_shed()
            return None
        try:
            futures = [self._engine.submit(row, deadline_ms=10_000) for row in self._images]
        except Exception:  # noqa: BLE001 — admission refused: shed
            self._ledger.record_shed()
            return None
        rows = [f.result(timeout=30.0) for f in futures]
        fingerprint = fingerprint_logits(rows)
        expected = load_reference(self._log_dir).get(self.key)
        if expected is None:
            # First run under this (probe, dtype): the observed bits BECOME
            # the reference every later run and restart must match.
            store_reference(self._log_dir, self.key, fingerprint)
            expected = load_reference(self._log_dir).get(self.key, fingerprint)
        return self._ledger.record(fingerprint=fingerprint, expected=expected,
                                   probe_id=self.probe_id)


# ---------------------------------------------------------- chaos seam


def _leaves(tree: dict, prefix: tuple = ()):
    """``(path, leaf)`` of a nested dict in the order ``jax.tree`` flattens
    it: keys sorted at every level."""
    for name in sorted(tree):
        value = tree[name]
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def noise_params(model: nn.Module, scale: float, seed: int = 0) -> None:
    """Deterministically perturb every float parameter of ``model`` in place,
    each by ``scale`` times its own std — the ``SAV_CHAOS_NOISE_WEIGHTS``
    seam: a planted corrupt replica for the shadow-agreement and
    probe-mismatch detection.

    The draws are ``sav_tpu``'s: one ``numpy`` generator from ``seed``,
    leaf by leaf in the order ``jax.tree`` flattens the flax params tree
    that :mod:`sav_tpu_torch.interop` maps the parameters to, each leaf
    perturbed in that tree's layout and carried back. So the noised
    parameters equal ``sav_tpu``'s noised tree carried across by
    ``params_from_flax``, exactly. Buffers (BatchNorm statistics) are left
    alone, as ``sav_tpu`` leaves its ``batch_stats``."""
    rng = np.random.default_rng(int(seed))
    scale = float(scale)
    params = {name: p.detach() for name, p in model.named_parameters()}
    tree = flax_from_params(params, type(model).__name__)["params"]
    noised: dict = {}
    for path, arr in _leaves(tree):
        if np.issubdtype(arr.dtype, np.floating):
            std = float(arr.std()) or 1.0
            noise = rng.standard_normal(arr.shape).astype(arr.dtype)
            arr = arr + scale * std * noise
        node = noised
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = arr
    state = params_from_flax(noised)
    with torch.no_grad():
        for name, value in state.items():
            params[name].copy_(value)
