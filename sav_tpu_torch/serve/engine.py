"""Serving engine: bucketed dynamic batching over one warmed model.

Port of the serving core of ``sav_tpu/serve/engine.py``. One engine owns:

- **A model on the device**, its parameters loaded from a ``sav_tpu`` flax
  tree (:mod:`sav_tpu_torch.interop`), passed in as a built module, or
  drawn from ``ServeConfig.seed``; cast to the compute dtype, except the
  tensors flax keeps f32 (BatchNorm's scale, bias and running statistics,
  BoTNet's relative tables: :func:`~sav_tpu_torch.models.layers.cast_for_compute`),
  and in eval mode, so BatchNorm uses its running statistics.
- **A bucket ladder**, each rung warmed by one forward at startup, which
  also seeds the batcher's per-bucket step estimate (``startup_report``).
- **A deadline-aware dynamic batcher** (:mod:`sav_tpu_torch.serve.batcher`).
- **One device thread**: it drains a batch, pads it to its bucket in a
  pinned uint8 host tensor, copies it to the device without blocking,
  normalises there, runs the model, and does ONE ``.cpu()`` per batch
  before it resolves the futures. Padded rows are zeroed by the validity
  mask.

Not ported yet (ROADMAP queue A5): request telemetry, quality probes, the
fleet, int8 weights, sharding layouts, a compile/graph cache and the
double-buffered ``DeviceFeeder``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model
from sav_tpu_torch.models.layers import cast_for_compute
from sav_tpu_torch.ops.preprocess import normalize_images
from sav_tpu_torch.serve.batcher import (
    DynamicBatcher,
    FormedBatch,
    QueueFullError,
    ServeClosedError,
)
from sav_tpu_torch.serve.bucketing import BucketLadder, default_ladder
from sav_tpu_torch.serve.latency import LatencyLedger
from sav_tpu_torch.utils.device import COMPUTE_DTYPES, require_device


@dataclasses.dataclass
class ServeConfig:
    """Serving configuration."""

    model_name: str = "deit_s_patch16"
    num_classes: int = 1000
    image_size: int = 224
    compute_dtype: str = "bfloat16"
    # None = the port's auto rule (the fused kernel where it is eligible).
    attention_backend: Optional[str] = None
    # Extra create_model arguments (config overrides, logits_dtype).
    model_overrides: Optional[dict] = None
    # Batch-size rungs; None = powers of two up to max_batch.
    buckets: Optional[list] = None
    max_batch: int = 8
    max_queue: int = 256
    deadline_ms: float = 100.0
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        require_device(self.device)
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {self.compute_dtype!r}"
            )

    def ladder(self) -> BucketLadder:
        return BucketLadder(self.buckets if self.buckets else default_ladder(self.max_batch))


def build_infer_fn(model: nn.Module, compute_dtype: torch.dtype) -> Callable:
    """The serving step: uint8 NHWC batch + validity mask → masked f32 logits.

    Normalisation runs on the device the batch is on; padded rows (valid 0)
    come out exactly 0. Runs under ``torch.inference_mode`` in whichever
    thread calls it (the mode is thread-local).
    """

    def infer(images: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if images.dtype != torch.uint8:
            raise ValueError(
                f"serving wire format is uint8, got {images.dtype}; keep "
                "requests uint8 end to end"
            )
        with torch.inference_mode():
            logits = model(normalize_images(images, compute_dtype))
            return logits.float() * valid[:, None]

    return infer


class ServeEngine:
    """One model, one warmed bucket ladder, one batcher, one device thread.

    Construction loads the parameters and warms every bucket
    (:attr:`startup_report`); :meth:`start` opens admission; :meth:`submit`
    returns a future per request; :meth:`stop` fails what is still queued
    and joins the device thread. Context manager = start/stop.

    Parameters come from ``params`` (a flax tree, with ``batch_stats``
    beside ``params`` for a BatchNorm model, converted by
    :func:`~sav_tpu_torch.interop.params_from_flax`) loaded into ``model``
    (or a registry model), else from ``model`` as passed, else from a fresh
    init drawn from ``config.seed``.
    """

    def __init__(self, config: ServeConfig, *, model: Optional[nn.Module] = None, params=None):
        self.config = config
        self.device = require_device(config.device)
        self.ladder = config.ladder()
        self.compute_dtype = COMPUTE_DTYPES[config.compute_dtype]
        t0 = time.perf_counter()
        source = "passed"
        if model is None:
            model = create_model(
                config.model_name,
                num_classes=config.num_classes,
                image_size=config.image_size,
                backend=config.attention_backend,
                seed=config.seed,
                **(config.model_overrides or {}),
            )
            source = "init"
        if params is not None:
            model.load_state_dict(params_from_flax(params), strict=True)
            source = "flax"
        self.model = cast_for_compute(model.to(self.device), self.compute_dtype).eval()
        self._infer = build_infer_fn(self.model, self.compute_dtype)
        param_bytes = sum(p.numel() * p.element_size() for p in self.model.parameters())
        # Two passes over the ladder: the first builds kernels and warms the
        # libraries, the second times each bucket for the batcher.
        self._step_est: dict = {}
        warmup_t0 = time.perf_counter()
        for _ in range(2):
            for bucket in self.ladder.buckets:
                t = time.perf_counter()
                self._run(bucket, [])
                self._step_est[bucket] = time.perf_counter() - t
        self.startup_report = {
            "model": config.model_name,
            "device": str(self.device),
            "buckets": list(self.ladder.buckets),
            "params_source": source,
            "dtype": config.compute_dtype,
            "param_bytes": param_bytes,
            "startup_s": round(time.perf_counter() - t0, 3),
            "warmup_s": round(time.perf_counter() - warmup_t0, 3),
            "warmup_step_s": {str(b): round(s, 5) for b, s in self._step_est.items()},
        }
        self.ledger = LatencyLedger()
        self._batcher: Optional[DynamicBatcher] = None
        self._device_thread: Optional[threading.Thread] = None
        self._started = False
        self._stopped = False
        self._errors = 0

    def _run(self, bucket: int, payloads: list) -> np.ndarray:
        """Pad ``payloads`` to ``bucket`` rows, run the model, return the
        ``[bucket, num_classes]`` host logits (the one sync of a batch)."""
        s = self.config.image_size
        pin = self.device.type == "cuda"
        images = torch.zeros((bucket, s, s, 3), dtype=torch.uint8, pin_memory=pin)
        rows = images.numpy()
        for i, payload in enumerate(payloads):
            rows[i] = payload
        valid = torch.zeros((bucket,), dtype=torch.float32, pin_memory=pin)
        valid[: len(payloads)] = 1.0
        logits = self._infer(
            images.to(self.device, non_blocking=True),
            valid.to(self.device, non_blocking=True),
        )
        return logits.cpu().numpy()

    def start(self) -> "ServeEngine":
        if self._started:
            raise RuntimeError("engine already started")
        self._batcher = DynamicBatcher(
            self.ladder,
            step_time_fn=lambda bucket: self._step_est.get(bucket, 0.0),
            max_queue=self.config.max_queue,
            default_deadline_s=self.config.deadline_ms / 1e3,
        )
        self._device_thread = threading.Thread(
            target=self._device_loop, name="serve-device-loop", daemon=True
        )
        self._started = True
        self.ledger.start()
        self._device_thread.start()
        return self

    def _device_loop(self):
        while True:
            formed = self._batcher.next_batch()
            if formed is None:
                return
            t0 = time.perf_counter()
            try:
                host = self._run(formed.bucket, [r.payload for r in formed.requests])
            except Exception as e:  # noqa: BLE001 — fail this batch, serve on
                self._errors += 1
                self._batcher.mark_completed()
                for request in formed.requests:
                    request.future.set_exception(e)
                continue
            self._complete(formed, host, t0)

    def _complete(self, formed: FormedBatch, host: np.ndarray, t0: float):
        self._batcher.mark_completed()
        step_s = time.perf_counter() - t0
        # EMA keeps the batcher's dispatch-by estimate tracking the device.
        prev = self._step_est.get(formed.bucket, step_s)
        self._step_est[formed.bucket] = 0.8 * prev + 0.2 * step_s
        now = time.monotonic()
        latencies, overruns = [], []
        for i, request in enumerate(formed.requests):
            request.future.set_result(host[i])
            latencies.append(now - request.enqueue_t)
            overruns.append(now - request.deadline_t)
        self.ledger.observe_batch(
            bucket=formed.bucket,
            latencies_s=latencies,
            overruns_s=overruns,
            queue_depth=formed.queue_depth,
            step_s=step_s,
        )

    def submit(self, image: np.ndarray, *, deadline_ms: Optional[float] = None):
        """Admit one ``[image_size, image_size, 3]`` uint8 request; returns
        its future. Raises :class:`QueueFullError` on an admission reject."""
        if not self._started or self._stopped:
            raise ServeClosedError("engine is not serving (start() first)")
        image = np.asarray(image)
        s = self.config.image_size
        if image.shape != (s, s, 3) or image.dtype != np.uint8:
            raise ValueError(
                f"expected a [{s}, {s}, 3] uint8 request, got {image.shape} {image.dtype}"
            )
        deadline_s = (deadline_ms if deadline_ms is not None else self.config.deadline_ms) / 1e3
        try:
            return self._batcher.submit(image, deadline_s=deadline_s)
        except QueueFullError:
            self.ledger.observe_rejected()
            raise

    def stop(self, timeout_s: float = 30.0) -> dict:
        """Fail queued requests, let the batch on the device finish, join the
        device thread. Returns the serving summary. Idempotent."""
        if not self._stopped:
            self._stopped = True
            if self._batcher is not None:
                self._batcher.close()
            if self._device_thread is not None:
                self._device_thread.join(timeout=timeout_s)
        return self.stats()

    def stats(self) -> dict:
        out = {"ledger": self.ledger.summary(), "errors": self._errors}
        if self._batcher is not None:
            out["batcher"] = self._batcher.stats()
        return out

    def __enter__(self) -> "ServeEngine":
        return self.start() if not self._started else self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False
