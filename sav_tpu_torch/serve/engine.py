"""Serving engine: bucketed dynamic batching over captured programs.

Port of the serving core of ``sav_tpu/serve/engine.py``. One engine owns:

- **A model on the device**, its parameters restored params-only from a
  training checkpoint (``ServeConfig.checkpoint_dir``, the port's
  :class:`~sav_tpu_torch.train.checkpoint.Checkpointer`; the optimizer
  file is never opened), loaded from a ``sav_tpu`` flax tree
  (:mod:`sav_tpu_torch.interop`), passed in as a built module, or drawn
  from ``ServeConfig.seed``; cast to the compute dtype, except the tensors
  flax keeps f32 (BatchNorm's scale, bias and running statistics, BoTNet's
  relative tables: :func:`~sav_tpu_torch.models.layers.cast_for_compute`),
  and in eval mode, so BatchNorm uses its running statistics.
- **A ladder of captured programs.** On the card, startup warms and
  captures one CUDA graph per bucket (:mod:`sav_tpu_torch.serve.graphs`)
  before admission opens, so request time never runs the model from
  Python; ``startup_report`` says what the capture launched and cost. On
  the CPU (``device="cpu"``, as the tests ask) the infer function runs
  eagerly. A CUDA graph cannot be saved to disk, so there is no
  ``compilation_cache_dir``: a restart captures again, and only the kernel
  libraries under ``build/`` persist (``compiled_from_scratch`` and
  ``cache_hits`` count them).
- **A deadline-aware dynamic batcher** (:mod:`sav_tpu_torch.serve.batcher`),
  its per-bucket step estimates seeded from timed replays.
- **A double-buffered feed** (:class:`~sav_tpu_torch.data.feeder.DeviceFeeder`):
  its worker drains the batcher, pads each batch into pinned host memory
  and copies it to the card on a CUDA stream of its own, while the device
  loop runs the batch before. The device loop waits on the batch's event,
  copies it into its bucket's static buffers, replays the graph on the
  engine's compute stream and makes ONE copy of the logits to the host per
  batch before it resolves the futures. Padded rows come out exactly 0
  (the validity mask).

With ``ServeConfig.quant_weights`` the engine serves int8 weights: it loads
the float parameters (any source above) into the float model, quantizes
them per channel (:func:`~sav_tpu_torch.ops.quant.quantize_params`) into
the same model built with ``quant="int8_serve"``, and serves that; every
projection, FF and head dot runs on the int8 kernels, the attention core
in the compute dtype. ``startup_report["quant"]`` carries ``sav_tpu``'s
HBM-density proof (:func:`~sav_tpu_torch.ops.quant.quant_report`).

**Telemetry** (``ServeConfig.telemetry``, on by default, as in ``sav_tpu``):
every request carries a span record stamped at each stage of its life
(:mod:`sav_tpu_torch.serve.telemetry`; host clock reads only, ``executed``
after the device loop's one sync per batch), the ledger feeds a live
window, an SLO tracker scores every request and shed, and with a
``log_dir`` a heartbeat thread appends ``kind=serve`` beats to
``fleet/proc_<i>.jsonl`` (windowed p99, queue depth, occupancy, SLO burn,
measured capacity, the caching allocator's memory watermark, firing
alerts), slow requests are dumped as exemplars under ``serve_traces/``, and
the serve run manifest (``manifest-serve-<time>-<pid>.json``) is finalized
at :meth:`ServeEngine.stop` with the ledger's metrics and ``slo_hit_frac``.
A telemetry that fails to start raises; it is never switched off quietly.

**Prediction quality** (:mod:`sav_tpu_torch.serve.quality`): the serving
program returns per-row digests (top-1, margin, entropy) beside the logits,
captured into the same graph and copied to the host with them before the
batch's one sync; the device loop folds them into a
:class:`~sav_tpu_torch.obs.quality.QualityTracker` (drift against a frozen
reference window) that every ``kind=serve`` beat and the manifest's
``notes.quality`` carry. With ``ServeConfig.probe_every_s`` a golden-probe
thread fingerprints a fixed probe batch whenever the engine is idle and
holds it against the reference stored under ``log_dir`` per ``probe_id`` and
``startup_report["dtype"]`` (a :class:`~sav_tpu_torch.obs.quality.ProbeLedger`
counts the outcomes). ``SAV_CHAOS_NOISE_WEIGHTS=<scale>`` perturbs the float
parameters before any quantization (the planted-corruption seam).

Not ported yet: the anomaly profiler (``ServeConfig.autoprof*``, ROADMAP
queue A10) and sharding layouts (A9). A fleet of engines behind a router is
:mod:`sav_tpu_torch.serve.fleet` and :mod:`sav_tpu_torch.serve.router`.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from sav_tpu_torch.data.feeder import DeviceFeeder
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model
from sav_tpu_torch.models.layers import cast_for_compute
from sav_tpu_torch.obs.fleet import HeartbeatWriter, resolve_identity
from sav_tpu_torch.obs.manifest import RunManifest, classify_exception
from sav_tpu_torch.obs.memory import HbmWatermark
from sav_tpu_torch.obs.quality import ProbeLedger, QualityTracker
from sav_tpu_torch.ops import _build
from sav_tpu_torch.ops.preprocess import normalize_images
from sav_tpu_torch.ops.quant import is_quantized_template, quant_report, quantize_params
from sav_tpu_torch.serve.batcher import (
    DynamicBatcher,
    FormedBatch,
    QueueFullError,
    ServeClosedError,
)
from sav_tpu_torch.serve.bucketing import BucketLadder, default_ladder
from sav_tpu_torch.serve.graphs import BucketGraphs
from sav_tpu_torch.serve.latency import LatencyLedger
from sav_tpu_torch.serve.preprocess import preprocess_request
from sav_tpu_torch.serve.quality import ProbeRunner, digested_infer_fn, noise_params
from sav_tpu_torch.serve.telemetry import ServeTelemetry, stamp
from sav_tpu_torch.train.checkpoint import Checkpointer
from sav_tpu_torch.train.state import persistent_buffers
from sav_tpu_torch.utils.device import COMPUTE_DTYPES, require_device
from sav_tpu_torch.utils.graphs import held_stream


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
    # Batch-size rungs, one captured program each; None = powers of two up
    # to max_batch.
    buckets: Optional[list] = None
    max_batch: int = 8
    max_queue: int = 256
    deadline_ms: float = 100.0
    # Placed batches buffered beyond the one executing (the DeviceFeeder's
    # depth: the copy of batch N+1 to the card overlaps the run of N).
    feed_depth: int = 2
    # A training checkpoint to serve (params-only restore; the optimizer
    # state is never read). None = params, model or a fresh init.
    checkpoint_dir: Optional[str] = None
    # Serve int8 weights: the float parameters quantized per channel into
    # the int8_serve model (sav_tpu's ServeConfig.quant_weights).
    quant_weights: bool = False
    # Sink for the serve run manifest and the telemetry files (None: no
    # files; spans, windows and SLO still run in memory).
    log_dir: Optional[str] = None
    seed: int = 0
    device: str = "cuda"
    # ---- serve telemetry (sav_tpu_torch/serve/telemetry.py), sav_tpu's
    # defaults. Heartbeats and slow-request exemplars need a log_dir.
    telemetry: bool = True
    # Trailing window of the live p50/p99/throughput/queue view.
    telemetry_window_s: float = 30.0
    # Serve heartbeat cadence (kind=serve lines; 0 disables the thread).
    heartbeat_secs: float = 5.0
    # Completed request traces kept in the span ring.
    trace_ring: int = 256
    # Slow-request exemplar bundles dumped per run (serve_traces/).
    slow_exemplars: int = 8
    # Slow gate: latency beyond median + slow_sigma scaled MADs of the
    # live window.
    slow_sigma: float = 4.0
    # SLO: deadline-hit-rate objective and the two burn windows.
    slo_target: float = 0.99
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 600.0
    slo_burn_threshold: float = 2.0
    # Golden-probe cadence: every probe_every_s seconds an idle engine runs
    # the probe batch through admission and fingerprints the logits (0
    # disables the thread). Probes shed themselves whenever live work is
    # queued or in flight.
    probe_every_s: float = 0.0

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
    thread calls it (the mode is thread-local). Nothing in it copies from
    the host, so it can be captured as a CUDA graph.
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


def restore_params(model: nn.Module, directory: str) -> None:
    """Copy the newest checkpoint's ``params`` and ``batch_stats`` in
    ``directory`` into ``model``'s parameters and buffers, params-only
    (:meth:`Checkpointer.restore_params_only`: the optimizer file is never
    opened). Raises ``FileNotFoundError`` when the directory holds no
    checkpoint."""
    template = {"params": dict(model.named_parameters()),
                "batch_stats": persistent_buffers(model)}
    ckpt = Checkpointer(directory, read_only=True)
    try:
        restored = ckpt.restore_params_only(template)
    finally:
        ckpt.close()
    if restored is None:
        raise FileNotFoundError(f"no checkpoint found in {directory!r}")
    with torch.no_grad():
        for kind in ("params", "batch_stats"):
            for name, value in restored[kind].items():
                template[kind][name].copy_(value)


class Placed(NamedTuple):
    """A batch on the engine's device: the padded uint8 images, the
    validity mask and, on the card, the event its copy recorded."""

    images: torch.Tensor
    valid: torch.Tensor
    event: Optional[torch.cuda.Event]


class ServeEngine:
    """One model, one ladder of captured programs, one batcher, one feeder,
    one device thread.

    Construction loads the parameters and, on the card, warms and captures
    every bucket (:attr:`startup_report`); :meth:`start` opens admission;
    :meth:`submit` (or :meth:`submit_raw`) returns a future per request;
    :meth:`drain` waits for what was admitted; :meth:`stop` fails what is
    still queued and joins the device thread. Context manager = start/stop.

    Parameters come from ``config.checkpoint_dir`` (params-only, through
    :func:`restore_params`), else from ``params`` (a flax tree, with
    ``batch_stats`` beside ``params`` for a BatchNorm model, converted by
    :func:`~sav_tpu_torch.interop.params_from_flax`), loaded into ``model``
    (or a registry model), else from ``model`` as passed, else from a fresh
    init drawn from ``config.seed``.

    Several engines may serve on one device at once: each holds streams
    of its own (:func:`~sav_tpu_torch.utils.graphs.held_stream`), so their
    graphs never share a cuBLAS workspace.

    With ``config.log_dir`` the engine writes the serve run manifest and,
    with telemetry on, the heartbeat stream and the exemplars beside it.

    Test seams: ``place_hook`` fires on the feeder thread after a batch is
    placed, ``execute_hook`` on the device loop before it runs one (after
    the ``dispatched`` stamp, so a held batch books as device time); the
    overlap test holds a batch in ``execute_hook`` and waits for the next
    one's ``place_hook``.
    """

    def __init__(
        self,
        config: ServeConfig,
        *,
        model: Optional[nn.Module] = None,
        params=None,
        place_hook: Optional[Callable[[FormedBatch], None]] = None,
        execute_hook: Optional[Callable[[FormedBatch], None]] = None,
        manifest: Optional[RunManifest] = None,
    ):
        self.config = config
        self.device = require_device(config.device)
        self.ladder = config.ladder()
        self.compute_dtype = COMPUTE_DTYPES[config.compute_dtype]
        self.place_hook = place_hook
        self.execute_hook = execute_hook
        t0 = time.perf_counter()
        source = "passed"
        if config.quant_weights and model is not None:
            raise ValueError(
                "quant_weights=True builds its own float/int8_serve model pair from the "
                "registry; pass model=None (an int8_serve model built elsewhere already "
                "holds quantized weights, so quant_weights would add nothing)"
            )
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
        if config.checkpoint_dir:
            restore_params(model, config.checkpoint_dir)
            source = f"checkpoint:{config.checkpoint_dir}"
        elif params is not None:
            state = params_from_flax(params)
            if config.quant_weights and is_quantized_template(state):
                raise ValueError(
                    "quant_weights=True quantizes float parameters; these are already an "
                    "int8 serving tree"
                )
            model.load_state_dict(state, strict=True)
            source = "flax"
        noise_scale = os.environ.get("SAV_CHAOS_NOISE_WEIGHTS")
        if noise_scale:
            # Chaos seam: corrupt the FLOAT parameters before any
            # quantization, so a planted-fault replica misbehaves alike on
            # every arm (the probe-mismatch and shadow-agreement checks).
            noise_params(model, float(noise_scale))
        self.quant_report: Optional[dict] = None
        if config.quant_weights:
            model, self.quant_report = self._quantized(model)
        self.model = cast_for_compute(model.to(self.device), self.compute_dtype).eval()
        # The serving program: the logits and their digests, one program
        # (one captured graph a bucket on the card).
        self.infer_fn = digested_infer_fn(build_infer_fn(self.model, self.compute_dtype))
        param_bytes = sum(t.numel() * t.element_size() for t in self.model.state_dict().values())
        on_card = self.device.type == "cuda"
        # Batches are copied to the card on the feed stream and run on the
        # compute stream, both held by this engine alone (utils.graphs.held_stream).
        self._feed_stream = held_stream(self.device, self) if on_card else None
        self._compute_stream = held_stream(self.device, self) if on_card else None
        built_before, loaded_before = set(_build.BUILD_LOGS), set(_build.loaded())
        self.graphs: Optional[BucketGraphs] = None
        if on_card:
            self.graphs = BucketGraphs(self.infer_fn, self.ladder.buckets,
                                       config.image_size, self.device)
            bucket_hbm = {b: param_bytes + n for b, n in self.graphs.hbm_bytes.items()}
        else:
            s = config.image_size
            bucket_hbm = {b: param_bytes + b * s * s * 3 + b * config.num_classes * 4
                          for b in self.ladder.buckets}
        # Two passes over the ladder, through the path that serves (a replay
        # on the card): the first warms it (on the CPU it is the warm-up),
        # the second times each bucket for the batcher.
        self._step_est: dict = {}
        warmup_t0 = time.perf_counter()
        for _ in range(2):
            for bucket in self.ladder.buckets:
                t = time.perf_counter()
                self._run(bucket, [])
                self._step_est[bucket] = time.perf_counter() - t
        built = set(_build.BUILD_LOGS) - built_before
        self.startup_report = {
            "model": config.model_name,
            "device": str(self.device),
            "buckets": list(self.ladder.buckets),
            "params_source": source,
            # What the weights are served in: int8 under quant_weights.
            "dtype": "int8" if config.quant_weights else config.compute_dtype,
            "param_bytes": param_bytes,
            "startup_s": round(time.perf_counter() - t0, 3),
            # The capture of every bucket (None: the CPU runs eagerly).
            "compile_s": round(self.graphs.capture_s, 3) if self.graphs else None,
            # Kernel libraries nvcc built during this startup, and those
            # loaded from build/ without a build.
            "compiled_from_scratch": len(built),
            "cache_hits": len(set(_build.loaded()) - loaded_before - built),
            "captured_launches": (
                {str(b): n for b, n in self.graphs.captured_launches.items()}
                if self.graphs else None
            ),
            "captured_variants": (
                {str(b): n for b, n in self.graphs.captured_variants.items()}
                if self.graphs else None
            ),
            # A bucket's device memory, its parameters included as in
            # sav_tpu: on the card the parameters plus the peak over its
            # warm-up and its static buffers, on the CPU sav_tpu's floor.
            "bucket_hbm_bytes": {str(b): int(n) for b, n in bucket_hbm.items()},
            "bucket_hbm_source": "measured" if on_card else "analytic",
            "warmup_s": round(time.perf_counter() - warmup_t0, 3),
            "warmup_step_s": {str(b): round(s, 5) for b, s in self._step_est.items()},
        }
        if self.quant_report is not None:
            self.startup_report["quant"] = self.quant_report
        # A manifest passed in (a fleet replica's, at the path its
        # supervisor preserves) is used as it is; else one under log_dir.
        self.manifest: Optional[RunManifest] = manifest
        if self.manifest is None and config.log_dir:
            self.manifest = RunManifest(
                os.path.join(config.log_dir, f"manifest-serve-{time.strftime('%Y%m%d-%H%M%S')}"
                                             f"-{os.getpid()}.json"),
                kind="serve",
                config=dataclasses.asdict(config),
            )
            self.manifest.begin()
        if self.manifest is not None:
            self.manifest.note("serve_startup", self.startup_report)
            if self.quant_report is not None:
                self.manifest.note("quant", dict(self.quant_report, weights="int8"))
        # Quality: digest windows and the golden-probe ledger, always built
        # (the digests ride every batch), even without telemetry; the probe
        # thread starts in start() when probe_every_s > 0.
        self._quality = QualityTracker()
        self._probe_ledger = ProbeLedger()
        self._probe: Optional[ProbeRunner] = None
        self._batcher: Optional[DynamicBatcher] = None
        self._telemetry: Optional[ServeTelemetry] = None
        self._watermark: Optional[HbmWatermark] = None
        if config.telemetry:
            self._telemetry = self._build_telemetry()
        self.ledger = LatencyLedger(
            window=self._telemetry.window if self._telemetry is not None else None
        )
        self._replays = dict.fromkeys(self.ladder.buckets, 0)
        self._feeder: Optional[DeviceFeeder] = None
        self._device_thread: Optional[threading.Thread] = None
        self._started = False
        self._stopped = False
        self._errors = 0

    def _build_telemetry(self) -> ServeTelemetry:
        """Spans, live window, SLO tracker and, with a log_dir, the
        heartbeat writer and its thread (started by :meth:`start`). A
        failure here raises: telemetry is never switched off quietly."""
        config = self.config
        writer = None
        if config.log_dir and config.heartbeat_secs > 0:
            proc, procs = resolve_identity()
            writer = HeartbeatWriter(config.log_dir, process_index=proc, process_count=procs)
        self._watermark = HbmWatermark(self.device)

        def hbm() -> Optional[dict]:
            self._watermark.observe()
            if not self._watermark.samples:
                return None
            return {"hbm_bytes_in_use": self._watermark.in_use_bytes,
                    "hbm_peak_bytes": self._watermark.peak_bytes}

        return ServeTelemetry(
            config.log_dir,
            dtype=self.startup_report["dtype"],
            trace_ring=config.trace_ring,
            exemplar_max=config.slow_exemplars,
            exemplar_sigma=config.slow_sigma,
            window_s=config.telemetry_window_s,
            heartbeat_secs=config.heartbeat_secs,
            slo_target=config.slo_target,
            slo_fast_window_s=config.slo_fast_window_s,
            slo_slow_window_s=config.slo_slow_window_s,
            slo_burn_threshold=config.slo_burn_threshold,
            writer=writer,
            queue_stats_fn=lambda: self._batcher.stats() if self._batcher else {},
            hbm_fn=hbm,
            # Quality fields on every kind=serve beat, folded at beat cadence.
            quality_fn=self.quality_snapshot,
            # Measured capacity: the ladder's top rung over the windowed step.
            max_batch=self.ladder.max_batch,
        )

    def _quantized(self, float_model: nn.Module) -> tuple:
        """The int8_serve twin of ``float_model`` (the registry's, with the
        config's options) holding its parameters quantized per channel, and
        the HBM-density report of ``sav_tpu``'s engine."""
        config = self.config
        serve_model = create_model(
            config.model_name,
            num_classes=config.num_classes,
            image_size=config.image_size,
            backend=config.attention_backend,
            seed=config.seed,
            quant="int8_serve",
            **(config.model_overrides or {}),
        )
        state = quantize_params(float_model.state_dict(), serve_model.state_dict())
        serve_model.load_state_dict(state, strict=True)
        return serve_model, quant_report(dict(float_model.named_parameters()), state)

    # ------------------------------------------------------------ batches

    def _place(self, bucket: int, payloads: list) -> Placed:
        """Pad ``payloads`` to ``bucket`` rows in (pinned) host memory and
        copy them to the device; on the card without a wait, on the feed
        stream, recording the event the compute stream waits on."""
        s = self.config.image_size
        on_card = self._feed_stream is not None
        images = torch.empty((bucket, s, s, 3), dtype=torch.uint8, pin_memory=on_card)
        rows = images.numpy()
        for i, payload in enumerate(payloads):
            rows[i] = payload
        rows[len(payloads):] = 0
        valid = torch.zeros((bucket,), dtype=torch.float32, pin_memory=on_card)
        valid[: len(payloads)] = 1.0
        if not on_card:
            return Placed(images, valid, None)
        with torch.cuda.stream(self._feed_stream):
            images = images.to(self.device, non_blocking=True)
            valid = valid.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        # The compute stream reads them: the caching allocator must not
        # hand their blocks to the feed stream before it has.
        images.record_stream(self._compute_stream)
        valid.record_stream(self._compute_stream)
        return Placed(images, valid, event)

    def _execute(self, bucket: int, placed: Placed) -> dict:
        """Run one placed batch: on the card, replay the bucket's graph on
        the compute stream after the batch's copy. Returns the host
        ``logits`` (``[bucket, num_classes]``) and the digests ``top1``,
        ``margin`` and ``entropy`` (``[bucket]``), all copied before the
        batch's one sync."""
        if self.graphs is None:
            out = self.infer_fn(placed.images, placed.valid)
            return {k: v.numpy() for k, v in out.items()}
        with torch.cuda.stream(self._compute_stream):
            self._compute_stream.wait_event(placed.event)
            out = self.graphs.replay(bucket, placed.images, placed.valid)
            # Into pinned memory, then one wait on the stream: a copy to
            # pageable memory would hold the feeder's copy to the card
            # until the replay ended.
            host = {}
            for name, value in out.items():
                host[name] = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
                host[name].copy_(value, non_blocking=True)
            self._compute_stream.synchronize()
        return {name: value.numpy().copy() for name, value in host.items()}

    def _run(self, bucket: int, payloads: list) -> np.ndarray:
        """Place and execute one batch on the calling thread; its logits."""
        return self._execute(bucket, self._place(bucket, payloads))["logits"]

    # ------------------------------------------------------------ serving

    def start(self) -> "ServeEngine":
        if self._started:
            raise RuntimeError("engine already started")
        self._batcher = DynamicBatcher(
            self.ladder,
            step_time_fn=lambda bucket: self._step_est.get(bucket, 0.0),
            max_queue=self.config.max_queue,
            default_deadline_s=self.config.deadline_ms / 1e3,
        )
        self._feeder = DeviceFeeder(
            self._formed_batches(),
            self._place_formed,
            depth=self.config.feed_depth,
            name="serve-feeder",
        )
        self._device_thread = threading.Thread(
            target=self._device_loop, name="serve-device-loop", daemon=True
        )
        self._started = True
        self.ledger.start()
        if self._telemetry is not None:
            self._telemetry.start()
        self._device_thread.start()
        if self.config.probe_every_s > 0:
            self._probe = ProbeRunner(self, self._probe_ledger,
                                      every_s=self.config.probe_every_s,
                                      log_dir=self.config.log_dir).start()
        return self

    def _formed_batches(self):
        """The batcher's drain as the feeder's source (on the feeder's
        worker thread: the drain's wait and the copy of the next batch both
        overlap the device loop's run)."""
        while True:
            formed = self._batcher.next_batch()
            if formed is None:
                return
            yield formed

    def _place_formed(self, formed: FormedBatch):
        """Pad and copy one formed batch (the feeder's worker thread)."""
        try:
            placed = self._place(formed.bucket, [r.payload for r in formed.requests])
            if self._telemetry is not None:
                # The copy to the card is issued (on the card it runs on
                # the feed stream; nothing here waits for it).
                t_placed = self._telemetry.clock()
                for request in formed.requests:
                    stamp(request.trace, "placed", t_placed)
            if self.place_hook is not None:
                self.place_hook(formed)
            return formed, placed
        except BaseException as e:
            # A failed placement must not strand its submitters; fail them,
            # then let the feeder hand the error to the device loop.
            self._batcher.mark_completed()
            for request in formed.requests:
                if not request.future.done():
                    request.future.set_exception(e)
            raise

    def _device_loop(self):
        try:
            for formed, placed in self._feeder:
                t0 = time.perf_counter()
                try:
                    telemetry = self._telemetry
                    if telemetry is not None:
                        t_dispatch = telemetry.clock()
                        for request in formed.requests:
                            stamp(request.trace, "dispatched", t_dispatch)
                    if self.execute_hook is not None:
                        self.execute_hook(formed)
                    host = self._execute(formed.bucket, placed)
                    if telemetry is not None:
                        # After _execute's synchronize returned: the device
                        # has finished the batch, not just been handed it.
                        t_exec = telemetry.clock()
                        for request in formed.requests:
                            stamp(request.trace, "executed", t_exec)
                    if self.graphs is not None:
                        self._replays[formed.bucket] += 1
                    self._complete(formed, host, t0)
                except Exception as e:  # noqa: BLE001 — fail this batch, serve on
                    self._errors += 1
                    self._batcher.mark_completed()
                    for request in formed.requests:
                        if not request.future.done():
                            request.future.set_exception(e)
        except Exception:  # noqa: BLE001 — the feeder or a placement died
            # _place_formed failed the batch in hand; close() fails what is
            # still queued, so no submitter waits on a future nothing sets.
            self._errors += 1
            self._batcher.close()

    def _complete(self, formed: FormedBatch, host: dict, t0: float):
        self._batcher.mark_completed()
        step_s = time.perf_counter() - t0
        # EMA keeps the batcher's dispatch-by estimate tracking the device.
        prev = self._step_est.get(formed.bucket, step_s)
        self._step_est[formed.bucket] = 0.8 * prev + 0.2 * step_s
        now = time.monotonic()
        telemetry = self._telemetry
        logits = host["logits"]
        latencies, overruns = [], []
        for i, request in enumerate(formed.requests):
            if telemetry is not None:
                stamp(request.trace, "depadded", telemetry.clock())
            request.future.set_result(logits[i])
            if telemetry is not None:
                stamp(request.trace, "completed", telemetry.clock())
            latencies.append(now - request.enqueue_t)
            overruns.append(now - request.deadline_t)
        n = len(formed.requests)
        # The batch's digest rows into the quality window: host values,
        # bounded appends only; the gate math waits for the beat thread.
        self._quality.observe_digests(
            host["top1"][:n].tolist(),
            host["margin"][:n].tolist(),
            host["entropy"][:n].tolist(),
            num_classes=self.config.num_classes,
        )
        self.ledger.observe_batch(
            bucket=formed.bucket,
            latencies_s=latencies,
            overruns_s=overruns,
            queue_depth=formed.queue_depth,
            step_s=step_s,
        )
        if telemetry is not None:
            # Ring, SLO and the slow-exemplar gate, on the window the
            # ledger just fed: host bookkeeping only.
            telemetry.observe_completed(
                formed, latencies_s=latencies, overruns_s=overruns, step_s=step_s
            )

    def submit(self, image: np.ndarray, *, deadline_ms: Optional[float] = None, trace_id=None):
        """Admit one ``[image_size, image_size, 3]`` uint8 request; returns
        its future. Raises :class:`QueueFullError` on an admission reject
        (counted on the ledger and, as an SLO miss, by the telemetry).
        ``trace_id``: an id propagated by a fleet router, adopted as the
        request's span id instead of a replica-local one. Raw decoded
        images go through :meth:`submit_raw`."""
        if not self._started or self._stopped:
            raise ServeClosedError("engine is not serving (start() first)")
        image = np.asarray(image)
        s = self.config.image_size
        if image.shape != (s, s, 3) or image.dtype != np.uint8:
            raise ValueError(
                f"expected a [{s}, {s}, 3] uint8 request, got {image.shape} {image.dtype}; "
                "run preprocess_request() (or submit_raw) first"
            )
        deadline_s = (deadline_ms if deadline_ms is not None else self.config.deadline_ms) / 1e3
        trace = (self._telemetry.begin_trace(deadline_s, rid=trace_id)
                 if self._telemetry is not None else None)
        try:
            return self._batcher.submit(image, deadline_s=deadline_s, trace=trace)
        except QueueFullError:
            self.ledger.observe_rejected()
            if self._telemetry is not None:
                self._telemetry.observe_shed()
            raise

    def submit_raw(self, image: np.ndarray, *, deadline_ms: Optional[float] = None):
        """``submit`` for a raw decoded ``[H, W, 3]`` uint8 image: the eval
        center crop and bicubic resize on the host
        (:func:`~sav_tpu_torch.serve.preprocess.preprocess_request`), then
        admission."""
        return self.submit(preprocess_request(image, self.config.image_size),
                           deadline_ms=deadline_ms)

    # ----------------------------------------------------------- shutdown

    def drain(self, timeout_s: float = 30.0, *, poll_s: float = 0.02) -> bool:
        """Wait until every admitted request has resolved (nothing queued,
        no drained batch still in the feeder or on the device loop). True
        when drained, False on timeout (:meth:`stop` then fails what is
        still queued). Polls on the host; no device sync."""
        if self._batcher is None:
            return True
        deadline = time.monotonic() + float(timeout_s)
        while self._batcher.pending() > 0:
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)
        return True

    def stop(self, timeout_s: float = 30.0, *, error: Optional[BaseException] = None) -> dict:
        """Fail queued requests, let the batches already drained finish,
        join the device thread, close the feeder, close the telemetry (its
        final beat) and finalize the manifest. Returns :meth:`stats`.
        Idempotent. ``error``: the exception the caller is unwinding on
        (the context manager passes it), so the manifest's outcome is that
        exception's, not ``ok``."""
        if not self._stopped:
            self._stopped = True
            if self._probe is not None:
                # Before the batcher closes: the probe thread must not be
                # mid-submit when admission shuts, and its ledger must be
                # final before the telemetry's last beat.
                self._probe.close()
            if self._batcher is not None:
                self._batcher.close()
            if self._device_thread is not None:
                self._device_thread.join(timeout=timeout_s)
            if self._feeder is not None:
                self._feeder.close()
            self._finish(error)
        return self.stats()

    def _finish(self, error: Optional[BaseException]) -> None:
        """Close the telemetry and finalize the manifest (``sav_tpu``'s
        notes and metrics)."""
        if error is not None:
            outcome, detail = classify_exception(error), repr(error)
        elif self._errors:
            outcome, detail = "error", f"{self._errors} batch(es) failed"
        else:
            outcome, detail = "ok", None
        tele_summary = None
        if self._telemetry is not None:
            self._watermark.finalize()
            tele_summary = self._telemetry.close(outcome)
        if self.manifest is None:
            return
        summary = self.ledger.summary()
        metrics = self.ledger.flat_metrics()
        if self.config.quant_weights:
            metrics["serve/quant_weights"] = 1.0
        metrics["serve/compiled_from_scratch"] = float(
            self.startup_report["compiled_from_scratch"])
        self.manifest.note("serve_summary", summary)
        if self.graphs is not None:
            # The kernels a served batch ran are replays x captured
            # (serve_startup's captured_launches), counted per bucket here.
            self.manifest.note("replays", {str(b): n for b, n in self._replays.items()})
        if tele_summary is not None:
            slo = tele_summary.get("slo") or {}
            # Absent on a run that served nothing: skipped, never 0.
            if isinstance(slo.get("hit_frac"), (int, float)):
                metrics["serve/slo_hit_frac"] = float(slo["hit_frac"])
            if isinstance(slo.get("burn_rate"), (int, float)):
                metrics["serve/burn_rate"] = float(slo["burn_rate"])
            metrics["serve/shed"] = float(tele_summary.get("shed", 0))
            self.manifest.note("serve_telemetry", {
                "slo": slo,
                "window": tele_summary.get("window"),
                "exemplars": tele_summary.get("exemplars"),
                "heartbeats": tele_summary.get("heartbeats"),
                "traced": tele_summary.get("traced"),
                "overhead_s": tele_summary.get("overhead_s"),
                "autoprof": tele_summary.get("autoprof"),
            })
            if tele_summary.get("alerts"):
                self.manifest.note("alerts", tele_summary["alerts"])
        qsnap = self.quality_snapshot()
        if qsnap.get("n") or qsnap.get("probe_runs"):
            # notes.quality and the probe metric; probe_ok_frac is absent
            # when no probe ran — skipped, never zero-filled.
            self.manifest.note("quality", qsnap)
            if isinstance(qsnap.get("probe_ok_frac"), (int, float)):
                metrics["serve/probe_ok_frac"] = float(qsnap["probe_ok_frac"])
        if self._watermark is not None and self._watermark.source is not None:
            metrics["serve/hbm_peak_bytes"] = float(self._watermark.peak_bytes)
        self.manifest.finalize(outcome, error=detail, metrics=metrics)

    def quality_snapshot(self) -> dict:
        """The quality fields one heartbeat (and the manifest's
        ``notes.quality``) carries: the digest drift gates and the probe
        ledger. Host bookkeeping only."""
        out = self._quality.snapshot()
        out.update(self._probe_ledger.snapshot())
        return out

    def stats(self) -> dict:
        out = {"ledger": self.ledger.summary(), "errors": self._errors,
               "replays": {str(b): n for b, n in self._replays.items()}}
        qsnap = self.quality_snapshot()
        if qsnap.get("n") or qsnap.get("probe_runs"):
            out["quality"] = qsnap
        if self.config.quant_weights:
            out["quant"] = "int8"
        if self._batcher is not None:
            out["batcher"] = self._batcher.stats()
        if self._feeder is not None:
            out["feeder"] = self._feeder.stats()
        if self._telemetry is not None:
            # The live view: windowed percentiles (None before the first
            # completed batch, never an exception) and the SLO burn.
            out["live"] = self.ledger.live()
            out["slo"] = self._telemetry.slo.state()
            out["telemetry"] = self._telemetry.stats()
        return out

    def __enter__(self) -> "ServeEngine":
        return self.start() if not self._started else self

    def __exit__(self, exc_type, exc, tb):
        self.stop(error=exc)
        return False
