"""One captured CUDA graph per serving bucket.

The card's counterpart of ``sav_tpu``'s per-bucket AOT executables
(``sav_tpu/serve/engine.py``): the engine's infer function is captured once
per bucket at startup, and every batch after that replays its bucket's
graph, one launch from the host for the whole forward instead of several
hundred from Python.

- **Static buffers.** Each bucket owns a uint8 ``[bucket, S, S, 3]`` image
  buffer and an f32 ``[bucket]`` validity buffer, which a replay reads, and
  the outputs its graph writes: the engine's program returns the f32 logits
  and their digests (``top1``, ``margin``, ``entropy``), all four captured in
  the one graph. A batch is copied into the buffers (device to device)
  before its replay; the outputs are overwritten by the next replay of the
  same bucket.
- **Warm-up before capture.** Every bucket runs eagerly
  :data:`WARMUP_RUNS` times on a side stream first: that builds and loads
  the kernel libraries (:mod:`sav_tpu_torch.ops._build` loads at first
  launch), allocates the cuBLAS workspaces and has cuDNN pick BoTNet's
  convolution algorithms, none of which may happen during a capture. A
  bucket's device memory (:attr:`BucketGraphs.hbm_bytes`) is the peak
  allocated over its last warm-up run above what was allocated before it,
  plus its static buffers: the first pass's one-time allocations (the
  workspaces every bucket shares) are left out, and so are the parameters
  (the engine's ``bucket_hbm_bytes`` adds them).
- **Capture.** On the same side stream the buckets are captured largest
  first into one memory pool
  (``torch.cuda.graph_pool_handle()``), so a smaller graph reuses the
  larger one's memory (the graphs never run at once: one device loop
  replays them), under ``torch.inference_mode()`` with
  ``capture_error_mode="thread_local"``. A capture that fails raises: on
  the card the engine never falls back to running eagerly.
- **Launch counts.** The kernel wrappers count their launches in Python
  (:func:`sav_tpu_torch.ops.launch_counts`); a replay moves none of them.
  So each bucket keeps the counters' increase during its capture
  (:attr:`BucketGraphs.captured_launches`) and the tallies' by variant
  (:attr:`BucketGraphs.captured_variants`), and a caller counts the
  kernels a replay runs as replays × captured.
- **Streams held by one owner.** Every stream an engine uses (feed,
  compute, capture) comes from
  :func:`sav_tpu_torch.utils.graphs.held_stream`, one that no other live
  owner holds, so two engines' graphs never share a cuBLAS workspace.

A CUDA graph lives in its process and cannot be written to disk, so there
is no counterpart of ``sav_tpu``'s ``compilation_cache_dir``: a restart
captures again. What does persist is the kernel libraries nvcc built under
``build/`` (the engine's ``startup_report`` counts builds and cache hits).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from sav_tpu_torch.utils.graphs import capture, held_stream

WARMUP_RUNS = 2


class BucketGraphs:
    """Warm, then capture ``infer(images, valid)`` once per bucket, on the
    card. Build it before any request is admitted: the constructor
    synchronises the device."""

    def __init__(
        self,
        infer: Callable[[torch.Tensor, torch.Tensor], object],
        buckets,
        image_size: int,
        device: torch.device,
    ):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.buckets = tuple(sorted(buckets))
        self.hbm_bytes: dict = {}
        self.captured_launches: dict = {}
        self.captured_variants: dict = {}
        self._static: dict = {}
        self._outputs: dict = {}
        self._graphs: dict = {}
        s = image_size
        side = self.stream = held_stream(device, self)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for bucket in self.buckets:
                self._static[bucket] = (
                    torch.zeros((bucket, s, s, 3), dtype=torch.uint8, device=device),
                    torch.ones((bucket,), dtype=torch.float32, device=device),
                )
            for _ in range(WARMUP_RUNS):
                for bucket in self.buckets:
                    torch.cuda.synchronize(device)
                    torch.cuda.reset_peak_memory_stats(device)
                    base = torch.cuda.memory_allocated(device)
                    infer(*self._static[bucket])
                    torch.cuda.synchronize(device)
                    static = sum(t.numel() * t.element_size() for t in self._static[bucket])
                    self.hbm_bytes[bucket] = (
                        torch.cuda.max_memory_allocated(device) - base + static)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        pool = torch.cuda.graph_pool_handle()
        for bucket in reversed(self.buckets):
            with torch.inference_mode():
                graph, out, launches, variants = capture(
                    lambda: infer(*self._static[bucket]), pool=pool, stream=side)
            self.captured_launches[bucket] = launches
            self.captured_variants[bucket] = variants
            self._graphs[bucket] = graph
            self._outputs[bucket] = out
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def replay(self, bucket: int, images: torch.Tensor, valid: torch.Tensor):
        """Copy ``images`` and ``valid`` (device tensors of the bucket's
        shapes) into the bucket's static buffers and replay its graph, all
        on the current stream. Returns the static outputs (what ``infer``
        returned at the capture: the engine's logits and digests), which the
        next replay of this bucket overwrites."""
        static_images, static_valid = self._static[bucket]
        static_images.copy_(images)
        static_valid.copy_(valid)
        self._graphs[bucket].replay()
        return self._outputs[bucket]
