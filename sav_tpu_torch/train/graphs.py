"""One captured CUDA graph per batch signature of a train or eval step.

The train counterpart of :class:`sav_tpu_torch.serve.graphs.BucketGraphs`,
and the card's counterpart of ``sav_tpu``'s ``jax.jit`` of
``_train_step_impl``: the step is captured once per batch signature (the
keys, shapes and dtypes of the batch, as jit retraces on a new shape), and
every step after that replays its graph, one launch from the host for the
forward, ``torch.autograd.grad`` over every micro-batch, the clip, AdamW,
the EMA, the metrics and the BatchNorm statistics, instead of thousands
from Python.

- **Static buffers.** Each signature owns a device buffer per batch key,
  which its graph reads; a step copies its batch into them (device to
  device) before the replay. What the step returns is the graph's own
  output tensors, overwritten by the next replay: a caller that keeps them
  copies them first.
- **Warm-ups leave no trace.** Before a capture the step runs eagerly
  :data:`WARMUP_RUNS` times on a side stream: that builds and loads the
  kernel libraries, allocates the cuBLAS workspace of the stream and has
  cuDNN plan its convolutions, none of which may happen during a capture.
  A train step updates what it is given in place (parameters, moments,
  EMA, count, BatchNorm statistics) and advances its generators, so every
  one of those ``tensors`` and ``generators`` is copied before the
  warm-ups and put back after them: the first replay starts from the state
  an eager step would have started from.
- **Generators.** Each generator the step draws from is registered with
  every graph (``CUDAGraph.register_generator_state``): a replay reads the
  generator's seed and offset when it is launched and advances the offset
  by what the captured draws took, so replays draw what eager steps would
  have drawn, and the generator's state after them is the eager one. So
  are the twins that recomputed blocks draw from (``recompute``, a
  :class:`~sav_tpu_torch.models.layers.RecomputeGenerators`): the
  warm-ups make them and record where each forward drew, and before each
  replay they are put there.
- **Capture.** On the side stream, into one memory pool for all the
  signatures (the graphs never run at once), through
  :func:`sav_tpu_torch.utils.graphs.capture`, which also records the
  kernel launches a replay runs (:attr:`StepGraphs.captured_launches`, by
  variant :attr:`StepGraphs.captured_variants`); the replays are counted
  in :attr:`StepGraphs.replays`, so the kernels a run launched are the
  warm-ups' (on the counters) plus replays × captured. A capture that
  fails raises: on the card a step never runs eagerly in its place.

The graphs hold the addresses of the tensors they were captured on; the
trainer keys its ``StepGraphs`` on those tensors and captures again when a
state brings others (``sav_tpu_torch.train.trainer``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from sav_tpu_torch.utils.graphs import capture, held_stream, warm_up

WARMUP_RUNS = 2


def signature(batch: dict) -> tuple:
    """A batch's signature: its keys with each tensor's shape and dtype."""
    return tuple((key, tuple(value.shape), value.dtype) for key, value in sorted(batch.items()))


class StepGraphs:
    """``step(batch) -> outputs`` (a tensor or a dict of tensors) captured
    once per batch signature on ``device`` and replayed after that.

    ``tensors`` are what ``step`` updates in place and ``generators`` what
    it draws from: both are restored after the warm-ups, and the generators
    are registered with each graph, with the twins of ``recompute``."""

    def __init__(self, step: Callable, device: torch.device, *, tensors: list = (),
                 generators: list = (), recompute=None):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.device = device
        self._step = step
        self._tensors = list(tensors)
        self._generators = list(generators)
        self._recompute = recompute
        self.stream = held_stream(device, self)
        self._pool = torch.cuda.graph_pool_handle()
        self._entries: dict = {}
        # Per signature: the capture's seconds (warm-ups included), its
        # counter increases, and the replays since.
        self.capture_s: dict = {}
        self.captured_launches: dict = {}
        self.captured_variants: dict = {}
        self.replays: dict = {}

    def _restore(self, tensors: list, states: list) -> None:
        with torch.no_grad():
            for live, saved in zip(self._tensors, tensors):
                live.copy_(saved)
        for generator, state in zip(self._generators, states):
            generator.set_state(state)

    def capture(self, batch: dict) -> tuple:
        """Warm up and capture ``batch``'s signature (a no-op when it has
        one); returns the signature. Synchronises the device."""
        key = signature(batch)
        if key in self._entries:
            return key
        device = self.device
        t0 = time.perf_counter()
        static = {k: torch.empty_like(v, memory_format=torch.contiguous_format)
                  for k, v in batch.items()}
        for k, v in static.items():
            v.copy_(batch[k])
        with torch.no_grad():
            saved = [t.clone() for t in self._tensors]
        states = [g.get_state() for g in self._generators]
        warm_up(lambda: self._step(static), self.stream, device, WARMUP_RUNS)
        self._restore(saved, states)
        del saved
        generators, offsets = self._generators, None
        if self._recompute is not None:
            generators = generators + self._recompute.generators()
            offsets = self._recompute.offsets()
        torch.cuda.synchronize(device)
        try:
            graph, outputs, launches, variants = capture(
                lambda: self._step(static), pool=self._pool, stream=self.stream,
                generators=generators)
        except RuntimeError as e:
            raise RuntimeError(f"the step could not be captured as a CUDA graph for the batch "
                               f"signature {key}: {e}") from e
        torch.cuda.synchronize(device)
        self.captured_launches[key] = launches
        self.captured_variants[key] = variants
        self.capture_s[key] = time.perf_counter() - t0
        self.replays[key] = 0
        self._entries[key] = (static, graph, outputs, offsets)
        return key

    def __call__(self, batch: dict):
        """Copy ``batch`` (device tensors) into its signature's static
        buffers and replay its graph on the current stream, capturing it
        first when the signature is new. Returns the graph's outputs."""
        key = self.capture(batch)
        static, graph, outputs, offsets = self._entries[key]
        for k, v in static.items():
            v.copy_(batch[k])
        if offsets is not None:
            self._recompute.position(offsets)
        graph.replay()
        self.replays[key] += 1
        return outputs

    def total_launches(self) -> dict:
        """The kernel launches that the replays ran: replays × captured,
        summed over the signatures (the warm-ups' are on the counters)."""
        out: dict = {}
        for key, captured in self.captured_launches.items():
            for kernel, n in captured.items():
                out[kernel] = out.get(kernel, 0) + self.replays[key] * n
        return out

    def total_variants(self) -> dict:
        """:meth:`total_launches` by kernel variant."""
        out: dict = {}
        for key, captured in self.captured_variants.items():
            for kernel, by_variant in captured.items():
                into = out.setdefault(kernel, {})
                for variant, n in by_variant.items():
                    into[variant] = into.get(variant, 0) + self.replays[key] * n
        return out

    def summary(self) -> Optional[dict]:
        """``{"signatures", "capture_s", "captured_launches", "replays"}``
        of the last signature captured, or None before any."""
        if not self._entries:
            return None
        key = next(reversed(self._entries))
        return {"signatures": len(self._entries), "capture_s": self.capture_s[key],
                "captured_launches": self.captured_launches[key],
                "captured_variants": self.captured_variants[key],
                "replays": self.replays[key]}
