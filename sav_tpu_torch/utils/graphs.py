"""What the serving engine's and the trainer's CUDA graphs share: streams
held by one owner, and the capture of one function into a graph with the
kernel launches it recorded.

- **Streams held by one owner.** A graph keeps the address of the cuBLAS
  workspace of the stream it was captured on, and cuBLAS keeps one
  workspace per stream for the life of the process. Two owners whose
  graphs shared a capture stream would race on one workspace when they
  replay at once, and work queued on a stream while another owner captures
  on it would land in that graph. PyTorch hands out streams from a pool of
  :data:`POOL_STREAMS` per device, round robin, so every stream a serving
  engine, a trainer or their graphs use comes from :func:`held_stream`:
  one that no live owner holds, freed for the next owner when its own is
  collected. The workspaces so stay bounded by the owners alive at once.
- **Capture.** :func:`capture` records ``fn()`` into a graph on the
  owner's stream, in a memory pool the caller shares between its graphs
  (they never run at once), with ``capture_error_mode="thread_local"``: a
  feeder's thread may place the next batch (pinned memory, copies on its
  own stream) while this one captures. The kernel wrappers count their
  launches in Python and a replay moves no counter, so the capture returns
  the counters' increase over it, in all and by variant: the kernels a
  replay runs.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Callable

import torch

from sav_tpu_torch.ops import launch_counts, variant_counts

# Streams in PyTorch's pool per device and priority, handed out round robin.
POOL_STREAMS = 32

# Streams held by a live owner, by device: the pointers in use, and those
# freed by a collected owner, kept for the next one (their workspaces with
# them).
_HELD: dict = {}
_FREE: dict = {}
_HELD_LOCK = threading.Lock()


def held_stream(device: torch.device, owner, new_stream: Callable = torch.cuda.Stream):
    """A stream of ``device`` that no other live owner holds, held until
    ``owner`` is collected: a freed one if there is one, else the next of
    PyTorch's pool (``new_stream(device)``) that nobody holds. Raises when
    owners hold every stream of the pool."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with _HELD_LOCK:
        held = _HELD.setdefault(device, set())
        free = _FREE.setdefault(device, [])
        # A freed stream first (its workspace is made already), then the pool.
        candidates = itertools.chain(reversed(free),
                                     (new_stream(device) for _ in range(POOL_STREAMS)))
        stream = next((s for s in candidates if s.cuda_stream not in held), None)
        if stream is None:
            raise RuntimeError(f"every one of the {POOL_STREAMS} pool streams of {device} is "
                               "held by a live owner (serving engines, trainers and their "
                               "step graphs)")
        held.add(stream.cuda_stream)
        _FREE[device] = [s for s in free if s.cuda_stream not in held]
    weakref.finalize(owner, _release, device, stream)
    return stream


def streams_held() -> int:
    """The streams that live owners hold, on every device: 0 once every
    owner is collected, and with it every graph that kept a workspace."""
    with _HELD_LOCK:
        return sum(len(held) for held in _HELD.values())


def _release(device: torch.device, stream) -> None:
    with _HELD_LOCK:
        _HELD[device].discard(stream.cuda_stream)
        _FREE[device].append(stream)


def warm_up(fn: Callable, stream, device: torch.device, runs: int) -> None:
    """``fn()`` ``runs`` times on ``stream``, ordered after the work queued
    on the current stream and before the work queued on it later."""
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for _ in range(runs):
            fn()
    torch.cuda.current_stream(device).wait_stream(stream)


def capture(fn: Callable, *, pool, stream, generators=()) -> tuple:
    """Capture ``fn()`` on ``stream`` into ``pool`` (with each of
    ``generators`` registered, so a replay advances it as the captured
    draws would). Returns ``(graph, outputs, launches, variants)``: what
    ``fn`` returned, which the graph overwrites at each replay, and the
    launch counters' increase over the capture, in all and by variant."""
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    before, variants_before = launch_counts(), variant_counts()
    with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
        outputs = fn()
    after, variants_after = launch_counts(), variant_counts()
    launches = {k: after[k] - before[k] for k in after}
    variants = {k: {v: n - variants_before[k][v] for v, n in by_variant.items()}
                for k, by_variant in variants_after.items()}
    return graph, outputs, launches, variants
