"""Device-memory watermark (the port's counterpart of ``sav_tpu``'s
``obs/memory.py`` ``hbm_stats`` and ``obs/memdump.py`` ``HbmWatermark``).

:func:`hbm_stats` reads the CUDA caching allocator's counters
(``torch.cuda.memory_allocated`` / ``max_memory_allocated``) and the card's
size: host-side reads of numbers the allocator keeps, no device sync and no
kernel. On the CPU, or before CUDA has started, it returns ``{}``, so a
serve heartbeat carries no HBM fields there, as in ``sav_tpu``'s engine on a
backend without memory stats.

torch is imported inside :func:`hbm_stats` only, so the module imports
without it. The rest of ``sav_tpu``'s memory forensics (the live-buffer
ranking, the OOM incident bundle, the retrace counter) waits in ROADMAP
queue A10.
"""

from __future__ import annotations

from typing import Optional


def hbm_stats(device=None) -> dict:
    """``{"hbm_bytes_in_use", "hbm_peak_bytes", "hbm_bytes_limit"}`` of one
    CUDA device (the current one by default): bytes held by tensors now,
    their peak since the process started (or the allocator's last peak
    reset), and the card's memory. ``{}`` for a CPU device, where CUDA is
    absent or not started, or where a read fails."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    try:
        in_use = float(torch.cuda.memory_allocated(device))
        peak = float(torch.cuda.max_memory_allocated(device))
        limit = float(torch.cuda.get_device_properties(
            device if device is not None else torch.cuda.current_device()).total_memory)
    except Exception:  # noqa: BLE001 — telemetry degrades, never raises
        return {}
    return {"hbm_bytes_in_use": in_use, "hbm_peak_bytes": peak, "hbm_bytes_limit": limit}


class HbmWatermark:
    """Running peak of device bytes in use (``sav_tpu``'s ``HbmWatermark``).

    ``observe()`` at heartbeat cadence (a host read of the allocator's
    counters); ``finalize()`` once at shutdown. Where no sample was ever
    read (the CPU) ``source`` stays None and the peak 0: unlike
    ``sav_tpu``'s, there is no live-array walk to stand in for it, so a
    reader skips the field rather than reading a made-up number.
    """

    def __init__(self, device=None):
        self.device = device
        self.peak_bytes = 0.0
        self.in_use_bytes = 0.0
        self.limit_bytes: Optional[float] = None
        self.source: Optional[str] = None
        self.samples = 0

    def observe(self, stats: Optional[dict] = None) -> None:
        """Fold one :func:`hbm_stats` sample in (read here unless passed)."""
        if stats is None:
            try:
                stats = hbm_stats(self.device)
            except Exception:  # noqa: BLE001
                return
        if not stats:
            return
        self.samples += 1
        self.source = "device-stats"
        self.in_use_bytes = float(stats.get("hbm_bytes_in_use", 0.0))
        peak = float(stats.get("hbm_peak_bytes", 0.0))
        self.peak_bytes = max(self.peak_bytes, peak or self.in_use_bytes)
        limit = stats.get("hbm_bytes_limit")
        if limit:
            self.limit_bytes = float(limit)

    def finalize(self) -> dict:
        """One more read (the peak may have moved since the last beat) and
        the final record for the manifest."""
        self.observe()
        return self.as_dict()

    def as_dict(self) -> dict:
        return {
            "peak_bytes": self.peak_bytes,
            "in_use_bytes": self.in_use_bytes,
            "limit_bytes": self.limit_bytes,
            "source": self.source,
            "samples": self.samples,
        }
