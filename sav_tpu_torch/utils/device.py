"""The port's device rule: entry points run on the card unless the caller
asks for the CPU, and never fall back to it silently; and the compute
dtypes its configs name."""

from __future__ import annotations

import torch

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def require_device(device: str) -> torch.device:
    """``device`` as a ``torch.device``, refusing a missing card instead of
    falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but no CUDA device is available; pass "
                "device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {device!r}")
    return dev
