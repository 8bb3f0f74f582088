"""The port's device rule: entry points run on the card unless the caller
asks for the CPU, and never fall back to it silently; and the compute
dtypes its configs name."""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

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


def card() -> Optional[str]:
    """``name, power.limit`` of the first card as nvidia-smi prints them;
    None without a card or without nvidia-smi."""
    if not torch.cuda.is_available() or shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]
