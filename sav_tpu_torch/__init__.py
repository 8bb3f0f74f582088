"""sav_tpu_torch — the PyTorch/CUDA port of ``sav_tpu`` for NVIDIA Hopper.

A second package beside ``sav_tpu``, which stays the reference: same layout
and module names, PyTorch idiom inside, and hand-written CUDA kernels where
``sav_tpu`` has Pallas kernels. It imports nothing of JAX or ``sav_tpu``.
Entry points run on the card unless the caller passes ``device="cpu"``.

The names below load on first use, so that the stdlib-only modules (the
supervisor, the manifest, the fleet readers) import without torch.
"""

import importlib

_EXPORTS = {
    "create_model": "sav_tpu_torch.models.registry",
    "ServeConfig": "sav_tpu_torch.serve.engine",
    "ServeEngine": "sav_tpu_torch.serve.engine",
    "TrainConfig": "sav_tpu_torch.train.config",
    "Trainer": "sav_tpu_torch.train.trainer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'sav_tpu_torch' has no attribute {name!r}")
