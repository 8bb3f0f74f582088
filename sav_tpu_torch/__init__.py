"""sav_tpu_torch — the PyTorch/CUDA port of ``sav_tpu`` for NVIDIA Hopper.

A second package beside ``sav_tpu``, which stays the reference: same layout
and module names, PyTorch idiom inside, and hand-written CUDA kernels where
``sav_tpu`` has Pallas kernels. It imports nothing of JAX or ``sav_tpu``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from sav_tpu_torch.models.registry import create_model
from sav_tpu_torch.serve.engine import ServeConfig, ServeEngine
from sav_tpu_torch.train import TrainConfig, Trainer

__all__ = ["ServeConfig", "ServeEngine", "TrainConfig", "Trainer", "create_model"]
