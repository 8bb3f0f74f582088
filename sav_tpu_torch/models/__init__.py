"""Models of the PyTorch port (mirrors ``sav_tpu/models``)."""

from sav_tpu_torch.models.registry import create_model, model_names

__all__ = ["create_model", "model_names"]
