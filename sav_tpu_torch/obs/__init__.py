"""Observability for the PyTorch port (mirrors ``sav_tpu/obs``)."""
