"""Utilities of the PyTorch port (mirrors ``sav_tpu/utils``)."""
