"""Data constants of the PyTorch port."""
