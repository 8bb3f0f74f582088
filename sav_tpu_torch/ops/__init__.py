"""Attention cores, preprocessing and the hand-written CUDA kernels' wrappers."""
