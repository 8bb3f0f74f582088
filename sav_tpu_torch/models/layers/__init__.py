"""Layers of the PyTorch port (mirrors ``sav_tpu/models/layers``)."""

from sav_tpu_torch.models.layers.attention import AttentionBlock, SelfAttentionBlock
from sav_tpu_torch.models.layers.feedforward import Dense, FFBlock
from sav_tpu_torch.models.layers.position_embed import AddAbsPosEmbed
from sav_tpu_torch.models.layers.stems import PatchEmbedBlock

__all__ = [
    "AddAbsPosEmbed",
    "AttentionBlock",
    "Dense",
    "FFBlock",
    "PatchEmbedBlock",
    "SelfAttentionBlock",
]
