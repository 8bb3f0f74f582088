"""Layers of the PyTorch port (mirrors ``sav_tpu/models/layers``)."""

from sav_tpu_torch.models.layers.attention import (
    AttentionBlock,
    SelfAttentionBlock,
    TalkingHeadsBlock,
)
from sav_tpu_torch.models.layers.class_attention import ClassSelfAttentionBlock
from sav_tpu_torch.models.layers.feedforward import Dense, FFBlock
from sav_tpu_torch.models.layers.normalization import LayerScaleBlock
from sav_tpu_torch.models.layers.position_embed import AddAbsPosEmbed
from sav_tpu_torch.models.layers.regularization import (
    StochasticDepthBlock,
    set_stochastic_depth_generator,
)
from sav_tpu_torch.models.layers.stems import PatchEmbedBlock

__all__ = [
    "AddAbsPosEmbed",
    "AttentionBlock",
    "ClassSelfAttentionBlock",
    "Dense",
    "FFBlock",
    "LayerScaleBlock",
    "PatchEmbedBlock",
    "SelfAttentionBlock",
    "StochasticDepthBlock",
    "TalkingHeadsBlock",
    "set_stochastic_depth_generator",
]
