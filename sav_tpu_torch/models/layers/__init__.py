"""Layers of the PyTorch port (mirrors ``sav_tpu/models/layers``)."""

from sav_tpu_torch.models.layers.attention import (
    AttentionBlock,
    SelfAttentionBlock,
    TalkingHeadsBlock,
)
from sav_tpu_torch.models.layers.bot_attention import BoTMHSA
from sav_tpu_torch.models.layers.class_attention import (
    ClassSelfAttentionBlock,
    LCSelfAttentionBlock,
)
from sav_tpu_torch.models.layers.convolution import SameConv2d, max_pool_same, same_pads
from sav_tpu_torch.models.layers.cvt_attention import (
    ConvProjectionBlock,
    CvTAttentionBlock,
    CvTSelfAttentionBlock,
)
from sav_tpu_torch.models.layers.depthwise import DepthwiseConv2D
from sav_tpu_torch.models.layers.feedforward import Dense, FFBlock, LeFFBlock, dense
from sav_tpu_torch.models.layers.normalization import (
    BatchNorm,
    LayerScaleBlock,
    cast_for_compute,
)
from sav_tpu_torch.models.layers.moe import MoEFFBlock, sow_losses
from sav_tpu_torch.models.layers.position_embed import (
    AddAbsPosEmbed,
    FixedPositionalEmbedding,
    RotaryPositionalEmbedding,
)
from sav_tpu_torch.models.layers.regularization import (
    Dropout,
    RecomputeGenerators,
    StochasticDepthBlock,
    set_dropout_generator,
    set_recompute_generators,
    set_stochastic_depth_generator,
)
from sav_tpu_torch.models.layers.squeeze_excite import SqueezeExciteBlock
from sav_tpu_torch.models.layers.stems import Image2TokenBlock, PatchEmbedBlock

__all__ = [
    "AddAbsPosEmbed",
    "AttentionBlock",
    "BatchNorm",
    "BoTMHSA",
    "ClassSelfAttentionBlock",
    "ConvProjectionBlock",
    "CvTAttentionBlock",
    "CvTSelfAttentionBlock",
    "Dense",
    "DepthwiseConv2D",
    "Dropout",
    "FFBlock",
    "FixedPositionalEmbedding",
    "Image2TokenBlock",
    "LCSelfAttentionBlock",
    "LayerScaleBlock",
    "LeFFBlock",
    "MoEFFBlock",
    "PatchEmbedBlock",
    "RecomputeGenerators",
    "RotaryPositionalEmbedding",
    "SameConv2d",
    "SelfAttentionBlock",
    "SqueezeExciteBlock",
    "StochasticDepthBlock",
    "TalkingHeadsBlock",
    "cast_for_compute",
    "dense",
    "max_pool_same",
    "same_pads",
    "set_dropout_generator",
    "set_recompute_generators",
    "set_stochastic_depth_generator",
    "sow_losses",
]
