"""ViT — Vision Transformer (port of ``sav_tpu/models/vit.py``).

Pre-LN encoder, zero-init CLS token and head, with every self-attention
core on the backend-dispatched seam of :mod:`sav_tpu_torch.ops.attention`.
Inputs are NHWC, as in ``sav_tpu``. ``pos_embed`` is ``"learned"`` (the
absolute table), ``"sincos"`` (the fixed sinusoidal table), ``"rotary"``
(RoPE on q and k in every block) or ``"none"``. With ``moe_num_experts``
every ``moe_every``-th block (blocks ``moe_every - 1``, ``2·moe_every - 1``,
...) routes its FF through a :class:`~sav_tpu_torch.models.layers.moe.MoEFFBlock`.
``remat=True`` recomputes each encoder block in the backward pass (flax's
``nn.remat``): activation memory drops to the blocks' boundaries for one
more forward of every block, so each attention core's forward kernel runs
twice per train step. The recompute draws the dropout masks the forward
drew (:func:`remat_block`).

``quant`` (``"int8"`` QAT or ``"int8_serve"``) puts the encoder's
projections and FFs and the head on the int8 arm of
:mod:`sav_tpu_torch.ops.quant`, as ``sav_tpu`` does: the patch embedding,
the position tables and the attention core stay in the compute dtype, and
an MoE block's experts stay float.

``dropout_rate`` drops after the position embedding, in each FF block and
on each attention output; ``attn_dropout_rate`` drops attention
probabilities, on the dense path (see :mod:`sav_tpu_torch.ops.attention`).

Parameters stay in their own dtype (f32 for training) and every layer
computes in the dtype of its input, casting its weights at use: the
counterpart of flax's ``dtype=bf16`` over f32 ``param_dtype``. Cast the
images to the compute dtype; the logits come out in it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sav_tpu_torch.models.layers import (
    AddAbsPosEmbed,
    Dropout,
    FFBlock,
    FixedPositionalEmbedding,
    MoEFFBlock,
    PatchEmbedBlock,
    RotaryPositionalEmbedding,
    SelfAttentionBlock,
    dense,
)
from sav_tpu_torch.models.layers.initializers import lecun_normal_
from sav_tpu_torch.models.layers.regularization import (
    RecomputeGenerators,
    StochasticDepthBlock,
    module_generators,
)

# flax.linen.LayerNorm's epsilon (torch's default is 1e-5).
LN_EPS = 1e-6

# sav_tpu ViT options this port does not carry yet, and the ROADMAP item
# each waits on. Setting one raises NotImplementedError.
_NOT_PORTED = {
    "seq_parallel": "queue A9 (parallelism)",
    "seq_mesh": "queue A9 (parallelism)",
    "layout": "queue A9 (parallelism)",
}


def refuse_unported(family: str, options: dict, table: dict) -> None:
    """Raise on an option the port does not carry: ``TypeError`` for a name
    ``table`` does not know, ``NotImplementedError`` naming the ROADMAP item
    for a known one set to anything but its off value."""
    for name, value in options.items():
        if name not in table:
            raise TypeError(f"{family} got an unexpected option {name!r}")
        if value:
            raise NotImplementedError(
                f"{family} option {name}={value!r} is not ported yet: ROADMAP {table[name]}"
            )


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax's epsilon, in the input's dtype: scale and
    bias are cast at use."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            inputs, self.normalized_shape, self.weight.to(inputs.dtype),
            self.bias.to(inputs.dtype), self.eps,
        )


def remat_block(block: nn.Module, inputs: torch.Tensor) -> torch.Tensor:
    """``block(inputs)`` under non-reentrant activation checkpointing whose
    recompute draws the masks the forward drew. The block's dropout and
    stochastic-depth layers draw from generators of their own, which
    ``checkpoint`` does not restore, so the recompute draws from twins of
    them that stood where they stood when the forward began
    (:class:`RecomputeGenerators`: the block's ``recompute_generators``,
    the trainer's, or one made for this call): no mask is kept until the
    backward, no generator is rewound (a CUDA graph capture would refuse
    that), and the generators move once, as without remat. Nothing in the port's models
    draws from the default generators, so ``checkpoint`` keeps no state of
    them (``preserve_rng_state=False``, which a capture also needs)."""
    generators = module_generators(block)
    recompute = getattr(block, "recompute_generators", None)
    if recompute is None:
        recompute = RecomputeGenerators()
        recompute.begin_step(generators)
    twin_of = dict(zip(map(id, generators), recompute.twins(generators)))
    layers = [m for m in block.modules()
              if isinstance(m, (Dropout, StochasticDepthBlock)) and m.generator is not None]
    passes = []

    def run(x):
        if not passes:
            passes.append(1)
            return block(x)
        own = [layer.generator for layer in layers]
        for layer in layers:
            layer.generator = twin_of[id(layer.generator)]
        try:
            return block(x)
        finally:
            for layer, generator in zip(layers, own):
                layer.generator = generator

    return checkpoint(run, inputs, use_reentrant=False, preserve_rng_state=False)


class EncoderBlock(nn.Module):
    """Pre-LN transformer block: LN→MHSA→res, LN→FF→res; the FF is an
    :class:`MoEFFBlock` when ``moe_num_experts`` is set, and q and k are
    rotated when ``use_rotary``."""

    def __init__(self, dim: int, num_heads: int, *, expand_ratio: float = 4.0,
                 backend: Optional[str] = None, logits_dtype=None,
                 attn_dropout_rate: float = 0.0, dropout_rate: float = 0.0,
                 use_rotary: bool = False, length: int = 0,
                 moe_num_experts: Optional[int] = None, moe_top_k: int = 2,
                 moe_router_z_loss_weight: float = 0.1, quant: Optional[str] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = SelfAttentionBlock(
            dim, num_heads, backend=backend, logits_dtype=logits_dtype,
            attn_dropout_rate=attn_dropout_rate, out_dropout_rate=dropout_rate,
            use_rotary=use_rotary, rotary_length=length, quant=quant,
        )
        self.norm2 = LayerNorm(dim)
        if moe_num_experts:
            self.ff = MoEFFBlock(dim, moe_num_experts, top_k=moe_top_k,
                                 expand_ratio=expand_ratio, dropout_rate=dropout_rate,
                                 router_z_loss_weight=moe_router_z_loss_weight)
        else:
            self.ff = FFBlock(dim, expand_ratio=expand_ratio, dropout_rate=dropout_rate,
                              quant=quant)
        # Where a recompute of this block under remat finds its twin
        # generators: the trainer's (set_recompute_generators), else one
        # made per call (remat_block).
        self.recompute_generators: Optional[RecomputeGenerators] = None

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.attn(self.norm1(inputs)) + inputs
        return x + self.ff(self.norm2(x))


class Encoder(nn.Module):
    """Position embedding (``pos_embed``: the learned table, the sinusoidal
    one, or none where q and k are rotated or nothing is added) and dropout,
    N pre-LN blocks, final LN. With ``remat``, each block runs under
    :func:`remat_block` whenever grad is enabled; the parameter names stay
    ``blocks.i``, as flax's ``nn.remat`` keeps ``block_i``."""

    def __init__(self, length: int, dim: int, num_layers: int, num_heads: int, *,
                 expand_ratio: float = 4.0, backend: Optional[str] = None,
                 logits_dtype=None, remat: bool = False,
                 attn_dropout_rate: float = 0.0, dropout_rate: float = 0.0,
                 pos_embed: str = "learned", moe_num_experts: Optional[int] = None,
                 moe_top_k: int = 2, moe_router_z_loss_weight: float = 0.1,
                 moe_every: int = 2, quant: Optional[str] = None):
        super().__init__()
        self.remat = remat
        if pos_embed == "learned":
            self.pos_embed = AddAbsPosEmbed(length, dim)
        elif pos_embed == "sincos":
            self.pos_embed = FixedPositionalEmbedding(length, dim)
        elif pos_embed in ("rotary", "none"):
            self.pos_embed = None
        else:
            raise ValueError(f"unknown pos_embed mode: {pos_embed!r}")
        self.pos_drop = Dropout(dropout_rate)
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, num_heads, expand_ratio=expand_ratio,
                         backend=backend, logits_dtype=logits_dtype,
                         attn_dropout_rate=attn_dropout_rate, dropout_rate=dropout_rate,
                         use_rotary=pos_embed == "rotary", length=length,
                         moe_num_experts=(moe_num_experts
                                          if i % moe_every == moe_every - 1 else None),
                         moe_top_k=moe_top_k, moe_router_z_loss_weight=moe_router_z_loss_weight,
                         quant=quant)
            for i in range(num_layers)
        )
        self.norm = LayerNorm(dim)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = inputs if self.pos_embed is None else self.pos_embed(inputs)
        x = self.pos_drop(x)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = remat_block(block, x)
            else:
                x = block(x)
        return self.norm(x)


class ViT(nn.Module):
    """inputs ``[B, H, W, C]`` NHWC → logits ``[B, num_classes]``.

    ``image_size`` fixes the position table's length at construction (flax
    reads it from the init input).
    """

    def __init__(
        self,
        num_classes: int,
        embed_dim: int,
        num_layers: int,
        num_heads: int,
        patch_shape,
        *,
        image_size: int = 224,
        expand_ratio: float = 4.0,
        pos_embed: str = "learned",
        backend: Optional[str] = None,
        logits_dtype=None,
        remat: bool = False,
        attn_dropout_rate: float = 0.0,
        dropout_rate: float = 0.0,
        moe_num_experts: Optional[int] = None,
        moe_top_k: int = 2,
        moe_router_z_loss_weight: float = 0.1,
        moe_every: int = 2,
        quant: Optional[str] = None,
        **unported,
    ):
        super().__init__()
        refuse_unported("ViT", unported, _NOT_PORTED)
        self.quant = quant
        self.moe_num_experts = moe_num_experts
        ph, pw = patch_shape
        if image_size % ph or image_size % pw:
            raise ValueError(f"image {image_size} not divisible by patch {patch_shape}")
        length = 1 + (image_size // ph) * (image_size // pw)
        self.patch_embed = PatchEmbedBlock(patch_shape, embed_dim)
        self.cls = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.encoder = Encoder(
            length, embed_dim, num_layers, num_heads,
            expand_ratio=expand_ratio, backend=backend, logits_dtype=logits_dtype,
            remat=remat, attn_dropout_rate=attn_dropout_rate, dropout_rate=dropout_rate,
            pos_embed=pos_embed, moe_num_experts=moe_num_experts, moe_top_k=moe_top_k,
            moe_router_z_loss_weight=moe_router_z_loss_weight, moe_every=moe_every,
            quant=quant,
        )
        self.head = dense(embed_dim, num_classes, quant=quant)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers from an explicit generator: lecun-normal
        (truncated) kernels, zero biases, unit LayerNorm scales, normal(0.02)
        position table, the MoE blocks' own, zero CLS token and zero head;
        the fixed position tables are made anew."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
            elif isinstance(module, SelfAttentionBlock):
                module.reset_parameters(generator)
            elif isinstance(module, (AddAbsPosEmbed, MoEFFBlock)):
                module.reset_parameters(generator)
            elif isinstance(module, (FixedPositionalEmbedding, RotaryPositionalEmbedding)):
                module.reset_buffers()
        nn.init.zeros_(self.cls)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(inputs)
        cls = self.cls.to(x.dtype).expand(x.shape[0], 1, -1)
        x = self.encoder(torch.cat([cls, x], dim=1))
        return self.head(x[:, 0])

