"""Convert ``sav_tpu`` (flax) ViT, CaiT, BoTNet, TNT, CeiT, CvT and MLP-Mixer variables into
the port's ``state_dict`` (:func:`params_from_flax`), and back
(:func:`flax_from_params`, the exact inverse under the same rules).

The tree comes as nested dicts of arrays (numpy, or anything
``numpy.asarray`` takes): the ``params`` alone, or ``{"params": ...}``
with, for the BatchNorm families (BoTNet, CeiT, CvT), ``"batch_stats"``
beside it. The family is read off the params' top level (``Encoder_0``:
ViT; ``block_i``/``ca_block_i``: CaiT; ``stem_conv``: BoTNet;
``Image2TokenBlock_0``: CeiT; ``stage_0``: CvT) and only that family's
rules apply (also ``PixelEmbedBlock_0``: TNT; ``block_i/token_mixing``:
MLP-Mixer). Every leaf must be consumed; an unknown key raises.

ViT:

======================================================  =======================================  ==========
flax key                                                port key                                 conversion
======================================================  =======================================  ==========
``PatchEmbedBlock_0/proj/{kernel,bias}``                ``patch_embed.proj.{weight,bias}``       HWIO → OIHW
``cls``                                                 ``cls``                                  as is
``Encoder_0/AddAbsPosEmbed_0/pos_embed``                ``encoder.pos_embed.pos_embed``          as is
``Encoder_0/block_i/LayerNorm_{0,1}/{scale,bias}``      ``encoder.blocks.i.norm{1,2}.*``         scale → weight
``Encoder_0/block_i/SelfAttentionBlock_0/to_qkv/kernel``  ``encoder.blocks.i.attn.to_qkv``        as is, ``[in, 3, H, D]``
``Encoder_0/block_i/SelfAttentionBlock_0/to_out/kernel``  ``encoder.blocks.i.attn.to_out``        as is, ``[H, D, out]``
``Encoder_0/block_i/FFBlock_0/fc{1,2}/{kernel,bias}``   ``encoder.blocks.i.ff.fc{1,2}.*``        ``[in, out]`` → ``[out, in]``
``Encoder_0/block_i/MoEFFBlock_0/{router,experts_*}``     ``encoder.blocks.i.ff.{router,experts_*}``  as is
``Encoder_0/LayerNorm_0/{scale,bias}``                  ``encoder.norm.*``                       scale → weight
``head/{kernel,bias}``                                  ``head.{weight,bias}``                   ``[in, out]`` → ``[out, in]``
======================================================  =======================================  ==========

A ViT with ``pos_embed`` ``"rotary"``, ``"sincos"`` or ``"none"`` has no
``AddAbsPosEmbed_0`` (its fixed tables are buffers, not parameters); an
MoE block's ``router [D, E]``, ``experts_w1 [E, D, H]``, ``experts_b1 [E,
H]``, ``experts_w2 [E, H, D]`` and ``experts_b2 [E, D]`` keep their shapes.

CaiT (``B`` = ``block_i/``, ``CA`` = ``ca_block_i/``; ``X`` = ``B`` or ``CA``):

=======================================================  ==========================================  ==========
flax key                                                 port key                                    conversion
=======================================================  ==========================================  ==========
``PatchEmbedBlock_0/proj/{kernel,bias}``                 ``patch_embed.proj.{weight,bias}``          HWIO → OIHW
``AddAbsPosEmbed_0/pos_embed``                           ``pos_embed.pos_embed``                     as is
``cls``                                                  ``cls``                                     as is
``X LayerNorm_{0,1}/{scale,bias}``                       ``{blocks,ca_blocks}.i.norm{1,2}.*``        scale → weight
``X LayerScaleBlock_{0,1}/scale``                        ``{blocks,ca_blocks}.i.ls{1,2}.scale``      as is
``X FFBlock_0/fc{1,2}/{kernel,bias}``                    ``{blocks,ca_blocks}.i.ff.fc{1,2}.*``       ``[in, out]`` → ``[out, in]``
``B SelfAttentionBlock_0/to_qkv/kernel``                 ``blocks.i.attn.to_qkv``                    as is, ``[in, 3, H, D]``
``B SelfAttentionBlock_0/{pre,post}_softmax/kernel``     ``blocks.i.attn.{pre,post}_softmax.kernel``  as is, ``[H, H]``
``B SelfAttentionBlock_0/to_out/kernel``                 ``blocks.i.attn.to_out``                    as is, ``[H, D, out]``
``CA ClassSelfAttentionBlock_0/to_{q,k,v}/kernel``       ``ca_blocks.i.attn.to_{q,k,v}``             as is, ``[in, H, D]``
``CA ClassSelfAttentionBlock_0/to_out/kernel``           ``ca_blocks.i.attn.to_out``                 as is, ``[H, D, out]``
``LayerNorm_0/{scale,bias}``                             ``norm.*``                                  scale → weight
``head/{kernel,bias}``                                   ``head.{weight,bias}``                      ``[in, out]`` → ``[out, in]``
=======================================================  ==========================================  ==========

BoTNet (``X`` = ``stage{s}_block{b}``; the port's modules keep the flax
names, so the rules copy the path):

==========================================================  ================================  ==========
flax key                                                    port key                          conversion
==========================================================  ================================  ==========
``stem_conv/kernel``, ``X/{conv1,conv2,conv3,proj_conv}/kernel``  ``….weight``            HWIO → OIHW
``stem_bn/…``, ``X/{bn1,bn2,bn3,proj_bn}/{scale,bias}``     ``….{weight,bias}``               scale → weight
``X/SqueezeExciteBlock_0/{reduce,expand}/{kernel,bias}``    ``X.se.{reduce,expand}.*``        ``[in, out]`` → ``[out, in]``
``X/mhsa/to_{q,k,v}/kernel``                                ``X.mhsa.to_{q,k,v}``             as is, ``[in, H, D]``
``X/mhsa/rel_emb_{h,w}``                                    ``X.mhsa.rel_emb_{h,w}``          as is
``head/{kernel,bias}``                                      ``head.{weight,bias}``            ``[in, out]`` → ``[out, in]``
batch_stats ``…/{mean,var}``                                ``….running_{mean,var}``          as is
==========================================================  ================================  ==========

CeiT (``S`` = ``Image2TokenBlock_0/``, ``B`` = ``block_i/``, ``F`` = ``B LeFFBlock_0/``):

======================================================  =====================================  ==========
flax key                                                port key                               conversion
======================================================  =====================================  ==========
``S stem_conv/kernel``, ``S patch_embed/proj/kernel``   ``stem.….weight``                      HWIO → OIHW
``S patch_embed/proj/bias``                             ``stem.patch_embed.proj.bias``         as is
``S stem_bn/…``, ``F bn{1,2,3}/{scale,bias}``           ``….{weight,bias}``                    scale → weight
``cls``, ``AddAbsPosEmbed_0/pos_embed``                 ``cls``, ``pos_embed.pos_embed``       as is
``B LayerNorm_{0,1}/{scale,bias}``                      ``blocks.i.norm{1,2}.*``               scale → weight
``B SelfAttentionBlock_0/to_{qkv,out}/kernel``          ``blocks.i.attn.to_{qkv,out}``         as is
``F {expand,project}/{kernel,bias}``                    ``blocks.i.leff.{expand,project}.*``   ``[in, out]`` → ``[out, in]``
``F dwconv/kernel``                                     ``blocks.i.leff.dwconv.weight``        ``[kh, kw, 1, C]`` → ``[C, 1, kh, kw]``
``lca/to_{q,k,v,out}/kernel``                           ``lca.to_{q,k,v,out}``                 as is
``LayerNorm_0``, ``head``                               ``norm``, ``head``                     as for ViT
batch_stats ``…/{mean,var}``                            ``….running_{mean,var}``               as is
======================================================  =====================================  ==========

CvT (``T`` = ``stage_s/``, ``B`` = ``T block_i/``, ``P`` = ``B CvTSelfAttentionBlock_0/to_{q,k,v}/``):

======================================================  =========================================  ==========
flax key                                                port key                                   conversion
======================================================  =========================================  ==========
``T ConvTokenEmbedBlock_0/proj/{kernel,bias}``          ``stages.s.embed.proj.{weight,bias}``      HWIO → OIHW
``T ConvTokenEmbedBlock_0/LayerNorm_0/…``               ``stages.s.embed.norm.*``                  scale → weight
``T cls`` (the last stage)                              ``stages.s.cls``                           as is
``B LayerNorm_{0,1}/…``                                 ``stages.s.blocks.i.norm{1,2}.*``          scale → weight
``P depthwise/kernel``                                  ``….attn.to_{q,k,v}.depthwise.weight``     ``[kh, kw, 1, C]`` → ``[C, 1, kh, kw]``
``P bn/{scale,bias}``                                   ``….attn.to_{q,k,v}.bn.{weight,bias}``     scale → weight
``P pointwise/kernel``                                  ``….attn.to_{q,k,v}.pointwise``            as is, ``[C, H, D]``
``B CvTSelfAttentionBlock_0/to_out/kernel``             ``stages.s.blocks.i.attn.to_out``          as is, ``[H, D, out]``
``B CvTSelfAttentionBlock_0/{pre,post}_softmax/kernel`` ``….attn.{pre,post}_softmax.kernel``       as is, ``[H, H]``
``B FFBlock_0/fc{1,2}/{kernel,bias}``                   ``stages.s.blocks.i.ff.fc{1,2}.*``         ``[in, out]`` → ``[out, in]``
``LayerNorm_0``, ``head``                               ``norm``, ``head``                         as for ViT
batch_stats ``P bn/{mean,var}``                         ``….bn.running_{mean,var}``                as is
======================================================  =========================================  ==========

TNT (``B`` = ``block_i/``; LayerNorm ``k`` of a block is ``inner_norm1``,
``inner_norm2``, ``outer_norm1``, ``outer_norm2`` for k = 0…3):

======================================================  =========================================  ==========
flax key                                                port key                                   conversion
======================================================  =========================================  ==========
``{Pixel,Patch}EmbedBlock_0/proj/{kernel,bias}``        ``{pixel,patch}_embed.proj.{weight,bias}``  HWIO → OIHW
``cls``, ``{inner,outer}_pos_embed/pos_embed``          ``cls``, ``{inner,outer}_pos_embed.pos_embed``  as is
``B LayerNorm_k/{scale,bias}``                          ``blocks.i.{inner,outer}_norm{1,2}.*``     scale → weight
``B {inner,outer}_attn/to_{qkv,out}/kernel``            ``blocks.i.{inner,outer}_attn.to_*``       as is
``B {inner,outer}_ff/fc{1,2}/{kernel,bias}``            ``blocks.i.{inner,outer}_ff.fc{1,2}.*``    ``[in, out]`` → ``[out, in]``
``B Inner2OuterBlock_0/LayerNorm_0/…``                  ``blocks.i.inner2outer.norm.*``            scale → weight
``B Inner2OuterBlock_0/proj/{kernel,bias}``             ``blocks.i.inner2outer.proj.*``            ``[in, out]`` → ``[out, in]``
``LayerNorm_0``, ``head``                               ``norm``, ``head``                         as for ViT
======================================================  =========================================  ==========

MLP-Mixer (``B`` = ``block_i/``):

======================================================  =========================================  ==========
flax key                                                port key                                   conversion
======================================================  =========================================  ==========
``PatchEmbedBlock_0/proj/{kernel,bias}``                ``patch_embed.proj.{weight,bias}``         HWIO → OIHW
``B LayerNorm_{0,1}/{scale,bias}``                      ``blocks.i.norm{1,2}.*``                   scale → weight
``B {token,channel}_mixing/fc{1,2}/{kernel,bias}``      ``blocks.i.{token,channel}_mixing.fc*``    ``[in, out]`` → ``[out, in]``
``LayerNorm_0``, ``head``                               ``norm``, ``head``                         as for ViT
======================================================  =========================================  ==========

``to_out`` is a ``DenseGeneral`` that contracts two axes, ``(-2, -1)``;
its kernel keeps flax's ``[H, D, out]`` and the port contracts it as one
``[H·D, out]`` matrix, so it converts by copying.
The int8 serving tree (``quant="int8_serve"`` on both sides) converts by
the same rules: an int8 ``kernel`` stays int8 (a ``Dense``'s transposed to
``[out, in]``, a raw projection's as is), and its ``scale`` goes to the
port's ``<layer>.scale`` for a ``Dense`` (``head/scale`` → ``head.scale``)
and to ``<name>_scale`` beside a raw projection (``…/to_qkv/scale`` →
``….attn.to_qkv_scale``). Every other leaf converts in f32. A QAT tree
(``quant="int8"``) is the float tree.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _as_is(a):
    return a


def _dense(a):
    return a.T


def _conv(a):
    return a.transpose(3, 2, 0, 1)


def _with_scales(rules: list) -> list:
    """``rules`` and, for each Dense or raw projection kernel among them,
    the rule of its int8 serving ``scale``."""
    scales = []
    for pattern, target, convert in rules:
        if not pattern.endswith("/kernel") or convert not in (_dense, _as_is):
            continue
        if convert is _dense:
            scale_target = target[:-len("weight")] + "scale"
        else:
            scale_target = target + "_scale"
        scales.append((pattern[:-len("kernel")] + "scale", scale_target, _as_is))
    return rules + scales


def _norm_rule(flax_prefix: str, port_prefix: str) -> list:
    return [
        (rf"{flax_prefix}/scale", rf"{port_prefix}.weight", _as_is),
        (rf"{flax_prefix}/bias", rf"{port_prefix}.bias", _as_is),
    ]


_COMMON = [
    (r"PatchEmbedBlock_0/proj/kernel", "patch_embed.proj.weight", _conv),
    (r"PatchEmbedBlock_0/proj/bias", "patch_embed.proj.bias", _as_is),
    (r"cls", "cls", _as_is),
    (r"head/kernel", "head.weight", _dense),
    (r"head/bias", "head.bias", _as_is),
]

_BLOCK = r"Encoder_0/block_(\d+)"
_VIT_RULES = [
    *_COMMON,
    (r"Encoder_0/AddAbsPosEmbed_0/pos_embed", "encoder.pos_embed.pos_embed", _as_is),
    *_norm_rule(rf"{_BLOCK}/LayerNorm_0", r"encoder.blocks.\1.norm1"),
    *_norm_rule(rf"{_BLOCK}/LayerNorm_1", r"encoder.blocks.\1.norm2"),
    (rf"{_BLOCK}/SelfAttentionBlock_0/to_qkv/kernel", r"encoder.blocks.\1.attn.to_qkv", _as_is),
    (rf"{_BLOCK}/SelfAttentionBlock_0/to_out/kernel", r"encoder.blocks.\1.attn.to_out", _as_is),
    (rf"{_BLOCK}/FFBlock_0/fc(1|2)/kernel", r"encoder.blocks.\1.ff.fc\2.weight", _dense),
    (rf"{_BLOCK}/FFBlock_0/fc(1|2)/bias", r"encoder.blocks.\1.ff.fc\2.bias", _as_is),
    (rf"{_BLOCK}/MoEFFBlock_0/(router|experts_[wb][12])", r"encoder.blocks.\1.ff.\2", _as_is),
    *_norm_rule(r"Encoder_0/LayerNorm_0", "encoder.norm"),
]


def _cait_block_rules(flax_block: str, port_block: str) -> list:
    """LayerNorms, LayerScales and FF of a CaiT trunk or class-attention block."""
    return [
        *_norm_rule(rf"{flax_block}/LayerNorm_0", rf"{port_block}.norm1"),
        *_norm_rule(rf"{flax_block}/LayerNorm_1", rf"{port_block}.norm2"),
        (rf"{flax_block}/LayerScaleBlock_0/scale", rf"{port_block}.ls1.scale", _as_is),
        (rf"{flax_block}/LayerScaleBlock_1/scale", rf"{port_block}.ls2.scale", _as_is),
        (rf"{flax_block}/FFBlock_0/fc(1|2)/kernel", rf"{port_block}.ff.fc\2.weight", _dense),
        (rf"{flax_block}/FFBlock_0/fc(1|2)/bias", rf"{port_block}.ff.fc\2.bias", _as_is),
    ]


_SA = r"block_(\d+)/SelfAttentionBlock_0"
_CA = r"ca_block_(\d+)/ClassSelfAttentionBlock_0"
_CAIT_RULES = [
    *_COMMON,
    (r"AddAbsPosEmbed_0/pos_embed", "pos_embed.pos_embed", _as_is),
    *_norm_rule(r"LayerNorm_0", "norm"),
    *_cait_block_rules(r"block_(\d+)", r"blocks.\1"),
    (rf"{_SA}/to_qkv/kernel", r"blocks.\1.attn.to_qkv", _as_is),
    (rf"{_SA}/(pre|post)_softmax/kernel", r"blocks.\1.attn.\2_softmax.kernel", _as_is),
    (rf"{_SA}/to_out/kernel", r"blocks.\1.attn.to_out", _as_is),
    *_cait_block_rules(r"ca_block_(\d+)", r"ca_blocks.\1"),
    (rf"{_CA}/to_(q|k|v|out)/kernel", r"ca_blocks.\1.attn.to_\2", _as_is),
]


_BOT = r"(stage\d+_block\d+)"
_BOTNET_RULES = [
    (rf"(stem_conv|{_BOT}/(?:conv[123]|proj_conv))/kernel", r"\1.weight", _conv),
    (rf"(stem_bn|{_BOT}/(?:bn[123]|proj_bn))/scale", r"\1.weight", _as_is),
    (rf"(stem_bn|{_BOT}/(?:bn[123]|proj_bn))/bias", r"\1.bias", _as_is),
    (rf"{_BOT}/SqueezeExciteBlock_0/(reduce|expand)/kernel", r"\1.se.\2.weight", _dense),
    (rf"{_BOT}/SqueezeExciteBlock_0/(reduce|expand)/bias", r"\1.se.\2.bias", _as_is),
    (rf"{_BOT}/mhsa/(to_[qkv])/kernel", r"\1.mhsa.\2", _as_is),
    (rf"{_BOT}/mhsa/(rel_emb_[hw])", r"\1.mhsa.\2", _as_is),
    (r"head/kernel", "head.weight", _dense),
    (r"head/bias", "head.bias", _as_is),
]


def _bn_stats_rules(flax_prefix: str, port_prefix: str) -> list:
    return [
        (rf"{flax_prefix}/mean", rf"{port_prefix}.running_mean", _as_is),
        (rf"{flax_prefix}/var", rf"{port_prefix}.running_var", _as_is),
    ]


_BOTNET_STATS_RULES = _bn_stats_rules(rf"(stem_bn|{_BOT}/(?:bn[123]|proj_bn))", r"\1")

_STEM = r"Image2TokenBlock_0"
_LEFF = r"block_(\d+)/LeFFBlock_0"
_CEIT_RULES = [
    (rf"{_STEM}/stem_conv/kernel", "stem.stem_conv.weight", _conv),
    *_norm_rule(rf"{_STEM}/stem_bn", "stem.stem_bn"),
    (rf"{_STEM}/patch_embed/proj/kernel", "stem.patch_embed.proj.weight", _conv),
    (rf"{_STEM}/patch_embed/proj/bias", "stem.patch_embed.proj.bias", _as_is),
    (r"cls", "cls", _as_is),
    (r"AddAbsPosEmbed_0/pos_embed", "pos_embed.pos_embed", _as_is),
    *_norm_rule(r"block_(\d+)/LayerNorm_0", r"blocks.\1.norm1"),
    *_norm_rule(r"block_(\d+)/LayerNorm_1", r"blocks.\1.norm2"),
    (r"block_(\d+)/SelfAttentionBlock_0/to_(qkv|out)/kernel", r"blocks.\1.attn.to_\2", _as_is),
    (rf"{_LEFF}/(expand|project)/kernel", r"blocks.\1.leff.\2.weight", _dense),
    (rf"{_LEFF}/(expand|project)/bias", r"blocks.\1.leff.\2.bias", _as_is),
    *_norm_rule(rf"{_LEFF}/(bn[123])", r"blocks.\1.leff.\2"),
    (rf"{_LEFF}/dwconv/kernel", r"blocks.\1.leff.dwconv.weight", _conv),
    (r"lca/to_(q|k|v|out)/kernel", r"lca.to_\1", _as_is),
    *_norm_rule(r"LayerNorm_0", "norm"),
    (r"head/kernel", "head.weight", _dense),
    (r"head/bias", "head.bias", _as_is),
]
_CEIT_STATS_RULES = [
    *_bn_stats_rules(rf"{_STEM}/stem_bn", "stem.stem_bn"),
    *_bn_stats_rules(rf"{_LEFF}/(bn[123])", r"blocks.\1.leff.\2"),
]

_STAGE = r"stage_(\d)"
_CVT_BLOCK = rf"{_STAGE}/block_(\d+)"
_CVT_PROJ = rf"{_CVT_BLOCK}/CvTSelfAttentionBlock_0/to_(q|k|v)"
_CVT_RULES = [
    (rf"{_STAGE}/ConvTokenEmbedBlock_0/proj/kernel", r"stages.\1.embed.proj.weight", _conv),
    (rf"{_STAGE}/ConvTokenEmbedBlock_0/proj/bias", r"stages.\1.embed.proj.bias", _as_is),
    *_norm_rule(rf"{_STAGE}/ConvTokenEmbedBlock_0/LayerNorm_0", r"stages.\1.embed.norm"),
    (rf"{_STAGE}/cls", r"stages.\1.cls", _as_is),
    *_norm_rule(rf"{_CVT_BLOCK}/LayerNorm_0", r"stages.\1.blocks.\2.norm1"),
    *_norm_rule(rf"{_CVT_BLOCK}/LayerNorm_1", r"stages.\1.blocks.\2.norm2"),
    (rf"{_CVT_PROJ}/depthwise/kernel", r"stages.\1.blocks.\2.attn.to_\3.depthwise.weight", _conv),
    *_norm_rule(rf"{_CVT_PROJ}/bn", r"stages.\1.blocks.\2.attn.to_\3.bn"),
    (rf"{_CVT_PROJ}/pointwise/kernel", r"stages.\1.blocks.\2.attn.to_\3.pointwise", _as_is),
    # to_out: a DenseGeneral contracting (-2, -1), kept [H, D, out].
    (rf"{_CVT_BLOCK}/CvTSelfAttentionBlock_0/to_out/kernel", r"stages.\1.blocks.\2.attn.to_out",
     _as_is),
    (rf"{_CVT_BLOCK}/CvTSelfAttentionBlock_0/(pre|post)_softmax/kernel",
     r"stages.\1.blocks.\2.attn.\3_softmax.kernel", _as_is),
    (rf"{_CVT_BLOCK}/FFBlock_0/fc(1|2)/kernel", r"stages.\1.blocks.\2.ff.fc\3.weight", _dense),
    (rf"{_CVT_BLOCK}/FFBlock_0/fc(1|2)/bias", r"stages.\1.blocks.\2.ff.fc\3.bias", _as_is),
    *_norm_rule(r"LayerNorm_0", "norm"),
    (r"head/kernel", "head.weight", _dense),
    (r"head/bias", "head.bias", _as_is),
]
_CVT_STATS_RULES = _bn_stats_rules(rf"{_CVT_PROJ}/bn", r"stages.\1.blocks.\2.attn.to_\3.bn")

_HEAD_RULES = [
    *_norm_rule(r"LayerNorm_0", "norm"),
    (r"head/kernel", "head.weight", _dense),
    (r"head/bias", "head.bias", _as_is),
]


def _ff_rules(flax_ff: str, port_ff: str, fc: int) -> list:
    """An FFBlock's two Dense layers; ``fc`` numbers their group, after
    ``flax_ff``'s own."""
    return [
        (rf"{flax_ff}/fc(1|2)/kernel", rf"{port_ff}.fc\{fc}.weight", _dense),
        (rf"{flax_ff}/fc(1|2)/bias", rf"{port_ff}.fc\{fc}.bias", _as_is),
    ]


_TNT_BLOCK = r"block_(\d+)"
_TNT_RULES = [
    *_COMMON[:2],
    (r"PixelEmbedBlock_0/proj/kernel", "pixel_embed.proj.weight", _conv),
    (r"PixelEmbedBlock_0/proj/bias", "pixel_embed.proj.bias", _as_is),
    (r"cls", "cls", _as_is),
    (r"(inner|outer)_pos_embed/pos_embed", r"\1_pos_embed.pos_embed", _as_is),
    *[rule for k, name in enumerate(("inner_norm1", "inner_norm2", "outer_norm1", "outer_norm2"))
      for rule in _norm_rule(rf"{_TNT_BLOCK}/LayerNorm_{k}", rf"blocks.\1.{name}")],
    (rf"{_TNT_BLOCK}/(inner|outer)_attn/to_(qkv|out)/kernel", r"blocks.\1.\2_attn.to_\3",
     _as_is),
    *_ff_rules(rf"{_TNT_BLOCK}/(inner|outer)_ff", r"blocks.\1.\2_ff", 3),
    *_norm_rule(rf"{_TNT_BLOCK}/Inner2OuterBlock_0/LayerNorm_0", r"blocks.\1.inner2outer.norm"),
    (rf"{_TNT_BLOCK}/Inner2OuterBlock_0/proj/kernel", r"blocks.\1.inner2outer.proj.weight", _dense),
    (rf"{_TNT_BLOCK}/Inner2OuterBlock_0/proj/bias", r"blocks.\1.inner2outer.proj.bias", _as_is),
    *_HEAD_RULES,
]

_MIXER_RULES = [
    *_COMMON[:2],
    *_norm_rule(r"block_(\d+)/LayerNorm_0", r"blocks.\1.norm1"),
    *_norm_rule(r"block_(\d+)/LayerNorm_1", r"blocks.\1.norm2"),
    *_ff_rules(r"block_(\d+)/(token|channel)_mixing", r"blocks.\1.\2_mixing", 3),
    *_HEAD_RULES,
]


def _family_rules(tree) -> tuple:
    """``(family, params rules, batch_stats rules)`` of a params tree."""
    if "Encoder_0" in tree:
        family = "ViT"
    elif "stem_conv" in tree:
        family = "BoTNet"
    elif "Image2TokenBlock_0" in tree:
        family = "CeiT"
    elif "stage_0" in tree:
        family = "CvT"
    elif "PixelEmbedBlock_0" in tree:
        family = "TNT"
    elif any(isinstance(block, dict) and "token_mixing" in block for block in tree.values()):
        family = "MLPMixer"
    elif any(re.fullmatch(r"(ca_)?block_\d+", str(name)) for name in tree):
        family = "CaiT"
    else:
        family = None
    if family is not None:
        return (family, *_FAMILY_RULES[family])
    raise KeyError(
        f"not a ViT or CaiT parameter tree, nor a BoTNet, TNT, CeiT, CvT or MLP-Mixer one "
        f"(top-level keys {sorted(map(str, tree))}); the port converts those seven families"
    )


def _flatten(tree, prefix=""):
    for name, value in tree.items():
        path = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def _convert(tree, rules, state, unknown, prefix="") -> None:
    for path, leaf in _flatten(dict(tree)):
        for pattern, target, convert in rules:
            match = re.fullmatch(pattern, path)
            if match:
                array = np.asarray(leaf)
                array = convert(array if array.dtype == np.int8 else array.astype(np.float32))
                name = match.expand(target).replace("/", ".")
                state[name] = torch.from_numpy(np.array(array, order="C"))
                break
        else:
            unknown.append(prefix + path)


def params_from_flax(tree) -> dict:
    """flax ViT, CaiT, BoTNet, TNT, CeiT, CvT or MLP-Mixer variables → a ``state_dict`` for
    ``load_state_dict(strict=True)``: the params tree, or
    ``{"params": ..., "batch_stats": ...}`` (the running statistics of a
    BoTNet, CeiT or CvT go into its BatchNorm buffers; its strict load
    needs them)."""
    stats = {}
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        stats = tree.get("batch_stats") or {}
        tree = tree["params"]
    family, rules, stats_rules = _family_rules(tree)
    state, unknown = {}, []
    _convert(tree, rules, state, unknown)
    _convert(stats, stats_rules, state, unknown, prefix="batch_stats/")
    if unknown:
        raise KeyError(f"flax variables the {family} port does not consume: {unknown}")
    return state


# ------------------------------------------------------------------ reverse

_FAMILY_RULES = {
    "ViT": (_with_scales(_VIT_RULES), []),
    "CaiT": (_with_scales(_CAIT_RULES), []),
    "BoTNet": (_with_scales(_BOTNET_RULES), _BOTNET_STATS_RULES),
    "CeiT": (_with_scales(_CEIT_RULES), _CEIT_STATS_RULES),
    "CvT": (_with_scales(_CVT_RULES), _CVT_STATS_RULES),
    "TNT": (_with_scales(_TNT_RULES), []),
    "MLPMixer": (_with_scales(_MIXER_RULES), []),
}


def _conv_back(a):
    return a.transpose(2, 3, 1, 0)  # OIHW → HWIO


_BACK = {_as_is: _as_is, _dense: _dense, _conv: _conv_back}


def _capture_spans(pattern: str) -> list:
    """``[start, end)`` of each capturing group of ``pattern``, by group
    number (index 0 is group 1)."""
    spans, stack, i = [], [], 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            i += 2
            continue
        if c == "[":
            i = pattern.index("]", i)
        elif c == "(":
            if pattern.startswith("(?", i):
                stack.append(None)
            else:
                spans.append([i, None])
                stack.append(len(spans) - 1)
        elif c == ")":
            index = stack.pop()
            if index is not None:
                spans[index][1] = i + 1
        i += 1
    return spans


def _reverse_rule(pattern: str, target: str):
    """A port-key regex for ``target`` and a function from its match to the
    flax path ``pattern`` matches: each ``\\N`` of ``target`` captures what
    group N of ``pattern`` matches (its ``/`` read as ``.``), and the flax
    path is ``pattern`` with those groups replaced by the captured text."""
    spans = _capture_spans(pattern)
    parts = re.split(r"\\(\d)", target)
    port, used = [], []
    for i, part in enumerate(parts):
        if i % 2 == 0:
            port.append(re.escape(part))
            continue
        number = int(part)
        start, end = spans[number - 1]
        inner = pattern[start + 1:end - 1].replace("/", r"\.")
        port.append(f"(?P<g{number}>{inner})")
        used.append(number)
    regex = re.compile("".join(port))

    def flax_path(match) -> str:
        path, cursor = [], 0
        for number in sorted(used, key=lambda n: spans[n - 1][0]):
            start, end = spans[number - 1]
            path.append(pattern[cursor:start])
            path.append(match.group(f"g{number}").replace(".", "/"))
            cursor = end
        path.append(pattern[cursor:])
        return "".join(path)

    return regex, flax_path


def _nest(flat: dict) -> dict:
    tree = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def flax_from_params(state_dict: dict, family: str) -> dict:
    """A port ``state_dict`` of ``family`` ('ViT', 'CaiT', 'BoTNet', 'TNT',
    'CeiT', 'CvT' or 'MLPMixer', the model's class name) → flax variables ``{"params": ...}`` (with ``"batch_stats"``
    for the BatchNorm families)
    as nested dicts of f32 numpy arrays: the exact inverse of
    :func:`params_from_flax` under the same rules. Every entry must be
    consumed; an unknown key raises."""
    if family not in _FAMILY_RULES:
        raise ValueError(f"family must be one of {sorted(_FAMILY_RULES)}, got {family!r}")
    params_rules, stats_rules = _FAMILY_RULES[family]
    reverse = [(*_reverse_rule(p, t), p, t, c, "params") for p, t, c in params_rules]
    reverse += [(*_reverse_rule(p, t), p, t, c, "batch_stats") for p, t, c in stats_rules]
    out = {"params": {}, "batch_stats": {}}
    unknown = []
    for name, value in state_dict.items():
        if torch.is_tensor(value):
            value = value.detach().cpu()
            array = (value if value.dtype == torch.int8 else value.float()).numpy()
        else:
            array = np.asarray(value)
            array = array if array.dtype == np.int8 else array.astype(np.float32)
        for regex, flax_path, pattern, target, convert, collection in reverse:
            match = regex.fullmatch(name)
            if match is None:
                continue
            path = flax_path(match)
            forward = re.fullmatch(pattern, path)
            if forward is None or forward.expand(target).replace("/", ".") != name:
                continue
            out[collection][path] = np.array(_BACK[convert](array), order="C")
            break
        else:
            unknown.append(name)
    if unknown:
        raise KeyError(f"state_dict entries the {family} rules do not produce: {unknown}")
    tree = {"params": _nest(out["params"])}
    if stats_rules:
        tree["batch_stats"] = _nest(out["batch_stats"])
    return tree
