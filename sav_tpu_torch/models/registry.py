"""Named model registry (port of ``sav_tpu/models/registry.py``).

Every ``sav_tpu`` name is ported: the plain ViT, its rotary and MoE
variants, the ten CaiT, the three BoTNet, the two TNT, the three CeiT, the
three CvT and the six MLP-Mixer entries.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sav_tpu_torch.models.botnet import BoTNet
from sav_tpu_torch.models.cait import CaiT
from sav_tpu_torch.models.ceit import CeiT
from sav_tpu_torch.models.cvt import CvT
from sav_tpu_torch.models.mlp_mixer import MLPMixer
from sav_tpu_torch.models.tnt import TNT
from sav_tpu_torch.models.vit import ViT
from sav_tpu_torch.ops.quant import check_mode, init_serving

# name -> (embed_dim, num_layers, num_heads, patch)
_VIT = {
    "vit_ti_patch16": (192, 12, 3, 16),
    "vit_s_patch32": (384, 12, 6, 32),
    "vit_s_patch16": (384, 12, 6, 16),
    "deit_s_patch16": (384, 12, 6, 16),
    "vit_b_patch32": (768, 12, 12, 32),
    "vit_b_patch16": (768, 12, 12, 16),
    "vit_l_patch32": (1024, 24, 16, 32),
    "vit_l_patch16": (1024, 24, 16, 16),
    # RoPE on q and k in every block, no learned table.
    "vit_s_patch16_rope": (384, 12, 6, 16),
    # DeiT-S's trunk with a top-2-routed 8-expert FF on every other block.
    "vit_moe_s_patch16_e8": (384, 12, 6, 16),
}
# ViT options of a _VIT name beyond its widths (sav_tpu/models/registry.py:56-65).
_VIT_OPTIONS = {
    "vit_s_patch16_rope": dict(pos_embed="rotary"),
    "vit_moe_s_patch16_e8": dict(moe_num_experts=8, moe_top_k=2),
}

# name -> (embed_dim, num_layers, num_heads, stoch_depth_rate, layerscale_eps);
# two class-attention layers and patch 16 each (sav_tpu/models/registry.py:93-114).
_CAIT = {
    "cait_xxs_24": (192, 24, 4, 0.05, 1e-5),
    "cait_xxs_36": (192, 36, 4, 0.1, 1e-6),
    "cait_xs_24": (288, 24, 6, 0.05, 1e-5),
    "cait_xs_36": (288, 36, 6, 0.1, 1e-6),
    "cait_s_24": (384, 24, 8, 0.1, 1e-5),
    "cait_s_36": (384, 36, 8, 0.2, 1e-6),
    "cait_s_48": (384, 48, 8, 0.3, 1e-6),
    "cait_m_24": (768, 24, 16, 0.2, 1e-5),
    "cait_m_36": (768, 36, 16, 0.3, 1e-6),
    "cait_m_48": (768, 48, 16, 0.4, 1e-6),
}

# name -> stage_sizes (sav_tpu/models/registry.py:68-70).
_BOTNET = {
    "botnet_t3": (3, 4, 6, 6),
    "botnet_t4": (3, 4, 23, 6),
    "botnet_t5": (3, 4, 23, 12),
}

# name -> (embed_dim, num_layers, num_heads); 4×4 patches after the conv
# stem (sav_tpu/models/registry.py:86-88).
_CEIT = {
    "ceit_t": (192, 12, 3),
    "ceit_s": (384, 12, 6),
    "ceit_b": (768, 12, 12),
}

# name -> (embed_dims, num_layers, num_heads) of the three stages
# (sav_tpu/models/registry.py:117-129).
_CVT = {
    "cvt-13": ((64, 192, 384), (1, 2, 10), (1, 3, 6)),
    "cvt-21": ((64, 192, 384), (1, 4, 16), (1, 3, 6)),
    "cvt-w24": ((192, 768, 1024), (2, 2, 20), (3, 12, 16)),
}

# name -> (embed_dim, inner_ch, num_layers, num_heads, inner_num_heads), patch
# 16; TNT-S and TNT-B as the paper has them (sav_tpu/models/registry.py:72-83
# un-swaps the reference's).
_TNT = {
    "tnt_s_patch16": (384, 24, 12, 6, 4),
    "tnt_b_patch16": (640, 40, 12, 10, 4),
}

# name -> (embed_dim, num_layers, tokens_hidden_ch, channels_hidden_ch, patch)
# (sav_tpu/models/registry.py:131-147).
_MIXER = {
    f"mixer_{size}_patch{patch}": (*widths, patch)
    for size, widths in (("s", (512, 8, 256, 2048)), ("b", (768, 12, 384, 3072)),
                         ("l", (1024, 24, 512, 4096)))
    for patch in (32, 16)
}

def model_names() -> list:
    """The names :func:`create_model` can build."""
    return sorted([*_VIT, *_CAIT, *_BOTNET, *_TNT, *_CEIT, *_CVT, *_MIXER])


def create_model(
    model_name: str,
    *,
    num_classes: int = 1000,
    image_size: int = 224,
    backend: Optional[str] = None,
    logits_dtype=None,
    seed: int = 0,
    quant: Optional[str] = None,
    **overrides,
) -> nn.Module:
    """Instantiate a named config with weights drawn from ``seed``.

    The module is built on the CPU in float32; move it with
    ``.to(device, dtype)``. ``backend`` ('fused' | 'pallas' | 'xla' | None =
    auto) and
    ``logits_dtype`` (the xla path's softmax dtype; None = the compute dtype)
    reach every attention block. ``overrides`` replace config fields
    (``embed_dim``, ``num_layers``, ``num_heads``, ``patch_shape``, and for
    CaiT ``num_layers_token_only``, ``stoch_depth_rate``, ...; for ViT
    ``remat``, ``pos_embed`` and the ``moe_*`` options; for BoTNet ``stage_sizes``, ``num_heads``, ``se_ratio``; for
    CeiT ``stem_ch``; for CvT ``embed_dims``, ``num_layers`` and
    ``num_heads`` of the three stages; for TNT ``inner_ch`` and
    ``inner_num_heads``; for MLP-Mixer ``tokens_hidden_ch`` and
    ``channels_hidden_ch``). ``quant`` puts every family's projection, FF
    and head dots on the int8 arm (:mod:`sav_tpu_torch.ops.quant`):
    ``"int8"`` (QAT: the float parameters, the int8 dot) or
    ``"int8_serve"`` (int8 codes and f32 scales, filled by
    :func:`~sav_tpu_torch.ops.quant.quantize_params`); None = the float
    path. The attention core stays in the compute dtype.
    """
    if quant is not None:
        overrides["quant"] = check_mode(quant)
    common = dict(image_size=image_size, backend=backend, logits_dtype=logits_dtype)
    if model_name in _BOTNET:
        kwargs = dict(stage_sizes=_BOTNET[model_name], **common)
        return _build(BoTNet, num_classes, {**kwargs, **overrides}, seed)
    if model_name in _CVT:
        embed_dims, num_layers, num_heads = _CVT[model_name]
        kwargs = dict(embed_dims=embed_dims, num_layers=num_layers, num_heads=num_heads,
                      **common)
        return _build(CvT, num_classes, {**kwargs, **overrides}, seed)
    if model_name in _TNT:
        embed_dim, inner_ch, num_layers, num_heads, inner_heads = _TNT[model_name]
        kwargs = dict(embed_dim=embed_dim, inner_ch=inner_ch, num_layers=num_layers,
                      num_heads=num_heads, inner_num_heads=inner_heads, patch_shape=(16, 16),
                      **common)
        return _build(TNT, num_classes, {**kwargs, **overrides}, seed)
    if model_name in _MIXER:
        embed_dim, num_layers, tokens_ch, channels_ch, patch = _MIXER[model_name]
        kwargs = dict(embed_dim=embed_dim, num_layers=num_layers, tokens_hidden_ch=tokens_ch,
                      channels_hidden_ch=channels_ch, patch_shape=(patch, patch),
                      image_size=image_size)
        return _build(MLPMixer, num_classes, {**kwargs, **overrides}, seed)
    if model_name in _VIT:
        cls = ViT
        embed_dim, num_layers, num_heads, patch = _VIT[model_name]
        kwargs = dict(patch_shape=(patch, patch), **_VIT_OPTIONS.get(model_name, {}))
    elif model_name in _CAIT:
        cls = CaiT
        embed_dim, num_layers, num_heads, sd_rate, ls_eps = _CAIT[model_name]
        kwargs = dict(num_layers_token_only=2, patch_shape=(16, 16),
                      stoch_depth_rate=sd_rate, layerscale_eps=ls_eps)
    elif model_name in _CEIT:
        cls = CeiT
        embed_dim, num_layers, num_heads = _CEIT[model_name]
        kwargs = dict(patch_shape=(4, 4))
    else:
        raise ValueError(
            f"unknown model {model_name!r}; available: {', '.join(model_names())}"
        )
    kwargs.update(embed_dim=embed_dim, num_layers=num_layers, num_heads=num_heads, **common)
    kwargs.update(overrides)
    return _build(cls, num_classes, kwargs, seed)


def _build(cls, num_classes: int, kwargs: dict, seed: int) -> nn.Module:
    # Built on the meta device so that no global RNG draw or throw-away
    # init happens; the weights come from the explicit generator only.
    with torch.device("meta"):
        model = cls(num_classes, **kwargs)
    model = model.to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    init_serving(model)
    return model
