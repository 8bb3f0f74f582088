"""Named model registry (port of ``sav_tpu/models/registry.py``).

The plain ViT entries are ported. Every other ``sav_tpu`` name is known here
and raises ``NotImplementedError`` naming the ROADMAP queue item it waits on.
"""

from __future__ import annotations

from typing import Optional

import torch

from sav_tpu_torch.models.vit import ViT

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
}

_NOT_PORTED = {
    "vit_s_patch16_rope": "queue A2 (ops/rotary.py)",
    "vit_moe_s_patch16_e8": "queue A7.7 (MoE)",
    **{n: "queue A7.6 (BoTNet)" for n in ("botnet_t3", "botnet_t4", "botnet_t5")},
    **{n: "queue A7.2 (TNT)" for n in ("tnt_s_patch16", "tnt_b_patch16")},
    **{n: "queue A7.4 (CeiT)" for n in ("ceit_t", "ceit_s", "ceit_b")},
    **{
        f"cait_{size}_{depth}": "queue A7.1 (CaiT)"
        for size, depth in (
            ("xxs", 24), ("xxs", 36), ("xs", 24), ("xs", 36), ("s", 24),
            ("s", 36), ("s", 48), ("m", 24), ("m", 36), ("m", 48),
        )
    },
    **{n: "queue A7.5 (CvT)" for n in ("cvt-13", "cvt-21", "cvt-w24")},
    **{
        f"mixer_{size}_patch{p}": "queue A7.3 (MLP-Mixer)"
        for size in ("s", "b", "l")
        for p in (32, 16)
    },
}


def model_names() -> list:
    """The names :func:`create_model` can build."""
    return sorted(_VIT)


def create_model(
    model_name: str,
    *,
    num_classes: int = 1000,
    image_size: int = 224,
    backend: Optional[str] = None,
    logits_dtype=None,
    seed: int = 0,
    **overrides,
) -> ViT:
    """Instantiate a named config with weights drawn from ``seed``.

    The module is built on the CPU in float32; move it with
    ``.to(device, dtype)``. ``backend`` ('fused' | 'xla' | None = auto) and
    ``logits_dtype`` (the xla path's softmax dtype; None = the compute dtype)
    reach every attention block. ``overrides`` replace config fields
    (``embed_dim``, ``num_layers``, ``num_heads``, ``patch_shape``, ...).
    """
    if model_name in _NOT_PORTED:
        raise NotImplementedError(
            f"{model_name!r} is not ported yet: ROADMAP {_NOT_PORTED[model_name]}"
        )
    if model_name not in _VIT:
        raise ValueError(
            f"unknown model {model_name!r}; available: {', '.join(model_names())}"
        )
    embed_dim, num_layers, num_heads, patch = _VIT[model_name]
    kwargs = dict(
        embed_dim=embed_dim,
        num_layers=num_layers,
        num_heads=num_heads,
        patch_shape=(patch, patch),
        image_size=image_size,
        backend=backend,
        logits_dtype=logits_dtype,
    )
    kwargs.update(overrides)
    # Built on the meta device so that no global RNG draw or throw-away
    # init happens; the weights come from the explicit generator only.
    with torch.device("meta"):
        model = ViT(num_classes, **kwargs)
    model = model.to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model
