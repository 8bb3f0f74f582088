"""Convert ``sav_tpu`` (flax) ViT parameters into the port's ``state_dict``.

The tree comes as nested dicts of arrays (numpy, or anything
``numpy.asarray`` takes), with or without the outer ``{"params": ...}``.
Every leaf must be consumed; an unknown key raises.

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
``Encoder_0/LayerNorm_0/{scale,bias}``                  ``encoder.norm.*``                       scale → weight
``head/{kernel,bias}``                                  ``head.{weight,bias}``                   ``[in, out]`` → ``[out, in]``
======================================================  =======================================  ==========
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


def _norm_rule(flax_prefix: str, port_prefix: str) -> list:
    return [
        (rf"{flax_prefix}/scale", rf"{port_prefix}.weight", _as_is),
        (rf"{flax_prefix}/bias", rf"{port_prefix}.bias", _as_is),
    ]


_BLOCK = r"Encoder_0/block_(\d+)"
_RULES = [
    (r"PatchEmbedBlock_0/proj/kernel", "patch_embed.proj.weight", _conv),
    (r"PatchEmbedBlock_0/proj/bias", "patch_embed.proj.bias", _as_is),
    (r"cls", "cls", _as_is),
    (r"Encoder_0/AddAbsPosEmbed_0/pos_embed", "encoder.pos_embed.pos_embed", _as_is),
    *_norm_rule(rf"{_BLOCK}/LayerNorm_0", r"encoder.blocks.\1.norm1"),
    *_norm_rule(rf"{_BLOCK}/LayerNorm_1", r"encoder.blocks.\1.norm2"),
    (rf"{_BLOCK}/SelfAttentionBlock_0/to_qkv/kernel", r"encoder.blocks.\1.attn.to_qkv", _as_is),
    (rf"{_BLOCK}/SelfAttentionBlock_0/to_out/kernel", r"encoder.blocks.\1.attn.to_out", _as_is),
    (rf"{_BLOCK}/FFBlock_0/fc(1|2)/kernel", r"encoder.blocks.\1.ff.fc\2.weight", _dense),
    (rf"{_BLOCK}/FFBlock_0/fc(1|2)/bias", r"encoder.blocks.\1.ff.fc\2.bias", _as_is),
    *_norm_rule(r"Encoder_0/LayerNorm_0", "encoder.norm"),
    (r"head/kernel", "head.weight", _dense),
    (r"head/bias", "head.bias", _as_is),
]


def _flatten(tree, prefix=""):
    for name, value in tree.items():
        path = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def params_from_flax(tree) -> dict:
    """flax ViT params → a ``state_dict`` for ``load_state_dict(strict=True)``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state, unknown = {}, []
    for path, leaf in _flatten(dict(tree)):
        for pattern, target, convert in _RULES:
            match = re.fullmatch(pattern, path)
            if match:
                array = convert(np.asarray(leaf, dtype=np.float32))
                state[match.expand(target)] = torch.from_numpy(np.array(array, order="C"))
                break
        else:
            unknown.append(path)
    if unknown:
        raise KeyError(f"flax parameters the ViT port does not consume: {unknown}")
    return state
