"""RandAugment and AutoAugment-v0 over :mod:`sav_tpu_torch.data.image_ops`
(the port's own copy of ``sav_tpu/data/autoaugment.py``).

The policies, op tables and magnitude mappings are ``sav_tpu``'s. The draws
(which op, whether it applies, the signs of signed magnitudes, Cutout's
centre) come from the ``numpy.random.Generator`` the caller passes, so an
image's augmentation is a pure function of the generator's seed.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from sav_tpu_torch.data import image_ops as ops

_MAX_LEVEL = 10.0


def _mag(level: float, maxval: float) -> float:
    return level / _MAX_LEVEL * maxval


def _signed(value: float, rng: np.random.Generator) -> np.float32:
    """``value`` as float32 times a uniform random sign."""
    return np.float32(value) * np.float32(int(rng.integers(0, 2)) * 2 - 1)


def _op_table(cutout_const: int, translate_const: int) -> dict:
    """name → ``callable(image, level, rng)`` applying the op at that
    magnitude. Posterize and Solarize keep the published AutoAugment
    mapping (bits = level/10·4; threshold = level/10·256, weaker at higher
    levels)."""
    def factor(lv, rng):
        return np.float32(1.0) + _signed(_mag(lv, 0.9), rng)

    return {
        "AutoContrast": lambda im, lv, rng: ops.autocontrast(im),
        "Equalize": lambda im, lv, rng: ops.equalize(im),
        "Invert": lambda im, lv, rng: ops.invert(im),
        "Rotate": lambda im, lv, rng: ops.rotate(im, _signed(_mag(lv, 30.0), rng)),
        "Posterize": lambda im, lv, rng: ops.posterize(im, int(_mag(lv, 4.0))),
        "Solarize": lambda im, lv, rng: ops.solarize(im, int(_mag(lv, 256.0))),
        "SolarizeAdd": lambda im, lv, rng: ops.solarize_add(im, int(_mag(lv, 110.0))),
        "Color": lambda im, lv, rng: ops.color(im, factor(lv, rng)),
        "Contrast": lambda im, lv, rng: ops.contrast(im, factor(lv, rng)),
        "Brightness": lambda im, lv, rng: ops.brightness(im, factor(lv, rng)),
        "Sharpness": lambda im, lv, rng: ops.sharpness(im, factor(lv, rng)),
        "ShearX": lambda im, lv, rng: ops.shear_x(im, _signed(_mag(lv, 0.3), rng)),
        "ShearY": lambda im, lv, rng: ops.shear_y(im, _signed(_mag(lv, 0.3), rng)),
        "TranslateX": lambda im, lv, rng: ops.translate_x(
            im, _signed(_mag(lv, float(translate_const)), rng)),
        "TranslateY": lambda im, lv, rng: ops.translate_y(
            im, _signed(_mag(lv, float(translate_const)), rng)),
        "Cutout": lambda im, lv, rng: ops.cutout(im, int(_mag(lv, float(cutout_const))), rng),
    }


RANDAUG_OPS = (
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "Color", "Contrast", "Brightness", "Sharpness", "ShearX", "ShearY",
    "TranslateX", "TranslateY", "Cutout", "SolarizeAdd",
)


def distort_image_with_randaugment(image: np.ndarray, num_layers: int, magnitude: int,
                                   rng: np.random.Generator, *, cutout_const: int = 40,
                                   translate_const: int = 100) -> np.ndarray:
    """RandAugment: ``num_layers`` times, a uniformly chosen op at
    ``magnitude``, applied with probability p ~ U[0.2, 0.8]."""
    table = _op_table(cutout_const, translate_const)
    for _ in range(num_layers):
        op = RANDAUG_OPS[int(rng.integers(0, len(RANDAUG_OPS)))]
        prob = rng.uniform(0.2, 0.8)
        if rng.random() < prob:
            image = table[op](image, float(magnitude), rng)
    return image


# AutoAugment ImageNet policy v0: 25 sub-policies of two (op, prob, level)
# steps, as published with the AutoAugment paper.
POLICY_V0 = (
    (("Equalize", 0.8, 1), ("ShearY", 0.8, 4)),
    (("Color", 0.4, 9), ("Equalize", 0.6, 3)),
    (("Color", 0.4, 1), ("Rotate", 0.6, 8)),
    (("Solarize", 0.8, 3), ("Equalize", 0.4, 7)),
    (("Solarize", 0.4, 2), ("Solarize", 0.6, 2)),
    (("Color", 0.2, 0), ("Equalize", 0.8, 8)),
    (("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)),
    (("ShearX", 0.2, 9), ("Rotate", 0.6, 8)),
    (("Color", 0.6, 1), ("Equalize", 1.0, 2)),
    (("Invert", 0.4, 9), ("Rotate", 0.6, 0)),
    (("Equalize", 1.0, 9), ("ShearY", 0.6, 3)),
    (("Color", 0.4, 7), ("Equalize", 0.6, 0)),
    (("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)),
    (("Solarize", 0.6, 8), ("Color", 0.6, 9)),
    (("Solarize", 0.2, 4), ("Rotate", 0.8, 9)),
    (("Rotate", 1.0, 7), ("TranslateY", 0.8, 9)),
    (("ShearX", 0.0, 0), ("Solarize", 0.8, 4)),
    (("ShearY", 0.8, 0), ("Color", 0.6, 4)),
    (("Color", 1.0, 0), ("Rotate", 0.6, 2)),
    (("Equalize", 0.8, 4), ("Equalize", 0.0, 8)),
    (("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)),
    (("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)),
    (("Posterize", 0.8, 2), ("Solarize", 0.6, 10)),
    (("Solarize", 0.6, 8), ("Equalize", 0.6, 1)),
    (("Color", 0.8, 6), ("Rotate", 0.4, 5)),
)


def distort_image_with_autoaugment(image: np.ndarray, rng: np.random.Generator, *,
                                   cutout_const: int = 100,
                                   translate_const: int = 250) -> np.ndarray:
    """One uniformly chosen AutoAugment-v0 sub-policy; each of its steps
    applies with its probability."""
    table = _op_table(cutout_const, translate_const)
    for name, prob, level in POLICY_V0[int(rng.integers(0, len(POLICY_V0)))]:
        if rng.random() < prob:
            image = table[name](image, float(level), rng)
    return image


def augment_fn(spec) -> Callable:
    """``(image, rng) -> image`` for an
    :class:`~sav_tpu_torch.data.augment_spec.AugmentSpec`'s RandAugment or
    AutoAugment (the identity when it has neither)."""
    if spec.randaugment is not None:
        layers, magnitude = spec.randaugment
        return lambda image, rng: distort_image_with_randaugment(image, layers, magnitude, rng)
    if spec.autoaugment:
        return distort_image_with_autoaugment
    return lambda image, rng: image
