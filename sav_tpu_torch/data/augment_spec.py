"""Augment-string mini-DSL parser (the port's own copy of
``sav_tpu/data/augment_spec.py``).

Strings like ``'cutmix_mixup_randaugment_405'`` select batch-mix ops and
AA/RA policies:

  - ``cutmix``            — CutMix on (part of) the batch
  - ``mixup``             — MixUp, Beta(0.2) ratio by default
  - ``mixup_<alpha>``     — override the Beta alpha (e.g. ``mixup_0.4``)
  - ``randaugment_<M>``   — RandAugment; M < 100 → (2 layers, mag M),
                            M ≥ 100 → (M // 100 layers, mag M % 100),
                            so ``randaugment_405`` = 4 layers, magnitude 5
  - ``autoaugment``       — AutoAugment-v0 policy

The trainer's ``device_preprocess`` reads the mixes
(:func:`sav_tpu_torch.ops.preprocess.apply_mixes`); RandAugment and
AutoAugment belong to a host pipeline.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AugmentSpec:
    cutmix: bool = False
    mixup: bool = False
    mixup_alpha: float = 0.2
    cutmix_alpha: float = 1.0
    randaugment: Optional[tuple[int, int]] = None  # (num_layers, magnitude)
    autoaugment: bool = False

    @property
    def mixes(self) -> bool:
        return self.cutmix or self.mixup


def parse_augment_spec(name: Optional[str]) -> AugmentSpec:
    if not name or name == "none":
        return AugmentSpec()
    mixup_alpha = 0.2
    m = re.search(r"mixup_([0-9.]+)", name)
    if m:
        mixup_alpha = float(m.group(1))
    randaug = None
    m = re.search(r"randaugment_(\d+)", name)
    if m:
        code = int(m.group(1))
        randaug = (code // 100, code % 100) if code >= 100 else (2, code)
    return AugmentSpec(
        cutmix="cutmix" in name,
        mixup="mixup" in name,
        mixup_alpha=mixup_alpha,
        randaugment=randaug,
        autoaugment="autoaugment" in name and "randaugment" not in name,
    )
