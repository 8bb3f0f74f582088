"""Peak FLOP/s of the card for MFU accounting (the port's counterpart of
``sav_tpu/utils/flops.py``, whose table holds TPU parts only).

MFU is per card: ``step_flops / step_time / peak``, with the peak of the
dtype the step's matrix products run in.
"""

from __future__ import annotations

from typing import Optional

# Dense peak FLOP/s of one card, by the name torch.cuda.get_device_name()
# gives and by compute dtype. Source: NVIDIA's H100 Tensor Core GPU data
# sheet, SXM part, dense (without sparsity): 989 TFLOP/s in bf16 on the
# tensor cores, 1,979 TOP/s in int8 on them, 67 TFLOP/s in f32 outside
# them, at the full 700 W power limit (a card set below it reaches less).
PEAK_FLOPS_PER_CARD = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12},
}
PEAK_SOURCE = "NVIDIA H100 data sheet, SXM, dense"


def per_card_peak_flops(name: str, dtype: str = "bfloat16") -> Optional[float]:
    """Peak FLOP/s of the card called ``name`` in ``dtype`` ('bfloat16',
    'int8' or 'float32'); None for a card or dtype the table does not
    know."""
    return PEAK_FLOPS_PER_CARD.get(name, {}).get(dtype)
