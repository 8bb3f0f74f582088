"""Feed-forward blocks: the transformer MLP and CeiT's locally-enhanced FF
(port of ``sav_tpu/models/layers/feedforward.py``).

With ``quant`` (``"int8"`` or ``"int8_serve"``) their dense layers are the
int8 twins of :class:`Dense` (:func:`dense`); the depthwise conv and the
BatchNorms of LeFF stay in the compute dtype, as in ``sav_tpu``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.models.layers.depthwise import DepthwiseConv2D
from sav_tpu_torch.models.layers.normalization import BatchNorm
from sav_tpu_torch.models.layers.regularization import Dropout
from sav_tpu_torch.ops.quant import QuantDense, QuantDenseServe, check_mode


class Dense(nn.Linear):
    """``nn.Linear`` that computes in the input's dtype: the weight and bias
    are cast at use, so f32 parameters serve bf16 activations as flax's
    ``Dense(dtype=bf16)`` does, and their gradients stay f32."""

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(inputs.dtype)
        return F.linear(inputs, self.weight.to(inputs.dtype), bias)


def dense(in_features: int, out_features: int, bias: bool = True,
          quant: Optional[str] = None) -> nn.Module:
    """A :class:`Dense`, or on the int8 arm its twin: :class:`QuantDense`
    (``"int8"``, the same parameters) or :class:`QuantDenseServe`
    (``"int8_serve"``, int8 ``weight`` and f32 ``scale``)."""
    cls = {None: Dense, "int8": QuantDense, "int8_serve": QuantDenseServe}[check_mode(quant)]
    return cls(in_features, out_features, bias=bias)


class FFBlock(nn.Module):
    """Dense(expand) → GELU (tanh approximation, flax's ``nn.gelu``) →
    dropout → Dense(in_ch) → dropout, in the input's dtype."""

    def __init__(
        self,
        in_ch: int,
        expand_ratio: Optional[float] = 4.0,
        hidden_ch: Optional[int] = None,
        use_bias: bool = True,
        dropout_rate: float = 0.0,
        quant: Optional[str] = None,
    ):
        super().__init__()
        hidden = hidden_ch or int(in_ch * expand_ratio)
        self.fc1 = dense(in_ch, hidden, use_bias, quant)
        self.fc2 = dense(hidden, in_ch, use_bias, quant)
        self.drop1 = Dropout(dropout_rate)
        self.drop2 = Dropout(dropout_rate)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.drop1(F.gelu(self.fc1(inputs), approximate="tanh"))
        return self.drop2(self.fc2(x))


class LeFFBlock(nn.Module):
    """CeiT's locally-enhanced feed-forward on ``[B, 1 + side², C]``: the
    CLS token is split off; the patch tokens are expanded, normalised,
    GELU'd, put on their ``side × side`` grid for a 5×5 depthwise conv,
    normalised and GELU'd, projected back, normalised and GELU'd; then the
    CLS token is joined back, untouched. Each BatchNorm reduces over the
    batch and the tokens (the tokens as ``[B·L, C]`` rows), with f32
    statistics; GELU is the tanh form (flax's ``nn.gelu``)."""

    def __init__(self, in_ch: int, expand_ratio: Optional[float] = 4.0,
                 hidden_ch: Optional[int] = None, kernel_size=(5, 5),
                 quant: Optional[str] = None):
        super().__init__()
        hidden = hidden_ch or int(in_ch * expand_ratio)
        self.expand = dense(in_ch, hidden, quant=quant)
        self.bn1 = BatchNorm(hidden)
        self.dwconv = DepthwiseConv2D(hidden, kernel_size)
        self.bn2 = BatchNorm(hidden)
        self.project = dense(hidden, in_ch, quant=quant)
        self.bn3 = BatchNorm(in_ch)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        cls_tok, tokens = inputs[:, :1], inputs[:, 1:]
        b, length, _ = tokens.shape
        side = int(round(length ** 0.5))
        if side * side != length:
            raise ValueError(f"LeFF requires a square token grid, got {length} tokens")

        def norm_act(bn, x):
            return F.gelu(bn(x.reshape(-1, x.shape[-1])), approximate="tanh")

        x = norm_act(self.bn1, self.expand(tokens))
        x = self.dwconv(x.view(b, side, side, -1))
        x = norm_act(self.bn2, x).view(b, length, -1)
        x = norm_act(self.bn3, self.project(x)).view(b, length, -1)
        return torch.cat([cls_tok, x], dim=1)
