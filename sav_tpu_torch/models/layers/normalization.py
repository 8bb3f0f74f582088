"""LayerScale and BatchNorm (port of ``sav_tpu/models/layers/normalization.py``
and of flax's ``nn.BatchNorm`` as BoTNet, CeiT and CvT use it)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerScaleBlock(nn.Module):
    """Per-channel learned scale on a residual branch, initialised to
    ``eps`` and cast to the input's dtype at use."""

    def __init__(self, dim: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim))

    def reset_parameters(self) -> None:
        nn.init.constant_(self.scale, self.eps)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return inputs * self.scale.to(inputs.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of an ``[N, C, H, W]`` tensor (any memory format) or of ``[N, C]``
    rows (tokens ``[B, L, C]`` reshaped to ``[B·L, C]``: flax's BatchNorm
    on channel-last tokens reduces over B and L).

    - The scale (``weight``), the bias and the running statistics are f32
      and stay f32 under a bf16 input: statistics and normalisation are
      computed in f32 and only the output takes the input's dtype, as flax
      does under ``dtype=bf16``.
    - Training normalises with the batch statistics and updates
      ``running = 0.9·running + 0.1·batch`` (flax's momentum 0.9 is torch's
      0.1) with the **biased** batch variance; torch's
      ``batch_norm(training=True)`` would update with the unbiased one, so
      the update is made here, from the f32 batch statistics the
      normalisation used.
    - Eval normalises with the running statistics.

    The ``state_dict`` holds what flax does and nothing else:
    ``weight``/``bias`` (flax ``scale``/``bias``) and
    ``running_mean``/``running_var`` (flax ``batch_stats`` ``mean``/``var``).
    """

    F32_TENSORS = ("weight", "bias", "running_mean", "running_var")

    def __init__(self, num_features: int, *, momentum: float = 0.9, eps: float = 1e-5,
                 zero_scale: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))

    def reset_parameters(self) -> None:
        """flax's init: scale 1 (0 where ``zero_scale``, BoTNet's ``bn3``),
        bias 0, running mean 0 and variance 1."""
        nn.init.constant_(self.weight, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(inputs, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        # The op F.batch_norm runs, called for the f32 batch mean and
        # 1/sqrt(var + eps) it normalises with (f32 under a bf16 input with
        # f32 weights); var is the biased variance (flax forms it as
        # E[x²] − E[x]², torch in one Welford pass: they agree to f32
        # rounding).
        out, mean, invstd = torch.native_batch_norm(
            inputs, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = torch.clamp(invstd.pow(-2) - self.eps, min=0.0)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return out


def cast_for_compute(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the floating parameters and buffers of ``model`` to ``dtype`` in
    place, except those a module names in its ``F32_TENSORS``, which stay
    f32: a :class:`BatchNorm`'s scale, bias and statistics (flax keeps them
    f32 under a bf16 ``dtype``), BoTMHSA's relative tables (the kernels'
    path reads them in f32) and a DepthwiseConv2D's kernel (``sav_tpu``
    multiplies by it in f32). Returns ``model``."""
    with torch.no_grad():
        for module in model.modules():
            keep = getattr(module, "F32_TENSORS", ())
            for name, param in module.named_parameters(recurse=False):
                if name not in keep and param.is_floating_point():
                    param.data = param.data.to(dtype)
            for name, buf in list(module.named_buffers(recurse=False)):
                if name not in keep and buf.is_floating_point():
                    setattr(module, name, buf.to(dtype))
    return model
