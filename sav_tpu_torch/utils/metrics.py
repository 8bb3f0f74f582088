"""Metrics (port of ``sav_tpu/utils/metrics.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def topk_correct(logits: torch.Tensor, labels: torch.Tensor, topk: tuple = (1, 5)) -> dict:
    """Per-example top-k correctness masks.

    Args:
      logits: ``[batch, num_classes]``.
      labels: ``[batch]`` int class ids.
      topk: the k values.

    Returns:
      ``{f'top_{k}_acc': [batch] f32 mask}``, 1.0 where the true label is
      among the k largest logits.
    """
    top_ids = logits.topk(max(topk), dim=-1).indices
    hit = top_ids == labels[:, None].to(top_ids.dtype)
    return {f"top_{k}_acc": hit[:, :k].any(dim=-1).float() for k in topk}


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor, topk: tuple = (1, 5)) -> dict:
    """Mean top-k accuracies over the batch."""
    return {k: v.mean() for k, v in topk_correct(logits, labels, topk).items()}


def cross_entropy(logits: torch.Tensor, label_probs: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy against (possibly soft or mixed) label
    distributions, in f32 whatever the logits' dtype."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(label_probs.float() * logp).sum(dim=-1).mean()
