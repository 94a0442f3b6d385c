"""Train-time accuracy; counterpart of avt_tpu/utils/metrics.py:topk_accuracy."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def topk_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                  topk: Sequence[int] = (1,)) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracy in percent over the flattened leading dims, one f32
    scalar tensor per k. A target of -1 never matches but counts in the
    denominator (the reference's convention); all targets negative gives 0."""
    logits = logits.reshape(-1, logits.shape[-1])
    targets = targets.reshape(-1)
    batch = targets.shape[0]
    pred = logits.topk(max(topk), dim=-1).indices
    correct = pred == targets[:, None]
    all_invalid = (targets < 0).all()
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    return tuple(
        torch.where(all_invalid, zero, correct[:, :k].float().sum() * (100.0 / batch))
        for k in topk)
