"""Loss and accuracy over model endpoints.

Counterpart of avt_tpu/train/ops.py (`mode_over_frames`,
`balance_weights_from_counts`, `basic_loss_accuracy`): per task the unreduced
cross entropy `cls_<task>` of `logits/<task>` and acc1/acc5; with past logits
and subclip targets, `past_cls_<task>` against the mode of each subclip's
frame labels. Every value stays a device tensor.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from avt_tpu_torch.losses.xent import multidim_cross_entropy
from avt_tpu_torch.models.base import PAST_LOGITS_PREFIX
from avt_tpu_torch.utils.metrics import topk_accuracy


def mode_over_frames(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Mode over the last axis of integer labels in [-1, num_classes): the
    smallest of the most frequent values wins a tie (torch.mode's rule), and
    -1 takes part."""
    counts = F.one_hot(labels.long() + 1, num_classes + 1).sum(dim=-2)
    return counts.argmax(dim=-1) - 1  # argmax picks the first maximum


def balance_weights_from_counts(counts: Mapping[int, int], num_classes: int,
                                device=None) -> torch.Tensor:
    """Inverse-frequency class weights from {class id: count}."""
    w = torch.zeros(num_classes, dtype=torch.float32, device=device)
    for cls_id, count in counts.items():
        if cls_id >= 0:
            w[cls_id] = count
    return 1.0 / (w / w.sum() + 1e-5)


def basic_loss_accuracy(
    outputs: Dict[str, torch.Tensor],
    target: Dict[str, torch.Tensor],
    target_subclips: Optional[Dict[str, torch.Tensor]] = None,
    *,
    num_classes: Mapping[str, int],
    class_weights: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(losses, accuracies) for every target task."""
    losses: Dict[str, torch.Tensor] = {}
    accuracies: Dict[str, torch.Tensor] = {}
    for task, tgt in target.items():
        logits = outputs[f"logits/{task}"]
        if logits.dim() != tgt.dim() + 1:
            raise ValueError(f"logits/{task} {tuple(logits.shape)} vs target {tuple(tgt.shape)}")
        weight = class_weights.get(task) if class_weights else None
        losses[f"cls_{task}"] = multidim_cross_entropy(logits, tgt, weight=weight)
        acc1, acc5 = topk_accuracy(logits, tgt, topk=(1, min(5, logits.shape[-1])))
        accuracies[f"acc1/{task}"] = acc1
        accuracies[f"acc5/{task}"] = acc5
        past_key = f"{PAST_LOGITS_PREFIX}logits/{task}"
        if past_key in outputs and target_subclips is not None:
            past_logits = outputs[past_key]
            past_target = mode_over_frames(target_subclips[task], num_classes[task])
            if past_logits.shape[:-1] != past_target.shape:
                raise ValueError(f"past logits {tuple(past_logits.shape)} vs target "
                                 f"{tuple(past_target.shape)}")
            losses[f"past_cls_{task}"] = multidim_cross_entropy(
                past_logits, past_target, weight=weight)
    return losses, accuracies
