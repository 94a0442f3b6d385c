"""The train step: forward, losses, backward, optimizer update.

Counterpart of avt_tpu/train/step.py (`weighted_loss_sum`,
`make_train_step`): per-loss mean reduction, the loss_wts-weighted sum with
zero-weight losses left out of the graph, the gradient, the update. The JAX
step is one jitted program over a donated TrainState; here the model's
parameters and the optimizer's buffers are updated in place, and the
returned metrics stay device tensors, so a step never waits for the device.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from avt_tpu_torch.train.ops import basic_loss_accuracy


def weighted_loss_sum(losses: Dict[str, torch.Tensor], loss_wts: Mapping[str, float]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean-reduce each loss, then sum those with weight > 0 (a weight-0
    loss stays out of the graph); a loss with no weight raises KeyError."""
    mean_losses = {k: v.float().mean() for k, v in losses.items()}
    total = None
    for key, val in mean_losses.items():
        if key not in loss_wts:
            raise KeyError(f"Loss {key!r} has no weight in loss_wts {sorted(loss_wts)}")
        wt = loss_wts[key]
        if wt > 0:
            total = wt * val if total is None else total + wt * val
    if total is None:
        device = next(iter(mean_losses.values())).device if mean_losses else None
        total = torch.zeros((), dtype=torch.float32, device=device)
    return total, mean_losses


def make_train_step(
    model,
    optimizer,
    loss_wts: Mapping[str, float],
    num_classes: Mapping[str, int],
    class_weights: Optional[Mapping[str, torch.Tensor]] = None,
    preprocess_fn: Optional[Callable] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(batch, generator) -> metrics, in train mode.

    batch: {'video': (B, #clips, [#crops,] C, T, H, W) (or what
    preprocess_fn(video, generator) turns into that), 'target': {task: (B,)},
    optional 'target_subclips': {task: (B, #clips, ...)}}. `generator` (a
    torch.Generator on the model's device, or None for torch's default)
    draws the dropout masks and is handed to preprocess_fn. Metrics: 'loss',
    'loss/<key>' per loss, 'acc1/<task>', 'acc5/<task>', detached."""

    def step(batch, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        target = batch["target"]
        target_shape = tuple(next(iter(target.values())).shape)
        video = batch["video"]
        if preprocess_fn is not None:
            video = preprocess_fn(video, generator)
        outputs, aux_losses = model(video, target_shape, generator=generator)
        tsub = batch.get("target_subclips")
        if tsub is not None:  # the mode runs over the frames of each subclip
            tsub = {k: v.reshape(v.shape[0], v.shape[1], -1) for k, v in tsub.items()}
        losses, accuracies = basic_loss_accuracy(outputs, target, tsub, num_classes=num_classes,
                                                 class_weights=class_weights)
        losses.update(aux_losses)
        total, mean_losses = weighted_loss_sum(losses, loss_wts)
        optimizer.zero_grad()
        total.backward()
        optimizer.step()
        metrics = {"loss": total.detach()}
        metrics.update({f"loss/{k}": v.detach() for k, v in mean_losses.items()})
        metrics.update(accuracies)
        return metrics

    return step
