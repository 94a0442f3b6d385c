"""The train and eval steps: forward, losses, backward, optimizer update.

Counterpart of avt_tpu/train/step.py (`weighted_loss_sum`,
`make_train_step`, `make_eval_step`): per-loss mean reduction, the
loss_wts-weighted sum with zero-weight losses left out of the graph, the
gradient, the update. The JAX
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


def _forward(model, video, batch, num_classes, class_weights, generator=None):
    """The model on `video`, then the per-task losses and accuracies against
    the batch's targets: (outputs, losses, aux losses, accuracies)."""
    target = batch["target"]
    outputs, aux_losses = model(video, tuple(next(iter(target.values())).shape),
                                generator=generator)
    tsub = batch.get("target_subclips")
    if tsub is not None:  # the mode runs over the frames of each subclip
        tsub = {k: v.reshape(v.shape[0], v.shape[1], -1) for k, v in tsub.items()}
    losses, accuracies = basic_loss_accuracy(outputs, target, tsub, num_classes=num_classes,
                                             class_weights=class_weights)
    return outputs, losses, aux_losses, accuracies


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
        video = batch["video"]
        if preprocess_fn is not None:
            video = preprocess_fn(video, generator)
        _, losses, aux_losses, accuracies = _forward(model, video, batch, num_classes,
                                                     class_weights, generator)
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


def make_eval_step(
    model,
    num_classes: Mapping[str, int],
    class_weights: Optional[Mapping[str, torch.Tensor]] = None,
    store_endpoint: str = "logits",
    preprocess_fn: Optional[Callable] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(batch) -> results, in eval mode under torch.no_grad().

    batch as for make_train_step (preprocess_fn(video) takes no generator).
    Results, the per-batch values the reference's result sink stores: every
    model output whose key starts with store_endpoint ('logits' for eval, a
    feature endpoint such as 'temp_agg' for feature extraction), the
    unreduced 'loss/cls_<task>' of each target task, the mean of each
    auxiliary loss as 'aux_loss/<key>', and 'acc1/<task>', 'acc5/<task>'."""

    @torch.no_grad()
    def step(batch) -> Dict[str, torch.Tensor]:
        model.eval()
        video = batch["video"]
        if preprocess_fn is not None:
            video = preprocess_fn(video)
        outputs, losses, aux_losses, accuracies = _forward(model, video, batch, num_classes,
                                                           class_weights)
        res = {k: v for k, v in outputs.items() if k.startswith(store_endpoint)}
        for task in batch["target"]:
            res[f"loss/cls_{task}"] = losses[f"cls_{task}"]
        for k, v in aux_losses.items():
            res[f"aux_loss/{k}"] = v.float().mean()
        res.update(accuracies)
        return res

    return step
