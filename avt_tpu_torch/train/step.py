"""The train and eval steps: forward, losses, backward, optimizer update.

Counterpart of avt_tpu/train/step.py (`weighted_loss_sum`,
`make_train_step`, `make_ssl_train_step`, `make_multi_step`,
`make_eval_step`, `make_forward_fn`): per-loss mean reduction, the
loss_wts-weighted sum with zero-weight losses left out of the graph, the
gradient, the update. The JAX
step is one jitted program over a donated TrainState; here the model's
parameters and the optimizer's buffers are updated in place, and the
returned metrics stay device tensors, so a step never waits for the device.

Under data parallelism over processes (parallel/ddp.py) each rank steps on
its shard of the global batch; the gradients are averaged over the ranks
between the backward and the optimizer (`allreduce_gradients`), so that
every rank takes the update of the global batch's mean loss. (A loss mean
that leaves ignored targets out, or weighs classes, is each rank's mean
averaged, as the reference's DDP takes it; it is the global batch's when
every rank keeps the same weight.) In one process nothing changes. Under
tensor parallelism (parallel/mesh.py) "the ranks" are the data replicas:
the gradients are averaged over the data group, and model peers, which
step on the same batch, draw the same masks and crops.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from avt_tpu_torch.parallel.ddp import RankGenerator, allreduce_gradients, data_rank, data_world
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
        allreduce_gradients(model.parameters())
        optimizer.step()
        metrics = {"loss": total.detach()}
        metrics.update({f"loss/{k}": v.detach() for k, v in mean_losses.items()})
        metrics.update(accuracies)
        return metrics

    return step


_COMBINE = {"min": torch.min, "max": torch.max, "mean": torch.mean, "sum": torch.sum}


def make_ssl_train_step(
    model,
    optimizer,
    loss_wts: Mapping[str, float],
    num_classes: Mapping[str, int],
    reg_criterion: Callable,
    *,
    nfutures: int = 1,
    future_target: str = "temp_agg_projected",
    incur_loss_style: str = "separately",
    combine_future_losses: str = "min",
    cumulative_future: bool = False,
    class_weights: Optional[Mapping[str, torch.Tensor]] = None,
    use_cls_loss: bool = True,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The self-supervised future-feature step (the reference's
    PredFutureFeat, func/train_eval_ops.py:148-231): step(batch, generator)
    -> metrics, as `make_train_step`'s.

    The observed clips and their `nfutures` future clips (batch keys
    'future_<i>_video') run as one forward of (1 + nfutures) * B clips. The
    classification losses (when `use_cls_loss`) take the first B rows; the
    auxiliary losses cover the whole batch. The 'reg' loss ties
    'future_projected' of the observed clips to each future clip's
    `future_target` feature: 'separately' (one `reg_criterion` a future,
    combined by min, max, mean or sum; with `cumulative_future` each
    future's features are first averaged cumulatively over the batch axis,
    as the JAX step does) or 'together' (the futures stacked as
    (B, nfutures, ...) positives). Like the JAX step, it takes feature or
    preprocessed video batches (no preprocess_fn)."""
    combine = _COMBINE[combine_future_losses]
    if incur_loss_style not in ("separately", "together"):
        raise NotImplementedError(incur_loss_style)

    def step(batch, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        target = batch["target"]
        B = next(iter(target.values())).shape[0]
        video = torch.cat([batch["video"]] + [batch[f"future_{i}_video"]
                                              for i in range(nfutures)], dim=0)
        outputs_full, aux_losses = model(video, generator=generator)
        outputs = {k: v[:B] for k, v in outputs_full.items()}
        if use_cls_loss:
            tsub = batch.get("target_subclips")
            if tsub is not None:
                tsub = {k: v.reshape(v.shape[0], v.shape[1], -1) for k, v in tsub.items()}
            losses, accuracies = basic_loss_accuracy(outputs, target, tsub,
                                                     num_classes=num_classes,
                                                     class_weights=class_weights)
        else:
            losses, accuracies = {}, {}
        losses.update(aux_losses)
        anchor = outputs["future_projected"]
        if incur_loss_style == "separately":
            reg_losses = []
            for i in range(nfutures):
                fut = outputs_full[future_target][(i + 1) * B:(i + 2) * B]
                if cumulative_future:
                    fut = torch.cumsum(fut, dim=0) / torch.arange(
                        1, fut.shape[0] + 1, dtype=fut.dtype, device=fut.device)[:, None]
                reg_losses.append(reg_criterion(anchor, fut))
            losses["reg"] = combine(torch.stack(reg_losses))
        else:
            fut = outputs_full[future_target][B:]
            fut = fut.reshape((nfutures, B) + tuple(fut.shape[1:])).transpose(0, 1)
            losses["reg"] = reg_criterion(anchor, fut)
        total, mean_losses = weighted_loss_sum(losses, loss_wts)
        optimizer.zero_grad()
        total.backward()
        allreduce_gradients(model.parameters())
        optimizer.step()
        metrics = {"loss": total.detach()}
        metrics.update({f"loss/{k}": v.detach() for k, v in mean_losses.items()})
        metrics.update(accuracies)
        return metrics

    return step


def _seeded(cls, seed: int, step_id: int, device, spawn_key=()) -> torch.Generator:
    seq = np.random.SeedSequence([int(seed), int(step_id)], spawn_key=spawn_key)
    state = seq.generate_state(2, np.uint32)
    gen = cls(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def step_generator(seed: int, step_id: int, device) -> torch.Generator:
    """The generator of global step `step_id` on `device`, seeded from
    (seed, step_id) alone, so that a run takes the same dropout masks and
    crop draws whether its steps are chunked or not, and whether it ran
    through or was resumed. This takes the place of JAX's
    `fold_in(rng, step_id)`; the masks themselves differ from JAX's.

    Under data parallelism the data rank is folded in (as the seed
    sequence's spawn key: a trailing 0 in its entropy would be no fold at
    all), so that no two replicas draw the same dropout mask or crop for
    their different clips, while the model peers of a replica, which run
    one batch, draw the same ones (the replicated residual stream would
    otherwise part between them); `shared` keeps the one-process
    generator. The port goes this way
    rather than drawing each mask for the global batch and keeping this
    rank's rows: plain dropout's masks and the crops then differ from the
    one-process run's, while the position-stable masks (keyed by the shared
    generator and the global row, models/layers.py) equal them."""
    if data_world() == 1:
        return _seeded(torch.Generator, seed, step_id, device)
    gen = _seeded(RankGenerator, seed, step_id, device, spawn_key=(data_rank(),))
    gen.shared = _seeded(torch.Generator, seed, step_id, device)
    return gen


def make_multi_step(step_fn: Callable, unroll_steps: int) -> Callable:
    """K = `unroll_steps` train steps in one call: multi(batches, step_id0,
    seed) runs `step_fn` on the K batches of the list `batches` (each
    already on the device), step j with `step_generator(seed, step_id0 + j)`
    on the batch's device, and returns each metric stacked (K,) on the
    device, without waiting for it. One call still queues the K steps one
    by one: capturing them in a CUDA graph is a later change (the
    schedule's LR is read on the host at each step)."""

    def multi(batches: Sequence[dict], step_id0: int, seed: int) -> Dict[str, torch.Tensor]:
        if len(batches) != unroll_steps:
            raise ValueError(f"{len(batches)} batches for a {unroll_steps}-step call")
        per_step = [step_fn(b, step_generator(seed, step_id0 + j, b["video"].device))
                    for j, b in enumerate(batches)]
        return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return multi


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


def make_forward_fn(model) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """fwd(video) -> the model's whole outputs dict, in eval mode with
    autograd off: the counterpart of the JAX package's plain jitted forward
    (the parameters are the model's own, so fwd takes only the video)."""

    @torch.no_grad()
    def fwd(video: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.eval()
        outputs, _ = model(video)
        return outputs

    return fwd
