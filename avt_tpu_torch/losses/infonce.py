"""SimCLR / MIL-NCE InfoNCE losses, in one process.

Counterpart of avt_tpu/losses/infonce.py (`mil_cross_entropy`,
`simclr_infonce`, `SimclrInfoNCE`, `MultiDimSimclrInfoNCE`), itself the
reference's loss_fn/simclr_infonce.py:
  * mil_cross_entropy: the sum form is logsumexp(all) - logsumexp(positives);
    the max form replaces the positives by their max before the
    denominator, and returns the mean whatever `reduction` says (the
    reference's quirk, :44-55);
  * simclr_infonce: f32, l2-normalised embeddings, one-hot positives,
    self-similarity masked with LARGE_NUM, K positives a row (MIL-NCE) and
    the optional target -> output term, which takes the first positive.
The negatives are the process's own batch: JAX's `_gather_embeddings` is
the identity without a mesh axis, and the port's all-gather comes with its
DDP slice. Positives are chosen with masks, so no shape depends on the data.
"""
from __future__ import annotations

import torch

from avt_tpu_torch.losses.mse import l2_normalize

LARGE_NUM = 1e9


def mil_cross_entropy(pred: torch.Tensor, labels_onehot: torch.Tensor, mil_type: str = "sum",
                      reduction: str = "mean") -> torch.Tensor:
    """Multiple-instance NCE cross entropy of (B, N) logits against (B, N)
    labels with 1 at the positive columns."""
    pos = labels_onehot > 0.5
    neg_inf = torch.full((), float("-inf"), dtype=pred.dtype, device=pred.device)
    if mil_type == "sum":
        numerator = torch.logsumexp(torch.where(pos, pred, neg_inf), dim=1)
        denominator = torch.logsumexp(pred, dim=1)
    elif mil_type == "max":
        numerator = torch.where(pos, pred, neg_inf).amax(dim=1)
        neg_only = torch.where(pos, neg_inf, pred)
        denominator = torch.logsumexp(torch.cat([numerator[:, None], neg_only], dim=1), dim=1)
    else:
        raise NotImplementedError(f"Unknown mil_type {mil_type!r}")
    loss = denominator - numerator
    if mil_type == "max" or reduction == "mean":
        return loss.mean()
    if reduction == "none":
        return loss
    raise NotImplementedError(f"Unknown reduction {reduction!r}")


def simclr_infonce(output: torch.Tensor, target: torch.Tensor, *, temperature: float = 0.1,
                   target_to_output_loss: bool = True, mil_type: str = "sum",
                   reduction: str = "mean") -> torch.Tensor:
    """SimCLR InfoNCE of (B, C) predictions against (B, C) positives or
    (B, K, C), K positives an item."""
    output = l2_normalize(output.float())
    target = l2_normalize(target.float())
    if target.dim() == 3:
        num_matching = target.shape[1]
        target_flat = target.reshape(-1, target.shape[-1])
        target = target[:, 0]
    elif target.dim() == 2:
        num_matching = 1
        target_flat = target
    else:
        raise ValueError(f"target must be 2D or 3D, got {tuple(target.shape)}")
    B = output.shape[0]
    labels = torch.eye(B, dtype=output.dtype, device=output.device)
    extra_zeros = torch.zeros_like(labels)
    logits_aa = output @ output.T / temperature - labels * LARGE_NUM  # no self-similarity
    logits_ab = output @ target_flat.T / temperature
    loss = mil_cross_entropy(
        torch.cat([logits_ab, logits_aa], dim=1),
        torch.cat([labels.repeat_interleave(num_matching, dim=1), extra_zeros], dim=1),
        mil_type=mil_type, reduction=reduction)
    if target_to_output_loss:  # only the first of the K positives takes part
        target_all = target_flat[::num_matching]
        logits_bb = target @ target_all.T / temperature - labels * LARGE_NUM
        logits_ba = target @ output.T / temperature
        loss = loss + mil_cross_entropy(
            torch.cat([logits_ba, logits_bb], dim=1), torch.cat([labels, extra_zeros], dim=1),
            mil_type=mil_type, reduction=reduction)
    return loss


class SimclrInfoNCE:
    """`simclr_infonce` with its options bound (the reference's
    DistributedSimclrInfoNCELoss, in one process)."""

    def __init__(self, temperature: float = 0.1, target_to_output_loss: bool = True,
                 mil_type: str = "sum", reduction: str = "mean"):
        self.temperature = temperature
        self.target_to_output_loss = target_to_output_loss
        self.mil_type = mil_type
        self.reduction = reduction

    def __call__(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return simclr_infonce(output, target, temperature=self.temperature,
                              target_to_output_loss=self.target_to_output_loss,
                              mil_type=self.mil_type, reduction=self.reduction)


class MultiDimSimclrInfoNCE(SimclrInfoNCE):
    """The leading dims folded into the batch first (the reference's
    MultiDimDistributedSimclrInfoNCELoss, :160-167)."""

    def __call__(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return super().__call__(output.reshape(-1, output.shape[-1]),
                                target.reshape(-1, target.shape[-1]))
