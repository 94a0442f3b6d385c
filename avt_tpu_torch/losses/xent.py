"""Cross entropy over multi-dimensional inputs with ignore-index semantics.

Counterpart of avt_tpu/losses/xent.py (`multidim_cross_entropy`,
`MultiDimCrossEntropy`): (*, C) logits against (*,) integer targets; targets
equal to `ignore_index` contribute 0 and are left out of the `mean`
denominator, which sums the weights of the kept elements. Ignoring is done
with masks, so the shapes never depend on the data.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def multidim_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = -1,
    reduction: str = "none",
) -> torch.Tensor:
    """reduction 'none' (target's shape), 'sum' or 'mean'; log-softmax in f32.
    A `mean` over a batch with every target ignored is 0 (torch gives nan)."""
    if logits.dim() != targets.dim() + 1:
        raise ValueError(f"logits must have one more dim than targets: "
                         f"{tuple(logits.shape)} vs {tuple(targets.shape)}")
    if logits.shape[:-1] != targets.shape:
        raise ValueError(f"leading dims must match: {tuple(logits.shape)} vs "
                         f"{tuple(targets.shape)}")
    valid = targets != ignore_index
    tgt = targets.clamp(0, logits.shape[-1] - 1).long()  # in bounds; masked below
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    w = (torch.ones_like(nll) if weight is None
         else torch.as_tensor(weight, dtype=nll.dtype, device=nll.device)[tgt])
    w = torch.where(valid, w, torch.zeros_like(w))
    loss = nll * w
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        denom = w.sum()
        return torch.where(denom > 0, loss.sum() / denom.clamp_min(1e-12),
                           torch.zeros_like(denom))
    raise ValueError(f"Unknown reduction {reduction!r}")


class MultiDimCrossEntropy:
    """Configurable wrapper around `multidim_cross_entropy`."""

    def __init__(self, weight: Optional[torch.Tensor] = None, ignore_index: int = -1,
                 reduction: str = "none"):
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def __call__(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return multidim_cross_entropy(logits, targets, weight=self.weight,
                                      ignore_index=self.ignore_index,
                                      reduction=self.reduction)
