"""Cross entropy over multi-dimensional inputs with ignore-index semantics.

Counterpart of avt_tpu/losses/xent.py (`multidim_cross_entropy`,
`MultiDimCrossEntropy`, `quantize_and_cross_entropy`,
`QuantizeAndCrossEntropy`): (*, C) logits against (*,) integer targets; targets
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


def quantize_and_cross_entropy(inp: torch.Tensor, tgt: torch.Tensor, centroids: torch.Tensor,
                               *, norm: bool = True, reduction: str = "none") -> torch.Tensor:
    """Cross entropy of features scored against k-means centroids, in JAX's
    order: both sides L2-normalised (with `norm`), logits = inp @ C^T, the
    target class tgt's nearest centroid (reference
    loss_fn/multidim_xentropy.py:28-54)."""
    if norm:
        inp = inp / torch.linalg.vector_norm(inp, dim=-1, keepdim=True).clamp_min(1e-12)
        tgt = tgt / torch.linalg.vector_norm(tgt, dim=-1, keepdim=True).clamp_min(1e-12)
    logits = inp @ centroids.T
    d = (centroids ** 2).sum(dim=-1)[None] - 2.0 * (tgt.reshape(-1, tgt.shape[-1]) @ centroids.T)
    tgt_ids = d.argmin(dim=-1).reshape(tgt.shape[:-1])
    return multidim_cross_entropy(logits, tgt_ids, reduction=reduction)


class QuantizeAndCrossEntropy:
    """Configurable wrapper around `quantize_and_cross_entropy`, its
    centroids read from a file (`models.cluster.load_centroids`) and moved
    to the inputs' device at the first call there."""

    def __init__(self, centroids_fpath, norm: bool = True, reduction: str = "none"):
        from avt_tpu_torch.models.cluster import load_centroids

        self.centroids = torch.as_tensor(load_centroids(centroids_fpath), dtype=torch.float32)
        self.norm = norm
        self.reduction = reduction

    def __call__(self, inp: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        if self.centroids.device != inp.device:
            self.centroids = self.centroids.to(inp.device)
        return quantize_and_cross_entropy(inp, tgt, self.centroids, norm=self.norm,
                                          reduction=self.reduction)
