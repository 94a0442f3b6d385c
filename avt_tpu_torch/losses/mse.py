"""MSE variants; counterpart of avt_tpu/losses/mse.py."""
from __future__ import annotations

import torch


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"Unknown reduction {reduction!r}")


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||_2, eps), as torch.nn.functional.normalize."""
    return x / torch.linalg.vector_norm(x, ord=2, dim=dim, keepdim=True).clamp_min(eps)


def mse(inp: torch.Tensor, tgt: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce((inp.float() - tgt.float()) ** 2, reduction)


def normed_mse(inp: torch.Tensor, tgt: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """MSE after L2-normalising both inputs along the feature dim."""
    return mse(l2_normalize(inp.float()), l2_normalize(tgt.float()), reduction)


class MSELoss:
    def __init__(self, reduction: str = "mean"):
        self.reduction = reduction

    def __call__(self, inp, tgt):
        return mse(inp, tgt, self.reduction)


class NormedMSE(MSELoss):
    def __call__(self, inp, tgt):
        return normed_mse(inp, tgt, self.reduction)
