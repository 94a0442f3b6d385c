"""MSE; counterpart of avt_tpu/losses/mse.py:mse."""
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


def mse(inp: torch.Tensor, tgt: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce((inp.float() - tgt.float()) ** 2, reduction)
