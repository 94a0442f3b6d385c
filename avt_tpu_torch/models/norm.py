"""BatchNorm with torch's running-statistics semantics.

Counterpart of avt_tpu/models/norm.py (`TorchExactBatchNorm`), which was
written to copy what torch's `nn.BatchNorm2d`/`3d` do: normalise with the
biased batch variance, accumulate the unbiased one (`var * n / (n - 1)`)
into running_var, and in eval mode normalise with the running statistics.
So the port takes torch's BatchNorm as it is; what is left is the config's
convention. `model.bn.mom` (conf/config.yaml) is torch's momentum, the
weight of the new batch's statistics; flax's momentum is `1 - mom`.
Train and eval mode follow `module.train()` / `module.eval()`.
"""
from __future__ import annotations

from torch import nn


def batch_norm(num_features: int, *, dims: int, eps: float = 1e-3, mom: float = 0.1,
               device=None) -> nn.Module:
    """A torch BatchNorm over `dims` spatial dims (2: BatchNorm2d, 3:
    BatchNorm3d) with the config's eps and torch momentum; weight 1, bias 0,
    running mean 0, running var 1."""
    cls = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[dims]
    return cls(num_features, eps=eps, momentum=mom, device=device)
