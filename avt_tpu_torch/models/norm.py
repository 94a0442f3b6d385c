"""BatchNorm with torch's running-statistics semantics, over the global batch.

Counterpart of avt_tpu/models/norm.py (`TorchExactBatchNorm`), which was
written to copy what torch's `nn.BatchNorm2d`/`3d` do: normalise with the
biased batch variance, accumulate the unbiased one (`var * n / (n - 1)`)
into running_var, and in eval mode normalise with the running statistics.
`model.bn.mom` (conf/config.yaml) is torch's momentum, the weight of the
new batch's statistics; flax's momentum is `1 - mom`. Train and eval mode
follow `module.train()` / `module.eval()`.

The JAX step normalises over the global batch however it is sharded
(conf/config.yaml's "SyncBN semantics by construction",
tests/test_parallel.py's test_bn_sharded_equals_global_stats). In one
process that is torch's BatchNorm as it is, bit for bit. Under data
parallelism over processes (parallel/ddp.py) the training-mode statistics
are the global batch's: each rank's per-channel sums and sums of squares and
its count are all-reduced through the autograd-aware collective, the mean
and the biased variance are taken over the global count, and running_var
takes the unbiased variance of the global count, on every rank alike.
`nn.SyncBatchNorm` would serve on CUDA, but it refuses CPU tensors, on which
the two-process equality is tested. Under tensor parallelism the sums go over
the data group only: model peers hold the same rows, which a sum over the
world would count twice (and so double the gradient).
"""
from __future__ import annotations

import torch
from torch import nn

from avt_tpu_torch.parallel.ddp import all_reduce_with_grad, data_world


class _GlobalStats:
    """The forward of a torch BatchNorm whose training-mode statistics are
    taken over every rank's batch."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and data_world() > 1):
            return super().forward(x)
        self._check_input_dim(x)
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()  # the statistics in f32, as torch's kernels take them
        C = x.shape[1]
        count = torch.full((1,), x.numel() // C, dtype=torch.float32, device=x.device)
        stats = all_reduce_with_grad(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]))
        n = stats[2 * C]
        mean = stats[:C] / n
        var = (stats[C:2 * C] / n - mean * mean).clamp_min(0.0)
        if self.track_running_stats:
            self.num_batches_tracked.add_(1)
            mom = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                   else self.momentum)
            with torch.no_grad():
                self.running_mean.mul_(1 - mom).add_(mean.detach(), alpha=mom)
                self.running_var.mul_(1 - mom).add_(var.detach() * (n / (n - 1)), alpha=mom)
        shape = [1, C] + [1] * (x.dim() - 2)
        y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        if self.affine:
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


class BatchNorm2d(_GlobalStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_GlobalStats, nn.BatchNorm3d):
    pass


def batch_norm(num_features: int, *, dims: int, eps: float = 1e-3, mom: float = 0.1,
               device=None) -> nn.Module:
    """A BatchNorm over `dims` spatial dims (2: BatchNorm2d, 3: BatchNorm3d)
    with the config's eps and torch momentum; weight 1, bias 0, running
    mean 0, running var 1."""
    cls = {2: BatchNorm2d, 3: BatchNorm3d}[dims]
    return cls(num_features, eps=eps, momentum=mom, device=device)
