"""BN-Inception (Inception-v2), the TSN-style frame-level backbone.

Counterpart of avt_tpu/models/bninception.py (`BNInceptionVideo`): the
`pretrainedmodels.bninception` 2D CNN run on each frame, its classifier
dropped, its last feature map averaged over space:
(B, 3, T, H, W) -> (B, 1024, T, 1, 1). Stock torch convolutions, pooling
and BatchNorm (the JAX package leaves them to XLA).

Module names are pretrainedmodels': `conv1_7x7_s2` and its BatchNorm
`conv1_7x7_s2_bn`, `conv2_3x3_reduce`, `conv2_3x3`, then for each
inception block `inception_<n>_{1x1, 3x3_reduce, 3x3, double_3x3_reduce,
double_3x3_1, double_3x3_2, pool_proj}` and their `_bn`s, so that the
released file loads by name. The convolutions keep their biases (the Caffe
conversion kept them, and the released running statistics were computed
with them). The stride-2 max-pools are pretrainedmodels' `ceil_mode=True`
pools, which the JAX package writes as right and bottom padding; the
stride-1 average pools count the padding (torch's and flax's default).

`bn_eps` and `bn_mom` (torch momentum) apply to every BatchNorm.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avt_tpu_torch.models.norm import batch_norm

# (c1, 3x3 reduce, 3x3, double 3x3 reduce, double 3x3, pool proj, pool type);
# c1 == 0 marks a stride-2 reduction block: no 1x1 branch, the max-pool
# passes its input through, and the 3x3 branches are strided
BLOCKS = [
    ("3a", (64, 64, 64, 64, 96, 32, "avg")),
    ("3b", (64, 64, 96, 64, 96, 64, "avg")),
    ("3c", (0, 128, 160, 64, 96, 0, "max")),
    ("4a", (224, 64, 96, 96, 128, 128, "avg")),
    ("4b", (192, 96, 128, 96, 128, 128, "avg")),
    ("4c", (160, 128, 160, 128, 160, 128, "avg")),
    ("4d", (96, 128, 192, 160, 192, 128, "avg")),
    ("4e", (0, 128, 192, 192, 256, 0, "max")),
    ("5a", (352, 192, 320, 160, 224, 128, "avg")),
    ("5b", (352, 192, 320, 192, 224, 128, "max")),
]


class BNInceptionVideo(nn.Module):
    """Per-frame BN-Inception: (B, 3, T, H, W) -> (B, 1024, T, 1, 1)."""

    output_dim = 1024

    def __init__(self, bn_eps: float = 1e-3, bn_mom: float = 0.1, device=None):
        super().__init__()

        def unit(name: str, cin: int, cout: int, k: int, stride: int = 1) -> None:
            setattr(self, name, nn.Conv2d(cin, cout, k, stride, k // 2, device=device))
            setattr(self, name + "_bn", batch_norm(cout, dims=2, eps=bn_eps, mom=bn_mom,
                                                   device=device))

        unit("conv1_7x7_s2", 3, 64, 7, 2)
        self.pool1_3x3_s2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        unit("conv2_3x3_reduce", 64, 64, 1)
        unit("conv2_3x3", 64, 192, 3)
        self.pool2_3x3_s2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        cin = 192
        for name, (c1, c3r, c3, cd3r, cd3, cpool, pool_type) in BLOCKS:
            p = f"inception_{name}_"
            stride = 2 if c1 == 0 else 1
            if c1:
                unit(p + "1x1", cin, c1, 1)
            unit(p + "3x3_reduce", cin, c3r, 1)
            unit(p + "3x3", c3r, c3, 3, stride)
            unit(p + "double_3x3_reduce", cin, cd3r, 1)
            unit(p + "double_3x3_1", cd3r, cd3, 3)
            unit(p + "double_3x3_2", cd3, cd3, 3, stride)
            if stride == 2:
                setattr(self, p + "pool", nn.MaxPool2d(3, 2, ceil_mode=True))
                cin = c3 + cd3 + cin
            else:
                pool = nn.AvgPool2d if pool_type == "avg" else nn.MaxPool2d
                setattr(self, p + "pool", pool(3, 1, 1, ceil_mode=True))
                unit(p + "pool_proj", cin, cpool, 1)
                cin = c1 + c3 + cd3 + cpool

    def _cbr(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, name + "_bn")(getattr(self, name)(x)))

    def _inception(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = f"inception_{name}_"
        branches = []
        if hasattr(self, p + "1x1"):
            branches.append(self._cbr(p + "1x1", x))
        branches.append(self._cbr(p + "3x3", self._cbr(p + "3x3_reduce", x)))
        d = self._cbr(p + "double_3x3_1", self._cbr(p + "double_3x3_reduce", x))
        branches.append(self._cbr(p + "double_3x3_2", d))
        pooled = getattr(self, p + "pool")(x)
        if hasattr(self, p + "pool_proj"):
            pooled = self._cbr(p + "pool_proj", pooled)
        branches.append(pooled)
        return torch.cat(branches, dim=1)

    def forward(self, video, generator: Optional[torch.Generator] = None):
        B, C, T, H, W = video.shape
        x = video.transpose(1, 2).reshape(B * T, C, H, W)
        x = self.pool1_3x3_s2(self._cbr("conv1_7x7_s2", x))
        x = self._cbr("conv2_3x3", self._cbr("conv2_3x3_reduce", x))
        x = self.pool2_3x3_s2(x)
        for name, _ in BLOCKS:
            x = self._inception(name, x)
        x = x.mean(dim=(2, 3))  # global average pool: (B * T, 1024)
        return x.reshape(B, T, -1).transpose(1, 2)[..., None, None]
