"""3D-convolutional video backbones: R3D, R(2+1)D, ir-CSN and ip-CSN.

Counterpart of avt_tpu/models/video_resnet.py: torchvision's VideoResNet
with the reference's conv makers (models/video_classification.py:26-210),
headless, as `backbone_last_n_modules_to_drop=2` leaves it:
(B, 3, T, H, W) -> (B, C', T', H', W'). Stock torch convolutions, pooling
and BatchNorm in NCDHW (the JAX package leaves these layers to XLA).

Module names are torchvision's, so that a torchvision or VMZ file loads by
name: `stem.0`, `stem.1`, ..., `layer<L>.<i>.conv1.0[.k]` (the conv maker),
`layer<L>.<i>.conv1.1` (its BatchNorm), `layer<L>.<i>.downsample.{0,1}`.
The conv makers:
  * Conv3DSimple: a 3x3x3 conv (r3d);
  * Conv2Plus1D: (1,3,3) conv, BN, ReLU, (3,1,1) conv, its mid-channels
    computed once per block from (block input, planes) and shared by both
    of the block's makers (torchvision's and every released checkpoint's
    convention, `tv_midplanes`);
  * Conv3DDepthwise: a 3x3x3 depthwise conv (ir-CSN);
  * IPConv3DDepthwise: 1x1x1 conv, BN, 3x3x3 depthwise conv (ip-CSN).
The video ResNets' convolutions have no bias.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from avt_tpu_torch.models.norm import batch_norm


def tv_midplanes(in_planes: int, planes: int) -> int:
    """torchvision's per-block Conv2Plus1D mid-channel count."""
    return (in_planes * planes * 3 * 3 * 3) // (in_planes * 3 * 3 + 3 * planes)


def _conv(cin, cout, kernel, stride=1, padding=0, groups=1, device=None) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding, groups=groups,
                     bias=False, device=device)


class Conv3DSimple(nn.Conv3d):
    """A plain 3x3x3 conv (r3d)."""

    def __init__(self, in_planes, out_planes, midplanes=None, stride=1, *, bn_eps=1e-3,
                 bn_mom=0.1, device=None):
        super().__init__(in_planes, out_planes, 3, stride=stride, padding=1, bias=False,
                         device=device)


class Conv2Plus1D(nn.Sequential):
    """(1,3,3) conv -> BN -> ReLU -> (3,1,1) conv, `midplanes` wide between
    (R(2+1)D)."""

    def __init__(self, in_planes, out_planes, midplanes, stride=1, *, bn_eps=1e-3, bn_mom=0.1,
                 device=None):
        super().__init__(
            _conv(in_planes, midplanes, (1, 3, 3), (1, stride, stride), (0, 1, 1),
                  device=device),
            batch_norm(midplanes, dims=3, eps=bn_eps, mom=bn_mom, device=device),
            nn.ReLU(inplace=True),
            _conv(midplanes, out_planes, (3, 1, 1), (stride, 1, 1), (1, 0, 0), device=device))


class Conv3DDepthwise(nn.Conv3d):
    """A 3x3x3 depthwise conv (ir-CSN)."""

    def __init__(self, in_planes, out_planes, midplanes=None, stride=1, *, bn_eps=1e-3,
                 bn_mom=0.1, device=None):
        if in_planes != out_planes:
            raise ValueError(f"a depthwise conv maps {out_planes} channels to themselves, "
                             f"got {in_planes} in")
        super().__init__(in_planes, out_planes, 3, stride=stride, padding=1,
                         groups=in_planes, bias=False, device=device)


class IPConv3DDepthwise(nn.Sequential):
    """1x1x1 conv -> BN -> 3x3x3 depthwise conv (ip-CSN)."""

    def __init__(self, in_planes, out_planes, midplanes=None, stride=1, *, bn_eps=1e-3,
                 bn_mom=0.1, device=None):
        if in_planes != out_planes:
            raise ValueError(f"ip-CSN's maker maps {out_planes} channels to themselves, "
                             f"got {in_planes} in")
        super().__init__(
            _conv(in_planes, out_planes, 1, device=device),
            batch_norm(out_planes, dims=3, eps=bn_eps, mom=bn_mom, device=device),
            _conv(out_planes, out_planes, 3, stride, 1, groups=out_planes, device=device))


def _downsample(cin, cout, stride, bn_eps, bn_mom, device) -> nn.Sequential:
    # every maker's downsample stride is (s, s, s)
    return nn.Sequential(_conv(cin, cout, 1, stride, device=device),
                         batch_norm(cout, dims=3, eps=bn_eps, mom=bn_mom, device=device))


class BasicBlock3D(nn.Module):
    expansion = 1

    def __init__(self, in_planes, planes, conv_maker, stride=1, downsample=False, *,
                 bn_eps=1e-3, bn_mom=0.1, device=None):
        super().__init__()
        mid = tv_midplanes(in_planes, planes)
        kw = dict(bn_eps=bn_eps, bn_mom=bn_mom, device=device)
        self.conv1 = nn.Sequential(
            conv_maker(in_planes, planes, mid, stride, **kw),
            batch_norm(planes, dims=3, eps=bn_eps, mom=bn_mom, device=device),
            nn.ReLU(inplace=True))
        self.conv2 = nn.Sequential(
            conv_maker(planes, planes, mid, 1, **kw),
            batch_norm(planes, dims=3, eps=bn_eps, mom=bn_mom, device=device))
        self.downsample = (_downsample(in_planes, planes, stride, bn_eps, bn_mom, device)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.conv2(self.conv1(x)) + identity)


class Bottleneck3D(nn.Module):
    expansion = 4

    def __init__(self, in_planes, planes, conv_maker, stride=1, downsample=False, *,
                 bn_eps=1e-3, bn_mom=0.1, device=None):
        super().__init__()
        mid = tv_midplanes(in_planes, planes)
        out = planes * self.expansion
        self.conv1 = nn.Sequential(
            _conv(in_planes, planes, 1, device=device),
            batch_norm(planes, dims=3, eps=bn_eps, mom=bn_mom, device=device),
            nn.ReLU(inplace=True))
        self.conv2 = nn.Sequential(
            conv_maker(planes, planes, mid, stride, bn_eps=bn_eps, bn_mom=bn_mom, device=device),
            batch_norm(planes, dims=3, eps=bn_eps, mom=bn_mom, device=device),
            nn.ReLU(inplace=True))
        self.conv3 = nn.Sequential(
            _conv(planes, out, 1, device=device),
            batch_norm(out, dims=3, eps=bn_eps, mom=bn_mom, device=device))
        self.downsample = (_downsample(in_planes, out, stride, bn_eps, bn_mom, device)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.conv3(self.conv2(self.conv1(x))) + identity)


def _stem(kind: str, bn_eps, bn_mom, device) -> nn.Sequential:
    def bn(c):
        return batch_norm(c, dims=3, eps=bn_eps, mom=bn_mom, device=device)

    if kind == "r2plus1d":
        return nn.Sequential(
            _conv(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), device=device), bn(45),
            nn.ReLU(inplace=True),
            _conv(45, 64, (3, 1, 1), 1, (1, 0, 0), device=device), bn(64),
            nn.ReLU(inplace=True))
    layers = [_conv(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), device=device), bn(64),
              nn.ReLU(inplace=True)]
    if kind == "basic_pool":
        layers.append(nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)))
    elif kind != "basic":
        raise ValueError(f"unknown stem {kind!r}")
    return nn.Sequential(*layers)


class VideoResNet(nn.Module):
    """A headless video ResNet: (B, 3, T, H, W) -> (B, 512 * expansion, T',
    H', W'). `stem` is 'basic', 'basic_pool' or 'r2plus1d'."""

    def __init__(self, block, conv_maker, layers: Sequence[int], stem: str, *,
                 bn_eps: float = 1e-3, bn_mom: float = 0.1, device=None):
        super().__init__()
        self.stem = _stem(stem, bn_eps, bn_mom, device)
        in_planes = 64
        for stage, (planes, stride, n) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2),
                                                        layers)):
            blocks = []
            for i in range(n):
                s = stride if i == 0 else 1
                blocks.append(block(
                    in_planes, planes, conv_maker, s,
                    downsample=i == 0 and (s != 1 or in_planes != planes * block.expansion),
                    bn_eps=bn_eps, bn_mom=bn_mom, device=device))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.output_dim = 512 * block.expansion

    def forward(self, video, generator: Optional[torch.Generator] = None):
        x = self.stem(video)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def r3d_18(bn_eps=1e-3, bn_mom=0.1, device=None):
    return VideoResNet(BasicBlock3D, Conv3DSimple, (2, 2, 2, 2), "basic", bn_eps=bn_eps,
                       bn_mom=bn_mom, device=device)


def r2plus1d_18(bn_eps=1e-3, bn_mom=0.1, device=None):
    return VideoResNet(BasicBlock3D, Conv2Plus1D, (2, 2, 2, 2), "r2plus1d", bn_eps=bn_eps,
                       bn_mom=bn_mom, device=device)


def r2plus1d_34(bn_eps=1e-3, bn_mom=0.1, device=None):
    return VideoResNet(BasicBlock3D, Conv2Plus1D, (3, 4, 6, 3), "r2plus1d", bn_eps=bn_eps,
                       bn_mom=bn_mom, device=device)


def r2plus1d_152(bn_eps=1e-3, bn_mom=0.1, device=None):
    return VideoResNet(Bottleneck3D, Conv2Plus1D, (3, 8, 36, 3), "r2plus1d", bn_eps=bn_eps,
                       bn_mom=bn_mom, device=device)


def ir_csn_152(bn_eps=1e-3, bn_mom=0.1, device=None):
    return VideoResNet(Bottleneck3D, Conv3DDepthwise, (3, 8, 36, 3), "basic_pool",
                       bn_eps=bn_eps, bn_mom=bn_mom, device=device)


def ip_csn_152(bn_eps=1e-3, bn_mom=0.1, device=None):
    return VideoResNet(Bottleneck3D, IPConv3DDepthwise, (3, 8, 36, 3), "basic_pool",
                       bn_eps=bn_eps, bn_mom=bn_mom, device=device)


def ip_csn_50(bn_eps=0.3, bn_mom=0.1, device=None):
    return VideoResNet(Bottleneck3D, IPConv3DDepthwise, (3, 8, 6, 3), "basic_pool",
                       bn_eps=bn_eps, bn_mom=bn_mom, device=device)


VIDEO_RESNETS = {f.__name__: f for f in (r3d_18, r2plus1d_18, r2plus1d_34, r2plus1d_152,
                                         ir_csn_152, ip_csn_152, ip_csn_50)}
