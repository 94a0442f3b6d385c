"""Backbones: (B, C, T, H, W) -> (B, C', T', H', W').

Counterpart of avt_tpu/models/backbones.py. The identity backbone serves the
pre-extracted-feature configurations (expts/02-06 and 08: features of
(B * #clips, C, 1, 1, 1)); the frame-level ViT (AVT-b) is in vit.py, the
video ResNets (r3d, r(2+1)d, CSN) in video_resnet.py and the per-frame
BN-Inception in bninception.py.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class IdentityBackbone(nn.Module):
    """Pass-through for pre-extracted features; it has no parameters."""

    def forward(self, video, generator: Optional[torch.Generator] = None):
        return video
