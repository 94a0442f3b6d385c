"""Temporal aggregators; counterpart of avt_tpu/models/temporal_agg.py.

Only the pass-through the flagship uses is ported so far."""
from __future__ import annotations

from torch import nn


class IdentityAgg(nn.Module):
    def __init__(self, in_features: int):
        super().__init__()
        self.in_features = in_features

    output_dim = property(lambda self: self.in_features)

    def forward(self, feats):
        return feats, {}
