"""Classifier heads; counterpart of avt_tpu/models/classifiers.py."""
from __future__ import annotations

from torch import nn


class LinearClassifier(nn.Linear):
    """torch.nn.Linear, as the reference's conf/model/classifier/linear.yaml
    builds it; its parameters sit at `classifiers.<task>.{weight,bias}`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
