"""Classifier heads; counterpart of avt_tpu/models/classifiers.py."""
from __future__ import annotations

from torch import nn


class LinearClassifier(nn.Linear):
    """torch.nn.Linear, as the reference's conf/model/classifier/linear.yaml
    builds it; its parameters sit at `classifiers.<task>.{weight,bias}`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)


class MLPClassifier(nn.Module):
    """`nlayers - 1` Linear(in, in) + ReLU, then Linear(in, out), as the
    JAX package's MLPClassifier: `bias` applies to the hidden Linears, the
    last one always has a bias. The Linears sit at `model.<2i>` (the port's
    names: the reference's checkpoint converter has no mapping for this
    head)."""

    def __init__(self, in_features: int, out_features: int, nlayers: int = 2,
                 bias: bool = True, device=None):
        super().__init__()
        layers = []
        for _ in range(nlayers - 1):
            layers += [nn.Linear(in_features, in_features, bias=bias, device=device), nn.ReLU()]
        layers.append(nn.Linear(in_features, out_features, device=device))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)
