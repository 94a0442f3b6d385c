"""Classifier heads; counterpart of avt_tpu/models/classifiers.py."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from avt_tpu_torch.parallel.mesh import copy_to_model, gather_from_model, local_bias


class LinearClassifier(nn.Linear):
    """torch.nn.Linear, as the reference's conf/model/classifier/linear.yaml
    builds it; its parameters sit at `classifiers.<task>.{weight,bias}`.
    With `tp` a mesh (parallel/mesh.py) it holds its rank's classes, a
    contiguous part, and its local logits are gathered over the model group
    before the losses."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.tp = None

    def forward(self, x):
        if self.tp is None:
            return super().forward(x)
        logits = F.linear(copy_to_model(x, self.tp), self.weight, local_bias(self.bias, self.tp))
        return gather_from_model(logits, self.tp, dim=-1)


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
