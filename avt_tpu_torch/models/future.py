"""Future predictors: the identity and MLP pass-throughs, and AVT-h, the
causal decoder head that predicts future frame features.

Counterpart of avt_tpu/models/future.py (`IdentityFuture`, `MLPFuture`;
`AVTh` at a one-step rollout
(output_len 1, every shipped configuration), which is one causal forward of
the GPT-2 core. Longer rollouts, the KV-cache mode, cluster-id inputs,
attention-map export and `drop_last_n` come later; the first two raise here).
Each returns (updated past, future feature, losses, endpoints).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from avt_tpu_torch.models.layers import GPT2Core


class IdentityFuture(nn.Module):
    """Pass-through: the features are both the past and the future."""

    def __init__(self, in_features: int):
        super().__init__()
        self.in_features = in_features

    output_dim = property(lambda self: self.in_features)

    def forward(self, feats, target_shape=None, generator: Optional[torch.Generator] = None):
        return feats, feats, {}, {}


class MLPFuture(IdentityFuture):
    """feats -> MLP(feats): `num_layers` Linear(in, in), a ReLU between
    each two. The Linears sit at `model.<2i>`, the reference's Sequential
    of [Linear, ReLU]*n minus the last ReLU."""

    def __init__(self, in_features: int, num_layers: int = 2, device=None):
        super().__init__(in_features)
        layers = []
        for i in range(num_layers):
            layers.append(nn.Linear(in_features, in_features, device=device))
            if i < num_layers - 1:
                layers.append(nn.ReLU())
        self.model = nn.Sequential(*layers)

    def forward(self, feats, target_shape=None, generator: Optional[torch.Generator] = None):
        return feats, self.model(feats), {}, {}


class AVTh(nn.Module):
    """Linear encoder into a GPT-2 core (wte removed), linear decoder back to
    the feature space, teacher-forced next-feature loss `feat`."""

    def __init__(self, in_features: int, output_len: int = -1, output_len_eval: int = -1,
                 avg_last_n: int = -1, inter_dim: int = 768, n_layer: int = 12,
                 n_head: int = 12, n_positions: int = 1024, embd_pdrop: float = 0.1,
                 attn_pdrop: float = 0.1, resid_pdrop: float = 0.1,
                 future_pred_loss: Optional[Callable] = None, return_past_too: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if in_features == 1:
            raise NotImplementedError("AVTh on cluster-id inputs is not ported yet")
        self.in_features = in_features
        self.output_len = output_len
        self.output_len_eval = output_len_eval
        self.avg_last_n = avg_last_n
        self.future_pred_loss = future_pred_loss
        self.return_past_too = return_past_too
        self.encoder = nn.Linear(in_features, inter_dim, bias=False, device=device)
        self.decoder = nn.Linear(inter_dim, in_features, bias=False, device=device)
        self.gpt_model = GPT2Core(inter_dim, n_layer=n_layer, n_head=n_head,
                                  n_positions=n_positions, embd_dropout=embd_pdrop,
                                  attn_dropout=attn_pdrop, resid_dropout=resid_pdrop,
                                  dtype=dtype, device=device)

    output_dim = property(lambda self: self.in_features)

    def forward(self, feats, target_shape=None, generator: Optional[torch.Generator] = None):
        """feats (B, T, C) or (B, C) -> (updated past (B, T, C), final
        feature, losses, endpoints). `generator` draws the train-mode
        dropout masks."""
        if feats.dim() == 2:
            feats = feats[:, None, :]
        if target_shape is not None and len(target_shape) == 3:
            output_len = int(target_shape[1])
        elif self.training or self.output_len_eval < 0:
            output_len = self.output_len
        else:
            output_len = self.output_len_eval
        if output_len < 1:
            raise ValueError(
                f"output_len must be >= 1 (got {output_len}); the reference "
                "errors on <1 too (empty concat)")
        if output_len > 1:
            raise NotImplementedError("AVTh rollouts longer than one step are not ported yet")
        T0 = feats.shape[1]

        hidden = self.gpt_model(self.encoder(feats), generator=generator)  # (B, T0, inter_dim)
        decoded = self.decoder(hidden)

        losses = {}
        if self.future_pred_loss is not None:
            n = min(feats.shape[1], decoded.shape[1])
            losses["feat"] = self.future_pred_loss(decoded[:, : n - 1], feats[:, 1:n])

        prev, all_outputs = feats, decoded
        if self.return_past_too:
            final = torch.cat([prev, all_outputs[:, T0 - 1:]], dim=1)
        else:
            final = all_outputs[:, -output_len:]
        if self.avg_last_n > 0:
            final = final[:, -self.avg_last_n:].mean(dim=1)
        updated_past_feat = torch.cat([prev[:, :1], all_outputs[:, : T0 - 1]], dim=1)
        return updated_past_feat, final, losses, {}
