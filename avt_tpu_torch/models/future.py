"""Future predictors: the identity and MLP pass-throughs, and AVT-h, the
causal decoder head that predicts future frame features.

Counterpart of avt_tpu/models/future.py (`IdentityFuture`, `MLPFuture`,
`AVTh` with every option). Each returns (updated past, future feature,
losses, endpoints).

AVT-h's rollout of L > 1 steps is JAX's static recompute by default: step
k runs one full causal pass of the GPT-2 core over the T0 + k - 1 tokens
so far (from 128 tokens on through the flash kernels), and one final pass
gives every hidden state. rollout_mode='cache' runs one prefill pass, then
L - 1 single-token decodes against per-layer KV caches (masked plain
attention over the cache). Under train-time dropout both take
position-stable masks drawn from one seed a forward, so the two modes give
the same outputs, gradients included.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from avt_tpu_torch.models.cluster import KmeansAssigner
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
    """A linear encoder into a GPT-2 core (wte removed) and a linear decoder
    back to the feature space, or, on cluster ids (in_features == 1, or
    `centroids` (K, C) to assign features to), an nn.Embedding encoder with
    the decoder's weight tied to it (reference future_prediction.py:83-87);
    teacher-forced next-feature loss `feat`.

    output_len / output_len_eval: rollout steps in training / eval.
    drop_last_n: drops the last n inputs (the loss still sees them all).
    quantize_before_rollout: feeds back argmax ids re-encoded (cluster
    ids only). output_attentions: endpoints gpt2_att_<k>, each step's maps
    (B, n_layer, n_head, Tq, Tk) sliced from the final pass (cache mode
    takes the recompute path then). rollout_mode: 'recompute' or
    'cache'."""

    def __init__(self, in_features: int, output_len: int = -1, output_len_eval: int = -1,
                 avg_last_n: int = -1, inter_dim: int = 768, n_layer: int = 12,
                 n_head: int = 12, n_positions: int = 1024, embd_pdrop: float = 0.1,
                 attn_pdrop: float = 0.1, resid_pdrop: float = 0.1,
                 future_pred_loss: Optional[Callable] = None, return_past_too: bool = False,
                 drop_last_n: int = 0, quantize_before_rollout: bool = False,
                 num_cluster_centers: int = 50000, centroids=None,
                 output_attentions: bool = False, rollout_mode: str = "recompute",
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if rollout_mode not in ("recompute", "cache"):
            raise ValueError(f"rollout_mode must be 'recompute' or 'cache', got "
                             f"{rollout_mode!r}")
        self.in_features = in_features
        self.inter_dim = inter_dim
        self.output_len = output_len
        self.output_len_eval = output_len_eval
        self.avg_last_n = avg_last_n
        self.future_pred_loss = future_pred_loss
        self.return_past_too = return_past_too
        self.drop_last_n = drop_last_n
        self.quantize_before_rollout = quantize_before_rollout
        self.output_attentions = output_attentions
        self.rollout_mode = rollout_mode
        self.pdrops = (embd_pdrop, attn_pdrop, resid_pdrop)
        self.quantized_input = in_features == 1 or centroids is not None
        if self.quantized_input:
            self.encoder = nn.Embedding(num_cluster_centers, inter_dim, device=device)
            self.decoder = nn.Linear(inter_dim, num_cluster_centers, bias=False, device=device)
            self.decoder.weight = self.encoder.weight  # logits = hidden @ E^T
        else:
            self.encoder = nn.Linear(in_features, inter_dim, bias=False, device=device)
            self.decoder = nn.Linear(inter_dim, in_features, bias=False, device=device)
        self.assigner = None if centroids is None else KmeansAssigner(
            centroids, device=self.encoder.weight.device)
        self.gpt_model = GPT2Core(inter_dim, n_layer=n_layer, n_head=n_head,
                                  n_positions=n_positions, embd_dropout=embd_pdrop,
                                  attn_dropout=attn_pdrop, resid_dropout=resid_pdrop,
                                  dtype=dtype, device=device)

    output_dim = property(lambda self: self.inter_dim if self.in_features == 1
                          else self.in_features)

    def _requantize(self, hidden):
        """The argmax cluster ids of hidden states, re-encoded."""
        if not self.quantized_input:
            raise ValueError("quantize_before_rollout needs cluster-id inputs")
        return self.encoder(self.decoder(hidden).argmax(dim=-1))

    def _cached_rollout(self, encoded, L, generator, dkey):
        """One prefill pass, then L - 1 single-token decodes against each
        layer's KV cache (grown to T0 + L - 1 positions): (B, T0 + L - 1,
        inter_dim) hidden states."""
        B, T0, _ = encoded.shape
        h0, kvs = self.gpt_model(encoded, generator=generator, dropout_key=dkey,
                                 return_kv=True)
        kvs = [tuple(torch.cat([a, a.new_zeros((B, L - 1) + tuple(a.shape[2:]))], dim=1)
                     for a in kv) for kv in kvs]
        hiddens, last = [h0], h0[:, -1:]
        for k in range(1, L):
            inp = self._requantize(last) if self.quantize_before_rollout else last
            last, kvs = self.gpt_model(inp, T0 + k - 1, generator, dropout_key=dkey,
                                       kv_caches=kvs)
            hiddens.append(last)
        return torch.cat(hiddens, dim=1)

    def forward(self, feats, target_shape=None, generator: Optional[torch.Generator] = None):
        """feats (B, T, C) or (B, C) (cluster ids as floats when in_features
        is 1) -> (updated past (B, T, C), final feature, losses,
        endpoints). `generator` draws the train-mode dropout masks, or, in
        a rollout of L > 1 steps, the one seed of its position-stable
        masks."""
        endpoints = {}
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
        full_inp_feats = feats
        if self.assigner is not None:
            feats = self.assigner.feat2cluster(feats)[..., None]
        if self.quantized_input:
            if feats.shape[-1] != 1:
                raise ValueError(f"cluster-id inputs are (B, T, 1), got {tuple(feats.shape)}")
            feats = feats[..., 0].long()
        full_orig_feats = feats  # the loss target (ids when quantized)
        inp_feats = full_inp_feats
        if self.drop_last_n != 0:
            feats = feats[:, :-self.drop_last_n]
            inp_feats = inp_feats[:, :-self.drop_last_n]
        T0, L = feats.shape[1], output_len

        encoded = self.encoder(feats)  # (B, T0, inter_dim)
        dkey = None
        if self.training and L > 1 and max(self.pdrops) > 0:
            dkey = torch.randint(0, 1 << 32, (), generator=generator, device=encoded.device)
        if self.rollout_mode == "cache" and L > 1 and not self.output_attentions:
            hidden = self._cached_rollout(encoded, L, generator, dkey)
        else:
            buf = encoded
            for _ in range(1, L):
                last = self.gpt_model(buf, generator=generator, dropout_key=dkey)[:, -1:]
                if self.quantize_before_rollout:
                    last = self._requantize(last)
                buf = torch.cat([buf, last], dim=1)
            hidden = self.gpt_model(buf, generator=generator, dropout_key=dkey,
                                    output_attentions=self.output_attentions)
        if self.output_attentions:
            # step 0 is the (T0, T0) causal block, step k the one new query
            # over its T0 + k visible keys (reference future_prediction.py:184-188)
            hidden, probs = hidden
            endpoints["gpt2_att_0"] = probs[..., :T0, :T0]
            for k in range(1, L):
                endpoints[f"gpt2_att_{k}"] = probs[..., T0 + k - 1:T0 + k, :T0 + k]
        decoded = self.decoder(hidden)

        losses = {}
        if self.future_pred_loss is not None:
            n = min(full_orig_feats.shape[1], decoded.shape[1])
            losses["feat"] = self.future_pred_loss(decoded[:, : n - 1], full_orig_feats[:, 1:n])

        if self.in_features == 1:
            prev, all_outputs = encoded, hidden  # hidden states are the features here
        elif self.assigner is not None:
            prev = inp_feats
            all_outputs = self.assigner.cluster2feat(decoded.argmax(dim=-1))
        else:
            prev, all_outputs = inp_feats, decoded
        if self.return_past_too:
            final = torch.cat([prev, all_outputs[:, T0 - 1:]], dim=1)
        else:
            final = all_outputs[:, -L:]
        if self.avg_last_n > 0:
            final = final[:, -self.avg_last_n:].mean(dim=1)
        updated_past_feat = torch.cat([prev[:, :1], all_outputs[:, : T0 - 1]], dim=1)
        return updated_past_feat, final, losses, endpoints
