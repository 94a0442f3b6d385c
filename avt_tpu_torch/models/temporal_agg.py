"""Temporal aggregators: (B, T, C) -> (B, C') (or pass-through).

Counterpart of avt_tpu/models/temporal_agg.py: Identity, Mean, the
rolling-unrolling LSTM (RULSTM) and the Transformer encoder with its
optional cloze (MLM) loss. Each takes `feats` and the train-mode dropout
`generator` and returns (aggregated features, aux losses).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avt_tpu_torch.models.layers import EncoderBlock, dropout, sincos_positional_encoding


class IdentityAgg(nn.Module):
    def __init__(self, in_features: int):
        super().__init__()
        self.in_features = in_features

    output_dim = property(lambda self: self.in_features)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        return feats, {}


class MeanAgg(IdentityAgg):
    def forward(self, feats, generator: Optional[torch.Generator] = None):
        return feats.mean(dim=1), {}


class LSTMLayer(nn.Module):
    """One torch nn.LSTM layer's tensors under its names (`weight_ih_l0`
    (4H, C), `weight_hh_l0` (4H, H), `bias_ih_l0`, `bias_hh_l0`, gates
    packed [i|f|g|o]), so an original RULSTM checkpoint loads as it is, run
    step by step as flax's LSTM cell runs: the input projection of every
    step is one product, then each step adds h @ W_hh^T.

    `bias_ih_l0` is a buffer, not a parameter: the JAX package's cell folds
    both biases into one (`import_torch._lstm_cell_to_flax`), so the gates'
    bias trains as one vector, `bias_hh_l0`, while a checkpoint's input-side
    bias stays as it was loaded. The step and its gradients are then those
    of the JAX cell."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih_l0 = nn.Parameter(torch.zeros(4 * hidden_size, input_size, device=device))
        self.weight_hh_l0 = nn.Parameter(torch.zeros(4 * hidden_size, hidden_size,
                                                     device=device))
        self.register_buffer("bias_ih_l0", torch.zeros(4 * hidden_size, device=device))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(4 * hidden_size, device=device))

    def project(self, x):
        """The input side of the gates: x @ W_ih^T + both biases."""
        return torch.matmul(x, self.weight_ih_l0.t()) + (self.bias_ih_l0 + self.bias_hh_l0)

    def step(self, x_proj, h, c):
        gates = x_proj + torch.matmul(h, self.weight_hh_l0.t())
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class RULSTMAgg(nn.Module):
    """Rolling-Unrolling LSTM (Furnari & Farinella, TPAMI'20), as the JAX
    package reimplements it: dropout on the features, a rolling LSTM over
    the T observed steps from a zero state, then an unrolling LSTM started
    from the rolling state that runs `num_pad_feats + 1` steps, each fed the
    last observed feature; the output is its final h (`intermediate_featdim`
    wide). Parameters: `rolling_lstm.*` and `unrolling_lstm.*` (LSTMLayer)."""

    def __init__(self, in_features: int, intermediate_featdim: int = 1024,
                 dropout: float = 0.8, num_pad_feats: int = 0, device=None):
        super().__init__()
        self.dropout = dropout
        self.num_pad_feats = num_pad_feats
        self.intermediate_featdim = intermediate_featdim
        self.rolling_lstm = LSTMLayer(in_features, intermediate_featdim, device=device)
        self.unrolling_lstm = LSTMLayer(in_features, intermediate_featdim, device=device)

    output_dim = property(lambda self: self.intermediate_featdim)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        B, T, _ = feats.shape
        feats = dropout(feats, self.dropout, generator, self.training)
        h = c = feats.new_zeros(B, self.intermediate_featdim)
        x_proj = self.rolling_lstm.project(feats)  # (B, T, 4H)
        for t in range(T):
            h, c = self.rolling_lstm.step(x_proj[:, t], h, c)
        last = self.unrolling_lstm.project(feats[:, -1])
        for _ in range(self.num_pad_feats + 1):
            h, c = self.unrolling_lstm.step(last, h, c)
        return h, {}


def _uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The cloze draw: U[0, 1) of `shape`."""
    return torch.rand(shape, generator=generator, device=device)


class TransformerEncoder(nn.Module):
    """nn.TransformerEncoder's names: `layers.<i>` and the final `norm`."""

    def __init__(self, dim: int, num_heads: int, num_layers: int, ffn_dim: int,
                 dropout: float, device=None):
        super().__init__()
        self.layers = nn.ModuleList(EncoderBlock(dim, num_heads, ffn_dim, dropout, device=device)
                                    for _ in range(num_layers))
        self.norm = nn.LayerNorm(dim, eps=1e-6, device=device)


class TransformerAgg(nn.Module):
    """Transformer-encoder aggregator: the `downproject` Linear, the sin/cos
    table, a dropout of 0.1 (fixed, as in the JAX package), `nlayers`
    post-LN encoder blocks, a final LayerNorm, then mean or last pooling.

    Cloze (MLM) training, with cloze_loss_ratio > 0 in train mode: each key
    position is drawn with that probability, replaced by the learned mask
    embedding `extra_embeddings.weight` (1, C) and masked as an attention
    key; with cloze_loss_wt > 0 the aux loss `tx_mlm` is the weighted mean
    squared distance of the masked outputs to the encoder's input. The mask
    embedding exists only when cloze_loss_ratio > 0.

    Names are those of the reference's torch module (downproject,
    transformer_encoder.layers.<i>.*, transformer_encoder.norm,
    extra_embeddings), which `avt_tpu/models/import_torch.py:
    transformer_agg_to_flax` reads."""

    def __init__(self, in_features: int, inter_rep: int = 512, nheads: int = 8,
                 nlayers: int = 6, ffn_dim: int = 2048, dropout: float = 0.1,
                 agg_style: str = "mean", cloze_loss_ratio: float = 0.0,
                 cloze_loss_wt: float = 0.0, max_len: int = 1000, device=None):
        super().__init__()
        if agg_style not in ("mean", "last"):
            raise NotImplementedError(f"Unknown agg_style {agg_style!r}")
        self.inter_rep = inter_rep
        self.agg_style = agg_style
        self.cloze_loss_ratio = cloze_loss_ratio
        self.cloze_loss_wt = cloze_loss_wt
        self.downproject = nn.Linear(in_features, inter_rep, device=device)
        self.register_buffer("pe", sincos_positional_encoding(max_len, inter_rep, device),
                             persistent=False)
        self.transformer_encoder = TransformerEncoder(inter_rep, nheads, nlayers, ffn_dim,
                                                      dropout, device=device)
        if cloze_loss_ratio > 0:
            self.extra_embeddings = nn.Embedding(1, in_features, device=device)

    output_dim = property(lambda self: self.inter_rep)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        B, T, _ = feats.shape
        aux_losses = {}
        key_mask = None
        if self.training and self.cloze_loss_ratio > 0:
            key_mask = _uniform((B, T), generator, feats.device) <= self.cloze_loss_ratio
            feats = torch.where(key_mask[..., None], self.extra_embeddings.weight, feats)
        x = self.downproject(feats) + self.pe[:T]
        x = dropout(x, 0.1, generator, self.training)
        enc_input = x
        # masked positions are dropped as attention keys: (B, 1, 1, T)
        attn_mask = None if key_mask is None else (~key_mask)[:, None, None, :]
        for layer in self.transformer_encoder.layers:
            x = layer(x, generator, attn_mask)
        x = self.transformer_encoder.norm(x)
        if key_mask is not None and self.cloze_loss_wt > 0:
            dist = ((x - enc_input) ** 2).mean(dim=-1)
            aux_losses["tx_mlm"] = self.cloze_loss_wt * (dist * key_mask).mean()
        res = x.mean(dim=1) if self.agg_style == "mean" else x[:, -1]
        return res, aux_losses
