"""Shared transformer building blocks: the GPT-2 decoder of AVT-h and the
encoder block of the Transformer aggregator.

Counterpart of avt_tpu/models/layers.py (`gelu_new`, `SelfAttention`,
`GPT2Block`, `GPT2Core`, `sincos_positional_encoding`, `EncoderBlock`) for
the recompute forward, in eval and train mode; the KV cache,
`output_attentions` and position-stable dropout (rollouts longer than one
step) come later. GPT-2's parameter names are HF transformers' GPT2Model
ones (Conv1D weights laid out (in, out)), the encoder block's those of
torch's nn.TransformerEncoderLayer, so reference state_dicts load unchanged.

`dense` and `layer_norm` reproduce flax's `dtype=` semantics, which every
module of the port follows: parameters stay f32; under a compute dtype the
input and weights are cast to it at use, a product is rounded to it before
the bias is added in it, and LayerNorm statistics are taken in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avt_tpu_torch.ops import dot_product_attention


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: Optional[torch.dtype], *, in_out: bool = False) -> torch.Tensor:
    """flax Dense: x @ W (+ b). weight is torch's (out, in), or (in, out)
    with in_out=True (GPT-2's Conv1D)."""
    if dtype is not None:  # cast before transposing: a contiguous cast
        x, weight = x.to(dtype), weight.to(dtype)
        bias = None if bias is None else bias.to(dtype)
    y = torch.matmul(x, weight if in_out else weight.t())
    return y if bias is None else y + bias


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax LayerNorm: statistics and affine in f32, result in `dtype` (f32
    when no dtype is given)."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y if dtype is None else y.to(dtype)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """flax Dropout: in training, keep each element with probability 1 - p
    and divide it by 1 - p, both in x's type (a weakly typed float takes
    the array's type); the mask is drawn from `generator` (torch's default
    when None), which nn.Dropout cannot take."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    keep_prob = torch.tensor(1.0 - p, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh-approximated GELU."""
    return F.gelu(x, approximate="tanh")


class Conv1D(nn.Module):
    """HF GPT-2's linear layer: weight (in, out), bias (out)."""

    def __init__(self, nx: int, nf: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(nx, nf, device=device))
        self.bias = nn.Parameter(torch.zeros(nf, device=device))

    def forward(self, x, dtype: Optional[torch.dtype] = None):
        return dense(x, self.weight, self.bias, dtype, in_out=True)


class SelfAttention(nn.Module):
    """Multi-head self-attention with a fused qkv projection (c_attn) and an
    output projection (c_proj). As in the JAX package, attention dropout
    acts on the attention output, which keeps the attention fused. q, k and
    v are strided (B, T, H, D) views of the c_attn output, which the flash
    kernels read in place (no split, pad or transpose copy)."""

    def __init__(self, dim: int, num_heads: int, causal: bool = False,
                 attn_dropout: float = 0.0, resid_dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.dtype = dtype
        self.c_attn = Conv1D(dim, 3 * dim, device=device)
        self.c_proj = Conv1D(dim, dim, device=device)
        self.attn_dropout = attn_dropout
        self.resid_dropout = resid_dropout

    def forward(self, x, generator: Optional[torch.Generator] = None):
        B, T, C = x.shape
        qkv = self.c_attn(x, self.dtype)
        q, k, v = (t.reshape(B, T, self.num_heads, C // self.num_heads)
                   for t in qkv.split(C, dim=-1))
        out = dot_product_attention(q, k, v, causal=self.causal)
        out = dropout(out, self.attn_dropout, generator, self.training).reshape(B, T, C)
        return dropout(self.c_proj(out, self.dtype), self.resid_dropout, generator,
                       self.training)


class GPT2MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.c_fc = Conv1D(dim, hidden, device=device)
        self.c_proj = Conv1D(hidden, dim, device=device)


class GPT2Block(nn.Module):
    """Pre-LN decoder block: x += attn(ln_1(x)); x += mlp(ln_2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 attn_dropout: float = 0.1, resid_dropout: float = 0.1,
                 ln_eps: float = 1e-5, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(dim, eps=ln_eps, device=device)
        self.attn = SelfAttention(dim, num_heads, causal=True, attn_dropout=attn_dropout,
                                  resid_dropout=resid_dropout, dtype=dtype, device=device)
        self.ln_2 = nn.LayerNorm(dim, eps=ln_eps, device=device)
        self.mlp = GPT2MLP(dim, mlp_ratio * dim, device=device)
        self.resid_dropout = resid_dropout

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x + self.attn(layer_norm(x, self.ln_1, self.dtype), generator)
        h = layer_norm(x, self.ln_2, self.dtype)
        h = gelu_new(self.mlp.c_fc(h, self.dtype))
        h = self.mlp.c_proj(h, self.dtype)
        return x + dropout(h, self.resid_dropout, generator, self.training)


class GPT2Core(nn.Module):
    """transformers.GPT2Model without wte: learned positions (wpe), a stack
    of GPT2Blocks (h) and a final LayerNorm (ln_f). Under a compute dtype the
    output comes back as f32."""

    def __init__(self, dim: int, n_layer: int = 12, n_head: int = 12,
                 n_positions: int = 1024, embd_dropout: float = 0.1,
                 attn_dropout: float = 0.1, resid_dropout: float = 0.1,
                 ln_eps: float = 1e-5, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.wpe = nn.Embedding(n_positions, dim, device=device)
        self.embd_dropout = embd_dropout
        self.h = nn.ModuleList(
            GPT2Block(dim, n_head, attn_dropout=attn_dropout, resid_dropout=resid_dropout,
                      ln_eps=ln_eps, dtype=dtype, device=device)
            for _ in range(n_layer)
        )
        self.ln_f = nn.LayerNorm(dim, eps=ln_eps, device=device)

    def forward(self, inputs_embeds, position_offset: int = 0,
                generator: Optional[torch.Generator] = None):
        T = inputs_embeds.shape[1]
        x = inputs_embeds + self.wpe.weight[position_offset:position_offset + T][None]
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = dropout(x, self.embd_dropout, generator, self.training)
        for block in self.h:
            x = block(x, generator)
        x = layer_norm(x, self.ln_f, self.dtype)
        return x.float() if self.dtype is not None else x


def sincos_positional_encoding(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """Sin/cos table (max_len, d_model) in f32, computed as the JAX package
    does (reference temporal_aggregation.py:50-70)."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class EncoderSelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters (a packed (3E, E) in_proj_weight,
    whose transpose is the JAX package's qkv kernel with the same contiguous
    per-head split, and out_proj), run as the JAX package's SelfAttention:
    q, k and v are strided (B, T, H, D) views of one projection, which the
    flash kernels read in place; dropout acts on the attention output."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, device=device))
        self.out_proj = nn.Linear(dim, dim, device=device)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None):
        B, T, C = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, T, self.num_heads, C // self.num_heads)
                   for t in qkv.split(C, dim=-1))
        out = dot_product_attention(q, k, v, causal=False, mask=mask)
        out = dropout(out, self.dropout, generator, self.training).reshape(B, T, C)
        return self.out_proj(out)


class EncoderBlock(nn.Module):
    """Post-LN encoder layer, torch.nn.TransformerEncoderLayer's semantics
    and names (self_attn, linear1, linear2, norm1, norm2): attention, add +
    LayerNorm, ReLU FFN, add + LayerNorm. Its LayerNorms take flax's
    epsilon, 1e-6, as the JAX package's block does. `mask` (True = keep,
    broadcastable to (B, H, T, T)) drops attention keys; without one, 128
    tokens or more take the flash kernels on CUDA."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int, dropout: float = 0.1,
                 device=None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = EncoderSelfAttention(dim, num_heads, dropout, device=device)
        self.linear1 = nn.Linear(dim, ffn_dim, device=device)
        self.linear2 = nn.Linear(ffn_dim, dim, device=device)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=device)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None):
        def drop(t):
            return dropout(t, self.dropout, generator, self.training)

        x = self.norm1(x + drop(self.self_attn(x, generator, mask)))
        h = drop(F.relu(self.linear1(x)))
        return self.norm2(x + drop(self.linear2(h)))


def init_normal_(module: nn.Module, std: float, generator: torch.Generator) -> None:
    """N(0, std) for every weight matrix (and embedding) of `module`, zero
    biases, LayerNorms at weight 1 / bias 0."""
    for sub in module.modules():
        if isinstance(sub, nn.LayerNorm):
            nn.init.ones_(sub.weight)
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, (nn.Linear, Conv1D, nn.Embedding)):
            nn.init.normal_(sub.weight, std=std, generator=generator)
            if getattr(sub, "bias", None) is not None:
                nn.init.zeros_(sub.bias)


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """flax truncated_normal(stddev): N(0, std^2) cut at +-2 std."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: variance_scaling(1, fan_in, truncated_normal)."""
    return trunc_normal_(t, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)
