"""Shared transformer building blocks: the GPT-2 decoder of AVT-h and the
encoder block of the Transformer aggregator.

Counterpart of avt_tpu/models/layers.py (`gelu_new`,
`position_stable_dropout`, `SelfAttention`, `GPT2Block`, `GPT2Core`,
`sincos_positional_encoding`, `EncoderBlock`): the causal forward in eval
and train mode, the KV-cache prefill and single-token decode, the
attention-map export (`output_attentions`) and the position-stable dropout
of rollouts longer than one step. GPT-2's parameter names are HF
transformers' GPT2Model ones (Conv1D weights laid out (in, out)), the
encoder block's those of torch's nn.TransformerEncoderLayer, so reference
state_dicts load unchanged.

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


_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mix32(x, c: int):
    """(x * c) mod 2**32: x under 2**32 and c under 2**31, so that the
    int64 product cannot overflow."""
    return (x * c) & _M32


def _hash32(x):
    """A bijective hash of 32-bit values held in int64 tensors (or ints):
    xorshift-multiply rounds with odd multipliers under 2**31."""
    x = _mix32(x ^ (x >> 16), 0x7FEB352D)
    x = _mix32(x ^ (x >> 15), 0x5BD1E995)
    return x ^ (x >> 16)


def fold_in(key, data):
    """A new key, a pure function of `key` (an int64 tensor of 32-bit
    values) and `data` (an int or an int64 tensor, broadcast against it):
    the port's jax.random.fold_in."""
    return _hash32(key ^ _hash32((data + _GOLDEN) & _M32))


def position_stable_dropout(x: torch.Tensor, key: torch.Tensor, rate: float,
                            offset: int = 0) -> torch.Tensor:
    """Dropout of a (B, T, C) x whose mask is a pure function of (key,
    absolute position, batch row, channel): position offset + t's mask is
    drawn from fold_in(key, offset + t), so any pass that covers a position
    regenerates its mask, whatever the length of the pass. A recomputed
    rollout prefix thus equals what a KV cache keeps, under train-time
    dropout too. One counter-based hash an element, on x's device, with no
    loop over positions; keep and scale as `dropout` does. The bits differ
    from JAX's threefry; the property and the sites are the same."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    B, T, C = x.shape
    pos_keys = fold_in(key, torch.arange(offset, offset + T, device=x.device))
    elems = _hash32(torch.arange(B * C, device=x.device).reshape(B, 1, C) + _GOLDEN)
    keep = _hash32(pos_keys[None, :, None] ^ elems) < int((1.0 - rate) * (1 << 32))
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _dropout(x, rate, generator, training, key, offset):
    """Position-stable dropout under a rollout key, `dropout` otherwise."""
    if key is not None and training:
        return position_stable_dropout(x, key, rate, offset)
    return dropout(x, rate, generator, training)


def _explicit_attention_probs(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Softmax attention probabilities (B, H, Tq, Tk) of (B, T, H, D) q and
    k, in q's type, causal as a query block ending at the last key
    (tril(k=Tk-Tq), masked logits at the type's minimum). Only attention-map
    export materialises them."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        Tq, Tk = logits.shape[-2:]
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril(Tk - Tq)
        logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    return torch.softmax(logits, dim=-1)


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

    def forward(self, x, generator: Optional[torch.Generator] = None, *,
                output_attentions: bool = False, dropout_key: Optional[torch.Tensor] = None,
                kv_cache=None, cache_index: Optional[int] = None, pos_offset: int = 0,
                return_kv: bool = False):
        """kv_cache (a (B, Tc, H, D) k, v pair) with cache_index: the
        decode of the one (B, 1, C) token at that position, whose k and v
        go into copies of the cache (out of place, so that an earlier
        step's saved tensors stay intact) and whose query attends over
        positions <= cache_index; returns (out, (k, v)) with the new
        cache. return_kv: also return this pass's (k, v) (the prefill).
        output_attentions: also return the probabilities (B, H, T, T).
        dropout_key: position-stable dropout at token positions pos_offset
        on, its sites fold_in(key, 0) (attention output) and 1 (c_proj)."""
        B, T, C = x.shape
        qkv = self.c_attn(x, self.dtype)
        q, k, v = (t.reshape(B, T, self.num_heads, C // self.num_heads)
                   for t in qkv.split(C, dim=-1))
        probs = None
        if kv_cache is not None:
            if output_attentions or T != 1:
                raise ValueError("a cached decode takes one token and exports no attention map")
            k, v = (cache.slice_scatter(new.to(cache.dtype), dim=1, start=cache_index,
                                        end=cache_index + 1)
                    for cache, new in zip(kv_cache, (k, v)))
            visible = torch.arange(k.shape[1], device=x.device) <= cache_index
            out = dot_product_attention(q, k, v, causal=False, mask=visible[None, None, None])
        elif output_attentions:
            probs = _explicit_attention_probs(q, k, self.causal)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        else:
            out = dot_product_attention(q, k, v, causal=self.causal)
        if dropout_key is not None and self.training:
            out = position_stable_dropout(out.reshape(B, T, C), fold_in(dropout_key, 0),
                                          self.attn_dropout, pos_offset)
        else:
            out = dropout(out, self.attn_dropout, generator, self.training).reshape(B, T, C)
        out = _dropout(self.c_proj(out, self.dtype), self.resid_dropout, generator,
                       self.training, None if dropout_key is None else fold_in(dropout_key, 1),
                       pos_offset)
        if kv_cache is not None or return_kv:
            return out, (k, v)
        if output_attentions:
            return out, probs
        return out


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

    def forward(self, x, generator: Optional[torch.Generator] = None, *,
                output_attentions: bool = False, dropout_key: Optional[torch.Tensor] = None,
                kv_cache=None, cache_index: Optional[int] = None, pos_offset: int = 0,
                return_kv: bool = False):
        """The options are SelfAttention's; with any of kv_cache, return_kv
        or output_attentions, returns (out, its second output). Dropout
        sites under dropout_key: fold_in(key, 0) the attention's, 1 the
        MLP's residual."""
        attn = self.attn(layer_norm(x, self.ln_1, self.dtype), generator,
                         output_attentions=output_attentions,
                         dropout_key=None if dropout_key is None else fold_in(dropout_key, 0),
                         kv_cache=kv_cache, cache_index=cache_index, pos_offset=pos_offset,
                         return_kv=return_kv)
        extra = None
        if kv_cache is not None or return_kv or output_attentions:
            attn, extra = attn
        x = x + attn
        h = layer_norm(x, self.ln_2, self.dtype)
        h = gelu_new(self.mlp.c_fc(h, self.dtype))
        h = self.mlp.c_proj(h, self.dtype)
        out = x + _dropout(h, self.resid_dropout, generator, self.training,
                           None if dropout_key is None else fold_in(dropout_key, 1), pos_offset)
        return out if extra is None else (out, extra)


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
                generator: Optional[torch.Generator] = None, *, output_attentions: bool = False,
                dropout_key: Optional[torch.Tensor] = None, kv_caches=None,
                return_kv: bool = False):
        """inputs_embeds (B, T, C) at token positions position_offset on.
        wpe is sliced as jax.lax.dynamic_slice_in_dim does, its start
        clamped so that T rows fit. dropout_key: position-stable dropout
        (the same key for every pass of a rollout makes the masks a function
        of the token position only, so recompute == KV cache); the sites
        fold_in(key, 0) for the embedding, 1 + i for block i.
        output_attentions: also return every layer's probabilities stacked
        (B, n_layer, n_head, T, T). return_kv: also return each layer's (k,
        v) of this pass (the prefill). kv_caches: each layer's (B, Tc, H, D)
        k, v pair, for the decode of the one token at position_offset;
        returns (out, the updated caches)."""
        T = inputs_embeds.shape[1]
        n_positions = self.wpe.num_embeddings
        if T > n_positions:
            raise ValueError(f"{T} tokens do not fit n_positions={n_positions}")
        start = min(max(position_offset, 0), n_positions - T)
        x = inputs_embeds + self.wpe.weight[start:start + T][None]
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = _dropout(x, self.embd_dropout, generator, self.training,
                     None if dropout_key is None else fold_in(dropout_key, 0), position_offset)
        extras = []
        for i, block in enumerate(self.h):
            x = block(x, generator, output_attentions=output_attentions,
                      dropout_key=None if dropout_key is None else fold_in(dropout_key, 1 + i),
                      kv_cache=None if kv_caches is None else kv_caches[i],
                      cache_index=None if kv_caches is None else position_offset,
                      pos_offset=position_offset, return_kv=return_kv)
            if kv_caches is not None or return_kv or output_attentions:
                x, extra = x
                extras.append(extra)
        x = layer_norm(x, self.ln_f, self.dtype)
        out = x.float() if self.dtype is not None else x
        if kv_caches is not None or return_kv:
            return out, extras
        if output_attentions:
            return out, torch.stack(extras, dim=1)
        return out


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
